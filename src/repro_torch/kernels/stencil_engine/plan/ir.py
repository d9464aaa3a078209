"""Plan IR: the tiny SSA program a spec compiles to, plus its analyses.

A :class:`StencilPlan` is an explicit tap schedule -- shift/scale/add/fma ops
in SSA form -- compiled by the pass pipeline in :mod:`.passes`.  It is the
port's copy of the reference's plan IR, op for op: the parity tests hold
``compile_plan`` here equal to the reference's for every registered spec.

The plain PyTorch versions of the kernels walk the plan with
:func:`execute_plan`; the CUDA kernels evaluate the spec's taps directly
(on integer-valued data the two agree exactly, whatever the summation
order).  Shifts are single-axis ops of any magnitude up to the spec's
per-axis radius, with zero fill (a slice plus an edge pad -- never a
wrap-around roll).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..spec import StencilSpec, bc_labels

Offset = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class PlanOp:
    """One SSA op.  Value ids: 0 is the input ``u``; op ``k`` defines id
    ``k + 1``.  ``shift``: value ``a`` moved by ``off`` (exactly one nonzero
    component, ``|off| <= radius`` on that axis, ``out[x] = in[x + off]``,
    zero fill).  ``scale``: ``w[w_idx] * a``.  ``add``: ``a + b``.  ``fma``:
    ``b + w[w_idx] * a``."""

    kind: str                     # "shift" | "scale" | "add" | "fma"
    a: int
    b: int = -1
    off: Offset = (0, 0, 0)
    w_idx: int = -1


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """A compiled execution schedule for one spec.

    ``out`` is the id of the final value (-1 for an empty tap list, which
    executes as zeros).  ``passes`` records the pass pipeline that produced
    the schedule.  ``shifts``/``flops`` are the static op counts (flops
    count multiplies and adds; an fma is two).  ``peak_live`` is the
    maximum number of simultaneously live SSA values while executing the
    schedule in order -- the paper's register-pressure constraint recast as
    the working set the executor carries.

    ``unroll`` is the innermost-sweep unroll factor chosen by the
    ``unroll[k]`` pass (the paper's register-level unroll); it is kept as a
    field of the plan so plans compare equal with the reference's, and
    :func:`execute_plan` does not need it.  ``modeled`` carries the chosen
    variant's :class:`~.cost.PlanCost` and ``candidates`` the full ``(kind,
    unroll, cycles_per_point)`` table the cost-driven compiler selected from
    (both hashable, so plans key caches).
    """

    spec: StencilSpec
    kind: str                     # "direct" | "cse" | "factored"
    ops: Tuple[PlanOp, ...]
    out: int
    passes: Tuple[str, ...] = ()
    unroll: int = 1
    modeled: Optional[object] = None            # cost.PlanCost of the choice
    candidates: Tuple[Tuple[str, int, float], ...] = ()

    @property
    def shifts(self) -> int:
        return sum(1 for op in self.ops if op.kind == "shift")

    @property
    def flops(self) -> int:
        return sum({"scale": 1, "add": 1, "fma": 2}.get(op.kind, 0)
                   for op in self.ops)

    @property
    def peak_live(self) -> int:
        return peak_live(self)

    def describe(self) -> Dict[str, object]:
        """Machine-readable op counts (benchmark / JSON artifact form).

        When the plan came out of the cost-driven compiler, ``selection``
        records the choice: the chosen ``(pass_list, unroll)``, its modeled
        cycles/point (and which core model produced the number), and the
        losing ``(kind, unroll, cycles_per_point)`` candidates.
        """
        d = {"taps": self.spec.taps, "shifts": self.shifts,
             "flops": self.flops, "ops": len(self.ops),
             "peak_live": self.peak_live,
             "radius": list(self.spec.radius),
             "bc": list(bc_labels(self.spec.bc)),
             "coef": self.spec.coef,
             "ordering": self.spec.ordering,
             "unroll": self.unroll,
             "pass_list": list(self.passes)}
        if self.modeled is not None:
            d["selection"] = {
                "kind": self.kind, "unroll": self.unroll,
                "cycles_per_point": self.modeled.cycles_per_point,
                "source": self.modeled.source,
                "candidates": [
                    {"kind": k, "unroll": u, "cycles_per_point": c}
                    for k, u, c in self.candidates],
            }
        return d


class Builder:
    """Emit helper: returns the SSA id of each new value."""

    def __init__(self):
        self.ops: List[PlanOp] = []

    def _emit(self, op: PlanOp) -> int:
        self.ops.append(op)
        return len(self.ops)          # u is id 0; op k defines id k + 1

    def shift(self, a: int, axis: int, d: int) -> int:
        off = [0, 0, 0]
        off[axis] = d
        return self._emit(PlanOp("shift", a, off=tuple(off)))

    def scale(self, w_idx: int, a: int) -> int:
        return self._emit(PlanOp("scale", a, w_idx=w_idx))

    def add(self, a: int, b: int) -> int:
        return self._emit(PlanOp("add", a, b))

    def fma(self, w_idx: int, a: int, acc: int) -> int:
        return self._emit(PlanOp("fma", a, acc, w_idx=w_idx))

    def acc(self, w_idx: int, a: int, acc: Optional[int]) -> int:
        return self.scale(w_idx, a) if acc is None else self.fma(w_idx, a, acc)


def op_sources(op: PlanOp) -> Tuple[int, ...]:
    """The SSA value ids an op reads (deduplicated, order preserved)."""
    srcs = [op.a]
    if op.b >= 0 and op.b != op.a:
        srcs.append(op.b)
    return tuple(srcs)


def peak_live(plan: StencilPlan) -> int:
    """Peak number of simultaneously live SSA values over the schedule.

    A value is live from its definition (the input ``u`` from the start)
    until its last use; the output stays live through the end.  This is the
    sequential-execution working set -- what ``execute_plan`` actually keeps
    resident -- and the invariant the ``order_ops`` pass must never increase.
    """
    if not plan.ops:
        return 1 if plan.out == 0 else 0
    last_use: Dict[int, int] = {}
    for i, op in enumerate(plan.ops):
        for v in op_sources(op):
            last_use[v] = i
    if plan.out >= 0:
        last_use[plan.out] = len(plan.ops)
    live = 1 if 0 in last_use else 0          # the input u
    peak = live
    for i, op in enumerate(plan.ops):
        live += 1                              # op i defines value i + 1
        peak = max(peak, live)
        for v in set(op_sources(op)):
            if last_use.get(v, -1) == i:
                live -= 1                      # last use: dead after op i
        if (i + 1) not in last_use:
            live -= 1                          # defined but never consumed
    return peak


def renumber(ops: List[PlanOp], order: List[int], out: int
             ) -> Tuple[Tuple[PlanOp, ...], int]:
    """Re-emit ``ops`` in ``order`` (a topological permutation of op
    indices) with SSA ids renumbered to the new positions."""
    newid = {0: 0}
    new_ops: List[PlanOp] = []
    for pos, old in enumerate(order):
        op = ops[old]
        new_ops.append(dataclasses.replace(
            op, a=newid[op.a], b=newid[op.b] if op.b >= 0 else -1))
        newid[old + 1] = pos + 1
    return tuple(new_ops), (newid[out] if out >= 0 else -1)


def shift_slice(t: torch.Tensor, off: Offset) -> torch.Tensor:
    """``out[x] = t[x + off]`` along one trailing axis, zero fill -- a slice
    plus an edge pad, never a wrap-around roll.  ``off`` indexes the
    (i, j, k) axes as the trailing three dims (k-only specs use only the
    last); the single nonzero component may have any magnitude up to the
    spec radius."""
    (idx, d), = [(i, o) for i, o in enumerate(off) if o]
    axis = t.dim() - 3 + idx
    k = abs(d)
    n = t.shape[axis]
    out = torch.zeros_like(t)
    if k >= n:
        return out
    if d > 0:
        out.narrow(axis, 0, n - k).copy_(t.narrow(axis, k, n - k))
    else:
        out.narrow(axis, k, n - k).copy_(t.narrow(axis, 0, n - k))
    return out


def execute_plan(cplan: StencilPlan, u: torch.Tensor,
                 w: torch.Tensor, shift=shift_slice) -> torch.Tensor:
    """Interpret the plan on whole tensors.  ``u`` must already carry the
    accumulation dtype; ``w`` is the canonical flat weight vector in the
    same dtype.

    The plan's ``unroll`` factor is not realized: the reference splits the
    trailing axis into ``unroll`` chunks for the arithmetic, and slicing
    commutes with elementwise arithmetic, so the unchunked walk computes
    the same per-element op sequence.
    """
    if cplan.out < 0:
        return torch.zeros_like(u)
    last_use: Dict[int, int] = {}
    for i, op in enumerate(cplan.ops):
        for v in op_sources(op):
            last_use[v] = i
    vals: List[Optional[torch.Tensor]] = [u]
    for i, op in enumerate(cplan.ops):
        if op.kind == "shift":
            v = shift(vals[op.a], op.off)
        elif op.kind == "scale":
            v = w[op.w_idx] * vals[op.a]
        elif op.kind == "add":
            v = vals[op.a] + vals[op.b]
        else:                                     # fma
            v = vals[op.b] + w[op.w_idx] * vals[op.a]
        vals.append(v)
        for src in op_sources(op):                # free dead values: on the
            if last_use[src] == i and src != cplan.out:   # card a value is a
                vals[src] = None                  # whole field
    return vals[cplan.out]
