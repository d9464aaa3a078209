"""Rewrite passes: the plan compiler as an explicit pass pipeline.

This is the paper's synthesis step (sect. 4: emit the kernel as a factored
instruction schedule, not N independent multiply-adds) restructured
xdsl-style: :func:`~.compile_plan` runs an ordered list of passes, each a
``StencilPlan -> StencilPlan`` rewrite that either improves the schedule or
returns its input unchanged, and each unit-testable on op-count / liveness
invariants.  The passes:

``build_direct`` (the mandatory first pass)
    Emits the naive schedule from the spec -- one shift per nonzero offset
    component per tap, one multiply-add per tap, in the spec's lexicographic
    order (54 shifts + 53 flop-ops for stencil27; kept alone as the
    ``direct`` parity escape hatch).

``cse``
    Rewrites to the common-subexpression-eliminated schedule for *arbitrary*
    masks: taps are grouped by ``(dj, dk)`` so each trailing-plane shift is
    built once (j-shifts of ``u`` are themselves shared across ``dk``) and
    reused across ``di``; per-``di`` partial sums are shifted once along i
    at the end (10 shifts + 53 flop-ops for stencil27).  Never emits more
    shifts or flops than the direct schedule.

``mirror_factor``
    The paper's partial-sum factorization, generalized to per-axis
    ``|d|``-symmetry at any radius: for specs closed under per-axis sign
    flips with weights depending only on ``(|di|, |dj|, |dk|)``,
    k-neighbour pair sums per distance are built once, reused across j,
    then across i -- 8 shifts + 19 flop-ops for stencil27, 12 + 19 for the
    radius-2 star13, 20 + 63 for box125.  A no-op on asymmetric specs.

``unroll[k]``
    Records an innermost-sweep unroll factor ``k`` in the plan IR -- the
    paper's register-level unroll (sect. 4.2, the 1xU / 2xU
    configurations); the plan's modeled cost depends on it, its arithmetic
    does not.  Inserted by the
    cost-driven compiler when the modeled PPC450 schedule says breaking the
    latency-5 FPU dependence chain pays for the extra live values.

``order_ops``
    Pure reordering: builds the plan's SSA dependence DAG (shift ops on
    the LSU, arithmetic on the FPU) and list-schedules it greedily for
    minimal live-value count, reusing the core scheduler's priority logic
    -- ``core.dag.path_to_sink``, the longest-path-to-sink priority
    ``greedy_schedule`` issues by (paper sect. 4.4) -- as the tie-break
    among pressure-equal ready ops.  The register-pressure constraint
    recast as the executor's live-value working set: the reordered
    schedule is kept only when its :func:`~.ir.peak_live` does not exceed
    the input's, so the pass *provably never increases* peak SSA
    liveness; op multiset, dataflow, and therefore arithmetic are
    unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..spec import StencilSpec
from .ir import Builder, PlanOp, StencilPlan, op_sources, peak_live, renumber

PassFn = Callable[[StencilPlan], StencilPlan]


def mirror_symmetric(spec: StencilSpec) -> bool:
    """True when the tap set is closed under per-axis sign flips and the
    weight index depends only on ``(|di|, |dj|, |dk|)`` -- the condition for
    the factored partial-sum schedule to be exact (any radius)."""
    wmap = dict(zip(spec.offsets, spec.w_index))
    for (di, dj, dk), wi in wmap.items():
        for si in ((1, -1) if di else (1,)):
            for sj in ((1, -1) if dj else (1,)):
                for sk in ((1, -1) if dk else (1,)):
                    if wmap.get((di * si, dj * sj, dk * sk)) != wi:
                        return False
    return True


def _mark(plan: StencilPlan, pass_name: str, kind: Optional[str] = None,
          ops: Optional[Tuple[PlanOp, ...]] = None,
          out: Optional[int] = None) -> StencilPlan:
    return dataclasses.replace(
        plan,
        kind=plan.kind if kind is None else kind,
        ops=plan.ops if ops is None else ops,
        out=plan.out if out is None else out,
        passes=plan.passes + (pass_name,))


def build_direct(spec: StencilSpec) -> StencilPlan:
    """Seed pass: the naive schedule, one shift per nonzero offset component
    per tap (a radius-2 component is one magnitude-2 shift), one
    multiply-add per tap, in the spec's lexicographic order (the seed
    engine's arithmetic)."""
    b = Builder()
    acc = None
    for off, wi in zip(spec.offsets, spec.w_index):
        t = 0
        for axis, d in enumerate(off):
            if d:
                t = b.shift(t, axis, d)
        acc = b.acc(wi, t, acc)
    return StencilPlan(spec=spec, kind="direct", ops=tuple(b.ops),
                       out=-1 if acc is None else acc,
                       passes=("build_direct",))


def cse(plan: StencilPlan) -> StencilPlan:
    """Grouped schedule: one shift per distinct ``(dj, dk)`` plane (j-shifts
    of ``u`` shared across dk), reused across ``di``; per-``di`` partial sums
    are shifted along i once at the end.  A single-tap ``di`` group would
    shift a bare product, so its scale is hoisted past the i-shift (same op
    counts -- see the :mod:`.ir` determinism invariant).  Offsets of any
    magnitude (radius-R) shift once by their full distance."""
    spec = plan.spec
    if not spec.offsets:
        return _mark(plan, "cse", kind="cse")
    var = spec.coef == "var"
    b = Builder()
    by_di: Dict[int, List[Tuple[int, int, int]]] = {}
    for (di, dj, dk), wi in zip(spec.offsets, spec.w_index):
        by_di.setdefault(di, []).append((dj, dk, wi))
    jshift: Dict[int, int] = {0: 0}
    plane: Dict[Tuple[int, int], int] = {}
    for dj, dk in sorted({(dj, dk) for g in by_di.values()
                          for dj, dk, _ in g}):
        if dj not in jshift:
            jshift[dj] = b.shift(0, 1, dj)
        plane[(dj, dk)] = (b.shift(jshift[dj], 2, dk) if dk
                           else jshift[dj])
    out = None
    for di in sorted(by_di):
        group = sorted(by_di[di])
        if di and (len(group) == 1 or var):
            # Variable coefficients are evaluated at the *output* point, so
            # a scaled partial sum must never be shifted: keep each tap's
            # i-shift on the unweighted plane and scale at the output (the
            # same hoist a single-tap group always used).
            for dj, dk, wi in group:
                out = b.acc(wi, b.shift(plane[(dj, dk)], 0, di), out)
            continue
        acc = None
        for dj, dk, wi in group:
            acc = b.acc(wi, plane[(dj, dk)], acc)
        term = b.shift(acc, 0, di) if di else acc
        out = term if out is None else b.add(out, term)
    return _mark(plan, "cse", kind="cse", ops=tuple(b.ops), out=out)


def mirror_factor(plan: StencilPlan) -> StencilPlan:
    """Partial-sum schedule for mirror-symmetric specs, per-axis at any
    radius: k-pair sums per distance swept once, reused across j (j-pair
    sums per distance), combined per ``|di|`` class, then reused across i --
    the paper's factored 27-point kernel as a rewrite.  A no-op on
    asymmetric specs (use inside ``auto`` pipelines); raising on misuse is
    the caller's job."""
    spec = plan.spec
    if not spec.offsets or not mirror_symmetric(spec):
        return plan
    var = spec.coef == "var"
    b = Builder()
    classes: Dict[Tuple[int, int, int], int] = {}
    for off, wi in zip(spec.offsets, spec.w_index):
        classes[(abs(off[0]), abs(off[1]), abs(off[2]))] = wi
    k_sum: Dict[int, int] = {}
    for c in sorted({c for _, _, c in classes}):
        k_sum[c] = 0 if c == 0 else b.add(b.shift(0, 2, -c),
                                          b.shift(0, 2, c))
    j_sum: Dict[Tuple[int, int], int] = {}
    for bb, c in sorted({(bb, c) for _, bb, c in classes}):
        j_sum[(bb, c)] = (k_sum[c] if bb == 0
                          else b.add(b.shift(k_sum[c], 1, -bb),
                                     b.shift(k_sum[c], 1, bb)))
    out = None
    for a in sorted({aa for aa, _, _ in classes}):
        group = sorted((bb, c) for aa, bb, c in classes if aa == a)
        if a == 0:
            acc = None
            for bb, c in group:
                acc = b.acc(classes[(0, bb, c)], j_sum[(bb, c)], acc)
            out = acc
        elif len(group) == 1 or var:
            # A single |di|=a class would shift a bare product; hoist the
            # scale past the i-pair sum (same op counts -- determinism
            # invariant).  Variable-coefficient specs take this branch for
            # *every* class -- the partial factoring: the unweighted k- and
            # j-pair sums stay shared (pure shifts of u), each class gets
            # its own i-pair sum, and the per-point weight lands at the
            # output, where the coefficient field is evaluated.
            for bb, c in group:
                pair = b.add(b.shift(j_sum[(bb, c)], 0, -a),
                             b.shift(j_sum[(bb, c)], 0, a))
                out = b.acc(classes[(a, bb, c)], pair, out)
        else:
            acc = None
            for bb, c in group:
                acc = b.acc(classes[(a, bb, c)], j_sum[(bb, c)], acc)
            pair = b.add(b.shift(acc, 0, -a), b.shift(acc, 0, a))
            out = pair if out is None else b.add(out, pair)
    return _mark(plan, "mirror_factor", kind="factored", ops=tuple(b.ops),
                 out=out)


def unroll(plan: StencilPlan, factor: int) -> StencilPlan:
    """Record an innermost-sweep unroll factor in the plan IR.

    The paper's register-level unroll (sect. 4.2) recorded in the IR --
    the knob the cost model turns to break the latency-5 FPU dependence
    chain.  ``factor=1`` is the identity (no marker recorded); the op list
    itself is untouched either way, so every op-count/liveness invariant
    is preserved by construction.
    """
    if factor < 1:
        raise ValueError(f"unroll factor must be >= 1, got {factor}")
    if factor == 1:
        return plan
    return dataclasses.replace(plan, unroll=factor,
                               passes=plan.passes + (f"unroll[{factor}]",))


def preset_with_unroll(kind: str, factor: int) -> Tuple[str, ...]:
    """The ``PASS_PRESETS[kind]`` pass list with ``unroll[factor]`` spliced
    in (before the trailing ``order_ops`` so the liveness-ordering pass
    stays last; a factor of 1 leaves the preset untouched)."""
    names = PASS_PRESETS[kind]
    if factor <= 1:
        return names
    tag = f"unroll[{factor}]"
    if names and names[-1] == "order_ops":
        return names[:-1] + (tag, "order_ops")
    return names + (tag,)


def order_ops(plan: StencilPlan) -> StencilPlan:
    """Reorder the schedule for minimal live-value count, keeping the
    result only when peak SSA liveness does not grow.

    The plan's ops become a symbolic instruction block (shift -> LSU,
    arithmetic -> FPU, SSA value ``v{id}`` registers), the dependence DAG
    is the pure-RAW SSA graph, and a greedy list scheduler emits, each
    step, the ready op that retires the most live values -- breaking ties
    by the core scheduler's priority logic, ``path_to_sink`` (the
    longest-path-to-sink priority ``core.scheduler.greedy_schedule``
    issues by, paper sect. 4.4).  The emitted order is always a valid
    topological order, so dataflow (and hence arithmetic, bit-for-bit
    under a fixed executor) is unchanged; only the live-value working set
    can move, and the guard makes "never worse" unconditional.
    """
    if len(plan.ops) <= 1:
        return _mark(plan, "order_ops")
    from ....core.dag import build_dag, path_to_sink
    from ....core.isa import Instr, Unit
    instrs = [Instr(op.kind,
                    Unit.LSU if op.kind == "shift" else Unit.FPU,
                    f"v{i + 1}",
                    tuple(f"v{v}" for v in op_sources(op)))
              for i, op in enumerate(plan.ops)]
    g = build_dag(instrs)                      # pure RAW on SSA values
    prio = path_to_sink(g)                     # the scheduler's priority
    uses: Dict[int, int] = {}                  # value id -> remaining uses
    for op in plan.ops:
        for v in op_sources(op):
            uses[v] = uses.get(v, 0) + 1
    if plan.out >= 0:
        uses[plan.out] = uses.get(plan.out, 0) + 1
    pending = {i: set(g.predecessors(i)) for i in range(len(plan.ops))}
    ready = sorted(i for i, p in pending.items() if not p)
    order: List[int] = []
    while ready:
        # Emit the ready op that frees the most live values *now* (its dying
        # sources minus the one value it defines); break ties by the list
        # scheduler's longest-path-to-sink priority, then program order.
        def gain(i: int) -> Tuple[int, int, int]:
            dies = sum(1 for v in set(op_sources(plan.ops[i]))
                       if uses.get(v, 0) == 1)
            return (dies, prio[i], -i)
        nxt = max(ready, key=gain)
        ready.remove(nxt)
        order.append(nxt)
        for v in set(op_sources(plan.ops[nxt])):
            uses[v] -= 1
        for s in g.successors(nxt):
            pending[s].discard(nxt)
            if not pending[s]:
                ready.append(s)
    ops, out = renumber(list(plan.ops), order, plan.out)
    cand = dataclasses.replace(plan, ops=ops, out=out)
    if peak_live(cand) <= peak_live(plan):
        return _mark(cand, "order_ops")
    return _mark(plan, "order_ops[kept-original]")


# Pass-list presets: the former monolithic plan kinds, now pipelines.  The
# ``direct`` preset stays untouched-naive (the parity escape hatch); the
# optimizing presets end with the liveness-ordering pass.
PASS_PRESETS: Dict[str, Tuple[str, ...]] = {
    "direct": ("build_direct",),
    "cse": ("build_direct", "cse", "order_ops"),
    "factored": ("build_direct", "mirror_factor", "order_ops"),
}

_PASSES: Dict[str, PassFn] = {
    "cse": cse,
    "mirror_factor": mirror_factor,
    "order_ops": order_ops,
}


def run_passes(spec: StencilSpec, pass_names: Tuple[str, ...]) -> StencilPlan:
    """Run an ordered pass list over ``spec``.  The first pass must be
    ``build_direct`` (the seed); every subsequent name indexes a
    ``StencilPlan -> StencilPlan`` rewrite.  The parametrized spelling
    ``unroll[k]`` records an unroll factor ``k`` (see :func:`unroll`)."""
    if not pass_names or pass_names[0] != "build_direct":
        raise ValueError(f"pass list must start with 'build_direct', got "
                         f"{pass_names!r}")
    plan = build_direct(spec)
    for name in pass_names[1:]:
        if name.startswith("unroll[") and name.endswith("]"):
            try:
                factor = int(name[len("unroll["):-1])
            except ValueError:
                raise ValueError(f"bad unroll factor in pass name {name!r}")
            plan = unroll(plan, factor)
            continue
        if name not in _PASSES:
            raise ValueError(f"unknown pass {name!r}; available: "
                             f"{sorted(_PASSES) + ['unroll[<k>]']}")
        plan = _PASSES[name](plan)
    return plan
