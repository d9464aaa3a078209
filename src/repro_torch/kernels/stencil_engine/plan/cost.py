"""Plan cost model: lower a :class:`~.ir.StencilPlan` onto the core PPC450
machine model and estimate cycles/point.

This closes the paper's loop (synthesize -> schedule -> simulate -> select)
for the engine's plan compiler: each candidate ``(pass_list, unroll)``
variant is lowered to a symbolic PPC450 instruction block -- shift ops become
LSU quad loads (L1 latency 4, one issue per 2 cycles), arithmetic becomes FPU
ops (latency 5, one per cycle), constant weights live in registers, variable
coefficients add one weight-plane load per point -- and costed exactly the way
``core.perfmodel.analyze`` costs the paper's synthesized kernels: greedy
list-schedule over the renamed (RAW-only) dependence DAG, then, for blocks
small enough, an in-order pipeline replay (``core.simulator``) whose
steady-state cycles/iteration is the estimate.  Unrolling replicates the
block per point with disjoint registers, which is what lets the scheduler
interleave independent chains across the latency-5 FPU pipe -- the paper's
sect. 4.2 effect, reproduced on the plan IR.

The absolute numbers are PPC450 cycles for one SIMD lane pair; the compiler
only consumes them *relatively*, to rank variants of the same spec.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ....core.dag import build_dag
from ....core.isa import (NUM_FPRS, Instr, fpadd, fpmadd, fxcpmul, lfpdx,
                          stfpdx)
from ....core.scheduler import greedy_schedule
from ....core.simulator import simulate_inorder
from .ir import StencilPlan

# Blocks at or below this instruction count get the in-order pipeline replay
# (the paper's simulator); larger blocks keep the scheduler's makespan.  All
# radius-1 builtin variants fall below it, so the fidelity tests can pin the
# estimate to ``core.simulator`` output exactly.
SIM_INSTR_LIMIT = 320

SIM_ITERS = 12


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Modeled cost of one (plan, unroll) variant -- frozen/hashable so it
    can ride inside a :class:`~.ir.StencilPlan` as a cache key."""

    cycles_per_point: float       # the selection metric
    makespan: int                 # greedy-schedule issue span of the block
    lower_bound: int              # paper eq. (1): max(CP, 2|LSU|, |FPU|)
    n_instrs: int                 # block size after unrolling
    unroll: int
    source: str                   # "simulator" (in-order replay) | "scheduler"


def lower_plan(plan: StencilPlan, unroll: int = 1) -> List[Instr]:
    """Lower a plan to a symbolic PPC450 instruction block for one unrolled
    iteration (``unroll`` output points).

    Per copy ``q``: the input value is one quad load; every ``shift`` is a
    quad load from the input stream (a shift of a *computed* value keeps a
    register dependence on it -- spill + shifted reload); ``scale``/``add``/
    ``fma`` map to their FPU instructions; the output is one quad store.
    Constant weights are register-resident (the paper keeps them in FPRs for
    the whole sweep); variable coefficients cost one weight-plane load per
    (weight, point) -- the extra streaming traffic the var path pays.
    """
    var = plan.spec.coef == "var"
    instrs: List[Instr] = []
    slot = 0

    def load(dest: str, space: str, deps: tuple = ()) -> None:
        nonlocal slot
        base = {"A": "gA", "W": "gW"}[space]
        ins = lfpdx(dest, base, 16 * slot, space=space)
        if deps:
            ins = dataclasses.replace(ins, srcs=ins.srcs + deps)
        instrs.append(ins)
        slot += 1

    for q in range(unroll):
        def reg(vid: int) -> str:
            return f"v{vid}q{q}"

        uses = {0} if plan.out == 0 else set()
        for op in plan.ops:
            uses.add(op.a)
            if op.b >= 0:
                uses.add(op.b)
        if 0 in uses:
            load(reg(0), "A")
        wregs = {}
        for op in plan.ops:
            if op.w_idx >= 0:
                if var:
                    if op.w_idx not in wregs:
                        wr = f"w{op.w_idx}q{q}"
                        load(wr, "W")
                        wregs[op.w_idx] = wr
                else:
                    wregs.setdefault(op.w_idx, f"w{op.w_idx}")
        for i, op in enumerate(plan.ops):
            dest = reg(i + 1)
            if op.kind == "shift":
                load(dest, "A", deps=() if op.a == 0 else (reg(op.a),))
            elif op.kind == "scale":
                instrs.append(fxcpmul(dest, wregs[op.w_idx], reg(op.a)))
            elif op.kind == "add":
                instrs.append(fpadd(dest, reg(op.a), reg(op.b)))
            else:                                 # fma: b + w * a
                instrs.append(fpmadd(dest, wregs[op.w_idx], reg(op.a),
                                     reg(op.b)))
        if plan.out >= 0:
            instrs.append(stfpdx(reg(plan.out), "gR", 16 * q, space="R"))
    return instrs


def fits_registers(plan: StencilPlan, unroll: int) -> bool:
    """Paper-style register-file guard for an unroll candidate.

    Each unrolled copy carries ``peak_live`` SSA values; constant weights
    stay resident (``n_weights`` FPRs shared by every copy), variable
    coefficients keep roughly one in-flight weight register per copy.  A
    candidate that cannot fit the ``NUM_FPRS`` file is not enumerated --
    e.g. box125's 27 resident weights pin it to ``unroll=1``.
    """
    if plan.spec.coef == "var":
        need = (plan.peak_live + 1) * unroll
    else:
        need = plan.peak_live * unroll + plan.spec.n_weights
    return need <= NUM_FPRS


def estimate_plan(plan: StencilPlan, unroll: Optional[int] = None) -> PlanCost:
    """Modeled cycles/point for one plan variant.

    The block is scheduled exactly the way ``core.perfmodel.analyze`` costs
    the paper's kernels -- greedy list schedule over the register-renamed
    (RAW-only) DAG -- and, when it fits ``SIM_INSTR_LIMIT``, replayed
    through the in-order pipeline simulator for the steady-state
    cycles/iteration; ``cycles_per_point`` divides by the unroll factor
    (one output point per unrolled copy).
    """
    u = plan.unroll if unroll is None else unroll
    instrs = lower_plan(plan, u)
    if not instrs:
        return PlanCost(0.0, 0, 0, 0, u, "scheduler")
    sched = greedy_schedule(instrs, build_dag(instrs, war=False))
    if len(instrs) <= SIM_INSTR_LIMIT:
        ordered = [instrs[i] for i in sched.order]
        timing = simulate_inorder(ordered, n_iters=SIM_ITERS)
        return PlanCost(timing.per_iter_cycles / u, sched.makespan,
                        sched.lower_bound, len(instrs), u, "simulator")
    return PlanCost(sched.makespan / u, sched.makespan, sched.lower_bound,
                    len(instrs), u, "scheduler")
