"""Cycle-level in-order PPC450 pipeline timing (paper sect. 4.1/4.4).

Replays a (scheduled) instruction stream through an in-order dual-issue
model: at each cycle the next instruction in program order may issue on the
FPU / LSU / IU if its unit is free and its operands are ready; a blocked
instruction stalls everything behind it.  Steady-state cycles/iteration are
measured by replaying the loop body ``n_iters`` times and differencing the
middle iterations.  Loads take the L1 latency (the plan cost model streams
from L1; the reference's stream-aware memory model is not needed here).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .isa import Instr, Unit


@dataclasses.dataclass
class TimingResult:
    total_cycles: int
    per_iter_cycles: float
    stalls: Dict[str, int]
    issue_trace: Optional[List[Tuple[int, int]]] = None  # (instr idx, cycle)


def simulate_inorder(body: List[Instr], n_iters: int = 12,
                     trace: bool = False) -> TimingResult:
    """In-order dual-issue timing simulation of ``body`` repeated
    ``n_iters`` times (readiness times only, no values)."""
    ready: Dict[str, int] = {}
    stalls = {"data": 0, "fpu_busy": 0, "lsu_busy": 0}
    lsu_free = 0
    cycle = 0
    iter_marks: List[int] = []
    issue_trace: List[Tuple[int, int]] = []

    for _ in range(n_iters):
        for bi, ins in enumerate(body):
            t_ready = max((ready.get(r, 0) for r in ins.srcs), default=0)
            t = max(cycle, t_ready)
            if ins.unit is Unit.LSU:
                t = max(t, lsu_free)
            if t > cycle and t > t_ready:
                stalls["lsu_busy" if ins.unit is Unit.LSU
                       else "fpu_busy"] += t - max(cycle, t_ready)
            elif t > cycle:
                stalls["data"] += t - cycle
            lat = ins.latency
            if ins.unit is Unit.LSU:
                lsu_free = t + 2
            if ins.dest is not None:
                ready[ins.dest] = t + max(1, lat)
            if trace:
                issue_trace.append((bi, t))
            cycle = t
            if ins.unit is Unit.FPU:
                ready.setdefault("__fpu__", 0)
                if ready["__fpu__"] > t:
                    stalls["fpu_busy"] += ready["__fpu__"] - t
                    t = ready["__fpu__"]
                    if ins.dest is not None:
                        ready[ins.dest] = t + max(1, lat)
                ready["__fpu__"] = t + 1
                cycle = t
            elif ins.unit is Unit.IU:
                ready.setdefault("__iu__", 0)
                if ready["__iu__"] > t:
                    t = ready["__iu__"]
                    if ins.dest is not None:
                        ready[ins.dest] = t + max(1, lat)
                ready["__iu__"] = t + 1
                cycle = t
        iter_marks.append(cycle)

    total = max(ready.values()) if ready else 0
    if n_iters >= 6:
        a, b = n_iters // 3, 2 * n_iters // 3
        per_iter = (iter_marks[b] - iter_marks[a]) / (b - a)
    else:
        per_iter = iter_marks[-1] / n_iters
    return TimingResult(total, per_iter, stalls,
                        issue_trace if trace else None)
