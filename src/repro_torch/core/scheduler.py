"""Greedy list scheduler (paper sect. 4.4).

It behaves as an infinite-lookahead, greedy out-of-order PPC450: each cycle
it tries to start one instruction on the FPU and one on the LSU (plus one IU
op), picking among ready instructions by longest-path-to-sink priority, then
by instruction index.  The emitted order is what the in-order hardware
executes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .dag import Dag, build_dag, lower_bound, path_to_sink
from .isa import Instr, Unit


@dataclasses.dataclass
class Schedule:
    order: List[int]               # instruction indices in issue order
    issue_cycle: Dict[int, int]    # index -> cycle issued
    makespan: int                  # cycles to issue all instructions
    lower_bound: int

    @property
    def optimal(self) -> bool:
        return self.makespan == self.lower_bound


def _ready_time(g: Dag, issue: Dict[int, int], n: int) -> int:
    return max((issue[p] + w for p, w in g.pred[n].items() if p in issue),
               default=0)


def greedy_schedule(instrs: List[Instr], g: Optional[Dag] = None) -> Schedule:
    if g is None:
        g = build_dag(instrs)
    prio = path_to_sink(g)
    unscheduled = set(range(len(instrs)))
    issue: Dict[int, int] = {}
    order: List[int] = []
    pending_preds = {n: set(g.pred[n]) for n in g.nodes}
    lsu_free_at = 0
    cycle = 0
    guard = 0
    while unscheduled:
        guard += 1
        if guard > 100 * len(instrs) + 1000:  # pragma: no cover
            raise RuntimeError("scheduler livelock")
        ready = [n for n in unscheduled
                 if not (pending_preds[n] - issue.keys())
                 and _ready_time(g, issue, n) <= cycle]
        ready.sort(key=lambda n: (-prio[n], n))
        fpu_used = iu_used = False
        lsu_used = lsu_free_at > cycle
        for n in ready:
            u = instrs[n].unit
            if u is Unit.FPU and not fpu_used:
                fpu_used = True
            elif u is Unit.LSU and not lsu_used:
                lsu_used = True
                lsu_free_at = cycle + 2
            elif u is Unit.IU and not iu_used:
                iu_used = True
            else:
                continue
            issue[n] = cycle
            order.append(n)
            unscheduled.discard(n)
        cycle += 1
    makespan = (max(issue[n] + instrs[n].issue_cycles for n in issue)
                if issue else 0)
    return Schedule(order, issue, makespan, lower_bound(instrs, g))
