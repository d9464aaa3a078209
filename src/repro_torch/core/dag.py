"""Dependency-DAG construction for PPC450 instruction blocks (paper sect. 3.3).

Nodes are instruction indices; a RAW edge i->j is weighted with the
producer's result latency, WAR/WAW edges carry weight 1 (the paper's
convention).  Memory dependencies are tracked symbolically by (alias-space,
base GPR version, byte range); distinct alias spaces never conflict.

The graph is plain dicts (``succ[u][v] = weight``, ``pred[v][u] = weight``)
rather than a graph library.  Every analysis here -- longest paths to a sink
or from a source -- is order-independent over topological orders, and the
schedulers that consume it break every tie by priority then node index, so
the results equal those of any other valid graph representation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .isa import Instr, Unit


@dataclasses.dataclass
class Dag:
    instrs: List[Instr]
    succ: Dict[int, Dict[int, int]]
    pred: Dict[int, Dict[int, int]]

    @property
    def nodes(self) -> range:
        return range(len(self.instrs))

    def successors(self, n: int):
        return iter(self.succ[n])

    def predecessors(self, n: int):
        return iter(self.pred[n])

    def add_edge(self, u: int, v: int, w: int) -> None:
        if u == v:
            return
        old = self.succ[u].get(v)
        if old is None or old < w:
            self.succ[u][v] = w
            self.pred[v][u] = w


def topological_order(g: Dag) -> List[int]:
    """Kahn's algorithm over node indices (smallest ready index first)."""
    indeg = {n: len(g.pred[n]) for n in g.nodes}
    ready = [n for n in g.nodes if indeg[n] == 0]
    order: List[int] = []
    while ready:
        n = ready.pop()
        order.append(n)
        for s in g.succ[n]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(order) != len(g.instrs):
        raise ValueError("dependency graph has a cycle")
    return order


def build_dag(instrs: List[Instr], war: bool = True) -> Dag:
    """Build the dependency DAG.

    ``war=True`` (default) emits WAR/WAW edges (weight 1, the paper's eq. 5
    convention); ``war=False`` models the paper's infinite-lookahead
    out-of-order simulator (implicit register renaming), keeping only true
    (RAW) and memory dependencies.
    """
    g = Dag(list(instrs), {i: {} for i in range(len(instrs))},
            {i: {} for i in range(len(instrs))})
    last_writer: Dict[str, int] = {}
    readers_since_write: Dict[str, List[int]] = {}
    gpr_version: Dict[str, int] = {}
    mem_ops: List[Tuple[int, str, str, int, int, int, bool]] = []

    for j, ins in enumerate(instrs):
        for r in ins.srcs:                                   # register RAW
            if r in last_writer:
                i = last_writer[r]
                g.add_edge(i, j, max(1, instrs[i].latency))
            readers_since_write.setdefault(r, []).append(j)
        if ins.dest is not None:                             # WAR / WAW
            if war:
                for rdr in readers_since_write.get(ins.dest, []):
                    g.add_edge(rdr, j, 1)
                if ins.dest in last_writer:
                    g.add_edge(last_writer[ins.dest], j, 1)
            last_writer[ins.dest] = j
            readers_since_write[ins.dest] = ([j] if ins.dest in ins.srcs
                                             else [])
        if ins.mem is not None:                              # memory deps
            m = ins.mem
            ver = gpr_version.get(m.base, 0)
            lo, hi = m.offset, m.offset + m.size
            for (i, sp, base, v, l2, h2, st2) in mem_ops:
                if sp != m.space:
                    continue
                conflict = (base != m.base or v != ver) or (lo < h2 and l2 < hi)
                if conflict and (m.is_store or st2):
                    g.add_edge(i, j, 1)
            mem_ops.append((j, m.space, m.base, ver, lo, hi, m.is_store))
        if ins.unit is Unit.IU and ins.dest is not None:
            gpr_version[ins.dest] = gpr_version.get(ins.dest, 0) + 1
    return g


def critical_path_length(g: Dag) -> int:
    """Longest weighted path through the DAG, including the final op's
    issue cycles."""
    if not g.instrs:
        return 0
    dist: Dict[int, int] = {}
    for n in topological_order(g):
        dist[n] = max((dist[p] + w for p, w in g.pred[n].items()), default=0)
    return max(dist[n] + g.instrs[n].issue_cycles for n in g.nodes)


def path_to_sink(g: Dag) -> Dict[int, int]:
    """For each node, the longest weighted path from it to any sink."""
    pr: Dict[int, int] = {}
    for n in reversed(topological_order(g)):
        pr[n] = max((w + pr[s] for s, w in g.succ[n].items()),
                    default=g.instrs[n].issue_cycles)
    return pr


def lower_bound(instrs: List[Instr], g: Optional[Dag] = None) -> int:
    """Paper eq. (1): L = max{critical path, 2*|LSU|, |FPU|}."""
    if g is None:
        g = build_dag(instrs)
    n_lsu = sum(1 for i in instrs if i.unit is Unit.LSU)
    n_fpu = sum(1 for i in instrs if i.unit is Unit.FPU)
    return max(critical_path_length(g), 2 * n_lsu, n_fpu)
