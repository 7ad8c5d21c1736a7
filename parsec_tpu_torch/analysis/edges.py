"""Declared-DAG enumeration shared by the static linter and the runtime
checkers.

There is exactly ONE walk of a PTG's declared dependency structure in the
port — :func:`parsec_tpu_torch.dsl.graph.capture` — and this module is
the front door to it (the port of :mod:`parsec_tpu.analysis.edges`): the
static verifier (:mod:`.linter`) and the runtime checkers consume the
same enumeration, so they can never disagree about what the declared
edges are (the reference has the same property: ``iterate_successors`` is
generated once by ``jdf2c`` and every checker calls it).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

from ..dsl.graph import PTGDefinitionView, TaskGraph, capture

TaskId = Tuple[str, Tuple]


def declared_dag(ptg_or_tp, constants: Optional[Dict] = None,
                 ranks: Optional[Iterable[int]] = None) -> TaskGraph:
    """Materialise the declared DAG.

    Accepts either an instantiated ``PTGTaskpool`` (``constants=None``) or
    a bare ``PTG`` definition plus a concrete constants dict — the linter
    verifies definitions without ever constructing a taskpool (no dep
    trackers, repos, or MCA side effects).
    """
    if constants is None:
        return capture(ptg_or_tp, ranks=ranks)
    return capture(PTGDefinitionView(ptg_or_tp, constants), ranks=ranks)


def declared_edge_set(g: TaskGraph) -> Set[Tuple[TaskId, TaskId]]:
    """The (producer tid, consumer tid) pairs of a captured DAG — the
    exact successor set the runtime's release path enumerates."""
    return {(tid, succ)
            for tid, n in g.nodes.items()
            for (_f, succ, _sf) in n.out_edges}


def count_instances(ptg, constants: Dict, cap: int) -> int:
    """Number of task instances over all classes, stopping early once
    ``cap`` is exceeded (returns ``cap + 1`` then) — the linter's guard
    against enumerating production-sized parameter spaces."""
    n = 0
    for pc in ptg.classes.values():
        for _loc in pc.param_space(constants):
            n += 1
            if n > cap:
                return n
    return n


class Reachability:
    """Lazy forward-reachability oracle over a captured DAG: one BFS per
    distinct queried source, memoised as a BITMASK over dense node
    indices (``index``: tid -> 0..V-1, e.g. topological positions) — V
    bits per queried source instead of a frozenset of tids, so even a
    source-heavy hazard pass stays at V^2/8 bytes worst case.  The
    caller bounds the number of distinct sources (see the hazard work
    limit in :mod:`.linter`)."""

    def __init__(self, g: TaskGraph, index: Dict[TaskId, int]):
        self.g = g
        self.index = index
        self._desc: Dict[TaskId, int] = {}

    def reachable(self, a: TaskId, b: TaskId) -> bool:
        if a == b:
            return True
        desc = self._desc.get(a)
        if desc is None:
            desc = 0
            seen = set()
            frontier = [a]
            while frontier:
                nxt = []
                for tid in frontier:
                    for (_f, succ, _sf) in self.g.nodes[tid].out_edges:
                        if succ not in seen:
                            seen.add(succ)
                            desc |= 1 << self.index[succ]
                            nxt.append(succ)
                frontier = nxt
            self._desc[a] = desc
        return (desc >> self.index[b]) & 1 == 1
