"""Static task-graph capture for PTG taskpools.

The port of :mod:`parsec_tpu.dsl.graph`.  The dynamic runtime never
materialises the whole DAG — it is implicit in each task's dependency
expressions.  :func:`capture` evaluates them once for every task and
returns the explicit graph the native engine
(:mod:`parsec_tpu_torch.dsl.native_exec`) executes: nodes with their
priorities, predecessor counts and successor edges, each flow's input
source, and the final write-backs.

Capture cost is O(tasks + edges) expression evaluations.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..core.lifecycle import AccessMode
from .ptg import (
    PTGTaskpool,
    _DataRef,
    _NewRef,
    _NoneRef,
    _expand_args,
)

TaskId = Tuple[str, Tuple]  # (class name, locals)


class TaskNode:
    __slots__ = ("tid", "priority", "rank", "in_edges", "out_edges",
                 "flow_sources", "write_backs", "remote_out")

    def __init__(self, tid: TaskId, priority: int, rank: int):
        self.tid = tid
        self.priority = priority
        self.rank = rank
        #: flow name -> ("data", collection_name, key) | ("task", producer
        #: tid, producer flow) | ("new",) | None
        self.flow_sources: Dict[str, Optional[Tuple]] = {}
        #: (flow name, collection name, key) final write-backs
        self.write_backs: List[Tuple[str, str, Tuple]] = []
        #: edges as (my flow, successor tid, successor flow)
        self.out_edges: List[Tuple[str, TaskId, str]] = []
        #: predecessor count (dependency goal)
        self.in_edges: int = 0
        #: successor edges leaving a rank-filtered capture (valid tasks
        #: placed on OTHER ranks), invisible in ``out_edges``
        self.remote_out: int = 0


class TaskGraph:
    def __init__(self, tp: PTGTaskpool):
        self.taskpool = tp
        self.nodes: Dict[TaskId, TaskNode] = {}
        #: every valid task's rank (the global placement map), filled by
        #: :func:`capture`'s first pass
        self.global_ranks: Dict[TaskId, int] = {}

    def successors(self, tid: TaskId) -> List[TaskId]:
        return [s for (_f, s, _sf) in self.nodes[tid].out_edges]


def find_cycle(g: TaskGraph) -> List[TaskId]:
    """One concrete dependency cycle of the captured DAG, or ``[]`` when
    the graph is acyclic.  Runs Kahn first (cheap), then walks the
    leftover subgraph — every node surviving peeling sits on or behind a
    cycle, so walking predecessors from any of them must close one."""
    indeg = {tid: n.in_edges for tid, n in g.nodes.items()}
    frontier = [tid for tid, d in indeg.items() if d == 0]
    while frontier:
        tid = frontier.pop()
        for (_f, succ, _sf) in g.nodes[tid].out_edges:
            indeg[succ] -= 1
            if indeg[succ] == 0:
                frontier.append(succ)
    stuck = {tid for tid, d in indeg.items() if d > 0}
    if not stuck:
        return []
    # every stuck node has at least one stuck PREDECESSOR (its residual
    # in-degree comes from an unpeeled producer), so walking predecessors
    # always closes a cycle — stuck SUCCESSORS need not exist
    pred: Dict[TaskId, TaskId] = {}
    for tid in stuck:
        for (_f, succ, _sf) in g.nodes[tid].out_edges:
            if succ in stuck and succ not in pred:
                pred[succ] = tid
    path: List[TaskId] = []
    on_path: Dict[TaskId, int] = {}
    tid = min(stuck)  # deterministic pick
    while tid not in on_path:
        on_path[tid] = len(path)
        path.append(tid)
        tid = pred[tid]
    cycle = path[on_path[tid]:]
    cycle.reverse()  # predecessor walk found it backwards
    return cycle


def capture(tp: PTGTaskpool, ranks: Optional[Iterable[int]] = None) -> TaskGraph:
    """Evaluate every task's dependency expressions and materialise the DAG.

    ``ranks=None`` captures all tasks; otherwise only tasks whose affinity
    maps into ``ranks`` (matching each rank's local view).
    """
    g = TaskGraph(tp)
    consts = tp.constants
    rankset = set(ranks) if ranks is not None else None

    # pass 1: nodes, and the global placement map (every valid task's rank)
    for pc in tp.ptg.classes.values():
        for loc in pc.param_space(consts):
            rank = pc.rank_of(loc, consts)
            g.global_ranks[(pc.name, loc)] = rank
            if rankset is not None and rank not in rankset:
                continue
            tid = (pc.name, loc)
            g.nodes[tid] = TaskNode(tid, pc.priority_of(loc, consts), rank)

    # pass 2: edges + sources (driven from each node's own deps)
    for tid, node in g.nodes.items():
        pc = tp.ptg.classes[tid[0]]
        loc = tid[1]
        env = pc.env_of(loc, consts)
        for f in pc.flows:
            # input source
            src = pc.active_input(f, env)
            if src is None or isinstance(src, _NoneRef):
                node.flow_sources[f.name] = ("new",) if (f.mode & AccessMode.OUT) else None
            elif isinstance(src, _NewRef):
                node.flow_sources[f.name] = ("new",)
            elif isinstance(src, _DataRef):
                node.flow_sources[f.name] = ("data", src.collection_name, src.key(env))
            else:  # _TaskRef
                key = tuple(a.scalar(env) for a in src.args)
                if (src.class_name, key) not in g.global_ranks:
                    # out-of-range producer reference: the input does not
                    # exist (reference complex_deps off-diagonal corner)
                    node.flow_sources[f.name] = \
                        ("new",) if (f.mode & AccessMode.OUT) else None
                else:
                    node.flow_sources[f.name] = (
                        "task", (src.class_name, key), src.flow_name)
            # output edges
            for dep in f.deps_out:
                t = dep.target(env)
                if t is None or isinstance(t, (_NoneRef, _NewRef)):
                    continue
                if isinstance(t, _DataRef):
                    node.write_backs.append((f.name, t.collection_name, t.key(env)))
                    continue
                succ_pc = tp.ptg.classes[t.class_name]
                for locs in _expand_args(t.args, env):
                    if len(locs) != len(succ_pc.param_names):
                        continue
                    # membership in g.nodes subsumes valid(): pass 1
                    # built the node set FROM the class param spaces
                    stid = (t.class_name, locs)
                    if stid in g.nodes:
                        node.out_edges.append((f.name, stid, t.flow_name))
                    elif stid in g.global_ranks:
                        node.remote_out += 1

    # pass 3: in-degrees tallied from the captured edges (a rank-filtered
    # capture must count only edges whose producer is in the capture)
    for node in g.nodes.values():
        for (_f, succ, _sf) in node.out_edges:
            g.nodes[succ].in_edges += 1
    return g


def source_tile(g: TaskGraph, tid: TaskId, flow_name: str):
    """Follow a flow's input chain to its ultimate memory source.

    Returns ``("data", collection_name, key)``, ``("new", producer_tid,
    flow)`` — the identity that aliases across the producer/consumer
    chain (PTG flows thread one datum through in-place bodies) — or
    ``("remote", producer_tid, flow)`` when the chain leaves a
    rank-filtered capture.

    Memoized with path compression on the graph (long dpotrf-style
    chains are walked once, not once per consumer); callers resolve
    sources only AFTER capture completes.
    """
    memo = g.__dict__.setdefault("_src_memo", {})
    key = (tid, flow_name)
    hit = memo.get(key)
    if hit is not None:
        return hit
    seen = set()
    path = []
    cur, cflow = tid, flow_name
    while True:
        if (cur, cflow) in seen:
            raise RuntimeError(f"cyclic flow chain at {cur}/{cflow}")
        seen.add((cur, cflow))
        path.append((cur, cflow))
        hit = memo.get((cur, cflow))
        if hit is not None:
            break
        src = g.nodes[cur].flow_sources.get(cflow)
        if src is None or src[0] == "new":
            hit = ("new", cur, cflow)
            break
        if src[0] == "data":
            hit = src
            break
        _, ptid, pflow = src
        if ptid not in g.nodes:
            hit = ("remote", ptid, pflow)
            break
        cur, cflow = ptid, pflow
    for k in path:
        memo[k] = hit
    return hit
