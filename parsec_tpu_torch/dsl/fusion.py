"""Supertask fusion: automatic granularity coarsening over the captured
static graph — the middle between per-task dispatch and whole-DAG
capture.

The port of :mod:`parsec_tpu.dsl.fusion`.  Per-task dispatch pays the
scheduler, the device module and staging once a task; a whole-DAG CUDA
graph (:class:`.cuda_graph.GraphExecutor`) pays them once a DAG but gives
all three up.  Fusion keeps them and pays them once a *region*:

* :func:`partition` groups **convex, same-device regions** of the
  captured :class:`~.graph.TaskGraph` into *supertasks* —

  - **linear carry chains**: maximal paths where every interior member
    has exactly ONE distinct successor (the attention ``(g, i)``
    online-softmax chain over ``s``, dpotrf's syrk/gemm chains along
    ``k``).  The single-successor rule makes a chain convex and
    deadlock-free by construction: every path out of the region leaves
    from its last member, so a cycle between regions would be a cycle
    of the DAG;
  - **independent same-class waves**: same class, same dependency level
    (longest path from a source) — level-equal tasks have no path
    between them, so the region is convex and region-to-region edges
    strictly increase levels;

* :class:`FusedPlan` lowers a region to ONE device body over the
  region's boundary tiles: it runs the members' own bodies — hand
  kernels included, through the same wrappers — in order, eagerly, on
  the device module's compute stream, dropping each interior value after
  its last reader.  No region is captured into a CUDA graph: a region's
  digest seldom repeats within one run, and a capture run once costs
  more than it saves;

* the runtimes dispatch each region as ONE device chore: the dynamic
  PTG runtime through a synthetic supertask (``dsl/ptg.py``, built by
  :func:`build_fusion_table` at attach), the native pump as one native
  node whose ``done_batch`` retires its N member tasks
  (``dsl/native_exec.py``).  Edges crossing a region boundary stay
  ordinary runtime dependencies.

MCA knobs (framework ``runtime``):

* ``runtime_fusion`` = ``off`` (default) | ``auto`` | ``chains`` |
  ``waves`` — what the partitioner may fuse;
* ``runtime_fusion_max_tasks`` — the most members a region holds
  (0 = the tuning store's winner for the card, else
  :data:`DEFAULT_HORIZON`);
* ``runtime_fusion_scan`` = ``auto`` | ``off`` | ``on`` — which uniform
  leading chain the reference rolls into one ``lax.scan`` (``auto``
  requires equal member shapes).  The port computes the same segment
  (:attr:`FusedPlan._scan_segments`) but has no scan to roll into: every
  member runs through the same loop, so the knob does not change
  execution.

Unlike the reference, a partitioner failure raises: nothing falls back
to per-task dispatch in silence.  Like every whole-graph consumer,
fusion needs a statically-capturable graph: dynamic guards whose truth
changes while the pool runs must not alter membership.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import tuning
from ..compile_cache import _scrub, body_fingerprint
from ..core.lifecycle import AccessMode, DEV_CPU, HookReturn
from ..core.task import Chore, Flow, Task, TaskClass
from ..data.data import _tile_dtype, torch_dtype
from ..utils import debug, mca_param
from .graph import TaskGraph, source_tile
from .ptg import _NewRef, _accel_hook

CTL = AccessMode.CTL
# plain ints: a flag operation on the IntFlag itself goes through the enum
# machinery, and the partition and the plans test every member flow
_OUT, _INOUT = int(AccessMode.OUT), int(AccessMode.INOUT)

#: the values of ``runtime_fusion``
MODES = ("off", "auto", "chains", "waves")
#: the fusion horizon when ``runtime_fusion_max_tasks`` is 0
DEFAULT_HORIZON = 16
#: the least uniform-chain length run as one member loop under ``auto``
SCAN_MIN = 4

TaskId = Tuple[str, Tuple]

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def fusion_mode() -> str:
    """Resolved ``runtime_fusion`` MCA value."""
    return str(mca_param.register(
        "runtime", "fusion", "off", choices=list(MODES), level=3,
        help="supertask fusion over captured graphs: off | auto (chains "
             "+ waves) | chains | waves"))


def fusion_max_tasks(device=None) -> int:
    """The region-size horizon: ``runtime_fusion_max_tasks``, or when it is
    0 the tuning store's entry for ``device``'s card (op ``fusion``, param
    ``max_tasks``), or :data:`DEFAULT_HORIZON`.  Unlike the reference, a
    failing lookup raises: a corrupt entry already reads as absent."""
    cap = int(mca_param.register(
        "runtime", "fusion_max_tasks", 0, level=3,
        help="max member tasks per fused region (0 = the tuning store's "
             f"entry for the card, else {DEFAULT_HORIZON})"))
    if cap > 0:
        return cap
    return int(tuning.resolve_nb("fusion", 0, "any", device=device, param="max_tasks",
                                 default=DEFAULT_HORIZON))


def fusion_scan_mode() -> str:
    return str(mca_param.register(
        "runtime", "fusion_scan", "auto", choices=["auto", "off", "on"],
        level=5,
        help="run a uniform leading fused chain as one member loop (auto: "
             "only when member shapes are provably equal)"))


def class_fusible(pc) -> bool:
    """Is a PTG task class eligible for fused regions?  It needs an
    accelerator BODY that does not donate its inputs (``_donate_args``: an
    in-place body is called once per task, outside any retry), no custom
    staging hooks and no input-side reshape property blocks: the fused
    body resolves dataflow itself and cannot replay those hooks per
    member."""
    dt = class_device_type(pc)
    if dt is None or pc.stage_hooks \
            or getattr(pc.bodies[dt], "_donate_args", None):
        return False
    for f in pc.flows:
        for dep in f.deps_in:
            if dep.props and not (isinstance(dep.then, _NewRef)
                                  or isinstance(dep.otherwise, _NewRef)):
                return False  # input reshape request: per-task machinery
    return True


def class_device_type(pc) -> Optional[str]:
    for dt in pc.bodies:
        if dt != DEV_CPU:
            return dt
    return None


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

class Region:
    """One fused region: topologically-ordered member task ids."""

    __slots__ = ("index", "kind", "members", "member_set")

    def __init__(self, index: int, kind: str, members: List[TaskId]):
        self.index = index
        self.kind = kind  # "chain" | "wave"
        self.members = list(members)
        self.member_set: Set[TaskId] = set(members)

    def __repr__(self) -> str:
        return (f"Region#{self.index}({self.kind}, {len(self.members)} "
                f"tasks: {self.members[0]}..{self.members[-1]})")


def _distinct_succs(node) -> Set[TaskId]:
    return {s for (_f, s, _sf) in node.out_edges}


def region_source(g: TaskGraph, member_set: Set[TaskId], tid: TaskId,
                  fname: str) -> Tuple:
    """Identity of a member flow's value at the REGION boundary: walk the
    flow chain while it stays inside the region.  Returns
    ``("data", cname, key)`` / ``("new", creator_tid, flow)`` /
    ``("ext", producer_tid, producer_flow)`` — the key that both dedups
    the fused body's slots and resolves to one backing ``Data`` (a PTG
    threads one datum through a flow chain, so equal keys mean equal
    tiles)."""
    cur, cf = tid, fname
    while True:
        src = g.nodes[cur].flow_sources.get(cf)
        if src is None or src[0] == "new":
            return ("new", cur, cf)
        if src[0] == "data":
            return ("data", src[1], tuple(src[2]))
        _, ptid, pflow = src
        if ptid not in member_set:
            return ("ext", ptid, pflow)
        cur, cf = ptid, pflow


def _writeback_safe(g: TaskGraph, classes, members: List[TaskId]) -> int:
    """Longest safe prefix of a candidate chain: a member with a
    write-back must be the LAST region writer of that tile, or the
    dynamic runtime's intermediate write-back would be superseded
    differently than the fused body's final commit."""
    n = len(members)
    while n >= 2:
        pref = members[:n]
        pset = set(pref)
        last_writer: Dict[Tuple, int] = {}
        for mi, tid in enumerate(pref):
            pc = classes[tid[0]]
            for f in pc.flows:
                if f.mode == CTL or not int(f.mode) & _OUT:
                    continue
                last_writer[region_source(g, pset, tid, f.name)] = mi
            for (_fname, cname, wkey) in g.nodes[tid].write_backs:
                last_writer.setdefault(("data", cname, tuple(wkey)), mi)
        bad = None
        for mi, tid in enumerate(pref):
            pc = classes[tid[0]]
            for (fname, _cname, _wkey) in g.nodes[tid].write_backs:
                f = next(fl for fl in pc.flows if fl.name == fname)
                if f.mode == CTL:
                    continue
                key = region_source(g, pset, tid, fname)
                if last_writer.get(key, mi) > mi:
                    bad = mi
                    break
            if bad is not None:
                break
        if bad is None:
            return n
        n = bad + 1 if bad >= 1 else 1
    return max(n, 1)


def _slots_consistent(g: TaskGraph, classes, members: List[TaskId]) -> bool:
    """Reject a candidate region where two DIFFERENT boundary slots alias
    one underlying tile and a member writes it: the fused body reads
    every slot at region entry, so an in-region writer's update would be
    invisible to a member reading the tile through the other slot."""
    pset = set(members)
    by_full: Dict[Tuple, Set[Tuple]] = {}
    writers: Set[Tuple] = set()
    for tid in members:
        pc = classes[tid[0]]
        for f in pc.flows:
            if f.mode == CTL:
                continue
            key = region_source(g, pset, tid, f.name)
            try:
                full = source_tile(g, tid, f.name)
            except RuntimeError:
                return False  # cyclic flow chain: never fuse
            by_full.setdefault(full, set()).add(key)
            if int(f.mode) & _OUT:
                writers.add(full)
    return not any(len(keys) > 1 and full in writers
                   for full, keys in by_full.items())


def partition(g: TaskGraph, classes, *, mode: str, max_tasks: int,
              eligible: Optional[Callable[[str], bool]] = None,
              wave_min: int = 2) -> List[Region]:
    """Partition the captured graph into fused regions (multi-member
    only; unassigned nodes keep per-task dispatch).  ``classes`` is the
    PTG class dict; ``eligible(class_name)`` gates membership (default
    :func:`class_fusible`).  Safe by construction — chains fuse only
    single-distinct-successor interiors, waves only level-equal
    same-class groups — and a contracted-graph cycle check backstops the
    proof: a cycle raises (the reference warns and fuses nothing)."""
    if mode not in MODES:
        raise ValueError(f"fusion mode {mode!r}: expected one of {MODES}")
    if mode == "off" or not g.nodes:
        return []
    if eligible is None:
        eligible = lambda name: class_fusible(classes[name])  # noqa: E731
    elig_memo: Dict[str, bool] = {}

    def ok(tid: TaskId) -> bool:
        e = elig_memo.get(tid[0])
        if e is None:
            e = elig_memo[tid[0]] = bool(eligible(tid[0]))
        return e

    def devtype(tid: TaskId) -> Optional[str]:
        pc = classes.get(tid[0])
        return class_device_type(pc) if pc is not None else None

    max_tasks = max(2, int(max_tasks))
    order = g.topo_order()
    assigned: Set[TaskId] = set()
    regions: List[Region] = []

    if mode in ("auto", "chains"):
        for tid in order:
            if tid in assigned or not ok(tid):
                continue
            chain = [tid]
            cur = tid
            dt0 = devtype(tid)
            rank0 = g.nodes[tid].rank
            while len(chain) < max_tasks:
                node = g.nodes[cur]
                succs = _distinct_succs(node)
                # an interior member has exactly ONE distinct successor
                # GLOBALLY: a forward to another rank buried inside a
                # region would only fire at region completion
                if len(succs) != 1 or node.remote_out:
                    break
                nxt = next(iter(succs))
                if nxt in assigned or not ok(nxt) or devtype(nxt) != dt0 \
                        or g.nodes[nxt].rank != rank0:
                    break
                chain.append(nxt)
                cur = nxt
            chain = chain[:_writeback_safe(g, classes, chain)]
            if len(chain) >= 2 and _slots_consistent(g, classes, chain):
                regions.append(Region(len(regions), "chain", chain))
                assigned.update(chain)

    # waves rest on the LEVEL argument, and levels are computed over the
    # captured edges only: on a rank-filtered capture a remote round trip
    # is invisible and could close a cycle between level-equal tasks, so
    # waves need the full graph (chains stay safe everywhere)
    full_capture = len(g.global_ranks) == len(g.nodes)
    if mode in ("auto", "waves") and full_capture:
        level: Dict[TaskId, int] = {t: 0 for t in order}
        for t in order:
            lt = level[t]
            for (_f, succ, _sf) in g.nodes[t].out_edges:
                if level[succ] < lt + 1:
                    level[succ] = lt + 1
        groups: Dict[Tuple, List[TaskId]] = {}
        for t in order:
            if t in assigned or not ok(t):
                continue
            groups.setdefault((t[0], level[t], g.nodes[t].rank), []).append(t)
        for key in sorted(groups, key=repr):
            g_members = sorted(groups[key])
            for i in range(0, len(g_members), max_tasks):
                wave = g_members[i:i + max_tasks]
                if len(wave) >= max(2, wave_min) \
                        and _slots_consistent(g, classes, wave):
                    regions.append(Region(len(regions), "wave", wave))
                    assigned.update(wave)

    if regions and _contracted_has_cycle(g, regions):
        raise RuntimeError(
            f"fusion: the contracted region graph has a cycle ({len(regions)} "
            "regions); the partition would deadlock the pool")
    return regions


def _contracted_has_cycle(g: TaskGraph, regions: List[Region]) -> bool:
    """Kahn over the region-contracted graph (impossible by construction,
    catastrophic if ever violated: a cyclic contraction deadlocks)."""
    rep: Dict[TaskId, Any] = {}
    for r in regions:
        for m in r.members:
            rep[m] = ("r", r.index)
    nodes: Set[Any] = set()
    edges: Dict[Any, Set[Any]] = {}
    indeg: Dict[Any, int] = {}
    for tid, node in g.nodes.items():
        u = rep.get(tid, tid)
        nodes.add(u)
        for (_f, succ, _sf) in node.out_edges:
            v = rep.get(succ, succ)
            if u == v:
                continue
            outs = edges.setdefault(u, set())
            if v not in outs:
                outs.add(v)
                indeg[v] = indeg.get(v, 0) + 1
                nodes.add(v)
    frontier = [u for u in nodes if indeg.get(u, 0) == 0]
    seen = 0
    while frontier:
        u = frontier.pop()
        seen += 1
        for v in edges.get(u, ()):
            indeg[v] -= 1
            if indeg[v] == 0:
                frontier.append(v)
    return seen != len(nodes)


# ---------------------------------------------------------------------------
# lowering: region -> one device body
# ---------------------------------------------------------------------------

class _FStep:
    __slots__ = ("tid", "cname", "locs", "body", "params", "resolvers",
                 "flow_names", "writable")

    def __init__(self, tid, cname, locs, body, params, resolvers,
                 flow_names, writable):
        self.tid = tid
        self.cname = cname
        self.locs = locs
        self.body = body
        self.params = params
        #: [(flow name, ("slot", idx) | ("val", producer_tid, flow)
        #:   | ("none",))]
        self.resolvers = resolvers
        self.flow_names = flow_names
        self.writable = writable


def _outputs(step: _FStep, outs) -> Tuple:
    if outs is None:
        outs = ()
    elif not isinstance(outs, (tuple, list)):
        outs = (outs,)
    if len(outs) != len(step.writable):
        raise ValueError(
            f"fused member {step.tid}: body returned {len(outs)} outputs "
            f"for {len(step.writable)} writable flows")
    return tuple(outs)


class FusedPlan:
    """Lowering of one region against a taskpool's constants: the slot
    structure, per-member steps, the fused body and its content digest.

    ``slots`` is the body's I/O: one entry per distinct region-boundary
    tile (:func:`region_source` identity), each with the union of the
    members' access modes.  The body takes one tensor per slot
    positionally and returns the final value of every writable slot in
    slot order — the CUDA device module's body contract, so a supertask
    dispatches like any other device chore."""

    def __init__(self, tp, g: TaskGraph, region: Region, *,
                 scan: Optional[str] = None):
        self.region = region
        classes = tp.ptg.classes
        consts = tp.constants
        pset = region.member_set

        slot_index: Dict[Tuple, int] = {}
        slot_keys: List[Tuple] = []
        slot_modes: List[int] = []
        #: per member: {flow name -> slot key or None}; release needs the
        #: backing Data of every flow, including internally-threaded ones
        self.member_flow_slots: List[Dict[str, Optional[Tuple]]] = []
        steps: List[_FStep] = []
        self.device_type = class_device_type(classes[region.members[0][0]])

        def slot_of(key: Tuple) -> int:
            idx = slot_index.get(key)
            if idx is None:
                idx = slot_index[key] = len(slot_keys)
                slot_keys.append(key)
                slot_modes.append(0)
            return idx

        for tid in region.members:
            pc = classes[tid[0]]
            env = pc.env_of(tid[1], consts)
            body = next(fn for dt, fn in pc.bodies.items() if dt != DEV_CPU)
            params = {n: env[n] for n in (pc.param_names + pc.def_names
                                          + pc.body_globals)}
            resolvers: List[Tuple] = []
            flow_names: List[str] = []
            writable: List[str] = []
            fslots: Dict[str, Optional[Tuple]] = {}
            for f in pc.flows:
                if f.mode == CTL:
                    continue
                mode = int(f.mode)
                flow_names.append(f.name)
                if mode & _OUT:
                    writable.append(f.name)
                src = g.nodes[tid].flow_sources.get(f.name)
                if src is None and not mode & _OUT:
                    resolvers.append((f.name, ("none",)))
                    fslots[f.name] = None
                    continue
                key = region_source(g, pset, tid, f.name)
                fslots[f.name] = key
                if src is not None and src[0] == "task" and src[1] in pset:
                    resolvers.append((f.name, ("val", src[1], src[2])))
                    continue
                idx = slot_of(key)
                slot_modes[idx] |= mode & _INOUT
                resolvers.append((f.name, ("slot", idx)))
            # every writable flow also writes its slot (threaded tiles:
            # interior flows share the creator's slot)
            for fname in writable:
                key = fslots.get(fname)
                if key is not None:
                    slot_modes[slot_of(key)] |= _OUT
            steps.append(_FStep(tid, tid[0], tid[1], body, params,
                                resolvers, flow_names, writable))
            self.member_flow_slots.append(fslots)

        self.steps = steps
        self.slot_keys = slot_keys
        self.slot_modes = slot_modes
        self.slot_index = slot_index
        self.out_slots = [i for i, m in enumerate(slot_modes) if m & _OUT]
        #: final writer per out slot: (member tid, flow name), the key of
        #: the body's value table
        last_writer: Dict[int, Tuple[TaskId, str]] = {}
        for mi, step in enumerate(steps):
            for fname in step.writable:
                key = self.member_flow_slots[mi].get(fname)
                if key is not None:
                    last_writer[slot_index[key]] = (step.tid, fname)
        self.slot_writer = last_writer
        self.priority = max(classes[t[0]].priority_of(t[1], consts)
                            for t in region.members)
        self.classes_of: List[str] = []
        for t in region.members:
            if t[0] not in self.classes_of:
                self.classes_of.append(t[0])
        self.name = f"fused[{'+'.join(self.classes_of)}]"

        #: the home tiles of the out slots (an external producer's value
        #: followed to its memory source), and their device bytes in this
        #: pool: the region's fresh outputs before the epilog accounts
        #: them (:func:`region_room`)
        self._out_tiles = [source_tile(g, k[1], k[2]) if k[0] == "ext" else k
                           for k in (slot_keys[i] for i in self.out_slots)]
        self.out_bytes = self.out_bytes_in(tp)
        self._scan_mode = scan if scan is not None else fusion_scan_mode()
        self.body_fn = _FusedBody(self)
        # a weak reference: the scan analysis reads the pool's tiles on
        # first use, and a plan must not keep its pool's collections alive
        self._pool = weakref.ref(tp)

    @functools.cached_property
    def digest(self) -> str:
        """Content digest over the member fingerprints and the region's
        shape, stable across recaptures; computed on first read.  No
        region is captured into a CUDA graph, so no program is cached
        under it (the reference's fused-program cache keys XLA programs
        on it)."""
        h = hashlib.sha256()
        for step in self.steps:
            h.update(repr((step.cname, step.locs, body_fingerprint(step.body),
                           sorted((k, _scrub(repr(v)))
                                  for k, v in step.params.items()),
                           step.resolvers, step.writable)).encode())
        h.update(repr(("slots", self.slot_keys, self.slot_modes, self.out_slots,
                       sorted(self.slot_writer.items()))).encode())
        h.update(repr(("region", self.region.kind,
                       len(self.region.members))).encode())
        return h.hexdigest()[:32]

    def out_bytes_in(self, tp) -> int:
        """The bytes of the tiles the region writes, in pool ``tp`` (a
        cached plan serves same-shaped pools whose tiles may differ)."""
        total = 0
        for key in self._out_tiles:
            if key[0] == "data":
                p = getattr(tp.constants[key[1]].data_of(*key[2]).newest_copy(),
                            "payload", None)
                total += 0 if p is None else int(p.nbytes)
            elif key[0] == "new":
                shape, dtype = tp.new_tile_spec(key[1][0], key[2], key[1][1])
                total += int(np.prod(shape, dtype=np.int64)) * torch_dtype(dtype).itemsize
            # a remote source is not on this rank's card
        return total

    # -- scan analysis -----------------------------------------------------
    @functools.cached_property
    def _scan_segments(self):
        """The reference's scan segment for this region (None: no roll),
        computed on first read.  Analysis only: the port runs every
        member through one loop whatever it is."""
        return self._plan_scan(self._scan_mode) if self._scan_mode != "off" \
            else None

    def _slot_shape(self, idx: int) -> Optional[Tuple]:
        key = self.slot_keys[idx]
        tp = self._pool()
        if tp is None:
            raise RuntimeError(f"{self.name}: the taskpool is gone")
        if key[0] == "data":
            c = tp.constants[key[1]].data_of(*key[2]).newest_copy()
            p = getattr(c, "payload", None)
            return None if p is None else (tuple(p.shape), str(p.dtype))
        if key[0] == "new":
            shape, dtype = tp.new_tile_spec(key[1][0], key[2], key[1][1])
            return (tuple(shape), str(_tile_dtype(dtype)))
        return None  # an external producer's value: shape unknown here

    def _plan_scan(self, scan_mode: str):
        """Detect one maximal uniform run covering steps [0, k): same
        body, identical resolver pattern with carries threaded
        step-to-step, per-step slots all shape-equal.  Returns
        ``(k, carries, const_flows, perstep_flows, carry0)`` or None —
        the reference's segment, field for field."""
        steps = self.steps
        least = 2 if scan_mode == "on" else SCAN_MIN
        if len(steps) < least:
            return None
        s0 = steps[0]
        k = 1
        while k < len(steps) and steps[k].body is s0.body \
                and steps[k].cname == s0.cname \
                and steps[k].flow_names == s0.flow_names \
                and steps[k].writable == s0.writable \
                and list(steps[k].params) == list(s0.params):
            k += 1
        if k < least:
            return None
        carries: List[str] = []
        const_flows: Dict[str, int] = {}
        perstep: Dict[str, List[int]] = {}
        for fi, (fname, _r0) in enumerate(s0.resolvers):
            rs = [steps[i].resolvers[fi][1] for i in range(k)]
            if all(r[0] == "val" and r[1] == steps[i - 1].tid and r[2] == fname
                   for i, r in enumerate(rs) if i > 0) \
                    and rs[0][0] == "slot" and fname in s0.writable:
                carries.append(fname)
            elif all(r[0] == "slot" for r in rs) and len({r[1] for r in rs}) == 1:
                const_flows[fname] = rs[0][1]
            elif all(r[0] == "slot" for r in rs) and len({r[1] for r in rs}) == k:
                perstep[fname] = [r[1] for r in rs]
            else:
                return None
        if set(carries) != set(s0.writable):
            return None
        if scan_mode == "auto":
            for idxs in perstep.values():
                shapes = {self._slot_shape(i) for i in idxs}
                if len(shapes) != 1 or None in shapes:
                    return None
        for p in s0.params:
            for i in range(k):
                if not isinstance(steps[i].params[p],
                                  (int, float, bool, np.integer, np.floating)):
                    return None
        carry0 = {f: steps[0].resolvers[s0.flow_names.index(f)][1][1]
                  for f in carries}
        return (k, carries, const_flows, perstep, carry0)

    # -- the fused body ----------------------------------------------------
    def _drops(self) -> List[List[Tuple[TaskId, str]]]:
        """Per step, the values no later step reads, dropped after it —
        as :class:`.cuda_graph.GraphExecutor` drops its flow values.  A
        slot's final value stays: the body returns it."""
        steps = self.steps
        last: Dict[Tuple[TaskId, str], int] = {}
        for i, step in enumerate(steps):
            for fname in step.flow_names:
                last[(step.tid, fname)] = i
            for _fname, r in step.resolvers:
                if r[0] == "val":
                    last[(r[1], r[2])] = i
        keep = set(self.slot_writer.values())
        drops: List[List[Tuple[TaskId, str]]] = [[] for _ in steps]
        for vkey, i in last.items():
            if vkey not in keep:
                drops[i].append(vkey)
        return drops

    def _build_program(self) -> Callable:
        """The members' bodies in order over the slot tensors: one tensor
        a slot in, the final value of every out slot returned."""
        steps = self.steps
        out_slots = tuple(self.out_slots)
        slot_writer = self.slot_writer
        drops = self._drops()

        def run(*arrays):
            vals: Dict = {}
            for step, dropped in zip(steps, drops):
                kw: Dict[str, Any] = {}
                for fname, r in step.resolvers:
                    if r[0] == "none":
                        kw[fname] = None
                    elif r[0] == "slot":
                        kw[fname] = arrays[r[1]]
                    else:
                        kw[fname] = vals[(r[1], r[2])]
                for fname in step.flow_names:  # read flows pass through
                    vals[(step.tid, fname)] = kw[fname]
                kw.update(step.params)
                outs = _outputs(step, step.body(**kw))
                del kw
                for fname, o in zip(step.writable, outs):
                    vals[(step.tid, fname)] = o
                del outs
                for vkey in dropped:
                    del vals[vkey]
            return tuple(vals[slot_writer[i]] for i in out_slots)

        return run


class _FusedBody:
    """A region's device body (:meth:`FusedPlan._build_program`), carrying
    what the device module reads of a body: ``_fused_n`` > 1 keeps it out
    of waves and counts its members; ``_graph_key`` (the plan's digest) is
    computed on first read."""

    def __init__(self, plan: FusedPlan):
        self._run = plan._build_program()
        self._plan = plan
        self._fused_n = len(plan.region.members)
        self._fused_classes = tuple(plan.classes_of)

    def __call__(self, *arrays):
        return self._run(*arrays)

    @property
    def _graph_key(self) -> Tuple[str, str]:
        return ("fused", self._plan.digest)


def region_room(plans: List[FusedPlan], tp=None) -> int:
    """Device bytes one fused region in flight holds outside the zone's
    accounting: its fresh outputs and, between members, one generation of
    interior values (each dropped after its last reader) — twice the
    largest region's output bytes (in ``tp``, default each plan's own
    pool).  The runtimes hand it to their device modules (``set_aside``)
    once the regions are known."""
    return 2 * max((p.out_bytes if tp is None else p.out_bytes_in(tp) for p in plans),
                   default=0)


# ---------------------------------------------------------------------------
# dynamic-runtime integration (used by dsl/ptg.py)
# ---------------------------------------------------------------------------

class _LiveRegion:
    __slots__ = ("region", "plan", "waiting", "lock", "supertask",
                 "ext_goals")

    def __init__(self, region: Region, plan: FusedPlan):
        self.region = region
        self.plan = plan
        self.waiting = 0
        self.lock = threading.Lock()
        self.supertask = None
        self.ext_goals: Dict[TaskId, int] = {}


class FusionTable:
    """Per-taskpool fusion state for the DYNAMIC runtime: member → region
    routing, region readiness counters (a region fires when every
    member's EXTERNAL dependency goal is met), and the synthetic
    supertasks dispatched as one device chore each.

    A fused member's dependency counter runs with its EXTERNAL goal (the
    total goal less its intra-region in-edges): intra-region producers
    never run on their own, so their releases never arrive.  Each member
    that becomes externally ready (or is claimed as a startup source)
    decrements the region's ``waiting`` count; the transition to zero
    schedules the supertask, which retires all N members at ONE
    completion (``Task.fused_n`` → ``Taskpool.task_done``)."""

    def __init__(self, tp, regions: List[Region], plans: List[FusedPlan],
                 analysis: List[Tuple[Dict[TaskId, int], int]]):
        self.tp = tp
        self._member: Dict[TaskId, _LiveRegion] = {}
        self.live: List[_LiveRegion] = []
        #: the device bytes one region in flight holds outside the zone
        self.room = region_room(plans, tp)
        for region, plan, (ext_goals, waiting) in zip(regions, plans, analysis):
            lr = _LiveRegion(region, plan)
            lr.ext_goals = ext_goals
            lr.waiting = waiting
            lr.supertask = self._build_supertask(lr)
            for m in region.members:
                self._member[m] = lr
            self.live.append(lr)

    # -- routing ---------------------------------------------------------
    def ext_goal(self, name: str, locs: Tuple) -> Optional[int]:
        lr = self._member.get((name, tuple(locs)))
        return None if lr is None else lr.ext_goals[(name, tuple(locs))]

    def same_region(self, a: TaskId, b: TaskId) -> bool:
        lr = self._member.get(a)
        return lr is not None and b in lr.region.member_set

    def is_member(self, name: str, locs: Tuple) -> bool:
        return (name, tuple(locs)) in self._member

    def route_ready(self, name: str, locs: Tuple):
        """One external-readiness event for a member (its counter fired,
        or a startup source was claimed).  Returns ``(handled,
        supertask)``: ``handled`` is False when the task is not fused (the
        caller builds an ordinary task); the supertask is non-None exactly
        once, on the region's last event."""
        lr = self._member.get((name, tuple(locs)))
        if lr is None:
            return False, None
        with lr.lock:
            lr.waiting -= 1
            fire = lr.waiting == 0
        return True, (lr.supertask if fire else None)

    # -- the synthetic supertask class -----------------------------------
    def _build_supertask(self, lr: _LiveRegion):
        plan = lr.plan
        flows = [Flow(f"t{i}", AccessMode(m) if m else AccessMode.IN, i)
                 for i, m in enumerate(plan.slot_modes)]
        tc = TaskClass(plan.name, flows=flows, nb_parameters=1)
        tc.prepare_input = self._make_prepare(lr)
        tc.release_deps = self._make_release(lr)
        chore = Chore(plan.device_type, _accel_hook)
        chore.body_fn = plan.body_fn
        tc.add_chore(chore)
        task = Task(self.tp, tc, locals_=(lr.region.index,),
                    priority=plan.priority)
        task.fused_n = len(lr.region.members)
        return task

    def _resolve_slot(self, key: Tuple):
        """Slot key → backing Data, by the machinery the member tasks
        would use on their own: collection tiles directly, NEW tiles
        through the taskpool's shared new-tile table, external producers
        through their class repo (deposited at the producer's release)."""
        tp = self.tp
        if key[0] == "data":
            return tp.constants[key[1]].data_of(*key[2])
        if key[0] == "new":
            (cname, locs), fname = key[1], key[2]
            pc = tp.ptg.classes[cname]
            f = next(fl for fl in pc.flows if fl.name == fname)
            return tp._new_tile(pc, f, locs)
        _, (pcname, plocs), pflow = key
        src_pc = tp.ptg.classes[pcname]
        entry = tp.repos[pcname].consume(plocs)
        if entry is None:
            if not src_pc.instance_exists(plocs, tp.constants, tp._exists_memo):
                return None
            raise RuntimeError(
                f"fused region: producer {pcname}{plocs} left no repo "
                f"entry for flow {pflow!r} (asymmetric deps?)")
        src_flow = next(sf for sf in src_pc.flows if sf.name == pflow)
        data = entry.copies[src_flow.index]
        if data is None:
            raise RuntimeError(
                f"fused region: producer {pcname}{plocs} deposited no "
                f"data for flow {pflow!r}")
        return data

    def _make_prepare(self, lr: _LiveRegion):
        plan = lr.plan

        def prepare_input(es, task) -> HookReturn:
            # repo USAGE accounting matches the per-task runtime: one
            # consume per member flow that directly references an
            # external producer (the producer counted each of them)
            slot_data: List[Any] = [None] * len(plan.slot_keys)
            for mi, step in enumerate(plan.steps):
                for fname, key in plan.member_flow_slots[mi].items():
                    if key is None or key[0] != "ext":
                        continue
                    idx = plan.slot_index.get(key)
                    if any(r[0] == "slot" and r[1] == idx
                           for fn_, r in step.resolvers if fn_ == fname):
                        d = self._resolve_slot(key)
                        if slot_data[idx] is None:
                            slot_data[idx] = d
            for idx, key in enumerate(plan.slot_keys):
                if slot_data[idx] is None:
                    slot_data[idx] = self._resolve_slot(key)
            task.body_args = [
                ("data", slot_data[i],
                 AccessMode(m) if m else AccessMode.IN)
                for i, m in enumerate(plan.slot_modes)]
            for i, d in enumerate(slot_data):
                task.data_in[i] = d.newest_copy() if d is not None else None
            #: per member: flow name -> Data, for the per-member release
            flow_data = []
            for mi in range(len(plan.steps)):
                fd: Dict[str, Any] = {}
                for fname, key in plan.member_flow_slots[mi].items():
                    if key is None:
                        fd[fname] = None
                        continue
                    idx = plan.slot_index.get(key)
                    fd[fname] = slot_data[idx] if idx is not None \
                        else self._resolve_slot(key)
                flow_data.append(fd)
            task.user = flow_data
            return HookReturn.DONE

        return prepare_input

    def _make_release(self, lr: _LiveRegion):
        plan = lr.plan
        tp = self.tp
        classes = tp.ptg.classes

        def release_deps(es, task):
            ready: List[Any] = []
            flow_data = task.user or [{} for _ in plan.steps]
            for mi, step in enumerate(plan.steps):
                pc = classes[step.cname]
                by_index = [None] * len(pc.flows)
                for f in pc.flows:
                    if f.mode != CTL:
                        by_index[f.index] = flow_data[mi].get(f.name)
                ready.extend(tp._release_deps_core(
                    pc, step.locs, by_index,
                    origin_region=lr.region.member_set))
            return ready

        return release_deps


def analyze_regions(tp, g: TaskGraph, regions: List[Region],
                    scan: Optional[str] = None):
    """Per-region lowering and external-goal analysis: ``(plans,
    [(ext_goals, waiting)])``, everything a :class:`FusionTable` needs
    beyond the live taskpool."""
    consts = tp.constants
    classes = tp.ptg.classes
    plans = [FusedPlan(tp, g, r, scan=scan) for r in regions]
    analysis: List[Tuple[Dict[TaskId, int], int]] = []
    for region in regions:
        intra: Dict[TaskId, int] = {m: 0 for m in region.members}
        for m in region.members:
            for (_f, succ, _sf) in g.nodes[m].out_edges:
                if succ in region.member_set:
                    intra[succ] += 1
        ext_goals: Dict[TaskId, int] = {}
        waiting = 0
        for m in region.members:
            goal = classes[m[0]].goal_of(m[1], consts, tp._exists_memo)
            ext = goal - intra[m]
            if ext < 0:
                raise RuntimeError(
                    f"fusion: member {m} external goal {ext} < 0 "
                    "(asymmetric deps?)")
            ext_goals[m] = ext
            if ext > 0 or goal == 0:
                waiting += 1
        if waiting <= 0:
            raise RuntimeError(
                f"fusion: region {region!r} has no external release "
                "events; it could never fire")
        analysis.append((ext_goals, waiting))
    return plans, analysis


class _CachedFusion:
    __slots__ = ("regions", "plans", "analysis", "placement", "scalars")

    def __init__(self, regions, plans, analysis, placement, scalars):
        self.regions = regions
        self.plans = plans
        self.analysis = analysis
        self.placement = placement
        self.scalars = scalars


#: PTG definition -> {config key -> _CachedFusion} (the reference's
#: partition cache).  Capture, partition and lowering cost real time an
#: attach, and many pools are built from one definition (the attention
#: definitions are memoized); the partition depends only on the
#: definition, the scalar constants and the placement map, each checked on
#: reuse.  Weak keys: a definition's entries go with it
_fusion_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_fusion_cache_lock = threading.Lock()
#: what :func:`build_fusion_table` did: ``captures`` and ``partitions``
#: (a pool partitioned), ``hits`` (a pool took a cached partition)
stats: Dict[str, int] = {"captures": 0, "partitions": 0, "hits": 0}


def _scalar_constants(constants: Dict[str, Any]) -> Tuple:
    return tuple(sorted(
        (k, v) for k, v in constants.items()
        if isinstance(v, (int, float, str, bool, np.integer, np.floating))))


def _placement_of(tp) -> Dict[TaskId, int]:
    """The global placement map, as the capture's first pass builds it."""
    consts = tp.constants
    out: Dict[TaskId, int] = {}
    for pc in tp.ptg.classes.values():
        for loc in pc.param_space(consts):
            out[(pc.name, loc)] = pc.rank_of(loc, consts)
    return out


def build_fusion_table(tp, context) -> Optional[FusionTable]:
    """Attach-time entry point of the dynamic runtime: capture this
    rank's subgraph, partition it, lower each region and build the table
    — or None when fusion is off or nothing fuses.  Any failure raises.
    The (regions, plans, goals) triple is cached per PTG definition and
    reused for a pool whose scalar constants and placement map equal the
    cached ones: no second capture and no second partition (the pump
    partitions on every build, as the reference's does)."""
    mode = fusion_mode()
    if mode == "off":
        return None
    rank = context.rank
    classes = tp.ptg.classes
    devices = [d for d in context.devices if getattr(d, "enabled", True)]
    devtypes = {d.device_type for d in devices}
    accel = next((d for d in devices if d.device_type != DEV_CPU), None)
    horizon = fusion_max_tasks(device=accel)
    scan = fusion_scan_mode()
    key = (rank, getattr(context, "nranks", 1), mode, horizon, scan, tuple(sorted(devtypes)))
    scalars = _scalar_constants(tp.constants)

    with _fusion_cache_lock:
        per = _fusion_cache.get(tp.ptg)
        cached = per.get(key) if per else None
    if cached is not None and cached.scalars == scalars \
            and cached.placement == _placement_of(tp):
        stats["hits"] += 1
        if not cached.regions:
            return None
        return FusionTable(tp, cached.regions, cached.plans, cached.analysis)

    g = tp.capture(ranks=[rank])
    stats["captures"] += 1

    def eligible(name: str) -> bool:
        pc = classes[name]
        return class_device_type(pc) in devtypes and class_fusible(pc)

    regions = partition(g, classes, mode=mode, max_tasks=horizon, eligible=eligible)
    stats["partitions"] += 1
    plans, analysis = analyze_regions(tp, g, regions, scan=scan) if regions else ([], [])
    with _fusion_cache_lock:
        _fusion_cache.setdefault(tp.ptg, {})[key] = _CachedFusion(
            regions, plans, analysis, dict(g.global_ranks), scalars)
    if not regions:
        return None
    debug.verbose(3, "fusion", "%s: fused %d regions covering %d/%d tasks",
                  tp.ptg.name, len(regions),
                  sum(len(r.members) for r in regions), len(g.nodes))
    return FusionTable(tp, regions, plans, analysis)
