"""Distributed native execution: the C++ engine runs each rank's local
partition of a PTG; cross-rank dependencies ride the aggregated
activation protocol.

The port of :mod:`parsec_tpu.dsl.native_dist`.  The reference has ONE
engine that is both native and distributed
(``parsec/interfaces/dtd/insert_function.c:2812-2860``: shadow tasks run
on the same C core as local ones).  This module is that composition:

* the local partition (``graph.capture(tp, ranks=[rank])``) executes on
  the native engine (``native/src/graph.cpp`` — atomic dep counters,
  worker threads, steal), Python entered per BODY only;
* every REMOTE producer with local successors becomes a *phantom* task
  inserted uncommitted (its commit token held by the network): when the
  producer's aggregated activation arrives — over the normal
  ``remote_dep`` wire, broadcast trees, parking, GETs and all — the
  payloads are deposited and the phantom commits, releasing the local
  consumers inside the live native graph (streaming insertion);
* completing local tasks with remote successors call the SAME
  ``send_activations`` aggregation path the Python runtime uses (one
  message per destination rank, payload shipped once, topology trees);
* cross-rank final write-backs ship via ``send_writeback``; expected
  arrivals are phantoms too, so the native run cannot quiesce before the
  data lands (the Python runtime's pre-counted runtime actions, in
  native-dependency form).

The executor registers itself with the ``RemoteDepManager`` under the
taskpool's name — both sides of the wire speak the unchanged protocol,
so Python-scheduled ranks and native ranks interoperate, over the
in-process fabric or the TCP backend alike.

Like the reference, it runs the pool's HOST bodies (the CPU regime of
:class:`~.native_exec.NativeExecutor`): its flows are host arrays, and
the wire carries them as they are.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

from ..comm.payload import to_wire
from ..utils import debug
from .graph import capture, source_tile
from .native_exec import NativeExecutor
from .ptg import CTL, PTGTaskpool, _DataRef, _NewRef, _NoneRef, _expand_args


class NativeDistExecutor(NativeExecutor):
    """Run rank ``ce.rank``'s partition of ``tp`` on the native engine,
    wired to peers through comm engine ``ce``.  One instance per rank;
    every rank instantiates the same logical taskpool (name-matched)."""

    def __init__(self, tp: PTGTaskpool, ce):
        self.ce = ce
        self.rank = ce.rank
        self.name = tp.name
        self.failed = False
        self._terminated = False
        #: deposited remote flow payloads: ((class, locals), flow_name) -> arr
        self._remote_payloads: Dict[Tuple, Any] = {}
        #: remote producer (class, locals) -> uncommitted phantom id
        self._phantoms: Dict[Tuple, int] = {}
        #: (collection, key) -> uncommitted write-back phantom ids
        self._wb_phantoms: Dict[Tuple, List[int]] = {}
        self._net_lock = threading.Lock()
        #: per-local-task remote-successor plan:
        #: tid -> (rank_masks, {flow_index: payload srckey or None})
        self._remote_out: Dict[Tuple, Tuple[Dict[int, int], Dict[int, Any]]] = {}
        #: tid -> [(collection, key, payload srckey or None, owner_rank)]
        self._remote_wb: Dict[Tuple, List[Tuple]] = {}
        # the remote-dep endpoint normally appears at Context attach; a
        # bare engine (no Context) gets one here — same protocol object
        if not hasattr(ce, "remote_dep"):
            from ..comm.remote_dep import RemoteDepManager

            ce.remote_dep = RemoteDepManager(ce)
        super().__init__(tp, graph=capture(tp, ranks=[self.rank]))
        self._plan_remote_edges()
        ce.remote_dep.new_taskpool(self)  # replays parked activations

    # -- build-time analysis of the cross-rank frontier ------------------
    def _plan_remote_edges(self) -> None:
        tp = self.taskpool
        g = self.graph
        consts = tp.constants
        ng = self._ng
        # (a) remote INPUTS: every local node whose direct flow source is
        # a task outside the capture awaits that producer's activation
        consumers: Dict[Tuple, set] = {}
        for tid, node in g.nodes.items():
            for _fname, src in node.flow_sources.items():
                if src is not None and src[0] == "task" \
                        and src[1] not in g.nodes:
                    consumers.setdefault(tuple(src[1]), set()).add(tid)
        for ptid, locals_ in consumers.items():
            ph = ng.add_task(0, -1)  # commit token held by the network
            self._phantoms[(ptid[0], tuple(ptid[1]))] = ph
            for ctid in locals_:
                ng.add_dep(ph, self._index[ctid])
        # (b) remote OUTPUTS + cross-rank write-backs, from each local
        # node's dep targets (the same enumeration the Python
        # release_deps path runs per completion, resolved once here).
        # Target ranks come from capture's global placement map — valid
        # targets are exactly its keys, so no valid()/rank_of() re-eval
        global_ranks = g.global_ranks
        for tid in g.nodes:
            pc = tp.ptg.classes[tid[0]]
            env = pc.env_of(tid[1], consts)
            rank_masks: Dict[int, int] = {}
            payload_src: Dict[int, Any] = {}
            for f in pc.flows:
                for dep in f.deps_out:
                    t = dep.target(env)
                    if t is None or isinstance(t, (_NoneRef, _NewRef)):
                        continue
                    if isinstance(t, _DataRef):
                        dc = consts[t.collection_name]
                        key = t.key(env)
                        owner = dc.rank_of(*key)
                        if owner != self.rank and f.mode != CTL:
                            src = source_tile(g, tid, f.name)
                            self._remote_wb.setdefault(tid, []).append(
                                (t.collection_name, tuple(key), src, owner))
                        continue
                    for locs in _expand_args(t.args, env):
                        r = global_ranks.get((t.class_name, locs))
                        if r is None or r == self.rank:
                            continue  # invalid target or local successor
                        rank_masks[r] = rank_masks.get(r, 0) | (1 << f.index)
                        if f.mode != CTL and f.index not in payload_src:
                            payload_src[f.index] = source_tile(g, tid, f.name)
            if rank_masks:
                self._remote_out[tid] = (rank_masks, payload_src)
        # (c) write-backs EXPECTED here: remote tasks whose data-ref deps
        # land on tiles this rank owns (the Python runtime pre-counts
        # these as termdet runtime actions; phantoms are their native
        # form — the run cannot quiesce before the data arrives).
        for pc in tp.ptg.classes.values():
            wb_deps = [
                (f, dep)
                for f in pc.flows if f.mode != CTL
                for dep in f.deps_out
                if isinstance(dep.then, _DataRef)
                or isinstance(getattr(dep, "otherwise", None), _DataRef)
            ]
            if not wb_deps:
                continue
            for (cname, loc), r in global_ranks.items():
                if cname != pc.name or r == self.rank:
                    continue
                env = pc.env_of(loc, consts)
                for _f, dep in wb_deps:
                    t = dep.target(env)
                    if isinstance(t, _DataRef):
                        dc = consts[t.collection_name]
                        key = tuple(t.key(env))
                        if dc.rank_of(*key) == self.rank:
                            ph = ng.add_task(0, -1)
                            self._wb_phantoms.setdefault(
                                (t.collection_name, key), []).append(ph)
        self._n_phantoms = len(self._phantoms) + sum(
            len(v) for v in self._wb_phantoms.values())
        # snapshots for rebind(): runs consume the live maps (pops on
        # arrival / failure drain); a reuse run restores them
        self._phantoms_init = dict(self._phantoms)
        self._wb_phantoms_init = {k: list(v)
                                  for k, v in self._wb_phantoms.items()}
        # every edge (local AND phantom) is declared: arm the local tasks
        # (phantom commit tokens stay with the network)
        for tid in g.nodes:
            ng.commit(self._index[tid])
        ng.seal()

    def _build(self) -> None:
        # keep the node->id map (the frontier pass adds phantom edges),
        # and leave committing and sealing to _plan_remote_edges
        g = self.graph
        ng = self._native.NativeGraph()
        self._ng = ng
        order = list(g.nodes)
        for tid in order:
            node = g.nodes[tid]
            self._index[tid] = ng.add_task(priority=node.priority,
                                           user_tag=len(self._bodies))
            self._bodies.append(self._make_body(tid))
        for tid in order:
            me = self._index[tid]
            for (_f, succ, _sf) in g.nodes[tid].out_edges:
                ng.add_dep(me, self._index[succ])
        # NOT committed and NOT sealed: _plan_remote_edges still adds
        # phantom edges — committing here would arm tasks whose remote
        # dependencies are not yet declared (they would release early)

    # -- payload resolution ----------------------------------------------
    def _payload(self, srckey: Tuple):
        if srckey[0] == "remote":
            _, ptid, pflow = srckey
            arr = self._remote_payloads.get(((ptid[0], tuple(ptid[1])), pflow))
            if arr is None:
                raise RuntimeError(
                    f"remote payload {ptid}/{pflow} consumed before arrival")
            return arr
        return super()._payload(srckey)

    # -- body wrapper: network sends at completion ------------------------
    def _make_body(self, tid: Tuple):
        base = super()._make_body(tid)
        rd = self.ce.remote_dep
        sends = wbs = None  # bound lazily: plans are built after bodies

        def body() -> None:
            nonlocal sends, wbs
            if self.failed:
                return  # drain mode: retire without executing or sending
            try:
                base()
                if sends is None:
                    sends = self._remote_out.get(tid, False)
                    wbs = self._remote_wb.get(tid, False)
                if wbs:
                    for (cname, key, src, owner) in wbs:
                        payload = None if src is None else \
                            to_wire(self._payload(src))
                        rd.send_writeback(self, cname, key, payload, owner)
                if sends:
                    rank_masks, payload_src = sends
                    flow_payloads = {
                        fi: to_wire(self._payload(sk))
                        for fi, sk in payload_src.items() if sk is not None}
                    rd.send_activations(self, tid[0], tid[1],
                                        dict(rank_masks), flow_payloads)
            except BaseException as e:
                # a producer dying BEFORE its sends would strand every
                # consumer rank's phantoms: fail the pool on every rank
                # (peers drain via _force_fail's phantom commits), then
                # re-raise so run() reports the original error
                rd._fail_pool_everywhere(
                    self, f"body {tid[0]}{tuple(tid[1])} on rank "
                    f"{self.rank} raised: {e!r}")
                raise

        return body

    # -- remote_dep taskpool surface --------------------------------------
    def incoming_activation(self, *, src_class: str, src_locals: Tuple,
                            mask: int, flow_data: Dict[int, Any]) -> None:
        key = (src_class, tuple(src_locals))
        pc = self.taskpool.ptg.classes[src_class]
        with self._net_lock:
            for f in pc.flows:
                if (mask >> f.index) & 1 and f.index in flow_data:
                    self._remote_payloads[(key, f.name)] = flow_data[f.index]
            ph = self._phantoms.pop(key, None)
        if ph is None:
            debug.verbose(3, "native", "activation %s%r had no waiting "
                          "phantom (duplicate or mask-only)", src_class,
                          tuple(src_locals))
            return
        self._ng.commit(ph)  # streaming release into the live graph

    def incoming_writeback(self, cname: str, key: Tuple, payload) -> None:
        if payload is not None:
            from ..data.data import land_into_home

            land_into_home(self.taskpool.constants[cname].data_of(*key),
                           payload)
        with self._net_lock:
            phl = self._wb_phantoms.get((cname, tuple(key)))
            ph = phl.pop() if phl else None
        if ph is None:
            debug.error("unexpected write-back %s%r", cname, tuple(key))
            return
        self._ng.commit(ph)

    def _force_fail(self) -> bool:
        # atomic terminating transition (same contract as
        # Taskpool._force_fail under _term_lock): concurrent failure
        # paths — a local body raising on a native worker vs a peer abort
        # on the pump thread — must not both observe the transition, or
        # _fail_pool_everywhere would broadcast the abort twice
        with self._net_lock:
            if self._terminated:
                return False
            self._terminated = True
        self.failed = True
        # Unblock run(): the native run retires tasks, not flags — every
        # phantom whose commit token the network still holds must commit
        # now or the native graph never drains and run() blocks forever.
        # Bodies released this way see self.failed and retire as no-ops,
        # so no successor consumes a missing remote payload and no
        # garbage lands in the backing collections.
        with self._net_lock:
            phantoms = list(self._phantoms.values())
            self._phantoms.clear()
            for phl in self._wb_phantoms.values():
                phantoms.extend(phl)
                phl.clear()
        for ph in phantoms:
            self._ng.commit(ph)
        return True

    def rebind(self, tp: PTGTaskpool) -> "NativeDistExecutor":
        """Distributed reuse: re-aim at a SAME-SHAPE taskpool (see
        :meth:`NativeExecutor.rebind`).  The wire identity carries a
        GENERATION tag (``name@@N``, advanced identically on every rank
        at each rebind), so a fast rank's round-N+1 activations arriving
        at a rank still finishing round N simply PARK under the unknown
        name and replay at that rank's own rebind — no barrier needed,
        no silent duplicate-drop.  Restores the phantom commit tokens
        (held by the network again) before re-registering."""
        self._generation = getattr(self, "_generation", 0) + 1
        self._remote_payloads.clear()
        self._terminated = False
        self.failed = False
        self._phantoms = dict(self._phantoms_init)
        self._wb_phantoms = {k: list(v)
                             for k, v in self._wb_phantoms_init.items()}
        super().rebind(tp)  # shape check + graph rewind + local commits
        self.name = f"{tp.name}@@{self._generation}"
        self.ce.remote_dep.new_taskpool(self)  # replays parked activations
        return self

    # -- execution ---------------------------------------------------------
    def run(self, nthreads: int = 2) -> int:
        """Execute the local partition to global quiescence; returns the
        number of LOCAL tasks run (phantoms excluded)."""
        bodies = self._bodies
        nlocal = len(bodies)

        def trampoline(_tid: int, user_tag: int) -> None:
            if user_tag >= 0:
                bodies[user_tag]()  # phantoms (tag -1) are pure releases

        stop = threading.Event()

        def pump() -> None:
            # drive comm progress while native workers run (TCP has its
            # own comm thread; inproc delivers in progress calls)
            while not stop.is_set():
                try:
                    if self.ce.progress_nonblocking() == 0:
                        time.sleep(0.0002)
                except Exception as e:  # pragma: no cover
                    debug.error("native_dist comm pump: %s", e)

        t = threading.Thread(target=pump, name=f"nd-pump-{self.rank}",
                             daemon=True)
        t.start()
        try:
            n = self._ng.run(trampoline, nthreads=nthreads)
        finally:
            stop.set()
            t.join(timeout=5)
            self._terminated = True
            self.ce.remote_dep.taskpool_done(self)
        if self.failed:
            raise RuntimeError(f"rank {self.rank}: distributed run failed")
        expected = nlocal + self._n_phantoms
        if n != expected:
            raise RuntimeError(
                f"rank {self.rank}: retired {n}/{expected} tasks")
        return nlocal
