"""Native execution engine for captured PTG taskpools.

The port of :mod:`parsec_tpu.dsl.native_exec`.  The reference's hot loop —
ready-queue pops, dependency counting, release_deps — is native C
(``scheduling.c``, ``mca/sched``); only task BODYs are application code.
This module keeps that split: the captured DAG (:mod:`.graph`) is handed
to the C++ engine (``native/src/graph.cpp``, bound by
:mod:`parsec_tpu_torch.native`), and dependency resolution, scheduling and
termination never touch the interpreter.  Single rank.  Three regimes:

* **CPU chores** (``native_device=False``, the default): in-place numpy
  tiles, entered once per task through the ``NativeGraph.run`` trampoline
  from native worker threads;
* **the legacy ASYNC-chore protocol** (``native_device=True`` with
  ``runtime_native_sched=off``, ``device_cuda_eager_complete=0``, or a
  class that has only a CPU body): native workers enter the interpreter
  once per task through the ``NativeGraph.run_async`` trampoline — a
  device task is handed to the CUDA module (``kernel_scheduler``, the
  chore returns ASYNC) and its completion callback signals
  ``NativeGraph.task_done``, a host task of a mixed DAG runs its CPU body
  through the ``Data`` staging discipline and completes inline.  Exactly
  two entries per device task, never one for dependency bookkeeping
  (``stats["trampoline_entries"]``, ``["completion_callbacks"]``);
* **pump mode** (``native_device=True``, all-device DAGs): the engine
  owns the whole per-task lifecycle — ready-queue order (priority, or the
  schedule explorer's seeded perturbation through ``sched_rnd_seed``),
  dep-counter decrements, successor pushes and quiescence.  One Python
  pump loop makes ONE ``pop_batch`` call per batch of ready tasks, runs
  the batch through :meth:`CudaDevice.submit_batch
  <parsec_tpu_torch.device.cuda.CudaDevice.submit_batch>` (stage, body —
  or one captured CUDA graph per same-signature wave chunk — epilog; no
  completion) and retires it with ONE ``done_batch`` call.
  Per task the interpreter is entered zero times for bookkeeping: no
  trampoline, no completion callback (``stats`` pins it).  At
  ``runtime_stage_depth`` >= 2 (the default is 1) the pump keeps a prefetch
  window of popped batches whose inputs the device's transfer lane
  stages while the oldest batch computes (:func:`_pump_loop`).  When a
  ``DEP_DECREMENT`` or ``NATIVE_TASK_DONE`` observer is subscribed (the
  hb checker), the engine buffers its lifecycle events and the pump
  drains them once a batch into PINS (:class:`_EventDrain`).

Supertask fusion (:mod:`.fusion`, ``runtime_fusion`` or ``fusion=``): with
``native_device=True`` each fused region is ONE native node — one device
dispatch of the region's fused body, and one ``done_batch`` slot (pump)
or one ``task_done`` (legacy) retiring its N member tasks.  The CPU
regime does not fuse, as in the reference: its bodies pay no device
dispatch to save.

``runtime_vpmap`` (``nb:<k>`` or ``'0,1;2,3'``) groups the native workers
into virtual processes for the engine's hierarchical steal, on every run.

A ``DEP_DECREMENT`` observer of a legacy-protocol run is fed the engine's
decrements: the run buffers them and each completion callback drains them
after its ``task_done`` (the run's end drains the rest).
``runtime_native_conformance=1`` replays every pump run's drained event
stream against the engine verifier's model (ENG014 raises).

:class:`NativeServeExecutor` (``run_native([...])``) runs N all-device
pools as wdrr tenants of ONE native graph, one device module and one
pump; :meth:`NativeExecutor.rebind` reuses a captured graph for a
same-shaped pool.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.lifecycle import AccessMode, HookReturn, DEV_CPU
from ..core.task import Chore, Task, TaskClass
from ..profiling import pins
from ..utils import mca_param
from .fusion import FusedPlan, fusion_max_tasks, fusion_mode, partition, region_room
from .graph import TaskGraph, capture, source_tile
from .ptg import CTL, PTGTaskpool, _wrap_device_body


def _native_sched_mode() -> str:
    return str(mca_param.register(
        "runtime", "native_sched", "auto",
        help="native-device lifecycle protocol: auto (pump mode — zero "
             "interpreter entries per task for all-device DAGs) | off "
             "(the legacy ASYNC-chore protocol: two entries per task)"))


def _drain_batch() -> int:
    return int(mca_param.register(
        "runtime", "native_drain", 256,
        help="pump-mode batch size: max ready tasks per pz_graph_pop_"
             "batch call (also floors the lifecycle-event drain buffer)"))


def _conformance_on() -> bool:
    return bool(int(mca_param.register(
        "runtime", "native_conformance", 0,
        help="1 = certify every pump run's drained lifecycle-event stream "
             "against the engine-verify model (exactly-once publish and "
             "retire, dep decrements matching in-degree, happens-before "
             "drain order); a divergence raises LintError with ENG014 "
             "findings.  Diagnostic: capture and replay cost O(events)")))


def _wdrr_quantum() -> int:
    return int(mca_param.register(
        "sched", "wdrr_quantum", 4,
        help="task credits a tenant's deficit gains per round-robin "
             "visit, scaled by the tenant's weight"))


def _sched_seed() -> int:
    # the schedule explorer's seed reaches the native scheduler through
    # the SAME param the reference's Python rnd scheduler reads
    return int(mca_param.register(
        "sched", "rnd_seed", -1,
        help="seeded pop-order perturbation of the native pump (>= 0 "
             "replays one schedule deterministically; -1 = priority order)"))


class _TaskInfo:
    """Task stand-in for PINS subscribers on the CPU trampoline path:
    carries the attributes observers read (``task_class.name``,
    ``locals``, ``taskpool``, ``prof``, ``repr``)."""

    __slots__ = ("task_class", "locals", "taskpool", "prof", "_r")

    def __init__(self, cname: str, detail: Any):
        self.task_class = types.SimpleNamespace(name=cname)
        self.locals = detail
        #: no pool: the trace's job and tenant instants come from a pool
        self.taskpool = None
        self.prof: Dict[str, Any] = {}
        self._r = f"{cname}{detail}"

    def __repr__(self) -> str:
        return self._r


class _NativePoolShim:
    """Stand-in taskpool for native-dispatched device tasks: carries the
    failure contract the device module uses (``failed`` checked before
    every dispatch, ``fail(why)`` called when a submit or epilog cannot
    be recovered).  The pump reads it after every batch; on a legacy run
    (``ng`` set) a failure also aborts the native workers, which would
    otherwise wait for a completion that never comes."""

    def __init__(self, name: str):
        self.name = name
        self.failed = False
        self.fail_reason: Optional[str] = None
        #: the legacy run's native graph
        self.ng = None

    def fail(self, why: str) -> bool:
        if self.failed:
            return False
        self.failed = True
        self.fail_reason = why
        if self.ng is not None:
            self.ng.fail()
        return True

    def task_done(self, task=None) -> None:
        """A legacy completion (``complete_execution``): quiescence is the
        native engine's, and the run reports progress at its end."""


class _NativeDeviceTask(Task):
    """Task instance handed to the device module from the pump: a real
    :class:`Task` (staging and epilog read its slots unchanged) with a
    bare task class — no ``release_deps``: successor release belongs to
    the engine — plus its native id and its cross-tile write-backs."""

    __slots__ = ("native_id", "_wbs")

    def __init__(self, pool, tclass, locals_, priority):
        super().__init__(pool, tclass, locals_, priority)
        self.native_id = -1
        #: (source Data, home Data) pairs the pump lands at retire
        #: (pre-resolved cross-tile write-backs; empty in the common case)
        self._wbs: List[Tuple[Any, Any]] = []


class _EventDrain:
    """Batched publisher for the native lifecycle-event buffer: maps the
    engine's (kind, a, b) records onto the PINS sites so the hb checker
    orders pump runs — with no per-task interpreter work on the hot path
    (one drain per pump batch).  Kind mapping:

    * ``EVT_DEP_DEC``  -> :data:`pins.DEP_DECREMENT` with tracker
      ``("native", graph.hb_token)`` (one record per native dep-counter
      decrement, ``ready`` flagging the release that armed the task);
    * ``EVT_PUBLISH``  -> :data:`pins.SCHEDULE_BEGIN` with a 1-task batch
      (the native SchedQ push — ``task_publish`` in hb terms);
    * ``EVT_RETIRE``   -> :data:`pins.NATIVE_TASK_DONE` (the payload the
      legacy ``task_done`` path fires, double completions included).
    """

    def __init__(self, ng, pump_index: Dict[int, Any], cap: int,
                 capture: Optional[List[Tuple[int, int, int]]] = None,
                 legacy: bool = False):
        self.ng = ng
        self.index = pump_index
        #: every drained record, kept raw for the conformance replay
        #: (``runtime_native_conformance``)
        self.capture = capture
        #: a legacy-protocol run: ``task_done`` fires NATIVE_TASK_DONE
        #: itself, so only the dep decrements are republished; drains
        #: come from several completing threads, one at a time
        self.legacy = legacy
        self._lock = threading.Lock()
        n = max(1024, cap * 4)
        self.k = (ctypes.c_int32 * n)()
        self.a = (ctypes.c_int64 * n)()
        self.b = (ctypes.c_int64 * n)()

    def drain(self) -> int:
        from ..core.deps import fire_native_dep_dec

        ng = self.ng
        k, a, b = self.k, self.a, self.b
        dep_on = pins.active(pins.DEP_DECREMENT)
        sched_on = pins.active(pins.SCHEDULE_BEGIN)
        done_on = pins.active(pins.NATIVE_TASK_DONE)
        token = ng.hb_token
        total = 0
        if self.legacy:
            sched_on = done_on = False
        while True:
            n = ng.events_drain(k, a, b)
            total += n
            if self.capture is not None:
                self.capture.extend(
                    (int(k[i]), int(a[i]), int(b[i])) for i in range(n))
            for i in range(n):
                kind = k[i]
                if kind == ng.EVT_DEP_DEC:
                    if dep_on:
                        fire_native_dep_dec(token, int(a[i]), bool(b[i]))
                elif kind == ng.EVT_PUBLISH:
                    if sched_on:
                        t = self.index.get(a[i])
                        if t is not None:
                            pins.fire(pins.SCHEDULE_BEGIN, None, (t,))
                elif done_on:
                    pins.fire(pins.NATIVE_TASK_DONE, None, {
                        "graph": token, "task": int(a[i]),
                        "accepted": bool(b[i])})
            if n < len(k):
                return total

    def drain_locked(self) -> int:
        with self._lock:
            return self.drain()


def _pump_failure(shims) -> Optional[str]:
    for shim in shims:
        if shim.failed:
            return shim.fail_reason or "device submit/epilog failed"
    return None


def _pump_loop(ng, dev, pump_index: Dict[int, Any], stats: Dict[str, int],
               shims, retire_cb: Callable[[List[Any]], None],
               ev: Optional[_EventDrain] = None) -> int:
    """The zero-interpreter hot loop.  Per batch: ONE ``pop_batch`` returns
    up to ``runtime_native_drain`` ready native ids, the device dispatches
    them (completion deferred), rare cross-tile write-backs land, the batch
    retires through :func:`..core.scheduling.retire_native` (COMPLETE_EXEC
    pins only), and ONE ``done_batch`` runs every dep decrement, successor
    push and quiescence count natively.  Python cost is O(batches), not
    O(tasks).

    When the device carries the staging pipeline (``stage_depth`` > 1) the
    pump keeps a WINDOW of up to ``stage_depth`` popped-but-not-yet-
    submitted batches: a batch with input tiles to move that is popped
    behind an older one goes to the device's transfer lane
    (:class:`..device.staging.StageLane`) at once, so its host->device
    copies overlap the older batch's dispatch; when the pump reaches it,
    the lane stops after the chunk in flight and the batch's submit
    stages what is left.  The oldest batch, and one whose inputs are all
    resident, stage in their own submit: handing them over would only add
    a thread handoff and make the lane's Python contend with the pump for
    the interpreter lock, with nothing to overlap.  When the whole ready
    frontier fits one pop and its prestage would move at least the
    device's ``stage_split_bytes`` (``runtime_stage_split_kb``), the batch
    is re-sliced across the free buffers so the window pipelines
    INTRA-wave.  A prestage failure is non-fatal:
    the submit path restages the tile and fails loudly if the data is
    truly bad.  ``ev`` republishes the engine's lifecycle events after
    each ``done_batch``.  ``shims`` are the pool shims of the pools the
    graph holds (one, or the serve executor's N): a failed one ends the
    run.

    Each batch's phases are spans of the device's job (``pop``,
    ``lane_wait``, ``submit``, ``retire``) and seconds in ``stats``
    (``pop_s``, ``lane_wait_s``, ``submit_s``, ``retire_s``)."""
    from ..core import scheduling
    from ..data.data import land_into_home

    depth = max(1, int(getattr(dev, "stage_depth", 1)))
    lane = None
    if depth > 1:
        from ..device.staging import StageLane

        lane = StageLane(dev)
    chunk = max(1, _drain_batch() // depth)
    free = collections.deque((ctypes.c_int64 * chunk)() for _ in range(depth))
    window: collections.deque = collections.deque()  # (buf, n, batch, job)
    done = 0
    job_id = dev.job
    try:
        while True:
            # fill the prefetch window: pop ready batches and hand the
            # stage-ins of those behind the oldest to the lane
            t_pop = time.perf_counter()
            with pins.span("pop", job=job_id):
                while free and len(window) < depth:
                    buf = free.popleft()
                    n = ng.pop_batch(buf)
                    if n == 0:
                        free.appendleft(buf)
                        break
                    stats["pop_batches"] += 1
                    stats["pumped_tasks"] += n
                    batch = [pump_index[buf[i]] for i in range(n)]
                    # the bytes to stage matter only to a batch the lane may
                    # take (one behind an older batch) or one that may split
                    need = dev.prestage_bytes(batch) if lane is not None and (
                        window or (free and n >= 4)) else 0
                    if (need and need >= dev.stage_split_bytes and not window
                            and free and n >= 4):
                        # one wide ready wave with real transfer work to hide:
                        # re-slice it across the free buffers so the lane
                        # prestages slot k+1 while slot k computes
                        ids = [buf[i] for i in range(n)]
                        bufs = [buf] + [free.popleft() for _ in range(len(free))]
                        per = -(-n // len(bufs))
                        off = 0
                        for b in bufs:
                            k = min(per, n - off)
                            if k <= 0:
                                free.append(b)
                                continue
                            for i in range(k):
                                b[i] = ids[off + i]
                            sub = batch[off:off + k]
                            off += k
                            job = lane.stage(sub) if window else None
                            stats["prefetched_batches"] += job is not None
                            window.append((b, k, sub, job))
                        continue
                    job = lane.stage(batch) if need and window else None
                    stats["prefetched_batches"] += job is not None
                    window.append((buf, n, batch, job))
            stats["pop_s"] += time.perf_counter() - t_pop
            if not window:
                why = _pump_failure(shims)
                if why is not None:
                    raise RuntimeError(f"native device run failed: {why}")
                if ng.quiesced():
                    return done
                raise RuntimeError(
                    f"native pump stalled: ready queue empty with {done} "
                    f"retired and {ng.sched_pending()} queued "
                    "(cycle or missing commit?)")
            buf, n, batch, job = window.popleft()
            t0 = time.perf_counter()
            if job is not None:
                # stops the lane after its chunk in flight (and logs a
                # prestage error): the submit stages what is left
                with pins.span("lane_wait", job=job_id):
                    job.wait()
            t1 = time.perf_counter()
            with pins.span("submit", job=job_id):
                dev.submit_batch(batch)
            t2 = time.perf_counter()
            with pins.span("retire", job=job_id):
                why = _pump_failure(shims)
                if why is not None:
                    raise RuntimeError(f"native device run failed: {why}")
                for t in batch:
                    for (src, home) in t._wbs:
                        land_into_home(home, src.newest_copy().payload)
                scheduling.retire_native(batch, dev)
                done += ng.done_batch(buf, n)
                stats["done_batches"] += 1
                free.append(buf)
                retire_cb(batch)
                if ev is not None:
                    stats["events_drained"] += ev.drain()
            # seconds the pump thread spent waiting on the lane, in the
            # device's dispatch and in retirement: O(batches) clock reads
            stats["lane_wait_s"] += t1 - t0
            stats["submit_s"] += t2 - t1
            stats["retire_s"] += time.perf_counter() - t2
    finally:
        if lane is not None:
            lane.close()


class NativeExecutor:
    """Run a PTG taskpool's full DAG on the native engine.

    ``NativeExecutor(tp).run(nthreads=4)`` executes every task with its
    CPU body and applies the declared write-backs to the backing
    collections, exactly like the dynamic runtime's CPU path.  The
    taskpool must be unstarted (never attached to a Context).

    ``native_device=True`` runs every task class that has a device BODY
    through the CUDA device module: in pump mode for an all-device DAG,
    else — ``runtime_native_sched=off``, ``device_cuda_eager_complete=0``,
    or a class with only a CPU body, which then runs on the host through
    the ``Data`` staging discipline — under the legacy ASYNC-chore
    protocol (see the module docstring).  ``device=`` reuses one
    :class:`CudaDevice` across executors; without it the executor builds
    one on a single-rank shim context, bound to the GPU unless
    ``PARSEC_MCA_device_cuda_torch_device=cpu`` asks for the torch CPU
    device.  :meth:`close` flushes dirty device tiles home.

    ``fusion`` (None: the ``runtime_fusion`` MCA param) partitions the
    captured DAG into fused regions, one native node each
    (``self._regions``); :meth:`run` still returns the LOGICAL task
    count.  A partitioner failure raises.

    :meth:`rebind` aims the executor at a same-shaped pool and reruns the
    captured graph: nothing is captured again.

    ``graph`` (a :class:`~.graph.TaskGraph` of ``tp``, e.g.
    ``tp.capture()``) is used instead of capturing one; the distributed
    executor (:mod:`.native_dist`) hands in its rank's filtered capture.

    ``job`` is the run's job id (:func:`..profiling.pins.new_job`): the
    taskpool's, minted when it was built, else a fresh one.  The executor
    hands it to its device module, and every span of the run carries it:
    ``capture``, ``native_build``, ``pump`` (with the pump's per-batch
    spans inside) and ``close``.
    """

    def __init__(self, tp: PTGTaskpool, *, graph: Optional[TaskGraph] = None,
                 native_device: bool = False, device=None,
                 fusion: Optional[str] = None,
                 _shared_graph=None, _tenant: int = 0):
        from .. import native

        self._native = native
        native.load()  # raises with the cause: there is no fallback
        self.taskpool = tp
        self.native_device = bool(native_device)
        self.device = device
        self.job = getattr(tp, "job", 0) or pins.new_job()
        #: control-plane counters.  ``trampoline_entries`` counts every
        #: interpreter entry through the native workers' trampoline (the
        #: CPU regime and the legacy protocol: one per task);
        #: ``completion_callbacks`` the legacy protocol's per-device-task
        #: completion callbacks.  In pump mode both MUST stay 0.  The
        #: ``*_s`` keys are host seconds: the TaskGraph capture and the
        #: native build, and the pump thread's per-batch phases
        #: (:func:`_pump_loop`)
        self.stats: Dict[str, int] = {
            "trampoline_entries": 0, "completion_callbacks": 0,
            "pop_batches": 0, "done_batches": 0, "pumped_tasks": 0,
            "prefetched_batches": 0, "events_drained": 0,
            "graph_capture_s": 0.0, "native_build_s": 0.0, "pop_s": 0.0,
            "lane_wait_s": 0.0, "submit_s": 0.0, "retire_s": 0.0}
        self._stats_lock = threading.Lock()
        #: serve mode (:class:`NativeServeExecutor`): build into ITS shared
        #: native graph under this wdrr tenant id instead of owning one
        self._shared_graph = _shared_graph
        self._tenant = int(_tenant)
        #: the native event buffer was armed at build (observers or the
        #: conformance replay), and the legacy run's drain
        self._events_on = False
        self._legacy_drain: Optional[_EventDrain] = None
        #: native-id edges as declared, kept for the conformance replay
        self._conformance = False
        self._edges: List[Tuple[int, int]] = []
        #: task id -> native id
        self._index: Dict[Tuple, int] = {}
        #: native id -> prebuilt device task, the pump's dispatch map
        self._pump_index: Dict[int, _NativeDeviceTask] = {}
        self._pool_shim: Optional[_NativePoolShim] = None
        #: pump mode (decided at build) and whether a CPU-only class runs
        #: on the host in this device DAG
        self._pump = False
        self._has_cpu_bodies = False
        #: native ids with no predecessor (the commit pass publishes them)
        self._roots: List[int] = []
        if self.native_device:
            mode = fusion if fusion is not None else fusion_mode()
            if self.device is None:
                self.device = self._make_device()
            self._pool_shim = _NativePoolShim(f"native:{tp.ptg.name}")
        if graph is None:
            t0 = time.perf_counter()
            with pins.span("capture", job=self.job):
                graph = capture(tp, ranks=[0])
            self.stats["graph_capture_s"] += time.perf_counter() - t0
        self.graph = graph
        self._new_tiles: Dict[Tuple, np.ndarray] = {}
        self._new_data: Dict[Tuple, Any] = {}
        #: per native node (user tag = index): its CPU body, or in pump
        #: mode its prebuilt device task (a fused region's supertask)
        self._bodies: List[Any] = []
        #: fused regions of the captured DAG (pump mode), each member's
        #: region, and the regions' plans
        self._regions: List[Any] = []
        self._region_of: Dict[Tuple, Any] = {}
        self._plans: List[FusedPlan] = []
        #: per task id: the object its EXEC pins fire with (the prebuilt
        #: device task, a fused region's supertask, or the CPU body's
        #: stand-in), so trace edges join the exec spans' tokens
        self._trace_objs: Dict[Tuple, Any] = {}
        if self.native_device:
            self._regions = partition(self.graph, tp.ptg.classes, mode=mode,
                                      max_tasks=fusion_max_tasks(device=self.device))
            for r in self._regions:
                for m in r.members:
                    self._region_of[m] = r
        self._ng = None
        t0 = time.perf_counter()
        with pins.span("native_build", job=self.job):
            self._build()
        self.stats["native_build_s"] += time.perf_counter() - t0
        if self._plans:
            self.device.set_aside(region_room(self._plans))

    @staticmethod
    def _make_device():
        """One CudaDevice bound to a minimal single-rank context shim (the
        native engine replaces the dynamic Context; the device module
        reads only ``rank`` and ``cuda_device`` from it)."""
        from ..device.cuda import CudaDevice

        shim = types.SimpleNamespace(rank=0, cuda_device=None)
        dev = CudaDevice(shim, index=1)
        dev.attach()
        return dev

    # -- tile resolution (CPU regime) --------------------------------------
    def _payload(self, srckey: Tuple):
        if srckey[0] == "remote":
            # a flow chain that leaves the captured partition: this
            # single-rank executor cannot resolve it (a zeros tile would
            # corrupt the numerics) — distributed captures go through
            # dsl.native_dist.NativeDistExecutor
            raise RuntimeError(
                f"flow source {srckey[1]}/{srckey[2]} is on another rank; "
                "use NativeDistExecutor for rank-filtered captures")
        consts = self.taskpool.constants
        if srckey[0] == "data":
            _, cname, key = srckey
            d = consts[cname].data_of(*key)
            c = d.newest_copy() or d.get_copy(0)
            if c is None or c.payload is None:
                raise ValueError(f"collection tile {cname}{key} has no payload")
            return c.payload
        t = self._new_tiles.get(srckey)
        if t is None:
            # ("new", producer tid, flow): NEW shape resolved by the taskpool
            _, (pc_name, _locs), fname = srckey
            shape, dtype = self.taskpool.new_tile_spec(pc_name, fname)
            t = self._new_tiles[srckey] = np.zeros(shape, dtype)
        return t

    def _build(self) -> None:
        g = self.graph
        ng = self._shared_graph if self._shared_graph is not None \
            else self._native.NativeGraph()
        self._ng = ng
        index = self._index
        self._conformance = _conformance_on()
        region_native: Dict[int, int] = {}
        order = list(g.nodes)
        for tid in order:
            reg = self._region_of.get(tid)
            if reg is not None:
                # a fused region: ONE native node for all its members, at
                # their highest priority
                rid = region_native.get(reg.index)
                if rid is None:
                    rid = region_native[reg.index] = ng.add_task(
                        priority=max(g.nodes[m].priority for m in reg.members),
                        user_tag=len(self._bodies))
                    if self._tenant:
                        ng.set_task_tenant(rid, self._tenant)
                    self._bodies.append(self._make_fused_dispatch(reg, rid))
                index[tid] = rid
                self._trace_objs[tid] = self._pump_index[rid]
                continue
            node = g.nodes[tid]
            index[tid] = ng.add_task(priority=node.priority,
                                     user_tag=len(self._bodies))
            if self._tenant:
                ng.set_task_tenant(index[tid], self._tenant)
            body = self._make_body(tid)
            if isinstance(body, _NativeDeviceTask):
                body.native_id = index[tid]
                self._pump_index[index[tid]] = body
                self._trace_objs[tid] = body
            self._bodies.append(body)
        # with regions, the contracted edges are DEDUPLICATED (add_dep is
        # symmetric: one in-degree per declared edge, one release per
        # successor entry, so one edge per node pair stays balanced), and
        # intra-region edges run inside the fused body
        seen_edges = set()
        has_pred = set()
        for tid in order:
            me = index[tid]
            for (_f, succ, _sf) in g.nodes[tid].out_edges:
                tgt = index[succ]
                if tgt == me or (self._regions and (me, tgt) in seen_edges):
                    continue
                seen_edges.add((me, tgt))
                ng.add_dep(me, tgt)
                if self._conformance:
                    self._edges.append((me, tgt))
                has_pred.add(tgt)
        self._roots = [nid for nid in dict.fromkeys(index.values())
                       if nid not in has_pred]
        if self._shared_graph is not None:
            # the serve executor configured the shared graph's wdrr pump;
            # a host body would need the trampoline the pump never runs
            if self._has_cpu_bodies:
                raise RuntimeError(
                    "NativeServeExecutor requires all-device task classes "
                    f"({self.taskpool.ptg.name} has CPU-only classes)")
            self._pump = True
        elif self.native_device:
            # pump or legacy, decided BEFORE the commit pass: committing
            # pushes the source tasks, and in pump mode those pushes must
            # land in the native SchedQ
            self._pump = (not self._has_cpu_bodies
                          and _native_sched_mode() != "off"
                          and getattr(self.device, "_eager", True))
            if self._pump:
                ng.sched_config(seed=_sched_seed())
            else:
                self._arm_legacy(ng)
        if self._pump and (self._conformance or pins.active(pins.DEP_DECREMENT)
                           or pins.active(pins.NATIVE_TASK_DONE)):
            # observers installed (or the replay asked for): buffer from
            # here on, so the commit pass's root publishes are captured
            ng.events_enable(True)
            self._events_on = True
        # commit only after EVERY edge is declared: committing a task arms
        # it, and a task whose in-edges arrived after arming would release
        # early
        for nid in dict.fromkeys(index.values()):
            ng.commit(nid)
        if self._shared_graph is None:
            ng.seal()

    def _make_body(self, tid: Tuple):
        """The numpy body (CPU regime), the prebuilt device task, or — a
        CPU-only class in a device DAG — the Data-staged host body."""
        if self.native_device:
            pc = self.taskpool.ptg.classes[tid[0]]
            if any(dt != DEV_CPU for dt in pc.bodies):
                return self._make_device_dispatch(tid)
            # a host body needs the legacy protocol's trampoline: its
            # presence rules the pump out
            self._has_cpu_bodies = True
            return self._make_cpu_data_body(tid)
        return self._make_numpy_body(tid)

    def _arm_legacy(self, ng) -> None:
        """The legacy protocol's completion side: each device task (a
        fused supertask included) gets the callback that the CUDA module's
        ``complete_execution`` calls — from the thread that retires it —
        which lands the task's cross-tile write-backs and signals ONE
        ``task_done``; successor release stays in the engine.  A device
        failure aborts the run (the pool shim fails the graph)."""
        from ..data.data import land_into_home

        stats = self.stats
        lock = self._stats_lock
        ev = None
        if pins.active(pins.DEP_DECREMENT):
            # the engine decrements inside task_done (and inside a host
            # task's inline completion): buffer, and drain after each
            # task_done on the completing thread
            ng.events_enable(True)
            ev = self._legacy_drain = _EventDrain(ng, self._pump_index, 64,
                                                  legacy=True)

        def on_complete(t: Task) -> None:
            with lock:
                stats["completion_callbacks"] += 1
            for (src, home) in t._wbs:
                land_into_home(home, src.newest_copy().payload)
            ng.task_done(t.native_id)
            if ev is not None:
                n = ev.drain_locked()
                with lock:
                    stats["events_drained"] += n

        for task in self._pump_index.values():
            task.on_complete = on_complete
        self._pool_shim.ng = ng

    def _make_cpu_data_body(self, tid: Tuple) -> Callable[[], bool]:
        """A CPU-only class in a device DAG: its CPU body runs on the host
        through the Data staging discipline — each input staged to the
        host copy at its newest version (a tile the card wrote is read
        after its ready event, :func:`.ptg.stage_to_cpu`), ownership moved
        to the host (a write invalidates the device copy, so the next
        device read restages it) and each written tile's host version
        bumped (the device's detach then leaves the newer host version
        alone: the write-back version guard).  Completes inline."""
        from ..data.data import land_into_home
        from .ptg import stage_to_cpu

        tp = self.taskpool
        cname, locs = tid
        pc = tp.ptg.classes[cname]
        fn = pc.bodies[DEV_CPU]
        flow_specs = self._flow_data(tid, pc)
        scalars = self._scalars_of(pc, locs)
        wbs = [(src, tp.constants[cname2].data_of(*key))
               for (src, cname2, key) in self._write_back_plan(tid)]
        info = self._trace_objs[tid] = _TaskInfo(cname, locs)

        def body() -> bool:
            pins.fire(pins.EXEC_BEGIN, None, info)
            kw: Dict[str, Any] = dict(scalars)
            writable = []
            for fname, data, mode in flow_specs:
                if data is None:
                    kw[fname] = None
                    continue
                kw[fname] = stage_to_cpu(data)
                data.transfer_ownership(0, mode & AccessMode.INOUT)
                if mode & AccessMode.OUT:
                    writable.append(data)
            result = fn(**kw)
            if result is not None and not isinstance(result, HookReturn):
                outs = result if isinstance(result, (tuple, list)) else (result,)
                for data, new in zip(writable, outs):
                    data.get_copy(0).payload = np.asarray(new)
            for data in writable:
                data.version_bump(0)
            pins.fire(pins.EXEC_END, None, info)
            pins.fire(pins.COMPLETE_EXEC_BEGIN, None, info)
            for (src, home) in wbs:
                land_into_home(home, src.newest_copy().payload)
            pins.fire(pins.COMPLETE_EXEC_END, None, info)
            return False  # synchronous: the worker completes it inline

        return body

    # -- native device dispatch ------------------------------------------
    def _flow_data(self, tid: Tuple, pc) -> List[Tuple[str, Any, Any]]:
        """(flow name, Data-or-None, mode) per non-CTL flow, resolving
        each flow's chain to its backing :class:`Data` (home collection
        tile, or a synthesized NEW tile shared along the chain)."""
        node = self.graph.nodes[tid]
        out: List[Tuple[str, Any, Any]] = []
        for f in pc.flows:
            if f.mode == CTL:
                continue
            src = node.flow_sources.get(f.name)
            if src is None and not (f.mode & AccessMode.OUT):
                out.append((f.name, None, f.mode))
                continue
            out.append((f.name, self._data_for(source_tile(
                self.graph, tid, f.name)), f.mode))
        return out

    def _data_for(self, srckey: Tuple):
        """Data object behind a resolved flow chain (the device-path
        sibling of :meth:`_payload`).  A NEW tile starts as host zeros of
        its ``new_tile_spec``; the device body's output rebinds its device
        copy, so the host buffer is staged once and never written."""
        from ..data.data import data_create

        if srckey[0] == "remote":
            raise RuntimeError(
                f"flow source {srckey[1]}/{srckey[2]} is on another rank; "
                "use NativeDistExecutor for rank-filtered captures")
        if srckey[0] == "data":
            _, cname, key = srckey
            return self.taskpool.constants[cname].data_of(*key)
        d = self._new_data.get(srckey)
        if d is None:
            _, (pc_name, _locs), fname = srckey
            shape, dtype = self.taskpool.new_tile_spec(pc_name, fname)
            d = self._new_data[srckey] = data_create(
                ("native_new",) + tuple(srckey[1:]),
                payload=np.zeros(shape, dtype))
        return d

    def _scalars_of(self, pc, locs) -> Dict[str, Any]:
        consts = self.taskpool.constants
        scalars = {n: consts[n] for n in pc.body_globals}
        scalars.update(zip(pc.param_names, locs))
        if pc.def_names:
            env = pc.env_of(locs, consts)
            for n in pc.def_names:
                scalars[n] = env[n]
        return scalars

    def _write_back_plan(self, tid: Tuple) -> List[Tuple[Any, str, Tuple]]:
        """Cross-tile write-backs (flow chain source != home tile); in the
        common threading case (dpotrf-style flows living in their home
        tiles) this is empty."""
        node = self.graph.nodes[tid]
        plan = []
        for (fname, cname2, key) in node.write_backs:
            src = source_tile(self.graph, tid, fname)
            if src != ("data", cname2, tuple(key)):
                plan.append((self._data_for(src), cname2, tuple(key)))
        return plan

    def _device_chore(self, pc) -> Chore:
        """One Chore per class carrying the wrapped device body."""
        cache = self.__dict__.setdefault("_chore_cache", {})
        chore = cache.get(pc.name)
        if chore is None:
            dev_type, fn = next(
                (dt, f) for dt, f in pc.bodies.items() if dt != DEV_CPU)
            chore = Chore(dev_type, hook=lambda es, task: HookReturn.ASYNC)
            chore.body_fn = _wrap_device_body(pc, fn)
            cache[pc.name] = chore
        return chore

    def _device_tclass(self, pc) -> TaskClass:
        """Bare per-class vtable for device tasks: every slot the
        completion path consults (release_deps, prepare_output, ...) is
        None — successor release belongs to the native engine."""
        cache = self.__dict__.setdefault("_tclass_cache", {})
        tc = cache.get(pc.name)
        if tc is None:
            tc = cache[pc.name] = TaskClass(pc.name)
        return tc

    def _make_device_dispatch(self, tid: Tuple) -> _NativeDeviceTask:
        """Prebuild the device task the pump hands to
        :meth:`CudaDevice.submit_batch` when the engine pops it."""
        tp = self.taskpool
        cname, locs = tid
        pc = tp.ptg.classes[cname]
        node = self.graph.nodes[tid]

        task = _NativeDeviceTask(self._pool_shim, self._device_tclass(pc),
                                 locs, node.priority)
        task.selected_chore = self._device_chore(pc)
        task.selected_device = self.device
        # body_args in prepare_input layout: flows by declaration order
        # (CTL placeholders keep f.index alignment), then values in the
        # positional order params, defs, body_globals — the order
        # _wrap_device_body zips its names against
        specs: List[Tuple[str, Any, Any]] = []
        flow_iter = iter(self._flow_data(tid, pc))
        for f in pc.flows:
            if f.mode == CTL:
                specs.append(("ctl", None, CTL))
            else:
                _, data, mode = next(flow_iter)
                specs.append(("data", data, mode))
        scalars = self._scalars_of(pc, locs)
        for name in pc.param_names + pc.def_names + pc.body_globals:
            specs.append(("value", scalars[name], AccessMode.VALUE))
        task.body_args = specs
        # write-backs PRE-RESOLVED to (source Data, home Data) pairs: the
        # pump lands them without touching the taskpool
        task._wbs = [(src_data, tp.constants[cname2].data_of(*key))
                     for (src_data, cname2, key) in self._write_back_plan(tid)]
        return task

    def _make_fused_dispatch(self, region, native_id: int) -> _NativeDeviceTask:
        """Prebuild the supertask of a fused region: one device task whose
        chore body is the region's :class:`.fusion.FusedPlan` body, over
        one Data a slot.  The pump dispatches it like any device task and
        its ``done_batch`` slot retires the N members (``fused_n``).
        There is no completion callback: successor release is the
        engine's, and every member's cross-tile write-back is
        pre-resolved into ``_wbs``."""
        tp = self.taskpool
        g = self.graph
        plan = FusedPlan(tp, g, region)
        self._plans.append(plan)

        def data_of_slot(key):
            if key[0] == "ext":
                # (producer tid, producer flow): the Data the producer's
                # flow threads, as its own dispatch resolves it
                key = source_tile(g, key[1], key[2])
            return self._data_for(key)

        task = _NativeDeviceTask(self._pool_shim, self._fused_tclass(plan),
                                 (region.index,), plan.priority)
        task.fused_n = len(region.members)
        chore = Chore(plan.device_type, hook=lambda es, task: HookReturn.ASYNC)
        chore.body_fn = plan.body_fn
        task.selected_chore = chore
        task.selected_device = self.device
        task.body_args = [("data", data_of_slot(k), AccessMode(m) if m else AccessMode.IN)
                          for k, m in zip(plan.slot_keys, plan.slot_modes)]
        task.native_id = native_id
        # every member's cross-tile write-backs, landed after the one
        # dispatch; per home tile only the LAST member's landing survives
        # (an earlier one would be superseded anyway)
        wb_map: Dict[Tuple, Any] = {}
        for tid in region.members:
            for (src_data, cname2, key) in self._write_back_plan(tid):
                wb_map[(cname2, key)] = src_data
        task._wbs = [(src_data, tp.constants[cname2].data_of(*key))
                     for (cname2, key), src_data in wb_map.items()]
        self._pump_index[native_id] = task
        return task

    def _fused_tclass(self, plan) -> TaskClass:
        """Bare vtable for a fused supertask (the contract of
        :meth:`_device_tclass`: every completion-path slot is None)."""
        cache = self.__dict__.setdefault("_ftclass_cache", {})
        tc = cache.get(plan.name)
        if tc is None:
            tc = cache[plan.name] = TaskClass(plan.name)
        return tc

    # -- default numpy path ----------------------------------------------
    def _make_numpy_body(self, tid: Tuple) -> Callable[[], None]:
        tp = self.taskpool
        g = self.graph
        consts = tp.constants
        cname, locs = tid
        pc = tp.ptg.classes[cname]
        # per-class invariants hoisted once
        cinfo = self.__dict__.setdefault("_cls_cache", {})
        cached = cinfo.get(cname)
        if cached is None:
            fn = pc.bodies.get(DEV_CPU)
            if fn is None:
                raise ValueError(
                    f"native_exec: class {cname} has no CPU body")
            data_flows = [f for f in pc.flows if f.mode != CTL]
            base_scalars = {n: consts[n] for n in pc.body_globals}
            cached = cinfo[cname] = (fn, data_flows, base_scalars)
        fn, data_flows, base_scalars = cached
        node = g.nodes[tid]

        # resolve flow kwargs lazily at execution time: "new" tiles are
        # shared with whichever predecessor created them
        flow_specs: List[Tuple[str, Optional[Tuple]]] = []
        for f in data_flows:
            src = node.flow_sources.get(f.name)
            if src is None and not (f.mode & AccessMode.OUT):
                flow_specs.append((f.name, None))  # unmatched IN: body gets None
            else:
                flow_specs.append((f.name, source_tile(g, tid, f.name)))
        scalars = dict(base_scalars)
        scalars.update(zip(pc.param_names, locs))
        if pc.def_names:
            env = pc.env_of(locs, consts)
            for n in pc.def_names:
                scalars[n] = env[n]
        # write-back sources are fixed at capture time: resolve once here
        write_backs = []
        for (fname, cname2, key) in node.write_backs:
            src = source_tile(g, tid, fname)
            home = ("data", cname2, tuple(key))
            write_backs.append((src if src != home else None, cname2, tuple(key)))

        info = self._trace_objs[tid] = _TaskInfo(cname, locs)

        def body() -> None:
            # PINS sites fire with es=None: the native engine owns
            # scheduling, but observers see the exec/complete lifecycle
            pins.fire(pins.EXEC_BEGIN, None, info)
            kw: Dict[str, Any] = dict(scalars)
            for fname, srckey in flow_specs:
                kw[fname] = None if srckey is None else self._payload(srckey)
            fn(**kw)
            pins.fire(pins.EXEC_END, None, info)
            pins.fire(pins.COMPLETE_EXEC_BEGIN, None, info)
            # write-backs run at producer completion (the dynamic
            # runtime's _write_back); chain successors are DAG-ordered
            # after us
            for (src, cname2, key) in write_backs:
                if src is not None:
                    np.copyto(self._payload(("data", cname2, key)),
                              self._payload(src))
                self.taskpool.constants[cname2].data_of(*key).version_bump(0)
            pins.fire(pins.COMPLETE_EXEC_END, None, info)

        return body

    def run(self, nthreads: int = 4) -> int:
        """Execute to quiescence; returns the number of LOGICAL tasks run
        (a fused region's node counts its members).  Honors
        ``runtime_vpmap``: the workers split into VP locality domains and
        the native steal path prefers same-VP victims."""
        self._apply_vpmap(nthreads)
        if pins.active(pins.RELEASE_DEPS_END):
            self._emit_trace_edges()
        if self.device is not None:
            self.device.job = self.job
        if self._pump:
            with pins.span("pump", job=self.job):
                n = self._run_pump()
        elif self.native_device:
            n = self._run_legacy(nthreads)
        else:
            bodies = self._bodies
            stats = self.stats
            lock = self._stats_lock

            def trampoline(_task_id: int, user_tag: int) -> None:
                with lock:
                    stats["trampoline_entries"] += 1
                bodies[user_tag]()

            n = self._ng.run(trampoline, nthreads=nthreads)
        if n != len(self._bodies):
            raise RuntimeError(
                f"native engine retired {n}/{len(self._bodies)} tasks")
        return len(self.graph.nodes)

    def _emit_trace_edges(self) -> None:
        """Publish the captured DAG's edges to trace observers in ONE
        pre-run pass through the RELEASE_DEPS_END site (the payload of
        the dynamic runtime's release, ``(task, successors)``): the
        engine releases successors natively, so no per-task release runs
        in Python, and ``profiling.critpath`` gets its predecessor map
        with no hot-loop instrumentation.  The objects are the ones each
        task's EXEC pins fire with, so the edges join the exec spans'
        tokens; an edge inside a fused region ran in the fused body and
        is left out."""
        for tid, node in self.graph.nodes.items():
            if not node.out_edges:
                continue
            me = self._trace_objs[tid]
            succs = [self._trace_objs[s] for (_f, s, _sf) in node.out_edges
                     if self._trace_objs[s] is not me]
            if succs:
                pins.fire(pins.RELEASE_DEPS_END, None, (me, succs))

    def _run_legacy(self, nthreads: int) -> int:
        """The legacy ASYNC-chore protocol: native workers enter the
        trampoline once per task.  A device task is handed to the CUDA
        module and reported ASYNC — its completion callback
        (:meth:`_arm_legacy`) releases the successors — and a host task
        runs inline.  Neither side holds a lock the other needs: the
        trampoline takes only the stats lock, and the device's manager
        (the worker whose ``kernel_scheduler`` call found no manager
        running) retires tasks and calls ``task_done``, which never
        re-enters the interpreter."""
        bodies = self._bodies
        stats = self.stats
        lock = self._stats_lock
        dev = self.device
        shim = self._pool_shim

        def trampoline(_task_id: int, user_tag: int) -> bool:
            with lock:
                stats["trampoline_entries"] += 1
            body = bodies[user_tag]
            if not isinstance(body, _NativeDeviceTask):
                return body()
            if shim.failed:
                raise RuntimeError(
                    f"native device pool failed: {shim.fail_reason}")
            dev.kernel_scheduler(None, body)
            return True  # ASYNC: task_done releases the successors

        try:
            n = self._ng.run_async(trampoline, nthreads=nthreads)
        except RuntimeError:
            if shim.failed:
                raise RuntimeError(
                    f"native device run failed: {shim.fail_reason}") from None
            raise
        if shim.failed:
            raise RuntimeError(f"native device run failed: {shim.fail_reason}")
        if self._legacy_drain is not None:
            # host tasks' inline completions decrement on the workers
            self.stats["events_drained"] += self._legacy_drain.drain_locked()
        self.taskpool.task_done_batch(len(self.graph.nodes))
        return n

    def _apply_vpmap(self, nthreads: int) -> None:
        """Hand ``runtime_vpmap`` to the engine for the next run's
        ``nthreads`` workers; an invalid spec raises ValueError."""
        from ..utils.binding import VPMap

        vm = VPMap.from_param(nthreads)
        self._ng.set_vpmap([vm.vp_of(w) for w in range(nthreads)])

    def _run_pump(self) -> int:
        """Drive the zero-interpreter lifecycle (:func:`_pump_loop`).
        Between commit and quiescence NO per-task Python runs outside the
        device dispatch: no trampoline is installed and no completion
        callback exists, and ``self.stats`` pins it."""
        tp = self.taskpool
        ng = self._ng
        drain = (self._events_on or pins.active(pins.DEP_DECREMENT)
                 or pins.active(pins.NATIVE_TASK_DONE))
        if drain and not self._events_on:
            # observers installed after the build (the hb checker): buffer
            # the engine's lifecycle events from here on.  The commit pass
            # published the roots unbuffered, so publish them now: hb then
            # orders each root's publish before its exec
            ng.events_enable(True)
            self._events_on = True
            if pins.active(pins.SCHEDULE_BEGIN):
                for nid in self._roots:
                    t = self._pump_index.get(nid)
                    if t is not None:
                        pins.fire(pins.SCHEDULE_BEGIN, None, (t,))
        capture: Optional[List[Tuple[int, int, int]]] = \
            [] if self._conformance else None
        ev = _EventDrain(ng, self._pump_index, _drain_batch(), capture) if drain else None
        # the progress currency counts logical tasks: a fused supertask
        # retires all its members (the rule of Taskpool.task_done)
        n = _pump_loop(ng, self.device, self._pump_index, self.stats,
                       (self._pool_shim,),
                       lambda batch: tp.task_done_batch(sum(t.fused_n for t in batch)),
                       ev)
        if capture is not None:
            self._certify_drain(capture)
        return n

    def _certify_drain(self, events: List[Tuple[int, int, int]]) -> None:
        """``runtime_native_conformance``: replay the drained lifecycle
        stream against the engine verifier's model; a divergence (ENG014)
        raises LintError — the drain misreported what the engine did."""
        from ..analysis import engine_verify
        from ..analysis.findings import LintError

        n_tasks = max(dict.fromkeys(self._index.values()), default=-1) + 1
        dag = engine_verify.SeedDag(
            f"pump:{self.taskpool.ptg.name}", n_tasks, tuple(self._edges))
        fs = engine_verify.conformance_findings(dag, events,
                                                quiesced=self._ng.quiesced())
        if fs:
            raise LintError(
                f"native pump drain failed conformance ({len(fs)} finding(s))", fs)
        self.stats["conformance_events"] = len(events)

    def rebind(self, tp: PTGTaskpool) -> "NativeExecutor":
        """Aim this executor at a SAME-SHAPE taskpool (the same task
        classes, parameter spaces, scalar globals and collection names;
        only the tiles' contents may differ) and rewind the native graph
        for another run: the captured graph, the fused partition and the
        native nodes and edges are reused, nothing is captured again.  A
        stream of same-shaped jobs (a decode step after another) pays the
        capture once.  With ``native_device=True`` the previous run's
        device tiles are flushed home first and the device tasks are
        rebuilt over the new pool's tiles.  A shape mismatch raises."""
        if self._shared_graph is not None:
            raise RuntimeError("rebind: a serve executor's child shares the "
                               "serve executor's graph and cannot be rebound")
        self._check_same_shape(tp)
        if self.device is not None:
            self.device.detach()  # the previous pool's tiles land home
        self.taskpool = tp
        self.job = getattr(tp, "job", 0) or pins.new_job()
        self._new_tiles.clear()
        self._new_data.clear()
        self.__dict__.pop("_chore_cache", None)
        t0 = time.perf_counter()
        with pins.span("native_build", job=self.job):
            self._ng.reset()
            if self.native_device:
                self._rebuild_device_tasks()
            # (the CPU regime's bodies read self.taskpool at run time)
            for nid in dict.fromkeys(self._index.values()):
                self._ng.commit(nid)
        self.stats["native_build_s"] += time.perf_counter() - t0
        return self

    def _rebuild_device_tasks(self) -> None:
        """Rebuild every native node's body over the current pool's tiles,
        in the build's order (a node's user tag is its body's position)."""
        self._pump_index.clear()
        self._plans.clear()
        self._has_cpu_bodies = False
        self._bodies = []
        for tid in self.graph.nodes:
            nid = self._index[tid]
            reg = self._region_of.get(tid)
            if reg is not None:
                if nid not in self._pump_index:
                    self._bodies.append(self._make_fused_dispatch(reg, nid))
                self._trace_objs[tid] = self._pump_index[nid]
                continue
            body = self._make_body(tid)
            if isinstance(body, _NativeDeviceTask):
                body.native_id = nid
                self._pump_index[nid] = body
                self._trace_objs[tid] = body
            self._bodies.append(body)
        if not self._pump:
            self._arm_legacy(self._ng)

    def _check_same_shape(self, tp: PTGTaskpool) -> None:
        """The new pool's global task placement and scalar globals must
        match the captured structure exactly (a pass-1 enumeration)."""
        consts = tp.constants
        fresh = {}
        for pc in tp.ptg.classes.values():
            for loc in pc.param_space(consts):
                fresh[(pc.name, loc)] = pc.rank_of(loc, consts)
        old = self.graph.global_ranks
        if fresh != old:
            raise ValueError(
                "rebind: taskpool shape/placement differs from the captured "
                f"structure ({len(fresh)} vs {len(old)} tasks or moved "
                "ranks); build a fresh executor")
        old_scalars = {k: v for k, v in self.taskpool.constants.items()
                       if isinstance(v, (int, float, str, bool))}
        new_scalars = {k: v for k, v in consts.items()
                       if isinstance(v, (int, float, str, bool))}
        if old_scalars != new_scalars:
            raise ValueError(
                "rebind: scalar globals differ (bodies bake them): "
                f"{old_scalars} vs {new_scalars}")

    def close(self) -> None:
        """Release the native graph, then flush dirty device tiles home so
        host-side readers (``TiledMatrix.to_array``) see the final data:
        ``detach`` drains the write-back committer first and writes the
        rest home in one batch.  The device stays usable: a caller may
        share it across executors.  A failed flush — a committer error
        included — raises: it would hand back pre-run host tiles.  A serve
        executor's child owns neither: closing it does nothing."""
        if self._shared_graph is not None:
            self._ng = None
            return
        with pins.span("close", job=self.job):
            ng = self._ng
            if ng is not None:
                self._ng = None
                ng.close()
            if self.device is not None:
                self.device.job = self.job
                self.device.detach()


class NativeServeExecutor:
    """Multi-tenant native pump: N unstarted all-device PTG taskpools share
    ONE native graph, ONE device module and ONE pump loop; the engine's
    wdrr SchedQ interleaves the pools (tenants) by weight with the
    semantics of :mod:`..core.sched.wdrr` — each round-robin visit gives a
    tenant's deficit ``quantum x weight`` task credits, a drained tenant
    forfeits its credits and leaves the ring, and within a tenant pops
    follow (priority desc, insertion order).  A small tenant's tasks keep
    retiring beside a large dpotrf backlog, with no interpreter entry per
    task.

    ``weights`` maps pool position -> wdrr weight (a sequence or a dict;
    default 1); they reach the engine before any child builds, so the
    commit pass's root pushes land in weighted bins.  :meth:`run` returns
    the per-pool logical task counts; :attr:`retire_log` holds ``(pool
    index, retire position, seconds since the pump started)`` for every
    retired native task.  The union run is one job (``job``): its ``pump``
    and ``close`` spans carry it, each pool's capture and build its own."""

    def __init__(self, pools: List[PTGTaskpool], *, device=None,
                 weights=None, seed: int = -1):
        from .. import native

        if len(pools) < 1:
            raise ValueError("NativeServeExecutor needs >= 1 taskpool")
        native.load()  # raises with the cause: there is no fallback
        self.ng = native.NativeGraph()
        self.device = device if device is not None else NativeExecutor._make_device()
        # BEFORE any child builds: the commit pass's pushes must land in
        # the configured wdrr bins
        self.ng.sched_config(policy="wdrr", quantum=_wdrr_quantum(), seed=seed)
        self.job = pins.new_job()
        self.stats: Dict[str, Any] = {
            "trampoline_entries": 0, "completion_callbacks": 0,
            "pop_batches": 0, "done_batches": 0, "pumped_tasks": 0,
            "prefetched_batches": 0, "events_drained": 0,
            "graph_capture_s": 0.0, "native_build_s": 0.0, "pop_s": 0.0,
            "lane_wait_s": 0.0, "submit_s": 0.0, "retire_s": 0.0}
        self.children: List[NativeExecutor] = []
        self.retire_log: List[Tuple[int, int, float]] = []
        self.weights: List[int] = []
        for i, tp in enumerate(pools):
            if weights is None:
                w = 1
            elif isinstance(weights, dict):
                w = int(weights.get(i, 1))
            else:
                w = int(weights[i])
            # one clamped weight, recorded and given to the engine alike
            w = max(1, w)
            self.weights.append(w)
            self.ng.set_tenant_weight(i + 1, w)
            self.children.append(NativeExecutor(
                tp, native_device=True, device=self.device,
                _shared_graph=self.ng, _tenant=i + 1))
        self.ng.seal()
        self._pump_index: Dict[int, _NativeDeviceTask] = {}
        self._tenant_of: Dict[int, int] = {}
        for i, ch in enumerate(self.children):
            self._pump_index.update(ch._pump_index)
            for nid in ch._pump_index:
                self._tenant_of[nid] = i
            for key in ("graph_capture_s", "native_build_s"):
                self.stats[key] += ch.stats[key]
            # the union pump owns the counters
            ch.stats = self.stats

    def run(self) -> List[int]:
        """Pump the union DAG to quiescence; returns the per-pool logical
        task counts."""
        if pins.active(pins.RELEASE_DEPS_END):
            for ch in self.children:
                ch._emit_trace_edges()
        ng = self.ng
        events_on = any(ch._events_on for ch in self.children)
        drain = events_on or pins.active(pins.DEP_DECREMENT) \
            or pins.active(pins.NATIVE_TASK_DONE)
        if drain and not events_on:
            ng.events_enable(True)
            if pins.active(pins.SCHEDULE_BEGIN):
                for ch in self.children:
                    for nid in ch._roots:
                        t = self._pump_index.get(nid)
                        if t is not None:
                            pins.fire(pins.SCHEDULE_BEGIN, None, (t,))
        ev = _EventDrain(ng, self._pump_index, _drain_batch()) if drain else None
        tenant_of = self._tenant_of
        log = self.retire_log
        children = self.children
        t0 = time.perf_counter()

        def retire_cb(batch):
            now = time.perf_counter() - t0
            done = [0] * len(children)
            pos = len(log)
            for t in batch:
                i = tenant_of[t.native_id]
                pos += 1
                log.append((i, pos, now))
                done[i] += t.fused_n
            for i, k in enumerate(done):
                if k:  # each pool's progress currency, one call a pool
                    children[i].taskpool.task_done_batch(k)

        self.device.job = self.job
        with pins.span("pump", job=self.job):
            n = _pump_loop(ng, self.device, self._pump_index, self.stats,
                           [ch._pool_shim for ch in children], retire_cb, ev)
        expected = sum(len(ch._bodies) for ch in children)
        if n != expected:
            raise RuntimeError(f"native serve pump retired {n}/{expected} tasks")
        return [len(ch.graph.nodes) for ch in children]

    def close(self) -> None:
        """Release the shared graph and flush the device's dirty tiles
        home (a failed flush raises, as :meth:`NativeExecutor.close`)."""
        with pins.span("close", job=self.job):
            for ch in self.children:
                ch.close()  # a child owns neither the graph nor the device
            ng = self.ng
            if ng is not None:
                self.ng = None
                ng.close()
            if self.device is not None:
                self.device.job = self.job
                self.device.detach()


def run_native(tp, *, nthreads: int = 4, native_device: bool = False,
               device=None, fusion: Optional[str] = None, weights=None):
    """One-shot: capture + native execution of ``tp``; returns the number
    of (logical) tasks run.  With ``native_device=True`` every task with a
    device body runs through the CUDA device module — driven by the native
    pump, or by the legacy ASYNC-chore protocol — fused regions as one
    dispatch each (``fusion``, None: ``runtime_fusion``; see
    :class:`NativeExecutor`).  A LIST of taskpools runs them as wdrr
    tenants of one shared native graph (:class:`NativeServeExecutor`,
    ``weights`` per pool) and returns the per-pool task counts."""
    if isinstance(tp, (list, tuple)):
        sx = NativeServeExecutor(list(tp), device=device, weights=weights)
        try:
            return sx.run()
        finally:
            sx.close()
    ex = NativeExecutor(tp, native_device=native_device, device=device,
                        fusion=fusion)
    try:
        return ex.run(nthreads=nthreads)
    finally:
        ex.close()
