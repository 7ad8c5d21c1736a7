"""Native execution engine for captured PTG taskpools.

The port of :mod:`parsec_tpu.dsl.native_exec`.  The reference's hot loop —
ready-queue pops, dependency counting, release_deps — is native C
(``scheduling.c``, ``mca/sched``); only task BODYs are application code.
This module keeps that split: the captured DAG (:mod:`.graph`) is handed
to the C++ engine (``native/src/graph.cpp``, bound by
:mod:`parsec_tpu_torch.native`), and dependency resolution, scheduling and
termination never touch the interpreter.  Single rank.  Two body regimes:

* **CPU chores** (``native_device=False``, the default): in-place numpy
  tiles, entered once per task through the ``NativeGraph.run`` trampoline
  from native worker threads;
* **pump mode** (``native_device=True``, all-device DAGs): the engine
  owns the whole per-task lifecycle — ready-queue order (priority, or the
  schedule explorer's seeded perturbation through ``sched_rnd_seed``),
  dep-counter decrements, successor pushes and quiescence.  One Python
  pump loop makes ONE ``pop_batch`` call per batch of ready tasks, runs
  the batch through :meth:`CudaDevice.submit_batch
  <parsec_tpu_torch.device.cuda.CudaDevice.submit_batch>` (stage, body,
  epilog; no completion) and retires it with ONE ``done_batch`` call.
  Per task the interpreter is entered zero times for bookkeeping: no
  trampoline, no completion callback (``stats`` pins it).  At
  ``runtime_stage_depth`` >= 2 (the default is 1) the pump keeps a prefetch
  window of popped batches whose inputs the device's transfer lane
  stages while the oldest batch computes (:func:`_pump_loop`).

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the legacy ASYNC-chore protocol (``runtime_native_sched=off``,
``device_cuda_eager_complete=0`` under the pump) and mixed DAGs with
CPU-only classes under ``native_device=True`` (A.10); supertask fusion
(A.4); a list of taskpools — the serve executor — and the lifecycle-event
drain that feeds ``DEP_DECREMENT`` observers (A.9).
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
from .graph import capture, source_tile
from .ptg import CTL, PTGTaskpool, _wrap_device_body


def _native_sched_mode() -> str:
    return str(mca_param.register(
        "runtime", "native_sched", "auto",
        help="native-device lifecycle protocol: auto (pump mode — zero "
             "interpreter entries per task) | off (the legacy ASYNC-chore "
             "protocol, not ported yet)"))


#: max ready tasks one ``pop_batch`` call returns in pump mode
_POP_BATCH = 256

#: the intra-wave split threshold: a lone ready batch is re-sliced across
#: the prefetch window only when its prestage would move at least this
#: many host->device bytes (the reference's ``runtime_stage_split_kb``)
_STAGE_SPLIT_BYTES = 256 << 10


def _fusion_mode() -> str:
    return str(mca_param.register(
        "runtime", "fusion", "off",
        help="supertask fusion over captured graphs: off (fusion is not "
             "ported yet)"))


def _sched_seed() -> int:
    # the schedule explorer's seed reaches the native scheduler through
    # the SAME param the reference's Python rnd scheduler reads
    return int(mca_param.register(
        "sched", "rnd_seed", -1,
        help="seeded pop-order perturbation of the native pump (>= 0 "
             "replays one schedule deterministically; -1 = priority order)"))


class _TaskInfo:
    """Task stand-in for PINS subscribers on the CPU trampoline path:
    carries the attributes observers read (``task_class.name``, ``prof``,
    ``repr``)."""

    __slots__ = ("task_class", "prof", "_r")

    def __init__(self, cname: str, detail: Any):
        self.task_class = types.SimpleNamespace(name=cname)
        self.prof: Dict[str, Any] = {}
        self._r = f"{cname}{detail}"

    def __repr__(self) -> str:
        return self._r


class _NativePoolShim:
    """Stand-in taskpool for pump-dispatched device tasks: carries the
    failure contract the device module uses (``failed`` checked before
    every dispatch, ``fail(why)`` called when a submit or epilog cannot
    be recovered).  The pump reads it after every batch."""

    def __init__(self, name: str):
        self.name = name
        self.failed = False
        self.fail_reason: Optional[str] = None

    def fail(self, why: str) -> bool:
        if self.failed:
            return False
        self.failed = True
        self.fail_reason = why
        return True


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


def _pump_loop(ng, dev, pump_index: Dict[int, Any], stats: Dict[str, int],
               shim: _NativePoolShim, retire_cb: Callable[[List[Any]], None]
               ) -> int:
    """The zero-interpreter hot loop.  Per batch: ONE ``pop_batch`` returns
    up to ``_POP_BATCH`` ready native ids, the device dispatches them
    (completion deferred), rare cross-tile write-backs land, the batch
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
    frontier fits one pop and its prestage would move at least
    ``_STAGE_SPLIT_BYTES``, the batch is re-sliced across the free buffers
    so the window pipelines INTRA-wave.  A prestage failure is non-fatal:
    the submit path restages the tile and fails loudly if the data is
    truly bad."""
    from ..core import scheduling
    from ..data.data import land_into_home

    depth = max(1, int(getattr(dev, "stage_depth", 1)))
    lane = None
    if depth > 1:
        from ..device.staging import StageLane

        lane = StageLane(dev)
    chunk = max(1, _POP_BATCH // depth)
    free = collections.deque((ctypes.c_int64 * chunk)() for _ in range(depth))
    window: collections.deque = collections.deque()  # (buf, n, batch, job)
    done = 0
    try:
        while True:
            # fill the prefetch window: pop ready batches and hand the
            # stage-ins of those behind the oldest to the lane
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
                if (need and need >= _STAGE_SPLIT_BYTES and not window
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
            if not window:
                if shim.failed:
                    raise RuntimeError(f"native device run failed: {shim.fail_reason}")
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
                job.wait()
            t1 = time.perf_counter()
            dev.submit_batch(batch)
            t2 = time.perf_counter()
            if shim.failed:
                raise RuntimeError(f"native device run failed: {shim.fail_reason}")
            for t in batch:
                for (src, home) in t._wbs:
                    land_into_home(home, src.newest_copy().payload)
            scheduling.retire_native(batch, dev)
            done += ng.done_batch(buf, n)
            stats["done_batches"] += 1
            free.append(buf)
            retire_cb(batch)
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

    ``native_device=True`` runs every task through the CUDA device module
    in pump mode (see the module docstring); every task class needs a
    device BODY.  ``device=`` reuses one :class:`CudaDevice` across
    executors; without it the executor builds one on a single-rank shim
    context, bound to the GPU unless
    ``PARSEC_MCA_device_cuda_torch_device=cpu`` asks for the torch CPU
    device.  :meth:`close` flushes dirty device tiles home.
    """

    def __init__(self, tp: PTGTaskpool, *, native_device: bool = False,
                 device=None, fusion: Optional[str] = None):
        from .. import native

        mode = fusion if fusion is not None else _fusion_mode()
        if mode not in ("", "off"):
            raise NotImplementedError(
                f"native fusion {mode!r}: supertask fusion is not ported yet "
                "(ROADMAP A.4)")
        self._native = native
        native.load()  # raises with the cause: there is no fallback
        self.taskpool = tp
        self.native_device = bool(native_device)
        self.device = device
        #: control-plane counters.  ``trampoline_entries`` counts every
        #: interpreter entry through the native workers' trampoline (the
        #: CPU regime: one per task); ``completion_callbacks`` the legacy
        #: protocol's per-task callbacks, which the port has no path for.
        #: In pump mode both MUST stay 0.
        self.stats: Dict[str, int] = {
            "trampoline_entries": 0, "completion_callbacks": 0,
            "pop_batches": 0, "done_batches": 0, "pumped_tasks": 0,
            "prefetched_batches": 0,
            "lane_wait_s": 0.0, "submit_s": 0.0, "retire_s": 0.0}
        self._stats_lock = threading.Lock()
        #: native id -> prebuilt device task, the pump's dispatch map
        self._pump_index: Dict[int, _NativeDeviceTask] = {}
        self._pool_shim: Optional[_NativePoolShim] = None
        if self.native_device:
            if _native_sched_mode() == "off":
                raise NotImplementedError(
                    "runtime_native_sched=off selects the legacy ASYNC-chore "
                    "protocol, which is not ported yet (ROADMAP A.10)")
            if pins.active(pins.DEP_DECREMENT):
                raise NotImplementedError(
                    "DEP_DECREMENT observers on a pump run need the native "
                    "lifecycle-event drain, which comes with the profiling "
                    "layer (ROADMAP A.9)")
            if self.device is None:
                self.device = self._make_device()
            if not getattr(self.device, "_eager", True):
                raise NotImplementedError(
                    "device_cuda_eager_complete=0 routes native runs to the "
                    "legacy ASYNC-chore protocol, which is not ported yet "
                    "(ROADMAP A.10)")
            self._pool_shim = _NativePoolShim(f"native:{tp.ptg.name}")
        self.graph = capture(tp, ranks=[0])
        self._new_tiles: Dict[Tuple, np.ndarray] = {}
        self._new_data: Dict[Tuple, Any] = {}
        #: per native task (user tag = index): its CPU body, or in pump
        #: mode its prebuilt device task
        self._bodies: List[Any] = []
        self._ng = None
        self._build()

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
            raise RuntimeError(
                f"flow source {srckey[1]}/{srckey[2]} is on another rank; "
                "distributed native execution is not ported yet (ROADMAP A.8)")
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
        ng = self._ng = self._native.NativeGraph()
        index: Dict[Tuple, int] = {}
        order = list(g.nodes)
        for tid in order:
            node = g.nodes[tid]
            index[tid] = ng.add_task(priority=node.priority,
                                     user_tag=len(self._bodies))
            body = self._make_body(tid)
            if isinstance(body, _NativeDeviceTask):
                body.native_id = index[tid]
                self._pump_index[index[tid]] = body
            self._bodies.append(body)
        for tid in order:
            me = index[tid]
            for (_f, succ, _sf) in g.nodes[tid].out_edges:
                ng.add_dep(me, index[succ])
        if self.native_device:
            # decided BEFORE the commit pass: committing pushes the source
            # tasks, and those pushes must land in the native SchedQ
            ng.sched_config(seed=_sched_seed())
        # commit only after EVERY edge is declared: committing a task arms
        # it, and a task whose in-edges arrived after arming would release
        # early
        for tid in order:
            ng.commit(index[tid])
        ng.seal()

    def _make_body(self, tid: Tuple):
        """The numpy body (CPU regime), or the prebuilt device task."""
        if self.native_device:
            pc = self.taskpool.ptg.classes[tid[0]]
            if all(dt == DEV_CPU for dt in pc.bodies):
                raise NotImplementedError(
                    f"native_device=True: class {pc.name} has only a CPU "
                    "body; mixed DAGs need the legacy ASYNC-chore protocol, "
                    "which is not ported yet (ROADMAP A.10)")
            return self._make_device_dispatch(tid)
        return self._make_numpy_body(tid)

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
                "distributed native execution is not ported yet (ROADMAP A.8)")
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

        info = _TaskInfo(cname, locs)

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
        """Execute to quiescence; returns the number of tasks run."""
        if self.native_device:
            n = self._run_pump()
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
        return n

    def _run_pump(self) -> int:
        """Drive the zero-interpreter lifecycle (:func:`_pump_loop`).
        Between commit and quiescence NO per-task Python runs outside the
        device dispatch: no trampoline is installed and no completion
        callback exists, and ``self.stats`` pins it."""
        tp = self.taskpool
        return _pump_loop(self._ng, self.device, self._pump_index, self.stats,
                          self._pool_shim,
                          lambda batch: tp.task_done_batch(len(batch)))

    def close(self) -> None:
        """Release the native graph, then flush dirty device tiles home so
        host-side readers (``TiledMatrix.to_array``) see the final data:
        ``detach`` drains the write-back committer first and writes the
        rest home in one batch.  The device stays usable: a caller may
        share it across executors.  A failed flush — a committer error
        included — raises: it would hand back pre-run host tiles."""
        ng = self._ng
        if ng is not None:
            self._ng = None
            ng.close()
        if self.device is not None:
            self.device.detach()


def run_native(tp, *, nthreads: int = 4, native_device: bool = False,
               device=None) -> int:
    """One-shot: capture + native execution of ``tp``; returns the number
    of tasks run.  With ``native_device=True`` every task runs through the
    CUDA device module driven by the native pump (see
    :class:`NativeExecutor`)."""
    if isinstance(tp, (list, tuple)):
        raise NotImplementedError(
            "run_native over a list of taskpools (the multi-tenant serve "
            "executor) is not ported yet (ROADMAP A.9)")
    ex = NativeExecutor(tp, native_device=native_device, device=device)
    try:
        return ex.run(nthreads=nthreads)
    finally:
        ex.close()
