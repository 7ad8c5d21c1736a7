"""CUDA device module: torch-backed accelerator execution.

The port of :mod:`parsec_tpu.device.tpu`, itself a re-design of the
reference's generic GPU layer (``parsec/mca/device/device_gpu.{c,h}`` +
the ``cuda`` module):

* **manager-thread model** — the first worker submitting a task becomes the
  device manager and drives the state machine until the queues drain;
  later workers enqueue and leave with ASYNC (``device_gpu.c:2542-2557``);
* **stage_in → exec → epilog** with a version-guarded host commit
  (``device_gpu.c:2015,2166,2343``);
* **device-memory residency with dual LRU** — clean vs dirty (owned)
  resident tiles, eviction with write-back (``device_gpu.h:240-243``),
  plain byte accounting against a budget taken from
  ``torch.cuda.mem_get_info`` (the caching allocator owns placement);
* **event-polled completion** — one in-order in-flight queue whose
  completion is a recorded ``torch.cuda.Event``
  (``parsec_device_progress_stream``, ``device_gpu.c:1879-1999``).

One CUDA stream.  Every body, kernel and copy of this module runs on the
device's default stream: eager completion (successors released at
dispatch, the default) is sound only because a successor's reads are
queued behind its producer's writes on the same stream — with two compute
streams and no cross-stream event waits they would race.  Events on one
stream complete in order, so one in-flight queue models the poll order
exactly.  The default stream also orders the device->host reads other
threads make (:func:`..data.data.host_array`).

Device bodies are functional torch, called directly: tensors in, fresh
tensors out for the writable flows (a device copy is never mutated in
place).  There is no jit and no compile cache (ROADMAP A.5), no wave
batching, no native zone allocator and no async staging pipeline
(ROADMAP A.3: this slice's transfers are synchronous, stage depth 1).
:meth:`CudaDevice.submit_batch` is the native pump's entry (no manager,
completion left to the engine).

Binding: ``cuda:<rank % device_count>`` by default.  The torch CPU device
is used only when asked for (``Context(cuda_device="cpu")`` or
``PARSEC_MCA_device_cuda_torch_device=cpu``); without a GPU and without
that request, attaching this module raises.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import traceback
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.lifecycle import AccessMode, HookReturn, DEV_CUDA
from ..core.task import Task
from ..profiling import pins
from ..utils import debug, mca_param, register_component
from ..data.data import Coherency, Data, host_array
from .device import Device


def resolve_torch_device(context) -> torch.device:
    """The torch device this rank's CUDA module binds: an explicit request
    (``context.cuda_device``, else the ``device_cuda_torch_device`` MCA
    param) or ``cuda:<rank % device_count>``.  Raises when no GPU is
    visible and the CPU was not asked for."""
    spec = getattr(context, "cuda_device", None)
    if spec is None:
        spec = str(mca_param.register(
            "device", "cuda_torch_device", "",
            help="torch device the CUDA module binds: '' = cuda:<rank % "
                 "device count>; 'cpu' runs device bodies on the torch "
                 "CPU device (tests); 'cuda:<i>' pins one GPU"))
    dev = torch.device(spec) if spec else torch.device("cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"CUDA device module cannot bind {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device module: torch.cuda.is_available() is False. Ask "
            "for the torch CPU device explicitly (Context(cuda_device="
            "'cpu') or PARSEC_MCA_device_cuda_torch_device=cpu), or build "
            "a host-only Context(devices=['cpu'])")
    if dev.index is not None:
        return dev
    return torch.device("cuda", getattr(context, "rank", 0) % torch.cuda.device_count())


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class _InFlight:
    """One submitted computation: outputs pending in the in-flight queue,
    with the event recorded after its last launch (None on the torch CPU
    device, where execution is synchronous)."""

    __slots__ = ("task", "outputs", "out_specs", "out_hooks", "event")

    def __init__(self, task: Task, outputs: List[Any],
                 out_specs: List[Tuple[int, Any]],
                 out_hooks: List[Any], event: Optional[torch.cuda.Event]):
        self.task = task
        self.outputs = outputs
        self.out_specs = out_specs  # (flow position in body_args, Data)
        #: per-output custom stage_out hooks (None = default commit)
        self.out_hooks = out_hooks
        self.event = event

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


@register_component("device")
class CudaDevice(Device):
    """One torch device (an NVIDIA GPU; the torch CPU device in tests) as a
    task executor."""

    mca_name = "cuda"
    mca_priority = 50
    device_type = DEV_CUDA

    def __init__(self, context, index):
        super().__init__(context, index)
        self.tdev = resolve_torch_device(context)
        self.is_cuda = self.tdev.type == "cuda"
        budget = mca_param.register(
            "device", "cuda_mem_budget_mb", 0,
            help="device bytes (MB) managed for resident tiles (0=auto: "
                 "85% of the free device memory at attach)")
        if budget:
            self.mem_budget = int(budget) << 20
        elif self.is_cuda:
            free, _total = torch.cuda.mem_get_info(self.tdev)
            self.mem_budget = int(free * 0.85)
        else:
            self.mem_budget = 4 << 30
        self.mem_used = 0
        #: device index used in Data.copies — assigned at attach
        self.data_index = index
        self.gflops_rating = 100.0  # strongly favour the GPU for eligible tasks
        #: the one stream every body, kernel and copy of this module uses
        self.stream = torch.cuda.default_stream(self.tdev) if self.is_cuda else None

        #: reference gpu_device->mutex collapses to a boolean, flipped
        #: under _lock together with the pending-queue append, closing the
        #: window where two workers could both become manager
        self._manager_active = False
        self._lock = threading.Lock()
        self._pending: Deque[Task] = collections.deque()
        #: submitted computations in submission order (= completion
        #: order: everything runs on the one stream)
        self._inflight: Deque[_InFlight] = collections.deque()
        #: eager completion: one stream orders computations by data
        #: dependencies already, so successor release need not wait for
        #: device events — the task completes at dispatch and the DAG
        #: streams asynchronously.  0 restores reference-style event
        #: polling (device_gpu.c:1879-1999).
        self._eager = bool(mca_param.register(
            "device", "cuda_eager_complete", 1,
            help="complete device tasks at dispatch; 0 = poll events"))
        #: dual LRU of resident Data keyed by data_id (reference
        #: gpu_mem_lru / gpu_mem_owned_lru)
        self._lru_clean: "collections.OrderedDict[int, Data]" = collections.OrderedDict()
        self._lru_dirty: "collections.OrderedDict[int, Data]" = collections.OrderedDict()
        self._accounted: Dict[int, int] = {}  # data_id -> accounted nbytes
        #: residency lock (LRU + accounting).  RLock — the stage/evict/
        #: realloc paths nest.  Order: _res_lock -> Data.lock.
        self._res_lock = threading.RLock()

    def attach(self) -> None:
        if self.is_cuda:
            # the reference asks XLA for precision="highest" (tiles.py):
            # float32 products here must be true FP32, never TF32 (which
            # keeps ~3 decimal digits and fails the 1e-5 tolerances)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        debug.verbose(3, "device", "%s bound to %s (budget %d MB, TF32 off)",
                      self.name, self.tdev, self.mem_budget >> 20)

    def _stream_ctx(self):
        return torch.cuda.stream(self.stream) if self.is_cuda \
            else contextlib.nullcontext()

    # ------------------------------------------------------------------
    # entry point from the scheduling core (chore hook delegates here)
    # ------------------------------------------------------------------
    def kernel_scheduler(self, es, task: Task) -> HookReturn:
        """Reference ``parsec_device_kernel_scheduler``
        (device_gpu.c:2510-2730)."""
        with self._lock:
            self._pending.append(task)
            if self._manager_active:
                return HookReturn.ASYNC  # a manager is already running
            self._manager_active = True
        # this worker becomes the manager
        try:
            with self._stream_ctx():
                self._manager_loop(es)
        except BaseException:
            # let another worker take over the still-queued work instead of
            # deadlocking every future device task behind a dead manager
            with self._lock:
                self._manager_active = False
            raise
        return HookReturn.ASYNC  # completions were issued by the manager

    def _manager_loop(self, es) -> None:
        while True:
            # phase: check_in_deps + exec — submit everything pending
            with self._lock:
                drained = list(self._pending)
                self._pending.clear()
            for task in drained:
                if task.taskpool.failed:
                    continue  # pool already failed: discard, never execute
                self._submit_one(task, es)
            # phase: get_data_out — retire ready computations in order
            progressed = self._poll_inflight(es)
            with self._lock:
                if not self._pending and not self._inflight:
                    self._manager_active = False
                    return
            if not progressed and self._inflight:
                # nothing completed this spin: block on the oldest event
                self._inflight[0].wait()

    def _submit_one(self, task: Task, es, complete: bool = True) -> None:
        """Per-task submit with the retry/fail-loudly discipline.
        ``complete=False`` runs the epilog but leaves completion (successor
        release) to the caller: the native pump's ``done_batch``."""
        try:
            self._submit(task, es, complete)
        except Exception as e:
            debug.error("cuda submit of %r failed: %s", task, e)
            traceback.print_exc()
            # eager _submit may have begun releasing successors before
            # raising — retrying or completing again would double-release
            # dependency counters: fail the pool
            if task._dev_completed:
                task.taskpool.fail(f"device epilog/completion raised: {e!r}")
                return
            # one retry with fresh state, ONLY when the first attempt
            # provably had no side effects — a partially committed epilog
            # would make the retry double-apply INOUT updates
            task._dev_attempts += 1
            if task._dev_attempts == 1 and not task._dev_effects:
                debug.warning("retrying device submit of %r", task)
                with self._lock:
                    self._pending.append(task)
                return
            # completing the task anyway would hand successors garbage and
            # quiesce "successfully" with wrong numerics: fail the pool
            task.taskpool.fail(f"device submit failed after retry: {e!r}")

    # ------------------------------------------------------------------
    # pump-mode batch dispatch (native scheduler, zero-entry lifecycle)
    # ------------------------------------------------------------------
    def submit_batch(self, tasks: List[Task], es=None) -> None:
        """Dispatch one native-popped ready batch at stage depth 1, WITHOUT
        per-task completion: the pump (:mod:`..dsl.native_exec`) retires
        the whole batch afterwards with one ``done_batch`` call, so
        successor release happens in the native engine, not here.
        Staging, dispatch, epilog and the failure discipline are the
        manager loop's (``_submit_one(complete=False)``); a task whose
        submit failed fails its pool, which the pump reads after the
        batch.  Runs on the caller's thread — the pump's, which never
        went through :meth:`kernel_scheduler` — so it enters the device's
        stream itself: eager completion is sound only because everything
        stays on that one stream."""
        exec_pins = pins.active(pins.EXEC_BEGIN) or pins.active(pins.EXEC_END)
        with self._stream_ctx():
            for task in tasks:
                if task.taskpool.failed:
                    continue
                if exec_pins:
                    pins.fire(pins.EXEC_BEGIN, es, task)
                self._submit_one(task, es, complete=False)
                if exec_pins:
                    pins.fire(pins.EXEC_END, es, task)
            # a transient-submit retry re-queues through ``_pending`` (the
            # manager loop's channel); there is no manager in pump mode,
            # so drain the retries here before the batch is retired
            while True:
                with self._lock:
                    if not self._pending:
                        return
                    retry = list(self._pending)
                    self._pending.clear()
                for task in retry:
                    if not task._dev_completed and not task.taskpool.failed:
                        self._submit_one(task, es, complete=False)

    # ------------------------------------------------------------------
    # stage_in / submit
    # ------------------------------------------------------------------
    def _stage_task_args(self, task: Task, body):
        """kernel_push: stage every flow of ``task`` onto this device and
        return ``(dev_args, out_specs, out_hooks)`` (reference
        device_gpu.c:2015-2164 stage-in phase)."""
        # per-flow custom staging (reference stage_in/stage_out device
        # hooks, device_gpu.h:62-94), keyed by data-arg order
        si_hooks = getattr(body, "_stage_in", None) or {}
        so_hooks = getattr(body, "_stage_out", None) or {}
        dev_args: List[Any] = []
        out_specs: List[Tuple[int, Data]] = []
        out_hooks: List[Any] = []
        data_idx = -1
        for pos, (kind, payload, mode) in enumerate(task.body_args or ()):
            if kind == "data":
                data_idx += 1
                if payload is None:  # optional (guarded-off) flow
                    dev_args.append(None)
                    continue
                rw = mode & AccessMode.INOUT
                si = si_hooks.get(data_idx)
                if si is not None and (mode & AccessMode.OUT) \
                        and so_hooks.get(data_idx) is None:
                    # the body would compute on the PACKED representation
                    # and the epilog would commit it as the home-layout
                    # tile — silently wrong; loud is the contract
                    raise RuntimeError(
                        f"{task!r}: stage_in on writable flow requires a "
                        "matching stage_out hook")
                if si is not None:
                    arr = self._stage_in_custom(payload, si)
                elif rw == AccessMode.OUT:
                    # write-only: the body overwrites it — skip the H2D
                    arr = self._out_placeholder(payload)
                else:
                    arr = self._stage_in(payload)
                payload.transfer_ownership(self.data_index, rw)
                dev_args.append(arr)
                if mode & AccessMode.OUT:
                    out_specs.append((pos, payload))
                    out_hooks.append(so_hooks.get(data_idx))
            elif kind == "value":
                dev_args.append(payload)
            # other kinds (e.g. "ctl") contribute no argument
        return dev_args, out_specs, out_hooks

    def _submit(self, task: Task, es=None, complete: bool = True) -> None:
        """Stage + body dispatch (reference device_gpu.c:2015-2164).  With
        ``complete=False`` the epilog runs at dispatch, as in eager mode,
        and the task is not completed here."""
        from ..core import scheduling

        body = task.selected_chore.body_fn
        if body is None:
            raise RuntimeError(f"chore of {task!r} has no body_fn for device execution")
        dev_args, out_specs, out_hooks = self._stage_task_args(task, body)
        outputs = body(*dev_args)
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        outputs = list(outputs)
        if len(outputs) != len(out_specs):
            raise ValueError(
                f"device body of {task!r} returned {len(outputs)} outputs "
                f"for {len(out_specs)} writable flows")
        eager = self._eager or not complete
        event = None
        if self.is_cuda and not eager:
            event = torch.cuda.Event()
            event.record(self.stream)
        inflight = _InFlight(task, outputs, out_specs, out_hooks, event)
        if eager:
            # the epilog mutates output tiles one by one (rebind + version
            # bump): once entered, a retry would double-apply
            task._dev_effects = True
            self._epilog(inflight)
            task._dev_completed = True
            if complete:
                scheduling.complete_execution(self.context, es, task)
            return
        self._inflight.append(inflight)

    def _h2d(self, host: np.ndarray) -> torch.Tensor:
        """Host->device copy.  Always a COPY: on the torch CPU device
        ``torch.from_numpy`` and ``.to("cpu")`` alias the host array, which
        CPU bodies mutate in place (the aliasing hazard the reference
        guards in ``private_device_put``)."""
        if not host.flags.writeable:
            host = host.copy()  # torch.from_numpy wants a writable array
        t = torch.from_numpy(host)
        return t.to(self.tdev) if self.is_cuda else t.clone()

    def _out_placeholder(self, data: Data) -> Any:
        """Device-side zeros standing in for a write-only tile."""
        newest = data.newest_copy()
        p = getattr(newest, "payload", None)
        shape = data.shape if data.shape is not None else getattr(p, "shape", None)
        dtype = data.dtype if data.dtype is not None else getattr(p, "dtype", None)
        if shape is None or dtype is None:
            return self._stage_in(data)  # shape unknown: fall back
        if not isinstance(dtype, torch.dtype):
            dtype = _torch_dtype(dtype)
        return torch.zeros(tuple(shape), dtype=dtype, device=self.tdev)

    def _as_device_tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.tdev)
        return self._h2d(np.asarray(x))

    def _stage_in_custom(self, data: Data, hook) -> Any:
        """Stage via a user hook: ``hook(data, device) -> tensor``.  The
        hook's result becomes the flow's device copy; residency is
        accounted at the STAGED size, which may differ from the home
        tile's (packed subtile)."""
        with self._res_lock:
            mine = data.get_copy(self.data_index)
            newest = data.newest_copy()
            if mine is not None and newest is not None \
                    and mine.version >= newest.version and mine.payload is not None \
                    and mine.staged_by is hook:
                # reusable ONLY if this same hook produced it
                self._lru_touch(data, dirty=mine.coherency is Coherency.OWNED)
                return mine.payload
            if mine is not None and mine.payload is not None \
                    and mine.staged_by is None:
                host = data.get_copy(0)
                if host is None or host.payload is None \
                        or host.version < mine.version:
                    # the device copy is the ONLY up-to-date home-layout
                    # replica: flush it home BEFORE the packed staging
                    # replaces it
                    self._writeback(data)
            arr = self._as_device_tensor(hook(data, self))
            old = mine.nbytes if (mine is not None and mine.payload is not None) else 0
            self._mem_realloc(data, old, arr.nbytes)
            self.stats["bytes_in"] += arr.nbytes
            self.stats["custom_stage_in"] = self.stats.get("custom_stage_in", 0) + 1
            c = data.attach_copy(self.data_index, arr)
            c.version = newest.version if newest is not None else 0
            c.staged_by = hook
            self._lru_touch(data, dirty=False)
            return arr

    def _stage_in(self, data: Data) -> Any:
        """Materialize the newest version of ``data`` on this device."""
        with self._res_lock:
            mine = data.get_copy(self.data_index)
            if mine is not None and mine.staged_by is not None:
                # a custom-staged PACKED representation must never be served
                # as the home layout: drop it and restage from the host copy
                self._drop_copy(data, evicted=False)
                mine = None
            newest = data.newest_copy()
            if mine is not None and newest is not None and mine.version >= newest.version and mine.payload is not None:
                self._lru_touch(data, dirty=mine.coherency is Coherency.OWNED)
                return mine.payload
            if newest is None:
                raise RuntimeError(f"{data!r}: no valid copy to stage in")
            # re-staging over a stale device copy replaces it: account the delta
            old = mine.nbytes if (mine is not None and mine.payload is not None) else 0
            if isinstance(newest.payload, torch.Tensor):
                # a tensor at another device index (device-to-device), or
                # a torch CPU host tile (host-to-device: bfloat16 host
                # tiles are torch tensors, numpy has no bfloat16)
                src = newest.payload
                self._mem_realloc(data, old, src.nbytes)
                arr = src.to(self.tdev, copy=True)
                self.stats["bytes_in" if src.device.type == "cpu"
                           else "bytes_d2d"] += src.nbytes
            else:
                host = np.asarray(newest.payload)
                self._mem_realloc(data, old, host.nbytes)
                arr = self._h2d(host)
                self.stats["bytes_in"] += host.nbytes
            c = data.attach_copy(self.data_index, arr)
            c.version = newest.version
            self._lru_touch(data, dirty=False)
            return arr

    # ------------------------------------------------------------------
    # memory budget + dual LRU eviction
    # ------------------------------------------------------------------
    def _reserve(self, nbytes: int) -> None:
        """Make room: evict clean first, then write back dirty tiles
        (reference device_gpu.c:978-1120 retry/evict loops)."""
        with self._res_lock:
            while self.mem_used + nbytes > self.mem_budget:
                if not self._evict_one():
                    break  # nothing evictable; trust the caching allocator

    def _evict_one(self) -> bool:
        with self._res_lock:
            if self._lru_clean:
                _, victim = self._lru_clean.popitem(last=False)
                mine = victim.get_copy(self.data_index)
                host = victim.get_copy(0)
                if mine is not None and (host is None or host.payload is None
                                         or host.version < mine.version):
                    # a CLEAN device copy can still be the ONLY valid copy
                    # (a device-native arrival with no host copy): dropping
                    # it without write-back would destroy the data
                    self._writeback(victim)
                self._drop_copy(victim)
                return True
            if self._lru_dirty:
                _, victim = self._lru_dirty.popitem(last=False)
                self._writeback(victim)
                self._drop_copy(victim)
                return True
            return False

    def _mem_realloc(self, data: Data, old_nbytes: int, new_nbytes: int) -> None:
        """(Re)account ``data``'s residency slot, evicting for space."""
        with self._res_lock:
            # the allocatee must not be its own eviction victim: callers
            # re-touch the LRU right after accounting
            self._lru_clean.pop(data.data_id, None)
            self._lru_dirty.pop(data.data_id, None)
            # what this device accounted lives in _accounted, not in the
            # caller's view: copies attached from outside enter the LRU
            # without ever being accounted, and freeing them must not
            # underflow the budget
            old_acc = self._accounted.pop(data.data_id, 0)
            self._reserve(max(0, new_nbytes - old_acc))
            self.mem_used += new_nbytes - old_acc
            if new_nbytes > 0:
                self._accounted[data.data_id] = new_nbytes

    def _drop_copy(self, data: Data, *, evicted: bool = True) -> None:
        with self._res_lock:
            c = data.detach_copy(self.data_index)
            if c is not None:
                self.mem_used -= self._accounted.pop(data.data_id, 0)
                if evicted:
                    self.stats["evictions"] += 1

    def _wb_snapshot(self, data: Data):
        """Version-guarded snapshot of a dirty device copy: returns
        ``(payload, version)`` to commit home, or None when the commit
        would be wrong or redundant.  Taken under the Data lock so a
        concurrent epilog rebind cannot tear payload from version."""
        with data.lock:
            c = data.get_copy(self.data_index)
            if c is None or c.payload is None:
                return None
            if c.staged_by is not None:
                # packed custom-staged representation: flushing it home
                # would corrupt the home tile; the host copy already holds
                # the same version in home layout (_stage_in_custom
                # pre-flushes)
                return None
            hc = data.get_copy(0)
            if hc is not None and hc.payload is not None \
                    and hc.version >= c.version:
                # the host already holds this version OR NEWER: flushing
                # the stale device copy would roll the tile back
                return None
            return (c.payload, c.version)

    def _commit_host(self, data: Data, version: int, host: np.ndarray) -> bool:
        """Land a D2H'd payload as the host copy at ``version``.  The guard
        re-checks under the Data lock: a newer commit that landed while our
        copy was in flight wins and ours drops.  Deliberately NO
        version_bump: the committed value is the same write the device
        epilog already bumped for."""
        with data.lock:
            hc = data.get_copy(0)
            if hc is not None and hc.payload is not None \
                    and hc.version >= version:
                return False
            hc = data.attach_copy(0, host)
            hc.version = version
            hc.coherency = Coherency.SHARED
        self.stats["bytes_out"] += host.nbytes
        return True

    def _writeback(self, data: Data) -> None:
        """Synchronous write-back-to-rest of a dirty tile (reference w2r
        tasks, ``parsec_gpu_create_w2r_task``)."""
        snap = self._wb_snapshot(data)
        if snap is None:
            return
        payload, version = snap
        self._commit_host(data, version, host_array(payload))

    def _lru_touch(self, data: Data, *, dirty: bool) -> None:
        with self._res_lock:
            self._lru_clean.pop(data.data_id, None)
            self._lru_dirty.pop(data.data_id, None)
            (self._lru_dirty if dirty else self._lru_clean)[data.data_id] = data

    # ------------------------------------------------------------------
    # completion / stage_out / epilog
    # ------------------------------------------------------------------
    def _poll_inflight(self, es) -> bool:
        """Retire completed computations in submission order (reference
        per-stream event polling)."""
        from ..core import scheduling

        progressed = False
        queue = self._inflight
        while queue:
            inflight = None
            try:
                if not queue[0].ready():
                    break
                inflight = queue.popleft()
                self._epilog(inflight)
            except Exception as e:
                # the computation itself died (a device error surfacing
                # at the event) or the epilog could not commit outputs:
                # the task must NOT complete — successors would consume
                # garbage.  Fail the pool loudly.
                if inflight is None:
                    inflight = queue.popleft()  # ready() raised
                debug.error("cuda retirement failed: %s", e)
                inflight.task.taskpool.fail(f"device retirement raised: {e!r}")
                progressed = True
                continue
            scheduling.complete_execution(self.context, es, inflight.task)
            progressed = True
        return progressed

    def _epilog(self, inflight: _InFlight) -> None:
        """Commit outputs: rebind device copies, bump versions, keep tiles
        resident & dirty (reference kernel_epilog device_gpu.c:2343 — data
        stays OWNED on device; the host pulls on demand).  A flow's custom
        stage_out hook transforms the body output first."""
        if pins.active(pins.DEVICE_EPILOG_BEGIN):
            pins.fire(pins.DEVICE_EPILOG_BEGIN, None, inflight.task)
        with self._res_lock:
            for (pos, data), arr, so in zip(inflight.out_specs,
                                            inflight.outputs,
                                            inflight.out_hooks):
                if so is not None:
                    arr = self._as_device_tensor(so(arr, data, self))
                    self.stats["custom_stage_out"] = self.stats.get("custom_stage_out", 0) + 1
                if not isinstance(arr, torch.Tensor) or arr.device != self.tdev:
                    raise TypeError(
                        f"device body of {inflight.task!r} returned "
                        f"{type(arr).__name__} on "
                        f"{getattr(arr, 'device', None)} for flow "
                        f"{pos}; expected a tensor on {self.tdev}")
                c = data.get_copy(self.data_index)
                old = c.nbytes if c is not None else 0
                if c is None:
                    c = data.attach_copy(self.data_index, arr)
                else:
                    c.payload = arr
                # the committed value is HOME-layout (stage_out already
                # unpacked): a packed stage_in marker must not survive it
                c.staged_by = None
                self._mem_realloc(data, old, arr.nbytes)
                data.version_bump(self.data_index)
                self._lru_touch(data, dirty=True)
            # outputs grew residency: re-settle under the budget
            self._reserve(0)

    # ------------------------------------------------------------------
    def resident_data(self, task: Task) -> int:
        total = 0
        for spec in task.body_args or ():
            if spec[0] != "data" or spec[1] is None:
                continue
            c = spec[1].get_copy(self.data_index)
            newest = spec[1].newest_copy()
            if c is not None and c.payload is not None and (newest is None or c.version >= newest.version):
                total += c.nbytes
        return total

    def detach(self) -> None:
        """Flush every dirty tile home (one version-guarded commit each),
        then release the residency accounting.  The payloads stay attached
        to their Data objects; a later stage-in reuses them unaccounted."""
        with self._stream_ctx(), self._res_lock:
            for _, data in list(self._lru_dirty.items()):
                self._writeback(data)
            self._lru_dirty.clear()
            self._lru_clean.clear()
            self._accounted.clear()
            self.mem_used = 0
