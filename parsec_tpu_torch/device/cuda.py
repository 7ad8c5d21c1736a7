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
  device bytes accounted by the native zone allocator (``zone_malloc.c``'s
  role) against a budget taken from ``torch.cuda.mem_get_info`` (the
  caching allocator owns placement);
* **event-polled completion** — one in-order in-flight queue whose
  completion is a recorded ``torch.cuda.Event``
  (``parsec_device_progress_stream``, ``device_gpu.c:1879-1999``);
* **the asynchronous staging pipeline** (:mod:`.staging`,
  ``runtime_stage_depth`` >= 2; at 1, the default, the dispatching
  thread moves every tile and ``detach`` writes back): the native pump's prefetch
  lane stages the next ready batch's inputs (:meth:`CudaDevice.prestage_batch`)
  and a write-back committer takes the dirty outputs home: when an
  eviction needs a victim home, at the flush barrier, and — only with a
  ``runtime_wb_window_mb`` watermark set — whenever that many dirty bytes
  are pending.

Streams.  One COMPUTE stream — the device's default stream — carries every
body and kernel: eager completion (successors released at dispatch, the
default) is sound only because a successor's reads are queued behind its
producer's writes on that one stream.  Transfers run on two copy streams
of their own, H2D and D2H, from and into a bounded ring of reused pinned
host buffers, and are ordered by events: each device copy carries the
event recorded after the copy or the body that produced it
(:func:`..data.data.set_ready_event`); a body's stage-in makes the compute
stream wait on its copy's event, the committer's D2H waits on the
producer's event, and :func:`..data.data.host_array` waits on the tensor's
event instead of the whole device.  The caching allocator reuses a freed
block only behind the streams it knows used it: an H2D destination is
allocated on the H2D stream, which never waits on compute, so a prefetch
overlaps the kernels queued before it; the compute stream's first wait on
the copy also records the block's use there (``record_stream``); body
outputs are allocated on the compute stream; and D2H readers hold their
source until the copy has completed — so a freed block is never reused
under a copy or a kernel still touching it.  Transfers move in batches
(one ``_foreach_copy_`` each way per chunk): a transfer thread pays for
every torch call it makes in waits on the interpreter lock.  On the torch
CPU device streams, events and pinning are skipped; the lane and committer
threads still run.

Device bodies are functional torch, called directly: tensors in, fresh
tensors out for the writable flows (a device copy is never mutated in
place).  There is no jit, no compile cache and no wave batching (ROADMAP
A.4: a captured CUDA graph per same-signature wave).
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
import time
import traceback
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.lifecycle import AccessMode, HookReturn, DEV_CUDA
from ..core.task import Task
from ..profiling import pins
from ..utils import debug, mca_param, register_component
from ..data.data import Coherency, Data, host_array, ready_event, set_ready_event
from .device import ADVICE_PREFETCH, ADVICE_WARMUP, Device
from .staging import _SPAN_SEQ, stage_depth_param


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


def _capacity_chunks(sizes: List[int], cap: int) -> List[List[int]]:
    """Indices of ``sizes`` in order, grouped so that each group's total is
    at most ``cap`` (an item larger than ``cap`` goes alone)."""
    chunks: List[List[int]] = []
    total = cap + 1
    for i, n in enumerate(sizes):
        if total + n > cap:
            chunks.append([])
            total = 0
        chunks[-1].append(i)
        total += n
    return chunks


#: pinned host bytes the copy streams may hold, both directions together:
#: the largest chunk one batched copy moves
_PINNED_RING_BYTES = 64 << 20


#: the access bit of a flow that reads its tile, as a plain int: this
#: test runs for every flow of every batch the pump pops, where an enum
#: operation would cost more than the rest of the test
_READS = int(AccessMode.IN)

#: the most bytes the transfer lane stages between checks of its stop
#: flag: the longest the pump waits for the lane when it reaches a batch
_LANE_CHUNK_BYTES = 16 << 20


def _pinned_empty(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class _PinnedRing:
    """Reused page-locked host buffers for the copy streams, bounded to
    ``capacity`` bytes.  A buffer handed back with :meth:`put` returns to
    the free list only once its copy's event has completed; :meth:`get`
    waits for the oldest busy buffer rather than grow past the capacity
    (a single request larger than the capacity is served alone and trimmed
    when it comes back).  ``allocated``/``peak`` count the pinned bytes.
    Busy buffers are kept in hand-back order and reclaimed from the front
    until the first whose copy is still running, and each buffer caches its
    typed views (:meth:`view`), so a reused buffer costs no torch call."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._busy: Deque[Tuple[torch.Tensor, Any]] = collections.deque()
        self._views: Dict[int, Dict[Tuple[torch.dtype, Tuple[int, ...]], torch.Tensor]] = {}
        self.allocated = 0
        self.peak = 0
        self._lock = threading.Lock()

    def get(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            while True:
                self._reclaim()
                free = self._free.get(nbytes)
                if free:
                    return free.pop()
                if self.allocated + nbytes <= self.capacity:
                    break
                if self._drop_one_free():
                    continue
                if not self._busy:
                    break  # over capacity with nothing in flight: serve it
                self._busy[0][1].synchronize()
            buf = _pinned_empty(nbytes)
            self._views[id(buf)] = {}
            self.allocated += nbytes
            self.peak = max(self.peak, self.allocated)
            return buf

    def view(self, buf: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
        """``buf`` seen as a contiguous tensor of ``dtype`` and ``shape``."""
        views = self._views[id(buf)]
        key = (dtype, tuple(shape))
        v = views.get(key)
        if v is None:
            v = views[key] = buf.view(dtype).view(key[1])
        return v

    def put(self, bufs: List[torch.Tensor], event) -> None:
        """Hand ``bufs`` back; they are reusable once ``event`` completes."""
        with self._lock:
            self._busy.extend((buf, event) for buf in bufs)
            self._reclaim()

    def _reclaim(self) -> None:
        busy = self._busy
        while busy and busy[0][1].query():
            buf, _event = busy.popleft()
            if self.allocated > self.capacity:
                self._release(buf)  # trim back to the capacity
            else:
                self._free.setdefault(buf.numel(), []).append(buf)

    def _release(self, buf: torch.Tensor) -> None:
        self.allocated -= buf.numel()
        del self._views[id(buf)]

    def _drop_one_free(self) -> bool:
        for free in self._free.values():
            if free:
                self._release(free.pop())
                return True
        return False


#: card index -> (H2D stream, D2H stream, pinned ring), shared by every
#: CudaDevice bound to that card: the caching allocator keeps freed blocks
#: per stream and the ring keeps its pinned buffers, so an executor that
#: builds its own device reuses both instead of allocating and pinning anew
_ENGINES: Dict[int, Tuple[Any, Any, _PinnedRing]] = {}
_ENGINES_LOCK = threading.Lock()


def _copy_engine(tdev: torch.device) -> Tuple[Any, Any, _PinnedRing]:
    with _ENGINES_LOCK:
        engine = _ENGINES.get(tdev.index)
        if engine is None:
            engine = _ENGINES[tdev.index] = (
                torch.cuda.Stream(tdev), torch.cuda.Stream(tdev),
                _PinnedRing(_PINNED_RING_BYTES))
        return engine


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
            budget = int(budget) << 20
        elif self.is_cuda:
            free, _total = torch.cuda.mem_get_info(self.tdev)
            budget = int(free * 0.85)
        else:
            budget = 4 << 30
        self.mem_used = 0
        #: device index used in Data.copies — assigned at attach
        self.data_index = index
        self.gflops_rating = 100.0  # strongly favour the GPU for eligible tasks
        #: the compute stream (the device's default stream: every body and
        #: kernel), and the card's copy engine: two copy streams and the
        #: pinned host buffers of both directions
        if self.is_cuda:
            self.stream = torch.cuda.default_stream(self.tdev)
            self.h2d_stream, self.d2h_stream, self._pinned = _copy_engine(self.tdev)
        else:
            self.stream = self.h2d_stream = self.d2h_stream = None
            self._pinned = _PinnedRing(_PINNED_RING_BYTES)  # pins nothing
        for key in ("h2d_copies", "d2h_copies", "prefetched_tiles",
                    "stage_batched_tiles", "wb_batches",
                    "wb_sync_fallbacks", "wb_committed", "wb_dropped_stale",
                    "wb_capacity_waits", "wb_drains"):
            self.stats[key] = 0
        #: seconds the transfer lane spent prestaging and the committer
        #: draining (set at detach)
        self.stats["prestage_s"] = self.stats["wb_drain_s"] = 0.0
        self._stats_lock = threading.Lock()

        #: reference gpu_device->mutex collapses to a boolean, flipped
        #: under _lock together with the pending-queue append, closing the
        #: window where two workers could both become manager
        self._manager_active = False
        self._lock = threading.Lock()
        self._pending: Deque[Task] = collections.deque()
        #: submitted computations in submission order (= completion
        #: order: every body runs on the one compute stream)
        self._inflight: Deque[_InFlight] = collections.deque()
        #: eager completion: one compute stream orders computations by
        #: data dependencies already, so successor release need not wait
        #: for device events — the task completes at dispatch and the DAG
        #: streams asynchronously.  0 restores reference-style event
        #: polling (device_gpu.c:1879-1999).
        self._eager = bool(mca_param.register(
            "device", "cuda_eager_complete", 1,
            help="complete device tasks at dispatch; 0 = poll events"))
        #: dual LRU of resident Data keyed by data_id (reference
        #: gpu_mem_lru / gpu_mem_owned_lru)
        self._lru_clean: "collections.OrderedDict[int, Data]" = collections.OrderedDict()
        self._lru_dirty: "collections.OrderedDict[int, Data]" = collections.OrderedDict()
        #: the native zone allocator models the budget's segments
        #: (alignment, fragmentation): data_id -> (offset, nbytes).  Not
        #: buildable raises: there is no other accounting
        from .. import native

        self._zone = native.ZoneAllocator(budget)
        self._offsets: Dict[int, Tuple[int, int]] = {}
        #: residency lock (LRU + accounting): the transfer lane prestages
        #: batch N+1 while the pump thread commits batch N's epilogs.
        #: RLock — the stage/evict/realloc paths nest.  Order: _lock ->
        #: _res_lock -> Data.lock; the committer takes only Data.lock, so
        #: an eviction waiting on it under _res_lock cannot deadlock.
        self._res_lock = threading.RLock()
        #: pipeline depth (runtime_stage_depth): 1 = synchronous transfers
        #: (no prefetch lane, no committer); >= 2 arms both
        self.stage_depth = stage_depth_param()
        self._committer = None
        #: eviction's bounded wait for an async victim commit before the
        #: synchronous fallback (counted in stats["wb_sync_fallbacks"])
        self._wb_wait = 60.0

    @property
    def mem_budget(self) -> int:
        """Device bytes managed for resident tiles: the zone's capacity."""
        return self._zone.capacity

    @mem_budget.setter
    def mem_budget(self, value: int) -> None:
        """A budget change rebuilds the zone, migrating live residency
        slots (slots that no longer fit fall out of segment accounting)."""
        from .. import native

        fresh = native.ZoneAllocator(int(value))
        migrated: Dict[int, Tuple[int, int]] = {}
        for did, (_off, nb) in self._offsets.items():
            noff = fresh.alloc(nb)
            if noff is not None:
                migrated[did] = (noff, nb)
        self._zone.close()
        self._zone = fresh
        self._offsets = migrated
        self.mem_used = fresh.used

    def _bump(self, **counts: float) -> None:
        """Add to transfer counters: the lane, the committer and the
        dispatch thread all move bytes."""
        with self._stats_lock:
            for key, n in counts.items():
                self.stats[key] += n

    @property
    def pinned_bytes(self) -> Tuple[int, int]:
        """(allocated, peak) bytes of pinned host memory the card's copy
        engine holds, for every device bound to the card (0 on the torch
        CPU device, which pins nothing)."""
        return self._pinned.allocated, self._pinned.peak

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
        """Dispatch one native-popped ready batch WITHOUT per-task
        completion: the pump (:mod:`..dsl.native_exec`) retires the whole
        batch afterwards with one ``done_batch`` call, so successor release
        happens in the native engine, not here.  Staging, dispatch, epilog
        and the failure discipline are the manager loop's
        (``_submit_one(complete=False)``); a task whose submit failed fails
        its pool, which the pump reads after the batch.  At stage depth
        >= 2 the pump's transfer lane prestaged the batch's inputs
        (:meth:`prestage_batch`), so their stage-ins are residency hits.
        Runs on the caller's thread — the pump's, which never went through
        :meth:`kernel_scheduler` — so it enters the compute stream itself:
        eager completion is sound only because every body stays on it."""
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
                self._await_copy(arr)
                dev_args.append(arr)
                if mode & AccessMode.OUT:
                    out_specs.append((pos, payload))
                    out_hooks.append(so_hooks.get(data_idx))
            elif kind == "value":
                dev_args.append(payload)
            # other kinds (e.g. "ctl") contribute no argument
        return dev_args, out_specs, out_hooks

    def _await_copy(self, arr) -> None:
        """Order the compute stream after the H2D copy that produced
        ``arr`` and record the block's use there, so the caching allocator
        reuses it only after the compute work queued by then (once: later
        compute work is queued behind the wait)."""
        if getattr(arr, "_ptt_h2d", False):
            self.stream.wait_event(ready_event(arr))
            arr.record_stream(self.stream)
            arr._ptt_h2d = False

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
        if self.is_cuda:
            # the outputs' ready event: the committer's D2H and host reads
            # wait on it; event-polled completion polls it
            event = torch.cuda.Event()
            event.record(self.stream)
            for out in outputs:
                if isinstance(out, torch.Tensor):
                    set_ready_event(out, event)
        inflight = _InFlight(task, outputs, out_specs, out_hooks,
                             None if eager else event)
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

    def _h2d(self, host) -> torch.Tensor:
        """Host->device copy of one ndarray or torch CPU tensor
        (:meth:`_h2d_batch`)."""
        return self._h2d_batch([host])[0]

    def _h2d_batch(self, hosts: List[Any]) -> List[torch.Tensor]:
        """Host->device copies of host tiles (ndarrays, or torch CPU tensors:
        numpy has no bfloat16); always COPIES (on the torch CPU device
        ``torch.from_numpy`` aliases the host array, which CPU bodies mutate
        in place).

        On a GPU, per chunk of at most the pinned ring's capacity: the
        tiles are copied into reused pinned buffers on the calling thread,
        then to device tensors on the H2D stream, each batch of copies a
        single ``_foreach_copy_`` call — few torch calls a tile, since a
        transfer thread that makes many of them waits on the interpreter
        lock behind the dispatch thread.  The destinations are allocated on
        the H2D stream, which waits on nothing, so the copies run beside
        the kernels already queued; the chunk's copy event becomes each
        tile's ready event, which the compute stream waits on before a body
        reads the tile (:meth:`_await_copy`, which also records the block's
        use on the compute stream)."""
        srcs = []
        for host in hosts:
            if isinstance(host, torch.Tensor):
                srcs.append(host)
                continue
            host = np.asarray(host)
            if not host.flags.writeable:
                host = host.copy()  # torch.from_numpy wants a writable array
            srcs.append(torch.from_numpy(host))
        self._bump(h2d_copies=len(srcs))
        if not self.is_cuda:
            return [t.clone() for t in srcs]
        with torch.cuda.stream(self.h2d_stream):
            dsts = [torch.empty(t.shape, dtype=t.dtype, device=self.tdev) for t in srcs]
        moving = [i for i, t in enumerate(srcs) if t.nbytes]
        for chunk in _capacity_chunks([srcs[i].nbytes for i in moving],
                                      self._pinned.capacity):
            chunk = [moving[k] for k in chunk]
            bufs = [self._pinned.get(srcs[j].nbytes) for j in chunk]
            staging = [self._pinned.view(b, srcs[j].dtype, srcs[j].shape)
                       for b, j in zip(bufs, chunk)]
            torch._foreach_copy_(staging, [srcs[j] for j in chunk])
            event = torch.cuda.Event()
            with torch.cuda.stream(self.h2d_stream):
                torch._foreach_copy_([dsts[j] for j in chunk], staging, non_blocking=True)
                event.record(self.h2d_stream)
            self._pinned.put(bufs, event)
            for j in chunk:
                set_ready_event(dsts[j], event)
                dsts[j]._ptt_h2d = True
        return dsts

    def _d2h_batch(self, payloads: List[Any]) -> List[Any]:
        """Device->host copies of ``payloads`` (each a fresh host array, or
        a torch CPU tensor for bfloat16): per chunk of at most the ring's
        capacity, one ``_foreach_copy_`` into pinned buffers on the D2H
        stream after a wait on each distinct ready event (or, for a tensor
        without one, on the compute stream), one event wait, then fresh
        host copies.  The caller holds the payloads until this returns, so
        no D2H read is in flight when one is freed."""
        self._bump(d2h_copies=len(payloads))
        if not self.is_cuda:
            return [host_array(p) for p in payloads]
        hosts: List[Any] = [None] * len(payloads)
        moving = []
        for i, p in enumerate(payloads):
            if isinstance(p, torch.Tensor) and p.is_cuda and p.nbytes:
                moving.append(i)
            else:
                hosts[i] = host_array(p)
        for chunk in _capacity_chunks([int(payloads[i].nbytes) for i in moving],
                                      self._pinned.capacity):
            chunk = [moving[k] for k in chunk]
            for j, host in zip(chunk, self._d2h_chunk([payloads[j] for j in chunk])):
                hosts[j] = host
        return hosts

    def _d2h_chunk(self, payloads: List[torch.Tensor]) -> List[Any]:
        s = self.d2h_stream
        bufs = [self._pinned.get(int(p.nbytes)) for p in payloads]
        pinned = [self._pinned.view(b, p.dtype, p.shape) for b, p in zip(bufs, payloads)]
        events = {id(e): e for e in map(ready_event, payloads) if e is not None}
        done = torch.cuda.Event()
        with torch.cuda.stream(s):
            if len(events) < len(payloads) and any(ready_event(p) is None
                                                   for p in payloads):
                s.wait_stream(self.stream)  # a tensor made outside the bodies
            for event in events.values():
                s.wait_event(event)
            torch._foreach_copy_(pinned, payloads, non_blocking=True)
            done.record(s)
        done.synchronize()
        # fresh host copies (torch's CPU copy runs on the intra-op threads)
        hosts = [v.clone() for v in pinned]
        self._pinned.put(bufs, done)
        return [h if h.dtype == torch.bfloat16 else h.numpy() for h in hosts]

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
            if x.device == self.tdev:
                return x
            return self._h2d(x) if x.device.type == "cpu" else x.to(self.tdev)
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
            self._mem_realloc(data, arr.nbytes)
            self._bump(bytes_in=arr.nbytes)
            self.stats["custom_stage_in"] = self.stats.get("custom_stage_in", 0) + 1
            c = data.attach_copy(self.data_index, arr)
            c.version = newest.version if newest is not None else 0
            c.staged_by = hook
            self._lru_touch(data, dirty=False)
            return arr

    def _stage_plan(self, data: Data):
        """Under ``_res_lock``: what staging ``data`` needs.  Returns None
        for a residency hit (LRU touched), else ``(source, version)`` with
        the residency slot already accounted for the source's bytes."""
        mine = data.get_copy(self.data_index)
        if mine is not None and mine.staged_by is not None:
            # a custom-staged PACKED representation must never be served
            # as the home layout: drop it and restage from the host copy
            self._drop_copy(data, evicted=False)
            mine = None
        newest = data.newest_copy()
        if mine is not None and newest is not None \
                and mine.version >= newest.version and mine.payload is not None:
            self._lru_touch(data, dirty=mine.coherency is Coherency.OWNED)
            return None
        if newest is None:
            raise RuntimeError(f"{data!r}: no valid copy to stage in")
        # re-staging over a stale device copy replaces its slot
        src = newest.payload
        if not isinstance(src, torch.Tensor):
            src = np.asarray(src)
        self._mem_realloc(data, int(src.nbytes))
        return src, newest.version

    def _copy_in(self, srcs: List[Any]) -> List[Tuple[torch.Tensor, str]]:
        """The device copies of staging sources and the counter each moves:
        host tiles (ndarrays, or torch CPU tensors — numpy has no bfloat16)
        in one :meth:`_h2d_batch`, a tensor at another device index
        device-to-device."""
        host = [i for i, src in enumerate(srcs)
                if not (isinstance(src, torch.Tensor) and src.device.type != "cpu")]
        out: List[Any] = [None] * len(srcs)
        for i, arr in zip(host, self._h2d_batch([srcs[i] for i in host])):
            out[i] = (arr, "bytes_in")
        for i, src in enumerate(srcs):
            if out[i] is None:
                out[i] = (src.to(self.tdev, copy=True), "bytes_d2d")
        return out

    def _stage_in(self, data: Data) -> Any:
        """Materialize the newest version of ``data`` on this device."""
        with self._res_lock:
            plan = self._stage_plan(data)
            if plan is None:
                return data.get_copy(self.data_index).payload
            src, version = plan
            [(arr, counter)] = self._copy_in([src])
            self._bump(**{counter: int(src.nbytes)})
            c = data.attach_copy(self.data_index, arr)
            c.version = version
            self._lru_touch(data, dirty=False)
            return arr

    # ------------------------------------------------------------------
    # async staging pipeline: prefetch lane + batched copies
    # ------------------------------------------------------------------
    def _collect_stage_tiles(self, tasks: List[Task]) -> List[Data]:
        """The unique PLAIN input tiles of ``tasks`` — flows the default
        stage-in path will serve: readable, not custom-staged (a hook's
        packed layout is the hook's business), deduplicated per tile."""
        out: List[Data] = []
        seen = set()
        for task in tasks:
            chore = task.selected_chore
            body = chore.body_fn if chore is not None else None
            si_hooks = getattr(body, "_stage_in", None) or {}
            data_idx = -1
            for kind, payload, mode in task.body_args or ():
                if kind != "data":
                    continue
                data_idx += 1
                if payload is None or si_hooks.get(data_idx) is not None:
                    continue
                if not int(mode) & _READS:
                    continue  # write-only: no H2D needed
                if payload.data_id in seen:
                    continue
                seen.add(payload.data_id)
                out.append(payload)
        return out

    def _stage_in_batch(self, datas: List[Data]) -> int:
        """Batched :meth:`_stage_in` for the transfer lane: plan every tile
        under the residency lock (hits touched, slots accounted), copy the
        misses OUTSIDE it — the pump's own stage-ins and epilogs go on
        meanwhile — then attach each copy unless a newer device copy
        landed in between (an epilog, or the pump staging the tile
        itself).  Returns the bytes moved."""
        with self._res_lock:
            plans = []
            for data in datas:
                plan = self._stage_plan(data)
                if plan is not None:
                    plans.append((data,) + plan)
        copies = self._copy_in([src for (_d, src, _v) in plans])
        moved = 0
        with self._res_lock:
            for (data, src, version), (arr, counter) in zip(plans, copies):
                with data.lock:
                    mine = data.get_copy(self.data_index)
                    if mine is not None and mine.payload is not None \
                            and mine.version >= version:
                        continue  # superseded while in flight: drop ours
                    c = data.attach_copy(self.data_index, arr)
                    c.version = version
                self._bump(**{counter: int(src.nbytes)})
                self._lru_touch(data, dirty=False)
                moved += int(src.nbytes)
        self._bump(stage_batched_tiles=len(plans))
        return moved

    def _stage_nbytes(self, data: Data) -> int:
        """The host->device bytes staging ``data`` would move now (0 for a
        residency hit).  Deliberately lock-free: a stale read merely
        mis-sizes a hint or a chunk."""
        newest = data.newest_copy()
        if newest is None or newest.payload is None:
            return 0
        mine = data.get_copy(self.data_index)
        if mine is not None and mine.payload is not None \
                and mine.staged_by is None and mine.version >= newest.version:
            return 0
        return int(getattr(newest.payload, "nbytes", 0))

    def prestage_bytes(self, tasks: List[Task]) -> int:
        """Cheap upper bound on the host->device bytes a prestage of
        ``tasks`` would move — the pump's lane and intra-wave split
        heuristics."""
        return sum(map(self._stage_nbytes, self._collect_stage_tiles(tasks)))

    def prestage_batch(self, tasks: List[Task], stop=None) -> None:
        """Transfer-lane half of the double-buffered pipeline: stage the
        NEXT ready batch's input tiles while the current one computes, so
        the pump's submit pass reuse-hits them.  Moves at most
        ``_LANE_CHUNK_BYTES`` between checks of ``stop`` (a
        ``threading.Event`` the pump sets when it reaches the batch; its
        submit stages what is left).  Fired as a STAGE_IN span;
        HB_STAGE_IN publishes each task's prestage."""
        t0 = time.perf_counter()
        datas = self._collect_stage_tiles(tasks)
        sizes = [self._stage_nbytes(d) for d in datas]
        moving = [d for d, n in zip(datas, sizes) if n]
        span = pins.active(pins.STAGE_IN_BEGIN)
        if span:
            info = {"rank": getattr(self.context, "rank", 0),
                    "id": next(_SPAN_SEQ), "tiles": len(moving), "bytes": 0}
            pins.fire(pins.STAGE_IN_BEGIN, None, info)
        moved = staged = 0
        for chunk in _capacity_chunks([n for n in sizes if n], _LANE_CHUNK_BYTES):
            if stop is not None and stop.is_set():
                break
            moved += self._stage_in_batch([moving[i] for i in chunk])
            staged += len(chunk)
        seconds = time.perf_counter() - t0
        self._bump(prefetched_tiles=staged, prestage_s=seconds)
        if span:
            info = dict(info, bytes=moved, seconds=seconds)
            pins.fire(pins.STAGE_IN_END, None, info)
        if pins.active(pins.HB_STAGE_IN):
            for task in tasks:
                pins.fire(pins.HB_STAGE_IN, None, {"task": task})

    def _wb_committer(self):
        """The write-back committer, armed lazily when the pipeline is on
        (``runtime_stage_depth`` >= 2); None in the synchronous regime."""
        if self.stage_depth <= 1:
            return None
        com = self._committer
        if com is None:
            from .staging import WritebackCommitter

            com = self._committer = WritebackCommitter(self)
        return com

    def flush(self, timeout: float = 300.0) -> None:
        """Write-back barrier: drain every deferred device->host commit (or
        re-raise the committer's sticky error).  :meth:`detach` calls it
        first; call it directly when host tiles must be current while the
        device stays attached.  A no-op at stage depth 1."""
        com = self._committer
        if com is not None:
            com.flush(timeout=timeout)

    # ------------------------------------------------------------------
    # memory budget + dual LRU eviction
    # ------------------------------------------------------------------
    def _evict_one(self) -> bool:
        """Evict one tile: clean first, then write back a dirty one
        (reference device_gpu.c:978-1120 retry/evict loops)."""
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
                    self._writeback_evict(victim)
                self._drop_copy(victim)
                return True
            if self._lru_dirty:
                _, victim = self._lru_dirty.popitem(last=False)
                self._writeback_evict(victim)
                self._drop_copy(victim)
                return True
            return False

    def _writeback_evict(self, victim: Data) -> None:
        """Eviction write-back, routed through the committer when the
        pipeline is on.  The wait is a bounded CAPACITY wait: the victim's
        bytes must be home before its device copy drops, so a wedged or
        failed committer falls back to the synchronous write-back — data
        safety first; the version guard makes the duplicate a no-op.
        Each fallback counts in ``stats["wb_sync_fallbacks"]``."""
        com = self._committer
        if com is not None and com.healthy:
            try:
                com.enqueue(victim)
            except RuntimeError as e:
                # the committer died between the check and the enqueue;
                # its sticky error surfaces at the next epilog or flush
                debug.warning("eviction of %r: committer failed (%s); "
                              "synchronous write-back", victim, e)
            else:
                if com.wait_for(victim.data_id, timeout=self._wb_wait):
                    return
                debug.warning("async write-back of eviction victim %r did not "
                              "land in %.0fs; synchronous write-back",
                              victim, self._wb_wait)
            self._bump(wb_sync_fallbacks=1)
        self._writeback(victim)

    def _mem_realloc(self, data: Data, nbytes: int) -> None:
        """(Re)account ``data``'s residency slot at ``nbytes`` in the zone,
        evicting for space: alignment and fragmentation are modelled, so an
        allocation can fail under budget and trigger eviction.  A copy
        attached from outside was never accounted: it has no slot to
        release.  With nothing left to evict the slot stays unaccounted
        (the caching allocator owns placement)."""
        with self._res_lock:
            # the allocatee must not be its own eviction victim: callers
            # re-touch the LRU right after accounting
            self._lru_clean.pop(data.data_id, None)
            self._lru_dirty.pop(data.data_id, None)
            self._mem_free(data)
            if nbytes > 0:
                off = self._zone.alloc(nbytes)
                while off is None and self._evict_one():
                    off = self._zone.alloc(nbytes)
                if off is not None:
                    self._offsets[data.data_id] = (off, nbytes)
                self.mem_used = self._zone.used

    def _mem_free(self, data: Data) -> None:
        with self._res_lock:
            slot = self._offsets.pop(data.data_id, None)
            if slot is not None:
                self._zone.release(slot[0])
            self.mem_used = self._zone.used

    def _drop_copy(self, data: Data, *, evicted: bool = True) -> None:
        with self._res_lock:
            c = data.detach_copy(self.data_index)
            if c is not None:
                self._mem_free(data)
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

    def _commit_host(self, data: Data, version: int, host) -> bool:
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
        self._bump(bytes_out=int(host.nbytes))
        return True

    def _writeback(self, data: Data) -> None:
        """Synchronous write-back-to-rest of a dirty tile (reference w2r
        tasks, ``parsec_gpu_create_w2r_task``); the committer shares its
        snapshot and commit halves."""
        snap = self._wb_snapshot(data)
        if snap is None:
            return
        payload, version = snap
        self._commit_host(data, version, self._d2h_batch([payload])[0])

    def _writeback_batch(self, datas: List[Data]) -> int:
        """Batched synchronous flush (the ``detach()`` path): snapshot
        every dirty tile, batched D2H copies, guarded commits.  Returns the
        number of tiles committed."""
        snaps = []
        for d in datas:
            snap = self._wb_snapshot(d)
            if snap is not None:
                snaps.append((d, snap[0], snap[1]))
        if not snaps:
            return 0
        span = pins.active(pins.WRITEBACK_BEGIN)
        if span:
            info = {"rank": getattr(self.context, "rank", 0),
                    "id": next(_SPAN_SEQ), "tiles": len(snaps),
                    "bytes": sum(int(getattr(p, "nbytes", 0)) for (_d, p, _v) in snaps)}
            pins.fire(pins.WRITEBACK_BEGIN, None, info)
            t0 = time.perf_counter()
        hosts = self._d2h_batch([p for (_d, p, _v) in snaps])
        committed = 0
        for (data, _p, version), host in zip(snaps, hosts):
            if self._commit_host(data, version, host):
                committed += 1
        self._bump(wb_batches=1)
        if span:
            info = dict(info, seconds=time.perf_counter() - t0)
            pins.fire(pins.WRITEBACK_END, None, info)
        return committed

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
        stays OWNED on device), then hand them to the write-back committer
        when the pipeline is on.  A flow's custom stage_out hook transforms
        the body output first."""
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
                if c is None:
                    c = data.attach_copy(self.data_index, arr)
                else:
                    c.payload = arr
                # the committed value is HOME-layout (stage_out already
                # unpacked): a packed stage_in marker must not survive it
                c.staged_by = None
                self._mem_realloc(data, arr.nbytes)
                data.version_bump(self.data_index)
                self._lru_touch(data, dirty=True)
        com = self._wb_committer()
        if com is not None:
            # OUTSIDE _res_lock: the committer's capacity wait must not
            # stall residency.  It dedups per tile and, without a
            # watermark, drains only for evictions and at the flush, so a
            # tile rewritten by a later task commits its FINAL version
            # once.  A sticky committer error re-raises here and fails the
            # pool through _submit_one.
            for (_pos, data) in inflight.out_specs:
                com.enqueue(data)

    # ------------------------------------------------------------------
    def data_advise(self, data: Data, advice: int) -> None:
        """Reference device.h:76-78: PREFETCH stages the newest version
        onto the device ahead of first use (a normal stage-in, LRU clean);
        WARMUP re-touches a resident copy so eviction passes it over;
        PREFERRED_DEVICE pins the selector (base class).  A hint while the
        manager is active is dropped: tiles stage on demand."""
        if advice in (ADVICE_PREFETCH, ADVICE_WARMUP):
            with self._lock:
                if self._manager_active:
                    return
                if advice == ADVICE_PREFETCH:
                    if data.newest_copy() is None:
                        return  # nothing materialized yet: a hint, not a command
                    self._stage_in(data)
                else:
                    mine = data.get_copy(self.data_index)
                    if mine is not None and mine.payload is not None:
                        self._lru_touch(data, dirty=mine.coherency is Coherency.OWNED)
        else:
            super().data_advise(data, advice)

    def drop_residency(self, data: Data) -> None:
        """Release ``data``'s residency slot WITHOUT a host write-back:
        ownership of the device tensor passes to the caller, who already
        holds the payload (caller code that reads a result and hands the
        buffer on; without this every completed output stays dirty-resident
        until LRU pressure forces its write-back)."""
        with self._lock, self._res_lock:
            self._lru_clean.pop(data.data_id, None)
            self._lru_dirty.pop(data.data_id, None)
            self._drop_copy(data, evicted=False)  # handed over, not evicted

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
        """Drain the write-back committer first (its error re-raises here,
        and the dead committer is discarded so a shared device arms a fresh
        one next run), then flush the remaining dirty tiles home as one
        batched write-back — the version guard makes tiles the committer
        already landed a no-op, so each commits exactly once — and release
        the residency accounting.  The payloads stay attached to their
        Data objects; a later stage-in reuses them unaccounted."""
        com = self._committer
        if com is not None:
            self._committer = None
            try:
                com.flush()
            finally:
                com.close(flush=False)
                self._bump(wb_committed=com.stats["committed"],
                           wb_dropped_stale=com.stats["dropped_stale"],
                           wb_capacity_waits=com.stats["capacity_waits"],
                           wb_drains=com.stats["batches"],
                           wb_drain_s=com.stats["drain_s"])
        with self._res_lock:
            self._writeback_batch(list(self._lru_dirty.values()))
            self._lru_dirty.clear()
            self._lru_clean.clear()
            for (off, _nb) in self._offsets.values():
                self._zone.release(off)
            self._offsets.clear()
            self.mem_used = self._zone.used
