"""Context: worker threads, scheduler installation, taskpool lifecycle.

Mirrors ``parsec/parsec.c`` (``parsec_init``, ``parsec_fini``) and the
context half of ``scheduling.c`` (``parsec_context_add_taskpool`` :832,
``parsec_context_start`` :935, ``parsec_context_wait`` :961, worker loop
``__parsec_context_wait`` :694).

Threading model: ``nb_cores`` execution streams; stream 0 belongs to the
thread calling :meth:`Context.wait` (the reference's master), streams 1..n-1
get dedicated worker threads created at init.  Workers park on a condition
variable with exponential-backoff timed waits when idle.

Device selection: by default the context attaches the CPU device plus the
CUDA device module, bound to ``cuda:<rank % device_count>``.  Without a
GPU that attach raises — nothing falls back to the CPU silently.  The
torch CPU device is used only on request (``cuda_device="cpu"`` here, or
the MCA param ``device_cuda_torch_device=cpu``), and ``devices=["cpu"]``
gives a host-only context with no accelerator module at all.

Single-rank only: comm engines, the compile cache, the ABI check and the
health/flight/watchdog/SLO planes of :class:`parsec_tpu.core.Context` are
not ported yet; asking for one raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..profiling import jobtrace, pins
from ..utils import debug, mca_param, open_component
from ..utils.binding import VPMap
from . import scheduling
from .task import Task
from .taskpool import Taskpool

#: environment switches of reference features the port has not ported yet
#: (env var -> ROADMAP item); a set switch raises instead of being ignored
_UNPORTED_ENV = {
    "PARSEC_TPU_HBCHECK": "A.9 (analysis: hb race checker)",
    "PARSEC_TPU_LOCKDEP": "A.9 (analysis: lockdep)",
    "PARSEC_TPU_ABI_CHECK": "A.9 (analysis: engine-verify ABI lint)",
    "PARSEC_TPU_FLIGHT": "A.9 (profiling: flight recorder)",
    "PARSEC_TPU_HEALTH": "A.9 (profiling: health exporter)",
    "PARSEC_TPU_WATCHDOG": "A.9 (profiling: watchdog)",
    "PARSEC_TPU_SLO": "A.9 (profiling: SLO plane)",
}


class ExecutionStream:
    """Per-worker state (reference ``parsec_execution_stream_t``)."""

    __slots__ = ("worker_id", "vp_id", "context", "next_task", "stats", "sched_obj", "profile")

    def __init__(self, worker_id: int, context: "Context", vp_id: int = 0):
        self.worker_id = worker_id
        self.vp_id = vp_id
        self.context = context
        self.next_task: Optional[Task] = None
        self.stats: Dict[str, int] = {"executed": 0, "selected": 0, "steals": 0}
        self.sched_obj = None  # scheduler-private
        self.profile = None    # profiling stream


class Context:
    """The runtime instance (reference ``parsec_context_t``).

    ``devices`` names the device modules to attach (``None`` = every
    module; the CPU device always attaches first).  ``cuda_device`` binds
    the CUDA device module to an explicit torch device — ``"cpu"`` runs its
    bodies on the torch CPU device, as the tests do."""

    def __init__(
        self,
        nb_cores: Optional[int] = None,
        *,
        scheduler: Optional[str] = None,
        devices: Optional[List[str]] = None,
        cuda_device: Optional[str] = None,
        rank: int = 0,
        nranks: int = 1,
        comm=None,
    ):
        for var, item in _UNPORTED_ENV.items():
            if os.environ.get(var, "0") not in ("", "0"):
                raise NotImplementedError(
                    f"{var} is set, but that feature is not ported yet "
                    f"(ROADMAP {item})")
        if comm is not None or nranks != 1:
            raise NotImplementedError(
                "multi-rank contexts (comm engines) are not ported yet "
                "(ROADMAP A.8)")
        if nb_cores is None:
            nb_cores = mca_param.register(
                "runtime", "num_cores", min(os.cpu_count() or 1, 8),
                help="number of worker execution streams",
            )
        self.nb_workers = max(1, int(nb_cores))
        self.rank = rank
        self.nranks = nranks
        self.comm = None
        self.cuda_device = cuda_device

        sched_name = scheduler or str(mca_param.register(
            "mca", "sched", "", help="scheduler component selection")) or None
        self.scheduler = open_component("sched", sched_name)
        self.scheduler.install(self)

        self.vpmap = VPMap.flat(self.nb_workers)
        self.streams: List[ExecutionStream] = [
            ExecutionStream(i, self, vp_id=self.vpmap.vp_of(i)) for i in range(self.nb_workers)
        ]
        for es in self.streams:
            self.scheduler.flow_init(es)

        # devices (device 0 = CPU; accelerators attach next)
        from ..device import device as devmod

        self.devices = devmod.attach_devices(self, devices)

        self._cv = threading.Condition()
        #: idle-wait cap: every work source notifies the cv, so the cap only
        #: bounds the staleness of polled fallbacks; each idle wake runs a
        #: scheduler select under the GIL, so it must stay generous
        self._idle_backoff_max = mca_param.register(
            "runtime", "idle_backoff_max", 0.02,
            help="max seconds an idle worker sleeps between scheduler "
                 "polls (wakeups are notify-driven; this caps staleness "
                 "of polled fallbacks)")
        #: exclusive ownership of execution stream 0 (the "master" stream):
        #: contended between a wait()-ing thread and non-worker helpers
        self._es0_lock = threading.Lock()
        self._taskpools: Dict[int, Taskpool] = {}
        self._active_taskpools = 0
        self._started = False
        self._shutdown = False
        self._fini_cbs = []
        self._abort_reason = None
        self._tls = threading.local()

        self._threads: List[threading.Thread] = []
        for es in self.streams[1:]:
            t = threading.Thread(target=self._worker_main, args=(es,), name=f"parsec-worker-{es.worker_id}", daemon=True)
            t.start()
            self._threads.append(t)
        debug.verbose(3, "core", "context up: %d workers, sched=%s, devices=%s",
                      self.nb_workers, self.scheduler.mca_name,
                      [d.name for d in self.devices])

    # ------------------------------------------------------------------
    # taskpool lifecycle
    # ------------------------------------------------------------------
    def add_taskpool(self, tp: Taskpool) -> None:
        """Reference ``parsec_context_add_taskpool`` (scheduling.c:832):
        register, run the startup hook, enqueue the initially-ready
        tasks."""
        with self._cv:
            self._taskpools[tp.taskpool_id] = tp
            self._active_taskpools += 1
        tp.attached(self)
        if tp.on_enqueue is not None:
            tp.on_enqueue(tp)
        # hold a runtime action across ready+startup so an empty-looking pool
        # cannot declare termination before its startup tasks are accounted
        tp.tdm.taskpool_addto_runtime_actions(tp, 1)
        tp.tdm.taskpool_ready(tp)
        startup = tp.startup(self)
        if startup:
            scheduling.schedule_ready(self, None, startup)
        tp.tdm.taskpool_addto_runtime_actions(tp, -1)
        self._notify_work()

    def _taskpool_terminated(self, tp: Taskpool) -> None:
        with self._cv:
            if tp.taskpool_id in self._taskpools:
                del self._taskpools[tp.taskpool_id]
                self._active_taskpools -= 1
            self._cv.notify_all()

    def abort(self, reason: str = "") -> None:
        """Cancel all outstanding work (reference ``parsec_abort``,
        ``runtime.h:236`` — softened: the process survives).  Every
        active taskpool terminates as FAILED (its ``wait()`` returns
        False), waiters wake immediately, and the context stays usable
        for new taskpools.  Already-queued tasks of aborted pools are
        discarded lazily at selection time (``_next_task``)."""
        with self._cv:
            self._abort_reason = reason or "aborted"
            pools = list(self._taskpools.values())
        debug.warning("context abort: %s (%d active taskpools)",
                      self._abort_reason, len(pools))
        for tp in pools:
            # atomic against a concurrent normal termination (the pool's
            # _term_lock): whichever side wins, on_complete fires at most
            # once and never after a successful cancellation
            if tp._force_fail():
                self._taskpool_terminated(tp)
        with self._cv:
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # start / wait / test
    # ------------------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            self._started = True
            self._cv.notify_all()

    def test(self) -> bool:
        """Non-blocking: True when no active taskpools remain."""
        with self._cv:
            return self._active_taskpools == 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Master joins the work loop until all taskpools quiesce."""
        self.start()
        return self._participate(lambda: self._active_taskpools == 0, timeout)

    def wait_taskpool(self, tp: Taskpool, timeout: Optional[float] = None) -> bool:
        self.start()
        return self._participate(lambda: tp.is_done(), timeout)

    def _participate(self, done: Callable[[], bool], timeout: Optional[float] = None) -> bool:
        es = self.current_es()
        own_es0 = False
        if es is None:
            # claim stream 0; if another thread drives it, wait passively
            own_es0 = self._es0_lock.acquire(blocking=False)
            es = self.streams[0] if own_es0 else None
            if own_es0:
                self._tls.es = es
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        backoff = 1e-6
        try:
            while True:
                with self._cv:
                    if done():
                        return True
                    if deadline is not None and time.monotonic() >= deadline:
                        return False
                task = self._next_task(es) if es is not None else None
                if task is not None:
                    backoff = 1e-6
                    self._run_task(es, task)
                    continue
                with self._cv:
                    if done():
                        return True
                    self._cv.wait(backoff)
                backoff = min(backoff * 2, self._idle_backoff_max)
        finally:
            if own_es0:
                self._tls.es = None
                self._es0_lock.release()

    # ------------------------------------------------------------------
    # worker internals
    # ------------------------------------------------------------------
    def _next_task(self, es: ExecutionStream) -> Optional[Task]:
        task = es.next_task
        if task is not None:
            es.next_task = None
            if not task.taskpool.failed:
                return task
            # the kept-next fast path must honor an abort too
        pins.fire(pins.SELECT_BEGIN, es, None)
        task = self.scheduler.select(es)
        pins.fire(pins.SELECT_END, es, task)
        # a task of an aborted pool may linger in a queue: discard, don't run
        while task is not None and task.taskpool.failed:
            task = self.scheduler.select(es)
        if task is not None:
            es.stats["selected"] += 1
        return task

    def _worker_main(self, es: ExecutionStream) -> None:
        self._tls.es = es
        backoff = 1e-6
        while True:
            with self._cv:
                if self._shutdown:
                    return
                if not self._started or self._active_taskpools == 0:
                    self._cv.wait(0.05)
                    continue
            task = self._next_task(es)
            if task is None:
                with self._cv:
                    if self._shutdown:
                        return
                    self._cv.wait(backoff)
                backoff = min(backoff * 2, self._idle_backoff_max)
                continue
            backoff = 1e-6
            self._run_task(es, task)

    def _run_task(self, es: ExecutionStream, task: Task) -> None:
        """Progress one task.  A raising body FAILS the pool — loudly and
        immediately, exactly like a device submit failure (reference
        hook-ERROR is fatal, ``scheduling.c:512``): ``wait()`` returns
        False at once, the pool leaves the active set, and its remaining
        queued tasks are discarded by ``_next_task``."""
        es.stats["executed"] += 1
        prev_trace = jobtrace.current()
        jobtrace.set_current(task.taskpool.trace_id)
        try:
            scheduling.task_progress(self, es, task)
        except debug.FatalError:
            raise
        except Exception as e:
            debug.error("worker %d: task %r raised: %s", es.worker_id, task, e)
            traceback.print_exc()
            task.taskpool.fail(f"task {task!r} body raised: {type(e).__name__}: {e}")
            # do NOT run the completion side: successors would consume the
            # failed task's stale data.  A device-manager hook may have
            # ALREADY completed this task before raising on someone else's
            # behalf — task.retired guards that.
            if not task.retired:
                task.taskpool.task_done(task)
        finally:
            jobtrace.set_current(prev_trace)

    def _notify_work(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def current_es(self) -> Optional[ExecutionStream]:
        return getattr(self._tls, "es", None)

    # ------------------------------------------------------------------
    def schedule(self, tasks, es: Optional[ExecutionStream] = None, distance: int = 0) -> None:
        """Public entry to make externally-built tasks runnable."""
        if isinstance(tasks, Task):
            tasks = [tasks]
        scheduling.schedule_ready(self, es, tasks, distance)

    def on_fini(self, cb) -> None:
        """Register a teardown callback, run at the start of :meth:`fini`
        while worker statistics are still intact."""
        self._fini_cbs.append(cb)

    def fini(self) -> None:
        """Reference ``parsec_fini``: drain and tear down.  Detaching the
        devices writes every dirty device tile back to its host copy (the
        write-back committer's flush first); a failed write-back raises
        here."""
        for cb in self._fini_cbs:
            try:
                cb()
            except Exception as e:  # teardown reports must not mask fini
                debug.warning("on_fini callback failed: %s", e)
        self._fini_cbs = []
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        from ..device import device as devmod

        try:
            # flushes each device's write-back committer first; a
            # committer error re-raises here, after every device detached
            devmod.detach_devices(self)
        finally:
            self.scheduler.remove(self)
            debug.verbose(3, "core", "context down")

    # context manager sugar
    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc) -> None:
        self.fini()
