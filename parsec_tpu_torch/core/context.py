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

Opt-in checkers (:mod:`..analysis`), installed before any runtime lock or
thread exists: ``PARSEC_TPU_HBCHECK=1|strict`` (happens-before race
recorder, findings in ``ctx.hb_findings`` at :meth:`Context.fini`),
``PARSEC_TPU_LOCKDEP=1`` (lock-order checker, ``ctx.lock_findings``) and
``PARSEC_TPU_ABI_CHECK=1|strict`` (the engine library's ABI against its
spec).

Live planes, installed last (:mod:`..profiling`): ``PARSEC_TPU_FLIGHT=1``
(the always-on flight recorder, dumped on a body failure, a watchdog
firing or a ``/flightdump`` request), ``PARSEC_TPU_HEALTH=1|<port>`` (the
health exporter on 127.0.0.1: ``/metrics``, ``/status``, ``/healthz``,
``/flightdump``; ``1`` takes an ephemeral port), ``PARSEC_TPU_WATCHDOG=1|
strict`` (the stall watchdog; strict fails stalled pools with its
diagnosis) and ``PARSEC_TPU_SLO=1`` (the SLO plane; a
:class:`~parsec_tpu_torch.serve.RuntimeService` installs one unless it is
``0``).  :meth:`Context.fini` stops and joins them first.

Multi-rank: ``Context(rank=r, nranks=n, comm=ce)`` with ``ce`` one
endpoint of a :class:`~parsec_tpu_torch.comm.InprocFabric` (N ranks in one
process) or this process's :class:`~parsec_tpu_torch.comm.TCPComm` (one
rank a process, :func:`~parsec_tpu_torch.comm.endpoint_from_env` under
the launcher).  Every rank is a full context; taskpools of the
same name on every rank are one logical pool, their cross-rank edges
carried by :mod:`~parsec_tpu_torch.comm.remote_dep`.  Every rank's CUDA
module binds ``cuda:<rank % device_count>``.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..profiling import jobtrace, pins
from ..utils import debug, mca_param, open_component
from ..utils.binding import VPMap, available_cores, bind_current_thread
from . import scheduling
from .task import Task
from .taskpool import Taskpool


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
        # opt-in runtime checkers, installed BEFORE any runtime lock or
        # thread exists so they observe the whole context lifetime
        if os.environ.get("PARSEC_TPU_HBCHECK", "0") not in ("", "0"):
            from ..analysis import hb as _hb

            _hb.ensure_live()
        if os.environ.get("PARSEC_TPU_LOCKDEP", "0") not in ("", "0"):
            from ..analysis import lockdep as _lockdep

            _lockdep.install()
        abi_mode = os.environ.get("PARSEC_TPU_ABI_CHECK", "0").strip().lower()
        if abi_mode not in ("", "0"):
            self._abi_check(strict=abi_mode == "strict")
        if nb_cores is None:
            nb_cores = mca_param.register(
                "runtime", "num_cores", min(os.cpu_count() or 1, 8),
                help="number of worker execution streams",
            )
        self.nb_workers = max(1, int(nb_cores))
        self.rank = rank
        self.nranks = nranks
        self.comm = comm  # comm engine (None = single process)
        self.cuda_device = cuda_device

        # the program cache (captured programs in this process), made
        # before the devices attach, as the reference's executable cache
        from .. import compile_cache

        self.compile_cache = compile_cache.for_context(self)

        sched_name = scheduler or str(mca_param.register(
            "mca", "sched", "", help="scheduler component selection")) or None
        self.scheduler = open_component("sched", sched_name)
        self.scheduler.install(self)

        # virtual-process map and optional core binding (reference vpmap.c
        # + bindthread.c; see utils/binding.py); an invalid map is fatal
        try:
            self.vpmap = VPMap.from_param(self.nb_workers)
        except ValueError as e:
            debug.fatal("%s", e)
        self._bind_threads = bool(mca_param.register(
            "runtime", "bind_threads", False,
            help="pin worker threads to cores round-robin"))
        self._cores = available_cores()
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
        if self.comm is not None:
            self.comm.attach_context(self)
        #: the serving plane (a RuntimeService hangs itself here)
        self.serve = None
        self._install_live_planes()

    def _install_live_planes(self) -> None:
        """The opt-in live planes, installed last (module docstring)."""
        self.flight = None
        self.health = None
        self.watchdog = None
        self.slo = None
        if os.environ.get("PARSEC_TPU_FLIGHT", "0") not in ("", "0"):
            from ..profiling.flight import FlightRecorder

            self.flight = FlightRecorder(
                nranks=1, base_rank=self.rank, context=self).install()
        hp = os.environ.get("PARSEC_TPU_HEALTH", "")
        if hp not in ("", "0"):
            from ..profiling.health import HealthServer

            port = int(hp) + self.rank if hp.isdigit() and hp != "1" else 0
            self.health = HealthServer(self, port=port).start()
        wd = os.environ.get("PARSEC_TPU_WATCHDOG", "0")
        if wd not in ("", "0"):
            from ..profiling.health import Watchdog

            self.watchdog = Watchdog(
                self, strict=(wd.strip().lower() == "strict")).start()
        if os.environ.get("PARSEC_TPU_SLO", "0") not in ("", "0"):
            from ..profiling.slo import SloPlane

            self.slo = SloPlane(self)

    def _abi_check(self, strict: bool) -> None:
        """``PARSEC_TPU_ABI_CHECK`` startup lint: the engine's ABI spec
        against the sources, and against the built library when there is
        one (ENG001-ENG006), before any ctypes call crosses the boundary.
        ``strict`` raises on error findings; otherwise they are logged.
        A library not built yet is not a finding: its first use builds
        it from the sources the spec was just checked against."""
        from .. import native
        from ..analysis.findings import LintError, errors_of
        from ..native import abi as _abi

        lib = os.path.join(native.BUILD_DIR, native.LIB_NAME)
        findings = _abi.abi_findings(lib if os.path.exists(lib) else None,
                                     native.SRC_DIR)
        for f in findings:
            debug.warning("abi-check: %s", f)
        if strict and errors_of(findings):
            raise LintError(
                f"PARSEC_TPU_ABI_CHECK=strict: {lib} drifted from the ABI "
                f"spec ({len(findings)} finding(s))", findings)

    # ------------------------------------------------------------------
    # taskpool lifecycle
    # ------------------------------------------------------------------
    def add_taskpool(self, tp: Taskpool) -> None:
        """Reference ``parsec_context_add_taskpool`` (scheduling.c:832):
        register, notify the comm layer, run the startup hook, enqueue the
        initially-ready tasks."""
        # Distributed termdet monitors (fourcounter) bind to the comm
        # engine and are driven from the idle loop (_progress_comm); one
        # distributed monitor per CE at a time — the TERMDET tag and
        # piggyback channel are single-slot.  The slot decision happens
        # FIRST, before the pool is registered anywhere: a refusal must
        # not leave a half-registration, and a tdm swap must happen before
        # attached() counts into it or the comm layer can deliver for it.
        if self.comm is not None:
            tdm = tp.tdm
            if hasattr(tdm, "bind") and getattr(tdm, "ce", None) is None:
                with self._cv:  # atomic slot claim across adder threads
                    claimed = getattr(self.comm, "_termdet_bound",
                                      None) is None
                    if claimed:
                        self.comm._termdet_bound = tdm
                if claimed:
                    tdm.bind(self.comm)
                elif getattr(tp, "auto_count", False):
                    # an UNBOUND fourcounter monitor has no wave driver and
                    # can never declare termination, and dynamic discovery
                    # (DTD) NEEDS it to see in-flight remote activations
                    raise RuntimeError(
                        f"taskpool {tp.name}: comm engine already "
                        "carries a distributed termdet monitor and "
                        "this pool's task count is dynamically "
                        "discovered — one fourcounter pool at a time "
                        "(wait for the bound pool to finish first)")
                else:
                    # front ends that keep their own accounting (PTG:
                    # pre-counted local tasks + write-back runtime
                    # actions) are correct under local termdet
                    from .termdet import TermDetLocal

                    debug.warning(
                        "taskpool %s: comm engine already carries a "
                        "distributed termdet monitor; falling back to "
                        "local termdet (one fourcounter pool at a time)",
                        tp.name)
                    fresh = TermDetLocal()
                    fresh.monitor_taskpool(tp, tp._termination_detected)
                    tp.tdm = fresh
        with self._cv:
            self._taskpools[tp.taskpool_id] = tp
            self._active_taskpools += 1
        tp.attached(self)
        if tp.on_enqueue is not None:
            tp.on_enqueue(tp)
        if self.comm is not None:
            self.comm.new_taskpool(tp)
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
        self._progress_comm()
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
                self._progress_comm()
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
        if self._bind_threads:
            bind_current_thread(self.vpmap.core_for(es.worker_id, self._cores))
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
        queued tasks are discarded by ``_next_task``.  With nranks > 1
        the failure is broadcast (``fail_pool_for_context``) so healthy
        peer ranks abort at once instead of waiting out their timeout."""
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
            why = f"task {task!r} body raised: {type(e).__name__}: {e}"
            from ..comm.remote_dep import fail_pool_for_context

            fail_pool_for_context(self, task.taskpool, why)
            # the incident's artifact: the flight recorder's last events
            # (a no-op unless PARSEC_TPU_FLIGHT installed one; never raises)
            from ..profiling import flight as _flight

            _flight.dump_on_failure(why)
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

    def _progress_comm(self) -> None:
        """Drive the comm engine (deliver what arrived) and the bound
        distributed termdet monitor's wave (rank 0, rate-limited)."""
        if self.comm is not None:
            self.comm.progress_nonblocking()
            tdm = getattr(self.comm, "_termdet_bound", None)
            if tdm is not None:
                tdm.idle_progress()

    def help_execute_one(self) -> bool:
        """Execute one ready task on the calling thread if safely possible
        (DTD's insertion window and ``wait``).  Worker threads use their
        own stream; other threads borrow stream 0 under its ownership
        lock.  The task runs through the same progress path as a worker's,
        so a CUDA chore goes through its device module's
        ``kernel_scheduler`` (the compute stream, its events), never
        through a host body.  Returns True if a task ran."""
        es = self.current_es()
        if es is not None:
            task = self._next_task(es)
            if task is not None:
                self._run_task(es, task)
                return True
            return False
        if not self._es0_lock.acquire(blocking=False):
            return False  # someone else drives stream 0; let them progress
        try:
            es = self.streams[0]
            self._tls.es = es
            task = self._next_task(es)
            if task is not None:
                self._run_task(es, task)
                return True
            return False
        finally:
            self._tls.es = None
            self._es0_lock.release()

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
        here.  The live planes stop first: the watchdog must not read the
        teardown as a stall, nor the exporter serve a context being taken
        apart."""
        for attr in ("watchdog", "health"):
            obj = getattr(self, attr, None)
            if obj is not None:
                try:
                    obj.stop()
                except Exception as e:
                    debug.warning("%s stop failed: %s", attr, e)
                setattr(self, attr, None)
        for attr in ("flight", "slo"):
            obj = getattr(self, attr, None)
            if obj is not None:
                obj.uninstall()
                setattr(self, attr, None)
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
        if self.comm is not None:
            self.comm.detach_context(self)
        from ..device import device as devmod

        try:
            # flushes each device's write-back committer first; a
            # committer error re-raises here, after every device detached
            devmod.detach_devices(self)
        finally:
            self.scheduler.remove(self)
        # env-driven checker reports (PARSEC_TPU_HBCHECK / LOCKDEP):
        # findings land on the context, are logged, and strict hb-check
        # raises
        if os.environ.get("PARSEC_TPU_HBCHECK", "0") not in ("", "0"):
            from ..analysis import hb as _hb

            self.hb_findings = _hb.live_report()
        if os.environ.get("PARSEC_TPU_LOCKDEP", "0") not in ("", "0"):
            from ..analysis import lockdep as _lockdep

            chk = _lockdep.checker()
            if chk is not None:
                self.lock_findings = chk.findings()
                for f in self.lock_findings:
                    debug.warning("lockdep: %s", f)
        debug.verbose(3, "core", "context down")

    # context manager sugar
    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc) -> None:
        self.fini()
