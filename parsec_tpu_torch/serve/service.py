"""RuntimeService — one persistent context admitting a stream of taskpools.

The port of :mod:`parsec_tpu.serve.service`.  PaRSEC's
``parsec_context_add_taskpool`` is designed for many concurrent taskpools
on one long-lived context; this module is the serving plane built on it:
a :class:`RuntimeService` wraps one
:class:`~parsec_tpu_torch.core.context.Context` and admits jobs from many
*tenants* —

* **submission** — ``service.submit(tenant, taskpool, priority=...,
  deadline=...)`` returns a nonblocking :class:`JobHandle` (``wait`` /
  ``cancel`` / ``status``).  Task priorities compose as (tenant weight,
  job priority, task priority) via :func:`compose_priority`, folded into
  every task through ``Taskpool.priority_base``;
* **admission control and backpressure** — jobs past the live thresholds
  (``serve_max_inflight_pools``, the scheduler backlog against
  ``serve_max_ready_backlog``, and the arena pressure — the larger of the
  live ``arena.global_stats()`` bytes in use and the in-flight jobs'
  declared footprints — against ``serve_arena_budget``) QUEUE; per-tenant
  quotas (``max_queued``) and the service-wide queue bound reject outright
  with :class:`AdmissionError`;
* **fairness** — on a context the service owns, the ``wdrr`` scheduler
  (weighted deficit round robin over per-tenant ready queues,
  :mod:`parsec_tpu_torch.core.sched.wdrr`) keeps a large factorization
  from starving a stream of small jobs;
* **drain and eviction** — ``cancel`` fails one pool (co-resident pools
  keep running), ``drain(tenant)`` evicts a tenant's queue and waits out
  its in-flight jobs, ``close()`` drains everything and finalizes a
  context the service owns;
* **observability** — the service hangs off ``ctx.serve``: ``/status``
  and ``/metrics`` carry per-tenant slices, the watchdog's stall report
  names the tenant whose pool wedged (OBS008), traces carry tenant tags
  for the per-tenant critical path, and the SLO plane
  (:mod:`parsec_tpu_torch.profiling.slo`) observes every job.

Across ranks: a cancel fails the pool on every rank
(:func:`~parsec_tpu_torch.comm.remote_dep.fail_pool_for_context`, the
comm layer's abort broadcast); an admission failure fails it locally.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

from ..core.context import Context
from ..core.taskpool import Taskpool
from ..profiling import pins
from ..utils import debug, mca_param

__all__ = ["AdmissionError", "JobHandle", "RuntimeService", "Tenant",
           "compose_priority", "JOB_PRIORITY_SPAN", "TASK_PRIORITY_SPAN"]


#: field widths of the composed priority: task priorities occupy the low
#: ``TASK_PRIORITY_SPAN`` (every in-repo priority expression tops out at
#: NT*1000, far below it), job priorities the next ``JOB_PRIORITY_SPAN``
#: band, tenant weight the bits above — a lexicographic
#: (weight, job, task) order packed into one int so it survives every
#: existing ``task.priority`` consumer (spq heaps, per-dest send
#: coalescing) unchanged.
TASK_PRIORITY_SPAN = 1 << 20
JOB_PRIORITY_SPAN = 1 << 10


def compose_priority(tenant_weight: int, job_priority: int,
                     task_priority: int = 0) -> int:
    """Pack (tenant weight, job priority, task priority) into one int,
    ordered lexicographically as long as ``|job_priority|`` stays under
    ``JOB_PRIORITY_SPAN`` and task priorities under
    ``TASK_PRIORITY_SPAN`` (out-of-band values degrade gracefully into
    the neighboring field rather than erroring — priorities are hints)."""
    return ((int(tenant_weight) * 2 * JOB_PRIORITY_SPAN
             + int(job_priority)) * TASK_PRIORITY_SPAN
            + int(task_priority))


class AdmissionError(RuntimeError):
    """The service refused a submission outright (quota or queue bound
    exceeded, or the service is closing).  Distinct from backpressure:
    a job the mesh merely has no capacity for right now QUEUES."""


# job lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


class Tenant:
    """Registered identity jobs are submitted under: a fairness weight
    (the wdrr share multiplier) plus admission quotas.  ``max_inflight``
    caps this tenant's concurrently admitted pools (None = service
    limit only); ``max_queued`` bounds its backlog — a submission past
    it is REJECTED (:class:`AdmissionError`), the per-tenant contract
    that one flooding client cannot consume the shared queue."""

    def __init__(self, name: str, weight: int = 1,
                 max_inflight: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 slo_p95_ms: Optional[float] = None):
        self.name = str(name)
        self.weight = max(1, int(weight))
        self.max_inflight = max_inflight
        self.max_queued = max_queued
        #: p95 job-latency SLO target in ms (None = the serve_slo_p95_ms
        #: MCA default; 0 disables).  Evaluated continuously by the SLO
        #: plane (profiling.slo): violating jobs count into
        #: parsec_slo_violations_total, a breached p95 surfaces as OBS009
        self.slo_p95_ms = slo_p95_ms
        # lifetime counters (service lock guards mutation)
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.rejected = 0
        #: tasks retired by this tenant's COMPLETED jobs (live jobs are
        #: summed on top by status_doc, straight from Taskpool.progress)
        self.retired_done = 0

    def __repr__(self) -> str:
        return f"Tenant({self.name}, w={self.weight})"


class JobHandle:
    """Nonblocking handle for one submitted taskpool."""

    def __init__(self, service: "RuntimeService", tenant: Tenant,
                 taskpool: Taskpool, job_id: int, priority: int,
                 deadline: Optional[float], est_bytes: int):
        self.service = service
        self.tenant = tenant
        self.taskpool = taskpool
        self.job_id = job_id
        self.priority = priority
        #: absolute monotonic deadline for ADMISSION (None = wait
        #: forever): a job still queued past it fails instead of
        #: occupying the queue — the client has long stopped caring
        self.deadline = deadline
        #: declared working-set estimate charged against
        #: ``serve_arena_budget`` while the job is in flight (0 = only
        #: the live arena gauge gates)
        self.est_bytes = int(est_bytes)
        #: 64-bit job trace id (profiling.jobtrace) — minted at submit
        #: (derived from the pool name, so every rank of an SPMD mesh
        #: agrees); the handle is the client-facing carrier of it
        self.trace_id = int(getattr(taskpool, "trace_id", 0) or 0)
        self.state = QUEUED
        self.fail_reason: Optional[str] = None
        #: set by RuntimeService.cancel before the pool is failed: the
        #: outcome classifier (CANCELLED vs FAILED) keys off this, not
        #: off fail-reason text
        self._cancel_requested = False
        self.t_submit = time.monotonic()
        self.t_admit: Optional[float] = None
        self.t_done: Optional[float] = None

    # -- queries ----------------------------------------------------------
    @property
    def queue_delay_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-done wall clock — the serving-side latency the
        fairness bench quotes percentiles of."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def status(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "tenant": self.tenant.name,
            "name": self.taskpool.name,
            "trace_id": f"{self.trace_id:016x}" if self.trace_id
            else None,
            "state": self.state,
            "priority": self.priority,
            "queue_delay_s": self.queue_delay_s,
            "latency_s": self.latency_s,
            "fail_reason": self.fail_reason,
            "progress": self.taskpool.progress()
            if self.t_admit is not None else None,
        }

    # -- blocking ---------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until this job leaves the system.  True only for a
        successful completion (False: failed, cancelled, expired, or
        still queued/running at ``timeout``)."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        sv = self.service
        with sv._cv:
            # cv-wait only while QUEUED; a RUNNING job is waited on its
            # pool below, outside the service lock
            while self.state == QUEUED:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                sv._cv.wait(rem if rem is None or rem < 0.2 else 0.2)
        if self.state == RUNNING:
            rem = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            self.taskpool.wait(timeout=rem)
            sv._job_transition(self)
        return self.state == DONE

    def cancel(self) -> bool:
        return self.service.cancel(self)

    def __repr__(self) -> str:
        return (f"JobHandle(#{self.job_id} {self.tenant.name}/"
                f"{self.taskpool.name}: {self.state})")


class RuntimeService:
    """The serving plane over one persistent context (see module doc)."""

    _ids = itertools.count(1)

    def __init__(self, context: Optional[Context] = None, *,
                 nb_cores: Optional[int] = None, fairness: bool = True,
                 scheduler: Optional[str] = None,
                 rank: int = 0, nranks: int = 1, comm=None,
                 devices: Optional[List[str]] = None,
                 cuda_device: Optional[str] = None):
        self._owns_context = context is None
        if context is None:
            if scheduler is None and fairness:
                scheduler = "wdrr"
            # a context the service owns attaches the CUDA module as any
            # Context does: on the card unless cuda_device asks otherwise
            context = Context(nb_cores=nb_cores, scheduler=scheduler,
                              devices=devices, cuda_device=cuda_device,
                              rank=rank, nranks=nranks, comm=comm)
        self.context = context
        # the fairness FLAG must reflect the scheduler actually
        # installed: a caller-provided context keeps its own scheduler,
        # and reporting fairness=on over lfq would promise a starvation
        # protection that does not exist
        installed = getattr(context.scheduler, "mca_name", "")
        if fairness and installed != "wdrr":
            debug.warning(
                "serve: context runs scheduler %r — tenant fairness "
                "(wdrr) is OFF; pass a wdrr-scheduled context or let "
                "the service own one", installed)
        self.fairness = fairness and installed == "wdrr"
        # admission thresholds (all MCA, env-overridable as
        # PARSEC_MCA_serve_*; see parsec_tpu_torch/OPERATIONS.md)
        self.max_inflight_pools = int(mca_param.register(
            "serve", "max_inflight_pools", 8,
            help="max concurrently admitted taskpools per service "
                 "(further jobs queue)"))
        self.max_ready_backlog = int(mca_param.register(
            "serve", "max_ready_backlog", 100000,
            help="scheduler ready-queue depth above which admission "
                 "pauses (backpressure, not rejection)"))
        self.arena_budget = int(mca_param.register(
            "serve", "arena_budget", 0,
            help="arena-pressure budget in bytes: admission pauses "
                 "while the LARGER of the live bytes-in-use gauge and "
                 "the in-flight jobs' declared est_bytes, plus the "
                 "candidate's est_bytes, exceeds it (the max avoids "
                 "double-counting a declared set once it is "
                 "allocated); 0 = unbounded"))
        self.max_queued = int(mca_param.register(
            "serve", "max_queued", 1024,
            help="service-wide admission-queue bound; a submission "
                 "past it raises AdmissionError"))
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[JobHandle] = []
        self._inflight: Dict[int, JobHandle] = {}
        self.tenants: Dict[str, Tenant] = {}
        self._job_ids = itertools.count(1)
        self._closing = False
        self._finalized = False
        #: pump reentrancy latch: True while some frame owns the
        #: admission loop; nested calls set _pump_pending instead of
        #: recursing (see _pump)
        self._pumping = False
        self._pump_pending = False
        self._jobs_done = 0
        self._jobs_failed = 0
        self._jobs_cancelled = 0
        self._jobs_rejected = 0
        self._jobs_expired = 0
        # hang the service off the context: /status, /metrics and the
        # watchdog read per-tenant state through this backref
        context.serve = self
        # SLO plane (profiling.slo): a serving mesh always measures —
        # per-tenant job latency / queue-delay histograms, per-class
        # exec digests (straggler attribution), violation counters.
        # PARSEC_TPU_SLO=0 opts a context out explicitly.
        import os as _os

        if getattr(context, "slo", None) is None \
                and _os.environ.get("PARSEC_TPU_SLO", "") != "0":
            from ..profiling.slo import SloPlane

            context.slo = SloPlane(context)
        # a serving context runs autonomously: admitted pools must progress
        # on the worker streams whether or not any client is inside a
        # JobHandle.wait (a queued client waits passively on the cv)
        context.start()
        self._admitter = threading.Thread(
            target=self._admit_loop,
            name=f"parsec-serve-r{context.rank}", daemon=True)
        self._admitter.start()
        debug.verbose(2, "serve",
                      "service up on rank %d (fairness=%s, inflight<=%d, "
                      "backlog<=%d, arena<=%s)", context.rank, fairness,
                      self.max_inflight_pools, self.max_ready_backlog,
                      self.arena_budget or "inf")

    # ------------------------------------------------------------------
    # tenants
    # ------------------------------------------------------------------
    def tenant(self, name: str, *, weight: Optional[int] = None,
               max_inflight: Optional[int] = None,
               max_queued: Optional[int] = None,
               slo_p95_ms: Optional[float] = None) -> Tenant:
        """Register (or re-tune) a tenant.  Auto-registration via
        :meth:`submit` uses the defaults (weight 1, no quotas,
        ``serve_slo_p95_ms`` SLO target)."""
        with self._lock:
            t = self.tenants.get(name)
            if t is None:
                t = self.tenants[name] = Tenant(name, weight or 1,
                                                max_inflight, max_queued,
                                                slo_p95_ms)
            else:
                if weight is not None:
                    t.weight = max(1, int(weight))
                if max_inflight is not None:
                    t.max_inflight = max_inflight
                if max_queued is not None:
                    t.max_queued = max_queued
                if slo_p95_ms is not None:
                    t.slo_p95_ms = slo_p95_ms
            return t

    # ------------------------------------------------------------------
    # submission + admission
    # ------------------------------------------------------------------
    def submit(self, tenant, taskpool: Taskpool, *, priority: int = 0,
               deadline: Optional[float] = None,
               est_bytes: int = 0) -> JobHandle:
        """Submit one taskpool under ``tenant`` (a name or a
        :class:`Tenant`).  Returns immediately with a
        :class:`JobHandle`; the pool attaches to the context when
        admission control lets it through.  ``priority`` is the job
        band of the composed priority; ``deadline`` (seconds from now)
        bounds how long the job may sit QUEUED; ``est_bytes`` declares
        the job's working set against ``serve_arena_budget``.  Raises
        :class:`AdmissionError` when a quota or queue bound rejects the
        submission outright."""
        with self._lock:
            if isinstance(tenant, Tenant):
                # adopt a caller-constructed Tenant: it must BE the
                # registry entry, or one name would split across two
                # objects with independent quotas and invisible jobs
                have = self.tenants.get(tenant.name)
                if have is None:
                    self.tenants[tenant.name] = tenant
                elif have is not tenant:
                    raise AdmissionError(
                        f"tenant {tenant.name!r} is already registered "
                        f"as a different object — submit by name, or "
                        f"reuse service.tenant({tenant.name!r})")
                t = tenant
            else:
                t = self.tenants.get(str(tenant))
                if t is None:
                    t = self.tenants[str(tenant)] = Tenant(str(tenant))
            if self._closing:
                raise AdmissionError("service is closing")
            t.submitted += 1
            queued_t = sum(1 for h in self._queue if h.tenant is t)
            if t.max_queued is not None and queued_t >= t.max_queued:
                t.rejected += 1
                self._jobs_rejected += 1
                raise AdmissionError(
                    f"tenant {t.name}: {queued_t} job(s) already queued "
                    f">= max_queued={t.max_queued}")
            if len(self._queue) >= self.max_queued:
                t.rejected += 1
                self._jobs_rejected += 1
                raise AdmissionError(
                    f"service queue full ({len(self._queue)} >= "
                    f"serve_max_queued={self.max_queued})")
            h = JobHandle(
                self, t, taskpool, next(self._job_ids), priority,
                (time.monotonic() + deadline) if deadline is not None
                else None, est_bytes)
            self._queue.append(h)
            self._cv.notify_all()
        self._fire_job_pin(pins.JOB_SUBMIT, h)
        # capacity permitting, admit THIS job synchronously (low
        # submit-to-running latency on an idle mesh) — but never do
        # other tenants' attach work on this caller's thread; older
        # queued jobs belong to the admitter
        self._pump(only=h)
        return h

    def _capacity_for(self, h: JobHandle) -> Optional[str]:
        """None when ``h`` may be admitted now, else the reason it must
        keep waiting (the backpressure diagnosis ``status`` shows)."""
        t = h.tenant
        if len(self._inflight) >= self.max_inflight_pools:
            return (f"{len(self._inflight)} pool(s) in flight >= "
                    f"serve_max_inflight_pools={self.max_inflight_pools}")
        if t.max_inflight is not None:
            mine = sum(1 for x in self._inflight.values()
                       if x.tenant is t)
            if mine >= t.max_inflight:
                return (f"tenant {t.name}: {mine} in flight >= "
                        f"max_inflight={t.max_inflight}")
        backlog = int(self.context.scheduler.pending_estimate())
        if backlog > self.max_ready_backlog:
            return (f"ready backlog {backlog} > "
                    f"serve_max_ready_backlog={self.max_ready_backlog}")
        if self.arena_budget > 0:
            from ..data import arena as arena_mod

            live = int(arena_mod.global_stats()["bytes_in_use"])
            declared = sum(x.est_bytes for x in self._inflight.values())
            want = max(live, declared) + h.est_bytes
            if want > self.arena_budget:
                return (f"arena pressure {live} B live / {declared} B "
                        f"declared + {h.est_bytes} B requested > "
                        f"serve_arena_budget={self.arena_budget}")
        return None

    def _admit(self, h: JobHandle) -> None:
        """Attach the pool (service lock held; attach itself outside)."""
        tp, t = h.taskpool, h.tenant
        tp.tenant = t.name
        tp.tenant_weight = t.weight
        tp.job_priority = h.priority
        tp.priority_base = compose_priority(t.weight, h.priority)
        prev_done = tp.on_complete

        def _on_complete(pool, _prev=prev_done):
            if _prev is not None:
                _prev(pool)
            self._job_transition(h)

        tp.on_complete = _on_complete
        h.state = RUNNING
        h.t_admit = time.monotonic()
        t.admitted += 1
        self._inflight[h.job_id] = h
        self._fire_job_pin(pins.JOB_ADMIT, h,
                           queue_delay_s=h.queue_delay_s)

    def _pump(self, only: Optional[JobHandle] = None) -> int:
        """Admit queued jobs current capacity allows.  Reentrancy-safe
        WITHOUT recursion: a pool that terminates synchronously inside
        ``add_taskpool`` re-enters here via on_complete ->
        _job_transition; the nested call just flags a re-run and the
        OWNING frame loops (a backlog of instantly-empty pools must
        not grow the stack by its length) — unless the owner is the
        submit fast path (``only``), which leaves the re-run to the
        admitter: a caller's thread attaches no other job.  Returns
        #admitted."""
        with self._lock:
            if self._pumping:
                self._pump_pending = True
                return 0
            self._pumping = True
        total = 0
        handoff = False
        try:
            while True:
                with self._lock:
                    self._pump_pending = False
                total += self._pump_pass(only)
                with self._lock:
                    if not self._pump_pending:
                        return total
                    if only is not None:
                        # the submit fast path admits its own job only: a
                        # re-run asked for meanwhile (the admitter's, or a
                        # pool that ended inside the attach) is the
                        # admitter's, woken below
                        handoff = True
                        return total
        finally:
            with self._lock:
                self._pumping = False
                if handoff:
                    self._cv.notify_all()

    def _pump_pass(self, only: Optional[JobHandle] = None) -> int:
        """One admission sweep (FIFO with skip: a blocked tenant's job
        must not head-of-line-block a small job a different gate would
        pass).  With ``only``, admission considers just that handle —
        the submit fast path — while deadline expiry still covers
        everyone."""
        to_attach: List[JobHandle] = []
        expired: List[JobHandle] = []
        with self._lock:
            now = time.monotonic()
            keep: List[JobHandle] = []
            for h in self._queue:
                if h.deadline is not None and now >= h.deadline:
                    h.state = FAILED
                    h.fail_reason = ("admission deadline expired after "
                                     f"{now - h.t_submit:.3f}s in queue")
                    h.t_done = now
                    h.tenant.failed += 1
                    self._jobs_expired += 1
                    self._jobs_failed += 1
                    self._fire_job_pin(pins.JOB_DONE, h, state=h.state)
                    expired.append(h)
                    continue
                # NB: closing blocks SUBMISSION, not admission — jobs
                # already accepted keep admitting as capacity frees, so
                # a graceful close (cancel_queued=False) runs the queue
                # dry instead of stranding parked jobs forever
                if (only is not None and h is not only) \
                        or self._capacity_for(h) is not None:
                    keep.append(h)
                    continue
                self._admit(h)
                to_attach.append(h)
            self._queue = keep
            if to_attach or expired:
                self._cv.notify_all()
        # expired jobs ARE latency outcomes: the client waited out its
        # deadline and got a failure.  Skipping them would give the SLO
        # histograms survivorship bias — p95 reads healthy exactly when
        # the mesh is too overloaded to admit (client cancels stay out:
        # an abandonment is the client's choice, not a service miss).
        slo = getattr(self.context, "slo", None)
        if slo is not None:
            for h in expired:
                slo.observe_job(h.tenant.name, h.t_done - h.t_submit,
                                None, target_ms=h.tenant.slo_p95_ms)
        for h in to_attach:
            # attach OUTSIDE the service lock: startup enumerates and
            # schedules real tasks (reentry into _pump via on_complete
            # of an instantly-empty pool must not deadlock)
            if h.taskpool.is_done():
                # a cancel raced the admit: the pool was force-failed
                # before it ever attached — registering it now would
                # leak an _active_taskpools slot nobody can release
                self._job_transition(h)
                continue
            try:
                self.context.add_taskpool(h.taskpool)
                if h.taskpool.is_done():
                    # cancel landed BETWEEN the check and the attach:
                    # the terminating transition saw an unregistered
                    # pool, so undo the registration ourselves
                    # (idempotent if termination already deregistered)
                    self.context._taskpool_terminated(h.taskpool)
                    self._job_transition(h)
            except BaseException as e:
                # the pool must TERMINATE, not just the handle: a client
                # already past the cv loop is blocked in taskpool.wait()
                # and only the pool's _terminated event wakes it
                why = f"admission failed: add_taskpool raised: {e!r}"
                h.taskpool.fail(why)
                self._job_transition(h)
                debug.error("serve: admitting job #%d failed: %s",
                            h.job_id, e)
        return len(to_attach)

    def _job_transition(self, h: JobHandle) -> None:
        """Fold a terminated pool's outcome into the job (idempotent;
        called from on_complete, waiters, and the admitter's sweep)."""
        tp = h.taskpool
        if not tp.is_done():
            return
        with self._lock:
            if h.state not in (RUNNING,):
                return
            h.t_done = time.monotonic()
            # fold the terminal pool's retirements into the tenant on
            # EVERY outcome: the exported parsec_tenant_retired_total is
            # a Prometheus counter and must never decrease when a
            # partially-run job fails or is cancelled
            h.tenant.retired_done += tp.nb_retired
            if tp.failed:
                why = getattr(tp, "fail_reason", None)
                if h.fail_reason is None:
                    h.fail_reason = why or "taskpool failed"
                h.state = CANCELLED if h._cancel_requested else FAILED
                if h.state == CANCELLED:
                    h.tenant.cancelled += 1
                    self._jobs_cancelled += 1
                else:
                    h.tenant.failed += 1
                    self._jobs_failed += 1
            else:
                h.state = DONE
                h.tenant.completed += 1
                self._jobs_done += 1
            self._inflight.pop(h.job_id, None)
            self._cv.notify_all()
        self._fire_job_pin(pins.JOB_DONE, h, state=h.state,
                           latency_s=h.latency_s)
        slo = getattr(self.context, "slo", None)
        if slo is not None and h.state != CANCELLED:
            # completions AND failures are latency outcomes; a client's
            # own cancel is an abandonment, not a service miss
            slo.observe_job(h.tenant.name, h.latency_s, h.queue_delay_s,
                            target_ms=h.tenant.slo_p95_ms)
        self._pump()

    def _fire_job_pin(self, site: str, h: JobHandle, **extra) -> None:
        """One job-lifecycle pin (binary traces record a ``job_phase``
        instant — the queue/admit/run/drain envelope of ``tools
        critpath --job``).  Near-free unless a subscriber is installed."""
        if pins.active(site):
            pins.fire(site, None, {
                "rank": self.context.rank, "trace": h.trace_id,
                "tenant": h.tenant.name, "job_id": h.job_id, **extra})

    def _admit_loop(self) -> None:
        """Background admitter: reacts to completions (notified) and to
        gauge decay the runtime cannot notify about (arena pressure,
        scheduler backlog) on a short poll."""
        while True:
            with self._cv:
                if self._closing and not self._queue \
                        and not self._inflight:
                    return
                self._cv.wait(0.05)
            # sweep in-flight pools that terminated without on_complete
            # (force-fail paths — cancel, watchdog strict, peer abort —
            # skip the completion callback by design)
            for h in list(self._inflight.values()):
                if h.taskpool.is_done():
                    self._job_transition(h)
            self._pump()

    # ------------------------------------------------------------------
    # cancel / drain / shutdown
    # ------------------------------------------------------------------
    def cancel(self, h: JobHandle, reason: str = "") -> bool:
        """Cancel one job.  Queued jobs leave the queue; a running
        job's pool is aborted through the runtime's existing fail path
        (``fail_pool_for_context`` — the same discipline a raising body
        uses, broadcast to every rank of a multi-rank context), so
        co-resident pools are untouched.  True if this call changed the
        job's fate."""
        why = f"cancelled by service: {reason or 'client request'}"
        with self._lock:
            if h.state == QUEUED:
                self._queue.remove(h)
                h.state = CANCELLED
                h.fail_reason = why
                h.t_done = time.monotonic()
                h.tenant.cancelled += 1
                self._jobs_cancelled += 1
                self._cv.notify_all()
                self._fire_job_pin(pins.JOB_DONE, h, state=h.state)
                return True
            if h.state != RUNNING:
                return False
            # unforgeable cancellation marker: _job_transition books the
            # outcome off this flag, never off fail-reason text (a body
            # failure whose message merely CONTAINS "cancelled" must
            # still count as a failure)
            h._cancel_requested = True
        from ..comm.remote_dep import fail_pool_for_context

        changed = fail_pool_for_context(self.context, h.taskpool, why)
        self._job_transition(h)
        return changed

    def drain(self, tenant=None, timeout: Optional[float] = None,
              cancel_queued: bool = True) -> bool:
        """Evict a tenant (or, with ``tenant=None``, everyone): queued
        jobs are cancelled (or, with ``cancel_queued=False``, left to
        admit and run to completion), then every remaining job is
        waited out.  True when nothing of the tenant's remains queued
        or in flight."""
        name = tenant.name if isinstance(tenant, Tenant) else tenant

        def mine(h: JobHandle) -> bool:
            return name is None or h.tenant.name == name

        if cancel_queued:
            with self._lock:
                queued = [h for h in self._queue if mine(h)]
            for h in queued:
                self.cancel(h, reason=f"drain({name or '*'})")
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            with self._lock:
                # queued jobs count as live work either way: with
                # cancel_queued a cancel may still be racing the pump,
                # without it they will admit and run to completion
                live = [h for h in self._inflight.values() if mine(h)] \
                    + [h for h in self._queue if mine(h)]
            if not live:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            rem = None if deadline is None \
                else max(0.01, deadline - time.monotonic())
            live[0].wait(timeout=min(rem, 0.2) if rem is not None
                         else 0.2)

    def close(self, timeout: Optional[float] = None,
              cancel_queued: bool = True) -> bool:
        """Clean service shutdown: stop accepting submissions, drain
        everything (queued jobs are cancelled by default, or run to
        completion with ``cancel_queued=False``), stop the admitter,
        and finalize the context iff this service created it.
        Idempotent.  Returns False — WITHOUT tearing anything down —
        when ``timeout`` expired with jobs still live: finalizing the
        mesh under running pools would strand their waiters forever,
        so the caller keeps a working (but submission-closed) service
        and may close() again."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        ok = self.drain(None, timeout=timeout,
                        cancel_queued=cancel_queued)
        if not ok:
            return False
        with self._cv:
            self._cv.notify_all()
        self._admitter.join(timeout=5)
        if getattr(self.context, "serve", None) is self:
            self.context.serve = None
        if self._owns_context and not self._finalized:
            self._finalized = True
            self.context.fini()
        return True

    # context-manager sugar
    def __enter__(self) -> "RuntimeService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        """Cheap live counters for gauge readers (one lock, no
        per-tenant document build — a metrics scrape reads several of
        these per exposition)."""
        with self._lock:
            return {
                "queued": float(len(self._queue)),
                "inflight": float(len(self._inflight)),
                "done": float(self._jobs_done),
                "failed": float(self._jobs_failed),
                "cancelled": float(self._jobs_cancelled),
                "rejected": float(self._jobs_rejected),
                "expired": float(self._jobs_expired),
                "tenants": float(len(self.tenants)),
            }

    def status_doc(self) -> Dict[str, Any]:
        """Per-tenant serving document (the ``serve`` section of
        ``/status``; ``tools serve-status`` renders it)."""
        slo = getattr(self.context, "slo", None)
        with self._lock:
            queue = [h.status() for h in self._queue]
            inflight = {h.job_id: h for h in self._inflight.values()}
            running = [h.status() for h in inflight.values()]
            tenants: Dict[str, Dict[str, Any]] = {}
            for t in self.tenants.values():
                live = [h for h in inflight.values() if h.tenant is t]
                retired_live = 0
                rate = 0.0
                eta = None
                for h in live:
                    p = h.taskpool.progress()
                    retired_live += p["retired"]
                    rate += p["rate_tasks_per_s"]
                    if p["eta_s"] is not None:
                        eta = max(eta or 0.0, p["eta_s"])
                slo_target = t.slo_p95_ms
                if slo_target is None and slo is not None:
                    slo_target = slo.default_slo_ms or None
                tenants[t.name] = {
                    "weight": t.weight,
                    "max_inflight": t.max_inflight,
                    "max_queued": t.max_queued,
                    "slo_p95_ms": slo_target,
                    "p95_ms": (slo.tenant_p95_ms(t.name)
                               if slo is not None else None),
                    "slo_violations": (
                        slo.violations_by_tenant().get(t.name, 0)
                        if slo is not None else 0),
                    "submitted": t.submitted,
                    "admitted": t.admitted,
                    "completed": t.completed,
                    "failed": t.failed,
                    "cancelled": t.cancelled,
                    "rejected": t.rejected,
                    "inflight": len(live),
                    "queued": sum(1 for h in self._queue
                                  if h.tenant is t),
                    "retired": t.retired_done + retired_live,
                    "rate_tasks_per_s": round(rate, 3),
                    "eta_s": round(eta, 3) if eta is not None else None,
                }
            return {
                "closing": self._closing,
                "fairness": self.fairness,
                "scheduler": self.context.scheduler.mca_name,
                "limits": {
                    "max_inflight_pools": self.max_inflight_pools,
                    "max_ready_backlog": self.max_ready_backlog,
                    "arena_budget": self.arena_budget,
                    "max_queued": self.max_queued,
                },
                "jobs": {
                    "queued": len(queue),
                    "inflight": len(inflight),
                    "done": self._jobs_done,
                    "failed": self._jobs_failed,
                    "cancelled": self._jobs_cancelled,
                    "rejected": self._jobs_rejected,
                    "expired": self._jobs_expired,
                },
                "queue": queue,
                # in-flight job rows (state/progress/ETA/trace id) — the
                # live "what is the mesh doing right now" table `tools
                # top` renders
                "jobs_inflight": running,
                "tenants": tenants,
            }
