"""Software-Defined Events — internal counters exposed by name.

Reference: ``parsec/papi_sde.c`` registers runtime
counters (tasks enabled/retired, scheduler queue lengths) as PAPI
Software-Defined Events (``PARSEC_PAPI_SDE_COUNTER_ADD`` call sites in
``scheduling.c:297-304,458``), so external profilers can read them by
name (``PARSEC::SCHEDULER::PENDING_TASKS`` etc.).

Here the registry is process-local: named monotonic/level counters with
``add``/``set`` semantics, readable by any monitor (and auto-published
into the live-properties :mod:`parsec_tpu_torch.profiling.dictionary`).  The
:class:`SDEModule` PINS subscriber maintains the reference's standard
counter set from the scheduling callback sites; overhead is zero unless
enabled (PINS fire is gated on subscribers).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

from . import dictionary, pins

# the reference's standard counter names (papi_sde.c)
TASKS_ENABLED = "PARSEC::TASKS_ENABLED"
TASKS_RETIRED = "PARSEC::TASKS_RETIRED"
PENDING_TASKS = "PARSEC::SCHEDULER::PENDING_TASKS"
# the reference's serving-side gauge set: the names are part of the
# monitoring contract, so the port declares them all.  The health plane
# (profiling.health.register_context_gauges) registers them per context;
# the comm counters read the context's comm engine (zero without one),
# the collective ones its collective endpoint (zero before its first
# collective)
READY_TASKS = "PARSEC::SCHEDULER::READY_TASKS"
COMM_WIRE_BYTES = "PARSEC::COMM::WIRE_BYTES"
COMM_EAGER_HIT_RATE = "PARSEC::COMM::EAGER_HIT_RATE"
COMM_RDV_PULLS_INFLIGHT = "PARSEC::COMM::RDV_PULLS_INFLIGHT"
ARENA_BYTES_IN_USE = "PARSEC::ARENA::BYTES_IN_USE"
ARENA_BYTES_HIGH_WATER = "PARSEC::ARENA::BYTES_HIGH_WATER"
DEVICE_WAVE_OCCUPANCY = "PARSEC::DEVICE::WAVE_OCCUPANCY"
DEVICE_TASKS_EXECUTED = "PARSEC::DEVICE::TASKS_EXECUTED"
DEVICE_STAGE_PREFETCHED = "PARSEC::DEVICE::STAGE_PREFETCHED"
DEVICE_WRITEBACKS_PENDING = "PARSEC::DEVICE::WRITEBACKS_PENDING"
DEVICE_WRITEBACKS_COMMITTED = "PARSEC::DEVICE::WRITEBACKS_COMMITTED"
DEVICE_WRITEBACKS_DROPPED_STALE = "PARSEC::DEVICE::WRITEBACKS_DROPPED_STALE"
COMPILE_CACHE_HITS = "PARSEC::COMPILE::CACHE_HITS"
COMPILE_CACHE_MISSES = "PARSEC::COMPILE::CACHE_MISSES"
COMPILE_CACHE_BYTES = "PARSEC::COMPILE::CACHE_BYTES"
COMPILE_BCAST_SENT = "PARSEC::COMPILE::BCAST_SENT"
COMPILE_BCAST_RECV = "PARSEC::COMPILE::BCAST_RECV"
COMPILE_LOCAL_ONLY = "PARSEC::COMPILE::LOCAL_ONLY"
COLL_OPS_STARTED = "PARSEC::COLL::OPS_STARTED"
COLL_OPS_DONE = "PARSEC::COLL::OPS_DONE"
COLL_BYTES = "PARSEC::COLL::BYTES"
COLL_SEGMENTS_INFLIGHT = "PARSEC::COLL::SEGMENTS_INFLIGHT"
FUSION_REGIONS_DISPATCHED = "PARSEC::FUSION::REGIONS_DISPATCHED"
FUSION_TASKS_FUSED = "PARSEC::FUSION::TASKS_FUSED"
FUSION_DISPATCH_SAVED = "PARSEC::FUSION::DISPATCH_SAVED"
ARRAY_PROGRAMS_LOWERED = "PARSEC::ARRAY::PROGRAMS_LOWERED"
ARRAY_CLASSES_GENERATED = "PARSEC::ARRAY::CLASSES_GENERATED"
ARRAY_TASKPOOLS_BUILT = "PARSEC::ARRAY::TASKPOOLS_BUILT"
SLO_VIOLATIONS = "PARSEC::SLO::VIOLATIONS"
SLO_STRAGGLER_RANKS = "PARSEC::SLO::STRAGGLER_RANKS"
SERVE_JOBS_QUEUED = "PARSEC::SERVE::JOBS_QUEUED"
SERVE_JOBS_INFLIGHT = "PARSEC::SERVE::JOBS_INFLIGHT"
SERVE_JOBS_DONE = "PARSEC::SERVE::JOBS_DONE"
SERVE_JOBS_REJECTED = "PARSEC::SERVE::JOBS_REJECTED"
SERVE_TENANTS = "PARSEC::SERVE::TENANTS"

_lock = threading.Lock()
_counters: Dict[str, float] = {}
#: callable-backed level counters ("gauges"): read() invokes the getter —
#: the PAPI-SDE *registered-function* counter flavor, vs the accumulated
#: _counters (PAPI_SDE_register_counter vs _register_fp_counter)
_gauges: Dict[str, Callable[[], float]] = {}
_gauge_warned: set = set()


def register_counter(name: str, initial: float = 0) -> None:
    with _lock:
        _counters.setdefault(name, initial)
    dictionary.register_property(f"sde.{name}", lambda n=name: read(n))


def unregister_counter(name: str) -> None:
    with _lock:
        _counters.pop(name, None)
        _gauges.pop(name, None)
        _gauge_warned.discard(name)
    dictionary.unregister_property(f"sde.{name}")


def register_gauge(name: str, getter: Callable[[], float]) -> None:
    """Register a callable-backed counter: ``read(name)`` calls
    ``getter()`` live (queue depths, bytes-in-use — values that cannot be
    maintained by accumulation).  Auto-published into the live-properties
    dictionary like plain counters; unregister with
    :func:`unregister_counter`."""
    with _lock:
        _gauges[name] = getter
    dictionary.register_property(f"sde.{name}", lambda n=name: read(n))


def counter_add(name: str, value: float) -> None:
    """Reference ``PARSEC_PAPI_SDE_COUNTER_ADD`` semantics: create on
    first use, accumulate."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def counter_set(name: str, value: float) -> None:
    with _lock:
        _counters[name] = value


def read(name: str) -> float:
    with _lock:
        getter = _gauges.get(name)
        if getter is None:
            return _counters.get(name, 0)
    try:
        return getter()
    except Exception as e:  # a broken gauge must not kill its reader
        with _lock:
            first = name not in _gauge_warned
            _gauge_warned.add(name)
        if first:
            from ..utils import debug

            debug.warning("sde gauge %r getter raised: %s (read as 0; "
                          "logged once)", name, e)
        return 0.0


def list_counters() -> List[str]:
    with _lock:
        return sorted(set(_counters) | set(_gauges))


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _gauge_warned.clear()


class SDEModule:
    """PINS subscriber maintaining the standard runtime counters.

    * ``TASKS_ENABLED``  — tasks pushed to the scheduler (monotonic);
    * ``TASKS_RETIRED``  — tasks whose completion retired (monotonic);
    * ``PENDING_TASKS``  — enabled minus selected (a queue-length level).
    """

    def __init__(self):
        for name in (TASKS_ENABLED, TASKS_RETIRED, PENDING_TASKS):
            register_counter(name)
        self._subs = [
            # SCHEDULE_BEGIN sees the full batch — the keep-next-task fast
            # path (scheduling.schedule_ready) pops the best task before
            # SCHEDULE_END and hands it to the worker without a scheduler
            # round-trip, so END undercounts
            (pins.SCHEDULE_BEGIN, self._on_schedule),
            # a kept task never passes SELECT either: drain "pending" when
            # execution actually begins
            (pins.EXEC_BEGIN, self._on_exec),
            (pins.COMPLETE_EXEC_END, self._on_retire),
        ]
        for site, cb in self._subs:
            pins.subscribe(site, cb)

    # -- callbacks -------------------------------------------------------
    def _on_schedule(self, es, batch) -> None:
        n = len(batch) if isinstance(batch, (list, tuple)) else 1
        counter_add(TASKS_ENABLED, n)
        counter_add(PENDING_TASKS, n)

    def _on_exec(self, es, task) -> None:
        counter_add(PENDING_TASKS, -1)

    def _on_retire(self, es, task) -> None:
        counter_add(TASKS_RETIRED, 1)

    def disable(self) -> None:
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        # symmetric teardown: stale frozen values must not keep being
        # served as live properties
        for name in (TASKS_ENABLED, TASKS_RETIRED, PENDING_TASKS):
            unregister_counter(name)
