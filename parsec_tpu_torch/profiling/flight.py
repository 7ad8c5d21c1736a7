"""Flight recorder — an always-on bounded ring of runtime events.

The port of :mod:`parsec_tpu.profiling.flight`.  The trace pipeline
(:mod:`.binary`, ``RankTraceSet``) answers "how did this run perform",
but only when it was turned on before the incident.  The flight recorder
answers "what were the last things this context did" after the fact: a
per-thread drop-oldest ring of the same 40-byte event records, cheap
enough to leave on, dumped to ``rank<r>.fr.pbt``

* when a task body fails (``Context._run_task``'s failure path),
* when the stall watchdog fires (:class:`.health.Watchdog`),
* on demand (``tools flightdump`` against a live health endpoint, or
  :func:`dump_all` in-process).

Dumps use the ``PBTRACE1`` encoding and sidecar of :mod:`.binary`, so an
incident yields the artifacts of a traced run: ``read_pbt``, ``tools
merge``, ``tools critpath`` and ``tools hbcheck`` read them unchanged.

Enable per context with ``PARSEC_TPU_FLIGHT=1`` (ring size: MCA
``profiling_fr_events`` per thread; dump directory:
``PARSEC_TPU_FLIGHT_DIR``, default the working directory), or install it
programmatically::

    from parsec_tpu_torch.profiling.flight import FlightRecorder
    fr = FlightRecorder(nranks=1, base_rank=0).install()
    ...
    fr.dump("incidents/run17")        # rank<r>.fr.pbt + sidecars
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import debug, mca_param

__all__ = ["RingTrace", "FlightRecorder", "installed", "dump_all",
           "dump_on_failure"]


class RingTrace:
    """Drop-in for :class:`~parsec_tpu_torch.profiling.binary.BinaryTrace`
    whose storage is a bounded drop-oldest ring per logging thread (no
    native library needed: the recorder works on hosts without a
    toolchain).  ``dump`` writes the same ``PBTRACE1`` binary layout +
    ``.meta.json`` sidecar as the native tracer, so every offline tool
    reads the snapshot unchanged; the sidecar additionally records
    ``flight_recorder: true`` and how many events the ring dropped."""

    def __init__(self, rank: int = 0, capacity: int = 16384):
        self.rank = rank
        self.capacity = max(1, int(capacity))
        #: same epoch semantics as BinaryTrace: record timestamps are
        #: offsets from construction on the shared monotonic clock, so
        #: ``tools merge`` aligns flight snapshots like any trace
        self.epoch_ns = time.monotonic_ns()
        self.clock_offset_ns = 0
        self._keywords: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        #: [(stream_id, ring_deque, thread_name)] — one per thread, in
        #: stream-id order.  Appends are lock-free (a CPython deque
        #: append is a single atomic bytecode effect under the GIL —
        #: this is the per-event hot path and a lock here measurably
        #: slows the mesh); the DUMPER handles the resulting "deque
        #: mutated during iteration" by retrying its snapshot.
        self._rings: List[Any] = []
        self._logged = 0  # events ever logged (not just retained)
        self._closed = False

    # -- dictionary (same contract as BinaryTrace.keyword) ---------------
    def keyword(self, name: str) -> int:
        with self._lock:
            kid = self._keywords.get(name)
            if kid is None:
                kid = self._keywords[name] = len(self._keywords)
            return kid

    def _ring(self):
        r = getattr(self._tls, "ring", None)
        if r is None:
            with self._lock:
                sid = len(self._rings)
                r = (sid, collections.deque(maxlen=self.capacity),
                     threading.current_thread().name)
                self._rings.append(r)
            self._tls.ring = r
        return r

    def _log(self, kid: int, phase: int, event_id: int, info: int) -> None:
        if self._closed:
            return
        sid, ring, _name = self._ring()
        ring.append((sid, kid, phase, 0,
                     time.monotonic_ns() - self.epoch_ns, event_id, info))
        self._logged += 1  # approximate across threads; sidecar metadata

    # -- logging (BinaryTrace interface) ---------------------------------
    def begin(self, kid: int, event_id: int = 0, info: int = 0) -> None:
        self._log(kid, 0, event_id, info)

    def end(self, kid: int, event_id: int = 0, info: int = 0) -> None:
        self._log(kid, 1, event_id, info)

    def instant(self, kid: int, event_id: int = 0, info: int = 0) -> None:
        self._log(kid, 2, event_id, info)

    def counter(self, kid: int, value: int) -> None:
        self._log(kid, 3, value, 0)

    @property
    def total_events(self) -> int:
        """Events currently RETAINED (bounded by capacity × threads)."""
        with self._lock:
            rings = list(self._rings)
        return sum(len(ring) for _sid, ring, _name in rings)

    @staticmethod
    def _snapshot(ring) -> List[tuple]:
        """Copy a ring that its owner thread may be appending to:
        ``list(deque)`` raises RuntimeError when the deque mutates under
        the iteration — retry (appends are fast; a handful of attempts
        always lands between two of them)."""
        for _ in range(64):
            try:
                return list(ring)
            except RuntimeError:
                continue
        return []  # pathologically hot ring: drop it from this snapshot

    # -- dump -------------------------------------------------------------
    def dump(self, path: str) -> int:
        """Snapshot the rings to ``path`` (+ sidecar) in ``PBTRACE1``
        layout; records are ordered per stream (ring order = time order
        within a thread, which is all the offline tools assume).  Safe
        against concurrent logging: each ring is snapshotted with the
        retry discipline of :meth:`_snapshot`.  Returns the number of
        records written."""
        from .binary import MAGIC, _RECORD_DTYPE

        with self._lock:
            rings = list(self._rings)
            names = [None] * len(self._keywords)
            for name, kid in self._keywords.items():
                names[kid] = name
            streams = [""] * len(rings)
        records: List[tuple] = []
        for sid, ring, tname in rings:
            records.extend(self._snapshot(ring))
            streams[sid] = tname
        arr = np.array(records, dtype=_RECORD_DTYPE) if records \
            else np.empty(0, dtype=_RECORD_DTYPE)
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(np.int64(len(arr)).tobytes())
            f.write(arr.tobytes())
        meta = {"rank": self.rank, "keywords": names,
                "streams": streams, "epoch_ns": self.epoch_ns,
                "clock_offset_ns": self.clock_offset_ns,
                "flight_recorder": True,
                "ring_capacity": self.capacity,
                "events_dropped": max(0, self._logged - len(arr))}
        from .binary import _sync_points_for

        sync = _sync_points_for(self.rank)
        if sync:
            meta["clock_sync"] = sync
        extra = getattr(self, "sidecar_extra", None)
        if extra:
            meta.update(extra)
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        return len(arr)

    def close(self) -> None:
        self._closed = True


class FlightRecorder:
    """Bounded always-on event recorder for one (or several in-process)
    rank(s): a :class:`~parsec_tpu_torch.profiling.binary.RankTraceSet` whose
    per-rank sinks are :class:`RingTrace` rings — every routing
    subscriber (task lifecycle, dep edges, comm protocol + transport,
    happens-before kinds) is reused verbatim, so the snapshot carries
    exactly the event vocabulary the offline tools understand."""

    def __init__(self, nranks: int = 1, base_rank: int = 0,
                 capacity: Optional[int] = None, context=None):
        from .binary import RankTraceSet

        #: owning context (set by Context.__init__ for env-installed
        #: recorders): lets a dump snapshot the SERVING state — job
        #: registry + tenant table — into the sidecar, so a post-mortem
        #: names the jobs that were in flight
        self.context = context
        if capacity is None:
            capacity = int(mca_param.register(
                "profiling", "fr_events", 16384,
                help="flight-recorder ring capacity (events retained per "
                     "logging thread; drop-oldest)"))
        self.capacity = capacity
        # lean site set: the recorder is ALWAYS on — it skips the
        # per-select instrumentation (fires on idle polls too) and the
        # prepare_input spans; everything merge/critpath/hbcheck consume
        # is still recorded
        self.set = RankTraceSet(
            nranks, base_rank, lean=True,
            trace_factory=lambda rank: RingTrace(rank=rank,
                                                 capacity=capacity))
        self._installed = False

    # -- lifecycle --------------------------------------------------------
    def install(self) -> "FlightRecorder":
        if not self._installed:
            self.set.install()
            self._installed = True
            with _reg_lock:
                _installed.append(self)
        return self

    def uninstall(self) -> None:
        if self._installed:
            self.set.uninstall()
            self._installed = False
            with _reg_lock:
                if self in _installed:
                    _installed.remove(self)

    def set_clock_offset(self, rank: int, offset_ns: int) -> None:
        self.set.set_clock_offset(rank, offset_ns)

    # -- dump -------------------------------------------------------------
    def _serve_snapshot(self) -> Optional[dict]:
        """The serving state at dump time (job registry incl. queued +
        in-flight rows, tenant table) — None when no service is
        attached.  Best-effort: a snapshot failure must never mask the
        incident being dumped."""
        ctx = self.context
        sv = getattr(ctx, "serve", None) if ctx is not None else None
        if sv is None:
            return None
        try:
            doc = sv.status_doc()
            return {"tenants": doc["tenants"], "jobs": doc["jobs"],
                    "queue": doc["queue"],
                    "jobs_inflight": doc["jobs_inflight"]}
        except Exception as e:  # pragma: no cover - defensive
            debug.warning("flight dump: serve snapshot failed: %s", e)
            return None

    def dump(self, directory: str = ".") -> List[str]:
        """Write one ``rank<r>.fr.pbt`` (+ sidecar) per rank into
        ``directory``; returns the paths.  When the owning context runs
        a serving plane, the sidecar carries a ``serve`` section naming
        the tenants and the jobs in flight at snapshot time."""
        serve = self._serve_snapshot()
        for tr in self.set.traces:
            tr.sidecar_extra = {"serve": serve} if serve else None
        return self.set.dump(directory, suffix=".fr.pbt")


# ---------------------------------------------------------------------------
# process-wide registry: "dump every installed recorder" is the incident
# hook (body failures, watchdog firings, the /flightdump endpoint)
# ---------------------------------------------------------------------------

_installed: List[FlightRecorder] = []
_reg_lock = threading.Lock()
_last_incident_dump = [float("-inf")]  # monotonic ts of the last dump


def installed() -> bool:
    with _reg_lock:
        return bool(_installed)


def default_dir() -> str:
    return os.environ.get("PARSEC_TPU_FLIGHT_DIR", ".")


def dump_all(directory: Optional[str] = None, reason: str = "",
             debounce: float = 0.0) -> List[str]:
    """Snapshot every installed recorder (all in-process ranks) into
    ``directory`` (default ``PARSEC_TPU_FLIGHT_DIR`` or cwd).  Returns
    the written paths; [] when no recorder is installed.

    ``debounce`` (seconds) suppresses the dump when another incident
    dump happened that recently: a failing pool typically takes several
    in-flight bodies down with it, each raising in turn — every later
    dump would OVERWRITE ``rank<r>.fr.pbt`` with a ring that has rolled
    past the root cause.  First dump wins; explicit requests (CLI,
    /flightdump) pass 0 and always snapshot."""
    with _reg_lock:
        recs = list(_installed)
        if not recs:
            return []
        if debounce > 0:
            now = time.monotonic()
            if now - _last_incident_dump[0] < debounce:
                debug.verbose(2, "core", "flight dump suppressed (%s): "
                              "an incident snapshot was written <%gs "
                              "ago and would be overwritten", reason,
                              debounce)
                return []
            # only INCIDENT dumps claim the stamp: an explicit request
            # (CLI, /flightdump) must never make a later real failure's
            # snapshot yield to it
            _last_incident_dump[0] = now
    directory = directory or default_dir()
    paths: List[str] = []
    for fr in recs:
        paths.extend(fr.dump(directory))
    debug.warning("flight recorder: dumped %d snapshot(s) to %s%s",
                  len(paths), directory,
                  f" ({reason})" if reason else "")
    return paths


def dump_on_failure(reason: str) -> List[str]:
    """Incident hook: like :func:`dump_all` but debounced (first dump
    of a failure cascade wins) and guaranteed never to raise (a
    diagnostic dump must not mask the failure it documents)."""
    try:
        return dump_all(reason=reason, debounce=30.0)
    except Exception as e:  # pragma: no cover - defensive
        debug.warning("flight recorder dump failed: %s", e)
        return []
