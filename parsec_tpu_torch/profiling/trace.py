"""Binary-style event tracing with a dictionary of event classes.

Reference: ``parsec/profiling.{c,h}`` — per-thread event
buffers, a dictionary of event classes (name, color, info schema —
``parsec_profiling_add_dictionary_keyword``, ``profiling.h:283``),
begin/end key pairs, and offline converters to pandas-able formats
(``tools/profiling/``). Here events buffer per thread and export directly
to the Chrome/Perfetto trace-event JSON format (the modern equivalent of
the reference's ``.prof`` → HDF5 pipeline); a pandas converter is
provided in :func:`to_dataframe`.

Enable via :class:`TaskProfiler` (a PINS subscriber), or log custom spans
with :meth:`Trace.begin` / :meth:`Trace.end`.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from . import pins


class Trace:
    """Event sink. Thread-safe via per-thread buffers merged at dump."""

    def __init__(self, rank: int = 0):
        self.rank = rank
        self._tls = threading.local()
        self._buffers: List[List[dict]] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        #: event-class dictionary (reference dictionary keywords)
        self.dictionary: Dict[str, dict] = {}

    def add_dictionary_keyword(self, name: str, *, color: str = "", info: Optional[dict] = None) -> None:
        self.dictionary[name] = {"color": color, "info": info or {}}

    def _buf(self) -> List[dict]:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = []
            with self._lock:
                self._buffers.append(buf)
        return buf

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- span API --------------------------------------------------------
    def begin(self, name: str, tid: Any = None, **info) -> None:
        self._buf().append({
            "name": name, "ph": "B", "ts": self._now_us(),
            "pid": self.rank, "tid": tid if tid is not None else threading.current_thread().name,
            "args": info,
        })

    def end(self, name: str, tid: Any = None, **info) -> None:
        self._buf().append({
            "name": name, "ph": "E", "ts": self._now_us(),
            "pid": self.rank, "tid": tid if tid is not None else threading.current_thread().name,
            "args": info,
        })

    def instant(self, name: str, tid: Any = None, **info) -> None:
        self._buf().append({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
            "pid": self.rank, "tid": tid if tid is not None else threading.current_thread().name,
            "args": info,
        })

    def counter(self, name: str, value: float) -> None:
        self._buf().append({
            "name": name, "ph": "C", "ts": self._now_us(),
            "pid": self.rank, "tid": 0, "args": {"value": value},
        })

    # -- export ----------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            out: List[dict] = []
            for b in self._buffers:
                out.extend(b)
        out.sort(key=lambda e: e["ts"])
        return out

    def dump(self, path: str) -> int:
        """Write Chrome trace-event JSON (load in Perfetto / chrome://tracing)."""
        evs = self.events()
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms",
                       "metadata": {"dictionary": self.dictionary}}, f)
        return len(evs)

    def to_dataframe(self):
        """Pandas frame of complete spans (reference pbt2ptt → pandas)."""
        import pandas as pd

        return pd.DataFrame([
            {"name": s["name"], "pid": s["pid"], "tid": s["tid"],
             "begin_us": s["begin_us"], "end_us": s["end_us"],
             "dur_us": s["dur_us"], **s["args"]}
            for s in iter_spans(self.events())
        ])


def iter_spans(events: List[dict]) -> List[dict]:
    """Pair B/E events into complete spans; instants become zero-duration
    rows. Tolerates missing pid/tid (legal in Chrome traces). Shared by
    :meth:`Trace.to_dataframe` and the offline tools CLI."""
    open_spans: Dict[tuple, dict] = {}
    rows: List[dict] = []
    for e in sorted(events, key=lambda e: e.get("ts", 0)):
        pid, tid, name = e.get("pid"), e.get("tid"), e.get("name")
        key = (pid, tid, name)
        ph = e.get("ph")
        if ph == "B":
            open_spans[key] = e
        elif ph == "E" and key in open_spans:
            b = open_spans.pop(key)
            rows.append({"name": name, "pid": pid, "tid": tid,
                         "begin_us": b["ts"], "end_us": e["ts"],
                         "dur_us": e["ts"] - b["ts"],
                         "args": b.get("args", {})})
        elif ph == "i":
            rows.append({"name": name, "pid": pid, "tid": tid,
                         "begin_us": e["ts"], "end_us": e["ts"],
                         "dur_us": 0.0, "args": e.get("args", {})})
    return rows


class _PinsModule:
    """Shared subscription lifecycle for PINS-backed trace modules."""

    def __init__(self, trace: Optional[Trace] = None):
        self.trace = trace or Trace()
        self._subs = []

    def _sub(self, site, cb):
        pins.subscribe(site, cb)
        self._subs.append((site, cb))

    def uninstall(self) -> None:
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        self._subs.clear()


class TaskProfiler(_PinsModule):
    """PINS module feeding task lifecycle events into a Trace (reference
    ``mca/pins/task_profiler``)."""

    def install(self) -> "TaskProfiler":
        t = self.trace
        for name in ("exec", "prepare_input", "complete_exec", "schedule", "select"):
            t.add_dictionary_keyword(name)

        def mk(name, getter=None):
            def on_begin(es, payload):
                t.begin(name, tid=_tid(es), **(getter(payload) if getter else {}))

            def on_end(es, payload):
                t.end(name, tid=_tid(es))

            return on_begin, on_end

        b, e = mk("exec", lambda task: {"task": repr(task)})
        self._sub(pins.EXEC_BEGIN, b)
        self._sub(pins.EXEC_END, e)
        b, e = mk("prepare_input", lambda task: {"task": repr(task)})
        self._sub(pins.PREPARE_INPUT_BEGIN, b)
        self._sub(pins.PREPARE_INPUT_END, e)
        b, e = mk("complete_exec", lambda task: {"task": repr(task)})
        self._sub(pins.COMPLETE_EXEC_BEGIN, b)
        self._sub(pins.COMPLETE_EXEC_END, e)
        return self


class CommProfiler(_PinsModule):
    """PINS module feeding comm-protocol events into a Trace (reference:
    the comm thread's profiling stream logging MPI_ACTIVATE /
    MPI_DATA_CTL / MPI_DATA_PLD, ``remote_dep_mpi.c:1198-1200``). Events
    are instants carrying byte counts, so offline validators can pin
    exact message/byte totals (``tests/profiling/check-comms.py``)."""

    #: trace-event names, kept reference-compatible for the validators
    ACTIVATE, DATA_CTL, DATA_PLD = "MPI_ACTIVATE", "MPI_DATA_CTL", "MPI_DATA_PLD"

    def install(self) -> "CommProfiler":
        t = self.trace
        for name, site in ((self.ACTIVATE, pins.COMM_ACTIVATE),
                           (self.DATA_CTL, pins.COMM_DATA_CTL),
                           (self.DATA_PLD, pins.COMM_DATA_PLD)):
            t.add_dictionary_keyword(name)

            def cb(es, info, name=name):
                t.instant(name, tid="comm", **(info or {}))

            self._sub(site, cb)
        return self


def _tid(es) -> Any:
    return f"worker-{es.worker_id}" if es is not None else "external"
