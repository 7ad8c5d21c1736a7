"""Multi-rank trace alignment and merge.

The port of :mod:`parsec_tpu.profiling.merge`.  Reference role: PaRSEC
dumps one binary ``.prof`` per rank and the offline tools
(``dbpreader.c`` multi-file mode, ``profile2h5 --merge``) stitch them into
one timeline.  Here:

* :func:`clock_handshake` — the pool-start handshake: every rank
  estimates its monotonic-clock offset to rank 0 over the comm engine
  (ping/pong on ``TAG_CTL``, midpoint method, best-of-N by minimum RTT —
  the classic Cristian estimate).  In-process ranks share the clock and
  measure ~0; :func:`last_handshake` keeps each rank's best sample and
  its round-trip time;
* :func:`merge_traces` — read per-rank ``.pbt`` dumps (or Chrome JSON),
  place every rank's events on one global timeline
  (``epoch_ns - clock_offset_ns + ts``), and emit ONE Chrome/Perfetto
  trace with one process track per rank (``pid`` = rank, labeled via
  ``process_name`` metadata events), job-stitched by
  :func:`annotate_jobs`.

The sidecar's ``epoch_ns`` is Python's ``time.monotonic_ns()`` and the
records' timestamps are the native tracer's ``steady_clock``: both read
``CLOCK_MONOTONIC`` on Linux, so a dump's events land where they ran.

CLI: ``python -m parsec_tpu_torch.profiling.tools merge rank*.pbt -o all.json``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils import debug

#: alignment tolerance the tests pin: same-process ranks must land
#: within this of each other after epoch alignment (python-side epoch
#: capture vs the native t0 costs single-digit microseconds)
ALIGN_TOLERANCE_US = 2000.0


# ---------------------------------------------------------------------------
# periodic clock re-sync (long-lived meshes drift past the pool-start
# handshake; the watchdog piggybacks re-handshakes on its heartbeat
# channel and records the samples here — every trace sidecar written
# afterwards carries them, and merge applies a piecewise-linear
# correction instead of one constant offset)
# ---------------------------------------------------------------------------

_sync_lock = threading.Lock()
#: rank -> [(t_local_monotonic_ns, offset_ns_to_rank0), ...] in time order
_sync_points: Dict[int, List[Tuple[int, int]]] = {}
#: retained samples per rank: at the default 60 s resync interval this
#: covers ~17 hours; beyond it the oldest samples are dropped (the
#: piecewise correction only needs the series spanning the trace)
SYNC_POINTS_MAX = 1024


def record_sync_point(rank: int, t_local_ns: int, offset_ns: int) -> None:
    """Record one clock-offset sample for ``rank`` (local monotonic
    timestamp, measured offset to rank 0).  Called by the pool-start
    handshake and by the watchdog's periodic re-sync."""
    with _sync_lock:
        pts = _sync_points.setdefault(int(rank), [])
        pts.append((int(t_local_ns), int(offset_ns)))
        pts.sort()
        if len(pts) > SYNC_POINTS_MAX:
            del pts[:len(pts) - SYNC_POINTS_MAX]


def reset_sync_points_for(rank: int) -> None:
    """Drop one rank's sample series.  Called when a NEW mesh starts
    for that rank (pool-start handshake, watchdog construction):
    offsets measured against a previous mesh's rank 0 are meaningless
    for the new clock domain and would corrupt the piecewise
    interpolation of every later trace."""
    with _sync_lock:
        _sync_points.pop(int(rank), None)


def sync_points_for(rank: int) -> List[Tuple[int, int]]:
    with _sync_lock:
        return list(_sync_points.get(int(rank), ()))


def reset_sync_points() -> None:
    with _sync_lock:
        _sync_points.clear()
        _handshakes.clear()


def _offset_at(points: List[Tuple[int, int]], t_ns: float) -> float:
    """Piecewise-linear offset estimate at local time ``t_ns``: linear
    interpolation between samples; constant before the first; beyond the
    last, extrapolated along the last segment's drift rate (a steadily
    drifting clock keeps drifting after the final sample)."""
    if not points:
        return 0.0
    if len(points) == 1 or t_ns <= points[0][0]:
        return float(points[0][1])
    for (t0, o0), (t1, o1) in zip(points, points[1:]):
        if t_ns <= t1:
            if t1 == t0:
                return float(o1)
            f = (t_ns - t0) / (t1 - t0)
            return o0 + (o1 - o0) * f
    (t0, o0), (t1, o1) = points[-2], points[-1]
    if t1 == t0:
        return float(o1)
    rate = (o1 - o0) / (t1 - t0)  # ns of offset per local ns: the drift
    return o1 + (t_ns - t1) * rate


#: rank -> the last handshake's best sample ``{"offset_ns", "rtt_ns",
#: "pings"}`` (what a run prints beside its merged trace)
_handshakes: Dict[int, Dict[str, int]] = {}


def last_handshake(rank: int) -> Optional[Dict[str, int]]:
    """The best (minimum round-trip) sample of ``rank``'s last
    :func:`clock_handshake`: offset and round-trip time in ns, and the
    pings it took; None before its first handshake or on rank 0."""
    with _sync_lock:
        got = _handshakes.get(int(rank))
        return dict(got) if got is not None else None


def clock_handshake(ce, *, pings: int = 8, timeout: float = 10.0) -> int:
    """Collective clock-alignment handshake at pool start: every rank
    calls this concurrently; returns this rank's estimated monotonic
    offset to rank 0 in ns (``local - rank0``; 0 on rank 0).

    Protocol (over ``TAG_CTL`` active messages): each rank != 0 sends
    ``pings`` pings, rank 0's handler answers each with its own clock,
    and the sample with the smallest round-trip wins (offset error is
    bounded by rtt/2).  Rank 0 progresses until every peer reports done.
    Every waiting rank progresses its engine itself: the in-process
    fabric moves only when a thread waits on it, and no pool runs yet.
    A timed-out handshake degrades loudly to offset 0 — tracing must
    never fail the run it observes."""
    from ..comm.engine import TAG_CTL

    nranks = getattr(ce, "nranks", 1)
    if nranks <= 1:
        return 0
    rank = getattr(ce, "rank", 0)
    state: Dict[str, Any] = {"pong": None, "done": 0}
    cv = threading.Condition()

    def on_ctl(src: int, msg: dict) -> None:
        op = msg.get("op")
        if op == "clk_ping":
            ce.send_am(TAG_CTL, src, {
                "op": "clk_pong", "seq": msg["seq"], "t0": msg["t0"],
                "t_ref": time.monotonic_ns()})
        elif op == "clk_pong":
            with cv:
                state["pong"] = msg
                cv.notify_all()
        elif op == "clk_done":
            with cv:
                state["done"] += 1
                cv.notify_all()

    # share TAG_CTL through the engine's op multiplexer: the watchdog's
    # heartbeat channel (profiling.health) lives on the same tag
    if hasattr(ce, "register_ctl"):
        for op in ("clk_ping", "clk_pong", "clk_done"):
            ce.register_ctl(op, on_ctl)
    else:  # bare test doubles without the CommEngine base
        ce.register_am(TAG_CTL, on_ctl)
    deadline = time.monotonic() + timeout
    if rank == 0:
        # serve pings until every peer confirmed its estimate
        while True:
            ce.progress_nonblocking()
            with cv:
                if state["done"] >= nranks - 1:
                    return 0
                cv.wait(0.001)
            if time.monotonic() > deadline:
                debug.warning(
                    "clock handshake: rank 0 timed out with %d/%d peers "
                    "done; offsets default to 0",
                    state["done"], nranks - 1)
                return 0
    best: Optional[Tuple[int, int]] = None  # (rtt_ns, offset_ns)
    for i in range(pings):
        with cv:
            state["pong"] = None
        ce.send_am(TAG_CTL, 0,
                   {"op": "clk_ping", "seq": i, "t0": time.monotonic_ns()})
        # a ping racing ahead of rank 0's handler registration can be
        # dropped (inproc warns on unregistered tags): resend until the
        # pong lands; rtt/offset use the ECHOED t0, so a pong matching a
        # superseded ping just measures a large rtt and loses best-of-N
        resend_at = time.monotonic() + 0.05
        pong = None
        while pong is None:
            ce.progress_nonblocking()
            with cv:
                p = state["pong"]
                if p is not None and p["seq"] == i:
                    pong = p
                else:
                    cv.wait(0.0005)
            now = time.monotonic()
            if pong is None and now > resend_at:
                ce.send_am(TAG_CTL, 0, {"op": "clk_ping", "seq": i,
                                        "t0": time.monotonic_ns()})
                resend_at = now + 0.05
            if now > deadline:
                debug.warning("clock handshake: rank %d timed out at "
                              "ping %d; offset defaults to 0", rank, i)
                ce.send_am(TAG_CTL, 0, {"op": "clk_done", "rank": rank})
                return best[1] if best is not None else 0
        t1 = time.monotonic_ns()
        t0 = pong["t0"]
        rtt = t1 - t0
        off = (t0 + t1) // 2 - pong["t_ref"]
        if best is None or rtt < best[0]:
            best = (rtt, off)
    ce.send_am(TAG_CTL, 0, {"op": "clk_done", "rank": rank})
    if best is not None:
        # first clock-sync sample of a NEW mesh for this rank: the
        # previous mesh's series (offsets against a rank 0 that no
        # longer exists) is dropped, the watchdog's periodic
        # re-handshake appends later ones and merge interpolates
        reset_sync_points_for(rank)
        record_sync_point(rank, time.monotonic_ns(), best[1])
        with _sync_lock:
            _handshakes[int(rank)] = {"offset_ns": int(best[1]),
                                      "rtt_ns": int(best[0]),
                                      "pings": int(pings)}
    return best[1] if best is not None else 0


# ---------------------------------------------------------------------------
# offline merge
# ---------------------------------------------------------------------------

def _load_one(path: str) -> Tuple[List[dict], Dict[str, Any]]:
    """(events, meta) for one per-rank trace: ``.pbt`` binary (events in
    µs relative to the tracer epoch, sidecar carries epoch/offset) or a
    Chrome JSON dump (aligned only if its metadata carries epoch_ns)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == b"PBTRACE1":
        from .binary import read_pbt_meta, to_chrome_events

        return to_chrome_events(path), read_pbt_meta(path)
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return doc, {}
    return doc.get("traceEvents", []), doc.get("metadata", {})


def merge_traces(paths: Sequence[str], out: Optional[str] = None, *,
                 jobs: bool = True) -> dict:
    """Merge per-rank traces into one Chrome/Perfetto document with one
    process track per rank.

    Per-trace events are shifted onto the global timeline by
    ``epoch_ns - clock_offset_ns`` (rank 0's clock is the reference; the
    earliest aligned trace becomes t=0).  A sidecar carrying
    ``clock_sync`` samples (the watchdog's periodic re-handshake on a
    long-lived mesh) gets the PIECEWISE-LINEAR correction instead — the
    offset interpolated at each event's local timestamp, so a drifting
    rank stays aligned hours after the pool-start handshake.  Traces
    without an epoch (hand-written JSON) pass through unshifted.

    With ``jobs=True`` (default) the merged document is job-stitched
    (:func:`annotate_jobs`): every job-attributable event gains
    ``args.trace_id`` and each job gets ONE track group with its
    queue/admit/run/drain phase row — the per-job Perfetto timeline.
    Returns the document; with ``out`` it is also written to disk."""
    loaded = [_load_one(p) for p in paths]
    bases: List[Optional[int]] = []
    for _evs, meta in loaded:
        epoch = meta.get("epoch_ns")
        bases.append(None if epoch is None
                     else int(epoch) - int(meta.get("clock_offset_ns", 0)))
    known = [b for b in bases if b is not None]
    t0 = min(known) if known else 0

    ranks: List[int] = []
    merged: List[dict] = []
    for (evs, meta), base in zip(loaded, bases):
        rank = int(meta.get("rank", evs[0].get("pid", 0) if evs else 0))
        ranks.append(rank)
        sync = [(int(t), int(o)) for t, o in meta.get("clock_sync", ())]
        sync.sort()
        epoch = meta.get("epoch_ns")
        if sync and epoch is not None:
            # piecewise-linear: offset evaluated at the event's LOCAL
            # absolute time, so drift accumulated between re-syncs is
            # taken out sample by sample
            epoch = int(epoch)
            for e in evs:
                e = dict(e)
                t_local = epoch + float(e.get("ts", 0.0)) * 1e3
                off = _offset_at(sync, t_local)
                e["ts"] = (t_local - off - t0) / 1e3
                e.setdefault("pid", rank)
                merged.append(e)
            continue
        shift_us = 0.0 if base is None else (base - t0) / 1e3
        for e in evs:
            e = dict(e)
            e["ts"] = float(e.get("ts", 0.0)) + shift_us
            e.setdefault("pid", rank)
            merged.append(e)
    merged.sort(key=lambda e: e["ts"])
    labels = [{"name": "process_name", "ph": "M", "pid": r, "ts": 0.0,
               "args": {"name": f"rank {r}"}} for r in sorted(set(ranks))]
    doc = {
        "traceEvents": labels + merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "ranks": sorted(set(ranks)),
            "aligned": len(known) == len(loaded),
            "sources": [str(p) for p in paths],
        },
    }
    if jobs:
        annotate_jobs(doc)
    if out is not None:
        with open(out, "w") as f:
            json.dump(doc, f)
    return doc


#: synthetic pid base for per-job track groups in a merged document
#: (well above any real rank pid)
JOB_TRACK_PID_BASE = 1 << 20


def annotate_jobs(doc: dict) -> Dict[str, Any]:
    """Job-stitch a merged document IN PLACE (profiling.jobtrace
    vocabulary): every job-attributable event — task lifecycle spans
    resolved through the ``job:<hex16>`` token map, ``jobwire_*`` /
    ``jobcoll`` / ``jobcompile`` / ``job_phase`` events through their
    event_id — gains ``args.trace_id``; each job gets exactly ONE track
    group (a ``process_name`` metadata track ``job <hex16>``) carrying
    its queue -> admit -> run -> drain phase row on top, so Perfetto
    shows one cross-rank timeline per job.  Returns (and stores as
    ``metadata.jobs``) a per-job summary."""
    from .jobtrace import hex_id, job_index, job_of_event

    events = doc.get("traceEvents", [])
    idx = job_index(events)
    token_to_job = idx["token_to_job"]
    #: trace_id -> {"events", "ranks", "first_us", "last_us"}
    summary: Dict[int, Dict[str, Any]] = {}
    for e in events:
        tid = job_of_event(e, token_to_job)
        if tid is None:
            continue
        e.setdefault("args", {})["trace_id"] = hex_id(tid)
        s = summary.setdefault(tid, {"events": 0, "ranks": set(),
                                     "first_us": None, "last_us": None})
        s["events"] += 1
        s["ranks"].add(e.get("pid"))
        if e.get("name") == "exec":
            ts = float(e.get("ts", 0.0))
            s["first_us"] = ts if s["first_us"] is None \
                else min(s["first_us"], ts)
            s["last_us"] = ts if s["last_us"] is None \
                else max(s["last_us"], ts)
    extra: List[dict] = []
    meta_jobs: Dict[str, Any] = {}
    for n, tid in enumerate(sorted(summary)):
        s = summary[tid]
        pid = JOB_TRACK_PID_BASE + n
        hexid = hex_id(tid)
        extra.append({"name": "process_name", "ph": "M", "pid": pid,
                      "ts": 0.0, "args": {"name": f"job {hexid}"}})
        ph = idx["phases"].get(tid, {})
        row = []  # (name, begin, end) on the job track's phase row

        def _span(name, a, b):
            if a is not None and b is not None and b > a:
                row.append((name, a, b))

        _span("phase:queue", ph.get("submit_us"), ph.get("admit_us"))
        _span("phase:admit", ph.get("admit_us"), s["first_us"])
        _span("phase:run", s["first_us"], s["last_us"])
        _span("phase:drain", s["last_us"], ph.get("done_us"))
        for name, a, b in row:
            extra.append({"name": name, "ph": "X", "pid": pid,
                          "tid": "phases", "ts": a, "dur": b - a,
                          "args": {"trace_id": hexid}})
        meta_jobs[hexid] = {
            "events": s["events"],
            "ranks": sorted(r for r in s["ranks"] if r is not None),
            "track_pid": pid,
            "phases": {k: round(v, 3) for k, v in ph.items()},
        }
    events.extend(extra)
    doc.setdefault("metadata", {})["jobs"] = meta_jobs
    return meta_jobs
