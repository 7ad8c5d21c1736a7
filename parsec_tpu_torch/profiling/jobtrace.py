"""Job-level trace ids: minting, the thread's trace context and the
offline index.

The port of :mod:`parsec_tpu.profiling.jobtrace`.  Every taskpool carries
a deterministic 63-bit *trace id* derived from its name
(:func:`trace_id_of`, blake2b: every process derives the same id from the
same name), and the worker loop stamps it as the calling thread's trace
context before each body (:func:`set_current` / :func:`current`).

Offline, :func:`job_index` rebuilds the token -> job map and the phase
timestamps from a (merged) Chrome trace: ``job_map`` instants (event_id =
task token, info = trace id) and ``job_phase`` instants (event_id = trace
id, info = ``PHASE_*``); :func:`job_of_event` resolves one event.
``profiling.merge`` annotates every job-attributable event with
``args.trace_id`` and ``profiling.critpath --job`` slices on it.  The
port records ``job_map`` instants for tasks whose pool carries a trace
id, the serving plane's ``job_phase`` instants, and, on a multi-rank
mesh, the ``jobwire_send`` / ``jobwire_eager`` / ``jobwire_rdv`` instants
of the wire (event_id = the payload's trace id, which activation frames,
rendezvous descriptors and DTD shipments carry), and ``jobcoll`` spans of
a collective issued from inside a job's body (:mod:`..comm.coll` reads
:func:`current` at the op's start).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional

__all__ = ["trace_id_of", "hex_id", "parse_trace_id", "set_current",
           "current", "job_index", "job_of_event", "PHASE_SUBMIT",
           "PHASE_ADMIT", "PHASE_DONE"]

#: ``job_phase`` instant codes (``info`` field; ``event_id`` = trace id)
PHASE_SUBMIT = 1
PHASE_ADMIT = 2
PHASE_DONE = 3

_MASK = 0x7FFFFFFFFFFFFFFF  # trace ids fit the 63-bit trace record field


def trace_id_of(name: str) -> int:
    """Deterministic 63-bit trace id of a logical taskpool name (never
    0 — 0 means "no trace context" everywhere).  ``hash()`` is seeded
    per process; blake2b makes every rank of a multi-process mesh derive
    the same id from the same pool name, which is the same cross-rank
    matching contract remote activations already rely on."""
    h = hashlib.blake2b(str(name).encode(), digest_size=8)
    tid = int.from_bytes(h.digest(), "big") & _MASK
    return tid or 1


def hex_id(trace_id: int) -> str:
    """Canonical 16-hex-digit rendering (the ``job:<hex16>`` keyword
    suffix, the ``args.trace_id`` annotation, the ``--job`` argument)."""
    return f"{int(trace_id) & _MASK:016x}"


def parse_trace_id(s) -> int:
    """Accept a hex16 string, a ``job:<hex16>`` keyword, or an int."""
    if isinstance(s, int):
        return s & _MASK
    s = str(s).strip()
    if s.startswith("job:"):
        s = s[4:]
    return int(s, 16) & _MASK


# ---------------------------------------------------------------------------
# thread-local trace context (the in-process propagation channel)
# ---------------------------------------------------------------------------

_tls = threading.local()


def set_current(trace_id: int) -> None:
    """Stamp the calling thread's trace context (0 = none).  The worker
    loop calls this with the task's pool id before each body; anything
    the body triggers on THIS thread (collectives, compiles) reads it
    back via :func:`current`."""
    _tls.trace = int(trace_id)


def current() -> int:
    """The calling thread's trace context (0 when outside any job)."""
    return getattr(_tls, "trace", 0)


# ---------------------------------------------------------------------------
# offline index (shared by profiling.merge and profiling.critpath)
# ---------------------------------------------------------------------------

def job_index(events: List[dict]) -> Dict[str, Any]:
    """Scan Chrome-trace events for the job vocabulary.  Returns::

        {"token_to_job": {(pid, token): trace_id},
         "phases": {trace_id: {"submit_us", "admit_us", "done_us"}},
         "jobs": {trace_id, ...}}

    ``job_map`` instants map task tokens to jobs (event_id = token,
    info = trace id; the legacy per-job ``job:<hex16>`` keyword form of
    early dumps is still read); ``job_phase`` instants carry
    submit/admit/done timestamps (event_id = trace id, info = phase
    code).  Multi-rank phases keep the earliest submit/admit and the
    latest done — the mesh-wide job envelope."""
    token_to_job: Dict[Any, int] = {}
    phases: Dict[int, Dict[str, float]] = {}
    jobs: set = set()
    for e in events:
        name = e.get("name")
        if not isinstance(name, str):
            continue
        args = e.get("args", {}) or {}
        if name == "job_map" and e.get("ph") == "i":
            tid = int(args.get("info", 0) or 0)
            tok = args.get("event_id")
            if tid and tok is not None:
                token_to_job[(e.get("pid"), tok)] = tid
                jobs.add(tid)
        elif name.startswith("job:") and e.get("ph") == "i":
            try:
                tid = parse_trace_id(name)
            except ValueError:
                continue
            tok = args.get("event_id")
            if tok is not None:
                token_to_job[(e.get("pid"), tok)] = tid
                jobs.add(tid)
        elif name == "job_phase" and e.get("ph") == "i":
            tid = int(args.get("event_id", 0) or 0)
            if not tid:
                continue
            jobs.add(tid)
            code = int(args.get("info", 0) or 0)
            ph = phases.setdefault(tid, {})
            ts = float(e.get("ts", 0.0))
            if code == PHASE_SUBMIT:
                ph["submit_us"] = min(ts, ph.get("submit_us", ts))
            elif code == PHASE_ADMIT:
                ph["admit_us"] = min(ts, ph.get("admit_us", ts))
            elif code == PHASE_DONE:
                ph["done_us"] = max(ts, ph.get("done_us", ts))
    return {"token_to_job": token_to_job, "phases": phases, "jobs": jobs}


def job_of_event(e: dict, token_to_job: Dict[Any, int]) -> Optional[int]:
    """Trace id of one event, or None.  Task-lifecycle spans resolve
    through the token map; job-vocabulary events (``jobwire_*``,
    ``jobcoll``, ``jobcompile``, ``job_phase``) carry the id AS their
    event_id."""
    name = e.get("name")
    if not isinstance(name, str):
        return None
    args = e.get("args", {}) or {}
    if name in ("exec", "prepare_input", "complete_exec", "job_map"):
        return token_to_job.get((e.get("pid"), args.get("event_id")))
    if name.startswith(("jobwire_", "jobcoll", "jobcompile")) \
            or name == "job_phase":
        tid = int(args.get("event_id", 0) or 0)
        return tid or None
    return None
