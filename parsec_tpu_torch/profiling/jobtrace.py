"""Job trace ids: the slice of :mod:`parsec_tpu.profiling.jobtrace` the
runtime core needs.

Every taskpool carries a deterministic 63-bit trace id derived from its
name, and the worker loop stamps it as the calling thread's trace
context before each body.  The offline index and merge tooling of the
reference module come with the profiling layer (ROADMAP A.11).
"""

from __future__ import annotations

import hashlib
import threading

__all__ = ["trace_id_of", "set_current", "current"]

_MASK = 0x7FFFFFFFFFFFFFFF  # trace ids fit the 63-bit trace record field


def trace_id_of(name: str) -> int:
    """Deterministic 63-bit trace id of a logical taskpool name (never
    0 — 0 means "no trace context").  ``hash()`` is seeded per process;
    blake2b makes every process derive the same id from the same name."""
    h = hashlib.blake2b(str(name).encode(), digest_size=8)
    tid = int.from_bytes(h.digest(), "big") & _MASK
    return tid or 1


_tls = threading.local()


def set_current(trace_id: int) -> None:
    """Stamp the calling thread's trace context (0 = none)."""
    _tls.trace = int(trace_id)


def current() -> int:
    """The calling thread's trace context (0 when outside any job)."""
    return getattr(_tls, "trace", 0)
