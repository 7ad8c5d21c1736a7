"""Arenas: recycled allocators for temporary (scratch, landing) buffers.

The port of :mod:`parsec_tpu.data.arena`.  Reference: ``parsec/arena.{c,h}``
— one arena per (datatype, shape); allocations are cached on a freelist
up to ``arena_max_cached`` and capped at ``arena_max_used`` outstanding
(``parsec.c:656-665`` MCA params).  An arena hands out host copies: a
:class:`~parsec_tpu_torch.data.data.DataCopy` at device 0 over a numpy
buffer, the payload the port's host copies hold.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..profiling import pins
from ..utils import mca_param
from .data import Data, DataCopy

#: every live Arena, for process-wide pressure gauges: weak, so an arena's
#: lifetime is still owned by whoever created it
_registry: "weakref.WeakSet[Arena]" = weakref.WeakSet()
_registry_lock = threading.Lock()


def all_arenas() -> "List[Arena]":
    """Snapshot of every live arena (BytePool size classes included)."""
    with _registry_lock:
        return list(_registry)


def global_stats() -> Dict[str, int]:
    """Process-wide arena pressure: outstanding/cached buffer counts and
    the byte totals behind them (``bytes_hw`` is the high-water mark of
    bytes outstanding per arena, summed)."""
    out = {"arenas": 0, "used": 0, "cached": 0, "created": 0,
           "bytes_in_use": 0, "bytes_cached": 0, "bytes_hw": 0}
    for ar in all_arenas():
        s = ar.stats()
        out["arenas"] += 1
        for k in ("used", "cached", "created",
                  "bytes_in_use", "bytes_cached", "bytes_hw"):
            out[k] += s[k]
    return out

#: DataCopy.flags bit: this copy's buffer has been returned to its arena.
#: A second release of the same copy would append the buffer to the free
#: list twice — two future allocations would then alias one buffer and
#: silently corrupt each other (the finalizer-vs-explicit-release race).
RECYCLED_FLAG = 0x1


class ArenaRecycleError(RuntimeError):
    """A pooled buffer was recycled twice (double release of one
    DataCopy — typically a finalizer racing an explicit ``release``)."""


class Arena:
    """Fixed-shape buffer pool. ``allocate()`` returns a DataCopy wrapping a
    recycled or fresh numpy buffer; ``release()`` returns it to the cache."""

    def __init__(self, shape: Tuple[int, ...], dtype=np.float64, name: str = "arena"):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.name = name
        self._free: List[np.ndarray] = []
        self._lock = threading.Lock()
        self.max_cached = mca_param.register(
            "runtime", "arena_max_cached", 64,
            help="max buffers cached per arena freelist")
        self.max_used = mca_param.register(
            "runtime", "arena_max_used", 0,
            help="max outstanding buffers per arena (0=unlimited)")
        self.nb_used = 0
        self.nb_created = 0
        #: most buffers ever outstanding at once (under ``_lock``)
        self.nb_used_hw = 0
        with _registry_lock:
            _registry.add(self)

    @property
    def elt_nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def allocate(self, key: Any = None) -> Optional[DataCopy]:
        """Returns None when max_used is reached (caller retries later —
        the reference returns NULL and the comm engine re-queues)."""
        with self._lock:
            if self.max_used and self.nb_used >= self.max_used:
                return None
            buf = self._free.pop() if self._free else None
            self.nb_used += 1
            if self.nb_used > self.nb_used_hw:
                self.nb_used_hw = self.nb_used
        if buf is None:
            buf = np.empty(self.shape, self.dtype)
            self.nb_created += 1
        d = Data(key, shape=self.shape, dtype=self.dtype)
        copy = d.attach_copy(0, buf)
        copy.arena = self
        if pins.active(pins.ARENA_ALLOC):
            pins.fire(pins.ARENA_ALLOC, None,
                      {"arena": self.name, "slot": d.data_id})
        return copy

    def release(self, copy: DataCopy) -> None:
        """Return ``copy``'s buffer to the free list.  A slot may be
        recycled exactly once per allocation: the second release raises a
        readable :class:`ArenaRecycleError` instead of silently pushing
        the buffer onto the free list twice (two future allocations would
        alias one buffer)."""
        with self._lock:
            if copy.flags & RECYCLED_FLAG:
                raise ArenaRecycleError(
                    f"arena {self.name}: slot {copy.data.key!r} "
                    f"(data_id={copy.data.data_id}) recycled twice — a "
                    "finalizer racing an explicit release?  The second "
                    "release was refused; the free list is intact.")
            copy.flags |= RECYCLED_FLAG
        self._recycle(copy)

    def _recycle(self, copy: DataCopy) -> None:
        """Unguarded recycle.  Callers go through :meth:`release`, which
        refuses a second recycle of one copy first."""
        buf = copy.payload
        copy.payload = None
        with self._lock:
            self.nb_used -= 1
            if buf is not None and len(self._free) < self.max_cached:
                self._free.append(buf)
            if pins.active(pins.ARENA_RECYCLE):
                # fired under the freelist lock, so the event order of
                # one slot's events is their lock order
                pins.fire(pins.ARENA_RECYCLE, None,
                          {"arena": self.name, "slot": copy.data.data_id})

    def stats(self) -> dict:
        with self._lock:
            nbytes = self.elt_nbytes
            return {
                "cached": len(self._free),
                "used": self.nb_used,
                "used_hw": self.nb_used_hw,
                "created": self.nb_created,
                "bytes_in_use": self.nb_used * nbytes,
                "bytes_cached": len(self._free) * nbytes,
                "bytes_hw": self.nb_used_hw * nbytes,
            }


class BytePool:
    """Power-of-two size-classed arenas of raw bytes — recycled landing
    buffers (reference: arena-backed receives,
    ``remote_dep_mpi.c:870-930``).  One :class:`Arena` of ``uint8`` per
    size class; ``allocate(nbytes)`` returns a DataCopy whose payload has
    at least ``nbytes`` bytes.  Classes are uncapped by ``arena_max_used``
    (receives must always land — backpressure belongs to the transport,
    and a None from ``allocate`` would kill a comm thread mid-frame)."""

    MIN_CLASS = 9  # 512 B — below this, slack beats class explosion

    def __init__(self, name: str = "bytes"):
        self.name = name
        self._classes: dict = {}
        self._lock = threading.Lock()

    def _arena_for(self, nbytes: int) -> Arena:
        k = max(self.MIN_CLASS, int(nbytes - 1).bit_length()) \
            if nbytes > 1 else self.MIN_CLASS
        with self._lock:
            ar = self._classes.get(k)
            if ar is None:
                ar = self._classes[k] = Arena(
                    (1 << k,), np.uint8, name=f"{self.name}-{1 << k}")
                ar.max_used = 0
        return ar

    def allocate(self, nbytes: int) -> DataCopy:
        return self._arena_for(nbytes).allocate()

    def arenas(self) -> List[Arena]:
        with self._lock:
            return list(self._classes.values())

    def stats(self) -> dict:
        out: Dict[str, int] = {"cached": 0, "used": 0, "created": 0}
        for ar in self.arenas():
            for k, v in ar.stats().items():
                out[k] = out.get(k, 0) + v
        return out

class ByteBudget:
    """Thread-safe extra-memory meter with a declared limit: consumers
    ``acquire``/``release`` the CAPACITY of every staging or landing
    buffer they hold, and the measured ``peak`` is reported against the
    limit (``RedistOp.result()['peak_extra_bytes']``).  The meter records —
    it never blocks: admission control (one landing batch at a time, one
    staging batch per ack window) is the caller's bounding mechanism
    (the memory-bounded redistribution rounds, ``comm.coll.RedistOp``),
    and a meter that blocked a comm callback would wedge the fabric."""

    __slots__ = ("limit", "now", "peak", "_lock")

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.now = 0
        self.peak = 0
        self._lock = threading.Lock()

    def acquire(self, nbytes: int) -> None:
        with self._lock:
            self.now += int(nbytes)
            if self.now > self.peak:
                self.peak = self.now

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.now -= int(nbytes)
