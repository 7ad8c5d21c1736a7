"""Dependency tracking.

Reference: the per-task-class storage backends for dependency state
(``parsec_hash_find_deps``, ``parsec_internal.h:362``) updated in
counter-mode or mask-mode (``parsec_internal.h:371-394``).

The port carries the hash backend in counter mode, the one the PTG uses:
a keyed map of small entries that become ready when ``count == goal``.
Mask mode and the dense index-array backend of :mod:`parsec_tpu.core.deps`
are not ported yet (ROADMAP A.11).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Hashable, Tuple

from ..profiling import pins

#: stable per-tracker tokens for the happens-before sites: ``id(tracker)``
#: would be reused after GC, making a later taskpool's decrements collide
#: with an earlier one's
_HB_TOKENS = itertools.count(1)


class DepEntry:
    __slots__ = ("count", "data")

    def __init__(self) -> None:
        self.count = 0
        self.data: Any = None  # front-end scratch (e.g. param assignment)


class DepTracker:
    """Hash-backed dependency storage, sharded to reduce lock contention
    (the reference's hash table is bucket-locked, ``parsec_hash_table.c``)."""

    SHARDS = 16

    def __init__(self) -> None:
        self.hb_token = next(_HB_TOKENS)
        self._shards = [
            (threading.Lock(), {}) for _ in range(self.SHARDS)
        ]  # type: list[Tuple[threading.Lock, Dict[Hashable, DepEntry]]]

    def _shard(self, key: Hashable) -> Tuple[threading.Lock, Dict[Hashable, DepEntry]]:
        return self._shards[hash(key) % self.SHARDS]

    def release_counter(self, key: Hashable, goal: int, data: Any = None) -> Tuple[bool, Any]:
        """Counter-mode release of one dependency of task ``key``.

        Returns ``(became_ready, entry_data)``. The entry is removed once
        ready (tasks fire exactly once).
        """
        lock, table = self._shard(key)
        with lock:
            e = table.get(key)
            if e is None:
                e = table[key] = DepEntry()
            if data is not None:
                e.data = data
            e.count += 1
            ready = e.count >= goal
            if pins.active(pins.DEP_DECREMENT):
                # happens-before site, fired under the entry's lock so
                # event order matches lock order
                pins.fire(pins.DEP_DECREMENT, None,
                          {"tracker": self.hb_token, "key": key,
                           "ready": ready, "mode": "counter"})
            if ready:
                del table[key]
                return True, e.data
            return False, e.data

    def __len__(self) -> int:
        return sum(len(t) for _, t in self._shards)
