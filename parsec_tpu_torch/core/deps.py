"""Dependency tracking backends.

Reference: the two per-task-class storage backends for dependency state —
a dense multidimensional array of counters/masks
(``parsec_default_find_deps``, ``parsec_internal.h:359``) and a dynamic hash
table (``parsec_hash_find_deps``, ``:362``) — updated in counter-mode or
mask-mode (``parsec_internal.h:371-394``).

The port of :mod:`parsec_tpu.core.deps`: both are a keyed map of small
entries; the dense variant pre-allocates over each registered task class's
parameter box for lookup without hashing, and falls back to the hash for
any key outside it.  Counter-mode entries become ready when
``count == goal``; mask-mode entries when ``mask == goal_mask``.  The PTG
chooses the backend through ``PTG.dep_storage`` or the
``runtime_dep_storage`` MCA param.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Hashable, Optional, Tuple

from ..profiling import pins

#: stable per-tracker tokens for the happens-before sites: ``id(tracker)``
#: would be reused after GC, making a later taskpool's decrements collide
#: with an earlier one's
_HB_TOKENS = itertools.count(1)


def _fire_dep_dec(tracker: "DepTracker | DenseDepTracker", key: Hashable,
                  ready: bool, mode: str) -> None:
    """Happens-before site: one dependency release observed.  MUST fire
    while the caller still holds the entry's lock — the hb checker chains
    decrements of one key in event order, which is only meaningful if
    event order matches lock order."""
    pins.fire(pins.DEP_DECREMENT, None,
              {"tracker": tracker.hb_token, "key": key, "ready": ready,
               "mode": mode})


def fire_native_dep_dec(graph_token: int, task_id: int, ready: bool) -> None:
    """The native engine's flavor of the same site, for the batched
    lifecycle-event drain of the pump (``dsl.native_exec._EventDrain``):
    one atomic dep-counter decrement observed inside
    ``pz_graph_done_batch``.  The
    tracker identity is ``("native", graph hb token)`` — tuple-tagged so
    it can never collide with a Python tracker's integer token — and the
    key is the decremented SUCCESSOR's native task id.  Payload shape is
    this module's, defined once, so every DEP_DECREMENT subscriber
    (hb-check, binary traces) reads both paths identically."""
    pins.fire(pins.DEP_DECREMENT, None,
              {"tracker": ("native", graph_token), "key": task_id,
               "ready": ready, "mode": "native"})


class DepEntry:
    __slots__ = ("count", "mask", "data")

    def __init__(self) -> None:
        self.count = 0
        self.mask = 0
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
                _fire_dep_dec(self, key, ready, "counter")
            if ready:
                del table[key]
                return True, e.data
            return False, e.data

    def release_mask(self, key: Hashable, bit: int, goal_mask: int, data: Any = None) -> Tuple[bool, Any]:
        """Mask-mode release: set ``bit``; ready when all goal bits set."""
        lock, table = self._shard(key)
        with lock:
            e = table.get(key)
            if e is None:
                e = table[key] = DepEntry()
            if data is not None:
                e.data = data
            e.mask |= bit
            ready = (e.mask & goal_mask) == goal_mask
            if pins.active(pins.DEP_DECREMENT):
                _fire_dep_dec(self, key, ready, "mask")
            if ready:
                del table[key]
                return True, e.data
            return False, e.data

    def peek(self, key: Hashable) -> Optional[DepEntry]:
        lock, table = self._shard(key)
        with lock:
            return table.get(key)

    def set_data(self, key: Hashable, data: Any) -> None:
        lock, table = self._shard(key)
        with lock:
            e = table.get(key)
            if e is None:
                e = table[key] = DepEntry()
            e.data = data

    def pending_keys(self) -> list:
        """Keys with partially-released counters/masks (entries are
        deleted on fire, so after a clean quiesce this is empty).  A
        non-empty result after wait() means some task was released by a
        strict subset of its producers — the runtime signature of the
        asymmetric-deps bugs a static verifier flags."""
        out = []
        for lock, table in self._shards:
            with lock:
                out.extend(k for k, e in table.items()
                           if e.count != 0 or e.mask != 0)
        return out

    def __len__(self) -> int:
        return sum(len(t) for _, t in self._shards)


class DenseDepTracker:
    """Dense-array dependency storage (the reference's index-array backend,
    ``parsec_default_find_deps`` / `-M index-array`, ``jdf2c -M``).

    Per registered task class, counters live in one flat array over the
    bounding box of the class's parameter space — O(1) lookup with no
    hashing or entry allocation, at the cost of memory proportional to the
    box volume (the classic PTG trade; the reference allocates the same
    dense array from the class's parameter ranges).

    Keys are ``(class_name, locals_tuple)``. Classes not registered (or
    keys outside the registered box) fall back to the hash backend, so the
    two trackers are drop-in interchangeable: firing resets the slot to 0
    — exactly the hash backend's delete-on-fire (and the reference's entry
    removal), so duplicate release sequences behave identically on both.
    """

    STRIPES = 16

    def __init__(self) -> None:
        self.hb_token = next(_HB_TOKENS)
        #: name -> (bounds, counter/mask slots, per-slot mode tags)
        self._classes: Dict[str, Tuple[Tuple[Tuple[int, int], ...], list, bytearray]] = {}
        self._locks = [threading.Lock() for _ in range(self.STRIPES)]
        self._fallback = DepTracker()
        self._data: Dict[Hashable, Any] = {}
        self._data_lock = threading.Lock()

    def register_class(self, name: str, bounds: "Tuple[Tuple[int, int], ...]") -> None:
        """``bounds``: inclusive ``(lo, hi)`` per parameter dimension."""
        dims = [hi - lo + 1 for lo, hi in bounds]
        vol = 1
        for d in dims:
            if d <= 0:
                return  # empty space: nothing to track densely
            vol *= d
        # third element: per-slot mode tag (0 untouched / 1 counter /
        # 2 mask) so peek() can report the right DepEntry field — the raw
        # slot value alone cannot distinguish count 3 from mask 0b11
        self._classes[name] = (tuple(bounds), [0] * vol, bytearray(vol))

    def _flat(self, name: str, locs: Tuple) -> Optional[int]:
        reg = self._classes.get(name)
        if reg is None:
            return None
        bounds = reg[0]
        if len(locs) != len(bounds):
            return None
        idx = 0
        for v, (lo, hi) in zip(locs, bounds):
            v = int(v)
            if v < lo or v > hi:
                return None  # outside the box: hash fallback
            idx = idx * (hi - lo + 1) + (v - lo)
        return idx

    def _counters(self, name: str) -> list:
        return self._classes[name][1]

    def release_counter(self, key: Hashable, goal: int, data: Any = None) -> Tuple[bool, Any]:
        name, locs = key
        idx = self._flat(name, locs)
        if idx is None:
            return self._fallback.release_counter(key, goal, data)
        if data is not None:
            self.set_data(key, data)
        _, arr, modes = self._classes[name]
        with self._locks[idx % self.STRIPES]:
            c = arr[idx] + 1
            ready = c >= goal
            if pins.active(pins.DEP_DECREMENT):
                _fire_dep_dec(self, key, ready, "counter")
            if ready:
                arr[idx] = 0  # delete-on-fire, like the hash backend
                modes[idx] = 0
                with self._data_lock:
                    d = self._data.pop(key, None)
                return True, d
            arr[idx] = c
            modes[idx] = 1
            return False, self._data.get(key)

    def release_mask(self, key: Hashable, bit: int, goal_mask: int, data: Any = None) -> Tuple[bool, Any]:
        name, locs = key
        idx = self._flat(name, locs)
        if idx is None:
            return self._fallback.release_mask(key, bit, goal_mask, data)
        if data is not None:
            self.set_data(key, data)
        _, arr, modes = self._classes[name]
        with self._locks[idx % self.STRIPES]:
            m = arr[idx] | bit
            ready = (m & goal_mask) == goal_mask
            if pins.active(pins.DEP_DECREMENT):
                _fire_dep_dec(self, key, ready, "mask")
            if ready:
                arr[idx] = 0  # delete-on-fire, like the hash backend
                modes[idx] = 0
                with self._data_lock:
                    d = self._data.pop(key, None)
                return True, d
            arr[idx] = m
            modes[idx] = 2
            return False, self._data.get(key)

    def peek(self, key: Hashable) -> Optional[DepEntry]:
        """Drop-in equivalent of the hash backend's peek: an entry exists
        while the slot has pending state OR set_data stored front-end
        scratch for the key; count/mask report only the field matching the
        mode actually used on the slot."""
        name, locs = key
        idx = self._flat(name, locs)
        if idx is None:
            return self._fallback.peek(key)
        _, arr, modes = self._classes[name]
        with self._locks[idx % self.STRIPES]:
            v = arr[idx]
            mode = modes[idx]
        data = self._data.get(key)
        if v == 0 and data is None:
            return None
        e = DepEntry()
        if mode == 1:
            e.count = v
        elif mode == 2:
            e.mask = v
        e.data = data
        return e

    def set_data(self, key: Hashable, data: Any) -> None:
        name, locs = key if isinstance(key, tuple) and len(key) == 2 else (None, None)
        if name is not None and self._flat(name, locs) is not None:
            with self._data_lock:
                self._data[key] = data
            return
        self._fallback.set_data(key, data)

    def pending_keys(self) -> list:
        """Dense-side keys with partially-released slots plus the hash
        fallback's pending keys (see ``DepTracker.pending_keys``)."""
        out = self._fallback.pending_keys()
        for name, (bounds, arr, _modes) in self._classes.items():
            dims = [hi - lo + 1 for lo, hi in bounds]
            for idx, v in enumerate(arr):
                if v == 0:
                    continue
                locs = []
                rem = idx
                for d, (lo, _hi) in zip(reversed(dims), reversed(bounds)):
                    locs.append(rem % d + lo)
                    rem //= d
                out.append((name, tuple(reversed(locs))))
        return out

    def __len__(self) -> int:
        n = len(self._fallback)
        for _, arr, _modes in self._classes.values():
            n += sum(1 for v in arr if v != 0)
        # data-only entries (set_data with no pending release) exist for
        # peek() just like the hash backend's — count them once
        with self._data_lock:
            for key in self._data:
                name, locs = key
                idx = self._flat(name, locs)
                if idx is not None and self._counters(name)[idx] == 0:
                    n += 1
        return n
