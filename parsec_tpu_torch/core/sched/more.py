"""The remaining scheduler strategies of the reference's roster (the
port of :mod:`parsec_tpu.core.sched.more`).

Reference modules (``parsec/mca/sched/``): ``llp`` (LIFO
local with priority), ``ltq`` (local tree queues over a mutexless maxheap),
``lhq`` (local hierarchical queues), ``pbq`` (priority-based local queues
with overflow), ``ip`` (in-place: strict LIFO on one shared dequeue).
Together with lfq/gd/ap/ll/rnd/spq this completes the 11-strategy set.
"""

from __future__ import annotations

import collections
import heapq
import itertools
import threading
from typing import List

from ...utils import register_component
from .base import Scheduler


class _LocalHeaps(Scheduler):
    """Shared machinery: per-worker priority heap + steal."""

    def install(self, context) -> None:
        super().install(context)
        n = context.nb_workers
        self._heaps: List[list] = [[] for _ in range(n)]
        self._locks: List[threading.Lock] = [threading.Lock() for _ in range(n)]
        self._seq = itertools.count()

    def _push(self, i: int, task) -> None:
        with self._locks[i]:
            heapq.heappush(self._heaps[i], (-task.priority, next(self._seq), task))

    def _pop(self, i: int):
        with self._locks[i]:
            if self._heaps[i]:
                return heapq.heappop(self._heaps[i])[2]
        return None

    def schedule(self, es, tasks, distance: int = 0) -> None:
        i = ((es.worker_id if es is not None else 0) + distance) % len(self._heaps)
        for t in tasks:
            self._push(i, t)

    def select(self, es):
        t = self._pop(es.worker_id)
        if t is not None:
            return t
        n = len(self._heaps)
        for d in range(1, n):
            t = self._pop((es.worker_id + d) % n)
            if t is not None:
                es.stats["steals"] += 1
                return t
        return None

    def pending_estimate(self) -> int:
        return sum(len(h) for h in self._heaps)


@register_component("sched")
class SchedLLP(_LocalHeaps):
    """``llp``: worker-local LIFO ordered by priority, steal from peers."""

    mca_name = "llp"
    mca_priority = 7


@register_component("sched")
class SchedLTQ(_LocalHeaps):
    """``ltq``: local tree queues — the reference keeps a mutexless maxheap
    per worker and steals whole subtrees; here per-worker heaps with
    element stealing (same ordering semantics, simpler transfer)."""

    mca_name = "ltq"
    mca_priority = 8


@register_component("sched")
class SchedPBQ(_LocalHeaps):
    """``pbq``: priority-based local queues with a bounded local size
    spilling to a shared overflow queue."""

    mca_name = "pbq"
    mca_priority = 9
    LOCAL_CAP = 128

    def install(self, context) -> None:
        super().install(context)
        self._overflow: collections.deque = collections.deque()
        self._olock = threading.Lock()

    def schedule(self, es, tasks, distance: int = 0) -> None:
        i = ((es.worker_id if es is not None else 0) + distance) % len(self._heaps)
        for t in tasks:
            with self._locks[i]:
                if len(self._heaps[i]) < self.LOCAL_CAP:
                    heapq.heappush(self._heaps[i], (-t.priority, next(self._seq), t))
                    continue
            with self._olock:
                self._overflow.append(t)

    def select(self, es):
        t = self._pop(es.worker_id)
        if t is not None:
            return t
        with self._olock:
            if self._overflow:
                return self._overflow.popleft()
        return super().select(es)

    def pending_estimate(self) -> int:
        return super().pending_estimate() + len(self._overflow)


@register_component("sched")
class SchedLHQ(Scheduler):
    """``lhq``: hierarchical local queues — worker, then a per-group level
    (stand-in for the NUMA level the reference derives from hwloc), then
    global. Push goes to the level selected by ``distance``."""

    mca_name = "lhq"
    mca_priority = 10
    GROUP = 4  # workers per intermediate group

    def install(self, context) -> None:
        super().install(context)
        n = context.nb_workers
        self._local = [collections.deque() for _ in range(n)]
        self._llocks = [threading.Lock() for _ in range(n)]
        ngroups = (n + self.GROUP - 1) // self.GROUP
        self._group = [collections.deque() for _ in range(ngroups)]
        self._glocks = [threading.Lock() for _ in range(ngroups)]
        self._global: collections.deque = collections.deque()
        self._globlock = threading.Lock()

    def _gid(self, worker: int) -> int:
        return worker // self.GROUP

    def schedule(self, es, tasks, distance: int = 0) -> None:
        i = es.worker_id if es is not None else 0
        if distance == 0:
            dq, lk = self._local[i], self._llocks[i]
        elif distance == 1:
            g = self._gid(i)
            dq, lk = self._group[g], self._glocks[g]
        else:
            dq, lk = self._global, self._globlock
        with lk:
            # highest priority must land at the popleft end (lfq idiom)
            for t in reversed(sorted(tasks, key=lambda t: -t.priority)):
                dq.appendleft(t)

    def select(self, es):
        i = es.worker_id
        with self._llocks[i]:
            if self._local[i]:
                return self._local[i].popleft()
        g = self._gid(i)
        with self._glocks[g]:
            if self._group[g]:
                return self._group[g].popleft()
        with self._globlock:
            if self._global:
                return self._global.popleft()
        # steal: nearest worker locals, then other groups
        n = len(self._local)
        for d in range(1, n):
            v = (i + d) % n
            with self._llocks[v]:
                if self._local[v]:
                    es.stats["steals"] += 1
                    return self._local[v].pop()
        for gg in range(len(self._group)):
            if gg == g:
                continue
            with self._glocks[gg]:
                if self._group[gg]:
                    es.stats["steals"] += 1
                    return self._group[gg].pop()
        return None

    def pending_estimate(self) -> int:
        return (sum(len(d) for d in self._local)
                + sum(len(d) for d in self._group) + len(self._global))


@register_component("sched")
class SchedIP(Scheduler):
    """``ip``: in-place — strict LIFO on a single shared dequeue; newly
    released tasks run immediately (depth-first), minimizing live memory."""

    mca_name = "ip"
    mca_priority = 2

    def install(self, context) -> None:
        super().install(context)
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def schedule(self, es, tasks, distance: int = 0) -> None:
        with self._lock:
            for t in tasks:
                self._dq.appendleft(t)

    def select(self, es):
        with self._lock:
            if self._dq:
                return self._dq.popleft()
        return None

    def pending_estimate(self) -> int:
        return len(self._dq)
