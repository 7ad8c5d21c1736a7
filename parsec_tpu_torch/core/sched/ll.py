"""``ll`` — per-worker LIFO with steal, no spill bound
(reference ``mca/sched/ll/sched_ll_module.c``: lock-free LIFO per thread,
local push/pop, steal from others)."""

from __future__ import annotations

import collections
import threading
from typing import List, Optional

from ...utils import register_component
from .base import Scheduler


@register_component("sched")
class SchedLL(Scheduler):
    mca_name = "ll"
    mca_priority = 6

    def install(self, context) -> None:
        super().install(context)
        n = context.nb_workers
        self._locals: List[collections.deque] = [collections.deque() for _ in range(n)]
        self._locks: List[threading.Lock] = [threading.Lock() for _ in range(n)]

    def schedule(self, es, tasks, distance: int = 0) -> None:
        i = (es.worker_id + distance) % len(self._locals) if es is not None else 0
        with self._locks[i]:
            for t in tasks:
                self._locals[i].appendleft(t)

    def select(self, es) -> Optional["object"]:
        i = es.worker_id
        with self._locks[i]:
            if self._locals[i]:
                return self._locals[i].popleft()
        n = len(self._locals)
        for d in range(1, n):
            v = (i + d) % n
            with self._locks[v]:
                if self._locals[v]:
                    es.stats["steals"] += 1
                    return self._locals[v].pop()
        return None

    def pending_estimate(self) -> int:
        return sum(len(d) for d in self._locals)
