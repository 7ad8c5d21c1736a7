"""``ap`` — absolute priority ordering over one global queue
(reference ``mca/sched/ap``): always run the highest-priority ready task."""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Optional

from ...utils import register_component
from .base import Scheduler


@register_component("sched")
class SchedAP(Scheduler):
    mca_name = "ap"
    mca_priority = 4

    def install(self, context) -> None:
        super().install(context)
        self._heap: list = []
        self._lock = threading.Lock()
        self._seq = itertools.count()  # FIFO tie-break

    def schedule(self, es, tasks, distance: int = 0) -> None:
        with self._lock:
            for t in tasks:
                heapq.heappush(self._heap, (-t.priority, next(self._seq), t))

    def select(self, es) -> Optional["object"]:
        with self._lock:
            if self._heap:
                return heapq.heappop(self._heap)[2]
        return None

    def pending_estimate(self) -> int:
        return len(self._heap)
