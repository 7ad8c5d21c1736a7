"""``gd`` — single global dequeue (reference ``mca/sched/gd``,
``sched_gd_module.c:82``): the simplest correct scheduler, useful as a
contention baseline. distance==0 pushes to the front (LIFO-ish), else back."""

from __future__ import annotations

import collections
import threading
from typing import Optional

from ...utils import register_component
from .base import Scheduler


@register_component("sched")
class SchedGD(Scheduler):
    mca_name = "gd"
    mca_priority = 5

    def install(self, context) -> None:
        super().install(context)
        self._dq: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def schedule(self, es, tasks, distance: int = 0) -> None:
        if not tasks:
            return
        with self._lock:
            if distance == 0:
                self._dq.extendleft(reversed(tasks))
            else:
                self._dq.extend(tasks)

    def select(self, es) -> Optional["object"]:
        with self._lock:
            if self._dq:
                return self._dq.popleft()
        return None

    def pending_estimate(self) -> int:
        return len(self._dq)
