"""``spq`` — simple priority queue with distance tie-break
(reference ``mca/sched/spq``): one global heap ordered by (priority desc,
distance asc, insertion order).

With MCA ``sched_native_queue=1`` the ordering state lives in the native
engine's SchedQ (``pz_rq_*`` — the same C++ discipline the pump
scheduler runs) instead of a Python heap: pops come back in an identical
order, and the heap ops leave the interpreter.  Task objects never cross
the boundary — a handle-keyed dict holds them and hands each back
exactly once on pop.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, Optional

from ...utils import register_component
from .base import Scheduler, native_ready_queue


@register_component("sched")
class SchedSPQ(Scheduler):
    mca_name = "spq"
    mca_priority = 3

    def install(self, context) -> None:
        super().install(context)
        self._heap: list = []
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._nq = native_ready_queue("prio")
        self._owned: Dict[int, object] = {}

    def schedule(self, es, tasks, distance: int = 0) -> None:
        with self._lock:
            if self._nq is not None:
                for t in tasks:
                    h = next(self._seq)
                    self._owned[h] = t
                    self._nq.push(t.priority, h, distance=distance)
                return
            for t in tasks:
                heapq.heappush(self._heap, (-t.priority, distance, next(self._seq), t))

    def select(self, es) -> Optional["object"]:
        with self._lock:
            if self._nq is not None:
                h = self._nq.pop()
                return None if h < 0 else self._owned.pop(h)
            if self._heap:
                return heapq.heappop(self._heap)[3]
        return None

    def pending_estimate(self) -> int:
        return len(self._owned) if self._nq is not None else len(self._heap)

    def remove(self, context) -> None:
        with self._lock:
            if self._nq is not None:
                self._nq.close()
                self._nq = None
            self._owned.clear()
            self._heap.clear()
