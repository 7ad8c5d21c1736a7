"""alperf — application-level performance counters (PINS module).

Reference: ``parsec/mca/pins/alperf/`` counts
application-declared quantities (tasks, flops, bytes) per task class as
tasks execute, and emits periodic snapshots so a live monitor can plot
rates.  Here: per-task-class execution counts and wall-time from the
EXEC begin/end PINS sites, plus user-declared measures — callables
evaluated per completed task (e.g. a flops model) — with an optional
periodic emitter thread publishing into the live-properties dictionary.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from . import dictionary, pins


class AlperfModule:
    """Subscribe at construction; ``report()`` anytime; ``disable()`` to
    detach.  ``declare_measure(name, fn)`` adds a per-task quantity:
    ``fn(task) -> float`` evaluated at EXEC_END and accumulated per class
    (reference: alperf's ALPERF_TASKS/ALPERF_FLOPS event set)."""

    def __init__(self, emit_interval: Optional[float] = None):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._begin: Dict[int, float] = {}  # id(task) -> ts
        self._per_class: Dict[str, Dict[str, float]] = {}
        self._measures: Dict[str, Callable[[Any], float]] = {}
        self._measure_errors: set = set()
        # account at COMPLETE_EXEC_END, not EXEC_END: for async device
        # chores EXEC_END fires when the hook merely *enqueued* the task
        # (HookReturn.ASYNC), while complete_execution runs once the work
        # actually retired — on every path, sync or async
        self._subs = [
            (pins.EXEC_BEGIN, self._on_begin),
            (pins.COMPLETE_EXEC_END, self._on_end),
        ]
        for site, cb in self._subs:
            pins.subscribe(site, cb)
        dictionary.register_property("alperf", self.report)
        self._emit_stop = threading.Event()
        self._emitter = None
        if emit_interval:
            self._emitter = threading.Thread(
                target=self._emit_loop, args=(emit_interval,),
                name="alperf-emit", daemon=True)
            self._emitter.start()

    def declare_measure(self, name: str, fn: Callable[[Any], float]) -> None:
        with self._lock:
            self._measures[name] = fn

    # -- callbacks -------------------------------------------------------
    def _on_begin(self, es, task) -> None:
        self._begin[id(task)] = time.perf_counter()

    def _on_end(self, es, task) -> None:
        now = time.perf_counter()
        t0 = self._begin.pop(id(task), now)
        cname = task.task_class.name
        with self._lock:
            row = self._per_class.setdefault(
                cname, {"tasks": 0.0, "time_s": 0.0})
            row["tasks"] += 1
            row["time_s"] += now - t0
            for mname, fn in self._measures.items():
                try:
                    row[mname] = row.get(mname, 0.0) + float(fn(task))
                except Exception as e:
                    # a broken measure must not fail the task it observes:
                    # the task is not counted under it, and the first
                    # failure of each measure is logged
                    if mname not in self._measure_errors:
                        self._measure_errors.add(mname)
                        from ..utils import debug

                        debug.warning("alperf measure %r raised on %r: %s: %s "
                                      "(logged once)", mname, task,
                                      type(e).__name__, e)

    # -- reporting -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Snapshot: per-class totals plus overall rates since enable."""
        wall = time.perf_counter() - self._t0
        with self._lock:
            per_class = {k: dict(v) for k, v in self._per_class.items()}
        total = sum(v["tasks"] for v in per_class.values())
        return {
            "wall_s": wall,
            "tasks_total": total,
            "tasks_per_s": total / wall if wall > 0 else 0.0,
            "per_class": per_class,
        }

    def _emit_loop(self, interval: float) -> None:
        from ..utils import debug

        while not self._emit_stop.wait(interval):
            r = self.report()
            debug.verbose(2, "alperf", "%d tasks, %.1f tasks/s",
                          int(r["tasks_total"]), r["tasks_per_s"])

    def disable(self) -> None:
        self._emit_stop.set()
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        dictionary.unregister_property("alperf")
