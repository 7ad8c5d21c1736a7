"""Scheduler component interface (reference ``mca/sched/sched.h``)."""

from __future__ import annotations

from typing import List, Optional, TYPE_CHECKING

from ...utils import Component

if TYPE_CHECKING:  # pragma: no cover
    from ..context import Context, ExecutionStream
    from ..task import Task


class Scheduler(Component):
    """Vtable: install / flow_init (per-es) / schedule / select / remove."""

    mca_type = "sched"

    def install(self, context: "Context") -> None:
        self.context = context

    def flow_init(self, es: "ExecutionStream") -> None:
        """Per-worker initialization (reference ``flow_init`` barriered
        across threads)."""

    def schedule(self, es: "ExecutionStream", tasks: List["Task"], distance: int = 0) -> None:
        """Make ``tasks`` runnable. ``distance`` is a locality hint: 0 means
        "near me / soon", larger means further away (reference uses it to
        spread AGAIN-ed tasks, ``scheduling.c:254``)."""
        raise NotImplementedError

    def select(self, es: "ExecutionStream") -> Optional["Task"]:
        """Pop the next task for this worker, or None."""
        raise NotImplementedError

    def remove(self, context: "Context") -> None:
        pass

    def pending_estimate(self) -> int:
        """Approximate queued-task count."""
        return 0
