"""Scheduler component interface (reference ``mca/sched/sched.h``)."""

from __future__ import annotations

from typing import List, Optional, TYPE_CHECKING

from ...utils import Component

if TYPE_CHECKING:  # pragma: no cover
    from ..context import Context, ExecutionStream
    from ..task import Task


def native_ready_queue(policy: str, quantum: int = 0):
    """Opt-in native mirror for a Python scheduler's ready-queue STATE
    (MCA ``sched_native_queue=1``): returns a
    :class:`parsec_tpu_torch.native.NativeReadyQueue` whose pop order is
    identical to the Python discipline (the ``pz_rq_*`` entry points run
    the same SchedQ the pump scheduler uses), or None when the mirror is
    off.  Ownership handoff: the scheduler keeps the Task OBJECTS in a
    handle-keyed dict and only the ordering state crosses into C++ — a
    popped handle transfers the task back exactly once.  A library that
    cannot be built raises, as every other native consumer of the port
    does."""
    from ...utils import mca_param

    if not int(mca_param.register(
            "sched", "native_queue", 0,
            help="mirror spq/wdrr ready-queue state into the native "
                 "engine (pz_rq_*): identical pop order, queue ops "
                 "outside the interpreter; 0 = pure-Python state")):
        return None
    from ... import native

    return native.NativeReadyQueue(policy=policy, quantum=quantum)


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
