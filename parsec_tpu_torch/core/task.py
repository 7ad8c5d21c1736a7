"""Task, TaskClass, Flow, Chore — the task model.

Mirrors the reference's task model (``parsec_task_t``,
``parsec_task_class_t``, ``parsec_flow_t``, ``__parsec_chore_t`` —
``parsec/parsec_internal.h:396-553``) as plain Python objects.  The
per-class *vtable* entries that the reference's DSLs generate as C
functions (``release_deps``, ``data_lookup``, ``make_key`` …) are callables
installed by the front-end (the PTG).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from .lifecycle import AccessMode, HookReturn, TaskStatus

if TYPE_CHECKING:  # pragma: no cover
    from .taskpool import Taskpool
    from ..data.data import DataCopy


class Flow:
    """A named dataflow slot of a task class (reference ``parsec_flow_t``)."""

    __slots__ = ("name", "access", "index")

    def __init__(self, name: str, access: AccessMode, index: int = -1):
        self.name = name
        self.access = access
        self.index = index

    def __repr__(self) -> str:
        return f"Flow({self.name}, {self.access!r}, idx={self.index})"


class Chore:
    """One BODY incarnation of a task class (reference ``__parsec_chore_t``,
    ``parsec_internal.h:396-402``): a device type + hook, with an optional
    ``evaluate`` predicate deciding applicability per task."""

    __slots__ = ("device_type", "hook", "evaluate", "enabled", "time_estimate", "body_fn")

    def __init__(
        self,
        device_type: str,
        hook: Callable[["Any", "Task"], HookReturn],
        evaluate: Optional[Callable[["Task"], bool]] = None,
        time_estimate: Optional[Callable[["Task", "Any"], float]] = None,
    ):
        self.device_type = device_type
        self.hook = hook
        self.evaluate = evaluate
        self.enabled = True
        self.time_estimate = time_estimate
        #: raw functional body for device execution (set by the front-end
        #: for accelerator chores; the device module calls it directly)
        self.body_fn = None


class TaskClass:
    """Per-class vtable (reference ``parsec_task_class_t``,
    ``parsec_internal.h:409-457``).

    Front-ends populate the callable slots; ``None`` slots fall back to
    no-op defaults in the scheduling core.
    """

    _ids = itertools.count()

    def __init__(
        self,
        name: str,
        flows: Sequence[Flow] = (),
        chores: Sequence[Chore] = (),
        *,
        nb_parameters: int = 0,
        dependencies_goal: int = 0,
        task_class_id: Optional[int] = None,
    ):
        self.name = name
        self.task_class_id = task_class_id if task_class_id is not None else next(self._ids)
        self.flows: List[Flow] = list(flows)
        for i, f in enumerate(self.flows):
            if f.index < 0:
                f.index = i
        self.chores: List[Chore] = list(chores)
        self.nb_parameters = nb_parameters
        #: number of input dependencies a task must see released before it
        #: becomes ready (counter-mode tracking); front-ends may instead use
        #: per-task goals via the dep tracker.
        self.dependencies_goal = dependencies_goal

        # vtable slots (all optional):
        self.make_key: Callable[[Tuple], Any] = lambda locals_: locals_
        self.prepare_input: Optional[Callable] = None     # data_lookup
        self.prepare_output: Optional[Callable] = None
        self.complete_execution: Optional[Callable] = None
        #: release_deps(es, task) -> iterable of ready successor Tasks
        self.release_deps: Optional[Callable] = None
        self.release_task: Optional[Callable] = None
        self.time_estimate: Optional[Callable] = None

    def add_chore(self, chore: Chore) -> None:
        self.chores.append(chore)

    def chores_for(self, device_types: Sequence[str]) -> List[Chore]:
        return [c for c in self.chores if c.enabled and c.device_type in device_types]

    def __repr__(self) -> str:
        return f"TaskClass({self.name}#{self.task_class_id})"


class Task:
    """A task instance (reference ``parsec_task_t``,
    ``parsec_internal.h:521-553``)."""

    __slots__ = (
        "taskpool",
        "task_class",
        "locals",
        "priority",
        "status",
        "chore_mask",
        "selected_device",
        "selected_chore",
        "selected_chore_idx",
        "counted",
        "data_in",
        "data_out",
        "repo_entry",
        "retired",
        "body_args",
        "on_complete",
        "prof",
        "user",
        "fused_n",
        "_dev_completed",
        "_dev_attempts",
        "_dev_effects",
    )

    def __init__(
        self,
        taskpool: "Taskpool",
        task_class: TaskClass,
        locals_: Tuple = (),
        priority: int = 0,
    ):
        self.taskpool = taskpool
        self.task_class = task_class
        self.locals = tuple(locals_)
        # the pool's composed (tenant weight, job priority) offset — set
        # by the serving plane, 0 everywhere else — rides every task, so
        # the scheduler's pop order sees the composition
        self.priority = priority + getattr(taskpool, "priority_base", 0)
        self.status = TaskStatus.NONE
        self.chore_mask: int = ~0  # bitmask over task_class.chores indices
        self.selected_device = None
        self.selected_chore: Optional[Chore] = None
        self.selected_chore_idx: int = -1
        #: already counted into auto-count termination detection
        self.counted = False
        #: per-flow input DataCopy (or None); parallel to task_class.flows
        self.data_in: List[Optional["DataCopy"]] = [None] * len(task_class.flows)
        #: per-flow output DataCopy
        self.data_out: List[Optional["DataCopy"]] = [None] * len(task_class.flows)
        self.repo_entry = None
        #: set once complete_execution has retired this task (guards
        #: against double-retire in error containment paths)
        self.retired = False
        #: opaque arguments handed to the body hook (the PTG's flow specs)
        self.body_args: Any = None
        self.on_complete: Optional[Callable[["Task"], None]] = None
        self.prof: Dict[str, float] = {}
        self.user: Any = None
        #: logical tasks this instance retires: a fused supertask
        #: (:mod:`parsec_tpu_torch.dsl.fusion`) completes its N members at
        #: once
        self.fused_n: int = 1
        #: set by the device module once its eager-completion path has
        #: retired the task (guards the manager's error-containment fallback
        #: against double-completion)
        self._dev_completed = False
        #: device submit attempts, and whether an attempt already had side
        #: effects (a partially committed epilog makes a retry unsafe)
        self._dev_attempts = 0
        self._dev_effects = False

    @property
    def key(self) -> Any:
        return self.task_class.make_key(self.locals)

    def unique_key(self) -> Tuple[int, Any]:
        return (self.task_class.task_class_id, self.key)

    def __repr__(self) -> str:
        loc = ",".join(map(str, self.locals))
        return f"{self.task_class.name}({loc})"
