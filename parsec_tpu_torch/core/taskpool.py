"""Taskpool: a DAG-in-execution attached to a context.

Reference: ``parsec_taskpool_t`` (``parsec/parsec_internal.h:121-167``) —
holds task classes, a termination-detection monitor, startup hook and
completion callbacks.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, TYPE_CHECKING

from ..profiling.jobtrace import trace_id_of
from ..utils import debug, open_component
from .task import Task, TaskClass
from .termdet import TermDetMonitor

if TYPE_CHECKING:  # pragma: no cover
    from .context import Context


class Taskpool:
    """Base taskpool. Front-ends subclass (PTG) or instantiate directly
    for hand-built DAGs."""

    _ids = itertools.count(1)

    # taskpool type tags (reference parsec_internal.h:112-115)
    TYPE_PTG = "ptg"
    TYPE_USER = "user"

    def __init__(
        self,
        name: str = "taskpool",
        *,
        termdet: Optional[str] = None,
        nb_tasks: Optional[int] = None,
    ):
        self.name = name
        self.taskpool_id: int = next(self._ids)
        self.taskpool_type = self.TYPE_USER
        self.context: Optional["Context"] = None
        self.task_classes: Dict[int, TaskClass] = {}
        self.tdm: TermDetMonitor = open_component("termdet", termdet)
        self.tdm.monitor_taskpool(self, self._termination_detected)
        self._terminated = threading.Event()
        #: serializes normal termination against a forced failure
        self._term_lock = threading.Lock()
        #: set by :meth:`fail` / Context.abort(): quiesced by cancellation,
        #: not success; ``fail_reason`` names the root cause
        self.failed = False
        self.fail_reason: Optional[str] = None
        self.on_enqueue: Optional[Callable[["Taskpool"], None]] = None
        self.on_complete: Optional[Callable[["Taskpool"], None]] = None
        #: front-end startup hook: enumerate initially-ready tasks
        self.startup_hook: Optional[Callable[["Context", "Taskpool"], List[Task]]] = None
        self._known_nb_tasks = nb_tasks
        #: auto-count mode: pools with no declared task count are accounted
        #: automatically — +1 when a task is first scheduled, -1 on retire.
        #: Front-ends that manage counters themselves set this False.
        self.auto_count = nb_tasks is None
        self.priority: int = 0
        #: 64-bit job trace id, derived deterministically from the pool name
        self.trace_id: int = trace_id_of(name)
        self.user: Any = None
        #: tasks retired through :meth:`task_done`; guarded — retirements
        #: arrive from concurrent workers and ``+=`` alone loses updates
        self.nb_retired = 0
        self._retire_lock = threading.Lock()

    # -- task classes -----------------------------------------------------
    def add_task_class(self, tc: TaskClass) -> TaskClass:
        self.task_classes[tc.task_class_id] = tc
        return tc

    def addto_nb_tasks(self, delta: int) -> None:
        """Adjust the expected task count at run time (reference
        ``tdm.module->taskpool_addto_nb_tasks``)."""
        self.tdm.taskpool_addto_nb_tasks(self, delta)

    # -- lifecycle --------------------------------------------------------
    def attached(self, context: "Context") -> None:
        """Called by ``Context.add_taskpool``."""
        self.context = context
        if self._known_nb_tasks is not None:
            self.tdm.taskpool_set_nb_tasks(self, self._known_nb_tasks)

    def startup(self, context: "Context") -> List[Task]:
        if self.startup_hook is not None:
            return list(self.startup_hook(context, self))
        return []

    def _force_fail(self) -> bool:
        """Mark cancelled unless already terminated normally. The lock
        makes this atomic against a concurrent _termination_detected, so
        on_complete can never fire after a successful force-fail."""
        with self._term_lock:
            if self._terminated.is_set():
                return False
            self.failed = True
            self._terminated.set()
            return True

    def fail(self, why: str) -> bool:
        """Fail this pool over an unrecoverable error (a raising body, a
        device submit that failed after its retry): ``wait()`` returns
        False at once and the pool leaves its context's active set.
        Returns True only on the terminating transition.  Reference: hook
        ERROR is fatal (``scheduling.c:512``)."""
        if self.fail_reason is None:
            self.fail_reason = why
        if not self._force_fail():
            return False
        debug.error("taskpool %s failed: %s", self.name, why)
        if self.context is not None:
            self.context._taskpool_terminated(self)
        return True

    def _termination_detected(self, tp: "Taskpool") -> None:
        with self._term_lock:
            if self._terminated.is_set():
                # already terminated (normally, or force-failed): a late
                # tdm zero-crossing must not re-fire on_complete
                return
            self._terminated.set()
        debug.verbose(4, "core", "taskpool %s(%d) terminated", self.name, self.taskpool_id)
        if self.context is not None:
            self.context._taskpool_terminated(self)
        if self.on_complete is not None:
            self.on_complete(self)

    def task_done(self, task: Optional[Task] = None) -> None:
        """Retire one task (drives termination detection).  A fused
        supertask (``task.fused_n > 1``) retires ALL its member tasks at
        this one completion: the members were counted into the termdet at
        startup, so the countdown and ``nb_retired`` move by N."""
        n = task.fused_n if task is not None else 1
        with self._retire_lock:
            self.nb_retired += n
        self.tdm.taskpool_addto_nb_tasks(self, -n)

    def task_done_batch(self, n: int) -> None:
        """Retire ``n`` tasks in one call — the same as ``n``
        :meth:`task_done` calls, at O(1) interpreter cost.  The native
        pump (:mod:`parsec_tpu_torch.dsl.native_exec`) retires whole
        batches per pop/done cycle and publishes the count here."""
        if n <= 0:
            return
        with self._retire_lock:
            self.nb_retired += n
        self.tdm.taskpool_addto_nb_tasks(self, -n)

    def is_done(self) -> bool:
        return self._terminated.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block the caller until this taskpool quiesces
        (reference ``parsec_taskpool_wait``, ``scheduling.c:995``).
        Returns False on timeout or when the pool was aborted."""
        if self.context is not None:
            ok = self.context.wait_taskpool(self, timeout=timeout)
        else:
            ok = self._terminated.wait(timeout)
        return ok and not self.failed

    # -- helpers ----------------------------------------------------------
    def new_task(self, tc: TaskClass, locals_=(), priority: int = 0) -> Task:
        return Task(self, tc, locals_, priority)

    def __repr__(self) -> str:
        return f"Taskpool({self.name}#{self.taskpool_id})"
