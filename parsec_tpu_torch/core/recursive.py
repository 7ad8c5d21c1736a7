"""Recursive tasks: a task body that spawns a nested taskpool.

Reference: ``parsec/recursive.h`` — a BODY may build a new taskpool for a
finer-grained version of its own work, attach it to the context, and
complete asynchronously when the nested pool quiesces
(``parsec_recursivecall_callback``).  The port of
:mod:`parsec_tpu.core.recursive`.

Usage inside a body hook::

    def body(es, task):
        sub = build_finer_taskpool(...)
        return recursive_invoke(es, task, sub)   # returns ASYNC
"""

from __future__ import annotations

from typing import Callable, Optional

from .lifecycle import HookReturn
from .taskpool import Taskpool
from .task import Task


def recursive_invoke(es, task: Task, subpool: Taskpool,
                     on_done: Optional[Callable[[Task], None]] = None) -> HookReturn:
    """Attach ``subpool`` to the parent context; when it terminates, the
    parent ``task`` completes (including its release_deps). Returns ASYNC
    for the caller to propagate out of the body hook."""
    context = task.taskpool.context
    if context is None:
        raise RuntimeError("recursive task outside an attached taskpool")
    # hold a runtime action on the parent pool while the child runs so the
    # parent cannot terminate under its outstanding recursive task
    task.taskpool.tdm.taskpool_addto_runtime_actions(task.taskpool, 1)
    prev = subpool.on_complete

    def chain(sub_tp):
        if prev is not None:
            prev(sub_tp)
        if on_done is not None:
            on_done(task)
        from . import scheduling

        wes = context.current_es()
        scheduling.complete_execution(context, wes, task)
        task.taskpool.tdm.taskpool_addto_runtime_actions(task.taskpool, -1)

    subpool.on_complete = chain
    context.add_taskpool(subpool)
    return HookReturn.ASYNC
