"""Task progress: the hot path from ready task to retired task.

Mirrors ``parsec/scheduling.c``:

* ``schedule_ready``        ≙ ``__parsec_schedule`` (:254) + keep-highest-
  priority-successor-local (``scheduling.c:327-385``),
* ``task_progress``         ≙ ``__parsec_task_progress`` (:474),
* ``execute``               ≙ ``__parsec_execute`` (:126) incl. device
  selection (:137) and chore hook dispatch (:150-153),
* ``complete_execution``    ≙ ``__parsec_complete_execution`` (:436),
* ``retire_native``         ≙ the same accounting for a batch the native
  engine already released (the pump, :mod:`..dsl.native_exec`).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, TYPE_CHECKING

from ..utils import debug
from .lifecycle import DEV_CPU, HookReturn, TaskStatus
from ..profiling import pins

if TYPE_CHECKING:  # pragma: no cover
    from .context import Context, ExecutionStream
    from .task import Task


def schedule_ready(context: "Context", es: Optional["ExecutionStream"], tasks: Iterable["Task"], distance: int = 0) -> None:
    """Make tasks runnable; if called from a worker, keep the best one as
    the worker's immediately-next task (cache-warm successor execution)."""
    batch: List["Task"] = [t for t in tasks if t is not None]
    if not batch:
        return
    for t in batch:
        tp = t.taskpool
        if tp.auto_count and not t.counted:
            t.counted = True
            tp.tdm.taskpool_addto_nb_tasks(tp, 1)
    pins.fire(pins.SCHEDULE_BEGIN, es, batch)
    if es is not None and es.next_task is None and distance == 0:
        best = max(range(len(batch)), key=lambda i: batch[i].priority)
        es.next_task = batch.pop(best)
    if batch:
        context.scheduler.schedule(es, batch, distance)
        # only a task actually pushed to the scheduler warrants waking the
        # idle threads: a kept-next successor is run by THIS worker
        context._notify_work()
    pins.fire(pins.SCHEDULE_END, es, batch)


def execute(context: "Context", es: "ExecutionStream", task: "Task") -> HookReturn:
    """Select a device/chore and run the body hook."""
    from ..device import device as devmod

    tc = task.task_class
    if task.selected_chore is None:
        rc = devmod.select_best_device(context, task)
        if rc != HookReturn.DONE:
            # no (device, chore) pair can ever run this task in this context:
            # that is a configuration error, not a transient condition
            debug.fatal(
                "task %r has no eligible (device, chore): chores=%s devices=%s",
                task,
                [(c.device_type, c.enabled) for c in tc.chores],
                [(d.device_type, d.enabled) for d in context.devices],
            )
    chore = task.selected_chore
    task.status = TaskStatus.HOOK
    # a device module that runs the task on a thread of its own fires the
    # EXEC pins around its submit there (the CUDA module: this hook only
    # hands the task to its manager, whose loop may run many other tasks
    # inside this call), so the core does not wrap its hook
    wrap = not getattr(task.selected_device, "fires_exec_pins", False)
    if wrap:
        pins.fire(pins.EXEC_BEGIN, es, task)
    rc = chore.hook(es, task)
    if rc is None:
        rc = HookReturn.DONE
    if wrap:
        pins.fire(pins.EXEC_END, es, task)
    return rc


def complete_execution(context: "Context", es: Optional["ExecutionStream"], task: "Task") -> None:
    """Output side of the lifecycle: prepare_output, completion callback,
    release of successor dependencies, retirement."""
    tc = task.task_class
    task.status = TaskStatus.PREPARE_OUTPUT
    if tc.prepare_output is not None:
        tc.prepare_output(es, task)
    pins.fire(pins.COMPLETE_EXEC_BEGIN, es, task)
    task.status = TaskStatus.COMPLETE
    if tc.complete_execution is not None:
        tc.complete_execution(es, task)
    ready: Iterable["Task"] = ()
    if tc.release_deps is not None:
        pins.fire(pins.RELEASE_DEPS_BEGIN, es, task)
        ready = tc.release_deps(es, task) or ()
        pins.fire(pins.RELEASE_DEPS_END, es, (task, ready))
    if task.on_complete is not None:
        task.on_complete(task)
    if tc.release_task is not None:
        tc.release_task(task)
    pins.fire(pins.COMPLETE_EXEC_END, es, task)
    if task.selected_device is not None:
        task.selected_device.sub_load(task.prof.get("est", 0.0))
        task.selected_device.count_executed()
    tp = task.taskpool
    task.retired = True
    schedule_ready(context, es, ready)
    tp.task_done(task)


def retire_native(tasks: Iterable["Task"], device=None) -> None:
    """Pump-mode retirement: COMPLETE_EXEC accounting for a batch of
    native-scheduled device tasks whose successor release already
    happened inside the native engine (``pz_graph_done_batch``).  Fires
    the COMPLETE_EXEC pins (gated, with ``es=None``), marks the tasks
    retired and bulk-updates the device's executed count — no
    ``release_deps``, no ``schedule_ready``: the Python scheduling core
    never touches these tasks."""
    begin = pins.active(pins.COMPLETE_EXEC_BEGIN)
    end = pins.active(pins.COMPLETE_EXEC_END)
    n = 0
    for task in tasks:
        n += 1
        if begin:
            pins.fire(pins.COMPLETE_EXEC_BEGIN, None, task)
        task.status = TaskStatus.COMPLETE
        task.retired = True
        if end:
            pins.fire(pins.COMPLETE_EXEC_END, None, task)
    if device is not None and n:
        device.count_executed(n)


def task_progress(context: "Context", es: "ExecutionStream", task: "Task") -> HookReturn:
    """Drive one task as far as it will go on this worker."""
    tc = task.task_class
    task.status = TaskStatus.PREPARE_INPUT
    if tc.prepare_input is not None:
        pins.fire(pins.PREPARE_INPUT_BEGIN, es, task)
        rc = tc.prepare_input(es, task)
        pins.fire(pins.PREPARE_INPUT_END, es, task)
        if rc == HookReturn.ASYNC:
            return rc  # awaiting data
        if rc == HookReturn.AGAIN:
            schedule_ready(context, es, [task], distance=1)
            return rc
    rc = execute(context, es, task)
    if rc == HookReturn.DONE:
        complete_execution(context, es, task)
    elif rc == HookReturn.AGAIN:
        # resource busy: demote priority and push away (scheduling.c:495-502)
        task.priority = max(0, task.priority - 1)
        _deselect(task)
        schedule_ready(context, es, [task], distance=1)
    elif rc == HookReturn.ASYNC:
        pass  # a device manager owns completion now
    elif rc == HookReturn.NEXT:
        # this incarnation declined for this task: mask it out so device
        # selection advances to the next chore (reference walks the
        # incarnation array; chore_mask exists for exactly this)
        if task.selected_chore_idx >= 0:
            task.chore_mask &= ~(1 << task.selected_chore_idx)
        if not any(
            task.chore_mask & (1 << ci) and c.enabled
            for ci, c in enumerate(tc.chores)
        ):
            debug.fatal("task %r: every incarnation declined (NEXT)", task)
        _deselect(task)
        schedule_ready(context, es, [task], distance=0)
    elif rc == HookReturn.DISABLE:
        # reference PARSEC_HOOK_RETURN_DISABLE (runtime.h:143): take the
        # failing device offline for future tasks and re-execute this one
        # elsewhere (device_gpu.c:2585).
        if task.selected_device is not None and task.selected_device.device_type != DEV_CPU:
            debug.warning("disabling device %s after DISABLE from %r", task.selected_device.name, task)
            task.selected_device.enabled = False
        elif task.selected_chore is not None:
            task.selected_chore.enabled = False
        _deselect(task)
        schedule_ready(context, es, [task], distance=1)
    elif rc == HookReturn.ERROR:
        debug.fatal("task %r body returned ERROR", task)
    return rc


def _deselect(task: "Task") -> None:
    """Undo a device selection, returning its reserved load."""
    if task.selected_device is not None:
        task.selected_device.sub_load(task.prof.get("est", 0.0))
    task.selected_chore = None
    task.selected_device = None
    task.selected_chore_idx = -1
