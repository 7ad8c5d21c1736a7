"""Core runtime (reference L2): context, taskpools, tasks, scheduling."""

from .lifecycle import AccessMode, HookReturn, TaskStatus, DEV_CPU, DEV_CUDA
from .task import Chore, Flow, Task, TaskClass
from .taskpool import Taskpool
from .context import Context, ExecutionStream
from . import sched  # register scheduler components
from . import termdet  # register termdet components

__all__ = [
    "AccessMode",
    "HookReturn",
    "TaskStatus",
    "DEV_CPU",
    "DEV_CUDA",
    "Chore",
    "Flow",
    "Task",
    "TaskClass",
    "Taskpool",
    "Context",
    "ExecutionStream",
]
