"""Task lifecycle enums and hook return codes.

Mirrors the reference's task status lifecycle and hook return conventions
(``parsec/parsec_internal.h:500-505`` task statuses;
``runtime.h:131-148`` ``parsec_hook_return_t``).
"""

from __future__ import annotations

import enum


class TaskStatus(enum.IntEnum):
    """Reference: PARSEC_TASK_STATUS_* (parsec_internal.h:500-505)."""

    NONE = 0
    PREPARE_INPUT = 1
    EVAL = 2
    HOOK = 3
    PREPARE_OUTPUT = 4
    COMPLETE = 5


class HookReturn(enum.IntEnum):
    """Reference: parsec_hook_return_t (runtime.h:131-148)."""

    DONE = 0        # body ran to completion synchronously
    AGAIN = 1       # try again later (resource busy); demote priority
    ASYNC = 2       # a device/thread took ownership; completion is deferred
    NEXT = 3        # this incarnation declines; try the next chore
    DISABLE = 4     # disable this incarnation/device for future tasks
    ERROR = -1


class AccessMode(enum.IntFlag):
    """Flow/argument access semantics. Reference: flow access flags +
    DTD arg flags (``interfaces/dtd/insert_function.h:53-72``)."""

    NONE = 0
    IN = 1
    OUT = 2
    INOUT = 3          # IN | OUT
    CTL = 4            # pure control dependency, no data
    SCRATCH = 8        # per-task scratch allocation
    VALUE = 16         # by-value argument captured at insert time
    ATOMIC_WRITE = 32  # commutative write; order among writers free
    AFFINITY = 64      # this argument decides task placement
    DONT_TRACK = 128   # exclude from dependency tracking


# Device type identifiers used by chores (reference: PARSEC_DEV_* bitmask,
# include/parsec/constants.h). Strings, not bits: registry is dynamic.
DEV_CPU = "cpu"
DEV_RECURSIVE = "recursive"
DEV_TPU = "tpu"
DEV_CUDA = "cuda"
