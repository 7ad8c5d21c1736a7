"""Scheduler components (MCA framework ``sched``).

Reference: ``parsec/mca/sched/`` — modules sharing the vtable
``install/schedule/select/remove`` (``mca/sched/sched.h``).  The port
carries the default, ``lfq`` (per-thread local queues with stealing); the
other strategies of :mod:`parsec_tpu.core.sched` (gd, ap, ll, rnd, spq,
wdrr, more) are not ported yet (ROADMAP A.11).
"""

from .base import Scheduler
from . import lfq  # noqa: F401  (self-registering)

__all__ = ["Scheduler"]
