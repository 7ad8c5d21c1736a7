"""Scheduler components (MCA framework ``sched``).

Reference: ``parsec/mca/sched/`` — modules sharing the vtable
``install/schedule/select/remove`` (``mca/sched/sched.h``).  The port of
:mod:`parsec_tpu.core.sched`: all twelve strategies (lfq, gd, ap, ll, rnd,
spq, wdrr and :mod:`.more`'s llp, ltq, pbq, lhq, ip).  Each module
registers itself; ``Context(scheduler=...)`` or ``PARSEC_MCA_mca_sched``
selects one, and ``lfq`` (per-thread local queues with stealing) is the
default, as in the reference.
"""

from .base import Scheduler
from . import lfq, gd, ap, ll, rnd, spq, wdrr, more  # noqa: F401  (self-registering)

__all__ = ["Scheduler"]
