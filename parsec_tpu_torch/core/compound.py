"""Compound taskpools: sequential composition via on_complete chaining.

Reference: ``parsec/compound.c`` (``parsec_compose`` :96) — a compound
taskpool runs its members one after another; member *i+1* is enqueued when
member *i* terminates.  The port of :mod:`parsec_tpu.core.compound`,
tenant propagation to the members included.
"""

from __future__ import annotations

from typing import List

from .taskpool import Taskpool


class CompoundTaskpool(Taskpool):
    def __init__(self, *members: Taskpool, name: str = "compound"):
        super().__init__(name=name)
        self.taskpool_type = Taskpool.TYPE_COMPOUND
        self.members: List[Taskpool] = list(members)
        self._next = 0
        # compound owns one synthetic "task" per member so the local termdet
        # fires only after the last member finishes
        self.tdm.taskpool_set_nb_tasks(self, len(self.members))

    def add(self, tp: Taskpool) -> "CompoundTaskpool":
        self.members.append(tp)
        self.tdm.taskpool_addto_nb_tasks(self, 1)
        return self

    def attached(self, context) -> None:
        # base attach does the bookkeeping (the _known_nb_tasks branch is a
        # no-op here — the member count was set in __init__), then the
        # first member launches
        super().attached(context)
        self._launch_next()

    def startup(self, context):
        return []

    def _launch_next(self) -> None:
        if self._next >= len(self.members):
            return
        member = self.members[self._next]
        self._next += 1
        # the serving plane's identity reaches the members at launch: a
        # compound submitted through a RuntimeService got its tenant and
        # composed priority at admission, after construction
        if self.tenant is not None:
            member.tenant = self.tenant
            member.tenant_weight = self.tenant_weight
            member.job_priority = self.job_priority
            member.priority_base = self.priority_base
        prev_cb = member.on_complete

        def chain(tp, _prev=prev_cb):
            if _prev is not None:
                _prev(tp)
            # retire through task_done (not a bare tdm decrement), so
            # nb_retired counts the members that finished
            self.task_done()
            self._launch_next()

        member.on_complete = chain
        if self.context is None:
            raise RuntimeError("compound taskpool launched before attach")
        self.context.add_taskpool(member)


def compose(a: Taskpool, b: Taskpool) -> CompoundTaskpool:
    """Reference ``parsec_compose(compound.c:96)``: folds compounds."""
    if isinstance(a, CompoundTaskpool):
        return a.add(b)
    return CompoundTaskpool(a, b)
