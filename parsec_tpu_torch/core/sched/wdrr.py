"""``wdrr`` — weighted deficit-round-robin over per-tenant ready queues.

The fairness layer of the serving plane (the reference's
``parsec_tpu.serve``, the port's ``parsec_tpu_torch.serve``): one
6000-task dpotrf must not starve a stream of 20-task stencil jobs just
because it got its tasks into the queue first.  Every ready task is
binned by its taskpool's *tenant* (pools outside a service share one
default bin), and workers pop via classic deficit round robin
[Shreedhar & Varghese '96]: each visit to a tenant's turn replenishes
its deficit by ``quantum x weight`` task credits, and the tenant keeps
the floor until the credits are spent or its queue drains.  A tenant
with weight 2 therefore retires ~2x the tasks per round of a weight-1
tenant — REGARDLESS of backlog sizes — while an idle tenant consumes
nothing (its bin leaves the ring and its stale deficit is forfeited).

Within a tenant, pops follow (priority desc, insertion order) — the
composed (tenant weight, job priority, task priority) ordering the
serving plane folds into ``Task.priority`` — so fairness decides WHICH
tenant runs and priority decides WHAT it runs.

Select like ``spq``, this is a single global structure (no per-worker
queues): the serving meshes it exists for are dispatch-bound on the
device manager, not on queue contention.

With MCA ``sched_native_queue=1`` the bins, ring and deficits live in
the native engine's SchedQ (``pz_rq_*`` — the exact C++ mirror of this
module's semantics, shared with the pump scheduler's wdrr mode): pop
order is identical, queue ops leave the interpreter, and task objects
stay in a handle-keyed Python dict (ownership handoff on pop).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Dict, List, Optional

from ...utils import register_component, mca_param
from .base import Scheduler, native_ready_queue

#: tenant bin for tasks whose pool was never admitted by a service
_DEFAULT = "_"


class _TenantQ:
    __slots__ = ("key", "weight", "heap", "deficit")

    def __init__(self, key: str, weight: int):
        self.key = key
        self.weight = max(1, int(weight))
        self.heap: List = []
        self.deficit = 0


@register_component("sched")
class SchedWDRR(Scheduler):
    mca_name = "wdrr"
    mca_priority = 2  # explicit selection only (sched=wdrr / serve)

    def install(self, context) -> None:
        super().install(context)
        self._quantum = int(mca_param.register(
            "sched", "wdrr_quantum", 4,
            help="task credits a tenant's deficit gains per round-robin "
                 "visit, scaled by the tenant's weight"))
        if self._quantum < 1:
            raise ValueError(
                f"sched_wdrr_quantum must be >= 1 (got {self._quantum})")
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._tenants: Dict[str, _TenantQ] = {}
        #: round-robin ring of tenant keys with queued tasks
        self._ring: List[str] = []
        self._cur = 0
        self._count = 0
        self._nq = native_ready_queue("wdrr", quantum=self._quantum)
        self._owned: Dict[int, object] = {}
        #: tenant key -> native tenant index (and its last-set weight)
        self._nq_tenants: Dict[str, int] = {}
        self._nq_weights: Dict[str, int] = {}

    @staticmethod
    def _key_of(task) -> str:
        return getattr(task.taskpool, "tenant", None) or _DEFAULT

    def _native_tenant(self, task) -> int:
        key = self._key_of(task)
        idx = self._nq_tenants.get(key)
        if idx is None:
            idx = self._nq_tenants[key] = len(self._nq_tenants) + 1
        w = max(1, int(getattr(task.taskpool, "tenant_weight", 1)))
        if self._nq_weights.get(key) != w:
            # weights are service-managed and may be re-tuned between
            # jobs; the latest admitted pool wins (same rule as below)
            self._nq_weights[key] = w
            self._nq.set_tenant_weight(idx, w)
        return idx

    def schedule(self, es, tasks, distance: int = 0) -> None:
        with self._lock:
            if self._nq is not None:
                for t in tasks:
                    h = next(self._seq)
                    self._owned[h] = t
                    self._nq.push(t.priority, h,
                                  tenant=self._native_tenant(t))
                return
            for t in tasks:
                key = self._key_of(t)
                tq = self._tenants.get(key)
                if tq is None:
                    tq = self._tenants[key] = _TenantQ(
                        key, getattr(t.taskpool, "tenant_weight", 1))
                else:
                    # weights are service-managed and may be re-tuned
                    # between jobs; the latest admitted pool wins
                    tq.weight = max(1, int(
                        getattr(t.taskpool, "tenant_weight", tq.weight)))
                if not tq.heap:
                    self._ring.append(key)
                heapq.heappush(tq.heap,
                               (-t.priority, next(self._seq), t))
                self._count += 1

    def select(self, es) -> Optional["object"]:
        with self._lock:
            if self._nq is not None:
                h = self._nq.pop()
                return None if h < 0 else self._owned.pop(h)
            while self._ring:
                if self._cur >= len(self._ring):
                    self._cur = 0
                key = self._ring[self._cur]
                tq = self._tenants[key]
                if not tq.heap:
                    # drained since its last pop: retire the bin and
                    # forfeit its credits (an idle tenant must not bank
                    # an unbounded burst for its return)
                    tq.deficit = 0
                    self._ring.pop(self._cur)
                    continue
                if tq.deficit <= 0:
                    tq.deficit += self._quantum * tq.weight
                task = heapq.heappop(tq.heap)[2]
                tq.deficit -= 1
                self._count -= 1
                if tq.deficit <= 0 or not tq.heap:
                    if not tq.heap:
                        tq.deficit = 0
                        self._ring.pop(self._cur)
                    else:
                        self._cur += 1
                return task
            return None

    def pending_estimate(self) -> int:
        return len(self._owned) if self._nq is not None else self._count

    def remove(self, context) -> None:
        with self._lock:
            if self._nq is not None:
                self._nq.close()
                self._nq = None
            self._owned.clear()
            self._nq_tenants.clear()
            self._nq_weights.clear()
            self._tenants.clear()
            self._ring.clear()
            self._count = 0
