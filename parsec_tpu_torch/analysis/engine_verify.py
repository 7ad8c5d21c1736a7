"""engine-verify: exhaustive lifecycle model checking of the native pump
engine, conformance replay of real drained event streams, and the
clang-tidy gate over ``native/src/``.

The port of :mod:`parsec_tpu.analysis.engine_verify`, run against the
library the port builds with g++ (:mod:`parsec_tpu_torch.native`).
Three legs (the ENG0xx family in :mod:`.findings`; the ABI-contract leg
lives in :mod:`parsec_tpu_torch.native.abi`):

* **Model checking** — :class:`EngineModel` is an executable Python
  mirror of ``native/src/graph.cpp``'s pump-mode state machine: the
  per-task dependency counters, the SchedQ (``prio`` max-heap keyed
  ``(priority, -seq, id)`` — pump pushes pass ``distance=0`` — and the
  ``wdrr`` deficit-round-robin ring), batched pop/done, the quiescence
  predicate ``sealed && n_executed == n_inserted``, and the lifecycle
  event ring (``EVT_DEP_DEC``/``EVT_PUBLISH``/``EVT_RETIRE``, with the
  engine's exact emission order: a completing task's successor
  DEP_DECs and PUBLISHes are recorded *before* its own accepted
  RETIRE).  :class:`ModelChecker` explores every interleaving of N
  model workers issuing atomic pop/retire steps with a DPOR-style
  reduction (state memoization + worker-symmetry canonicalization +
  sleep sets over an independence relation), checking ENG010-ENG013
  invariants online at every transition.

* **Conformance replay** — :func:`conformance_findings` replays a real
  engine's drained ``(kind, a, b)`` stream against the same event
  automaton the model enforces, given only the DAG: exactly-once
  publish/retire, per-successor decrement counts that match in-degree
  with the ready flag on the final decrement, and drain order
  consistent with happens-before.  Divergence is ENG014.
  :func:`native_conformance` runs a real pump loop on the port's
  ``libparsec_core.so`` (``NativeGraph`` driven directly) and certifies
  its drain.

* **clang-tidy** — :func:`tidy_findings` runs the repo's
  ``.clang-tidy`` profile over ``native/src/`` with a zero-warning
  gate (ENG020); absent tooling is an explicit INFO skip (ENG021),
  never a silent pass.

The model intentionally matches the granularity the conformance mode
certifies: one drainer thread per ``done_batch`` call (the pump), with
any number of concurrent poppers — each (dep decrement + event record)
pair is one atomic micro-step, as it is under the engine's per-call
``graph_mu`` hold.

Mutation hooks (``EngineModel(mutate=...)``) seed one deliberate defect
each, so the test suite can prove every ENG code actually fires:

========================  ====================================  ======
mutation                  seeded defect                         trips
========================  ====================================  ======
``lost_retire``           worker drops a popped task silently   ENG010
``double_retire``         double-complete guard removed         ENG010
``early_quiesce``         quiescence counts in-flight as done   ENG011
``double_publish``        ready task pushed (+published) twice  ENG012
``drop_event``            first DEP_DEC record suppressed       ENG012
``retire_before_deps``    RETIRE recorded before its DEP_DECs   ENG012
``wdrr_lose_bin``         exhausted-credit bin leaves the ring  ENG013
========================  ====================================  ======
"""

from __future__ import annotations

import heapq
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding

EVT_DEP_DEC, EVT_PUBLISH, EVT_RETIRE = 0, 1, 2
_EVT_NAMES = {EVT_DEP_DEC: "DEP_DEC", EVT_PUBLISH: "PUBLISH",
              EVT_RETIRE: "RETIRE"}

MUTATIONS = ("lost_retire", "double_retire", "early_quiesce",
             "double_publish", "drop_event", "retire_before_deps",
             "wdrr_lose_bin")


# ---------------------------------------------------------------------------
# seed DAGs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SeedDag:
    """A small DAG the checker explores exhaustively.  ``edges`` are
    ``(pred, succ)`` pairs over ``range(n)``; ``priority``/``tenant``
    default to 0; ``weights`` maps tenant -> wdrr weight."""

    name: str
    n: int
    edges: Tuple[Tuple[int, int], ...] = ()
    priority: Tuple[int, ...] = ()
    tenant: Tuple[int, ...] = ()
    weights: Tuple[Tuple[int, int], ...] = ()

    def prio_of(self, t: int) -> int:
        return self.priority[t] if self.priority else 0

    def tenant_of(self, t: int) -> int:
        return self.tenant[t] if self.tenant else 0

    def succs(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in range(self.n)]
        for p, s in self.edges:
            out[p].append(s)
        return out

    def in_degree(self) -> List[int]:
        deg = [0] * self.n
        for _, s in self.edges:
            deg[s] += 1
        return deg


#: the acceptance-criteria trio (3-task chain explored with 2 workers)
#: plus the shapes that exercise each queue discipline
SEED_DAGS: Tuple[SeedDag, ...] = (
    SeedDag("chain3", 3, ((0, 1), (1, 2))),
    SeedDag("indep3", 3, priority=(2, 0, 1)),
    SeedDag("diamond4", 4, ((0, 1), (0, 2), (1, 3), (2, 3)),
            priority=(0, 3, 1, 0)),
    SeedDag("wdrr2x2", 4, tenant=(0, 0, 1, 1), weights=((0, 1), (1, 2))),
)


# ---------------------------------------------------------------------------
# event automaton (shared between the model checker and conformance)
# ---------------------------------------------------------------------------

class EventAutomaton:
    """Online validator of a lifecycle event stream against a DAG.

    Tracks per-task counters only (no order book), so its entire state
    is derivable from the counts — the model checker folds it into the
    memoized state without blowing up the state space.  Checks, at each
    event:

    * PUBLISH exactly once per task, and never before the task's final
      (ready) DEP_DEC for non-roots;
    * per-successor DEP_DEC count never exceeds in-degree, with the
      ready flag set on exactly the in-degree'th decrement;
    * RETIRE(accepted) exactly once, only after the task's PUBLISH,
      and never before the DEP_DECs it emitted (happens-before: the
      engine records a completing task's successor decrements *before*
      its own RETIRE, so a drained RETIRE whose successor counts lag
      its retired-predecessor counts is a reordered drain);
    * a DEP_DEC is only feasible while some published-but-unretired
      predecessor could have emitted it.

    ``code`` parametrizes the finding code: the model checker reports
    precise ENG010/ENG012, conformance mode reports every stream
    divergence as ENG014.
    """

    def __init__(self, dag: SeedDag, code: Optional[str] = None):
        self.dag = dag
        self.succs = dag.succs()
        self.in_deg = dag.in_degree()
        self.code = code
        self.published = [0] * dag.n
        self.dep_decs = [0] * dag.n
        self.ready_seen = [False] * dag.n
        self.retired = [0] * dag.n
        self.refused = [0] * dag.n
        self.retired_preds = [0] * dag.n
        self.findings: List[Finding] = []

    def _emit(self, code: str, msg: str, task: Optional[int] = None) -> None:
        self.findings.append(Finding(
            self.code or code, msg,
            task=None if task is None else f"t{task}"))

    def key(self) -> Tuple:
        return (tuple(self.published), tuple(self.dep_decs),
                tuple(self.retired), tuple(self.refused),
                tuple(self.retired_preds))

    def feed(self, kind: int, a: int, b: int) -> None:
        if kind == EVT_PUBLISH:
            t = a
            self.published[t] += 1
            if self.published[t] > 1:
                self._emit("ENG012", "event drain: task published "
                           f"{self.published[t]} times", t)
            if self.in_deg[t] and not self.ready_seen[t]:
                self._emit("ENG012", "event drain: PUBLISH drained before "
                           "the task's ready DEP_DEC", t)
        elif kind == EVT_DEP_DEC:
            s = a
            self.dep_decs[s] += 1
            if self.dep_decs[s] > self.in_deg[s]:
                self._emit("ENG012", "event drain: more DEP_DECs than "
                           f"in-degree ({self.dep_decs[s]} > "
                           f"{self.in_deg[s]})", s)
            else:
                want_ready = self.dep_decs[s] == self.in_deg[s]
                if bool(b) != want_ready:
                    self._emit("ENG012", "event drain: ready flag on "
                               f"DEP_DEC #{self.dep_decs[s]} of "
                               f"{self.in_deg[s]} is {int(bool(b))}", s)
            if b:
                self.ready_seen[s] = True
            avail = sum(1 for p in range(self.dag.n)
                        if s in self.succs[p] and self.published[p])
            if self.dep_decs[s] > avail:
                self._emit("ENG012", "event drain: DEP_DEC with no "
                           "published unretired predecessor to emit it", s)
        elif kind == EVT_RETIRE:
            t = a
            if b:
                self.retired[t] += 1
                if self.retired[t] > 1:
                    self._emit("ENG010", "accepted retire drained "
                               f"{self.retired[t]} times", t)
                if not self.published[t]:
                    self._emit("ENG012", "event drain: RETIRE of a task "
                               "never published", t)
                for s in self.succs[t]:
                    self.retired_preds[s] += 1
                    if self.dep_decs[s] < self.retired_preds[s]:
                        self._emit("ENG012", "event drain: RETIRE drained "
                                   "before the DEP_DEC it emitted for "
                                   f"successor t{s} (happens-before "
                                   "inversion)", t)
            else:
                self.refused[t] += 1
        else:
            self._emit("ENG012", f"event drain: unknown event kind {kind}")

    def final(self, quiesced: bool, allow_refused: bool = False) -> None:
        """Completeness at end-of-stream: with the engine quiescent,
        every lifecycle event must have drained exactly once."""
        for t in range(self.dag.n):
            if self.retired[t] != 1:
                self._emit("ENG010", "task retired "
                           f"{self.retired[t]} times (expected exactly "
                           "once)", t)
            if self.published[t] != 1:
                self._emit("ENG012", "event drain: task published "
                           f"{self.published[t]} times (expected exactly "
                           "once)", t)
            if self.dep_decs[t] != self.in_deg[t]:
                self._emit("ENG012", "event drain: "
                           f"{self.dep_decs[t]} DEP_DECs for in-degree "
                           f"{self.in_deg[t]}", t)
            if self.refused[t] and not allow_refused:
                self._emit("ENG014", "engine refused "
                           f"{self.refused[t]} double completion(s) for a "
                           "single-drainer pump run", t)
        if not quiesced:
            self._emit("ENG011", "stream complete but the engine never "
                       "declared quiescence")


# ---------------------------------------------------------------------------
# the engine model
# ---------------------------------------------------------------------------

class _SchedQModel:
    """Mirror of graph.cpp ``SchedQ`` for the pump path (``distance`` is
    always 0 there, so the prio key reduces to ``(priority, -seq, id)``;
    the seeded discipline is excluded — its xorshift perturbation is
    covered by the pop-parity mirror tests, not the model checker)."""

    def __init__(self, policy: str = "prio", quantum: int = 4,
                 weights: Iterable[Tuple[int, int]] = ()):
        assert policy in ("prio", "wdrr")
        self.policy = policy
        self.quantum = quantum
        self.seq = 0
        self.count = 0
        self.heap: List[Tuple[int, int, int]] = []  # (-prio, seq, id)
        self.bins: Dict[int, dict] = {}
        self.ring: List[int] = []
        self.cur = 0
        self.weights = dict(weights)

    def _bin(self, tenant: int) -> dict:
        b = self.bins.get(tenant)
        if b is None:
            b = {"heap": [], "deficit": 0,
                 "weight": self.weights.get(tenant, 1)}
            self.bins[tenant] = b
        return b

    def push(self, prio: int, tenant: int, tid: int) -> None:
        self.count += 1
        s = self.seq
        self.seq += 1
        if self.policy == "wdrr":
            b = self._bin(max(tenant, 0))
            if not b["heap"]:
                self.ring.append(max(tenant, 0))
            heapq.heappush(b["heap"], (-prio, s, tid))
            return
        heapq.heappush(self.heap, (-prio, s, tid))

    def pop(self, lose_bin: bool = False) -> int:
        if self.policy == "wdrr":
            while self.ring:
                if self.cur >= len(self.ring):
                    self.cur = 0
                b = self.bins[self.ring[self.cur]]
                if not b["heap"]:
                    b["deficit"] = 0
                    del self.ring[self.cur]
                    continue
                if b["deficit"] <= 0:
                    b["deficit"] += self.quantum * b["weight"]
                tid = heapq.heappop(b["heap"])[2]
                b["deficit"] -= 1
                self.count -= 1
                if lose_bin and b["heap"]:
                    # seeded fault: the bin forfeits its ring slot with
                    # work still queued — the classic DRR lost-bin bug
                    del self.ring[self.cur]
                elif b["deficit"] <= 0 or not b["heap"]:
                    if not b["heap"]:
                        b["deficit"] = 0
                        del self.ring[self.cur]
                    else:
                        self.cur += 1
                return tid
            return -1
        if not self.heap:
            return -1
        tid = heapq.heappop(self.heap)[2]
        self.count -= 1
        return tid

    def can_pop(self) -> bool:
        """True when pop() would return a task.  Ring entries always
        hold nonempty heaps (a bin is erased the moment it drains), so
        a nonempty ring is sufficient; with the ring lost while tasks
        stay binned (the lose_bin fault), ``count > 0`` would lie."""
        if self.policy == "wdrr":
            return bool(self.ring)
        return bool(self.heap)

    def key(self) -> Tuple:
        if self.policy == "wdrr":
            return (tuple(self.ring), self.cur, self.seq,
                    tuple(sorted((t, b["deficit"], tuple(sorted(b["heap"])))
                                 for t, b in self.bins.items())))
        return (tuple(sorted(self.heap)), self.seq)

    def snapshot(self) -> Tuple:
        if self.policy == "wdrr":
            return ("wdrr", self.seq, self.count, tuple(self.ring),
                    self.cur,
                    tuple(sorted((t, b["deficit"], b["weight"],
                                  tuple(b["heap"]))
                                 for t, b in self.bins.items())))
        return ("prio", self.seq, self.count, tuple(self.heap))

    def restore(self, snap: Tuple) -> None:
        if snap[0] == "wdrr":
            _, self.seq, self.count, ring, self.cur, bins = snap
            self.ring = list(ring)
            self.bins = {t: {"deficit": d, "weight": w, "heap": list(h)}
                         for t, d, w, h in bins}
        else:
            _, self.seq, self.count, heap = snap
            self.heap = list(heap)


class EngineModel:
    """Executable mirror of the native pump engine over one seed DAG.

    Atomic steps (the engine's lock granularity): ``pop()`` — one
    SchedQ pop under ``sq.mu``; ``retire(tid)`` — the per-task body of
    ``pz_graph_done_batch`` under ``graph_mu``: the double-complete
    guard, ``complete()`` (successor decrements, ready pushes, their
    DEP_DEC/PUBLISH events), and the task's own RETIRE event.
    """

    def __init__(self, dag: SeedDag, policy: str = "prio",
                 quantum: int = 4, mutate: Optional[str] = None):
        if mutate is not None and mutate not in MUTATIONS:
            raise ValueError(f"unknown mutation {mutate!r}")
        self.dag = dag
        self.mutate = mutate
        self.succs = dag.succs()
        self.missing = dag.in_degree()
        self.done = [False] * dag.n
        self.n_executed = 0
        self.n_inserted = dag.n
        self.sealed = True
        self.sq = _SchedQModel(policy, quantum, dag.weights)
        self.auto = EventAutomaton(dag)
        self._dropped_one_event = False
        # commit: every root publishes (graph.cpp pz_graph_task_commit
        # -> push_pump -> EVT_PUBLISH for missing==0 tasks)
        for t in range(dag.n):
            if self.missing[t] == 0:
                self._publish(t)

    # -- event plumbing ------------------------------------------------
    def _record(self, kind: int, a: int, b: int) -> None:
        if (self.mutate == "drop_event" and kind == EVT_DEP_DEC
                and not self._dropped_one_event):
            self._dropped_one_event = True
            return
        self.auto.feed(kind, a, b)

    def _publish(self, t: int) -> None:
        self.sq.push(self.dag.prio_of(t), self.dag.tenant_of(t), t)
        self._record(EVT_PUBLISH, t, self.dag.prio_of(t))
        if self.mutate == "double_publish":
            self.sq.push(self.dag.prio_of(t), self.dag.tenant_of(t), t)
            self._record(EVT_PUBLISH, t, self.dag.prio_of(t))

    # -- atomic steps --------------------------------------------------
    def pop(self) -> int:
        return self.sq.pop(lose_bin=self.mutate == "wdrr_lose_bin")

    def retire(self, tid: int) -> bool:
        """One task of a done_batch.  Returns False when the guard
        refused a double completion."""
        if self.mutate == "lost_retire":
            # the worker drops the popped task on the floor: no guard,
            # no complete, no events — the task simply never retires
            return True
        if self.done[tid] and self.mutate != "double_retire":
            self._record(EVT_RETIRE, tid, 0)
            return False
        self.done[tid] = True
        # seeded fault double_retire: the done.exchange guard is gone,
        # so a duplicate id in a batch completes a second time
        rounds = 2 if self.mutate == "double_retire" else 1
        for _ in range(rounds):
            if self.mutate == "retire_before_deps":
                self._record(EVT_RETIRE, tid, 1)
            # complete(): per successor, (decrement + DEP_DEC record)
            # then a PUBLISH for each newly ready one — all recorded
            # before the task's own RETIRE
            for s in self.succs[tid]:
                self.missing[s] -= 1
                ready = self.missing[s] == 0
                self._record(EVT_DEP_DEC, s, 1 if ready else 0)
                if ready:
                    self._publish(s)
            self.n_executed += 1
            if self.mutate != "retire_before_deps":
                self._record(EVT_RETIRE, tid, 1)
        return True

    # -- predicates ----------------------------------------------------
    def quiesced(self, in_flight: int = 0) -> bool:
        if self.mutate == "early_quiesce":
            # seeded fault: quiescence counts popped-but-unretired
            # in-flight tasks as executed
            return self.sealed and (self.n_executed + in_flight
                                    >= self.n_inserted)
        return self.sealed and self.n_executed == self.n_inserted

    # -- state save/restore for DFS ------------------------------------
    def snapshot(self) -> Tuple:
        return (tuple(self.missing), tuple(self.done), self.n_executed,
                self.sq.snapshot(), self._dropped_one_event,
                (tuple(self.auto.published), tuple(self.auto.dep_decs),
                 tuple(self.auto.ready_seen), tuple(self.auto.retired),
                 tuple(self.auto.refused), tuple(self.auto.retired_preds),
                 len(self.auto.findings)))

    def restore(self, snap: Tuple) -> None:
        (missing, done, self.n_executed, sq, self._dropped_one_event,
         auto) = snap
        self.missing = list(missing)
        self.done = list(done)
        self.sq.restore(sq)
        a = self.auto
        (pub, dec, ready, ret, refused, rpreds, nf) = auto
        a.published, a.dep_decs = list(pub), list(dec)
        a.ready_seen, a.retired = list(ready), list(ret)
        a.refused, a.retired_preds = list(refused), list(rpreds)
        del a.findings[nf:]


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

@dataclass
class ExploreStats:
    states: int = 0
    transitions: int = 0
    sleep_skips: int = 0
    max_depth: int = 0
    terminals: int = 0
    truncated: bool = False


class ModelChecker:
    """Exhaustive DFS over every interleaving of ``workers`` model
    threads issuing atomic pop/retire steps, with a DPOR-style
    reduction: canonical-state memoization (worker identities are
    symmetric, so held-task multisets are sorted before hashing), and
    sleep sets over a conservative independence relation (two retires
    of distinct sink tasks commute — they touch no shared dependency
    counter and push nothing).

    ENG010/ENG012 fire online inside the event automaton; ENG011 is
    checked after every transition (quiescence declared with a popped
    task in flight, a queued task, or an unretired task); ENG013 both
    as bounded overtaking during exploration (a nonempty bin skipped
    for more than one full credit rotation) and as a lost bin at
    terminal states (idle workers, empty-popping queue, work still
    binned).
    """

    def __init__(self, model: EngineModel, workers: int = 2,
                 max_states: int = 250_000):
        self.m = model
        self.workers = workers
        self.max_states = max_states
        self.stats = ExploreStats()
        self.findings: List[Finding] = []
        self._seen_msgs: Set[Tuple[str, str, Optional[str]]] = set()
        self._visited: Set[Tuple] = set()
        # wdrr bounded-overtaking budget: one full rotation grants
        # every bin its refilled credits, so a nonempty bin that
        # watches more than sum(quantum*weight)+|bins| foreign pops
        # without popping has been starved
        w = model.sq.weights
        nbins = max(len({model.dag.tenant_of(t)
                         for t in range(model.dag.n)}), 1)
        self._starve_bound = (model.sq.quantum
                              * max(sum(w.values()), nbins) + nbins + 1)

    # -- finding plumbing ---------------------------------------------
    def _emit(self, code: str, msg: str, task: Optional[str] = None) -> None:
        k = (code, msg, task)
        if k not in self._seen_msgs:
            self._seen_msgs.add(k)
            self.findings.append(Finding(code, msg, task=task))

    def _absorb_auto(self) -> None:
        for f in self.m.auto.findings:
            self._emit(f.code, f.message, f.task)

    # -- state --------------------------------------------------------
    def _key(self, held: List[List[int]], skips: Tuple[int, ...]) -> Tuple:
        return (tuple(self.m.missing), tuple(self.m.done),
                self.m.n_executed, self.m.sq.key(),
                tuple(sorted(tuple(sorted(h)) for h in held)),
                self.m.auto.key(), skips)

    # -- invariants ---------------------------------------------------
    def _check_state(self, held: List[List[int]]) -> None:
        in_flight = sum(len(h) for h in held)
        if self.m.quiesced(in_flight):
            if in_flight:
                self._emit("ENG011", "quiescence declared with "
                           f"{in_flight} popped task(s) still in flight")
            elif self.m.sq.count:
                self._emit("ENG011", "quiescence declared with "
                           f"{self.m.sq.count} task(s) still queued")
            elif not all(self.m.done):
                pend = [t for t in range(self.m.dag.n) if not self.m.done[t]]
                self._emit("ENG011", "quiescence declared before task(s) "
                           f"{pend} retired")

    def _check_terminal(self, held: List[List[int]]) -> None:
        self.stats.terminals += 1
        for t in range(self.m.dag.n):
            if self.m.auto.retired[t] != 1:
                self._emit("ENG010", "task retired "
                           f"{self.m.auto.retired[t]} times in a complete "
                           "interleaving (expected exactly once)", f"t{t}")
        if self.m.sq.policy == "wdrr" and self.m.sq.count:
            starved = sorted(t for t, b in self.m.sq.bins.items()
                             if b["heap"])
            self._emit("ENG013", f"wdrr lost bin(s) {starved}: tasks "
                       "queued but the ring no longer serves them "
                       "(workers idle, pops return empty)")
        elif self.m.sq.count and not any(held):
            self._emit("ENG010", f"{self.m.sq.count} task(s) queued at a "
                       "terminal state with idle workers")
        if all(self.m.done) and not self.m.quiesced(0):
            self._emit("ENG011", "all tasks retired but quiescence never "
                       "declared")
        # event completeness only on clean terminals: a lost bin/retire
        # already produced its own precise finding
        if all(c == 1 for c in self.m.auto.retired):
            a = EventAutomaton(self.m.dag)  # throwaway: reuse final()
            a.published = list(self.m.auto.published)
            a.dep_decs = list(self.m.auto.dep_decs)
            a.retired = list(self.m.auto.retired)
            a.refused = [0] * self.m.dag.n  # refusals are legal races here
            a.in_deg = self.m.auto.in_deg
            a.final(quiesced=True)
            for f in a.findings:
                self._emit(f.code, f.message, f.task)

    # -- independence (sleep sets) ------------------------------------
    def _independent(self, a: Tuple, b: Tuple) -> bool:
        # only (retire t1, retire t2) on distinct sink tasks commute:
        # no shared counters, no queue pushes, commuting event counts
        if a[0] != "retire" or b[0] != "retire":
            return False
        t1, t2 = a[2], b[2]
        return (t1 != t2 and not self.m.succs[t1] and not self.m.succs[t2])

    # -- exploration ---------------------------------------------------
    def run(self) -> List[Finding]:
        held: List[List[int]] = [[] for _ in range(self.workers)]
        skips: List[int] = [0] * 64  # per-tenant foreign-pop counters
        self._dfs(held, skips, 0, frozenset())
        return self.findings

    def _enabled(self, held: List[List[int]]) -> List[Tuple]:
        acts: List[Tuple] = []
        for w in range(self.workers):
            if self.m.sq.can_pop():
                acts.append(("pop", w))
            for t in sorted(set(held[w])):
                acts.append(("retire", w, t))
        return acts

    def _dfs(self, held: List[List[int]], skips: List[int],
             depth: int, sleep: frozenset) -> None:
        if self.stats.states >= self.max_states:
            self.stats.truncated = True
            return
        key = self._key(held, tuple(skips[:8]))
        if key in self._visited:
            return
        self._visited.add(key)
        self.stats.states += 1
        self.stats.max_depth = max(self.stats.max_depth, depth)

        acts = self._enabled(held)
        if not acts:
            self._check_terminal(held)
            return

        done_here: List[Tuple] = []
        for act in acts:
            if act in sleep:
                self.stats.sleep_skips += 1
                continue
            snap = self.m.snapshot()
            held_snap = [list(h) for h in held]
            skips_snap = list(skips)

            if act[0] == "pop":
                tid = self.m.pop()
                if tid >= 0:
                    held[act[1]].append(tid)
                    if self.m.sq.policy == "wdrr":
                        ten = self.m.dag.tenant_of(tid)
                        for t, b in self.m.sq.bins.items():
                            if t != ten and b["heap"]:
                                skips[t] += 1
                                if skips[t] > self._starve_bound:
                                    self._emit(
                                        "ENG013",
                                        f"wdrr starvation: tenant {t} has "
                                        "queued work but other tenants "
                                        f"popped {skips[t]} times in a row "
                                        f"(bound {self._starve_bound})")
                        skips[ten] = 0
            else:
                _, w, t = act
                held[w].remove(t)
                self.m.retire(t)
                self._absorb_auto()

            self.stats.transitions += 1
            self._check_state(held)
            nxt = frozenset(a for a in (set(sleep) | set(done_here))
                            if self._independent(a, act))
            self._dfs(held, skips, depth + 1, nxt)

            self.m.restore(snap)
            for i in range(self.workers):
                held[i][:] = held_snap[i]
            skips[:] = skips_snap
            done_here.append(act)


def model_findings(dags: Sequence[SeedDag] = SEED_DAGS, workers: int = 2,
                   mutate: Optional[str] = None,
                   max_states: int = 250_000
                   ) -> Tuple[List[Finding], Dict[str, ExploreStats]]:
    """Explore every seed DAG under its natural policy; returns the
    deduplicated findings and per-DAG exploration stats."""
    out: List[Finding] = []
    stats: Dict[str, ExploreStats] = {}
    for dag in dags:
        policy = "wdrr" if dag.weights or dag.tenant else "prio"
        m = EngineModel(dag, policy=policy, mutate=mutate)
        c = ModelChecker(m, workers=workers, max_states=max_states)
        for f in c.run():
            out.append(Finding(f.code, f"[{dag.name}/{policy}] {f.message}",
                               task=f.task))
        stats[dag.name] = c.stats
    return out, stats


# ---------------------------------------------------------------------------
# conformance replay
# ---------------------------------------------------------------------------

def conformance_findings(dag: SeedDag,
                         events: Iterable[Tuple[int, int, int]],
                         quiesced: bool = True) -> List[Finding]:
    """Replay a real engine's drained ``(kind, a, b)`` stream against
    the lifecycle automaton.  Every divergence reports as ENG014."""
    auto = EventAutomaton(dag, code="ENG014")
    for kind, a, b in events:
        auto.feed(int(kind), int(a), int(b))
    auto.final(quiesced=quiesced)
    return auto.findings


def _dag_from_edges(n: int, edges: Iterable[Tuple[int, int]],
                    name: str = "conformance") -> SeedDag:
    return SeedDag(name, n, tuple((int(p), int(s)) for p, s in edges))


def dpotrf_dag(nt: int) -> Tuple[int, List[Tuple[int, int]], Dict[Tuple, int]]:
    """Tiled right-looking Cholesky task DAG over an ``nt x nt`` tile
    grid (POTRF/TRSM/SYRK/GEMM), the acceptance workload.  Returns
    ``(n_tasks, edges, id_of)`` with ``id_of`` keyed by the task tuple
    (``("potrf", k)`` etc.) in insertion order."""
    ids: Dict[Tuple, int] = {}

    def tid(*key) -> int:
        return ids.setdefault(key, len(ids))

    edges: List[Tuple[int, int]] = []
    for k in range(nt):
        p = tid("potrf", k)
        if k:
            edges.append((tid("syrk", k - 1, k), p))
        for m in range(k + 1, nt):
            t = tid("trsm", k, m)
            edges.append((p, t))
            if k:
                edges.append((tid("gemm", k - 1, m, k), t))
        for m in range(k + 1, nt):
            s = tid("syrk", k, m)
            edges.append((tid("trsm", k, m), s))
            if k:
                edges.append((tid("syrk", k - 1, m), s))
            for n in range(m + 1, nt):
                g = tid("gemm", k, n, m)
                edges.append((tid("trsm", k, m), g))
                edges.append((tid("trsm", k, n), g))
                if k:
                    edges.append((tid("gemm", k - 1, n, m), g))
    return len(ids), edges, ids


def native_conformance(nt: int = 4, seeds: Sequence[int] = (0,),
                       batch: int = 8) -> Tuple[List[Finding], Dict[str, int]]:
    """Run a real pump loop — ``pop_batch``/``done_batch`` with the
    event drain enabled — over the dpotrf DAG on the port's native
    library (built on first use; an unbuildable library raises), for each
    schedule-explorer seed, and certify every drained stream against the
    model.  Returns (findings, stats)."""
    import ctypes

    from .. import native

    n, edges, _ = dpotrf_dag(nt)
    dag = _dag_from_edges(n, edges, name=f"dpotrf{nt}")
    out: List[Finding] = []
    stats = {"tasks": n, "edges": len(edges), "runs": 0, "events": 0}
    for seed in seeds:
        ng = native.NativeGraph()
        if seed >= 0:
            # seeded pops perturb ORDER only; lifecycle events are
            # order-insensitive in the automaton, so every explorer
            # seed must certify
            ng.sched_config(seed=seed)
        ng.events_enable(True)
        ids = [ng.add_task() for _ in range(n)]
        for p, s in edges:
            ng.add_dep(ids[p], ids[s])
        back = {nid: i for i, nid in enumerate(ids)}
        for t in ids:
            ng.commit(t)
        ng.seal()

        buf = (ctypes.c_int64 * batch)()
        ek = (ctypes.c_int32 * 512)()
        ea = (ctypes.c_int64 * 512)()
        eb = (ctypes.c_int64 * 512)()
        events: List[Tuple[int, int, int]] = []

        def drain() -> None:
            while True:
                c = ng.events_drain(ek, ea, eb)
                stats["events"] += c
                for i in range(c):
                    events.append((ek[i], ea[i], eb[i]))
                if c < len(ek):
                    break

        guard = 0
        while not ng.quiesced():
            got = ng.pop_batch(buf)
            if got:
                ng.done_batch(buf, got)
            drain()
            guard += 1
            if guard > 10 * n:  # pragma: no cover - engine defect
                out.append(Finding("ENG014",
                                   f"pump did not quiesce after {guard} "
                                   "iterations"))
                break
        drain()
        # native ids are remapped to dag indices before replay
        events = [(k, back.get(a, a), b) for k, a, b in events]
        out.extend(conformance_findings(dag, events,
                                        quiesced=ng.quiesced()))
        stats["runs"] += 1
    return out, stats


# ---------------------------------------------------------------------------
# clang-tidy gate
# ---------------------------------------------------------------------------

#: checks the profile enables (kept in .clang-tidy; this is the
#: fallback when the profile file is missing)
TIDY_CHECKS = ("-*,bugprone-*,concurrency-*,clang-analyzer-*,"
               "performance-*,-bugprone-easily-swappable-parameters")


def tidy_findings(src_dir: Optional[str] = None,
                  binary: Optional[str] = None) -> List[Finding]:
    """Run clang-tidy over every ``native/src/*.cpp`` with the repo
    profile and a zero-warning gate.  Absent tooling is an explicit
    ENG021 INFO skip — reported, never silently passed."""
    if src_dir is None:
        from ..native import SRC_DIR
        src_dir = SRC_DIR
    tidy = binary or shutil.which("clang-tidy")
    if not tidy:
        return [Finding("ENG021", "clang-tidy not found on PATH: the C++ "
                        "static-analysis gate was skipped, not passed")]
    srcs = sorted(f for f in os.listdir(src_dir) if f.endswith(".cpp"))
    if not srcs:
        return [Finding("ENG021", f"no C++ sources under {src_dir}")]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(src_dir)))
    profile = os.path.join(repo, ".clang-tidy")
    cmd = [tidy, "--quiet"]
    if not os.path.exists(profile):
        cmd.append(f"--checks={TIDY_CHECKS}")
    cmd += [os.path.join(src_dir, f) for f in srcs]
    cmd += ["--", "-std=c++17", "-pthread", f"-I{src_dir}"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [Finding("ENG021", f"clang-tidy did not run ({e}): gate "
                        "skipped, not passed")]
    out: List[Finding] = []
    for line in proc.stdout.splitlines():
        if ": warning:" in line or ": error:" in line:
            out.append(Finding("ENG020", line.strip()))
    if not out and proc.returncode not in (0, 1):
        out.append(Finding("ENG021", "clang-tidy exited "
                           f"{proc.returncode} with no diagnostics: gate "
                           "skipped, not passed"))
    return out


# ---------------------------------------------------------------------------
# aggregate entry point
# ---------------------------------------------------------------------------

def verify_engine(legs: Sequence[str] = ("abi", "model", "conformance",
                                         "tidy"),
                  workers: int = 2, conformance_nt: int = 4,
                  conformance_seeds: Sequence[int] = (0, 1, 2, 3)
                  ) -> Tuple[List[Finding], Dict[str, object]]:
    """Run the requested engine-verify legs; returns (findings, stats).
    ``tools engine-verify`` and ``tools check`` sit on top of this."""
    out: List[Finding] = []
    stats: Dict[str, object] = {}
    if "abi" in legs:
        from .. import native
        from ..native import abi

        # the library the port loads: build_library returns it as it is
        # when it is newer than every source, and builds it otherwise
        fs = abi.abi_findings(native.build_library(), native.SRC_DIR)
        out.extend(fs)
        stats["abi"] = {"symbols": len(abi.SPEC), "findings": len(fs)}
    if "model" in legs:
        fs, st = model_findings(workers=workers)
        out.extend(fs)
        stats["model"] = {name: vars(s) for name, s in st.items()}
    if "conformance" in legs:
        fs, st = native_conformance(nt=conformance_nt,
                                    seeds=conformance_seeds)
        out.extend(fs)
        stats["conformance"] = st
    if "tidy" in legs:
        fs = tidy_findings()
        out.extend(fs)
        stats["tidy"] = {"findings": len(fs)}
    return out, stats
