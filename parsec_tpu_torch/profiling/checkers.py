"""Runtime correctness checkers (PINS modules).

Reference: ``parsec/mca/pins/iterators_checker/`` — a PINS
module that cross-checks the successor/predecessor iterators of every
executed task against the dependencies actually released at runtime.  Here
the declared DAG comes from :func:`parsec_tpu_torch.dsl.graph.capture`, and the
observed DAG from the RELEASE_DEPS / COMPLETE_EXEC PINS sites.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from . import pins


class IteratorsChecker:
    """Subscribe to the PINS sites, run the workload, then :meth:`verify`
    against a PTG taskpool's declared dependency structure.

    Checks performed (mirroring the reference module's assertions):

    * every executed task is one the declared DAG contains;
    * every *released* successor corresponds to a declared edge of the
      releasing task (``iterate_successors`` consistency);
    * at the end, the executed set covers the declared local task set
      exactly (nothing lost, nothing spurious);
    * every non-startup task was released exactly once (single final
      release when its dependency goal is reached), and its releaser
      completed.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.executed: List[Tuple[int, str, Tuple]] = []  # (tp_id, class, locals)
        self.released: List[Tuple[int, Tuple, Tuple]] = []  # (tp_id, src tid, dst tid)
        self.errors: List[str] = []
        self._installed = False

    # -- pins wiring ------------------------------------------------------
    def install(self) -> "IteratorsChecker":
        pins.subscribe(pins.COMPLETE_EXEC_END, self._on_complete)
        pins.subscribe(pins.RELEASE_DEPS_END, self._on_release)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            pins.unsubscribe(pins.COMPLETE_EXEC_END, self._on_complete)
            pins.unsubscribe(pins.RELEASE_DEPS_END, self._on_release)
            self._installed = False

    def __enter__(self) -> "IteratorsChecker":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_complete(self, es, task) -> None:
        with self._lock:
            self.executed.append((task.taskpool.taskpool_id, task.task_class.name, tuple(task.locals)))

    def _on_release(self, es, payload) -> None:
        task, ready = payload
        src = (task.task_class.name, tuple(task.locals))
        with self._lock:
            for r in ready:
                self.released.append(
                    (task.taskpool.taskpool_id, src, (r.task_class.name, tuple(r.locals))))

    # -- verification ------------------------------------------------------
    def verify(self, ptg_tp, rank: Optional[int] = None) -> List[str]:
        """Compare observations against the declared DAG of ``ptg_tp``.
        Returns the list of inconsistencies (empty = clean).

        The declared edges come from the SAME enumeration the static
        verifier uses (:mod:`parsec_tpu_torch.analysis.edges`), so the runtime
        checker and ``ptg-lint`` can never disagree about what the
        declared dependency structure is."""
        from ..analysis.edges import declared_dag, declared_edge_set

        if rank is None:
            rank = ptg_tp.context.rank if ptg_tp.context else 0
        g = declared_dag(ptg_tp, ranks=[rank])
        declared: Set[Tuple] = set(g.nodes)
        edges: Set[Tuple[Tuple, Tuple]] = declared_edge_set(g)
        errors: List[str] = []
        with self._lock:
            executed = [(c, l) for (tp, c, l) in self.executed if tp == ptg_tp.taskpool_id]
            released = [(s, d) for (tp, s, d) in self.released if tp == ptg_tp.taskpool_id]

        exec_set = set(executed)
        for t in executed:
            if t not in declared:
                errors.append(f"executed task {t} not in declared DAG")
        if len(executed) != len(exec_set):
            errors.append("some task executed more than once")
        missing = declared - exec_set
        if missing:
            errors.append(f"declared tasks never executed: {sorted(missing)[:5]}")
        for (s, d) in released:
            if (s, d) not in edges:
                errors.append(f"released edge {s} -> {d} has no declared dependency")
            if s not in exec_set:
                errors.append(f"release by {s} observed but {s} never completed")
        # every non-startup task becomes ready through exactly one final
        # release (counter reaching its goal once)
        release_count: Dict[Tuple, int] = {}
        for (_s, d) in released:
            release_count[d] = release_count.get(d, 0) + 1
        for tid, node in g.nodes.items():
            expect = 1 if node.in_edges > 0 else 0
            got = release_count.get(tid, 0)
            if got != expect:
                errors.append(f"task {tid} released {got} times (expected {expect})")
        # after a clean quiesce every dependency counter has fired and
        # been deleted; a leftover is a task released by only a strict
        # subset of its producers (the runtime signature of the
        # asymmetric-deps defects ptg-lint reports as PTG001/PTG002)
        pending = getattr(ptg_tp.deps, "pending_keys", lambda: [])()
        if pending:
            errors.append(
                f"dependency counters still pending for {sorted(pending)[:5]}"
                f" ({len(pending)} total): partial release / missed fire")
        self.errors = errors
        return errors
