"""lockdep — lock-order runtime checker for the Python side.

The port of :mod:`parsec_tpu.analysis.lockdep`.  It covers the
interpreter half of the lock-order question (the reference's native
flavor, a ThreadSanitizer build of the engine, is not part of the port):
every ``threading.Lock``/``RLock`` **created while the checker is
installed** is wrapped so acquisitions record, per thread, the stack of
locks currently held.  Locks are classed by their allocation site
(``file:line``, the lockdep "lock class"), and the checker maintains a
directed graph of observed orders between classes: observing both
``A -> B`` and ``B -> A`` is an inconsistent order — a potential
deadlock — reported as an ``RT010``
:class:`~parsec_tpu_torch.analysis.findings.Finding` carrying both acquisition
stacks.

Opt-in only (``install()``/context manager, or ``PARSEC_TPU_LOCKDEP=1``
which installs at the first ``Context`` construction): patching the
``threading`` factories is global, and locks created *before* install
(module-level locks) are not tracked — run the workload you want checked
entirely inside the scope.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

from .findings import CODES, Finding

__all__ = ["LockOrderChecker", "install", "uninstall", "checker"]

_real_lock = threading.Lock
_real_rlock = threading.RLock


def _site(depth: int = 2) -> str:
    """Allocation/acquisition site: innermost frame outside this module
    and the threading module."""
    import sys

    f = sys._getframe(depth)
    hops = 0
    while f is not None and hops < 12:
        # exact-basename match: "test_lockdep.py" must NOT be skipped
        base = os.path.basename(f.f_code.co_filename)
        if base not in ("lockdep.py", "threading.py"):
            return f"{base}:{f.f_lineno}"
        f = f.f_back
        hops += 1
    return "<unknown>"


class _TrackedLock:
    """Wrapper delegating to a real lock while reporting acquisition
    order to the checker.  Supports the context-manager protocol and the
    ``acquire``/``release``/``locked`` surface ``threading`` locks
    expose; reentrant acquires of an RLock do not re-push."""

    __slots__ = ("_lk", "_chk", "site", "_reentrant", "_owner", "_depth",
                 "_held_in")

    def __init__(self, chk: "LockOrderChecker", reentrant: bool):
        self._lk = _real_rlock() if reentrant else _real_lock()
        self._chk = chk
        self.site = _site(3)
        self._reentrant = reentrant
        self._owner = None
        self._depth = 0
        self._held_in = None

    def _acq(self, blocking: bool, timeout: float) -> bool:
        # a non-blocking acquire must not pass a timeout (ValueError)
        if timeout == -1:
            return self._lk.acquire(blocking)
        return self._lk.acquire(blocking, timeout)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._reentrant and self._owner == me:
            got = self._acq(blocking, timeout)
            if got:
                self._depth += 1
            return got
        got = self._acq(blocking, timeout)
        if got:
            self._owner = me
            self._depth = 1
            self._chk._note_acquire(self)
        return got

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner == me:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                self._chk._note_release(self)
        elif not self._reentrant and self._owner is not None:
            # cross-thread release of a plain Lock (legal for
            # threading.Lock): drop the acquirer's stale held-stack entry
            # so its future orderings aren't polluted
            self._owner = None
            self._depth = 0
            held = self._held_in
            if held is not None and self in held:
                try:
                    held.remove(self)
                except ValueError:  # holder popped it concurrently
                    pass
        self._lk.release()

    def locked(self) -> bool:
        locked = getattr(self._lk, "locked", None)
        return locked() if locked is not None else self._depth > 0

    # -- threading.Condition protocol (a Condition() allocates an RLock
    # through the patched factory and calls these; without them its
    # acquire(0)-probe fallback misreads a reentrant wrapper as
    # un-owned and wait() raises) --------------------------------------
    def _is_owned(self) -> bool:
        inner = getattr(self._lk, "_is_owned", None)
        if inner is not None:
            return inner()
        return self._owner == threading.get_ident()

    def _release_save(self):
        if not self._reentrant:  # Condition over a plain Lock (Event)
            self.release()
            return None
        state = self._lk._release_save()
        if self._owner == threading.get_ident():
            self._owner = None
            self._depth = 0
            self._chk._note_release(self)
        return state

    def _acquire_restore(self, state) -> None:
        if not self._reentrant:
            self.acquire()
            return
        self._lk._acquire_restore(state)
        self._owner = threading.get_ident()
        self._depth = state[0] if isinstance(state, tuple) and state else 1
        self._chk._note_acquire(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class LockOrderChecker:
    """Observed lock-order graph + RT010 findings (lockdep-lite)."""

    def __init__(self):
        #: (site_a, site_b) -> acquisition stack summary proving a->b
        self.edges: Dict[Tuple[str, str], str] = {}
        self._held = threading.local()
        self._mu = _real_lock()
        self._findings: List[Finding] = []
        self._flagged: Set[Tuple[str, str]] = set()
        self.n_locks = 0
        self._installed = False

    # -- lock event intake ------------------------------------------------
    def _note_acquire(self, lk: _TrackedLock) -> None:
        held = getattr(self._held, "stack", None)
        if held is None:
            held = self._held.stack = []
        for prev in held:
            if prev.site == lk.site:
                continue  # same class (e.g. sharded locks): no ordering
            edge = (prev.site, lk.site)
            rev = (lk.site, prev.site)
            proof = " -> ".join(h.site for h in held) + f" -> {lk.site}"
            with self._mu:
                if edge not in self.edges:
                    self.edges[edge] = proof
                if rev in self.edges and edge not in self._flagged:
                    self._flagged.add(edge)
                    self._flagged.add(rev)
                    self._findings.append(Finding(
                        "RT010",
                        CODES["RT010"][1] +
                        f"; order {prev.site} -> {lk.site} seen here "
                        f"[{proof}] but {lk.site} -> {prev.site} was "
                        f"observed earlier [{self.edges[rev]}]",
                        dep=f"{prev.site} <-> {lk.site}"))
        held.append(lk)
        lk._held_in = held

    def _note_release(self, lk: _TrackedLock) -> None:
        held = getattr(self._held, "stack", None)
        if held and lk in held:
            held.remove(lk)

    # -- lifecycle --------------------------------------------------------
    def install(self) -> "LockOrderChecker":
        if self._installed:
            return self
        self._installed = True

        def make_lock():
            self.n_locks += 1
            return _TrackedLock(self, reentrant=False)

        def make_rlock():
            self.n_locks += 1
            return _TrackedLock(self, reentrant=True)

        threading.Lock = make_lock
        threading.RLock = make_rlock
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        threading.Lock = _real_lock
        threading.RLock = _real_rlock

    def __enter__(self) -> "LockOrderChecker":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def findings(self) -> List[Finding]:
        with self._mu:
            return list(self._findings)


_checker: "LockOrderChecker | None" = None
_mu = _real_lock()


def install() -> LockOrderChecker:
    """Install (once) the process-wide checker (``PARSEC_TPU_LOCKDEP=1``
    path)."""
    global _checker
    with _mu:
        if _checker is None:
            _checker = LockOrderChecker().install()
        return _checker


def uninstall() -> None:
    global _checker
    with _mu:
        if _checker is not None:
            _checker.uninstall()
            _checker = None


def checker() -> "LockOrderChecker | None":
    return _checker
