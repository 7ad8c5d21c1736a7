"""Fourcounter — distributed termination detection for dynamic taskpools.

Reference: ``parsec/mca/termdet/fourcounter/`` — when a
taskpool's total task count is unknown (DTD, dynamic discovery), local
counters cannot decide quiescence because activations may still be in
flight. The classic four-counter algorithm aggregates, over a wave through
all ranks, the counts of (messages sent, messages received) plus per-rank
busy state; termination is declared when **two consecutive waves** observe
all ranks idle and identical, balanced totals (sent == received), proving
no message was in flight between the waves.

The wave here is coordinated by rank 0 over the CE's TERMDET AM tag
(reference reserves a dedicated tag, ``parsec_comm_engine.h:35``); replies
return each rank's ``(busy, sent, received)``.

**Piggybacking** (reference ``termdet.h:153-232``): every rank's
``(busy, sent, recv)`` state rides APPLICATION frames through the CE's
piggyback channel (:meth:`CommEngine.set_piggyback`), so in steady state
the protocol sends **zero dedicated messages** — rank 0 passively
accumulates the freshest per-rank states.  Dedicated waves fire only
from idle progress, and only when the piggybacked picture already looks
terminal (all ranks idle, totals balanced): a wave against a
visibly-busy system cannot succeed and is suppressed.  The confirming
wave itself remains dedicated traffic — the consistent cut that proves
no message was in flight cannot ride unordered app frames.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..core.termdet import TermDetMonitor
from ..utils import debug, register_component
from .engine import CommEngine, TAG_TERMDET


@register_component("termdet")
class TermDetFourCounter(TermDetMonitor):
    """Per-taskpool monitor; every rank's taskpool installs one, bound to
    the rank's comm engine via :meth:`bind`."""

    mca_name = "fourcounter"
    mca_priority = 5  # local wins by default; selected explicitly

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nb_tasks = 0
        self._runtime_actions = 0
        self._ready = False
        self._terminated = False
        self._on_termination: Optional[Callable] = None
        self._tp = None
        # the four counters
        self.msgs_sent = 0
        self.msgs_recv = 0
        # wave state (rank 0 only)
        self._wave_id = 0
        self._wave_replies: Dict[int, Tuple[bool, int, int]] = {}
        self._last_totals: Optional[Tuple[int, int]] = None
        self.ce: Optional[CommEngine] = None
        #: freshest piggybacked state per peer rank: (seq, busy, sent, recv)
        self._peer_states: Dict[int, Tuple[int, bool, int, int]] = {}
        self._pb_seq = 0
        #: dedicated TERMDET messages this rank sent (probe/reply/terminate)
        #: — the piggyback "Done" pin: zero while application traffic flows
        self.dedicated_sent = 0
        #: waves suppressed because the piggybacked picture showed a busy
        #: rank or unbalanced totals (the wave could not have succeeded)
        self.waves_suppressed = 0
        #: liveness valve: piggyback updates seen, and the count at the
        #: last suppression — a stale busy picture (no new states between
        #: consecutive attempts) stops suppressing after 2 tries, because
        #: an idle rank sends nothing and its last state never refreshes
        self._pb_updates = 0
        self._suppress_streak = 0
        self._updates_at_suppress = -1

    # -- monitor interface ------------------------------------------------
    def monitor_taskpool(self, tp, on_termination):
        self._tp = tp
        self._on_termination = on_termination

    def bind(self, ce: CommEngine) -> "TermDetFourCounter":
        self.ce = ce
        ce.register_am(TAG_TERMDET, self._on_am)
        ce.set_piggyback(self._pb_state, self._pb_recv)
        return self

    # -- piggyback channel ------------------------------------------------
    def _pb_state(self):
        """Stamped on every outgoing application frame (tiny, monotonic
        seq disambiguates reordered frames).  Must account the SAME
        quantities as :meth:`_local_state` (monitor-local counters plus
        the CE's app-message counters) or rank 0 would compare
        piggybacked peer states against incommensurable wave totals and
        the balanced-picture check could never pass."""
        with self._lock:
            if self._terminated:
                return None
            self._pb_seq += 1
            busy = (not self._ready) or self._nb_tasks != 0 \
                or self._runtime_actions != 0
            s, r = self.msgs_sent, self.msgs_recv
        if self.ce is not None:
            # plain-int reads; same sourcing as _local_state
            s += self.ce.termdet_sent
            r += self.ce.termdet_recv
        return (self._pb_seq, busy, s, r)

    def _pb_recv(self, src: int, state) -> None:
        if not isinstance(state, tuple) or len(state) != 4:
            return
        with self._lock:
            cur = self._peer_states.get(src)
            if cur is None or state[0] > cur[0]:
                self._peer_states[src] = state
                self._pb_updates += 1

    def taskpool_ready(self, tp):
        with self._lock:
            self._ready = True

    def taskpool_set_nb_tasks(self, tp, n):
        if getattr(tp, "auto_count", False):
            tp.auto_count = False
        with self._lock:
            self._nb_tasks = n

    def taskpool_addto_nb_tasks(self, tp, delta):
        with self._lock:
            self._nb_tasks += delta
            return self._nb_tasks

    def taskpool_addto_runtime_actions(self, tp, delta):
        with self._lock:
            self._runtime_actions += delta
            return self._runtime_actions

    def is_terminated(self, tp) -> bool:
        with self._lock:
            return self._terminated

    # -- message accounting (piggyback stand-in) -------------------------
    def note_message_sent(self) -> None:
        with self._lock:
            self.msgs_sent += 1

    def note_message_recv(self) -> None:
        with self._lock:
            self.msgs_recv += 1

    def _local_state(self) -> Tuple[bool, int, int]:
        with self._lock:
            busy = (not self._ready) or self._nb_tasks != 0 or self._runtime_actions != 0
            s, r = self.msgs_sent, self.msgs_recv
        # production: the CE counts every app message from CONSTRUCTION
        # (messages delivered before this monitor bound are included);
        # the monitor-local counters serve protocol-level tests driving
        # note_message_* by hand
        if self.ce is not None:
            s += self.ce.termdet_sent
            r += self.ce.termdet_recv
        return busy, s, r

    #: production wave pacing: idle_progress initiates at most one wave
    #: per interval (seconds) — waves are the idle-time FALLBACK; the
    #: piggyback channel carries steady-state detection for free
    wave_interval = 0.02

    def idle_progress(self) -> None:
        """Production wave driver, called from worker idle loops
        (Context._progress_comm).  Rank 0 only; rate-limited; every
        suppression heuristic of initiate_wave applies."""
        if self.ce is None or self.ce.rank != 0:
            return
        import time

        now = time.monotonic()
        with self._lock:
            if self._terminated:
                return
            if now - getattr(self, "_last_wave_at", 0.0) < self.wave_interval:
                return
            self._last_wave_at = now
        self.initiate_wave()

    def _picture_looks_terminal(self) -> bool:
        """Passive check against the piggybacked states: a wave can only
        succeed if every known peer reported idle and the global totals
        balance.  Missing peers (no app traffic seen yet from them) do
        NOT block the wave — liveness must not depend on traffic."""
        busy, s, r = self._local_state()
        if busy:
            return False
        tot_s, tot_r = s, r
        with self._lock:
            for rank in range(1, self.ce.nranks):
                st = self._peer_states.get(rank)
                if st is None:
                    continue  # unknown: let the wave find out
                if st[1]:
                    return False  # that rank said it was busy
                tot_s += st[2]
                tot_r += st[3]
            if len(self._peer_states) == self.ce.nranks - 1 \
                    and tot_s != tot_r:
                return False  # complete picture, unbalanced: in flight
        return True

    # -- wave protocol ----------------------------------------------------
    def initiate_wave(self, force: bool = False) -> None:
        """Rank 0 starts a collection wave (driven from idle progress).
        Suppressed while the piggybacked picture shows the system busy —
        a dedicated 2(R-1)-message round against a visibly-running
        computation cannot conclude anything (``force`` overrides, for
        callers that must probe regardless)."""
        assert self.ce is not None and self.ce.rank == 0
        if not force:
            if self._local_state()[0]:
                # rank 0 itself is busy: ITS busy flag rides the wave, so
                # the wave provably cannot conclude — no liveness concern
                # (rank 0 going idle re-triggers the idle driver)
                with self._lock:
                    self.waves_suppressed += 1
                return
            if not self._picture_looks_terminal():
                # peers look busy, but their piggybacked state may be
                # stale (an idle rank sends nothing): suppress only while
                # fresh updates keep arriving, probe after 2 quiet tries
                with self._lock:
                    fresh = self._pb_updates != self._updates_at_suppress
                    self._updates_at_suppress = self._pb_updates
                    self._suppress_streak = 1 if fresh \
                        else self._suppress_streak + 1
                    if self._suppress_streak <= 2:
                        self.waves_suppressed += 1
                        return
        with self._lock:
            self._suppress_streak = 0
            if self._terminated:
                return
            self._wave_id += 1
            wid = self._wave_id
            self._wave_replies = {}
            self.dedicated_sent += self.ce.nranks - 1
        busy, s, r = self._local_state()
        self._wave_replies[0] = (busy, s, r)
        for dst in range(1, self.ce.nranks):
            self.ce.send_am(TAG_TERMDET, dst, {"type": "probe", "wave": wid})
        self._maybe_conclude(wid)

    def _on_am(self, src: int, msg: dict) -> None:
        t = msg.get("type")
        if t == "probe":
            busy, s, r = self._local_state()
            with self._lock:
                self.dedicated_sent += 1
            self.ce.send_am(TAG_TERMDET, src, {
                "type": "reply", "wave": msg["wave"],
                "busy": busy, "sent": s, "recv": r, "rank": self.ce.rank})
        elif t == "reply":
            with self._lock:
                if msg["wave"] != self._wave_id:
                    return  # stale wave
                self._wave_replies[msg["rank"]] = (msg["busy"], msg["sent"], msg["recv"])
            self._maybe_conclude(msg["wave"])
        elif t == "terminate":
            self._declare()

    def _maybe_conclude(self, wid: int) -> None:
        with self._lock:
            if wid != self._wave_id or len(self._wave_replies) < self.ce.nranks:
                return
            replies = list(self._wave_replies.values())
            any_busy = any(b for b, _, _ in replies)
            tot_sent = sum(s for _, s, _ in replies)
            tot_recv = sum(r for _, _, r in replies)
            balanced = (not any_busy) and tot_sent == tot_recv
            confirmed = balanced and self._last_totals == (tot_sent, tot_recv)
            self._last_totals = (tot_sent, tot_recv) if balanced else None
        if confirmed:
            with self._lock:
                self.dedicated_sent += self.ce.nranks - 1
            for dst in range(1, self.ce.nranks):
                self.ce.send_am(TAG_TERMDET, dst, {"type": "terminate"})
            self._declare()

    def _declare(self) -> None:
        fire = False
        with self._lock:
            if not self._terminated:
                self._terminated = True
                fire = True
        if fire and self.ce is not None \
                and getattr(self.ce, "_termdet_bound", None) is self:
            # free the CE's single distributed-monitor slot for the next
            # pool (the AM handler stays ours until a new bind replaces
            # it; stale wave traffic no-ops against _terminated)
            self.ce._termdet_bound = None
        if fire and self._on_termination is not None and self._tp is not None:
            self._on_termination(self._tp)
