"""Termination detection (MCA framework ``termdet``).

Reference: ``parsec/mca/termdet/`` — a monitor embedded in
every taskpool (``tp->tdm``, ``parsec_internal.h:147``) that decides when the
taskpool has quiesced.  Two counters drive it (``termdet.h:153-232``):

* ``nb_tasks``        — known/discovered tasks not yet retired,
* ``runtime_actions`` — in-flight runtime work (messages, device tasks,
                        pending activations) that must drain.

The ``local`` module (default; reference
``termdet/local/termdet_local_module.c``) declares termination when both hit
zero after the taskpool is marked ready.  ``user_trigger`` (reference
``termdet/user_trigger``) holds termination until the application calls
``tp.tdm.trigger(tp)``; at one rank it is ``local`` plus that gate.  The
distributed ``fourcounter`` wave algorithm, and ``user_trigger``'s signal
across ranks, come with the distributed layer (ROADMAP A.8).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, TYPE_CHECKING

from ..utils import Component, register_component

if TYPE_CHECKING:  # pragma: no cover
    from .taskpool import Taskpool


class TermDetMonitor(Component):
    """Interface of a per-taskpool termination monitor."""

    mca_type = "termdet"

    def monitor_taskpool(self, tp: "Taskpool", on_termination: Callable[["Taskpool"], None]) -> None:
        raise NotImplementedError

    def taskpool_ready(self, tp: "Taskpool") -> None:
        raise NotImplementedError

    def taskpool_set_nb_tasks(self, tp: "Taskpool", n: int) -> None:
        raise NotImplementedError

    def taskpool_addto_nb_tasks(self, tp: "Taskpool", delta: int) -> int:
        raise NotImplementedError

    def taskpool_addto_runtime_actions(self, tp: "Taskpool", delta: int) -> int:
        raise NotImplementedError

    def is_terminated(self, tp: "Taskpool") -> bool:
        raise NotImplementedError

    # distributed monitors piggyback state on outgoing messages
    def outgoing_message_pack(self, tp: "Taskpool", dst_rank: int) -> bytes:
        return b""

    def incoming_message_unpack(self, tp: "Taskpool", src_rank: int, data: bytes) -> None:
        pass


@register_component("termdet")
class TermDetLocal(TermDetMonitor):
    """Counter-based local termination (reference ``termdet/local``)."""

    mca_name = "local"
    mca_priority = 10

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nb_tasks = 0
        self._runtime_actions = 0
        self._ready = False
        self._terminated = False
        self._on_termination: Optional[Callable] = None
        self._tp: Optional["Taskpool"] = None

    def monitor_taskpool(self, tp, on_termination):
        self._tp = tp
        self._on_termination = on_termination

    def taskpool_ready(self, tp):
        fire = False
        with self._lock:
            self._ready = True
            fire = self._check_locked()
        if fire:
            self._fire()

    def taskpool_set_nb_tasks(self, tp, n):
        # an explicit task count means the caller manages accounting
        if getattr(tp, "auto_count", False):
            tp.auto_count = False
        fire = False
        with self._lock:
            self._nb_tasks = n
            fire = self._check_locked()
        if fire:
            self._fire()

    def taskpool_addto_nb_tasks(self, tp, delta):
        fire = False
        with self._lock:
            self._nb_tasks += delta
            v = self._nb_tasks
            fire = self._check_locked()
        if fire:
            self._fire()
        return v

    def taskpool_addto_runtime_actions(self, tp, delta):
        fire = False
        with self._lock:
            self._runtime_actions += delta
            v = self._runtime_actions
            fire = self._check_locked()
        if fire:
            self._fire()
        return v

    def _check_locked(self) -> bool:
        if self._ready and not self._terminated and self._nb_tasks == 0 and self._runtime_actions == 0:
            self._terminated = True
            return True
        return False

    def _fire(self) -> None:
        if self._on_termination and self._tp is not None:
            self._on_termination(self._tp)

    def is_terminated(self, tp) -> bool:
        with self._lock:
            return self._terminated

    # reset support for reusable taskpools (reference: tdm re-monitor)
    def reset(self) -> None:
        with self._lock:
            self._ready = False
            self._terminated = False
            self._nb_tasks = 0
            self._runtime_actions = 0


@register_component("termdet")
class TermDetUserTrigger(TermDetLocal):
    """App-driven termination (reference ``termdet/user_trigger``): the
    taskpool quiesces only once the application has called
    :meth:`trigger` — the counters are still tracked, so runtime actions
    drain, but reaching zero alone does not terminate.  Select with
    ``Taskpool(termdet="user_trigger")``; the taskpool exposes it as
    ``tp.tdm.trigger(tp)``."""

    mca_name = "user_trigger"
    mca_priority = 0  # never auto-selected

    def __init__(self) -> None:
        super().__init__()
        self._triggered = False

    def trigger(self, tp) -> None:
        """The user's termination signal.  At one rank it gates this
        monitor; carrying it to other ranks needs the comm engine."""
        ctx = getattr(tp, "context", None)
        if ctx is not None and getattr(ctx, "nranks", 1) > 1:
            raise NotImplementedError(
                "user_trigger termination across ranks needs the "
                "distributed layer, which is not ported yet (ROADMAP A.8)")
        fire = False
        with self._lock:
            self._triggered = True
            fire = self._check_locked()
        if fire:
            self._fire()

    def _check_locked(self) -> bool:
        # the trigger means "no more work will be discovered": terminate
        # once the known tasks and runtime actions have drained
        if (self._ready and self._triggered and not self._terminated
                and self._nb_tasks == 0 and self._runtime_actions == 0):
            self._terminated = True
            return True
        return False

    def reset(self) -> None:
        super().reset()
        self._triggered = False
