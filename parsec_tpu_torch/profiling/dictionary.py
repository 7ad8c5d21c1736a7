"""Live runtime-properties dictionary.

Reference: ``parsec/dictionary.{c,h}`` + PAPI-SDE
(``papi_sde.c``) — internal counters (tasks enabled/retired, scheduler
queue lengths) registered in a shared dictionary that external monitors
poll (``tools/aggregator_visu``). Here: a process-local registry of
callables snapshotted on demand; an aggregator thread can poll
:func:`snapshot` and stream JSON.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict

_lock = threading.Lock()
_props: Dict[str, Callable[[], Any]] = {}
#: properties whose getter already raised once (logged on first failure
#: only — a poisoned getter sampled at 10 Hz must not flood the log)
_err_logged: set = set()


def register_property(name: str, getter: Callable[[], Any]) -> None:
    with _lock:
        _props[name] = getter
        _err_logged.discard(name)  # a re-registered getter logs anew


def unregister_property(name: str) -> None:
    with _lock:
        _props.pop(name, None)
        _err_logged.discard(name)


def snapshot(exclude_prefix: str = "") -> Dict[str, Any]:
    """Sample every registered property.  A raising getter must not kill
    the sampler (the Aggregator thread polls this forever): the failure
    is logged ONCE per property and the property keeps being published as
    an ``"<error: ...>"`` string — visible to monitors, fatal to nobody.

    ``exclude_prefix`` skips matching properties WITHOUT sampling them —
    for consumers that read a subset elsewhere (the Prometheus exporter
    reads the SDE registry directly and must not pay its gauges twice)."""
    with _lock:
        items = list(_props.items())
    out = {}
    for name, getter in items:
        if exclude_prefix and name.startswith(exclude_prefix):
            continue
        try:
            out[name] = getter()
        except Exception as e:
            with _lock:
                first = name not in _err_logged
                _err_logged.add(name)
            if first:
                from ..utils import debug

                debug.warning("dictionary property %r getter raised: "
                              "%s: %s (published as an error string; "
                              "logged once)", name, type(e).__name__, e)
            out[name] = f"<error: {type(e).__name__}: {e}>"
    return out


def register_context(context, prefix: str = "runtime") -> None:
    """Expose the standard counters for a context (reference PAPI-SDE set:
    SCHEDULER::PENDING_TASKS, per-device counts…)."""
    register_property(f"{prefix}.pending_tasks", context.scheduler.pending_estimate)
    register_property(
        f"{prefix}.executed_per_worker",
        lambda: [es.stats["executed"] for es in context.streams])
    for dev in context.devices:
        register_property(f"{prefix}.device.{dev.name}", lambda d=dev: dict(d.stats))


class Aggregator:
    """Polling monitor (reference aggregator_visu, minus the GUI): samples
    the dictionary at an interval into a list / JSONL file."""

    def __init__(self, interval: float = 0.1, path: str = ""):
        self.interval = interval
        self.path = path
        self.samples = []
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "Aggregator":
        def loop():
            f = open(self.path, "w") if self.path else None
            try:
                while not self._stop.is_set():
                    s = {"t": time.time(), **snapshot()}
                    self.samples.append(s)
                    if f:
                        f.write(json.dumps(s) + "\n")
                    self._stop.wait(self.interval)
            finally:
                if f:
                    f.close()

        self._thread = threading.Thread(target=loop, daemon=True, name="parsec-aggregator")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
