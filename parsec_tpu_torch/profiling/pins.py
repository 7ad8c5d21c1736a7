"""PINS — Performance INStrumentation callback sites.

Reference: ``parsec/mca/pins/pins.h:26-55`` defines 13 begin/end callback
flags fired from the scheduling core; modules subscribe per-site.  Here
``fire`` is a near-no-op unless at least one subscriber is registered for
the site (the reference gates with an enable mask, ``pins.h:161-171``).

The port carries the sites its runtime core and staging pipeline fire;
the comm, collective, serving and compile sites of
:mod:`parsec_tpu.profiling.pins` arrive with the layers that fire them.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

# callback sites (reference PARSEC_PINS_FLAG enum)
SELECT_BEGIN = "select_begin"
SELECT_END = "select_end"
PREPARE_INPUT_BEGIN = "prepare_input_begin"
PREPARE_INPUT_END = "prepare_input_end"
RELEASE_DEPS_BEGIN = "release_deps_begin"
RELEASE_DEPS_END = "release_deps_end"
EXEC_BEGIN = "exec_begin"
EXEC_END = "exec_end"
COMPLETE_EXEC_BEGIN = "complete_exec_begin"
COMPLETE_EXEC_END = "complete_exec_end"
SCHEDULE_BEGIN = "schedule_begin"
SCHEDULE_END = "schedule_end"
# happens-before sites: runtime transitions whose ORDERING decides
# concurrency correctness.  They fire with ``es=None`` and a dict payload;
# producers guard payload construction behind ``active()`` so the hot
# paths stay near-free when nothing subscribes.
DEP_DECREMENT = "dep_decrement"          # one dependency release observed
                                         # {"tracker","key","ready","mode"}
DATA_VERSION_BUMP = "data_version_bump"  # write retired: new tile version
                                         # {"data","key","version","device"}
# device-manager epilog entry, fired with the TASK as payload BEFORE its
# outputs commit (version bumps)
DEVICE_EPILOG_BEGIN = "device_epilog_begin"
# staging-pipeline spans (device/staging.py): one begin/end pair per
# host->device prefetch batch (STAGE_IN, fired on the transfer lane) and
# per device->host commit batch (WRITEBACK, fired on the committer thread
# or around a batched detach flush).  Payload {"rank","id","tiles",
# "bytes"} (+ "seconds" on END).
STAGE_IN_BEGIN = "stage_in_begin"
STAGE_IN_END = "stage_in_end"
WRITEBACK_BEGIN = "writeback_begin"
WRITEBACK_END = "writeback_end"
# happens-before edges of the staging pipeline: HB_STAGE_IN fires on the
# transfer thread after a task's inputs are prestaged ({"task": task});
# HB_WB_ENQUEUE on the thread that committed the epilog ({"ticket",
# "data"}) and HB_WB_COMMIT on the committer thread when that deferred
# write-back lands ({"tickets": [...]}).
HB_STAGE_IN = "hb_stage_in"
HB_WB_ENQUEUE = "hb_wb_enqueue"
HB_WB_COMMIT = "hb_wb_commit"

ALL_SITES = [v for k, v in list(globals().items()) if k.isupper() and isinstance(v, str)]

#: site -> TUPLE of callbacks.  The value is immutable and replaced
#: wholesale on every (un)subscribe — copy-on-write, so a concurrent
#: ``fire`` iterating a snapshot can never observe a list mutating under it.
_subscribers: Dict[str, Tuple[Callable[..., None], ...]] = {}
_enabled = False
_sub_lock = threading.Lock()


def subscribe(site: str, cb: Callable[..., None]) -> None:
    global _enabled
    with _sub_lock:
        _subscribers[site] = _subscribers.get(site, ()) + (cb,)
        _enabled = True


def unsubscribe(site: str, cb: Callable[..., None]) -> None:
    global _enabled
    with _sub_lock:
        cur = _subscribers.get(site, ())
        if cb in cur:
            lst = list(cur)
            lst.remove(cb)
            _subscribers[site] = tuple(lst)
        _enabled = any(_subscribers.values())


def active(site: str) -> bool:
    """True when ``site`` has subscribers — lets hot paths skip building
    event payloads entirely (reference PARSEC_PINS enable-mask gate)."""
    return _enabled and bool(_subscribers.get(site))


def fire(site: str, es: Any, payload: Any) -> None:
    if not _enabled:
        return
    for cb in _subscribers.get(site, ()):  # pragma: no branch
        try:
            cb(es, payload)
        except Exception as e:  # instrumentation must never kill the run
            from ..utils import debug

            debug.warning("pins callback for %s raised: %s", site, e)


def clear() -> None:
    global _enabled
    with _sub_lock:
        _subscribers.clear()
        _enabled = False
