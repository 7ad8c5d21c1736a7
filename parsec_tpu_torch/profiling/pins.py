"""PINS — Performance INStrumentation callback sites.

Reference: ``parsec/mca/pins/pins.h:26-55`` defines 13 begin/end callback
flags fired from the scheduling core; modules subscribe per-site.  Here
``fire`` is a near-no-op unless at least one subscriber is registered for
the site (the reference gates with an enable mask, ``pins.h:161-171``).

The port declares every site of :mod:`parsec_tpu.profiling.pins`, so a
subscriber (the binary tracer's :class:`~.binary.RankTraceSet`) wires
itself as the reference's does.  The comm layer
(:mod:`parsec_tpu_torch.comm`) fires the comm-protocol, transport and
frame sites, and its collectives (:mod:`parsec_tpu_torch.comm.coll`)
the collective sites.  ``ACTIVATE_CB_*`` and ``DATA_FLUSH_*`` have no
firing site, in the reference either.
The serving plane (:mod:`parsec_tpu_torch.serve`) fires the job sites.

The port adds the spans of a job (:data:`SPANS`, fired through
:func:`span`): the front end, the executor, the pump and the device
module each open one at their boundaries, so that a subscriber — the
``torch.profiler`` sink :class:`~.torch_spans.ProfilerSpans` — sees where
a job's host time goes.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Callable, Dict, Optional, Tuple

# callback sites (reference PARSEC_PINS_FLAG enum)
SELECT_BEGIN = "select_begin"
SELECT_END = "select_end"
PREPARE_INPUT_BEGIN = "prepare_input_begin"
PREPARE_INPUT_END = "prepare_input_end"
RELEASE_DEPS_BEGIN = "release_deps_begin"
RELEASE_DEPS_END = "release_deps_end"
# EXEC fires with the task around its body; for a task on the CUDA module
# the module fires it around the task's submit (on the dynamic path, the
# pump and the legacy protocol alike; the core's hook only hands the task
# over), for every member of a wave, with ``task.prof["wave"]`` the chunk
# size (0 for a per-task submit) and ``task.prof["job"]`` the device
# module's job
EXEC_BEGIN = "exec_begin"
EXEC_END = "exec_end"
COMPLETE_EXEC_BEGIN = "complete_exec_begin"
COMPLETE_EXEC_END = "complete_exec_end"
SCHEDULE_BEGIN = "schedule_begin"
SCHEDULE_END = "schedule_end"
# remote-activation callback and data flush: named for subscribers; no
# site fires them, in the reference either
ACTIVATE_CB_BEGIN = "activate_cb_begin"
ACTIVATE_CB_END = "activate_cb_end"
DATA_FLUSH_BEGIN = "data_flush_begin"
DATA_FLUSH_END = "data_flush_end"
# comm-thread sites: protocol instants ({"rank", "dst"|"peer", "bytes",
# "trace", "proto"}) and one begin/end span per frame crossing the
# transport ({"rank", "peer", "bytes", "tag", "qdepth"}): comm/remote_dep
# fires the instants, comm/inproc the spans
COMM_ACTIVATE = "comm_activate"
COMM_DATA_CTL = "comm_data_ctl"
COMM_DATA_PLD = "comm_data_pld"
COMM_SEND_BEGIN = "comm_send_begin"
COMM_SEND_END = "comm_send_end"
COMM_RECV_BEGIN = "comm_recv_begin"
COMM_RECV_END = "comm_recv_end"
# collective spans, one begin/end per op ({"rank","id","kind","bytes",
# "nranks"}) and one COLL_SEG instant per landed segment: comm/coll fires
# them
COLL_BEGIN = "coll_begin"
COLL_END = "coll_end"
COLL_SEG = "coll_seg"
# serving-plane job lifecycle ({"rank","trace","tenant","job_id"}): the
# serving plane (parsec_tpu_torch.serve) fires them
JOB_SUBMIT = "job_submit"
JOB_ADMIT = "job_admit"
JOB_DONE = "job_done"
# program-cache compile spans: one begin/end pair around a CUDA-graph
# capture that missed the program cache (dsl/cuda_graph.py's
# GraphExecutor), payload {"rank","fp","key","trace","job"} (+ "kind"
# and "seconds" on END; ``job`` the job of the span open on the thread).
# A cache hit fires nothing.  Binary traces record them as ``compile``
# spans, critpath's ``compile`` bucket
COMPILE_BEGIN = "compile_begin"
COMPILE_END = "compile_end"
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
# "bytes"} (+ "seconds" on END), and a job's span keys (below).
STAGE_IN_BEGIN = "stage_in_begin"
STAGE_IN_END = "stage_in_end"
WRITEBACK_BEGIN = "writeback_begin"
WRITEBACK_END = "writeback_end"
# a job's spans, one begin/end pair at each layer boundary, fired by
# :func:`span` on one thread.  Payload {"rank","id","job","parent"}, plus
# "bytes" and "tiles" where the span moves data: ``job`` is the job's id
# (:func:`new_job`: the taskpool's, or its executor's), ``parent`` the id
# of the span open on the same thread when this one began (0: none)
TASKPOOL_BEGIN = "taskpool_begin"          # the front end builds the pool
TASKPOOL_END = "taskpool_end"
MATERIALIZE_BEGIN = "materialize_begin"    # a lazily made host tile
MATERIALIZE_END = "materialize_end"
CAPTURE_BEGIN = "capture_begin"            # the executor's TaskGraph capture
CAPTURE_END = "capture_end"
NATIVE_BUILD_BEGIN = "native_build_begin"  # the native graph's build
NATIVE_BUILD_END = "native_build_end"
PUMP_BEGIN = "pump_begin"                  # a pump run, and per batch in it:
PUMP_END = "pump_end"
POP_BEGIN = "pop_begin"                    # filling the window (pop_batch)
POP_END = "pop_end"
LANE_WAIT_BEGIN = "lane_wait_begin"        # the wait on the transfer lane
LANE_WAIT_END = "lane_wait_end"
SUBMIT_BEGIN = "submit_begin"              # the device module's dispatch
SUBMIT_END = "submit_end"
RETIRE_BEGIN = "retire_begin"              # write-backs, done_batch, callbacks
RETIRE_END = "retire_end"
STAGE_COPY_BEGIN = "stage_copy_begin"      # host copies into staging buffers
STAGE_COPY_END = "stage_copy_end"
CARD_WAIT_BEGIN = "card_wait_begin"        # the host blocked on the card
CARD_WAIT_END = "card_wait_end"
WB_COPY_BEGIN = "wb_copy_begin"            # the write-back's host copies
WB_COPY_END = "wb_copy_end"
CLOSE_BEGIN = "close_begin"                # the executor's close
CLOSE_END = "close_end"
ASSEMBLE_BEGIN = "assemble_begin"          # an output assembled on the host
ASSEMBLE_END = "assemble_end"
KV_UP_BEGIN = "kv_up_begin"                # a latent attention's K/V expansion
KV_UP_END = "kv_up_end"
# happens-before edges of the staging pipeline: HB_STAGE_IN fires on the
# transfer thread after a task's inputs are prestaged ({"task": task});
# HB_WB_ENQUEUE on the thread that committed the epilog ({"ticket",
# "data"}) and HB_WB_COMMIT on the committer thread when that deferred
# write-back lands ({"tickets": [...]}).
HB_STAGE_IN = "hb_stage_in"
HB_WB_ENQUEUE = "hb_wb_enqueue"
HB_WB_COMMIT = "hb_wb_commit"
# arena slots (data/arena.py): a buffer handed out and one recycled, the
# latter fired under the freelist lock
ARENA_ALLOC = "arena_alloc"              # {"arena","slot"}
ARENA_RECYCLE = "arena_recycle"          # {"arena","slot"}
# comm frames (cross-rank happens-before edges): a frame handed to the
# transport and the same frame delivered on its peer.  The hb recorder
# subscribes to both; comm/inproc fires them
HB_FRAME_SEND = "hb_frame_send"          # {"frame","peer"}
HB_FRAME_DELIVER = "hb_frame_deliver"    # {"frame","peer"}
# one ASYNC completion entered the native engine (NativeGraph.task_done,
# the legacy protocol); accepted=False records a signal the engine's
# double-completion guard refused
NATIVE_TASK_DONE = "native_task_done"    # {"graph","task","accepted"}

ALL_SITES = [v for k, v in list(globals().items()) if k.isupper() and isinstance(v, str)]

#: a job's spans by name: (BEGIN, END) of each boundary above, and the
#: staging and compile spans that open inside them
SPANS: Dict[str, Tuple[str, str]] = {
    "taskpool": (TASKPOOL_BEGIN, TASKPOOL_END),
    "materialize": (MATERIALIZE_BEGIN, MATERIALIZE_END),
    "capture": (CAPTURE_BEGIN, CAPTURE_END),
    "native_build": (NATIVE_BUILD_BEGIN, NATIVE_BUILD_END),
    "pump": (PUMP_BEGIN, PUMP_END),
    "pop": (POP_BEGIN, POP_END),
    "lane_wait": (LANE_WAIT_BEGIN, LANE_WAIT_END),
    "submit": (SUBMIT_BEGIN, SUBMIT_END),
    "retire": (RETIRE_BEGIN, RETIRE_END),
    "stage_copy": (STAGE_COPY_BEGIN, STAGE_COPY_END),
    "card_wait": (CARD_WAIT_BEGIN, CARD_WAIT_END),
    "wb_copy": (WB_COPY_BEGIN, WB_COPY_END),
    "close": (CLOSE_BEGIN, CLOSE_END),
    "assemble": (ASSEMBLE_BEGIN, ASSEMBLE_END),
    "kv_up": (KV_UP_BEGIN, KV_UP_END),
    "stage_in": (STAGE_IN_BEGIN, STAGE_IN_END),
    "writeback": (WRITEBACK_BEGIN, WRITEBACK_END),
    "compile": (COMPILE_BEGIN, COMPILE_END),
}

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


# -- a job's spans ------------------------------------------------------------

_span_ids = itertools.count(1)
_job_ids = itertools.count(1)
#: ``stack``: the payloads of the spans open on this thread, innermost last
_open = threading.local()
_NO_SPAN = contextlib.nullcontext()


def new_job() -> int:
    """A fresh, process-wide job id."""
    return next(_job_ids)


def current_job() -> int:
    """The job of the innermost span open on this thread (0: none)."""
    stack = getattr(_open, "stack", None)
    return stack[-1]["job"] if stack else 0


class _Span:
    __slots__ = ("end", "info", "stack")

    def __init__(self, end: str, info: Dict[str, Any], stack: list):
        self.end, self.info, self.stack = end, info, stack

    def __enter__(self) -> Dict[str, Any]:
        return self.info

    def __exit__(self, *exc) -> bool:
        self.stack.pop()
        fire(self.end, None, dict(self.info))
        return False


def span(name: str, job: Optional[int] = None, rank: Optional[int] = None,
         **fields: Any):
    """``with span(name, ...) as info:`` fires the BEGIN and END sites of
    the span ``name`` (:data:`SPANS`) around the block, on this thread,
    when either has a subscriber.  ``info`` is the payload —
    ``{"rank","id","job","parent"}`` and ``fields`` — or None when nobody
    subscribes; the block may add to it (the bytes it moved) before END
    fires with a copy.  ``job`` and ``rank`` default to the enclosing
    span's (0 outside any)."""
    begin, end = SPANS[name]
    if not (active(begin) or active(end)):
        return _NO_SPAN
    stack = _open.__dict__.setdefault("stack", [])
    up = stack[-1] if stack else None
    info = {"rank": rank if rank is not None else (up["rank"] if up else 0),
            "id": next(_span_ids),
            "job": job if job is not None else (up["job"] if up else 0),
            "parent": up["id"] if up else 0}
    info.update(fields)
    stack.append(info)
    fire(begin, None, dict(info))
    return _Span(end, info, stack)
