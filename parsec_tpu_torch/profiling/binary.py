"""Binary trace format (``.pbt``) over the native tracer.

The port of :mod:`parsec_tpu.profiling.binary`; reference role: the dbp
binary tracer of ``parsec/profiling.c`` — per-thread native buffers, a
dictionary of event classes, binary files read by offline tools
(``tools/profiling/dbpreader.c``).  Here:

* :class:`BinaryTrace` — dictionary + :class:`parsec_tpu_torch.native.NativeTracer`
  (40-byte records, steady-clock ns timestamps taken in C++, one native
  buffer per thread);
* :class:`BinaryTaskProfiler` — PINS module feeding task lifecycle
  events into a BinaryTrace (native analogue of ``TaskProfiler``);
* :class:`RankTraceSet` — the per-rank recorder the offline tools read
  (exec spans, dependency edges, staging and compile spans, hb kinds);
* :func:`read_pbt` / :func:`to_chrome_events` — offline readers (numpy
  bulk parse); ``profiling.tools`` auto-detects ``.pbt`` inputs.

A dump produces two files: ``<path>`` (binary records) and
``<path>.meta.json`` (keyword dictionary + stream names + clock epoch).
The format is the reference's, byte for byte: either package reads the
other's dumps.

On the card an ``exec`` span times the host's submit of the task (its
staging, launch and epilog enqueue), not the kernel's run on the device.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import pins

MAGIC = b"PBTRACE1"

_RECORD_DTYPE = np.dtype([
    ("stream", "<i4"), ("keyword", "<i4"), ("phase", "<i4"), ("res", "<i4"),
    ("ts_ns", "<i8"), ("event_id", "<i8"), ("info", "<i8"),
])

PHASES = {0: "B", 1: "E", 2: "i", 3: "C"}

#: ONE process-wide sequence behind every ``task.prof["pbt_token"]``
#: stamp.  Coexisting recorders (an always-on flight recorder per rank
#: plus a deliberate RankTraceSet, or a BinaryTaskProfiler) race to
#: first-touch a task; per-instance counters would hand two distinct
#: tasks the same token value and silently corrupt every offline
#: token-keyed analysis once their dumps are read together.
_PBT_TOKEN_SEQ = itertools.count(1)


def _sync_points_for(rank: int):
    """Clock re-sync samples for one rank (lazy import: merge <-> binary
    already import each other lazily in the other direction)."""
    from .merge import sync_points_for

    return sync_points_for(rank)


class BinaryTrace:
    """Keyword dictionary + native event sink."""

    def __init__(self, rank: int = 0):
        from .. import native

        self.rank = rank
        self._tracer = native.NativeTracer()
        #: absolute monotonic time of the tracer's t0 (its event
        #: timestamps are offsets from construction), on the same
        #: CLOCK_MONOTONIC the native steady_clock reads, so per-rank
        #: traces can be placed on one global timeline by
        #: ``profiling.merge``.  The native tracer reads it around the
        #: native t0 itself, so the engine's load (a first-use build
        #: included) never lands between the two clocks
        self.epoch_ns = self._tracer.epoch_ns
        #: this rank's clock offset to rank 0 (local - rank0, ns), from
        #: the pool-start handshake (``merge.clock_handshake``); 0 for
        #: same-process ranks sharing the monotonic clock
        self.clock_offset_ns = 0
        self._keywords: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- dictionary (reference add_dictionary_keyword) -------------------
    def keyword(self, name: str) -> int:
        with self._lock:
            kid = self._keywords.get(name)
            if kid is None:
                kid = self._keywords[name] = len(self._keywords)
            return kid

    # -- logging ---------------------------------------------------------
    def begin(self, kid: int, event_id: int = 0, info: int = 0) -> None:
        self._tracer.log(kid, 0, event_id, info)

    def end(self, kid: int, event_id: int = 0, info: int = 0) -> None:
        self._tracer.log(kid, 1, event_id, info)

    def instant(self, kid: int, event_id: int = 0, info: int = 0) -> None:
        self._tracer.log(kid, 2, event_id, info)

    def counter(self, kid: int, value: int) -> None:
        self._tracer.log(kid, 3, value, 0)

    @property
    def total_events(self) -> int:
        return self._tracer.total_events

    # -- dump ------------------------------------------------------------
    def dump(self, path: str) -> int:
        n = self._tracer.dump(path)
        with self._lock:
            names = [None] * len(self._keywords)
            for name, kid in self._keywords.items():
                names[kid] = name
        meta = {"rank": self.rank, "keywords": names,
                "streams": self._tracer.stream_names(),
                "epoch_ns": self.epoch_ns,
                "clock_offset_ns": self.clock_offset_ns}
        # periodic clock re-sync samples (merge.sync_points_for): a
        # long-lived mesh drifts past the pool-start handshake, and the
        # merge applies a piecewise-linear correction from these
        sync = _sync_points_for(self.rank)
        if sync:
            meta["clock_sync"] = sync
        extra = getattr(self, "sidecar_extra", None)
        if extra:
            meta.update(extra)
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        return n

    def close(self) -> None:
        self._tracer.close()


class BinaryTaskProfiler:
    """PINS module: task lifecycle into a BinaryTrace (native buffers).

    ``event_id`` carries a stable per-task token — a monotonically
    assigned sequence number, stamped on the task at its first event —
    so offline analysis can match begin/end pairs per task even after
    objects are garbage-collected (``id()`` would be reused)."""

    def __init__(self, trace: Optional[BinaryTrace] = None):
        self.trace = trace or BinaryTrace()
        k = self.trace.keyword
        self._k_exec = k("exec")
        self._k_prep = k("prepare_input")
        self._k_complete = k("complete_exec")
        self._subs = []

        def sub(site, cb):
            pins.subscribe(site, cb)
            self._subs.append((site, cb))

        def tok(task) -> int:
            prof = task.prof
            t = prof.get("pbt_token")
            if t is None:
                t = prof["pbt_token"] = next(_PBT_TOKEN_SEQ)
            return t

        t = self.trace
        sub(pins.EXEC_BEGIN, lambda es, task: t.begin(self._k_exec, tok(task)))
        sub(pins.EXEC_END, lambda es, task: t.end(self._k_exec, tok(task)))
        sub(pins.PREPARE_INPUT_BEGIN, lambda es, task: t.begin(self._k_prep, tok(task)))
        sub(pins.PREPARE_INPUT_END, lambda es, task: t.end(self._k_prep, tok(task)))
        sub(pins.COMPLETE_EXEC_BEGIN, lambda es, task: t.begin(self._k_complete, tok(task)))
        sub(pins.COMPLETE_EXEC_END, lambda es, task: t.end(self._k_complete, tok(task)))

    def uninstall(self) -> None:
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        self._subs.clear()


class RankTraceSet:
    """Per-rank binary trace streams over one process (the virtual-mesh
    harness shape: N ranks as N Contexts in-process).  One
    :class:`BinaryTrace` per rank; every PINS event routes to the firing
    rank's OWN trace — task lifecycle by the worker's context rank,
    comm-protocol and transport events by the ``rank`` field the comm
    layer stamps on payloads.  This is what makes per-rank overlap and
    the critical-path analyzer possible: rank r's comm events land next
    to rank r's compute spans, never unioned across the mesh.

    Beyond the task lifecycle the set records, per rank:

    * ``class:<name>`` instants mapping each task token to its task
      class (offline tools attribute time per class);
    * ``dep_edge`` instants (``event_id`` = producer token, ``info`` =
      released successor token) from the RELEASE_DEPS_END payload — the
      dependency edges ``profiling.critpath`` walks;
    * ``select`` spans (scheduler select latency, per worker stream) and
      a ``steals`` counter sampled on change — the scheduler-side PINS
      subscribers (reference ``mca/pins/print_steals`` made trace-borne);
    * ``ce_send`` / ``ce_recv`` transport spans (bytes in ``info``, peer
      in ``event_id``) and a ``qdepth`` counter from the comm engines;
    * ``comm_send`` / ``comm_recv`` protocol instants (activation sent /
      payload landed — the events the overlap metric counts).

    In a TCP (multi-process) launch each process is one rank: build the
    set with ``nranks=1`` and ``base_rank=<this rank>``; merge the
    per-process dumps offline.

    ``trace_factory(rank) -> trace`` swaps the per-rank sink: the default
    is the native :class:`BinaryTrace`; the flight recorder
    (:mod:`.flight`) passes a bounded ring here.

    The comm and collective callbacks are subscribed as the reference
    subscribes them; the comm layer fires the comm sites (a payload's
    ``jobwire_*`` instants carry its pool's trace id) and its collectives
    the collective ones (``coll`` spans, ``coll_seg`` instants).
    The serving plane fires the job sites.

    ``lean=True`` drops the highest-frequency/lowest-value subscribers —
    the select-latency/steals instrumentation (which fires on every
    scheduler select, idle polls included: the reference measured it
    as the top non-idle GIL cost) and the prepare_input spans — keeping everything the offline
    tools need (exec spans, dep edges, comm protocol + transport,
    hb kinds).  The always-on flight recorder runs lean."""

    #: distinguishes coexisting sets' per-task bookkeeping in task.prof
    #: (an always-on flight recorder plus a deliberate trace is a normal
    #: production combination)
    _SET_IDS = itertools.count(1)

    def __init__(self, nranks: int = 1, base_rank: int = 0,
                 trace_factory=None, lean: bool = False):
        if trace_factory is None:
            trace_factory = lambda rank: BinaryTrace(rank=rank)  # noqa: E731
        self.nranks = nranks
        self.base_rank = base_rank
        self.lean = lean
        self._class_key = f"pbt_class_{next(RankTraceSet._SET_IDS)}"
        self.traces = [trace_factory(base_rank + r)
                       for r in range(nranks)]
        self._k = [
            {name: t.keyword(name) for name in
             ("exec", "prepare_input", "complete_exec", "select",
              "dep_edge", "comm_send", "comm_recv", "comm_ctl",
              "comm_recv_eager", "comm_recv_rdv", "frame_coalesced",
              "ce_send", "ce_recv", "qdepth", "steals", "compile",
              "coll", "coll_seg",
              # job-level trace vocabulary (profiling.jobtrace):
              # event_id = the 63-bit job trace id (job_map: event_id =
              # task token, info = trace id)
              "jobwire_send", "jobwire_eager", "jobwire_rdv",
              "jobcoll", "jobcompile", "job_phase", "job_map",
              # happens-before event kinds (analysis.hb / tools hbcheck;
              # analysis.hb.TRACE_KINDS)
              "hb_dep_dec", "hb_ver_bump", "hb_arena_alloc",
              "hb_arena_recycle", "hb_frame_send", "hb_frame_deliver",
              "hb_task_done", "sched_publish",
              # staging-pipeline vocabulary: stage_in /
              # writeback spans (event_id = batch span id, info =
              # bytes) feed critpath's ``transfer`` bucket; the hb_*
              # instants carry the pipeline's ordering edges
              "stage_in", "writeback",
              "hb_stage_in", "hb_wb_enqueue", "hb_wb_commit")}
            for t in self.traces]
        self._steals_seen: Dict[int, int] = {}
        self._subs: List[Any] = []
        self._installed = False

    # -- routing ---------------------------------------------------------
    def _trace_of(self, rank: int) -> Optional[BinaryTrace]:
        i = rank - self.base_rank
        return self.traces[i] if 0 <= i < self.nranks else None

    @staticmethod
    def _es_rank(es, task=None) -> int:
        if es is not None:
            return es.context.rank
        ctx = getattr(getattr(task, "taskpool", None), "context", None)
        return getattr(ctx, "rank", 0)

    def _tok(self, task) -> int:
        prof = task.prof
        t = prof.get("pbt_token")
        if t is None:
            t = prof["pbt_token"] = next(_PBT_TOKEN_SEQ)
        # the class:<name> instant (critpath's token -> class mapping) is
        # per SET, not per token: the token itself is shared across
        # coexisting sets (so their dumps agree on identity), but each
        # set must carry the mapping in its OWN trace or the
        # second-installed set's dump loses every class attribution
        if self._class_key not in prof:
            prof[self._class_key] = True
            r = self._es_rank(None, task)
            tr = self._trace_of(r)
            if tr is not None:
                name = getattr(task.task_class, "name",
                               type(task).__name__)
                tr.instant(tr.keyword(f"class:{name}"), t)
                # serving plane: tag the token with its pool's tenant so
                # offline tools (critpath --per-tenant table) attribute
                # chain time to WHOSE job it was, not just which class
                pool = getattr(task, "taskpool", None)
                tenant = getattr(pool, "tenant", None)
                if tenant:
                    tr.instant(tr.keyword(f"tenant:{tenant}"), t)
                # fused supertask (dsl.fusion): record the member count
                # (info = N) so critpath can report the dispatches saved;
                # member CLASSES ride the fused[...]  class name above
                fused_n = int(getattr(task, "fused_n", 1) or 1)
                if fused_n > 1:
                    tr.instant(tr.keyword("fused_n"), t, fused_n)
                # job-level tracing: one ``job_map`` instant (event_id
                # = token, info = trace id) maps this token to its
                # pool's job, so every span of the task is
                # job-attributable offline (merge annotates
                # args.trace_id; critpath --job slices on it).  ONE
                # fixed keyword — a per-job dynamic name would grow the
                # always-on flight recorder's keyword table without
                # bound on a serving mesh
                tid = int(getattr(pool, "trace_id", 0) or 0)
                if tid:
                    tr.instant(tr.keyword("job_map"), t, tid)
        return t

    # -- lifecycle -------------------------------------------------------
    def install(self) -> "RankTraceSet":
        if self._installed:
            return self
        self._installed = True

        def sub(site, cb):
            pins.subscribe(site, cb)
            self._subs.append((site, cb))

        def task_cb(key, phase):
            def cb(es, task):
                r = self._es_rank(es, task)
                tr = self._trace_of(r)
                if tr is not None:
                    getattr(tr, phase)(self._k[r - self.base_rank][key],
                                       self._tok(task))
            return cb

        sub(pins.EXEC_BEGIN, task_cb("exec", "begin"))
        sub(pins.EXEC_END, task_cb("exec", "end"))
        if not self.lean:
            sub(pins.PREPARE_INPUT_BEGIN,
                task_cb("prepare_input", "begin"))
            sub(pins.PREPARE_INPUT_END, task_cb("prepare_input", "end"))
        sub(pins.COMPLETE_EXEC_BEGIN, task_cb("complete_exec", "begin"))
        sub(pins.COMPLETE_EXEC_END, task_cb("complete_exec", "end"))

        def on_release(es, payload):
            task, ready = payload
            r = self._es_rank(es, task)
            tr = self._trace_of(r)
            if tr is None:
                return
            kid = self._k[r - self.base_rank]["dep_edge"]
            src = self._tok(task)
            for succ in ready or ():
                tr.instant(kid, src, self._tok(succ))

        sub(pins.RELEASE_DEPS_END, on_release)

        def on_schedule(es, batch):
            # scheduler hand-off instants: hbcheck's ordering edge for
            # tasks released OUTSIDE release_deps (remote activations
            # decrement counters directly) — event_id = task token
            for t in batch or ():
                r = self._es_rank(es, t)
                tr = self._trace_of(r)
                if tr is not None:
                    tr.instant(self._k[r - self.base_rank]["sched_publish"],
                               self._tok(t))

        sub(pins.SCHEDULE_BEGIN, on_schedule)

        # scheduler-side subscribers: select latency + steal counts.
        # Empty selects (idle polls) are NOT logged: on a waiting mesh
        # they outnumber real selects hundreds-to-one, and every log is
        # a native call under the GIL — the reference measured the
        # idle-poll select spans as the single largest non-idle cost of
        # an 8-rank dpotrf.  A successful select logs ONE
        # ``select`` instant whose info carries the measured latency in
        # ns (the span's information content, at a fraction of the
        # events).
        sel_t0: Dict[int, int] = {}

        def on_select_begin(es, _):
            sel_t0[id(es)] = time.monotonic_ns()

        def on_select_end(es, task):
            r = self._es_rank(es)
            tr = self._trace_of(r)
            if tr is None:
                return
            ks = self._k[r - self.base_rank]
            if task is not None:
                t0 = sel_t0.get(id(es))
                lat = (time.monotonic_ns() - t0) if t0 else 0
                tr.instant(ks["select"], 1, lat)
            if es is not None:
                steals = es.stats.get("steals", 0)
                key = id(es)
                if steals != self._steals_seen.get(key):
                    self._steals_seen[key] = steals
                    tr.counter(ks["steals"], steals)

        if not self.lean:
            # EVERY scheduler select enters these (idle polls included):
            # too hot for an always-on recorder, earn-their-keep for a
            # deliberate trace
            sub(pins.SELECT_BEGIN, on_select_begin)
            sub(pins.SELECT_END, on_select_end)

        # comm-protocol instants (fired with es=None; rank rides the
        # payload) — the events the overlap fraction counts
        def comm_cb(key):
            def cb(es, info):
                info = info or {}
                tr = self._trace_of(info.get("rank", 0))
                if tr is not None:
                    ks = self._k[tr.rank - self.base_rank]
                    tr.instant(
                        ks[key],
                        info.get("dst", info.get("peer", 0)) or 0,
                        int(info.get("bytes", 0)))
                    # job-attributable activation send: the wire frame
                    # carries the pool's trace id (remote_dep), recorded
                    # as a jobwire_send instant (event_id = trace id)
                    trace = int(info.get("trace", 0) or 0)
                    if trace and key == "comm_send":
                        tr.instant(ks["jobwire_send"], trace,
                                   int(info.get("bytes", 0)))
            return cb

        def pld_cb(es, info):
            # payload landings split BY REGIME so critpath/tools can
            # attribute comm bytes per protocol path: comm_recv keeps
            # the unified stream (overlap metric), comm_recv_eager /
            # comm_recv_rdv add the tagged view.  For rdv chunks the
            # event_id packs (chunk_index << 16 | chunk_count) — peer
            # already rides the unified event.
            info = info or {}
            tr = self._trace_of(info.get("rank", 0))
            if tr is None:
                return
            ks = self._k[tr.rank - self.base_rank]
            nbytes = int(info.get("bytes", 0))
            tr.instant(ks["comm_recv"],
                       info.get("dst", info.get("peer", 0)) or 0, nbytes)
            trace = int(info.get("trace", 0) or 0)
            if info.get("proto") == "rdv":
                packed = ((int(info.get("chunk", 0)) << 16)
                          | (int(info.get("nchunks", 1)) & 0xFFFF))
                tr.instant(ks["comm_recv_rdv"], packed, nbytes)
                if trace:
                    tr.instant(ks["jobwire_rdv"], trace, nbytes)
            else:
                tr.instant(ks["comm_recv_eager"],
                           info.get("peer", 0) or 0, nbytes)
                if trace:
                    tr.instant(ks["jobwire_eager"], trace, nbytes)

        sub(pins.COMM_ACTIVATE, comm_cb("comm_send"))
        sub(pins.COMM_DATA_PLD, pld_cb)
        sub(pins.COMM_DATA_CTL, comm_cb("comm_ctl"))

        # transport spans from the comm engines (bytes/peer/queue depth)
        def wire_cb(key, phase):
            def cb(es, info):
                info = info or {}
                tr = self._trace_of(info.get("rank", 0))
                if tr is None:
                    return
                ks = self._k[tr.rank - self.base_rank]
                getattr(tr, phase)(ks[key], int(info.get("peer", 0)),
                                   int(info.get("bytes", 0)))
                if phase == "begin" and "qdepth" in info:
                    tr.counter(ks["qdepth"], int(info["qdepth"]))
                if phase == "begin" and int(info.get("coalesced", 0)) > 1:
                    # coalesced-frame size: how many AMs shared this
                    # frame (event_id = peer, info = message count)
                    tr.instant(ks["frame_coalesced"],
                               int(info.get("peer", 0)),
                               int(info["coalesced"]))
            return cb

        sub(pins.COMM_SEND_BEGIN, wire_cb("ce_send", "begin"))
        sub(pins.COMM_SEND_END, wire_cb("ce_send", "end"))
        sub(pins.COMM_RECV_BEGIN, wire_cb("ce_recv", "begin"))
        sub(pins.COMM_RECV_END, wire_cb("ce_recv", "end"))

        # executable-cache compile spans (rare, kept in lean mode too):
        # event_id = fingerprint hash so B/E pair up; END's info carries
        # the resolution kind (0 = full miss, 1 = disk/bcast hit) — the
        # critpath ``compile`` bucket reads the span, tools read the kind
        def compile_cb(phase):
            def cb(es, p):
                p = p or {}
                tr = self._trace_of(p.get("rank", self.base_rank))
                if tr is None:
                    return
                # stable across processes/ranks (hash() is seeded per
                # process): the fingerprint is a hex digest, so its
                # leading nibbles ARE a deterministic id
                fps = p.get("fp", "") or "0"
                try:
                    eid = int(fps[:15], 16)
                except ValueError:
                    eid = int.from_bytes(
                        hashlib.blake2b(fps.encode(),
                                        digest_size=8).digest(),
                        "big") & 0x7FFFFFFFFFFFFFFF
                info = 0
                if phase == "end" and str(p.get("kind", "")).startswith(
                        "hit"):
                    info = 1
                ks = self._k[tr.rank - self.base_rank]
                getattr(tr, phase)(ks["compile"], eid, info)
                # a compile stalling a JOB (trace context from the
                # worker thread, or a compile-bcast frame): one
                # jobcompile instant at span end (event_id = trace id,
                # info = the span's fingerprint id for pairing)
                trace = int(p.get("trace", 0) or 0)
                if trace and phase == "end":
                    tr.instant(ks["jobcompile"], trace, eid)
            return cb

        sub(pins.COMPILE_BEGIN, compile_cb("begin"))
        sub(pins.COMPILE_END, compile_cb("end"))

        # collective spans (comm/coll.py): one begin/end per CollOp,
        # event_id = the op's deterministic cid token (identical on
        # every participating rank, so merged traces pair them up);
        # info = payload bytes.  The critpath ``coll`` bucket reads the
        # span.  One ``coll_seg`` instant per landed segment (event_id =
        # token, info = segment index) — per-chunk frequency, dropped in
        # lean mode like the other high-rate instants.
        def coll_cb(phase):
            def cb(es, p):
                p = p or {}
                tr = self._trace_of(p.get("rank", self.base_rank))
                if tr is not None:
                    ks = self._k[tr.rank - self.base_rank]
                    getattr(tr, phase)(
                        ks["coll"],
                        int(p.get("id", 0)) & 0x7FFFFFFFFFFFFFFF,
                        int(p.get("bytes", 0)))
                    # job-attributable collective: the op inherited its
                    # trace context from the issuing task's thread
                    # (jobtrace.current at op construction) — recorded
                    # as a jobcoll span (event_id = trace id, info =
                    # the cid token for pairing)
                    trace = int(p.get("trace", 0) or 0)
                    if trace:
                        getattr(tr, phase)(
                            ks["jobcoll"], trace,
                            int(p.get("id", 0)) & 0x7FFFFFFFFFFFFFFF)
            return cb

        sub(pins.COLL_BEGIN, coll_cb("begin"))
        sub(pins.COLL_END, coll_cb("end"))
        if not self.lean:
            def coll_seg_cb(es, p):
                p = p or {}
                tr = self._trace_of(p.get("rank", self.base_rank))
                if tr is not None:
                    tr.instant(
                        self._k[tr.rank - self.base_rank]["coll_seg"],
                        int(p.get("id", 0)) & 0x7FFFFFFFFFFFFFFF,
                        int(p.get("seg", 0)))

            sub(pins.COLL_SEG, coll_seg_cb)

        # serving-plane job lifecycle (serve.RuntimeService): one
        # ``job_phase`` instant per transition — event_id = trace id,
        # info = phase code (jobtrace.PHASE_*).  These are what let
        # ``tools critpath --job`` split a job's latency into
        # queue/admit/run/drain and merge draw the phase row.
        from .jobtrace import PHASE_ADMIT, PHASE_DONE, PHASE_SUBMIT

        def job_cb(code):
            def cb(es, p):
                p = p or {}
                trace = int(p.get("trace", 0) or 0)
                if not trace:
                    return
                tr = self._trace_of(p.get("rank", self.base_rank))
                if tr is None:
                    tr = self.traces[0]
                tr.instant(self._k[tr.rank - self.base_rank]["job_phase"],
                           trace, code)
            return cb

        sub(pins.JOB_SUBMIT, job_cb(PHASE_SUBMIT))
        sub(pins.JOB_ADMIT, job_cb(PHASE_ADMIT))
        sub(pins.JOB_DONE, job_cb(PHASE_DONE))

        # happens-before instants (tools hbcheck reconstructs the event
        # streams offline — analysis.hb.analyze_trace).  Sites without a
        # rank in the payload (dep counters, tile versions, arena slots)
        # land on the set's FIRST trace; the native per-thread streams
        # keep the event streams apart, which is what the checker orders
        # on.  Ids are truncated to the record's 63-bit field.
        def hb_cb(key, eid_fn, info_fn=lambda p: 0):
            def cb(es, p):
                tr = self._trace_of(p.get("rank", self.base_rank)) \
                    if p else None
                if tr is None:
                    tr = self.traces[0]
                tr.instant(self._k[tr.rank - self.base_rank][key],
                           int(eid_fn(p)) & 0x7FFFFFFFFFFFFFFF,
                           int(info_fn(p)))
            return cb

        def _hash(v) -> int:
            return hash(v) & 0x7FFFFFFFFFFFFFFF

        sub(pins.DEP_DECREMENT, hb_cb(
            "hb_dep_dec", lambda p: _hash((p["tracker"], p["key"])),
            lambda p: 1 if p["ready"] else 0))
        sub(pins.DATA_VERSION_BUMP, hb_cb(
            "hb_ver_bump", lambda p: p["data"],
            lambda p: p.get("version", 0)))
        sub(pins.ARENA_ALLOC, hb_cb("hb_arena_alloc", lambda p: p["slot"]))
        sub(pins.ARENA_RECYCLE, hb_cb("hb_arena_recycle",
                                      lambda p: p["slot"]))
        sub(pins.HB_FRAME_SEND, hb_cb("hb_frame_send",
                                      lambda p: p["frame"]))
        sub(pins.HB_FRAME_DELIVER, hb_cb("hb_frame_deliver",
                                         lambda p: p["frame"]))
        sub(pins.NATIVE_TASK_DONE, hb_cb(
            "hb_task_done",
            lambda p: ((p["graph"] & 0x3FFFFF) << 40)
            | (p["task"] & 0xFFFFFFFFFF),
            lambda p: 1 if p["accepted"] else 0))

        # staging-pipeline spans (device/staging.py, fired on the
        # transfer lane / committer threads): event_id = the batch's
        # process-wide span id so B/E pair up, info = bytes moved.  The
        # critpath ``transfer`` bucket reads these spans.
        def stage_cb(key, phase):
            def cb(es, p):
                p = p or {}
                tr = self._trace_of(p.get("rank", self.base_rank))
                if tr is None:
                    tr = self.traces[0]
                getattr(tr, phase)(
                    self._k[tr.rank - self.base_rank][key],
                    int(p.get("id", 0)) & 0x7FFFFFFFFFFFFFFF,
                    int(p.get("bytes", 0)))
            return cb

        sub(pins.STAGE_IN_BEGIN, stage_cb("stage_in", "begin"))
        sub(pins.STAGE_IN_END, stage_cb("stage_in", "end"))
        sub(pins.WRITEBACK_BEGIN, stage_cb("writeback", "begin"))
        sub(pins.WRITEBACK_END, stage_cb("writeback", "end"))

        # staging-pipeline hb edges: hb_stage_in's event_id is the TASK
        # token (same space as the exec spans, so the offline analyzer
        # joins stage_in -> exec); wb enqueue/commit carry the
        # committer's ticket (commit fires once per drained batch with
        # the whole ticket list)
        sub(pins.HB_STAGE_IN, hb_cb(
            "hb_stage_in", lambda p: self._tok(p["task"])))

        def on_wb_hb(es, p):
            p = p or {}
            tr = self.traces[0]
            ks = self._k[tr.rank - self.base_rank]
            if "ticket" in p:
                tr.instant(ks["hb_wb_enqueue"],
                           int(p["ticket"]) & 0x7FFFFFFFFFFFFFFF)
            for t in p.get("tickets") or ():
                tr.instant(ks["hb_wb_commit"],
                           int(t) & 0x7FFFFFFFFFFFFFFF)

        sub(pins.HB_WB_ENQUEUE, on_wb_hb)
        sub(pins.HB_WB_COMMIT, on_wb_hb)
        return self

    def uninstall(self) -> None:
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        self._subs.clear()
        self._installed = False

    # -- clock alignment / dump ------------------------------------------
    def set_clock_offset(self, rank: int, offset_ns: int) -> None:
        tr = self._trace_of(rank)
        if tr is not None:
            tr.clock_offset_ns = int(offset_ns)

    def dump(self, directory: str, suffix: str = ".pbt") -> List[str]:
        """Write one ``rank<r><suffix>`` (+ sidecar) per rank; returns
        the paths, merge-ready for :func:`profiling.merge.merge_traces`
        (flight-recorder snapshots use ``suffix=".fr.pbt"``)."""
        import os

        os.makedirs(directory, exist_ok=True)
        paths = []
        for tr in self.traces:
            p = os.path.join(directory, f"rank{tr.rank}{suffix}")
            tr.dump(p)
            paths.append(p)
        return paths

    def close(self) -> None:
        for tr in self.traces:
            tr.close()


# ---------------------------------------------------------------------------
# offline readers (reference dbpreader.c / pbt2ptt)
# ---------------------------------------------------------------------------

def read_pbt_meta(path: str) -> Dict[str, Any]:
    """The sidecar dictionary of a .pbt dump (rank, keyword/stream
    tables, clock epoch + handshake offset); empty-ish defaults when the
    sidecar is missing."""
    meta: Dict[str, Any] = {"keywords": [], "streams": [], "rank": 0}
    try:
        with open(path + ".meta.json") as f:
            meta.update(json.load(f))
    except OSError:
        pass
    return meta


def read_pbt(path: str) -> List[Dict[str, Any]]:
    """Parse a .pbt file (+ sidecar) into event dicts."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a PBTRACE1 file")
        count = int(np.frombuffer(f.read(8), "<i8")[0])
        recs = np.fromfile(f, dtype=_RECORD_DTYPE, count=count)
    meta = read_pbt_meta(path)
    kw = meta["keywords"]
    streams = meta["streams"]
    out = []
    for r in recs:
        kid = int(r["keyword"])
        sid = int(r["stream"])
        out.append({
            "name": kw[kid] if 0 <= kid < len(kw) else f"kw{kid}",
            "ph": PHASES.get(int(r["phase"]), "?"),
            "ts": float(r["ts_ns"]) / 1e3,  # Chrome traces use microseconds
            "pid": meta.get("rank", 0),
            "tid": streams[sid] if 0 <= sid < len(streams) else f"stream{sid}",
            "args": {"event_id": int(r["event_id"]), "info": int(r["info"])},
        })
    return out


def to_chrome_events(path: str) -> List[Dict[str, Any]]:
    """Chrome trace-event view of a .pbt (counter records become 'C')."""
    evs = read_pbt(path)
    for e in evs:
        if e["ph"] == "C":
            e["args"] = {"value": e["args"]["event_id"]}
    return evs
