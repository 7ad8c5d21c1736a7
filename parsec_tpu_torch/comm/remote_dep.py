"""Remote dependency protocol: the dataflow wire logic on top of the CE.

Reference: ``parsec/remote_dep.c`` + ``remote_dep_mpi.c`` —
a completing task with remote successors emits an *activation* message
(taskpool, task class, locals, output mask) to each successor rank.  The
data plane is TWO-REGIME (``remote_dep_mpi.c:1319-1371`` short/rendezvous
split):

* **eager** — payloads at or below ``runtime_comm_eager_limit`` ride
  INLINE with the activation frame: the receiver completes the input with
  zero extra round trips (the GET machinery is never touched);
* **rendezvous** — larger payloads are advertised by handle + wire header
  (shape/dtype/bytes) and PULLED by the receiver in pipelined chunks:
  ``runtime_comm_pipeline_depth`` chunk requests in flight per transfer,
  each landing at its byte offset in ONE preallocated arena-backed buffer
  (:class:`~parsec_tpu_torch.data.arena.BytePool`), so deserialization overlaps
  the wire and no full-payload intermediate copy is ever made.  Chunks may
  arrive out of order; completion is byte-counted.

Device-capable fabrics (``CommEngine.device_payloads``) short-circuit the
split for CUDA-tensor payloads: a device buffer crosses as one clone made
on the card at any size (the device-native path, SURVEY §5.8; the
in-process fabric's ``_wire_copy``) and counts as eager.  Host payloads
are numpy arrays or torch CPU tensors (bfloat16); both frame raw
(:mod:`.payload`).

On arrival the receiver deposits the data and runs the origin task's
``release_deps`` locally (``remote_dep_release_incoming``). Activations
for taskpools the receiver has not seen yet are parked in a fifo and
replayed at taskpool registration (``dep_activates_noobj_fifo``,
``remote_dep_mpi.c:102``).

Taskpools are matched across ranks by *name* (every rank instantiates the
same logical taskpool; numeric ids are process-local).
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import debug, mca_param
from ..data.arena import BytePool
from ..data.data import data_create
from ..profiling import pins
from .engine import (
    CommEngine, EAGER_LIMIT_DEFAULT, PIPELINE_DEPTH_DEFAULT,
    RDV_CHUNK_DEFAULT, TAG_ACTIVATE, TAG_DTD,
)
from .payload import (
    as_bytes, from_wire, is_device_array, raw_framable, to_wire, wire_header,
)


def _key_words(key) -> int:
    """32-bit word count of a DTD wire key (scalar or tuple)."""
    return len(key) if isinstance(key, (tuple, list)) else 1


def _fail_pool(tp, why: str) -> bool:
    """Force-fail a taskpool over an unrecoverable comm loss, with the
    same Context pairing as ``Context.abort`` (context.py:176-181): the
    pool must leave the context's active set, or ``Context.wait()`` would
    still hang on ``_active_taskpools`` even though ``tp.wait()`` returns.
    Returns True only on the terminating transition."""
    # record the root cause BEFORE the terminating transition so whoever
    # surfaces the failure (tp.wait() callers, the native executor's
    # pool shim) can name it instead of a generic "failed (see log)"
    if getattr(tp, "fail_reason", None) is None:
        try:
            tp.fail_reason = why
        except Exception:
            pass  # exotic pool types without settable attrs: log-only
    if not tp._force_fail():
        return False  # already terminated (normally or by an earlier failure)
    debug.error("taskpool %s failed: %s", tp.name, why)
    ctx = getattr(tp, "context", None)
    if ctx is not None:
        ctx._taskpool_terminated(tp)
    return True


def fail_pool_for_context(ctx, tp, why: str) -> bool:
    """Fail one pool through the path its context warrants: broadcast
    the abort to peer ranks on a multi-rank mesh (healthy peers must
    not block to their full timeout), plain local fail otherwise.  The
    single dispatch the worker error path, the strict watchdog and the
    serving plane's cancel/evict all share."""
    if getattr(tp, "fail_reason", None) is None:
        try:
            tp.fail_reason = why
        except Exception:
            pass
    rd = getattr(ctx.comm, "remote_dep", None) \
        if getattr(ctx, "comm", None) is not None else None
    if getattr(ctx, "nranks", 1) > 1 and rd is not None:
        rd._fail_pool_everywhere(tp, why)
        return tp.failed
    return _fail_pool(tp, why)


def _wire_len(msg: dict) -> int:
    """Logical activation-header length in bytes (reference
    ``remote_dep_wire_activate_t``: taskpool_id, task_class_id, locals,
    output_mask packed as 32-bit words, plus 2 words per forward-set
    entry — the rank/mask pairs this receiver re-propagates).
    Deterministic so trace-based regression tests can pin exact byte sums
    (tests/profiling/check-comms.py analog); inline payload bytes are
    accounted by the DATA_PLD event, not here."""
    return 4 * (4 + len(msg["src_locals"]) + 2 * len(msg.get("fwd", ())))


class _RdvPull:
    """One incoming rendezvous transfer: a pipelined chunk pull into a
    preallocated arena-backed buffer.

    ``pipeline_depth`` chunk requests stay in flight; each completion
    lands at its byte offset (out-of-order safe) and refills the window.
    The buffer is a :class:`BytePool` slot; the delivered array is a
    zero-copy view over it whose liveness (PEP 3118 exporter chain)
    returns the slot exactly when the last consumer dies — the same slot
    discipline as the TCP receive path.  The pump is iterative, never
    recursive, so synchronous engines (inproc) cannot blow the stack at
    high chunk counts."""

    __slots__ = ("mgr", "src", "desc", "cb", "slot", "holder", "nbytes",
                 "chunk", "nchunks", "next_off", "recvd", "inflight",
                 "failed", "finished", "_lock", "_pumping")

    def __init__(self, mgr: "RemoteDepManager", src_rank: int, desc: dict,
                 cb: Callable[[Optional[np.ndarray]], None]):
        self.mgr = mgr
        self.src = src_rank
        self.desc = desc
        self.cb = cb
        self.nbytes = int(desc["nbytes"])
        self.chunk = max(1, int(mgr.rdv_chunk))
        self.nchunks = max(1, -(-self.nbytes // self.chunk))
        self.slot = mgr._rx_pool.allocate(max(1, self.nbytes))
        holder = self.slot.payload[:self.nbytes]
        weakref.finalize(holder, self.slot.arena.release, self.slot)
        self.holder = holder
        self.next_off = 0
        self.recvd = 0
        self.inflight = 0
        self.failed = False
        self.finished = False
        self._lock = threading.Lock()
        self._pumping = False
        self.pump()

    def pump(self) -> None:
        """Issue chunk requests up to the pipeline depth.  Re-entrant
        calls (a synchronous engine completing a chunk inside get_part)
        turn into no-ops; the OUTER pump's loop keeps the window full.
        A CROSS-THREAD completion racing the flag (it no-ops while this
        thread still holds ``_pumping``, then this thread exits with a
        freed window) is caught by the post-clear re-check: the flag
        holder loops until the window is genuinely full, finished, or
        failed — no lost wakeups."""
        while True:
            with self._lock:
                if self._pumping:
                    return
                self._pumping = True
            try:
                self._fill_window()
            finally:
                with self._lock:
                    self._pumping = False
                    again = (not self.failed and not self.finished
                             and self.next_off < self.nbytes
                             and self.inflight < self.mgr.pipeline_depth)
            if not again:
                return

    def _fill_window(self) -> None:
        while True:
            with self._lock:
                if (self.failed or self.finished
                        or self.next_off >= self.nbytes
                        or self.inflight >= self.mgr.pipeline_depth):
                    return
                off = self.next_off
                ln = min(self.chunk, self.nbytes - off)
                self.next_off = off + ln
                self.inflight += 1
                fin = self.next_off >= self.nbytes
            idx = off // self.chunk
            self.mgr.stats["rdv_chunks_req"] += 1
            if pins.active(pins.COMM_DATA_CTL):
                pins.fire(pins.COMM_DATA_CTL, None,
                          {"rank": self.mgr.ce.rank, "dst": self.src,
                           "bytes": ln, "proto": "rdv",
                           "chunk": idx, "nchunks": self.nchunks})
            try:
                self.mgr.ce.get_part(
                    self.src, self.desc["handle"], off, ln,
                    lambda buf, off=off, ln=ln, idx=idx:
                        self.on_chunk(buf, off, ln, idx),
                    fin=fin, priority=int(self.desc.get("prio", 0)))
            except Exception as e:  # inproc raises synchronously
                debug.error("rdv chunk %d of %r from rank %d raised: %s",
                            idx, self.desc["handle"], self.src, e)
                self.on_chunk(None, off, ln, idx)

    def on_chunk(self, buf, off: int, ln: int, idx: int) -> None:
        finish = None
        with self._lock:
            self.inflight -= 1
            if self.failed or self.finished:
                return
            if buf is None:
                self.failed = True
                finish = "fail"
            else:
                self.holder[off:off + ln] = np.frombuffer(
                    memoryview(buf), np.uint8, count=ln)
                self.recvd += ln
                if self.recvd >= self.nbytes:
                    self.finished = True
                    finish = "done"
        if finish == "fail":
            self.mgr.stats["rdv_pulls_failed"] += 1
            # best-effort release: this consumer will never send its fin
            # chunk, so consume our use of the registration with a
            # zero-length fin read — otherwise the producer's use count
            # never drains and the full payload stays pinned in its mem
            # table (the whole-buffer GET decremented on every serve;
            # chunking must not leak where it didn't)
            try:
                self.mgr.ce.get_part(self.src, self.desc["handle"], 0, 0,
                                     lambda _buf: None, fin=True)
            except Exception:
                pass  # registration already gone (that IS the failure)
            self.cb(None)
            return
        self.mgr.stats["rdv_bytes"] += ln
        if pins.active(pins.COMM_DATA_PLD):
            pins.fire(pins.COMM_DATA_PLD, None,
                      {"rank": self.mgr.ce.rank, "peer": self.src,
                       "bytes": ln, "kind": "rdv", "proto": "rdv",
                       "chunk": idx, "nchunks": self.nchunks,
                       "trace": int(self.desc.get("trace", 0) or 0)})
        if finish == "done":
            self.mgr.stats["rdv_pulls_done"] += 1
            self.cb(from_wire(self.desc["hdr"], self.holder))
            return
        self.pump()


class RemoteDepManager:
    """Per-rank protocol endpoint bound to a comm engine."""

    def __init__(self, ce: CommEngine):
        self.ce = ce
        self.context = None
        self._taskpools: Dict[str, Any] = {}
        #: parked activations for unknown taskpools (reference noobj fifo)
        self._noobj: Dict[str, List[Tuple[int, dict]]] = collections.defaultdict(list)
        self._noobj_dtd: Dict[str, List[Tuple[int, dict]]] = collections.defaultdict(list)
        #: names of pools that finished here (cleared on name reuse) —
        #: discriminates stale aborts from startup-skew aborts
        self._completed: set = set()
        self._lock = threading.Lock()
        # two-regime thresholds: the engine registered and VALIDATED the
        # protocol params at construction (engine.py _init_protocol); the
        # pre-rendezvous ``comm_short_limit`` stays honored as the legacy
        # explicit override so existing configs/tests keep their meaning.
        legacy = mca_param.register(
            "runtime", "comm_short_limit", 1 << 16,
            help="DEPRECATED alias of runtime_comm_eager_limit (honored "
                 "when set explicitly while the new param is default)")
        # read from the REGISTRY, not engine attributes: registration is
        # idempotent, so engines that ran _init_protocol and bare test
        # doubles resolve identically — and an explicitly configured
        # legacy comm_short_limit is honored either way
        eager = int(mca_param.register(
            "runtime", "comm_eager_limit", EAGER_LIMIT_DEFAULT))
        if (mca_param.source("runtime", "comm_short_limit") != "default"
                and mca_param.source("runtime", "comm_eager_limit")
                == "default"):
            eager = int(legacy)
        #: eager/rendezvous split point (``short_limit`` kept as the
        #: historical attribute name for external readers)
        self.eager_limit = self.short_limit = eager
        # engines validate at construction; the max() guards only cover
        # engines that never ran _init_protocol
        self.pipeline_depth = max(1, int(mca_param.register(
            "runtime", "comm_pipeline_depth", PIPELINE_DEPTH_DEFAULT)))
        self.rdv_chunk = max(1, int(mca_param.register(
            "runtime", "comm_rdv_chunk", RDV_CHUNK_DEFAULT)))
        #: landing buffers for rendezvous payloads (recycled size
        #: classes).  Rank-qualified name: slot lifecycle events
        #: (pins.ARENA_ALLOC/RECYCLE — the hb-check double-recycle
        #: detector, which watches exactly the finalizer-driven recycle
        #: _RdvPull rides) name the endpoint, not just "rdv-rx"
        self._rx_pool = BytePool(f"rdv-rx{getattr(ce, 'rank', 0)}")
        self.bcast_topo = str(mca_param.register(
            "runtime", "bcast_topo", "binomial",
            choices=["star", "chain", "binomial"],
            help="activation fan-out topology: star | chain | binomial "
                 "(reference remote_dep propagation trees)"))
        if self.bcast_topo not in ("star", "chain", "binomial"):
            debug.warning("remote_dep: unknown bcast_topo %r, using binomial",
                          self.bcast_topo)
            self.bcast_topo = "binomial"
        self.stats = collections.Counter()
        # register LAST: backends with a live comm thread may replay parked
        # activations synchronously from inside register_am
        ce.register_am(TAG_DTD, self._on_dtd)
        ce.register_am(TAG_ACTIVATE, self._on_activate)

    # -- regime decision + counters --------------------------------------
    def _regime(self, payload) -> str:
        """eager | rdv for one flow payload.  CUDA tensors on a device-
        capable fabric are ALWAYS eager: they cross as one clone on the
        card, so the host-copy rationale for the threshold does not apply
        (and chunking a device buffer would force the very host bounce the
        fabric exists to avoid)."""
        if is_device_array(payload):
            if getattr(self.ce, "device_payloads", False):
                return "eager"
            payload = to_wire(payload)  # serializing fabric: wire form
        nbytes = getattr(payload, "nbytes", 0)
        return "eager" if nbytes <= self.eager_limit else "rdv"

    def _host_form(self, payload):
        """The raw-framable host form of a rendezvous payload: its wire
        form (an ndarray, or a torch CPU tensor for bfloat16), gathered to
        contiguous once when it is a strided view."""
        payload = to_wire(payload)
        if not raw_framable(payload):
            payload = self._gather(payload)
        return payload

    def _gather(self, payload):
        """Gather a non-contiguous view to wire-contiguous form once at
        rendezvous registration (the CE pack slot's job — chunk serves
        then slice raw bytes with no further copies).  Counted in the
        ENGINE's ``dt_packed`` so datatype-packed-send accounting stays
        one number wherever the gather happens (transport or protocol)."""
        stats = getattr(self.ce, "stats", None)
        if stats is not None:
            stats["dt_packed"] += 1
        self.stats["rdv_packed"] += 1
        if isinstance(payload, torch.Tensor):
            return payload.contiguous()
        return np.ascontiguousarray(payload)

    def _count_eager(self, payload) -> None:
        self.stats["inline_sent"] += 1     # legacy name, kept for tools
        self.stats["eager_sent"] += 1
        self.stats["eager_bytes"] += int(getattr(payload, "nbytes", 0))

    def protocol_stats(self) -> dict:
        """Protocol-level wire summary: eager hit-rate + bytes per regime
        (surfaced by CommEngine stats consumers: bench legs, critpath)."""
        eager = int(self.stats["eager_sent"])
        rdv = int(self.stats["rdv_advertised"])
        total = eager + rdv
        return {
            "eager_sent": eager,
            "rdv_sent": rdv,
            "eager_hit_rate": (eager / total) if total else 1.0,
            "eager_bytes": int(self.stats["eager_bytes"]),
            "rdv_bytes": int(self.stats["rdv_bytes"]),
            "rdv_chunks": int(self.stats["rdv_chunks_req"]),
        }

    def rdv_pulls_in_flight(self) -> int:
        """Incoming rendezvous transfers started but not yet fully landed
        (nor failed) — a live gauge for the health plane: nonzero at
        quiescence means payload chunks went missing."""
        return max(0, int(self.stats["rdv_pulls"])
                   - int(self.stats["rdv_pulls_done"])
                   - int(self.stats["rdv_pulls_failed"]))

    # -- taskpool registry ----------------------------------------------
    def new_taskpool(self, tp) -> None:
        with self._lock:
            self._taskpools[tp.name] = tp
            # the name now denotes THIS logical run: a later abort for it
            # is live again (see _on_activate's completed-name check)
            self._completed.discard(tp.name)
            parked = self._noobj.pop(tp.name, [])
            parked_dtd = self._noobj_dtd.pop(tp.name, [])
        for src, msg in parked:
            self._deliver(tp, src, msg)
        for src, msg in parked_dtd:
            self._deliver_dtd(tp, src, msg)

    def taskpool_done(self, tp) -> None:
        with self._lock:
            self._taskpools.pop(tp.name, None)
            self._noobj.pop(tp.name, None)
            self._noobj_dtd.pop(tp.name, None)
            self._completed.add(tp.name)

    def _lookup_or_park(self, src_rank: int, msg: dict, parked, stat: str):
        """Resolve the target taskpool or park the message until it
        registers (reference noobj fifo, remote_dep_mpi.c:102)."""
        tp = self._taskpools.get(msg["pool"])
        if tp is None:
            with self._lock:
                tp = self._taskpools.get(msg["pool"])
                if tp is None:
                    parked[msg["pool"]].append((src_rank, msg))
                    self.stats[stat] += 1
        return tp

    # -- producer side ---------------------------------------------------
    def send_activations(
        self,
        tp,
        src_class: str,
        src_locals: Tuple,
        rank_masks: Dict[int, int],
        flow_payloads: Dict[int, np.ndarray],
        priority: int = 0,
    ) -> None:
        """Aggregated activations for ONE completing task: a single
        message per destination rank carrying the output-flow mask for
        every dep that rank participates in, with each flow's payload
        shipped once (reference ``parsec_remote_deps_t`` +
        ``remote_dep_wire_activate_t.output_mask``, remote_dep.h:132-153).

        Destinations are covered down a broadcast topology (MCA
        ``runtime_bcast_topo``: star | chain | binomial) with forward
        sets: a receiver re-propagates to its subtree from its own copy,
        so a 1→R fan-out costs the root O(children) payload sends and
        O(log R) hops end-to-end under binomial instead of O(R) root
        sends (reference remote_dep.c:262-345 propagation + fw_mask).

        ``priority`` (the completing task's priority) orders this
        activation against others sharing a coalesced frame/drain cycle:
        critical-path tiles leave first (reference: priority-ordered
        per-peer rings, remote_dep_mpi.c:1095-1132).

        The receiver re-derives its local successors from (task, mask) —
        the reference model (iterate_successors on the receiving rank) —
        so successor lists never travel the wire."""
        targets = sorted(rank_masks.items())
        self._send_tree(tp.name, src_class, src_locals, targets,
                        flow_payloads, priority=priority,
                        trace=int(getattr(tp, "trace_id", 0) or 0))

    def _topo_children(
            self, targets: List[Tuple[int, int]]
    ) -> List[Tuple[Tuple[int, int], List[Tuple[int, int]]]]:
        """Split ``[(rank, mask)...]`` into ``[(child, subtree)...]`` per
        the configured topology.  binomial: each child takes the first
        half of the remainder, halving recursively (log-depth, log root
        fan-out); chain: one child carries everyone; star: all direct."""
        # snapshot at init like eager_limit — no registry lock on the
        # send/forward hot path
        topo = self.bcast_topo
        if topo == "star":
            return [(t, []) for t in targets]
        if topo == "chain":
            return [(targets[0], targets[1:])] if targets else []
        out = []  # binomial
        rest = list(targets)
        while rest:
            k = (len(rest) + 1) // 2  # child + its subtree
            out.append((rest[0], rest[1:k]))
            rest = rest[k:]
        return out

    def _send_tree(
        self,
        pool: str,
        src_class: str,
        src_locals: Tuple,
        targets: List[Tuple[int, int]],
        flow_payloads: Dict[int, np.ndarray],
        lost_mask: int = 0,
        priority: int = 0,
        trace: int = 0,
    ) -> None:
        """Send one aggregated activation to each topology child, with its
        subtree attached as the forward set (used by the producer AND by
        every forwarding receiver — data follows the tree)."""
        children = self._topo_children(targets)
        if not children:
            return
        # regime per flow, decided ONCE (not per child): eager payloads
        # ride every child's frame; rendezvous payloads register their
        # raw bytes ONCE with a pull budget equal to the number of
        # children, so registrations self-reclaim instead of pinning
        # every large payload forever
        regimes = {fi: self._regime(p) for fi, p in flow_payloads.items()}
        needs: List[int] = []
        get_counts: Dict[int, int] = {}
        for (child, cmask), subtree in children:
            need = cmask
            for _r, m in subtree:
                need |= m
            needs.append(need)
            for fi, payload in flow_payloads.items():
                if (need >> fi) & 1 and regimes[fi] == "rdv":
                    get_counts[fi] = get_counts.get(fi, 0) + 1
        rdv_desc: Dict[int, dict] = {}
        for fi, n in get_counts.items():
            payload = self._host_form(flow_payloads[fi])
            handle = (pool, src_class, src_locals, fi)
            self.ce.mem_register(handle, as_bytes(payload), uses=n)
            # the wire-header extension: the rendezvous descriptor
            # carries the job trace id, so every chunk the receiver
            # lands is job-attributable (profiling.jobtrace)
            hdr = wire_header(payload)
            rdv_desc[fi] = {"handle": handle, "hdr": hdr,
                            "nbytes": hdr["nbytes"], "trace": trace}
        for ((child, cmask), subtree), need in zip(children, needs):
            flows: Dict[int, dict] = {}
            for fi, payload in flow_payloads.items():
                if not (need >> fi) & 1:
                    continue
                if regimes[fi] == "eager":
                    flows[fi] = {"kind": "eager", "data": payload}
                    self._count_eager(payload)
                else:
                    d = dict(rdv_desc[fi])
                    d["kind"] = "rdv"
                    flows[fi] = d
                    self.stats["get_advertised"] += 1  # legacy name
                    self.stats["rdv_advertised"] += 1
                    if pins.active(pins.COMM_DATA_CTL):
                        pins.fire(pins.COMM_DATA_CTL, None,
                                  {"rank": self.ce.rank, "dst": child,
                                   "bytes": d["nbytes"], "proto": "rdv"})
            msg = {
                "pool": pool,
                "kind": "agg",
                "src_class": src_class,
                "src_locals": src_locals,
                "mask": cmask,
                "fwd": subtree,
                "flows": flows,
            }
            if priority:
                msg["prio"] = priority
            if trace:
                msg["trace"] = trace
            if lost_mask:
                # flows lost upstream (failed GET): tell the subtree so
                # every downstream rank fails fast instead of timing out
                msg["lost"] = lost_mask
            self.stats["activations_sent"] += 1
            if pins.active(pins.COMM_ACTIVATE):
                ne = sum(1 for d in flows.values() if d["kind"] == "eager")
                pins.fire(pins.COMM_ACTIVATE, None,
                          {"rank": self.ce.rank, "dst": child,
                           "bytes": _wire_len(msg), "class": src_class,
                           "eager_flows": ne,
                           "rdv_flows": len(flows) - ne,
                           "trace": trace})
            self.ce.send_am(TAG_ACTIVATE, child, msg, priority=priority)

    def send_writeback(self, tp, collection_name: str, key: Tuple,
                       payload: Optional[np.ndarray], dst_rank: int) -> None:
        """Ship a flow's FINAL value to its home tile's owner (a PTG
        ``-> A(...)`` output dep whose collection element lives on another
        rank). The owner pre-counts expected write-backs as termdet
        runtime actions, so its taskpool cannot quiesce before the data
        lands (reference analog: the data-collection write side of
        release_deps, DTD's data_flush for the dynamic case).
        ``payload=None`` is a pure retire for a counted-but-dataless flow."""
        if payload is not None and not getattr(self.ce, "device_payloads",
                                               False):
            payload = to_wire(payload)  # serialize for the wire
        msg = {
            "pool": tp.name,
            "kind": "writeback",
            "collection": collection_name,
            "key": tuple(key),
            "data": payload,
            "trace": int(getattr(tp, "trace_id", 0) or 0),
        }
        self.stats["writebacks_sent"] += 1
        self.ce.send_am(TAG_ACTIVATE, dst_rank, msg)

    # -- receiver side ---------------------------------------------------
    def _on_activate(self, src_rank: int, msg: dict) -> None:
        if msg.get("kind") == "abort":
            # three cases, discriminated so an abort neither hangs a
            # startup-skewed rank NOR poisons a later same-named run:
            #  * pool live here        -> deliver (fail it now);
            #  * pool ALREADY FINISHED -> drop: this rank's wait()
            #    returned long ago; parking would replay the abort into
            #    the next pool that reuses the name, killing a healthy
            #    run;
            #  * pool not yet seen     -> park: this rank is still
            #    attaching (startup skew) and must fail at registration,
            #    not discover the loss by exhausting its wait() timeout.
            # completed-check AND the lookup/park decision under ONE lock
            # acquisition: taskpool_done racing between them would park a
            # stale abort that replays into the next pool reusing the name
            with self._lock:
                if msg["pool"] in self._completed:
                    debug.verbose(3, "comm", "abort for finished pool %s "
                                  "from rank %d: dropped", msg["pool"],
                                  src_rank)
                    return
                tp = self._taskpools.get(msg["pool"])
                if tp is None:
                    self._noobj[msg["pool"]].append((src_rank, msg))
                    self.stats["parked"] += 1
                    return
            self._deliver(tp, src_rank, msg)
            return
        tp = self._lookup_or_park(src_rank, msg, self._noobj, "parked")
        if tp is not None:
            self._deliver(tp, src_rank, msg)

    def _fail_pool_everywhere(self, tp, why: str) -> None:
        """Fail the pool on EVERY rank, not just locally: ranks outside
        the broadcast subtree (the producer, write-back-counting tile
        owners) would otherwise still discover the loss by exhausting
        their full wait() timeout.  Failures are rare; R-1 tiny abort
        messages are nothing.  Broadcast only on the terminating
        transition — a pool losing many in-flight payloads must not
        re-notify every peer per loss."""
        if not _fail_pool(tp, why):
            return
        msg = {"pool": tp.name, "kind": "abort", "why": why}
        for r in range(getattr(self.ce, "nranks", 1)):
            if r != getattr(self.ce, "rank", 0):
                try:
                    self.ce.send_am(TAG_ACTIVATE, r, msg)
                except Exception as e:  # a dead peer must not mask the fail
                    debug.error("abort notify to rank %d failed: %s", r, e)

    def _deliver(self, tp, src_rank: int, msg: dict) -> None:
        kind = msg["kind"]
        if kind == "abort":
            _fail_pool(tp, "aborted by rank %d: %s"
                       % (src_rank, msg.get("why", "")))
            return
        if kind == "writeback":
            self.stats["writebacks_recv"] += 1
            tp.incoming_writeback(msg["collection"], tuple(msg["key"]),
                                  msg["data"])
            return
        self.stats["activations_recv"] += 1
        # aggregated activation: resolve every flow payload (eager ones
        # now — the zero-round-trip fast path — rendezvous pulls
        # asynchronously), then forward down the tree and release local
        # successors
        flows: Dict[int, dict] = msg.get("flows", {})
        resolved: Dict[int, np.ndarray] = {}
        pulls = [(fi, d) for fi, d in flows.items()
                 if d["kind"] in ("rdv", "get")]
        for fi, d in flows.items():
            if d["kind"] in ("eager", "inline"):
                resolved[fi] = d["data"]
                self.stats["eager_recv"] += 1
                if pins.active(pins.COMM_DATA_PLD):
                    pins.fire(pins.COMM_DATA_PLD, None,
                              {"rank": self.ce.rank, "peer": src_rank,
                               "bytes": getattr(d["data"], "nbytes", 0),
                               "kind": "eager", "proto": "eager",
                               "trace": int(msg.get("trace", 0) or 0)})
        if not pulls:
            self._complete_incoming(tp, msg, resolved, msg.get("lost", 0))
            return
        remaining = [len(pulls)]  # comm-thread-serial on TCP; lock-free ok
        failed = [msg.get("lost", 0)]

        def arrived(fi, buf):
            if buf is None:
                # pull failed (handle gone at the source): the payload is
                # permanently lost.  The surviving flows still propagate
                # down the tree, then _complete_incoming fail-fasts the
                # pool on every rank (abort broadcast) — wait() returns
                # False promptly instead of timing out.
                debug.error(
                    "activation %s%r flow %d: payload pull failed; "
                    "failing the pool",
                    msg["src_class"], tuple(msg["src_locals"]), fi)
                failed[0] |= 1 << fi
            else:
                resolved[fi] = buf
            remaining[0] -= 1
            if remaining[0] == 0:
                self._complete_incoming(tp, msg, resolved, failed[0])

        for fi, d in pulls:
            self.stats["get_issued"] += 1  # legacy name: one per transfer
            if d["kind"] == "rdv":
                self.stats["rdv_pulls"] += 1
                d = dict(d)
                d.setdefault("prio", msg.get("prio", 0))
                _RdvPull(self, src_rank, d,
                         lambda buf, fi=fi: arrived(fi, buf))
            else:  # legacy whole-buffer GET (not emitted; robustness)
                try:
                    self.ce.get(src_rank, d["handle"],
                                lambda buf, fi=fi: arrived(fi, buf))
                except Exception as e:
                    debug.error("GET %r from %d raised: %s",
                                d["handle"], src_rank, e)
                    arrived(fi, None)

    def _complete_incoming(self, tp, msg: dict,
                           resolved: Dict[int, np.ndarray],
                           failed_mask: int = 0) -> None:
        """All payloads in hand: re-propagate to this rank's subtree FIRST
        (the tree must not wait on local execution — reference
        remote_dep_propagate runs in the comm engine), then re-derive and
        release local successors (reference remote_dep_release_incoming /
        iterate_successors on the receiving rank).  Flows whose payload
        was lost are masked OUT everywhere downstream: their successors
        stay unreleased (loudly), the rest of the DAG keeps moving."""
        fwd = [(r, m & ~failed_mask) for r, m in
               (tuple(t) for t in msg.get("fwd", ()))]
        if fwd:
            self.stats["forwarded"] += 1
            self._send_tree(msg["pool"], msg["src_class"],
                            tuple(msg["src_locals"]), fwd, resolved,
                            lost_mask=failed_mask,
                            priority=msg.get("prio", 0),
                            trace=int(msg.get("trace", 0) or 0))
        tp.incoming_activation(
            src_class=msg["src_class"],
            src_locals=tuple(msg["src_locals"]),
            mask=msg["mask"] & ~failed_mask,
            flow_data=resolved,
        )
        if failed_mask:
            # a payload is permanently lost: the masked-out successors can
            # never run, so this pool can never quiesce — fail it now
            # (after propagating the surviving flows AND the lost mask, so
            # the whole subtree fails fast too) so wait() returns promptly
            # instead of timing out.  Only the rank that DISCOVERED the
            # loss (no "lost" bit from upstream) broadcasts the abort;
            # subtree ranks fail locally off the mask they were handed.
            why = "lost payload(s) of %s%r (mask %#x)" % (
                msg["src_class"], tuple(msg["src_locals"]), failed_mask)
            if failed_mask & ~msg.get("lost", 0):
                self._fail_pool_everywhere(tp, why)
            else:
                _fail_pool(tp, why)

    # -- DTD tile-version channel (shadow-task protocol) -----------------
    def send_dtd(self, tp, wire_key, epoch: int, payload: np.ndarray, dst_rank: int) -> None:
        """Ship one tile version to the rank that will consume it.  Same
        two-regime policy as PTG activations (remote_dep_mpi.c:1319):
        small versions ride eager with the message, large ones advertise
        a chunked-rendezvous handle."""
        msg = {"pool": tp.name, "tile": wire_key, "epoch": epoch,
               "trace": int(getattr(tp, "trace_id", 0) or 0)}
        if self._regime(payload) == "eager":
            msg["kind"] = "eager"
            msg["data"] = payload
            self.stats["dtd_inline_sent"] += 1  # legacy name
            self._count_eager(payload)
        else:
            payload = self._host_form(payload)
            hdr = wire_header(payload)
            handle = ("dtd", tp.name, wire_key, epoch, dst_rank)
            # exactly one consumer pulls each (tile, epoch, dst) handle:
            # consume-on-serve so epoch-keyed registrations don't pile up
            self.ce.mem_register(handle, as_bytes(payload), once=True)
            msg["kind"] = "rdv"
            msg["handle"] = handle
            msg["hdr"] = hdr
            msg["nbytes"] = hdr["nbytes"]
            self.stats["dtd_get_advertised"] += 1  # legacy name
            self.stats["rdv_advertised"] += 1
            if pins.active(pins.COMM_DATA_CTL):
                pins.fire(pins.COMM_DATA_CTL, None,
                          {"rank": self.ce.rank, "dst": dst_rank,
                           "bytes": hdr["nbytes"], "proto": "rdv"})
        self.stats["dtd_sent"] += 1
        if pins.active(pins.COMM_ACTIVATE):
            # DTD tile shipments are activations too (shadow-task wire):
            # header = pool + tile key + epoch words
            pins.fire(pins.COMM_ACTIVATE, None,
                      {"rank": self.ce.rank, "dst": dst_rank,
                       "bytes": 4 * (2 + _key_words(wire_key)),
                       "class": "dtd",
                       "trace": int(getattr(tp, "trace_id", 0) or 0)})
        self.ce.send_am(TAG_DTD, dst_rank, msg)

    def _on_dtd(self, src_rank: int, msg: dict) -> None:
        tp = self._lookup_or_park(src_rank, msg, self._noobj_dtd, "dtd_parked")
        if tp is not None:
            self._deliver_dtd(tp, src_rank, msg)

    def _deliver_dtd(self, tp, src_rank: int, msg: dict) -> None:
        self.stats["dtd_recv"] += 1
        key = tuple(msg["tile"]) if isinstance(msg["tile"], list) else msg["tile"]

        def arrived(buf):
            if buf is None:  # failed pull (see _on_get_ans error path)
                # the consumer task can never run — fail the pool on every
                # rank so wait() returns promptly instead of timing out
                self._fail_pool_everywhere(
                    tp, "dtd tile %r epoch %s: payload pull failed"
                    % (key, msg["epoch"]))
                return
            tp.dtd_incoming(key, msg["epoch"], buf)

        if msg["kind"] == "rdv":
            self.stats["get_issued"] += 1
            self.stats["rdv_pulls"] += 1
            _RdvPull(self, src_rank, msg, arrived)
        elif msg["kind"] == "get":  # legacy whole-buffer GET (robustness)
            try:
                self.ce.get(src_rank, msg["handle"], arrived)
            except Exception as e:  # inproc raises synchronously
                debug.error("dtd GET %r from %d raised: %s",
                            msg["handle"], src_rank, e)
                arrived(None)
        else:
            self.stats["eager_recv"] += 1
            if pins.active(pins.COMM_DATA_PLD):
                pins.fire(pins.COMM_DATA_PLD, None,
                          {"rank": self.ce.rank, "peer": src_rank,
                           "bytes": getattr(msg["data"], "nbytes", 0),
                           "kind": "eager", "proto": "eager",
                           "trace": int(msg.get("trace", 0) or 0)})
            arrived(msg["data"])
