"""Runtime collectives: nonblocking allreduce / reduce-scatter /
allgather / bcast riding the rendezvous machinery.

The port of :mod:`parsec_tpu.comm.coll`.  Reference shape: PaRSEC routes
multi-party values through per-dependency activation trees
(``remote_dep.c`` star/chain/binomial propagation) and ships no reduction
collectives of its own; MPI-class runtimes implement them as segmented
ring / recursive-doubling schedules over the same point-to-point engine
(the classic Rabenseifner decomposition).  That is what this module does,
on OUR wire: a :class:`CollOp` decomposes the payload into
``runtime_coll_segment``-sized segments, keeps
``runtime_comm_pipeline_depth`` of them in flight per peer through the
existing ``mem_register``/``get_part`` one-sided vtable, and lands bytes
at their offsets into ONE preallocated
:class:`~parsec_tpu_torch.data.arena.BytePool` slot — so an N-rank
allreduce of a large tile streams at ring bandwidth (each rank moves
~2·nbytes/N per step, all links busy) instead of gather-reduce-rebroadcast
through one root.

Algorithms (MCA ``runtime_coll_algo``):

* ``ring`` (default) — reduce-scatter + allgather pipeline, 2(N-1)
  steps, memory-lean (one landing block + one staging block beyond the
  accumulator), bandwidth-optimal for large payloads;
* ``rd`` — recursive doubling, log2(N) full-buffer exchanges
  (power-of-two groups; falls back to ring otherwise), latency-optimal
  for small payloads;
* ``gather`` — the naive gather-reduce-rebroadcast baseline (root pulls
  every contribution, reduces, re-broadcasts).  Kept selectable so the
  ring can be measured against it honestly.

Contributions and results.  A numpy contribution reduces with the
matching numpy ufunc and its result is an ndarray view of the op's pool
slot, as in the reference.  A torch tensor contribution is copied into
the slot once (a CUDA tensor's device-to-host copy is counted in
``stats["bytes_d2h"]``), and every combine is a torch elementwise op
(``add``, ``mul``, ``maximum``, ``minimum``) on the contribution's own
device, over the accumulator block and the landed block (their copies to
and back from the card counted in ``bytes_h2d``/``bytes_d2h``); each
combine counts under the reference's ``stats["jit_reduces"]``.  Its
result is a tensor on that device (a CUDA result is copied back to the
card once).  A bfloat16 tensor travels as its raw bits and combines as a
bfloat16 torch op on a view of the slot: numpy has no bfloat16, and a
ufunc on the ``uint16`` bits would sum them as integers.  Where the
reference jits its combiner through the context's compile cache and falls
back to the host ufunc when the jitted combine fails, the port needs no
cache for a torch op and has no fallback: a failed combine fails the op
on every rank.

Wire discipline:

* control messages (block adverts, acks) ride the shared ``TAG_CTL``
  channel (op ``"coll"``) at MCA ``runtime_coll_priority`` (default -1:
  BELOW dependency activations, so bulk collectives never starve the
  critical path) and are counted by distributed termination detection on
  both sides like any app message — a collective embedded in a taskpool
  (:class:`~parsec_tpu_torch.dsl.collective.CollectiveTask`) is
  termdet-safe because the task itself retires only at collective
  completion;
* block payloads move by chunked one-sided pulls (consume-on-fin
  use accounting, exactly like the rendezvous data plane), and every
  block fires ``pins.HB_FRAME_SEND``/``HB_FRAME_DELIVER`` with a
  deterministic frame id so ``tools hbcheck`` orders collective
  completions across ranks even on fabrics whose one-sided path
  bypasses AM frames (inproc table serves).

:class:`RedistOp` reuses the same endpoint for memory-bounded
redistribution: per-destination region batches staged under a byte
budget, moved in linear-shift rounds with single-slot admission on the
receive side, in the style of "Memory-efficient array redistribution
through portable collective communication" (PAPERS.md) — peak extra
memory per rank stays under ``runtime_redistribute_mem_budget``.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.arena import ByteBudget, BytePool
from ..data.data import ready_event
from ..profiling import jobtrace, pins
from ..utils import debug, mca_param
from .engine import TAG_CTL

__all__ = ["CollManager", "CollOp", "RedistOp", "CollError", "REDUCERS"]

#: host-side reducers (in-place capable numpy ufuncs)
REDUCERS: Dict[str, Any] = {
    "sum": np.add,
    "prod": np.multiply,
    "max": np.maximum,
    "min": np.minimum,
}

#: the torch elementwise combiners of tensor contributions (``out=``
#: capable), by op name — the reference's jitted ``_JIT_EXPRS``
TORCH_REDUCERS: Dict[str, Callable] = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


class CollError(RuntimeError):
    """A collective failed (peer error, lost segment, bad arguments)."""


def _cid_key(cid) -> Any:
    """Canonical hashable form of a collective id after a wire round
    trip (list containers come back as lists on some paths)."""
    if isinstance(cid, (list, tuple)):
        return tuple(_cid_key(c) for c in cid)
    return cid


def _cid_token(cid) -> int:
    """Deterministic 63-bit trace token for a collective id (stable
    across processes — ``hash()`` is seeded per interpreter)."""
    h = hashlib.blake2b(repr(_cid_key(cid)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") & 0x7FFFFFFFFFFFFFFF


def _frame_id(cid, src_rank: int, skey) -> int:
    """Deterministic frame id for one collective block transfer, keyed
    by (cid, ORIGIN rank, staging key): both endpoints derive the SAME
    id — the receiver reads the sender's ``skey`` off the advert — so
    the hb checker can pair the sender-side HB_FRAME_SEND with the
    receiver-side HB_FRAME_DELIVER even though these blocks move over
    the one-sided path (which never enters the AM frame machinery on
    table-served fabrics).  The origin rank is part of the key because
    ring peers stage the same step index under one cid."""
    h = hashlib.blake2b(
        repr((_cid_key(cid), int(src_rank), _cid_key(skey))).encode(),
        digest_size=8)
    return int.from_bytes(h.digest(), "big") & 0x7FFFFFFFFFFFFFFF


def _elem_bounds(total: int, itemsize: int, n: int) -> List[int]:
    """Byte offsets of the n-way element partition of a flat array
    (itemsize-aligned, non-dividing sizes allowed: trailing parts may be
    smaller or empty)."""
    return [(k * total // n) * itemsize for k in range(n + 1)]


class _SegPull:
    """Pipelined chunked pull of one collective block into a
    caller-provided landing view (a byte range of the op's single
    preallocated pool slot).  Same iterative pump discipline as the
    rendezvous ``_RdvPull`` — synchronous fabrics cannot recurse, cross-
    thread completions cannot strand the window."""

    __slots__ = ("op", "src", "handle", "nbytes", "dst", "key", "prio",
                 "chunk", "nchunks", "next_off", "recvd", "inflight",
                 "failed", "finished", "_lock", "_pumping")

    def __init__(self, op: "_BaseOp", src: int, handle, nbytes: int,
                 dst: np.ndarray, *, key, priority: int):
        self.op = op
        self.src = src
        self.handle = handle
        self.nbytes = int(nbytes)
        self.dst = dst
        self.key = key
        self.prio = priority
        self.chunk = max(1, int(op.mgr.segment))
        self.nchunks = max(1, -(-self.nbytes // self.chunk))
        self.next_off = 0
        self.recvd = 0
        self.inflight = 0
        self.failed = False
        self.finished = False
        self._lock = threading.Lock()
        self._pumping = False
        self.pump()

    def pump(self) -> None:
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
                             and self.inflight < self.op.mgr.pipeline_depth)
            if not again:
                return

    def _fill_window(self) -> None:
        while True:
            with self._lock:
                if (self.failed or self.finished
                        or self.next_off >= self.nbytes
                        or self.inflight >= self.op.mgr.pipeline_depth):
                    return
                off = self.next_off
                ln = min(self.chunk, self.nbytes - off)
                self.next_off = off + ln
                self.inflight += 1
                fin = self.next_off >= self.nbytes
            idx = off // self.chunk
            self.op.mgr.stats["seg_req"] += 1
            try:
                self.op.mgr.ce.get_part(
                    self.src, self.handle, off, ln,
                    lambda buf, off=off, ln=ln, idx=idx:
                        self.on_chunk(buf, off, ln, idx),
                    fin=fin, priority=self.prio)
            except Exception as e:  # inproc raises synchronously
                debug.error("coll segment %d of %r from rank %d raised: %s",
                            idx, self.handle, self.src, e)
                self.on_chunk(None, off, ln, idx)

    def on_chunk(self, buf, off: int, ln: int, idx: int) -> None:
        finish = None
        with self._lock:
            self.inflight -= 1
            if self.failed or self.finished:
                # a sibling of an already-failed (or raced-finished)
                # pull: account it so segments_in_flight drains to 0
                self.op.mgr.stats["seg_failed"] += 1
                return
            if buf is None:
                self.failed = True
                finish = "fail"
            else:
                self.dst[off:off + ln] = np.frombuffer(
                    memoryview(buf), np.uint8, count=ln)
                self.recvd += ln
                if self.recvd >= self.nbytes:
                    self.finished = True
                    finish = "done"
        if finish == "fail":
            self.op.mgr.stats["seg_failed"] += 1
            # consume our use of the registration with a zero-length fin
            # read so the sender's use count drains (rendezvous
            # discipline: chunking must not leak where one GET didn't)
            try:
                self.op.mgr.ce.get_part(self.src, self.handle, 0, 0,
                                        lambda _b: None, fin=True)
            except Exception:
                pass
            # symptom, not cause: defer so the origin's "err" notice
            # (already in flight when its staging teardown broke this
            # pull) supplies the root-cause reason — see _fail_deferred
            self.op._fail_deferred(
                f"segment pull of {self.handle!r} from rank "
                f"{self.src} failed")
            return
        self.op.mgr.stats["seg_done"] += 1
        self.op.mgr.stats["bytes_landed"] += ln
        if pins.active(pins.COLL_SEG):
            pins.fire(pins.COLL_SEG, None,
                      {"rank": self.op.mgr.ce.rank, "peer": self.src,
                       "bytes": ln, "id": self.op.token,
                       "seg": idx, "nsegs": self.nchunks,
                       "trace": self.op.trace})
        if finish == "done":
            self.op._block_landed(self.key, self.src)
            return
        self.pump()


class _BaseOp:
    """State shared by every collective kind: group geometry, the single
    landing/accumulator pool slot, staging registration bookkeeping,
    completion/failure signalling, pins spans."""

    kind = "coll"

    def __init__(self, mgr: "CollManager", cid, group: List[int],
                 *, priority: Optional[int] = None):
        self.mgr = mgr
        self.ce = mgr.ce
        self.cid = _cid_key(cid)
        self.token = _cid_token(self.cid)
        self.group = list(group)
        self.N = len(self.group)
        try:
            self.i = self.group.index(self.ce.rank)
        except ValueError:
            raise CollError(
                f"rank {self.ce.rank} is not in collective group "
                f"{self.group}")
        self.priority = (mgr.priority if priority is None else int(priority))
        #: job trace context (profiling.jobtrace): a collective issued
        #: from inside a task body inherits the running job's trace id
        #: off the worker thread (dsl.CollectiveTask's rendezvous shape),
        #: so its spans land in the job's merged timeline; standalone
        #: API calls carry 0
        self.trace = jobtrace.current()
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self.done = False
        self.failed = False
        self.fail_reason: Optional[str] = None
        #: (reason, deadline) of a deferred local failure — see
        #: :meth:`_fail_deferred`
        self._pending_fail: Optional[Tuple[str, float]] = None
        self._result = None
        #: holders (pool-slot views) kept alive until the op dies
        self._holders: List[Any] = []
        #: overall-send-index -> (handle, staging DataCopy or None)
        self._staged: Dict[Any, Any] = {}
        self.t0 = time.perf_counter()
        self.total_bytes = 0
        #: the contribution's torch device (None: a numpy contribution)
        self.tdev: Optional[torch.device] = None
        self._src = None

    # -- the contribution --------------------------------------------------
    def _take(self, arr) -> None:
        """Record the contribution's shape, dtype and home (where the
        reference runs ``np.asarray``, which would copy a CUDA tensor to
        the host in silence or fail on it): a numpy dtype for a host
        array, the torch dtype and device for a tensor.  Its bytes enter
        the op's slot only through :meth:`_load`."""
        if isinstance(arr, torch.Tensor):
            t = arr.detach()
            self.tdev = t.device
            self.dtype = t.dtype
            self.itemsize = t.element_size()
            self.shape = tuple(t.shape)
            self.size = t.numel()
        else:
            t = np.ascontiguousarray(np.asarray(arr))
            self.dtype = t.dtype
            self.itemsize = t.dtype.itemsize
            self.shape = t.shape
            self.size = t.size
        self._src = t

    def _load(self, dst: np.ndarray) -> None:
        """Write the contribution's bytes into ``dst`` (a uint8 byte range
        of the op's slot, exactly its size).  A CUDA tensor is copied home
        once, behind its ready event when it has one, and counted in
        ``stats["bytes_d2h"]``."""
        src, self._src = self._src, None
        if self.tdev is None:
            dst[:] = src.reshape(-1).view(np.uint8)
            return
        if src.is_cuda:
            ev = ready_event(src)
            if ev is not None:
                torch.cuda.current_stream(src.device).wait_event(ev)
            self.mgr.stats["bytes_d2h"] += int(dst.nbytes)
        torch.from_numpy(dst).view(self.dtype).copy_(src.reshape(-1))

    def _view(self, buf: np.ndarray, off: int, nbytes: int):
        """Elements of ``nbytes`` bytes at byte ``off`` of the uint8
        buffer ``buf``, aliased: an ndarray, or a CPU tensor for a tensor
        contribution (bfloat16 included).  The view holds ``buf`` itself
        alive (through a memoryview of it, as the reference's result
        does): the slot goes back to its pool only when ``buf``, the op's
        holder, dies — a slice of it would pin only the pool's buffer."""
        if self.tdev is None:
            return np.frombuffer(memoryview(buf), self.dtype,
                                 count=nbytes // self.itemsize, offset=off)
        return torch.from_numpy(np.frombuffer(
            memoryview(buf), np.uint8, count=nbytes, offset=off)).view(self.dtype)

    def _home(self, flat, shape=None):
        """A result in the contribution's form: a host array for a host
        contribution, a tensor on the contribution's device for a tensor
        (a CUDA result is copied back once, counted in ``bytes_h2d``)."""
        out = flat if shape is None else flat.reshape(shape)
        if self.tdev is not None and self.tdev.type != "cpu":
            self.mgr.stats["bytes_h2d"] += int(out.numel() * self.itemsize)
            out = out.to(self.tdev)
        return out

    def _combine(self, acc_v, inc_v) -> bool:
        """``acc_v = op(acc_v, inc_v)`` in place, over two views of
        :meth:`_view`: the numpy ufunc for a host contribution; for a
        tensor the manager's torch combiner on the contribution's device,
        counted under ``stats["jit_reduces"]``.  A failed torch combine
        fails the op on every rank (False): there is no host fallback."""
        if self.tdev is None:
            self.reducer(acc_v, inc_v, out=acc_v)
            return True
        try:
            fn = self.mgr._torch_combiner(self.op_name)
            if self.tdev.type == "cpu":
                fn(acc_v, inc_v, out=acc_v)
            else:
                a = acc_v.to(self.tdev)
                fn(a, inc_v.to(self.tdev), out=a)
                acc_v.copy_(a)
                nb = int(acc_v.numel() * self.itemsize)
                self.mgr.stats["bytes_h2d"] += 2 * nb
                self.mgr.stats["bytes_d2h"] += nb
        except Exception as e:
            self._fail(f"device combine ({self.op_name}) on {self.tdev} "
                       f"failed: {e}")
            return False
        self.mgr.stats["jit_reduces"] += 1
        return True

    # -- lifecycle --------------------------------------------------------
    def _begin(self, nbytes: int) -> None:
        """First post-validation step of every subclass constructor —
        the op only counts as started here, so a constructor CollError
        (unknown reducer, rank outside the group) cannot skew the
        ops_inflight gauge forever."""
        self.total_bytes = int(nbytes)
        self.mgr.stats["ops_started"] += 1
        self.mgr.stats[f"ops_{self.kind}"] += 1
        if pins.active(pins.COLL_BEGIN):
            pins.fire(pins.COLL_BEGIN, None,
                      {"rank": self.ce.rank, "id": self.token,
                       "kind": self.kind, "bytes": int(nbytes),
                       "nranks": self.N, "cid": repr(self.cid),
                       "trace": self.trace})

    def _finish(self, result) -> None:
        """Terminal success transition (any thread)."""
        with self._lock:
            if self.done or self.failed:
                return
            self._result = result
            self.done = True
            self._cv.notify_all()
        self.mgr.stats["ops_done"] += 1
        self.mgr.unbind(self.cid)
        self._release_staging()
        if pins.active(pins.COLL_END):
            pins.fire(pins.COLL_END, None,
                      {"rank": self.ce.rank, "id": self.token,
                       "kind": self.kind, "bytes": self.total_bytes,
                       "seconds": time.perf_counter() - self.t0,
                       "trace": self.trace})

    def _fail(self, why: str, notify_peers: bool = True) -> None:
        with self._lock:
            if self.done or self.failed:
                return
            self.failed = True
            self.fail_reason = why
            self._cv.notify_all()
        debug.error("collective %r on rank %d failed: %s",
                    self.cid, self.ce.rank, why)
        self.mgr.stats["ops_failed"] += 1
        self.mgr.unbind(self.cid)
        self._release_staging()
        if pins.active(pins.COLL_END):
            pins.fire(pins.COLL_END, None,
                      {"rank": self.ce.rank, "id": self.token,
                       "kind": self.kind, "bytes": self.total_bytes,
                       "failed": True,
                       "seconds": time.perf_counter() - self.t0,
                       "trace": self.trace})
        if notify_peers:
            msg = {"op": "coll", "kind": "err", "cid": self.cid,
                   "why": why}
            for r in self.group:
                if r != self.ce.rank:
                    try:
                        self.ce.send_am(TAG_CTL, r, dict(msg),
                                        priority=self.priority)
                    except Exception:
                        pass  # a dead peer cannot mask the local failure

    def _fail_deferred(self, why: str) -> None:
        """Record a LOCAL failure whose root cause lives on a peer.

        A failed segment pull is almost always a *symptom*: the origin
        rank tore down its staging registration inside its own
        ``_fail``, whose very next step notifies every peer with the
        root-cause reason ("advert mismatch ...").  Failing immediately
        here races that in-flight "err" notice — whichever rank's pull
        tripped first would raise the generic pull message instead of
        the origin's reason (the allgather-fails-loudly
        flake).  So: park the generic reason with a grace deadline and
        keep the op bound; the peer's "err" fails the op with the real
        reason via ``on_msg``, and only a genuinely silent peer (died
        without notifying) lets the deadline expire — ``wait()`` then
        applies the parked reason, preserving liveness."""
        with self._lock:
            if self.done or self.failed or self._pending_fail is not None:
                return
            self._pending_fail = (why, time.monotonic() + self.mgr.err_grace)
            self._cv.notify_all()
        debug.verbose(2, "coll",
                      "collective %r on rank %d: deferring local failure "
                      "(%s) for a peer's root-cause notice", self.cid,
                      self.ce.rank, why)

    def _check_pending_fail(self) -> None:
        """Apply an expired deferred failure (called from wait())."""
        with self._lock:
            pf = self._pending_fail
            if pf is None or self.done or self.failed:
                return
            if time.monotonic() < pf[1]:
                return
        self._fail(pf[0])

    def _bind(self) -> None:
        """Bind this op to the endpoint, accounting a duplicate-cid
        refusal as a failed op first (ops_started already counted in
        ``_begin``; without the ``_fail`` the ops_inflight gauge would
        read a wedged collective forever, and any staging registered
        before the bind — _RDOp stages step 0 first by design — would
        leak)."""
        try:
            self.mgr.bind(self.cid, self)
        except CollError as e:
            self._fail(str(e), notify_peers=False)
            raise

    def _release_staging(self) -> None:
        with self._lock:
            staged, self._staged = self._staged, {}
        for handle, slot in staged.values():
            try:
                self.ce.mem_unregister(handle)
            except Exception:
                pass
            if slot is not None:
                try:
                    slot.arena.release(slot)
                except Exception:
                    pass

    # -- wire helpers -----------------------------------------------------
    def _send_ctl(self, dst_rank: int, msg: dict) -> None:
        msg = dict(msg)
        msg["op"] = "coll"
        msg["cid"] = self.cid
        self.ce.send_am(TAG_CTL, dst_rank, msg, priority=self.priority)

    def _stage_send(self, skey, src_bytes: np.ndarray, dst_rank: int,
                    adv: dict, *, uses: int = 1, copy: bool = True) -> None:
        """Register ``src_bytes`` (copied into a staging slot unless the
        caller guarantees stability) under a handle derived from
        ``skey``, fire the HB send edge, and advertise to ``dst_rank``
        (``adv`` gains handle/nbytes).  The registration + staging slot
        are reclaimed on ack (or at op teardown)."""
        handle = ("coll", self.cid, skey)
        nbytes = int(src_bytes.nbytes)
        slot = None
        if copy and nbytes:
            slot = self.mgr.pool.allocate(nbytes)
            view = slot.payload[:nbytes]
            view[:] = src_bytes
            reg = view
        else:
            reg = src_bytes
        with self._lock:
            self._staged[skey] = (handle, slot)
        self.ce.mem_register(handle, reg, uses=uses)
        if pins.active(pins.HB_FRAME_SEND):
            pins.fire(pins.HB_FRAME_SEND, None,
                      {"rank": self.ce.rank, "peer": dst_rank,
                       "frame": _frame_id(self.cid, self.ce.rank, skey)})
        adv = dict(adv)
        adv["handle"] = handle
        adv["nbytes"] = nbytes
        adv["skey"] = skey  # receivers ack exactly this staging key
        self._send_ctl(dst_rank, adv)
        self.mgr.stats["blocks_sent"] += 1

    def _ack(self, dst_rank: int, skey) -> None:
        self._send_ctl(dst_rank, {"kind": "ack", "skey": skey})
        self.mgr.stats["acks_sent"] += 1

    def _on_ack(self, skey) -> None:
        """Reclaim the staging registration for one acked send."""
        with self._lock:
            entry = self._staged.pop(_cid_key(skey), None)
        if entry is not None:
            handle, slot = entry
            if slot is not None:
                try:
                    slot.arena.release(slot)
                except Exception as e:  # pragma: no cover - diagnostics
                    debug.error("coll staging release failed: %s", e)

    def _deliver_edge(self, skey, src_rank: int) -> None:
        """Fire the delivery half of one block's hb pair.  ``skey`` must
        be the SENDER's staging key (read off the advert), never the
        local pull key — the ids would not pair otherwise."""
        if pins.active(pins.HB_FRAME_DELIVER):
            pins.fire(pins.HB_FRAME_DELIVER, None,
                      {"rank": self.ce.rank, "peer": src_rank,
                       "frame": _frame_id(self.cid, src_rank, skey)})

    # -- to be provided by subclasses ------------------------------------
    def on_msg(self, src_rank: int, msg: dict) -> None:
        raise NotImplementedError

    def _block_landed(self, key, src_rank: int) -> None:
        raise NotImplementedError

    # -- public surface ---------------------------------------------------
    def state(self) -> str:
        """One-line progress description (watchdog stall diagnosis)."""
        return f"{self.kind} cid={self.cid!r} group={self.group}"

    def result(self):
        with self._lock:
            if self.failed:
                raise CollError(
                    f"collective {self.cid!r} failed: {self.fail_reason}")
            if not self.done:
                raise CollError(
                    f"collective {self.cid!r} still in flight "
                    "(wait() it first)")
            return self._result

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drive local progress until the collective completes.  Returns
        True on success, False on timeout; raises :class:`CollError` on
        failure.  Safe to call from a worker thread (it pumps the comm
        engine itself, like a DTD window drain)."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        # engines with their own funnelled progress thread (TCP) complete
        # us from that thread: sleep on the condvar, don't spin-pump — a
        # per-rank 0.5 ms poll loop measurably starves the comm threads
        # on oversubscribed hosts.  Pump-driven fabrics (inproc) need the
        # caller's pump, tightly.
        self_prog = bool(getattr(self.ce, "self_progressing", False))
        while True:
            self._check_pending_fail()
            with self._lock:
                if self.failed:
                    raise CollError(
                        f"collective {self.cid!r} failed: "
                        f"{self.fail_reason}")
                if self.done:
                    return True
                if deadline is not None and time.monotonic() > deadline:
                    return False
                if self_prog:
                    self._cv.wait(0.05)
                    continue
            moved = 0
            try:
                moved = self.ce.progress_nonblocking()
            except Exception as e:  # pragma: no cover - engine teardown
                debug.verbose(3, "coll", "progress raised in wait: %s", e)
            if moved:
                continue  # a delivered message usually legalizes the
                # next ring step — repump NOW, don't park the chain
                # behind the poll interval
            with self._lock:
                if not (self.done or self.failed):
                    self._cv.wait(0.0005)


class _RingOp(_BaseOp):
    """Segmented ring allreduce / reduce-scatter / allgather.

    Overall step index k counts completed receive steps; send k's block
    content is ready exactly when receive k-1 combined (k=0: the local
    contribution), so sends self-clock off the ring with no barrier.  A
    two-deep ack window bounds staging memory to <= 2 blocks; the
    accumulator and landing area live in ONE pool slot."""

    def __init__(self, mgr, cid, group, arr, *, op="sum", kind="allreduce",
                 priority=None):
        super().__init__(mgr, cid, group, priority=priority)
        self.kind = kind
        self.op_name = op
        self.reducer = REDUCERS.get(op)
        if kind != "allgather" and self.reducer is None:
            raise CollError(f"unknown reduction op {op!r} "
                            f"(have {sorted(REDUCERS)})")
        self._take(arr)
        if kind == "allgather":
            # contribution is this rank's block; result is N blocks
            self.block_elems = self.size
            total = self.size * self.N
            self.out_shape = (self.N * (self.shape[0] if self.shape else 1),
                              ) + tuple(self.shape[1:])
        else:
            total = self.size
            self.out_shape = self.shape
        self.total_elems = total
        self.bounds = _elem_bounds(total, self.itemsize, self.N)
        self.nbytes = total * self.itemsize
        # ONE preallocated slot: accumulator + (for reduce phases) a
        # landing block appended at the tail
        land_max = max((self.bounds[k + 1] - self.bounds[k]
                        for k in range(self.N)), default=0)
        self.land_off = self.nbytes
        slot_bytes = self.nbytes + (land_max if kind != "allgather" else 0)
        self.slot = mgr.pool.allocate(max(1, slot_bytes))
        holder = self.slot.payload[:max(1, slot_bytes)]
        weakref.finalize(holder, self.slot.arena.release, self.slot)
        self.acc = holder
        self._holders.append(holder)
        if kind == "allgather":
            # ragged groups surface at advert time ("advert mismatch"):
            # each rank's bounds derive from its OWN contribution, so a
            # differently-shaped peer advertises block sizes this rank
            # does not expect and every rank's wait() raises CollError
            b0, b1 = self.bounds[self.i], self.bounds[self.i + 1]
            self._load(self.acc[b0:b1])
        else:
            self._load(self.acc[:self.nbytes])
        self.total_steps = self.N - 1 if kind in ("reduce_scatter",
                                                  "allgather") \
            else 2 * (self.N - 1)
        self.recv_done = 0
        self.send_next = 0
        self.acks_recv = 0
        self.window = 2
        self._pending_adv: Dict[int, Tuple[int, dict]] = {}
        self._begin(self.nbytes)
        if self.N == 1 or self.nbytes == 0:
            self._finish(self._make_result())
            return
        self._bind()
        self._advance()

    # -- geometry ---------------------------------------------------------
    def _phase_of(self, k: int) -> str:
        if self.kind == "allgather":
            return "ag"
        if self.kind == "reduce_scatter":
            return "rs"
        return "rs" if k < self.N - 1 else "ag"

    def _send_block(self, k: int) -> int:
        if self._phase_of(k) == "rs":
            return (self.i - k - 1) % self.N
        s = k if self.kind == "allgather" else k - (self.N - 1)
        return (self.i - s) % self.N

    def _recv_block(self, k: int) -> int:
        if self._phase_of(k) == "rs":
            return (self.i - k - 2) % self.N
        s = k if self.kind == "allgather" else k - (self.N - 1)
        return (self.i - s - 1) % self.N

    def _block_bytes(self, b: int) -> int:
        return self.bounds[b + 1] - self.bounds[b]

    # -- the self-clocked engine ------------------------------------------
    def _advance(self) -> None:
        """Issue every currently-legal action (sends, pending landings).
        Decisions under the lock, wire IO outside it."""
        while True:
            actions: List[Tuple[str, Any]] = []
            with self._lock:
                if self.done or self.failed:
                    return
                # sends: self-clocked by completed receives + ack window
                while (self.send_next < self.total_steps
                       and self.send_next <= self.recv_done
                       and self.send_next - self.acks_recv < self.window):
                    k = self.send_next
                    self.send_next += 1
                    actions.append(("send", k))
                # receive k: the expected advert may already be parked
                k = self.recv_done
                if k < self.total_steps:
                    blk = self._recv_block(k)
                    if self._block_bytes(blk) == 0:
                        # empty partition block: nothing crosses the wire
                        self.recv_done += 1
                        actions.append(("noop", k))
                    elif k in self._pending_adv:
                        src, adv = self._pending_adv.pop(k)
                        actions.append(("pull", (k, src, adv)))
                if not actions:
                    done = (self.recv_done >= self.total_steps
                            and self.acks_recv >= self.total_steps)
            if not actions:
                if done:
                    self._finish(self._make_result())
                return
            for what, arg in actions:
                if what == "send":
                    self._do_send(arg)
                elif what == "pull":
                    k, src, adv = arg
                    self._do_pull(k, src, adv)
            # loop: a completed action may have legalized more

    def _do_send(self, k: int) -> None:
        blk = self._send_block(k)
        b0, b1 = self.bounds[blk], self.bounds[blk + 1]
        right = self.group[(self.i + 1) % self.N]
        if b1 == b0:  # empty block: its ack is implicit
            with self._lock:
                self.acks_recv += 1
            return
        # zero-copy registration: a sent block is stable by construction
        # until the peer consumed it — combines only ever write blocks
        # (i-k'-2) for k' >= k and allgather lands only write the recv
        # block of the step, never a block inside the 2-deep ack window
        self._stage_send(k, self.acc[b0:b1], right,
                         {"kind": "adv", "k": k, "blk": blk}, copy=False)

    def _do_pull(self, k: int, src: int, adv: dict) -> None:
        blk = self._recv_block(k)
        b0, b1 = self.bounds[blk], self.bounds[blk + 1]
        if int(adv["nbytes"]) != b1 - b0 or int(adv["blk"]) != blk:
            self._fail(f"ring step {k}: advert mismatch (block "
                       f"{adv['blk']}/{adv['nbytes']}B, expected "
                       f"{blk}/{b1 - b0}B)")
            return
        if self._phase_of(k) == "rs":
            dst = self.acc[self.land_off:self.land_off + (b1 - b0)]
        else:  # allgather lands in place, zero extra copies
            dst = self.acc[b0:b1]
        _SegPull(self, src, adv["handle"], b1 - b0, dst,
                 key=k, priority=self.priority)

    def _block_landed(self, key, src_rank: int) -> None:
        k = key
        blk = self._recv_block(k)
        b0, b1 = self.bounds[blk], self.bounds[blk + 1]
        if self._phase_of(k) == "rs" and not self._combine(
                self._view(self.acc, b0, b1 - b0),
                self._view(self.acc, self.land_off, b1 - b0)):
            return
        self._deliver_edge(k, src_rank)
        left = self.group[(self.i - 1) % self.N]
        self._ack(left, k)
        with self._lock:
            self.recv_done += 1
        self._advance()

    def _make_result(self):
        if self.kind == "reduce_scatter":
            b0, b1 = self.bounds[self.i], self.bounds[self.i + 1]
            return self._home(self._view(self.acc, b0, b1 - b0))
        flat = self._view(self.acc, 0, self.nbytes)
        try:
            return self._home(flat, self.out_shape)
        except (ValueError, RuntimeError):  # ragged allgather head: flat
            return self._home(flat)

    # -- messages ---------------------------------------------------------
    def on_msg(self, src_rank: int, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "adv":
            with self._lock:
                self._pending_adv[int(msg["k"])] = (src_rank, msg)
            self._advance()
        elif kind == "ack":
            self._on_ack(msg["skey"])
            with self._lock:
                self.acks_recv += 1
            self._advance()
        elif kind == "err":
            self._fail(f"peer rank {src_rank}: {msg.get('why', '?')}",
                       notify_peers=False)

    def state(self) -> str:
        with self._lock:
            return (f"{self.kind}[ring] cid={self.cid!r} "
                    f"step {self.recv_done}/{self.total_steps} recvd, "
                    f"{self.acks_recv}/{self.total_steps} acked")


class _RDOp(_BaseOp):
    """Recursive-doubling allreduce: log2(N) full-buffer exchanges.
    Power-of-two groups only (the manager falls back to ring otherwise).
    Lockstep per step: advance when our pull combined AND our send
    acked."""

    kind = "allreduce"

    def __init__(self, mgr, cid, group, arr, *, op="sum", priority=None):
        super().__init__(mgr, cid, group, priority=priority)
        self.op_name = op
        self.reducer = REDUCERS.get(op)
        if self.reducer is None:
            raise CollError(f"unknown reduction op {op!r}")
        self._take(arr)
        self.nbytes = self.size * self.itemsize
        self.nsteps = max(1, (self.N - 1).bit_length())
        self.slot = mgr.pool.allocate(max(1, 2 * self.nbytes))
        holder = self.slot.payload[:max(1, 2 * self.nbytes)]
        weakref.finalize(holder, self.slot.arena.release, self.slot)
        self.acc = holder
        self._holders.append(holder)
        self._load(self.acc[:self.nbytes])
        self.step = 0
        self.landed = False
        self.acked = False
        self._pending_adv: Dict[int, Tuple[int, dict]] = {}
        self._begin(self.nbytes)
        if self.N == 1 or self.nbytes == 0:
            self._finish(self._make_result())
            return
        # stage step 0's send BEFORE binding: bind replays parked
        # adverts, and on a synchronous fabric the replayed pull combines
        # the peer's contribution into the accumulator immediately — a
        # send staged after that would double-count it at the peer
        self._issue_step()
        self._bind()
        self._try_pull()

    def _peer(self, t: int) -> int:
        return self.group[self.i ^ (1 << t)]

    def _issue_step(self) -> None:
        t = self.step
        peer = self._peer(t)
        self._stage_send(("rd", t), self.acc[:self.nbytes], peer,
                         {"kind": "adv", "k": t})
        self._try_pull()

    def _try_pull(self) -> None:
        with self._lock:
            ent = self._pending_adv.pop(self.step, None)
        if ent is None:
            return
        src, adv = ent
        if int(adv["nbytes"]) != self.nbytes:
            self._fail(f"rd step {self.step}: size mismatch "
                       f"({adv['nbytes']} != {self.nbytes})")
            return
        _SegPull(self, src, adv["handle"], self.nbytes,
                 self.acc[self.nbytes:2 * self.nbytes],
                 key=("rd", self.step), priority=self.priority)

    def _block_landed(self, key, src_rank: int) -> None:
        if not self._combine(self._view(self.acc, 0, self.nbytes),
                             self._view(self.acc, self.nbytes, self.nbytes)):
            return
        self._deliver_edge(key, src_rank)
        self._ack(src_rank, key)
        with self._lock:
            self.landed = True
        self._maybe_advance()

    def on_msg(self, src_rank: int, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "adv":
            with self._lock:
                self._pending_adv[int(msg["k"])] = (src_rank, msg)
            self._try_pull()
        elif kind == "ack":
            self._on_ack(msg["skey"])
            with self._lock:
                self.acked = True
            self._maybe_advance()
        elif kind == "err":
            self._fail(f"peer rank {src_rank}: {msg.get('why', '?')}",
                       notify_peers=False)

    def _maybe_advance(self) -> None:
        with self._lock:
            if self.done or self.failed or not (self.landed and self.acked):
                return
            self.step += 1
            self.landed = self.acked = False
            final = self.step >= self.nsteps
        if final:
            self._finish(self._make_result())
        else:
            self._issue_step()

    def _make_result(self):
        return self._home(self._view(self.acc, 0, self.nbytes), self.shape)

    def state(self) -> str:
        with self._lock:
            return (f"allreduce[rd] cid={self.cid!r} step "
                    f"{self.step}/{self.nsteps}")


class _GatherOp(_BaseOp):
    """The naive gather-reduce-rebroadcast allreduce: every contribution
    funnels through group[0], which reduces and re-broadcasts.  O(N)
    full-payload transfers through one endpoint and N-1 simultaneous
    landing buffers at the root — kept as the honest bench baseline the
    ring is measured against.

    The root folds the contributions in group order, each as soon as it
    and every one before it have landed (the reference folds in arrival
    order), so the result's bits do not depend on which peer's pull
    finished first."""

    kind = "allreduce"

    def __init__(self, mgr, cid, group, arr, *, op="sum", priority=None):
        super().__init__(mgr, cid, group, priority=priority)
        self.op_name = op
        self.reducer = REDUCERS.get(op)
        if self.reducer is None:
            raise CollError(f"unknown reduction op {op!r}")
        self._take(arr)
        self.nbytes = self.size * self.itemsize
        self.root = self.group[0]
        self.is_root = self.i == 0
        self.slot = mgr.pool.allocate(max(1, self.nbytes))
        holder = self.slot.payload[:max(1, self.nbytes)]
        weakref.finalize(holder, self.slot.arena.release, self.slot)
        self.acc = holder
        self._holders.append(holder)
        self._load(self.acc[:self.nbytes])
        self.contribs = 0
        self.result_acks = 0
        self._land_slots: Dict[int, Any] = {}
        #: landed contributions waiting for their turn, and the group
        #: index of the next one to fold (the root's own is index 0)
        self._landed: Dict[int, Any] = {}
        self._next = 1
        self._fold_lock = threading.Lock()
        self._begin(self.nbytes)
        if self.N == 1 or self.nbytes == 0:
            self._finish(self._make_result())
            return
        self._bind()
        if not self.is_root:
            # zero-copy: a non-root contribution is never written again
            self._stage_send(("g", self.ce.rank), self.acc[:self.nbytes],
                             self.root, {"kind": "adv", "k": "g"},
                             copy=False)

    def on_msg(self, src_rank: int, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "adv" and msg.get("k") == "g" and self.is_root:
            slot = self.mgr.pool.allocate(max(1, self.nbytes))
            with self._lock:
                self._land_slots[src_rank] = slot
            _SegPull(self, src_rank, msg["handle"], self.nbytes,
                     slot.payload[:self.nbytes], key=("g", src_rank),
                     priority=self.priority)
        elif kind == "adv" and msg.get("k") == "r" and not self.is_root:
            with self._lock:
                self._result_skey = _cid_key(msg.get("skey"))
            _SegPull(self, src_rank, msg["handle"], self.nbytes,
                     self.acc[:self.nbytes], key=("r",),
                     priority=self.priority)
        elif kind == "ack":
            self._on_ack(msg["skey"])
            if self.is_root:
                with self._lock:
                    self.result_acks += 1
                    done = self.result_acks >= self.N - 1
                if done:
                    self._finish(self._make_result())
        elif kind == "err":
            self._fail(f"peer rank {src_rank}: {msg.get('why', '?')}",
                       notify_peers=False)

    def _block_landed(self, key, src_rank: int) -> None:
        if key == ("r",):  # non-root: result landed
            skey = getattr(self, "_result_skey", key)
            self._deliver_edge(skey, src_rank)
            self._ack(src_rank, skey)
            self._finish(self._make_result())
            return
        self._deliver_edge(key, src_rank)
        # root: one contribution landed — park it for its turn
        with self._lock:
            self._landed[src_rank] = self._land_slots.pop(src_rank)
        self._fold()

    def _fold(self) -> None:
        """Reduce every landed contribution whose turn has come, in group
        order (one folding thread at a time), dropping each buffer and
        acking its sender."""
        with self._fold_lock:
            while True:
                with self._lock:
                    if self.failed or self._next >= self.N:
                        return
                    src = self.group[self._next]
                    slot = self._landed.pop(src, None)
                    if slot is None:
                        return
                    self._next += 1
                ok = self._combine(self._view(self.acc, 0, self.nbytes),
                                   self._view(slot.payload, 0, self.nbytes))
                slot.arena.release(slot)
                if not ok:
                    return
                self._ack(src, ("g", src))
                with self._lock:
                    self.contribs += 1
                    ready = self.contribs >= self.N - 1
                if ready:
                    # zero-copy: the reduced result is final once all
                    # contribs are in — register the accumulator once per
                    # child
                    res = self.acc[:self.nbytes]
                    for r in self.group[1:]:
                        self._stage_send(("r", r), res, r,
                                         {"kind": "adv", "k": "r"},
                                         copy=False)

    def _make_result(self):
        return self._home(self._view(self.acc, 0, self.nbytes), self.shape)

    def state(self) -> str:
        with self._lock:
            return (f"allreduce[gather] cid={self.cid!r} root={self.root}"
                    f" contribs={self.contribs}/{self.N - 1} "
                    f"result_acks={self.result_acks}")


class _BcastOp(_BaseOp):
    """Binomial-tree broadcast: each receiver re-registers its landed
    bytes and forwards to its subtree (log2 N hops end-to-end; the root
    serves only its direct children)."""

    kind = "bcast"

    def __init__(self, mgr, cid, group, arr_or_template, *, root: int,
                 priority=None):
        super().__init__(mgr, cid, group, priority=priority)
        self.root = root
        ri = self.group.index(root)
        self.vi = (self.i - ri) % self.N
        self._take(arr_or_template)
        self.nbytes = self.size * self.itemsize
        self.slot = mgr.pool.allocate(max(1, self.nbytes))
        holder = self.slot.payload[:max(1, self.nbytes)]
        weakref.finalize(holder, self.slot.arena.release, self.slot)
        self.acc = holder
        self._holders.append(holder)
        if self.vi == 0:
            self._load(self.acc[:self.nbytes])
        else:
            self._src = None  # a template: only its shape and dtype count
        self.children = self._children()
        self.child_acks = 0
        self.have_data = self.vi == 0
        self._begin(self.nbytes)
        if self.N == 1 or self.nbytes == 0:
            self._finish(self._make_result())
            return
        self._bind()
        if self.have_data:
            self._forward()

    def _children(self) -> List[int]:
        out = []
        hb = 1
        while hb <= self.vi:
            hb <<= 1
        m = max(hb, 1) if self.vi else 1
        while self.vi + m < self.N:
            out.append(self.vi + m)
            m <<= 1
        return out

    def _forward(self) -> None:
        if not self.children:
            self._maybe_done()
            return
        data = self.acc[:self.nbytes]
        ri = self.group.index(self.root)
        for c in self.children:
            dst = self.group[(c + ri) % self.N]
            # zero-copy: acc is written exactly once (ctor at the root,
            # the landing pull elsewhere) before _forward runs and never
            # again — stable until every child consumed it
            self._stage_send(("b", self.vi, c), data, dst,
                             {"kind": "adv", "k": "b"}, copy=False)

    def on_msg(self, src_rank: int, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "adv" and msg.get("k") == "b":
            if int(msg["nbytes"]) != self.nbytes:
                self._fail(f"bcast size mismatch ({msg['nbytes']} != "
                           f"{self.nbytes})")
                return
            with self._lock:
                self._parent_skey = _cid_key(msg.get("skey"))
            _SegPull(self, src_rank, msg["handle"], self.nbytes,
                     self.acc[:self.nbytes], key=("b",),
                     priority=self.priority)
        elif kind == "ack":
            self._on_ack(msg["skey"])
            with self._lock:
                self.child_acks += 1
            self._maybe_done()
        elif kind == "err":
            self._fail(f"peer rank {src_rank}: {msg.get('why', '?')}",
                       notify_peers=False)

    def _block_landed(self, key, src_rank: int) -> None:
        skey = getattr(self, "_parent_skey", key)
        self._deliver_edge(skey, src_rank)
        self._ack(src_rank, skey)
        with self._lock:
            self.have_data = True
        self._forward()

    def _maybe_done(self) -> None:
        with self._lock:
            if not self.have_data or self.child_acks < len(self.children):
                return
        self._finish(self._make_result())

    def _make_result(self):
        return self._home(self._view(self.acc, 0, self.nbytes), self.shape)

    def state(self) -> str:
        with self._lock:
            return (f"bcast[binomial] cid={self.cid!r} root={self.root} "
                    f"have_data={self.have_data} acks="
                    f"{self.child_acks}/{len(self.children)}")


class RedistOp(_BaseOp):
    """Memory-bounded redistribution rounds (the redistribution-paper
    decomposition over our wire).

    ``sends[dst]`` is an ordered list of ``(meta, nbytes, fill)`` items;
    ``fill(dst_view)`` writes the region's bytes straight into the
    staging slot (no intermediate temporary).  Items are packed into
    batches whose slot capacity stays <= budget/2; destinations are
    walked in linear-shift order (round k -> rank ``(i + k) % N``) with a
    one-batch ack window, and the receive side admits ONE landing batch
    at a time — so peak extra memory per rank is one staging slot plus
    one landing slot <= ``budget`` (tracked exactly in ``budget_acct``).
    ``deliver(meta, view)`` scatters each landed region; ``expect_from``
    lists the source ranks that will send here (deterministically known
    to both sides from the distribution arithmetic)."""

    kind = "redistribute"

    def __init__(self, mgr, cid, group, *, sends, expect_from, deliver,
                 budget: int, priority=None):
        super().__init__(mgr, cid, group, priority=priority)
        self.deliver = deliver
        self.budget = int(budget)
        self.budget_acct = ByteBudget(self.budget)
        half = max(1, self.budget // 2)
        # largest power-of-two capacity fitting half the budget (pool
        # slots round up to powers of two: pack against CAPACITY so the
        # accounted peak respects the budget, not just the nominal bytes)
        self._batch_cap = 1 << max(BytePool.MIN_CLASS,
                                   (half.bit_length() - 1))
        if self._batch_cap > half:
            self._batch_cap >>= 1
        self._batches: Dict[int, List[List[Tuple[Any, int, Any]]]] = {}
        total_bytes = 0
        for dst, items in sends.items():
            batches: List[List[Tuple[Any, int, Any]]] = []
            cur: List[Tuple[Any, int, Any]] = []
            cur_bytes = 0
            for meta, nbytes, fill in items:
                total_bytes += int(nbytes)
                if nbytes > self._batch_cap:
                    self.mgr.stats["redist_oversize"] += 1
                if cur and cur_bytes + nbytes > self._batch_cap:
                    batches.append(cur)
                    cur, cur_bytes = [], 0
                cur.append((meta, int(nbytes), fill))
                cur_bytes += int(nbytes)
            if cur:
                batches.append(cur)
            if batches:
                self._batches[dst] = batches
        # linear-shift destination order relative to this rank
        order = sorted(self._batches,
                       key=lambda d: (self.group.index(d) - self.i)
                       % self.N)
        self._send_plan: List[Tuple[int, int]] = [
            (dst, bi) for dst in order
            for bi in range(len(self._batches[dst]))]
        self._send_pos = 0
        self._send_outstanding = False
        self._staged_cap: Dict[Any, int] = {}
        self._expect = set(expect_from)
        self._fins_recv: set = set()
        #: receive admission: one landing batch at a time
        self._landing = None
        self._land_queue: collections.deque = collections.deque()
        self._begin(total_bytes)
        self._bind()
        self._pump_send()
        self._check_done()

    # -- send side --------------------------------------------------------
    def _pump_send(self) -> None:
        while True:
            with self._lock:
                if (self.done or self.failed or self._send_outstanding
                        or self._send_pos >= len(self._send_plan)):
                    return
                dst, bi = self._send_plan[self._send_pos]
                self._send_pos += 1
                self._send_outstanding = True
                batch = self._batches[dst][bi]
                fin = bi == len(self._batches[dst]) - 1
            nbytes = sum(nb for _m, nb, _f in batch)
            slot = self.mgr.pool.allocate(max(1, nbytes))
            cap = slot.payload.nbytes
            self.budget_acct.acquire(cap)
            view = slot.payload[:nbytes]
            off = 0
            manifest = []
            for meta, nb, fill in batch:
                fill(view[off:off + nb])
                manifest.append((meta, nb))
                off += nb
            skey = ("r", dst, bi)
            handle = ("coll", self.cid, skey)
            with self._lock:
                self._staged[skey] = (handle, slot)
                self._staged_cap[skey] = cap  # capacity, for release
            self.ce.mem_register(handle, view, uses=1)
            if pins.active(pins.HB_FRAME_SEND):
                pins.fire(pins.HB_FRAME_SEND, None,
                          {"rank": self.ce.rank, "peer": dst,
                           "frame": _frame_id(self.cid, self.ce.rank,
                                              skey)})
            self._send_ctl(dst, {"kind": "radv", "skey": skey,
                                 "manifest": manifest, "nbytes": nbytes,
                                 "fin": fin, "handle": handle})
            self.mgr.stats["blocks_sent"] += 1
            return  # wait for the ack before staging the next batch

    # -- receive side -----------------------------------------------------
    def on_msg(self, src_rank: int, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "radv":
            with self._lock:
                self._land_queue.append((src_rank, msg))
            self._admit()
        elif kind == "ack":
            skey = _cid_key(msg["skey"])
            with self._lock:
                cap = self._staged_cap.pop(skey, 0)
            self._on_ack(skey)
            if cap:
                self.budget_acct.release(cap)
            with self._lock:
                self._send_outstanding = False
            self._pump_send()
            self._check_done()
        elif kind == "err":
            self._fail(f"peer rank {src_rank}: {msg.get('why', '?')}",
                       notify_peers=False)

    def _admit(self) -> None:
        with self._lock:
            if self._landing is not None or not self._land_queue:
                return
            src, msg = self._land_queue.popleft()
            nbytes = int(msg["nbytes"])
            slot = self.mgr.pool.allocate(max(1, nbytes))
            self._landing = (src, msg, slot)
        self.budget_acct.acquire(slot.payload.nbytes)
        if nbytes == 0:
            self._block_landed(("l",), src)
            return
        _SegPull(self, src, _cid_key(msg["handle"]), nbytes,
                 slot.payload[:nbytes], key=("l",), priority=self.priority)

    def _block_landed(self, key, src_rank: int) -> None:
        with self._lock:
            src, msg, slot = self._landing
        nbytes = int(msg["nbytes"])
        view = slot.payload[:nbytes]
        off = 0
        try:
            for meta, nb in msg["manifest"]:
                self.deliver(meta, view[off:off + nb])
                off += nb
        except Exception as e:
            self._fail(f"redistribute deliver failed: {e}")
            return
        self._deliver_edge(_cid_key(msg["skey"]), src_rank)
        cap = slot.payload.nbytes
        slot.arena.release(slot)
        self.budget_acct.release(cap)
        self._ack(src_rank, msg["skey"])
        with self._lock:
            self._landing = None
            if msg.get("fin"):
                self._fins_recv.add(src)
        self._admit()
        self._check_done()

    def _check_done(self) -> None:
        with self._lock:
            if self.done or self.failed:
                return
            if (self._send_pos >= len(self._send_plan)
                    and not self._send_outstanding
                    and not self._staged_cap
                    and self._fins_recv >= self._expect
                    and self._landing is None
                    and not self._land_queue):
                ready = True
            else:
                ready = False
        if ready:
            self._finish({"peak_extra_bytes": self.budget_acct.peak,
                          "budget": self.budget})

    def state(self) -> str:
        with self._lock:
            return (f"redistribute cid={self.cid!r} sends "
                    f"{self._send_pos}/{len(self._send_plan)}, fins "
                    f"{sorted(self._fins_recv)}/{sorted(self._expect)}, "
                    f"extra {self.budget_acct.now}B "
                    f"(peak {self.budget_acct.peak}B)")


class CollManager:
    """Per-rank collective endpoint bound to a comm engine.  Created on
    first use (``CommEngine.coll``); registers the ``"coll"`` control op
    immediately, so it must exist on every rank before the first
    collective message can arrive (context attach does this; bare-engine
    users touch ``ce.coll`` before exchanging)."""

    def __init__(self, ce):
        self.ce = ce
        self.algo = str(mca_param.register(
            "runtime", "coll_algo", "auto",
            choices=["auto", "ring", "rd", "gather"],
            help="collective algorithm: ring (segmented, bandwidth-"
                 "optimal) | rd (recursive doubling, power-of-two "
                 "groups) | gather (naive gather+bcast baseline) | auto"))
        seg = int(mca_param.register(
            "runtime", "coll_segment", 0,
            help="collective segment size in bytes (0 = follow "
                 "runtime_comm_rdv_chunk); each segment is one pipelined "
                 "one-sided chunk"))
        self.segment = seg if seg > 0 else int(getattr(
            ce, "rdv_chunk", 256 << 10))
        self.pipeline_depth = max(1, int(getattr(ce, "pipeline_depth", 4)))
        self.priority = int(mca_param.register(
            "runtime", "coll_priority", -1,
            help="send priority for collective control/data messages "
                 "(below 0 = after dependency activations in a shared "
                 "frame, so bulk collectives never starve the critical "
                 "path)"))
        self.err_grace = float(mca_param.register(
            "runtime", "coll_err_grace", 5.0,
            help="seconds a locally-detected segment-pull failure waits "
                 "for the origin rank's root-cause err notice before the "
                 "generic reason is raised (0 = fail immediately)"))
        self.stats = collections.Counter()
        self.pool = BytePool(f"coll{getattr(ce, 'rank', 0)}")
        self._ops: Dict[Any, _BaseOp] = {}
        self._parked: Dict[Any, List[Tuple[int, dict]]] = \
            collections.defaultdict(list)
        #: recently-finished cids (bounded): late stragglers (an err from
        #: a peer that failed after we finished) are dropped instead of
        #: parking forever
        self._done_cids: "collections.OrderedDict[Any, bool]" = \
            collections.OrderedDict()
        self._seq: Dict[Any, int] = collections.defaultdict(int)
        self._lock = threading.Lock()
        ce.register_ctl("coll", self._on_ctl)

    # -- control-plane routing -------------------------------------------
    def _on_ctl(self, src_rank: int, msg: dict) -> None:
        cid = _cid_key(msg.get("cid"))
        with self._lock:
            op = self._ops.get(cid)
            if op is None:
                if cid in self._done_cids:
                    self.stats["dropped_late"] += 1
                else:
                    self._parked[cid].append((src_rank, msg))
                    self.stats["parked"] += 1
                return
        op.on_msg(src_rank, msg)

    def bind(self, cid, op: _BaseOp) -> None:
        cid = _cid_key(cid)
        with self._lock:
            if cid in self._ops:
                raise CollError(f"collective id {cid!r} already in "
                                "flight (same-group collectives must be "
                                "issued in the same order on all ranks)")
            self._ops[cid] = op
            parked = self._parked.pop(cid, [])
        for src, msg in parked:
            op.on_msg(src, msg)

    def unbind(self, cid) -> None:
        with self._lock:
            cid = _cid_key(cid)
            self._ops.pop(cid, None)
            self._parked.pop(cid, None)
            self._done_cids[cid] = True
            while len(self._done_cids) > 4096:
                self._done_cids.popitem(last=False)

    def _next_cid(self, group: List[int], kind: str) -> Tuple:
        gk = tuple(group)
        with self._lock:
            self._seq[gk] += 1
            return (gk, kind, self._seq[gk])

    def sequence(self, key) -> int:
        """Monotonic per-key counter for callers that derive their own
        collective ids (CollectiveTask, datadist.redistribute): the
        SPMD insert stream is identical on every rank, so equal call
        sites draw equal numbers — and REPEATED call sites (two
        redistributions of the same window, two same-named taskpools)
        draw DISTINCT ones, which the cid must include: a reused cid
        races the endpoint's finished-cid ledger (a peer's advert
        arriving between op N's unbind and op N+1's bind would be
        dropped as a late straggler and the collective would hang)."""
        key = _cid_key(key)
        with self._lock:
            self._seq[key] += 1
            return self._seq[key]

    def _group(self, group) -> List[int]:
        if group is None:
            return list(range(getattr(self.ce, "nranks", 1)))
        return list(group)

    def _pick_algo(self, algo: Optional[str], n: int) -> str:
        a = algo or self.algo
        if a == "auto":
            return "ring"
        if a == "rd" and n & (n - 1):
            debug.verbose(2, "coll", "recursive doubling needs a power-"
                          "of-two group (N=%d); using ring", n)
            return "ring"
        return a

    def _torch_combiner(self, op: str) -> Callable:
        """The torch elementwise combiner of tensor contributions (the
        reference's ``_jit_combiner``).  A torch op needs no compile
        cache: it runs where its operands live."""
        return TORCH_REDUCERS[op]

    # -- public collectives ----------------------------------------------
    def allreduce(self, arr, *, group=None, op: str = "sum",
                  algo: Optional[str] = None, cid=None,
                  priority: Optional[int] = None) -> _BaseOp:
        """Nonblocking allreduce of ``arr`` across ``group`` (default:
        every rank).  Returns a :class:`CollOp` handle; ``wait()`` it,
        then ``result()`` is the reduced array (every rank gets the full
        result).  A tensor contribution combines through the torch
        combiner on its own device and its result is a tensor there."""
        group = self._group(group)
        if cid is None:
            cid = self._next_cid(group, "ar")
        a = self._pick_algo(algo, len(group))
        if a == "rd":
            return _RDOp(self, cid, group, arr, op=op, priority=priority)
        if a == "gather":
            return _GatherOp(self, cid, group, arr, op=op,
                             priority=priority)
        return _RingOp(self, cid, group, arr, op=op, kind="allreduce",
                       priority=priority)

    def reduce_scatter(self, arr, *, group=None, op: str = "sum",
                       cid=None, priority: Optional[int] = None) -> _BaseOp:
        """Ring reduce-scatter: every rank contributes the full array and
        receives its own partition of the elementwise reduction (rank
        ``group[i]`` gets the i-th element partition)."""
        group = self._group(group)
        if cid is None:
            cid = self._next_cid(group, "rs")
        return _RingOp(self, cid, group, arr, op=op, kind="reduce_scatter",
                       priority=priority)

    def allgather(self, arr, *, group=None, cid=None,
                  priority: Optional[int] = None) -> _BaseOp:
        """Ring allgather of equal-shaped per-rank contributions; the
        result concatenates the group's arrays along axis 0 (rank
        order)."""
        group = self._group(group)
        if cid is None:
            cid = self._next_cid(group, "ag")
        return _RingOp(self, cid, group, arr, kind="allgather",
                       priority=priority)

    def bcast(self, arr, *, root: int = 0, group=None, cid=None,
              priority: Optional[int] = None) -> _BaseOp:
        """Binomial-tree broadcast from ``root``.  Non-root ranks pass an
        array of the SAME shape/dtype as the root's (its content is the
        result template — MPI-style in-place broadcast)."""
        group = self._group(group)
        if cid is None:
            cid = self._next_cid(group, "bc")
        return _BcastOp(self, cid, group, arr, root=root,
                        priority=priority)

    def redistribute(self, cid, *, sends, expect_from, deliver,
                     budget: int, group=None,
                     priority: Optional[int] = None) -> RedistOp:
        """Memory-bounded redistribution rounds (see :class:`RedistOp`).
        ``cid`` must be caller-supplied and identical on every rank (the
        datadist layer derives it from the taskpool name)."""
        group = self._group(group)
        return RedistOp(self, cid, group, sends=sends,
                        expect_from=expect_from, deliver=deliver,
                        budget=budget, priority=priority)

    # -- introspection (health plane / watchdog) -------------------------
    def ops_in_flight(self) -> List[str]:
        """State lines of every collective currently bound (started and
        neither finished nor failed) — the watchdog names these in its
        OBS007 stall finding."""
        with self._lock:
            ops = list(self._ops.values())
        return [op.state() for op in ops]

    def segments_in_flight(self) -> int:
        return max(0, int(self.stats["seg_req"])
                   - int(self.stats["seg_done"])
                   - int(self.stats["seg_failed"]))

    def summary(self) -> Dict[str, Any]:
        """Counter snapshot for /metrics and the SDE gauges."""
        return {
            "ops_started": int(self.stats["ops_started"]),
            "ops_done": int(self.stats["ops_done"]),
            "ops_failed": int(self.stats["ops_failed"]),
            "ops_inflight": max(0, int(self.stats["ops_started"])
                                - int(self.stats["ops_done"])
                                - int(self.stats["ops_failed"])),
            "bytes": int(self.stats["bytes_landed"]),
            "segments": int(self.stats["seg_done"]),
            "segments_inflight": self.segments_in_flight(),
        }


#: public alias for type hints / docs
CollOp = _BaseOp
