"""In-process multi-rank comm backend.

N "ranks" — each a full :class:`~parsec_tpu_torch.core.context.Context` — live in
one process, connected by per-rank message queues. This is the fabric the
multi-rank protocol tests run on (the reference's equivalent is mpiexec
with N processes on one node, SURVEY.md §4; we go one level further down so
tests need no launcher at all).

Protocol parity with the TCP backend (the tier-1 fabric must exercise the
SAME eager/rendezvous/coalescing semantics the wire backend ships, or the
protocol is only ever tested under sockets):

* frames carry a *batch*: every AM queued for one destination inside a
  coalescing window (``CommEngine.coalesce``; progress dispatch opens one
  implicitly) travels as a single inbox entry, stable-sorted by priority —
  the per-peer aggregation + priority rings of the reference comm thread;
* one-sided ``get``/``get_part`` serve from the fabric's registration
  table with the same peek/consume-on-fin accounting as TCP's AM
  handshake, so chunked rendezvous pulls count identically on both.

Payload hygiene: messages are deep-ish copied at send so ranks cannot
alias each other's memory through the "wire" — numpy arrays and torch CPU
tensors are copied, and a CUDA tensor is cloned on the card (one
device-to-device copy queued behind its producer, see :func:`_wire_copy`);
keeps the protocol honest for a real network backend.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.data import ready_event, set_ready_event
from ..profiling import pins
from ..utils import debug, register_component
from .engine import CommEngine, MAX_AM_TAGS
from .payload import byte_slice


def _device_clone(t: torch.Tensor) -> torch.Tensor:
    """One device-to-device clone of a CUDA payload, ordered after its
    producer: the clone is queued on the device's compute stream (the
    default stream, where the port's bodies and kernels run) behind the
    tensor's ready event when it has one (an H2D copy's), and an event
    recorded after it becomes the clone's ready event — the receiver's
    stage-in waits on that event, not on the whole device.  The sender may
    then write its tile in place: the clone is the receiver's alone."""
    stream = torch.cuda.default_stream(t.device)
    ready = ready_event(t)
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        out = t.detach().clone()
        done = torch.cuda.Event()
        done.record(stream)
    set_ready_event(out, done)
    return out


def _wire_copy(obj: Any) -> Any:
    """Copy payloads crossing the fake wire: numpy arrays and torch CPU
    tensors on the host, CUDA tensors on the card (:func:`_device_clone`;
    a CUDA payload never turns into a host array here)."""
    if isinstance(obj, torch.Tensor):
        return _device_clone(obj) if obj.is_cuda else obj.detach().clone()
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, tuple):
        return tuple(_wire_copy(o) for o in obj)
    if isinstance(obj, list):
        return [_wire_copy(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _wire_copy(v) for k, v in obj.items()}
    return obj


class InprocFabric:
    """The shared 'network': per-rank inboxes + a memory-registration table
    (stands in for RDMA-registered segments)."""

    def __init__(self, nranks: int):
        self.nranks = nranks
        self.inboxes: List["queue.SimpleQueue"] = [queue.SimpleQueue() for _ in range(nranks)]
        self.mem: Dict[Any, Any] = {}
        #: (rank, handle) -> remaining GETs before self-reclaim
        self.mem_uses: Dict[Any, int] = {}
        self.mem_lock = threading.Lock()
        self._barrier = threading.Barrier(nranks)
        self.engines: List[Optional["InprocComm"]] = [None] * nranks

    def endpoints(self) -> List["InprocComm"]:
        out = []
        for r in range(self.nranks):
            ce = InprocComm(self, r)
            self.engines[r] = ce
            out.append(ce)
        return out


@register_component("comm")
class InprocComm(CommEngine):
    mca_name = "inproc"
    mca_priority = 10
    #: same-process fabric: device payloads cross without serialization
    #: (cloned on the card, never bounced through the host)
    device_payloads = True

    def __init__(self, fabric: InprocFabric, rank: int):
        self.fabric = fabric
        self.rank = rank
        self.nranks = fabric.nranks
        self._am: Dict[int, Callable[[int, Any], None]] = {}
        self._progress_lock = threading.Lock()
        self.context = None
        self.stats = collections.Counter()
        self._init_protocol()
        # per-destination outboxes for the coalescing window (reference
        # per-peer rings): (priority, seq, tag, payload) entries, flushed
        # as ONE inbox frame per destination when the outermost window
        # closes.  Outside a window every send flushes immediately, so
        # latency is never traded for batching without an explicit scope.
        self._out_lock = threading.RLock()
        self._outbox: Dict[int, List[Tuple[int, int, int, Any]]] = \
            collections.defaultdict(list)
        self._out_seq = 0
        #: frame ids: (src_rank << 32 | seq), stamped on every inbox
        #: frame so the hb checker can pair each delivery with its send
        #: (pins.HB_FRAME_SEND/DELIVER — the cross-rank ordering edge)
        self._frame_seq = 0
        #: window nesting is PER-THREAD: only the opener's own sends
        #: buffer until its close.  An engine-wide window would park
        #: every other thread's sends behind whatever the opener is
        #: doing inside it — e.g. a first kernel build in the device
        #: manager loop would stall the whole rank's outgoing
        #: activations for the build's duration.
        self._win_tls = threading.local()

    # -- AM -------------------------------------------------------------
    def register_am(self, tag: int, cb) -> None:
        if tag >= MAX_AM_TAGS:
            raise ValueError(f"tag {tag} out of tag space")
        self._am[tag] = cb

    def send_am(self, tag: int, dst_rank: int, payload: Any,
                priority: int = 0) -> None:
        self.stats[f"am_sent_{tag}"] += 1
        nbytes = _payload_bytes(payload)
        self.stats["am_bytes"] += nbytes
        self._termdet_note_sent(tag)
        copied = _wire_copy(payload)  # deep copy OUTSIDE the lock: the
        # lock guards an append, not a multi-MB ndarray copy
        with self._out_lock:
            self._out_seq += 1
            self._outbox[dst_rank].append(
                (priority, self._out_seq, tag, copied))
        if (self.coalesce_enabled
                and getattr(self._win_tls, "depth", 0) > 0):
            return  # flushed when THIS thread's outermost window closes
        self._flush(dst_rank)

    @contextlib.contextmanager
    def coalesce(self):
        """Coalescing window: the calling thread's sends nest into the
        per-destination outboxes; its OUTERMOST close flushes one
        priority-ordered frame per destination.  Other threads' sends
        flush immediately (draining anything already pending for that
        destination, order kept by the sequence numbers) — a window must
        never park a whole rank's traffic behind one thread's work."""
        depth = getattr(self._win_tls, "depth", 0)
        self._win_tls.depth = depth + 1
        try:
            yield
        finally:
            self._win_tls.depth = depth
            if depth == 0:
                self.flush_sends()

    def flush_sends(self) -> None:
        """Flush every pending outbox frame (highest-priority peer
        first)."""
        with self._out_lock:
            dsts = sorted(
                (d for d, items in self._outbox.items() if items),
                key=lambda d: -max(p for p, _s, _t, _pl in self._outbox[d]))
        for dst in dsts:
            self._flush(dst)

    def _flush(self, dst_rank: int) -> None:
        with self._out_lock:
            items = self._outbox.pop(dst_rank, None)
            self._frame_seq += 1
            fid = (self.rank << 32) | self._frame_seq
        if not items:
            return
        items.sort(key=lambda it: (-it[0], it[1]))  # priority, then FIFO
        batch = [(tag, payload) for _p, _s, tag, payload in items]
        self.stats["frames_sent"] += 1
        if len(batch) > 1:
            self.stats["frames_coalesced"] += 1
            self.stats["msgs_coalesced"] += len(batch)
        # transport span: bytes + peer + receiver queue depth measured AT
        # the wire (per-rank tracing routes on the ``rank`` field); the
        # byte re-walk only happens when someone is listening
        wire = pins.active(pins.COMM_SEND_BEGIN)
        if wire:
            nbytes = sum(_payload_bytes(p) for _t, p in batch)
            pins.fire(pins.COMM_SEND_BEGIN, None,
                      {"rank": self.rank, "peer": dst_rank,
                       "bytes": nbytes, "coalesced": len(batch),
                       "qdepth": self.fabric.inboxes[dst_rank].qsize()})
        if pins.active(pins.HB_FRAME_SEND):
            # happens-before edge source: everything this rank did before
            # the frame left is visible to whatever its delivery triggers
            pins.fire(pins.HB_FRAME_SEND, None,
                      {"rank": self.rank, "peer": dst_rank, "frame": fid})
        self.fabric.inboxes[dst_rank].put(
            (self.rank, batch, self._pb_outgoing(), fid))
        if wire:
            pins.fire(pins.COMM_SEND_END, None,
                      {"rank": self.rank, "peer": dst_rank,
                       "bytes": nbytes})
        peer = self.fabric.engines[dst_rank]
        if peer is not None and peer.context is not None:
            peer.context._notify_work()

    # -- one-sided ------------------------------------------------------
    def mem_register(self, handle: Any, buffer: Any, once: bool = False,
                     uses: Optional[int] = None) -> None:
        if once:
            uses = 1
        with self.fabric.mem_lock:
            self.fabric.mem[(self.rank, handle)] = buffer
            if uses is not None:
                self.fabric.mem_uses[(self.rank, handle)] = uses
            else:
                self.fabric.mem_uses.pop((self.rank, handle), None)

    def mem_unregister(self, handle: Any) -> None:
        with self.fabric.mem_lock:
            self.fabric.mem.pop((self.rank, handle), None)
            self.fabric.mem_uses.pop((self.rank, handle), None)

    def _mem_lookup(self, src_rank: int, handle: Any, consume: bool):
        """Fabric-table read with TCP-equivalent accounting: use counts
        decrement on consuming reads only (``fin`` chunks / whole GETs),
        so a chunked rendezvous transfer costs exactly one use however
        many chunks it pulled."""
        with self.fabric.mem_lock:
            buf = self.fabric.mem.get((src_rank, handle))
            if not consume:
                return buf
            uses = self.fabric.mem_uses.get((src_rank, handle))
            if uses is not None:
                if uses <= 1:
                    self.fabric.mem.pop((src_rank, handle), None)
                    self.fabric.mem_uses.pop((src_rank, handle), None)
                else:
                    self.fabric.mem_uses[(src_rank, handle)] = uses - 1
        return buf

    def get(self, src_rank: int, handle: Any, on_done) -> None:
        """Emulated one-sided pull (the reference emulates put/get with AM
        handshakes over MPI; here the fabric table IS the registered
        memory)."""
        buf = self._mem_lookup(src_rank, handle, consume=True)
        if buf is None:
            raise KeyError(f"no registered memory {handle!r} at rank {src_rank}")
        self.stats["get_bytes"] += _payload_bytes(buf)
        on_done(_wire_copy(buf))

    def get_part(self, src_rank: int, handle: Any, offset: int,
                 length: int, on_done, fin: bool = False,
                 priority: int = 0) -> None:
        """Rendezvous chunk fetch against the fabric table (synchronous —
        the protocol layer's pump is iterative, so depth-deep pipelines
        cannot recurse).  Same slice-and-copy semantics as the wire: the
        chunk is an honest copy, never an alias of the producer's
        registered bytes."""
        buf = self._mem_lookup(src_rank, handle, consume=fin)
        if buf is None:
            raise KeyError(f"no registered memory {handle!r} at rank {src_rank}")
        chunk = byte_slice(buf, offset, length)
        self.stats["get_bytes"] += chunk.nbytes
        on_done(chunk.copy())

    # -- progress -------------------------------------------------------
    def progress_nonblocking(self) -> int:
        if not self._progress_lock.acquire(blocking=False):
            return 0  # another thread of this rank is already progressing
        n = 0
        try:
            inbox = self.fabric.inboxes[self.rank]
            # dispatch inside a coalescing window: everything the AM
            # callbacks send (tree forwards, chunk serves, released-task
            # activations) batches per destination until the drain ends —
            # the "one progress cycle, one frame per peer" semantics of
            # the funnelled comm thread
            with self.coalesce():
                while True:
                    try:
                        src, batch, pb, fid = inbox.get_nowait()
                    except queue.Empty:
                        break
                    if pins.active(pins.HB_FRAME_DELIVER):
                        pins.fire(pins.HB_FRAME_DELIVER, None,
                                  {"rank": self.rank, "peer": src,
                                   "frame": fid})
                    self._pb_incoming(src, pb)
                    nbytes = sum(_payload_bytes(p) for _t, p in batch)
                    # recv span: covers the frame's dispatch
                    # (deserialize-free on this fabric, so the span is
                    # the handlers' own work)
                    wire = pins.active(pins.COMM_RECV_BEGIN)
                    if wire:
                        pins.fire(pins.COMM_RECV_BEGIN, None,
                                  {"rank": self.rank, "peer": src,
                                   "bytes": nbytes,
                                   "coalesced": len(batch),
                                   "qdepth": inbox.qsize()})
                    try:
                        for tag, payload in batch:
                            self._termdet_note_recv(tag)
                            cb = self._am.get(tag)
                            if cb is None:
                                debug.warning(
                                    "rank %d: AM on unregistered tag %d",
                                    self.rank, tag)
                                continue
                            try:
                                cb(src, payload)
                            except Exception as e:
                                debug.error(
                                    "rank %d: AM callback tag %d raised: %s",
                                    self.rank, tag, e)
                                import traceback

                                traceback.print_exc()
                            n += 1
                            self.stats[f"am_recv_{tag}"] += 1
                    finally:
                        if wire:
                            pins.fire(pins.COMM_RECV_END, None,
                                      {"rank": self.rank, "peer": src})
        finally:
            self._progress_lock.release()
        return n

    def barrier(self) -> None:
        self.flush_sends()  # nothing queued may wait out a barrier
        self.fabric._barrier.wait()


def _payload_bytes(obj: Any) -> int:
    if isinstance(obj, np.ndarray) or hasattr(obj, "nbytes"):
        return obj.nbytes
    if isinstance(obj, (tuple, list)):
        return sum(_payload_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_payload_bytes(v) for v in obj.values())
    return 0
