"""TCP multi-process comm backend with a funnelled comm thread.

The port of :mod:`parsec_tpu.comm.tcp`.  Reference:
``parsec/parsec_mpi_funnelled.c`` — the MPI backend runs a single
dedicated communication thread ("funnelled") that owns every network
endpoint; workers enqueue typed commands to a MPSC queue and the comm
thread drains it, aggregates messages per peer (``remote_dep_mpi.c:1066-1190``
per-peer rings), posts sends, and dispatches incoming active messages.
One-sided ``put``/``get`` are *emulated* with an AM handshake on internal
tags (``parsec_mpi_funnelled.c:273,361,949-960``).

This backend keeps that architecture over TCP sockets, the transport
between the port's rank processes (one rank per process; launch them with
:mod:`.launch`):

* full-mesh connectivity: rank *i* accepts from ranks *j > i* and
  connects to ranks *j < i*; a 4-byte handshake carries the peer rank;
* rendezvous through a shared directory (each rank binds an ephemeral
  port and publishes ``<rank>.addr``) or an explicit ``peers`` list of
  ``host:port`` — the multi-host form;
* frames carry a *batch*: every AM queued for the same peer at drain
  time travels in one frame (the per-peer aggregation of the reference);
* **datatype-described wire**: a frame is a small versioned header +
  a pickled CONTROL structure + the raw bytes of every array payload
  shipped OUT-OF-BAND (pickle protocol 5 buffers).  Sends are
  zero-copy — array memory goes to the socket as memoryviews, never
  copied into the pickle stream; non-contiguous ndarrays are gathered
  through the datatype layer's ``pack`` (the CE pack/unpack slots,
  reference ``parsec_comm_engine.h:176-199``).  A torch CPU tensor (a
  bfloat16 tile: numpy has no bfloat16) ships out of band as its raw
  bits under its :func:`~.payload.wire_header` and is rebuilt over the
  receive slot (:func:`~.payload.from_wire`), never through torch's own
  pickling.  A CUDA tensor is refused at :meth:`TCPComm.send_am`
  (``TypeError``): pickling it would copy it to the host and restore it
  onto a card at the receiver, a device move nobody asked for.  The
  protocol layers hand this wire host payloads only (``device_payloads``
  is False: :func:`~.payload.prefetch_to_host` / :func:`~.payload.to_wire`
  make exactly one D2H copy a tile).  Receives land payload bytes
  DIRECTLY into recycled :class:`~parsec_tpu_torch.data.arena.BytePool`
  slots (``recv_into``, no intermediate bytes objects — reference
  arena-backed receives, ``remote_dep_mpi.c:870-930``); delivered
  arrays alias the arena slot, which self-releases when they die;
* the comm thread dispatches AM callbacks directly (funnelled semantics:
  callbacks schedule work into the owning context's queues, exactly like
  the reference comm thread running ``release_deps``).

Trust model: endpoints are the runtime's own cooperating processes
(pickle for the control headers, like MPI's trusted-cluster assumption);
frames are magic/version-checked and size-capped, but do not expose the
rendezvous port to untrusted networks.
"""

from __future__ import annotations

import collections
import os
import pickle
import queue
import select
import socket
import struct
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..profiling import pins
from ..utils import debug, mca_param, register_component
from .engine import CommEngine, MAX_AM_TAGS
from .payload import (as_bytes, byte_slice, from_wire, is_device_array,
                      raw_framable, wire_header)

# internal tag space (reference registers internal GET/PUT AM tags at init,
# parsec_mpi_funnelled.c:583-592); user tags must stay below these.
TAG_FIN = MAX_AM_TAGS - 4         # 8: close handshake, last frame ever sent
TAG_BARRIER = MAX_AM_TAGS - 3     # 9
TAG_GET_REQ = MAX_AM_TAGS - 2     # 10
TAG_GET_ANS = MAX_AM_TAGS - 1     # 11

#: frame header: magic, wire version, control-blob bytes, out-of-band
#: buffer count; then ``nbufs`` u64 buffer lengths, the control pickle,
#: and the raw array bytes
_HDR = struct.Struct("!HHII")
_BUFLEN = struct.Struct("!Q")
_MAGIC = 0x9A7C
_WIRE_VERSION = 4  # v4: control blob = (rank, batch, piggyback-or-None,
                   # frame-id) — the id pairs each delivery with its send
                   # for the hb-check happens-before edge
_RANK = struct.Struct("!i")
_MISSING = object()
#: protocol constant: out-of-band buffers one frame may carry; the
#: receiver drops the connection as corrupt above this (must agree with
#: every peer's sender-side chunking/diagnostics)
_MAX_OOB_BUFS = 65536

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


class _WireTensor:
    """A torch CPU tensor on the wire: its :func:`~.payload.wire_header`
    and its raw bytes as a flat uint8 ndarray, which pickle protocol 5
    ships out of band like any array payload.  It unpickles to the tensor
    itself, a view over the receive slot (:func:`_tensor_from_wire`)."""

    __slots__ = ("hdr", "raw")

    def __init__(self, t: torch.Tensor):
        self.hdr = wire_header(t)
        self.raw = as_bytes(t)

    def __reduce__(self):
        return (_tensor_from_wire, (self.hdr, self.raw))


def _tensor_from_wire(hdr: dict, raw: np.ndarray) -> torch.Tensor:
    """The receiver's half of :class:`_WireTensor`: a tensor aliasing the
    landed bytes (it keeps them, hence the arena slot, alive)."""
    return from_wire(hdr, raw)


def _refuse_device(obj: Any) -> None:
    """Raise ``TypeError`` for a tensor off the host anywhere in a payload
    (plain containers, as :func:`_walk_arrays` sees them)."""
    if isinstance(obj, torch.Tensor):
        if is_device_array(obj) or obj.device.type != "cpu":
            raise TypeError(
                f"a {obj.device.type} tensor cannot cross the TCP wire: "
                "hand it a host payload (payload.to_wire) — pickling would "
                "move it through the host and back onto a device")
    elif isinstance(obj, dict):
        for v in obj.values():
            _refuse_device(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _refuse_device(v)


def _pack_arrays(obj: Any, stats) -> Any:
    """Route every non-contiguous ndarray through the datatype layer's
    ``pack`` (gather to wire-contiguous form) and wrap every torch CPU
    tensor as a :class:`_WireTensor`, so pickle-5 ships ALL array
    payloads out-of-band as zero-copy buffers; contiguous ndarrays pass
    through untouched."""
    if isinstance(obj, torch.Tensor):
        if not raw_framable(obj):
            stats["dt_packed"] += 1
            obj = obj.contiguous()
        return _WireTensor(obj)
    if isinstance(obj, np.ndarray):
        if obj.flags.c_contiguous or obj.flags.f_contiguous:
            return obj
        stats["dt_packed"] += 1
        base = obj.base
        if (obj.ndim == 2 and obj.strides[1] == obj.itemsize
                and isinstance(base, np.ndarray) and base.flags.c_contiguous):
            # a strided row panel (LAPACK tile view): describe it as a
            # Vector over its base buffer and gather via the datatype
            # layer's pack — the CE pack slot exercised on the real wire.
            # reshape(-1) on a contiguous base is a VIEW (same pointer),
            # so the element-offset arithmetic below is exact; anything
            # misaligned (sub-itemsize byte offset) falls through to the
            # plain gather rather than shipping shifted bytes.
            from ..data.datatype import type_of_array

            try:
                flat = base.reshape(-1)
                if flat.dtype != obj.dtype:
                    flat = flat.view(obj.dtype)
                delta = (obj.__array_interface__["data"][0]
                         - flat.__array_interface__["data"][0])
                if delta >= 0 and delta % obj.itemsize == 0:
                    dt = type_of_array(obj)
                    return dt.pack(flat, delta // obj.itemsize).reshape(obj.shape)
            except (ValueError, TypeError):
                pass
        return np.ascontiguousarray(obj)
    if isinstance(obj, dict):
        return {k: _pack_arrays(v, stats) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_pack_arrays(v, stats) for v in obj)
    if isinstance(obj, list):
        return [_pack_arrays(v, stats) for v in obj]
    return obj


def _walk_arrays(obj: Any, out: List[Any]) -> None:
    """Collect the array payloads (ndarrays and torch tensors) of plain
    containers: the frame splitter's weights."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _walk_arrays(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk_arrays(v, out)


class _RecvState:
    """Per-peer streaming frame parser: header → buffer-length table →
    control blob → payload buffers, each phase filled by ``recv_into``
    with payloads landing straight in arena slots."""

    __slots__ = ("phase", "target", "got", "ctl_len", "ctl", "nbufs",
                 "lens", "bufs", "bufi")

    def __init__(self):
        self.reset()

    def reset(self):
        self.phase = "hdr"
        self.target = memoryview(bytearray(_HDR.size))
        self.got = 0
        self.ctl_len = 0
        self.ctl = b""
        self.nbufs = 0
        self.lens: List[int] = []
        self.bufs: List[Any] = []   # DataCopy per payload (arena slots)
        self.bufi = 0


@register_component("comm")
class TCPComm(CommEngine):
    """One endpoint of the TCP fabric (one per process/rank)."""

    mca_name = "tcp"
    mca_priority = 20
    #: GET answers are AM frames: their bytes already land in am_bytes
    pull_bytes_in_frames = True
    #: a serializing wire: the protocol layers hand it host payloads (one
    #: D2H copy a CUDA tile at the sender, one H2D at the receiver's stage-in)
    device_payloads = False

    def __init__(
        self,
        rank: int,
        nranks: int,
        rendezvous_dir: Optional[str] = None,
        peers: Optional[List[str]] = None,
        host: str = "127.0.0.1",
        connect_timeout: float = 60.0,
    ):
        self.rank = rank
        self.nranks = nranks
        self.context = None
        self.stats: collections.Counter = collections.Counter()
        self._am: Dict[int, Callable[[int, Any], None]] = {}
        # AMs that raced ahead of their tag registration are parked and
        # replayed at register time (the reference preposts persistent
        # recvs per registered tag, so a message can never outrun its
        # handler; this is the stream-socket analog).  _am_lock closes the
        # window between the comm thread's lookup-then-park and the main
        # thread's register-then-replay.
        self._am_lock = threading.Lock()
        self._unclaimed: Dict[int, List[Tuple[int, Any]]] = collections.defaultdict(list)
        self._mem: Dict[Any, Any] = {}
        self._mem_uses: Dict[Any, int] = {}
        self._mem_lock = threading.Lock()
        self._pending_gets: Dict[int, Callable[[Any], None]] = {}
        self._get_seq = 0
        self._get_lock = threading.Lock()
        # wire-protocol tunables (eager/rendezvous/coalescing), registered
        # and validated before anything can queue traffic
        self._init_protocol()
        # MPSC command queue drained by the comm thread (reference
        # dep_cmd_queue, remote_dep_mpi.c:513-520); entries are
        # (dst, tag, payload, priority) — the drain orders each peer's
        # batch by priority (critical-path tiles leave first), FIFO among
        # equals, never across drain cycles
        self._cmds: "queue.SimpleQueue[Tuple[int, int, Any, int]]" = queue.SimpleQueue()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)  # a full wake pipe is skipped, not blocked on
        self._closing = threading.Event()
        #: ranks whose FIN frame arrived (touched only on the comm thread)
        self._peer_fin: set = set()
        # Endpoints are expected to close roughly together (after a
        # barrier / taskpool quiesce); a rank closing while peers keep
        # computing waits out close_timeout for their FINs, then closes
        # anyway (mid-stream truncation risk is back on that peer).
        self.close_timeout = mca_param.register(
            "runtime", "comm_close_timeout", 10.0,
            help="seconds close() waits for peer FIN frames before "
                 "closing sockets anyway")
        #: wedged-peer bound for one frame write; close() must wait out at
        #: least one full send before giving up on the comm thread
        self.send_timeout = mca_param.register(
            "runtime", "comm_send_timeout", 30.0,
            help="seconds a single frame write may block before the "
                 "peer is declared wedged and the connection dropped")
        self._barrier_epoch = 0
        self._barrier_state: Dict[int, Any] = {}
        self._barrier_cv = threading.Condition()

        self._socks: Dict[int, socket.socket] = {}
        #: per-peer streaming frame parsers (recv_into arena slots)
        self._rx: Dict[int, _RecvState] = {}
        # receive arenas by power-of-two size class (recv_into targets;
        # backpressure is TCP's job, so the pool is uncapped — a None
        # from allocate() would kill the comm thread mid-frame)
        from ..data.arena import BytePool

        self._rx_pool = BytePool(f"rx{rank}")
        self.max_frame = mca_param.register(
            "runtime", "comm_max_frame", 1 << 31,
            help="per-frame cap (bytes) on control blob / payload total; "
                 "larger frames drop the connection as corrupt")
        if nranks > 1:
            self._bootstrap(rendezvous_dir, peers, host, connect_timeout)

        # internal handlers bind directly (the comm thread isn't running
        # yet, so no message can race these); register_am refuses the
        # internal band so a user callback can never shadow them
        self._am[TAG_GET_REQ] = self._on_get_req
        self._am[TAG_GET_ANS] = self._on_get_ans
        self._am[TAG_BARRIER] = self._on_barrier
        self._am[TAG_FIN] = self._on_fin

        self._thread = threading.Thread(
            target=self._comm_main, name=f"parsec-comm-{rank}", daemon=True)
        self._thread.start()

    # -- bootstrap -------------------------------------------------------
    def _bootstrap(self, rdv: Optional[str], peers: Optional[List[str]],
                   host: str, timeout: float) -> None:
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if peers is not None:
            # explicit peer list: bind the port this rank advertises
            my_host, my_port_s = peers[self.rank].rsplit(":", 1)
            lsock.bind((my_host, int(my_port_s)))
        else:
            lsock.bind((host, 0))
        lsock.listen(self.nranks)
        my_port = lsock.getsockname()[1]

        if peers is None:
            if rdv is None:
                raise ValueError("TCPComm needs rendezvous_dir or peers")
            os.makedirs(rdv, exist_ok=True)
            tmp = os.path.join(rdv, f".{self.rank}.addr.tmp")
            with open(tmp, "w") as f:
                f.write(f"{host}:{my_port}")
            os.replace(tmp, os.path.join(rdv, f"{self.rank}.addr"))
            peers = [None] * self.nranks
            deadline = time.time() + timeout
            for r in range(self.nranks):
                path = os.path.join(rdv, f"{r}.addr")
                while not os.path.exists(path):
                    if time.time() > deadline:
                        raise TimeoutError(f"rendezvous: rank {r} missing")
                    time.sleep(0.01)
                with open(path) as f:
                    peers[r] = f.read().strip()

        # connect DOWN, accept UP; peers may not have bound yet (explicit
        # peer lists have no publish-after-listen ordering), so refused
        # connections retry until the deadline
        for r in range(self.rank):
            h, p = peers[r].rsplit(":", 1)
            deadline = time.time() + timeout
            while True:
                try:
                    s = socket.create_connection((h, int(p)), timeout=timeout)
                    break
                except (ConnectionRefusedError, socket.timeout, OSError):
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(_RANK.pack(self.rank))
            self._socks[r] = s
        for _ in range(self.rank + 1, self.nranks):
            lsock.settimeout(timeout)
            s, _addr = lsock.accept()
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            (peer_rank,) = _RANK.unpack(_recv_exact(s, _RANK.size))
            self._socks[peer_rank] = s
        lsock.close()
        for s in self._socks.values():
            s.setblocking(False)
        self._rx = {r: _RecvState() for r in self._socks}

    # -- AM --------------------------------------------------------------
    def register_am(self, tag: int, cb) -> None:
        if tag >= TAG_FIN:
            raise ValueError(
                f"tag {tag} is in the internal band [{TAG_FIN}, "
                f"{MAX_AM_TAGS}) (FIN/barrier/get handshakes)")
        with self._am_lock:
            self._am[tag] = cb
            parked = self._unclaimed.pop(tag, None)
        if parked:
            for src, payload in parked:
                self._dispatch(tag, src, payload)

    def send_am(self, tag: int, dst_rank: int, payload: Any,
                priority: int = 0) -> None:
        """Queue an AM for the comm thread.  A tensor off the host in the
        payload raises ``TypeError`` here, on the sender's thread."""
        if dst_rank == self.rank:
            self.stats[f"am_sent_{tag}"] += 1
            # self-sends short-circuit (reference delivers locally too)
            self._dispatch(tag, self.rank, payload)
            return
        _refuse_device(payload)
        self.stats[f"am_sent_{tag}"] += 1
        self._termdet_note_sent(tag)
        self._cmds.put((dst_rank, tag, payload, priority))
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass

    # -- one-sided (AM-handshake emulation) ------------------------------
    def mem_register(self, handle: Any, buffer: Any, once: bool = False,
                     uses: Optional[int] = None) -> None:
        if once:
            uses = 1
        with self._mem_lock:
            self._mem[handle] = buffer
            if uses is not None:
                self._mem_uses[handle] = uses
            else:
                self._mem_uses.pop(handle, None)

    def mem_unregister(self, handle: Any) -> None:
        with self._mem_lock:
            self._mem.pop(handle, None)
            self._mem_uses.pop(handle, None)

    def _mem_take(self, handle: Any, default=None, consume: bool = True):
        """Read a registered buffer; use-counted registrations self-reclaim
        after their declared number of GETs.  ``consume=False`` peeks
        without touching the count (non-final rendezvous chunks)."""
        with self._mem_lock:
            buf = self._mem.get(handle, default)
            if not consume:
                return buf
            uses = self._mem_uses.get(handle)
            if uses is not None:
                if uses <= 1:
                    self._mem.pop(handle, None)
                    self._mem_uses.pop(handle, None)
                else:
                    self._mem_uses[handle] = uses - 1
        return buf

    def get(self, src_rank: int, handle: Any, on_done) -> None:
        if src_rank == self.rank:
            buf = self._mem_take(handle)
            if buf is None:
                raise KeyError(f"no registered memory {handle!r} locally")
            on_done(buf)
            return
        with self._get_lock:
            self._get_seq += 1
            req = self._get_seq
            self._pending_gets[req] = on_done
        self.send_am(TAG_GET_REQ, src_rank, {"req": req, "handle": handle})

    def get_part(self, src_rank: int, handle: Any, offset: int,
                 length: int, on_done, fin: bool = False,
                 priority: int = 0) -> None:
        """Rendezvous chunk fetch: the AM-handshake emulation of a
        one-sided partial read.  Only the ``fin`` request consumes a
        use-counted registration (one decrement per consumer, however
        many chunks it pulled); the answer echoes the request's priority
        so critical-path chunks overtake bulk ones in the peer's drain."""
        if src_rank == self.rank:
            buf = self._mem_take(handle, consume=fin)
            if buf is None:
                raise KeyError(f"no registered memory {handle!r} locally")
            on_done(byte_slice(buf, offset, length))
            return
        with self._get_lock:
            self._get_seq += 1
            req = self._get_seq
            self._pending_gets[req] = on_done
        self.send_am(TAG_GET_REQ, src_rank,
                     {"req": req, "handle": handle, "off": offset,
                      "len": length, "fin": fin, "prio": priority},
                     priority=priority)

    def _on_get_req(self, src: int, msg: dict) -> None:
        part = "off" in msg
        buf = self._mem_take(msg["handle"], _MISSING,
                             consume=(not part) or msg.get("fin", False))
        if buf is _MISSING or buf is None:
            debug.error("rank %d: GET for unknown handle %r", self.rank, msg["handle"])
            self.send_am(TAG_GET_ANS, src,
                         {"req": msg["req"], "error": f"unknown handle {msg['handle']!r}"},
                         priority=msg.get("prio", 0))
            return
        if part:
            # contiguous slice of the registered bytes: ships out-of-band
            # as a zero-copy buffer (no intermediate copy on this side)
            buf = byte_slice(buf, msg["off"], msg["len"])
        self.send_am(TAG_GET_ANS, src, {"req": msg["req"], "data": buf},
                     priority=msg.get("prio", 0))

    def _on_get_ans(self, src: int, msg: dict) -> None:
        with self._get_lock:
            cb = self._pending_gets.pop(msg["req"], None)
        if cb is None:
            return
        if "error" in msg:
            # loud protocol error; the requester's callback is told (None)
            # so an aggregated activation can degrade instead of hanging
            # its whole forward subtree on one lost payload
            debug.error("rank %d: GET %s failed at rank %d: %s",
                        self.rank, msg["req"], src, msg["error"])
            cb(None)
            return
        self.stats["get_bytes"] += getattr(msg["data"], "nbytes", 0)
        cb(msg["data"])

    # -- barrier (central, AM-based) -------------------------------------
    def barrier(self) -> None:
        if self.nranks == 1:
            return
        with self._barrier_cv:
            self._barrier_epoch += 1
            epoch = self._barrier_epoch
        if self.rank == 0:
            self._on_barrier(0, {"epoch": epoch, "phase": "enter"})
        else:
            self.send_am(TAG_BARRIER, 0, {"epoch": epoch, "phase": "enter"})
        with self._barrier_cv:
            while self._barrier_state.get(("released", epoch)) is None:
                if self._closing.is_set():
                    raise RuntimeError("comm engine closed while in barrier")
                if len(self._socks) < self.nranks - 1:
                    lost = set(range(self.nranks)) - set(self._socks) - {self.rank}
                    raise RuntimeError(f"peer rank(s) {sorted(lost)} lost in barrier")
                self._barrier_cv.wait(timeout=1.0)
            self._barrier_state.pop(("released", epoch))

    def _on_barrier(self, src: int, msg: dict) -> None:
        epoch, phase = msg["epoch"], msg["phase"]
        with self._barrier_cv:
            if phase == "enter":  # only rank 0 sees these
                n = self._barrier_state.get(("count", epoch), 0) + 1
                self._barrier_state[("count", epoch)] = n
                if n == self.nranks:
                    self._barrier_state.pop(("count", epoch))
                    for r in range(1, self.nranks):
                        # control handshake: ahead of any data sharing
                        # the drain cycle (peers are blocked on it)
                        self._cmds.put((r, TAG_BARRIER,
                                        {"epoch": epoch, "phase": "release"},
                                        1 << 30))
                    try:
                        self._wake_w.send(b"\0")
                    except (BlockingIOError, OSError):
                        pass
                    self._barrier_state[("released", epoch)] = True
                    self._barrier_cv.notify_all()
            else:  # release
                self._barrier_state[("released", epoch)] = True
                self._barrier_cv.notify_all()

    # -- comm thread -----------------------------------------------------
    def _comm_main(self) -> None:
        """The funnelled progress loop (reference
        ``remote_dep_dequeue_main`` → ``…nothread_progress``).

        Shutdown is a deterministic close handshake, not flag-racing
        (reference fini tears down only after progress quiesces,
        ``parsec_mpi_funnelled.c:527``): when ``close()`` sets ``_closing``
        the loop queues one FIN frame to every live peer — FIFO-ordered
        after everything queued before close, so barrier releases etc.
        always precede it on the wire — then KEEPS progressing (flushing
        sends, reading and dispatching peers' traffic) until its own queue
        drained and every live peer's FIN arrived.  A peer's FIN is the
        last frame that peer will ever send, so once all are in, no data
        can be lost by closing the sockets; peers that vanished (EOF)
        stop being waited on."""
        fin_sent = False
        fin_deadline = 0.0
        while True:
            sent = self._drain_cmds()
            got = self._poll_incoming(0.0 if sent else 0.05)
            if (sent or got) and self.context is not None:
                self.context._notify_work()
            if not self._closing.is_set():
                continue
            if not fin_sent:
                fin_sent = True
                fin_deadline = time.monotonic() + self.close_timeout
                for r in list(self._socks):
                    # lowest priority: a FIN must never be reordered
                    # ahead of data it happens to share a frame with
                    self._cmds.put((r, TAG_FIN, None, -(1 << 30)))
                continue  # next iteration flushes the FINs
            if self._cmds.empty() and all(
                    r in self._peer_fin for r in self._socks):
                break
            if time.monotonic() > fin_deadline:
                lagging = sorted(set(self._socks) - self._peer_fin)
                debug.error(
                    "rank %d: close handshake timed out after %.1fs "
                    "(no FIN from rank(s) %s)",
                    self.rank, self.close_timeout, lagging)
                break

    def _on_fin(self, src: int, _payload: Any) -> None:
        self._peer_fin.add(src)

    def _drain_cmds(self) -> int:
        """Drain the command queue, aggregating per peer into one frame
        (reference per-peer rings, remote_dep_mpi.c:1095-1132), PRIORITY-
        ordered within the cycle: each peer's batch is stable-sorted by
        descending priority (critical-path activations and their chunk
        answers leave first, FIFO among equals), and peers themselves go
        out highest-priority-first.  Ordering never crosses drain cycles,
        so earlier-cycle control traffic is never overtaken."""
        pending: Dict[int, List[Tuple[int, int, Any]]] = collections.defaultdict(list)
        n = 0
        while True:
            try:
                dst, tag, payload, prio = self._cmds.get_nowait()
            except queue.Empty:
                break
            pending[dst].append((prio, tag, payload))
            n += 1
        order = sorted(pending.items(),
                       key=lambda kv: -max(p for p, _t, _p in kv[1]))
        for dst, items in order:
            items.sort(key=lambda it: -it[0])  # stable: FIFO among equals
            whole = [(tag, payload) for _prio, tag, payload in items]
            for batch in self._frame_chunks(whole):
                self._send_frame(dst, batch)
        return n

    def _frame_chunks(self, batch: List[Tuple[int, Any]]):
        """Split a peer's batch so each frame respects the receiver's
        limits — the comm_max_frame payload cap AND the 65536
        out-of-band buffer cap (an aggregated drain can legitimately
        exceed both; the receiver treats oversize as corruption).  The
        weights are a walk over dict/list/tuple payloads; arrays nested
        in custom objects ship fine (pickle-5 finds them) but weigh 0
        here, so keep protocol payloads in plain containers.  NOTE: the
        caps are protocol constants — comm_max_frame must agree across
        ranks (it is an MCA param; set it identically everywhere)."""
        cap = max(1 << 20, self.max_frame // 2)
        chunk, weight, nbufs = [], 0, 0
        for item in batch:
            arrs: List[Any] = []
            _walk_arrays(item[1], arrs)
            w = sum(a.nbytes for a in arrs)
            if chunk and (weight + w > cap or len(chunk) >= 16384
                          or nbufs + len(arrs) > 32768):
                yield chunk
                chunk, weight, nbufs = [], 0, 0
            if w > self.max_frame:
                debug.error(
                    "rank %d: single AM payload (%d bytes) exceeds "
                    "comm_max_frame (%d) — the receiver will drop the "
                    "connection; raise the runtime_comm_max_frame param",
                    self.rank, w, self.max_frame)
            if len(arrs) > _MAX_OOB_BUFS:
                debug.error(
                    "rank %d: single AM payload carries %d arrays, above "
                    "the receiver's %d out-of-band buffer cap — the "
                    "receiver will drop the connection; split the payload",
                    self.rank, len(arrs), _MAX_OOB_BUFS)
            chunk.append(item)
            weight += w
            nbufs += len(arrs)
        if chunk:
            yield chunk

    def _send_frame(self, dst: int, batch: List[Tuple[int, Any]]) -> None:
        # control structure pickles; array payloads ship out-of-band
        # as raw zero-copy memoryviews appended after the blob
        self._frame_seq = getattr(self, "_frame_seq", 0) + 1
        fid = (self.rank << 32) | self._frame_seq
        if pins.active(pins.HB_FRAME_SEND):
            pins.fire(pins.HB_FRAME_SEND, None,
                      {"rank": self.rank, "peer": dst, "frame": fid})
        bufs: List[memoryview] = []
        blob = pickle.dumps(
            (self.rank, _pack_arrays(batch, self.stats),
             self._pb_outgoing(), fid),
            protocol=5,
            buffer_callback=lambda pb: bufs.append(pb.raw()) and None)
        head = (_HDR.pack(_MAGIC, _WIRE_VERSION, len(blob), len(bufs))
                + b"".join(_BUFLEN.pack(b.nbytes) for b in bufs) + blob)
        frame_bytes = len(head) + sum(b.nbytes for b in bufs)
        self.stats["am_bytes"] += frame_bytes
        self.stats["frames_sent"] += 1
        sock = self._socks.get(dst)
        if sock is None:
            debug.error("rank %d: no route to rank %d", self.rank, dst)
            return
        # transport span on the comm thread's stream: one frame on the
        # wire, with bytes, peer, and the command-queue depth behind it
        wire = pins.active(pins.COMM_SEND_BEGIN)
        if wire:
            pins.fire(pins.COMM_SEND_BEGIN, None,
                      {"rank": self.rank, "peer": dst,
                       "bytes": frame_bytes, "coalesced": len(batch),
                       "qdepth": self._cmds.qsize()})
        try:
            # byte-tracked sends: sendall on a non-blocking socket can
            # transmit part of the frame before raising, with no way to
            # learn how much — that would corrupt the framed stream on
            # retry, so every segment goes through the tracker
            self._send_tracked(sock, head)
            for b in bufs:
                self._send_tracked(sock, b)
            if wire:
                pins.fire(pins.COMM_SEND_END, None,
                          {"rank": self.rank, "peer": dst,
                           "bytes": frame_bytes})
        except OSError as e:
            if wire:
                pins.fire(pins.COMM_SEND_END, None,
                          {"rank": self.rank, "peer": dst, "bytes": 0})
            if not self._closing.is_set():
                debug.error("rank %d: send to %d failed: %s", self.rank, dst, e)
            else:
                # close-phase sends (barrier releases, FIN) are
                # load-bearing for the handshake: a failure here is why
                # a peer would later report a missing FIN
                debug.verbose(1, "comm",
                              "rank %d: close-phase send to %d failed: %s",
                              self.rank, dst, e)

    def _send_tracked(self, sock: socket.socket, data: bytes) -> None:
        """Write the whole frame or raise.  Deliberately does NOT abort on
        ``_closing`` — the close handshake flushes queued frames AFTER the
        flag is set (an earlier version bailed here, silently dropping the
        final barrier releases).  A wedged peer is bounded by a deadline
        instead."""
        view = memoryview(data)
        deadline = time.monotonic() + self.send_timeout
        while view:
            try:
                sent = sock.send(view)
                view = view[sent:]
            except (BlockingIOError, InterruptedError):
                # the peer may be blocked sending to US (mutual large
                # frames); keep draining incoming traffic while waiting
                # for writability, or both comm threads deadlock with
                # full kernel buffers
                if time.monotonic() > deadline:
                    raise OSError(
                        f"send wedged for {self.send_timeout:.0f}s "
                        f"({len(view)} bytes unsent)")
                self._poll_incoming(0.0)
                select.select([], [sock], [], 0.05)

    def _poll_incoming(self, timeout: float) -> int:
        rlist = list(self._socks.values()) + [self._wake_r]
        try:
            ready, _, _ = select.select(rlist, [], [], timeout)
        except OSError:
            return 0
        n = 0
        for sock in ready:
            if sock is self._wake_r:
                try:
                    while sock.recv(4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
                continue
            peer = next((r for r, s in self._socks.items() if s is sock), None)
            if peer is None:
                continue
            n += self._pump_peer(peer, sock)
        return n

    def _pump_peer(self, peer: int, sock: socket.socket) -> int:
        """Advance peer's frame parser with whatever bytes are available
        (bounded per call so one fast peer can't starve the rest).
        Payload phases recv_into arena slots directly — network bytes land
        in recycled buffers, never in intermediate bytes objects."""
        st = self._rx[peer]
        n = 0
        budget = 16 << 20
        while budget > 0:
            if st.got == len(st.target):
                # zero-length phase (empty ndarray payload): nothing to
                # read — advance directly, recv_into on an empty view
                # would return 0 and be mistaken for EOF
                n += self._rx_advance(peer, st)
                continue
            try:
                got = sock.recv_into(st.target[st.got:])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                got = 0
            if got == 0:
                if not self._closing.is_set():
                    debug.verbose(2, "comm", "rank %d: peer %d closed",
                                  self.rank, peer)
                self._rx_abort(st)
                self._socks.pop(peer, None)
                break
            st.got += got
            budget -= got
            if st.got < len(st.target):
                continue
            n += self._rx_advance(peer, st)
        return n

    def _rx_advance(self, peer: int, st: _RecvState) -> int:
        """One parser phase filled; step the state machine.  Returns the
        number of AMs delivered (only the final phase delivers)."""
        if st.phase == "hdr":
            magic, ver, ctl_len, nbufs = _HDR.unpack(st.target)
            if magic != _MAGIC or ver != _WIRE_VERSION:
                debug.error("rank %d: bad frame from %d (magic=%#x ver=%d) — "
                            "dropping connection", self.rank, peer, magic, ver)
                self._drop_peer(peer, st)
                return 0
            if ctl_len > self.max_frame or nbufs > _MAX_OOB_BUFS:
                debug.error("rank %d: oversized frame from %d (ctl=%d nbufs=%d)"
                            " — dropping connection", self.rank, peer, ctl_len, nbufs)
                self._drop_peer(peer, st)
                return 0
            st.ctl_len, st.nbufs = ctl_len, nbufs
            st.phase = "lens"
            st.target = memoryview(bytearray(_BUFLEN.size * nbufs)) \
                if nbufs else st.target
            st.got = 0
            if nbufs == 0:
                st.lens = []
                st.phase = "ctl"
                st.target = memoryview(bytearray(st.ctl_len))
            return 0
        if st.phase == "lens":
            st.lens = [_BUFLEN.unpack_from(st.target, i * _BUFLEN.size)[0]
                       for i in range(st.nbufs)]
            if sum(st.lens) > self.max_frame:
                debug.error("rank %d: oversized payload from %d (%d bytes) — "
                            "dropping connection", self.rank, peer, sum(st.lens))
                self._drop_peer(peer, st)
                return 0
            st.phase = "ctl"
            st.target = memoryview(bytearray(st.ctl_len))
            st.got = 0
            return 0
        if st.phase == "ctl":
            st.ctl = bytes(st.target)
            st.bufs, st.bufi = [], 0
            return self._rx_next_buf(peer, st)
        # payload buffer st.bufi filled
        st.bufi += 1
        return self._rx_next_buf(peer, st)

    def _rx_next_buf(self, peer: int, st: _RecvState) -> int:
        if st.bufi < st.nbufs:
            copy = self._rx_alloc(st.lens[st.bufi])
            st.bufs.append(copy)
            st.phase = "buf"
            st.target = memoryview(copy.payload)[:st.lens[st.bufi]]
            st.got = 0
            return 0
        delivered = self._rx_deliver(st)
        st.reset()
        return delivered

    @property
    def _rx_arenas(self) -> Dict[int, Any]:
        """Size-class view of the receive pool (diagnostics/tests)."""
        return self._rx_pool._classes

    def _rx_alloc(self, nbytes: int):
        """Arena slot for an incoming payload: power-of-two size classes
        of raw bytes, recycled across frames (reference arena-backed
        receives)."""
        return self._rx_pool.allocate(nbytes)

    def _rx_deliver(self, st: _RecvState) -> int:
        """Frame complete: rebuild the batch with arrays aliasing the
        arena slots, dispatch.  Slot lifetime rides the buffer-reference
        chain, not structure inspection: pickle.loads is handed a
        memoryview of a *holder* ndarray view per slot, and anything
        reconstructed over that buffer keeps the memoryview — hence the
        holder — alive (PEP 3118 exporter chain; works for arrays nested
        in ANY container, custom objects included).  A weakref finalizer
        on the holder returns the slot exactly when the last consumer
        dies; if nothing aliased the buffer the holder dies as soon as
        this frame's locals do."""
        holders = []
        views = []
        for c, ln in zip(st.bufs, st.lens):
            holder = c.payload[:ln]  # ndarray view: weakref-able anchor
            weakref.finalize(holder, c.arena.release, c)
            holders.append(holder)
            views.append(memoryview(holder))
        try:
            src, batch, pb, fid = pickle.loads(st.ctl, buffers=views)
        except Exception as e:
            debug.error("rank %d: undecodable frame: %s", self.rank, e)
            return 0  # finalizers recycle the slots as holders die
        finally:
            del views, holders  # only consumer chains keep slots alive now
        if pins.active(pins.HB_FRAME_DELIVER):
            pins.fire(pins.HB_FRAME_DELIVER, None,
                      {"rank": self.rank, "peer": src, "frame": fid})
        self._pb_incoming(src, pb)  # state first: it describes the sender
        # as of (at latest) this frame's messages
        # recv span: one frame's dispatch (unpickle already done above;
        # the span is the AM handlers' own work — release_deps etc.)
        wire = pins.active(pins.COMM_RECV_BEGIN)
        if wire:
            pins.fire(pins.COMM_RECV_BEGIN, None,
                      {"rank": self.rank, "peer": src,
                       "bytes": len(st.ctl) + sum(st.lens)})
        n = 0
        try:
            for tag, payload in batch:
                self._dispatch(tag, src, payload)
                n += 1
        finally:
            if wire:
                pins.fire(pins.COMM_RECV_END, None,
                          {"rank": self.rank, "peer": src})
        return n

    def _rx_abort(self, st: _RecvState) -> None:
        """Mid-frame EOF/teardown: recycle any half-filled arena slots."""
        for c in st.bufs:
            try:
                c.arena.release(c)
            except Exception:
                pass
        st.reset()

    def _drop_peer(self, peer: int, st: _RecvState) -> None:
        self._rx_abort(st)
        s = self._socks.pop(peer, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _dispatch(self, tag: int, src: int, payload: Any) -> None:
        if src != self.rank:
            self._termdet_note_recv(tag)  # self-sends count on neither side
        with self._am_lock:
            cb = self._am.get(tag)
            if cb is None:
                self._unclaimed[tag].append((src, payload))
                return
        self.stats[f"am_recv_{tag}"] += 1
        try:
            cb(src, payload)
        except Exception as e:
            debug.error("rank %d: AM callback tag %d raised: %s", self.rank, tag, e)
            import traceback

            traceback.print_exc()

    # -- CE vtable misc ---------------------------------------------------
    #: a dedicated comm thread owns the sockets and drives all progress —
    #: callers blocked on comm completions (coll wait) should SLEEP on
    #: their condvar, not spin-pump (the reference's funnelled mode)
    self_progressing = True

    def progress_nonblocking(self) -> int:
        # a dedicated comm thread owns the sockets; workers have nothing
        # to drive (reference multi-node mode: comm thread does it all)
        return 0

    def detach_context(self, context) -> None:
        self.close()

    def close(self) -> None:
        """Initiate the FIN handshake and join the comm thread.  Returns
        once every queued frame reached the kernel and every live peer
        confirmed (via its own FIN) that it will send nothing more — i.e.
        closing the sockets below cannot discard anything a peer is still
        blocked on."""
        if self._closing.is_set():
            return
        self._closing.set()
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass
        # must outlast one full wedged send + the FIN wait: closing the
        # sockets under a comm thread still mid-frame would truncate a
        # peer's length-prefixed stream
        self._thread.join(timeout=self.send_timeout + self.close_timeout + 5.0)
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


def endpoint_from_env() -> TCPComm:
    """Build this process's endpoint from the launcher environment
    (``PARSEC_TPU_RANK`` / ``_NRANKS`` / ``_RDV`` or ``_PEERS``)."""
    rank = int(os.environ["PARSEC_TPU_RANK"])
    nranks = int(os.environ["PARSEC_TPU_NRANKS"])
    peers = os.environ.get("PARSEC_TPU_PEERS")
    return TCPComm(
        rank, nranks,
        rendezvous_dir=os.environ.get("PARSEC_TPU_RDV"),
        peers=peers.split(",") if peers else None,
    )
