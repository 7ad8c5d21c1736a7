"""Communication-engine abstraction (MCA framework ``comm``).

Reference: ``parsec/parsec_comm_engine.{c,h}`` — a
backend-neutral vtable ``parsec_ce`` with active messages
(``tag_register``/``send_am``), one-sided ``put``/``get`` on registered
memory, ``progress``, and capability bits; a fixed tag space of 12 AM tags
(``parsec_comm_engine.h:24-40``). The reference ships one backend (MPI
funnelled, single comm thread); here the backends are:

* ``inproc``  — N ranks inside one process (threads + queues), the test
  fabric and the one-card multi-rank path (the reference tests
  "multi-node" as multi-process on one node — same idea one level down);
* ``tcp``     — one rank a process over TCP sockets, a funnelled comm
  thread owning them (:mod:`.tcp`; :mod:`.launch` starts the ranks).

Every engine carries the runtime collectives (:mod:`.coll`, ``ce.coll``
and the ``coll_*`` conveniences).

Payloads are Python objects (tuples, numpy arrays, torch tensors); a wire
backend would serialize them — the protocol layer (:mod:`.remote_dep`)
never assumes shared memory except through ``put``/``get``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, TYPE_CHECKING

from ..utils import Component, debug, mca_param

if TYPE_CHECKING:  # pragma: no cover
    from ..core.context import Context

# AM tag space (reference parsec_comm_engine.h:24-40)
TAG_ACTIVATE = 0        # dependency activation (remote_dep wire_activate)
TAG_GET = 1             # payload pull request
TAG_PUT = 2             # payload push / get answer
TAG_TERMDET = 3         # termination-detection waves (fourcounter)
TAG_CTL = 4             # generic control
TAG_DTD = 5             # DTD tile-version transfers (shadow-task protocol)
TAG_USER_BASE = 6
MAX_AM_TAGS = 12

#: wire-protocol defaults — single source of truth for the engine class
#: attributes, ``_init_protocol``'s registrations, and the protocol
#: layer's own (idempotent) re-registrations in ``remote_dep``
EAGER_LIMIT_DEFAULT = 8192
PIPELINE_DEPTH_DEFAULT = 4
RDV_CHUNK_DEFAULT = 256 << 10


class CommEngine(Component):
    """Backend vtable. One instance per rank."""

    mca_type = "comm"

    rank: int = 0
    nranks: int = 1

    # -- wire-protocol tunables (reference: the eager/rendezvous split of
    # remote_dep_mpi.c — parsec_param_short_limit / the pipelined GET
    # depth of the put/get handshake).  Registered + VALIDATED at engine
    # construction: a zero/negative depth would not error anywhere on its
    # own, it would simply never issue a chunk request and hang the first
    # large transfer — reject it here with a readable message instead.
    eager_limit: int = EAGER_LIMIT_DEFAULT
    pipeline_depth: int = PIPELINE_DEPTH_DEFAULT
    rdv_chunk: int = RDV_CHUNK_DEFAULT
    coalesce_enabled: bool = True
    #: True when one-sided pull traffic rides AM frames (and is therefore
    #: already inside ``stats["am_bytes"]``) — wire-byte accounting must
    #: not add ``get_bytes`` on top for such engines (TCP's GET answers),
    #: but must for table-served fabrics (inproc) where pulls bypass
    #: frames entirely
    pull_bytes_in_frames: bool = False

    def _init_protocol(self) -> None:
        """Register the comm-protocol MCA params (env-overridable as
        ``PARSEC_MCA_runtime_comm_*``) and validate them.  Called by every
        backend's constructor."""
        self.eager_limit = int(mca_param.register(
            "runtime", "comm_eager_limit", EAGER_LIMIT_DEFAULT,
            help="payloads at or below this many bytes ship inline with "
                 "the activation (eager regime, zero extra round trips); "
                 "larger ones use the pipelined chunked rendezvous"))
        self.pipeline_depth = int(mca_param.register(
            "runtime", "comm_pipeline_depth", PIPELINE_DEPTH_DEFAULT,
            help="in-flight chunk requests per rendezvous transfer"))
        self.rdv_chunk = int(mca_param.register(
            "runtime", "comm_rdv_chunk", RDV_CHUNK_DEFAULT,
            help="rendezvous chunk size (bytes); each chunk is one "
                 "get round-trip, pipeline_depth of them in flight"))
        self.coalesce_enabled = bool(mca_param.register(
            "runtime", "comm_coalesce", True,
            help="coalesce all messages queued for one destination in "
                 "one progress cycle into a single frame"))
        if self.eager_limit < 0:
            raise ValueError(
                f"runtime_comm_eager_limit must be >= 0 (0 sends every "
                f"payload through rendezvous), got {self.eager_limit}")
        if self.pipeline_depth <= 0:
            raise ValueError(
                f"runtime_comm_pipeline_depth must be >= 1 (a transfer "
                f"with no in-flight chunk requests would hang, not "
                f"error), got {self.pipeline_depth}")
        if self.rdv_chunk <= 0:
            raise ValueError(
                f"runtime_comm_rdv_chunk must be >= 1 byte, "
                f"got {self.rdv_chunk}")

    # -- lifecycle ------------------------------------------------------
    def attach_context(self, context: "Context") -> None:
        self.context = context
        from .remote_dep import RemoteDepManager

        self.remote_dep = RemoteDepManager(self)
        # collectives endpoint: created eagerly so the "coll" control op
        # is registered before any peer's first advert can arrive
        _ = self.coll

    #: lazily-built collectives endpoint (bare engines outside a context
    #: build it on first touch — do that BEFORE exchanging collectives)
    _coll_mgr = None
    _coll_lock = threading.Lock()

    @property
    def coll(self):
        """The per-rank :class:`~parsec_tpu_torch.comm.coll.CollManager`."""
        mgr = self._coll_mgr
        if mgr is None:
            with CommEngine._coll_lock:
                mgr = self._coll_mgr
                if mgr is None:
                    from .coll import CollManager

                    mgr = self._coll_mgr = CollManager(self)
        return mgr

    # -- collective conveniences (both backends speak the same ctl-advert
    # + chunked one-sided pull protocol) ---------------------------------
    def coll_allreduce(self, arr, **kw):
        """Nonblocking allreduce; see :meth:`coll.CollManager.allreduce`.
        Returns a handle — ``wait()`` it, read ``result()``."""
        return self.coll.allreduce(arr, **kw)

    def coll_reduce_scatter(self, arr, **kw):
        return self.coll.reduce_scatter(arr, **kw)

    def coll_allgather(self, arr, **kw):
        return self.coll.allgather(arr, **kw)

    def coll_bcast(self, arr, **kw):
        return self.coll.bcast(arr, **kw)

    def detach_context(self, context: "Context") -> None:
        pass

    def new_taskpool(self, tp) -> None:
        """Reference DEP_NEW_TASKPOOL: taskpools register so incoming
        activations can resolve them (unknown ones are parked)."""
        rd = getattr(self, "remote_dep", None)
        if rd is not None:
            rd.new_taskpool(tp)

    # -- active messages ------------------------------------------------
    def register_am(self, tag: int, cb: Callable[[int, Any], None]) -> None:
        """cb(src_rank, payload) runs during ``progress``."""
        raise NotImplementedError

    def send_am(self, tag: int, dst_rank: int, payload: Any,
                priority: int = 0) -> None:
        """Queue an active message.  ``priority`` orders messages that
        share one coalesced frame / drain cycle (higher leaves first —
        critical-path tiles ahead of bulk updates); FIFO is preserved
        among equal priorities, and ordering never crosses progress
        cycles, so control handshakes queued in an earlier cycle are
        never overtaken."""
        raise NotImplementedError

    def register_ctl(self, op: str, cb: Callable[[int, Any], None]) -> None:
        """Share the single generic-control tag among independent
        protocols: ``TAG_CTL`` frames are dicts carrying an ``"op"`` key,
        and this registers ``cb(src_rank, msg)`` for one op.  The first
        call installs a dispatching AM handler that persists for the
        engine's lifetime; later registrations (clock handshakes at every
        pool start, a watchdog's heartbeat channel) replace only their own
        op — they can no longer silently unhook each other the way raw
        ``register_am(TAG_CTL, ...)`` calls did."""
        with CommEngine._ctl_install_lock:
            # first-install must be atomic: two threads racing here
            # (concurrent pool starts each running a clock handshake)
            # would otherwise build two dispatchers and the loser's ops
            # would be silently unhooked
            ops = getattr(self, "_ctl_ops", None)
            if ops is None:
                ops = self._ctl_ops = {}

                def _dispatch(src_rank: int, msg: Any) -> None:
                    fn = ops.get(msg.get("op")) \
                        if isinstance(msg, dict) else None
                    if fn is None:
                        debug.verbose(
                            3, "comm", "unhandled CTL op %r from %d",
                            msg.get("op") if isinstance(msg, dict)
                            else msg, src_rank)
                        return
                    fn(src_rank, msg)

                self.register_am(TAG_CTL, _dispatch)
            ops[op] = cb

    #: guards the one-time _ctl_ops installation above
    _ctl_install_lock = threading.Lock()

    @contextlib.contextmanager
    def coalesce(self):
        """Coalescing window: messages sent inside nest into per-
        destination queues and flush as ONE frame per destination when
        the outermost window closes (the per-peer aggregation of the
        reference comm thread, remote_dep_mpi.c:1066-1190).  Backends
        with a dedicated comm thread already aggregate at drain time and
        keep this a no-op; synchronous fabrics buffer."""
        yield

    # -- piggyback channel (reference termdet.h:153-232: termination-
    # detection state rides APPLICATION messages; dedicated waves are the
    # idle-time fallback only) -------------------------------------------
    #: provider() -> small picklable state or None, stamped on every
    #: outgoing frame; consumer(src_rank, state) runs per received frame
    _pb_provider: Optional[Callable[[], Any]] = None
    _pb_consumer: Optional[Callable[[int, Any], None]] = None

    def set_piggyback(self, provider: Optional[Callable[[], Any]],
                      consumer: Optional[Callable[[int, Any], None]]) -> None:
        """Install the piggyback channel.  The state must be tiny (it
        travels on EVERY frame) and monotonic/self-describing (frames can
        be reordered relative to the wave protocol)."""
        self._pb_provider = provider
        self._pb_consumer = consumer

    def _pb_outgoing(self) -> Any:
        if self._pb_provider is None:
            return None
        try:
            return self._pb_provider()
        except Exception as e:  # a broken provider must not kill sends
            debug.error("piggyback provider raised: %s", e)
            return None

    def _pb_incoming(self, src_rank: int, state: Any) -> None:
        if state is None or self._pb_consumer is None:
            return
        try:
            self._pb_consumer(src_rank, state)
        except Exception as e:
            debug.error("piggyback consumer raised: %s", e)

    # -- distributed-termdet message accounting (the four counters):
    # every non-TERMDET message is counted at the CE boundary on both
    # sides, so a wave observing idle ranks with sent != recv knows a
    # message is still in flight (reference termdet.h:153-232).  The
    # counters live on the CE and count from CONSTRUCTION — a message
    # delivered before a rank's monitor binds (startup skew) must still
    # be in the totals, or sent/recv never balances and termination is
    # never concluded.  Cumulative totals are fine: balance at quiesce
    # holds regardless of when counting started, as long as both sides
    # counted every message.
    termdet_sent: int = 0
    termdet_recv: int = 0
    #: send_am is called from arbitrary threads; += is not atomic
    _termdet_lock = threading.Lock()

    def _termdet_note_sent(self, tag: int) -> None:
        if tag != TAG_TERMDET:  # waves must not count as app traffic
            with CommEngine._termdet_lock:
                self.termdet_sent += 1

    def _termdet_note_recv(self, tag: int) -> None:
        if tag != TAG_TERMDET:
            with CommEngine._termdet_lock:
                self.termdet_recv += 1

    # -- one-sided ------------------------------------------------------
    def mem_register(self, handle: Any, buffer: Any, once: bool = False,
                     uses: Optional[int] = None) -> None:
        """Expose ``buffer`` for one-sided GETs under ``handle``. With
        ``once`` the registration is consumed by the first GET served —
        used for single-consumer transfers (e.g. DTD tile versions) so
        epoch-keyed handles don't pin buffers forever.  ``uses=N``
        generalizes: the registration self-reclaims after serving N GETs
        (activation payloads know their consumer count up front)."""
        raise NotImplementedError

    def mem_unregister(self, handle: Any) -> None:
        raise NotImplementedError

    def get(self, src_rank: int, handle: Any, on_done: Callable[[Any], None]) -> None:
        """Pull a registered remote buffer; on_done(buffer) fires locally."""
        raise NotImplementedError

    def get_part(self, src_rank: int, handle: Any, offset: int,
                 length: int, on_done: Callable[[Any], None],
                 fin: bool = False, priority: int = 0) -> None:
        """Pull ``length`` bytes at byte ``offset`` of a registered remote
        buffer (the pipelined rendezvous chunk fetch; reference: the
        chunked wire_get of remote_dep_mpi.c's put/get handshake).
        ``on_done(chunk)`` receives a byte-addressable array (or None on
        a protocol error).  ``fin`` marks the LAST chunk this consumer
        will request: use-counted registrations decrement exactly once
        per consumer, on the fin request, so a chunked transfer counts
        like one GET."""
        raise NotImplementedError

    # -- datatype serialization (reference CE pack/unpack slots,
    # parsec_comm_engine.h:190-195) --------------------------------------
    def pack(self, dtype, buffer, offset: int = 0):
        """Gather ``buffer`` data described by
        :class:`~parsec_tpu_torch.data.datatype.Datatype` ``dtype`` into
        contiguous wire form."""
        return dtype.pack(buffer, offset)

    def unpack(self, dtype, raw, buffer, offset: int = 0) -> None:
        """Scatter contiguous wire data back through ``dtype``'s layout."""
        dtype.unpack(raw, buffer, offset)

    # -- progress -------------------------------------------------------
    def progress_nonblocking(self) -> int:
        """Drain pending incoming messages; returns #messages handled.
        Driven from worker idle loops (single-node mode of the reference,
        ``scheduling.c:712-722``) and/or a dedicated comm thread."""
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError
