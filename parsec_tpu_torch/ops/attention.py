"""Attention as a task graph: blockwise flash attention and distributed
ring attention.

The port of :mod:`parsec_tpu.ops.attention`.

* :func:`flash_attention_ptg` — single-rank blockwise flash attention:
  task class ``attn_step(g, i, s)`` threads the online-softmax carry
  ``(acc, m, l)`` of query block ``i`` (group ``g`` = one (batch, head)
  plane) through the KV blocks ``s``; ``attn_out(g, i)`` normalises
  ``acc / l`` into the output block.
* :func:`ring_attention_ptg` — distributed ring attention: each rank owns
  one query block and one resident K/V block; per step ``s`` rank ``r``
  computes against K/V block ``(r + s) % R`` and forwards it one
  neighbour hop (``variant="ring"``, the rotation is ordinary remote
  dependencies on the comm engine's wire), or takes each block from its
  owner's broadcast (``variant="bcast"``).

A step's CUDA chore is the hand-written kernel
:func:`parsec_tpu_torch.ops.kernels.flash_attention_block` (B5), its CPU
chore the same update in numpy.  Host planes are torch CPU tensors, so
bfloat16 q/k/v need no numpy bfloat16: the CUDA module stages torch host
tiles as they are, and a CPU chore widens them to float32 numpy.  The
carries are float32 numpy tiles.

:func:`run_flash_attention` drives the flash graph through a live
context's dynamic runtime, :func:`run_flash_attention_native` through the
native engine's pump, :func:`run_ring_attention_graph` the ring graph over
in-process ranks (:func:`~parsec_tpu_torch.multirank.run_multirank_perf`).
``"auto"`` block sizes read the autotuner's winners for the sequence
length and the card (:func:`..tuning.autotune_attention`), else
``min(128, S)``, as the reference's.

The numerics oracle is
:func:`parsec_tpu_torch.parallel.attention_reference`.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tuning
from ..core.lifecycle import AccessMode
from ..data.collection import DataCollection
from ..data.data import Data, data_create, host_array
from ..dsl.ptg import PTG
from ..profiling import pins
from . import kernels

IN = AccessMode.IN
OUT = AccessMode.OUT
INOUT = AccessMode.INOUT

#: finite "-inf" used to initialise the running max ``m`` (keeps ``exp()``
#: NaN-free on fully-masked causal blocks)
NEG_BIG = -1e30


def block_splits(n: int, block: int) -> List[Tuple[int, int]]:
    """``(offset, size)`` per block of an ``n``-long axis; the tail block
    is ragged when ``block`` does not divide ``n``."""
    if block <= 0:
        raise ValueError(f"block size must be positive (got {block})")
    return [(o, min(block, n - o)) for o in range(0, n, block)]


# ---------------------------------------------------------------------------
# collections: per-(group, block) planes of a [B, S, H, D] tensor
# ---------------------------------------------------------------------------

class PlaneCollection(DataCollection):
    """Lazily-materialised planes keyed ``(g, j)`` — group ``g`` is one
    (batch, head) pair, ``j`` a sequence-block index.  ``init(g, j)``
    builds the tile (a torch CPU tensor is kept as it is, anything else
    becomes an ndarray) on its first :meth:`data_of`, a ``materialize``
    span of the job open there; ``keys`` declares the planes (:meth:`tiles`);
    ``rank_of`` (optional) distributes block ``j`` (ring attention places
    block ``j`` on rank ``j``).  ``blank``: the init returns uninitialised
    tiles (``torch.empty``), the home of a write-only flow.

    ``stats`` counts what the inits handed out: ``view_tiles`` (views of
    memory the init did not make — the caller's), ``blank_tiles``, and
    ``copied_tiles`` with their ``copied_bytes`` (tiles an init copied or
    filled).  The ``materialize`` span's ``bytes`` is a tile's copied
    bytes: 0 for a view or a blank tile."""

    def __init__(self, name: str, init: Callable[[int, int], object], *,
                 keys: Sequence[Tuple[int, int]] = (), nodes: int = 1,
                 myrank: int = 0,
                 rank_of: Optional[Callable[[int, int], int]] = None,
                 blank: bool = False):
        super().__init__(name, nodes=nodes, myrank=myrank)
        self._init = init
        self._keys = [tuple(k) for k in keys]
        self._rank_of = rank_of
        self._blank = blank
        self._store: Dict[Tuple[int, int], Data] = {}
        self._lock = threading.Lock()
        self.stats = {"view_tiles": 0, "blank_tiles": 0, "copied_tiles": 0,
                      "copied_bytes": 0}

    def data_key(self, *key):
        if len(key) == 1 and isinstance(key[0], tuple):
            key = key[0]
        g, j = key
        return (int(g), int(j))

    def rank_of(self, *key) -> int:
        if self._rank_of is None:
            return 0
        g, j = self.data_key(*key)
        return self._rank_of(g, j)

    def data_of(self, *key) -> Data:
        k = self.data_key(*key)
        with self._lock:
            d = self._store.get(k)
            if d is None:
                with pins.span("materialize", tiles=1) as info:
                    tile = self._init(*k)
                    if not isinstance(tile, torch.Tensor):
                        tile = np.asarray(tile)
                    copied = self._count(tile)
                    if info is not None:
                        info["bytes"] = copied
                d = data_create(k, self, payload=tile)
                self._store[k] = d
            return d

    def _count(self, tile) -> int:
        """Count ``tile`` in :attr:`stats`; returns its copied bytes."""
        base = tile._base if isinstance(tile, torch.Tensor) else tile.base
        if base is not None:
            self.stats["view_tiles"] += 1
            return 0
        if self._blank:
            self.stats["blank_tiles"] += 1
            return 0
        self.stats["copied_tiles"] += 1
        self.stats["copied_bytes"] += int(tile.nbytes)
        return int(tile.nbytes)

    def tiles(self):
        return list(self._keys)

    def local_tiles(self):
        """Declared keys owned by this rank — the explorer's
        :func:`~parsec_tpu_torch.analysis.schedules.tile_digest` currency."""
        for key in self._keys:
            if self.rank_of(*key) == self.myrank:
                yield key


# ---------------------------------------------------------------------------
# task bodies (cuda = the hand-written kernel; cpu = numpy)
# ---------------------------------------------------------------------------

def _f32(x) -> np.ndarray:
    """float32 numpy values of a host tile (an ndarray, or a torch CPU
    tensor — the form bfloat16 tiles take on the host)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return x.astype(np.float32)


def _make_step_body_cuda(q_block: int, kv_block: int, causal: bool,
                         scale: float, q_offset: int):
    # the step reads i and s (its block offsets), not g: same-offset steps
    # of every group share one wave signature
    def attn_step(QB, KB, VB, ACC, M, L, i, s, **_):
        return kernels.flash_attention_block(
            QB, KB, VB, ACC, M, L, q_offset + i * q_block, s * kv_block,
            causal=causal, scale=float(scale))

    return attn_step


def _np_step(QB, KB, VB, ACC, M, L, q_off: int, k_off: int,
             causal: bool, scale: float) -> None:
    """One in-place numpy online-softmax block update (the CPU
    incarnation; mirrors the kernel's -inf masking discipline)."""
    logits = (_f32(QB) @ _f32(KB).T) * scale
    if causal:
        qpos = q_off + np.arange(logits.shape[0])[:, None]
        kpos = k_off + np.arange(logits.shape[1])[None, :]
        logits = np.where(qpos >= kpos, logits, -np.inf)
    m_new = np.maximum(M, logits.max(axis=-1, keepdims=True))
    p = np.exp(logits - m_new)          # -inf - finite -> 0 exactly
    corr = np.exp(M - m_new)
    L *= corr
    L += p.sum(axis=-1, keepdims=True)
    ACC *= corr
    ACC += p @ _f32(VB)
    M[:] = m_new


def _make_step_body_cpu(q_block: int, kv_block: int, causal: bool,
                        scale: float, q_offset: int):
    def attn_step(QB, KB, VB, ACC, M, L, **kw):
        i, s = kw["i"], kw["s"]
        _np_step(QB, KB, VB, ACC, M, L, q_offset + i * q_block,
                 s * kv_block, causal, scale)

    return attn_step


def _make_ring_step_body_cuda(q_block: int, kv_block: int, causal: bool,
                              scale: float, block_rem: int):
    def attn_rstep(QB, KB, VB, ACC, M, L, r, ki, **_):
        # balanced splits: the first block_rem blocks are one row
        # taller, so block idx starts at idx*base + min(idx, rem)
        return kernels.flash_attention_block(
            QB, KB, VB, ACC, M, L, r * q_block + min(r, block_rem),
            ki * kv_block + min(ki, block_rem), causal=causal, scale=float(scale))

    return attn_rstep


def _make_ring_step_body_cpu(q_block: int, kv_block: int, causal: bool,
                             scale: float, block_rem: int):
    def attn_rstep(QB, KB, VB, ACC, M, L, **kw):
        r, ki = kw["r"], kw["ki"]
        _np_step(QB, KB, VB, ACC, M, L,
                 r * q_block + min(r, block_rem),
                 ki * kv_block + min(ki, block_rem), causal, scale)

    return attn_rstep


def _attn_out_cuda(ACC, M, L, O, **_):
    return (ACC / L).to(O.dtype)


def _attn_out_cpu(ACC, M, L, O, **_):
    if isinstance(O, torch.Tensor):
        O.copy_(torch.from_numpy(ACC / L))  # rounds to O's dtype
    else:
        O[:] = (ACC / L).astype(O.dtype)


def _kvsrc_cuda(KB, VB, **_):
    return ()  # pure forward: no writable flows


def _kvsrc_cpu(KB, VB, **_):
    pass


def _bodies(pc, cuda_body, cpu_body, use_cuda: bool, use_cpu: bool) -> None:
    kw = {}
    if use_cuda:
        kw["cuda"] = cuda_body
    if use_cpu:
        kw["cpu"] = cpu_body
    if not kw:
        raise ValueError(f"{pc.name}: no BODY selected (use_cuda and use_cpu "
                         "are both False)")
    pc.body(**kw)


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------

#: per-query-block causal horizon: the LAST kv-block index whose span
#: intersects query block i's allowed region — blocks beyond it are
#: entirely above the diagonal and their online-softmax update is a
#: provable no-op (p == 0, corr == 1), so causal graphs do not even
#: instantiate those step tasks.  Needs the taskpool constants QB / KVB
#: / QOFF / SQ next to NK.
_CAUSAL_HZ = "min(NK-1, (QOFF + min((i+1)*QB, SQ) - 1) // KVB)"


def flash_attention_ptg(*, causal: bool = False, scale: float = 1.0,
                        q_block: int = 128, kv_block: int = 128,
                        q_offset: int = 0,
                        use_cuda: bool = True, use_cpu: bool = True) -> PTG:
    """Single-rank blockwise flash attention.  Instantiate with
    ``.taskpool(G=, NQ=, NK=, QB=, KVB=, QOFF=, SQ=, Q=, K=, V=, O=,
    CA=, CM=, CL=)`` where the collections are keyed ``(g, block)``:
    ``Q(g, i)``/``O(g, i)`` are ``(sq_i, D)`` query/output blocks (O
    write-only: its home tile is never read),
    ``K(g, s)``/``V(g, s)`` are ``(sk_s, D)`` KV blocks, and
    ``CA``/``CM``/``CL`` hold the per-query-block carry initials
    (zeros, ``NEG_BIG``, zeros); the scalar constants repeat the block
    geometry (``QB``/``KVB`` block sizes, ``QOFF`` global query offset,
    ``SQ`` query length) so the causal step range can stop at each
    block's horizon.  ``q_offset`` shifts the global query positions
    (decode: queries live at the tail of the KV sequence).
    :func:`build_flash_attention` assembles all of this from
    ``[B, S, H, D]`` tensors."""
    ptg = PTG("flash_attn")

    # hz = last kv step of query block i: causal graphs stop the carry
    # chain at the diagonal block instead of dispatching no-op tasks
    st = ptg.task_class("attn_step", g="0 .. G-1", i="0 .. NQ-1")
    st.define("hz", _CAUSAL_HZ if causal else "NK-1")
    st.param("s", "0 .. hz")
    st.affinity("Q(g, i)")
    st.priority("NK - s")  # drain each carry chain front-first
    st.flow("QB", IN, "<- Q(g, i)")
    st.flow("KB", IN, "<- K(g, s)")
    st.flow("VB", IN, "<- V(g, s)")
    for name, coll in (("ACC", "CA"), ("M", "CM"), ("L", "CL")):
        st.flow(name, INOUT,
                f"<- (s == 0) ? {coll}(g, i) : {name} attn_step(g, i, s-1)",
                f"-> (s < hz) ? {name} attn_step(g, i, s+1) "
                f": {name} attn_out(g, i)")
    _bodies(st,
            _make_step_body_cuda(q_block, kv_block, causal, scale, q_offset),
            _make_step_body_cpu(q_block, kv_block, causal, scale, q_offset),
            use_cuda, use_cpu)

    out = ptg.task_class("attn_out", g="0 .. G-1", i="0 .. NQ-1")
    out.define("hz", _CAUSAL_HZ if causal else "NK-1")
    out.affinity("Q(g, i)")
    out.priority("0")
    out.flow("ACC", IN, "<- ACC attn_step(g, i, hz)")
    out.flow("M", IN, "<- M attn_step(g, i, hz)")
    out.flow("L", IN, "<- L attn_step(g, i, hz)")
    # write-only: both bodies overwrite O whole, so its home is never
    # staged in (the device module hands the CUDA body device-side zeros)
    out.flow("O", OUT, "<- O(g, i)", "-> O(g, i)")
    _bodies(out, _attn_out_cuda, _attn_out_cpu, use_cuda, use_cpu)
    return ptg


def ring_attention_ptg(*, causal: bool = False, scale: float = 1.0,
                       q_block: int = 128, kv_block: int = 128,
                       block_rem: int = 0,
                       variant: str = "ring",
                       use_cuda: bool = True, use_cpu: bool = True) -> PTG:
    """Distributed ring attention over ``R`` ranks: rank ``r`` owns query
    block ``r`` and (initially) K/V block ``r``; instantiate with
    ``.taskpool(G=, R=, Q=, K=, V=, O=, CA=, CM=, CL=)`` where the
    collections place block ``j`` on rank ``j`` (``rank_of``).

    ``variant="ring"``: step ``s`` of rank ``r`` computes against K/V
    block ``ki = (r + s) % R``, received from neighbour ``(r + 1) % R``'s
    step ``s-1`` and forwarded to ``(r - 1) % R``'s step ``s+1`` — the
    rotation is nothing but remote dependencies, so the payloads ride
    the eager/rendezvous protocol and the transfer of step ``s+1``'s
    block overlaps step ``s``'s compute.

    ``variant="bcast"``: the carry chain is reindexed by KV block
    (``attn_bstep(g, r, j)`` consumes block ``j`` directly from its
    owner's ``attn_kvsrc(g, j)`` forward task, one ranged output dep =
    the runtime's activation broadcast tree).  Accumulation order is
    block order on every rank; correct for causal too, but built for
    the non-causal case where order is free.

    ``block_rem``: with balanced splits of a non-dividing sequence the
    first ``block_rem`` blocks are one row taller; the step bodies
    compute global offsets as ``idx*block + min(idx, block_rem)``.
    Unlike the flash graph, causal ring graphs keep their fully-masked
    steps: the block must still TRANSIT the rank to reach later
    consumers on the rotation path, and a masked block's kernel update
    is exactly the identity on the carry."""
    if variant not in ("ring", "bcast"):
        raise ValueError(f"unknown ring-attention variant {variant!r} "
                         "(expected 'ring' or 'bcast')")
    ptg = PTG(f"ring_attn_{variant}")
    cuda_step = _make_ring_step_body_cuda(q_block, kv_block, causal, scale, block_rem)
    cpu_step = _make_ring_step_body_cpu(q_block, kv_block, causal, scale, block_rem)

    if variant == "ring":
        st = ptg.task_class("attn_rstep", g="0 .. G-1", r="0 .. R-1",
                            s="0 .. R-1")
        st.define("ki", "(r + s) % R")
        st.affinity("Q(g, r)")
        st.priority("(R - s) * 10")
        st.flow("QB", IN, "<- Q(g, r)")
        # the rotation: K/V blocks hop one neighbour per step.  `s` is the
        # step index, so the producing neighbour is always its step s-1 —
        # reciprocity holds under the modular index arithmetic.
        st.flow("KB", IN,
                "<- (s == 0) ? K(g, r) : KB attn_rstep(g, (r+1) % R, s-1)",
                "-> (s < R-1) ? KB attn_rstep(g, (r-1) % R, s+1)")
        st.flow("VB", IN,
                "<- (s == 0) ? V(g, r) : VB attn_rstep(g, (r+1) % R, s-1)",
                "-> (s < R-1) ? VB attn_rstep(g, (r-1) % R, s+1)")
        for name, coll in (("ACC", "CA"), ("M", "CM"), ("L", "CL")):
            st.flow(name, INOUT,
                    f"<- (s == 0) ? {coll}(g, r) "
                    f": {name} attn_rstep(g, r, s-1)",
                    f"-> (s < R-1) ? {name} attn_rstep(g, r, s+1) "
                    f": {name} attn_out(g, r)")
        _bodies(st, cuda_step, cpu_step, use_cuda, use_cpu)
        step_name = "attn_rstep"
    else:
        # bcast variant: every rank's carry visits KV blocks in block
        # order j, each block broadcast once by its owner's forward task
        src = ptg.task_class("attn_kvsrc", g="0 .. G-1", j="0 .. R-1")
        src.affinity("K(g, j)")
        src.priority("1000")  # ship KV blocks before anything computes
        src.flow("KB", IN, "<- K(g, j)",
                 "-> KB attn_bstep(g, 0 .. R-1, j)")
        src.flow("VB", IN, "<- V(g, j)",
                 "-> VB attn_bstep(g, 0 .. R-1, j)")
        _bodies(src, _kvsrc_cuda, _kvsrc_cpu, use_cuda, use_cpu)

        st = ptg.task_class("attn_bstep", g="0 .. G-1", r="0 .. R-1",
                            j="0 .. R-1")
        st.define("ki", "j")
        st.affinity("Q(g, r)")
        st.priority("(R - j) * 10")
        st.flow("QB", IN, "<- Q(g, r)")
        st.flow("KB", IN, "<- KB attn_kvsrc(g, j)")
        st.flow("VB", IN, "<- VB attn_kvsrc(g, j)")
        for name, coll in (("ACC", "CA"), ("M", "CM"), ("L", "CL")):
            st.flow(name, INOUT,
                    f"<- (j == 0) ? {coll}(g, r) "
                    f": {name} attn_bstep(g, r, j-1)",
                    f"-> (j < R-1) ? {name} attn_bstep(g, r, j+1) "
                    f": {name} attn_out(g, r)")
        _bodies(st, cuda_step, cpu_step, use_cuda, use_cpu)
        step_name = "attn_bstep"

    out = ptg.task_class("attn_out", g="0 .. G-1", r="0 .. R-1")
    out.affinity("Q(g, r)")
    out.priority("0")
    out.flow("ACC", IN, f"<- ACC {step_name}(g, r, R-1)")
    out.flow("M", IN, f"<- M {step_name}(g, r, R-1)")
    out.flow("L", IN, f"<- L {step_name}(g, r, R-1)")
    out.flow("O", INOUT, "<- O(g, r)", "-> O(g, r)")
    _bodies(out, _attn_out_cuda, _attn_out_cpu, use_cuda, use_cpu)
    return ptg


# ---------------------------------------------------------------------------
# builders and entry points
# ---------------------------------------------------------------------------

def _resolve_block(value, op_param: str, seq: int, dtype) -> int:
    """``"auto"`` resolves against the tuning store (op ``attention``,
    param ``q_block``/``kv_block``, keyed on the sequence length, the dtype
    and the card), else ``min(128, seq)``; explicit values pass
    through."""
    if value != "auto":
        return int(value)
    default = min(128, seq)
    return int(tuning.resolve_nb("attention", seq, dtype, param=op_param, default=default))


#: memo of flash-attention PTG *definitions* keyed by every builder
#: argument: a PTG is problem-size-independent and reusable, so rebuilding
#: the class/dep structure per call is pure overhead.  BOUNDED LRU: decode
#: bakes a growing q_offset (Sk - Sq) into the key every step, and an
#: unbounded memo would keep one definition per decode step
_PTG_MEMO: "collections.OrderedDict[Tuple, PTG]" = collections.OrderedDict()
_PTG_MEMO_MAX = 32
_PTG_MEMO_LOCK = threading.Lock()


def _flash_ptg_cached(**kw) -> PTG:
    key = tuple(sorted(kw.items()))
    with _PTG_MEMO_LOCK:
        p = _PTG_MEMO.get(key)
        if p is None:
            p = _PTG_MEMO[key] = flash_attention_ptg(**kw)
        _PTG_MEMO.move_to_end(key)
        while len(_PTG_MEMO) > _PTG_MEMO_MAX:
            _PTG_MEMO.popitem(last=False)
        return p


def _carry_inits(D: int, q_sizes: Sequence[int]):
    """(CA, CM, CL) init callables for the per-query-block carries."""
    def ca(g, i):
        return np.zeros((q_sizes[i], D), np.float32)

    def cm(g, i):
        return np.full((q_sizes[i], 1), NEG_BIG, np.float32)

    def cl(g, i):
        return np.zeros((q_sizes[i], 1), np.float32)

    return ca, cm, cl


def _host_tensor(x) -> torch.Tensor:
    """A torch CPU tensor holding ``x`` (numpy array or tensor on any
    device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


def build_flash_attention(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None,
                          q_block="auto", kv_block="auto",
                          q_offset: Optional[int] = None,
                          use_cuda: bool = True, use_cpu: bool = True,
                          out_dtype: Optional[torch.dtype] = None):
    """Build the single-rank flash-attention taskpool for ``[B, S, H, D]``
    numpy arrays or torch tensors (``q`` may be shorter than ``k``/``v`` —
    the decode shape).  Returns ``(taskpool, assemble)`` where
    ``assemble()`` reads the output collection back into one
    ``[B, Sq, H, D]`` torch CPU tensor after the pool quiesced.

    ``q_offset`` is the global position of query row 0 for the causal
    mask; it defaults to ``Sk - Sq`` (decode semantics: the queries are
    the tail of the KV sequence).  q, k and v may differ in dtype; the
    steps compute in float32 unless all three are bfloat16.
    ``out_dtype`` (a torch dtype) defaults to q's.

    The Q, K and V planes are views of ``q``, ``k`` and ``v`` (of their
    host form: a tensor on the card is brought home, a non-contiguous
    numpy array made contiguous, once and whole): the caller must not
    write them until the pool has run.  The output planes are write-only,
    uninitialised until their ``attn_out`` task writes them.

    The build is the job's ``taskpool`` span, ``assemble()`` its
    ``assemble`` span (:mod:`..profiling.pins`)."""
    with pins.span("taskpool", job=pins.current_job() or pins.new_job()):
        return _build_flash_attention(q, k, v, causal, scale, q_block, kv_block,
                                      q_offset, use_cuda, use_cpu, out_dtype)


def _build_flash_attention(q, k, v, causal, scale, q_block, kv_block, q_offset,
                           use_cuda, use_cpu, out_dtype):
    q, k, v = _host_tensor(q), _host_tensor(k), _host_tensor(v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if tuple(k.shape) != (B, Sk, H, D) or tuple(v.shape) != (B, Sk, H, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    scale_v = scale if scale is not None else 1.0 / math.sqrt(D)
    if q_offset is None:
        q_offset = Sk - Sq
    if causal and q_offset < 0:
        # a negative offset puts leading query rows BEFORE every key
        # position: those rows are fully masked, their normalizer l
        # stays 0 and attn_out would return silent 0/0 NaNs — the
        # usual cause is swapped prefill arguments (Sq > Sk)
        raise ValueError(
            f"causal attention with q_offset={q_offset} < 0 (Sq={Sq} > "
            f"Sk={Sk}?): leading query rows would attend to nothing; "
            "pass q/k/v with Sq <= Sk or an explicit q_offset >= 0")
    qb = _resolve_block(q_block, "q_block", Sq, q.dtype)
    kvb = _resolve_block(kv_block, "kv_block", Sk, q.dtype)
    qs = block_splits(Sq, qb)
    ks = block_splits(Sk, kvb)
    G = B * H
    odt = out_dtype if out_dtype is not None else q.dtype

    def plane(arr, splits):
        # a strided view of the caller's tensor, never a copy: staging
        # gathers it straight into its pinned buffer
        def init(g, j):
            b, h = divmod(g, H)
            o, n = splits[j]
            return arr[b, o:o + n, h, :]
        return init

    keys_q = [(g, i) for g in range(G) for i in range(len(qs))]
    keys_k = [(g, s) for g in range(G) for s in range(len(ks))]
    Qc = PlaneCollection("Q", plane(q, qs), keys=keys_q)
    Kc = PlaneCollection("K", plane(k, ks), keys=keys_k)
    Vc = PlaneCollection("V", plane(v, ks), keys=keys_k)
    Oc = PlaneCollection("O", lambda g, i: torch.empty((qs[i][1], D), dtype=odt),
                         keys=keys_q, blank=True)
    ca, cm, cl = _carry_inits(D, [n for _, n in qs])
    tp = _flash_ptg_cached(
        causal=causal, scale=scale_v, q_block=qb, kv_block=kvb,
        q_offset=q_offset, use_cuda=use_cuda, use_cpu=use_cpu,
    ).taskpool(G=G, NQ=len(qs), NK=len(ks), QB=qb, KVB=kvb,
               QOFF=q_offset, SQ=Sq,
               Q=Qc, K=Kc, V=Vc, O=Oc,
               CA=PlaneCollection("CA", ca, keys=keys_q),
               CM=PlaneCollection("CM", cm, keys=keys_q),
               CL=PlaneCollection("CL", cl, keys=keys_q))

    def assemble() -> torch.Tensor:
        with pins.span("assemble", job=tp.job, bytes=B * Sq * H * D * odt.itemsize,
                       tiles=G * len(qs)):
            # the splits cover [0, Sq) for every (b, h): the tiles write
            # every element
            out = torch.empty((B, Sq, H, D), dtype=odt)
            for g in range(G):
                b, h = divmod(g, H)
                for i, (o, n) in enumerate(qs):
                    c = Oc.data_of(g, i).newest_copy()
                    out[b, o:o + n, h, :] = _host_tensor(host_array(c.payload))
        return out

    return tp, assemble


def attention_task_count(B: int, Sq: int, Sk: int, H: int,
                         q_block: int, kv_block: int, *,
                         causal: bool = False,
                         q_offset: Optional[int] = None) -> int:
    """Task count of the flash graph: per query block, one step per kv
    block up to its causal horizon (non-causal: all NK), plus the
    normalize task — G * (sum_i (hz_i + 1) + NQ)."""
    if q_offset is None:
        q_offset = Sk - Sq
    nq = (Sq + q_block - 1) // q_block
    nk = (Sk + kv_block - 1) // kv_block
    steps = 0
    for i in range(nq):
        hz = nk - 1
        if causal:
            hz = min(hz, (q_offset + min((i + 1) * q_block, Sq) - 1)
                     // kv_block)
        steps += hz + 1
    return B * H * (steps + nq)


def run_flash_attention(context, q, k, v, *, timeout: float = 600,
                        **kw) -> torch.Tensor:
    """Blockwise flash attention through a live context's dynamic
    runtime; returns the ``[B, Sq, H, D]`` output as a torch CPU tensor.
    The steps run on the context's CUDA device module (the GPU, unless the
    context was bound to the CPU) or, with ``use_cpu``, on host chores."""
    tp, assemble = build_flash_attention(q, k, v, **kw)
    context.add_taskpool(tp)
    if not tp.wait(timeout=timeout):
        raise RuntimeError(f"flash-attention taskpool did not quiesce "
                           f"({tp.fail_reason})")
    return assemble()


def run_flash_attention_native(q, k, v, *, nthreads: int = 4, device=None,
                               fusion=None, **kw) -> torch.Tensor:
    """The same graph through the native C++ engine's pump: every step on
    the CUDA device module (the GPU, unless ``device=`` or
    ``PARSEC_MCA_device_cuda_torch_device=cpu`` says otherwise), with
    scheduling and successor release never entering the interpreter;
    ``nthreads`` is the engine's worker count (``PTGTaskpool.run_native``);
    ``fusion`` (None: the ``runtime_fusion`` MCA param) dispatches each
    fused carry chain as one chore.  Returns the ``[B, Sq, H, D]`` output
    as a torch CPU tensor."""
    for bad in ("use_cpu", "timeout"):
        if bad in kw:
            raise ValueError(
                f"run_flash_attention_native does not take {bad!r} "
                "(device chores only, runs to quiescence); use "
                "run_flash_attention for CPU bodies or timeouts")
    tp, assemble = build_flash_attention(q, k, v, use_cpu=False, **kw)
    tp.run_native(nthreads=nthreads, native_device=True, device=device,
                  fusion=fusion)
    return assemble()


def ring_attention_builder(nranks: int, q, k, v, *,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           variant: str = "ring",
                           use_cuda: bool = True, use_cpu: bool = True):
    """The per-rank builder of the distributed ring-attention PTG — the
    ``build(rank, ctx) -> (taskpool, O-collection)`` shape shared by
    :func:`~parsec_tpu_torch.multirank.run_multirank_perf` and the schedule
    explorer (:func:`parsec_tpu_torch.analysis.schedules.explore`).
    ``q``/``k``/``v`` are ``[B, S, H, D]`` numpy arrays or torch tensors
    (bfloat16 too).  Returns ``(build, assemble)``; call
    ``assemble(users)`` on the per-rank O collections after quiescence for
    the ``[B, S, H, D]`` output, a torch CPU tensor in q's dtype."""
    q, k, v = _host_tensor(q), _host_tensor(k), _host_tensor(v)
    B, S, H, D = q.shape
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError("ring attention needs equal q/k/v shapes")
    scale_v = scale if scale is not None else 1.0 / math.sqrt(D)
    # one block per rank, BALANCED: the first S%R ranks get one extra
    # row (a ceil-sized split can yield fewer blocks than ranks — e.g.
    # S=9, R=4 — so it cannot cover every S >= R)
    base, rem = divmod(S, nranks)
    if base == 0:
        raise ValueError(f"S={S} < nranks={nranks}: every rank needs at "
                         "least one sequence row")
    splits = [(r * base + min(r, rem), base + (1 if r < rem else 0))
              for r in range(nranks)]
    G = B * H
    keys = [(g, r) for g in range(G) for r in range(nranks)]
    ptg = ring_attention_ptg(causal=causal, scale=scale_v, q_block=base,
                             kv_block=base, block_rem=rem, variant=variant,
                             use_cuda=use_cuda, use_cpu=use_cpu)
    sizes = [n for _, n in splits]

    def plane(arr):
        def init(g, j):
            b, h = divmod(g, H)
            o, n = splits[j]
            return arr[b, o:o + n, h, :].clone(memory_format=torch.contiguous_format)
        return init

    def build(r, ctx):
        owner = dict(keys=keys, nodes=nranks, myrank=r,
                     rank_of=lambda g, j: j % nranks)
        Oc = PlaneCollection(
            "O", lambda g, i: torch.zeros((sizes[i], D), dtype=q.dtype), **owner)
        ca, cm, cl = _carry_inits(D, sizes)
        tp = ptg.taskpool(
            G=G, R=nranks,
            Q=PlaneCollection("Q", plane(q), **owner),
            K=PlaneCollection("K", plane(k), **owner),
            V=PlaneCollection("V", plane(v), **owner),
            O=Oc,
            CA=PlaneCollection("CA", ca, **owner),
            CM=PlaneCollection("CM", cm, **owner),
            CL=PlaneCollection("CL", cl, **owner))
        return tp, Oc

    def assemble(users) -> torch.Tensor:
        out = torch.zeros((B, S, H, D), dtype=q.dtype)
        for r, oc in enumerate(users):
            o, n = splits[r]
            for g in range(G):
                b, h = divmod(g, H)
                c = oc.data_of(g, r).newest_copy()
                out[b, o:o + n, h, :] = _host_tensor(host_array(c.payload))
        return out

    return build, assemble


def run_ring_attention_graph(nranks: int, q, k, v, *,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             variant: str = "ring",
                             use_cuda: bool = True, use_cpu: bool = True,
                             fabric=None, nb_cores: int = 2,
                             timeout: float = 300,
                             trace_pins: bool = False,
                             trace_dir: Optional[str] = None,
                             devices: Optional[Sequence[str]] = None,
                             cuda_device: Optional[str] = None):
    """Drive the distributed ring-attention PTG over ``nranks`` in-process
    ranks (one Context a rank; the K/V rotation is remote dependencies on
    the fabric).  ``q``/``k``/``v`` are full ``[B, S, H, D]`` arrays or
    tensors; block ``r`` of every plane lives on rank ``r``.  Every rank's
    context binds the card unless ``devices=`` / ``cuda_device=`` (passed
    to every rank's ``Context``) say otherwise.  Returns ``(out, stats)``
    — ``out`` a torch CPU tensor, ``stats`` the
    :func:`~parsec_tpu_torch.multirank.run_multirank_perf` record; with
    ``trace_pins`` it includes the per-rank comm/compute overlap
    metrics."""
    from ..multirank import run_multirank_perf

    B, S, H, D = tuple(q.shape)
    build, assemble = ring_attention_builder(
        nranks, q, k, v, causal=causal, scale=scale, variant=variant,
        use_cuda=use_cuda, use_cpu=use_cpu)
    flops = 4.0 * B * H * S * S * D
    users, stats = run_multirank_perf(
        nranks, build, nb_cores=nb_cores, timeout=timeout, fabric=fabric,
        overlap=trace_pins, flops=flops, trace_dir=trace_dir, devices=devices,
        cuda_device=cuda_device)
    return assemble(users), stats
