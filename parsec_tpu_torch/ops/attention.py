"""Attention as a task graph: single-rank blockwise flash attention.

The port of the single-rank part of :mod:`parsec_tpu.ops.attention`.
:func:`flash_attention_ptg` has task class ``attn_step(g, i, s)``, which
threads the online-softmax carry ``(acc, m, l)`` of query block ``i``
(group ``g`` = one (batch, head) plane) through the KV blocks ``s``.  Its
CUDA chore is the hand-written kernel
:func:`parsec_tpu_torch.ops.kernels.flash_attention_block` (B5), its CPU
chore the same update in numpy.  ``attn_out(g, i)`` normalises
``acc / l`` into the output block.

Host planes are torch CPU tensors, so bfloat16 q/k/v need no numpy
bfloat16: the CUDA module stages torch host tiles as they are, and a CPU
chore widens them to float32 numpy.  The carries are float32 numpy tiles.

:func:`run_flash_attention` drives the graph through a live context's
dynamic runtime, :func:`run_flash_attention_native` through the native
engine's pump.  Not ported yet, each raising ``NotImplementedError``: the
distributed ring-attention graphs (:func:`ring_attention_ptg`,
:func:`ring_attention_builder`, :func:`run_ring_attention_graph`, ROADMAP
A.8).  ``"auto"`` block sizes take the value the reference falls back to
on an empty tuning store; the store itself is ROADMAP A.5.

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

from ..core.lifecycle import AccessMode
from ..data.collection import DataCollection
from ..data.data import Data, data_create, host_array
from ..dsl.ptg import PTG
from . import kernels

IN = AccessMode.IN
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
    becomes an ndarray).  Single rank: the reference's ``rank_of``
    placement serves the ring graphs (ROADMAP A.8)."""

    def __init__(self, name: str, init: Callable[[int, int], object]):
        super().__init__(name)
        self._init = init
        self._store: Dict[Tuple[int, int], Data] = {}
        self._lock = threading.Lock()

    def data_key(self, *key):
        if len(key) == 1 and isinstance(key[0], tuple):
            key = key[0]
        g, j = key
        return (int(g), int(j))

    def data_of(self, *key) -> Data:
        k = self.data_key(*key)
        with self._lock:
            d = self._store.get(k)
            if d is None:
                tile = self._init(*k)
                if not isinstance(tile, torch.Tensor):
                    tile = np.asarray(tile)
                d = data_create(k, self, payload=tile)
                self._store[k] = d
            return d


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


def _attn_out_cuda(ACC, M, L, O, **_):
    return (ACC / L).to(O.dtype)


def _attn_out_cpu(ACC, M, L, O, **_):
    if isinstance(O, torch.Tensor):
        O.copy_(torch.from_numpy(ACC / L))  # rounds to O's dtype
    else:
        O[:] = (ACC / L).astype(O.dtype)


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
    ``Q(g, i)``/``O(g, i)`` are ``(sq_i, D)`` query/output blocks,
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
    out.flow("O", INOUT, "<- O(g, i)", "-> O(g, i)")
    _bodies(out, _attn_out_cuda, _attn_out_cpu, use_cuda, use_cpu)
    return ptg


# ---------------------------------------------------------------------------
# builders and entry points
# ---------------------------------------------------------------------------

def _resolve_block(value, seq: int) -> int:
    """``"auto"`` resolves to ``min(128, seq)``: the reference's value on
    an empty tuning store (the store is ROADMAP A.5); explicit values
    pass through."""
    if value != "auto":
        return int(value)
    return min(128, seq)


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
    ``out_dtype`` (a torch dtype) defaults to q's."""
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
    qb = _resolve_block(q_block, Sq)
    kvb = _resolve_block(kv_block, Sk)
    qs = block_splits(Sq, qb)
    ks = block_splits(Sk, kvb)
    G = B * H
    odt = out_dtype if out_dtype is not None else q.dtype

    def plane(arr, splits):
        def init(g, j):
            b, h = divmod(g, H)
            o, n = splits[j]
            return arr[b, o:o + n, h, :].clone(memory_format=torch.contiguous_format)
        return init

    Qc = PlaneCollection("Q", plane(q, qs))
    Kc = PlaneCollection("K", plane(k, ks))
    Vc = PlaneCollection("V", plane(v, ks))
    Oc = PlaneCollection("O", lambda g, i: torch.zeros((qs[i][1], D), dtype=odt))
    ca, cm, cl = _carry_inits(D, [n for _, n in qs])
    tp = _flash_ptg_cached(
        causal=causal, scale=scale_v, q_block=qb, kv_block=kvb,
        q_offset=q_offset, use_cuda=use_cuda, use_cpu=use_cpu,
    ).taskpool(G=G, NQ=len(qs), NK=len(ks), QB=qb, KVB=kvb,
               QOFF=q_offset, SQ=Sq,
               Q=Qc, K=Kc, V=Vc, O=Oc,
               CA=PlaneCollection("CA", ca),
               CM=PlaneCollection("CM", cm),
               CL=PlaneCollection("CL", cl))

    def assemble() -> torch.Tensor:
        out = torch.zeros((B, Sq, H, D), dtype=odt)
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


def run_flash_attention_native(q, k, v, *, device=None, fusion=None,
                               **kw) -> torch.Tensor:
    """The same graph through the native C++ engine's pump: every step on
    the CUDA device module (the GPU, unless ``device=`` or
    ``PARSEC_MCA_device_cuda_torch_device=cpu`` says otherwise), with
    scheduling and successor release never entering the interpreter;
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
    tp.run_native(native_device=True, device=device, fusion=fusion)
    return assemble()


def ring_attention_ptg(*args, **kw):
    """Not ported yet: distributed ring attention is ROADMAP A.8."""
    raise NotImplementedError("ring_attention_ptg: remote dependencies are "
                              "not ported yet (ROADMAP A.8)")


def ring_attention_builder(*args, **kw):
    """Not ported yet: distributed ring attention is ROADMAP A.8."""
    raise NotImplementedError("ring_attention_builder: remote dependencies "
                              "are not ported yet (ROADMAP A.8)")


def run_ring_attention_graph(*args, **kw):
    """Not ported yet: distributed ring attention is ROADMAP A.8."""
    raise NotImplementedError("run_ring_attention_graph: multi-rank runs are "
                              "not ported yet (ROADMAP A.8)")
