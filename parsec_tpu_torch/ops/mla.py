"""Multi-head latent attention (MLA) as a task graph: the causal prefill of
DeepSeek-V2's attention (arXiv:2405.04434) against its latent KV cache.

The cache holds, for each token, the latent ``c`` (``kv_a_layernorm``'s
output, ``L`` = ``kv_lora_rank`` values) and the rotated key ``k_pe``
(``R`` = ``qk_rope_head_dim`` values) that every head shares.  Head ``h``
expands them with its rows of ``kv_b_proj`` (``[H * (Dn + Dv), L]``, head
``h``'s ``Dn`` key rows ``W_UK_h`` then its ``Dv`` value rows ``W_UV_h``):

    k_h = [c W_UK_h^T | k_pe]      (Dqk = Dn + R wide)
    v_h =  c W_UV_h^T              (Dv wide)
    o_h = softmax(q_h k_h^T * scale, causal) v_h

The graph (:func:`mla_attention_ptg`), per group ``g`` = one (batch,
head) pair:

* ``kv_up(g, s)`` expands KV block ``s``: it reads the latent and rotary
  planes of (batch, block) — views of the caller's tensors that the
  group's heads share, so each is staged once while it stays resident —
  and head ``h``'s weight slice, and makes a K tile ``(kvb, Dqk)`` and a V
  tile ``(kvb, Dv)`` in the operands' dtype.  Both are ``<- NEW`` tiles
  that no collection holds: on the native device path they live on the
  card only (``ScratchData``), made by two B2 launches
  (:func:`.kernels.matmul`) and the rotary columns joined on.  They go to
  ``attn_step(g, i, s)`` of every query block ``i`` whose causal horizon
  reaches ``s``, by one ranged output dep;
* ``attn_step`` and ``attn_out`` are the flash graph's carry chain
  (:func:`.attention._flash_chain`); the steps run B5 at ``Dqk`` against
  ``Dv`` (192 / 128 in bfloat16, DeepSeek-V2's widths).

``kv_up`` runs ahead of the steps (its priority is above theirs).  The CPU
bodies are numpy's, as the flash graph's.  The plain reference is
``parsec_tpu_torch/reference/mla.py``, which the program never imports.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..dsl.ptg import PTG
from ..profiling import pins
from . import kernels
from .attention import (IN, OUT, PlaneCollection, _assemble, _bodies, _carry_tile_types, _f32,
                        _flash_chain, _host_tensor, _ptg_cached, attention_task_count,
                        block_splits)

__all__ = ["mla_attention_ptg", "build_mla_attention", "mla_attention_task_count"]


def _make_kv_up_cuda(d_nope: int):
    def kv_up(CB, PB, WB, K, V, **_):
        # K and V are the tiles' homes on the device, written whole here
        with pins.span("kv_up", tiles=2) as info:
            torch.cat((kernels.matmul(CB, WB[:d_nope]), PB), dim=1, out=K)
            kernels.matmul(CB, WB[d_nope:], out=V)
            if info is not None:
                info["bytes"] = int(K.nbytes + V.nbytes)
        return K, V

    return kv_up


def _fill(tile, values: np.ndarray) -> None:
    """Write float32 ``values`` into a host tile, rounding to its dtype."""
    if isinstance(tile, torch.Tensor):
        tile.copy_(torch.from_numpy(values))
    else:
        tile[:] = values.astype(tile.dtype)


def _make_kv_up_cpu(d_nope: int):
    def kv_up(CB, PB, WB, K, V, **_):
        with pins.span("kv_up", tiles=2) as info:
            c, w = _f32(CB), _f32(WB)
            _fill(K, np.concatenate((c @ w[:d_nope].T, _f32(PB)), axis=1))
            _fill(V, c @ w[d_nope:].T)
            if info is not None:
                info["bytes"] = int(K.nbytes + V.nbytes)

    return kv_up


def mla_attention_ptg(*, causal: bool = False, scale: float = 1.0,
                      q_block: int = 128, kv_block: int = 128, d_nope: int = 128,
                      use_cuda: bool = True, use_cpu: bool = True) -> PTG:
    """Latent attention's prefill graph.  Instantiate with ``.taskpool(G=,
    H=, NQ=, NK=, QB=, KVB=, QOFF=0, SQ=, Q=, CKV=, KPE=, WKV=, O=,
    KTILE=, VTILE=, ACCTILE=, ROWTILE=)``: ``Q(g, i)``/``O(g, i)`` are the
    ``(sq_i, Dqk)`` query and ``(sq_i, Dv)`` output blocks of group ``g =
    b * H + h`` (O write-only), ``CKV(b, s)``/``KPE(b, s)`` the ``(sk_s,
    L)`` latent and ``(sk_s, R)`` rotary blocks of batch ``b``, ``WKV(h,
    0)`` head ``h``'s ``(Dn + Dv, L)`` rows of ``kv_b_proj`` (``Dn =
    d_nope``); ``KTILE(g, s)`` and ``VTILE(g, s)`` give each ``kv_up``
    task's K and V tile as ``(dtype, shape)``, ``ACCTILE(g, i, s)`` and
    ``ROWTILE(g, i, s)`` the task-made carries' (float32 ``(sq_i, Dv)``
    and ``(sq_i, 1)``, :func:`.attention._carry_tile_types`).
    :func:`build_mla_attention` assembles it all from the caller's
    tensors."""
    ptg = PTG("mla_attn")
    up = ptg.task_class("kv_up", g="0 .. G-1", s="0 .. NK-1")
    up.define("b", "g // H")
    up.define("h", "g % H")
    # the first query block whose causal horizon reaches block s: every
    # later one's does too
    up.define("lo", "max(0, (s*KVB - QOFF) // QB)" if causal else "0")
    up.affinity("CKV(b, s)")
    up.priority("2*NK - s")  # above every step (NK - s at most)
    up.flow("CB", IN, "<- CKV(b, s)")
    up.flow("PB", IN, "<- KPE(b, s)")
    up.flow("WB", IN, "<- WKV(h, 0)")
    up.flow("K", OUT, "<- NEW [type=KTILE]", "-> KB attn_step(g, lo .. NQ-1, s)")
    up.flow("V", OUT, "<- NEW [type=VTILE]", "-> VB attn_step(g, lo .. NQ-1, s)")
    _bodies(up, _make_kv_up_cuda(d_nope), _make_kv_up_cpu(d_nope), use_cuda, use_cpu)
    _flash_chain(ptg, causal=causal, scale=scale, q_block=q_block, kv_block=kv_block,
                 q_offset=0, use_cuda=use_cuda, use_cpu=use_cpu,
                 kv_deps=("<- K kv_up(g, s)", "<- V kv_up(g, s)"))
    return ptg


def build_mla_attention(q, c_kv, k_pe, w_kv_b, *, scale: float, causal: bool = False,
                        q_block: int = 128, kv_block: int = 128,
                        use_cuda: bool = True, use_cpu: bool = True,
                        out_dtype: Optional[torch.dtype] = None):
    """Build the latent-attention prefill taskpool.  ``q`` is ``[B, S, H,
    Dqk]`` (each head's ``Dn`` own columns, then its ``R`` rotary ones),
    ``c_kv`` ``[B, S, L]``, ``k_pe`` ``[B, S, R]`` and ``w_kv_b`` ``[H *
    (Dn + Dv), L]``, the published ``kv_b_proj`` layout; all of one dtype
    (bfloat16 on the card: B5 takes unequal widths in bfloat16 only), numpy
    arrays or torch tensors.  ``scale`` is the softmax scale, the caller's
    (DeepSeek-V2 folds YaRN's ``mscale`` into it).  Returns ``(taskpool,
    assemble)``; ``assemble()`` reads the ``[B, S, H, Dv]`` output into a
    torch CPU tensor (``out_dtype``, default q's) after the pool quiesced.

    The Q, latent, rotary and weight planes are views of the caller's
    tensors (their host form): the caller must not write them until the
    pool has run.  The build is the job's ``taskpool`` span."""
    with pins.span("taskpool", job=pins.current_job() or pins.new_job()):
        return _build_mla_attention(q, c_kv, k_pe, w_kv_b, scale, causal, q_block,
                                    kv_block, use_cuda, use_cpu, out_dtype)


def _mla_dims(q, c_kv, k_pe, w_kv_b) -> Tuple[int, int, int, int, int, int, int, int]:
    """``(B, S, H, Dqk, L, R, Dn, Dv)`` of the operands, checked."""
    if q.dim() != 4 or c_kv.dim() != 3 or k_pe.dim() != 3 or w_kv_b.dim() != 2:
        raise ValueError(f"build_mla_attention: q [B, S, H, Dqk], c_kv [B, S, L], k_pe "
                         f"[B, S, R] and w_kv_b [H * (Dn + Dv), L], got {tuple(q.shape)}, "
                         f"{tuple(c_kv.shape)}, {tuple(k_pe.shape)}, {tuple(w_kv_b.shape)}")
    B, S, H, dqk = q.shape
    L, R = c_kv.shape[-1], k_pe.shape[-1]
    dn = dqk - R
    rows = w_kv_b.shape[0]
    if (tuple(c_kv.shape[:2]) != (B, S) or tuple(k_pe.shape[:2]) != (B, S)
            or w_kv_b.shape[1] != L or rows % H or dn < 1 or rows // H <= dn):
        raise ValueError(f"build_mla_attention: shapes do not agree: q {tuple(q.shape)}, "
                         f"c_kv {tuple(c_kv.shape)}, k_pe {tuple(k_pe.shape)}, "
                         f"w_kv_b {tuple(w_kv_b.shape)}")
    dtypes = {t.dtype for t in (q, c_kv, k_pe, w_kv_b)}
    if len(dtypes) != 1:
        raise TypeError(f"build_mla_attention: q, c_kv, k_pe and w_kv_b must share one "
                        f"dtype, got {sorted(map(str, dtypes))}")
    return B, S, H, dqk, L, R, dn, rows // H - dn


def _build_mla_attention(q, c_kv, k_pe, w_kv_b, scale, causal, q_block, kv_block,
                         use_cuda, use_cpu, out_dtype):
    q, c_kv, k_pe, w_kv_b = (_host_tensor(t) for t in (q, c_kv, k_pe, w_kv_b))
    B, S, H, dqk, L, R, dn, dv = _mla_dims(q, c_kv, k_pe, w_kv_b)
    qs, ks = block_splits(S, int(q_block)), block_splits(S, int(kv_block))
    G = B * H
    dt = q.dtype
    odt = out_dtype if out_dtype is not None else dt

    def rows(arr, splits):
        def init(x, j):
            o, n = splits[j]
            return arr[x, o:o + n]
        return init

    def q_plane(g, i):
        b, h = divmod(g, H)
        o, n = qs[i]
        return q[b, o:o + n, h, :]

    keys_q = [(g, i) for g in range(G) for i in range(len(qs))]
    keys_b = [(b, s) for b in range(B) for s in range(len(ks))]
    Oc = PlaneCollection("O", lambda g, i: torch.empty((qs[i][1], dv), dtype=odt),
                         keys=keys_q, blank=True)
    tp = _ptg_cached(
        mla_attention_ptg, causal=bool(causal), scale=float(scale), q_block=int(q_block),
        kv_block=int(kv_block), d_nope=dn, use_cuda=use_cuda, use_cpu=use_cpu,
    ).taskpool(G=G, H=H, NQ=len(qs), NK=len(ks), QB=int(q_block), KVB=int(kv_block),
               QOFF=0, SQ=S,
               Q=PlaneCollection("Q", q_plane, keys=keys_q),
               CKV=PlaneCollection("CKV", rows(c_kv, ks), keys=keys_b),
               KPE=PlaneCollection("KPE", rows(k_pe, ks), keys=keys_b),
               WKV=PlaneCollection("WKV", lambda h, _j: w_kv_b[h * (dn + dv):(h + 1) * (dn + dv)],
                                   keys=[(h, 0) for h in range(H)]),
               O=Oc,
               KTILE=lambda g, s: (dt, (ks[s][1], dqk)),
               VTILE=lambda g, s: (dt, (ks[s][1], dv)),
               **_carry_tile_types(dv, [n for _, n in qs]))
    return tp, lambda: _assemble(Oc, tp.job, (B, S, H, dv), qs, odt)


def mla_attention_task_count(B: int, S: int, H: int, q_block: int, kv_block: int, *,
                             causal: bool = False) -> int:
    """Task count of the latent-attention graph: the flash graph's steps
    and outputs (:func:`.attention.attention_task_count`) and one
    ``kv_up`` a (group, KV block)."""
    nk = (S + kv_block - 1) // kv_block
    return attention_task_count(B, S, S, H, q_block, kv_block, causal=causal) + B * H * nk
