"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

The port of :mod:`parsec_tpu.parallel.ring_attention`:

* :func:`ring_attention` — blockwise attention over a 1D ring of mesh
  positions.  Every position owns one sequence block of Q/K/V; K/V blocks
  rotate one hop per step (:func:`~.shard_map.ppermute`) while a streaming
  (online-softmax) accumulator keeps the numerics of full attention
  without ever materialising the S×S matrix.  With ``use_kernels`` each
  step's carry update is the hand-written kernel
  :func:`parsec_tpu_torch.ops.kernels.flash_attention_block` (B5) under
  ``torch.vmap`` over batch and heads: one batched launch a position a
  step on a CUDA position, the wrapper's plain version on a CPU one.
  Without it, the step is the torch einsum chain the reference computes
  outside its Pallas kernel.
* :func:`ulysses_attention` — all-to-all sequence parallelism: resharding
  [seq-sharded, all heads] → [all seq, head-sharded], dense per-head
  attention, and the inverse reshard.

Both take ``[batch, seq, heads, head_dim]`` tensors, sequence-sharded over
one mesh axis, and return the same layout.  The runtime-native
formulation — the same numerics as PTG task graphs whose K/V rotation
rides the remote-dependency wire — is
:func:`parsec_tpu_torch.ops.attention.ring_attention_ptg`; on the card its
causal float32 output is bit-identical to :func:`ring_attention` with
``use_kernels`` (the same B5 updates in the same ``(r + s) % R`` order).
:func:`attention_reference` is the numerics oracle of both.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .mesh import Mesh
from .shard_map import P, all_to_all, axis_index, ppermute, shard_map

#: finite "-inf" for the running-max init (keeps exp() NaN-free)
_NEG_BIG = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention of ``[B, S, H, D]`` tensors on one device.

    The reference takes the logits to float32; here they are taken to at
    least float32 (``promote_types(dtype, float32)``), so a float64 call is
    a float64 oracle while float32 and bfloat16 inputs compute as the
    reference does.  The causal mask is aligned at row 0 / column 0, as in
    the reference.  The output is in ``v``'s dtype."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32)) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        rows = torch.arange(sq, device=logits.device)[:, None]
        cols = torch.arange(sk, device=logits.device)[None, :]
        logits = logits.masked_fill(rows < cols, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: Optional[str] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Attention over sequence blocks distributed around a ring of
    positions.

    ``q, k, v``: ``[B, S, H, D]``, sequence dim sharded over ``axis``.
    R ring steps; at step s the position holding query block ``i``
    computes against key/value block ``(i + s) mod R`` then forwards K/V
    one hop (the last step forwards nothing).  Online softmax (running max
    ``m``, normaliser ``l``, accumulator) makes the result exactly dense
    attention.  ``use_kernels`` runs each step as one batched B5 launch
    over the B·H planes."""
    axis = axis or mesh.axis_names[0]
    R = mesh.shape[axis]
    if q.shape[1] % R:
        raise ValueError(f"ring size {R} must divide seq length {q.shape[1]}")
    scale_v = scale or 1.0 / math.sqrt(q.shape[-1])
    perm = [(i, (i - 1) % R) for i in range(R)]

    def kernel(q_blk, k_blk, v_blk):
        idx = axis_index(axis)
        Bb, Sb, H, D = q_blk.shape
        dev = q_blk.device
        if use_kernels:
            from ..ops import kernels

            def planes(t):  # [B, Sb, H, D] -> [B*H, Sb, D]
                return t.permute(0, 2, 1, 3).reshape(Bb * H, Sb, D).contiguous()

            qh, kb, vb = planes(q_blk), planes(k_blk), planes(v_blk)
            acc = torch.zeros((Bb * H, Sb, D), dtype=torch.float32, device=dev)
            m = torch.full((Bb * H, Sb, 1), _NEG_BIG, dtype=torch.float32, device=dev)
            l = torch.zeros((Bb * H, Sb, 1), dtype=torch.float32, device=dev)
            for s in range(R):
                ki = (idx + s) % R  # block id of the resident K/V
                upd = torch.vmap(
                    lambda q2, k2, v2, a2, m2, l2, _ki=ki: kernels.flash_attention_block(
                        q2, k2, v2, a2, m2, l2, idx * Sb, _ki * Sb,
                        causal=causal, scale=float(scale_v)))
                acc, m, l = upd(qh, kb, vb, acc, m, l)
                if s < R - 1:
                    kb, vb = ppermute(kb, axis, perm), ppermute(vb, axis, perm)
            out = (acc / l).reshape(Bb, H, Sb, D)
        else:
            qpos = idx * Sb + torch.arange(Sb, device=dev)  # my queries' positions
            acc = torch.zeros((Bb, H, Sb, D), dtype=torch.float32, device=dev)
            m = torch.full((Bb, H, Sb), _NEG_BIG, dtype=torch.float32, device=dev)
            l = torch.zeros((Bb, H, Sb), dtype=torch.float32, device=dev)
            kb, vb = k_blk, v_blk
            for s in range(R):
                ki = (idx + s) % R
                logits = torch.einsum("bqhd,bkhd->bhqk", q_blk, kb).float() * scale_v
                if causal:
                    kpos = ki * Sb + torch.arange(Sb, device=dev)
                    mask = qpos[:, None] >= kpos[None, :]
                    logits = logits.masked_fill(~mask, float("-inf"))
                m_new = torch.maximum(m, logits.amax(dim=-1))
                p = torch.exp(logits - m_new[..., None])  # -inf - finite -> 0
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
                m = m_new
                if s < R - 1:
                    kb, vb = ppermute(kb, axis, perm), ppermute(vb, axis, perm)
            out = acc / l[..., None]
        return out.permute(0, 2, 1, 3).to(q_blk.dtype)  # -> [B, Sb, H, D]

    spec = P(None, axis, None, None)
    return shard_map(kernel, mesh, (spec, spec, spec), spec)(q, k, v)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: Optional[str] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses pattern):
    reshard seq-sharded → head-sharded, run dense attention on the full
    sequence for the local head group, reshard back.  Two all_to_all
    collectives a tensor; the axis size must divide the head count."""
    axis = axis or mesh.axis_names[0]
    R = mesh.shape[axis]
    if q.shape[2] % R:
        raise ValueError(f"mesh axis size {R} must divide head count {q.shape[2]}")

    def kernel(q_blk, k_blk, v_blk):
        # [B, Sb, H, D] -> [B, S, H/R, D]: gather seq, scatter heads
        def a2a(t):
            return all_to_all(t, axis, split_axis=2, concat_axis=1)

        out = attention_reference(a2a(q_blk), a2a(k_blk), a2a(v_blk), causal=causal,
                                  scale=scale)
        # [B, S, H/R, D] -> [B, Sb, H, D]: scatter seq, gather heads
        return all_to_all(out, axis, split_axis=1, concat_axis=2)

    spec = P(None, axis, None, None)
    return shard_map(kernel, mesh, (spec, spec, spec), spec)(q, k, v)
