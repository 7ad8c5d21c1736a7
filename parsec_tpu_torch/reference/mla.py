"""Plain reference of DeepSeek-V2's multi-head latent attention (MLA), the
attention core of one layer, in float32 PyTorch (arXiv:2405.04434 and
``DeepseekV2Attention`` of the published ``modeling_deepseek.py``).

It imports torch alone: no kernel or module of the port, and nothing in
the program imports it.  Float32 matrix products run in float32, not TF32
(:func:`mla_attention` turns TF32 off for the card's matmul and cuDNN).

Departures from the published layer, each outside this function: the
query projection (``q_proj``; DeepSeek-V2-Lite has no ``q_lora_rank``),
the KV down-projection ``kv_a_proj_with_mqa`` and its ``kv_a_layernorm``,
YaRN's rotary embedding of the rope parts of q and k, and ``o_proj``.
Their outputs are its inputs: ``q`` with each head's rope columns already
rotated, the normalised latent ``c_kv`` and the rotated shared key
``k_pe``; its output is the heads' attention before ``o_proj``.  The
softmax scale is the caller's (the published layer's ``softmax_scale``:
``mscale**2 / sqrt(qk_nope_head_dim + qk_rope_head_dim)``, with YaRN's
``mscale = 0.1 * mscale_all_dim * ln(factor) + 1``).
"""

from __future__ import annotations

import math

import torch


def softmax_scale(qk_nope_head_dim: int, qk_rope_head_dim: int, rope_scaling=None) -> float:
    """The published layer's softmax scale: ``1 / sqrt(Dqk)``, times
    YaRN's ``mscale**2`` where ``rope_scaling`` gives ``mscale_all_dim``."""
    scale = (qk_nope_head_dim + qk_rope_head_dim) ** -0.5
    all_dim = (rope_scaling or {}).get("mscale_all_dim", 0)
    factor = (rope_scaling or {}).get("factor", 1.0)
    if all_dim and factor > 1:
        mscale = 0.1 * all_dim * math.log(factor) + 1.0
        scale *= mscale * mscale
    return scale


def mla_attention(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
                  w_kv_b: torch.Tensor, scale: float, causal: bool = True) -> torch.Tensor:
    """Latent attention: ``q`` ``[B, S, H, Dn + R]``, ``c_kv`` ``[B, S,
    L]``, ``k_pe`` ``[B, S, R]``, ``w_kv_b`` ``[H * (Dn + Dv), L]`` (each
    head's ``Dn`` key rows, then its ``Dv`` value rows).  For each head h:
    ``k = [c_kv W_UK_h^T | k_pe]``, ``v = c_kv W_UV_h^T``, ``o_h =
    softmax(q_h k^T * scale, causal) v``.  Returns ``[B, S, H, Dv]`` in
    float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, H, dqk = q.shape
    R = k_pe.shape[-1]
    dn = dqk - R
    w = w_kv_b.float().reshape(H, -1, w_kv_b.shape[-1])
    w_uk, w_uv = w[:, :dn], w[:, dn:]
    c, pe, qf = c_kv.float(), k_pe.float(), q.float()
    k_nope = torch.einsum("bsl,hdl->bshd", c, w_uk)
    k = torch.cat((k_nope, pe[:, :, None, :].expand(B, S, H, R)), dim=-1)
    v = torch.einsum("bsl,hdl->bshd", c, w_uv)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
