"""Plain PyTorch reference of the latent-attention (MLA) prefill cell: the
attention core of DeepSeek-V2's layer against its latent cache.

Imports torch alone (a copy of ``parsec_tpu_torch/reference/mla.py``'s
arithmetic, which the benchmark may not import).  For each head h, with
``W_UK_h`` and ``W_UV_h`` its key and value rows of ``kv_b_proj``:
``k = [c W_UK_h^T | k_pe]``, ``v = c W_UV_h^T``, ``o_h = softmax(q_h k^T *
scale, causal) v``.  ``precision="float64"`` is the reference the output
is judged against; ``precision="fp8"`` is the control: float32 with the
operands of the expansion (c and the weight), of ``q k^T`` (q and the
expanded k) and of ``p v`` (the probabilities and the expanded v) rounded
to FP8 E4M3, the step below the bfloat16 the configuration states.
Computed one (batch, head) plane and one block of query rows at a time on
the device the inputs are on.
"""

from __future__ import annotations

import math

import torch

from .rounding import fp8_round


def softmax_scale(qk_nope_head_dim: int, qk_rope_head_dim: int, rope_scaling=None) -> float:
    """DeepseekV2Attention's softmax scale: ``1 / sqrt(Dqk)`` times YaRN's
    ``mscale**2``, ``mscale = 0.1 * mscale_all_dim * ln(factor) + 1``."""
    scale = (qk_nope_head_dim + qk_rope_head_dim) ** -0.5
    all_dim = (rope_scaling or {}).get("mscale_all_dim", 0)
    factor = (rope_scaling or {}).get("factor", 1.0)
    if all_dim and factor > 1:
        mscale = 0.1 * all_dim * math.log(factor) + 1.0
        scale *= mscale * mscale
    return scale


def mla_attention(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
                  w_kv_b: torch.Tensor, scale: float, precision: str = "float64",
                  rows: int = 2048, causal: bool = True) -> torch.Tensor:
    """``q`` ``[B, S, H, Dn + R]``, ``c_kv`` ``[B, S, L]``, ``k_pe`` ``[B,
    S, R]``, ``w_kv_b`` ``[H * (Dn + Dv), L]``.  Returns ``[B, S, H, Dv]``
    in float64 (``"float64"``) or float32 (``"fp8"``)."""
    if precision not in ("float64", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32
    rnd = fp8_round if precision == "fp8" else (lambda t: t)
    B, S, H, dqk = q.shape
    R = k_pe.shape[-1]
    dn = dqk - R
    w = w_kv_b.reshape(H, -1, w_kv_b.shape[-1])
    dv = w.shape[1] - dn
    out = torch.empty((B, S, H, dv), dtype=dt, device=q.device)
    pos = torch.arange(S, device=q.device)
    for b in range(B):
        c = rnd(c_kv[b].to(dt))
        pe = k_pe[b].to(dt)
        for h in range(H):
            wh = rnd(w[h].to(dt))
            k = rnd(torch.cat((c @ wh[:dn].mT, pe), dim=1))
            v = rnd(c @ wh[dn:].mT)
            for r0 in range(0, S, rows):
                r1 = min(r0 + rows, S)
                kend = r1 if causal else S
                logits = (rnd(q[b, r0:r1, h].to(dt)) @ k[:kend].mT) * scale
                if causal:
                    logits.masked_fill_(pos[r0:r1, None] < pos[None, :kend], float("-inf"))
                logits -= logits.amax(-1, keepdim=True)
                p = logits.exp_()
                denom = p.sum(-1, keepdim=True)
                out[b, r0:r1, h] = (rnd(p) @ v[:kend]) / denom
    return out
