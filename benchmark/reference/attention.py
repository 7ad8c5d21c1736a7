"""Plain PyTorch reference of the prefill cell: causal softmax attention.

Imports torch alone.  ``precision="float64"`` is the reference the output
is judged against; ``precision="fp8"`` is the control: float32 with both
products' operands (q, k, the probabilities and v) rounded to FP8 E4M3,
the step below the bfloat16 the configuration states.  Computed
one (batch, head) plane and one block of query rows at a time, so that the
logits of a block fit beside the inputs.
"""

from __future__ import annotations

import torch

from .rounding import fp8_round


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     precision: str = "float64", rows: int = 2048) -> torch.Tensor:
    """``softmax(q k^T * scale, causal) v`` for ``[B, S, H, D]`` tensors,
    query row r seeing keys 0 .. r.  Returns ``[B, S, H, D]`` in float64
    (``"float64"``) or float32 (``"fp8"``)."""
    if precision not in ("float64", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32
    rnd = fp8_round if precision == "fp8" else (lambda t: t)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=dt, device=q.device)
    pos = torch.arange(S, device=q.device)
    for b in range(B):
        for h in range(H):
            kh = rnd(k[b, :, h].to(dt))
            vh = rnd(v[b, :, h].to(dt))
            for r0 in range(0, S, rows):
                r1 = min(r0 + rows, S)
                logits = (rnd(q[b, r0:r1, h].to(dt)) @ kh[:r1].mT) * scale
                logits.masked_fill_(pos[r0:r1, None] < pos[None, :r1], float("-inf"))
                logits -= logits.amax(-1, keepdim=True)
                p = logits.exp_()
                denom = p.sum(-1, keepdim=True)
                out[b, r0:r1, h] = (rnd(p) @ vh[:r1]) / denom
    return out
