"""Dense attention: the numerics oracle of every attention path.

The port of ``attention_reference`` from
:mod:`parsec_tpu.parallel.ring_attention`.  ``ring_attention`` itself (the
``shard_map`` loop over a sequence-parallel mesh) is not ported yet
(ROADMAP A.8c).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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
