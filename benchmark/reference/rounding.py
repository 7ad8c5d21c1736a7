"""Rounding to the precisions the controls compute in: TF32 (1 sign, 8
exponent, 10 mantissa bits), the precision one tensor-core pass takes its
operands in, and FP8 E4M3 (3 mantissa bits), the step below bfloat16.
Plain arithmetic on the CPU or the card; no TF32 or FP8 hardware needed."""

from __future__ import annotations

import torch

_DROP = 13  # float32 has 23 mantissa bits, TF32 keeps 10


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """A new float32 tensor: ``x`` rounded to the nearest TF32 value (ties
    away from zero).  Finite inputs only."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << (_DROP - 1))) & -(1 << _DROP)
    return bits.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """A new tensor of ``x``'s dtype: ``x`` rounded to the nearest FP8 E4M3
    value (``torch.float8_e4m3fn``).  Inputs within its range, |x| <= 448."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)
