"""TF32 rounding as the port's CUDA kernels do it, emulated on the CPU with
integer bit operations, for the tests of the f32 modes' 3xTF32
arithmetic (tests/test_torch_kernels.py, tests/test_torch_attention.py)."""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as the kernels round it (cvt.rna.tf32.f32's round to
    nearest, ties away from zero, low 13 bits cleared): adding half a TF32
    ulp to the magnitude bits and truncating."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3(x: torch.Tensor):
    """The (hi, lo) TF32 split: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)
