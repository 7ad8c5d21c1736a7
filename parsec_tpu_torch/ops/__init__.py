"""Operations: the dpotrf, flash-attention and 5-point-stencil taskpools,
their tile bodies and hand-written kernels.

The other taskpools of :mod:`parsec_tpu.ops` (LU, QR, panel and segmented
factorizations) are not ported yet (ROADMAP A.6-A.7), nor are the
ring-attention graphs (A.8).
"""

from .attention import (
    attention_task_count,
    build_flash_attention,
    flash_attention_ptg,
    run_flash_attention,
    run_flash_attention_native,
)
from .cholesky import cholesky_ptg, dpotrf_task_count, run_cholesky
from .stencil import StencilBuffers, reference_stencil, stencil_ptg

__all__ = [
    "attention_task_count",
    "build_flash_attention",
    "flash_attention_ptg",
    "run_flash_attention",
    "run_flash_attention_native",
    "cholesky_ptg",
    "dpotrf_task_count",
    "run_cholesky",
    "StencilBuffers",
    "reference_stencil",
    "stencil_ptg",
]
