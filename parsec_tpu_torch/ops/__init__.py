"""Operations: the dense factorizations (tiled dpotrf, LU and QR; the
panel and segmented Cholesky, LU and QR), the flash-attention, latent
(MLA) attention, distributed ring-attention and 5-point-stencil
taskpools, their tile bodies and hand-written kernels.
"""

from .attention import (
    attention_task_count,
    build_flash_attention,
    flash_attention_ptg,
    ring_attention_builder,
    ring_attention_ptg,
    run_flash_attention,
    run_flash_attention_native,
    run_ring_attention_graph,
)
from .cholesky import cholesky_ptg, dpotrf_task_count, insert_dpotrf, run_cholesky
from .lu import lu_ptg, lu_task_count, run_lu
from .mla import build_mla_attention, mla_attention_ptg, mla_attention_task_count
from .panel_chol import PanelCholesky, WholeCholesky
from .qr import qr_constants, qr_ptg, qr_task_count, run_qr
from .segmented_chol import SegmentedCholesky, n_segments, segmented_cholesky_ptg
from .segmented_lu import SegmentedLU, segmented_lu_ptg
from .segmented_qr import SegmentedQR, segmented_qr_ptg
from .stencil import StencilBuffers, reference_stencil, stencil_ptg

__all__ = [
    "attention_task_count",
    "build_flash_attention",
    "flash_attention_ptg",
    "run_flash_attention",
    "run_flash_attention_native",
    "ring_attention_ptg",
    "ring_attention_builder",
    "run_ring_attention_graph",
    "mla_attention_ptg",
    "build_mla_attention",
    "mla_attention_task_count",
    "cholesky_ptg",
    "insert_dpotrf",
    "dpotrf_task_count",
    "run_cholesky",
    "lu_ptg",
    "lu_task_count",
    "run_lu",
    "qr_constants",
    "qr_ptg",
    "qr_task_count",
    "run_qr",
    "PanelCholesky",
    "WholeCholesky",
    "SegmentedCholesky",
    "n_segments",
    "segmented_cholesky_ptg",
    "SegmentedLU",
    "segmented_lu_ptg",
    "SegmentedQR",
    "segmented_qr_ptg",
    "StencilBuffers",
    "reference_stencil",
    "stencil_ptg",
]
