"""Operations: the dpotrf taskpool, its tile bodies and hand-written kernels.

The other taskpools of :mod:`parsec_tpu.ops` (LU, QR, stencil, attention,
panel and segmented factorizations) are not ported yet (ROADMAP A.8-A.9).
"""

from .cholesky import cholesky_ptg, dpotrf_task_count, run_cholesky

__all__ = ["cholesky_ptg", "dpotrf_task_count", "run_cholesky"]
