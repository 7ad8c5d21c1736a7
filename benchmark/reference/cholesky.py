"""Plain PyTorch reference of the dpotrf cell: the seeded SPD matrix, the
check a factor is judged by, and a blocked right-looking lower Cholesky
factorization for the control.

Imports torch alone.  A factor L of A is judged by its componentwise
backward error (:func:`componentwise_residual`), worked out in float64
from A itself.  The control is :func:`blocked_cholesky_` with
``precision="tf32"``: the same blocks in float32 with the trailing
update's operands rounded to TF32 (10 mantissa bits), as one pass of the
tensor cores would take them, the step below the FP32 accuracy the
configuration states.
"""

from __future__ import annotations

import math

import torch

from .rounding import tf32_round


def plghe(n: int, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    """DPLASMA's ``plghe`` test matrix made on ``device`` from ``seed``:
    symmetric, entries uniform in [-0.5, 0.5), ``n`` added to the
    diagonal (``testing_spotrf``'s bump), so it is SPD.  Generated as one
    block of uniforms; the lower triangle is mirrored into the upper."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a = torch.rand((n, n), generator=gen, device=device, dtype=torch.float32)
    a -= 0.5
    a.tril_()
    a += a.tril(-1).mT
    a.diagonal().add_(float(n))
    return a.to(dtype)


def blocked_cholesky_(a: torch.Tensor, nb: int, precision: str = "float64") -> torch.Tensor:
    """Factor ``a`` in place, right-looking over panels of ``nb`` columns:
    the diagonal block by ``torch.linalg.cholesky``, the panel below it by
    a triangular solve, the trailing matrix by one product.  Returns the
    lower factor (the upper triangle is zeroed).  ``a`` must already be in
    the working dtype: float64 for ``"float64"``, float32 for ``"tf32"``
    and ``"float32"``."""
    if precision not in ("float64", "float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    want = torch.float64 if precision == "float64" else torch.float32
    if a.dtype != want:
        raise ValueError(f"{precision} factorization of a {a.dtype} matrix")
    n = a.shape[0]
    for k in range(0, n, nb):
        e = min(k + nb, n)
        d = torch.linalg.cholesky(a[k:e, k:e])
        a[k:e, k:e] = d
        if e == n:
            break
        panel = torch.linalg.solve_triangular(d.mT, a[e:, k:e], upper=True, left=False)
        a[e:, k:e] = panel
        p = tf32_round(panel) if precision == "tf32" else panel
        a[e:, e:].addmm_(p, p.mT, alpha=-1.0)
    return a.tril_()


def componentwise_residual(a: torch.Tensor, l: torch.Tensor, nb: int) -> float:
    """The largest componentwise backward error of the lower factor ``l``
    of ``a``: max over the lower triangle of
    ``|A - L L^T|_ij / (|L| |L|^T)_ij``, in float64, a block of ``nb`` rows
    at a time.  Whatever the matrix's scale, a factor computed in FP32
    reads a small multiple of FP32's unit roundoff (2^-24), and one whose
    updates took their operands in TF32 reads near TF32's (2^-11) where
    the updates make up most of an entry.  A factor whose diagonal is not
    positive (a Cholesky factor's is), or that holds a NaN, reads
    infinite."""
    n = a.shape[0]
    l = l.to(torch.float64)
    if not bool((l.diagonal() > 0).all()):
        return float("inf")
    absl = l.abs()
    worst = 0.0
    for r0 in range(0, n, nb):
        r1 = min(r0 + nb, n)
        res = (a[r0:r1, :r1].to(torch.float64) - l[r0:r1, :r1] @ l[:r1, :r1].mT).abs_()
        scale = absl[r0:r1, :r1] @ absl[:r1, :r1].mT
        ratio = res.div_(scale.clamp_min_(torch.finfo(torch.float64).tiny)).tril_(r0)
        m = ratio.max().item()
        if not math.isfinite(m):  # NaN or inf anywhere fails the factor
            return float("inf")
        worst = max(worst, m)
    return worst
