"""Tile-level compute bodies for tiled Cholesky (dpotrf), and the shared
tiling check.

Each op comes in two incarnations, matching the multi-chore model
(reference: BODY [type=CUDA] blocks):

* ``*_cpu`` — numpy, mutates tiles in place (reference CPU BODY
  semantics), the same arithmetic as :mod:`parsec_tpu.ops.tiles`;
* ``*_cuda`` — functional torch: tensors in, a fresh tensor out; the CUDA
  device module calls them directly.  float32 products run in full FP32
  (the device module turns TF32 off), the counterpart of the reference's
  ``precision="highest"``.

potrf, trsm and trtri stay library calls, as they are XLA calls in the
reference: ``torch.linalg.cholesky_ex`` (not ``cholesky``, whose error
check synchronises the host on every potrf and stalls eager completion)
and ``torch.linalg.solve_triangular``.  Their results come back
column-major; the bodies return them row-major contiguous, the layout the
host tiles and the kernels share.  The ``*_kernel`` incarnations run the
hand-written kernels of :mod:`.kernels` (the reference's ``*_pallas``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


# -- tiling validation ------------------------------------------------------

def check_tiling(n: int, nb: int, *, what: str = "N", op: str = "op",
                 allow_ragged: bool = False) -> int:
    """Validate a 1-D tiling and return the tile count.

    ONE shared check for every builder that cuts a size-``n`` extent into
    ``nb``-sized tiles (the port's copy of
    ``parsec_tpu.ops.tiles.check_tiling``): ``nb`` must be a positive tile
    size and — unless ``allow_ragged`` — divide ``n`` exactly."""
    if int(nb) != nb or int(n) != n:
        raise ValueError(f"{op}: {what}={n!r} / tile size {nb!r} must be "
                         "integers")
    n, nb = int(n), int(nb)
    if nb <= 0:
        raise ValueError(f"{op}: tile size {nb} for {what} must be positive")
    if n <= 0:
        raise ValueError(f"{op}: {what}={n} must be positive")
    if not allow_ragged and n % nb:
        raise ValueError(
            f"{op}: {what}={n} is not divisible by {nb} "
            f"(the tile cut would leave a ragged remainder of {n % nb}; "
            f"pick a value dividing {what}, or an op that supports "
            "ragged tiles)")
    return (n + nb - 1) // nb


# -- Cholesky kernels (lower, right-looking) --------------------------------

def potrf_cpu(T, **_):
    T[:] = np.linalg.cholesky(T)


def potrf_cuda(T, **_):
    # info is left unchecked, as jnp.linalg.cholesky leaves it: a non-SPD
    # tile yields NaNs downstream instead of a host sync per potrf
    L, _info = torch.linalg.cholesky_ex(T)
    return L.contiguous()


def trsm_cpu(T, C, **_):
    # solve X * T^T = C  for X (T lower-triangular) => X = C * T^{-T}
    C[:] = np.linalg.solve(np.tril(T), C.T).T


def trsm_cuda(T, C, **_):
    return torch.linalg.solve_triangular(T.mT, C, upper=True, left=False).contiguous()


def syrk_cpu(A, B, **_):
    A -= B @ B.T


def syrk_cuda(A, B, **_):
    return A - B @ B.mT


def gemm_update_cpu(A, B1, B2, **_):
    A -= B1 @ B2.T


def gemm_update_cuda(A, B1, B2, **_):
    return A - B1 @ B2.mT


def trtri_cpu(T, I, **_):
    # I := inv(tril(T)); NEW-flow scratch I is overwritten
    I[:] = np.linalg.solve(np.tril(T), np.eye(T.shape[0], dtype=T.dtype))


def trtri_cuda(T, I, **_):
    # functional: the NEW-flow input I is shape-irrelevant scratch
    eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    return torch.linalg.solve_triangular(T, eye, upper=False).contiguous()


def trsm_inv_cpu(I, C, **_):
    C[:] = C @ np.tril(I).T


def trsm_inv_cuda(I, C, **_):
    return C @ torch.tril(I).mT


# -- hand-written kernel incarnations ---------------------------------------
# The update chores (where the dpotrf FLOPs are) and the trsm-as-product as
# the hand-written kernels: the subtraction rides the accumulation, one
# device-memory write of the tile instead of product + subtract.

def trsm_inv_kernel(I, C, **_):
    # X = C @ inv(T)^T — the triangular solve as one product against the
    # per-column inverse
    return kernels.matmul(C, I, transpose_b=True)


def syrk_kernel(A, B, **_):
    return kernels.matmul_update(A, B, B, alpha=-1.0)


def gemm_update_kernel(A, B1, B2, **_):
    return kernels.matmul_update(A, B1, B2, alpha=-1.0)


# mixed precision: panel operands in bfloat16, accumulation and the updated
# tile in f32.  The casts live outside the kernel and are re-done per
# consuming task, as on the reference's dynamic path.

def syrk_kernel_bf16(A, B, **_):
    b = B.to(torch.bfloat16)
    return kernels.matmul_update(A, b, b, alpha=-1.0)


def gemm_update_kernel_bf16(A, B1, B2, **_):
    return kernels.matmul_update(A, B1.to(torch.bfloat16),
                                 B2.to(torch.bfloat16), alpha=-1.0)
