"""Tiled LU factorization (no pivoting) as a PTG.

The port of :mod:`parsec_tpu.ops.lu`: the right-looking no-pivot variant
(DPLASMA's ``getrf_nopiv``), numerically valid for diagonally dominant or
SPD-like matrices — the caller's responsibility:

  for k:  getrf(k):       A[k,k]  = L_kk U_kk            (in-place LU)
          trsm_l(k, n):   A[k,n]  = L_kk^{-1} A[k,n]          (n > k)
          trsm_u(k, m):   A[m,k]  = A[m,k] U_kk^{-1}          (m > k)
          gemm(k, m, n):  A[m,n] -= A[m,k] A[k,n]         (m, n > k)

The ``*_cpu`` bodies are the reference's numpy; the ``*_cuda`` bodies are
functional torch.  getrf and the two solves stay library calls (XLA in the
reference): on the card getrf is ``torch.linalg.lu_factor_ex(T,
pivot=False)``, which runs only there; on the torch CPU device it is the
reference's rank-1 loop (:func:`getrf_plain`), which ``chip_smoke.py``
holds the card body against.  ``use_kernels`` runs the gemm updates, where
the FLOPs are, through the hand-written B1 kernel with ``transpose_b=False``
(the reference's ``use_pallas``).  float32 products run in full FP32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG
from . import kernels

IN = AccessMode.IN
INOUT = AccessMode.INOUT


# -- tile bodies -------------------------------------------------------------

def getrf_cpu(T, **_):
    n = T.shape[0]
    for j in range(n - 1):
        T[j + 1:, j] /= T[j, j]
        T[j + 1:, j + 1:] -= np.outer(T[j + 1:, j], T[j, j + 1:])


def getrf_plain(T: torch.Tensor) -> torch.Tensor:
    """The reference's device getrf, a loop of rank-1 steps: the unit-lower
    L and U packed into a fresh tile."""
    a = T.clone()
    for j in range(a.shape[0] - 1):
        a[j + 1:, j] /= a[j, j]
        a[j + 1:, j + 1:] -= torch.outer(a[j + 1:, j], a[j, j + 1:])
    return a


def getrf_cuda(T, **_):
    if T.is_cuda:
        # info is left unchecked (no host sync), as potrf_cuda leaves it
        LU, _piv, _info = torch.linalg.lu_factor_ex(T, pivot=False)
        return LU.contiguous()
    return getrf_plain(T)


def trsm_l_cpu(T, C, **_):
    # C := L_kk^{-1} C with unit-diagonal L from the packed LU tile
    L = np.tril(T, -1) + np.eye(T.shape[0], dtype=T.dtype)
    C[:] = np.linalg.solve(L, C)


def trsm_l_cuda(T, C, **_):
    return torch.linalg.solve_triangular(T, C, upper=False,
                                         unitriangular=True).contiguous()


def trsm_u_cpu(T, C, **_):
    # C := C U_kk^{-1} with upper U from the packed LU tile
    U = np.triu(T)
    C[:] = np.linalg.solve(U.T, C.T).T


def trsm_u_cuda(T, C, **_):
    return torch.linalg.solve_triangular(T, C, upper=True, left=False).contiguous()


def gemm_lu_cpu(A, B1, B2, **_):
    A -= B1 @ B2


def gemm_lu_cuda(A, B1, B2, **_):
    return A - B1 @ B2


def gemm_lu_kernel(A, B1, B2, **_):
    return kernels.matmul_update(A, B1, B2, alpha=-1.0, transpose_b=False)


# -- the PTG -----------------------------------------------------------------

def lu_ptg(*, use_cuda: bool = True, use_cpu: bool = True,
           use_kernels: bool = False) -> PTG:
    """Build the no-pivot tiled-LU PTG (instantiate with
    ``.taskpool(NT=A.mt, A=A)``; in place: L strictly-lower with unit
    diagonal, U upper, packed into A).  A kernel chore is a device chore:
    ``use_kernels`` implies the CUDA incarnation."""
    ptg = PTG("getrf")

    def bodies(cpu, cuda):
        kw = {}
        if use_cpu:
            kw["cpu"] = cpu
        if use_cuda or use_kernels:
            kw["cuda"] = cuda
        return kw

    getrf = ptg.task_class("getrf", k="0 .. NT-1")
    getrf.affinity("A(k, k)")
    getrf.priority("(NT - k) * 1000")
    getrf.flow("T", INOUT,
               "<- (k == 0) ? A(k, k) : A gemm(k-1, k, k)",
               "-> T trsm_l(k, k+1 .. NT-1)",
               "-> T trsm_u(k, k+1 .. NT-1)",
               "-> A(k, k)")
    getrf.body(**bodies(getrf_cpu, getrf_cuda))

    trsm_l = ptg.task_class("trsm_l", k="0 .. NT-2", n="k+1 .. NT-1")
    trsm_l.affinity("A(k, n)")
    trsm_l.priority("(NT - n) * 100")
    trsm_l.flow("T", IN, "<- T getrf(k)")
    trsm_l.flow("C", INOUT,
                "<- (k == 0) ? A(k, n) : A gemm(k-1, k, n)",
                "-> B2 gemm(k, k+1 .. NT-1, n)",
                "-> A(k, n)")
    trsm_l.body(**bodies(trsm_l_cpu, trsm_l_cuda))

    trsm_u = ptg.task_class("trsm_u", k="0 .. NT-2", m="k+1 .. NT-1")
    trsm_u.affinity("A(m, k)")
    trsm_u.priority("(NT - m) * 100")
    trsm_u.flow("T", IN, "<- T getrf(k)")
    trsm_u.flow("C", INOUT,
                "<- (k == 0) ? A(m, k) : A gemm(k-1, m, k)",
                "-> B1 gemm(k, m, k+1 .. NT-1)",
                "-> A(m, k)")
    trsm_u.body(**bodies(trsm_u_cpu, trsm_u_cuda))

    gemm = ptg.task_class("gemm", k="0 .. NT-2", m="k+1 .. NT-1", n="k+1 .. NT-1")
    gemm.affinity("A(m, n)")
    gemm.priority("(NT - m) * 10")
    gemm.flow("A", INOUT,
              "<- (k == 0) ? A(m, n) : A gemm(k-1, m, n)",
              "-> (m == k+1 and n == k+1) ? T getrf(k+1)",
              "-> (m == k+1 and n > k+1) ? C trsm_l(k+1, n)",
              "-> (m > k+1 and n == k+1) ? C trsm_u(k+1, m)",
              "-> (m > k+1 and n > k+1) ? A gemm(k+1, m, n)",
              "-> A(m, n)")
    gemm.flow("B1", IN, "<- C trsm_u(k, m)")
    gemm.flow("B2", IN, "<- C trsm_l(k, n)")
    gemm.body(**bodies(gemm_lu_cpu, gemm_lu_kernel if use_kernels else gemm_lu_cuda))

    return ptg


def lu_task_count(nt: int) -> int:
    """Tasks of one tiled LU over ``nt`` x ``nt`` tiles: nt getrf,
    nt(nt-1)/2 trsm_l and trsm_u each, and sum (nt-1-k)^2 gemm."""
    return nt + nt * (nt - 1) + (nt - 1) * nt * (2 * nt - 1) // 6


def run_lu(context, A, *, use_cuda: bool = True, use_cpu: bool = True,
           use_kernels: bool = False) -> None:
    """Factorize TiledMatrix ``A`` in place: A := L\\U (no pivoting —
    the caller guarantees diagonal dominance or similar)."""
    if A.m != A.n or A.mb != A.nb:
        # a ragged last row/col is fine for a square matrix with square
        # tiles; a non-square one would factorize only a leading block
        raise ValueError(
            f"tiled LU needs a square matrix with square tiles; "
            f"got {A.m}x{A.n}, tiles {A.mb}x{A.nb}")
    tp = lu_ptg(use_cuda=use_cuda, use_cpu=use_cpu,
                use_kernels=use_kernels).taskpool(NT=A.mt, A=A)
    context.add_taskpool(tp)
    if not tp.wait(timeout=None):
        raise RuntimeError(f"lu taskpool failed: {tp.fail_reason}")
