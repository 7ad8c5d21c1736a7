"""Tiled Householder-class QR factorization as a PTG.

The port of :mod:`parsec_tpu.ops.qr`, the PLASMA-style tiled task graph:

  for k:  geqrt(k):       A[k,k]          -> Q_k, R_kk
          unmqr(k, n):    A[k,n]          <- Q_k^T A[k,n]        (n > k)
          tsqrt(k, m):    [R_kk; A[m,k]]  -> Q_km, R_kk'         (m > k)
          tsmqr(k, m, n): [A[k,n]; A[m,n]] <- Q_km^T [ . ; . ]   (m,n > k)

The orthogonal factors are small dense Q blocks passed along NEW flows, so
every update is a plain product.  tsqrt's (2nb, 2nb) Q comes from
``"<- NEW [type=QSHAPE2]"``: the property resolves through the taskpool's
constants (:meth:`..dsl.ptg.PTGTaskpool.new_tile_spec`).  The result is R
in the upper triangle of A (tiles below the diagonal zeroed); the
invariant A^T A = R^T R verifies it without Q.

geqrt and tsqrt stay library QRs (``torch.linalg.qr``, XLA in the
reference); ``use_kernels`` runs unmqr and tsmqr through the hand-written
B2 kernel, ``Q^T @ C`` with ``transpose_b=False`` (the reference's
``use_pallas``).  The kernel takes contiguous operands, so ``Q^T`` is made
contiguous first: nb^2 (unmqr) or 4 nb^2 (tsmqr) elements copied beside a
product of 2 nb^3 or 8 nb^3 flops.  float32 products run in full FP32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG
from . import kernels
from .lu import lu_task_count

IN = AccessMode.IN
INOUT = AccessMode.INOUT


# -- tile bodies -------------------------------------------------------------

def geqrt_cpu(T, Q, **_):
    q, r = np.linalg.qr(T)
    T[:] = r
    Q[:] = q


def geqrt_cuda(T, Q, **_):
    q, r = torch.linalg.qr(T)
    return r.contiguous(), q.contiguous()


def unmqr_cpu(Q, C, **_):
    C[:] = Q.T @ C


def unmqr_cuda(Q, C, **_):
    return Q.mT @ C


def tsqrt_cpu(R, B, Q, **_):
    nb = R.shape[0]
    stacked = np.vstack([np.triu(R), B])
    q, r = np.linalg.qr(stacked, mode="complete")
    R[:] = r[:nb]
    B[:] = 0.0
    Q[:] = q


def tsqrt_cuda(R, B, Q, **_):
    # functional: the NEW-flow input Q is shape-irrelevant scratch
    nb = R.shape[0]
    q, r = torch.linalg.qr(torch.cat([R.triu(), B]), mode="complete")
    return r[:nb].contiguous(), torch.zeros_like(B), q.contiguous()


def tsmqr_cpu(Q, C1, C2, **_):
    nb = C1.shape[0]
    s = Q.T @ np.vstack([C1, C2])
    C1[:] = s[:nb]
    C2[:] = s[nb:]


def tsmqr_cuda(Q, C1, C2, **_):
    nb = C1.shape[0]
    s = Q.mT @ torch.cat([C1, C2])
    return s[:nb], s[nb:]


def unmqr_kernel(Q, C, **_):
    return kernels.matmul(Q.mT.contiguous(), C, transpose_b=False)


def tsmqr_kernel(Q, C1, C2, **_):
    nb = C1.shape[0]
    s = kernels.matmul(Q.mT.contiguous(), torch.cat([C1, C2]), transpose_b=False)
    return s[:nb], s[nb:]


# -- the PTG -----------------------------------------------------------------

def qr_ptg(*, use_cuda: bool = True, use_cpu: bool = True,
           use_kernels: bool = False) -> PTG:
    """Build the tiled-QR PTG. Instantiate with ``.taskpool(NT=A.mt, A=A,
    TILE_SHAPE=(nb, nb), TILE_DTYPE=..., QSHAPE2=(dtype, (2*nb, 2*nb)))``
    — the NEW-flow Q blocks are allocated from ``TILE_SHAPE`` except
    tsqrt's, whose ``[type=QSHAPE2]`` dep property resolves the (2nb, 2nb)
    stacked-Q shape through the constants (device chores are functional
    and ignore the scratch; the shapes matter for the in-place CPU path).
    :func:`run_qr` fills these in.  A kernel chore is a device chore:
    ``use_kernels`` implies the CUDA incarnation.

    Square tile grids with uniform tiles (N divisible by nb)."""
    ptg = PTG("geqrf")

    def bodies(cpu, cuda):
        kw = {}
        if use_cpu:
            kw["cpu"] = cpu
        if use_cuda or use_kernels:
            kw["cuda"] = cuda
        return kw

    geqrt = ptg.task_class("geqrt", k="0 .. NT-1")
    geqrt.affinity("A(k, k)")
    geqrt.priority("(NT - k) * 1000")
    geqrt.flow("T", INOUT,
               "<- (k == 0) ? A(k, k) : C2 tsmqr(k-1, k, k)",
               "-> (k < NT-1) ? R tsqrt(k, k+1)",
               "-> (k == NT-1) ? A(k, k)")
    geqrt.flow("Q", INOUT,
               "<- NEW",
               "-> Q unmqr(k, k+1 .. NT-1)")
    geqrt.body(**bodies(geqrt_cpu, geqrt_cuda))

    tsqrt = ptg.task_class("tsqrt", k="0 .. NT-2", m="k+1 .. NT-1")
    tsqrt.affinity("A(m, k)")
    tsqrt.priority("(NT - m) * 100 + 500")
    tsqrt.flow("R", INOUT,
               "<- (m == k+1) ? T geqrt(k) : R tsqrt(k, m-1)",
               "-> (m < NT-1) ? R tsqrt(k, m+1) : A(k, k)")
    tsqrt.flow("B", INOUT,
               "<- (k == 0) ? A(m, k) : C2 tsmqr(k-1, m, k)",
               "-> A(m, k)")
    tsqrt.flow("Q", INOUT,
               "<- NEW [type=QSHAPE2]",  # (2nb, 2nb): taskpool constant
               "-> Q tsmqr(k, m, k+1 .. NT-1)")
    tsqrt.body(**bodies(tsqrt_cpu, tsqrt_cuda))

    unmqr = ptg.task_class("unmqr", k="0 .. NT-2", n="k+1 .. NT-1")
    unmqr.affinity("A(k, n)")
    unmqr.priority("(NT - n) * 100 + 400")
    unmqr.flow("Q", IN, "<- Q geqrt(k)")
    unmqr.flow("C", INOUT,
               "<- (k == 0) ? A(k, n) : C2 tsmqr(k-1, k, n)",
               "-> C1 tsmqr(k, k+1, n)")
    unmqr.body(**bodies(unmqr_cpu, unmqr_kernel if use_kernels else unmqr_cuda))

    tsmqr = ptg.task_class("tsmqr", k="0 .. NT-2", m="k+1 .. NT-1", n="k+1 .. NT-1")
    tsmqr.affinity("A(m, n)")
    tsmqr.priority("(NT - m) * 10")
    tsmqr.flow("Q", IN, "<- Q tsqrt(k, m)")
    tsmqr.flow("C1", INOUT,
               "<- (m == k+1) ? C unmqr(k, n) : C1 tsmqr(k, m-1, n)",
               "-> (m < NT-1) ? C1 tsmqr(k, m+1, n) : A(k, n)")
    tsmqr.flow("C2", INOUT,
               "<- (k == 0) ? A(m, n) : C2 tsmqr(k-1, m, n)",
               "-> (m == k+1 and n == k+1) ? T geqrt(k+1)",
               "-> (m == k+1 and n > k+1) ? C unmqr(k+1, n)",
               "-> (m > k+1 and n == k+1) ? B tsqrt(k+1, m)",
               "-> (m > k+1 and n > k+1) ? C2 tsmqr(k+1, m, n)",
               "-> A(m, n)")
    tsmqr.body(**bodies(tsmqr_cpu, tsmqr_kernel if use_kernels else tsmqr_cuda))

    return ptg


def qr_constants(A) -> dict:
    """The taskpool constants :func:`qr_ptg` needs for TiledMatrix ``A``."""
    nb = A.mb
    return dict(TILE_SHAPE=(nb, nb), TILE_DTYPE=A.default_dtype,
                QSHAPE2=(A.default_dtype, (2 * nb, 2 * nb)))


#: tasks of one tiled QR over nt x nt tiles: LU's count — nt geqrt,
#: nt(nt-1)/2 unmqr and tsqrt each, and sum (nt-1-k)^2 tsmqr
qr_task_count = lu_task_count


def run_qr(context, A, *, use_cuda: bool = True, use_cpu: bool = True,
           use_kernels: bool = False) -> None:
    """Factorize TiledMatrix ``A`` in place: A := R (upper), zeros below."""
    if A.m != A.n or A.mb != A.nb or A.m % A.mb != 0:
        raise ValueError(
            f"tiled QR needs a square matrix with uniform square tiles "
            f"(N divisible by nb); got {A.m}x{A.n}, tiles {A.mb}x{A.nb}")
    tp = qr_ptg(use_cuda=use_cuda, use_cpu=use_cpu,
                use_kernels=use_kernels).taskpool(NT=A.mt, A=A, **qr_constants(A))
    context.add_taskpool(tp)
    if not tp.wait(timeout=None):
        raise RuntimeError(f"qr taskpool failed: {tp.fail_reason}")
