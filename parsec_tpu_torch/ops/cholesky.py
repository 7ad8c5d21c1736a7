"""Tiled Cholesky factorization (dpotrf) as a PTG — the flagship taskpool.

The classic right-looking tiled algorithm expressed in the PTG DSL (the
port of :mod:`parsec_tpu.ops.cholesky`, same task classes, flows and
priorities):

  for k:  potrf(k):      A[k,k]   = chol(A[k,k])
          trsm(k, m):    A[m,k]   = A[m,k] @ A[k,k]^{-T}          (m > k)
          syrk(k, m):    A[m,m]  -= A[m,k] @ A[m,k]^T             (m > k)
          gemm(k, m, n): A[m,n]  -= A[m,k] @ A[n,k]^T         (m > n > k)

Dataflow: each tile's value threads through the update chain as a flow, so
lookahead across iterations emerges from dependencies alone.
"""

from __future__ import annotations

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG
from . import tiles

IN = AccessMode.IN
INOUT = AccessMode.INOUT


def cholesky_ptg(*, use_cuda: bool = True, use_cpu: bool = True,
                 use_kernels: bool = False, use_trtri: bool = False,
                 bf16_updates: bool = False) -> PTG:
    """Build the dpotrf PTG (instantiate with ``.taskpool(NT=..., A=...)``
    where ``A`` is a TiledMatrix holding the SPD matrix; the factorization
    happens in place, lower-triangular).

    ``use_kernels`` swaps the syrk/gemm update chores (and, with
    ``use_trtri``, the trsm chore) for the hand-written CUDA kernels of
    :mod:`parsec_tpu_torch.ops.kernels` — the reference's ``use_pallas``.
    A kernel chore is a device chore: it implies the CUDA incarnation.

    ``use_trtri`` adds a per-column ``trtri(k)`` task inverting the
    factored diagonal block, turning every trsm into one product
    ``C @ inv(T)^T``.  CPU chores then need the ``TILE_SHAPE``/
    ``TILE_DTYPE`` constants for the NEW-flow scratch (device chores are
    functional and ignore it).

    ``bf16_updates`` (requires ``use_kernels``) feeds the syrk/gemm panel
    operands to the kernel in bfloat16 with f32 accumulation — only the
    operand cast rounds (bf16 x bf16 products are exact in f32)."""
    ptg = PTG("dpotrf")

    def bodies(cpu, cuda):
        kw = {}
        if use_cpu:
            kw["cpu"] = cpu
        if use_cuda or use_kernels:
            kw["cuda"] = cuda
        return kw

    potrf = ptg.task_class("potrf", k="0 .. NT-1")
    potrf.affinity("A(k, k)")
    potrf.priority("(NT - k) * 1000")
    potrf.flow("T", INOUT,
               "<- (k == 0) ? A(k, k) : A syrk(k-1, k)",
               # trtri mode: the factored block feeds the inverter, which
               # fans the inverse out to the column's trsms
               "-> T trtri(k)" if use_trtri else "-> T trsm(k, k+1 .. NT-1)",
               "-> A(k, k)")
    potrf.body(**bodies(tiles.potrf_cpu, tiles.potrf_cuda))

    if use_trtri:
        trtri = ptg.task_class("trtri", k="0 .. NT-2")
        trtri.affinity("A(k, k)")
        trtri.priority("(NT - k) * 1000 - 1")  # right behind its potrf
        trtri.flow("T", IN, "<- T potrf(k)")
        trtri.flow("I", INOUT,
                   "<- NEW",
                   "-> I trsm(k, k+1 .. NT-1)")
        trtri.body(**bodies(tiles.trtri_cpu, tiles.trtri_cuda))

    trsm = ptg.task_class("trsm", k="0 .. NT-2", m="k+1 .. NT-1")
    trsm.affinity("A(m, k)")
    trsm.priority("(NT - m) * 100")
    if use_trtri:
        trsm.flow("I", IN,
                  "<- I trtri(k)")
    else:
        trsm.flow("T", IN,
                  "<- T potrf(k)")
    trsm.flow("C", INOUT,
              "<- (k == 0) ? A(m, k) : A gemm(k-1, m, k)",
              "-> B syrk(k, m)",
              "-> B1 gemm(k, m, k+1 .. m-1)",
              "-> B2 gemm(k, m+1 .. NT-1, m)",
              "-> A(m, k)")
    if use_trtri:
        trsm.body(**bodies(tiles.trsm_inv_cpu,
                           tiles.trsm_inv_kernel if use_kernels
                           else tiles.trsm_inv_cuda))
    else:
        trsm.body(**bodies(tiles.trsm_cpu, tiles.trsm_cuda))

    syrk = ptg.task_class("syrk", k="0 .. NT-2", m="k+1 .. NT-1")
    syrk.affinity("A(m, m)")
    syrk.priority("(NT - m) * 100 + 10")
    syrk.flow("A", INOUT,
              "<- (k == 0) ? A(m, m) : A syrk(k-1, m)",
              "-> (k == m-1) ? T potrf(m) : A syrk(k+1, m)")
    syrk.flow("B", IN,
              "<- C trsm(k, m)")
    syrk_dev = tiles.syrk_cuda
    gemm_dev = tiles.gemm_update_cuda
    if use_kernels:
        syrk_dev = tiles.syrk_kernel_bf16 if bf16_updates else tiles.syrk_kernel
        gemm_dev = (tiles.gemm_update_kernel_bf16 if bf16_updates
                    else tiles.gemm_update_kernel)
    elif bf16_updates:
        raise ValueError("bf16_updates requires use_kernels")
    syrk.body(**bodies(tiles.syrk_cpu, syrk_dev))

    gemm = ptg.task_class("gemm", k="0 .. NT-3", m="k+2 .. NT-1", n="k+1 .. m-1")
    gemm.affinity("A(m, n)")
    gemm.priority("(NT - m) * 10")
    gemm.flow("A", INOUT,
              "<- (k == 0) ? A(m, n) : A gemm(k-1, m, n)",
              "-> (k == n-1) ? C trsm(n, m) : A gemm(k+1, m, n)")
    gemm.flow("B1", IN, "<- C trsm(k, m)")
    gemm.flow("B2", IN, "<- C trsm(k, n)")
    gemm.body(**bodies(tiles.gemm_update_cpu, gemm_dev))

    return ptg


def dpotrf_task_count(nt: int, *, use_trtri: bool = False) -> int:
    """Tasks of one dpotrf over ``nt`` x ``nt`` tiles: nt potrf,
    nt(nt-1)/2 trsm and syrk, C(nt, 3) gemm, plus nt-1 trtri."""
    n = nt + nt * (nt - 1) + nt * (nt - 1) * (nt - 2) // 6
    return n + (nt - 1 if use_trtri else 0)


def run_cholesky(context, A, *, use_cuda: bool = True, use_cpu: bool = True,
                 use_kernels: bool = False, use_trtri: bool = False,
                 bf16_updates: bool = False) -> None:
    """Factorize TiledMatrix ``A`` (SPD) in place: A := L (lower)."""
    consts = {}
    if use_trtri and use_cpu:
        consts = {"TILE_SHAPE": (A.mb, A.nb), "TILE_DTYPE": A.default_dtype}
    tp = cholesky_ptg(use_cuda=use_cuda, use_cpu=use_cpu,
                      use_kernels=use_kernels, use_trtri=use_trtri,
                      bf16_updates=bf16_updates).taskpool(NT=A.mt, A=A, **consts)
    context.add_taskpool(tp)
    ok = tp.wait(timeout=None)
    if not ok:
        raise RuntimeError(f"cholesky taskpool failed: {tp.fail_reason}")
