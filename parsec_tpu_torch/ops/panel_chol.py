"""Panel-wise Cholesky: the whole factorization as NT panel steps on one
matrix, outside the task runtime.

The port of :mod:`parsec_tpu.ops.panel_chol`.  Per step k (panel offset
k0 = k*nb, trailing rows R):

    L  = chol(A[k0:k0+nb, k0:k0+nb]);  W = inv(L)      # nb x nb, library
    P  = A[k0+nb:k0+nb+R, k0:k0+nb] @ W.T              # panel trsm as ONE gemm
    A[k0+nb:, k0+nb:] -= P @ P.T                       # rank-nb update

The update writes both triangles, which keeps the trailing matrix
symmetric (no masking anywhere) at about twice a tile-wise syrk's flops.
Every step updates the matrix IN PLACE through views (the reference's
donated ``.at[].set``): one matrix and one step's temporaries on the card.

* :class:`PanelCholesky` pads the matrix with an identity diagonal to a
  bucket multiple, so each step's trailing size is its bucketed R (the
  reference compiles one program per bucket; eager torch runs the same
  arithmetic with nothing to compile);
* :class:`WholeCholesky` runs every step with its exact trailing shape —
  the runtime-bypassing ceiling the segmented path
  (:mod:`.segmented_chol`) is measured against.

The products are library calls (the reference leaves them to XLA).
float32 products run in full FP32 (the CUDA device module and
``chip_smoke.py`` turn TF32 off).  ``bf16=True`` feeds the update's
operands in bfloat16 with f32 accumulation; ``bf16="storage"`` keeps the
matrix itself in bfloat16 (panel math in f32) — half the bytes.  On the
torch CPU device a bf16 x bf16 product widens its operands to f32 first
(exact products, f32 sums): the CPU has no bf16 GEMM with an f32 output.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import math
import numpy as np
import torch

from ..dsl.cuda_graph import resolve_device
from .tiles import check_tiling


def mm_acc32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result: bfloat16 operands
    run one bf16 GEMM on the card (``out_dtype``) and are widened to f32
    on the CPU (a bf16 x bf16 product is exact in f32)."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def chol_inv(D: torch.Tensor):
    """(L, inv(L)) of an SPD block: ``cholesky_ex`` (no host sync on the
    info flag, as ``tiles.potrf_cuda``) and one triangular solve."""
    L, _info = torch.linalg.cholesky_ex(D)
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def sub_product(T: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """``T -= a @ b`` in place, ``T`` usually a strided view of the matrix:
    f32/f64 operands as one ``addmm_`` into the view; bf16 operands with
    f32 accumulation; a bf16 ``T`` (storage mode) updated in f32 and
    rounded once."""
    if T.dtype == torch.bfloat16:
        T.copy_((T.float() - mm_acc32(a, b)).to(torch.bfloat16))
    elif a.dtype == torch.bfloat16:
        T.sub_(mm_acc32(a, b))
    else:
        T.addmm_(a, b, alpha=-1.0)


def _panel_step(A: torch.Tensor, k0: int, *, R: int, nb: int, bf16: bool,
                strip: int = 0) -> torch.Tensor:
    """One bucketed right-looking panel step on the padded matrix, in
    place.  ``strip > 0`` runs the trailing update over column strips of
    that width (which must divide R): temporaries of R x strip, not R x R."""
    L, W = chol_inv(A[k0:k0 + nb, k0:k0 + nb])
    A[k0:k0 + nb, k0:k0 + nb] = L.tril()
    if R == 0:
        return A
    P = A[k0 + nb:k0 + nb + R, k0:k0 + nb]
    if bf16:
        Pn = mm_acc32(P.to(torch.bfloat16), W.mT.to(torch.bfloat16))
    else:
        Pn = P @ W.mT
    A[k0 + nb:k0 + nb + R, k0:k0 + nb] = Pn
    Pl = Pn.to(torch.bfloat16) if bf16 else Pn
    if not strip or strip >= R:
        sub_product(A[k0 + nb:k0 + nb + R, k0 + nb:k0 + nb + R], Pl, Pl.mT)
        return A
    if R % strip:
        raise ValueError(f"strip {strip} must divide R {R}")
    for j in range(R // strip):
        c0 = k0 + nb + j * strip
        Pj = Pl[j * strip:(j + 1) * strip]
        sub_product(A[k0 + nb:k0 + nb + R, c0:c0 + strip], Pl, Pj.mT)
    return A


class PanelCholesky:
    """Bucketed panel-step factorizer; reusable across same-shape
    matrices."""

    def __init__(self, n: int, nb: int = 512, *, bucket: int = 8,
                 bf16: bool = False, strip: int = 0, device=None):
        check_tiling(n, nb, op="panel cholesky")
        if bf16 == "storage":
            raise ValueError(
                "PanelCholesky does not implement bf16='storage' — use "
                "WholeCholesky or SegmentedCholesky for the bf16-storage "
                "mode (a truthy string would silently run the operand-"
                "cast mode at full-f32 traffic)")
        self.n, self.nb, self.bucket, self.bf16 = n, nb, bucket, bf16
        self.nt = n // nb
        # pad so every bucketed trailing slice stays in bounds
        self.n_pad = n + (bucket - 1) * nb
        #: strip width for the trailing update; 0 = whole-R (auto: strip
        #: when the R x R temporaries would approach device-memory scale)
        self.strip = strip if strip else (
            bucket * nb if n * n * 4 >= (4 << 30) else 0)
        if self.strip and (bucket * nb) % self.strip:
            raise ValueError(
                f"strip {self.strip} must divide bucket*nb {bucket * nb}")
        self.device = resolve_device(device, "PanelCholesky")

    def _padded(self, A_np: np.ndarray) -> torch.Tensor:
        n, n_pad = self.n, self.n_pad
        buf = np.zeros((n_pad, n_pad), np.result_type(A_np.dtype, np.float32))
        buf[:n, :n] = A_np
        idx = np.arange(n, n_pad)
        buf[idx, idx] = 1.0  # identity padding: chol-stable, zero updates
        return torch.from_numpy(buf).to(self.device)

    def run_padded(self, A: torch.Tensor) -> torch.Tensor:
        """Factorize a padded device matrix in place and return it (the
        lower triangle of the leading N x N is L)."""
        nb, bucket, nt = self.nb, self.bucket, self.nt
        for k in range(nt):
            trail = nt - 1 - k
            R = (math.ceil(trail / bucket) * bucket) * nb if trail else 0
            _panel_step(A, k * nb, R=R, nb=nb, bf16=self.bf16, strip=self.strip)
        return A

    def __call__(self, A_np: np.ndarray) -> np.ndarray:
        A = self.run_padded(self._padded(A_np))
        return np.tril(A[: self.n, : self.n].cpu().numpy())


class WholeCholesky:
    """Every panel step with its exact trailing shape, in place, on one
    device matrix: no taskpool, no scheduler, no device module — the
    ceiling the runtime's segmented path is held against.

    ``strip`` bounds the trailing-update temporaries (R x strip)."""

    def __init__(self, n: int, nb: int = 512, *, bf16=False,
                 strip: int = 4096, device=None):
        check_tiling(n, nb, op="whole cholesky")
        if strip:
            check_tiling(strip, nb, what="strip", op="whole cholesky")
        #: ``bf16``: False = storage precision; True = bf16 operand casts
        #: (f32 accumulate/storage); "storage" = the matrix lives in bf16
        self.n, self.nb, self.bf16, self.strip = n, nb, bf16, strip
        self.store_bf16 = bf16 == "storage"
        self.nt = n // nb
        self.device = resolve_device(device, "WholeCholesky")

    def _factorize(self, A: torch.Tensor) -> torch.Tensor:
        n, nb, bf16, strip = self.n, self.nb, self.bf16, self.strip
        store = self.store_bf16
        for k in range(self.nt):
            k0 = k * nb
            D = A[k0:k0 + nb, k0:k0 + nb]
            L, W = chol_inv(D.float() if store else D)
            A[k0:k0 + nb, k0:k0 + nb] = L.tril().to(A.dtype)
            if n - k0 - nb == 0:
                continue
            P = A[k0 + nb:, k0:k0 + nb]
            if store:
                Pn = P.float() @ W.mT
                Pl = Pn.to(torch.bfloat16)
                A[k0 + nb:, k0:k0 + nb] = Pl
            elif bf16:
                Pn = mm_acc32(P.to(torch.bfloat16), W.mT.to(torch.bfloat16))
                A[k0 + nb:, k0:k0 + nb] = Pn
                Pl = Pn.to(torch.bfloat16)
            else:
                Pl = P @ W.mT
                A[k0 + nb:, k0:k0 + nb] = Pl
            for c0 in range(k0 + nb, n, strip or n):
                w = min(strip or n, n - c0)
                Pj = Pl[c0 - (k0 + nb):c0 - (k0 + nb) + w]
                sub_product(A[k0 + nb:, c0:c0 + w], Pl, Pj.mT)
        return A

    def run(self, A: torch.Tensor) -> torch.Tensor:
        """Factorize a device matrix (n x n) IN PLACE and return it.  In
        storage mode an f32 input is cast to a bf16 copy first (an f32
        matrix would keep f32 traffic with bf16-rounded numerics)."""
        if self.store_bf16 and A.dtype != torch.bfloat16:
            A = A.to(torch.bfloat16)
        return self._factorize(A)

    def __call__(self, A_np: np.ndarray) -> np.ndarray:
        # a fresh device tensor: the in-place run never writes into the
        # caller's array (on the CPU, ``torch.from_numpy`` would alias it)
        A = torch.tensor(np.ascontiguousarray(A_np), device=self.device)
        out = self.run(A)
        if self.store_bf16:
            out = out.float()  # numpy has no bfloat16
        return np.tril(out.cpu().numpy())
