"""Panel-segmented QR through the runtime: Block Classical Gram-Schmidt
with CholeskyQR2 panels.

The port of :mod:`parsec_tpu.ops.segmented_qr`:

    per panel k (ALWAYS full height — BCGS deflates columns, rows never
    shrink, so every op below is a large product):
      Q_k, R_kk = CQR2(A[:, k])          # gram, chol, trsm-as-gemm, x2
      R_kj = Q_k^T A_j   (j > k)          # block row of R
      A_j -= Q_k R_kj                     # deflation

    CQR2(P): R1 = chol(P^T P)^T; Q1 = P R1^-1; repeat on Q1; R = R2 R1.

The factorization emits EXPLICIT Q (in place of A) and R (a second matrix
threaded as a second flow), both updated IN PLACE on the card by a
donating body (:mod:`.segmented_chol`'s runtime model).

Precision: ``prec`` takes the reference's names (``"highest"``,
``"high"``, ``"default"``; :func:`.segmented_lu.check_precision`); every
float32 product here runs in full FP32 whichever is named (the device
module turns TF32 off).  bf16 modes are rejected, with the reference's
measured rationale (:func:`_make_qr_body_generic`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG
from .segmented_chol import (_attach_device_matrix, _chunked, auto_nb,
                             device_module, n_segments, run_on_device)
from .segmented_lu import check_precision
from .tiles import check_tiling

INOUT = AccessMode.INOUT


def _chol_r(G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, inv(R)^T) with G = R^T R, R upper."""
    L, _info = torch.linalg.cholesky_ex(G)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return L.mT, torch.linalg.solve_triangular(L, eye, upper=False)


def _cqr2(P: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR2 of a full-height panel: returns (Q, R) with Q^T Q ~ I."""
    R1, W1 = _chol_r(P.mT @ P)
    Q1 = P @ W1.mT
    R2, W2 = _chol_r(Q1.mT @ Q1)
    return Q1 @ W2.mT, R2 @ R1


def _make_qr_body(n: int, nb: int, strip: int, prec, kt: Optional[int] = None):
    """Whole-matrix QR panel body (``specialize="static"``)."""
    nt = n // nb
    if kt is None:
        kt = nt - 1

    def step(M, R, k):
        k0 = k * nb
        Q, Rkk = _cqr2(M[:, k0:k0 + nb])
        M[:, k0:k0 + nb] = Q
        R[k0:k0 + nb, k0:k0 + nb] = Rkk.triu()
        for c0 in range(k0 + nb, n, strip):
            w = min(strip, n - c0)
            T = M[:, c0:c0 + w]
            Rk = Q.mT @ T
            R[k0:k0 + nb, c0:c0 + w] = Rk
            T.addmm_(Q, Rk, alpha=-1.0)

    def panel(M, R, k, **_):
        for kk in range(k, nt if k >= kt else k + 1):
            step(M, R, kk)  # task kt runs the fused tail [kt, NT)
        return M, R

    panel._donate_args = (0, 1)  # Q overwrites A; R accumulates in place
    return panel


def _make_qr_body_generic(n: int, nb: int, strip: int, prec,
                          kt: Optional[int] = None, bf16=False):
    """The reference's parameter-generic QR panel body: the trailing
    deflation walks the exact column chunk grid
    (:func:`.segmented_chol._chunked`); BCGS columns are always full
    height, so no row offsets are needed.

    ``bf16`` is REJECTED for QR, as in the reference, on its measurements
    (TPU v5e, not re-measured here):

    * numerically: one-shot Block CLASSICAL Gram-Schmidt amplifies any
      deflation-path error by the input's conditioning (the classic CGS
      loss-of-orthogonality bound).  Measured on a random gaussian n=256 /
      kappa~1.4e3 input: bf16 OPERAND deflation -> orth err 0.17; bf16
      STORAGE of the trailing matrix between panels -> orth err 0.125 —
      both fail even a 1e-1 gate while f32 measures 3.4e-5.
    * performance: BCGS at nb=512 runs ~nb/2 = 256 flops/byte, so QR is
      bound by its products, not by the bytes bf16 storage would halve."""
    if bf16:
        raise ValueError(
            "bf16 QR modes are rejected: CGS error amplification ~ "
            "kappa(A) breaks orthogonality (measured 0.17 operand-cast / "
            "0.125 storage at n=256 vs 3.4e-5 f32), and BCGS at nb>=512 "
            "is bound by its products, not by bytes — see "
            "_make_qr_body_generic docstring")
    nt = n // nb
    if kt is None:
        kt = nt - 1

    def step(k, M, R):
        k0 = k * nb
        Q, Rkk = _cqr2(M[:, k0:k0 + nb])
        M[:, k0:k0 + nb] = Q
        R[k0:k0 + nb, k0:k0 + nb] = Rkk.triu()

        def upd(c0, w, carry):
            T = M[:, c0:c0 + w]
            Rk = Q.mT @ T
            R[k0:k0 + nb, c0:c0 + w] = Rk
            T.addmm_(Q, Rk, alpha=-1.0)

        _chunked(k, n, nb, strip, upd, None)

    def panel(M, R, k, **_):
        # task k runs steps [k, k+1) — the fused-tail task kt runs [kt, nt)
        for kk in range(k, nt if (kt < nt and k >= kt) else k + 1):
            step(kk, M, R)
        return M, R

    panel._donate_args = (0, 1)
    return panel


def segmented_qr_ptg(n: int, nb: int, *, strip: int = 4096,
                     prec=None, specialize: str = "generic",
                     tail: int = 4096, bf16=False) -> PTG:
    """Build the BCGS/CQR2 QR PTG.  Instantiate with
    ``.taskpool(NT=n_segments(n, nb, tail), A=collection, R=collection)``:
    ``A(0)`` holds the matrix (becomes Q in place), ``R(0)`` a zero matrix
    (becomes R).  ``tail`` fuses the final panels (trailing size <= tail)
    into the last task; 0 disables."""
    check_tiling(n, nb, op="segmented QR")
    strip = min(strip, n)
    check_tiling(strip, nb, what="strip", op="segmented QR")
    prec = check_precision(prec)
    if bf16:
        # surface the rejection for the static path too (the generic
        # builder carries the measured rationale)
        _make_qr_body_generic(n, nb, strip, prec, bf16=bf16)
    if specialize not in ("static", "generic"):
        raise ValueError(f"unknown specialize mode {specialize!r}")
    kt = n_segments(n, nb, tail) - 1
    ptg = PTG("dgeqrf_seg")
    panel = ptg.task_class("panel", k="0 .. NT-1")
    panel.affinity("A(0)")
    panel.priority("NT - k")
    panel.flow("M", INOUT,
               "<- (k == 0) ? A(0) : M panel(k-1)",
               "-> (k == NT-1) ? A(0) : M panel(k+1)")
    panel.flow("R", INOUT,
               "<- (k == 0) ? R(0) : R panel(k-1)",
               "-> (k == NT-1) ? R(0) : R panel(k+1)")
    if specialize == "generic":
        panel.body(cuda=_make_qr_body_generic(n, nb, strip, prec, kt, bf16))
    else:
        panel.body(cuda=_make_qr_body(n, nb, strip, prec, kt))
    return ptg


class SegmentedQR:
    """QR a device-resident matrix through taskpool + scheduler + the CUDA
    device module.  Returns explicit (Q, R)."""

    def __init__(self, context, n: int, nb="auto", *, strip: int = 4096,
                 prec=None, specialize: str = "generic",
                 tail: int = 4096, bf16=False):
        nb = auto_nb(nb, n)
        self.context = context
        self.n, self.nb = n, nb
        self.nt_tasks = n_segments(n, nb, tail)
        self.ptg = segmented_qr_ptg(n, nb, strip=strip, prec=prec,
                                    specialize=specialize, tail=tail,
                                    bf16=bf16)
        self.device = device_module(context, "segmented QR")

    def run(self, A_dev: torch.Tensor, *, timeout: Optional[float] = 600) -> Tuple:
        """Factorize; ``A_dev`` becomes Q in place.  Returns (Q, R) device
        tensors."""
        R_dev = torch.zeros((self.n, self.n), dtype=A_dev.dtype, device=A_dev.device)
        dA, dR = (_attach_device_matrix(self.device, name, arr)
                  for name, arr in (("A", A_dev), ("R", R_dev)))
        tp = self.ptg.taskpool(NT=self.nt_tasks, A=dA.collection, R=dR.collection)
        Q, R = run_on_device(self.context, self.device, tp, [dA, dR],
                             "segmented QR", timeout)
        return Q, R

    def __call__(self, A_np: np.ndarray):
        # a fresh device tensor: the in-place run never writes into the
        # caller's array
        A = torch.tensor(np.ascontiguousarray(A_np), device=self.device.tdev)
        Q, R = self.run(A)
        return (Q.float().cpu().numpy(), np.triu(R.float().cpu().numpy()))
