"""Panel-segmented LU through the runtime: block right-looking getrf with
diagonal-block-local pivoting, everything but an nb x nb factorization
as large products.

The port of :mod:`parsec_tpu.ops.segmented_lu`:

    per step k (k0 = k*nb):
      P, L_D, U_D = lu(A[k0:k0+nb, k0:k0+nb])   # library LU, nb x nb
      A[k0:k0+nb, :] = P^T A[k0:k0+nb, :]        # block-local row swaps
      L_panel = A[k0+nb:, k0:k0+nb] @ U_D^-1     # trsm as ONE gemm
      U_row   = L_D^-1 @ A[k0:k0+nb, k0+nb:]     # trsm as ONE gemm
      A[k0+nb:, k0+nb:] -= L_panel @ U_row       # strip-mined update

**Pivoting scope**: the pivot search is restricted to the nb diagonal
rows (the reference's getrf_nopiv parity mode, with pivoting inside the
block): exact for the diagonally-dominant matrices nopiv targets, and
L U reconstructs the input.  ``pivot="panel"`` is true partial pivoting
over the full trailing column (a second flow carries the permutation).

The runtime model is :mod:`.segmented_chol`'s: one task per panel (tail
panels fused), the matrix updated IN PLACE on the card by a donating
body.  The row swap is a gather (``rows[idx]``), exact, where the
reference multiplies by the permutation matrix.

Precision (``prec``, ``solve_prec``): the reference's MXU precisions,
taken as strings — ``"highest"``, ``"high"`` and ``"default"`` — and
validated.  Every float32 product here runs in full FP32 whichever is
named (the device module turns TF32 off, and ``"default"`` is torch's
float32 matmul under that setting), so the three give the same result.
``fused_update=True`` is the reference's one-kernel ``HIGH``: the trailing
update runs through the hand-written B1 kernel in ``split_f32`` mode
(three bf16 passes, f32 accumulation; :func:`.kernels.matmul_update`).
The kernel takes contiguous operands, so each strip of the matrix (a
strided view) is copied out, updated and copied back, and the U-row
slice is made contiguous: per strip ``4 * R * w`` f32 elements of copy
traffic beside the product's ``R * nb + nb * w + 2 * R * w`` (a row pitch
in the kernel's interface would remove the copies; ROADMAP lists it).

``bf16``: False = f32 trailing update; True = bf16 operands with f32
accumulation; ``"storage"`` = the matrix lives in bf16 (panel math in
f32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG
from . import kernels
from .panel_chol import sub_product
from .segmented_chol import (_attach_device_matrix, _chunked, auto_nb,
                             device_module, n_segments, run_on_device)
from .tiles import check_tiling

INOUT = AccessMode.INOUT

#: the reference's MXU precision names; every one runs full FP32 here
PRECISIONS = ("highest", "high", "default")


def check_precision(prec, default: str = "high") -> str:
    """``prec`` as one of :data:`PRECISIONS` (None gives ``default``)."""
    if prec is None:
        return default
    name = str(prec).lower().rsplit(".", 1)[-1]
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}; expected one of {PRECISIONS}")
    return name


def split_update(T: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> None:
    """``T -= A @ B`` through B1 ``split_f32`` (``transpose_b=False``):
    the operands made contiguous for the kernel and the result copied back
    into the view ``T``."""
    T.copy_(kernels.matmul_update(T.contiguous(), A.contiguous(), B.contiguous(),
                                  alpha=-1.0, transpose_b=False, split_f32=True))


def _check_fused(fused: bool, bf16) -> None:
    if fused and bf16:
        raise ValueError("fused_update is the f32-path lever (bf16 modes "
                         "already run one pass)")


def _block_lu(D: torch.Tensor):
    """(row order, packed L\\U, inv(U), inv(L)) of an nb x nb block: the
    library LU with partial pivoting inside the block; ``idx`` such that
    ``D[idx] = L @ U``."""
    P_, L_D, U_D = torch.linalg.lu(D)
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    invU = torch.linalg.solve_triangular(U_D, eye, upper=True)
    invL = torch.linalg.solve_triangular(L_D, eye, upper=False, unitriangular=True)
    # P^T @ rows == rows[idx]: row i of the swapped block is the row j
    # with P[j, i] = 1
    return P_.argmax(dim=0), U_D.triu() + L_D.tril(-1), invU, invL


def _pivoted_panel(A: torch.Tensor, k0: int, nb: int):
    """Right-looking getf2 with PARTIAL PIVOTING over the full trailing
    column height: ``A`` is the (n, nb) full-height column block, valid
    rows ``>= k0``.  Returns the packed L\\U block (rows >= k0) and the
    GLOBAL row permutation applied (identity above k0).  nb sequential
    rank-1 steps, each on device tensors (no host sync)."""
    n = A.shape[0]
    rows = torch.arange(n, device=A.device)
    cols = torch.arange(nb, device=A.device)
    perm = rows.clone()
    for i in range(nb):
        ri = k0 + i
        p = torch.argmax(A[:, i].abs().masked_fill(rows < ri, -float("inf")))
        # swap rows ri <-> p (A and the permutation record)
        swap = torch.where(rows == ri, p, torch.where(rows == p, ri, rows))
        A, perm = A[swap], perm[swap]
        f = torch.where(rows > ri, A[:, i] / A[ri, i], torch.zeros_like(A[:, i]))
        # eliminate rows > ri, columns > i; store the multipliers in col i
        A = A - torch.outer(f, A[ri]) * (cols > i)[None, :]
        A[:, i] = torch.where(rows > ri, f, A[:, i])
    return A, perm


def _make_lu_body(n: int, nb: int, strip: int, prec, kt: int, bf16=False,
                  pivot: str = "block", fused_update: bool = False,
                  solve_prec=None):
    """Whole-matrix getrf panel body with each step's exact trailing
    block (``specialize="static"``)."""
    if pivot == "panel":
        return _make_lu_body_panelpiv(n, nb, strip, prec, kt, bf16,
                                      solve_prec=solve_prec)
    store_bf16 = bf16 == "storage"
    _check_fused(fused_update, bf16)

    def step(M, k):
        k0 = k * nb
        D = M[k0:k0 + nb, k0:k0 + nb]
        idx, LU, invU, invL = _block_lu(D.float() if store_bf16 else D)
        # block-local row swaps across ALL columns
        M[k0:k0 + nb, :] = M[k0:k0 + nb, :][idx]
        M[k0:k0 + nb, k0:k0 + nb] = LU.to(M.dtype)
        if k0 + nb >= n:
            return
        Lp = M[k0 + nb:, k0:k0 + nb].to(invU.dtype) @ invU
        Ur = invL @ M[k0:k0 + nb, k0 + nb:].to(invL.dtype)
        M[k0 + nb:, k0:k0 + nb] = Lp.to(M.dtype)
        M[k0:k0 + nb, k0 + nb:] = Ur.to(M.dtype)
        if store_bf16 or bf16:
            Lp, Ur = Lp.to(torch.bfloat16), Ur.to(torch.bfloat16)
        for c0 in range(k0 + nb, n, strip):
            w = min(strip, n - c0)
            cs = slice(c0 - k0 - nb, c0 - k0 - nb + w)
            if fused_update:
                split_update(M[k0 + nb:, c0:c0 + w], Lp, Ur[:, cs])
            else:
                sub_product(M[k0 + nb:, c0:c0 + w], Lp, Ur[:, cs])

    def panel(M, k, **_):
        for kk in range(k, n // nb if k >= kt else k + 1):
            step(M, kk)  # task kt runs the fused tail [kt, NT)
        return M

    panel._donate_args = (0,)
    return panel


def _make_lu_body_panelpiv(n: int, nb: int, strip: int, prec, kt: int,
                           bf16=False, solve_prec=None):
    """Panel-wide partial pivoting (``pivot="panel"``): the pivoted getf2
    factors each full-height panel, its row permutation is applied across
    ALL columns and composed into the pivot vector riding a second INOUT
    flow (``V[i]`` = original row now at row i, so ``A[V] = L @ U``).
    f32 storage only."""
    if bf16:
        raise NotImplementedError(
            "pivot='panel' currently supports f32 storage only")

    def step(M, V, k):
        k0 = k * nb
        C, perm = _pivoted_panel(M[:, k0:k0 + nb].clone(), k0, nb)
        # the panel's swaps apply to EVERY column and compose into V
        M.copy_(M[perm])
        V.copy_(V[perm])
        M[:, k0:k0 + nb] = C
        if k0 + nb >= n:
            return
        eye = torch.eye(nb, dtype=M.dtype, device=M.device)
        invL = torch.linalg.solve_triangular(C[k0:k0 + nb], eye, upper=False,
                                             unitriangular=True)
        Ur = invL @ M[k0:k0 + nb, k0 + nb:]
        M[k0:k0 + nb, k0 + nb:] = Ur
        Lp = C[k0 + nb:]  # the stored multipliers ARE the L panel
        for c0 in range(k0 + nb, n, strip):
            w = min(strip, n - c0)
            sub_product(M[k0 + nb:, c0:c0 + w], Lp,
                        Ur[:, c0 - k0 - nb:c0 - k0 - nb + w])

    def panel(M, V, k, **_):
        for kk in range(k, n // nb if k >= kt else k + 1):
            step(M, V, kk)
        return M, V

    panel._donate_args = (0, 1)
    return panel


def _make_lu_body_generic(n: int, nb: int, strip: int, prec, kt: int,
                          bf16=False, fused_update: bool = False,
                          solve_prec=None):
    """The reference's parameter-generic getrf panel body.  Both triangles
    hold live factors, so nothing outside the exact update region is
    written: the panel solve and the U row are computed over the full
    column/row (the out-of-range part of the result is junk and never
    written back), then stored chunk-wise over exactly ``[k0+nb, n)``
    (:func:`.segmented_chol._chunked`), and the trailing update walks the
    same chunk grid in rows x columns."""
    nt = n // nb
    store_bf16 = bf16 == "storage"
    _check_fused(fused_update, bf16)

    def step(k, M):
        k0 = k * nb
        D = M[k0:k0 + nb, k0:k0 + nb]
        idx, LU, invU, invL = _block_lu(D.float() if store_bf16 else D)
        M[k0:k0 + nb, :] = M[k0:k0 + nb, :][idx]
        M[k0:k0 + nb, k0:k0 + nb] = LU.to(M.dtype)
        # full-extent solves; only the [k0+nb, n) part is ever stored
        Lp = M[:, k0:k0 + nb].to(invU.dtype) @ invU   # rows >= k0+nb valid
        Ur = invL @ M[k0:k0 + nb, :].to(invL.dtype)   # cols >= k0+nb valid

        def put_col(r0, h, carry):
            M[r0:r0 + h, k0:k0 + nb] = Lp[r0:r0 + h].to(M.dtype)

        def put_row(c0, w, carry):
            M[k0:k0 + nb, c0:c0 + w] = Ur[:, c0:c0 + w].to(M.dtype)

        _chunked(k, n, nb, strip, put_col, None)
        _chunked(k, n, nb, strip, put_row, None)
        if store_bf16 or bf16:
            Lp, Ur = Lp.to(torch.bfloat16), Ur.to(torch.bfloat16)

        def upd(r0, h, c0, w):
            T = M[r0:r0 + h, c0:c0 + w]
            if fused_update:
                split_update(T, Lp[r0:r0 + h], Ur[:, c0:c0 + w])
            else:
                sub_product(T, Lp[r0:r0 + h], Ur[:, c0:c0 + w])

        def cols(c0, w, carry):
            return _chunked(k, n, nb, strip,
                            lambda r0, h, c: upd(r0, h, c0, w), carry)

        _chunked(k, n, nb, strip, cols, None)

    def panel(M, k, **_):
        # task k runs steps [k, k+1); the fused-tail task kt runs [kt, nt)
        for kk in range(k, nt if (kt < nt and k >= kt) else k + 1):
            step(kk, M)
        return M

    panel._donate_args = (0,)
    return panel


def segmented_lu_ptg(n: int, nb: int, *, strip: int = 4096,
                     prec=None, tail: int = 4096,
                     specialize: str = "generic", bf16=False,
                     pivot: str = "block",
                     fused_update: bool = False,
                     solve_prec=None) -> PTG:
    """Build the segmented getrf PTG (factors in place: unit-lower L below
    the diagonal, U on/above).  Instantiate with
    ``.taskpool(NT=n_segments(n, nb, tail), A=collection)`` (and
    ``PV=collection`` with ``pivot="panel"``, which needs
    ``specialize="static"`` and f32 storage)."""
    check_tiling(n, nb, op="segmented LU")
    strip = min(strip, n)
    check_tiling(strip, nb, what="strip", op="segmented LU")
    prec = check_precision(prec)
    solve_prec = check_precision(solve_prec, "highest" if pivot == "panel" else prec)
    if specialize not in ("static", "generic"):
        raise ValueError(f"unknown specialize mode {specialize!r}")
    kt = n_segments(n, nb, tail) - 1
    ptg = PTG("dgetrf_seg")
    panel = ptg.task_class("panel", k="0 .. NT-1")
    panel.affinity("A(0)")
    panel.priority("NT - k")
    panel.flow("M", INOUT,
               "<- (k == 0) ? A(0) : M panel(k-1)",
               "-> (k == NT-1) ? A(0) : M panel(k+1)")
    if pivot == "panel":
        if specialize != "static":
            raise ValueError("pivot='panel' requires specialize='static'")
        panel.flow("V", INOUT,
                   "<- (k == 0) ? PV(0) : V panel(k-1)",
                   "-> (k == NT-1) ? PV(0) : V panel(k+1)")
        panel.body(cuda=_make_lu_body_panelpiv(n, nb, strip, prec, kt, bf16=bf16,
                                               solve_prec=solve_prec))
        return ptg
    if pivot != "block":
        raise ValueError(f"unknown pivot mode {pivot!r}")
    make = (_make_lu_body_generic if specialize == "generic"
            else _make_lu_body)
    panel.body(cuda=make(n, nb, strip, prec, kt, bf16=bf16,
                         fused_update=fused_update, solve_prec=solve_prec))
    return ptg


class SegmentedLU:
    """getrf a device-resident matrix through taskpool + scheduler + the
    CUDA device module."""

    def __init__(self, context, n: int, nb="auto", *, strip: int = 4096,
                 prec=None, tail: int = 4096, specialize: str = "generic",
                 bf16=False, pivot: str = "block",
                 fused_update: bool = False, solve_prec=None):
        nb = auto_nb(nb, n)
        self.context = context
        self.n, self.nb = n, nb
        self.store_bf16 = bf16 == "storage"
        self.pivot = pivot
        self.nt_tasks = n_segments(n, nb, tail)
        self.ptg = segmented_lu_ptg(n, nb, strip=strip, prec=prec,
                                    tail=tail, specialize=specialize,
                                    bf16=bf16, pivot=pivot,
                                    fused_update=fused_update,
                                    solve_prec=solve_prec)
        self.device = device_module(context, "segmented LU")

    def run(self, A_dev: torch.Tensor, *, timeout: Optional[float] = 600):
        """Factorize IN PLACE and return the packed L\\U tensor — or
        ``(LU, V)`` in panel-pivot mode, where row i of LU is original row
        ``V[i]`` (``A[V] = L @ U``).  In storage mode an f32 input is cast
        to a bf16 copy first."""
        if self.store_bf16 and A_dev.dtype != torch.bfloat16:
            A_dev = A_dev.to(torch.bfloat16)
        d = _attach_device_matrix(self.device, "A", A_dev)
        kwargs = {"NT": self.nt_tasks, "A": d.collection}
        datas = [d]
        if self.pivot == "panel":
            V0 = torch.arange(self.n, dtype=torch.int64, device=self.device.tdev)
            dv = _attach_device_matrix(self.device, "PV", V0)
            kwargs["PV"] = dv.collection
            datas.append(dv)
        out = run_on_device(self.context, self.device, self.ptg.taskpool(**kwargs),
                            datas, "segmented LU", timeout)
        return tuple(out) if self.pivot == "panel" else out[0]

    def __call__(self, A_np: np.ndarray):
        # a fresh device tensor: the in-place run never writes into the
        # caller's array
        A = torch.tensor(np.ascontiguousarray(A_np), device=self.device.tdev)
        out = self.run(A)
        if self.pivot == "panel":
            M, V = out[0].cpu().numpy(), out[1].cpu().numpy()
            L = np.tril(M, -1) + np.eye(self.n, dtype=M.dtype)
            return L, np.triu(M), V
        M = (out.float() if self.store_bf16 else out).cpu().numpy()
        L = np.tril(M, -1) + np.eye(self.n, dtype=M.dtype)
        return L, np.triu(M)
