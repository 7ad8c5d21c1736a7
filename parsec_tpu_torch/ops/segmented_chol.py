"""Panel-segmented Cholesky THROUGH the task runtime.

The port of :mod:`parsec_tpu.ops.segmented_chol`.  :class:`.panel_chol.
WholeCholesky` runs every panel step on one matrix but bypasses the
framework; this module puts the same steps inside it:

* the PTG has ONE task class, ``panel(k)`` — a whole right-looking panel
  step (potrf + trsm-as-gemm + strip-mined trailing update);
* the whole matrix threads through the chain as a single INOUT flow, so
  the taskpool's dependency machinery, the scheduler and the CUDA device
  module (stage-in, epilog rebinding, eager completion) run every step;
* the body updates the matrix IN PLACE through views and returns it: the
  device copy is the same tensor from the first step to the last (one
  matrix plus one step's R x strip temporaries on the card).  Such a body
  is marked ``_donate_args`` — the device module never runs it twice for
  one task (an out-of-memory error inside it raises), and it joins no
  wave and no fused region.

Per step k (panel offset k0 = k*nb, trailing rows R = n-k0-nb):

    L  = chol(A[k0:k0+nb, k0:k0+nb]);  W = inv(L)     # nb x nb, library
    P  = A[k0+nb:, k0:k0+nb] @ W.T                    # panel trsm as gemm
    A[k0+nb:, c0:c0+w] -= P @ P[c0-rows].T            # strip-mined update

``specialize``: eager torch has no program to specialise, so both bodies
run the same arithmetic; ``"static"`` slices each step's exact trailing
block, ``"generic"`` walks the reference's parameter-generic chunk grid
(:func:`_chunked`: nb-granular chunks up to the next strip boundary, full
strips, then the nb-granular partial tail) with Python ints.

``bf16``: False = storage precision; True = bf16 operands with f32
accumulation; ``"storage"`` = the matrix lives in bf16 (panel math in
f32).  The products are library calls; float32 runs in full FP32 (the
device module turns TF32 off).

``nb="auto"`` resolves through :func:`auto_nb`: the reference's rule for
an empty tuning store (the port has no tuner yet, ROADMAP A.5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..data.collection import DataCollection
from ..data.data import Data, data_create
from ..dsl.ptg import PTG
from .panel_chol import chol_inv, mm_acc32, sub_product
from .tiles import check_tiling

INOUT = AccessMode.INOUT


def auto_nb(nb, n: int, *, default: int = 512):
    """The panel width for ``nb="auto"``: ``default`` halved until it
    divides ``n`` — what the reference's ``tuning.auto_nb`` returns with an
    empty tuning store.  The store lookup (the autotuner's persisted
    winner for the op, N, dtype and device) lands with ROADMAP A.5.  An
    explicit ``nb`` passes through."""
    if nb != "auto":
        return nb
    d = default
    while d > 1 and n % d:
        d //= 2
    return d


class _DeviceMatrix(DataCollection):
    """A one-element collection whose only Data has its one copy on a
    device: no host placeholder is allocated (for a bfloat16 matrix numpy
    could not hold one)."""

    def __init__(self, name: str, data_index: int, arr: torch.Tensor):
        super().__init__(name)
        self.default_dtype = arr.dtype
        self._data = data_create(0, self, payload=arr, device_index=data_index)

    def data_of(self, *key) -> Data:
        return self._data


def _attach_device_matrix(device, name: str, arr: torch.Tensor) -> Data:
    """A Data whose current copy is the device-resident ``arr`` — the
    shared setup of every segmented-factorization driver."""
    if arr.device != device.tdev:
        raise ValueError(f"{name}: matrix on {arr.device}, device module on "
                         f"{device.tdev}")
    return _DeviceMatrix(name, device.data_index, arr).data_of(0)


def device_module(context, what: str):
    """The context's CUDA device module, or raise."""
    dev = next((d for d in context.devices if d.mca_name == "cuda"), None)
    if dev is None:
        raise RuntimeError(f"{what} needs the cuda device module")
    return dev


def run_on_device(context, device, tp, datas, what: str, timeout):
    """Run ``tp`` and hand the device payloads of ``datas`` to the caller,
    releasing their residency slots without a write-back (else each run's
    results stay dirty-resident until memory pressure or detach writes
    them home)."""
    context.add_taskpool(tp)
    if not tp.wait(timeout=timeout):
        raise RuntimeError(f"{what} did not quiesce: {tp.fail_reason}")
    out = []
    for d in datas:
        c = d.get_copy(device.data_index)
        if c is None or c.payload is None:
            raise RuntimeError(f"{what} left no device result")
        out.append(c.payload)
        device.drop_residency(d)
    return out


def _make_panel_body(n: int, nb: int, bf16, strip: int, kt: int):
    """Whole-matrix panel-step device body with each step's exact trailing
    block.  ``kt`` is the fused-tail boundary: task ``kt`` runs ALL
    remaining panels (the tail panels are too small to be tasks of their
    own — the reference's recursive-task coarsening)."""
    store_bf16 = bf16 == "storage"

    def step(M, k):
        k0 = k * nb
        D = M[k0:k0 + nb, k0:k0 + nb]
        L, W = chol_inv(D.float() if store_bf16 else D)
        M[k0:k0 + nb, k0:k0 + nb] = L.tril().to(M.dtype)
        if n - k0 - nb == 0:
            return
        P = M[k0 + nb:, k0:k0 + nb]
        if store_bf16:
            # panel solve in f32, the factor stored back in bf16
            Pl = (P.float() @ W.mT).to(torch.bfloat16)
            M[k0 + nb:, k0:k0 + nb] = Pl
        elif bf16:
            Pn = mm_acc32(P.to(torch.bfloat16), W.mT.to(torch.bfloat16))
            M[k0 + nb:, k0:k0 + nb] = Pn
            Pl = Pn.to(torch.bfloat16)
        else:
            Pl = P @ W.mT
            M[k0 + nb:, k0:k0 + nb] = Pl
        # strip-mined symmetric update: R x strip temporaries
        for c0 in range(k0 + nb, n, strip):
            w = min(strip, n - c0)
            Pj = Pl[c0 - (k0 + nb):c0 - (k0 + nb) + w]
            sub_product(M[k0 + nb:, c0:c0 + w], Pl, Pj.mT)

    def panel(M, k, **_):
        for kk in range(k, n // nb if k >= kt else k + 1):
            step(M, kk)  # task kt runs the fused tail [kt, NT)
        return M

    panel._donate_args = (0,)  # the matrix updates in place on the card
    return panel


def _chunked(k: int, n: int, nb: int, strip: int, apply, carry):
    """The chunk walk of the trailing range ``[(k+1)*nb, n)`` in three
    exact phases — nb-granular up to the next strip boundary, full strips,
    then the nb-granular partial tail when ``strip`` does not divide
    ``n``.  ``apply(offset, size, carry) -> carry`` runs per chunk (size
    nb or strip); shared by the generic segmented chol/LU/QR bodies.
    Requires ``n % nb == 0`` and ``strip % nb == 0`` (the builders
    validate)."""
    nt = n // nb
    spb = strip // nb
    ns = n // strip          # full strips in [0, n)
    ts = ns * spb            # partial-tail start, in nb units
    b1 = (k * nb + nb + strip - 1) // strip  # first full-strip chunk
    e1 = min(b1 * spb, nt)                   # end of the leading nb phase
    for j in range(k + 1, e1):
        carry = apply(j * nb, nb, carry)
    for s in range(b1, ns):
        carry = apply(s * strip, strip, carry)
    # partial tail [ns*strip, n): past both the leading nb phase and the
    # full strips — empty when the panel sits in the tail or strip | n
    for j in range(max(e1, ts), nt):
        carry = apply(j * nb, nb, carry)
    return carry


def _make_panel_body_generic(n: int, nb: int, bf16, strip: int, kt: int):
    """The reference's parameter-generic panel body: the panel solve runs
    at FULL height n (the junk it computes for rows above the panel lands
    in the strictly-upper triangle, which no step reads), the diagonal
    block is rewritten after the full-column store, and the trailing
    update walks the exact chunk grid (rows x columns, both by
    :func:`_chunked`), so the lower triangle matches the static body's
    arithmetic operation for operation."""
    store_bf16 = bf16 == "storage"
    nt = n // nb

    def step(k, M):
        k0 = k * nb
        D = M[k0:k0 + nb, k0:k0 + nb]
        L, W = chol_inv(D.float() if store_bf16 else D)
        C = M[:, k0:k0 + nb]  # full-height column
        if store_bf16:
            Pl = (C.float() @ W.mT).to(torch.bfloat16)
            M[:, k0:k0 + nb] = Pl
        elif bf16:
            Pn = mm_acc32(C.to(torch.bfloat16), W.mT.to(torch.bfloat16))
            M[:, k0:k0 + nb] = Pn.to(M.dtype)
            Pl = Pn.to(torch.bfloat16)
        else:
            Pl = C @ W.mT
            M[:, k0:k0 + nb] = Pl
        M[k0:k0 + nb, k0:k0 + nb] = L.tril().to(M.dtype)

        def upd(r0, h, c0, w):
            sub_product(M[r0:r0 + h, c0:c0 + w], Pl[r0:r0 + h], Pl[c0:c0 + w].mT)

        def cols(c0, w, carry):
            return _chunked(k, n, nb, strip,
                            lambda r0, h, c: upd(r0, h, c0, w), carry)

        _chunked(k, n, nb, strip, cols, None)

    def panel(M, k, **_):
        # task k runs steps [k, k+1) — the fused-tail task kt runs [kt, nt)
        for kk in range(k, nt if (kt < nt and k >= kt) else k + 1):
            step(kk, M)
        return M

    panel._donate_args = (0,)  # the matrix updates in place on the card
    return panel


def segmented_cholesky_ptg(n: int, nb: int, *, bf16=False,
                           strip: int = 4096, tail: int = 4096,
                           specialize: str = "static") -> PTG:
    """Build the panel-segmented dpotrf PTG.  Instantiate with
    ``.taskpool(NT=n_segments(n, nb, tail), A=collection)`` where ``A(0)``
    holds the full n x n SPD matrix; the factorization happens in place
    (lower).  ``tail`` fuses the final panels (trailing size <= tail) into
    the last task; 0 disables fusing."""
    check_tiling(n, nb, op="segmented cholesky")
    strip = min(strip, n)
    check_tiling(strip, nb, what="strip", op="segmented cholesky")
    if specialize not in ("static", "generic"):
        raise ValueError(f"unknown specialize mode {specialize!r}")
    kt = n_segments(n, nb, tail) - 1  # the one source of the tail boundary
    ptg = PTG("dpotrf_seg")
    panel = ptg.task_class("panel", k="0 .. NT-1")
    panel.affinity("A(0)")
    panel.priority("NT - k")  # panel order IS the critical path
    panel.flow("M", INOUT,
               "<- (k == 0) ? A(0) : M panel(k-1)",
               "-> (k == NT-1) ? A(0) : M panel(k+1)")
    make = (_make_panel_body_generic if specialize == "generic"
            else _make_panel_body)
    panel.body(cuda=make(n, nb, bf16, strip, kt))
    return ptg


def n_segments(n: int, nb: int, tail: int = 4096) -> int:
    """Task count of the segmented PTG: panels before the fused-tail
    boundary, plus the one tail task."""
    nt = n // nb
    kt = max(0, nt - max(1, tail // nb)) if tail else nt - 1
    return kt + 1


class SegmentedCholesky:
    """Run the segmented PTG through a live Context's CUDA device module.

    Builds a fresh taskpool per ``run`` (attach, enumeration and dispatch
    are part of what a run costs); the matrix stays on the card across
    the steps: its device copy is the same tensor throughout."""

    def __init__(self, context, n: int, nb="auto", *, bf16=False,
                 strip: int = 4096, tail: int = 4096,
                 specialize: str = "static"):
        nb = auto_nb(nb, n)
        self.context = context
        self.n, self.nb = n, nb
        self.store_bf16 = bf16 == "storage"
        self.nt_tasks = n_segments(n, nb, tail)
        self.ptg = segmented_cholesky_ptg(n, nb, bf16=bf16, strip=strip,
                                          tail=tail, specialize=specialize)
        self.device = device_module(context, "segmented cholesky")

    def run(self, A_dev: torch.Tensor, *, timeout: Optional[float] = 600) -> torch.Tensor:
        """Factorize a device-resident (n, n) tensor IN PLACE through the
        runtime and return it (the lower triangle is L).  In storage mode
        an f32 input is cast to a bf16 copy first."""
        if self.store_bf16 and A_dev.dtype != torch.bfloat16:
            A_dev = A_dev.to(torch.bfloat16)
        d = _attach_device_matrix(self.device, "A", A_dev)
        tp = self.ptg.taskpool(NT=self.nt_tasks, A=d.collection)
        return run_on_device(self.context, self.device, tp, [d],
                             "segmented dpotrf", timeout)[0]

    def __call__(self, A_np: np.ndarray) -> np.ndarray:
        # a fresh device tensor: the in-place run never writes into the
        # caller's array (``torch.from_numpy`` would alias it on the CPU)
        A = torch.tensor(np.ascontiguousarray(A_np), device=self.device.tdev)
        return np.tril(self.run(A).float().cpu().numpy())
