"""Band-storage conversion: the ``diag_band_to_rect`` analog.

The port of :mod:`parsec_tpu.datadist.band`.  Reference:
``parsec/data_dist/matrix/diag_band_to_rect.jdf`` — gathers the diagonal
and subdiagonal tiles of a symmetric block-cyclic matrix into a compact
rectangular band-storage matrix (the input layout of bulge-chasing
band-reduction solvers): output tile ``B(0, k)`` is ``(MB+1, NB+2)`` with
column ``j`` holding the diagonal-aligned entries ``D[j:MB, j]`` on top
and the subdiagonal spill ``SD[0:j+1, j]`` below; the trailing two
columns and the optional padding tile ``B(0, NT)`` are zero.

The same three task classes as the reference JDF: ``read_diag(k)`` and
``read_subdiag(k)`` forward tiles from A's distribution (pure readers),
and ``convert_diag(k)`` packs on B's owner.  The bodies are host bodies:
a tile whose newest version lives on the CUDA module (a factor the card
just wrote) is staged to the host before ``convert_diag`` reads it.
"""

from __future__ import annotations

import numpy as np

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG

IN = AccessMode.IN
INOUT = AccessMode.INOUT


def diag_band_to_rect_ptg(MB: int, NB: int) -> PTG:
    """Build the conversion PTG.  Instantiate with
    ``.taskpool(NT=..., A=sym_matrix, B=band_matrix)`` where ``B`` has
    one tile row of ``(MB+1, NB+2)`` tiles — ``NT`` of them, or (with
    ``PAD=1``) ``NT+1`` including a zeroed padding tile (the reference
    discovers the same choice from descB->super.n)."""
    ptg = PTG("diag_band_to_rect")

    rd = ptg.task_class("read_diag", k="0 .. NT-1")
    rd.affinity("A(k, k)")
    rd.flow("A", IN, "<- A(k, k)", "-> D convert_diag(k)")
    rd.body(cpu=lambda A, k: None)

    rs = ptg.task_class("read_subdiag", k="0 .. NT-2")
    rs.affinity("A(k+1, k)")
    rs.flow("A", IN, "<- A(k+1, k)", "-> SD convert_diag(k)")
    rs.body(cpu=lambda A, k: None)

    cv = ptg.task_class("convert_diag", k="0 .. NT - 1 + PAD")
    cv.affinity("B(0, k)")
    cv.flow("D", IN, "<- (k < NT) ? A read_diag(k)")
    cv.flow("SD", IN, "<- (k < NT - 1) ? A read_subdiag(k)")
    cv.flow("B", INOUT, "<- B(0, k)", "-> B(0, k)")

    def convert(B, D, SD, k, NT):
        B[:] = 0.0
        if k == NT:
            return  # the padding tile stays zero
        for j in range(NB):
            B[0:MB - j, j] = D[j:MB, j]
            if SD is not None:  # k < NT-1: subdiagonal spill below
                B[MB - j:MB + 1, j] = SD[0:j + 1, j]

    ptg.constants.setdefault("PAD", 0)
    cv.use_globals("NT")
    cv.body(cpu=convert)
    return ptg


def diag_band_to_rect_reference(A: np.ndarray, MB: int, NB: int,
                                NT: int, pad: bool = False) -> np.ndarray:
    """Pure-numpy oracle of the packing, for tests."""
    cols = (NT + 1) if pad else NT
    out = np.zeros((MB + 1, cols * (NB + 2)), A.dtype)
    for k in range(NT):
        D = A[k * MB:(k + 1) * MB, k * NB:(k + 1) * NB]
        for j in range(NB):
            out[0:MB - j, k * (NB + 2) + j] = D[j:MB, j]
            if k < NT - 1:
                SD = A[(k + 1) * MB:(k + 2) * MB, k * NB:(k + 1) * NB]
                out[MB - j:MB + 1, k * (NB + 2) + j] = SD[0:j + 1, j]
    return out
