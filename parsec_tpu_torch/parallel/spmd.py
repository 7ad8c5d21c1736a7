"""SPMD execution of distributed dense kernels over a device mesh.

The port of :mod:`parsec_tpu.parallel.spmd`: one program a mesh position
(:func:`~.shard_map.shard_map`), its communication explicit
``ppermute``/``all_gather``/``psum``, mirroring the reference runtime's
neighbour sends and broadcast trees.

* ``spmd_cholesky`` — blocked right-looking dpotrf on a (p, q)-sharded
  matrix.  The reference lets GSPMD partition one whole-matrix program;
  torch has no GSPMD, so here each position runs the same steps on its
  own block with explicit gathers (ROADMAP C): the ``n x nb`` column strip
  is gathered to every position, which factors the diagonal block and
  solves the panel, then applies the masked trailing update to its block
  and writes the panel back where its columns meet it.
* ``summa_gemm`` — C = A @ B with all_gather of row/col panels (SUMMA).
* ``ring_gemm`` — C = A @ B over a 1D ring with ppermute-rotated B blocks:
  the sequence-parallel/ring-attention communication pattern.

The factorizations and products are library calls (``torch.linalg``,
``torch.matmul``), as they are XLA calls in the reference; float32
products follow torch's TF32 setting (``torch.backends.cuda.matmul.
allow_tf32``, off by default).
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh
from .shard_map import P, all_gather, as_tensor, axis_index, ppermute, psum, shard_map


# ---------------------------------------------------------------------------
# blocked Cholesky
# ---------------------------------------------------------------------------

def _panel(strip: torch.Tensor, i0: int, nb: int):
    """The factored diagonal block ``L`` and the solved panel, its rows
    outside ``i0 + nb ..`` masked to zero, from the ``n x nb`` strip."""
    L = torch.linalg.cholesky(strip[i0:i0 + nb])
    Pfull = torch.linalg.solve_triangular(L, strip.mT, upper=False).mT
    rows = torch.arange(strip.shape[0], device=strip.device)[:, None]
    Pmask = torch.where(rows >= i0 + nb, Pfull, torch.zeros((), dtype=Pfull.dtype,
                                                            device=Pfull.device))
    return L, Pmask


def _chol_step(A: torch.Tensor, k: int, nb: int) -> torch.Tensor:
    """One right-looking step on the whole matrix (the unsharded program,
    the reference's ``_chol_step``)."""
    i0 = k * nb
    L, Pmask = _panel(A[:, i0:i0 + nb], i0, nb)
    # trailing update touches exactly the (below, below) submatrix
    A = A - Pmask @ Pmask.mT
    # the factor panel: L on the diagonal block, the solve below, zeros
    # above (the strictly-upper region is junk for a lower factorization)
    panel = Pmask.clone()
    panel[i0:i0 + nb] += L
    A[:, i0:i0 + nb] = panel
    return A


def spmd_cholesky(A, nb: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Factorize SPD ``A`` (n×n, n % nb == 0) in f32/f64; returns the full
    matrix whose lower triangle is L.  With ``mesh``, A is block-sharded
    over (p, q) and each position factors with its own block."""
    A = as_tensor(A)
    n = A.shape[0]
    if n % nb:
        raise ValueError(f"n={n} must be a multiple of nb={nb}")
    nt = n // nb
    if mesh is None:
        out = A.clone()
        for k in range(nt):
            out = _chol_step(out, k, nb)
        return out
    pax, qax = mesh.axis_names
    p, q = mesh.shape[pax], mesh.shape[qax]
    if n % p or n % q:
        raise ValueError(f"n={n} does not split over the {p}x{q} mesh")
    mb, nq = n // p, n // q

    def kernel(a):
        r0, c0 = axis_index(pax) * mb, axis_index(qax) * nq
        for k in range(nt):
            i0 = k * nb
            # the strip's columns this position holds, [lo, hi)
            lo, hi = max(i0, c0), min(i0 + nb, c0 + nq)
            piece = torch.zeros((mb, nb), dtype=a.dtype, device=a.device)
            if lo < hi:
                piece[:, lo - i0:hi - i0] = a[:, lo - c0:hi - c0]
            # rows gathered down the column, then the owners' columns summed
            # across the row (every other contribution is zero: exact)
            strip = psum(all_gather(piece, pax, axis=0), qax)
            L, Pmask = _panel(strip, i0, nb)
            a = a - Pmask[r0:r0 + mb] @ Pmask[c0:c0 + nq].mT
            if lo < hi:
                panel = Pmask[r0:r0 + mb, lo - i0:hi - i0].clone()
                top, bot = max(i0, r0), min(i0 + nb, r0 + mb)
                if top < bot:
                    panel[top - r0:bot - r0] += L[top - i0:bot - i0, lo - i0:hi - i0]
                a[:, lo - c0:hi - c0] = panel
        return a

    spec = P(pax, qax)
    return shard_map(kernel, mesh, (spec,), spec)(A)


# ---------------------------------------------------------------------------
# SUMMA GEMM
# ---------------------------------------------------------------------------

def summa_gemm(A, B, mesh: Mesh) -> torch.Tensor:
    """C = A @ B with A, B, C block-sharded over (p, q): each position
    all_gathers its row panel of A along q and its column panel of B along
    p, then multiplies locally — textbook SUMMA."""
    pax, qax = mesh.axis_names

    def kernel(a_blk, b_blk):
        a_row = all_gather(a_blk, qax, axis=1)   # my row of A
        b_col = all_gather(b_blk, pax, axis=0)   # my col of B
        return a_row @ b_col

    spec = P(pax, qax)
    return shard_map(kernel, mesh, (spec, spec), spec)(as_tensor(A), as_tensor(B))


# ---------------------------------------------------------------------------
# ring GEMM (1D ring, ppermute rotation — the ring-attention pattern)
# ---------------------------------------------------------------------------

def ring_gemm(A, B, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """C = A @ B over a 1D ring: A row-sharded, B row-sharded (on its
    contraction dim).  Each of the R steps multiplies the resident B block
    against the matching column slice of the local A rows, then rotates the
    B block one hop (the last step's rotation, whose result nothing reads,
    is left out)."""
    A, B = as_tensor(A), as_tensor(B)
    axis = axis or mesh.axis_names[0]
    R = mesh.shape[axis]
    n_k = A.shape[1]
    if n_k % R:
        raise ValueError(f"contraction dimension {n_k} does not split over {R} positions")
    kb = n_k // R
    perm = [(i, (i - 1) % R) for i in range(R)]

    def kernel(a_blk, b_blk):
        idx = axis_index(axis)
        c = torch.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=A.dtype, device=a_blk.device)
        b = b_blk
        for s in range(R):
            # the resident b block is contraction slice (idx + s) mod R
            src = (idx + s) % R
            c = c + a_blk[:, src * kb:(src + 1) * kb] @ b
            if s < R - 1:
                b = ppermute(b, axis, perm)
        return c

    spec = P(axis, None)
    return shard_map(kernel, mesh, (spec, spec), spec)(A, B)
