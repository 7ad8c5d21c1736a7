"""Tile bodies for the generated array task classes.

The port of :mod:`parsec_tpu.array.kernels`.  The linear-algebra kernels
are the EXISTING :mod:`parsec_tpu_torch.ops.tiles` bodies
(potrf/trsm/syrk/gemm_update for Cholesky, gemm for matmul,
trsv_fwd/gemm_sub for the triangular solve) — the array layer generates
graphs, it does not grow a second kernel library.  What lives here are
the small glue bodies the expression ops need (elementwise combine,
transpose, copy/forward, partial reductions), each in the standard two
incarnations: ``*_cpu`` numpy, the reference's arithmetic (mutates the
INOUT tile in place — what the native pump's host chores require) and
``*_cuda`` functional torch (returns a fresh, row-major contiguous
tensor).  The device bodies are library calls, as the reference's are XLA
calls: no hand-written kernel runs on the array's path.

Every body is MODULE-LEVEL so the program cache's content fingerprint
(bytecode + closure values) is stable across processes — a generated
array program keys into the same cached entries on every run.
"""

from __future__ import annotations

import numpy as np
import torch


# -- matmul ------------------------------------------------------------------
# The k-chain init: C(i,j) = A(i,0) @ B(0,j) overwriting the chain tile
# (never read at k==0) — accumulation steps reuse tiles.gemm_*.

def mm_init_cpu(a, b, c, **_):
    c[:] = np.asarray(a) @ np.asarray(b)


def mm_init_cuda(a, b, c, **_):
    return a @ b


# -- elementwise -------------------------------------------------------------

def add_cpu(A, B, O, **_):
    O[:] = A + B


def add_cuda(A, B, O, **_):
    return A + B


def sub_cpu(A, B, O, **_):
    O[:] = A - B


def sub_cuda(A, B, O, **_):
    return A - B


def mul_cpu(A, B, O, **_):
    O[:] = A * B


def mul_cuda(A, B, O, **_):
    return A * B


def scale_cpu(A, O, alpha=1.0, **_):
    O[:] = A * np.asarray(A).dtype.type(alpha)


def scale_cuda(A, O, alpha=1.0, **_):
    # alpha rounded to the tile's dtype first, as the reference's
    # jnp.asarray(alpha, A.dtype): a Python float would multiply at the
    # op's wider compute precision
    return A * torch.tensor(alpha, dtype=torch.float64).to(A.dtype).item()


# -- transpose ---------------------------------------------------------------

def transpose_cpu(A, O, **_):
    O[:] = np.asarray(A).T


def transpose_cuda(A, O, **_):
    return A.mT.contiguous()


# -- copy / redistribute -----------------------------------------------------
# copy_* backs both the explicit same-tiling redistribute node and the
# implicit private-copy classes in front of in-place consumers
# (Cholesky mutates its working tiles; a source collection or a
# multiply-consumed producer tile must never be that working set).

def copy_cpu(A, O, **_):
    O[:] = A


def copy_cuda(A, O, **_):
    # a fresh buffer: the output never aliases the source's device copy
    return A.clone()


# -- forwarding reader (no-op body; the flow data itself is the product) ----

def forward_cpu(X, **_):
    pass


# -- partial reductions (terminal sum/norm; f64 accumulators) ---------------

def psum_cpu(A, S, **_):
    S[:] = np.asarray(A, np.float64).sum()


def psumsq_cpu(A, S, **_):
    a = np.asarray(A, np.float64)
    S[:] = (a * a).sum()
