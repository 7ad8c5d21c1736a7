"""Iterative 5-point stencil over a tile grid, as a PTG.

The port of :mod:`parsec_tpu.ops.stencil` (same task class, flows and
priorities).  Each iteration's tile task consumes its own previous value
plus the four neighbours' previous values (halo exchange expressed purely
as dataflow), so the runtime overlaps neighbour communication with
interior compute.

WAR safety: iteration t writes the parity-((t+1)%2) buffer while reading
the parity-(t%2) buffers. A tile's generation-t value is read only by
generation t+1 of itself and its 4 neighbours, and the next writer of the
same physical buffer is generation t+2 of the same tile — which depends on
exactly those t+1 readers, so two-generation separation makes the in-place
write race-free (the classic double-buffered stencil dataflow).

Task space: stencil(t, i, j), T iterations over an MT×NT tile grid.
The backing collection ``A`` is keyed (parity, i, j); the result after T
iterations lives at parity ``T % 2``.

Chores: ``stencil_cpu`` (numpy, in place), ``stencil_cuda`` (plain torch,
the reference's ``stencil_tpu``) and ``stencil_kernel`` (the hand-written
kernel :func:`parsec_tpu_torch.ops.kernels.stencil_5pt`, B3 — the
reference's ``stencil_pallas``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..data.collection import DataCollection
from ..data.data import Data, data_create, host_array
from ..dsl.ptg import PTG
from . import kernels
from .tiles import check_tiling

IN = AccessMode.IN
INOUT = AccessMode.INOUT


class StencilBuffers(DataCollection):
    """Double-buffered tile grid: keys are (parity, i, j); parity 0 holds
    the initial state, parity 1 is scratch.  ``rank_of(i, j)`` (optional)
    places tile (i, j) of both parities on a rank of a distributed run."""

    def __init__(self, grid: np.ndarray, mt: int, nt: int, *, nodes: int = 1,
                 myrank: int = 0, rank_of=None, name: str = "A"):
        super().__init__(name, nodes=nodes, myrank=myrank)
        self.mt, self.nt = mt, nt
        h, w = grid.shape
        check_tiling(h, mt, what="grid rows", op="stencil")
        check_tiling(w, nt, what="grid cols", op="stencil")
        self.th, self.tw = h // mt, w // nt
        self.dtype = grid.dtype
        self._rank_of = rank_of
        self._store = {}
        self._lock = threading.Lock()
        self._grid0 = grid

    def data_key(self, *key):
        if len(key) == 1:
            key = key[0]
        p, i, j = key
        return (int(p), int(i), int(j))

    def rank_of(self, *key):
        p, i, j = self.data_key(*key)
        if self._rank_of is not None:
            return self._rank_of(i, j)
        return 0

    def data_of(self, *key) -> Data:
        k = self.data_key(*key)
        with self._lock:
            d = self._store.get(k)
            if d is None:
                p, i, j = k
                if p == 0:
                    # copy (not a view): the runtime mutates tiles in place
                    # and must never alias the caller's array
                    tile = self._grid0[i * self.th:(i + 1) * self.th,
                                       j * self.tw:(j + 1) * self.tw].copy()
                else:
                    tile = np.zeros((self.th, self.tw), self.dtype)
                d = data_create(k, self, payload=tile)
                self._store[k] = d
            return d

    def to_array(self, parity: int) -> np.ndarray:
        """The grid at ``parity`` as one host array, from each tile's
        newest copy (a device copy is read through ``host_array``)."""
        out = np.zeros((self.mt * self.th, self.nt * self.tw), self.dtype)
        for i in range(self.mt):
            for j in range(self.nt):
                c = self.data_of(parity, i, j).newest_copy()
                out[i * self.th:(i + 1) * self.th, j * self.tw:(j + 1) * self.tw] = \
                    host_array(c.payload)
        return out


def _apply_5pt(xp, OLD, UP, DOWN, LEFT, RIGHT):
    """One zero-padded 5-point step of ``OLD`` with the facing edges of the
    neighbour tiles (``None`` at physical boundaries); ``xp`` is ``np`` or
    ``torch``."""
    h, w = OLD.shape
    if xp is np:
        pad = np.zeros((h + 2, w + 2), OLD.dtype)
    else:
        # new_zeros, not torch.zeros: under torch.func.vmap (a level-batched
        # replay) the padded tile is batched with OLD, so the halo writes
        # below can land in it
        pad = OLD.new_zeros((h + 2, w + 2))
    pad[1:-1, 1:-1] = OLD
    if UP is not None:
        pad[0, 1:-1] = UP[-1, :]
    if DOWN is not None:
        pad[-1, 1:-1] = DOWN[0, :]
    if LEFT is not None:
        pad[1:-1, 0] = LEFT[:, -1]
    if RIGHT is not None:
        pad[1:-1, -1] = RIGHT[:, 0]
    return 0.25 * (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:])


def stencil_cpu(OLD, UP, DOWN, LEFT, RIGHT, NEW, **_):
    NEW[:] = _apply_5pt(np, OLD, UP, DOWN, LEFT, RIGHT)


def stencil_cuda(OLD, UP, DOWN, LEFT, RIGHT, NEW, **_):
    return _apply_5pt(torch, OLD, UP, DOWN, LEFT, RIGHT)


def stencil_kernel(OLD, UP, DOWN, LEFT, RIGHT, NEW, **_):
    """Kernel chore: the 5-point step as one launch of the B3 kernel; the
    halo tiles are reduced to their facing edge row or column (the
    columns stay strided views), zeros at physical boundaries."""
    h, w = OLD.shape

    def zeros(shape):
        return torch.zeros(shape, dtype=OLD.dtype, device=OLD.device)

    up = zeros((1, w)) if UP is None else UP[-1:, :]
    down = zeros((1, w)) if DOWN is None else DOWN[:1, :]
    left = zeros((h, 1)) if LEFT is None else LEFT[:, -1:]
    right = zeros((h, 1)) if RIGHT is None else RIGHT[:, :1]
    return kernels.stencil_5pt(OLD, up, down, left, right)


def stencil_ptg(*, use_cuda: bool = True, use_kernels: bool = False,
                use_cpu: bool = True) -> PTG:
    """Build the 2D 5-point stencil PTG; instantiate with
    ``taskpool(T=iters, MT=..., NT=..., A=StencilBuffers(...))``.

    ``use_cuda`` adds the plain-torch CUDA chore; ``use_kernels`` makes the
    CUDA chore the hand-written B3 kernel (it implies the CUDA
    incarnation); ``use_cpu`` adds the numpy chore."""
    ptg = PTG("stencil2d")
    st = ptg.task_class("stencil", t="0 .. T-1", i="0 .. MT-1", j="0 .. NT-1")
    st.affinity("A(0, i, j)")
    st.priority("T - t")
    # previous generation: own tile + four halos (guarded at boundaries)
    st.flow("OLD", IN,
            "<- (t == 0) ? A(0, i, j) : NEW stencil(t-1, i, j)")
    # halo flows end in an explicit `<- NONE` fallback: boundary tiles
    # statically have no neighbour, which must be said explicitly
    st.flow("UP", IN,
            "<- (t == 0 and i > 0) ? A(0, i-1, j)",
            "<- (t > 0 and i > 0) ? NEW stencil(t-1, i-1, j)",
            "<- NONE")
    st.flow("DOWN", IN,
            "<- (t == 0 and i < MT-1) ? A(0, i+1, j)",
            "<- (t > 0 and i < MT-1) ? NEW stencil(t-1, i+1, j)",
            "<- NONE")
    st.flow("LEFT", IN,
            "<- (t == 0 and j > 0) ? A(0, i, j-1)",
            "<- (t > 0 and j > 0) ? NEW stencil(t-1, i, j-1)",
            "<- NONE")
    st.flow("RIGHT", IN,
            "<- (t == 0 and j < NT-1) ? A(0, i, j+1)",
            "<- (t > 0 and j < NT-1) ? NEW stencil(t-1, i, j+1)",
            "<- NONE")
    # the write buffer: the opposite-parity tile, WAR-safe (see module doc)
    st.flow("NEW", INOUT,
            "<- A((t+1) % 2, i, j)",
            "-> (t < T-1) ? OLD stencil(t+1, i, j)",
            "-> (t < T-1 and i > 0) ? DOWN stencil(t+1, i-1, j)",
            "-> (t < T-1 and i < MT-1) ? UP stencil(t+1, i+1, j)",
            "-> (t < T-1 and j > 0) ? RIGHT stencil(t+1, i, j-1)",
            "-> (t < T-1 and j < NT-1) ? LEFT stencil(t+1, i, j+1)",
            "-> A((t+1) % 2, i, j)")
    kw = {}
    if use_cpu:
        kw["cpu"] = stencil_cpu
    if use_cuda or use_kernels:
        kw["cuda"] = stencil_kernel if use_kernels else stencil_cuda
    if not kw:
        raise ValueError(
            "stencil_ptg: no BODY selected (use_cpu, use_cuda and "
            "use_kernels are all False)")
    st.body(**kw)
    return ptg


def reference_stencil(grid: np.ndarray, iters: int) -> np.ndarray:
    """Dense numpy model for verification."""
    g = grid.copy()
    for _ in range(iters):
        pad = np.zeros((g.shape[0] + 2, g.shape[1] + 2), g.dtype)
        pad[1:-1, 1:-1] = g
        g = 0.25 * (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:])
    return g
