"""Distribution descriptors for :class:`parsec_tpu_torch.array.DistArray`.

The port of :mod:`parsec_tpu.array.dist`, with the same names.

A descriptor is the user-facing, collection-independent statement of WHERE
tiles live — the analogue of picking a ``parsec_matrix_block_cyclic_t``
vs a replicated descriptor in the reference's data-collections layer
(PAPER.md L6).  ``build()`` turns it into a concrete
:class:`~parsec_tpu_torch.datadist.matrix.TiledMatrix` for one rank;
``partials()`` builds the aligned (1, 1)-tiled scalar grid reductions
land in; ``same_placement()`` is the alignment predicate the lowerer
uses to decide whether a consumer may read a collection tile directly
(owner-local memory reference) or must route it through a forwarding
reader task.  A p x q grid is built and lowered at one process — ranks
are only arithmetic there — but running it waits for the distributed
layer (ROADMAP A.8).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..datadist.matrix import TiledMatrix, TwoDimBlockCyclic, as_tile


class ReplicatedTiled(TiledMatrix):
    """Every rank holds the FULL tile set; rank 0 is the canonical owner
    (affinity / write-backs).  Memory-reference *reads* resolve against
    the local store, so replicated inputs never need forwarding tasks —
    the classic use is a small right-hand side or scale factor every
    rank already has."""

    replicated = True

    def rank_of(self, *key) -> int:
        return 0

    def local_tiles(self):
        # every tile is locally readable — fills and to_array() walk all
        yield from self.tiles()

    def from_array(self, a: np.ndarray) -> "ReplicatedTiled":
        for (i, j) in self.tiles():
            h, w = self.tile_shape(i, j)
            tile = as_tile(a[i * self.mb:i * self.mb + h,
                              j * self.nb:j * self.nb + w], self.default_dtype)
            d = self.data_of(i, j)
            copy = d.get_copy(0) or d.attach_copy(0, tile)
            copy.payload = tile
        return self


class Distribution:
    """Base descriptor.  Subclasses define ``nodes``, ``build`` and a
    ``placement_key`` (two descriptors with equal keys place equal tile
    indices on equal ranks)."""

    nodes: int = 1

    def build(self, m: int, n: int, mb: int, nb: int, *, dtype, name: str,
              myrank: int = 0) -> TiledMatrix:
        raise NotImplementedError

    def partials(self, mt: int, nt: int, *, name: str,
                 myrank: int = 0) -> TiledMatrix:
        """The aligned (mt x nt) scalar grid for reductions: partial of
        tile (i, j) must land on tile (i, j)'s owner."""
        raise NotImplementedError

    def transposed(self) -> "Distribution":
        return self

    def placement_key(self) -> Tuple:
        raise NotImplementedError

    def same_placement(self, other: "Distribution") -> bool:
        return self.placement_key() == other.placement_key()

    @property
    def replicated(self) -> bool:
        return False


class BlockCyclic(Distribution):
    """ScaLAPACK-style 2D block-cyclic over a ``p x q`` rank grid with
    optional ``kp``/``kq`` super-tiling (``datadist.matrix``).  ``q=1``
    is the 1-D row-cyclic layout (:func:`Block1D`)."""

    def __init__(self, p: int = 1, q: int = 1, *, kp: int = 1, kq: int = 1):
        if p < 1 or q < 1 or kp < 1 or kq < 1:
            raise ValueError(f"bad block-cyclic grid p={p} q={q} "
                             f"kp={kp} kq={kq}")
        self.p, self.q, self.kp, self.kq = p, q, kp, kq
        self.nodes = p * q

    def build(self, m, n, mb, nb, *, dtype, name, myrank=0):
        return TwoDimBlockCyclic(m, n, mb, nb, p=self.p, q=self.q,
                                 kp=self.kp, kq=self.kq, myrank=myrank,
                                 name=name, dtype=dtype)

    def partials(self, mt, nt, *, name, myrank=0):
        # 1x1 tiles: tile index == element index, so the block-cyclic
        # formula places partial (i, j) exactly where tile (i, j) lives
        return TwoDimBlockCyclic(mt, nt, 1, 1, p=self.p, q=self.q,
                                 kp=self.kp, kq=self.kq, myrank=myrank,
                                 name=name, dtype=np.float64)

    def transposed(self) -> "BlockCyclic":
        return BlockCyclic(self.q, self.p, kp=self.kq, kq=self.kp)

    def placement_key(self):
        return ("2dbc", self.p, self.q, self.kp, self.kq)

    def __repr__(self):
        return (f"BlockCyclic(p={self.p}, q={self.q}, "
                f"kp={self.kp}, kq={self.kq})")


def Block1D(p: int, *, kp: int = 1) -> BlockCyclic:
    """1-D row-cyclic distribution over ``p`` ranks (tile row ``i`` on
    rank ``(i // kp) % p``) — a ``p x 1`` block-cyclic grid."""
    return BlockCyclic(p, 1, kp=kp)


class Replicated(Distribution):
    """Full copy on every rank; rank 0 owns writes.  Input-oriented:
    reads are always local, but anything MATERIALIZED into a replicated
    array lands only on rank 0 (the canonical owner) on multi-rank
    meshes."""

    nodes = 1

    def build(self, m, n, mb, nb, *, dtype, name, myrank=0):
        return ReplicatedTiled(m, n, mb, nb, myrank=myrank, name=name,
                               dtype=dtype)

    def partials(self, mt, nt, *, name, myrank=0):
        return ReplicatedTiled(mt, nt, 1, 1, myrank=myrank, name=name,
                               dtype=np.float64)

    def placement_key(self):
        return ("replicated",)

    @property
    def replicated(self) -> bool:
        return True

    def __repr__(self):
        return "Replicated()"
