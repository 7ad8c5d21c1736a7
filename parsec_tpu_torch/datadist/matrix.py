"""Tiled-matrix descriptors.

Reference: ``parsec/data_dist/matrix/`` — the ``parsec_tiled_matrix_t``
base descriptor (``matrix.h``: mb/nb tile sizes, lm/ln full sizes, mt/nt
tile counts, uplo storage), and the two-dimensional block-cyclic
distribution with k-cyclic super-tiling (``two_dim_rectangle_cyclic.h``:
row rank = (m / kp) % P, col rank = (n / kq) % Q) with its symmetric
variant (``sym_two_dim_rectangle_cyclic.c``).  The owner math covers any
P×Q grid, but only one rank runs: ``from_array``/``to_array`` move the
tiles this rank owns.  Multi-rank use, the tabular and band distributions
come with the distributed layer (ROADMAP A.8).

Host tiles are numpy arrays, exactly as in the JAX package, so both
packages can factor identical input (:func:`from_numpy_tiles`).  Device
copies are torch tensors owned by the CUDA device module.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from ..data.collection import DataCollection
from ..data.data import Data, data_create, host_array

LOWER = "lower"
UPPER = "upper"
FULL = "full"


class TiledMatrix(DataCollection):
    """Base tiled-matrix collection: an ``m×n`` matrix cut into ``mb×nb``
    tiles (ragged edge tiles allowed), keys are ``(i, j)`` tile indices."""

    def __init__(
        self,
        m: int,
        n: int,
        mb: int,
        nb: int,
        *,
        name: str = "A",
        dtype=np.float64,
        nodes: int = 1,
        myrank: int = 0,
        uplo: str = FULL,
        init: Optional[Callable[[int, int, Tuple[int, int]], np.ndarray]] = None,
    ):
        super().__init__(name, nodes=nodes, myrank=myrank)
        self.m, self.n, self.mb, self.nb = m, n, mb, nb
        self.mt = (m + mb - 1) // mb
        self.nt = (n + nb - 1) // nb
        self.default_dtype = np.dtype(dtype)
        self.uplo = uplo
        self._init = init
        self._store: Dict[Tuple[int, int], Data] = {}
        self._lock = threading.Lock()

    # -- geometry ---------------------------------------------------------
    def tile_shape(self, i: int, j: int) -> Tuple[int, int]:
        return (
            min(self.mb, self.m - i * self.mb),
            min(self.nb, self.n - j * self.nb),
        )

    def stored(self, i: int, j: int) -> bool:
        if not (0 <= i < self.mt and 0 <= j < self.nt):
            return False
        if self.uplo == LOWER:
            return i >= j
        if self.uplo == UPPER:
            return i <= j
        return True

    def tiles(self):
        """All stored (i, j) keys."""
        for i in range(self.mt):
            for j in range(self.nt):
                if self.stored(i, j):
                    yield (i, j)

    def local_tiles(self):
        """The stored keys this rank owns."""
        for key in self.tiles():
            if self.rank_of(*key) == self.myrank:
                yield key

    # -- vtable -----------------------------------------------------------
    def data_key(self, *key) -> Tuple[int, int]:
        if len(key) == 1:
            key = key[0]
        i, j = key
        return (int(i), int(j))

    def data_of(self, *key) -> Data:
        k = self.data_key(*key)
        if not self.stored(*k):
            raise KeyError(f"tile {k} not stored in {self.uplo} matrix {self.name}")
        with self._lock:
            d = self._store.get(k)
            if d is None:
                shape = self.tile_shape(*k)
                if self._init is not None:
                    payload = np.asarray(self._init(k[0], k[1], shape), dtype=self.default_dtype)
                else:
                    payload = np.zeros(shape, self.default_dtype)
                d = data_create(k, self, payload=payload)
                self._store[k] = d
            return d

    # -- whole-matrix helpers (tests / verification) ----------------------
    def to_array(self) -> np.ndarray:
        """Gather this rank's tiles into a dense host array; a tile whose
        newest copy lives on a device is copied back without changing
        residency."""
        out = np.zeros((self.m, self.n), self.default_dtype)
        for (i, j) in self.local_tiles():
            c = self.data_of(i, j).newest_copy()
            if c is None:
                continue
            h, w = self.tile_shape(i, j)
            out[i * self.mb : i * self.mb + h, j * self.nb : j * self.nb + w] = host_array(c.payload)[:h, :w]
        return out

    def from_array(self, a: np.ndarray) -> "TiledMatrix":
        for (i, j) in self.local_tiles():
            h, w = self.tile_shape(i, j)
            # copy (not a view): the runtime mutates tiles in place and must
            # never alias the caller's array
            tile = a[i * self.mb : i * self.mb + h, j * self.nb : j * self.nb + w].astype(
                self.default_dtype, copy=True)
            d = self.data_of(i, j)
            copy = d.get_copy(0) or d.attach_copy(0, tile)
            copy.payload = tile
        return self


class TwoDimBlockCyclic(TiledMatrix):
    """ScaLAPACK-style 2D block-cyclic placement over a P×Q process grid
    with kp/kq k-cyclic super-tiling (reference
    ``two_dim_rectangle_cyclic.h:24-95``)."""

    def __init__(self, m, n, mb, nb, *, p: int = 1, q: int = 1, kp: int = 1,
                 kq: int = 1, **kw):
        kw.setdefault("nodes", p * q)
        super().__init__(m, n, mb, nb, **kw)
        if p * q != self.nodes:
            raise ValueError(f"grid {p}x{q} incompatible with {self.nodes} nodes")
        self.p, self.q, self.kp, self.kq = p, q, kp, kq

    def rank_of(self, *key) -> int:
        i, j = self.data_key(*key)
        rrow = (i // self.kp) % self.p
        rcol = (j // self.kq) % self.q
        return rrow * self.q + rcol

    def vpid_of(self, *key) -> int:
        return 0


class SymTwoDimBlockCyclic(TwoDimBlockCyclic):
    """Symmetric (triangular-storage) block-cyclic matrix (reference
    ``sym_two_dim_rectangle_cyclic.c``)."""

    def __init__(self, m, n, mb, nb, *, uplo: str = LOWER, **kw):
        if uplo not in (LOWER, UPPER):
            raise ValueError("sym matrix needs uplo lower|upper")
        super().__init__(m, n, mb, nb, uplo=uplo, **kw)


def from_numpy_tiles(tiles: Mapping[Tuple[int, int], np.ndarray], mb: int,
                     nb: int, *, m: Optional[int] = None,
                     n: Optional[int] = None, name: str = "A",
                     dtype=None, uplo: str = FULL) -> TiledMatrix:
    """Build the port's :class:`TiledMatrix` from numpy tile payloads —
    the state carried over from the JAX package's ``TiledMatrix`` (whose
    host tiles are numpy arrays too), so both packages factor identical
    input.  Every tile is copied: the runtime mutates host tiles in place.

    ``m``/``n`` default to the extent the tile keys span (full tiles but
    the ragged last row/column, whose size the payloads give); ``dtype``
    defaults to the tiles' own."""
    if not tiles:
        raise ValueError("from_numpy_tiles: no tiles given")
    keys = sorted(tiles)
    mt = max(i for i, _ in keys) + 1
    nt = max(j for _, j in keys) + 1
    if m is None:
        m = (mt - 1) * mb + next(np.shape(tiles[k])[0] for k in keys if k[0] == mt - 1)
    if n is None:
        n = (nt - 1) * nb + next(np.shape(tiles[k])[1] for k in keys if k[1] == nt - 1)
    if dtype is None:
        dtype = np.asarray(tiles[keys[0]]).dtype
    A = TiledMatrix(m, n, mb, nb, name=name, dtype=dtype, uplo=uplo)
    for (i, j) in keys:
        src = np.asarray(tiles[(i, j)])
        if src.shape != A.tile_shape(i, j):
            raise ValueError(f"from_numpy_tiles: tile {(i, j)} has shape "
                             f"{src.shape}, expected {A.tile_shape(i, j)}")
        tile = src.astype(A.default_dtype, copy=True)
        d = A.data_of(i, j)
        d.get_copy(0).payload = tile
    return A
