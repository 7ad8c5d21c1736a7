"""Tiled-matrix descriptors.

Reference: ``parsec/data_dist/matrix/`` — the ``parsec_tiled_matrix_t``
base descriptor (``matrix.h``: mb/nb tile sizes, lm/ln full sizes, mt/nt
tile counts, uplo storage), and the two-dimensional block-cyclic
distribution with k-cyclic super-tiling (``two_dim_rectangle_cyclic.h``:
row rank = (m / kp) % P, col rank = (n / kq) % Q) with its symmetric
variant (``sym_two_dim_rectangle_cyclic.c``), and the band composites
that route a band around the diagonal to a sub-distribution of its own
(``{sym_,}two_dim_rectangle_cyclic_band.{c,h}``).  The owner math covers
any P×Q grid; ``from_array``/``to_array`` move the tiles this rank owns,
and each rank of a multi-rank context holds its own
(``myrank``).  The distributed vector (``vector_two_dim_cyclic``) and the
rank-table placement (``two_dim_tabular``) complete the set.

Host tiles are numpy arrays, exactly as in the JAX package, so both
packages can factor identical input (:func:`from_numpy_tiles`).  Device
copies are torch tensors owned by the CUDA device module.  numpy has no
bfloat16 (the JAX package borrows ``ml_dtypes``'): a matrix of dtype
``torch.bfloat16`` (or any dtype named ``"bfloat16"``) keeps its host tiles
as bfloat16 torch CPU tensors, the form :func:`..data.data.host_array`
gives them, and ``to_array`` widens them to float32, which holds every
bfloat16 value exactly.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.collection import DataCollection
from ..data.data import Data, data_create, host_array

LOWER = "lower"
UPPER = "upper"
FULL = "full"


def is_bfloat16(dtype) -> bool:
    """True for ``torch.bfloat16`` and for any dtype named ``bfloat16``
    (``"bfloat16"``, ``ml_dtypes``' numpy dtype)."""
    if dtype is torch.bfloat16:
        return True
    name = getattr(dtype, "name", dtype)
    return isinstance(name, str) and name == "bfloat16"


def tile_dtype(dtype):
    """A tile dtype: ``torch.bfloat16`` for a bfloat16, else a numpy dtype."""
    return torch.bfloat16 if is_bfloat16(dtype) else np.dtype(dtype)


def _zeros(shape, dtype):
    if dtype is torch.bfloat16:
        return torch.zeros(shape, dtype=torch.bfloat16)
    return np.zeros(shape, dtype)


def as_tile(block: np.ndarray, dtype):
    """A private host tile of ``dtype`` holding ``block``'s values."""
    if dtype is torch.bfloat16:
        # a bfloat16 source (ml_dtypes') widens to float32 exactly first:
        # torch reads no numpy bfloat16
        wide = np.float32 if is_bfloat16(block.dtype) else None
        return torch.from_numpy(np.array(block, dtype=wide, copy=True)).to(torch.bfloat16)
    return block.astype(dtype, copy=True)


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
        self.default_dtype = tile_dtype(dtype)
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
                    payload = self._init(k[0], k[1], shape)
                    payload = (as_tile(np.asarray(payload), torch.bfloat16)
                               if self.default_dtype is torch.bfloat16
                               else np.asarray(payload, dtype=self.default_dtype))
                else:
                    # zero on first touch: a lazily-zero matrix costs
                    # nothing until a tile is read
                    payload = _zeros(shape, self.default_dtype)
                d = data_create(k, self, payload=payload)
                self._store[k] = d
            return d

    def materialized_keys(self):
        """Tile keys whose Data exists right now (no lazy creation)."""
        with self._lock:
            return list(self._store)

    # -- whole-matrix helpers (tests / verification) ----------------------
    def to_array(self) -> np.ndarray:
        """Gather this rank's tiles into a dense host array; a tile whose
        newest copy lives on a device is copied back without changing
        residency."""
        bf16 = self.default_dtype is torch.bfloat16
        out = np.zeros((self.m, self.n), np.float32 if bf16 else self.default_dtype)
        for (i, j) in self.local_tiles():
            c = self.data_of(i, j).newest_copy()
            if c is None:
                continue
            h, w = self.tile_shape(i, j)
            tile = host_array(c.payload)
            if isinstance(tile, torch.Tensor):
                tile = tile.float().numpy()
            out[i * self.mb : i * self.mb + h, j * self.nb : j * self.nb + w] = tile[:h, :w]
        return out

    def from_array(self, a: np.ndarray) -> "TiledMatrix":
        for (i, j) in self.local_tiles():
            h, w = self.tile_shape(i, j)
            # copy (not a view): the runtime mutates tiles in place and must
            # never alias the caller's array
            tile = as_tile(a[i * self.mb : i * self.mb + h, j * self.nb : j * self.nb + w],
                            self.default_dtype)
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


class VectorTwoDimCyclic(TiledMatrix):
    """Distributed vector: ``m`` elements in ``mb``-sized segments, placed
    cyclically over the process grid (reference
    ``vector_two_dim_cyclic.{c,h}``).  Keys are single segment indices
    ``(i,)``; placement follows the row dimension of a P×Q grid so a vector
    aligns with the rows of a matching :class:`TwoDimBlockCyclic` matrix."""

    def __init__(self, m, mb, *, p: int = 1, q: int = 1, kp: int = 1, **kw):
        kw.setdefault("nodes", p * q)
        super().__init__(m, 1, mb, 1, **kw)
        if p * q != self.nodes:
            raise ValueError(f"grid {p}x{q} incompatible with {self.nodes} nodes")
        self.p, self.q, self.kp = p, q, kp

    def data_key(self, *key) -> Tuple[int, int]:
        if len(key) == 1 and not isinstance(key[0], tuple):
            return (int(key[0]), 0)
        return super().data_key(*key)

    def tile_shape(self, i: int, j: int = 0) -> Tuple[int, int]:
        return (min(self.mb, self.m - i * self.mb), 1)

    def rank_of(self, *key) -> int:
        i, _ = self.data_key(*key)
        return ((i // self.kp) % self.p) * self.q

    def vpid_of(self, *key) -> int:
        return 0


class TwoDimTabular(TiledMatrix):
    """Arbitrary rank table (reference ``two_dim_tabular.c``): placement
    comes from a user table or callable over tile keys."""

    def __init__(self, m, n, mb, nb, *, rank_table, **kw):
        super().__init__(m, n, mb, nb, **kw)
        self._rank_table = rank_table

    def rank_of(self, *key) -> int:
        k = self.data_key(*key)
        if callable(self._rank_table):
            return int(self._rank_table(*k))
        return int(self._rank_table[k])


class TwoDimBlockCyclicBand(TiledMatrix):
    """Composite band distribution (reference
    ``two_dim_rectangle_cyclic_band.{c,h}``): tiles within
    ``|i - j| < band_size`` of the diagonal delegate to the ``band``
    sub-distribution at the remapped row ``i - j + band_size - 1`` (the
    band is stored as a (2*band_size-1, NT) rectangle); every other tile
    delegates to ``off_band``.  Storage lives in the sub-collections —
    this wrapper only routes."""

    def __init__(self, band: TiledMatrix, off_band: TiledMatrix,
                 band_size: int):
        super().__init__(off_band.m, off_band.n, off_band.mb, off_band.nb,
                         name=f"{off_band.name}_band",
                         nodes=off_band.nodes, myrank=off_band.myrank,
                         dtype=off_band.default_dtype)
        if band_size < 1:
            raise ValueError("band_size must be >= 1")
        self.band, self.off_band, self.band_size = band, off_band, band_size

    def _band_row(self, i: int, j: int) -> int:
        return i - j + self.band_size - 1

    def _in_band(self, i: int, j: int) -> bool:
        return abs(i - j) < self.band_size

    def rank_of(self, *key) -> int:
        i, j = self.data_key(*key)
        if self._in_band(i, j):
            return self.band.rank_of(self._band_row(i, j), j)
        return self.off_band.rank_of(i, j)

    def vpid_of(self, *key) -> int:
        i, j = self.data_key(*key)
        if self._in_band(i, j):
            return self.band.vpid_of(self._band_row(i, j), j)
        return self.off_band.vpid_of(i, j)

    def data_of(self, *key) -> Data:
        i, j = self.data_key(*key)
        if self._in_band(i, j):
            return self.band.data_of(self._band_row(i, j), j)
        return self.off_band.data_of(i, j)


class SymTwoDimBlockCyclicBand(TiledMatrix):
    """Symmetric band composite (reference
    ``sym_two_dim_rectangle_cyclic_band.{c,h}``): band tiles remap to row
    ``|i - j|`` of the ``band`` sub-distribution (the band stored as a
    (band_size, NT) rectangle); off-band tiles delegate to the symmetric
    ``off_band`` distribution."""

    def __init__(self, band: TiledMatrix, off_band: TiledMatrix,
                 band_size: int):
        super().__init__(off_band.m, off_band.n, off_band.mb, off_band.nb,
                         name=f"{off_band.name}_symband",
                         nodes=off_band.nodes, myrank=off_band.myrank,
                         dtype=off_band.default_dtype)
        if band_size < 1:
            raise ValueError("band_size must be >= 1")
        self.band, self.off_band, self.band_size = band, off_band, band_size

    def rank_of(self, *key) -> int:
        i, j = self.data_key(*key)
        if abs(i - j) < self.band_size:
            return self.band.rank_of(abs(i - j), j)
        return self.off_band.rank_of(i, j)

    def vpid_of(self, *key) -> int:
        i, j = self.data_key(*key)
        if abs(i - j) < self.band_size:
            return self.band.vpid_of(abs(i - j), j)
        return self.off_band.vpid_of(i, j)

    def data_of(self, *key) -> Data:
        i, j = self.data_key(*key)
        if abs(i - j) < self.band_size:
            return self.band.data_of(abs(i - j), j)
        return self.off_band.data_of(i, j)


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
