"""Lazy distributed-array expressions.

The port of :mod:`parsec_tpu.array.expr`.  A :class:`DistArray` is a
handle on a node of an expression DAG — the HDArray-style front end:
operations (``@``, ``+``, ``cholesky``, ``solve``, ``transpose``,
``redistribute`` …) append nodes instead of executing, and
:meth:`DistArray.compute` (or ``parsec_tpu_torch.array.lower(...).run(ctx)``)
lowers the whole reachable graph into **one** PTG taskpool whose cross-op
edges are ordinary flow dependencies — no materialize-and-reload between
ops (see :mod:`parsec_tpu_torch.array.lower`).

Ownership/versioning is the runtime's: leaves are tiled collections
(:mod:`parsec_tpu_torch.datadist.matrix`), intermediates exist only as flow
data, and a computed array becomes a leaf backed by its result
collection — later expressions read it like any input.

dtypes: a node's dtype is a numpy dtype, or ``torch.bfloat16`` — numpy has
no bfloat16 of its own, and the JAX package's ``ml_dtypes`` is not
installed beside the port.  ``from_numpy``/``zeros`` take
``dtype=torch.bfloat16``, the string ``"bfloat16"`` or ``ml_dtypes``'
bfloat16 where that package exists; the host tiles are then bfloat16
torch CPU tensors, and ``to_numpy`` returns float32, which holds every
bfloat16 value exactly.  bfloat16 programs run on the device bodies.

What waits for the distributed layer (ROADMAP A.8) raises
``NotImplementedError`` before any runtime work: a geometry-changing
``redistribute`` (``datadist.redistribute``) and the cross-rank allreduce
of ``sum``/``norm`` on a multi-rank grid.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..datadist.matrix import tile_dtype
from ..ops.tiles import check_tiling
from .dist import BlockCyclic, Distribution

__all__ = ["DistArray", "Node", "from_numpy", "zeros"]


class Node:
    """One expression-DAG node.  ``kind`` is the op; ``inputs`` are the
    producer nodes; ``coll`` is the backing collection for leaves and
    for computed (materialized) nodes — None while purely lazy."""

    __slots__ = ("kind", "inputs", "shape", "mb", "nb", "dtype", "dist",
                 "myrank", "coll", "alpha", "reduce_op", "uplo")

    def __init__(self, kind: str, inputs: Sequence["Node"], shape, mb, nb,
                 dtype, dist: Distribution, myrank: int, *, coll=None,
                 alpha: Optional[float] = None, reduce_op: str = "",
                 uplo: str = "full"):
        self.kind = kind
        self.inputs = list(inputs)
        self.shape = tuple(int(s) for s in shape)
        self.mb, self.nb = int(mb), int(nb)
        self.dtype = tile_dtype(dtype)
        self.dist = dist
        self.myrank = int(myrank)
        self.coll = coll
        self.alpha = alpha
        self.reduce_op = reduce_op
        #: structural zero pattern of the VALUE ("full" | "lower"):
        #: a cholesky result is lower-triangular — unwritten upper tiles
        #: of its collection read as zeros, which IS the value
        self.uplo = uplo

    # -- geometry ---------------------------------------------------------
    @property
    def mt(self) -> int:
        return (self.shape[0] + self.mb - 1) // self.mb

    @property
    def nt(self) -> int:
        return (self.shape[1] + self.nb - 1) // self.nb

    @property
    def is_source(self) -> bool:
        """Readable straight from a collection (leaf or already computed)."""
        return self.coll is not None

    def __repr__(self):
        return (f"Node({self.kind}, shape={self.shape}, "
                f"tiles=({self.mb},{self.nb}), dist={self.dist!r})")


def _promote(a, b):
    """The result dtype of combining ``a`` and ``b`` (``np.promote_types``,
    with the JAX lattice's place for bfloat16: bfloat16 with itself or an
    integer stays bfloat16; with float16 or wider floats it becomes the
    narrowest float holding both)."""
    if a is not torch.bfloat16 and b is not torch.bfloat16:
        return np.promote_types(a, b)
    other = b if a is torch.bfloat16 else a
    if other is torch.bfloat16 or other.kind in "biu":
        return torch.bfloat16
    return np.promote_types(np.float32, other)


def _binop_check(a: "DistArray", b: "DistArray", what: str) -> None:
    if a.shape != b.shape:
        raise ValueError(f"{what}: shapes {a.shape} vs {b.shape} differ")
    if (a.mb, a.nb) != (b.mb, b.nb):
        raise ValueError(
            f"{what}: tilings {(a.mb, a.nb)} vs {(b.mb, b.nb)} differ "
            "(redistribute one side first)")
    if a._node.myrank != b._node.myrank:
        raise ValueError(f"{what}: operands built for different ranks")


class DistArray:
    """A tiled array with a distribution and a lazy expression graph.

    Build leaves with :func:`from_numpy` / :func:`zeros`; combine with
    the operators below; run with :meth:`compute` — every pending op in
    the reachable graph lowers into ONE taskpool (:mod:`.lower`)."""

    def __init__(self, node: Node):
        self._node = node

    # -- introspection ----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self._node.shape

    @property
    def dtype(self):
        return self._node.dtype

    @property
    def mb(self) -> int:
        return self._node.mb

    @property
    def nb(self) -> int:
        return self._node.nb

    @property
    def dist(self) -> Distribution:
        return self._node.dist

    @property
    def computed(self) -> bool:
        return self._node.is_source

    def __repr__(self):
        state = "computed" if self.computed else f"lazy:{self._node.kind}"
        return (f"DistArray(shape={self.shape}, tiles=({self.mb},{self.nb}),"
                f" dtype={self.dtype}, dist={self.dist!r}, {state})")

    # -- elementwise ------------------------------------------------------
    def _ew(self, other: "DistArray", op: str) -> "DistArray":
        _binop_check(self, other, op)
        n = self._node
        return DistArray(Node(op, [n, other._node], n.shape, n.mb, n.nb,
                              _promote(n.dtype, other._node.dtype),
                              n.dist, n.myrank))

    def __add__(self, other):
        if np.isscalar(other):
            raise TypeError("scalar + array: use scale()/shift via numpy "
                            "before from_numpy, or an explicit op")
        return self._ew(other, "add")

    def __sub__(self, other):
        if np.isscalar(other):
            raise TypeError("array - scalar: use scale()/shift via numpy "
                            "before from_numpy, or an explicit op")
        return self._ew(other, "sub")

    def __mul__(self, other):
        if np.isscalar(other):
            return self.scale(float(other))
        return self._ew(other, "mul")

    def __rmul__(self, other):
        if np.isscalar(other):
            return self.scale(float(other))
        return NotImplemented

    def scale(self, alpha: float) -> "DistArray":
        n = self._node
        return DistArray(Node("scale", [n], n.shape, n.mb, n.nb, n.dtype,
                              n.dist, n.myrank, alpha=float(alpha)))

    # -- structure --------------------------------------------------------
    def transpose(self) -> "DistArray":
        n = self._node
        return DistArray(Node("transpose", [n], (n.shape[1], n.shape[0]),
                              n.nb, n.mb, n.dtype, n.dist.transposed(),
                              n.myrank))

    @property
    def T(self) -> "DistArray":
        return self.transpose()

    # -- linear algebra ---------------------------------------------------
    def __matmul__(self, other: "DistArray") -> "DistArray":
        return self.matmul(other)

    def matmul(self, other: "DistArray") -> "DistArray":
        a, b = self._node, other._node
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"matmul: inner dims {a.shape} @ {b.shape}")
        if a.nb != b.mb or a.nt != b.mt:
            raise ValueError(
                f"matmul: inner tilings differ (a.nb={a.nb} over "
                f"{a.nt} tiles vs b.mb={b.mb} over {b.mt})")
        if a.myrank != b.myrank:
            raise ValueError("matmul: operands built for different ranks")
        return DistArray(Node("matmul", [a, b], (a.shape[0], b.shape[1]),
                              a.mb, b.nb,
                              _promote(a.dtype, b.dtype),
                              a.dist, a.myrank))

    def cholesky(self) -> "DistArray":
        n = self._node
        if n.shape[0] != n.shape[1] or n.mb != n.nb:
            raise ValueError(
                f"cholesky needs a square matrix with square tiles, got "
                f"shape {n.shape} tiles ({n.mb}, {n.nb})")
        return DistArray(Node("cholesky", [n], n.shape, n.mb, n.nb,
                              n.dtype, n.dist, n.myrank, uplo="lower"))

    def solve(self, b: "DistArray") -> "DistArray":
        """``x = self^{-1} b`` with ``self`` LOWER-triangular (e.g. a
        :meth:`cholesky` factor) — blocked forward substitution."""
        L, bn = self._node, b._node
        if L.shape[0] != L.shape[1] or L.mb != L.nb:
            raise ValueError("solve: L must be square with square tiles")
        if bn.shape[0] != L.shape[0] or bn.mb != L.mb:
            raise ValueError(
                f"solve: rhs rows/tiling {bn.shape[0]}/{bn.mb} do not "
                f"match L {L.shape[0]}/{L.mb}")
        if L.myrank != bn.myrank:
            raise ValueError("solve: operands built for different ranks")
        return DistArray(Node("solve", [L, bn], bn.shape, bn.mb, bn.nb,
                              _promote(L.dtype, bn.dtype),
                              bn.dist, bn.myrank))

    # -- layout -----------------------------------------------------------
    def redistribute(self, dist: Distribution, *, context=None,
                     algo: Optional[str] = None,
                     mem_budget: Optional[int] = None,
                     mb: Optional[int] = None,
                     nb: Optional[int] = None) -> "DistArray":
        """Move this array to another distribution.

        Same tile geometry: a LAZY copy node — placement changes become
        ordinary cross-rank flow edges inside the fused taskpool.
        Different tile geometry (``mb``/``nb`` given and differing) goes
        through ``datadist.redistribute``, which comes with the
        distributed layer: it raises ``NotImplementedError`` (ROADMAP
        A.8) before any runtime work."""
        n = self._node
        new_mb = int(mb) if mb is not None else n.mb
        new_nb = int(nb) if nb is not None else n.nb
        check_tiling(n.shape[0], new_mb, what="M", op="redistribute",
                     allow_ragged=True)
        check_tiling(n.shape[1], new_nb, what="N", op="redistribute",
                     allow_ragged=True)
        if (new_mb, new_nb) == (n.mb, n.nb):
            if algo is not None or mem_budget is not None:
                raise ValueError(
                    "redistribute: algo=/mem_budget= apply to the eager "
                    "datadist path only — a same-geometry redistribution "
                    "is a lazy in-graph copy (pass mb=/nb= to force the "
                    "datadist path)")
            return DistArray(Node("redist", [n], n.shape, n.mb, n.nb,
                                  n.dtype, dist, n.myrank, uplo=n.uplo))
        raise NotImplementedError(
            f"redistribute from ({n.mb}, {n.nb}) tiles to ({new_mb}, {new_nb}) "
            "runs through datadist.redistribute, which is not ported yet "
            "(ROADMAP A.8)")

    # -- reductions (terminal: they run the graph) ------------------------
    def sum(self, context, *, timeout: Optional[float] = 600,
            use_cpu: bool = True, use_cuda: bool = True) -> float:
        """Global element sum — per-tile partials inside the fused
        taskpool (host f64 accumulators: a device tile is staged home
        first), then the fold on the host.  The cross-rank combine of a
        multi-rank grid waits for the collectives (ROADMAP A.8)."""
        return self._reduce(context, "sum", timeout=timeout,
                            use_cpu=use_cpu, use_cuda=use_cuda)

    def norm(self, context, *, timeout: Optional[float] = 600,
             use_cpu: bool = True, use_cuda: bool = True) -> float:
        """Frobenius norm (sqrt of the summed squares)."""
        return math.sqrt(self._reduce(context, "sumsq", timeout=timeout,
                                      use_cpu=use_cpu, use_cuda=use_cuda))

    def _reduce(self, context, op: str, *, timeout, use_cpu, use_cuda):
        from .lower import lower

        n = self._node
        if not n.dist.replicated and n.dist.nodes > 1:
            raise NotImplementedError(
                f"array {op} over a {n.dist.nodes}-rank grid needs the "
                "cross-rank allreduce, which is not ported yet (ROADMAP A.8)")
        red = Node("reduce", [n], (n.mt, n.nt), 1, 1, np.float64, n.dist,
                   n.myrank, reduce_op=op)
        prog = lower([red], name=f"array_{op}", use_cpu=use_cpu,
                     use_cuda=use_cuda)
        prog.run(context, timeout=timeout)
        P = red.coll
        local = 0.0
        for key in P.tiles():
            if P.rank_of(*key) != P.myrank and not getattr(
                    P, "replicated", False):
                continue
            c = P.data_of(*key).newest_copy()
            if c is not None and c.payload is not None:
                local += float(np.asarray(c.payload).ravel()[0])
        return local

    # -- execution --------------------------------------------------------
    def compute(self, context, *, others: Sequence["DistArray"] = (),
                timeout: Optional[float] = 600, use_cpu: bool = True,
                use_cuda: bool = True,
                native: bool = False) -> "DistArray":
        """Materialize this array (and ``others``) — the whole reachable
        expression graph lowers into ONE taskpool, runs to quiescence,
        and the requested arrays become collection-backed leaves.
        ``native=True`` executes on the native engine
        (``tp.run_native``) instead of a live context."""
        pending = [a for a in (self, *others) if not a.computed]
        if not pending:
            return self
        from .lower import lower

        prog = lower([a._node for a in pending], use_cpu=use_cpu,
                     use_cuda=use_cuda)
        if native:
            prog.run_native()
        else:
            prog.run(context, timeout=timeout)
        return self

    def to_numpy(self) -> np.ndarray:
        """Assemble the LOCAL tiles into a dense array (zeros where a
        tile lives on another rank; float32 for a bfloat16 array).
        Single-rank and replicated arrays assemble fully; call
        :meth:`compute` first if lazy."""
        n = self._node
        if not n.is_source:
            raise RuntimeError(
                "DistArray is lazy — compute(context) it first")
        return n.coll.to_array()


# ---------------------------------------------------------------------------
# leaf constructors
# ---------------------------------------------------------------------------

def from_numpy(a: np.ndarray, mb: int, nb: Optional[int] = None, *,
               dist: Optional[Distribution] = None, myrank: int = 0,
               dtype=None, name: Optional[str] = None) -> DistArray:
    """Cut a dense array into an ``mb x nb``-tiled :class:`DistArray`
    (ragged tails allowed).  Every rank calls this with the same global
    array (SPMD); only locally-owned tiles are stored — except under
    :class:`~parsec_tpu_torch.array.dist.Replicated`, which stores all.
    ``dtype`` may name bfloat16 (see the module docstring)."""
    a = np.asarray(a)
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    if a.ndim != 2:
        raise ValueError(f"from_numpy needs a 1-D/2-D array, got {a.ndim}-D")
    nb = mb if nb is None else nb
    check_tiling(a.shape[0], mb, what="M", op="from_numpy",
                 allow_ragged=True)
    check_tiling(a.shape[1], nb, what="N", op="from_numpy",
                 allow_ragged=True)
    dist = dist or BlockCyclic(1, 1)
    dtype = tile_dtype(a.dtype if dtype is None else dtype)
    global _leaf_seq
    with _leaf_lock:
        _leaf_seq += 1
        seq = _leaf_seq
    coll = dist.build(a.shape[0], a.shape[1], mb, nb, dtype=dtype,
                      name=name or f"arr_leaf{seq}", myrank=myrank)
    coll.from_array(a)
    return DistArray(Node("leaf", [], a.shape, mb, nb, dtype, dist,
                          myrank, coll=coll))


def zeros(shape, mb: int, nb: Optional[int] = None, *,
          dist: Optional[Distribution] = None, myrank: int = 0,
          dtype=np.float64, name: Optional[str] = None) -> DistArray:
    """An all-zero leaf.  No dense array is ever built: the collection's
    tiles materialize lazily as zeros on first touch (the TiledMatrix
    default-init contract), so a huge zero operand costs nothing up
    front."""
    m, n = (shape if isinstance(shape, (tuple, list)) else (shape, shape))
    m, n = int(m), int(n)
    nb = mb if nb is None else nb
    check_tiling(m, mb, what="M", op="zeros", allow_ragged=True)
    check_tiling(n, nb, what="N", op="zeros", allow_ragged=True)
    dist = dist or BlockCyclic(1, 1)
    global _leaf_seq
    with _leaf_lock:
        _leaf_seq += 1
        seq = _leaf_seq
    coll = dist.build(m, n, mb, nb, dtype=tile_dtype(dtype),
                      name=name or f"arr_leaf{seq}", myrank=myrank)
    return DistArray(Node("leaf", [], (m, n), mb, nb, tile_dtype(dtype),
                          dist, myrank, coll=coll))


_leaf_seq = 0
_leaf_lock = threading.Lock()
