"""Generic tiled-matrix operations as taskpools.

The port of :mod:`parsec_tpu.datadist.ops`.  Reference:
``parsec/data_dist/matrix/`` ships JDF taskpools for elementwise
application (``apply.jdf`` + ``apply_wrapper.c``), reductions
(``reduce.jdf``, ``reduce_col.jdf``, ``reduce_row.jdf`` +
``reduce_wrapper.c``) and a generic unary-operator taskpool
(``map_operator.c``).  Same capabilities here, as DTD taskpools of host
bodies: a tile whose newest version lives on the CUDA module is staged to
the host before its body runs.  Across ranks (one context a rank over a
fabric), ``apply``/``map``/``reduce_taskpool`` visit the rank's own tiles
and ``reduce_rows``/``reduce_cols`` fold remote tiles in through the DTD
shadow-task protocol; a collection spread over a different number of
ranks than the context's is refused.

Each operation inserts one module-level body per kind, with the user's
operator and the tile index as values, so its tasks share one task class.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..dsl.dtd import AFFINITY, DTDTaskpool, IN, INOUT
from .matrix import TiledMatrix


def _check_context_ranks(context, A: TiledMatrix, what: str) -> None:
    """A collection distributed over N ranks needs a context with exactly
    N ranks: otherwise remote-owned tiles would be lazily materialized as
    zeros and silently folded in (or the owner rank would not exist and
    the taskpool would never quiesce)."""
    nr = getattr(context, "nranks", 1)
    if A.nodes not in (1, nr):
        raise ValueError(
            f"{what}: {A.name} is distributed over {A.nodes} ranks but the "
            f"context has {nr}; run one context per rank over a fabric")


def _local(A: TiledMatrix):
    """The stored tiles this rank owns."""
    return [k for k in A.tiles() if A.rank_of(*k) == A.myrank]


def _apply_body(t, op, i, j):
    return op(t, i, j)


def _map_body(a, b, op, i, j):
    return op(a, b, i, j)


def apply_taskpool(context, A: TiledMatrix,
                   op: Callable[[np.ndarray, int, int], Any], *,
                   uplo: Optional[str] = None) -> DTDTaskpool:
    """Apply ``op(tile, i, j)`` to every stored tile (reference
    ``parsec_apply`` / apply.jdf).  ``op`` may mutate in place or return a
    replacement tile.  Returns the taskpool (wait on it).  ``uplo`` is
    accepted and ignored, as the reference does: every stored tile is
    visited."""
    _check_context_ranks(context, A, "apply_taskpool")
    tp = DTDTaskpool(context, name=f"apply_{A.name}")
    for (i, j) in _local(A):
        tp.insert_task(_apply_body, (A.data_of(i, j), INOUT), op, i, j,
                       name="apply")
    return tp


def map_operator(context, A: TiledMatrix, B: TiledMatrix,
                 op: Callable[[np.ndarray, np.ndarray, int, int], Any]) -> DTDTaskpool:
    """Binary tile map ``B[i,j] = op(A[i,j], B[i,j])`` (reference
    ``map_operator.c``'s generic operator taskpool)."""
    if (A.mt, A.nt) != (B.mt, B.nt):
        raise ValueError("map_operator needs matching tile grids")
    _check_context_ranks(context, A, "map_operator")
    _check_context_ranks(context, B, "map_operator")
    tp = DTDTaskpool(context, name=f"map_{A.name}_{B.name}")
    for (i, j) in _local(A):
        tp.insert_task(_map_body, (A.data_of(i, j), IN), (B.data_of(i, j), INOUT),
                       op, i, j, name="map")
    return tp


def _leaf_body(t, tile_reduce, key, values, lock):
    v = tile_reduce(t)
    with lock:
        values[key] = v


def reduce_taskpool(context, A: TiledMatrix,
                    tile_reduce: Callable[[np.ndarray], Any],
                    combine: Callable[[Any, Any], Any]) -> DTDTaskpool:
    """Full reduction over the rank's tiles: one leaf task a tile, then the
    leaves combined pairwise in tile order on the host (reference
    reduce.jdf).  The result is ``tp.result``; the call waits."""
    _check_context_ranks(context, A, "reduce_taskpool")
    tp = DTDTaskpool(context, name=f"reduce_{A.name}")
    keys = _local(A)
    lock = threading.Lock()
    values: Dict[Any, Any] = {}
    for k in keys:
        tp.insert_task(_leaf_body, (A.data_of(*k), IN), tile_reduce, k,
                       values, lock, name="reduce_leaf")
    tp.wait()
    acc = None
    for k in keys:
        acc = values[k] if acc is None else combine(acc, values[k])
    tp.result = acc
    return tp


def _fold_body(*args):
    # (tile, tile, ..., combine_tiles, out, index, lock): the tiles first
    *tiles, combine_tiles, out, index, lock = args
    acc = tiles[0].copy()
    for t in tiles[1:]:
        acc = np.asarray(combine_tiles(acc, t))
    with lock:
        out[index] = acc


def _fold(context, A: TiledMatrix, lines: List[List[tuple]], name: str,
          combine_tiles) -> list:
    tp = DTDTaskpool(context, name=f"{name}_{A.name}")
    out: list = [None] * len(lines)
    lock = threading.Lock()
    for index, keys in enumerate(lines):
        if not keys:  # triangular storage: a row or column may hold none
            continue
        args = [(A.data_of(*k), IN) for k in keys]
        args[0] = (args[0][0], IN | AFFINITY)  # fold on the first tile's owner
        tp.insert_task(_fold_body, *args, combine_tiles, out, index, lock,
                       name=name)
    tp.wait()
    return out


def reduce_rows(context, A: TiledMatrix,
                combine_tiles: Callable[[np.ndarray, np.ndarray], Any]) -> list:
    """Row-wise tile reduction: fold each tile row to one tile (reference
    reduce_row.jdf).  Returns the per-row results (None for a row that
    stores no tile).

    Multi-rank: every rank inserts the identical stream; each row's fold
    executes on the owner of the row's first stored tile (AFFINITY), with
    remote tiles shipped by the DTD shadow-task protocol — so on each
    rank the returned list holds results only for the rows it folded
    (owner-computes), None elsewhere."""
    _check_context_ranks(context, A, "reduce_rows")
    return _fold(context, A, [[(i, j) for j in range(A.nt) if A.stored(i, j)]
                              for i in range(A.mt)], "reduce_row", combine_tiles)


def reduce_cols(context, A: TiledMatrix,
                combine_tiles: Callable[[np.ndarray, np.ndarray], Any]) -> list:
    """Column-wise tile reduction (reference reduce_col.jdf).  Multi-rank
    contract as in :func:`reduce_rows` (owner of the column's first
    stored tile folds it)."""
    _check_context_ranks(context, A, "reduce_cols")
    return _fold(context, A, [[(i, j) for i in range(A.mt) if A.stored(i, j)]
                              for j in range(A.nt)], "reduce_col", combine_tiles)
