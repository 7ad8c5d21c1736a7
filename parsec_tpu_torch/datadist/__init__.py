"""Data distributions: the tiled matrix, its block-cyclic, band, vector
and tabular placements, the tiled-matrix operations (:mod:`.ops`) and the
band-storage conversion (:mod:`.band`)."""

from .matrix import (FULL, LOWER, UPPER, SymTwoDimBlockCyclic,
                     SymTwoDimBlockCyclicBand, TiledMatrix, TwoDimBlockCyclic,
                     TwoDimBlockCyclicBand, TwoDimTabular, VectorTwoDimCyclic,
                     from_numpy_tiles)
from .ops import (apply_taskpool, map_operator, reduce_cols, reduce_rows,
                  reduce_taskpool)

__all__ = ["FULL", "LOWER", "UPPER", "SymTwoDimBlockCyclic",
           "SymTwoDimBlockCyclicBand", "TiledMatrix", "TwoDimBlockCyclic",
           "TwoDimBlockCyclicBand", "TwoDimTabular", "VectorTwoDimCyclic",
           "apply_taskpool", "from_numpy_tiles",
           "map_operator", "reduce_cols", "reduce_rows", "reduce_taskpool"]
