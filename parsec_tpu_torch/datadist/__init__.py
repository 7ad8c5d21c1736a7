"""Data distributions: the tiled matrix, its block-cyclic and band
placements, the tiled-matrix operations (:mod:`.ops`) and the band-storage
conversion (:mod:`.band`)."""

from .matrix import (FULL, LOWER, UPPER, SymTwoDimBlockCyclic,
                     SymTwoDimBlockCyclicBand, TiledMatrix, TwoDimBlockCyclic,
                     TwoDimBlockCyclicBand, from_numpy_tiles)
from .ops import (apply_taskpool, map_operator, reduce_cols, reduce_rows,
                  reduce_taskpool)

__all__ = ["FULL", "LOWER", "UPPER", "SymTwoDimBlockCyclic",
           "SymTwoDimBlockCyclicBand", "TiledMatrix", "TwoDimBlockCyclic",
           "TwoDimBlockCyclicBand", "apply_taskpool", "from_numpy_tiles",
           "map_operator", "reduce_cols", "reduce_rows", "reduce_taskpool"]
