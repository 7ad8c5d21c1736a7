"""Data distributions: the tiled matrix and its block-cyclic placements."""

from .matrix import (FULL, LOWER, UPPER, SymTwoDimBlockCyclic, TiledMatrix,
                     TwoDimBlockCyclic, from_numpy_tiles)

__all__ = ["FULL", "LOWER", "UPPER", "SymTwoDimBlockCyclic", "TiledMatrix",
           "TwoDimBlockCyclic", "from_numpy_tiles"]
