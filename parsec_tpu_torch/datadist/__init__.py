"""Data distributions: the single-rank tiled matrix."""

from .matrix import FULL, LOWER, UPPER, TiledMatrix, from_numpy_tiles

__all__ = ["FULL", "LOWER", "UPPER", "TiledMatrix", "from_numpy_tiles"]
