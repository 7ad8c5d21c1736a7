"""Multi-position SPMD layer: meshes, collectives, partitioned kernels.

The port of :mod:`parsec_tpu.parallel`.  A mesh is one process driving
its positions, a thread a position, each on its own device (a device may
repeat: four positions on one card); collectives meet at an in-process
exchange (:mod:`.shard_map`).  See ``spmd.py`` for the mapping onto the
reference runtime's multi-rank execution.
"""

from .mesh import best_grid, block_sharding, make_mesh, replicated
from . import collectives
from .ring_attention import attention_reference, ring_attention, ulysses_attention
from .spmd import ring_gemm, spmd_cholesky, summa_gemm
from .stencil_spmd import spmd_stencil_5pt

__all__ = [
    "best_grid",
    "make_mesh",
    "block_sharding",
    "replicated",
    "collectives",
    "spmd_cholesky",
    "summa_gemm",
    "ring_gemm",
    "spmd_stencil_5pt",
    "ring_attention",
    "ulysses_attention",
    "attention_reference",
]
