"""Parallel layer of the port.

Only the numerics oracle of attention is ported so far
(:func:`attention_reference`); the SPMD programs of
:mod:`parsec_tpu.parallel` (mesh, ring attention as a ``shard_map`` loop,
the SPMD stencil, collectives) wait for ROADMAP
A.8c).
"""

from .ring_attention import attention_reference

__all__ = ["attention_reference"]
