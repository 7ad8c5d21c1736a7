"""parsec_tpu_torch.array — the HDArray-style tiled-array front end.

The port of :mod:`parsec_tpu.array`, with the same names, at one rank.
Tiled arrays with a distribution (2-D block-cyclic / 1-D / replicated —
:mod:`.dist`) and a LAZY expression layer (:mod:`.expr`): ``matmul``,
``cholesky``, triangular ``solve``, elementwise ``add/sub/mul/scale``,
``transpose``, ``sum``/``norm`` and the same-geometry ``redistribute``.
``DistArray.compute(ctx)`` (or ``lower([...]).run(ctx)``) compiles the
whole expression graph into ONE lint-clean taskpool — cross-op edges are
flow dependencies, no materialize-and-reload between ops (:mod:`.lower`).
The taskpool runs on the dynamic path, through the native pump
(``ArrayProgram.run_native``), as a serving-plane job, or under a
``GraphExecutor``; its device bodies are torch library calls on the GPU.

    import numpy as np
    from parsec_tpu_torch import Context
    from parsec_tpu_torch import array as pa

    A = pa.from_numpy(G, 32)          # 32x32 tiles
    B = pa.from_numpy(H, 32)
    b = pa.from_numpy(rhs, 32, 1)
    C = (A @ A.T + B).cholesky()      # nothing runs yet
    x = C.solve(b)
    with Context() as ctx:
        x.compute(ctx, others=[C])    # ONE taskpool for the whole chain
    print(x.to_numpy())

A multi-rank grid runs SPMD: every rank builds the same program over its
own ``myrank`` and computes it on its rank of a multi-rank context; its
``sum``/``norm`` allreduce across ranks, and a geometry-changing
``redistribute`` runs through ``datadist.redistribute``.  Its
``run_native`` raises ``ValueError``: the native engine executes
single-rank programs.
"""

from .dist import Block1D, BlockCyclic, Distribution, Replicated
from .expr import DistArray, from_numpy, zeros
from .lower import ArrayProgram, canonical_program, counters, lower

__all__ = [
    "ArrayProgram",
    "Block1D",
    "BlockCyclic",
    "DistArray",
    "Distribution",
    "Replicated",
    "canonical_program",
    "counters",
    "from_numpy",
    "lower",
    "zeros",
]
