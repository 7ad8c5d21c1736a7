"""Task-graph front-ends: the runtime-built PTG, its whole-DAG capture
(:mod:`.graph`), the native executor (:mod:`.native_exec`), whole-DAG
CUDA-graph capture (:mod:`.cuda_graph`, :class:`GraphExecutor`, with
level batching: ``batch_levels=True``) and supertask fusion
(:mod:`.fusion`).

DTD, JDF compilation, the serve and distributed executors of
:mod:`parsec_tpu.dsl` are not ported yet (ROADMAP A.8, A.9).
"""

from .cuda_graph import GraphExecutor
from .ptg import PTG, PTGTaskClass, PTGTaskpool

__all__ = ["GraphExecutor", "PTG", "PTGTaskClass", "PTGTaskpool"]
