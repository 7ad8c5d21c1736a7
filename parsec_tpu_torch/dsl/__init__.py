"""Task-graph front-ends: the runtime-built PTG, JDF compilation onto it
(:mod:`.jdf`, the :mod:`.jdfc` code generator), DTD task insertion
(:mod:`.dtd`, and :mod:`.dtd_native` streaming into the native engine),
the PTG-to-DTD replay (:mod:`.ptg_to_dtd`), the PTG's whole-DAG capture
(:mod:`.graph`), the native executor (:mod:`.native_exec`), whole-DAG
CUDA-graph capture (:mod:`.cuda_graph`, :class:`GraphExecutor`, with
level batching: ``batch_levels=True``) and supertask fusion
(:mod:`.fusion`).  :class:`~.native_exec.NativeServeExecutor` runs several
pools as wdrr tenants of one native graph.  :class:`CollectiveTask`
inserts collectives as DTD nodes (:mod:`.collective`).
:class:`~.native_dist.NativeDistExecutor` runs one rank's partition of a
PTG on the native engine, its cross-rank edges over the comm engine
(:mod:`.native_dist`).
"""

from .collective import CollectiveTask
from .cuda_graph import GraphExecutor
from .dtd import (AFFINITY, ATOMIC_WRITE, CTL, DONT_TRACK, IN, INOUT, OUT,
                  SCRATCH, VALUE, DTDTaskpool)
from .dtd_native import NativeDTD
from .jdf import JDF, compile_jdf, compile_jdf_file
from .ptg import PTG, PTGTaskClass, PTGTaskpool
from .ptg_to_dtd import replay_via_dtd

__all__ = [
    "CollectiveTask", "GraphExecutor", "PTG", "PTGTaskClass", "PTGTaskpool",
    "DTDTaskpool", "NativeDTD", "JDF", "compile_jdf", "compile_jdf_file",
    "replay_via_dtd",
    "IN", "OUT", "INOUT", "CTL", "VALUE", "SCRATCH", "ATOMIC_WRITE",
    "AFFINITY", "DONT_TRACK",
]
