"""Task-graph front-ends: the runtime-built PTG, its whole-DAG capture
(:mod:`.graph`) and the native executor (:mod:`.native_exec`).

DTD, JDF compilation, fusion, the serve and distributed executors of
:mod:`parsec_tpu.dsl` are not ported yet (ROADMAP A.4, A.8, A.9).
"""

from .ptg import PTG, PTGTaskClass, PTGTaskpool

__all__ = ["PTG", "PTGTaskClass", "PTGTaskpool"]
