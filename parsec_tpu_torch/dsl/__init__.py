"""Task-graph front-ends: the runtime-built PTG (dynamic path).

DTD, JDF compilation, graph capture, fusion and the native executors of
:mod:`parsec_tpu.dsl` are not ported yet (ROADMAP A.4, A.6, A.11).
"""

from .ptg import PTG, PTGTaskClass, PTGTaskpool

__all__ = ["PTG", "PTGTaskClass", "PTGTaskpool"]
