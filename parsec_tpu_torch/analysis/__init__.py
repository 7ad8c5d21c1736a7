"""Static analysis for PTG/JDF task graphs and the runtime checkers.

The port of :mod:`parsec_tpu.analysis`, with the same finding codes and
public signatures.  Ahead-of-time verification of parameterized task
graphs — edge reciprocity, data-hazard detection, deadlock/liveness,
expression and affinity lint — without executing a single task body:

* :func:`verify_ptg` / ``PTG.verify(globals_, level=...)`` — verify a
  definition against concrete globals; returns :class:`Finding` objects
  with stable ``PTGxxx`` codes;
* :func:`lint_jdf` — verify a compiled ``.jdf`` (run by ``jdfc``'s
  generator and ``JDF.verify``);
* ``python -m parsec_tpu_torch.profiling.tools lint`` — the CLI (`--all`
  sweeps the in-repo :mod:`.registry`);
* ``PARSEC_TPU_LINT=1|strict`` — verify every PTG taskpool at attach;
* :mod:`.edges` — the declared-DAG enumeration the checks share.

Runtime-concurrency layer (``RT0xx`` finding codes):

* :mod:`.hb` — vector-clock happens-before race checker over the
  runtime's PINS event streams, live (``PARSEC_TPU_HBCHECK=1|strict``)
  and offline over binary ``.pbt`` dumps (``tools hbcheck``);
* :mod:`.schedules` — deterministic schedule explorer at one rank:
  seeded pop order and completion timing, with bit-identical-results +
  clean-hb-check assertions per seed;
* :mod:`.lockdep` — lock-order checker for the Python side
  (``PARSEC_TPU_LOCKDEP=1``).

Engine and documentation checks: :mod:`.engine_verify` (``ENG0xx``: the
ABI contract, the lifecycle model checker, conformance of the g++-built
engine's event drain, clang-tidy) and :mod:`.doc_lint` (``DOC0xx``: the
port's MCA parameters against ``parsec_tpu_torch/OPERATIONS.md``).
"""

from .findings import CODES, ERROR, WARNING, Finding, LintError, errors_of
from .linter import (
    SynthCollection,
    collection_names,
    lint_jdf,
    synthesize_collections,
    verify_ptg,
)

__all__ = [
    "CODES",
    "ERROR",
    "WARNING",
    "Finding",
    "HBRecorder",
    "LintError",
    "SynthCollection",
    "analyze_trace",
    "collection_names",
    "errors_of",
    "explore",
    "lint_jdf",
    "synthesize_collections",
    "verify_ptg",
]


def __getattr__(name):
    # concurrency-layer entry points: lazy, so importing the package
    # stays light for lint-only consumers (jdfc, the PTG attach hook)
    if name in ("HBRecorder", "analyze_trace"):
        from . import hb

        return getattr(hb, name)
    if name == "explore":
        from .schedules import explore

        return explore
    raise AttributeError(name)
