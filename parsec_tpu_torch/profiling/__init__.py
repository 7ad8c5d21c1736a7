"""Profiling: PINS callback sites, job trace ids, and the ``cache``,
``autotune``, ``lint`` and ``engine-verify`` commands (:mod:`.tools`).

Tracing, critical-path analysis, health and SLO planes and the other
commands of :mod:`parsec_tpu.profiling` are not ported yet (ROADMAP A.9b).
"""

from . import jobtrace, pins  # noqa: F401
