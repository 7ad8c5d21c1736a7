"""Profiling: PINS callback sites and job trace ids.

Tracing, critical-path analysis, health and SLO planes of
:mod:`parsec_tpu.profiling` are not ported yet (ROADMAP A.11).
"""

from . import jobtrace, pins  # noqa: F401
