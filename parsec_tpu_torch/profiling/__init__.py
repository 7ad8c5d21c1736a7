"""Observability layer (reference L7): PINS hooks, the JSON and binary
tracers, the DOT grapher, the live properties dictionary, SDE counters,
alperf, job trace ids, the offline trace tools (:mod:`.tools`:
``info``, ``to-csv``, ``merge``, ``critpath``, ``hbcheck``, ``check``), and
the sink that puts a job's spans on the ``torch.profiler`` timeline
(:class:`~.torch_spans.ProfilerSpans`).

The port of :mod:`parsec_tpu.profiling`, with its live planes: the health
exporter and the stall watchdog (:mod:`.health`), the flight recorder
(:mod:`.flight`), the SLO plane (:mod:`.slo`), ``top`` (:mod:`.top`) and
the monitor (:mod:`.monitor`).
"""

from . import pins
from .trace import CommProfiler, TaskProfiler, Trace
from .grapher import DotGrapher
from . import dictionary
from . import sde
from . import jobtrace  # noqa: F401
from .alperf import AlperfModule
from .sde import SDEModule

__all__ = ["pins", "Trace", "TaskProfiler", "CommProfiler", "DotGrapher",
           "dictionary", "sde", "SDEModule", "AlperfModule",
           "BinaryTrace", "BinaryTaskProfiler", "RankTraceSet",
           "HealthServer", "Watchdog", "FlightRecorder", "ProfilerSpans"]


def __getattr__(name):
    # the binary tracer builds the native engine on first use: import it
    # lazily so the package loads without touching g++
    if name in ("BinaryTrace", "BinaryTaskProfiler", "RankTraceSet"):
        from . import binary

        return getattr(binary, name)
    if name in ("HealthServer", "Watchdog"):
        from . import health

        return getattr(health, name)
    if name == "FlightRecorder":
        from .flight import FlightRecorder

        return FlightRecorder
    if name == "ProfilerSpans":
        from .torch_spans import ProfilerSpans

        return ProfilerSpans
    raise AttributeError(name)
