"""Observability layer (reference L7): PINS hooks, the JSON and binary
tracers, the DOT grapher, the live properties dictionary, SDE counters,
alperf, job trace ids, and the offline trace tools (:mod:`.tools`:
``info``, ``to-csv``, ``merge``, ``critpath``, ``hbcheck``, ``check``).

The port of :mod:`parsec_tpu.profiling`.  Its live planes — the health
server, the stall watchdog, the flight recorder, the SLO plane, ``top``
and the serve monitor — are ROADMAP A.9b part 2.
"""

from . import pins
from .trace import CommProfiler, TaskProfiler, Trace
from .grapher import DotGrapher
from . import dictionary
from . import sde
from . import jobtrace  # noqa: F401
from .alperf import AlperfModule
from .sde import SDEModule

#: the reference's live-plane names (health server, watchdog, flight
#: recorder): ROADMAP A.9b part 2
_LIVE_PLANES = ("HealthServer", "Watchdog", "FlightRecorder")

__all__ = ["pins", "Trace", "TaskProfiler", "CommProfiler", "DotGrapher",
           "dictionary", "sde", "SDEModule", "AlperfModule",
           "BinaryTrace", "BinaryTaskProfiler", "RankTraceSet"]


def __getattr__(name):
    # the binary tracer builds the native engine on first use: import it
    # lazily so the package loads without touching g++
    if name in ("BinaryTrace", "BinaryTaskProfiler", "RankTraceSet"):
        from . import binary

        return getattr(binary, name)
    if name in _LIVE_PLANES:
        raise NotImplementedError(
            f"profiling.{name}: the live planes are not ported yet "
            "(ROADMAP A.9b part 2)")
    raise AttributeError(name)
