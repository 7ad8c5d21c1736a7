"""Reading the device trace of a traced window.

The harness marks each job and each of its phases with a
``torch.profiler.record_function`` span named ``bench.<phase>``; the
profiler's CUDA events give every kernel and copy on the card.  The traced
window is the sum of the jobs' spans: the harness's own work between jobs
(the fresh input copy) runs on the host and is left out, so the card's idle
share is the system's.

The arithmetic (interval unions, clipping, idle gaps) is kept in plain
functions of ``(start, end)`` pairs so that it is tested on synthetic
events.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

Span = Tuple[float, float]

#: the job span and the phases inside it (``bench.<name>``)
JOB = "job"
PHASES = ("capture", "run", "writeback", "assemble")


def union(spans: Iterable[Span]) -> List[Span]:
    """The disjoint, sorted union of ``spans``."""
    out: List[List[float]] = []
    for s0, s1 in sorted(spans):
        if s1 <= s0:
            continue
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return [(a, b) for a, b in out]


def length(spans: Iterable[Span]) -> float:
    """Total length of the union of ``spans``."""
    return sum(b - a for a, b in union(spans))


def clip(spans: Iterable[Span], windows: Sequence[Span]) -> List[Span]:
    """The parts of ``spans`` inside the union of ``windows``."""
    wins = union(windows)
    out = []
    for s0, s1 in spans:
        for w0, w1 in wins:
            a, b = max(s0, w0), min(s1, w1)
            if b > a:
                out.append((a, b))
    return out


def gaps(busy: Iterable[Span], window: Span) -> List[Span]:
    """The parts of ``window`` that no span of ``busy`` covers."""
    w0, w1 = window
    out, at = [], w0
    for a, b in union(clip(busy, [window])):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < w1:
        out.append((at, w1))
    return out


def kind_of(name: str) -> str:
    """What a device event is, by the name CUPTI gives it."""
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy"):
        return "d2d"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


@dataclass
class Summary:
    """One traced window, in seconds."""
    jobs: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0        # summed, not unioned: every kernel's own time
    h2d_s: float = 0.0
    h2d_count: int = 0
    d2h_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def summarize(device: Sequence[Tuple[str, float, float]],
              host: Sequence[Tuple[str, float, float]], *, scale: float = 1e-6,
              top: int = 10) -> Summary:
    """``device``: ``(name, start, end)`` of each kernel and copy;
    ``host``: ``(phase, start, end)`` of the harness's spans (``job`` and
    :data:`PHASES`); times in units of ``scale`` seconds (the profiler's
    microseconds by default).  Device work outside every job span is not
    counted."""
    jobs = union(a_b for n, *a_b in host if n == JOB)
    s = Summary(jobs=len(jobs))
    if not jobs:
        return s
    s.window_s = length(jobs) * scale
    spans, by_name = [], {}
    for n, a, b in device:
        parts = [(max(a, w0), min(b, w1)) for w0, w1 in jobs if a < w1 and b > w0]
        if not parts:
            continue
        spans += parts
        d = sum(y - x for x, y in parts)
        k = kind_of(n)
        if k == "kernel":
            s.kernel_s += d * scale
        elif k == "h2d":
            s.h2d_s += d * scale
            s.h2d_count += 1
        elif k == "d2h":
            s.d2h_s += d * scale
        by_name[n] = by_name.get(n, 0.0) + d * scale
    s.busy_s = length(spans) * scale
    s.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    phases = [(n, a, b) for n, a, b in host if n in PHASES]
    idle: Dict[str, float] = {}
    busy = union(spans)
    for j0, j1 in jobs:
        mine = [(n, a, b) for n, a, b in phases if a < j1 and b > j0]
        for g0, g1 in gaps(busy, (j0, j1)):
            left = g1 - g0
            for n, a, b in mine:
                d = min(g1, b) - max(g0, a)
                if d > 0:
                    idle[n] = idle.get(n, 0.0) + d * scale
                    left -= d
            if left > 0:
                idle["between phases"] = idle.get("between phases", 0.0) + left * scale
    s.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return s


def from_profiler(prof) -> Tuple[List[Tuple[str, float, float]],
                                 List[Tuple[str, float, float]]]:
    """The device events and the harness's spans of a finished
    ``torch.profiler.profile``, in microseconds on one clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.events():
        name = ev.name
        if name.startswith("bench."):
            if ev.device_type != cuda:
                host.append((name[len("bench."):], ev.time_range.start,
                             ev.time_range.end))
            continue
        if ev.device_type != cuda or getattr(ev, "is_user_annotation", False):
            continue
        device.append((name, ev.time_range.start, ev.time_range.end))
    return device, host
