"""Running one cell once: set-up, the measured window, the comparison with
the plain reference, and the result line.

A job is one user call: from taskpool construction to the answer home on
the host (the entry's ``Job.run``).  Jobs run back to back, one caller, a
closed loop.  Between jobs the harness makes the next job's fresh input and
collects garbage; that time is its own, printed on the detail line and
left out of every metric.  ``gflops`` is the useful flops of the jobs that
started and finished inside the window over the sum of their walls.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import trace as tr
from .spec import HERE, Cell

#: top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "parsec_tpu")

#: fixed cache directories inside the checkout, one per tool
CACHES = {
    "PARSEC_TPU_COMPILE_CACHE": "parsec_tpu_torch",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "nv",
}


def set_cache_env() -> None:
    """Point every build and kernel cache at a fixed directory under
    ``benchmark/.cache`` (the program's own kernels build into
    ``parsec_tpu_torch/_build`` in the checkout)."""
    base = HERE / ".cache"
    for var, sub in CACHES.items():
        path = base / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def bind_device(device: str) -> None:
    """Bind the program's device module to ``device``: the card (the
    program's default, ``cuda:<rank>``), or the torch CPU device, where the
    tests drive the same path at small sizes."""
    from parsec_tpu_torch.utils import mca_param

    mca_param.set_param("device", "cuda_torch_device", "cpu" if device == "cpu" else "")


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of :data:`FORBIDDEN`."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Run:
    """What the metric readers read: every finished job of the window, the
    work of one job, the set-up seconds and the traced window's summary."""
    jobs: List[Dict] = field(default_factory=list)
    flops: float = 0.0
    nbytes: float = 0.0
    precision: str = ""
    peaks: Dict = field(default_factory=dict)
    setup_s: float = 0.0
    trace: Optional[tr.Summary] = None


class Phases:
    """``span(phase)`` for the entry's jobs: host seconds into the current
    job's record, and a ``bench.<phase>`` profiler span when tracing."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.current: Dict[str, float] = {}

    @contextmanager
    def __call__(self, phase: str):
        ctx = nullcontext()
        if self.tracing:
            from torch.profiler import record_function
            ctx = record_function(f"bench.{phase}")
        t0 = time.perf_counter()
        with ctx:
            yield
        self.current[phase] = self.current.get(phase, 0.0) + time.perf_counter() - t0


def log(*parts) -> None:
    print("bench:", *parts, file=sys.stderr, flush=True)


def _reservoir_slot(index: int, room: int, rng: random.Random) -> Optional[int]:
    """Reservoir sampling over the window's jobs: the slot that job
    ``index`` is copied into, or None.  After every job the slots hold a
    uniform sample of at most ``room`` of the jobs so far, drawn by ``rng``
    (seeded by the run's seed)."""
    if index < room:
        return index
    r = rng.randrange(index + 1)
    return r if r < room else None


def window(job, seconds: float, phases: Phases, rng: random.Random):
    """Jobs back to back until ``seconds`` have passed.  A sampled job's
    output is copied into one of the entry's slots, made at set-up; every
    job's own output is dropped before the next, so each job finds the
    host memory as the one before it left it.  Returns the finished jobs'
    records, the number of outputs sampled, the jobs attempted and failed,
    and the harness's own seconds between jobs."""
    records = []
    attempted = failed = 0
    between = 0.0
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        inp = job.fresh_input()
        gc.collect()
        between += time.perf_counter() - t0
        if time.perf_counter() >= t_end:
            break
        attempted += 1
        phases.current = {}
        t0 = time.perf_counter()
        try:
            with phases("job"):
                rec = job.run(inp, phases)
        except Exception:  # a failed job is counted and ends the window
            failed += 1
            traceback.print_exc()
            break
        t1 = time.perf_counter()
        del inp
        out = rec.pop("output")
        rec.update(wall=t1 - t0, counted=t1 <= t_end, **{
            f"{p}_s": s for p, s in phases.current.items() if p != "job"})
        t0 = time.perf_counter()
        slot = _reservoir_slot(len(records), job.slots, rng)
        if slot is not None:
            job.keep(out, slot)
        del out
        between += time.perf_counter() - t0
        records.append(rec)
    return records, min(len(records), job.slots), attempted, failed, between


def run_cell(cell: Cell, seed: int, seconds: float, tracing: bool, *, device: str,
             t_start: float) -> int:
    """Run ``cell`` once and print its result line; returns the exit
    code."""
    import torch

    from benchmark.roofline import work

    torch.backends.cuda.matmul.allow_tf32 = False   # FP32 as configured,
    torch.backends.cudnn.allow_tf32 = False         # never TF32
    if device == "cuda":
        torch.cuda.set_device(0)
    bind_device(device)
    phases = Phases(tracing)
    log(f"cell {cell.name} seed {seed} seconds {seconds} trace {int(tracing)}")
    job = cell.entry.Job(cell.config, cell.traffic, seed, device)
    log(f"inputs made at {time.perf_counter() - t_start:.3f} s")
    for _ in range(int(cell.traffic.get("warm_jobs", 1))):
        phases.current = {}
        job.warm(phases)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats(0)
    rng = random.Random(seed)
    prof = None
    if tracing:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        records, kept, attempted, failed, between = window(job, seconds, phases, rng)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(0) if device == "cuda" else 0
    flops, nbytes = job.work()
    run = Run(records, flops, nbytes, job.precision, work.peaks(), setup_s)
    if prof is not None:
        t0 = time.perf_counter()
        run.trace = tr.summarize(*tr.from_profiler(prof))
        prof = None
        log(f"trace read in {time.perf_counter() - t0:.3f} s")
    counted = [r for r in records if r["counted"]]
    print(json.dumps({"detail": {
        "between_jobs_s": between, "jobs": len(records), "counted": len(counted),
        "job_walls_s": [r["wall"] for r in records],
        "phases_s": [{k: v for k, v in r.items() if k.endswith("_s") and k != "submit_s"}
                     for r in records]}}), flush=True)

    # the comparison, once the window has closed and the program's state
    # on the card is freed
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = {}
    if kept:
        numbers = job.numbers(job.kept(kept), job.reference())
    log(f"reference compared {kept} job(s) in {time.perf_counter() - t0:.3f} s")
    checks = {}
    for name in cell.entry.CHECKS:
        limit = float(cell.limits[name]["limit"])
        value = numbers.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
    correct = (failed == 0 and bool(kept) and
               all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                   for c in checks.values()))

    metrics = {}
    for m in cell.per_layer if tracing else cell.end_to_end:
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"bench: modules that may not load in the measuring process: "
              f"{', '.join(bad)}", file=sys.stderr, flush=True)
        return 3
    for name, c in checks.items():
        print(f"bench: check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
