"""A job's spans and counters in the port (``parsec_tpu_torch.profiling.pins``
``SPANS``, the ``torch.profiler`` sink ``ProfilerSpans``, the executor's
and the device module's ``stats``), on the CUDA module bound to the torch
CPU device.

Two jobs as a user runs them, each from its taskpool to its answer on the
host: a dpotrf (N=1024 in 256-tiles) and a causal flash-attention prefill
(S=2048 in 512-blocks, the planes made lazily), through
``NativeExecutor(tp, native_device=True)``.  Every span pairs its BEGIN
and END on one thread, carries the job's id and its parent's, and nests as
:data:`PARENTS` says; the counters are never negative and the pump's
phases fit in the run's wall; the sink's ``parsec.*`` ranges nest as the
spans do; nothing fires, and no payload is made, when nothing subscribes.
The card's own waits (``card_wait``) have no event to wait on here: the
card checks them (``chip_smoke.py`` and the benchmark's traced runs).
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from parsec_tpu_torch import mca_param
from parsec_tpu_torch.datadist import TiledMatrix
from parsec_tpu_torch.device import staging
from parsec_tpu_torch.dsl.native_exec import NativeExecutor
from parsec_tpu_torch.ops import build_flash_attention, cholesky_ptg
from parsec_tpu_torch.ops.attention import PlaneCollection
from parsec_tpu_torch.profiling import pins
from parsec_tpu_torch.profiling.torch_spans import ProfilerSpans

#: span -> the spans it may open inside (None: at the top of its thread)
PARENTS = {
    "taskpool": {None, "taskpool"},   # the PTG pool inside build_flash_attention's
    "materialize": {"native_build"},  # the build resolves each task's tiles
    "capture": {None},
    "native_build": {None},
    "pump": {None},
    "pop": {"pump"},
    "lane_wait": {"pump"},
    "submit": {"pump"},
    "retire": {"pump"},
    "stage_copy": {"submit", "stage_in"},
    "wb_copy": {"writeback"},
    "writeback": {"close", None},     # None: the committer's thread
    "stage_in": {None},               # the transfer lane's thread
    "close": {None},
    "assemble": {None},
}

#: the spans each job opens at stage depth 1 on the torch CPU device
FIRED = {
    "dpotrf": {"taskpool", "capture", "native_build", "pump", "pop", "submit",
               "retire", "stage_copy", "wb_copy", "writeback", "close"},
    "prefill": {"taskpool", "materialize", "capture", "native_build", "pump", "pop",
                "submit", "retire", "stage_copy", "wb_copy", "writeback", "close",
                "assemble"},
}

#: the spans that move data carry its bytes and tiles; a ``materialize``
#: span's bytes are the tile's copied bytes, 0 for a view or a blank tile
MOVING = ("materialize", "stage_copy", "wb_copy", "writeback", "assemble")


@pytest.fixture
def cpu_device():
    """The pump's CUDA module on the torch CPU device; the params unset
    after."""
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    set_("device", "cuda_torch_device", "cpu")
    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


class _Recorder:
    """Every BEGIN and END of a job's span: (span, "begin"|"end", thread,
    payload)."""

    def __init__(self):
        self.events = []
        self._subs = []
        for name, (begin, end) in pins.SPANS.items():
            for site, phase in ((begin, "begin"), (end, "end")):
                cb = (lambda es, p, name=name, phase=phase:
                      self.events.append((name, phase, threading.get_ident(), dict(p))))
                pins.subscribe(site, cb)
                self._subs.append((site, cb))

    def close(self):
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)

    def begins(self):
        return [(n, t, p) for n, ph, t, p in self.events if ph == "begin"]


@pytest.fixture
def recorder():
    rec = _Recorder()
    yield rec
    rec.close()


def _spd(n, seed=0):
    m = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return m @ m.T + n * np.eye(n, dtype=np.float32)


def _dpotrf():
    a = TiledMatrix(1024, 1024, 256, 256, name="A", dtype=np.float32).from_array(_spd(1024))
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(NT=a.mt, A=a)
    ex = NativeExecutor(tp, native_device=True)
    t0 = time.perf_counter()
    ex.run()
    wall = time.perf_counter() - t0
    ex.close()
    return tp, ex, wall


def _prefill():
    gen = torch.Generator().manual_seed(0)
    q, k, v = torch.randn((3, 1, 2048, 2, 16), generator=gen)
    tp, assemble = build_flash_attention(q, k, v, causal=True, q_block=512,
                                         kv_block=512, use_cpu=False)
    ex = NativeExecutor(tp, native_device=True)
    t0 = time.perf_counter()
    ex.run()
    wall = time.perf_counter() - t0
    ex.close()
    assert tuple(assemble().shape) == (1, 2048, 2, 16)
    return tp, ex, wall


JOBS = {"dpotrf": _dpotrf, "prefill": _prefill}


def _parents(events):
    """Per BEGIN: (span, payload, the span open on its thread when it
    began, or None), checking that BEGIN and END pair on one thread."""
    open_ = collections.defaultdict(list)
    out = []
    for name, phase, tid, p in events:
        stack = open_[tid]
        if phase == "begin":
            out.append((name, p, stack[-1] if stack else None))
            stack.append((name, p["id"]))
        else:
            assert stack and stack[-1] == (name, p["id"]), (name, p, stack)
            stack.pop()
    assert not any(open_.values()), dict(open_)
    return out


@pytest.mark.parametrize("job", sorted(JOBS))
def test_spans_pair_on_one_thread(job, cpu_device, recorder):
    JOBS[job]()
    begins = collections.Counter(p["id"] for n, ph, t, p in recorder.events if ph == "begin")
    ends = collections.Counter(p["id"] for n, ph, t, p in recorder.events if ph == "end")
    assert begins == ends and set(begins.values()) == {1}
    _parents(recorder.events)  # nested BEGIN/END pairs on each thread
    assert {n for n, _t, _p in recorder.begins()} == FIRED[job]


@pytest.mark.parametrize("job", sorted(JOBS))
def test_spans_carry_the_job_and_their_parent(job, cpu_device, recorder):
    tp, ex, _wall = JOBS[job]()
    assert tp.job == ex.job == ex.device.job > 0
    ends = {p["id"]: p for _n, ph, _t, p in recorder.events if ph == "end"}
    made = 0
    for name, p, up in _parents(recorder.events):
        assert {"rank", "id", "job", "parent"} <= set(p), (name, p)
        assert p["job"] == ex.job, (name, p)
        assert p["parent"] == (up[1] if up else 0), (name, p, up)
        assert (up[0] if up else None) in PARENTS[name], (name, up)
        if name in MOVING:  # known by the END
            end = ends[p["id"]]
            if name == "materialize":
                made += end["bytes"]
                assert end["bytes"] >= 0 and end["tiles"] == 1, (name, end)
            else:
                assert end["bytes"] > 0 and end["tiles"] > 0, (name, end)
    copied = sum(dc.stats["copied_bytes"] for dc in tp.constants.values()
                 if isinstance(dc, PlaneCollection))
    assert made == copied and (job == "dpotrf" or copied > 0)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_counters_fit_the_run(job, cpu_device):
    """Always on: the executor's and the device module's seconds are never
    negative, and the pump's phases fit in the wall of ``run()``."""
    _tp, ex, wall = JOBS[job]()
    st, dev = ex.stats, ex.device.stats
    keys = ("graph_capture_s", "native_build_s", "pop_s", "lane_wait_s", "submit_s",
            "retire_s")
    assert all(st[k] >= 0 for k in keys)
    assert st["graph_capture_s"] > 0 and st["native_build_s"] > 0 and st["pop_s"] > 0
    assert st["pop_s"] + st["lane_wait_s"] + st["submit_s"] + st["retire_s"] <= wall
    assert dev["stage_copy_s"] > 0 and dev["wb_copy_s"] > 0
    assert dev["card_wait_s"] == 0 and dev["card_waits"] == 0  # no card here


@pytest.mark.parametrize("job", sorted(JOBS))
def test_profiler_ranges_nest_as_the_spans(job, cpu_device, recorder):
    """One ``parsec.<span>`` range a span, carrying the span's payload as
    its arguments, inside its parent's range on the profiler's clock."""
    sink = ProfilerSpans().install()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            _tp, ex, _wall = JOBS[job]()
    finally:
        sink.uninstall()
    ranges = {ev.kwinputs["id"]: (ev.name, ev.kwinputs, ev.time_range)
              for ev in prof.events() if ev.name.startswith("parsec.")}
    spans = _parents(recorder.events)
    assert len(ranges) == len(spans)
    for name, p, up in spans:
        got, args, when = ranges[p["id"]]
        assert got == f"parsec.{name}"
        assert args == {k: p[k] for k in ("job", "id", "parent", "bytes", "tiles") if k in p}
        assert args["job"] == ex.job
        if up is not None:
            outer = ranges[up[1]][2]
            assert outer.start <= when.start and when.end <= outer.end, (name, up)


def test_uninstall_leaves_no_subscriber():
    sites = [s for pair in pins.SPANS.values() for s in pair]
    before = {s: pins._subscribers.get(s, ()) for s in sites}
    sink = ProfilerSpans().install()
    assert sink.install() is sink  # once
    assert all(len(pins._subscribers[s]) == len(before[s]) + 1 for s in sites)
    sink.uninstall()
    assert {s: pins._subscribers.get(s, ()) for s in sites} == before


@pytest.mark.parametrize("job", sorted(JOBS))
def test_nothing_subscribed_fires_nothing(job, cpu_device, monkeypatch):
    """With no subscriber every span site is asked ``pins.active`` and
    answers False: no payload is made and nothing fires."""
    sites = {s: name for name, pair in pins.SPANS.items() for s in pair}
    asked, fired = collections.Counter(), []
    active, fire = pins.active, pins.fire

    def spy_active(site):
        on = active(site)
        if site in sites:
            asked[sites[site], on] += 1
        return on

    def spy_fire(site, es, payload):
        if site in sites:
            fired.append(site)
        fire(site, es, payload)

    monkeypatch.setattr(pins, "active", spy_active)
    monkeypatch.setattr(pins, "fire", spy_fire)
    JOBS[job]()
    assert not fired
    assert {name for name, on in asked} == FIRED[job]
    assert not any(on for _name, on in asked)


def test_exec_pins_carry_the_job(cpu_device):
    jobs = []
    cb = lambda es, task: jobs.append(task.prof["job"])  # noqa: E731
    pins.subscribe(pins.EXEC_BEGIN, cb)
    try:
        _tp, ex, _wall = _dpotrf()
    finally:
        pins.unsubscribe(pins.EXEC_BEGIN, cb)
    assert len(jobs) == 20 and set(jobs) == {ex.job}


def test_lane_and_committer_spans_carry_the_job(cpu_device, recorder, monkeypatch):
    """At stage depth 2 the transfer lane's ``stage_in`` spans and the
    committer's ``writeback`` spans open on their own threads and carry
    the job the executor handed its device module; the pump waits for the
    lane (``lane_wait``).  The pump lets the lane finish each batch, as
    ``test_torch_staging.py`` does, so the lane stages in every run."""
    cpu_device("runtime", "stage_depth", 2)
    cpu_device("runtime", "stage_split_kb", 0)
    stop_after_chunk = staging._StageJob.wait

    def wait_for_the_lane(job):
        job.done.wait(timeout=60)
        stop_after_chunk(job)

    monkeypatch.setattr(staging._StageJob, "wait", wait_for_the_lane)
    _tp, ex, _wall = _dpotrf()
    me = threading.get_ident()
    spans = _parents(recorder.events)
    lane = [(p, up) for (n, p, up) in spans if n == "stage_in"]
    assert lane and ex.stats["lane_wait_s"] >= 0
    assert "lane_wait" in {n for n, _p, _up in spans}
    assert {p["job"] for p, _up in lane} == {ex.job}
    assert all(up is None and p["parent"] == 0 for p, up in lane)
    threads = {t for n, ph, t, p in recorder.events if n == "stage_in"}
    assert me not in threads
    assert {p["job"] for n, p, _up in spans if n == "writeback"} == {ex.job}
    for name, p, up in spans:
        assert p["job"] == ex.job and (up[0] if up else None) in PARENTS[name], (name, up)
