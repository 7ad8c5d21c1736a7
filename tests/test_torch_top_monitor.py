"""``tools top`` (``parsec_tpu_torch.profiling.top``), the live monitor
(``profiling.monitor``) and the steals reporter against the JAX
package's: the sparkline and the dashboard frame render the same text from
the same ``/status`` documents, histograms merge across ranks, ``top
--once`` and ``monitor`` run against a live serving endpoint on
127.0.0.1, the JSONL tail rides out truncation, and a flight dump cut
while a service runs names its tenants and jobs.  Mirrors
``tests/profiling/test_top.py``, ``test_monitor_serve.py`` and
``test_steals_monitor.py``."""

import io
import json
import os
import re
import threading

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import parsec_tpu_torch  # noqa: E402
from parsec_tpu.profiling import monitor as ref_monitor  # noqa: E402
from parsec_tpu.profiling import top as ref_top  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl.ptg import IN, INOUT, PTG  # noqa: E402
from parsec_tpu_torch.profiling import monitor, sde, top  # noqa: E402
from parsec_tpu_torch.profiling.health import HealthServer  # noqa: E402
from parsec_tpu_torch.profiling.monitor import (TailReader, poll_status,  # noqa: E402
                                                read_samples, render)
from parsec_tpu_torch.profiling.top import fetch_status, render_status, run_top, sparkline  # noqa: E402
from parsec_tpu_torch.serve import RuntimeService  # noqa: E402


@pytest.fixture
def clean_sde():
    sde.reset()
    yield
    sde.reset()


def _gated_pool(gate, n=4, name="toppool", entered=None):
    dc = LocalCollection("topD", shape=(1,), init=lambda k: np.zeros(1))
    ptg = PTG(name)
    st = ptg.task_class("top_step", k="0 .. N-1")
    st.affinity("D(0)")
    st.flow("X", INOUT, "<- (k == 0) ? D(0) : X top_step(k-1)",
            "-> (k < N-1) ? X top_step(k+1) : D(0)")

    def body(X, k):
        if k == 0:
            if entered is not None:
                entered.set()
            assert gate.wait(timeout=60)
        X += 1.0

    st.body(cpu=body)
    return ptg.taskpool(N=n, D=dc)


def _service():
    return RuntimeService(nb_cores=2, cuda_device="cpu")


# ---------------------------------------------------------------------------
# top
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts,width", [
    ([], 8), ([0, 0, 0], 4), ([0] * 10 + [100] + [0] * 10, 21), ([1, 1000], 2),
    (list(range(25)), 24), ([5, 0, 3, 0, 9, 1], 3)])
def test_sparkline_matches_the_reference(counts, width):
    assert sparkline(counts, width) == ref_top.sparkline(counts, width)
    assert len(sparkline(counts, width)) == width


def test_sparkline_shapes():
    assert sparkline([], width=8) == " " * 8
    assert "█" in sparkline([0] * 10 + [100] + [0] * 10, width=21)
    s2 = sparkline([1, 1000], width=2)
    assert s2[0] != " " and s2[1] == "█"


def _crafted_doc():
    return {
        "rank": 0, "nranks": 2,
        "scheduler": {"name": "wdrr", "ready_tasks": 17},
        "workers": {"executed": 4321},
        "active_taskpools": 2,
        "watchdog": {"stalled": False, "last_heard_age_s": {1: 0.2}},
        "slo": {
            "histograms": {"job_latency{'tenant': 'acme'}":
                           {"counts": [0] * 10 + [5] + [0] * 14, "sum": 1.0, "count": 5}},
            "stragglers": [{"class": "gemm", "rank": 1, "factor": 4.2, "mean_ms": 8.0,
                            "mesh_median_ms": 1.9, "jobs": ["acme/#7"]}],
            "violations": {"acme": 3}, "violations_total": 3,
        },
        "serve": {
            "closing": False, "fairness": True, "scheduler": "wdrr",
            "jobs": {"queued": 1, "inflight": 1, "done": 9, "failed": 0, "cancelled": 0,
                     "rejected": 0, "expired": 0},
            "queue": [{"job_id": 12, "tenant": "acme", "name": "qd", "state": "queued",
                       "trace_id": "ab" * 8, "progress": None}],
            "jobs_inflight": [{"job_id": 7, "tenant": "acme", "name": "dpotrf",
                               "state": "running", "trace_id": "cd" * 8,
                               "progress": {"retired": 50, "known": 100, "eta_s": 1.25}}],
            "tenants": {"acme": {"weight": 2, "inflight": 1, "queued": 1, "completed": 9,
                                 "slo_violations": 3, "p95_ms": 43.25, "slo_p95_ms": 20.0,
                                 "rate_tasks_per_s": 123.4}},
        },
    }


def _frame_body(text):
    # the first line carries the wall clock and the package's name
    return text.split("\n", 1)[1]


def test_render_status_crafted_matches_the_reference():
    out = render_status([_crafted_doc()])
    assert "ready 17" in out
    assert "STRAGGLER" in out and "gemm" in out and "acme/#7" in out
    assert "acme" in out and "43.25" in out and "20.0" in out
    assert "#   7" in out and "running 50%" in out and "1.2s" in out
    assert "cd" * 8 in out and "ab" * 8 in out and "queued" in out
    assert "n=5" in out and "job_latency" in out
    assert out.startswith("parsec_tpu_torch top")
    assert _frame_body(out) == _frame_body(ref_top.render_status([_crafted_doc()]))


def test_render_status_merges_histograms_across_ranks():
    d0, d1 = _crafted_doc(), _crafted_doc()
    d1["rank"] = 1
    d1["serve"] = None
    out = render_status([d0, d1])
    assert "n=10" in out
    assert _frame_body(out) == _frame_body(ref_top.render_status([d0, d1]))


@pytest.mark.parametrize("job,phase", [
    ({"state": "queued"}, "queued"),
    ({"state": "running", "progress": {"retired": 0, "known": 10}}, "starting"),
    ({"state": "running", "progress": {"retired": 10, "known": 10}}, "draining"),
    ({"state": "running", "progress": {"retired": 3, "known": 10}}, "running 30%"),
    ({"state": "running", "progress": {"retired": 3, "known": None}}, "running")])
def test_job_phase_matches_the_reference(job, phase):
    assert top._phase_of(job) == ref_top._phase_of(job) == phase


def test_top_once_against_live_endpoint(clean_sde):
    svc = _service()
    hs = HealthServer(svc.context).start()
    gate, entered = threading.Event(), threading.Event()
    try:
        h = svc.submit("t-top", _gated_pool(gate, entered=entered))
        assert entered.wait(timeout=30)
        buf = io.StringIO()
        assert run_top([hs.url], once=True, out=buf) == 0
        frame = buf.getvalue()
        assert "parsec_tpu_torch top" in frame and "t-top" in frame
        assert f"{h.trace_id:016x}" in frame
        gate.set()
        assert h.wait(timeout=60)
        # the tools command over the same endpoint
        from parsec_tpu_torch.profiling import tools

        out = io.StringIO()
        from contextlib import redirect_stdout

        with redirect_stdout(out):
            assert tools.main(["top", hs.url, "--once"]) == 0
        assert "t-top" in out.getvalue()
        buf = io.StringIO()
        assert run_top(["http://127.0.0.1:1/"], once=True, out=buf) == 1
        assert "unreachable" in buf.getvalue()
        assert fetch_status(hs.url)["rank"] == 0
    finally:
        gate.set()
        hs.stop()
        svc.close(timeout=30)


def test_top_max_updates_redraws_in_place(clean_sde):
    ctx = parsec_tpu_torch.Context(nb_cores=1, cuda_device="cpu")
    hs = HealthServer(ctx).start()
    try:
        buf = io.StringIO()
        assert run_top([hs.url], interval=0.01, max_updates=2, out=buf) == 0
        assert buf.getvalue().count(top.CLEAR) == 2
    finally:
        hs.stop()
        ctx.fini()


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

def test_monitor_poll_status_flattens_serve_section(clean_sde):
    svc = _service()
    hs = HealthServer(svc.context).start()
    gate, entered = threading.Event(), threading.Event()
    try:
        svc.tenant("t-mon", weight=3)
        h = svc.submit("t-mon", _gated_pool(gate, entered=entered))
        assert entered.wait(timeout=30)
        sample = poll_status(hs.url)
        assert sample["serve.tenants.t-mon.weight"] == 3
        assert sample["serve.tenants.t-mon.inflight"] == 1
        assert sample["serve.jobs.inflight"] == 1
        assert sample["serve.fairness"] is True
        jobs = sample.get("serve.jobs_inflight")
        assert isinstance(jobs, list) and jobs[0]["tenant"] == "t-mon"
        assert jobs[0]["trace_id"] == f"{h.trace_id:016x}"
        assert any(re.match(r"taskpools\[\d+:toppool\]\.retired", k) for k in sample)
        assert "serve.tenants.t-mon.weight" in render([sample])
        gate.set()
        assert h.wait(timeout=60)
        done = poll_status(hs.url)
        assert done["serve.tenants.t-mon.completed"] == 1
        assert done["serve.jobs.done"] == 1
        assert any(k.startswith("slo.") for k in done)
    finally:
        gate.set()
        hs.stop()
        svc.close(timeout=30)


def test_monitor_flatten_and_render_match_the_reference():
    doc = _crafted_doc()
    doc["taskpools"] = [{"taskpool_id": 3, "name": "x", "retired": 4, "known": 8}]
    port, ref = {}, {}
    monitor._flatten(doc, "", port)
    ref_monitor._flatten(doc, "", ref)
    assert port == ref and "taskpools[3:x].retired" in port
    samples = [{"t": 1.0, "a": 1, "b": [1, 2]}, {"t": 3.0, "a": 5, "b": {"c": "x" * 80}}]
    assert render(samples) == ref_monitor.render(samples)
    assert render([]) == ref_monitor.render([]) == "(no samples)"


def test_monitor_render_and_cli(tmp_path, capsys):
    samples = [{"t": 1.0, "runtime.pending_tasks": 10, "sde.X": 0},
               {"t": 2.0, "runtime.pending_tasks": 4, "sde.X": 100}]
    path = tmp_path / "live.jsonl"
    path.write_text("\n".join(json.dumps(s) for s in samples) + "\n{\"torn")
    assert "(-6.0/s)" in render(samples)
    assert monitor.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "2 samples" in out and "+100.0/s" in out
    assert read_samples(str(path)) == samples
    assert monitor.main([str(tmp_path / "missing.jsonl")]) == 1
    assert "cannot read" in capsys.readouterr().err
    assert monitor.main(["http://127.0.0.1:1"]) == 1
    assert "cannot poll" in capsys.readouterr().err


def test_monitor_tail_handles_truncation(tmp_path):
    path = tmp_path / "live.jsonl"
    path.write_text('{"t": 1.0, "a": 1}\n{"t": 2.0, "a": 2}\n')
    tail = TailReader(str(path))
    assert [s["a"] for s in tail.poll()] == [1, 2]
    assert tail.poll() == []
    path.write_text('{"t": 3.0, "a": 3}\n')
    assert [s["a"] for s in tail.poll()] == [3]
    with open(path, "a") as f:
        f.write('{"t": 4.0, ')
    assert tail.poll() == []
    with open(path, "a") as f:
        f.write('"a": 4}\n')
    assert [s["a"] for s in tail.poll()] == [4]
    path.unlink()
    assert tail.poll() == []  # a vanished file is ridden out


def _fan_tp(n):
    dc = LocalCollection("D", shape=(4,), init=lambda k: np.zeros(4))
    ptg = PTG("fan")
    src = ptg.task_class("src")
    src.affinity("D(0)")
    src.flow("X", INOUT, "<- D(0)", "-> X work(0 .. N-1)")
    src.body(cpu=lambda X: X.__iadd__(1.0))
    work = ptg.task_class("work", w="0 .. N-1")
    work.affinity("D(0)")
    work.flow("X", IN, "<- X src()")
    work.body(cpu=lambda X, w: None)
    return ptg.taskpool(N=n, D=dc)


def test_monitor_with_live_aggregator(tmp_path):
    from parsec_tpu_torch.profiling import dictionary

    path = str(tmp_path / "agg.jsonl")
    ctx = parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")
    try:
        dictionary.register_context(ctx)
        agg = dictionary.Aggregator(interval=0.02, path=path).start()
        tp = _fan_tp(16)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        sampled = threading.Event()
        for _ in range(500):
            if agg.samples:
                sampled.set()
                break
            sampled.wait(0.02)
        agg.stop()
    finally:
        ctx.fini()
        dictionary.unregister_property("runtime.pending_tasks")
        dictionary.unregister_property("runtime.executed_per_worker")
    samples = read_samples(path)
    assert samples and any("runtime.pending_tasks" in s for s in samples)


def test_print_steals_report():
    from parsec_tpu_torch.profiling.print_steals import PrintSteals

    ctx = parsec_tpu_torch.Context(nb_cores=4, cuda_device="cpu")
    mod = PrintSteals(ctx, auto=True)
    tp = _fan_tp(64)
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=60)
    rows = mod.snapshot()
    assert len(rows) == 4 and sum(r["executed"] for r in rows) == 65
    rep = mod.report()
    assert "total steals" in rep and "worker" in rep
    ctx.fini()


# ---------------------------------------------------------------------------
# flight snapshots of a serving context (tests/profiling/test_monitor_serve.py)
# ---------------------------------------------------------------------------

def test_flight_dump_sidecar_carries_serve_snapshot(tmp_path, clean_sde):
    from parsec_tpu_torch.profiling.flight import FlightRecorder

    svc = _service()
    fr = FlightRecorder(nranks=1, context=svc.context).install()
    gate, entered = threading.Event(), threading.Event()
    try:
        svc.tenant("t-fr", weight=2)
        h = svc.submit("t-fr", _gated_pool(gate, name="frpool", entered=entered))
        assert entered.wait(timeout=30)
        meta = json.load(open(fr.dump(str(tmp_path))[0] + ".meta.json"))
        serve = meta["serve"]
        assert serve["tenants"]["t-fr"]["weight"] == 2
        assert [(j["tenant"], j["name"], j["trace_id"]) for j in serve["jobs_inflight"]] == \
            [("t-fr", "frpool", f"{h.trace_id:016x}")]
        gate.set()
        assert h.wait(timeout=60)
        meta = json.load(open(fr.dump(str(tmp_path))[0] + ".meta.json"))
        assert meta["serve"]["jobs"]["done"] == 1 and meta["serve"]["jobs_inflight"] == []
    finally:
        gate.set()
        fr.uninstall()
        svc.close(timeout=30)


def test_flight_dump_without_serve_has_no_serve_key(tmp_path):
    from parsec_tpu_torch.profiling.flight import FlightRecorder

    ctx = parsec_tpu_torch.Context(nb_cores=1, cuda_device="cpu")
    fr = FlightRecorder(nranks=1, context=ctx).install()
    try:
        meta = json.load(open(fr.dump(str(tmp_path))[0] + ".meta.json"))
        assert "serve" not in meta and meta["flight_recorder"] is True
    finally:
        fr.uninstall()
        ctx.fini()
