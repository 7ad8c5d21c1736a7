"""The port's SLO plane (``parsec_tpu_torch.profiling.slo``) against the
JAX package's: the fixed log-spaced buckets, the element-wise merge, the
percentile estimator and the Prometheus histogram lines give the same
numbers on the same observations; the plane's EXEC-fed exec histograms on
``/metrics`` and ``/status``; OBS009 on an induced SLO violation and
OBS010 on an induced straggler, alone and in the watchdog's report; and a
RuntimeService's plane observing its jobs.  Mirrors
``tests/profiling/test_slo.py``."""

import json
import os
import re
import urllib.request

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import parsec_tpu_torch  # noqa: E402
from parsec_tpu.profiling import slo as ref_slo  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl.ptg import INOUT, PTG  # noqa: E402
from parsec_tpu_torch.profiling import sde, slo  # noqa: E402
from parsec_tpu_torch.profiling.health import HealthServer, Watchdog  # noqa: E402
from parsec_tpu_torch.profiling.slo import (BUCKET_BOUNDS_S, Histogram,  # noqa: E402
                                            SloPlane, merge_status_histograms)


@pytest.fixture
def clean_sde():
    sde.reset()
    yield
    sde.reset()


def _ctx(n=2):
    return parsec_tpu_torch.Context(nb_cores=n, cuda_device="cpu")


def _samples(seed, n=300):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(1e-5, 1e-3, n // 3), rng.lognormal(-3, 2, n // 3),
                           rng.uniform(100.0, 5000.0, n - 2 * (n // 3))])


# ---------------------------------------------------------------------------
# the histogram, held to the reference's
# ---------------------------------------------------------------------------

def test_bucket_bounds_and_families_match_the_reference():
    assert BUCKET_BOUNDS_S == ref_slo.BUCKET_BOUNDS_S
    assert len(BUCKET_BOUNDS_S) == 24 and BUCKET_BOUNDS_S[0] == 1e-4
    assert slo.FAMILIES == ref_slo.FAMILIES


def test_histogram_buckets_fixed_and_le_semantics():
    h = Histogram()
    assert len(h.counts) == len(BUCKET_BOUNDS_S) + 1
    h.observe(BUCKET_BOUNDS_S[0])
    h.observe(BUCKET_BOUNDS_S[0] * 1.5)
    h.observe(1e9)
    assert h.counts[0] == 1 and h.counts[1] == 1 and h.counts[-1] == 1
    assert h.count == 3
    h.observe(-1.0)
    h.observe(float("nan"))
    assert h.count == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_observations_match_the_reference(seed):
    port, ref = Histogram(), ref_slo.Histogram()
    for v in _samples(seed):
        port.observe(v)
        ref.observe(v)
    assert port.snapshot() == ref.snapshot()
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert port.percentile(q) == ref.percentile(q)


def test_histogram_merge_is_elementwise_bucket_add():
    rng = np.random.default_rng(7)
    a, b = rng.uniform(1e-4, 10.0, 200), rng.uniform(1e-3, 100.0, 300)
    ha, hb, hu = Histogram(), Histogram(), Histogram()
    for v in a:
        ha.observe(v)
        hu.observe(v)
    for v in b:
        hb.observe(v)
        hu.observe(v)
    merged = merge_status_histograms([ha.snapshot(), hb.snapshot()])
    assert merged.counts == hu.counts and merged.count == hu.count == 500
    assert merged.sum == pytest.approx(hu.sum)
    # a port snapshot merges into the reference's histogram and back
    r = ref_slo.merge_status_histograms([ha.snapshot(), hb.snapshot()])
    assert r.counts == merged.counts
    ha.merge(hb)
    assert ha.counts == hu.counts


def test_histogram_percentile_interpolates():
    h = Histogram()
    for _ in range(99):
        h.observe(0.001)
    h.observe(10.0)
    assert Histogram().percentile(0.5) is None
    p50 = h.percentile(0.5)
    assert BUCKET_BOUNDS_S[3] < p50 <= BUCKET_BOUNDS_S[4]
    assert h.percentile(1.0) > 1.0


def test_histogram_shape_mismatch_rejected():
    with pytest.raises(ValueError):
        Histogram().merge_snapshot({"counts": [1, 2, 3], "sum": 0.0, "count": 6})


def test_prometheus_histogram_lines_match_the_reference():
    h = Histogram()
    for v in _samples(4):
        h.observe(v)
    port, ref = [], []
    labels = {"rank": 0, "tenant": 'a"b'}
    slo.prometheus_histogram_lines("parsec_job_latency_seconds", labels, h.snapshot(), port)
    ref_slo.prometheus_histogram_lines("parsec_job_latency_seconds", labels, h.snapshot(), ref)
    assert port == ref
    assert port[len(BUCKET_BOUNDS_S)].endswith(f" {h.count}")  # le="+Inf" == count


def test_mesh_stragglers_match_the_reference():
    by_class = {"gemm": {0: (10, 1.0), 1: (10, 1.1), 2: (10, 9.0), 3: (2, 50.0)},
                "potrf": {0: (6, 2.0), 1: (6, 2.0)}, "trsm": {0: (9, 1.0)}}
    assert slo.mesh_stragglers(by_class, 3.0, 5) == \
        ref_slo.mesh_stragglers(by_class, 3.0, 5) == [("gemm", 2, 9.0, 1.1, 9.0 / 1.1)]


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

def _run_chain(ctx, n=6, name="slochain"):
    dc = LocalCollection(name + "D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = PTG(name)
    step = ptg.task_class("slostep", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", INOUT, "<- (k == 0) ? D(0) : X slostep(k-1)",
              "-> (k < N-1) ? X slostep(k+1) : D(0)")
    step.body(cpu=lambda X, k: X.__iadd__(1.0))
    tp = ptg.taskpool(N=n, D=dc)
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=60)
    return tp


PROM_HIST_BUCKET = re.compile(r'^parsec_task_exec_seconds_bucket\{[^}]*le="([^"]+)"\} (\d+)$')


def test_exec_histogram_exported_as_prometheus_family(clean_sde):
    ctx = _ctx()
    plane = SloPlane(ctx)
    ctx.slo = plane
    hs = HealthServer(ctx).start()
    try:
        _run_chain(ctx, n=6)
        text = urllib.request.urlopen(hs.url + "/metrics", timeout=10).read().decode()
        buckets = []
        for ln in text.splitlines():
            m = PROM_HIST_BUCKET.match(ln)
            if m and 'class="slostep"' in ln:
                buckets.append((m.group(1), int(m.group(2))))
        assert buckets, text
        vals = [v for _le, v in buckets]
        assert vals == sorted(vals)
        assert buckets[-1] == ("+Inf", 6)
        assert re.search(r'parsec_task_exec_seconds_count\{[^}]*class="slostep"\} 6', text)
        assert "parsec_task_exec_seconds_sum" in text
        assert re.search(r'parsec_slo_violations_total\{rank="0"\} 0', text)
        assert re.search(r'parsec_straggler_ranks\{rank="0"\} 0', text)
        st = json.loads(urllib.request.urlopen(hs.url + "/status", timeout=10).read().decode())
        hists = st["slo"]["histograms"]
        key = [k for k in hists if "slostep" in k]
        assert key and hists[key[0]]["count"] == 6
        assert st["slo"]["bucket_bounds_s"] == list(BUCKET_BOUNDS_S)
        assert set(st["slo"]) == {"bucket_bounds_s", "histograms", "targets_ms", "violations",
                                  "violations_total", "stragglers", "straggler_factor"}
    finally:
        hs.stop()
        plane.uninstall()
        ctx.fini()


def test_induced_slo_violation_yields_obs009_like_the_reference():
    """The same observations through both planes: the same violation
    counts, p95 estimates and OBS009 finding."""
    ctx = _ctx(1)
    port = SloPlane(ctx)
    ref = ref_slo.SloPlane(type("C", (), {"rank": 0, "serve": None})())
    try:
        for plane in (port, ref):
            for _ in range(6):
                plane.observe_job("acme", latency_s=1.0, queue_delay_s=0.01, target_ms=1.0)
            plane.observe_job("calm", latency_s=0.0001, queue_delay_s=0.0, target_ms=1000.0)
        for plane in (port, ref):
            assert plane.violations_total() == 6
            assert plane.violations_by_tenant() == {"acme": 6}
        fp, fr = port.slo_findings(), ref.slo_findings()
        assert len(fp) == 1 and fp[0].code == "OBS009" and fp[0].task == "acme"
        assert [(f.code, f.message, f.task, f.count) for f in fp] == \
            [(f.code, f.message, f.task, f.count) for f in fr]
        assert port.tenant_p95_ms("acme") == ref.tenant_p95_ms("acme") > 1.0
        assert port.tenant_p95_ms("nobody") is None
    finally:
        port.uninstall()
        ref.uninstall()
        ctx.fini()


def test_induced_straggler_yields_obs010_naming_rank_class():
    ctx = _ctx(1)
    plane = SloPlane(ctx)
    ctx.slo = plane
    try:
        _run_chain(ctx, n=8)
        my = plane.exec_digest()["slostep"]
        assert my[0] == 8
        plane.note_peer_digest(1, {"slostep": [my[0], my[1]]})
        plane.note_peer_digest(3, {"slostep": [my[0], my[1] * 10.0]})
        out = plane.stragglers()
        assert len(out) == 1 and out[0]["rank"] == 3 and out[0]["class"] == "slostep"
        assert out[0]["factor"] >= plane.factor
        assert any(f.code == "OBS010" and "rank 3" in f.message and "slostep" in f.message
                   for f in plane.straggler_findings())
        late = plane.straggler_findings(heartbeat_ages={2: 99.0}, late_after=5.0)
        assert any(f.code == "OBS010" and "rank 2" in f.message and "late" in f.message
                   for f in late)
        plane.note_peer_digest(4, {"slostep": "garbage"})  # dropped, never raises
    finally:
        plane.uninstall()
        ctx.fini()


def test_watchdog_report_carries_obs009_obs010():
    ctx = _ctx(1)
    plane = SloPlane(ctx)
    ctx.slo = plane
    wd = Watchdog(ctx, window=3600.0)
    ctx.watchdog = wd
    try:
        _run_chain(ctx, n=8)
        for _ in range(5):
            plane.observe_job("acme", latency_s=2.0, queue_delay_s=0.0, target_ms=1.0)
        my = plane.exec_digest()["slostep"]
        plane.note_peer_digest(1, {"slostep": [my[0], my[1]]})
        plane.note_peer_digest(2, {"slostep": [my[0], my[1] * 20.0]})
        report = wd.diagnose(pools=[])
        codes = {f.code for f in report.findings}
        assert "OBS009" in codes and "OBS010" in codes
        text = report.render()
        assert "acme" in text and "rank 2" in text
    finally:
        wd.stop()
        plane.uninstall()
        ctx.fini()


def test_plane_uninstall_is_symmetric_and_comm_observers_stay_unfired():
    from parsec_tpu_torch.profiling import pins

    ctx = _ctx(1)
    plane = SloPlane(ctx)
    try:
        for site in (pins.EXEC_BEGIN, pins.EXEC_END, pins.COLL_BEGIN, pins.COLL_SEG,
                     pins.COLL_END):
            assert pins.active(site)
        _run_chain(ctx, n=3)
        assert ("coll_segment", ()) not in plane._hists
        assert ("comm_rtt", ()) not in plane._hists
    finally:
        plane.uninstall()
        ctx.fini()
    assert plane._subs == []


def test_serve_installs_slo_plane_and_observes_jobs(clean_sde, monkeypatch):
    from parsec_tpu_torch.serve import RuntimeService

    svc = RuntimeService(nb_cores=2, cuda_device="cpu")
    try:
        ctx = svc.context
        assert ctx.slo is not None
        svc.tenant("t-slo", slo_p95_ms=0.0001)
        dc = LocalCollection("svD", shape=(1,), init=lambda k: np.zeros(1))
        ptg = PTG("svchain")
        st = ptg.task_class("svstep", k="0 .. N-1")
        st.affinity("D(0)")
        st.flow("X", INOUT, "<- (k == 0) ? D(0) : X svstep(k-1)",
                "-> (k < N-1) ? X svstep(k+1) : D(0)")
        st.body(cpu=lambda X, k: X.__iadd__(1.0))
        h = svc.submit("t-slo", ptg.taskpool(N=4, D=dc))
        assert h.wait(timeout=60)
        tn = svc.status_doc()["tenants"]["t-slo"]
        assert tn["slo_p95_ms"] == 0.0001 and tn["slo_violations"] == 1
        assert tn["p95_ms"] is not None and tn["p95_ms"] > 0.0001
        assert ctx.slo.violations_total() == 1
        assert ctx.slo.hist("job_latency", ("tenant", "t-slo")).count == 1
        assert ctx.slo.hist("job_queue_delay", ("tenant", "t-slo")).count == 1
    finally:
        svc.close(timeout=30)
    # PARSEC_TPU_SLO=0 opts a service's context out
    monkeypatch.setenv("PARSEC_TPU_SLO", "0")
    svc = RuntimeService(nb_cores=1, cuda_device="cpu")
    try:
        assert svc.context.slo is None
        assert svc.status_doc()["tenants"] == {}
    finally:
        svc.close(timeout=30)
