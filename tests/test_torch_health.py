"""The port's health plane (``parsec_tpu_torch.profiling.health``) and
stall watchdog against the JAX package's: ``/metrics`` (valid Prometheus
text, the per-taskpool, serving and per-tenant families), ``/status``,
``/healthz`` and ``/flightdump`` served on 127.0.0.1, the SDE gauge set
against ``OPERATIONS.md``, the live monitor over HTTP, ``tools
serve-status``, and the watchdog: no false positive on a healthy run, a
wedged single-rank pool diagnosed (OBS001, OBS008 naming the tenant,
OBS006) and failed in strict mode, on-demand diagnosis.  Documents are
compared key by key with the reference's over the same scenario.

Mirrors ``tests/profiling/test_health.py``, ``test_watchdog.py`` and
``tests/serve/test_observability.py`` at one rank; the multi-rank cases
(the 2-rank scrape, heartbeats, the clock re-sync, the silent-rank and
fourcounter findings) are in ``test_torch_multirank_obs.py``.  Stalls are
waited for through the watchdog's ``on_stall`` event,
scrapes while a run is live through a gated first task."""

import io
import json
import math
import os
import re
import threading
import urllib.error
import urllib.request
from contextlib import redirect_stdout

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocal  # noqa: E402
from parsec_tpu.dsl.ptg import INOUT as REF_INOUT  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.profiling import health as ref_health  # noqa: E402
from parsec_tpu.profiling import sde as ref_sde  # noqa: E402
from parsec_tpu.serve import RuntimeService as RefService  # noqa: E402
from parsec_tpu_torch.analysis.findings import CODES  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl.ptg import INOUT, PTG  # noqa: E402
from parsec_tpu_torch.profiling import dictionary, health, sde, tools  # noqa: E402
from parsec_tpu_torch.profiling.health import (HealthServer, Watchdog,  # noqa: E402
                                               register_context_gauges)
from parsec_tpu_torch.serve import RuntimeService  # noqa: E402

OPS_MD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "parsec_tpu_torch", "OPERATIONS.md")
PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9eE+.]+$")


@pytest.fixture
def clean_sde():
    sde.reset()
    ref_sde.reset()
    yield
    sde.reset()
    ref_sde.reset()


def _gated_job(name, gate, n=5, entered=None, ref=False):
    """A chain whose FIRST task signals ``entered`` and blocks on
    ``gate``: the pool stays live until the test opens it."""
    Local, P, io_ = (RefLocal, RefPTG, REF_INOUT) if ref else (LocalCollection, PTG, INOUT)
    dc = Local("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = P(name)
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", io_, "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")

    def body(X, k):
        if k == 0:
            if entered is not None:
                entered.set()
            assert gate.wait(timeout=60)
        X += 1.0

    step.body(cpu=body)
    return ptg.taskpool(N=n, D=dc), dc


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read().decode()


def _ctx(**kw):
    return parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu", **kw)


def _families(text):
    return {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
            if ln and not ln.startswith("#")}


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    return None


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------

def test_metrics_status_healthz_during_a_live_run(clean_sde):
    ctx = _ctx()
    hs = HealthServer(ctx).start()
    gate, entered = threading.Event(), threading.Event()
    try:
        assert hs.host == "127.0.0.1" and hs.port > 0
        assert hs.url == f"http://127.0.0.1:{hs.port}"
        tp, _ = _gated_job("gated", gate, n=6, entered=entered)
        ctx.add_taskpool(tp)
        ctx.start()
        assert entered.wait(timeout=30)
        # a counter another module registered is exported under parsec_sde
        # (the context's own gauges are exported under their families)
        sde.register_gauge("PARSEC::TEST::GAUGE", lambda: 7.0)
        text = _get(hs.url + "/metrics")
        for ln in (x for x in text.splitlines() if x and not x.startswith("#")):
            assert PROM_LINE.match(ln), f"invalid prom line: {ln!r}"
        assert 'parsec_ready_tasks{rank="0"' in text
        assert 'parsec_taskpool_retired_total{rank="0"' in text
        assert "parsec_taskpool_known_tasks" in text
        assert 'parsec_arena_bytes_in_use{rank="0"}' in text
        assert "parsec_device_wave_occupancy" in text
        assert 'parsec_compile_cache_hits_total{rank="0"}' in text
        assert 'parsec_sde{rank="0",counter="PARSEC::TEST::GAUGE"} 7' in text
        st = json.loads(_get(hs.url + "/status"))
        assert st["rank"] == 0 and st["nranks"] == 1
        assert st["active_taskpools"] == 1
        prog = st["taskpools"][0]
        assert prog["name"] == "gated" and prog["known"] == 6
        assert prog["retired"] < 6 and not prog["done"]
        assert st["comm"] is None and st["coll"] is None
        # the array front end's live counters (zeros before its first
        # program in this process)
        from parsec_tpu_torch.array import counters as array_counters

        assert st["array"] == array_counters()
        assert [d["name"] for d in st["devices"]][0] == "cpu0"
        assert json.loads(_get(hs.url + "/healthz")) == {"ok": True, "rank": 0,
                                                          "stalled": False}
        assert f"sde.{sde.READY_TASKS}" in dictionary.snapshot()
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(hs.url + "/nowhere")
        assert err.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(hs.url + "/flightdump")  # no recorder installed
        assert err.value.code == 404
        gate.set()
        assert tp.wait(timeout=60)
        assert json.loads(_get(hs.url + "/status"))["active_taskpools"] == 0
    finally:
        gate.set()
        hs.stop()
        ctx.fini()
    assert sde.READY_TASKS not in sde.list_counters()


def test_env_switches_start_and_stop_the_planes(monkeypatch):
    for var, val in (("PARSEC_TPU_HEALTH", "1"), ("PARSEC_TPU_WATCHDOG", "strict"),
                     ("PARSEC_TPU_FLIGHT", "1"), ("PARSEC_TPU_SLO", "1")):
        monkeypatch.setenv(var, val)
    ctx = _ctx()
    try:
        assert ctx.health.host == "127.0.0.1" and ctx.health.port > 0
        assert ctx.watchdog.strict and ctx.flight is not None and ctx.slo is not None
        threads = {t.name for t in threading.enumerate()}
        assert "parsec-health-r0" in threads and "parsec-watchdog-r0" in threads
        assert json.loads(_get(ctx.health.url + "/healthz"))["ok"] is True
        health_thread = ctx.health._thread
        watchdog_thread = ctx.watchdog._thread
    finally:
        ctx.fini()
    assert ctx.health is ctx.watchdog is ctx.flight is ctx.slo is None
    assert not health_thread.is_alive() and not watchdog_thread.is_alive()


def test_metrics_families_and_status_keys_match_the_reference(clean_sde):
    """One service, one tenant, one job through each package: the same
    Prometheus family names and the same ``/status`` key tree."""
    texts, docs = {}, {}
    for name in ("port", "ref"):
        if name == "port":
            sv = RuntimeService(nb_cores=2, cuda_device="cpu")
            hs = HealthServer(sv.context).start()
        else:
            sv = RefService(nb_cores=2)
            hs = ref_health.HealthServer(sv.context).start()
        try:
            gate = threading.Event()
            gate.set()
            sv.tenant("acme", weight=3)
            assert sv.submit("acme", _gated_job("j", gate, ref=name == "ref")[0],
                             priority=1).wait(timeout=60)
            texts[name] = _get(hs.url + "/metrics")
            docs[name] = json.loads(_get(hs.url + "/status"))
        finally:
            hs.stop()
            sv.close(timeout=30)
    assert _families(texts["port"]) == _families(texts["ref"])
    sd_p = {k for k in docs["port"]}
    assert sd_p == set(docs["ref"])
    for key in ("scheduler", "workers", "arena", "serve", "slo", "array"):
        assert _keys(docs["port"][key]) == _keys(docs["ref"][key]), key
    assert docs["port"]["serve"]["tenants"]["acme"]["completed"] == \
        docs["ref"]["serve"]["tenants"]["acme"]["completed"] == 1
    jobs = {n: sorted(k for k in docs[n]["slo"]["histograms"] if k.startswith("job_"))
            for n in docs}
    assert jobs["port"] == jobs["ref"] == ["job_latency{'tenant': 'acme'}",
                                           "job_queue_delay{'tenant': 'acme'}"]
    assert set(docs["port"]["sde"]) == set(docs["ref"]["sde"])


def test_metrics_and_status_carry_tenant_slices(clean_sde):
    with RuntimeService(nb_cores=2, cuda_device="cpu") as sv:
        hs = HealthServer(sv.context).start()
        gate, entered = threading.Event(), threading.Event()
        tp, _ = _gated_job("tenjob", gate, entered=entered)
        sv.tenant("acme", weight=3)
        h = sv.submit("acme", tp, priority=1)
        try:
            assert entered.wait(timeout=30)
            text = _get(hs.url + "/metrics")
            assert 'name="tenjob"' in text and 'tenant="acme"' in text
            assert 'parsec_tenant_retired_total{rank="0",tenant="acme"}' in text
            assert 'parsec_tenant_weight{rank="0",tenant="acme"} 3' in text
            assert 'parsec_tenant_jobs_inflight{rank="0",tenant="acme"} 1' in text
            assert "parsec_serve_jobs_inflight" in text
            st = json.loads(_get(hs.url + "/status"))
            ten = st["serve"]["tenants"]["acme"]
            assert ten["weight"] == 3 and ten["inflight"] == 1
            assert st["taskpools"][0]["tenant"] == "acme"
            assert sde.read(sde.SERVE_JOBS_INFLIGHT) == 1.0
            assert sde.read(sde.SERVE_TENANTS) == 1.0
        finally:
            gate.set()
        assert h.wait(timeout=60)
        assert sde.read(sde.SERVE_JOBS_DONE) == 1.0
        hs.stop()


def test_taskpool_progress_counts_rate_and_eta():
    ctx = _ctx()
    try:
        gate = threading.Event()
        gate.set()
        tp, _ = _gated_job("p", gate)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
        p = tp.progress()
        assert p["retired"] == 5 and p["known"] == 5
        assert p["done"] and not p["failed"]
        assert p["rate_tasks_per_s"] > 0 and p["eta_s"] == 0.0
        for _ in range(3):
            assert p["eta_s"] is None or math.isfinite(p["eta_s"])
    finally:
        ctx.fini()


def test_sde_doc_drift_after_dpotrf(clean_sde):
    """Every SDE counter named in the port's OPERATIONS.md is registered
    after a small dpotrf with the health gauges installed, and the port
    declares the reference's whole gauge set."""
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops import cholesky_ptg
    from parsec_tpu_torch.profiling import SDEModule

    documented = set(re.findall(r"`(PARSEC::[A-Z_:]+)`", open(OPS_MD).read()))
    declared = {v for k, v in vars(sde).items() if k.isupper() and isinstance(v, str)
                and v.startswith("PARSEC::")}
    ref_declared = {v for k, v in vars(ref_sde).items() if k.isupper()
                    and isinstance(v, str) and v.startswith("PARSEC::")}
    assert declared == ref_declared and documented == declared
    rng = np.random.default_rng(5)
    M = rng.standard_normal((64, 64))
    mod = SDEModule()
    ctx = _ctx()
    unregister = register_context_gauges(ctx)
    try:
        A = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float64).from_array(
            M @ M.T + 64 * np.eye(64))
        tp = cholesky_ptg(use_cuda=False).taskpool(NT=A.mt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        missing = documented - set(sde.list_counters())
        assert not missing, missing
        assert sde.read(sde.TASKS_RETIRED) == 20
        assert sde.read(sde.DEVICE_TASKS_EXECUTED) == 20
        assert sde.read(sde.COMM_EAGER_HIT_RATE) == 1.0  # comm-less
        from parsec_tpu_torch.array import counters as array_counters

        live = array_counters()
        assert sde.read(sde.ARRAY_PROGRAMS_LOWERED) == live["programs_lowered"]
        assert sde.read(sde.ARRAY_CLASSES_GENERATED) == live["classes_generated"]
        assert sde.read(sde.ARRAY_TASKPOOLS_BUILT) == live["taskpools_built"]
    finally:
        unregister()
        mod.disable()
        ctx.fini()


def test_operations_doc_names_the_live_plane_rows():
    text = open(OPS_MD).read()
    for row in ("serve_max_inflight_pools", "serve_max_ready_backlog", "serve_arena_budget",
                "serve_max_queued", "serve_slo_p95_ms", "profiling_fr_events",
                "runtime_watchdog_window", "parsec_tenant_retired_total",
                "parsec_serve_jobs_queued", "parsec_tenant_weight",
                "parsec_job_latency_seconds", "parsec_job_queue_delay_seconds",
                "parsec_task_exec_seconds", "parsec_slo_violations_total",
                "parsec_straggler_ranks", "OBS008", "OBS009", "OBS010",
                "serve-status", "tools top", "flightdump", "PARSEC_TPU_HEALTH",
                "PARSEC_TPU_WATCHDOG", "PARSEC_TPU_FLIGHT", "PARSEC_TPU_SLO"):
        assert row in text, f"OPERATIONS.md misses {row}"


def test_prometheus_line_rendering_matches_the_reference():
    for labels, value in (({"rank": 0}, 3), ({"rank": 1, "x": 'a"b'}, 2.5),
                          ({}, float("nan")), ({"t": "w\\x"}, 2 ** 60), ({"a": 1}, "n/a")):
        port, ref = [], []
        health._line(port, "parsec_x", labels, value)
        ref_health._line(ref, "parsec_x", labels, value)
        assert port == ref


def test_dictionary_snapshot_survives_poisoned_getter(clean_sde):
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        raise RuntimeError("boom")

    dictionary.register_property("test.poisoned", poisoned)
    dictionary.register_property("test.fine", lambda: 42)
    try:
        for s in (dictionary.snapshot(), dictionary.snapshot()):
            assert s["test.fine"] == 42
            assert s["test.poisoned"].startswith("<error: RuntimeError")
        assert calls["n"] == 2
    finally:
        dictionary.unregister_property("test.poisoned")
        dictionary.unregister_property("test.fine")


def test_serve_status_cli_renders_tenant_table(clean_sde, capsys):
    with RuntimeService(nb_cores=2, cuda_device="cpu") as sv:
        hs = HealthServer(sv.context).start()
        gate = threading.Event()
        gate.set()
        for i in range(2):
            assert sv.submit("acme", _gated_job(f"j{i}", gate)[0]).wait(timeout=60)
        rc = tools.main(["serve-status", hs.url])
        out = capsys.readouterr().out
        assert rc == 0
        assert "acme" in out and "done" in out
        assert "scheduler=wdrr fairness=on" in out
        hs.stop()
    ctx = _ctx()
    hs = HealthServer(ctx).start()
    try:
        assert tools.main(["serve-status", hs.url]) == 1
        assert "no serving plane" in capsys.readouterr().err
    finally:
        hs.stop()
        ctx.fini()


def test_serve_status_cli_renders_unknown_eta_as_dashes(capsys):
    import http.server

    doc = {"rank": 0, "serve": {
        "closing": False, "fairness": True, "scheduler": "wdrr",
        "limits": {"max_inflight_pools": 4, "max_ready_backlog": 0,
                   "arena_budget": None, "max_queued": 64},
        "jobs": {"inflight": 1, "queued": 0, "done": 0, "failed": 0,
                 "cancelled": 0, "rejected": 0, "expired": 0},
        "tenants": {
            "stuck": {"weight": 1, "inflight": 1, "queued": 0, "completed": 0,
                      "failed": 0, "rejected": 0, "retired": 0,
                      "rate_tasks_per_s": 0.0, "eta_s": float("inf")},
            "idle": {"weight": 1, "inflight": 0, "queued": 0, "completed": 0,
                     "failed": 0, "rejected": 0, "retired": 0,
                     "rate_tasks_per_s": 0.0, "eta_s": None}}}}

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert tools.main(["serve-status", f"http://127.0.0.1:{srv.server_port}"]) == 0
        rows = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.strip().startswith(("stuck", "idle"))]
        assert len(rows) == 2
        for ln in rows:
            assert ln.rstrip().endswith("--") and "inf" not in ln
    finally:
        srv.shutdown()
        srv.server_close()


def test_monitor_polls_http_status(clean_sde):
    from parsec_tpu_torch.profiling.monitor import main as monitor_main

    ctx = _ctx()
    hs = HealthServer(ctx).start()
    try:
        gate = threading.Event()
        gate.set()
        tp, _ = _gated_job("m", gate, n=4)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = monitor_main([hs.url, "--follow", "--interval", "0.05", "--max-updates", "2"])
        assert rc == 0
        out = buf.getvalue()
        assert "scheduler.ready_tasks" in out and "2 samples" in out
    finally:
        hs.stop()
        ctx.fini()


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def test_obs_codes_registered_like_the_reference():
    from parsec_tpu.analysis.findings import CODES as REF_CODES

    for code in ("OBS001", "OBS002", "OBS003", "OBS004", "OBS005", "OBS006",
                 "OBS007", "OBS008", "OBS009", "OBS010", "OBS011"):
        assert code in CODES and CODES[code][0] == REF_CODES[code][0], code


def test_watchdog_no_false_positive_on_healthy_run():
    ctx = _ctx()
    wd = Watchdog(ctx, window=10.0, poll=0.1, strict=True).start()
    ctx.watchdog = wd
    try:
        gate = threading.Event()
        gate.set()
        tp, _ = _gated_job("chain", gate, n=12)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
        assert not wd.stalled and wd.last_report is None
        assert wd.status()["stalled"] is False
        # an idle context has nothing to diagnose
        assert wd.diagnose().errors == []
    finally:
        wd.stop()
        ctx.fini()


def test_watchdog_diagnoses_and_fails_a_wedged_pool_strict():
    """A pool wedged in its first body: the strict watchdog fires after
    its window (the on_stall event), names the stall and the wedged
    tenant-less pool, fails the pool with the report, and /healthz turns
    503 while stalled."""
    ctx = _ctx()
    fired = threading.Event()
    wd = Watchdog(ctx, window=0.5, poll=0.1, strict=True,
                  on_stall=lambda rep: fired.set()).start()
    ctx.watchdog = wd
    hs = HealthServer(ctx).start()
    gate, entered = threading.Event(), threading.Event()
    try:
        tp, _ = _gated_job("wedged", gate, n=4, entered=entered)
        ctx.add_taskpool(tp)
        ctx.start()
        assert entered.wait(timeout=30)
        assert fired.wait(timeout=30), "the watchdog never fired"
        assert wd.stalled
        codes = {f.code for f in wd.last_report.findings}
        assert "OBS001" in codes
        assert "wedged" in wd.last_report.render()
        assert not tp.wait(timeout=30)
        assert "watchdog" in tp.fail_reason
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(hs.url + "/healthz")
        assert err.value.code == 503
        assert json.loads(err.value.read())["stalled"] is True
    finally:
        gate.set()
        hs.stop()
        wd.stop()
        ctx.fini()


def test_watchdog_obs008_names_stalled_tenant(clean_sde):
    with RuntimeService(nb_cores=2, cuda_device="cpu") as sv:
        fired = threading.Event()
        wd = Watchdog(sv.context, window=0.6, poll=0.1,
                      on_stall=lambda rep: fired.set()).start()
        sv.context.watchdog = wd
        gate, entered = threading.Event(), threading.Event()
        tp, _ = _gated_job("stuckjob", gate, entered=entered)
        h = sv.submit("victim-tenant", tp, priority=3)
        try:
            assert entered.wait(timeout=30)
            assert fired.wait(timeout=30), "the watchdog never fired on the wedged job"
            rep = wd.last_report
            obs8 = [f for f in rep.findings if f.code == "OBS008"]
            assert len(obs8) == 1 and obs8[0].task == "victim-tenant"
            assert "stuckjob" in obs8[0].message and "job priority 3" in obs8[0].message
            assert "0/5 tasks retired" in obs8[0].message
        finally:
            gate.set()
        assert h.wait(timeout=60)
        wd.stop()


def test_obs008_message_matches_the_reference():
    """The same wedged tenant job diagnosed on demand by each package:
    the OBS008 finding's text (pool ids aside) and severity agree."""
    msgs = {}
    for name in ("port", "ref"):
        sv = RuntimeService(nb_cores=2, cuda_device="cpu") if name == "port" \
            else RefService(nb_cores=2)
        W = Watchdog if name == "port" else ref_health.Watchdog
        wd = W(sv.context, window=60.0, poll=30.0).start()
        gate, entered = threading.Event(), threading.Event()
        try:
            sv.tenant("acme", weight=2)
            h = sv.submit("acme", _gated_job("stuck", gate, entered=entered,
                                             ref=name == "ref")[0], priority=1)
            assert entered.wait(timeout=30)
            f = [f for f in wd.diagnose().findings if f.code == "OBS008"]
            assert len(f) == 1
            msgs[name] = (re.sub(r"#\d+", "#", f[0].message), f[0].task, f[0].severity)
        finally:
            gate.set()
            wd.stop()
        assert h.wait(timeout=60)
        sv.close(timeout=30)
    assert msgs["port"] == msgs["ref"]


def test_diagnose_on_demand_names_pending_counters():
    gate, entered = threading.Event(), threading.Event()
    ctx = _ctx()
    wd = Watchdog(ctx, window=60.0, poll=30.0).start()
    try:
        tp, _ = _gated_job("gated", gate, n=4, entered=entered)
        ctx.add_taskpool(tp)
        ctx.start()
        assert entered.wait(timeout=30)
        rep = wd.diagnose()
        assert any(f.code == "OBS001" for f in rep.findings)
        assert "gated" in rep.render()
        assert "window 60s" in rep.render()
        gate.set()
        assert tp.wait(timeout=30)
    finally:
        gate.set()
        wd.stop()
        ctx.fini()


def test_watchdog_takes_a_comm_engine_channel():
    """A watchdog on a 2-rank context registers its heartbeat and re-sync
    ops on the engine's ``TAG_CTL`` multiplexer, as the reference's does,
    and ``stop()`` takes exactly those two ops back off it."""
    from parsec_tpu import Context as RefContext
    from parsec_tpu import comm as ref_comm
    from parsec_tpu_torch import comm

    for Ctx, fab, kw in ((parsec_tpu_torch.Context, comm.InprocFabric, {"devices": ["cpu"]}),
                         (RefContext, ref_comm.InprocFabric, {})):
        ces = fab(2).endpoints()
        ctx = Ctx(nb_cores=1, rank=1, nranks=2, comm=ces[1], **kw)
        try:
            before = set(getattr(ces[1], "_ctl_ops", {}) or {})
            wd = (Watchdog if Ctx is not RefContext else ref_health.Watchdog)(
                ctx, window=60.0, poll=30.0)
            assert {"hb", "clk2"} <= set(ces[1]._ctl_ops) - before
            assert wd.last_heard == {} and wd.clock_sync is None
            wd.stop()
            assert set(ces[1]._ctl_ops) == before
        finally:
            ctx.fini()
