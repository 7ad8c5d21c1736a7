"""The port's cross-rank readers against the JAX package's: per-rank
traces, the clock handshake and re-sync, the multi-rank merge, per-rank
overlap and critpath, ``check-comms``, the watchdog and the health plane
on a comm context, ``run_multirank_perf`` and the distributed segmented
Cholesky.

Pairs with ``tests/profiling/test_merge.py``, ``test_clock_resync.py``,
``test_overlap.py``, ``test_check_comms.py``, ``test_watchdog.py`` and
``test_health.py``'s 2-rank scrape, and with
``tests/runtime/test_segmented_chol_dist.py``.  Host arithmetic done in
the same order (the offset interpolation, the piecewise merge, critpath's
buckets, the comm-protocol byte counts) is compared bit for bit; a
measured clock offset is held within half its round trip plus
``ALIGN_TOLERANCE_US``.  No case depends on the wall-clock order of
events across ranks (the reference's merge round trip does, and races).
"""

import collections
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import parsec_tpu.comm.termdet_fourcounter  # noqa: E402,F401  (registers the component)
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import multirank as ref_multirank  # noqa: E402
from parsec_tpu.analysis import schedules as ref_schedules  # noqa: E402
from parsec_tpu.ops import segmented_chol_dist as ref_scd  # noqa: E402
from parsec_tpu.profiling import critpath as ref_critpath  # noqa: E402
from parsec_tpu.profiling import health as ref_health  # noqa: E402
from parsec_tpu.profiling import merge as ref_merge  # noqa: E402
from parsec_tpu.profiling import trace as ref_trace  # noqa: E402
from parsec_tpu.profiling.tools import main as ref_tools  # noqa: E402
from parsec_tpu_torch import comm, mca_param, multirank  # noqa: E402
from parsec_tpu_torch.analysis import schedules  # noqa: E402
from parsec_tpu_torch.analysis.findings import CODES  # noqa: E402
from parsec_tpu_torch.ops import segmented_chol_dist as scd  # noqa: E402
from parsec_tpu_torch.profiling import critpath, health, merge, sde  # noqa: E402
from parsec_tpu_torch.profiling import trace as port_trace  # noqa: E402
from parsec_tpu_torch.profiling.tools import main as tools  # noqa: E402

from test_torch_critpath import seeded_events  # noqa: E402
from test_torch_dtd_multirank import PORT as DTD_PORT  # noqa: E402
from test_torch_dtd_multirank import REF as DTD_REF  # noqa: E402
from test_torch_dtd_multirank import run_dtd_ranks  # noqa: E402
from test_torch_multirank import PORT, REF, host, run_ranks  # noqa: E402

BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
MERGES = pytest.mark.parametrize("mg", [merge, ref_merge], ids=["port", "ref"])


@pytest.fixture(autouse=True)
def clean_sync():
    for mg in (merge, ref_merge):
        mg.reset_sync_points()
    yield
    for mg in (merge, ref_merge):
        mg.reset_sync_points()


def _mr(P):
    return multirank if P is PORT else ref_multirank


def _kw(P):
    return dict(P["ctx_kw"])


# ---------------------------------------------------------------------------
# tests/profiling/test_clock_resync.py: the estimator and the store
# ---------------------------------------------------------------------------

@MERGES
def test_offset_interpolation_piecewise_linear(mg):
    pts = [(0, 0), (1_000_000_000, 1000), (2_000_000_000, 3000)]
    assert mg._offset_at(pts, -5) == 0
    assert mg._offset_at(pts, 500_000_000) == 500
    assert mg._offset_at(pts, 1_500_000_000) == 2000
    assert mg._offset_at(pts, 3_000_000_000) == 5000  # the last drift, extrapolated
    assert mg._offset_at([], 123) == 0.0
    assert mg._offset_at([(10, 7)], 999) == 7.0
    rng = np.random.default_rng(5)
    many = sorted((int(t), int(o)) for t, o in zip(rng.integers(0, 10**12, 9),
                                                   rng.integers(-10**6, 10**6, 9)))
    for t in rng.integers(-10**11, 2 * 10**12, 50):
        assert merge._offset_at(many, float(t)) == ref_merge._offset_at(many, float(t))


@MERGES
def test_record_sync_point_store_roundtrip(mg):
    mg.record_sync_point(2, 100, 5)
    mg.record_sync_point(2, 50, 3)
    assert mg.sync_points_for(2) == [(50, 3), (100, 5)]
    mg.reset_sync_points_for(2)
    assert mg.sync_points_for(2) == [] and mg.sync_points_for(0) == []


def _write_trace(tmpdir, rank, events, epoch_ns, clock_sync=None, clock_offset_ns=0):
    meta = {"rank": rank, "epoch_ns": epoch_ns, "clock_offset_ns": clock_offset_ns}
    if clock_sync is not None:
        meta["clock_sync"] = clock_sync
    path = f"{tmpdir}/rank{rank}.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "metadata": meta}, f)
    return path


def test_merge_applies_piecewise_drift_correction(tmp_path):
    """Rank 1's clock runs 0.1% fast and 500 us ahead (injected sync
    samples bracket the run): events simultaneous in true time land within
    1 us of each other, and both packages merge to the same document."""
    epoch = 1_000_000_000
    r0 = [{"name": "tick", "ph": "i", "ts": float(t), "pid": 0, "tid": "w",
           "args": {"event_id": i}} for i, t in enumerate((0, 1000, 2000))]

    def local_us(true_us):
        return true_us * 1.001 + 500.0

    r1 = [{"name": "tick", "ph": "i", "ts": local_us(t), "pid": 1, "tid": "w",
           "args": {"event_id": i}} for i, t in enumerate((0, 1000, 2000))]
    sync = [(int(epoch + local_us(t) * 1e3), int((local_us(t) - t) * 1e3))
            for t in (0.0, 2000.0)]
    p0 = _write_trace(tmp_path, 0, r0, epoch)
    p1 = _write_trace(tmp_path, 1, r1, epoch, clock_sync=sync)
    doc = merge.merge_traces([p0, p1], jobs=False)
    assert doc == ref_merge.merge_traces([p0, p1], jobs=False)
    by = collections.defaultdict(dict)
    for e in doc["traceEvents"]:
        if e.get("name") == "tick":
            by[e["args"]["event_id"]][e["pid"]] = e["ts"]
    for i in range(3):
        assert by[i][1] == pytest.approx(by[i][0], abs=1.0), (i, by[i])


def test_merge_without_sync_keeps_constant_offset(tmp_path):
    epoch = 5_000_000
    p0 = _write_trace(tmp_path, 0, [{"name": "tick", "ph": "i", "ts": 100.0, "pid": 0,
                                     "tid": "w", "args": {}}], epoch)
    p1 = _write_trace(tmp_path, 1, [{"name": "tick", "ph": "i", "ts": 150.0, "pid": 1,
                                     "tid": "w", "args": {}}], epoch, clock_offset_ns=50_000)
    doc = merge.merge_traces([p0, p1], jobs=False)
    assert doc == ref_merge.merge_traces([p0, p1], jobs=False)
    ts = {e["pid"]: e["ts"] for e in doc["traceEvents"] if e.get("name") == "tick"}
    assert ts[1] - ts[0] == pytest.approx(0.0, abs=1e-6)


# ---------------------------------------------------------------------------
# the live re-sync, heartbeats and the healthy watched run
# ---------------------------------------------------------------------------

def _dpotrf_build(P, nranks, n=32, nb=8, grid=(2, 1), out=None):
    S = np.random.default_rng(7).standard_normal((n, n))
    S = S @ S.T + n * np.eye(n)

    def build(r, ctx):
        A = P["BC"](n, n, nb, nb, p=grid[0], q=grid[1], myrank=r, name="A")
        A.from_array(S)
        if out is not None:
            out[r] = A
        return P["chol"]().taskpool(NT=A.mt, A=A)

    return build, S


def _wait_for(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_watchdog_resync_records_samples_and_rtt():
    """Two ranks, each watched, nobody else progressing the fabric: the
    watchdogs' own ticks carry the ping/pong, rank 1 records re-sync
    samples (offset within half the round trip of 0: one shared clock),
    the SLO plane's ``comm_rtt`` histogram fills, and rank 0 never pings
    itself."""
    from parsec_tpu_torch.profiling.slo import SloPlane

    mca_param.set_param("runtime", "clock_resync_interval", 0.05)
    ces = comm.InprocFabric(2).endpoints()
    ctxs = [parsec_tpu_torch.Context(nb_cores=1, rank=r, nranks=2, comm=ces[r],
                                     devices=["cpu"]) for r in range(2)]
    slos = [SloPlane(ctx) for ctx in ctxs]
    for ctx, sp in zip(ctxs, slos):
        ctx.slo = sp
    wds = [health.Watchdog(ctx, window=3600.0, poll=0.05).start() for ctx in ctxs]
    try:
        assert _wait_for(lambda: len(merge.sync_points_for(1)) >= 2
                         and wds[1].clock_sync is not None)
        pts = merge.sync_points_for(1)
        samples = list(wds[1].resync_samples)
        assert len(samples) >= 2
        for s in samples:
            assert s["rtt_ns"] > 0
            assert abs(s["offset_ns"]) <= s["rtt_ns"] / 2 + merge.ALIGN_TOLERANCE_US * 1e3
        assert [(s["t_ns"], s["offset_ns"]) for s in samples] == pts[:len(samples)]
        cs = wds[1].clock_sync
        assert "drift_ns_per_s" in cs and cs["rtt_ns"] > 0
        assert slos[1].hist("comm_rtt", ()).count >= 1
        assert wds[0].clock_sync is None and wds[0].resync_samples == []
        assert wds[0].status()["clock_sync"] is None
        assert _wait_for(lambda: wds[0].heartbeats.get(1, 0) >= 1
                         and wds[1].heartbeats.get(0, 0) >= 1)
    finally:
        for wd in wds:
            wd.stop()
        for sp in slos:
            sp.uninstall()
        for ctx in ctxs:
            ctx.fini()
        mca_param.unset("runtime", "clock_resync_interval")


def test_watched_healthy_multirank_run_has_no_findings():
    """A strict watchdog on each rank of a 4-rank dpotrf, the window from
    ``runtime_watchdog_window`` (its default, 30 s: six xdist workers'
    CPU contention cannot reach it): the run ends with no stall and no
    report, every rank hears every peer, ranks 1-3 each record a re-sync
    sample, and an on-demand diagnosis names no silent rank."""
    nranks = 4
    build, _S = _dpotrf_build(PORT, nranks, n=64, nb=16, grid=(2, 2))
    wds = {}
    ces = comm.InprocFabric(nranks).endpoints()
    ctxs = [parsec_tpu_torch.Context(nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                                     devices=["cpu"]) for r in range(nranks)]
    try:
        for r in range(nranks):
            wds[r] = health.Watchdog(ctxs[r], poll=0.05, strict=True).start()
        assert wds[0].window == 30.0
        oks = [None] * nranks

        def worker(r):
            tp = build(r, ctxs[r])
            ctxs[r].add_taskpool(tp)
            oks[r] = tp.wait(timeout=120)

        ts = [threading.Thread(target=worker, args=(r,)) for r in range(nranks)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(150)
        assert oks == [True] * nranks
        assert _wait_for(lambda: all(
            all(wds[r].heartbeats.get(p, 0) >= 1 for p in range(nranks) if p != r)
            and (r == 0 or len(wds[r].resync_samples) >= 1) for r in range(nranks)))
        for r in range(nranks):
            assert not wds[r].stalled and wds[r].last_report is None
            assert not any(f.code == "OBS004" for f in wds[r].diagnose().findings)
    finally:
        for wd in wds.values():
            wd.stop()
        for c in ctxs:
            c.fini()


def _wedged_pair(mod_schedules, Context, ctx_kw):
    fabric = mod_schedules.ExplorerFabric(2, seed=3, delay_prob=0.0, max_delay=0)
    # wedge: every frame toward rank 1 defers for ~forever
    import random

    fabric.inboxes[1] = mod_schedules._PerturbedInbox(
        random.Random(0), delay_prob=1.0, max_delay=1 << 30)
    ces = fabric.endpoints()
    return [Context(nb_cores=2, rank=r, nranks=2, comm=ces[r], **ctx_kw)
            for r in range(2)]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_watchdog_diagnoses_a_wedged_mesh(pkg):
    """Rank 1's inbound delivery wedged on a 2-rank dpotrf: both pools
    stall.  Report-only watchdogs (no rank fails the other's pool before it
    reports, the race of the reference's strict test) each fire once: the
    reports name the stall (OBS001), the blocked dpotrf dep counters
    (OBS002) and, on rank 1, the silent rank 0 (OBS004); the same codes on
    both packages."""
    P = PORT if pkg == "port" else REF
    Wd = health.Watchdog if pkg == "port" else ref_health.Watchdog
    ctxs = _wedged_pair(schedules if pkg == "port" else ref_schedules,
                        P["Context"], _kw(P))
    fired = [threading.Event(), threading.Event()]
    wds = [Wd(ctx, window=1.0, poll=0.1, on_stall=lambda rep, r=r: fired[r].set()).start()
           for r, ctx in enumerate(ctxs)]
    build, _S = _dpotrf_build(P, 2)
    pools = [build(r, ctxs[r]) for r in range(2)]
    ts = [threading.Thread(target=lambda r=r: (ctxs[r].add_taskpool(pools[r]),
                                               pools[r].wait(timeout=60)))
          for r in range(2)]
    try:
        for t in ts:
            t.start()
        assert all(ev.wait(60) for ev in fired)
        codes = [{f.code for f in wd.last_report.findings} for wd in wds]
        assert all("OBS001" in c for c in codes)
        dep = [f for wd in wds for f in wd.last_report.findings if f.code == "OBS002"]
        assert dep and any(f.task in ("potrf", "trsm", "syrk", "gemm") for f in dep)
        assert "OBS004" in codes[1]
    finally:
        from parsec_tpu.comm import remote_dep as ref_rd
        from parsec_tpu_torch.comm import remote_dep as port_rd

        for tp in pools:
            (port_rd if P is PORT else ref_rd)._fail_pool(tp, "test teardown")
        for t in ts:
            t.join(60)
        for wd in wds:
            wd.stop()
        for ctx in ctxs:
            ctx.fini()


def test_strict_watchdog_fails_the_wedged_pools_on_every_rank():
    """Strict mode on the wedged pair: both ``wait()`` calls return False
    well inside their timeout — whichever rank reports first fails its
    pool here and, through the abort broadcast, on the peer — and every
    fail reason names the watchdog."""
    ctxs = _wedged_pair(schedules, parsec_tpu_torch.Context, _kw(PORT))
    wds = [health.Watchdog(ctx, window=1.0, poll=0.1, strict=True).start()
           for ctx in ctxs]
    build, _S = _dpotrf_build(PORT, 2)
    pools = [build(r, ctxs[r]) for r in range(2)]
    oks = [None, None]
    try:
        def worker(r):
            ctxs[r].add_taskpool(pools[r])
            oks[r] = pools[r].wait(timeout=60)

        ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join(90)
        assert oks == [False, False] and time.monotonic() - t0 < 60
        assert all("watchdog" in (tp.fail_reason or "") for tp in pools)
        assert any(wd.last_report is not None for wd in wds)
    finally:
        for wd in wds:
            wd.stop()
        for ctx in ctxs:
            ctx.fini()


def test_obs_codes_registered_and_obs007_waits():
    for code in ("OBS001", "OBS002", "OBS003", "OBS004", "OBS005", "OBS006", "OBS007"):
        assert code in CODES


@BOTH
def test_diagnose_names_fourcounter_and_rendezvous(P):
    """Mid-run on a gated 2-rank fourcounter pool: the diagnosis carries
    the fourcounter's local state (OBS005) and, with rendezvous pulls in
    flight, OBS003 with their count — the reference's messages."""
    gate = threading.Event()
    ces = P["comm"].InprocFabric(2).endpoints()
    ctxs = [P["Context"](nb_cores=2, rank=r, nranks=2, comm=ces[r], **_kw(P))
            for r in range(2)]
    Wd = health.Watchdog if P is PORT else ref_health.Watchdog
    pools = []
    try:
        for r, ctx in enumerate(ctxs):
            dc = P["LC"]("D", shape=(1,), nodes=2, myrank=r, init=lambda k: np.zeros(1))
            dc.rank_of = lambda *key: dc.data_key(*key) % 2
            g = P["ptg"].PTG("gated4c")
            step = g.task_class("step", k="0 .. 3")
            step.affinity("D(k)")
            step.flow("X", P["ptg"].INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
                      "-> (k < 3) ? X step(k+1) : D(k)")
            step.body(cpu=lambda X, k: gate.wait(60) and None)
            tp = g.taskpool(D=dc, termdet="fourcounter")
            ctx.add_taskpool(tp)
            pools.append(tp)
        wd = Wd(ctxs[0], window=60.0, poll=30.0)
        rd = ctxs[0].comm.remote_dep
        orig = rd.rdv_pulls_in_flight
        rd.rdv_pulls_in_flight = lambda: 2
        try:
            rep = wd.diagnose()
        finally:
            rd.rdv_pulls_in_flight = orig
        by = {f.code: f for f in rep.findings}
        assert "OBS005" in by and by["OBS005"].message.startswith("fourcounter: local busy=")
        assert "OBS003" in by and by["OBS003"].count == 2
        assert by["OBS003"].message.startswith("rank 0: 2 rendezvous pull(s) in flight")
        wd.stop()
        gate.set()

        def finish(r):
            assert ctxs[r].wait(timeout=60)

        ts = [threading.Thread(target=finish, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(90)
        assert all(tp.is_done() for tp in pools)
    finally:
        gate.set()
        for ctx in ctxs:
            ctx.fini()


# ---------------------------------------------------------------------------
# tests/profiling/test_health.py: the comm summary, /metrics, the SDE gauges
# ---------------------------------------------------------------------------

@BOTH
def test_comm_summary_after_a_run(P):
    """After a 2x2 dpotrf of host tiles, each rank's comm summary counts
    its engine's wire bytes (active-message payloads plus the fabric's
    pulls) with no rendezvous pull left in flight, and the port's SDE
    ``PARSEC::COMM::*`` gauges read that summary."""
    build, _S = _dpotrf_build(P, 4, n=64, nb=16, grid=(2, 2))
    ctxs = run_ranks(P, 4, build)
    summ = [(health if P is PORT else ref_health)._comm_summary(c) for c in ctxs]
    for c, s in zip(ctxs, summ):
        st = c.comm.stats
        assert s["wire_bytes"] == int(st.get("am_bytes", 0)) + int(st.get("get_bytes", 0))
        assert s["rdv_pulls_inflight"] == 0 and 0.0 <= s["eager_hit_rate"] <= 1.0
    if P is PORT:
        sde.reset()
        try:
            health.register_context_gauges(ctxs[0])
            health.register_context_gauges(ctxs[1])
            assert sde.read(sde.COMM_WIRE_BYTES) == summ[0]["wire_bytes"] > 0
            assert sde.read("PARSEC::RANK1::COMM::WIRE_BYTES") == summ[1]["wire_bytes"] > 0
            assert sde.read(sde.COMM_RDV_PULLS_INFLIGHT) == 0
            assert sde.read(sde.COMM_EAGER_HIT_RATE) == summ[0]["eager_hit_rate"]
        finally:
            sde.reset()


def test_comm_summary_matches_between_packages():
    """The protocol's counters of the same 2x2 dpotrf on both packages,
    run in this test (not left to the order the parametrized cases ran)."""
    out = {}
    for P in (REF, PORT):
        build, _S = _dpotrf_build(P, 4, n=64, nb=16, grid=(2, 2))
        ctxs = run_ranks(P, 4, build)
        hmod = health if P is PORT else ref_health
        out[P["name"]] = [{k: v for k, v in hmod._comm_summary(c).items()}
                          for c in ctxs]
    assert out["port"] == out["ref"]
    assert health._comm_summary(parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"])) is None


class _OwnRank(PORT["LC"]):
    def rank_of(self, *key) -> int:
        return self.myrank


def test_metrics_scrape_live_2rank_mesh():
    """``/metrics`` on a live 2-rank mesh (each rank's first task gated):
    valid Prometheus text, rank-labelled, carrying the ``parsec_comm_*``
    families; ``/status`` carries the comm summary.  The reference's
    2-rank scrape case."""
    ces = comm.InprocFabric(2).endpoints()
    ctxs = [parsec_tpu_torch.Context(nb_cores=2, rank=r, nranks=2, comm=ces[r],
                                     devices=["cpu"]) for r in range(2)]
    servers = [health.HealthServer(ctx).start() for ctx in ctxs]
    gate = threading.Event()
    try:
        pools = []
        for r, ctx in enumerate(ctxs):
            dc = _OwnRank("D", shape=(1,), init=lambda k: np.zeros(1), nodes=2, myrank=r)
            g = PORT["ptg"].PTG("gated")
            step = g.task_class("step", k="0 .. N-1")
            step.affinity("D(0)")
            step.flow("X", PORT["ptg"].INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
                      "-> (k < N-1) ? X step(k+1) : D(0)")
            step.body(cpu=lambda X, k: (gate.wait(60) if k == 0 else None, X.__iadd__(1.0))[1])
            tp = g.taskpool(N=6, D=dc)
            ctx.add_taskpool(tp)
            pools.append(tp)
        for r, hs in enumerate(servers):
            text = urllib.request.urlopen(hs.url + "/metrics", timeout=10).read().decode()
            for fam in ("parsec_comm_wire_bytes_total", "parsec_comm_frames_sent_total",
                        "parsec_comm_eager_hit_rate", "parsec_comm_rdv_pulls_inflight",
                        "parsec_comm_eager_bytes_total", "parsec_comm_rdv_bytes_total"):
                assert f'{fam}{{rank="{r}"}}' in text, fam
            st = json.loads(urllib.request.urlopen(hs.url + "/status", timeout=10).read())
            assert st["rank"] == r and st["nranks"] == 2 and st["comm"] is not None
        gate.set()
        for tp in pools:
            assert tp.wait(timeout=60)
    finally:
        gate.set()
        for hs in servers:
            hs.stop()
        for ctx in ctxs:
            ctx.fini()


# ---------------------------------------------------------------------------
# run_multirank_perf and the multi-rank merge (tests/profiling/test_merge.py)
# ---------------------------------------------------------------------------

def _chain_build(P, nranks):
    K = 4 * nranks

    def build(r, ctx):
        web = P["ptg"].PTG("merge_chain")
        tc = web.task_class("t", k=f"0 .. {K - 1}")
        tc.affinity("D(k)")
        tc.flow("A", P["ptg"].INOUT, "<- (k == 0) ? D(k) : A t(k-1)",
                f"-> (k == {K - 1}) ? D(k) : A t(k+1)")

        def body(A, k):
            np.dot(np.ones((48, 48)), np.ones((48, 48)))

        tc.body(cpu=body)
        dc = P["LC"]("D", shape=(K, 4), dtype=np.float64, nodes=nranks, myrank=r)
        dc.rank_of = lambda k: k % nranks
        return web.taskpool(D=dc), dc

    return build


#: trace events the protocol fires a fixed number of times per run
_DETERMINISTIC = ("exec", "comm_send", "comm_recv", "comm_recv_eager", "jobwire_send",
                  "jobwire_eager", "dep_edge")


@BOTH
def test_multirank_trace_merge_roundtrip(P, tmp_path):
    _roundtrip(P, tmp_path)


def _roundtrip(P, tmp_path):
    """4 ranks through ``run_multirank_perf(overlap=True, trace_dir=)``:
    one ``rank<r>.pbt`` a rank, a merged trace with one track a rank,
    every rank's exec spans on its own track, handshake offsets within
    half their round trip of 0 (one shared clock), the per-rank overlap
    populated — and the protocol's event counts per rank the same on both
    packages."""
    nranks = 4
    _users, stats = _mr(P).run_multirank_perf(
        nranks, _chain_build(P, nranks), overlap=True, trace_dir=str(tmp_path),
        timeout=120, **_kw(P))
    assert stats["executed_tasks"] == 4 * nranks
    assert stats["trace_ranks"] == nranks
    assert len(stats["overlap_per_rank"]) == nranks
    assert 0.0 <= stats["overlap_min"] <= stats["overlap_fraction"] <= 1.0
    assert sorted(p.name for p in tmp_path.glob("rank*.pbt")) == [
        f"rank{r}.pbt" for r in range(nranks)]
    with open(stats["merged_trace"]) as f:
        doc = json.load(f)
    assert doc["metadata"]["aligned"] is True
    assert doc["metadata"]["ranks"] == list(range(nranks))
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M" and e["pid"] < nranks]
    counts = collections.Counter((e["pid"], e["name"], e["ph"]) for e in evs
                                 if e["name"] in _DETERMINISTIC)
    for r in range(nranks):
        assert counts[(r, "exec", "B")] == counts[(r, "exec", "E")] == 4
    names = {e["name"] for e in evs}
    assert {"select", "ce_send", "ce_recv", "comm_send", "comm_recv"} <= names
    if P is PORT:
        assert stats["clock_offsets_ns"][0] == 0
        for r in range(1, nranks):
            rtt = stats["handshake_rtt_ns"][r]
            assert 0 < rtt and abs(stats["clock_offsets_ns"][r]) <= (
                rtt / 2 + merge.ALIGN_TOLERANCE_US * 1e3)
        assert all(t is not None and 0 < t <= stats["wall_s"] for t in stats["rank_wall_s"])
    return counts


def test_multirank_trace_counts_match_between_packages(tmp_path):
    """The protocol's per-rank event counts of the 4-rank chain — exec
    spans, activations sent, payloads landed, their job-wire instants,
    dependency edges — are the same on both packages."""
    got = [_roundtrip(P, tmp_path / P["name"]) for P in (REF, PORT)]
    assert got[0] == got[1]


@BOTH
def test_run_multirank_perf_stats_and_factor(P):
    _perf_run(P)


def _perf_run(P):
    """A 2x2 dpotrf of host tiles through the harness: the factor is the
    same on both packages bit for bit (the same numpy bodies in the same
    order), and so are the run's executed tasks, activations, wire bytes
    and protocol split."""
    mats = {}
    build, S = _dpotrf_build(P, 4, n=64, nb=16, grid=(2, 2), out=mats)
    users, stats = _mr(P).run_multirank_perf(
        4, lambda r, ctx: (build(r, ctx), r), flops=64**3 / 3, **_kw(P))
    assert users == [0, 1, 2, 3]
    out = np.zeros((64, 64))
    for A in mats.values():
        for (i, j) in A.local_tiles():
            out[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16] = host(
                A.data_of(i, j).newest_copy().payload)
    assert np.abs(np.tril(out) @ np.tril(out).T - S).max() < 1e-9 * np.abs(S).max()
    row = {k: stats[k] for k in ("executed_tasks", "activations", "wire_bytes",
                                 "eager_hit_rate", "bytes_d2d")}
    row["wire"] = dict(stats["wire"])
    # gflops is round(flops / wall / 1e9, 3) in both packages: exact
    # whatever the wall, where "> 0" failed on a wall over ~0.175 s
    assert stats["wall_s"] > 0
    assert stats["gflops"] == round(64**3 / 3 / stats["wall_s"] / 1e9, 3)
    return row, np.tril(out)


def test_run_multirank_perf_matches_between_packages():
    (row_ref, L_ref), (row, L) = (_perf_run(P) for P in (REF, PORT))
    assert row == row_ref
    assert np.array_equal(L, L_ref)


@BOTH
def test_run_multirank_perf_raises_after_fini_on_a_rank_error(P):
    """A rank whose build raises: the harness raises after finalizing every
    context (no worker thread left behind)."""
    before = threading.active_count()

    def build(r, ctx):
        if r == 1:
            raise ValueError("injected build failure")
        dc = P["LC"]("D", shape=(1,), nodes=2, myrank=r, init=lambda k: np.zeros(1))
        g = P["ptg"].PTG("one")
        t = g.task_class("t", k="0 .. 0")
        t.affinity("D(0)")
        t.flow("X", P["ptg"].INOUT, "<- D(0)", "-> D(0)")
        t.body(cpu=lambda X, k: None)
        return g.taskpool(D=dc), dc

    with pytest.raises(RuntimeError, match="injected build failure"):
        _mr(P).run_multirank_perf(2, build, timeout=10, **_kw(P))
    assert _wait_for(lambda: threading.active_count() <= before, timeout=10)


# ---------------------------------------------------------------------------
# critpath on each rank track
# ---------------------------------------------------------------------------

def test_analyze_ranks_is_the_reference_analyze_on_each_track():
    """``analyze_ranks`` on a seeded 3-track trace equals the reference's
    ``analyze`` run on each track's events alone, bucket for bucket (the
    same host arithmetic in the same order)."""
    evs = seeded_events(11)
    per = critpath.analyze_ranks(evs)
    assert sorted(per) == [0, 1, 2]
    for pid, rep in per.items():
        theirs = ref_critpath.analyze([e for e in evs if e.get("pid") == pid])
        assert {k: rep[k] for k in ("wall_us", "n_tasks", "coverage", "buckets")} == \
            {k: theirs[k] for k in ("wall_us", "n_tasks", "coverage", "buckets")}


def test_rank_window_split_known_answer(capsys, tmp_path):
    """One rank: exec 0-100 and 200-300, a transport span 80-150 (50 us of
    it outside exec), window 0-300: exec 200, comm 50, rest 50; a compile
    span 120-160 adds only its 10 us outside both; the CLI's
    ``--per-rank`` prints the split."""
    def span(name, b, e, tok, tid):
        return [{"name": name, "ph": ph, "ts": ts, "pid": 0, "tid": tid,
                 "args": {"event_id": tok}} for ph, ts in (("B", b), ("E", e))]

    evs = (span("exec", 0.0, 100.0, 1, "w0") + span("exec", 200.0, 300.0, 2, "w0")
           + span("ce_recv", 80.0, 150.0, 0, "comm")
           + [{"name": "dep_edge", "ph": "i", "ts": 100.0, "pid": 0, "tid": "w0",
               "args": {"event_id": 1, "info": 2}}])
    w = critpath.analyze_ranks(evs)[0]["window"]
    assert w == {"window_us": 300.0, "exec_us": 200.0, "comm_us": 50.0,
                 "coll_us": 0.0, "compile_us": 0.0, "transfer_us": 0.0,
                 "rest_us": 50.0, "exec_spans": 2}
    # a compile span under the transport one and past it: only its 10 us
    # beyond both count, and the rest shrinks by as much
    evs += span("compile", 120.0, 160.0, 0, "w1")
    w = critpath.analyze_ranks(evs)[0]["window"]
    assert (w["comm_us"], w["compile_us"], w["rest_us"]) == (50.0, 10.0, 40.0)
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    assert tools(["critpath", str(p), "--per-rank"]) == 0
    out = capsys.readouterr().out
    assert "per rank" in out and "outside exec: comm 0.050" in out


# ---------------------------------------------------------------------------
# tests/profiling/test_check_comms.py
# ---------------------------------------------------------------------------

def _run_bandwidth(P, nflows, length_elems, short_limit):
    """F independent src -> sink transfers of L float64s across 2 ranks
    under the package's CommProfiler; returns its trace."""
    tmod = port_trace if P is PORT else ref_trace
    P["mca"].set_param("runtime", "comm_short_limit", short_limit)
    prof = tmod.CommProfiler(tmod.Trace()).install()
    try:
        def build(rank, ctx):
            dc = P["LC"]("D", shape=(length_elems,), nodes=2, myrank=rank,
                         init=lambda k: np.full(length_elems, 3.0))
            dc.rank_of = lambda *key: 0 if key[0] < nflows else 1
            g = P["ptg"].PTG("bw")
            src = g.task_class("src", f="0 .. F-1")
            src.affinity("D(f)")
            src.flow("X", P["ptg"].INOUT, "<- D(f)", "-> X sink(f)")
            src.body(cpu=lambda X, f: X.__iadd__(1.0))
            sink = g.task_class("sink", f="0 .. F-1")
            sink.affinity("D(F + f)")
            sink.flow("X", P["ptg"].IN, "<- X src(f)")
            sink.body(cpu=lambda X, f: None)
            return g.taskpool(F=nflows, D=dc)

        run_ranks(P, 2, build, timeout=60)
        return prof.trace
    finally:
        prof.uninstall()
        P["mca"].params.unset("runtime", "comm_short_limit")


@BOTH
def test_comm_trace_counts_large_payloads(P):
    F, L = 10, 262144  # 2 MiB payloads through the chunked rendezvous
    P["mca"].set_param("runtime", "comm_rdv_chunk", 512 << 10)
    nchunks = (L * 8) // (512 << 10)
    try:
        df = _run_bandwidth(P, F, L, short_limit=1024).to_dataframe()
    finally:
        P["mca"].params.unset("runtime", "comm_rdv_chunk")
    act = df[df["name"] == "MPI_ACTIVATE"]
    ctl = df[df["name"] == "MPI_DATA_CTL"]
    pld = df[df["name"] == "MPI_DATA_PLD"]
    assert len(act) == F and act["bytes"].sum() == F * 20
    assert len(ctl) == F + F * nchunks
    assert len(pld) == F * nchunks and pld["bytes"].sum() == F * L * 8
    assert set(pld["kind"]) == {"rdv"}
    assert sorted(set(pld["chunk"])) == list(range(nchunks))


@BOTH
def test_comm_trace_counts_inline_payloads(P):
    F, L = 7, 16
    df = _run_bandwidth(P, F, L, short_limit=1 << 16).to_dataframe()
    assert len(df[df["name"] == "MPI_ACTIVATE"]) == F
    assert len(df[df["name"] == "MPI_DATA_CTL"]) == 0
    pld = df[df["name"] == "MPI_DATA_PLD"]
    assert len(pld) == F and pld["bytes"].sum() == F * L * 8
    assert set(pld["kind"]) == {"eager"}


@pytest.mark.parametrize("D", [DTD_REF, DTD_PORT], ids=["ref", "port"])
def test_comm_trace_counts_dtd_channel(D):
    """A cross-rank DTD chain of n hops logs its tile shipments on the
    DTD channel with exact byte sums."""
    tmod = port_trace if D is DTD_PORT else ref_trace
    d = D["dtd"]
    n, W = 8, 32
    prof = tmod.CommProfiler(tmod.Trace()).install()
    try:
        def body(rank, ctx):
            dc = D["LC"]("T", shape=(W,), nodes=2, myrank=rank, init=lambda k: np.zeros(W))
            dc.rank_of = lambda *key: dc.data_key(*key) % 2
            dtd = d.DTDTaskpool(ctx, name="chain")
            for k in range(n):
                if k == 0:
                    dtd.insert_task(lambda cur: None, (dc.data_of(0), d.INOUT | d.AFFINITY))
                else:
                    def step(prev, cur):
                        cur[:] = prev

                    dtd.insert_task(step, (dc.data_of(k - 1), d.IN),
                                    (dc.data_of(k), d.INOUT | d.AFFINITY))
            dtd.flush_all()
            dtd.close()
            assert ctx.wait(timeout=60)

        run_dtd_ranks(D, 2, body)
        df = prof.trace.to_dataframe()
    finally:
        prof.uninstall()
    act = df[(df["name"] == "MPI_ACTIVATE") & (df["class"] == "dtd")]
    pld = df[df["name"] == "MPI_DATA_PLD"]
    assert len(act) == len(pld) >= n - 1
    assert set(pld["kind"]) == {"eager"}
    assert pld["bytes"].sum() == len(pld) * W * 8


def test_comm_trace_dump_roundtrip_through_check_comms(tmp_path, capsys):
    """Both packages' CommProfiler dumps of the same 3-flow run carry the
    comm dictionary and events; ``check-comms`` on each prints the same
    table as the reference's reader and holds the exact counts."""
    F, L = 3, 16
    outs = []
    for P in (REF, PORT):
        tr = _run_bandwidth(P, F, L, short_limit=1 << 16)
        p = tmp_path / f"comm_{P['name']}.json"
        tr.dump(str(p))
        doc = json.loads(p.read_text())
        assert "MPI_ACTIVATE" in doc["metadata"]["dictionary"]
        assert len(doc["traceEvents"]) >= 2 * F
        expect = ["--expect", f"MPI_ACTIVATE:nb={F}",
                  "--expect", f"MPI_DATA_PLD:lensum={F * L * 8}"]
        assert tools(["check-comms", str(p), *expect]) == 0
        mine = capsys.readouterr().out
        assert ref_tools(["check-comms", str(p), *expect]) == 0
        assert capsys.readouterr().out == mine
        outs.append(mine)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# tests/runtime/test_segmented_chol_dist.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", [{"cuda_device": "cpu"}, {"devices": ["cpu"]}],
                         ids=["cuda_module", "host"])
def test_dist_segmented_cholesky_4ranks(where):
    """N=256, nb=32 over 4 ranks: the reference's bound, err < 1e-3 against
    the float64 factor, every panel and update task executed, the panel
    broadcasts crossing ranks — on the CUDA module (bound to the torch CPU
    device: there ``bytes_d2d`` stays 0; the card's run checks it) and on
    host chores — with the reference's task and activation counts; the
    two errors within 1e-6 of each other (float32 factors, different
    library orders)."""
    err, stats = scd.run_dist_segmented_cholesky(4, 256, 32, **where)
    ref_err, ref_stats = ref_scd.run_dist_segmented_cholesky(4, 256, 32)
    nt = 256 // 32
    assert err < 1e-3 and ref_err < 1e-3
    assert abs(err - ref_err) < 1e-6
    assert stats["executed_tasks"] == ref_stats["executed_tasks"] == nt + nt * (nt - 1) // 2
    assert stats["activations"] == ref_stats["activations"] > 0
    assert stats["gflops"] > 0


def test_dist_segmented_cholesky_ptg_lints_as_the_reference():
    from parsec_tpu.analysis import verify_ptg as ref_verify
    from parsec_tpu_torch.analysis import registry, verify_ptg

    ptg, consts = registry.build("ops.segmented_chol_dist")
    assert [f for f in verify_ptg(ptg, consts) if f.severity != "info"] == []
    ref_ptg = ref_scd.dist_segmented_cholesky_ptg(8, 4)
    assert sorted(ptg.classes) == sorted(ref_ptg.classes) == ["panel", "upd"]
    assert [f for f in ref_verify(ref_ptg, consts) if f.severity != "info"] == []
