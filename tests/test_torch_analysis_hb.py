"""The port's happens-before race checker (parsec_tpu_torch.analysis.hb)
against the JAX package's: its live half and its offline front-end.

The analyzer cases of the reference's ``tests/analysis/test_hbcheck.py``
feed the same synthetic event streams to both packages' analyzers, which
must give the same findings.  The live cases record real runs of both
packages (clean schedules stay clean; seeded races with a guard bypassed
give the same code).  Beyond those: ``PARSEC_TPU_HBCHECK`` on the port's
``Context`` (the dynamic path and the pump at stage depth 2, where the
transfer lane and the write-back committer add their edges, and the
pump's lifecycle-event drain its native decrements), and the offline
front-end over ``.pbt`` dumps of either package (a seeded race gives the
reference's findings; a traced pump run is clean).  Findings of live runs
are compared as (code, severity): their subjects name Python objects.
"""

import collections
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.analysis import hb as ref_hb  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.analysis import LintError, hb  # noqa: E402
from parsec_tpu_torch.analysis.hb import HBEvent, HBRecorder, analyze_events  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import native_exec  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402
from parsec_tpu_torch.profiling import pins  # noqa: E402


def full_key(findings):
    return collections.Counter(
        (f.code, f.severity, f.task, f.flow, f.env, f.dep, f.count)
        for f in findings)


def codes(findings):
    return [(f.code, f.severity) for f in findings]


def _spd(n, dtype=np.float64, seed=0):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(dtype)


@pytest.fixture
def port_param():
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


@pytest.fixture
def live_env(monkeypatch):
    """``PARSEC_TPU_HBCHECK`` for one test: the process-wide recorder it
    installs is removed after the test, so no later test runs observed."""
    def set_(mode="1"):
        monkeypatch.setenv("PARSEC_TPU_HBCHECK", mode)

    monkeypatch.setattr(hb, "_live_reported", set())
    yield set_
    rec = hb.live_recorder()
    if rec is not None:
        rec.uninstall()
    hb._live = None


# ---------------------------------------------------------------------------
# analyzer semantics (synthetic streams, both analyzers)
# ---------------------------------------------------------------------------

STREAMS = {
    "unordered_version_bumps": ([
        (1, "A", "ver_bump", ("data", 5), {"version": 1}),
        (2, "B", "ver_bump", ("data", 5), {"version": 2}),
    ], ["RT001"]),
    "dep_edge_plus_exec_orders_the_writers": ([
        (1, "A", "ver_bump", ("data", 5), {"version": 1}),
        (2, "A", "dep_edge", (10, 11), None),
        (3, "B", "exec_begin", 11, None),
        (4, "B", "ver_bump", ("data", 5), {"version": 2}),
    ], []),
    "task_publish_orders_like_dep_edge": ([
        (1, "A", "ver_bump", ("data", 5), {"version": 1}),
        (2, "A", "task_publish", 11, None),
        (3, "B", "exec_begin", 11, None),
        (4, "B", "ver_bump", ("data", 5), {"version": 2}),
    ], []),
    "frame_send_deliver_orders_across_ranks": ([
        (1, "r0", "ver_bump", ("data", 5), {"version": 1}),
        (2, "r0", "frame_send", 42, None),
        (3, "r1", "frame_deliver", 42, None),
        (4, "r1", "ver_bump", ("data", 5), {"version": 2}),
    ], []),
    "exec_to_complete_handoff": ([
        (1, "W", "ver_bump", ("data", 1), {"version": 1}),
        (2, "W", "exec_end", 7, None),
        (3, "M", "complete_begin", 7, None),
        (4, "M", "ver_bump", ("data", 1), {"version": 2}),
    ], []),
    "deliver_without_send_warns": ([
        (1, "r0", "frame_send", 1, None),
        (2, "r1", "frame_deliver", 1, None),
        (3, "r1", "frame_deliver", 99, None),
    ], ["RT004"]),
    "dep_decrement_chain_carries_all_producers": ([
        (1, "A", "ver_bump", ("data", 1), {"version": 1}),
        (2, "A", "dep_dec", ("t", ("c", (0,))), {"ready": False}),
        (3, "B", "ver_bump", ("data", 2), {"version": 1}),
        (4, "B", "dep_dec", ("t", ("c", (0,))), {"ready": True}),
        (5, "B", "dep_edge", (20, 21), None),
        (6, "C", "exec_begin", 21, None),
        (7, "C", "ver_bump", ("data", 1), {"version": 2}),
        (8, "C", "ver_bump", ("data", 2), {"version": 2}),
    ], []),
    "release_after_fire": ([
        (1, "A", "dep_dec", ("t", ("c", (0,))), {"ready": True}),
        (2, "B", "dep_dec", ("t", ("c", (0,))), {"ready": False}),
    ], ["RT003"]),
    "stage_in_orders_lane_before_exec": ([
        (1, "lane", "ver_bump", ("data", 3), {"version": 1}),
        (2, "lane", "stage_in", 9, None),
        (3, "pump", "exec_begin", 9, None),
        (4, "pump", "ver_bump", ("data", 3), {"version": 2}),
    ], []),
    "wb_commit_joins_its_enqueue": ([
        (1, "pump", "ver_bump", ("data", 4), {"version": 1}),
        (2, "pump", "wb_enqueue", 17, None),
        (3, "committer", "wb_commit", 17, None),
        (4, "committer", "ver_bump", ("data", 4), {"version": 2}),
    ], []),
    "wb_commit_of_another_ticket_races": ([
        (1, "pump", "ver_bump", ("data", 4), {"version": 1}),
        (2, "pump", "wb_enqueue", 17, None),
        (3, "committer", "wb_commit", 18, None),
        (4, "committer", "ver_bump", ("data", 4), {"version": 2}),
    ], ["RT001"]),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_analyzer_matches_the_reference(case):
    events, want = STREAMS[case]
    port = analyze_events([HBEvent(*e) for e in events])
    ref = ref_hb.analyze_events([ref_hb.HBEvent(*e) for e in events])
    assert [f.code for f in port] == want
    assert full_key(port) == full_key(ref)
    if want == ["RT001"]:  # both offending events are named
        first, second = (f"{e[2]}[{e[1]}]#{e[0]}" for e in (events[0], events[-1]))
        assert first in port[0].message and second in port[0].message


# ---------------------------------------------------------------------------
# live recorder on real runtime objects
# ---------------------------------------------------------------------------

def test_live_clean_single_rank_cholesky():
    """The dpotrf on both packages' dynamic path: clean schedules, and
    the port's run goes through the B1 wrapper on the CUDA module bound
    to the torch CPU device."""
    from parsec_tpu.datadist.matrix import TiledMatrix as RefTiledMatrix
    from parsec_tpu.ops.cholesky import cholesky_ptg as ref_cholesky_ptg

    N, nb = 32, 8
    SPD = _spd(N)
    with HBRecorder() as rec:
        A = TiledMatrix(N, N, nb, nb, dtype=np.float32).from_array(
            SPD.astype(np.float32))
        tp = cholesky_ptg(use_kernels=True).taskpool(NT=A.mt, A=A)
        with parsec_tpu_torch.Context(nb_cores=4, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
    with ref_hb.HBRecorder() as ref_rec:
        B = RefTiledMatrix(N, N, nb, nb)
        B.from_array(SPD)
        tp = ref_cholesky_ptg(use_tpu=False).taskpool(NT=B.mt, A=B)
        ctx = parsec_tpu.Context(nb_cores=4, devices=["cpu"])
        try:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
        finally:
            ctx.fini()
    assert rec.analyze() == [] == ref_rec.analyze()
    kinds = collections.Counter(e.kind for e in rec.events)
    for kind in ("exec_begin", "exec_end", "dep_dec", "dep_edge", "ver_bump"):
        assert kinds[kind] > 0, kinds
    np.testing.assert_allclose(np.tril(A.to_array()), np.linalg.cholesky(SPD),
                               atol=1e-4)


def _same_named_threads(P_data_create, Recorder):
    d = P_data_create("k", payload=np.zeros(2))
    d.attach_copy(1, np.zeros(2))
    bar = threading.Barrier(2)

    def bump(dev):
        bar.wait()  # both threads live at once, like two ranks' workers
        d.version_bump(dev)

    with Recorder() as rec:
        ts = [threading.Thread(target=bump, args=(dev,), name="parsec-worker-0")
              for dev in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
    return rec.analyze()


def test_same_named_threads_keep_distinct_clocks():
    from parsec_tpu.data.data import data_create as ref_data_create
    from parsec_tpu_torch.data.data import data_create

    port = _same_named_threads(data_create, HBRecorder)
    ref = _same_named_threads(ref_data_create, ref_hb.HBRecorder)
    assert codes(port) == codes(ref) == [("RT001", "error")]


@pytest.mark.parametrize("releases", [2, 3])
def test_real_dep_tracker_fires_hb_events(releases):
    """Two releases of a goal-2 counter are clean; a third, after the
    counter fired, is the duplicate release RT003 names."""
    from parsec_tpu.core.deps import DepTracker as RefDepTracker
    from parsec_tpu_torch.core.deps import DepTracker

    out = []
    for Tracker, Recorder in ((DepTracker, HBRecorder),
                              (RefDepTracker, ref_hb.HBRecorder)):
        t = Tracker()
        with Recorder() as rec:
            fired = [t.release_counter(("a", (0,)), 2)[0] for _ in range(releases)]
        assert fired[:2] == [False, True]
        assert [e.kind for e in rec.events] == ["dep_dec"] * releases
        out.append(codes(rec.analyze()))
    assert out[0] == out[1] == ([] if releases == 2 else [("RT003", "error")])


def test_task_done_double_complete_guard_disabled_flags_rt005():
    """What a guard-less pz_task_done would emit: both signals accepted."""
    out = []
    for P, Recorder in ((pins, HBRecorder), (ref_pins, ref_hb.HBRecorder)):
        with Recorder() as rec:
            for _ in range(2):
                P.fire(P.NATIVE_TASK_DONE, None,
                       {"graph": 1, "task": 7, "accepted": True})
        fs = rec.analyze()
        assert fs[0].message.count("task_done[MainThread") == 2
        out.append(codes(fs))
    assert out[0] == out[1] == [("RT005", "error")]


def test_task_done_guard_intact_is_clean():
    """The port's g++-built engine: the second signal is refused by the
    atomic claim (accepted=False) and hb-check stays clean."""
    from parsec_tpu_torch import native

    g = native.NativeGraph()
    t0 = g.add_task()
    g.commit(t0)
    g.seal()
    done = []
    ran = threading.Event()
    with HBRecorder() as rec:
        def body(task_id, tag):
            done.append(task_id)
            return True  # ASYNC

        def complete():
            while not done:
                pass
            assert g.task_done(t0) is True
            assert g.task_done(t0) is False  # guard: rejected
            ran.set()

        th = threading.Thread(target=complete)
        th.start()
        g.run_async(body, nthreads=2)
        th.join(timeout=10)
        assert ran.is_set()
    assert rec.analyze() == []
    assert [e.info["accepted"] for e in rec.events if e.kind == "task_done"] \
        == [True, False]
    assert g.double_completes == 1
    g.close()


@pytest.mark.parametrize("bypass", [True, False])
def test_arena_recycle_guard(bypass):
    """Two recycles of one slot with the guard bypassed are RT002, naming
    both events; allocations between releases are clean."""
    from parsec_tpu.data.arena import Arena as RefArena
    from parsec_tpu_torch.data.arena import Arena

    out = []
    for ArenaCls, Recorder in ((Arena, HBRecorder), (RefArena, ref_hb.HBRecorder)):
        ar = ArenaCls((8,), np.float64, name="fixture")
        with Recorder() as rec:
            if bypass:
                c = ar.allocate()
                ar._recycle(c)   # guard intentionally bypassed
                ar._recycle(c)   # the double recycle the guard would refuse
            else:
                for _ in range(3):
                    ar.release(ar.allocate())
        fs = rec.analyze()
        if bypass:
            assert fs[0].message.count("arena_recycle[") == 2
        out.append(codes(fs))
    assert out[0] == out[1] == ([("RT002", "error")] if bypass else [])


def test_offline_front_end_waits_for_the_profiling_layer(tmp_path):
    """The post-hoc front-end reads binary dumps now that the tracer is
    ported: a missing dump raises (no quiet empty analysis), and the
    trace kinds are the reference's."""
    with pytest.raises(FileNotFoundError):
        hb.events_from_trace([str(tmp_path / "rank0.pbt")])
    with pytest.raises(FileNotFoundError):
        hb.analyze_trace(str(tmp_path / "rank0.pbt"))
    assert hb.TRACE_KINDS == ref_hb.TRACE_KINDS
    from parsec_tpu_torch import analysis

    assert analysis.analyze_trace is hb.analyze_trace
    assert analysis.HBRecorder is HBRecorder


def test_frame_sites_are_the_references():
    assert (pins.HB_FRAME_SEND, pins.HB_FRAME_DELIVER) == \
        (ref_pins.HB_FRAME_SEND, ref_pins.HB_FRAME_DELIVER)
    assert pins.HB_FRAME_SEND in pins.ALL_SITES


# ---------------------------------------------------------------------------
# PARSEC_TPU_HBCHECK on the port's Context and the pump
# ---------------------------------------------------------------------------

def _dpotrf_pool(N=64, nb=16, seed=0):
    A = TiledMatrix(N, N, nb, nb, name="A", dtype=np.float32).from_array(
        _spd(N, np.float32, seed))
    return cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
        NT=A.mt, A=A), A


def test_hbcheck_env_reports_at_fini(live_env):
    live_env("1")
    tp, A = _dpotrf_pool()
    with parsec_tpu_torch.Context(nb_cores=4, cuda_device="cpu") as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    assert ctx.hb_findings == []
    assert len(hb.live_recorder().events) > 0
    # a second context reports only what is new since the first
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx2:
        pass
    assert ctx2.hb_findings == []


def test_hbcheck_strict_raises_at_fini_on_a_race(live_env):
    live_env("strict")
    from parsec_tpu_torch.data.data import data_create

    ctx = parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"])
    d = data_create("k", payload=np.zeros(2))
    d.attach_copy(1, np.zeros(2))
    ts = [threading.Thread(target=d.version_bump, args=(dev,)) for dev in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    with pytest.raises(LintError) as ei:
        ctx.fini()
    assert [f.code for f in ei.value.findings] == ["RT001"]


def test_hbcheck_depth2_pump_records_lane_committer_and_drain(
        live_env, port_param, monkeypatch):
    """A checked pump run at stage depth 2 with the transfer lane engaged:
    the prestage, write-back enqueue/commit and the drained native
    decrements, publishes and retires are all recorded, the schedule is
    clean, and the factor is the unchecked run's bit for bit."""
    port_param("device", "cuda_torch_device", "cpu")
    port_param("runtime", "stage_depth", 2)
    monkeypatch.setattr(native_exec, "_STAGE_SPLIT_BYTES", 1)
    tp, A = _dpotrf_pool(N=128, nb=16)
    ex = NativeExecutor(tp, native_device=True)
    try:
        ex.run()
    finally:
        ex.close()
    want = A.to_array()
    live_env("strict")
    rec = hb.ensure_live()
    tp, A = _dpotrf_pool(N=128, nb=16)
    ex = NativeExecutor(tp, native_device=True)
    try:
        ntasks = ex.run()
    finally:
        ex.close()
    assert ex._pump and ex.stats["prefetched_batches"] > 0
    assert ex.stats["events_drained"] > 0
    assert hb.live_report() == []
    kinds = collections.Counter(e.kind for e in rec.events)
    for kind in ("stage_in", "wb_enqueue", "wb_commit", "task_publish",
                 "dep_dec", "task_done", "exec_begin"):
        assert kinds[kind] > 0, kinds
    assert kinds["task_publish"] == kinds["task_done"] == ntasks
    np.testing.assert_array_equal(A.to_array(), want)


def test_pump_drain_feeds_dep_decrement_observers(port_param):
    """The pump's drain republishes every native decrement: one per
    captured edge, the ready flag on each task's last one."""
    port_param("device", "cuda_torch_device", "cpu")
    seen = []
    cb = lambda es, p: seen.append((p["key"], p["ready"]))  # noqa: E731
    pins.subscribe(pins.DEP_DECREMENT, cb)
    try:
        tp, _ = _dpotrf_pool()
        ex = NativeExecutor(tp, native_device=True)
        try:
            ex.run()
            n_edges = sum(len(n.out_edges) for n in ex.graph.nodes.values())
            n_inner = sum(1 for n in ex.graph.nodes.values() if n.in_edges)
        finally:
            ex.close()
    finally:
        pins.unsubscribe(pins.DEP_DECREMENT, cb)
    assert len(seen) == n_edges
    assert sum(r for _, r in seen) == n_inner


# ---------------------------------------------------------------------------
# post-hoc front-end over .pbt dumps (tools hbcheck)
# ---------------------------------------------------------------------------

def _doctored_dump(path, writer, seeded_race):
    """A dump of ``writer``'s BinaryTrace (the JAX package's or the
    port's): hb events of a release, an exec and version commits on
    named threads; with ``seeded_race`` two threads commit one tile with
    no happens-before path between them (RT001)."""
    tr = writer.BinaryTrace(rank=0)
    k = {n: tr.keyword(n) for n in ("hb_ver_bump", "dep_edge", "exec", "hb_dep_dec")}

    def on(name, fn):
        th = threading.Thread(target=fn, name=name)
        th.start()
        th.join()

    def producer():
        tr.begin(k["exec"], 1)
        tr.instant(k["hb_ver_bump"], 5, 1)
        tr.end(k["exec"], 1)
        tr.instant(k["hb_dep_dec"], 77, 1)
        tr.instant(k["dep_edge"], 1, 2)

    def consumer():
        tr.begin(k["exec"], 2)
        tr.instant(k["hb_ver_bump"], 5, 2)
        tr.end(k["exec"], 2)

    on("producer", producer)
    on("consumer", consumer)
    if seeded_race:
        on("rogue", lambda: tr.instant(k["hb_ver_bump"], 5, 3))
    tr.dump(path)
    tr.close()


@pytest.mark.parametrize("seeded_race", [False, True], ids=["clean", "race"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_analyze_trace_over_a_dump_gives_the_references_findings(
        tmp_path, writer, seeded_race, capsys):
    from parsec_tpu.profiling import binary as ref_binary
    from parsec_tpu.profiling.tools import main as ref_tools
    from parsec_tpu_torch.profiling import binary
    from parsec_tpu_torch.profiling.tools import main as tools

    p = str(tmp_path / "rank0.pbt")
    _doctored_dump(p, binary if writer == "port" else ref_binary, seeded_race)
    mine, ref = hb.analyze_trace(p), ref_hb.analyze_trace(p)
    assert full_key(mine) == full_key(ref)
    # the rogue commit is unordered with both ordered commits: two RT001
    assert codes(mine) == ([("RT001", "error")] * 2 if seeded_race else [])
    evs, ref_evs = hb.events_from_trace([p]), ref_hb.events_from_trace([p])
    assert [(e.seq, e.thread, e.kind, e.obj, e.info) for e in evs] == \
        [(e.seq, e.thread, e.kind, e.obj, e.info) for e in ref_evs]
    rc = tools(["hbcheck", p])
    out = capsys.readouterr().out
    assert rc == ref_tools(["hbcheck", p]) == (1 if seeded_race else 0)
    assert out == capsys.readouterr().out


def test_hbcheck_over_a_traced_pump_run_is_clean(tmp_path, port_param):
    """A RankTraceSet over a pump dpotrf: the engine's drained decrements,
    publishes and retires, the exec spans and the trace edges land in the
    dump, and the offline checker finds the schedule clean."""
    from parsec_tpu_torch.profiling.binary import RankTraceSet
    from parsec_tpu_torch.profiling.tools import main as tools

    port_param("device", "cuda_torch_device", "cpu")
    tp, A = _dpotrf_pool(N=128, nb=16)
    ts = RankTraceSet(1).install()
    ex = NativeExecutor(tp, native_device=True)
    try:
        ex.run()
        ex.close()
    finally:
        ts.uninstall()
    paths = ts.dump(str(tmp_path))
    ts.close()
    kinds = collections.Counter(e.kind for e in hb.events_from_trace(paths))
    for kind in ("dep_dec", "task_publish", "task_done", "exec_begin", "dep_edge", "ver_bump"):
        assert kinds[kind] > 0, kinds
    assert hb.analyze_trace(paths) == []
    assert tools(["hbcheck", *paths]) == 0


def test_hbcheck_with_no_events_exits_2(tmp_path):
    from parsec_tpu_torch.profiling.binary import BinaryTrace
    from parsec_tpu_torch.profiling.tools import main as tools

    tr = BinaryTrace(rank=0)
    tr.instant(tr.keyword("unrelated"), 1)
    p = str(tmp_path / "empty.pbt")
    tr.dump(p)
    tr.close()
    assert tools(["hbcheck", p]) == 2
