"""The port's binary tracer (parsec_tpu_torch.profiling.binary over
parsec_tpu_torch.native.NativeTracer) against the JAX package's.

* the ``.pbt`` format: a dump written by either package's
  :class:`BinaryTrace` reads back equal through both readers, field for
  field, and the Chrome-event views are equal;
* the reference's tracer tests (round trip, one stream per thread, a
  dump concurrent with logging, the task profiler read by the tools);
* a traced dpotrf: an ``exec`` pair for every task, and its ``dep_edge``
  set — mapped through each token's task to (class, locals) names —
  equal to the reference's on the same DAG, on the dynamic path and on
  the native pump (where it is the captured DAG's every edge);
* the runtime hooks: the pump's trace edges join the exec spans' tokens
  (critpath walks the DAG's longest path, fused regions included), the
  legacy protocol's device tasks get exec spans, the staging pipeline's
  lane and committer spans, and a ``compile`` span on a cold
  ``GraphExecutor`` capture, none on a program-cache hit;
* ENG006's reader leg: the reader's record dtype against the ABI spec.
"""

import collections
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import native_exec as ref_native_exec  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.profiling import binary as ref_binary  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import native_exec  # noqa: E402
from parsec_tpu_torch.dsl.graph import capture  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.dsl.ptg import INOUT, PTG  # noqa: E402
from parsec_tpu_torch.native import NativeTracer, abi  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402
from parsec_tpu_torch.profiling import binary, critpath, pins  # noqa: E402
from parsec_tpu_torch.profiling.tools import main as tools_main  # noqa: E402

N, NB = 256, 64  # dpotrf at test size: NT = 4, 20 tasks


@pytest.fixture
def port_param():
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def _write_sample(mod, path):
    """Two threads, every record phase, a clock offset: one dump."""
    t = mod.BinaryTrace(rank=2)
    k_a, k_b = t.keyword("alpha"), t.keyword("beta")
    t.clock_offset_ns = 12345

    def work(base):
        t.begin(k_a, event_id=base)
        t.instant(k_b, event_id=base + 1, info=(1 << 40) + base)
        t.counter(k_b, base * 3)
        t.end(k_a, event_id=base)

    th = threading.Thread(target=work, args=(100,), name="second")
    th.start()
    th.join()
    work(7)
    assert t.dump(path) == 8
    t.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pbt_reads_back_equal_through_both_readers(tmp_path, writer):
    """Either package's dump is the same format: both readers give the
    same events, field for field, and the same Chrome view and sidecar."""
    path = str(tmp_path / "t.pbt")
    _write_sample(binary if writer == "port" else ref_binary, path)
    with open(path, "rb") as f:
        assert f.read(8) == binary.MAGIC == ref_binary.MAGIC
    mine, ref = binary.read_pbt(path), ref_binary.read_pbt(path)
    assert mine == ref and len(mine) == 8
    assert {e["tid"] for e in mine} == {"second", "MainThread"}
    assert binary.to_chrome_events(path) == ref_binary.to_chrome_events(path)
    assert binary.read_pbt_meta(path) == ref_binary.read_pbt_meta(path)
    assert binary.read_pbt_meta(path)["clock_offset_ns"] == 12345
    assert binary._RECORD_DTYPE == ref_binary._RECORD_DTYPE
    assert binary._RECORD_DTYPE.itemsize == 40


def test_roundtrip(tmp_path):
    t = binary.BinaryTrace(rank=3)
    k_a, k_b = t.keyword("alpha"), t.keyword("beta")
    assert t.keyword("alpha") == k_a  # stable ids
    t.begin(k_a, event_id=7)
    t.end(k_a, event_id=7)
    t.instant(k_b, event_id=42, info=99)
    t.counter(k_b, 123)
    path = str(tmp_path / "t.pbt")
    assert t.dump(path) == 4
    evs = binary.read_pbt(path)
    assert [e["ph"] for e in evs] == ["B", "E", "i", "C"]
    assert evs[0]["name"] == "alpha" and evs[0]["pid"] == 3
    assert evs[2]["args"] == {"event_id": 42, "info": 99}
    assert evs[1]["ts"] >= evs[0]["ts"]  # monotonic within a stream
    assert binary.to_chrome_events(path)[3]["args"] == {"value": 123}
    t.close()


def test_multithreaded_streams(tmp_path):
    t = binary.BinaryTrace()
    k = t.keyword("work")
    n, nt = 500, 4

    def worker():
        for i in range(n):
            t.instant(k, event_id=i)

    threads = [threading.Thread(target=worker) for _ in range(nt)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.total_events == n * nt
    path = str(tmp_path / "mt.pbt")
    assert t.dump(path) == n * nt
    evs = binary.read_pbt(path)
    assert len({e["tid"] for e in evs}) == nt  # one stream per thread
    t.close()


def test_dump_concurrent_with_logging(tmp_path):
    """dump() while workers log: the header count matches the records in
    the file (a consistent prefix), crossing block boundaries."""
    t = binary.BinaryTrace()
    k = t.keyword("w")
    stop = threading.Event()

    def worker():
        i = 0
        while not stop.is_set():
            t.instant(k, event_id=i)
            i += 1

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for th in threads:
        th.start()
    try:
        for round_ in range(3):
            while t.total_events < (round_ + 1) * 6000:
                pass
            path = str(tmp_path / f"c{round_}.pbt")
            n = t.dump(path)
            evs = binary.read_pbt(path)
            assert len(evs) == n
            per = {}
            for e in evs:
                per.setdefault(e["tid"], []).append(e["args"]["event_id"])
            for ids in per.values():
                assert ids == list(range(len(ids)))
    finally:
        stop.set()
        for th in threads:
            th.join()
    t.close()


def test_tracer_failures_raise(tmp_path):
    """No quiet loss: an unwritable dump raises, a dump after close()
    raises, and a log after close() writes nothing."""
    t = binary.BinaryTrace()
    k = t.keyword("x")
    t.instant(k)
    with pytest.raises(OSError):
        t.dump(str(tmp_path / "missing_dir" / "t.pbt"))
    t.close()
    t.instant(k)  # a straggler logger after close: no effect
    with pytest.raises(OSError, match="closed"):
        t.dump(str(tmp_path / "t.pbt"))
    nt = NativeTracer()
    assert nt.total_events == 0
    nt.close()
    assert nt.total_events == 0


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_a_rank_set_routes_each_rank_to_its_own_trace(pkg, tmp_path):
    """``RankTraceSet(nranks=2)`` over a 2-rank round-robin chain: every
    rank's exec spans land in ITS dump (the tasks it owns), the comm
    sites' instants and transport spans too, and both packages record the
    same per-rank event counts for the protocol's deterministic events."""
    from test_torch_multirank import PORT, REF, run_ranks

    P = PORT if pkg == "port" else REF
    bmod = binary if pkg == "port" else ref_binary
    K, nranks = 6, 2

    def build(r, ctx):
        dc = P["LC"]("D", shape=(4,), nodes=nranks, myrank=r,
                     init=lambda k: np.zeros(4))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        g = P["ptg"].PTG("chain")
        step = g.task_class("step", k=f"0 .. {K - 1}")
        step.affinity("D(k)")
        step.flow("X", P["ptg"].INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
                  f"-> (k < {K - 1}) ? X step(k+1) : D(k)")
        step.body(cpu=lambda X, k: X.__iadd__(1.0))
        return g.taskpool(D=dc)

    ts = bmod.RankTraceSet(nranks).install()
    try:
        run_ranks(P, nranks, build)
    finally:
        ts.uninstall()
    paths = ts.dump(str(tmp_path))
    ts.close()
    assert [p.rsplit("/", 1)[1] for p in paths] == ["rank0.pbt", "rank1.pbt"]
    counts = []
    for r, p in enumerate(paths):
        evs = bmod.to_chrome_events(p)
        assert {e["pid"] for e in evs} == {r}
        c = collections.Counter((e["name"], e["ph"]) for e in evs)
        # step(k) on rank k % 2: three exec spans a rank
        assert c[("exec", "B")] == c[("exec", "E")] == K // nranks
        counts.append({k: c[k] for k in (("comm_send", "i"), ("comm_recv", "i"),
                                         ("ce_send", "B"), ("ce_recv", "B"))})
    # every hop but the last crosses ranks: one activation sent, one
    # payload landed a hop, split by the rank that fired it
    assert sum(c[("comm_send", "i")] for c in counts) == K - 1
    assert sum(c[("comm_recv", "i")] for c in counts) == K - 1
    assert all(c[("ce_send", "B")] > 0 and c[("ce_recv", "B")] > 0 for c in counts)


def _chain_pool(n=10):
    dc = LocalCollection("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = PTG("chain")
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", INOUT,
              "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")
    step.body(cpu=lambda X, k: X.__iadd__(1.0))
    return ptg.taskpool(N=n, D=dc)


def test_binary_task_profiler_and_tools(tmp_path, capsys):
    prof = binary.BinaryTaskProfiler()
    try:
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
            tp = _chain_pool()
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
        path = str(tmp_path / "task.pbt")
        assert prof.trace.dump(path) >= 60  # 10 tasks x 3 span pairs
    finally:
        prof.uninstall()
    assert tools_main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "exec" in out and "complete_exec" in out
    out_csv = tmp_path / "spans.csv"
    assert tools_main(["to-csv", path, "-o", str(out_csv)]) == 0
    lines = out_csv.read_text().strip().split("\n")
    assert sum(1 for ln in lines if ln.startswith("exec,")) == 10


# ---------------------------------------------------------------------------
# traced dpotrf: exec spans and dependency edges against the reference
# ---------------------------------------------------------------------------

def _traced(bmod, pmod, run, path):
    """Run ``run()`` under a RankTraceSet of ``bmod``; returns (events,
    token -> (class, locals)) — each token's task as its EXEC_END saw it."""
    names = {}

    def name_of(es, task):
        names[task.prof["pbt_token"]] = (task.task_class.name,
                                         tuple(getattr(task, "locals", ())))

    ts = bmod.RankTraceSet(1).install()
    pmod.subscribe(pmod.EXEC_END, name_of)
    try:
        run()
    finally:
        pmod.unsubscribe(pmod.EXEC_END, name_of)
        ts.uninstall()
    p = ts.dump(str(path))[0]
    ts.close()
    return bmod.read_pbt(p), names


def _edges(evs, names):
    return sorted((names[e["args"]["event_id"]], names[e["args"]["info"]])
                  for e in evs if e["name"] == "dep_edge")


def _exec_counts(evs):
    c = collections.Counter(e["ph"] for e in evs if e["name"] == "exec")
    return c["B"], c["E"]


def _dag(tp):
    """The captured DAG's edges as (class, locals) pairs, and its longest
    path in tasks."""
    g = capture(tp, ranks=[0])
    edges = sorted(((t[0], tuple(t[1])), (s[0], tuple(s[1])))
                   for t, n in g.nodes.items() for (_f, s, _sf) in n.out_edges if s != t)
    indeg = {t: 0 for t in g.nodes}
    for _a, b in edges:
        indeg[(b[0], b[1])] += 1
    depth = {t: 1 for t in g.nodes}
    ready = [t for t, d in indeg.items() if d == 0]
    while ready:
        t = ready.pop()
        for (_f, s, _sf) in g.nodes[t].out_edges:
            if s == t:
                continue
            depth[s] = max(depth[s], depth[t] + 1)
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    return edges, max(depth.values()), len(g.nodes)


def _ref_dynamic():
    A = RefTiledMatrix(N, N, NB, NB, name="A").from_array(_spd(N))
    with parsec_tpu.Context(nb_cores=1, devices=["cpu"]) as ctx:
        tp = ref_cholesky_ptg(use_tpu=False, use_cpu=True).taskpool(NT=A.mt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)


def _port_dynamic():
    A = TiledMatrix(N, N, NB, NB, name="A").from_array(_spd(N))
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)


def _ref_pump():
    A = RefTiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(
        _spd(N).astype(np.float32))
    tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False).taskpool(NT=A.mt, A=A)
    ref_mca_param.params.set("device", "tpu_wave_batch", 0)
    try:
        ref_native_exec.run_native(tp, native_device=True)
    finally:
        ref_mca_param.params.unset("device", "tpu_wave_batch")


def _port_pool(dtype=np.float32, seed=0, n=N):
    A = TiledMatrix(n, n, NB, NB, name="A", dtype=dtype).from_array(
        _spd(n, seed).astype(dtype))
    return cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
        NT=A.mt, A=A), A


def _port_pump():
    tp, _ = _port_pool()
    ex = NativeExecutor(tp, native_device=True)
    try:
        assert ex._pump
        ex.run()
    finally:
        ex.close()


@pytest.mark.parametrize("path", ["dynamic", "pump"])
def test_traced_dpotrf_edges_equal_the_reference(tmp_path, port_param, path):
    """An exec pair for every task; the dep_edge set, named by each
    token's task, equal to the reference's.  On the dynamic path an edge
    is a release (one a successor: its last predecessor), on the pump
    every edge of the captured DAG, published once before the run."""
    port_param("device", "cuda_torch_device", "cpu")
    runs = {"dynamic": (_ref_dynamic, _port_dynamic), "pump": (_ref_pump, _port_pump)}
    ref_run, port_run = runs[path]
    rev, rnames = _traced(ref_binary, ref_pins, ref_run, tmp_path / "ref")
    pev, pnames = _traced(binary, pins, port_run, tmp_path / "port")
    dag_edges, _, ntasks = _dag(_port_pool()[0])
    assert _exec_counts(pev) == _exec_counts(rev) == (ntasks, ntasks)
    mine, ref = _edges(pev, pnames), _edges(rev, rnames)
    assert mine == ref
    assert set(mine) <= set(dag_edges)
    if path == "pump":
        assert mine == dag_edges
    else:
        assert len(mine) == ntasks - 1  # one source
        assert len({b for _a, b in mine}) == ntasks - 1


def test_dynamic_trace_on_the_cuda_module(tmp_path, port_param):
    """The dynamic path on the CUDA module bound to the torch CPU device
    (synchronous streams, the manager thread firing the exec pins): an
    exec pair for every task, every release edge a DAG edge, and
    critpath's chain a path of release edges from the source to the last
    task, its wall attributed.  Which predecessor releases a task is the
    schedule's, so the chain is the DAG's longest path only when every
    release on it came from a longest-path predecessor: it is never
    longer."""
    tp, A = _port_pool()
    dag_edges, longest, ntasks = _dag(_port_pool()[0])

    def run():
        with parsec_tpu_torch.Context(nb_cores=4, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)

    evs, names = _traced(binary, pins, run, tmp_path)
    assert _exec_counts(evs) == (ntasks, ntasks)
    edges = _edges(evs, names)
    assert len(edges) == ntasks - 1 and set(edges) <= set(dag_edges)
    rep = critpath.analyze(evs)
    chain = [names[r["token"]] for r in rep["chain"]]
    assert chain[0] == ("potrf", (0,)) and chain[-1] == ("potrf", (A.mt - 1,))
    assert all(pair in set(edges) for pair in zip(chain, chain[1:]))
    assert 1 < rep["n_tasks"] <= longest
    assert rep["coverage"] == pytest.approx(1.0)
    L = np.tril(A.to_array())
    np.testing.assert_allclose(L @ L.T, _spd(N), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("fusion", ["off", "auto"])
def test_pump_trace_edges_join_the_exec_tokens(tmp_path, port_param, fusion):
    """The pump's one pre-run edge pass fires with the objects its EXEC
    pins fire with: critpath's chain over the dump is the DAG's longest
    path (fused: no longer than it, the regions reported as dispatch
    saved), and the factor is the untraced run's."""
    port_param("device", "cuda_torch_device", "cpu")
    tp, A = _port_pool()
    ex = NativeExecutor(tp, native_device=True, fusion=fusion)
    try:
        ex.run()
    finally:
        ex.close()
    want = A.to_array()
    tp, A = _port_pool()
    dag_edges, longest, ntasks = _dag(tp)
    ex = NativeExecutor(tp, native_device=True, fusion=fusion)

    def run():
        try:
            ex.run()
        finally:
            ex.close()

    evs, names = _traced(binary, pins, run, tmp_path)
    np.testing.assert_array_equal(A.to_array(), want)
    rep = critpath.analyze(evs)
    nodes = len(ex._bodies)
    assert _exec_counts(evs) == (nodes, nodes)
    if fusion == "off":
        assert _edges(evs, names) == dag_edges
        assert rep["n_tasks"] == longest
    else:
        assert ex._regions and nodes < ntasks
        assert 1 < rep["n_tasks"] <= longest
        assert rep["fused"]["regions"] == len(ex._regions)
        assert rep["fused"]["tasks"] == sum(len(r.members) for r in ex._regions)


def test_pump_publishes_no_edges_untraced(port_param, monkeypatch):
    """Nothing observes RELEASE_DEPS_END: the pump's edge pass is skipped."""
    port_param("device", "cuda_torch_device", "cpu")
    calls = []
    monkeypatch.setattr(NativeExecutor, "_emit_trace_edges",
                        lambda self: calls.append(self))
    tp, _ = _port_pool()
    native_exec.run_native(tp, native_device=True)
    assert calls == []


def test_legacy_protocol_device_tasks_get_exec_spans(tmp_path, port_param):
    """The legacy ASYNC protocol: the CUDA module fires each device task's
    exec pair around its submit on the manager thread (no scheduling core
    wraps the native trampoline's hand-off)."""
    port_param("device", "cuda_torch_device", "cpu")
    port_param("runtime", "native_sched", "off")
    tp, A = _port_pool()
    _, _, ntasks = _dag(tp)
    prof = binary.BinaryTaskProfiler()
    try:
        ex = NativeExecutor(tp, native_device=True)
        try:
            assert not ex._pump
            ex.run()
        finally:
            ex.close()
        path = str(tmp_path / "legacy.pbt")
        prof.trace.dump(path)
    finally:
        prof.uninstall()
        prof.trace.close()
    evs = binary.read_pbt(path)
    assert _exec_counts(evs) == (ntasks, ntasks)
    toks = collections.Counter(e["args"]["event_id"] for e in evs
                               if e["name"] == "exec" and e["ph"] == "B")
    assert len(toks) == ntasks and set(toks.values()) == {1}
    assert ex.stats["completion_callbacks"] == ntasks


def test_depth2_pump_records_lane_and_committer_spans(tmp_path, port_param, monkeypatch):
    """Stage depth 2 with the lane engaged: ``stage_in`` spans from the
    transfer lane's own stream, ``writeback`` spans from the committer's
    flush at close, hb instants for both, and hbcheck finds nothing."""
    from parsec_tpu_torch.analysis import hb
    from parsec_tpu_torch.device import staging

    stop_after_chunk = staging._StageJob.wait

    def wait_for_the_lane(job):
        job.done.wait(timeout=60)
        stop_after_chunk(job)

    monkeypatch.setattr(staging._StageJob, "wait", wait_for_the_lane)
    port_param("runtime", "stage_split_kb", 0)
    port_param("device", "cuda_torch_device", "cpu")
    port_param("runtime", "stage_depth", 2)
    tp, _ = _port_pool(n=512)
    ex = NativeExecutor(tp, native_device=True)

    def run():
        try:
            ex.run()
        finally:
            ex.close()

    evs, _ = _traced(binary, pins, run, tmp_path)
    assert ex.stats["prefetched_batches"] > 0
    c = collections.Counter((e["name"], e["ph"]) for e in evs)
    for name in ("stage_in", "writeback"):
        assert c[(name, "B")] == c[(name, "E")] > 0, c
    for name in ("hb_stage_in", "hb_wb_enqueue", "hb_wb_commit"):
        assert c[(name, "i")] > 0, c
    lane = {e["tid"] for e in evs if e["name"] == "stage_in"}
    assert lane and lane.isdisjoint({e["tid"] for e in evs if e["name"] == "exec"})
    assert hb.analyze_trace(str(tmp_path / "rank0.pbt")) == []


def test_graph_executor_fires_a_compile_span_on_a_cold_capture_only(monkeypatch):
    """A GraphExecutor capture that misses the program cache is one
    COMPILE_BEGIN/END pair with the reference's payload keys and the job of
    the span open on its thread (0: none); a same-shaped executor that hits
    the cache fires nothing.  The card's capture is stubbed (the torch CPU
    device cannot capture a CUDA graph)."""
    import torch

    from parsec_tpu_torch import compile_cache
    from parsec_tpu_torch.device import cuda as cuda_mod
    from parsec_tpu_torch.dsl import GraphExecutor

    class _Stream:
        def __init__(self, *a, **k):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a, **k: 0)
    monkeypatch.setattr(cuda_mod, "capture_graph", lambda fn, stream: (None, [], 0))
    monkeypatch.setattr(GraphExecutor, "_warm_up", lambda self, ins, stream: ins)
    monkeypatch.setattr(compile_cache, "_default_cache", compile_cache.ProgramCache())
    seen = []
    sub_b = lambda es, p: seen.append(("B", p))  # noqa: E731
    sub_e = lambda es, p: seen.append(("E", p))  # noqa: E731
    pins.subscribe(pins.COMPILE_BEGIN, sub_b)
    pins.subscribe(pins.COMPILE_END, sub_e)
    try:
        cold = GraphExecutor(_port_pool(seed=0)[0], device="cpu")
        cold._build([torch.ones(2)])
        assert not cold.cache_hit
        assert [ph for ph, _ in seen] == ["B", "E"]
        (_, b), (_, e) = seen
        assert list(b) == ["rank", "fp", "key", "trace", "job"]
        assert list(e) == ["rank", "fp", "key", "trace", "job", "kind", "seconds"]
        assert b["job"] == 0
        assert e["kind"] == "miss" and b["fp"] == e["fp"] and e["seconds"] >= 0
        hit = GraphExecutor(_port_pool(seed=1)[0], device="cpu")
        hit._build([torch.ones(2)])
        assert hit.cache_hit and len(seen) == 2
    finally:
        pins.unsubscribe(pins.COMPILE_BEGIN, sub_b)
        pins.unsubscribe(pins.COMPILE_END, sub_e)


def test_compile_spans_land_in_the_compile_bucket(tmp_path):
    """RankTraceSet records the COMPILE pins as ``compile`` spans whose
    end carries the resolution kind (0 = miss), and critpath attributes a
    gap under one to the compile bucket."""
    ts = binary.RankTraceSet(1).install()
    try:
        payload = {"rank": 0, "fp": "ab" * 16, "key": "graph:x", "trace": 0}
        pins.fire(pins.COMPILE_BEGIN, None, dict(payload))
        pins.fire(pins.COMPILE_END, None, dict(payload, kind="miss", seconds=0.1))
    finally:
        ts.uninstall()
    p = ts.dump(str(tmp_path))[0]
    ts.close()
    evs = [e for e in binary.read_pbt(p) if e["name"] == "compile"]
    assert [e["ph"] for e in evs] == ["B", "E"]
    assert evs[0]["args"]["event_id"] == int(("ab" * 16)[:15], 16)
    assert evs[1]["args"]["info"] == 0


# ---------------------------------------------------------------------------
# ENG006: the .pbt reader's record layout
# ---------------------------------------------------------------------------

def test_eng006_reader_leg_is_clean_on_the_tree():
    assert abi._record_layout_findings() == []
    assert [f.code for f in abi.abi_findings()] == []


def test_eng006_flags_a_reader_with_a_field_moved():
    fields = [(n, binary._RECORD_DTYPE[n].str) for n in binary._RECORD_DTYPE.names]
    fields.insert(1, fields.pop(4))  # ts_ns moved ahead of keyword
    moved = np.dtype(fields)
    assert moved.itemsize == binary._RECORD_DTYPE.itemsize
    findings = abi._record_layout_findings(record_dtype=moved)
    assert [f.code for f in findings] == ["ENG006"]
    assert "profiling.binary reads" in findings[0].message
