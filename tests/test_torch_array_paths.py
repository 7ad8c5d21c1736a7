"""Execution paths, serving and observability of the port's array front end
(parsec_tpu_torch.array), against the JAX package's where it has the
same case.

* fusion (the reference's ``tests/array/test_fusion_native.py``): the
  elementwise chain and the mixed program with ``runtime_fusion`` off and
  ``auto`` are bit-identical and fusion engages; ``run_native`` against
  the dynamic path, bit-identical, on the host bodies and through the
  pump on the CUDA module bound to the torch CPU device; a rebuilt
  program's ``GraphExecutor`` (``device="cpu"``) has the first one's
  program digest and cache key — on the card, the program-cache hit;
* redistribute (``tests/array/test_redistribute.py:15-37``): the
  single-rank lazy copy, its composition into one pool, and the
  geometry change through ``datadist.redistribute`` (the rest of that
  file is ``tests/test_torch_redistribute.py``'s);
* serving and observability (``test_serve.py``,
  ``test_array_observability.py``): a tenant job, two tenants
  co-resident, the ``PARSEC::ARRAY::*`` SDE gauges, ``/metrics`` and
  ``/status``, the gauges' rows in OPERATIONS.md, ``label_of("arr_*")``,
  and a traced run's ``array`` row in critpath's ``per_label``;
* the one-rank schedule explorer (``test_explorer.py``) over 4 seeds,
  bit-identical across seeds and right against the numpy factor, and
  at 2 ranks over the perturbed in-process fabric, equal to the JAX
  package's.
"""

import json
import os
import re
import threading
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import array as ref_pa  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import array as pa  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.profiling import sde  # noqa: E402

RUN_LIMIT = 240


def _within(fn, limit=RUN_LIMIT):
    """Run ``fn`` on a daemon thread; fail if it does not return within
    ``limit`` seconds."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the test thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"run did not finish within {limit} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


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
def cpu_device(port_param):
    """Bind every CUDA module a context or the pump makes to the torch
    CPU device."""
    port_param("device", "cuda_torch_device", "cpu")


@pytest.fixture
def clean_sde():
    sde.reset()
    yield
    sde.reset()


def _mixed(seed=13, n=20, nb=8, dtype=np.float64):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)).astype(dtype)
    H = (np.eye(n) * n).astype(dtype)
    rhs = rng.standard_normal((n, 2)).astype(dtype)

    def build(P=pa):
        A = P.from_numpy(G, nb)
        B = P.from_numpy(H, nb)
        b = P.from_numpy(rhs, nb, 2)
        C = (A @ A.T + B).cholesky()
        return C, C.solve(b)

    L = np.linalg.cholesky((G @ G.T + H).astype(np.float64))
    return build, L, np.linalg.solve(L, rhs)


def _ctx(device):
    if device:
        return parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")
    return parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"])


# ---------------------------------------------------------------------------
# fusion, the native pump, the graph executor
# ---------------------------------------------------------------------------

def _chain_arrays(P=pa, dtype=np.float32, n=64, nb=16, seed=5):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)).astype(dtype)
    H = rng.standard_normal((n, n)).astype(dtype)
    A = P.from_numpy(G, nb)
    B = P.from_numpy(H, nb)
    return ((A + B) * 0.5 - B).scale(2.0), G, H


def _run_chain(mode):
    mca_param.set_param("runtime", "fusion", mode)
    out, G, H = _chain_arrays()
    with _ctx(True) as ctx:
        out.compute(ctx, use_cpu=False)
        stats = {k: sum(d.stats.get(k, 0) for d in ctx.devices)
                 for k in ("fused_submits", "fused_tasks", "executed_tasks")}
    return out.to_numpy(), stats, G, H


def test_fused_chain_bit_identical(port_param):
    port_param("runtime", "fusion", "off")
    off, stats_off, G, H = _run_chain("off")
    on, stats_on, _, _ = _run_chain("auto")
    assert np.array_equal(off, on), "fusion changed array numerics"
    assert stats_off["fused_submits"] == 0
    assert stats_on["fused_submits"] > 0
    assert stats_on["fused_tasks"] > stats_on["fused_submits"]
    # the reference's device bodies on JAX's CPU backend, unfused
    ref, _, _ = _chain_arrays(ref_pa)
    with parsec_tpu.Context(nb_cores=2) as ctx:
        ref.compute(ctx, use_cpu=False, use_tpu=True)
    assert np.array_equal(on, ref.to_numpy())
    want = ((G.astype(np.float64) + H) * 0.5 - H) * 2.0
    assert np.abs(on - want).max() <= 4 * np.finfo(np.float32).eps * np.abs(want).max()


@pytest.mark.parametrize("device", [False, True])
def test_fused_mixed_program_bit_identical(port_param, device):
    """The mixed program, fusion off and ``auto``: host bodies (nothing is
    eligible) and device bodies (the elementwise and copy classes fuse)
    stay bit-identical."""
    build, L, _ = _mixed(seed=9, n=24)

    def run(mode):
        port_param("runtime", "fusion", mode)
        C, x = build()
        with _ctx(device) as ctx:
            x.compute(ctx, others=[C], use_cpu=not device, use_cuda=device)
        return C.to_numpy().tobytes(), x.to_numpy().tobytes()

    assert run("off") == run("auto")
    if not device:
        ref_mca_param.params.set("runtime", "fusion", "auto")
        try:
            C, x = build(ref_pa)
            with parsec_tpu.Context(nb_cores=2) as ctx:
                x.compute(ctx, others=[C], use_tpu=False)
        finally:
            ref_mca_param.params.unset("runtime", "fusion")
        assert run("auto") == (C.to_numpy().tobytes(), x.to_numpy().tobytes())


def test_native_engine_matches_dynamic():
    """run_native (host bodies, in place on the native engine's workers)
    is bit-identical to the dynamic runtime and to the JAX package's."""
    build, L, xo = _mixed()
    C1, x1 = build()
    with _ctx(False) as ctx:
        x1.compute(ctx, others=[C1], use_cuda=False)
    C2, x2 = build()
    prog = pa.lower([x2, C2], use_cuda=False)
    _within(lambda: prog.run_native(nthreads=4))
    assert x1.to_numpy().tobytes() == x2.to_numpy().tobytes()
    assert C1.to_numpy().tobytes() == C2.to_numpy().tobytes()
    C3, x3 = build(ref_pa)
    ref_pa.lower([x3, C3], use_tpu=False).run_native(nthreads=4)
    assert x3.to_numpy().tobytes() == x2.to_numpy().tobytes()
    assert np.allclose(x2.to_numpy(), xo, atol=1e-10)


def test_native_pump_matches_dynamic_on_the_cuda_module(cpu_device):
    """``run_native(native_device=True)``: every task through the CUDA
    module driven by the pump, torch.equal to the dynamic path's."""
    build, L, xo = _mixed(dtype=np.float32)
    C1, x1 = build()
    with _ctx(True) as ctx:
        x1.compute(ctx, others=[C1], use_cpu=False)
    C2, x2 = build()
    _within(lambda: pa.lower([x2, C2], use_cpu=False).run_native(native_device=True))
    assert np.array_equal(C1.to_numpy(), C2.to_numpy())
    assert np.array_equal(x1.to_numpy(), x2.to_numpy())
    assert np.allclose(x2.to_numpy(), xo, atol=2e-3)
    assert np.count_nonzero(np.triu(C2.to_numpy(), 1)) == 0


def test_rebuilt_program_keys_into_the_first_programs_graph():
    """A GraphExecutor over a rebuilt same-shaped program has the first
    one's program digest and cache fingerprint — the key of the card's
    program-cache hit — and both give the dynamic path's result."""
    from parsec_tpu_torch.dsl import GraphExecutor

    build, L, xo = _mixed(dtype=np.float32)
    C0, x0 = build()
    with _ctx(True) as ctx:
        x0.compute(ctx, others=[C0], use_cpu=False)
    runs = []
    for _ in range(2):
        C, x = build()
        prog = pa.lower([x, C], use_cpu=False)
        ex = GraphExecutor(prog.taskpool(), device="cpu")
        ex()  # the collections' tiles in, the results attached home
        prog.finalize()
        runs.append((ex, C, x))
    (e1, _, _), (e2, _, _) = runs
    assert e1.program_digest == e2.program_digest
    assert e1.input_keys == e2.input_keys and e1.output_keys == e2.output_keys
    ins = [torch.as_tensor(np.asarray(
        e1.taskpool.constants[c].data_of(*k).newest_copy().payload))
        for c, k in e1.input_keys]
    assert e1._fingerprint(ins) == e2._fingerprint(ins)
    for _ex, C, x in runs:
        assert np.array_equal(C.to_numpy(), C0.to_numpy())
        assert np.array_equal(x.to_numpy(), x0.to_numpy())


# ---------------------------------------------------------------------------
# redistribute
# ---------------------------------------------------------------------------

def test_lazy_redistribute_single_rank_is_copy():
    rng = np.random.default_rng(3)
    G = rng.standard_normal((20, 12))  # ragged under (8, 4)
    A = pa.from_numpy(G, 8, 4)
    R = A.redistribute(pa.BlockCyclic(1, 1))
    assert not R.computed
    with _ctx(False) as ctx:
        R.compute(ctx, use_cuda=False)
    assert np.array_equal(R.to_numpy(), G)


def test_lazy_redistribute_composes_into_one_taskpool():
    rng = np.random.default_rng(5)
    G = rng.standard_normal((16, 16))
    A = pa.from_numpy(G, 4)
    out = A.redistribute(pa.BlockCyclic(1, 1)) + A
    before = pa.counters()["taskpools_built"]
    with _ctx(True) as ctx:
        out.compute(ctx, use_cpu=False)
    assert pa.counters()["taskpools_built"] == before + 1
    assert np.array_equal(out.to_numpy(), 2 * G)


def test_geometry_change_waits_for_the_distributed_layer():
    """A geometry change runs through ``datadist.redistribute`` (the
    shared resolver picks ``dtd`` on one rank): it needs ``context=``,
    computes the source once and returns a computed leaf equal to the
    source, bit for bit, as the reference's does."""
    rng = np.random.default_rng(11)
    G = rng.standard_normal((24, 24))
    A = pa.from_numpy(G, 8)
    with pytest.raises(ValueError, match="needs context"):
        A.redistribute(pa.BlockCyclic(1, 1), mb=6, nb=6)
    with pytest.raises(ValueError, match="positive"):
        A.redistribute(pa.BlockCyclic(1, 1), mb=0)
    with _ctx(False) as ctx:
        R = A.redistribute(pa.BlockCyclic(1, 1), mb=6, nb=6, context=ctx)
    assert R.computed and (R.mb, R.nb) == (6, 6)
    assert np.array_equal(R.to_numpy(), G)
    ref = ref_pa.from_numpy(G, 8)
    with parsec_tpu.Context(nb_cores=2) as rctx:
        RR = ref.redistribute(ref_pa.BlockCyclic(1, 1), mb=6, nb=6, context=rctx)
    assert np.array_equal(R.to_numpy(), RR.to_numpy())


# ---------------------------------------------------------------------------
# serving and observability
# ---------------------------------------------------------------------------

def test_array_program_submits_as_tenant_job():
    from parsec_tpu_torch.serve import RuntimeService

    build, L, xo = _mixed(seed=3, n=16, nb=4)
    with RuntimeService(nb_cores=2, cuda_device="cpu") as sv:
        sv.tenant("arrays", weight=2)
        C, x = build()
        prog = pa.lower([x, C], use_cuda=False)
        tp = prog.taskpool()
        h = sv.submit("arrays", tp, priority=1)
        assert h.wait(timeout=120)
        prog.finalize()
        assert tp.progress()["tenant"] == "arrays"
        assert np.allclose(x.to_numpy(), xo, atol=1e-10)


def test_array_jobs_coexist_with_other_tenants():
    """Two tenants' array programs co-resident, one on the host bodies
    and one on the CUDA module: both match their oracles."""
    from parsec_tpu_torch.serve import RuntimeService

    with RuntimeService(nb_cores=2, cuda_device="cpu") as sv:
        jobs = []
        for i, tenant in enumerate(("acme", "globex")):
            build, L, xo = _mixed(seed=10 + i, n=16, nb=4)
            C, x = build()
            prog = pa.lower([x, C], use_cpu=(i == 0), use_cuda=(i == 1))
            jobs.append((sv.submit(tenant, prog.taskpool()), prog, x, xo))
        for h, prog, x, xo in jobs:
            assert h.wait(timeout=120)
            prog.finalize()
            assert np.allclose(x.to_numpy(), xo, atol=1e-10)


def test_array_sde_gauges_track_synthesis(clean_sde):
    from parsec_tpu_torch.profiling.health import register_context_gauges

    ctx = _ctx(False)
    unregister = register_context_gauges(ctx)
    try:
        base = sde.read(sde.ARRAY_PROGRAMS_LOWERED)
        A = pa.from_numpy(np.eye(8), 4)
        (A + A).compute(ctx, use_cuda=False)
        assert sde.read(sde.ARRAY_PROGRAMS_LOWERED) == base + 1
        assert sde.read(sde.ARRAY_CLASSES_GENERATED) > 0
        assert sde.read(sde.ARRAY_TASKPOOLS_BUILT) >= 1
        assert sde.read(sde.ARRAY_CLASSES_GENERATED) == pa.counters()["classes_generated"]
    finally:
        unregister()
        ctx.fini()


def test_array_gauges_on_metrics_endpoint(clean_sde):
    from parsec_tpu_torch.profiling.health import HealthServer, register_context_gauges

    ctx = _ctx(False)
    register_context_gauges(ctx)
    hs = HealthServer(ctx, host="127.0.0.1").start()
    try:
        A = pa.from_numpy(np.eye(8), 4)
        (A * 2.0).compute(ctx, use_cuda=False)
        text = urllib.request.urlopen(hs.url + "/metrics", timeout=10).read().decode()
        m = re.search(r'parsec_array_programs_total\{rank="0"\} (\d+)', text)
        assert m and int(m.group(1)) >= 1, text[-500:]
        assert int(m.group(1)) == pa.counters()["programs_lowered"]
        assert 'parsec_array_taskpools_total{rank="0"}' in text
        assert sde.read(sde.ARRAY_PROGRAMS_LOWERED) >= 1
        st = json.loads(urllib.request.urlopen(hs.url + "/status", timeout=10).read().decode())
        assert st["array"] == pa.counters()
    finally:
        hs.stop()
        ctx.fini()


def test_health_summary_never_imports_the_array_package(monkeypatch):
    """The scrape is import-light: with the lowering module absent from
    ``sys.modules`` it reads zeros and imports nothing."""
    import sys

    from parsec_tpu_torch.profiling import health

    monkeypatch.delitem(sys.modules, "parsec_tpu_torch.array.lower", raising=False)
    assert health._array_summary() == {"programs_lowered": 0, "classes_generated": 0,
                                       "taskpools_built": 0}
    assert "parsec_tpu_torch.array.lower" not in sys.modules


def test_operations_md_documents_array_gauges():
    here = os.path.dirname(os.path.abspath(__file__))
    ops_md = os.path.join(here, "..", "parsec_tpu_torch", "OPERATIONS.md")
    with open(ops_md) as f:
        text = f.read()
    documented = set(re.findall(r"`(PARSEC::[A-Z_:]+)`", text))
    assert {sde.ARRAY_PROGRAMS_LOWERED, sde.ARRAY_CLASSES_GENERATED,
            sde.ARRAY_TASKPOOLS_BUILT} <= documented
    assert "A.7b" not in text


def test_critpath_per_label_rolls_arr_classes():
    from parsec_tpu.profiling.critpath import label_of as ref_label_of
    from parsec_tpu_torch.profiling.critpath import label_of

    for name in ("arr_mm3", "arr_po7", "arr_ldf0", "fused[arr_ew2+arr_sc3]", "potrf"):
        assert label_of(name) == ref_label_of(name)
    assert label_of("arr_mm3") == "array" and label_of("potrf") is None


def test_critpath_real_trace_array_label(tmp_path):
    """A traced array program (the native tracer's binary streams, merged)
    attributes its critical path under ONE ``array`` per_label row."""
    from parsec_tpu_torch.profiling import critpath
    from parsec_tpu_torch.profiling.binary import RankTraceSet
    from parsec_tpu_torch.profiling.merge import merge_traces

    traces = RankTraceSet(1).install()
    try:
        rng = np.random.default_rng(3)
        G = rng.standard_normal((16, 16))
        A = pa.from_numpy(G, 4)
        M = (A @ A.T) + A
        with _ctx(False) as ctx:
            M.compute(ctx, use_cuda=False)
        paths = traces.dump(str(tmp_path))
    finally:
        traces.uninstall()
    merged = str(tmp_path / "merged.json")
    merge_traces(paths, merged)
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    rep = critpath.analyze(events)
    assert rep["n_tasks"] > 0
    assert all(link["class"].startswith("arr_") for link in rep["chain"])
    assert set(rep["per_label"]) == {"array"}, rep["per_class"]
    assert rep["per_label"]["array"]["count"] == rep["n_tasks"]
    assert "array" in critpath.render(rep)


# ---------------------------------------------------------------------------
# the one-rank schedule explorer
# ---------------------------------------------------------------------------

N, NB = 24, 8
_rng = np.random.default_rng(43)
G_EX = _rng.standard_normal((N, N))
H_EX = np.eye(N) * N
RHS_EX = _rng.standard_normal((N, 2))


def _build_explore(rank, ctx):
    A = pa.from_numpy(G_EX, NB)
    B = pa.from_numpy(H_EX, NB)
    b = pa.from_numpy(RHS_EX, NB, 2)
    C = (A @ A.T + B).cholesky()
    x = C.solve(b)
    prog = pa.lower([x, C], use_cuda=False)
    prog.finalize()  # collections exist now; tiles land at quiescence
    return prog.taskpool(ctx), [C._node.coll, x._node.coll]


def test_mixed_array_program_explorer_4_seeds(cpu_device):
    from parsec_tpu_torch.analysis.schedules import explore, tile_digest

    res = _within(lambda: explore(
        _build_explore, nranks=1, seeds=range(4), timeout=180,
        snapshot=lambda users: [tile_digest(c) for ranks in users for c in ranks]))
    assert len(res.seeds) == 4 and not res.errors
    L = np.tril(np.linalg.cholesky(G_EX @ G_EX.T + H_EX))
    c_digest = res.digests[res.seeds[0]][0]
    assert c_digest, "no factor tiles"
    for (i, j), (shape, dtype, raw) in c_digest.items():
        got = np.frombuffer(raw, dtype).reshape(shape)
        np.testing.assert_allclose(
            got, L[i * NB:i * NB + shape[0], j * NB:j * NB + shape[1]],
            atol=1e-10, err_msg=f"tile {(i, j)}")


def _build_explore_2ranks(pkg):
    def build(rank, ctx):
        p = pa if pkg == "port" else ref_pa
        dist = p.Block1D(2)
        A = p.from_numpy(G_EX, NB, dist=dist, myrank=rank)
        B = p.from_numpy(H_EX, NB, dist=dist, myrank=rank)
        b = p.from_numpy(RHS_EX, NB, 2, dist=dist, myrank=rank)
        C = (A @ A.T + B).cholesky()
        x = C.solve(b)
        prog = (pa.lower([x, C], use_cuda=False) if pkg == "port"
                else ref_pa.lower([x, C], use_tpu=False))
        prog.finalize()
        return prog.taskpool(ctx), [C._node.coll, x._node.coll]
    return build


def test_explorer_beyond_one_rank_raises_naming_a8(cpu_device):
    """Beyond one rank since ROADMAP A.8a (the reference's
    ``tests/array/test_explorer.py`` at 2 ranks): every seed quiesces on
    both ranks with bit-identical tiles, rank 0's factor is right, and
    the tiles equal the JAX package's explorer's."""
    from parsec_tpu.analysis.schedules import explore as ref_explore
    from parsec_tpu.analysis.schedules import tile_digest as ref_digest
    from parsec_tpu_torch.analysis.schedules import explore, tile_digest

    res = _within(lambda: explore(
        _build_explore_2ranks("port"), nranks=2, seeds=range(3), timeout=180,
        snapshot=lambda users: [tile_digest(c) for ranks in users for c in ranks]))
    assert len(res.seeds) == 3 and not res.errors
    L = np.tril(np.linalg.cholesky(G_EX @ G_EX.T + H_EX))
    c0 = res.digests[0][0]  # rank 0's C collection
    assert c0, "rank 0 produced no factor tiles"
    for (i, j), (shape, dtype, raw) in c0.items():
        np.testing.assert_allclose(
            np.frombuffer(raw, dtype).reshape(shape),
            L[i * NB:i * NB + shape[0], j * NB:j * NB + shape[1]],
            atol=1e-10, err_msg=f"tile {(i, j)}")
    ref = _within(lambda: ref_explore(
        _build_explore_2ranks("ref"), nranks=2, seeds=range(1), timeout=180,
        snapshot=lambda users: [ref_digest(c) for ranks in users for c in ranks]))
    assert res.digests[0] == ref.digests[0]
