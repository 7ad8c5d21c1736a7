"""The native serve executor, ``run_native`` over a list of pools,
``NativeExecutor.rebind`` and the pump's conformance replay, on the port
and against the JAX package.

Mirrors the serve-executor and ``rebind`` cases of
``tests/dsl/test_native_pump.py`` / ``tests/dsl/test_native_device.py`` /
``tests/dsl/test_native_dist.py`` and the conformance cases of
``tests/analysis/test_engine_verify.py``.  The pump runs on the CUDA
device module bound to the torch CPU device (``device_cuda_torch_device=
cpu``); fairness is read off retire positions, never off clocks.

One deliberate difference: the reference refuses ``rebind`` on a device
executor; the port rebuilds the device tasks over the new pool's tiles
(after flushing the previous run's tiles home), so a stream of
same-shaped jobs reuses one captured graph on the card too."""

import os
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import native_exec as ref_native_exec  # noqa: E402
from parsec_tpu.ops.cholesky import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.analysis.findings import LintError  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import native_exec  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import (NativeExecutor,  # noqa: E402
                                              NativeServeExecutor, run_native)
from parsec_tpu_torch.dsl.ptg import INOUT, PTG  # noqa: E402
from parsec_tpu_torch.ops import build_flash_attention, cholesky_ptg, kernels  # noqa: E402
from parsec_tpu_torch.profiling import pins  # noqa: E402

H, D = 2, 8


@pytest.fixture
def cpu_device():
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


@pytest.fixture
def port_param():
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


def _spd(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(dtype)


def _dpotrf(n, nb, seed=0, dtype=np.float32, **kw):
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=dtype).from_array(_spd(n, seed, dtype))
    return cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A), A


def _decode(tag, sk=64):
    """A decode pool: 8 query rows at the tail of ``sk`` keys, its inputs
    seeded by the crc32 of its tag (as the bench's serving leg seeds)."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    mk = lambda s: torch.from_numpy(rng.standard_normal((1, s, H, D)).astype(np.float32))  # noqa: E731
    return build_flash_attention(mk(8), mk(sk), mk(sk), causal=True, q_block=8,
                                 kv_block=16, use_cpu=False)


def _prefill(seed=5, s=64):
    rng = np.random.default_rng(seed)
    mk = lambda: torch.from_numpy(rng.standard_normal((1, s, H, D)).astype(np.float32))  # noqa: E731
    return build_flash_attention(mk(), mk(), mk(), causal=True, q_block=16, kv_block=16,
                                 use_cpu=False)


def _solo(tp):
    ex = NativeExecutor(tp, native_device=True)
    try:
        return ex.run()
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# the serve executor
# ---------------------------------------------------------------------------

def test_serve_executor_outputs_equal_solo_pump_runs(cpu_device):
    """The prefill, a dpotrf and two decodes as four wdrr tenants of one
    native graph: each output equals its solo pump run bit for bit, the
    counts come back per pool, no task entered the interpreter, and each
    pool's progress currency retired its own tasks."""
    solo_pf = _prefill()
    _solo(solo_pf[0])
    solo_chol = _dpotrf(128, 32, seed=3, use_kernels=True)
    _solo(solo_chol[0])
    solo_dec = [_decode(f"d{i}") for i in range(2)]
    for tp, _ in solo_dec:
        _solo(tp)
    pf, chol = _prefill(), _dpotrf(128, 32, seed=3, use_kernels=True)
    decs = [_decode(f"d{i}") for i in range(2)]
    pools = [pf[0], chol[0]] + [tp for tp, _ in decs]
    kernels.reset_counts()
    sx = NativeServeExecutor(pools, weights=[1, 1, 4, 4])
    try:
        counts = sx.run()
        stats = dict(sx.stats)
        log = list(sx.retire_log)
    finally:
        sx.close()
    assert counts == [len(ch.graph.nodes) for ch in sx.children]
    assert counts[1] == 20 and counts[2] == counts[3]
    assert stats["trampoline_entries"] == stats["completion_callbacks"] == 0
    assert stats["pumped_tasks"] == sum(counts) == len(log)
    assert [tp.nb_retired for tp in pools] == counts
    assert torch.equal(pf[1](), solo_pf[1]())
    assert np.array_equal(chol[1].to_array(), solo_chol[1].to_array())
    for (tp, asm), (stp, sasm) in zip(decs, solo_dec):
        assert torch.equal(asm(), sasm())
    # the B5 steps and the dpotrf's updates each went through their wrapper
    assert kernels.flash_attention_block.calls > 0 and kernels.matmul_update.calls == 10
    # the decodes (weight 4) finished before the dpotrf's last retire
    last = {i: max(p for t, p, _ in log if t == i) for i in range(4)}
    assert last[2] < last[1] and last[3] < last[1]


def test_run_native_over_a_list_matches_the_reference(cpu_device):
    """``run_native([...])`` returns the per-pool logical counts, as the
    reference's does over the same shapes, and each factor agrees with
    the reference's within f32 rounding."""
    S = [_spd(96, seed=s) for s in (1, 2)]
    port = [TiledMatrix(96, 96, 32, 32, name="A", dtype=np.float32).from_array(s) for s in S]
    ref = [RefTiledMatrix(96, 96, 32, 32, name="A", dtype=np.float32).from_array(s) for s in S]
    got = run_native([cholesky_ptg(use_cuda=True, use_cpu=False).taskpool(NT=3, A=a)
                      for a in port], weights=[1, 2])
    want = ref_native_exec.run_native(
        [ref_cholesky_ptg(use_tpu=True, use_cpu=False).taskpool(NT=3, A=a) for a in ref])
    assert got == want == [10, 10]
    for a, r, s in zip(port, ref, S):
        L = np.tril(a.to_array()).astype(np.float64)
        np.testing.assert_allclose(L @ L.T, s, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(a.to_array(), r.to_array(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("weights", [(1, 1), (1, 4), (3, 1), (0, -3)])
def test_serve_executor_retire_order_matches_the_reference(weights, cpu_device):
    """The engine is shared: over two same-shaped dpotrf tenants the
    port's union pump retires tenants in the reference's order, weight by
    weight (one pump thread pops each ready batch in wdrr order).  A
    weight below 1 is taken as 1, in the executor's record as in the
    engine's bins."""
    def port_pools():
        return [_dpotrf(128, 32, seed=s)[0] for s in (1, 2)]

    def ref_pools():
        out = []
        for s in (1, 2):
            A = RefTiledMatrix(128, 128, 32, 32, name="A", dtype=np.float32).from_array(
                _spd(128, s))
            out.append(ref_cholesky_ptg(use_tpu=True, use_cpu=False).taskpool(NT=A.mt, A=A))
        return out

    sx = NativeServeExecutor(port_pools(), weights=list(weights))
    try:
        sx.run()
        port_order = [t for t, _, _ in sx.retire_log]
    finally:
        sx.close()
    assert sx.weights == [max(1, w) for w in weights]
    rx = ref_native_exec.NativeServeExecutor(ref_pools(), weights=list(weights))
    try:
        rx.run()
        ref_order = [t for t, _, _ in rx.retire_log]
    finally:
        rx.close()
    assert port_order == ref_order
    assert sorted(port_order) == [0] * 20 + [1] * 20


def test_native_drain_sets_the_pop_batch_as_in_the_reference(cpu_device, port_param):
    """ROADMAP C.13: ``runtime_native_drain`` caps each ``pop_batch`` of the
    union pump.  Over two dpotrf tenants whose ready frontier reaches 132
    tasks, the port at 64 retires tenants in the reference's order at 64,
    and in another order than at the default 256.  The reference runs at
    the port's default stage depth of 1 (its own is 2, which halves each
    pop), so both pop batches of 64."""
    def port_order():
        sx = NativeServeExecutor([_dpotrf(384, 32, seed=s)[0] for s in (1, 2)])
        try:
            sx.run()
            return [t for t, _, _ in sx.retire_log]
        finally:
            sx.close()

    def ref_order():
        pools = []
        for s in (1, 2):
            A = RefTiledMatrix(384, 384, 32, 32, name="A", dtype=np.float32).from_array(
                _spd(384, s))
            pools.append(ref_cholesky_ptg(use_tpu=True, use_cpu=False).taskpool(NT=A.mt, A=A))
        rx = ref_native_exec.NativeServeExecutor(pools)
        try:
            rx.run()
            return [t for t, _, _ in rx.retire_log]
        finally:
            rx.close()

    at_default = port_order()
    port_param("runtime", "native_drain", 64)
    ref_mca_param.params.set("runtime", "native_drain", 64)
    ref_mca_param.params.set("runtime", "stage_depth", 1)
    try:
        at_64, ref_at_64 = port_order(), ref_order()
    finally:
        ref_mca_param.params.unset("runtime", "native_drain")
        ref_mca_param.params.unset("runtime", "stage_depth")
    assert sorted(at_64) == [0] * 364 + [1] * 364
    assert at_64 == ref_at_64
    assert at_64 != at_default


def _device_chain(name, n=12):
    dc = LocalCollection(f"S{name}", shape=(1,),
                         init=lambda k: np.zeros(4, dtype=np.float32))
    ptg = PTG(f"small_{name}")
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("S(0)")
    step.flow("X", INOUT, "<- (k == 0) ? S(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : S(0)")
    step.body(cuda=lambda X, k: X + 1.0)
    return ptg.taskpool(N=n, S=dc), dc


@pytest.mark.parametrize("drain", [None, 64])
def test_serve_fairness_small_tenant_not_starved_under_native_pop(drain, cpu_device,
                                                                  port_param):
    """Four 12-task chains beside a 5984-task dpotrf in one native graph:
    with the wdrr deficits in the engine, each chain's last retire comes
    early in the union's retire order (starvation would put it at the
    tail, after the whole backlog).  At the default pop batch and at the
    reference test's ``runtime_native_drain`` of 64."""
    if drain is not None:
        port_param("runtime", "native_drain", drain)
    big, _ = _dpotrf(1024, 32, seed=5, dtype=np.float64)
    smalls = [_device_chain(f"c{i}") for i in range(4)]
    sx = NativeServeExecutor([big] + [tp for tp, _ in smalls])
    try:
        counts = sx.run()
        log = list(sx.retire_log)
    finally:
        sx.close()
    assert counts == [5984] + [12] * 4
    total = len(log)
    done_pos = {}
    for tenant, pos, _ in log:
        done_pos[tenant] = pos
    for i in range(1, 5):
        assert done_pos[i] < 0.4 * total, (i, done_pos[i], total)
    for _, dc in smalls:
        assert np.array_equal(dc.data_of(0).newest_copy().payload, np.full(4, 12.0, np.float32))


def test_serve_executor_requires_all_device_classes(cpu_device):
    A = TiledMatrix(64, 64, 32, 32, name="A", dtype=np.float32).from_array(_spd(64))
    tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
    with pytest.raises(RuntimeError, match="all-device"):
        NativeServeExecutor([_dpotrf(64, 32)[0], tp])
    with pytest.raises(ValueError, match=">= 1"):
        NativeServeExecutor([])


def test_serve_executor_failing_pool_fails_the_run(cpu_device):
    coll = LocalCollection("B", shape=(1,), init=lambda k: np.zeros(2, np.float32))
    ptg = PTG("boom")
    s = ptg.task_class("s", k="0 .. 0")
    s.affinity("B(0)")
    s.flow("X", INOUT, "<- B(0)", "-> B(0)")

    def body(X, k):
        raise RuntimeError("device body exploded")

    s.body(cuda=body)
    with pytest.raises(RuntimeError, match="native device run failed.*exploded"):
        run_native([_dpotrf(64, 32)[0], ptg.taskpool(B=coll)])


def test_serve_executor_hbcheck_orders_the_union_run(cpu_device):
    """The event drain republishes the shared graph's lifecycle: hb-check
    sees every task's publish and retire and finds no race."""
    from parsec_tpu_torch.analysis.hb import HBRecorder

    with HBRecorder(stacks=False) as rec:
        counts = run_native([_dpotrf(96, 24, seed=4)[0], _decode("h")[0]], weights=[1, 2])
    kinds = {}
    for ev in rec.events:
        kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
    assert kinds.get("task_done") == sum(counts)
    assert kinds.get("task_publish", 0) >= sum(counts)
    assert rec.analyze() == []


# ---------------------------------------------------------------------------
# rebind
# ---------------------------------------------------------------------------

def test_rebind_cpu_regime_reuses_the_graph_like_the_reference():
    """The CPU regime's rebind (the reference's semantics): the second
    run over a fresh matrix reuses the captured graph and equals a fresh
    executor's factor, and the reference's rebind gives the same
    factor."""
    S1, S2 = _spd(96, 1, np.float64), _spd(96, 2, np.float64)

    def port_run(S, ex=None):
        A = TiledMatrix(96, 96, 32, 32, name="A", dtype=np.float64).from_array(S)
        tp = cholesky_ptg(use_cuda=False).taskpool(NT=3, A=A)
        if ex is None:
            ex = NativeExecutor(tp)
        else:
            ex.rebind(tp)
        assert ex.run(nthreads=2) == 10
        return ex, A.to_array()

    ex, _ = port_run(S1)
    graph = ex.graph
    _, second = port_run(S2, ex)
    assert ex.graph is graph
    ex.close()
    _, fresh = port_run(S2)

    def ref_run(S, ex=None):
        A = RefTiledMatrix(96, 96, 32, 32, name="A", dtype=np.float64).from_array(S)
        tp = ref_cholesky_ptg(use_tpu=False).taskpool(NT=3, A=A)
        if ex is None:
            ex = ref_native_exec.NativeExecutor(tp)
        else:
            ex.rebind(tp)
        ex.run(nthreads=2)
        return ex, A.to_array()

    rex, _ = ref_run(S1)
    _, ref_second = ref_run(S2, rex)
    rex.close()
    assert np.array_equal(second, fresh)
    assert np.array_equal(second, ref_second)


@pytest.mark.parametrize("protocol", ["pump", "legacy"])
def test_rebind_device_executor_captures_nothing(protocol, cpu_device, port_param, monkeypatch):
    """A device executor rebound to a same-shaped decode pool captures no
    graph again; its output equals the pool's solo run, and the first
    pool's output landed home before the rebind."""
    if protocol == "legacy":
        port_param("runtime", "native_sched", "off")
    solo = {}
    for tag in ("r0", "r1"):
        tp, asm = _decode(tag)
        _solo(tp)
        solo[tag] = asm()
    captures = []
    real_capture = native_exec.capture
    monkeypatch.setattr(native_exec, "capture",
                        lambda *a, **k: captures.append(1) or real_capture(*a, **k))
    tp0, asm0 = _decode("r0")
    ex = NativeExecutor(tp0, native_device=True)
    try:
        ex.run()
        graph = ex.graph
        tp1, asm1 = _decode("r1")
        assert ex.rebind(tp1) is ex
        assert torch.equal(asm0(), solo["r0"])
        ex.run()
        assert ex.graph is graph and ex._pump == (protocol == "pump")
    finally:
        ex.close()
    assert captures == [1]
    assert torch.equal(asm1(), solo["r1"])
    assert tp1.nb_retired == len(graph.nodes)


def test_rebind_rejects_another_shape(cpu_device):
    tp, _ = _decode("s0", sk=64)
    ex = NativeExecutor(tp, native_device=True)
    try:
        ex.run()
        with pytest.raises(ValueError, match="shape/placement differs"):
            ex.rebind(_decode("s1", sk=96)[0])
        A = TiledMatrix(64, 64, 32, 32, name="A", dtype=np.float32).from_array(_spd(64))
        ex2 = NativeExecutor(cholesky_ptg(use_cuda=False).taskpool(NT=2, A=A))
        other = cholesky_ptg(use_cuda=False).taskpool(NT=2, A=A)
        other.constants["NT"] = 2
        ex2.run()
        B = TiledMatrix(96, 96, 32, 32, name="A", dtype=np.float32).from_array(_spd(96))
        with pytest.raises(ValueError, match="rebind"):
            ex2.rebind(cholesky_ptg(use_cuda=False).taskpool(NT=3, A=B))
        ex2.close()
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# runtime_native_conformance and the legacy protocol's event drain
# ---------------------------------------------------------------------------

def test_native_conformance_certifies_real_pump_runs(cpu_device, port_param):
    """``runtime_native_conformance=1``: the pump keeps its drained event
    stream and replays it against the engine verifier's model; a faithful
    run certifies, with the events counted."""
    port_param("runtime", "native_conformance", 1)
    tp, A = _dpotrf(128, 32, seed=2)
    ex = NativeExecutor(tp, native_device=True)
    try:
        assert ex.run() == 20
        assert ex.stats["conformance_events"] > 0
        assert ex.stats["events_drained"] == ex.stats["conformance_events"]
    finally:
        ex.close()
    L = np.tril(A.to_array()).astype(np.float64)
    np.testing.assert_allclose(L @ L.T, _spd(128, 2), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("doctor", ["drop_retire", "duplicate_retire"])
def test_native_conformance_rejects_a_doctored_drain(doctor, cpu_device, port_param,
                                                     monkeypatch):
    port_param("runtime", "native_conformance", 1)
    real = NativeExecutor._certify_drain

    def doctored(self, events):
        retires = [i for i, e in enumerate(events) if e[0] == 2]
        if doctor == "drop_retire":
            events = events[:retires[-1]] + events[retires[-1] + 1:]
        else:
            events = events + [events[retires[-1]]]
        return real(self, events)

    monkeypatch.setattr(NativeExecutor, "_certify_drain", doctored)
    tp, _ = _dpotrf(96, 32)
    ex = NativeExecutor(tp, native_device=True)
    try:
        with pytest.raises(LintError) as err:
            ex.run()
        assert err.value.findings and all(f.code == "ENG014" for f in err.value.findings)
    finally:
        ex.close()


def test_legacy_protocol_feeds_dep_decrement_observers_like_the_pump(cpu_device,
                                                                      port_param):
    """A DEP_DECREMENT observer sees one native decrement per DAG edge on
    the legacy ASYNC protocol as on the pump (the legacy run drains the
    engine's buffer after each task_done)."""
    seen = {"pump": [], "legacy": []}
    for protocol in ("pump", "legacy"):
        if protocol == "legacy":
            port_param("runtime", "native_sched", "off")
        cb = lambda es, p, _s=seen[protocol]: _s.append(p)  # noqa: E731
        pins.subscribe(pins.DEP_DECREMENT, cb)
        try:
            tp, _ = _dpotrf(128, 32, seed=1)
            ex = NativeExecutor(tp, native_device=True)
            try:
                assert ex.run() == 20
                edges = sum(len(n.out_edges) for n in ex.graph.nodes.values())
                assert ex.stats["events_drained"] >= edges
            finally:
                ex.close()
        finally:
            pins.unsubscribe(pins.DEP_DECREMENT, cb)
    assert len(seen["pump"]) == len(seen["legacy"]) == edges
    assert sorted(p["key"] for p in seen["pump"]) == sorted(p["key"] for p in seen["legacy"])
    assert sum(p["ready"] for p in seen["legacy"]) == 20 - 1  # every non-root armed once
