"""Whole-DAG capture (parsec_tpu_torch.dsl.cuda_graph.GraphExecutor) and
the captured graph's topological order (TaskGraph.topo_order), against the
JAX package's GraphExecutor (parsec_tpu.dsl.xla_lower).

The mirrors of ``tests/dsl/test_xla_lower.py`` run the port's executor on
the torch CPU device (``device="cpu"``: the plan runs eagerly, the kernel
wrappers take their plain versions) and hold each result to numpy at the
reference test's tolerance, bit for bit to the port's dynamic path, and
within that tolerance of the JAX executor on the same seed-made input
(its Pallas kernels in interpret mode).  Capture and replay themselves
run only on a card: ``tests/test_torch_cuda_capture.py`` holds them.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import graph as ref_graph  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.dsl.xla_lower import GraphExecutor as RefGraphExecutor  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu_torch import AccessMode, mca_param  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import PTG, GraphExecutor, graph  # noqa: E402
from parsec_tpu_torch.ops import attention, cholesky_ptg, stencil  # noqa: E402

IN, INOUT = AccessMode.IN, AccessMode.INOUT
SEEDS = (0, 1, 7, 42)  # the reference's four schedule-explorer seeds


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


# (port kwargs, reference kwargs, n, nb, dtype, seed, |LL^T - S| bound):
# tests/dsl/test_xla_lower.py:18-150's cases and tolerances
_DPOTRF = {
    "library": (dict(), dict(), 64, 16, np.float64, 0, 1e-8),
    "kernels": (dict(use_kernels=True), dict(use_pallas=True), 128, 32, np.float32, 3, 2e-3),
    "trtri": (dict(use_trtri=True), dict(use_trtri=True), 128, 32, np.float32, 4, 2e-3),
    "kernels_trtri": (dict(use_kernels=True, use_trtri=True),
                      dict(use_pallas=True, use_trtri=True), 128, 32, np.float32, 4, 2e-3),
    "kernels_bf16": (dict(use_kernels=True, bf16_updates=True),
                     dict(use_pallas=True, bf16_updates=True), 128, 32, np.float32, 6, 2e-2),
}


def _port_graph_factor(variant, **ex_kw):
    kw, _rkw, n, nb, dt, seed, _bound = _DPOTRF[variant]
    S = _spd(n, dt, seed)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=dt).from_array(S)
    ex = GraphExecutor(cholesky_ptg(use_cpu=False, **kw).taskpool(NT=A.mt, A=A),
                       device="cpu", **ex_kw)
    ex(block=True)
    return ex, np.tril(A.to_array()), S


@pytest.mark.parametrize("variant", sorted(_DPOTRF))
def test_graph_dpotrf_matches_numpy_and_reference_executor(variant):
    """dpotrf through the executor: the lower triangle is read (one input
    key a tile), L L^T = S within the reference test's bound, and L within
    that bound of the JAX GraphExecutor's on the same input."""
    _kw, rkw, n, nb, dt, seed, bound = _DPOTRF[variant]
    ex, L, S = _port_graph_factor(variant)
    nt = n // nb
    assert len(ex.input_keys) == len(ex.output_keys) == nt * (nt + 1) // 2
    err = np.abs(L.astype(np.float64) @ L.T - S).max() / np.abs(S).max()
    assert err < bound, err
    rA = RefTiledMatrix(n, n, nb, nb, name="A", dtype=dt).from_array(S)
    RefGraphExecutor(ref_cholesky_ptg(use_tpu=True, use_cpu=False, **rkw).taskpool(
        NT=rA.mt, A=rA))(block=True)
    Lr = np.tril(rA.to_array())
    assert np.abs(L.astype(np.float64) - Lr).max() / np.abs(Lr).max() < bound


@pytest.mark.parametrize("variant", sorted(_DPOTRF))
def test_graph_dpotrf_bit_identical_to_dynamic_path(variant):
    """The executor's plan runs the same bodies on the same tiles as the
    dynamic path, in a dependency order: the factors are bit-identical."""
    kw, _rkw, n, nb, dt, seed, _bound = _DPOTRF[variant]
    _ex, L, S = _port_graph_factor(variant)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=dt).from_array(S)
    tp = cholesky_ptg(use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
    with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
    np.testing.assert_array_equal(L, np.tril(A.to_array()))


def _chain(ptg_cls, coll_cls, lib):
    dc = coll_cls("D", shape=(4,), init=lambda k: np.zeros(4))
    ptg = ptg_cls("chain")
    s = ptg.task_class("s", k="0 .. 7")
    s.affinity("D(0)")
    s.flow("X", INOUT,
           "<- (k == 0) ? D(0) : X s(k-1)",
           "-> (k < 7) ? X s(k+1) : D(0)")
    s.body(**{lib: lambda X, k: X + k})
    return ptg.taskpool(D=dc)


def test_graph_chain_with_explicit_feeds():
    """apply() on explicit feeds, as the reference's chain: 1 + 0 + ... + 7,
    equal to the JAX executor's."""
    out = GraphExecutor(_chain(PTG, LocalCollection, "cuda"), device="cpu").apply(
        {("D", (0,)): torch.ones(4, dtype=torch.float64)})
    ref = RefGraphExecutor(_chain(RefPTG, RefLocalCollection, "tpu")).apply(
        {("D", (0,)): jax.numpy.ones(4)})
    np.testing.assert_allclose(out[("D", (0,))].numpy(), 1.0 + sum(range(8)))
    np.testing.assert_allclose(out[("D", (0,))].numpy(), np.asarray(ref[("D", (0,))]))


def test_graph_requires_functional_body():
    dc = LocalCollection("D", shape=(2,), init=lambda k: np.zeros(2))
    ptg = PTG("cpuonly")
    s = ptg.task_class("s")
    s.flow("X", INOUT, "<- D(0)", "-> D(0)")
    s.body(cpu=lambda X: X.__iadd__(1))
    with pytest.raises(ValueError, match="functional"):
        GraphExecutor(ptg.taskpool(D=dc), device="cpu")


@pytest.mark.parametrize("feed", ["numpy", "torch"])
def test_apply_never_writes_through_and_outputs_survive_a_second_apply(feed):
    """apply() copies the feeds in (a caller's array or tensor is never
    written), and a second apply leaves the first one's outputs intact."""
    ex = GraphExecutor(_chain(PTG, LocalCollection, "cuda"), device="cpu")
    ones = np.ones(4) if feed == "numpy" else torch.ones(4, dtype=torch.float64)
    first = ex.apply({("D", (0,)): ones})[("D", (0,))]
    kept = first.clone()
    twos = 2 * ones
    second = ex.apply({("D", (0,)): twos})[("D", (0,))]
    np.testing.assert_array_equal(np.asarray(ones), 1.0)
    np.testing.assert_array_equal(np.asarray(twos), 2.0)
    assert torch.equal(first, kept)
    assert torch.equal(second, kept + 1)


def test_graph_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphExecutor(_chain(PTG, LocalCollection, "cuda"))


def test_graph_write_back_bumps_versions_and_attaches_results():
    """__call__ attaches each result to its tile as a device copy (the
    executor's device) and bumps the tile's version."""
    _kw, _rkw, n, nb, dt, seed, _b = _DPOTRF["library"]
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=dt).from_array(_spd(n, dt, seed))
    ex = GraphExecutor(cholesky_ptg(use_cpu=False).taskpool(NT=A.mt, A=A), device="cpu")
    before = {k: A.data_of(*k[1]).newest_copy().version for k in ex.output_keys}
    outs = ex()
    for k, arr in outs.items():
        c = A.data_of(*k[1]).newest_copy()
        assert c.payload is arr and c.version == before[k] + 1


def test_plan_digest_tracks_the_plan():
    """The digest is the plan's content: a rebuilt identical taskpool
    digests the same, another body or another size does not."""
    def digest(nt, **kw):
        A = TiledMatrix(16 * nt, 16 * nt, 16, 16, name="A", dtype=np.float64)
        return GraphExecutor(cholesky_ptg(use_cpu=False, **kw).taskpool(NT=A.mt, A=A),
                             device="cpu").program_digest

    assert digest(3) == digest(3)
    assert len({digest(3), digest(4), digest(3, use_kernels=True)}) == 3


def test_plan_drops_each_value_after_its_last_reader():
    """Liveness: every flow value is dropped exactly once, at its last
    reader, so a 20-step stencil holds about two generations of tiles —
    not every step's."""
    T, M = 20, 3
    grid = np.random.default_rng(1).standard_normal((24, 24))
    ex = GraphExecutor(stencil.stencil_ptg(use_cpu=False).taskpool(
        T=T, MT=M, NT=M, A=stencil.StencilBuffers(grid, M, M)), device="cpu")
    produced = [(s.tid, f) for s in ex._plan for f in s.flow_names]
    dropped = [v for s in ex._plan for v in s.drops]
    assert sorted(produced) == sorted(dropped)
    live = peak = 0
    for s in ex._plan:
        live += len(s.flow_names) - len(s.drops)
        peak = max(peak, live + len(s.drops))
    assert live == 0 and peak <= 2 * M * M * 6, peak
    out = ex()
    assert len(out) == 2 * M * M
    got = ex.taskpool.constants["A"].to_array(T % 2)
    np.testing.assert_allclose(got, ref_stencil.reference_stencil(grid, T),
                               rtol=1e-12, atol=1e-12)


# -- topological order ---------------------------------------------------------

def _order_cases():
    S = _spd(192, np.float32, 5)
    rng = np.random.default_rng(9)
    qkv = [rng.standard_normal((1, 64, 2, 8)).astype(np.float32) for _ in range(3)]
    grid = np.random.default_rng(1).standard_normal((36, 36))
    return {
        # 12 x 12 tiles: 364 tasks, ordered natively
        "dpotrf": (lambda: cholesky_ptg().taskpool(
            NT=12, A=TiledMatrix(192, 192, 16, 16, name="A", dtype=np.float32).from_array(S)),
                   lambda: ref_cholesky_ptg().taskpool(
            NT=12, A=RefTiledMatrix(192, 192, 16, 16, name="A",
                                    dtype=np.float32).from_array(S))),
        "attention": (lambda: attention.build_flash_attention(
            *qkv, causal=True, q_block=16, kv_block=8)[0],
                      lambda: ref_attention.build_flash_attention(
            *qkv, causal=True, q_block=16, kv_block=8)[0]),
        "stencil": (lambda: stencil.stencil_ptg().taskpool(
            T=3, MT=3, NT=3, A=stencil.StencilBuffers(grid, 3, 3)),
                    lambda: ref_stencil.stencil_ptg().taskpool(
            T=3, MT=3, NT=3, A=ref_stencil.StencilBuffers(grid, 3, 3))),
        # 8 steps of 6 x 6 tiles: 288 tasks, ordered natively
        "stencil_native": (lambda: stencil.stencil_ptg().taskpool(
            T=8, MT=6, NT=6, A=stencil.StencilBuffers(grid, 6, 6)),
                           lambda: ref_stencil.stencil_ptg().taskpool(
            T=8, MT=6, NT=6, A=ref_stencil.StencilBuffers(grid, 6, 6))),
    }


@pytest.mark.parametrize("case", ["dpotrf", "attention", "stencil", "stencil_native"])
def test_topo_order_valid_and_equal_to_reference_across_seeds(case):
    """topo_order is a valid dependency order, the reference's own (the
    Python heap at up to 256 nodes, the native order above), and does not
    move with the schedule explorer's seed."""
    mine_tp, ref_tp = _order_cases()[case]
    want = ref_graph.capture(ref_tp()).topo_order()
    for seed in SEEDS:
        mca_param.set_param("sched", "rnd_seed", seed)
        try:
            g = mine_tp().capture()
            order = g.topo_order()
        finally:
            mca_param.unset("sched", "rnd_seed")
        pos = {tid: i for i, tid in enumerate(order)}
        assert len(pos) == len(g.nodes)
        for tid, node in g.nodes.items():
            for (_f, succ, _sf) in node.out_edges:
                assert pos[tid] < pos[succ]
        assert order == want


def test_topo_order_raises_on_a_cycle_in_either_engine(monkeypatch):
    ptg = PTG("loop")
    a = ptg.task_class("a", k="0 .. 1")
    a.flow("X", INOUT, "<- X a((k + 1) % 2)", "-> X a((k + 1) % 2)")
    a.body(cpu=lambda X, k: None)
    g = graph.capture(ptg.taskpool())
    with pytest.raises(RuntimeError, match="cycle"):
        g.topo_order()
    monkeypatch.setattr(graph, "_NATIVE_ORDER_MIN", 0)
    with pytest.raises(RuntimeError, match="cycle"):
        g.topo_order()
