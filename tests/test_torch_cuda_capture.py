"""CUDA-graph capture on the card: whole-DAG capture
(:class:`parsec_tpu_torch.dsl.GraphExecutor`) and wave batching's captured
chunks (``device_cuda_wave_batch``), each held bit for bit to the eager
path it replaces.

Every test here needs an NVIDIA GPU (the ``cuda`` marker) and skips
without one: capture has no CPU form.  The file imports neither JAX nor
the JAX package, so it runs on a card's machine, where the repo's
``conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_capture.py

Their CPU counterparts, held against the JAX package, are
``tests/test_torch_graph.py`` and ``tests/test_torch_waves.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parsec_tpu_torch import AccessMode, mca_param  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.device import cuda as cuda_mod  # noqa: E402
from parsec_tpu_torch.dsl import PTG, GraphExecutor  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import attention, cholesky_ptg, kernels, stencil  # noqa: E402

pytestmark = pytest.mark.cuda

INOUT = AccessMode.INOUT
_N, _NB = 512, 128
_GRID = np.random.default_rng(1).standard_normal((256, 256)).astype(np.float32)
_ST = dict(T=4, MT=4, NT=4)
_QKV = [np.random.default_rng(9).standard_normal((1, 256, 4, 64)).astype(np.float32)
        for _ in range(3)]
_ATTN = dict(causal=True, q_block=64, kv_block=64)
_DPOTRF = {"kernels": dict(use_kernels=True),
           "kernels_trtri": dict(use_kernels=True, use_trtri=True)}


@pytest.fixture
def card():
    """The current CUDA device, or a skip: capture needs a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA-graph capture has no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def _spd(n, seed=3):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return m @ m.T + n * np.eye(n, dtype=np.float32)


def _dpotrf_pool(variant):
    A = TiledMatrix(_N, _N, _NB, _NB, name="A", dtype=np.float32).from_array(_spd(_N))
    return cholesky_ptg(use_cpu=False, **_DPOTRF[variant]).taskpool(NT=A.mt, A=A), A


@pytest.mark.parametrize("variant", sorted(_DPOTRF))
def test_captured_dpotrf_replays_equal_to_eager(variant, card):
    """The captured graph's replays equal the eager plan bit for bit, a
    second apply leaves the first outputs intact, and the launch counters
    count each replay."""
    tp, A = _dpotrf_pool(variant)
    eager = GraphExecutor(tp, device=card, capture=False)
    feeds = {k: torch.from_numpy(A.data_of(*k[1]).newest_copy().payload).to(card)
             for k in eager.input_keys}
    want = eager.apply(feeds)
    ex = GraphExecutor(tp, device=card)
    first = ex.apply(feeds)
    kernels.reset_counts()
    second = ex.apply(feeds)
    torch.cuda.synchronize()
    nt = _N // _NB
    assert ex.launches[("matmul_update", "total")] == \
        nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    assert kernels.launch_counts()[("matmul_update", "total")] == \
        ex.launches[("matmul_update", "total")]
    for k in ex.output_keys:
        assert torch.equal(first[k], want[k]) and torch.equal(second[k], want[k])
        assert first[k].data_ptr() != second[k].data_ptr()



def _batched_pool(path):
    """(taskpool, feeds source) of one level-batched path at test size."""
    if path == "stencil":
        A = stencil.StencilBuffers(_GRID, _ST["MT"], _ST["NT"])
        return stencil.stencil_ptg(use_kernels=True, use_cpu=False).taskpool(A=A, **_ST)
    if path == "attention":
        return attention.build_flash_attention(*_QKV, use_cpu=False, **_ATTN)[0]
    return _dpotrf_pool(path)[0]


@pytest.mark.parametrize("path", ["kernels", "kernels_trtri", "attention", "stencil"])
def test_batched_replays_launch_a_group_once(path, card):
    """``GraphExecutor(batch_levels=True)`` on the card: no group falls
    back, a replay launches each hand kernel once a batched group (its
    ``_b`` mode) and once a per-task task, the members counted apart;
    the stencil and the prefill equal the unbatched replay bit for bit,
    dpotrf within f32 rounding of it (batched library potrf/trsm)."""
    tp = _batched_pool(path)
    plain = GraphExecutor(tp, device=card)
    feeds = {k: torch.as_tensor(tp.constants[k[0]].data_of(*k[1]).newest_copy().payload)
             .to(card) for k in plain.input_keys}
    want = plain.apply(feeds)
    ex = GraphExecutor(tp, device=card, batch_levels=True)
    ex.apply(feeds)
    kernels.reset_counts()
    got = ex.apply(feeds)
    torch.cuda.synchronize()
    assert ex.batch_fallbacks == 0
    cls, fn = {"stencil": ("stencil", kernels.stencil_5pt),
               "attention": ("attn_step", kernels.flash_attention_block)}.get(
        path, ("gemm", kernels.matmul_update))
    groups = ex.group_counts()[cls]
    batched = sum(n for mode, n in fn.launches_by_mode.items() if mode.endswith("_b"))
    assert groups["batched"] > 0 and batched >= groups["batched"]
    assert fn.members >= groups["members"]
    assert kernels.launch_counts() == {k: n for k, n in ex.launches.items()} | {
        k: 0 for k in kernels.launch_counts() if k not in ex.launches}
    for k in ex.output_keys:
        if path in ("stencil", "attention"):
            assert torch.equal(got[k], want[k])
        else:
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


def _run(path, wave):
    mca_param.set_param("device", "cuda_wave_batch", wave)
    try:
        if path == "attention":
            dev = NativeExecutor._make_device()
            out = attention.run_flash_attention_native(*_QKV, device=dev, **_ATTN).numpy()
            return out, dev.stats
        if path == "stencil":
            A = stencil.StencilBuffers(_GRID, _ST["MT"], _ST["NT"])
            tp = stencil.stencil_ptg(use_kernels=True, use_cpu=False).taskpool(A=A, **_ST)
            read = lambda: A.to_array(_ST["T"] % 2)  # noqa: E731
        else:
            tp, A = _dpotrf_pool(path)
            read = A.to_array
        ex = NativeExecutor(tp, native_device=True)
        try:
            ex.run()
        finally:
            ex.close()
        return read(), ex.device.stats
    finally:
        mca_param.unset("device", "cuda_wave_batch")


@pytest.mark.parametrize("path", ["kernels", "kernels_trtri", "attention", "stencil"])
def test_wave_graphs_replay_equal_to_per_task(path, card):
    """Every path through the pump with waves on — each key's first chunk
    eager, its next captured, later ones replayed — equals waves off bit
    for bit, with no fallback.  A holder keeps the card's graphs across
    the runs, as a device module that stays attached would; its release
    drops them."""
    off, _stats = _run(path, 0)
    graphs = cuda_mod._wave_graphs(card)
    graphs.hold(graphs.share)
    captured = replayed = 0
    try:
        for _rep in range(3):
            on, stats = _run(path, 2)
            np.testing.assert_array_equal(on, off)
            assert stats["wave_fallbacks"] == 0 and stats["wave_tasks"] > 0
            captured += stats["wave_graphs"]
            replayed += stats["wave_copy_bytes"]
        assert cuda_mod.wave_graph_bytes(card) > 0
    finally:
        graphs.release()
    assert captured > 0 and replayed > 0
    assert cuda_mod.wave_graph_bytes(card) == 0


def test_wave_graphs_go_when_the_last_module_detaches(card):
    """Without another holder a run's graphs go at its close(): the next
    run starts with an empty cache."""
    assert cuda_mod.wave_graph_bytes(card) == 0
    _on, stats = _run("kernels", 2)
    assert stats["wave_tasks"] > 0 and stats["wave_fallbacks"] == 0
    assert cuda_mod.wave_graph_bytes(card) == 0


def _row_pool(rows=4, width=4):
    """``rows`` rows of ``width`` same-signature tasks, row r after row
    r - 1 (task (r, i) updates D(i)): the pump pops one row a batch, so one
    wave key comes back every row.  The body reads a device value on the
    host: legal eagerly, illegal inside a capture."""
    D = LocalCollection("D", shape=(4,), init=lambda k: np.full(4, k, np.float32))
    ptg = PTG("rows")
    t = ptg.task_class("t", r=f"0 .. {rows - 1}", i=f"0 .. {width - 1}")
    t.affinity("D(i)")
    t.flow("X", INOUT, "<- (r == 0) ? D(i) : X t(r-1, i)",
           f"-> (r < {rows - 1}) ? X t(r+1, i) : D(i)")
    t.body(cuda=lambda X, **_: X + float(X.sum().item()))
    return ptg.taskpool(D=D), D


def test_failed_wave_capture_is_counted_once_then_runs_per_task(card):
    """Row 0 warms the key, row 1's capture fails (counted in
    ``wave_fallbacks``, the row resubmitted per task), rows 2 and 3 run
    their bodies one by one without trying the capture again; the result
    equals waves off."""
    results = {}
    for wave in (0, 2):
        mca_param.set_param("device", "cuda_wave_batch", wave)
        try:
            tp, D = _row_pool()
            ex = NativeExecutor(tp, native_device=True)
            try:
                ex.run()
            finally:
                ex.close()
        finally:
            mca_param.unset("device", "cuda_wave_batch")
        results[wave] = (np.stack([np.asarray(D.data_of(i).newest_copy().payload)
                                   for i in range(4)]), dict(ex.device.stats))
    np.testing.assert_array_equal(results[2][0], results[0][0])
    stats = results[2][1]
    assert stats["wave_fallbacks"] == 1 and stats["wave_graphs"] == 0, stats
    # rows 0, 2 and 3 ran as waves; row 1 went per task
    assert stats["wave_tasks"] == 12 and stats["wave_submits"] == 3, stats


def _host_sync_pool():
    """A chain whose body reads a device value on the host: legal eagerly,
    illegal inside a capture."""
    dc = LocalCollection("D", shape=(4,), init=lambda k: np.zeros(4, np.float32))
    ptg = PTG("sync")
    s = ptg.task_class("s", k="0 .. 3")
    s.affinity("D(0)")
    s.flow("X", INOUT, "<- (k == 0) ? D(0) : X s(k-1)", "-> (k < 3) ? X s(k+1) : D(0)")
    s.body(cuda=lambda X, **_: X + float(X.sum().item()))
    return ptg.taskpool(D=dc)


def test_failed_capture_raises_instead_of_running_eagerly(card):
    ex = GraphExecutor(_host_sync_pool(), device=card)
    with pytest.raises(RuntimeError):
        ex.apply({("D", (0,)): torch.ones(4, device=card)})
    assert ex.replays == 0
    # the card stays usable after the failed capture
    assert torch.equal(torch.ones(2, device=card) + 1, torch.full((2,), 2.0, device=card))
