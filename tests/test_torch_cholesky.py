"""Whole-slice parity: the port's dpotrf on its CUDA device module against
the JAX package's dpotrf on its TPU device module.

The port's CUDA module is bound to the torch CPU device (the explicit CPU
request; no GPU here), so its kernel chores run the wrappers' plain
versions.  The reference runs through its own Context on JAX's CPU
backend, its Pallas kernels in interpret mode.  Both factor the same
numpy-seeded SPD matrix, handed across as the reference's numpy tiles.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix, from_numpy_tiles  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count, kernels  # noqa: E402


def _spd(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


def _port_dpotrf(A, nb_cores=3, **kw):
    """Run the port's dpotrf with every task on the CUDA module (bound to
    the torch CPU device); returns (taskpool, cuda device stats)."""
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
    with parsec_tpu_torch.Context(nb_cores=nb_cores, cuda_device="cpu") as ctx:
        dev = ctx.devices[1]
        assert dev.mca_name == "cuda" and dev.tdev == torch.device("cpu")
        ctx.add_taskpool(tp)
        ok = tp.wait(timeout=60)
        stats = dict(dev.stats)
    assert ok, tp.fail_reason
    return tp, stats


# (port kwargs, reference kwargs, |LL^T - S| bound): the reference's own
# tolerances, tests/dsl/test_xla_lower.py:95-96 and :144-145
_VARIANTS = {
    "kernels": (dict(use_kernels=True), dict(use_pallas=True), 2e-3),
    "kernels_trtri": (dict(use_kernels=True, use_trtri=True),
                      dict(use_pallas=True, use_trtri=True), 2e-3),
    "kernels_bf16": (dict(use_kernels=True, bf16_updates=True),
                     dict(use_pallas=True, bf16_updates=True), 2e-2),
    "library": (dict(), dict(), 2e-3),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_dpotrf_matches_reference_device_path(variant):
    port_kw, ref_kw, bound = _VARIANTS[variant]
    n, nb = 128, 32
    S = _spd(n, seed=3)
    ref_A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    A = from_numpy_tiles({k: ref_A.data_of(*k).newest_copy().payload
                          for k in ref_A.tiles()}, nb, nb)

    ref_tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False, **ref_kw).taskpool(
        NT=ref_A.mt, A=ref_A)
    with parsec_tpu.Context(nb_cores=2) as ctx:
        ctx.add_taskpool(ref_tp)
        assert ref_tp.wait(timeout=120)
    L_ref = np.tril(ref_A.to_array())

    kernels.reset_counts()
    tp, stats = _port_dpotrf(A, **port_kw)
    L = np.tril(A.to_array())

    trtri = port_kw.get("use_trtri", False)
    ntasks = dpotrf_task_count(A.mt, use_trtri=trtri)
    assert stats["executed_tasks"] == tp.nb_retired == ntasks == ref_tp.nb_retired
    nt = A.mt
    n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    uses = port_kw.get("use_kernels", False)
    assert kernels.matmul_update.calls == (n_upd if uses else 0)
    assert kernels.matmul.calls == (nt * (nt - 1) // 2 if uses and trtri else 0)
    # on the CPU the wrappers take their plain versions: nothing launched
    assert kernels.matmul_update.launches == kernels.matmul.launches == 0

    scale = np.abs(L_ref).max()
    if variant == "kernels_bf16":
        assert np.abs(L - L_ref).max() / scale < 2e-2
    else:
        assert np.abs(L - L_ref).max() / scale < 1e-4
    err = np.abs(L @ L.T - S).max() / np.abs(S).max()
    assert err < bound, err
    if bound == 2e-3:
        np.testing.assert_allclose(L @ L.T, S, rtol=2e-3, atol=2e-3)


def test_bf16_updates_requires_kernels():
    with pytest.raises(ValueError, match="requires use_kernels"):
        cholesky_ptg(use_kernels=False, bf16_updates=True)


def test_small_budget_forces_eviction_writeback():
    """A device budget of a few tiles forces clean evictions and dirty
    write-backs mid-run; the factor must still be right."""
    n, nb = 128, 32
    S = _spd(n, seed=5)
    A = TiledMatrix(n, n, nb, nb, dtype=np.float32).from_array(S)
    mca_param.set_param("device", "cuda_mem_budget_mb", 1)
    try:
        # 1 MB would hold every 4 KiB tile: shrink it after attach
        tp = cholesky_ptg(use_cuda=True, use_cpu=False,
                          use_kernels=True).taskpool(NT=A.mt, A=A)
        with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
            dev = ctx.devices[1]
            assert dev.mem_budget == 1 << 20
            dev.mem_budget = 3 * nb * nb * 4
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60), tp.fail_reason
            stats = dict(dev.stats)
            assert dev.mem_used <= dev.mem_budget
    finally:
        mca_param.unset("device", "cuda_mem_budget_mb")
    assert stats["evictions"] > 0 and stats["bytes_out"] > 0
    L = np.tril(A.to_array())
    np.testing.assert_allclose(L @ L.T, S, rtol=2e-3, atol=2e-3)


def test_lane_polling_mode_matches_eager():
    """cuda_eager_complete=0: completion goes through the in-flight queue
    (events on a GPU; synchronous on the torch CPU device) — same factor."""
    n, nb = 96, 32
    S = _spd(n, seed=6)
    factors = []
    for eager in (1, 0):
        A = TiledMatrix(n, n, nb, nb, dtype=np.float32).from_array(S)
        mca_param.set_param("device", "cuda_eager_complete", eager)
        try:
            _port_dpotrf(A, use_kernels=True)
        finally:
            mca_param.unset("device", "cuda_eager_complete")
        factors.append(np.tril(A.to_array()))
    np.testing.assert_array_equal(factors[0], factors[1])


def test_cpu_device_copies_never_alias_host_tiles():
    """On the torch CPU device, host->device staging must copy: the tiles
    the caller handed in stay untouched while the device copies change."""
    n, nb = 64, 32
    S = _spd(n, seed=7)
    A = TiledMatrix(n, n, nb, nb, dtype=np.float32).from_array(S)
    host = {k: A.data_of(*k).get_copy(0).payload for k in A.tiles() if k[0] >= k[1]}
    before = {k: v.copy() for k, v in host.items()}
    tp = cholesky_ptg(use_cuda=True, use_cpu=False).taskpool(NT=A.mt, A=A)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        for k, v in host.items():
            np.testing.assert_array_equal(v, before[k])
            dev_copy = A.data_of(*k).get_copy(1).payload
            assert not np.shares_memory(dev_copy.numpy(), v)


def test_per_flow_stage_hooks_pack_and_scatter():
    """Custom per-flow staging: stage_in packs the first two rows of the
    tile onto the device, the body works on the packed subtile, and
    stage_out scatters it back into the home layout."""
    from parsec_tpu_torch.core.lifecycle import AccessMode
    from parsec_tpu_torch.data import LocalCollection, host_array
    from parsec_tpu_torch.dsl.ptg import PTG

    home = np.arange(12.0).reshape(4, 3)
    dc = LocalCollection("D", shape=(4, 3), init=lambda k: home.copy())
    ptg = PTG("staged")
    s = ptg.task_class("s", k="0 .. 1")
    s.flow("X", AccessMode.INOUT, "<- (k == 0) ? D(0) : X s(k-1)",
           "-> (k < 1) ? X s(k+1) : D(0)")
    s.body(cuda=lambda X, k: X * 2.0)

    def pack(data, dev):  # the host copy is current: the module flushes first
        return torch.from_numpy(data.get_copy(0).payload[:2].copy())

    def scatter(arr, data, dev):
        full = torch.from_numpy(data.get_copy(0).payload.copy())
        full[:2] = arr
        return full

    s.stage("X", stage_in=pack, stage_out=scatter)
    tp = ptg.taskpool(D=dc)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30), tp.fail_reason
        stats = dict(ctx.devices[1].stats)
    assert stats["custom_stage_in"] == stats["custom_stage_out"] == 2
    want = home.copy()
    want[:2] *= 4.0
    np.testing.assert_array_equal(host_array(dc.data_of(0).newest_copy().payload), want)


def test_cuda_module_without_gpu_or_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default binding succeeds")
    with pytest.raises(RuntimeError, match="is_available"):
        parsec_tpu_torch.Context(nb_cores=1)
    with pytest.raises(RuntimeError, match="is_available"):
        parsec_tpu_torch.Context(nb_cores=1, devices=["cuda"])
    # the explicit CPU request, the MCA switch and a host-only context work
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    try:
        with parsec_tpu_torch.Context(nb_cores=1) as ctx:
            assert ctx.devices[1].tdev == torch.device("cpu")
    finally:
        mca_param.unset("device", "cuda_torch_device")
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        assert [d.mca_name for d in ctx.devices] == ["cpu"]
