"""Tiled LU and QR: the port's :mod:`parsec_tpu_torch.ops.lu` and
:mod:`parsec_tpu_torch.ops.qr` against the JAX package's, and a
``<- NEW`` dep's ``[type=NAME]`` / ``[shape=…]`` / ``[dtype=…]``
resolution.

The same numpy-seeded matrix goes through the reference (its Context, its
native engine or its ``GraphExecutor`` on JAX's CPU backend, the Pallas
kernels in interpret mode, as ``tests/collections/test_lu.py`` and
``test_qr.py`` run them) and the port (``Context``, ``run_native`` or
``GraphExecutor`` with the CUDA device module or the executor bound to
the torch CPU device, whose kernel wrappers take their plain versions),
each held to the reference test's tolerance.  CPU chores do the
reference's numpy arithmetic in the same order: their factors are
bit-identical.

``test_qr_graph_batched_levels`` is mirrored in
``tests/test_torch_batch_levels.py``.  Not mirrored:
``test_qr_via_dtd_replay`` (DTD, A.9a) and ``test_lu_distributed_2x2``
(the distributed layer, A.8).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl.native_exec import run_native as ref_run_native  # noqa: E402
from parsec_tpu.dsl.xla_lower import GraphExecutor as RefGraphExecutor  # noqa: E402
from parsec_tpu.ops import lu as ref_lu  # noqa: E402
from parsec_tpu.ops import qr as ref_qr  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import PTG, GraphExecutor  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import run_native  # noqa: E402
from parsec_tpu_torch.ops import (  # noqa: E402
    kernels,
    lu_ptg,
    lu_task_count,
    qr_constants,
    qr_ptg,
    qr_task_count,
    run_lu,
    run_qr,
)
from parsec_tpu_torch.ops.lu import getrf_cuda, getrf_plain  # noqa: E402


def _dd(n, dtype=np.float64, seed=0):
    """Diagonally dominant matrix (no-pivot LU is stable on these)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m + n * np.eye(n, dtype=dtype)


def _mk(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)).astype(dtype)


def _check_lu(A0, packed, rtol):
    n = A0.shape[0]
    L = np.tril(packed, -1) + np.eye(n, dtype=packed.dtype)
    U = np.triu(packed)
    np.testing.assert_allclose(L @ U, A0, rtol=rtol, atol=rtol * np.abs(A0).max())


def _check_r(A, R, rtol):
    """tests/collections/test_qr.py's invariant: R upper, A^T A = R^T R,
    and R equal to numpy's up to row signs."""
    np.testing.assert_allclose(np.tril(R, -1), 0, atol=1e-10 * max(1, np.abs(R).max()))
    np.testing.assert_allclose(R.T @ R, A.T @ A, rtol=rtol,
                               atol=rtol * np.abs(A.T @ A).max())
    R_np = np.linalg.qr(A, mode="r")
    s_ours = np.sign(np.diag(R))
    s_np = np.sign(np.diag(R_np))
    np.testing.assert_allclose(s_ours[:, None] * R, s_np[:, None] * R_np,
                               rtol=rtol, atol=rtol * np.abs(R_np).max())


def _pair(n, nb, A0, dtype):
    ref = RefTiledMatrix(n, n, nb, nb, name="A", dtype=dtype).from_array(A0)
    port = TiledMatrix(n, n, nb, nb, name="A", dtype=dtype).from_array(A0)
    return ref, port


@pytest.fixture
def cpu_device():
    """Bind every CUDA device module (the pump's too) to the torch CPU
    device."""
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


# -- tiled LU (tests/collections/test_lu.py) ------------------------------------

@pytest.mark.parametrize("n,nb", [(64, 32), (96, 32)])
def test_lu_dynamic_cpu_bit_identical(n, nb):
    """CPU chores through both Contexts: the reference's tolerance, and
    bit-identical factors."""
    A0 = _dd(n, seed=n)
    ref, A = _pair(n, nb, A0, np.float64)
    with parsec_tpu.Context(nb_cores=4) as ctx:
        ref_lu.run_lu(ctx, ref, use_tpu=False, use_cpu=True)
    with parsec_tpu_torch.Context(nb_cores=4, devices=["cpu"]) as ctx:
        run_lu(ctx, A, use_cuda=False, use_cpu=True)
    _check_lu(A0, A.to_array(), rtol=1e-10)
    np.testing.assert_array_equal(A.to_array(), ref.to_array())


def test_lu_ragged_last_tile():
    """N % nb != 0 with square tiles: the reference's note — tile-level
    solves and gemms stay shape-consistent."""
    n, nb = 80, 32
    A0 = _dd(n, seed=4)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(A0)
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        run_lu(ctx, A, use_cuda=False)
    _check_lu(A0, A.to_array(), rtol=1e-10)
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        with pytest.raises(ValueError, match="square matrix with square tiles"):
            run_lu(ctx, TiledMatrix(64, 96, 32, 32, name="A"), use_cuda=False)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lu_device_path_matches_reference_graph(use_kernels):
    """Every task on the port's CUDA device module (bound to the torch CPU
    device; ``use_kernels`` through B1 with ``transpose_b=False``, one call
    a gemm task) against the reference's lowered graph (``use_pallas``:
    its interpret-mode kernel), at the reference test's f32 tolerance."""
    n, nb = 128, 32
    A0 = _dd(n, np.float32, seed=5)
    ref, A = _pair(n, nb, A0, np.float32)
    RefGraphExecutor(ref_lu.lu_ptg(use_tpu=True, use_cpu=False,
                                   use_pallas=use_kernels).taskpool(NT=ref.mt, A=ref))(block=True)
    tp = lu_ptg(use_cuda=True, use_cpu=False, use_kernels=use_kernels).taskpool(NT=A.mt, A=A)
    kernels.reset_counts()
    with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
        dev = next(d for d in ctx.devices if d.mca_name == "cuda")
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
        executed = dev.stats["executed_tasks"]
    nt = A.mt
    assert executed == tp.nb_retired == lu_task_count(nt)
    assert kernels.matmul_update.calls == ((nt - 1) * nt * (2 * nt - 1) // 6 if use_kernels else 0)
    _check_lu(A0, A.to_array(), rtol=1e-4)
    np.testing.assert_allclose(A.to_array(), ref.to_array(), rtol=1e-4,
                               atol=1e-4 * np.abs(ref.to_array()).max())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lu_graph_executor(use_kernels):
    """The port's GraphExecutor (eager plan on the torch CPU device) and
    the reference's (tests/collections/test_lu.py::test_lu_graph_lowered)."""
    n, nb = 128, 32
    A0 = _dd(n, np.float32, seed=5)
    ref, A = _pair(n, nb, A0, np.float32)
    RefGraphExecutor(ref_lu.lu_ptg(use_tpu=True, use_cpu=False,
                                   use_pallas=use_kernels).taskpool(NT=ref.mt, A=ref))(block=True)
    GraphExecutor(lu_ptg(use_cuda=True, use_cpu=False, use_kernels=use_kernels).taskpool(
        NT=A.mt, A=A), device="cpu")(block=True)
    _check_lu(A0, A.to_array(), rtol=1e-4)
    np.testing.assert_allclose(A.to_array(), ref.to_array(), rtol=1e-4,
                               atol=1e-4 * np.abs(ref.to_array()).max())


def test_lu_matches_scipy_factors():
    from scipy.linalg import lu as scipy_lu

    n, nb = 64, 16
    A0 = _dd(n, seed=3)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(A0)
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        run_lu(ctx, A, use_cuda=False)
    packed = A.to_array()
    P, L, U = scipy_lu(A0)
    assert np.allclose(P, np.eye(n))
    np.testing.assert_allclose(np.tril(packed, -1), np.tril(L, -1), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.triu(packed), U, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("regime", ["cpu", "pump"])
def test_lu_native_engine(regime, cpu_device):
    """The native engine: CPU chores on its worker threads (bit-identical
    to the reference's native run), and the pump over the CUDA module."""
    n, nb = 96, 32
    A0 = _dd(n, seed=7)
    ref, A = _pair(n, nb, A0, np.float64)
    ref_run_native(ref_lu.lu_ptg(use_tpu=False).taskpool(NT=ref.mt, A=ref), nthreads=4)
    pump = regime == "pump"
    tp = lu_ptg(use_cpu=not pump).taskpool(NT=A.mt, A=A)
    assert run_native(tp, nthreads=4, native_device=pump) == lu_task_count(A.mt)
    _check_lu(A0, A.to_array(), rtol=1e-10)
    if not pump:
        np.testing.assert_array_equal(A.to_array(), ref.to_array())


def test_getrf_tile_bodies_agree():
    """getrf's device body on the torch CPU device IS the reference's
    rank-1 loop (the card runs ``lu_factor_ex(pivot=False)``, held
    against it by chip_smoke), equal to the numpy chore's factor."""
    T = _dd(32, np.float32, seed=9)
    want = T.copy()
    ref_lu.getrf_cpu(want)
    got = getrf_cuda(torch.from_numpy(T))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, getrf_plain(torch.from_numpy(T)))
    ref_dev = np.asarray(ref_lu.getrf_tpu(jax.numpy.asarray(T)))
    np.testing.assert_allclose(got.numpy(), ref_dev, rtol=1e-6, atol=1e-6)


# -- tiled QR (tests/collections/test_qr.py) ------------------------------------

@pytest.mark.parametrize("n,nb", [(64, 32), (96, 32), (128, 32)])
def test_qr_dynamic_cpu_bit_identical(n, nb):
    A0 = _mk(n, seed=n)
    ref, A = _pair(n, nb, A0, np.float64)
    with parsec_tpu.Context(nb_cores=4) as ctx:
        ref_qr.run_qr(ctx, ref, use_tpu=False, use_cpu=True)
    with parsec_tpu_torch.Context(nb_cores=4, devices=["cpu"]) as ctx:
        run_qr(ctx, A, use_cuda=False, use_cpu=True)
    _check_r(A0, A.to_array(), rtol=1e-9)
    np.testing.assert_array_equal(A.to_array(), ref.to_array())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_qr_graph_executor(use_kernels):
    """tests/collections/test_qr.py::test_qr_graph_lowered and
    ::test_qr_graph_pallas_chores: the port's GraphExecutor (eager plan on
    the torch CPU device, tsqrt's (2nb, 2nb) NEW Q from ``[type=QSHAPE2]``)
    against the reference's, at rtol 5e-3."""
    n, nb = 128, 32
    A0 = _mk(n, np.float32, seed=7 if not use_kernels else 12)
    ref, A = _pair(n, nb, A0, np.float32)
    RefGraphExecutor(ref_qr.qr_ptg(use_tpu=True, use_cpu=False, use_pallas=use_kernels).taskpool(
        NT=ref.mt, A=ref, TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float32,
        QSHAPE2=(np.float32, (2 * nb, 2 * nb))))(block=True)
    tp = qr_ptg(use_cuda=True, use_cpu=False, use_kernels=use_kernels).taskpool(
        NT=A.mt, A=A, **qr_constants(A))
    ex = GraphExecutor(tp, device="cpu")
    ex(block=True)
    _check_r(A0, A.to_array(), rtol=5e-3)
    _check_r(A0, ref.to_array(), rtol=5e-3)
    np.testing.assert_allclose(A.to_array(), ref.to_array(), rtol=5e-3,
                               atol=5e-3 * np.abs(ref.to_array()).max())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_qr_device_path(use_kernels):
    """Every task on the CUDA device module (torch CPU device):
    ``use_kernels`` runs unmqr and tsmqr through B2 (``Q^T`` made
    contiguous, ``transpose_b=False``), one call each."""
    n, nb = 128, 32
    A0 = _mk(n, np.float32, seed=13)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(A0)
    kernels.reset_counts()
    with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
        run_qr(ctx, A, use_cpu=False, use_kernels=use_kernels)
        dev = next(d for d in ctx.devices if d.mca_name == "cuda")
        executed = dev.stats["executed_tasks"]
    nt = A.mt
    assert executed == qr_task_count(nt)
    n_mm = nt * (nt - 1) // 2 + (nt - 1) * nt * (2 * nt - 1) // 6
    assert kernels.matmul.calls == (n_mm if use_kernels else 0)
    _check_r(A0, A.to_array(), rtol=5e-3)


@pytest.mark.parametrize("regime", ["cpu", "pump"])
def test_qr_native_engine(regime, cpu_device):
    n, nb = 96, 32
    A0 = _mk(n, seed=9)
    ref, A = _pair(n, nb, A0, np.float64)
    ref_run_native(ref_qr.qr_ptg(use_tpu=False, use_cpu=True).taskpool(
        NT=ref.mt, A=ref, TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float64,
        QSHAPE2=(np.float64, (2 * nb, 2 * nb))), nthreads=4)
    pump = regime == "pump"
    tp = qr_ptg(use_cpu=not pump).taskpool(NT=A.mt, A=A, **qr_constants(A))
    assert run_native(tp, nthreads=4, native_device=pump) == qr_task_count(A.mt)
    _check_r(A0, A.to_array(), rtol=1e-9)
    if not pump:
        np.testing.assert_array_equal(A.to_array(), ref.to_array())


def test_qr_single_tile():
    A0 = _mk(32, seed=10)
    A = TiledMatrix(32, 32, 32, 32, name="A", dtype=np.float64).from_array(A0)
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        run_qr(ctx, A, use_cuda=False, use_cpu=True)
    _check_r(A0, A.to_array(), rtol=1e-10)


def test_qr_rejects_ragged_or_rectangular():
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        bad = TiledMatrix(112, 112, 32, 32, name="A", dtype=np.float64)
        with pytest.raises(ValueError, match="square matrix with uniform"):
            run_qr(ctx, bad, use_cuda=False)
        rect = TiledMatrix(64, 96, 32, 32, name="A", dtype=np.float64)
        with pytest.raises(ValueError, match="square matrix with uniform"):
            run_qr(ctx, rect, use_cuda=False)


# -- NEW deps' property blocks ---------------------------------------------------

def test_new_tile_spec_guarded_otherwise_branch():
    """[type=...] props apply when NEW sits in a guard's else-branch
    (tests/collections/test_qr.py::test_new_tile_spec_guarded_otherwise_branch)."""
    ptg = PTG("probe")
    tc = ptg.task_class("t", i="0 .. 1")
    tc.flow("X", AccessMode.INOUT,
            "<- (i > 0) ? X t(i-1) : NEW [type=XSHAPE]",
            "-> (i < 1) ? X t(i+1)")
    tc.body(cpu=lambda X, **_: None)
    tp = ptg.taskpool(XSHAPE=(np.float32, (3, 5)), TILE_SHAPE=(1,))
    shape, dtype = tp.new_tile_spec("t", "X")
    assert shape == (3, 5) and np.dtype(dtype) == np.float32


@pytest.mark.parametrize("props,want", [
    ("[shape=4x6]", ((4, 6), np.float64)),
    ("[dtype=float32]", ((2, 2), np.float32)),
    ("[type=XDT]", ((2, 2), np.float16)),
    ("[type=NOT_A_CONSTANT]", ((2, 2), np.float64)),
    ("[type=XSHAPE shape=7x1]", ((7, 1), np.float32)),
])
def test_new_tile_spec_property_forms(props, want):
    """``[shape=AxB]``, ``[dtype=NAME]``, ``[type=NAME]`` naming a dtype
    or a (dtype, shape) constant, a ``[type=NAME]`` naming no constant (a
    wire-layout tag: the TILE_* defaults), and an explicit key beside a
    type: each as the reference's ``ReshapeSpec.from_props`` reads it."""
    from parsec_tpu.dsl.ptg import PTG as RefPTG

    consts = dict(XSHAPE=(np.float32, (3, 5)), XDT=np.float16, TILE_SHAPE=(2, 2),
                  TILE_DTYPE=np.float64)
    specs = []
    for P in (PTG, RefPTG):
        ptg = P("probe")
        tc = ptg.task_class("t", i="0 .. 0")
        tc.flow("X", AccessMode.INOUT, f"<- NEW {props}")
        tc.body(cpu=lambda X, **_: None)
        shape, dtype = ptg.taskpool(**consts).new_tile_spec("t", "X")
        specs.append((tuple(shape), np.dtype(dtype)))
    assert specs[0] == specs[1] == (want[0], np.dtype(want[1]))


def test_new_tile_property_block_on_every_runtime(cpu_device):
    """A NEW tile sized by ``[type=NAME]`` reaches the body at that shape on
    the dynamic path, the pump and GraphExecutor."""
    seen = []

    def body(X, O, **_):
        seen.append(tuple(X.shape))
        return X, torch.full(O.shape, float(X.numel()), dtype=O.dtype)

    def pool():
        from parsec_tpu_torch.data import LocalCollection

        O = LocalCollection("O", shape=(2, 2), dtype=np.float64)
        ptg = PTG("newprops")
        tc = ptg.task_class("t", i="0 .. 0")
        tc.affinity("O(i)")
        tc.flow("X", AccessMode.INOUT, "<- NEW [type=QS]")
        tc.flow("O", AccessMode.INOUT, "<- O(i)", "-> O(i)")
        tc.body(cuda=body)
        return ptg.taskpool(O=O, QS=(np.float64, (6, 4)), TILE_SHAPE=(1,)), O

    tp, O = pool()
    with parsec_tpu_torch.Context(nb_cores=1, cuda_device="cpu") as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30), tp.fail_reason
    tp, O = pool()
    assert run_native(tp, native_device=True) == 1
    tp, O = pool()
    GraphExecutor(tp, device="cpu")(block=True)
    assert seen == [(6, 4)] * 3
    np.testing.assert_array_equal(np.asarray(O.data_of(0).newest_copy().payload), 24.0)


def test_reshape_of_incoming_data_still_raises_a8():
    """A property block on a dep that brings data in (not NEW) is a
    reshape request: not ported yet (ROADMAP A.8)."""
    from parsec_tpu_torch.data import LocalCollection

    D = LocalCollection("D", shape=(2, 2))
    ptg = PTG("reshape")
    tc = ptg.task_class("t", i="0 .. 0")
    tc.flow("X", AccessMode.IN, "<- D(i) [dtype=float32]")
    tc.body(cpu=lambda X, **_: None)
    tp = ptg.taskpool(D=D)
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        ctx.add_taskpool(tp)
        assert not tp.wait(timeout=30)
    assert "A.8" in str(tp.fail_reason)


# -- the untransposed B1/B2 launch counters ------------------------------------

@pytest.mark.parametrize("name,mode,transpose_b", [
    ("matmul_update", "f32", False), ("matmul_update", "split", False),
    ("matmul_update", "bf16", False), ("matmul", "f32", False),
    ("matmul_update", "f32", True), ("matmul", "bf16", True)])
def test_untransposed_launches_count_apart(name, mode, transpose_b):
    """A launch with ``transpose_b=False`` counts under its mode's ``_nt``
    key, one with B transposed under the plain mode: the kernel table can
    show the tiled LU/QR and segmented-LU callers' launches."""
    fn = getattr(kernels, name)
    key = kernels._layout_mode(mode, transpose_b)
    assert key == (mode if transpose_b else mode + "_nt")
    assert key in fn.launches_by_mode
    kernels.reset_counts()
    kernels._count_mode(fn, key)
    assert fn.launches == 1
    assert fn.launches_by_mode == {mo: int(mo == key) for mo in fn.launches_by_mode}
    delta = kernels.launch_counts()
    kernels.add_launches(delta, times=2)
    assert fn.launches_by_mode[key] == 3
    kernels.reset_counts()
