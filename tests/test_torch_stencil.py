"""The port's 5-point stencil (parsec_tpu_torch.ops.stencil and the B3/B4
kernel wrappers) against the JAX package's.

The wrappers run their plain PyTorch versions here (a CUDA kernel cannot
run on the CPU) against ``pallas_kernels.stencil_5pt`` and
``stencil_5pt_fused`` in interpret mode.  The stencil PTG's host chores do
the same numpy arithmetic in the same order as the JAX package's, so their
grids must be bit-identical; its kernel chores run on the port's CUDA
device module bound to the torch CPU device.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu.ops import tiles as ref_tiles  # noqa: E402
from parsec_tpu_torch.ops import kernels, stencil, tiles  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _halo_case(seed, h, w, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(dtype)  # noqa: E731
    # the halo columns are the facing edge columns of wider neighbour
    # tiles, as the stencil chore passes them
    return mk(h, w), mk(1, w), mk(1, w), mk(h, 5), mk(h, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(16, 128), (37, 20)])
def test_stencil_5pt_matches_pallas(dtype, shape):
    old, up, down, lt, rt = _halo_case(3, *shape, dtype)
    left, right = _t(lt)[:, -1:], _t(rt)[:, :1]   # strided views
    assert not left.is_contiguous() and left.stride(0) == 5
    out = kernels.stencil_5pt(_t(old), _t(up), _t(down), left, right)
    assert out.dtype == _t(old).dtype
    ref = np.asarray(pk.stencil_5pt(*map(jnp.asarray, (old, up, down, lt[:, -1:],
                                                        rt[:, :1]))))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    # and the stencil module's zero-padded formula
    pad = np.zeros((shape[0] + 2, shape[1] + 2), dtype)
    pad[1:-1, 1:-1], pad[0, 1:-1], pad[-1, 1:-1] = old, up[0], down[0]
    pad[1:-1, 0], pad[1:-1, -1] = lt[:, -1], rt[:, 0]
    formula = 0.25 * (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:])
    np.testing.assert_array_equal(out.numpy(), formula)


@pytest.mark.parametrize("dtype,iters", [(np.float32, 5), (np.float64, 7),
                                         (np.float32, 1)])
def test_stencil_5pt_fused_matches_pallas(dtype, iters):
    g = np.random.default_rng(4).standard_normal((32, 128)).astype(dtype)
    out = kernels.stencil_5pt_fused(_t(g), iters)
    ref = np.asarray(pk.stencil_5pt_fused(jnp.asarray(g), iters))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), stencil.reference_stencil(g, iters),
                               rtol=1e-5, atol=1e-5)


def test_stencil_5pt_fused_zero_iters_is_a_copy():
    g = _t(np.random.default_rng(5).standard_normal((8, 8)).astype(np.float32))
    out = kernels.stencil_5pt_fused(g, 0)
    assert torch.equal(out, g) and out.data_ptr() != g.data_ptr()


def _ok_halos(h=4, w=6, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype) for s in ((h, w), (1, w), (1, w), (h, 1), (h, 1))]


@pytest.mark.parametrize("bad", [
    "old_f16", "old_int", "mixed_dtype", "up_shape", "left_shape", "old_noncontig",
    "up_noncontig", "not_2d", "empty", "halo_not_tensor", "meta_device",
])
def test_stencil_5pt_rejects_bad_input(bad):
    args = _ok_halos()
    err = ValueError
    if bad == "old_f16":
        args, err = [a.half() for a in args], TypeError
    elif bad == "old_int":
        args, err = [a.int() for a in args], TypeError
    elif bad == "mixed_dtype":
        args[3], err = args[3].double(), TypeError
    elif bad == "up_shape":
        args[1] = torch.zeros(1, 5)
    elif bad == "left_shape":
        args[3] = torch.zeros(3, 1)
    elif bad == "old_noncontig":
        args[0] = torch.zeros(6, 4).mT
    elif bad == "up_noncontig":
        args[1] = torch.zeros(6, 2)[:, :1].mT
    elif bad == "not_2d":
        args[0] = torch.zeros(4, 6, 1)
    elif bad == "empty":
        args = [torch.zeros(s) for s in ((0, 6), (1, 6), (1, 6), (0, 1), (0, 1))]
    elif bad == "halo_not_tensor":
        args[2], err = np.zeros((1, 6), np.float32), TypeError
    elif bad == "meta_device":
        args = [a.to("meta") for a in args]
    with pytest.raises(err):
        kernels.stencil_5pt(*args)


@pytest.mark.parametrize("bad", ["negative_iters", "fractional_iters", "bf16", "1d",
                                 "noncontig"])
def test_stencil_5pt_fused_rejects_bad_input(bad):
    g, iters, err = torch.zeros(4, 6), 2, ValueError
    if bad == "negative_iters":
        iters = -1
    elif bad == "fractional_iters":
        iters = 1.5
    elif bad == "bf16":
        g, err = g.to(torch.bfloat16), TypeError
    elif bad == "1d":
        g = torch.zeros(6)
    else:
        g = torch.zeros(6, 4).mT
    with pytest.raises(err):
        kernels.stencil_5pt_fused(g, iters)


def test_stencil_wrappers_count_calls_not_launches_on_cpu():
    kernels.reset_counts()
    kernels.stencil_5pt(*_ok_halos())
    kernels.stencil_5pt_fused(torch.zeros(4, 4), 3)
    kernels.stencil_5pt_fused(torch.zeros(4, 4), 0)
    assert (kernels.stencil_5pt.calls, kernels.stencil_5pt_fused.calls) == (1, 2)
    assert (kernels.stencil_5pt.launches, kernels.stencil_5pt_fused.launches) == (0, 0)
    kernels.reset_counts()
    assert kernels.stencil_5pt_fused.calls == 0


# -- the stencil PTG --------------------------------------------------------

def _run_ref(grid, mt, nt, iters, **kw):
    A = ref_stencil.StencilBuffers(grid, mt, nt)
    tp = ref_stencil.stencil_ptg(**kw).taskpool(T=iters, MT=mt, NT=nt, A=A)
    # host chores on a host-only context; the Pallas chore on the JAX
    # package's own device module (JAX's CPU backend, interpret mode)
    devices = None if kw.get("use_pallas") else ["cpu"]
    with parsec_tpu.Context(nb_cores=3, devices=devices) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    return A.to_array(iters % 2)


def _run_port(grid, mt, nt, iters, ctx_kw, **kw):
    A = stencil.StencilBuffers(grid, mt, nt)
    tp = stencil.stencil_ptg(**kw).taskpool(T=iters, MT=mt, NT=nt, A=A)
    with parsec_tpu_torch.Context(nb_cores=3, **ctx_kw) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
        executed = sum(d.stats["executed_tasks"] for d in ctx.devices)
        on_cuda = [d.stats["executed_tasks"] for d in ctx.devices if d.mca_name == "cuda"]
        out = A.to_array(iters % 2)
    assert executed == iters * mt * nt
    return out, on_cuda


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("iters,mt,nt", [(1, 4, 3), (2, 4, 3), (5, 4, 3), (3, 1, 1)])
def test_host_stencil_bit_identical_to_reference(dtype, iters, mt, nt):
    grid = np.random.default_rng(0).standard_normal((32, 48)).astype(dtype)
    mine, _ = _run_port(grid, mt, nt, iters, dict(devices=["cpu"]),
                        use_cuda=False, use_cpu=True)
    theirs = _run_ref(grid, mt, nt, iters, use_tpu=False, use_cpu=True)
    assert mine.dtype == theirs.dtype == dtype
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(mine, stencil.reference_stencil(grid, iters))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chore", ["kernels", "torch"])
def test_device_stencil_matches_reference(dtype, chore):
    """Every task on the CUDA module (bound to the torch CPU device): the B3
    wrapper's chore and the plain-torch chore match the host result and the
    JAX package's Pallas chore within 1e-6."""
    grid = np.random.default_rng(2).standard_normal((16, 24)).astype(dtype)
    kw = dict(use_kernels=True) if chore == "kernels" else dict(use_cuda=True)
    kernels.reset_counts()
    mine, on_cuda = _run_port(grid, 2, 2, 3, dict(cuda_device="cpu"),
                              use_cpu=False, **kw)
    assert on_cuda == [12]
    assert kernels.stencil_5pt.calls == (12 if chore == "kernels" else 0)
    host = stencil.reference_stencil(grid, 3)
    np.testing.assert_allclose(mine, host, rtol=1e-6, atol=1e-6)
    if dtype == np.float32:
        theirs = _run_ref(grid, 2, 2, 3, use_pallas=True, use_cpu=False)
        np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=1e-6)


def test_apply_5pt_torch_branch_equals_numpy_branch():
    rng = np.random.default_rng(6)
    tiles5 = [rng.standard_normal((6, 7)) for _ in range(5)]
    for drop in (None, 1, 2, 3, 4):
        np_args = [None if i == drop else a for i, a in enumerate(tiles5)]
        t_args = [None if a is None else _t(a) for a in np_args]
        np.testing.assert_array_equal(stencil._apply_5pt(torch, *t_args).numpy(),
                                      stencil._apply_5pt(np, *np_args))


def test_stencil_builders_reject_bad_input():
    with pytest.raises(ValueError, match="not divisible"):
        stencil.StencilBuffers(np.zeros((10, 12)), 3, 4)
    with pytest.raises(ValueError, match="no BODY"):
        stencil.stencil_ptg(use_cuda=False, use_kernels=False, use_cpu=False)


@pytest.mark.parametrize("args", [
    (10, 5, {}), (10, 3, dict(allow_ragged=True)), (10, 3, {}), (0, 4, {}),
    (8, -2, {}), (8, 2.5, {}), (7.0, 7, {}),
])
def test_check_tiling_matches_reference(args):
    n, nb, kw = args

    def outcome(fn):
        try:
            return fn(n, nb, what="rows", op="t", **kw)
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tiles.check_tiling) == outcome(ref_tiles.check_tiling)
