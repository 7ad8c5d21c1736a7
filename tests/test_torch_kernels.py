"""The port's hand-kernel wrappers (parsec_tpu_torch.ops.kernels) against
the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (a CUDA kernel
cannot run here); the Pallas kernels run in interpret mode, as
tests/runtime/test_pallas_kernels.py runs them off-TPU.  Inputs come from
numpy seeds and cross between the frameworks as numpy arrays.  The CUDA
kernels themselves are held against the same plain versions on the card
by chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x):
    """float32 values rounded to bfloat16, as numpy float32 (both
    frameworks then see the same bf16 operands)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# (C shape, A shape, B shape, kwargs, pallas block kwargs, tolerance):
# the cases and tolerances of tests/runtime/test_pallas_kernels.py, plus a
# ragged shape no Pallas block size tiles evenly
_UPDATE_CASES = {
    "syrk": ((256, 256), (256, 128), None, dict(alpha=-1.0), {}, 1e-5),
    "gemm_blocked": ((256, 384), (256, 512), (384, 512), dict(alpha=-1.0),
                     dict(bm=128, bn=128, bk=128), 1e-4),
    "no_transpose_pos_alpha": ((128, 128), (128, 256), (256, 128),
                               dict(alpha=1.0, transpose_b=False),
                               dict(bk=128), 1e-4),
    "ragged": ((200, 136), (200, 72), (136, 72), dict(alpha=-0.5), {}, 1e-4),
}


@pytest.mark.parametrize("case", sorted(_UPDATE_CASES))
def test_matmul_update_matches_pallas(case):
    cs, as_, bs, kw, blocks, tol = _UPDATE_CASES[case]
    rng = np.random.default_rng(sorted(_UPDATE_CASES).index(case))
    C = rng.standard_normal(cs).astype(np.float32)
    A = rng.standard_normal(as_).astype(np.float32)
    B = A if bs is None else rng.standard_normal(bs).astype(np.float32)
    ref = np.asarray(pk.matmul_update(jnp.asarray(C), jnp.asarray(A),
                                      jnp.asarray(B), **kw, **blocks))
    out = kernels.matmul_update(_t(C), _t(A), _t(B), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(256, 256, 256), (200, 136, 72)])
def test_matmul_update_bf16_operands_match_pallas(shape):
    """bf16 operands with an f32 C: products are exact in f32 on both
    sides, so only the summation order differs."""
    m, n, k = shape
    rng = np.random.default_rng(11)
    C = rng.standard_normal((m, n)).astype(np.float32)
    A = _bf16(rng.standard_normal((m, k)).astype(np.float32))
    B = _bf16(rng.standard_normal((n, k)).astype(np.float32))
    ref = np.asarray(pk.matmul_update(
        jnp.asarray(C), jnp.asarray(A, jnp.bfloat16),
        jnp.asarray(B, jnp.bfloat16), alpha=-1.0))
    out = kernels.matmul_update(_t(C), _t(A).to(torch.bfloat16),
                                _t(B).to(torch.bfloat16), alpha=-1.0).numpy()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err < 1e-3, err


@pytest.mark.parametrize("transpose_b", [False, True])
def test_matmul_update_split_f32_f32_class(transpose_b):
    """split_f32: the (hi, lo) bf16 decomposition with three cross terms
    lands in the f32 class against f64 (< 1e-5, the Pallas test's bound),
    and agrees with the Pallas kernel."""
    rng = np.random.default_rng(9)
    m = n = k = 256
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((n, k) if transpose_b else (k, n)).astype(np.float32)
    C = rng.standard_normal((m, n)).astype(np.float32)
    b64 = B.astype(np.float64)
    ref64 = C.astype(np.float64) - A.astype(np.float64) @ (b64.T if transpose_b else b64)
    out = kernels.matmul_update(_t(C), _t(A), _t(B), alpha=-1.0,
                                transpose_b=transpose_b, split_f32=True).numpy()
    err = np.abs(out - ref64).max() / np.abs(ref64).max()
    assert err < 1e-5, err
    pal = np.asarray(pk.matmul_update(C, A, B, alpha=-1.0, transpose_b=transpose_b,
                                      split_f32=True, bm=128, bn=128, bk=128))
    np.testing.assert_allclose(out, pal, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["blocked_t", "no_transpose", "ragged"])
def test_matmul_matches_pallas(case):
    rng = np.random.default_rng(8)
    if case == "blocked_t":
        A = rng.standard_normal((256, 128)).astype(np.float32)
        B = rng.standard_normal((192, 128)).astype(np.float32)
        kw, blocks = dict(transpose_b=True), dict(bm=128, bn=64, bk=128)
    elif case == "no_transpose":
        A0 = rng.standard_normal((256, 128)).astype(np.float32)
        A, B = np.ascontiguousarray(A0.T), A0
        kw, blocks = dict(transpose_b=False), {}
    else:
        A = rng.standard_normal((100, 60)).astype(np.float32)
        B = rng.standard_normal((70, 60)).astype(np.float32)
        kw, blocks = dict(transpose_b=True), {}
    ref = np.asarray(pk.matmul(jnp.asarray(A), jnp.asarray(B), **kw, **blocks))
    out = kernels.matmul(_t(A), _t(B), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _ok_update_args():
    return (torch.zeros(4, 6), torch.zeros(4, 3), torch.zeros(6, 3))


@pytest.mark.parametrize("bad", [
    "dtype_f64", "mixed_dtypes", "c_dtype", "inner_dim", "c_shape",
    "noncontiguous", "not_2d", "split_bf16", "meta_device",
])
def test_matmul_update_rejects_bad_input(bad):
    C, A, B = _ok_update_args()
    kw = {}
    err = ValueError
    if bad == "dtype_f64":
        A, B, err = A.double(), B.double(), TypeError
    elif bad == "mixed_dtypes":
        B, err = B.to(torch.bfloat16), TypeError
    elif bad == "c_dtype":
        C = C.double()
    elif bad == "inner_dim":
        B = torch.zeros(6, 4)
    elif bad == "c_shape":
        C = torch.zeros(6, 4)
    elif bad == "noncontiguous":
        B = torch.zeros(3, 6).mT
    elif bad == "not_2d":
        A = torch.zeros(4, 3, 1)
    elif bad == "split_bf16":
        A, B = A.to(torch.bfloat16), B.to(torch.bfloat16)
        kw, err = dict(split_f32=True), TypeError
    elif bad == "meta_device":
        C, A, B = C.to("meta"), A.to("meta"), B.to("meta")
    with pytest.raises(err):
        kernels.matmul_update(C, A, B, **kw)


@pytest.mark.parametrize("bad", ["dtype_f64", "inner_dim", "noncontiguous"])
def test_matmul_rejects_bad_input(bad):
    A, B, err = torch.zeros(4, 3), torch.zeros(6, 3), ValueError
    if bad == "dtype_f64":
        A, B, err = A.double(), B.double(), TypeError
    elif bad == "inner_dim":
        B = torch.zeros(6, 5)
    else:
        A = torch.zeros(3, 4).mT
    with pytest.raises(err):
        kernels.matmul(A, B)


def test_counters_count_calls_but_no_launch_on_cpu():
    """A kernel launch is counted only where it happens: on the CPU the
    wrapper's plain version runs and ``launches`` stays put."""
    kernels.reset_counts()
    C, A, B = (torch.ones(8, 8),) * 3
    kernels.matmul_update(C, A, B)
    kernels.matmul(A, B)
    kernels.matmul(A, B, transpose_b=False)
    assert (kernels.matmul_update.calls, kernels.matmul.calls) == (1, 2)
    assert (kernels.matmul_update.launches, kernels.matmul.launches) == (0, 0)
    kernels.reset_counts()
    assert kernels.matmul.calls == 0


def test_kernel_sources_and_build_flags():
    """The build is nvcc route (b): one sm_90a shared library with a plain
    C interface, built from the package's own sources into a directory
    .gitignore lists."""
    import pathlib

    srcs = [pathlib.Path(p) for p in kernels._SOURCES]
    assert all(p.exists() and p.suffix == ".cu" for p in srcs)
    text = "".join(p.read_text() for p in srcs)
    assert sorted(p.name for p in srcs) == ["attention.cu", "matmul.cu", "stencil.cu"]
    for sym in ("ptt_matmul_update", "ptt_matmul", "ptt_flash_attention_block",
                "ptt_stencil_5pt", "ptt_stencil_5pt_fused", "cudaGetLastError",
                "cudaLaunchCooperativeKernel", "cudaDevAttrCooperativeLaunch"):
        assert sym in text
    # exp(0) must be exactly 1 for the attention kernel's exact no-op cases
    assert "use_fast_math" not in " ".join(kernels._NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in kernels._NVCC_FLAGS
    root = pathlib.Path(__file__).resolve().parent.parent
    ignored = (root / ".gitignore").read_text().split()
    assert kernels._BUILD_DIR.relative_to(root).as_posix() + "/" in ignored
