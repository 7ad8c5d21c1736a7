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
from tf32_emulation import tf32x3  # noqa: E402


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


@pytest.mark.parametrize("transpose_b", [False, True])
def test_matmul_update_tf32x3_f32_class(transpose_b):
    """The f32 modes' arithmetic: each operand splits into TF32 (hi, lo)
    with hi exact and x - hi exact in f32, and hi*hi + hi*lo + lo*hi (each
    product exact in f32, summed here in float64) lands within 1e-5 of
    float64 and of the Pallas kernel in interpret mode (max error over the
    largest magnitude, as the float64 gates on the card)."""
    rng = np.random.default_rng(13)
    m = n = k = 256
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((n, k) if transpose_b else (k, n)).astype(np.float32)
    C = rng.standard_normal((m, n)).astype(np.float32)
    a_hi, a_lo = tf32x3(_t(A))
    b = _t(B).mT if transpose_b else _t(B)
    b_hi, b_lo = tf32x3(b.contiguous())
    for x, hi, lo in ((_t(A), a_hi, a_lo), (b, b_hi, b_lo)):
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        assert not (lo.view(torch.int32) & 0x1FFF).any()
        assert torch.equal(hi + (x - hi), x)   # x - hi is exact
        resid = (x.double() - hi.double() - lo.double()).abs()
        assert (resid <= 2.0 ** -22 * x.double().abs()).all()
    prod = (a_hi.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
            + a_lo.double() @ b_hi.double())
    out = (_t(C).double() - prod).float().numpy()
    b64 = B.astype(np.float64)
    ref64 = C.astype(np.float64) - A.astype(np.float64) @ (b64.T if transpose_b else b64)
    err = np.abs(out - ref64).max() / np.abs(ref64).max()
    assert err < 1e-5, err
    pal = np.asarray(pk.matmul_update(C, A, B, alpha=-1.0, transpose_b=transpose_b,
                                      bm=128, bn=128, bk=128))
    err_pal = np.abs(out - pal).max() / np.abs(pal).max()
    assert err_pal < 1e-5, err_pal


# (m, n, k): the dpotrf tile, a ragged shape, one slab of one output tile,
# and row pitches that are not 16-byte multiples
_CONFIG_SHAPES = {"tile": (512, 512, 512), "ragged": (500, 300, 200),
                  "tiny": (64, 64, 16), "unaligned": (130, 70, 37)}
# (operand dtype, output dtype, split_f32, has C): the B1 and B2 modes
_CONFIG_MODES = {
    "update_f32": (torch.float32, torch.float32, False, True),
    "update_bf16": (torch.bfloat16, torch.float32, False, True),
    "update_split": (torch.float32, torch.float32, True, True),
    "matmul_f32": (torch.float32, torch.float32, False, False),
    "matmul_bf16": (torch.bfloat16, torch.bfloat16, False, False),
}


@pytest.mark.parametrize("shape", sorted(_CONFIG_SHAPES))
@pytest.mark.parametrize("transpose_b", [True, False])
@pytest.mark.parametrize("mode", sorted(_CONFIG_MODES))
def test_mm_config(mode, transpose_b, shape):
    """The operand mode follows the dtypes, and a 16-byte vector (or a C/O
    pair) is chosen exactly where the row pitch and the base address allow
    it."""
    m, n, k = _CONFIG_SHAPES[shape]
    op, out, split, has_c = _CONFIG_MODES[mode]
    isz, osz = torch.tensor([], dtype=op).element_size(), torch.tensor([], dtype=out).element_size()
    b_pitch = (k if transpose_b else n) * isz
    for shift in (0, isz):  # 16-byte aligned bases, then bases one element off
        ptrs = dict(a_ptr=4096 + shift, b_ptr=8192 + shift, o_ptr=12288 + shift,
                    c_ptr=16384 + shift if has_c else None)
        cfg = kernels._mm_config(m, n, k, operand_dtype=op, out_dtype=out,
                                 transpose_b=transpose_b, split_f32=split, **ptrs)
        assert cfg.mode == ("bf16" if op == torch.bfloat16 else "split" if split else "f32")
        assert cfg.mode in kernels.matmul_update.launches_by_mode
        assert cfg.vec_a == (shift == 0 and (k * isz) % 16 == 0)
        assert cfg.vec_b == (shift == 0 and b_pitch % 16 == 0)
        pairs = shift % (2 * osz) == 0 and (not has_c or shift % 8 == 0)
        assert cfg.vec_c == (n % 2 == 0 and pairs)


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
    assert not any(kernels.matmul_update.launches_by_mode.values())
    assert not any(kernels.matmul.launches_by_mode.values())
    kernels.reset_counts()
    assert kernels.matmul.calls == 0


@pytest.mark.parametrize("name, mode", [("matmul_update", "f32"), ("matmul_update", "bf16"),
                                        ("matmul_update", "split"), ("matmul", "f32"),
                                        ("matmul", "bf16"), ("matmul_update", "f32_nt"),
                                        ("matmul_update", "bf16_nt"),
                                        ("matmul_update", "split_nt"), ("matmul", "f32_nt"),
                                        ("matmul", "bf16_nt")])
def test_launch_counts_by_mode(name, mode):
    """A B1/B2 launch adds one to the wrapper's total and to its mode's
    count, and reset_counts zeroes both."""
    fn = getattr(kernels, name)
    kernels.reset_counts()
    kernels._count_mode(fn, mode)
    kernels._count_mode(fn, mode)
    assert fn.launches == 2
    assert fn.launches_by_mode == {mo: 2 if mo == mode else 0 for mo in fn.launches_by_mode}
    kernels.reset_counts()
    assert fn.launches == 0 and not any(fn.launches_by_mode.values())


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
    # B1/B2 run on the tensor cores, with no atomics and no library GEMM
    mm = (kernels._PKG / "csrc" / "matmul.cu").read_text()
    assert "wgmma.mma_async" in mm and "cvt.rna.tf32.f32" in mm
    for banned in ("atomicadd", "atomiccas", "cublas", "cutlass", "fmaf("):
        assert banned not in mm.lower()
    # the kernel sizes its shared memory from the mode and refuses to build
    # a stage layout above the 227 KB one block may opt in to on an H100
    assert "SMEM_LIMIT = 232448;" in mm
    assert "static_assert(SMEM <= SMEM_LIMIT" in mm
    # exp(0) must be exactly 1 for the attention kernel's exact no-op cases
    assert "use_fast_math" not in " ".join(kernels._NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in kernels._NVCC_FLAGS
    root = pathlib.Path(__file__).resolve().parent.parent
    ignored = (root / ".gitignore").read_text().split()
    assert kernels._BUILD_DIR.relative_to(root).as_posix() + "/" in ignored


def test_attention_kernel_source():
    """B5's engine runs both products on the tensor cores in both modes
    (mma.sync: bf16 m16n8k16, three TF32 passes of m16n8k8), streams K/V
    with cp.async, uses no atomics, no library and no FP32-FMA product
    loop, keeps expf for the exact no-op cases, and refuses to build a
    tile layout above the 227 KB one block may opt in to; the wide kernel
    for D > 256 is FP32 FMA with expf and no atomics."""
    full = (kernels._PKG / "csrc" / "attention.cu").read_text()
    # the wide kernel (D > 256) is FP32 FMA by design; the engine is not
    src, wide = full.split("// -- the wide kernel (D > D_ENGINE)")
    assert "fmaf(" in wide and "expf(" in wide and "__syncthreads" in wide
    for banned in ("atomicadd", "atomiccas", "atom.", "__expf("):
        assert banned not in wide.lower(), banned
    for needed in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global", "expf(", "SMEM_LIMIT = 232448;",
                   "static_assert(SMEM <= SMEM_LIMIT"):
        assert needed in src, needed
    for banned in ("atomicadd", "atomiccas", "atom.", "cublas", "cudnn", "cutlass",
                   "fmaf(", "__expf("):
        assert banned not in src.lower(), banned



def test_stencil_kernel_source():
    """B3 takes 16-byte groups with neighbours through shuffles and
    streaming stores; B4's smem mode exchanges edge rows as step-tagged
    words read and written at gpu scope, under a cooperative launch;
    neither uses atomics or an FMA, nor reads a library."""
    src = (kernels._PKG / "csrc" / "stencil.cu").read_text()
    for needed in ("__shfl_up_sync", "__shfl_down_sync", "__stcs(", "__ldg(",
                   "st.relaxed.gpu.global.b64", "ld.relaxed.gpu.global.b64",
                   "cudaLaunchCooperativeKernel", "cudaDevAttrMaxSharedMemoryPerBlockOptin",
                   "__float2half_rn", "__float2bfloat16_rn", "grid.sync()"):
        assert needed in src, needed
    for banned in ("atomicadd", "atomiccas", "atom.", "fmaf(", "fma(", "__fmul_rn",
                   "cublas", "cudnn", "cutlass"):
        assert banned not in src.lower(), banned
    # the smem mode's limits are the ones _fused_mode plans with
    assert f"FUSED_SMEM_THREADS = {kernels._FUSED_SMEM_THREADS};" in src
    assert "sizeof(T) == 8 ? 2 : 4" in src and kernels._FUSED_SLOTS == {8: 2, 4: 4, 2: 4}
