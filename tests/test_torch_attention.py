"""The port's flash attention (parsec_tpu_torch.ops.attention and the B5
kernel wrapper) against the JAX package's.

The B5 wrapper runs its plain PyTorch version here (a CUDA kernel cannot
run on the CPU) against ``pallas_kernels.flash_attention_block`` in
interpret mode, on the cases of tests/runtime/test_pallas_kernels.py.  The
graph runs on the port's CUDA device module bound to the torch CPU device
(``Context(cuda_device="cpu")``, so every step goes through the B5
wrapper) and on host chores, against the JAX package's graph on its own
Context and against both packages' ``attention_reference``.  Inputs come
from numpy seeds; bfloat16 inputs cross as float32 numpy arrays already
rounded to bfloat16, so both packages see identical values.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu.parallel import attention_reference as jax_attention_reference  # noqa: E402
from parsec_tpu_torch.ops import attention, kernels  # noqa: E402
from parsec_tpu_torch.parallel import attention_reference  # noqa: E402
from tf32_emulation import tf32, tf32x3  # noqa: E402

B, S, H, D = 1, 48, 2, 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x):
    """float32 values rounded to bfloat16 (round to nearest even), as numpy
    float32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _qkv(seed, dtype="float32", s=S, b=B, h=H, d=D):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.standard_normal((b, s, h, d)).astype(np.float32)
        out.append(_bf16(a) if dtype == "bfloat16" else a)
    return out


def _jax_in(a, dtype):
    return np.asarray(jnp.asarray(a, dtype=jnp.bfloat16)) if dtype == "bfloat16" else a


def _port_in(a, dtype):
    t = _t(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _dense(q, k, v, causal):
    return np.asarray(jax_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), causal=causal))


@pytest.fixture(scope="module")
def ref_ctx():
    c = parsec_tpu.Context(nb_cores=4)
    yield c
    c.fini()


@pytest.fixture(scope="module")
def port_ctx():
    """The port's CUDA device module bound to the torch CPU device."""
    c = parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu")
    assert [d.mca_name for d in c.devices] == ["cpu", "cuda"]
    yield c
    c.fini()


@pytest.fixture(scope="module")
def host_ctx():
    c = parsec_tpu_torch.Context(nb_cores=3, devices=["cpu"])
    yield c
    c.fini()


# -- B5: the kernel wrapper against the Pallas kernel ------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_accumulates_to_dense_like_pallas(causal):
    """Feeding four K/V blocks through the online update gives dense
    softmax attention, and each carry matches the Pallas kernel's."""
    rng = np.random.default_rng(5)
    Sq, Sk, d, R = 128, 128, 64, 4
    scale = 1.0 / np.sqrt(d)
    q = rng.standard_normal((Sq, d)).astype(np.float32)
    ks = [rng.standard_normal((Sk, d)).astype(np.float32) for _ in range(R)]
    vs = [rng.standard_normal((Sk, d)).astype(np.float32) for _ in range(R)]
    q_off = (R - 1) * Sk
    carry = (torch.zeros(Sq, d), torch.full((Sq, 1), -1e30), torch.zeros(Sq, 1))
    jcarry = (jnp.zeros((Sq, d), jnp.float32), jnp.full((Sq, 1), -1e30, jnp.float32),
              jnp.zeros((Sq, 1), jnp.float32))
    for r in range(R):
        carry = kernels.flash_attention_block(_t(q), _t(ks[r]), _t(vs[r]), *carry,
                                              q_off, r * Sk, causal=causal,
                                              scale=float(scale))
        jcarry = pk.flash_attention_block(jnp.asarray(q), jnp.asarray(ks[r]),
                                          jnp.asarray(vs[r]), *jcarry, q_off, r * Sk,
                                          causal=causal, scale=float(scale))
        for mine, theirs in zip(carry, jcarry):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=1e-4, atol=1e-4)
    out = (carry[0] / carry[2]).numpy()
    K, V = np.concatenate(ks, 0), np.concatenate(vs, 0)
    logits = (q @ K.T) * scale
    if causal:
        qpos = q_off + np.arange(Sq)[:, None]
        logits = np.where(qpos >= np.arange(R * Sk)[None, :], logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    np.testing.assert_allclose(out, w @ V, rtol=1e-4, atol=1e-4)


def _block_inputs(seed, Sq, Sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((Sq, d), (Sk, d), (Sk, d))]


def test_flash_block_future_block_leaves_carry_exactly():
    """A K/V block entirely in the future must not change a (m=0, l=1)
    carry: exactly, on both sides."""
    q, k, v = _block_inputs(6, 128, 128, 32)
    acc0 = np.random.default_rng(60).standard_normal((128, 32)).astype(np.float32)
    m0, l0 = np.zeros((128, 1), np.float32), np.ones((128, 1), np.float32)
    acc, m, l = kernels.flash_attention_block(_t(q), _t(k), _t(v), _t(acc0), _t(m0),
                                              _t(l0), 0, 128, causal=True, scale=0.1)
    ja, jm, jl = pk.flash_attention_block(*map(jnp.asarray, (q, k, v, acc0, m0, l0)),
                                          0, 128, causal=True, scale=0.1)
    for mine, theirs, init in ((acc, ja, acc0), (m, jm, m0), (l, jl, l0)):
        np.testing.assert_array_equal(mine.numpy(), init)
        np.testing.assert_array_equal(np.asarray(theirs), init)


def test_flash_block_masked_block_at_init_carry_is_exact():
    """A fully masked block met while the carry is at its -1e30/0/0 init
    leaves acc = 0, l = 0 and m bit-identical."""
    q, k, v = _block_inputs(7, 128, 128, 32)
    acc0 = torch.zeros(128, 32)
    m0 = torch.full((128, 1), attention.NEG_BIG)
    l0 = torch.zeros(128, 1)
    acc, m, l = kernels.flash_attention_block(_t(q), _t(k), _t(v), acc0, m0, l0,
                                              0, 128, causal=True, scale=0.1)
    assert float(acc.abs().max()) == 0.0
    assert float(l.abs().max()) == 0.0
    assert torch.equal(m, m0)
    _, jm, _ = pk.flash_attention_block(
        *map(jnp.asarray, (q, k, v, acc0.numpy(), m0.numpy(), l0.numpy())),
        0, 128, causal=True, scale=0.1)
    np.testing.assert_array_equal(np.asarray(jm), m.numpy())


@pytest.mark.parametrize("case", ["ragged_decode_tail", "bf16"])
def test_flash_block_matches_pallas(case):
    """The decode path's ragged tail (96 queries against a 416-key block,
    at the offsets the path gives it) and bfloat16 operands."""
    rng = np.random.default_rng(8)
    if case == "ragged_decode_tail":
        Sq, Sk, d, q_off, k_off, dtype = 96, 416, 32, 3904, 3584, "float32"
    else:
        Sq, Sk, d, q_off, k_off, dtype = 128, 96, 64, 0, 0, "bfloat16"
    q, k, v = _block_inputs(80, Sq, Sk, d)
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    acc0 = rng.standard_normal((Sq, d)).astype(np.float32)
    m0 = rng.standard_normal((Sq, 1)).astype(np.float32)
    l0 = np.abs(rng.standard_normal((Sq, 1))).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    mine = kernels.flash_attention_block(
        *(_port_in(x, dtype) for x in (q, k, v)), _t(acc0), _t(m0), _t(l0),
        q_off, k_off, causal=True, scale=scale)
    theirs = pk.flash_attention_block(
        *(jnp.asarray(_jax_in(x, dtype)) for x in (q, k, v)),
        *map(jnp.asarray, (acc0, m0, l0)), q_off, k_off, causal=True, scale=scale)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


# -- the CUDA kernel's arithmetic, emulated in plain torch ---------------------
#
# csrc/attention.cu cannot run here.  These tests emulate what it does -- the
# keys of each 64-key chunk split over four warps' partial carries, combined
# in warp order; 3xTF32 products in f32; p split into bf16 hi and lo in bf16
# -- and hold that arithmetic against the Pallas kernel and float64.

_CHUNK, _WARPS = 64, 4


def _f32_dot(a, b):
    """a @ b.T with products and sums in float64, rounded to float32 once."""
    return (a.double() @ b.double().mT).float()


def _tf32x3_dot(a, b):
    """a @ b.T as the f32 kernel computes it: each operand split into TF32
    hi and lo; per k step of 8, hi*lo + lo*hi and hi*hi as two fresh tiles
    (each product exact, summed here in float64) whose sum is added to the
    f32 total."""
    a_hi, a_lo = tf32x3(a.contiguous())
    b_hi, b_lo = tf32x3(b.contiguous())
    out = torch.zeros(a.shape[0], b.shape[0])
    for kk in range(0, a.shape[1], 8):
        s = slice(kk, kk + 8)
        lo = (a_hi[:, s].double() @ b_lo[:, s].double().mT
              + a_lo[:, s].double() @ b_hi[:, s].double().mT).float()
        hi = (a_hi[:, s].double() @ b_hi[:, s].double().mT).float()
        out = out + (lo + hi)
    return out


def _pv_f32(p, v):
    return _f32_dot(p, v.mT.contiguous())


def _pv_tf32x3(p, v):
    return _tf32x3_dot(p, v.mT.contiguous())


def _pv_bf16_split(p, v):
    """p @ v with p split into bf16 hi and lo (round to nearest even), lo.v
    then hi.v: the bf16 kernel's two passes."""
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return (lo.double() @ v.double() + hi.double() @ v.double()).float()


def _pv_bf16_single(p, v):
    return (p.to(torch.bfloat16).double() @ v.double()).float()


def _warp_split_update(q, k, v, acc, m, l, q_off, k_off, *, causal, scale,
                       qk=_f32_dot, pv=_pv_f32):
    """The kernel's update: warp w of 4 takes keys [16w, 16w + 16) of every
    64-key chunk and keeps a partial carry (m_w from the incoming m, l_w and
    acc_w from 0); the partials are combined in warp order.  A key slice
    masked for every row is visited here and skipped by the kernel: the same
    identity step either way."""
    sq, sk = q.shape[0], k.shape[0]
    kw = _CHUNK // _WARPS
    m_w = [m.clone() for _ in range(_WARPS)]
    l_w = [torch.zeros_like(l) for _ in range(_WARPS)]
    acc_w = [torch.zeros_like(acc) for _ in range(_WARPS)]
    qpos = q_off + torch.arange(sq)[:, None]
    for kc in range(0, sk, _CHUNK):
        for w in range(_WARPS):
            k0 = kc + kw * w
            if k0 >= sk:
                continue
            k1 = min(k0 + kw, sk)
            s = qk(q, k[k0:k1]) * scale
            if causal:
                s = s.masked_fill(qpos < k_off + torch.arange(k0, k1)[None, :],
                                  float("-inf"))
            m_new = torch.maximum(m_w[w], s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m_w[w] - m_new)
            p = torch.exp(s - m_new)
            l_w[w] = l_w[w] * corr + p.sum(dim=-1, keepdim=True)
            acc_w[w] = acc_w[w] * corr + pv(p, v[k0:k1])
            m_w[w] = m_new
    m_out = m
    for w in range(_WARPS):
        m_out = torch.maximum(m_out, m_w[w])
    e = torch.exp(m - m_out)
    l_out, acc_out = l * e, acc * e
    for w in range(_WARPS):
        e = torch.exp(m_w[w] - m_out)
        l_out = l_out + l_w[w] * e
        acc_out = acc_out + acc_w[w] * e
    return acc_out, m_out, l_out


def _carry_inputs(seed, sq, sk, d):
    q, k, v = _block_inputs(seed, sq, sk, d)
    rng = np.random.default_rng(seed + 100)
    acc = rng.standard_normal((sq, d)).astype(np.float32)
    m = rng.standard_normal((sq, 1)).astype(np.float32)
    l = np.abs(rng.standard_normal((sq, 1))).astype(np.float32)
    return q, k, v, acc, m, l


def _rel_errs(out, ref):
    """Per output, the max error over the largest magnitude (the float64
    gates' measure)."""
    return [float((o.double() - r.double()).abs().max() / r.double().abs().max())
            for o, r in zip(out, ref)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_warp_split_combine_matches_pallas(seed, causal):
    """Four warps' partial carries over a ragged 200-key block (three whole
    chunks and a partial one; the causal mask cuts through a slice),
    combined in warp order, give the Pallas kernel's update."""
    q, k, v, acc, m, l = _carry_inputs(seed, 48, 200, 32)
    kw = dict(causal=causal, scale=32 ** -0.5)
    mine = _warp_split_update(*map(_t, (q, k, v, acc, m, l)), 150, 0, **kw)
    theirs = pk.flash_attention_block(*map(jnp.asarray, (q, k, v, acc, m, l)),
                                      150, 0, **kw)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


def test_warp_split_masked_block_at_init_carry_is_exact():
    """Every slice masked while the carry is at its -1e30/0/0 init: every
    m_w stays at m_in, every factor is exp(0) = 1 and every partial 0, so
    the combine returns the carry bit for bit, as the Pallas kernel does."""
    q, k, v = _block_inputs(7, 48, 128, 32)
    acc0, m0, l0 = (torch.zeros(48, 32), torch.full((48, 1), attention.NEG_BIG),
                    torch.zeros(48, 1))
    acc, m, l = _warp_split_update(_t(q), _t(k), _t(v), acc0, m0, l0, 0, 48,
                                   causal=True, scale=0.1)
    assert torch.equal(acc, acc0) and torch.equal(m, m0) and torch.equal(l, l0)
    ja, jm, jl = pk.flash_attention_block(
        *map(jnp.asarray, (q, k, v, acc0.numpy(), m0.numpy(), l0.numpy())),
        0, 48, causal=True, scale=0.1)
    for mine, theirs in ((acc, ja), (m, jm), (l, jl)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("causal", [False, True])
def test_warp_split_tf32x3_f32_class(causal):
    """The f32 mode's arithmetic: both products as three TF32 passes land
    within 1e-5 of the update in float64 (max error over the largest
    magnitude), no worse than twice the plain f32 version's error (the
    card's float64 gate), while a single TF32 pass misses 1e-5."""
    q, k, v, acc, m, l = map(_t, _carry_inputs(20, 64, 256, 64))
    kw = dict(causal=causal, scale=64 ** -0.5)
    ref64 = kernels.flash_attention_block_plain(q, k, v, acc, m, l, 192, 0,
                                                compute_dtype=torch.float64, **kw)
    mine = _warp_split_update(q, k, v, acc, m, l, 192, 0, qk=_tf32x3_dot,
                              pv=_pv_tf32x3, **kw)
    plain = kernels.flash_attention_block_plain(q, k, v, acc, m, l, 192, 0, **kw)
    errs, plain_errs = _rel_errs(mine, ref64), _rel_errs(plain, ref64)
    assert max(errs) < 1e-5, errs
    assert max(errs) <= 2 * max(plain_errs), (errs, plain_errs)

    def tf32_dot(a, b):
        return _f32_dot(tf32(a.contiguous()), tf32(b.contiguous()))

    one_pass = _warp_split_update(q, k, v, acc, m, l, 192, 0, qk=tf32_dot,
                                  pv=lambda p, vv: tf32_dot(p, vv.mT), **kw)
    assert max(_rel_errs(one_pass, ref64)) > 1e-5


def _fma_chain(a, b, block):
    """a @ b.T as the wide kernel's FP32 FMA: one chain per ``block``
    columns of the shared dimension (each FMA rounded to f32, emulated in
    float64), each chain's sum added to the f32 total."""
    total = torch.zeros(a.shape[0], b.shape[0])
    for c0 in range(0, a.shape[1], block):
        part = torch.zeros_like(total)
        for c in range(c0, min(c0 + block, a.shape[1])):
            part = (a[:, c, None].double() * b[None, :, c].double() + part.double()).float()
        total = total + part
    return total


def _wide_update(q, k, v, acc, m, l, *, scale, block):
    """The wide kernel's update (non-causal): 64-key chunks, logits and each
    chunk's p.v as FMA chains of ``block``."""
    for kc in range(0, k.shape[0], 64):
        s = _fma_chain(q, k[kc:kc + 64], block) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _fma_chain(p, v[kc:kc + 64].mT.contiguous(), 64)
        m = m_new
    return acc, m, l


def test_wide_kernel_blocked_sums_f32_class():
    """The wide kernel (D > 256) sums in FMA chains of 64, as a library
    GEMM blocks its sums: at D = 512 that lands within 1e-4 of the update
    in float64, more than twice as close as one chain over all 512 columns
    (at the card's 512 x 512 block the single chain missed 1e-4)."""
    q, k, v, acc, m, l = map(_t, _carry_inputs(40, 128, 512, 512))
    kw = dict(scale=512 ** -0.5)
    ref64 = kernels.flash_attention_block_plain(q, k, v, acc, m, l, 0, 0,
                                                compute_dtype=torch.float64, **kw)

    def err(out):
        return max(float((o.double() - r).abs().max()) for o, r in zip(out, ref64))

    blocked = err(_wide_update(q, k, v, acc, m, l, block=64, **kw))
    chain = err(_wide_update(q, k, v, acc, m, l, block=512, **kw))
    assert blocked < 1e-4 and chain > 2 * blocked, (blocked, chain)


@pytest.mark.parametrize("seed", [30, 31])
def test_warp_split_bf16_p_needs_two_passes(seed):
    """bf16 q, k, v: p is f32, so the kernel splits it into bf16 hi and lo
    and runs p.v twice.  That lands within 1e-5 of the update with f32 p
    (max error over the largest magnitude); a single bf16 p, rounded by up
    to 2^-9, misses 1e-4."""
    q, k, v, acc, m, l = (_t(x) for x in _carry_inputs(seed, 48, 200, 64))
    q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))
    kw = dict(causal=True, scale=64 ** -0.5)
    ref = _warp_split_update(q, k, v, acc, m, l, 150, 0, **kw)
    split = _warp_split_update(q, k, v, acc, m, l, 150, 0, pv=_pv_bf16_split, **kw)
    single = _warp_split_update(q, k, v, acc, m, l, 150, 0, pv=_pv_bf16_single, **kw)
    assert max(_rel_errs(split, ref)) < 1e-5
    assert max(_rel_errs(single, ref)) > 1e-4


def _ok_block():
    return [torch.zeros(s) for s in ((4, 8), (6, 8), (6, 8), (4, 8), (4, 1), (4, 1))]


@pytest.mark.parametrize("bad", [
    "q_int", "v_complex", "acc_bf16", "k_width", "v_rows", "acc_shape", "m_shape",
    "noncontiguous", "not_2d", "d_zero", "meta_device",
])
def test_flash_block_rejects_bad_input(bad):
    args = _ok_block()
    err = ValueError
    if bad == "q_int":
        args[0], err = args[0].int(), TypeError
    elif bad == "v_complex":
        args[2], err = args[2].to(torch.complex64), TypeError
    elif bad == "acc_bf16":
        args[3] = args[3].to(torch.bfloat16)
    elif bad == "k_width":
        args[1] = torch.zeros(6, 9)
    elif bad == "v_rows":
        args[2] = torch.zeros(5, 8)
    elif bad == "acc_shape":
        args[3] = torch.zeros(4, 9)
    elif bad == "m_shape":
        args[4] = torch.zeros(4)
    elif bad == "noncontiguous":
        args[1] = torch.zeros(8, 6).mT
    elif bad == "not_2d":
        args[0] = torch.zeros(4, 8, 1)
    elif bad == "d_zero":
        args[:4] = [torch.zeros(n, 0) for n in (4, 6, 6, 4)]
    elif bad == "meta_device":
        args = [a.to("meta") for a in args]
    with pytest.raises(err):
        kernels.flash_attention_block(*args, 0, 0)


_F16, _BF16, _F32, _F64 = torch.float16, torch.bfloat16, torch.float32, torch.float64


@pytest.mark.parametrize("case,d,dtypes", [
    ("q_f64", 64, (_F64,) * 3), ("mixed_qkv", 64, (_F32, _BF16, _F32)),
    ("f16", 64, (_F16,) * 3), ("d_over_limit", 257, (_F32,) * 3),
    ("d320_f16", 320, (_F16,) * 3), ("d320_f64", 320, (_F64,) * 3),
    ("d512", 512, (_F32,) * 3), ("d512_bf16", 512, (_BF16,) * 3),
    ("d512_mixed", 512, (_F16, _F32, _BF16)),
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_any_dtype_and_width_matches_pallas(case, d, dtypes, causal):
    """Operands the reference takes and the port once refused -- float16,
    float64, mixed q/k/v and heads wider than 256 -- give the Pallas
    kernel's carry within 1e-4 (it casts q, k and v to float32, as the
    port's f32 engine does)."""
    Sq, Sk, q_off = 40, 70, 50
    q, k, v, acc, m, l = _carry_inputs(90 + d, Sq, Sk, d)
    ops = [_t(x).to(dt) for x, dt in zip((q, k, v), dtypes)]
    scale = 1.0 / math.sqrt(d)
    mine = kernels.flash_attention_block(*ops, _t(acc), _t(m), _t(l), q_off, 0,
                                         causal=causal, scale=scale)
    jax_dt = {_F16: jnp.float16, _BF16: jnp.bfloat16, _F32: jnp.float32,
              _F64: jnp.float32}  # JAX without x64 holds float64 as float32
    theirs = pk.flash_attention_block(
        *(jnp.asarray(o.float().numpy(), dtype=jax_dt[dt]) for o, dt in zip(ops, dtypes)),
        *map(jnp.asarray, (acc, m, l)), q_off, 0, causal=causal, scale=scale)
    for a, b in zip(mine, theirs):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtypes,d,mode", [
    ((_F32,) * 3, 128, "f32"), ((_BF16,) * 3, 128, "bf16"), ((_F16,) * 3, 64, "f32"),
    ((_F64,) * 3, 256, "f32"), ((_F32, _BF16, _BF16), 64, "f32"),
    ((_F32,) * 3, 257, "f32_wide"), ((_BF16,) * 3, 512, "bf16_wide"),
    ((_BF16, _BF16, _F16), 320, "f32_wide"),
])
def test_attention_mode(dtypes, d, mode):
    """The kernel a B5 launch runs: the bf16 engine only for all-bfloat16
    operands, the f32 one (on float32 copies) for the rest, and the wide
    kernel above ATTENTION_ENGINE_D."""
    assert kernels._attention_mode(*dtypes, d) == mode
    assert mode in kernels.flash_attention_block.launches_by_mode


def test_flash_block_counts_calls_not_launches_on_cpu():
    kernels.reset_counts()
    kernels.flash_attention_block(*_ok_block(), 0, 0)
    assert (kernels.flash_attention_block.calls,
            kernels.flash_attention_block.launches) == (1, 0)
    assert not any(kernels.flash_attention_block.launches_by_mode.values())
    kernels._count_mode(kernels.flash_attention_block, "f32_wide")
    assert kernels.flash_attention_block.launches_by_mode["f32_wide"] == 1
    kernels.reset_counts()
    assert not any(kernels.flash_attention_block.launches_by_mode.values())
    assert kernels.flash_attention_block.calls == 0


# -- the graph against the JAX package's ------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("qb,kvb", [(16, 16), (20, 28)])
def test_flash_graph_matches_reference_package(ref_ctx, port_ctx, causal, dtype,
                                               tol, qb, kvb):
    """tests/runtime/test_attention_graph.py's matrix (dividing and ragged
    blocks): the port's graph on its CUDA module (every step through the
    B5 wrapper) against the JAX package's graph and the dense oracle of
    both packages."""
    q, k, v = _qkv(1, dtype)
    kernels.reset_counts()
    out = attention.run_flash_attention(
        port_ctx, *(_port_in(x, dtype) for x in (q, k, v)), causal=causal,
        q_block=qb, kv_block=kvb, use_cpu=False)
    steps = attention.attention_task_count(B, S, S, H, qb, kvb, causal=causal) \
        - B * H * (-(-S // qb))
    assert kernels.flash_attention_block.calls == steps
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tuple(out.shape) == (B, S, H, D)
    got = out.float().numpy()
    theirs = ref_attention.run_flash_attention(
        ref_ctx, *(_jax_in(x, dtype) for x in (q, k, v)), causal=causal,
        q_block=qb, kv_block=kvb)
    np.testing.assert_allclose(got, np.asarray(theirs, dtype=np.float32),
                               rtol=tol, atol=tol)
    dense = _dense(q, k, v, causal)
    np.testing.assert_allclose(got, dense, rtol=tol, atol=tol)
    mine = attention_reference(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(mine, dense, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_graph_host_bodies_bit_identical_to_reference(ref_ctx, host_ctx,
                                                            dtype, causal):
    """Host chores on both sides run the same numpy arithmetic in the same
    order: the outputs are bit-identical (bfloat16 outputs round to
    nearest even on both sides)."""
    q, k, v = _qkv(2, dtype)
    kw = dict(causal=causal, q_block=20, kv_block=28)
    mine = attention.run_flash_attention(
        host_ctx, *(_port_in(x, dtype) for x in (q, k, v)), use_cuda=False, **kw)
    theirs = ref_attention.run_flash_attention(
        ref_ctx, *(_jax_in(x, dtype) for x in (q, k, v)), use_tpu=False, **kw)
    np.testing.assert_array_equal(mine.float().numpy(),
                                  np.asarray(theirs, dtype=np.float32))


@pytest.mark.parametrize("case", ["d512", "float16", "mixed"])
def test_flash_graph_wide_head_and_narrow_planes_match_reference_package(
        ref_ctx, port_ctx, case):
    """run_flash_attention with a head of 512 and with float16 (or mixed)
    planes, every step through the B5 wrapper on the CUDA module, against
    the JAX package's graph within the f32 tolerance 2e-5 (float32
    output); the default output takes q's dtype, as the reference's does."""
    d = 512 if case == "d512" else D
    q, k, v = _qkv(6, s=40, d=d)
    if case == "d512":
        mine_in, theirs_in = [_t(x) for x in (q, k, v)], [q, k, v]
    else:
        q, k, v = (x.astype(np.float16).astype(np.float32) for x in (q, k, v))
        theirs_in = [q.astype(np.float16), k.astype(np.float16), v]
        if case == "float16":
            theirs_in[2] = v.astype(np.float16)
        mine_in = [_t(x) for x in theirs_in]
    kw = dict(causal=True, q_block=16, kv_block=24)
    kernels.reset_counts()
    out = attention.run_flash_attention(port_ctx, *mine_in, use_cpu=False,
                                        out_dtype=torch.float32, **kw)
    assert kernels.flash_attention_block.calls == attention.attention_task_count(
        B, 40, 40, H, 16, 24, causal=True) - B * H * 3
    theirs = ref_attention.run_flash_attention(ref_ctx, *theirs_in, out_dtype=np.float32,
                                               **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), _dense(q, k, v, True), rtol=2e-5, atol=2e-5)
    if case != "d512":
        narrow = attention.run_flash_attention(port_ctx, *mine_in, use_cpu=False, **kw)
        assert narrow.dtype == torch.float16
        # one float16 rounding of values that agree within 2e-5
        np.testing.assert_allclose(narrow.float().numpy(), out.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_flash_graph_decode_tail(ref_ctx, port_ctx):
    """Decode: a short q block at the END of the KV sequence (q_offset
    defaults to Sk - Sq), with a ragged KV tail and the "auto" q block,
    equals the tail rows of full causal attention and the JAX package."""
    q, k, v = _qkv(2, s=52)
    kw = dict(causal=True, q_block="auto", kv_block=16)
    out = attention.run_flash_attention(port_ctx, _t(q[:, -8:]), _t(k), _t(v),
                                        use_cpu=False, **kw).numpy()
    np.testing.assert_allclose(out, _dense(q, k, v, True)[:, -8:],
                               rtol=2e-5, atol=2e-5)
    theirs = ref_attention.run_flash_attention(ref_ctx, q[:, -8:], k, v, **kw)
    np.testing.assert_allclose(out, theirs, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cfg", [
    (1, 48, 48, 2, 16, 16, False), (1, 48, 48, 2, 16, 16, True),
    (2, 48, 48, 3, 20, 28, True), (1, 8, 48, 2, 8, 16, True),
    (1, 96, 4000, 32, 96, 512, True), (1, 4096, 4096, 32, 512, 512, True),
])
def test_task_counts_match_reference(cfg):
    b, sq, sk, h, qb, kvb, causal = cfg
    assert attention.attention_task_count(b, sq, sk, h, qb, kvb, causal=causal) \
        == ref_attention.attention_task_count(b, sq, sk, h, qb, kvb, causal=causal)


def test_the_path_shapes_count_as_planned():
    """The chip run's attention shapes: 1408 tasks / 1152 steps for the
    4096-token prefill in 512-blocks, 288 / 256 for the decode step."""
    count = attention.attention_task_count
    assert count(1, 4096, 4096, 32, 512, 512, causal=True) == 1408
    assert count(1, 96, 4000, 32, 96, 512, causal=True) == 288
    assert attention.block_splits(4000, 512)[-1] == (3584, 416)


def test_executed_tasks_equal_task_count(port_ctx):
    q, k, v = _qkv(3)
    dev = port_ctx.devices[1]
    before = dev.stats["executed_tasks"]
    attention.run_flash_attention(port_ctx, q, k, v, causal=True, q_block=16,
                                  kv_block=20, use_cpu=False)
    assert dev.stats["executed_tasks"] - before == attention.attention_task_count(
        B, S, S, H, 16, 20, causal=True)


def test_build_rejects_bad_shapes():
    q, k, v = _qkv(4)
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.build_flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="q_offset"):
        attention.build_flash_attention(q, k[:, :24], v[:, :24], causal=True)
    # mixed q/k/v dtypes build, as in the reference; the output takes q's
    _, assemble = attention.build_flash_attention(_t(q).half(), _t(k).to(torch.bfloat16),
                                                  _t(v), q_block=16, kv_block=16)
    assert assemble().dtype == torch.float16
    with pytest.raises(ValueError, match="no BODY"):
        attention.flash_attention_ptg(use_cuda=False, use_cpu=False)
    # the Sq > Sk shape is fine non-causal
    attention.build_flash_attention(q, k[:, :24], v[:, :24], causal=False,
                                    q_block=16, kv_block=16)


def test_auto_blocks_take_the_empty_store_default(tmp_path, monkeypatch):
    """On an empty tuning store (a fresh cache root) "auto" is min(128, S)
    in both packages; explicit values pass through."""
    monkeypatch.setenv("PARSEC_TPU_COMPILE_CACHE", str(tmp_path))
    for value, param, seq in (("auto", "q_block", 48), ("auto", "kv_block", 4096),
                              (20, "q_block", 4096)):
        got = attention._resolve_block(value, param, seq, np.float32)
        assert got == ref_attention._resolve_block(value, param, seq, np.float32)
    assert attention._resolve_block("auto", "q_block", 48, torch.float32) == 48
    assert attention._resolve_block("auto", "kv_block", 4096, torch.float32) == 128
    assert attention._resolve_block(20, "q_block", 4096, torch.float32) == 20
    with pytest.raises(ValueError, match="positive"):
        attention.block_splits(10, 0)


def test_ptg_definitions_are_memoised_and_bounded():
    attention._PTG_MEMO.clear()
    a = attention._flash_ptg_cached(causal=True, scale=0.5, q_block=8, kv_block=8,
                                    q_offset=0, use_cuda=True, use_cpu=True)
    b = attention._flash_ptg_cached(causal=True, scale=0.5, q_block=8, kv_block=8,
                                    q_offset=0, use_cuda=True, use_cpu=True)
    assert a is b
    for off in range(attention._PTG_MEMO_MAX + 5):
        attention._flash_ptg_cached(causal=True, scale=0.5, q_block=8, kv_block=8,
                                    q_offset=off + 1, use_cuda=True, use_cpu=True)
    assert len(attention._PTG_MEMO) == attention._PTG_MEMO_MAX


def test_attention_reference_float64_and_bf16_inputs():
    """The port's oracle keeps float64 in float64 and takes bfloat16 logits
    to float32, as the reference does."""
    q, k, v = _qkv(5)
    out64 = attention_reference(*(_t(x).double() for x in (q, k, v)), causal=True)
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out64.numpy(), _dense(q, k, v, True), rtol=1e-5, atol=1e-5)
    qb, kb, vb = (_port_in(_bf16(x), "bfloat16") for x in (q, k, v))
    out = attention_reference(qb, kb, vb)
    assert out.dtype == torch.bfloat16
    theirs = jax_attention_reference(*(jnp.asarray(_jax_in(_bf16(x), "bfloat16"))
                                       for x in (q, k, v)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(theirs, np.float32),
                               rtol=2e-2, atol=2e-2)
