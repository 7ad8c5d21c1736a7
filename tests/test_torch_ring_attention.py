"""The port's sequence-parallel attention (parsec_tpu_torch.parallel:
``ring_attention`` and ``ulysses_attention``) against the JAX package's,
the counterpart of ``tests/runtime/test_ring_attention.py``.

Both run on an 8-position sequence-parallel mesh: the JAX package on the
8-device CPU mesh of ``tests/conftest.py``, the port on 8 CPU positions.
The same seeded numpy q/k/v go to both; bfloat16 inputs cross as float32
arrays already rounded to bfloat16.  ``use_kernels=True`` runs each step
through the B5 wrapper under ``torch.vmap`` (its plain version on the
CPU: one call a position a step), against the reference's
``use_pallas=True`` (Pallas in interpret mode).  Tolerances are the
reference tests'.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from parsec_tpu import parallel as ref  # noqa: E402
from parsec_tpu_torch import parallel  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402

B, S, H, D = 2, 64, 8, 16

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def meshes():
    return (parallel.make_mesh((8, 1), axes=("sp", "unused"), devices=["cpu"] * 8),
            ref.make_mesh((8, 1), axes=("sp", "unused"), devices=jax.devices()))


def _bf16(x):
    """float32 values rounded to bfloat16, as numpy float32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def qkv(seed=0, shape=(B, S, H, D), dtype="float32"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.standard_normal(shape).astype(np.float32)
        out.append(_bf16(a) if dtype == "bfloat16" else a)
    return out


def _port(arrays, dtype="float32"):
    ts = [torch.from_numpy(a) for a in arrays]
    return [t.to(torch.bfloat16) for t in ts] if dtype == "bfloat16" else ts


def _jax(arrays, dtype="float32"):
    return [jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
            for a in arrays]


def _dense(arrays, causal):
    return np.asarray(ref.attention_reference(*_jax(arrays), causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(meshes, causal):
    m, rm = meshes
    arrays = qkv(1)
    out = parallel.ring_attention(*_port(arrays), m, axis="sp", causal=causal)
    theirs = np.asarray(ref.ring_attention(*_jax(arrays), rm, axis="sp", causal=causal))
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, S, H, D)
    np.testing.assert_allclose(out.numpy(), _dense(arrays, causal), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), theirs, rtol=2e-5, atol=2e-5)
    ours_ref = parallel.attention_reference(*_port(arrays), causal=causal)
    np.testing.assert_allclose(out.numpy(), ours_ref.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_dense(meshes, causal):
    m, rm = meshes
    arrays = qkv(2)
    out = parallel.ulysses_attention(*_port(arrays), m, axis="sp", causal=causal)
    theirs = np.asarray(ref.ulysses_attention(*_jax(arrays), rm, axis="sp", causal=causal))
    np.testing.assert_allclose(out.numpy(), _dense(arrays, causal), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), theirs, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ring_attention_bf16_runs(meshes, use_kernels):
    """bfloat16 inputs with f32 accumulation; the output stays bf16."""
    m, rm = meshes
    arrays = qkv(3, dtype="bfloat16")
    out = parallel.ring_attention(*_port(arrays, "bfloat16"), m, axis="sp", causal=True,
                                  use_kernels=use_kernels)
    assert out.dtype == torch.bfloat16
    theirs = ref.ring_attention(*_jax(arrays, "bfloat16"), rm, axis="sp", causal=True)
    assert theirs.dtype == jnp.bfloat16
    dense = _dense(arrays, True)
    np.testing.assert_allclose(out.float().numpy(), dense, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(theirs, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ring_attention_long_context_memory_shape(meshes, use_kernels):
    """S=1024 over 8 positions: each position only ever holds S/8-sized
    blocks (the point of sequence parallelism)."""
    m, rm = meshes
    arrays = qkv(4, shape=(1, 1024, 2, 8))
    out = parallel.ring_attention(*_port(arrays), m, axis="sp", causal=True,
                                  use_kernels=use_kernels)
    theirs = np.asarray(ref.ring_attention(*_jax(arrays), rm, axis="sp", causal=True))
    np.testing.assert_allclose(out.numpy(), _dense(arrays, True), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_kernel_block_matches_pallas(meshes, causal):
    """The B5 block-update path against the reference's fused Pallas path
    (interpret mode) and the dense oracle; each position makes one
    batched call a step (8 positions x 8 steps), none of them a per-plane
    call."""
    m, rm = meshes
    arrays = qkv(4)
    kernels.reset_counts()
    out = parallel.ring_attention(*_port(arrays), m, axis="sp", causal=causal,
                                  use_kernels=True)
    assert kernels.flash_attention_block.calls == 8 * 8
    theirs = np.asarray(ref.ring_attention(*_jax(arrays), rm, axis="sp", causal=causal,
                                           use_pallas=True))
    np.testing.assert_allclose(out.numpy(), theirs, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), _dense(arrays, causal), rtol=2e-5, atol=2e-5)


def test_ring_attention_on_a_2d_mesh_axis_and_its_checks():
    """A ring along one axis of a 2x4 mesh runs one ring a row of
    positions (each row holding the whole sequence of its replica); a
    sequence the ring does not divide, or heads Ulysses cannot split,
    raise."""
    m = parallel.make_mesh((2, 4), axes=("dp", "sp"), devices=["cpu"] * 8)
    arrays = qkv(5, shape=(1, 32, 4, 8))
    out = parallel.ring_attention(*_port(arrays), m, axis="sp", causal=True)
    np.testing.assert_allclose(out.numpy(), _dense(arrays, True), rtol=2e-5, atol=2e-5)
    q = torch.zeros((1, 30, 4, 8))
    with pytest.raises(ValueError, match="must divide seq length"):
        parallel.ring_attention(q, q, q, m, axis="sp")
    q = torch.zeros((1, 32, 6, 8))
    with pytest.raises(ValueError, match="must divide head count"):
        parallel.ulysses_attention(q, q, q, m, axis="sp")
