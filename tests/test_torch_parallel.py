"""The port's SPMD layer (parsec_tpu_torch.parallel) against the JAX
package's, the counterpart of ``tests/runtime/test_parallel.py``.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port side on 8 CPU positions (``make_mesh(devices=["cpu"] * 8)``, a
thread a position).  The same seeded numpy inputs go to both.  The
collectives only move data or add zeros, so they are compared exactly;
the dense kernels at the reference tests' tolerances.  Beyond those: a
position that raises (or never arrives) makes the call raise within
seconds and the next call works, sums are bit-identical on every
position, a receive never aliases its sender, and ``make_mesh()`` with no
devices raises on a host without a card.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from parsec_tpu import parallel as ref  # noqa: E402
from parsec_tpu.ops.stencil import reference_stencil as ref_stencil  # noqa: E402
from parsec_tpu.parallel import collectives as ref_coll  # noqa: E402
from parsec_tpu.parallel._compat import no_vma_check_kwargs  # noqa: E402
from parsec_tpu.parallel._compat import shard_map as jax_shard_map  # noqa: E402
from parsec_tpu_torch import mca_param, parallel  # noqa: E402
from parsec_tpu_torch.ops.stencil import reference_stencil  # noqa: E402
from parsec_tpu_torch.parallel import collectives  # noqa: E402
from parsec_tpu_torch.parallel import shard_map as sm  # noqa: E402
from parsec_tpu_torch.parallel.shard_map import P, shard_map  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device CPU mesh")

CPU8 = ["cpu"] * 8


def port_mesh(shape, axes=("p", "q")):
    return parallel.make_mesh(shape, axes=axes, devices=CPU8)


def ref_mesh(shape, axes=("p", "q")):
    return ref.make_mesh(shape, axes=axes, devices=jax.devices()[:shape[0] * shape[1]])


def both(fn_port, fn_ref, x, in_spec, out_spec, shape=(1, 8), axes=("r", "x"), **kw):
    """Run one kernel on each package's mesh over the same numpy input;
    returns (port output as numpy, reference output as numpy)."""
    port = shard_map(fn_port, port_mesh(shape, axes), P(*in_spec), _pspec(out_spec))(
        torch.from_numpy(x))
    f = jax_shard_map(fn_ref, mesh=ref_mesh(shape, axes), in_specs=JP(*in_spec),
                      out_specs=_jspec(out_spec), **kw)
    theirs = jax.jit(f)(jnp.asarray(x))
    if isinstance(port, tuple):
        return [p.numpy() for p in port], [np.asarray(t) for t in theirs]
    return port.numpy(), np.asarray(theirs)


def _pspec(spec):
    return tuple(P(*s) for s in spec) if isinstance(spec[0], tuple) else P(*spec)


def _jspec(spec):
    return tuple(JP(*s) for s in spec) if isinstance(spec[0], tuple) else JP(*spec)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 12, 16])
def test_best_grid(n):
    assert parallel.best_grid(n) == ref.best_grid(n)


def test_make_mesh_shape():
    m, r = parallel.make_mesh(devices=CPU8), ref.make_mesh()
    assert m.devices.size == r.devices.size == 8
    assert m.axis_names == r.axis_names == ("p", "q")
    assert dict(m.shape) == dict(r.shape) == {"p": 2, "q": 4}
    assert all(d == torch.device("cpu") for d in m.devices.flat)


def test_make_mesh_repeats_a_device_and_refuses_too_few():
    m = parallel.make_mesh((4, 1), axes=("sp", "u"), devices=["cpu"] * 4)
    assert m.shape == {"sp": 4, "u": 1}
    with pytest.raises(ValueError, match="needs 8 devices"):
        parallel.make_mesh((2, 4), devices=["cpu"] * 4)


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()


def test_shardings_name_the_mesh_axes():
    m = port_mesh((2, 4))
    assert parallel.block_sharding(m).spec == P("p", "q")
    assert parallel.replicated(m).spec == P()


# ---------------------------------------------------------------------------
# collectives, exactly the reference's
# ---------------------------------------------------------------------------

X8 = np.arange(8.0).reshape(8, 1)


@pytest.mark.parametrize("root", [0, 3, 7])
@pytest.mark.parametrize("topo", ["star", "chain", "binomial"])
def test_bcast_topologies(topo, root):
    """All three broadcast topologies deliver the root's data, as the
    reference's do."""
    port, theirs = both(lambda x: collectives.bcast(x, "x", root=root, topology=topo),
                        lambda x: ref_coll.bcast(x, "x", root=root, topology=topo),
                        X8, ("x", None), ("x", None))
    np.testing.assert_array_equal(port, theirs)
    np.testing.assert_array_equal(port, np.full((8, 1), float(root)))


def test_bcast_topology_from_mca_param():
    mca_param.set_param("runtime", "comm_coll_bcast", "chain")
    try:
        port, _ = both(lambda x: collectives.bcast(x, "x", root=5),
                       lambda x: ref_coll.bcast(x, "x", root=5, topology="chain"),
                       X8, ("x", None), ("x", None))
    finally:
        mca_param.unset("runtime", "comm_coll_bcast")
    np.testing.assert_array_equal(port, np.full((8, 1), 5.0))


@pytest.mark.parametrize("offset", [1, 3, -2])
def test_shift_ring(offset):
    port, theirs = both(lambda x: collectives.shift(x, "x", offset),
                        lambda x: ref_coll.shift(x, "x", offset),
                        X8, ("x", None), ("x", None))
    np.testing.assert_array_equal(port, theirs)
    np.testing.assert_array_equal(port.ravel(), np.roll(np.arange(8.0), offset))


def test_collective_wrappers():
    def kern(mod):
        def k(x):
            s = mod.allreduce_sum(x.sum(), "x")
            return s * (torch.ones_like(x) if mod is collectives else jnp.ones_like(x)), \
                mod.allgather(x, "x")
        return k

    (ps, pg), (rs, rg) = both(kern(collectives), kern(ref_coll), X8, ("x", None),
                              (("x", None), (None, None)), **no_vma_check_kwargs())
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pg, rg)
    assert float(ps[0, 0]) == 28.0
    np.testing.assert_array_equal(pg.ravel(), np.arange(8.0))


def test_reduce_scatter_sum():
    # integers: every order of the adds gives the same sum
    x = np.random.default_rng(3).integers(-1000, 1000, (64, 3)).astype(np.float64)
    port, theirs = both(lambda t: collectives.reduce_scatter_sum(t, "x"),
                        lambda t: ref_coll.reduce_scatter_sum(t, "x"),
                        x, ("x", None), ("x", None))
    np.testing.assert_array_equal(port, theirs)
    np.testing.assert_array_equal(port, x.reshape(8, 8, 3).sum(axis=0))


def test_all_to_all_round_trip():
    """The Ulysses reshard (split heads, gather sequence) equals the
    reference's, and its inverse gives the input back."""
    x = np.random.default_rng(4).standard_normal((2, 16, 8, 3))

    def there(t):
        return sm.all_to_all(t, "x", split_axis=2, concat_axis=1)

    fwd, theirs = both(there, lambda t: lax.all_to_all(
        t, "x", split_axis=2, concat_axis=1, tiled=True), x, (None, "x"), (None, None, "x"))
    np.testing.assert_array_equal(fwd, theirs)
    back, _ = both(lambda t: sm.all_to_all(there(t), "x", split_axis=1, concat_axis=2),
                   lambda t: t, x, (None, "x"), (None, "x"))
    np.testing.assert_array_equal(back, x)


def test_partial_ppermute_gives_zeros_where_nothing_arrives():
    perm = [(0, 2), (5, 1)]
    port, theirs = both(lambda x: sm.ppermute(x, "x", perm),
                        lambda x: lax.ppermute(x, "x", perm), X8 + 1, ("x", None), ("x", None))
    np.testing.assert_array_equal(port, theirs)
    assert port.ravel().tolist() == [0, 6, 1, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="not a permutation"):
        shard_map(lambda x: sm.ppermute(x, "x", [(0, 1), (2, 1)]), port_mesh((1, 8), ("r", "x")),
                  P("x", None), P("x", None))(torch.from_numpy(X8))


def test_collectives_group_positions_along_one_axis():
    """On a 2x4 mesh a psum along q adds within each row p, an all_gather
    along p within each column q, as the reference's."""
    x = np.arange(8.0 * 8).reshape(8, 8)

    def kern(psum, gather):
        return lambda t: (psum(t, "q"), gather(t, "p"))

    (ps, pg), (rs, rg) = both(
        kern(sm.psum, lambda t, a: sm.all_gather(t, a, axis=0)),
        kern(lax.psum, lambda t, a: lax.all_gather(t, a, axis=0, tiled=True)),
        x, ("p", "q"), (("p", "q"), (None, "q")), shape=(2, 4), axes=("p", "q"),
        **no_vma_check_kwargs())
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(pg, rg)


def test_psum_adds_in_position_order_on_every_position():
    """Every position's sum has the same bits: the contributions added in
    position order, c0 + c1 + ... + c7."""
    x = np.random.default_rng(5).standard_normal((8, 64)).astype(np.float32) * \
        np.logspace(-6, 6, 8, dtype=np.float32)[:, None]
    per = shard_map(lambda t: sm.psum(t[sm.axis_index("x")][None], "x"),
                    port_mesh((1, 8), ("r", "x")), P(None, None), P("x", None))(
        torch.from_numpy(x))
    want = torch.from_numpy(x[0])
    for i in range(1, 8):
        want = want + torch.from_numpy(x[i])
    assert all(torch.equal(per[i], want) for i in range(8))


def test_a_receive_never_aliases_its_sender():
    """A sender writing its tensor in place after the exchange changes
    nothing a receiver got."""
    def kern(x):
        y = collectives.shift(x, "x", 1)
        x.add_(100.0)
        return y

    out = shard_map(kern, port_mesh((1, 8), ("r", "x")), P("x", None), P("x", None))(
        torch.from_numpy(X8.copy()))
    np.testing.assert_array_equal(out.numpy().ravel(), np.roll(np.arange(8.0), 1))


def test_a_collective_outside_shard_map_raises():
    with pytest.raises(RuntimeError, match="inside a shard_map"):
        collectives.my_index("x")


# ---------------------------------------------------------------------------
# a failing position
# ---------------------------------------------------------------------------

def test_a_failing_position_raises_promptly_and_the_next_call_works():
    mesh = port_mesh((1, 8), ("r", "x"))

    def bad(x):
        if collectives.my_index("x") == 5:
            raise ValueError("position 5 fails")
        x = collectives.allreduce_sum(x, "x")
        return collectives.shift(x, "x")

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="position 5 fails"):
        shard_map(bad, mesh, P("x", None), P("x", None))(torch.from_numpy(X8))
    assert time.monotonic() - t0 < 5.0
    out = shard_map(lambda x: collectives.allreduce_sum(x, "x"), mesh, P("x", None),
                    P("x", None))(torch.from_numpy(X8))
    np.testing.assert_array_equal(out.numpy().ravel(), np.full(8, 28.0))
    assert not [t for t in threading.enumerate() if t.name.startswith("shard_map-")]


def test_a_position_that_never_arrives_times_out():
    """Position 0 skips the collective the others wait in: each rendezvous
    is bounded, so the call raises instead of hanging."""
    def kern(x):
        if collectives.my_index("x") == 0:
            return x
        return collectives.allreduce_sum(x, "x")

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="waited 0.5 s"):
        shard_map(kern, port_mesh((1, 8), ("r", "x")), P("x", None), P("x", None),
                  timeout=0.5)(torch.from_numpy(X8))
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# the dense kernels
# ---------------------------------------------------------------------------

def test_summa_gemm_matches():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 64))
    B = rng.standard_normal((64, 64))
    C = parallel.summa_gemm(torch.from_numpy(A), torch.from_numpy(B), port_mesh((2, 4)))
    theirs = np.asarray(ref.summa_gemm(jnp.asarray(A), jnp.asarray(B), ref_mesh((2, 4))))
    np.testing.assert_allclose(C.numpy(), A @ B, rtol=1e-10)
    np.testing.assert_allclose(C.numpy(), theirs, rtol=1e-10)


def test_ring_gemm_matches():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((64, 32))
    B = rng.standard_normal((32, 48))
    C = parallel.ring_gemm(torch.from_numpy(A), torch.from_numpy(B),
                           port_mesh((8, 1), ("x", "y")), axis="x")
    theirs = np.asarray(ref.ring_gemm(jnp.asarray(A), jnp.asarray(B),
                                      ref_mesh((8, 1), ("x", "y")), axis="x"))
    np.testing.assert_allclose(C.numpy(), A @ B, rtol=1e-10)
    np.testing.assert_allclose(C.numpy(), theirs, rtol=1e-10)


def _spd(seed, n=64):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def test_spmd_cholesky_single():
    SPD = _spd(2)
    L = parallel.spmd_cholesky(torch.from_numpy(SPD), 16)
    theirs = np.asarray(ref.spmd_cholesky(jnp.asarray(SPD), 16))
    np.testing.assert_allclose(np.tril(L.numpy()), np.linalg.cholesky(SPD),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(L.numpy(), theirs, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_spmd_cholesky_sharded(shape):
    SPD = _spd(3)
    L = parallel.spmd_cholesky(torch.from_numpy(SPD), 16, mesh=port_mesh(shape))
    theirs = np.asarray(ref.spmd_cholesky(jnp.asarray(SPD), 16, mesh=ref_mesh(shape)))
    np.testing.assert_allclose(np.tril(L.numpy()), np.linalg.cholesky(SPD),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(L.numpy(), theirs, rtol=1e-8, atol=1e-8)


def test_spmd_cholesky_strip_across_two_column_blocks():
    """nb = 12 does not divide a position's 16 columns: a strip spans two
    positions of a row and is summed from both."""
    SPD = _spd(6, 48)
    L = parallel.spmd_cholesky(torch.from_numpy(SPD), 12, mesh=port_mesh((1, 3)))
    np.testing.assert_allclose(np.tril(L.numpy()), np.linalg.cholesky(SPD),
                               rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError, match="multiple of nb"):
        parallel.spmd_cholesky(torch.from_numpy(SPD), 10)


def test_spmd_stencil_matches_reference():
    """Halo exchange on a 4x2 mesh == the dense oracle and the reference's
    SPMD stencil (the 'stencil 2D5pt comm/compute overlap' configuration)."""
    p, q = 4, 2
    grid = np.random.default_rng(0).standard_normal((8 * p, 8 * q)).astype(np.float32)
    out = parallel.spmd_stencil_5pt(torch.from_numpy(grid), 5,
                                    port_mesh((p, q), ("r", "c")), axes=("r", "c"))
    theirs = np.asarray(ref.spmd_stencil_5pt(jnp.asarray(grid), 5,
                                             ref_mesh((p, q), ("r", "c")), axes=("r", "c")))
    np.testing.assert_allclose(out.numpy(), reference_stencil(grid, 5), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), theirs, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(reference_stencil(grid, 5), ref_stencil(grid, 5))


def test_spmd_stencil_single_iteration_edges():
    grid = np.ones((8 * 8, 16), np.float64)
    out = parallel.spmd_stencil_5pt(torch.from_numpy(grid), 1,
                                    port_mesh((8, 1), ("r", "c")), axes=("r", "c"))
    theirs = np.asarray(ref.spmd_stencil_5pt(jnp.asarray(grid), 1,
                                             ref_mesh((8, 1), ("r", "c")), axes=("r", "c")))
    np.testing.assert_allclose(out.numpy(), reference_stencil(grid, 1), rtol=1e-12)
    np.testing.assert_allclose(out.numpy(), theirs, rtol=1e-12)


def test_spmd_takes_numpy_and_refuses_a_ragged_split():
    grid = np.ones((12, 16))
    with pytest.raises(ValueError, match="does not split"):
        parallel.spmd_stencil_5pt(grid, 1, port_mesh((8, 1), ("r", "c")), axes=("r", "c"))
    C = parallel.summa_gemm(np.eye(8), np.ones((8, 8)), port_mesh((2, 4)))
    np.testing.assert_array_equal(C.numpy(), np.ones((8, 8)))
