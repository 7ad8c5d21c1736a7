"""The port's tiled-matrix operations and band storage
(parsec_tpu_torch.datadist.ops, .band and the band distributions of
.matrix) against the JAX package's.

* ``tests/collections/test_matrix_ops.py``'s apply, map and reduce cases
  run the same seeded matrices through both packages: the tiles are
  ``np.array_equal`` (the same numpy operators in the same per-tile
  order; the full reduction combines in tile order in both) and within
  the reference's tolerances of numpy's answer.  Its redistribute cases
  wait for the distributed layer (ROADMAP A.8): a matrix spread over
  several ranks raises, naming it.
* ``tests/collections/test_band.py``'s routing case and its single-rank
  ``diag_band_to_rect`` case: equal rank and storage routing, and the
  packed band equal in both packages and to the numpy oracle.  Also a
  band packed from a factor whose tiles are newest on the CUDA module
  (bound to the torch CPU device): the host bodies read the device's
  versions.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import datadist as ref_dd  # noqa: E402
from parsec_tpu.datadist import band as ref_band  # noqa: E402
from parsec_tpu_torch import datadist as dd  # noqa: E402
from parsec_tpu_torch.datadist import band  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402

REF = dict(dd=ref_dd, band=ref_band,
           Context=lambda: parsec_tpu.Context(nb_cores=4, devices=["cpu"]))
PORT = dict(dd=dd, band=band,
            Context=lambda: parsec_tpu_torch.Context(nb_cores=4, devices=["cpu"]))


def both(scenario):
    out = []
    for P in (REF, PORT):
        with P["Context"]() as ctx:
            out.append(scenario(P["dd"], ctx))
    return out


def _equal(res):
    ref, port = res
    for a, b in zip(ref, port):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    return port


# ---------------------------------------------------------------------------
# tests/collections/test_matrix_ops.py
# ---------------------------------------------------------------------------

def test_apply_scales_every_tile():
    M = np.random.default_rng(0).standard_normal((20, 20))

    def run(m, ctx):
        A = m.TiledMatrix(20, 20, 8, 8).from_array(M)
        tp = m.apply_taskpool(ctx, A, lambda t, i, j: t.__imul__(2.0))
        assert tp.wait(timeout=30)
        return [A.to_array()]

    [out] = _equal(both(run))
    np.testing.assert_allclose(out, M * 2)


def test_apply_functional_return():
    def run(m, ctx):
        A = m.TiledMatrix(12, 12, 4, 4).from_array(np.ones((12, 12)))
        tp = m.apply_taskpool(ctx, A, lambda t, i, j: t + i + j)
        assert tp.wait(timeout=30)
        return [A.to_array()]

    [out] = _equal(both(run))
    expect = np.ones((12, 12))
    for i in range(3):
        for j in range(3):
            expect[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4] += i + j
    np.testing.assert_array_equal(out, expect)


def test_apply_lower_storage_touches_stored_tiles_only():
    M = np.random.default_rng(7).standard_normal((16, 16))

    def run(m, ctx):
        A = m.TiledMatrix(16, 16, 4, 4, uplo="lower").from_array(M)
        tp = m.apply_taskpool(ctx, A, lambda t, i, j: t - 1.0)
        assert tp.wait(timeout=30)
        return [A.to_array()]

    [out] = _equal(both(run))
    lower = np.kron(np.tril(np.ones((4, 4))), np.ones((4, 4))).astype(bool)
    np.testing.assert_allclose(out[lower], M[lower] - 1.0, rtol=0, atol=1e-15)
    assert not out[~lower].any()  # tiles not stored are never materialized


def test_map_operator_binary():
    rng = np.random.default_rng(1)
    Ma, Mb = rng.standard_normal((16, 16)), rng.standard_normal((16, 16))

    def run(m, ctx):
        A = m.TiledMatrix(16, 16, 8, 8).from_array(Ma)
        B = m.TiledMatrix(16, 16, 8, 8).from_array(Mb)
        tp = m.map_operator(ctx, A, B, lambda a, b, i, j: b + a * 3.0)
        assert tp.wait(timeout=30)
        return [A.to_array(), B.to_array()]

    a, b = _equal(both(run))
    np.testing.assert_array_equal(a, Ma)
    np.testing.assert_allclose(b, Mb + 3 * Ma)


def test_map_operator_grid_mismatch_rejected():
    with PORT["Context"]() as ctx:
        A = dd.TiledMatrix(8, 8, 4, 4)
        B = dd.TiledMatrix(8, 8, 2, 2)
        with pytest.raises(ValueError, match="matching tile grids"):
            dd.map_operator(ctx, A, B, lambda a, b, i, j: b)


def test_reduce_full_sum():
    M = np.random.default_rng(2).standard_normal((24, 24))

    def run(m, ctx):
        tp = m.reduce_taskpool(ctx, m.TiledMatrix(24, 24, 8, 8).from_array(M),
                               tile_reduce=np.sum, combine=lambda a, b: a + b)
        return [tp.result]

    [total] = _equal(both(run))
    assert total == pytest.approx(M.sum())


def test_reduce_rows_cols():
    M = np.random.default_rng(3).standard_normal((12, 12))

    def run(m, ctx):
        A = m.TiledMatrix(12, 12, 4, 4).from_array(M)
        return (m.reduce_rows(ctx, A, lambda a, b: a + b)
                + m.reduce_cols(ctx, A, lambda a, b: a + b))

    out = _equal(both(run))
    for i, r in enumerate(out[:3]):
        np.testing.assert_allclose(
            r, sum(M[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4] for j in range(3)))
    for j, c in enumerate(out[3:]):
        np.testing.assert_allclose(
            c, sum(M[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4] for i in range(3)))


def test_reduce_rows_upper_storage_skips_empty():
    """Triangular storage: a row that stores no tile folds to None."""
    M = np.random.default_rng(8).standard_normal((12, 12))

    def run(m, ctx):
        A = m.TiledMatrix(12, 12, 4, 4, uplo="upper").from_array(M)
        cols = m.reduce_cols(ctx, A, lambda a, b: a + b)
        return [c is None for c in cols] + [c for c in cols if c is not None]

    out = _equal(both(run))
    assert out[:3] == [False, False, False]


@pytest.mark.parametrize("op", ["apply", "map", "reduce", "rows", "cols"])
def test_multirank_matrix_raises_naming_a8(op):
    """A matrix spread over two ranks needs the distributed layer."""
    A = dd.TwoDimBlockCyclic(8, 8, 4, 4, p=2, q=1, myrank=0, name="A")
    with PORT["Context"]() as ctx:
        call = {"apply": lambda: dd.apply_taskpool(ctx, A, lambda t, i, j: t),
                "map": lambda: dd.map_operator(ctx, A, A, lambda a, b, i, j: b),
                "reduce": lambda: dd.reduce_taskpool(ctx, A, np.sum, max),
                "rows": lambda: dd.reduce_rows(ctx, A, max),
                "cols": lambda: dd.reduce_cols(ctx, A, max)}[op]
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            call()


# ---------------------------------------------------------------------------
# tests/collections/test_band.py
# ---------------------------------------------------------------------------

def test_band_distribution_routing():
    """Band tiles route to the band sub-distribution at the remapped row,
    the others to the off-band distribution, in both packages; storage
    lives in the sub-collections."""
    routes = []
    for m in (ref_dd, dd):
        nodes, bs = 4, 2
        b = m.TwoDimBlockCyclic(3 * 16, 8 * 16, 16, 16, p=1, q=nodes,
                                myrank=0, name="band")
        off = m.TwoDimBlockCyclic(8 * 16, 8 * 16, 16, 16, p=2, q=2,
                                  myrank=0, name="off")
        dc = m.TwoDimBlockCyclicBand(b, off, bs)
        r = []
        for i in range(8):
            for j in range(8):
                if abs(i - j) < bs:
                    assert dc.data_of(i, j) is b.data_of(i - j + bs - 1, j)
                else:
                    assert dc.data_of(i, j) is off.data_of(i, j)
                r.append((dc.rank_of(i, j), dc.vpid_of(i, j)))
        sb = m.TwoDimBlockCyclic(bs * 16, 8 * 16, 16, 16, p=1, q=nodes,
                                 myrank=0, name="sband")
        sdc = m.SymTwoDimBlockCyclicBand(sb, off, bs)
        assert sdc.rank_of(5, 4) == sb.rank_of(1, 4)
        assert sdc.rank_of(4, 5) == sb.rank_of(1, 5)
        assert sdc.rank_of(6, 2) == off.rank_of(6, 2)
        assert sdc.data_of(4, 5) is sb.data_of(1, 5)
        r += [sdc.rank_of(i, j) for i in range(8) for j in range(8)]
        r += [dc.name, sdc.name, (dc.mt, dc.nt, dc.mb)]
        routes.append(r)
    assert routes[0] == routes[1]


@pytest.mark.parametrize("cls", ["TwoDimBlockCyclicBand", "SymTwoDimBlockCyclicBand"])
def test_band_size_must_be_positive(cls):
    off = dd.TiledMatrix(8, 8, 4, 4)
    with pytest.raises(ValueError, match="band_size"):
        getattr(dd, cls)(dd.TiledMatrix(4, 8, 4, 4), off, 0)


def test_diag_band_to_rect_single_rank():
    MB = NB = 8
    NT = 4
    Afull = np.random.default_rng(3).standard_normal((NT * MB, NT * NB))

    def run(m, ctx):
        P = REF if m is ref_dd else PORT
        A = m.TiledMatrix(NT * MB, NT * NB, MB, NB, name="A").from_array(Afull)
        B = m.TiledMatrix(MB + 1, NT * (NB + 2), MB + 1, NB + 2, name="B")
        tp = P["band"].diag_band_to_rect_ptg(MB, NB).taskpool(NT=NT, A=A, B=B)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        return [B.to_array()]

    [got] = _equal(both(run))
    np.testing.assert_array_equal(
        got, band.diag_band_to_rect_reference(Afull, MB, NB, NT))


@pytest.mark.parametrize("pad", [False, True])
def test_band_oracle_matches_reference(pad):
    Afull = np.random.default_rng(6).standard_normal((24, 24))
    np.testing.assert_array_equal(
        band.diag_band_to_rect_reference(Afull, 8, 8, 3, pad=pad),
        ref_band.diag_band_to_rect_reference(Afull, 8, 8, 3, pad=pad))


def test_diag_band_to_rect_of_a_device_newest_factor():
    """The factor's tiles are newest on the CUDA module (torch CPU device)
    when the band PTG runs in the same context: the host bodies stage the
    device's versions, so the band equals the oracle of the factor."""
    n, nb = 64, 16
    nt = n // nb
    m = np.random.default_rng(4).standard_normal((n, n)).astype(np.float32)
    S = m @ m.T + n * np.eye(n, dtype=np.float32)
    A = dd.TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    B = dd.TiledMatrix(nb + 1, nt * (nb + 2), nb + 1, nb + 2, name="B",
                       dtype=np.float32)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        tp = cholesky_ptg(use_kernels=True).taskpool(NT=nt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        assert A.data_of(1, 0).newest_copy().device_index != 0
        tp = band.diag_band_to_rect_ptg(nb, nb).taskpool(NT=nt, A=A, B=B)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    np.testing.assert_array_equal(
        B.to_array(), band.diag_band_to_rect_reference(A.to_array(), nb, nb, nt))
