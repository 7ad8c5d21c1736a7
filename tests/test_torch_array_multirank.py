"""The port's array front end at 2 and 4 ranks (parsec_tpu_torch.array over
the in-process fabric) against the JAX package's: the multi-rank cases of
``tests/array/test_numerics.py`` that need no allreduce.

* the mixed program ``C = (A @ A.T + B).cholesky(); x = C.solve(b)`` at 2
  ranks (Block-cyclic 2x1) and 4 ranks (a 2x2 grid): every rank builds
  the same program over its own ``myrank`` (SPMD) and runs it on its
  context; each rank's tiles of C and x are within 1e-10 of the numpy
  oracle and equal, bit for bit, to the JAX package's (host bodies, the
  same numpy in the same order);
* a sequence of programs on one mesh (``A.T``, ``A @ t``, ``+ B``,
  ``cholesky``), each pool named with the engine's SPMD sequence number
  so same-named pools never cross-talk;
* a ``Replicated()`` right-hand side read locally on every rank (one
  reader class only), the result landing on its canonical owner.

The cross-rank ``sum`` (the allreduce) is ``tests/test_torch_redistribute.py``'s.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu import array as ref_pa  # noqa: E402
from parsec_tpu.dsl.dtd import DTDTaskpool as RefDTD  # noqa: E402
from parsec_tpu_torch import array as pa  # noqa: E402
from parsec_tpu_torch.dsl.dtd import DTDTaskpool  # noqa: E402

from test_torch_multirank import PORT, REF, host, run_ranks  # noqa: E402

SIDES = [(REF, ref_pa, {"use_tpu": False}, RefDTD),
         (PORT, pa, {"use_cuda": False}, DTDTaskpool)]


def _spd(n, rng):
    G = rng.standard_normal((n, n))
    return G, G @ G.T + n * np.eye(n)


def _tiles(coll):
    out = {}
    for (i, j) in coll.local_tiles():
        h, w = coll.tile_shape(i, j)
        out[(i, j)] = host(coll.data_of(i, j).newest_copy().payload)[:h, :w]
    return out


def _mixed(side, nranks, q, n=32, nb=8):
    P, p_, kw, _ = side
    rng = np.random.default_rng(29)
    G, _ = _spd(n, rng)
    H = np.eye(n) * n
    rhs = rng.standard_normal((n, 2))
    outs = {}

    def build(rank, ctx):
        dist = p_.BlockCyclic(nranks // q, q)
        A = p_.from_numpy(G, nb, dist=dist, myrank=rank)
        B = p_.from_numpy(H, nb, dist=dist, myrank=rank)
        b = p_.from_numpy(rhs, nb, 2, dist=p_.BlockCyclic(nranks // q, q),
                          myrank=rank)
        C = (A @ A.T + B).cholesky()
        x = C.solve(b)
        prog = p_.lower([x, C], **kw)
        outs[rank] = (prog, C, x)
        return prog.taskpool(ctx)

    run_ranks(P, nranks, build, timeout=180)
    res = {}
    for rank, (prog, C, x) in outs.items():
        prog.finalize()
        res[rank] = (_tiles(C._node.coll), _tiles(x._node.coll))
    L = np.linalg.cholesky(G @ G.T + H)
    return res, L, np.linalg.solve(L, rhs)


@pytest.mark.parametrize("nranks,q", [(2, 1), (4, 2)], ids=["2_ranks", "4_ranks_2x2"])
def test_mixed_program_multi_rank(nranks, q):
    nb = 8
    port, L, xo = _mixed(SIDES[1], nranks, q)
    ref, _, _ = _mixed(SIDES[0], nranks, q)
    for rank in range(nranks):
        ctiles, xtiles = port[rank]
        assert ctiles, f"rank {rank} holds no factor tile"
        for (i, j), got in ctiles.items():
            h, w = got.shape
            np.testing.assert_allclose(
                got, np.tril(L)[i * nb:i * nb + h, j * nb:j * nb + w],
                atol=1e-10, err_msg=f"L tile {(i, j)} rank {rank}")
            np.testing.assert_array_equal(got, ref[rank][0][(i, j)])
        for (i, j), got in xtiles.items():
            h, w = got.shape
            np.testing.assert_allclose(
                got, xo[i * nb:i * nb + h, j * 2:j * 2 + w], atol=1e-10)
            np.testing.assert_array_equal(got, ref[rank][1][(i, j)])


def _sequential(side):
    P, p_, kw, DTD = side
    NR, n, nb = 2, 48, 8
    rng = np.random.default_rng(41)
    G = rng.standard_normal((n, n))
    H = np.eye(n) * n
    outs = {}

    def build(rank, ctx):
        dist = p_.Block1D(NR)
        ckw = dict(kw, timeout=90)
        A = p_.from_numpy(G, nb, dist=dist, myrank=rank)
        B = p_.from_numpy(H, nb, dist=dist, myrank=rank)
        t = A.T
        t.compute(ctx, **ckw)
        m1 = A @ t
        m1.compute(ctx, **ckw)
        m2 = m1 + B
        m2.compute(ctx, **ckw)
        C = m2.cholesky()
        C.compute(ctx, **ckw)
        outs[rank] = C
        return DTD(ctx, name=f"noop{rank}", auto_add=False)

    run_ranks(P, NR, build, timeout=240)
    return ({r: _tiles(outs[r]._node.coll) for r in range(NR)},
            np.linalg.cholesky(G @ G.T + H))


def test_sequential_programs_on_one_mesh():
    """Four programs in a row on one persistent mesh, each pool's name
    suffixed with the engine's SPMD sequence number: all complete, the
    factor is right and equals the JAX package's."""
    nb = 8
    port, L = _sequential(SIDES[1])
    ref, _ = _sequential(SIDES[0])
    for rank, tiles in port.items():
        for (i, j), got in tiles.items():
            h, w = got.shape
            np.testing.assert_allclose(
                got, np.tril(L)[i * nb:i * nb + h, j * nb:j * nb + w],
                atol=1e-10, err_msg=f"tile {(i, j)} rank {rank}")
            np.testing.assert_array_equal(got, ref[rank][(i, j)])


def _replicated(side):
    P, p_, kw, _ = side
    n, nb, NR = 16, 4, 2
    rng = np.random.default_rng(37)
    G, _ = _spd(n, rng)
    rhs = rng.standard_normal((n, 1))
    outs = {}
    readers = {}

    def build(rank, ctx):
        dist = p_.Block1D(NR)
        A = p_.from_numpy(G, nb, dist=dist, myrank=rank)
        B = p_.from_numpy(n * np.eye(n), nb, dist=dist, myrank=rank)
        b = p_.from_numpy(rhs, nb, 1, dist=p_.Replicated(), myrank=rank)
        x = (A @ A.T + B).cholesky().solve(b)
        prog = p_.lower([x], **kw)
        readers[rank] = [c for c in prog.ptg.classes if c.startswith("arr_ld")]
        outs[rank] = (prog, x)
        return prog.taskpool(ctx)

    run_ranks(P, NR, build, timeout=120)
    prog, x = outs[0]
    prog.finalize()
    xl = x._node.coll
    got = {}
    for (i, j) in xl.tiles():
        h, w = xl.tile_shape(i, j)
        got[(i, j)] = host(xl.data_of(i, j).newest_copy().payload)[:h, :w]
    L = np.linalg.cholesky(G @ G.T + n * np.eye(n))
    return readers, got, np.linalg.solve(L, rhs)


def test_replicated_rhs_reads_locally():
    nb = 4
    readers, got, xo = _replicated(SIDES[1])
    ref_readers, ref_got, _ = _replicated(SIDES[0])
    assert all(len(r) == 1 for r in readers.values()), readers
    assert readers == ref_readers
    for (i, j), g in got.items():
        np.testing.assert_allclose(g, xo[i * nb:i * nb + g.shape[0], :g.shape[1]],
                                   atol=1e-10)
        np.testing.assert_array_equal(g, ref_got[(i, j)])
