"""The port's redistribution (parsec_tpu_torch.datadist.redistribute, the
collective ``RedistOp`` path and the array's geometry change) and its
multi-rank tiled-matrix operations against the JAX package's, case for
case with ``tests/collections/test_redistribute_multirank.py``,
``tests/array/test_redistribute.py`` and
``tests/array/test_lowering.py::test_redistribute_algo_resolver_precedence``,
plus the cross-rank ``sum``/``norm`` of ``tests/array/test_numerics.py``
(``test_distributed_sum_allreduce``).

Each case runs the same seeded numpy inputs through both packages over
their in-process fabrics (``test_torch_multirank.run_ranks``).  A
redistribution is a pure copy, so every target tile is held to the
numpy oracle and to the reference's tile bit for bit; a collective
redistribution's ``peak_extra_bytes`` stays within its budget; ``sum``
and ``norm`` agree within the reference test's 1e-9.

The port's own cases: a source whose newest tiles live on the CUDA module
(bound to the torch CPU device) while older host copies remain is read
from the module, never stale, on both paths; a bfloat16 matrix
redistributes bit for bit.
"""

import importlib
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import array as ref_pa  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.datadist import ops as ref_ops  # noqa: E402
from parsec_tpu.dsl.dtd import DTDTaskpool as RefDTD  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch import array as pa  # noqa: E402
from parsec_tpu_torch.core.lifecycle import DEV_CUDA  # noqa: E402
from parsec_tpu_torch.datadist import TwoDimBlockCyclic  # noqa: E402
from parsec_tpu_torch.datadist import ops as port_ops  # noqa: E402
from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, DTDTaskpool  # noqa: E402
from parsec_tpu_torch.utils import mca_param as port_mca  # noqa: E402

from test_torch_multirank import PORT as MR_PORT  # noqa: E402
from test_torch_multirank import REF as MR_REF  # noqa: E402
from test_torch_multirank import host, run_ranks  # noqa: E402

# the packages' datadist/__init__ export the function under the module's name
ref_rd = importlib.import_module("parsec_tpu.datadist.redistribute")
port_rd = importlib.import_module("parsec_tpu_torch.datadist.redistribute")

REF = dict(name="ref", BC=RefBC, TM=RefTiledMatrix, ops=ref_ops, rd=ref_rd,
           DTD=RefDTD, mca=ref_mca, pa=ref_pa, mr=MR_REF,
           Context=parsec_tpu.Context, ctx_kw={}, arr_kw={"use_tpu": False})
PORT = dict(name="port", BC=TwoDimBlockCyclic, TM=None, ops=port_ops, rd=port_rd,
            DTD=DTDTaskpool, mca=port_mca, pa=pa, mr=MR_PORT,
            Context=parsec_tpu_torch.Context, ctx_kw={"devices": ["cpu"]},
            arr_kw={"use_cuda": False})
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def _filled(mat):
    """Fill local tiles of a distributed matrix from a global pattern."""
    for (i, j) in mat.local_tiles():
        ti, tj = mat.tile_shape(i, j)
        base = np.arange(ti * tj, dtype=float).reshape(ti, tj)
        mat.data_of(i, j).newest_copy().payload[:] = (
            base + 1000.0 * i + 10000.0 * j)
    return mat


def _expected_global(m, n, mb, nb):
    G = np.zeros((m, n))
    for i in range((m + mb - 1) // mb):
        for j in range((n + nb - 1) // nb):
            ti = min(mb, m - i * mb)
            tj = min(nb, n - j * nb)
            base = np.arange(ti * tj, dtype=float).reshape(ti, tj)
            G[i * mb:i * mb + ti, j * nb:j * nb + tj] = (
                base + 1000.0 * i + 10000.0 * j)
    return G


def _tiles(T):
    out = {}
    for (i, j) in T.local_tiles():
        h, w = T.tile_shape(i, j)
        out[(i, j)] = host(T.data_of(i, j).newest_copy().payload)[:h, :w].copy()
    return out


# ---------------------------------------------------------------------------
# tests/collections/test_redistribute_multirank.py
# ---------------------------------------------------------------------------

def _across_grids(P, mb_t, nb_t):
    NR, M, N, MB, NB = 2, 24, 24, 8, 8
    results = {}

    def build(rank, ctx):
        S = P["BC"](M, N, MB, NB, p=2, q=1, myrank=rank, name="S")
        _filled(S)
        T = P["BC"](M, N, mb_t, nb_t, p=1, q=2, myrank=rank, name="T")
        for (i, j) in T.local_tiles():
            T.data_of(i, j).newest_copy().payload[:] = 0.0
        results[rank] = T
        return P["rd"].redistribute(ctx, S, T)

    run_ranks(P["mr"], NR, build, timeout=120)
    G = _expected_global(M, N, MB, NB)
    out = {}
    for rank in range(NR):
        T = results[rank]
        for key, got in _tiles(T).items():
            i, j = key
            ti, tj = T.tile_shape(i, j)
            want = G[i * mb_t:i * mb_t + ti, j * nb_t:j * nb_t + tj]
            np.testing.assert_array_equal(got, want, err_msg=f"tile {key} on rank {rank}")
            out[(rank, key)] = got
    return out


@pytest.mark.parametrize("mb_t,nb_t", [(8, 8), (6, 10)])
def test_redistribute_across_grids(mb_t, nb_t):
    """2x1 block-cyclic source -> 1x2 target with a different tiling:
    every target tile gathers from remote source tiles (``auto``: the
    collective path at two ranks), the same bytes on both packages."""
    port, ref = _across_grids(PORT, mb_t, nb_t), _across_grids(REF, mb_t, nb_t)
    assert port.keys() == ref.keys()
    assert all(np.array_equal(port[k], ref[k]) for k in port)


def _reduce_rows(P):
    NR, M, N, MB, NB = 2, 16, 16, 4, 4
    per_rank = {}

    def build(rank, ctx):
        A = P["BC"](M, N, MB, NB, p=2, q=1, myrank=rank, name="A")
        _filled(A)
        per_rank[rank] = (A, P["ops"].reduce_rows(ctx, A, lambda a, b: a + b),
                          P["ops"].reduce_cols(ctx, A, lambda a, b: a + b))
        # the folds wait internally; return a trivially-done taskpool
        return P["DTD"](ctx, name="noop")

    run_ranks(P["mr"], NR, build, timeout=120)
    G = _expected_global(M, N, MB, NB)
    out = {}
    for rank in range(NR):
        A, rows, cols = per_rank[rank]
        for i in range(M // MB):
            if A.rank_of(i, 0) == rank:
                want = sum(G[i * MB:(i + 1) * MB, j * NB:(j + 1) * NB]
                           for j in range(N // NB))
                np.testing.assert_allclose(rows[i], want, err_msg=f"row {i} on rank {rank}")
            else:
                assert rows[i] is None
        for j in range(N // NB):
            if A.rank_of(0, j) == rank:
                want = sum(G[i * MB:(i + 1) * MB, j * NB:(j + 1) * NB]
                           for i in range(M // MB))
                np.testing.assert_allclose(cols[j], want)
            else:
                assert cols[j] is None
        out[rank] = (rows, cols)
    return out


def test_reduce_rows_multirank():
    """Row (and column) folds execute on the owner of each line's first
    tile; remote tiles arrive via shadow tasks (reference reduce_row.jdf
    distributed) — bit for bit the reference's folds."""
    port, ref = _reduce_rows(PORT), _reduce_rows(REF)
    for rank in range(2):
        for a, b in zip(port[rank][0] + port[rank][1], ref[rank][0] + ref[rank][1]):
            assert (a is None and b is None) or np.array_equal(a, b)


def _misaligned(P, algo):
    NR = 2
    M_S, N_S = 23, 29          # 8x8 source tiles: ragged last row/col
    M_T, N_T = 27, 25          # 6x10 target tiles: ragged + different
    m, n = 17, 13              # window smaller than either matrix
    ia, ja, ib, jb = 3, 2, 5, 4
    budget = 1 << 20
    rng = np.random.default_rng(42)
    GS = rng.standard_normal((M_S, N_S))
    sentinel = -7.25  # exactly representable: untouched cells must keep it
    results, pools = {}, {}

    def build(rank, ctx):
        S = P["BC"](M_S, N_S, 8, 8, p=2, q=1, myrank=rank, name="S")
        for (i, j) in S.local_tiles():
            ti, tj = S.tile_shape(i, j)
            S.data_of(i, j).newest_copy().payload[:] = \
                GS[i * 8:i * 8 + ti, j * 8:j * 8 + tj]
        T = P["BC"](M_T, N_T, 6, 10, p=1, q=2, myrank=rank, name="T")
        for (i, j) in T.local_tiles():
            T.data_of(i, j).newest_copy().payload[:] = sentinel
        results[rank] = T
        tp = P["rd"].redistribute(ctx, S, T, m=m, n=n, ia=ia, ja=ja, ib=ib,
                                  jb=jb, algo=algo, mem_budget=budget)
        pools[rank] = tp
        return tp

    run_ranks(P["mr"], NR, build, timeout=120)
    GT = np.full((M_T, N_T), sentinel)
    GT[ib:ib + m, jb:jb + n] = GS[ia:ia + m, ja:ja + n]
    out = {}
    for rank in range(NR):
        T = results[rank]
        for key, got in _tiles(T).items():
            i, j = key
            ti, tj = T.tile_shape(i, j)
            # bit-identical: a redistribution is a copy, not arithmetic
            np.testing.assert_array_equal(
                got, GT[i * 6:i * 6 + ti, j * 10:j * 10 + tj],
                err_msg=f"tile {key} on rank {rank}")
            out[(rank, key)] = got
        assert pools[rank].user["algo"] == algo
        if algo == "coll":
            peak = pools[rank].user["peak_extra_bytes"]
            assert 0 < peak <= budget, (rank, pools[rank].user)
            out[(rank, "peak")] = peak
    return out


@pytest.mark.parametrize("algo", ["dtd", "coll"])
def test_redistribute_misaligned_offsets_vs_numpy(algo):
    """Misaligned windows (ia/ja/ib/jb != 0) over NON-dividing tile sizes
    against a pure-numpy reference — the all-pairs DTD path and the
    memory-bounded collective path are both bit-identical to it and to
    the reference's, and the collective path respects its extra-memory
    budget with the reference's measured peak."""
    port, ref = _misaligned(PORT, algo), _misaligned(REF, algo)
    assert port.keys() == ref.keys()
    for k in port:
        assert np.array_equal(port[k], ref[k]), k


def _budget_run(P, budget):
    NR, M, N, MB, NB = 2, 48, 48, 8, 8
    results, pools = {}, {}

    def build(rank, ctx):
        S = P["BC"](M, N, MB, NB, p=2, q=1, myrank=rank, name="S")
        _filled(S)
        T = P["BC"](M, N, 6, 10, p=1, q=2, myrank=rank, name="T")
        for (i, j) in T.local_tiles():
            T.data_of(i, j).newest_copy().payload[:] = 0.0
        results[rank] = T
        pools[rank] = P["rd"].redistribute(ctx, S, T, algo="coll", mem_budget=budget)
        return pools[rank]

    run_ranks(P["mr"], NR, build, timeout=120)
    G = _expected_global(M, N, MB, NB)
    for rank in range(NR):
        for (i, j), got in _tiles(results[rank]).items():
            ti, tj = results[rank].tile_shape(i, j)
            np.testing.assert_array_equal(got, G[i * 6:i * 6 + ti, j * 10:j * 10 + tj])
        tp = pools[rank]
        assert tp.user["peak_extra_bytes"] <= budget, (budget, rank, tp.user)
        assert tp.user["budget"] == budget
    return [dict(pools[r].user) for r in range(NR)]


def test_redistribute_coll_budget_bounds_peak():
    """The collective path's measured peak extra memory tracks the
    configured budget: a tight budget forces more, smaller rounds (lower
    peak) than a loose one, both within their limits, identical bytes —
    and the same peaks as the reference's."""
    tight, loose = 4096, 1 << 22
    for budget in (tight, loose):
        assert _budget_run(PORT, budget) == _budget_run(REF, budget)
    assert (max(u["peak_extra_bytes"] for u in _budget_run(PORT, tight))
            < max(u["peak_extra_bytes"] for u in _budget_run(PORT, loose)))


@BOTH
def test_rank_mismatch_refused(P):
    """A 4-rank distribution under a 1-rank context must refuse loudly
    (remote tiles would silently materialize as zeros)."""
    A = P["BC"](16, 16, 4, 4, p=2, q=2, myrank=0)
    with P["Context"](nb_cores=1, **P["ctx_kw"]) as ctx:
        with pytest.raises(ValueError, match="distributed over 4 ranks"):
            P["ops"].reduce_rows(ctx, A, lambda a, b: a + b)
        with pytest.raises(ValueError, match="redistribute"):
            P["rd"].redistribute(ctx, A, A)


# ---------------------------------------------------------------------------
# tests/array/test_redistribute.py and the resolver
# ---------------------------------------------------------------------------

@BOTH
def test_lazy_redistribute_single_rank_is_copy(P):
    rng = np.random.default_rng(3)
    G = rng.standard_normal((20, 12))  # ragged under (8, 4)
    A = P["pa"].from_numpy(G, 8, 4)
    R = A.redistribute(P["pa"].BlockCyclic(1, 1))
    assert not R.computed  # lazy node, same program
    with P["Context"](nb_cores=2, **P["ctx_kw"]) as ctx:
        R.compute(ctx, **P["arr_kw"])
    assert np.array_equal(R.to_numpy(), G)


@BOTH
def test_lazy_redistribute_composes_into_one_taskpool(P):
    """redistribute feeding further ops stays ONE taskpool."""
    rng = np.random.default_rng(5)
    G = rng.standard_normal((16, 16))
    A = P["pa"].from_numpy(G, 4)
    out = A.redistribute(P["pa"].BlockCyclic(1, 1)) + A
    before = P["pa"].counters()["taskpools_built"]
    with P["Context"](nb_cores=2, **P["ctx_kw"]) as ctx:
        out.compute(ctx, **P["arr_kw"])
    assert P["pa"].counters()["taskpools_built"] == before + 1
    assert np.allclose(out.to_numpy(), 2 * G)


def _lazy_across(P):
    NR, n, nb = 2, 24, 8
    rng = np.random.default_rng(7)
    G = rng.standard_normal((n, n))
    outs = {}

    def build(rank, ctx):
        A = P["pa"].from_numpy(G, nb, dist=P["pa"].BlockCyclic(NR, 1), myrank=rank)
        R = A.redistribute(P["pa"].BlockCyclic(1, NR))
        prog = P["pa"].lower([R], **P["arr_kw"])
        outs[rank] = (prog, R)
        return prog.taskpool(ctx)

    run_ranks(P["mr"], NR, build, timeout=120)
    got = {}
    for rank in range(NR):
        prog, R = outs[rank]
        prog.finalize()
        cl = R._node.coll
        assert cl.rank_of(0, 1) != cl.rank_of(0, 0)  # really re-placed
        for key, tile in _tiles(cl).items():
            i, j = key
            h, w = cl.tile_shape(i, j)
            np.testing.assert_array_equal(tile, G[i * nb:i * nb + h, j * nb:j * nb + w])
            got[(rank, key)] = tile
    return got


def test_lazy_redistribute_across_grids_2_ranks():
    """1-D row grid -> 1-D column grid, same tiling: every moved tile
    crosses the wire as a flow dependency inside the taskpool."""
    port, ref = _lazy_across(PORT), _lazy_across(REF)
    assert port.keys() == ref.keys()


@BOTH
def test_geometry_change_uses_datadist_path(P):
    """mb/nb changes route through datadist.redistribute (the shared
    resolver picks dtd on a single-rank mesh) and return a leaf."""
    rng = np.random.default_rng(11)
    G = rng.standard_normal((24, 24))
    A = P["pa"].from_numpy(G, 8)
    with pytest.raises(ValueError, match="needs context"):
        A.redistribute(P["pa"].BlockCyclic(1, 1), mb=6, nb=6)
    with P["Context"](nb_cores=2, **P["ctx_kw"]) as ctx:
        R = A.redistribute(P["pa"].BlockCyclic(1, 1), mb=6, nb=6, context=ctx)
    assert R.computed and (R.mb, R.nb) == (6, 6)
    assert np.array_equal(R.to_numpy(), G)


@BOTH
def test_redistribute_algo_resolver_precedence(P):
    resolve = P["rd"].resolve_redistribute_algo
    mca = P["mca"]
    # default: auto resolves by mesh shape (no context -> dtd)
    assert resolve(None, None) == "dtd"
    assert resolve("auto", None) == "dtd"
    assert resolve("coll", None) == "coll"
    # an explicitly configured MCA value beats a caller's literal "auto"
    mca.params.set("runtime", "redistribute_algo", "coll")
    try:
        assert resolve("auto", None) == "coll"
        assert resolve(None, None) == "coll"
        # ...but never an explicit caller choice
        assert resolve("dtd", None) == "dtd"
    finally:
        mca.params.unset("runtime", "redistribute_algo")
    with pytest.raises(ValueError, match="unknown redistribute algo"):
        resolve("bogus", None)


# ---------------------------------------------------------------------------
# the array's cross-rank paths: sum / norm, a geometry change at 2 ranks
# ---------------------------------------------------------------------------

def _array_cross_rank(P, algo):
    n, nb, NR = 24, 8, 2
    rng = np.random.default_rng(31)
    G = rng.standard_normal((n, n))
    res, tiles = {}, {}

    def build(rank, ctx):
        # one name on every rank, as each process of an SPMD run draws it
        # (the in-process ranks share one leaf counter)
        A = P["pa"].from_numpy(G, nb, dist=P["pa"].BlockCyclic(NR, 1), myrank=rank,
                               name="A")
        res[rank] = (A.sum(ctx, **P["arr_kw"]), A.norm(ctx, **P["arr_kw"]))
        R = A.redistribute(P["pa"].BlockCyclic(1, NR), mb=6, nb=12, context=ctx,
                           algo=algo)
        tiles[rank] = _tiles(R._node.coll)
        return P["DTD"](ctx, name="noop")

    run_ranks(P["mr"], NR, build, timeout=120)
    for rank in range(NR):
        s, nrm = res[rank]
        assert abs(s - G.sum()) < 1e-9, rank
        assert abs(nrm - np.linalg.norm(G)) < 1e-9, rank
        for (i, j), t in tiles[rank].items():
            np.testing.assert_array_equal(t, G[i * 6:i * 6 + t.shape[0],
                                               j * 12:j * 12 + t.shape[1]])
    return res, tiles


@pytest.mark.parametrize("algo", ["dtd", "coll"])
def test_distributed_sum_norm_and_geometry_change(algo):
    """sum() and norm() fold local partials and allreduce across ranks
    through the collectives — every rank gets the global value, within
    1e-9 of numpy's and equal to the reference's — and a geometry-changing
    redistribute at 2 ranks copies every tile bit for bit."""
    port, ref = _array_cross_rank(PORT, algo), _array_cross_rank(REF, algo)
    for rank in range(2):
        assert port[0][rank] == pytest.approx(ref[0][rank], abs=1e-9)
        assert port[0][rank] == port[0][0]
        assert port[1][rank].keys() == ref[1][rank].keys()


# ---------------------------------------------------------------------------
# the port's own: a device-resident source, bfloat16
# ---------------------------------------------------------------------------

def _bump(t):
    return t * 2.0 + 1.0


@pytest.mark.parametrize("algo", ["dtd", "coll"])
def test_device_resident_source_is_never_read_stale(algo):
    """Every source tile is rewritten by a device chore (the CUDA module
    bound to the torch CPU device), so its newest copy lives on the module
    and its host copy is stale; both paths copy the new values."""
    NR, M, N = 2, 24, 24
    rng = np.random.default_rng(8)
    G = rng.standard_normal((M, N))
    results = {}

    def build(rank, ctx):
        S = TwoDimBlockCyclic(M, N, 8, 8, p=2, q=1, myrank=rank, name="S").from_array(G)
        T = TwoDimBlockCyclic(M, N, 6, 12, p=1, q=2, myrank=rank, name="T")
        d = DTDTaskpool(ctx, name="touch")
        for (i, j) in S.tiles():
            d.insert_task({DEV_CUDA: _bump}, (S.data_of(i, j), INOUT | AFFINITY),
                          name="touch")
        assert d.wait(timeout=60)
        for (i, j) in S.local_tiles():
            newest = S.data_of(i, j).newest_copy()
            assert newest.device_index != 0 and isinstance(newest.payload, torch.Tensor)
        results[rank] = T
        return port_rd.redistribute(ctx, S, T, algo=algo)

    run_ranks(MR_PORT, NR, build, timeout=120, ctx_kw={"cuda_device": "cpu"})
    want = G * 2.0 + 1.0
    for rank in range(NR):
        for (i, j), got in _tiles(results[rank]).items():
            np.testing.assert_array_equal(got, want[i * 6:i * 6 + got.shape[0],
                                                    j * 12:j * 12 + got.shape[1]])


@pytest.mark.parametrize("algo", ["dtd", "coll"])
def test_bfloat16_matrix_redistributes_bit_for_bit(algo):
    NR = 2
    rng = np.random.default_rng(12)
    G = torch.from_numpy(rng.standard_normal((16, 20)).astype(np.float32)).to(torch.bfloat16)
    results = {}

    def build(rank, ctx):
        S = TwoDimBlockCyclic(16, 20, 8, 8, p=2, q=1, myrank=rank, name="S",
                              dtype=torch.bfloat16)
        for (i, j) in S.local_tiles():
            h, w = S.tile_shape(i, j)
            S.data_of(i, j).newest_copy().payload.copy_(G[i * 8:i * 8 + h, j * 8:j * 8 + w])
        T = TwoDimBlockCyclic(16, 20, 4, 10, p=1, q=2, myrank=rank, name="T",
                              dtype=torch.bfloat16)
        results[rank] = T
        return port_rd.redistribute(ctx, S, T, algo=algo)

    run_ranks(MR_PORT, NR, build, timeout=120)
    for rank in range(NR):
        T = results[rank]
        for (i, j) in T.local_tiles():
            h, w = T.tile_shape(i, j)
            got = T.data_of(i, j).newest_copy().payload[:h, :w]
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16),
                               G[i * 4:i * 4 + h, j * 10:j * 10 + w].contiguous().view(torch.int16))


def test_norm_matches_math():
    """norm() is the square root of the allreduced square sum."""
    rng = np.random.default_rng(2)
    G = rng.standard_normal((16, 16))
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        A = pa.from_numpy(G, 8)
        assert abs(A.norm(ctx, use_cuda=False) - math.sqrt((G * G).sum())) < 1e-9
