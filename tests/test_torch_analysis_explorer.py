"""The port's schedule explorer (parsec_tpu_torch.analysis.schedules) at
one rank, against the JAX package's.

The one-rank cases of the reference's
``tests/analysis/test_schedule_explorer.py``: the ``rnd`` scheduler's
``sched_rnd_seed`` replay, the explorer over dpotrf and the stencil
(bit-identical digests across seeds, a clean hb-check, and the same
values as the JAX package's explorer and the numpy references), and a
schedule-dependent pool failing loudly.  Beyond those: the dpotrf with
the B1 kernel chores on the CUDA module bound to the torch CPU device
(its digests are those of its newest copies, torch tensors), the digest
of a tensor payload, and the two-rank explorer over the perturbed
in-process fabric.  Every explorer run has its own time limit.  The reference's
200-seed sweep stays ``slow``, as it is there.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.analysis import schedules as ref_schedules  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.analysis.schedules import (  # noqa: E402
    ExplorationError,
    ExplorerFabric,
    explore,
    tile_digest,
)

RUN_LIMIT = 240


def _within(fn, limit=RUN_LIMIT):
    """Run ``fn`` on a daemon thread; fail the test if it does not return
    within ``limit`` seconds.  Returns ``fn``'s result or re-raises."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the test thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"run did not finish within {limit} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture
def cpu_device():
    """The explorer's contexts attach the CUDA module as any Context does:
    bind it to the torch CPU device."""
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


# ---------------------------------------------------------------------------
# the rnd scheduler's replay hook (MCA sched_rnd_seed)
# ---------------------------------------------------------------------------

class _T:
    def __init__(self, k):
        self.k = k
        self.priority = 0


def _pop_order(rnd_cls, params, seed_set, seed=0):
    if seed_set:
        params.set("sched", "rnd_seed", seed)
    try:
        s = rnd_cls()
        s.install(context=None)
        s.schedule(None, [_T(k) for k in range(32)])
        out = []
        while True:
            t = s.select(None)
            if t is None:
                return [x.k for x in out], s.seed
            out.append(t)
    finally:
        params.unset("sched", "rnd_seed")


def test_rnd_seed_replays_one_schedule():
    from parsec_tpu.core.sched.rnd import SchedRND as RefSchedRND
    from parsec_tpu_torch.core.sched.rnd import SchedRND

    a, seed_a = _pop_order(SchedRND, mca_param.params, True, 1234)
    b, seed_b = _pop_order(SchedRND, mca_param.params, True, 1234)
    c, _ = _pop_order(SchedRND, mca_param.params, True, 99)
    assert seed_a == seed_b == 1234
    assert a == b and a != c
    # the same seed gives the reference's schedule
    assert a == _pop_order(RefSchedRND, ref_mca_param.params, True, 1234)[0]


def test_rnd_default_stays_unseeded():
    from parsec_tpu_torch.core.sched.rnd import SchedRND

    assert _pop_order(SchedRND, mca_param.params, False)[1] is None


# ---------------------------------------------------------------------------
# explorer over dpotrf and the stencil (one rank)
# ---------------------------------------------------------------------------

N, NB = 32, 8
_M = np.random.default_rng(7).standard_normal((N, N))
SPD = _M @ _M.T + N * np.eye(N)


def _build_dpotrf(rank, ctx):
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops.cholesky import cholesky_ptg

    A = TiledMatrix(N, N, NB, NB, name="A").from_array(SPD)
    return cholesky_ptg(use_cuda=False).taskpool(NT=A.mt, A=A), A


def _ref_build_dpotrf(rank, ctx):
    from parsec_tpu.datadist import TiledMatrix
    from parsec_tpu.ops.cholesky import cholesky_ptg

    A = TiledMatrix(N, N, NB, NB, name="A")
    A.from_array(SPD)
    return cholesky_ptg(use_tpu=False).taskpool(NT=A.mt, A=A), A


def _stitch(tiles, dtype=np.float64):
    out = np.zeros((N, N), dtype)
    for (i, j), (shape, dt, raw) in tiles.items():
        out[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB] = \
            np.frombuffer(raw, dtype=dt).reshape(shape)
    return out


def test_explorer_dpotrf_identical_and_raceless(cpu_device):
    """Four seeds on the port's host chores: identical, raceless, right,
    and the values of the JAX package's explorer on the same matrix."""
    res = _within(lambda: explore(_build_dpotrf, nranks=1, seeds=range(4),
                                  timeout=90))
    assert res.identical and res.race_findings() == []
    assert sorted(res.wall_s) == [0, 1, 2, 3]
    d0 = res.digests[0][0]
    np.testing.assert_allclose(np.tril(_stitch(d0)), np.linalg.cholesky(SPD),
                               rtol=1e-8, atol=1e-8)
    ref = _within(lambda: ref_schedules.explore(
        _ref_build_dpotrf, nranks=1, seeds=range(2), timeout=90))
    assert ref.identical
    np.testing.assert_allclose(_stitch(d0), _stitch(ref.digests[0][0]),
                               rtol=1e-12, atol=1e-12)


def test_explorer_kernel_dpotrf_on_the_cuda_module(cpu_device):
    """The B1 chores on the CUDA module (bound to the torch CPU device):
    the newest copies are torch tensors, digested bit for bit, identical
    across seeds, equal to an unexplored run's factor."""
    import parsec_tpu_torch
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops.cholesky import cholesky_ptg

    S32 = SPD.astype(np.float32)

    def build(rank, ctx):
        A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S32)
        return cholesky_ptg(use_cuda=True, use_cpu=False,
                            use_kernels=True).taskpool(NT=A.mt, A=A), A

    A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S32)
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
        NT=A.mt, A=A)
    with parsec_tpu_torch.Context(nb_cores=2) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    want = A.to_array()
    res = _within(lambda: explore(build, nranks=1, seeds=range(3), timeout=90))
    assert res.identical and res.race_findings() == []
    d0 = res.digests[0][0]
    assert all(dt == "float32" for (_s, dt, _r) in d0.values())
    np.testing.assert_array_equal(_stitch(d0, np.float32), want)


GRID = np.random.default_rng(3).standard_normal((16, 16))
T_ITERS = 2


def _build_stencil(rank, ctx):
    from parsec_tpu_torch.ops.stencil import StencilBuffers, stencil_ptg

    A = StencilBuffers(GRID, 2, 2)
    tp = stencil_ptg(use_cuda=False, use_cpu=True).taskpool(
        T=T_ITERS, MT=2, NT=2, A=A)
    return tp, A


def _stencil_snapshot(users):
    A = users[0]
    tiles = {}
    for i in range(A.mt):
        for j in range(A.nt):
            c = A.data_of(T_ITERS % 2, i, j).newest_copy()
            arr = np.asarray(c.payload)
            tiles[(i, j)] = (arr.shape, str(arr.dtype), arr.tobytes())
    return tiles


def test_explorer_stencil_identical_and_raceless(cpu_device):
    from parsec_tpu_torch.ops.stencil import reference_stencil

    res = _within(lambda: explore(_build_stencil, nranks=1, seeds=range(4),
                                  timeout=90, snapshot=_stencil_snapshot))
    assert res.identical and res.race_findings() == []
    ref = reference_stencil(GRID, T_ITERS)
    th = GRID.shape[0] // 2
    for (i, j), (shape, dtype, raw) in res.digests[0].items():
        got = np.frombuffer(raw, dtype=dtype).reshape(shape)
        np.testing.assert_allclose(
            got, ref[i * th:(i + 1) * th, j * th:(j + 1) * th], rtol=1e-12)


def test_explorer_detects_schedule_dependent_results(cpu_device):
    """A pool whose visible result depends on execution order must make
    the explorer fail loudly with the diverging seed."""
    from parsec_tpu_torch.core.lifecycle import AccessMode
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl.ptg import PTG

    def build(rank, ctx):
        order = []
        lock = threading.Lock()
        dc = LocalCollection("D", shape=(1,), init=lambda k: np.zeros(1))
        ptg = PTG("orderdep")
        a = ptg.task_class("a", k="0 .. 7")
        a.affinity("D(k)")
        a.flow("X", AccessMode.INOUT, "<- D(k)", "-> D(k)")

        def body(X, k):
            with lock:
                order.append(k)

        a.body(cpu=body)
        return ptg.taskpool(D=dc), order

    with pytest.raises(ExplorationError, match="DIVERGE"):
        _within(lambda: explore(build, nranks=1, nb_cores=1, seeds=range(4),
                                timeout=60, snapshot=lambda users: tuple(users[0])))


def _build_dpotrf_2ranks(pkg):
    def build(rank, ctx):
        if pkg == "port":
            from parsec_tpu_torch.datadist import TwoDimBlockCyclic
            from parsec_tpu_torch.ops.cholesky import cholesky_ptg as chol

            make = lambda: chol(use_cuda=False)  # noqa: E731
        else:
            from parsec_tpu.datadist import TwoDimBlockCyclic
            from parsec_tpu.ops.cholesky import cholesky_ptg as chol

            make = lambda: chol(use_tpu=False)  # noqa: E731
        A = TwoDimBlockCyclic(N, N, NB, NB, p=2, q=1, myrank=rank, name="A")
        A.from_array(SPD)
        return make().taskpool(NT=A.mt, A=A), A
    return build


def test_multi_rank_explorer_waits_for_the_comm_layer(cpu_device):
    """The comm layer is ported (ROADMAP A.8a): the explorer runs two
    ranks over an :class:`ExplorerFabric` (frames reordered and deferred
    per seed), every seed quiesces with bit-identical tiles and a clean
    hb-check, and the tiles equal the JAX package's explorer's."""
    fab = ExplorerFabric(2, seed=5)
    assert fab.nranks == 2 and fab.explorer_seed == 5
    assert all(hasattr(ib, "peek_pending") for ib in fab.inboxes)
    res = _within(lambda: explore(_build_dpotrf_2ranks("port"), nranks=2,
                                  seeds=range(3), timeout=90))
    assert res.identical and res.race_findings() == [] and not res.errors
    ref = _within(lambda: ref_schedules.explore(
        _build_dpotrf_2ranks("ref"), nranks=2, seeds=range(1), timeout=90))
    assert res.digests[0] == ref.digests[0]


def test_explore_defaults_to_two_ranks_as_the_reference(cpu_device):
    """ROADMAP C.10: ``explore(build)`` with no ``nranks`` runs two ranks
    over an :class:`ExplorerFabric` on both packages (the port defaulted
    to one), and the two-rank dpotrf lands the reference's digests."""
    import inspect

    for fn in (explore, ref_schedules.explore):
        assert inspect.signature(fn).parameters["nranks"].default == 2
    res = _within(lambda: explore(_build_dpotrf_2ranks("port"), seeds=[0], timeout=90),
                  limit=120)
    ref = _within(lambda: ref_schedules.explore(_build_dpotrf_2ranks("ref"), seeds=[0],
                                                timeout=90), limit=120)
    assert res.nranks == ref.nranks == 2
    assert len(res.digests[0]) == 2 and not res.errors
    assert res.digests[0] == ref.digests[0]


def test_tile_digest_of_tensor_payloads():
    """A tensor payload digests as its bytes with the numpy dtype name, so
    a device copy and a host copy of equal values digest equal; bfloat16
    (no numpy dtype) by its raw bits."""
    from parsec_tpu_torch.analysis.schedules import _payload_digest
    from parsec_tpu_torch.data import LocalCollection

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert _payload_digest(torch.from_numpy(x)) == _payload_digest(x)
    b = torch.from_numpy(x).to(torch.bfloat16)
    shape, dtype, raw = _payload_digest(b)
    assert (shape, dtype) == ((3, 4), "bfloat16") and len(raw) == 24
    assert raw == b.view(torch.int16).numpy().tobytes()
    dc = LocalCollection("D", shape=(2,), init=lambda k: np.full(2, float(k)))
    dc.data_of(0)
    assert tile_digest(dc) == {"repr": repr(dc)}  # no local_tiles: opaque


@pytest.mark.slow
def test_explorer_200_seeds_dpotrf_and_stencil(cpu_device):
    """The acceptance-scale sweep at one rank: 200 seeds each, zero
    findings, bit-identical results across every seed."""
    res = explore(_build_dpotrf, nranks=1, seeds=range(200), timeout=90)
    assert res.identical and res.race_findings() == []
    res = explore(_build_stencil, nranks=1, seeds=range(200), timeout=90,
                  snapshot=_stencil_snapshot)
    assert res.identical and res.race_findings() == []
