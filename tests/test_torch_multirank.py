"""The port's multi-rank runtime against the JAX package's: N ranks, each a
full ``Context``, over the in-process fabric (parsec_tpu_torch.comm).

* ``tests/runtime/test_multirank.py``'s six cases — the cross-rank chain,
  the broadcast fan-out, the rendezvous (GET) path, the 2x2 distributed
  Cholesky and QR, CTL and dataless write-backs — each run on both
  packages over the same seeded inputs.  Host bodies do the same numpy
  arithmetic in the same order on both sides, so the distributed factors
  match the JAX package's tile for tile, bit for bit.
* ``tests/runtime/test_multirank_device.py``'s cases with the CUDA module
  bound to the torch CPU device (``Context(cuda_device="cpu")``): device
  chores only, mixed chores, a device tile crossing ranks, and eviction
  pressure.  The rank -> chip binding case becomes a test of
  ``resolve_torch_device`` under a stubbed device count (every rank of a
  one-card host binds ``cuda:0``).
* The wire never aliases two ranks: a receiver's in-place write to a
  delivered tile leaves the sender's tile unchanged.
* A body raising on one rank fails the pool on every rank
  (``fail_pool_for_context``'s abort broadcast); each context stays
  usable.

:func:`run_ranks` is shared by the other multi-rank parity files.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import comm as ref_comm  # noqa: E402
from parsec_tpu import multirank as ref_multirank  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.dsl import ptg as ref_ptg  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops.qr import qr_ptg as ref_qr_ptg  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch import comm as port_comm  # noqa: E402
from parsec_tpu_torch import multirank as port_multirank  # noqa: E402
from parsec_tpu_torch.core.lifecycle import DEV_CUDA  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TwoDimBlockCyclic  # noqa: E402
from parsec_tpu_torch.device import cuda as port_cuda  # noqa: E402
from parsec_tpu_torch.dsl import ptg as port_ptg  # noqa: E402
from parsec_tpu_torch.dsl.ptg import stage_to_cpu  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402
from parsec_tpu_torch.ops.qr import qr_ptg  # noqa: E402
from parsec_tpu_torch.utils import mca_param as port_mca  # noqa: E402

REF = dict(name="ref", Context=parsec_tpu.Context, comm=ref_comm,
           LC=RefLocalCollection, BC=RefBC, ptg=ref_ptg, mca=ref_mca,
           chol=lambda: ref_cholesky_ptg(use_tpu=False),
           qr=lambda: ref_qr_ptg(use_tpu=False), ctx_kw={})
PORT = dict(name="port", Context=parsec_tpu_torch.Context, comm=port_comm,
            LC=LocalCollection, BC=TwoDimBlockCyclic, ptg=port_ptg,
            mca=port_mca, chol=lambda: cholesky_ptg(use_cuda=False),
            qr=lambda: qr_ptg(use_cuda=False), ctx_kw={"devices": ["cpu"]})
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def run_ranks(P, nranks, build, *, nb_cores=2, timeout=60, ctx_kw=None):
    """Spin up ``nranks`` contexts of package ``P`` over one in-process
    fabric; per rank ``build(rank, ctx) -> taskpool``; run all of them to
    completion in parallel threads through the package's shared harness,
    ``run_multirank_perf`` (the reference's ``run_ranks`` shape).  Raises
    on a rank error or a pool that did not quiesce.  Returns the
    contexts, finalized."""
    kw = dict(P["ctx_kw"] if ctx_kw is None else ctx_kw)
    mr = port_multirank if P["Context"] is parsec_tpu_torch.Context else ref_multirank
    ctxs, _stats = mr.run_multirank_perf(
        nranks, lambda r, ctx: (build(r, ctx), ctx), nb_cores=nb_cores,
        timeout=timeout, **kw)
    return ctxs


def host(payload) -> np.ndarray:
    """A host numpy view of a tile payload (ndarray or torch tensor)."""
    if isinstance(payload, torch.Tensor):
        t = payload.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(payload)


def assemble(mats, n, nb) -> np.ndarray:
    """Stitch every rank's home tiles into one dense matrix."""
    out = np.zeros((n, n))
    for A in mats.values():
        for (i, j) in A.local_tiles():
            h, w = A.tile_shape(i, j)
            out[i * nb:i * nb + h, j * nb:j * nb + w] = host(
                A.data_of(i, j).newest_copy().payload)
    return out


# ---------------------------------------------------------------------------
# tests/runtime/test_multirank.py
# ---------------------------------------------------------------------------

def _chain(P):
    nranks, n = 4, 16
    seen = {r: [] for r in range(nranks)}
    locks = {r: threading.Lock() for r in range(nranks)}
    dcs = {}

    def build(rank, ctx):
        dc = P["LC"]("D", shape=(4,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(4))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        dcs[rank] = dc
        g = P["ptg"].PTG("chain")
        step = g.task_class("step", k="0 .. N-1")
        step.affinity("D(k)")
        step.flow("X", P["ptg"].INOUT,
                  "<- (k == 0) ? D(0) : X step(k-1)",
                  "-> (k < N-1) ? X step(k+1) : D(k)")

        def body(X, k):
            with locks[rank]:
                seen[rank].append(k)
            X += 1.0

        step.body(cpu=body)
        return g.taskpool(N=n, D=dcs[rank])

    ctxs = run_ranks(P, nranks, build)
    final = host(dcs[(n - 1) % nranks].data_of(n - 1).newest_copy().payload)
    return seen, final, [int(c.comm.remote_dep.stats["activations_sent"])
                         for c in ctxs]


def test_cross_rank_chain():
    """A chain whose steps round-robin across 4 ranks: every dependency
    crosses the wire; each rank runs its share in order, the final value
    lands home, and both packages send the same activations."""
    ref, port = _chain(REF), _chain(PORT)
    for r in range(4):
        assert port[0][r] == list(range(r, 16, 4))
    np.testing.assert_array_equal(port[1], np.full(4, 16.0))
    np.testing.assert_array_equal(port[1], ref[1])
    assert port[2] == ref[2] == [4, 4, 4, 3]


def _bcast(P):
    nranks = 4
    got = {r: [] for r in range(nranks)}
    locks = {r: threading.Lock() for r in range(nranks)}

    def build(rank, ctx):
        dc = P["LC"]("D", shape=(8,), nodes=nranks, myrank=rank,
                     init=lambda k: np.full(8, 7.0))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        g = P["ptg"].PTG("bcast")
        src = g.task_class("src")
        src.affinity("D(0)")
        src.flow("X", P["ptg"].INOUT, "<- D(0)", "-> X sink(0 .. NR-1)")
        src.body(cpu=lambda X: X.__iadd__(35.0))  # 7 + 35 = 42
        sink = g.task_class("sink", r="0 .. NR-1")
        sink.affinity("D(r)")
        sink.flow("X", P["ptg"].IN, "<- X src()")

        def sink_body(X, r):
            with locks[rank]:
                got[rank].append(float(X[0]))

        sink.body(cpu=sink_body)
        return g.taskpool(NR=nranks, D=dc)

    ctxs = run_ranks(P, nranks, build)
    return got, [dict(c.comm.remote_dep.stats) for c in ctxs]


def test_broadcast_fanout_across_ranks():
    """One producer, consumers on every rank: the payload arrives with the
    producer's value, down the same binomial tree on both packages."""
    ref, port = _bcast(REF), _bcast(PORT)
    for r in range(4):
        assert port[0][r] == [42.0], port[0]
    assert port == ref


def _big(P):
    P["mca"].set_param("runtime", "comm_short_limit", 64)  # force the pull
    try:
        nranks = 2
        got = []

        def build(rank, ctx):
            dc = P["LC"]("D", shape=(1024,), nodes=nranks, myrank=rank,
                         init=lambda k: np.arange(1024.0))
            dc.rank_of = lambda *key: dc.data_key(*key) % nranks
            g = P["ptg"].PTG("big")
            src = g.task_class("src")
            src.affinity("D(0)")
            src.flow("X", P["ptg"].INOUT, "<- D(0)", "-> X sink()")
            src.body(cpu=lambda X: X.__imul__(2.0))
            sink = g.task_class("sink")
            sink.affinity("D(1)")
            sink.flow("X", P["ptg"].IN, "<- X src()")
            sink.body(cpu=lambda X: got.append(np.array(X)))
            return g.taskpool(D=dc)

        ctxs = run_ranks(P, nranks, build)
        return got, dict(ctxs[1].comm.remote_dep.stats)
    finally:
        P["mca"].params.unset("runtime", "comm_short_limit")


def test_large_payload_get_path():
    """A payload above the limit travels the chunked rendezvous pull."""
    ref, port = _big(REF), _big(PORT)
    np.testing.assert_allclose(port[0][0], np.arange(1024.0) * 2.0)
    assert port[1]["get_issued"] >= 1 and port[1]["rdv_pulls_done"] == 1
    np.testing.assert_array_equal(port[0][0], ref[0][0])
    assert port[1] == ref[1]


def _chol_2x2(P, build_ptg, ctx_kw=None, timeout=120):
    nranks, p, q = 4, 2, 2
    N, nb = 64, 16
    rng = np.random.default_rng(11)
    M = rng.standard_normal((N, N))
    SPD = M @ M.T + N * np.eye(N)
    mats = {}

    def build(rank, ctx):
        A = P["BC"](N, N, nb, nb, p=p, q=q, myrank=rank, name="A")
        A.from_array(SPD)  # each rank holds only its local tiles
        mats[rank] = A
        return build_ptg().taskpool(NT=A.mt, A=A)

    ctxs = run_ranks(P, nranks, build, timeout=timeout, ctx_kw=ctx_kw)
    return SPD, assemble(mats, N, nb), ctxs


def test_distributed_cholesky_2x2():
    """Tiled dpotrf over a 2x2 block-cyclic grid, host bodies: the
    reference's tolerance against numpy, and the JAX package's factor
    tile for tile."""
    SPD, out, _ = _chol_2x2(PORT, PORT["chol"])
    np.testing.assert_allclose(np.tril(out), np.linalg.cholesky(SPD),
                               rtol=1e-8, atol=1e-8)
    _, ref_out, _ = _chol_2x2(REF, REF["chol"])
    np.testing.assert_array_equal(out, ref_out)


def _qr_2x2(P):
    nranks, p, q = 4, 2, 2
    N, nb = 64, 16
    rng = np.random.default_rng(12)
    A0 = rng.standard_normal((N, N))
    mats = {}

    def build(rank, ctx):
        A = P["BC"](N, N, nb, nb, p=p, q=q, myrank=rank, name="A")
        A.from_array(A0)
        mats[rank] = A
        return P["qr"]().taskpool(
            NT=A.mt, A=A, TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float64,
            QSHAPE2=(np.float64, (2 * nb, 2 * nb)))

    run_ranks(P, nranks, build, timeout=180)
    return A0, assemble(mats, N, nb)


def test_distributed_qr_2x2():
    """Tiled Householder QR over a 2x2 grid: NEW-flow (dense Q block)
    transfers across ranks; R matches the reference's tolerance and the
    JAX package's R tile for tile."""
    A0, R = _qr_2x2(PORT)
    np.testing.assert_allclose(np.tril(R, -1), 0, atol=1e-10)
    ATA = A0.T @ A0
    np.testing.assert_allclose(R.T @ R, ATA, rtol=1e-8,
                               atol=1e-8 * np.abs(ATA).max())
    np.testing.assert_array_equal(R, _qr_2x2(REF)[1])


@BOTH
def test_ctl_and_dataless_writeback_do_not_hang(P):
    """A CTL flow and a dataless flow with a ``-> D(k)`` output dep to a
    REMOTE tile: the owner pre-counts write-backs, the sender skips the
    CTL one and sends a payload-less retire for the dataless one."""
    nranks = 2
    ran = []

    def build(rank, ctx):
        dc = P["LC"]("D", shape=(4,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(4))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        g = P["ptg"].PTG("ctlwb")
        a = g.task_class("a")
        a.affinity("D(1)")                    # runs on rank 1
        a.flow("X", P["ptg"].INOUT, "<- D(1)", "-> D(1)")
        a.flow("C", P["ptg"].CTL, "-> D(0)")           # CTL to rank 0
        a.flow("Y", P["ptg"].IN, "<- NONE", "-> D(0)")  # dataless, same
        a.body(cpu=lambda X, Y: ran.append(rank))
        return g.taskpool(D=dc)

    ctxs = run_ranks(P, nranks, build, timeout=20)
    assert ran == [1]
    assert ctxs[1].comm.remote_dep.stats["writebacks_sent"] == 1
    assert ctxs[0].comm.remote_dep.stats["writebacks_recv"] == 1


# ---------------------------------------------------------------------------
# tests/runtime/test_multirank_device.py (torch CPU device)
# ---------------------------------------------------------------------------

CPU_DEV = {"cuda_device": "cpu"}


def _cuda_of(ctx):
    return next(d for d in ctx.devices if d.device_type == DEV_CUDA)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_rank_to_device_binding(monkeypatch, count):
    """Each rank's CUDA module binds ``cuda:<rank % device_count>``: on a
    one-card host every rank binds ``cuda:0``, on a four-card host each
    its own card (the reference binds distinct chips)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)

    class _Ctx:
        cuda_device = ""

    bound = []
    for rank in range(4):
        c = _Ctx()
        c.rank = rank
        bound.append(port_cuda.resolve_torch_device(c))
    assert bound == [torch.device("cuda", r % count) for r in range(4)]
    c = _Ctx()
    c.rank, c.cuda_device = 3, "cpu"
    assert port_cuda.resolve_torch_device(c) == torch.device("cpu")


def test_distributed_cholesky_device_chores():
    """Distributed dpotrf, 2x2 grid, device chores only: every task runs
    through each rank's CUDA module; cross-rank tiles are device-produced
    tensors; the factor equals the host-body one within the reference's
    tolerance."""
    SPD, out, ctxs = _chol_2x2(
        PORT, lambda: cholesky_ptg(use_cpu=False), ctx_kw=CPU_DEV,
        timeout=180)
    for c in ctxs:
        dev = _cuda_of(c)
        assert dev.stats["executed_tasks"] > 0, f"rank {c.rank}"
        assert dev.stats["bytes_in"] + dev.stats["bytes_d2d"] > 0
        assert c.comm.remote_dep.stats["activations_sent"] > 0
    np.testing.assert_allclose(np.tril(out), np.linalg.cholesky(SPD),
                               rtol=1e-6, atol=1e-6)


def test_distributed_mixed_cpu_device_chores():
    """Both incarnations: the selector may split work per rank; the
    answer does not depend on the split."""
    nranks, p, q = 2, 1, 2
    N, nb = 48, 16
    rng = np.random.default_rng(32)
    M = rng.standard_normal((N, N))
    SPD = M @ M.T + N * np.eye(N)
    mats = {}

    def build(rank, ctx):
        A = TwoDimBlockCyclic(N, N, nb, nb, p=p, q=q, myrank=rank, name="A")
        A.from_array(SPD)
        mats[rank] = A
        return cholesky_ptg(use_cuda=True, use_cpu=True).taskpool(NT=A.mt, A=A)

    run_ranks(PORT, nranks, build, timeout=120, ctx_kw=CPU_DEV)
    np.testing.assert_allclose(np.tril(assemble(mats, N, nb)),
                               np.linalg.cholesky(SPD), rtol=1e-6, atol=1e-6)


def test_device_payload_crosses_as_a_tensor():
    """A device-produced tile crosses ranks as a tensor (the fabric's
    copy, never a host array built on the way) and lands in the
    consumer's host slot as one; the consumer's module stages it and the
    value is right: 2 * 3 + 2 = 8."""
    nranks = 2
    colls = {}
    arrivals = []

    def build(rank, ctx):
        dc = LocalCollection("D", shape=(32, 32), nodes=nranks, myrank=rank,
                             init=lambda k: np.full((32, 32), 2.0, np.float32))
        dc.rank_of = lambda *key: key[0] % nranks
        colls[rank] = dc
        g = port_ptg.PTG("d2d")
        src = g.task_class("src")
        src.affinity("D(0)")
        src.flow("X", port_ptg.INOUT, "<- D(0)", "-> X sink(0)")
        src.body(cuda=lambda X: X * 3.0)
        sink = g.task_class("sink", i="0 .. 0")
        sink.affinity("D(1)")
        sink.flow("X", port_ptg.IN, "<- X src()")
        sink.flow("Y", port_ptg.INOUT, "<- D(1)", "-> D(1)")
        sink.body(cuda=lambda X, Y, i: X + Y)
        tp = g.taskpool(D=dc)
        if rank == 1:
            dep = tp._deposit_payload

            def spy(key, payload):
                arrivals.append(payload)
                return dep(key, payload)

            tp._deposit_payload = spy
        return tp

    ctxs = run_ranks(PORT, nranks, build, timeout=60, ctx_kw=CPU_DEV)
    assert len(arrivals) == 1 and isinstance(arrivals[0], torch.Tensor)
    dev1 = _cuda_of(ctxs[1])
    assert dev1.stats["executed_tasks"] == 1
    # its own D(1) and the arrival (on the CPU device a tensor counts as
    # host bytes; on the card it is bytes_d2d)
    assert dev1.stats["bytes_in"] + dev1.stats["bytes_d2d"] == 2 * 32 * 32 * 4
    np.testing.assert_allclose(stage_to_cpu(colls[1].data_of(1)), 8.0)
    np.testing.assert_allclose(stage_to_cpu(colls[0].data_of(0)), 6.0)


def test_distributed_device_chores_under_eviction_pressure():
    """The composed distributed + device path under memory pressure:
    budgets shrunk until tiles are evicted mid-factorization; the numerics
    survive eviction and re-staging across the wire."""
    nranks, p, q = 2, 2, 1
    N, nb = 128, 16
    rng = np.random.default_rng(44)
    M = rng.standard_normal((N, N))
    SPD = M @ M.T + N * np.eye(N)
    mats = {}

    def build(rank, ctx):
        _cuda_of(ctx).mem_budget = 16 << 10  # ~8 tiles of 16x16 f64
        A = TwoDimBlockCyclic(N, N, nb, nb, p=p, q=q, myrank=rank, name="A")
        A.from_array(SPD)
        mats[rank] = A
        return cholesky_ptg(use_cpu=False).taskpool(NT=A.mt, A=A)

    ctxs = run_ranks(PORT, nranks, build, timeout=240, ctx_kw=CPU_DEV)
    assert sum(_cuda_of(c).stats["evictions"] for c in ctxs) > 0
    np.testing.assert_allclose(np.tril(assemble(mats, N, nb)),
                               np.linalg.cholesky(SPD), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the wire never aliases two ranks; a failure fails every rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx_kw", [{"devices": ["cpu"]}, CPU_DEV],
                         ids=["numpy", "torch_cpu"])
def test_receiver_write_never_reaches_the_sender(ctx_kw):
    """rank 0 produces X and ships it to rank 1, whose host body writes
    the delivered tile in place: rank 0's tile keeps its value.  Over a
    host-only context the payload is a numpy array, over the torch CPU
    device a torch CPU tensor."""
    nranks = 2
    colls = {}

    def build(rank, ctx):
        dc = LocalCollection("D", shape=(16,), nodes=nranks, myrank=rank,
                             init=lambda k: np.full(16, 1.0, np.float32))
        dc.rank_of = lambda *key: key[0] % nranks
        colls[rank] = dc
        g = port_ptg.PTG("alias")
        src = g.task_class("src")
        src.affinity("D(0)")
        src.flow("X", port_ptg.INOUT, "<- D(0)", "-> X sink(0)", "-> D(0)")
        src.body(cpu=lambda X: X.__imul__(3.0),
                 cuda=lambda X: X * 3.0)
        sink = g.task_class("sink", i="0 .. 0")
        sink.affinity("D(1)")
        sink.flow("X", port_ptg.IN, "<- X src()")
        def write_in_place(X, i):
            X += 100.0  # the delivered tile, written in place

        sink.body(cpu=write_in_place)
        return g.taskpool(D=dc)

    run_ranks(PORT, nranks, build, ctx_kw=ctx_kw)
    np.testing.assert_array_equal(stage_to_cpu(colls[0].data_of(0)),
                                  np.full(16, 3.0, np.float32))


@BOTH
def test_body_failure_on_one_rank_fails_every_rank(P):
    """A body raising on rank 1 of a 2-rank chain fails the pool there and
    broadcasts the abort: every rank's wait returns False promptly, and
    each context then runs a fresh pool."""
    nranks = 2
    fabric = P["comm"].InprocFabric(nranks)
    ces = fabric.endpoints()
    ctxs = [P["Context"](nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                         **P["ctx_kw"]) for r in range(nranks)]

    def chain(rank, name, fail):
        dc = P["LC"]("D", shape=(2,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(2))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        g = P["ptg"].PTG(name)
        step = g.task_class("step", k="0 .. N-1")
        step.affinity("D(k)")
        step.flow("X", P["ptg"].INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
                  "-> (k < N-1) ? X step(k+1) : D(k)")

        def body(X, k):
            if fail and k == 3:
                raise RuntimeError("injected")
            X += 1.0

        step.body(cpu=body)
        return g.taskpool(N=8, D=dc)

    try:
        oks = [None] * nranks

        def run(name, fail):
            def worker(r):
                tp = chain(r, name, fail)
                ctxs[r].add_taskpool(tp)
                oks[r] = tp.wait(timeout=30)
            ts = [threading.Thread(target=worker, args=(r,))
                  for r in range(nranks)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            return list(oks)

        assert run("boom", True) == [False, False]
        assert run("fine", False) == [True, True]
    finally:
        for c in ctxs:
            c.fini()


@BOTH
def test_live_hbcheck_pairs_every_frame(P):
    """The fabric fires ``HB_FRAME_SEND`` at send and ``HB_FRAME_DELIVER``
    at delivery, with one frame id: under the live happens-before
    recorder a 4-rank Cholesky is race-free, and every delivered frame id
    was sent (the cross-rank ordering edge of ``tests/analysis/
    test_hbcheck.py``'s frame cases, on real traffic)."""
    hbmod = (__import__("parsec_tpu.analysis.hb", fromlist=["HBRecorder"])
             if P is REF else
             __import__("parsec_tpu_torch.analysis.hb", fromlist=["HBRecorder"]))
    with hbmod.HBRecorder(stacks=False) as rec:
        SPD, out, _ = _chol_2x2(P, P["chol"])
    assert rec.analyze() == []
    sends = {e.obj for e in rec.events if e.kind == "frame_send"}
    delivers = {e.obj for e in rec.events if e.kind == "frame_deliver"}
    assert delivers and delivers <= sends
    np.testing.assert_allclose(np.tril(out), np.linalg.cholesky(SPD),
                               rtol=1e-8, atol=1e-8)


@BOTH
def test_serve_cancel_fails_the_pool_on_every_rank(P):
    """The serving plane's cancel across ranks: a job cancelled on rank 0
    fails its pool there and, through ``fail_pool_for_context``'s abort
    broadcast, on rank 1, whose handle returns False long before its
    pool could have finished."""
    import time

    serve = (__import__("parsec_tpu.serve", fromlist=["RuntimeService"])
             if P is REF else
             __import__("parsec_tpu_torch.serve", fromlist=["RuntimeService"]))
    nranks, n = 2, 60
    ces = P["comm"].InprocFabric(nranks).endpoints()
    svs = [serve.RuntimeService(nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                                **P["ctx_kw"]) for r in range(nranks)]
    handles, out = [None] * nranks, [None] * nranks

    def chain(rank):
        dc = P["LC"]("D", shape=(2,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(2))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        g = P["ptg"].PTG("served_chain")
        step = g.task_class("step", k="0 .. N-1")
        step.affinity("D(k)")
        step.flow("X", P["ptg"].INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
                  "-> (k < N-1) ? X step(k+1) : D(k)")

        def body(X, k):
            time.sleep(0.05)
            X += 1.0

        step.body(cpu=body)
        return g.taskpool(N=n, D=dc)

    def worker(r):
        svs[r].tenant("t", weight=1)
        handles[r] = svs[r].submit("t", chain(r))
        t0 = time.monotonic()
        ok = handles[r].wait(timeout=30)
        out[r] = (ok, time.monotonic() - t0)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(nranks)]
    try:
        for t in ts:
            t.start()
        deadline = time.monotonic() + 10
        while (handles[0] is None or handles[0].state != "running") \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)
        assert handles[0].cancel()
        for t in ts:
            t.join(60)
        assert [ok for ok, _t in out] == [False, False], out
        assert all(dt < 2.5 for _ok, dt in out), out  # the chain needs 3 s
        assert handles[1].taskpool.failed
        assert "cancelled" in (handles[1].taskpool.fail_reason or "")
    finally:
        for sv in svs:
            sv.close(timeout=30)
