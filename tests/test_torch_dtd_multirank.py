"""The port's multi-rank DTD (parsec_tpu_torch.dsl.dtd's shadow-task
protocol) against the JAX package's.

Every rank runs the same insert stream; a task whose affinity tile is
remote becomes a shadow task that only advances the tile's epoch, and the
send and receive tasks are inferred on both sides and carried on
``TAG_DTD``; ``flush_all`` pushes final versions home.  The four cases of
``tests/dsl/test_dtd_multirank.py`` — the cross-rank chain, one writer
with a reader on every rank, a flush home from a remote writer, and a
distributed GEMM — run on both packages over the same seeded inputs; the
host bodies do the same numpy arithmetic, so the results are equal bit
for bit.  The port's own case: the 4-rank DTD dpotrf with the B1 kernel
chores (the CUDA module bound to the torch CPU device) is
``torch.equal`` to the 4-rank PTG dpotrf, shadow tasks and all.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import comm as ref_comm  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLC  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.dsl import dtd as ref_dtd  # noqa: E402
from parsec_tpu_torch import comm as port_comm  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TwoDimBlockCyclic  # noqa: E402
from parsec_tpu_torch.dsl import dtd as port_dtd  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg, insert_dpotrf  # noqa: E402

from test_torch_multirank import host, run_ranks  # noqa: E402

REF = dict(Context=parsec_tpu.Context, comm=ref_comm, LC=RefLC, BC=RefBC,
           dtd=ref_dtd, ctx_kw={})
PORT = dict(Context=parsec_tpu_torch.Context, comm=port_comm,
            LC=LocalCollection, BC=TwoDimBlockCyclic, dtd=port_dtd,
            ctx_kw={"devices": ["cpu"]})


def run_dtd_ranks(P, nranks, body, *, nb_cores=2, timeout=60, ctx_kw=None):
    """Each rank: a Context over the in-process fabric; ``body(rank,
    ctx)`` drives a DTD taskpool to completion (the reference's
    ``run_ranks`` of test_dtd_multirank.py)."""
    fabric = P["comm"].InprocFabric(nranks)
    ces = fabric.endpoints()
    kw = dict(P["ctx_kw"] if ctx_kw is None else ctx_kw)
    ctxs = [P["Context"](nb_cores=nb_cores, rank=r, nranks=nranks,
                         comm=ces[r], **kw) for r in range(nranks)]
    errors = []

    def worker(r):
        try:
            body(r, ctxs[r])
        except Exception as e:  # pragma: no cover - reported below
            import traceback

            traceback.print_exc()
            errors.append((r, e))

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    alive = [t for t in threads if t.is_alive()]
    for c in ctxs:
        c.fini()
    assert not errors, errors
    assert not alive, "rank workers stalled"
    return ctxs


def _chain(P):
    nranks, n = 4, 12
    executed = {r: [] for r in range(nranks)}
    finals = {}
    d = P["dtd"]

    def body(rank, ctx):
        dc = P["LC"]("T", shape=(4,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(4))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        dtd = d.DTDTaskpool(ctx, name="chain")
        for k in range(n):
            def step(prev, cur, k=k):
                executed[rank].append(k)
                cur[:] = prev + 1.0

            if k == 0:
                def start(cur):
                    executed[rank].append(0)
                    cur[:] = 1.0
                dtd.insert_task(start, (dc.data_of(0), d.INOUT | d.AFFINITY))
            else:
                dtd.insert_task(step, (dc.data_of(k - 1), d.IN),
                                (dc.data_of(k), d.INOUT | d.AFFINITY))
        dtd.flush_all()
        dtd.close()
        finals[rank] = {k: host(dc.data_of(k).newest_copy().payload)
                        for k in range(n) if k % nranks == rank}

    ctxs = run_dtd_ranks(P, nranks, body)
    return executed, finals, [int(c.comm.remote_dep.stats["dtd_sent"])
                              for c in ctxs]


def test_cross_rank_chain():
    """Round-robin chain: step k runs on rank k%4, reads tile k-1 (remote)
    and writes tile k — every RAW dependency crosses the wire."""
    ref, port = _chain(REF), _chain(PORT)
    for r in range(4):
        assert port[0][r] == list(range(r, 12, 4))
        for k, got in port[1][r].items():
            np.testing.assert_array_equal(got, np.full(4, k + 1.0))
            np.testing.assert_array_equal(got, ref[1][r][k])
    assert port[0] == ref[0] and port[2] == ref[2]


def _bcast(P):
    nranks = 4
    got = {}
    d = P["dtd"]

    def body(rank, ctx):
        dc = P["LC"]("B", shape=(8,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(8))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        dtd = d.DTDTaskpool(ctx, name="bcast")

        def produce(x):
            x[:] = 42.0

        dtd.insert_task(produce, (dc.data_of(0), d.INOUT | d.AFFINITY))
        for r in range(nranks):
            def consume(x, probe, r=r):
                got[r] = float(x[0])
                probe[:] = x

            dtd.insert_task(consume, (dc.data_of(0), d.IN),
                            (dc.data_of(r), d.INOUT | d.AFFINITY))
        dtd.flush_all()
        dtd.close()

    ctxs = run_dtd_ranks(P, nranks, body)
    return got, sum(c.comm.remote_dep.stats.get("dtd_sent", 0) for c in ctxs)


def test_broadcast_one_writer_many_remote_readers():
    """One producer on rank 0, a reader on every rank: the version ships
    once per consuming rank."""
    ref, port = _bcast(REF), _bcast(PORT)
    assert port == ({r: 42.0 for r in range(4)}, 3)
    assert port == ref


def _flush_home(P):
    nranks = 2
    homes = {}
    d = P["dtd"]

    def body(rank, ctx):
        dc = P["LC"]("H", shape=(4,), nodes=nranks, myrank=rank,
                     init=lambda k: np.zeros(4))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        dtd = d.DTDTaskpool(ctx, name="flush")

        def write_remote(home, anchor):
            home[:] = 7.0

        # runs on rank 1 (affinity); tile 0 is owned by rank 0
        dtd.insert_task(write_remote, (dc.data_of(0), d.INOUT),
                        (dc.data_of(1), d.INOUT | d.AFFINITY))
        dtd.flush_all()
        dtd.close()
        if rank == 0:
            homes[rank] = host(dc.data_of(0).newest_copy().payload)

    run_dtd_ranks(P, nranks, body)
    return homes


def test_flush_returns_data_home():
    """Writer rank != owner rank: flush pushes the final version home."""
    ref, port = _flush_home(REF), _flush_home(PORT)
    np.testing.assert_array_equal(port[0], np.full(4, 7.0))
    np.testing.assert_array_equal(port[0], ref[0])


def _gemm(P):
    nranks, p, q = 4, 2, 2
    N, NB = 96, 32
    rng = np.random.default_rng(7)
    A0 = rng.standard_normal((N, N))
    B0 = rng.standard_normal((N, N))
    results = {}
    d = P["dtd"]

    def body(rank, ctx):
        def mk(nm):
            return P["BC"](N, N, NB, NB, p=p, q=q, nodes=nranks, myrank=rank,
                           name=nm)

        A, B, C = mk("gA"), mk("gB"), mk("gC")
        A.from_array(A0)
        B.from_array(B0)
        dtd = d.DTDTaskpool(ctx, name="gemm")

        def gemm(a, b, c):
            c += a @ b

        for i in range(A.nt):
            for j in range(A.nt):
                for k in range(A.nt):
                    dtd.insert_task(gemm, (A.data_of(i, k), d.IN),
                                    (B.data_of(k, j), d.IN),
                                    (C.data_of(i, j), d.INOUT | d.AFFINITY))
        dtd.flush_all()
        dtd.close()
        results[rank] = C.to_array()

    run_dtd_ranks(P, nranks, body, timeout=120)
    return A0 @ B0, sum(results[r] for r in range(nranks))


def test_distributed_dtd_gemm():
    """DTD tiled GEMM on a 2x2 block-cyclic grid across 4 ranks, against
    numpy at the reference's tolerance and the JAX package bit for bit."""
    C_ref, port = _gemm(PORT)
    np.testing.assert_allclose(port, C_ref, atol=1e-9)
    np.testing.assert_array_equal(port, _gemm(REF)[1])


@pytest.mark.parametrize("use_trtri", [False, True], ids=["kernels", "trtri"])
def test_dtd_dpotrf_4_ranks_equals_the_ptg(use_trtri):
    """The port's DTD dpotrf over 4 ranks (2x2 grid, B1 kernel chores on
    the CUDA module bound to the torch CPU device; tasks placed by the
    tile they write) is ``torch.equal`` to the 4-rank PTG dpotrf and
    within 1e-4 of numpy's factor."""
    nranks, N, nb = 4, 96, 16
    rng = np.random.default_rng(3)
    M = rng.standard_normal((N, N))
    SPD = (M @ M.T + N * np.eye(N)).astype(np.float32)
    cpu = {"cuda_device": "cpu"}

    def matrix(rank):
        A = TwoDimBlockCyclic(N, N, nb, nb, p=2, q=2, myrank=rank, name="A",
                              dtype=np.float32)
        return A.from_array(SPD)

    ptg_mats, dtd_mats = {}, {}

    def build(rank, ctx):
        A = ptg_mats[rank] = matrix(rank)
        return cholesky_ptg(use_cpu=False, use_kernels=True,
                            use_trtri=use_trtri).taskpool(NT=A.mt, A=A)

    run_ranks(PORT, nranks, build, ctx_kw=cpu, timeout=120)

    def body(rank, ctx):
        A = dtd_mats[rank] = matrix(rank)
        dtd = port_dtd.DTDTaskpool(ctx, name="dtd_dpotrf")
        insert_dpotrf(dtd, A, use_cpu=False, use_kernels=True,
                      use_trtri=use_trtri)
        dtd.flush_all()
        dtd.close()

    ctxs = run_dtd_ranks(PORT, nranks, body, ctx_kw=cpu, timeout=120)
    assert all(c.comm.remote_dep.stats["dtd_sent"] > 0 for c in ctxs)
    for r in range(nranks):
        for (i, j) in ptg_mats[r].local_tiles():
            if j > i:
                continue
            want = torch.as_tensor(host(ptg_mats[r].data_of(i, j)
                                        .newest_copy().payload))
            got = torch.as_tensor(host(dtd_mats[r].data_of(i, j)
                                       .newest_copy().payload))
            assert torch.equal(got, want), (r, i, j)
    out = np.zeros((N, N), np.float32)
    for A in dtd_mats.values():
        for (i, j) in A.local_tiles():
            out[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = host(
                A.data_of(i, j).newest_copy().payload)
    np.testing.assert_allclose(np.tril(out),
                               np.linalg.cholesky(SPD.astype(np.float64)),
                               atol=1e-4, rtol=1e-4)
