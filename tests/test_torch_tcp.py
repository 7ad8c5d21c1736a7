"""The port's TCP backend (parsec_tpu_torch.comm.tcp) and launcher
(parsec_tpu_torch.comm.launch): real multi-PROCESS ranks over loopback
sockets, as ``tests/runtime/test_tcp.py`` runs the JAX package's.

Run as a script, this file is the port's per-rank driver: ``python
tests/test_torch_tcp.py <scenario>`` under ``parsec_tpu_torch.comm.launch``
(which hands each process its rank), with
``PARSEC_MCA_device_cuda_torch_device=cpu`` in the launch environment so
every rank's CUDA module binds the torch CPU device.  Each scenario
self-checks and the rank prints one JSON line of results.  The driver
imports the port only.

As a test module it covers:

* the scenarios of ``tests/runtime/test_tcp.py``: the CE smoke at 2 and
  4 ranks, a cross-rank PTG chain, the GET path of a big payload,
  distributed DTD GEMM and PTG QR at 4 ranks, the close handshakes
  (``barrier_close``, ``send_then_close``), concurrent pools on one
  context and a job's trace propagation; the distributed dpotrf (also
  run through the reference's own ``tests/runtime/tcp_driver.py``), the
  segmented Cholesky, the datatype ping-pong, the broadcast topologies
  and the collectives (both also through the reference's driver) are
  ``tests/test_torch_tcp_dist.py``'s;
* the four cases of ``tests/runtime/test_tcp_wire.py`` on both packages
  (two endpoints in one process), a bfloat16 tensor's out-of-band round
  trip and the refusal of a CUDA tensor (``is_device_array`` stubbed);
* the TCP cases of ``tests/runtime/test_comm_protocol.py``: the zero-GET
  eager round trip, and the same protocol pins over TCP as over the
  port's in-process fabric;
* the launcher's job-wide deadline and its "a failed rank dooms the job".

Every launch has a ``timeout``, so a hang fails instead of waiting.
"""

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
#: one BLAS/OpenMP thread a rank process: N ranks share the host's cores
THREADS_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
#: the per-rank environment of every port launch
PORT_ENV = {"PARSEC_MCA_device_cuda_torch_device": "cpu", **THREADS_ENV}


# ---------------------------------------------------------------------------
# the per-rank driver (run as a script under the launcher)
# ---------------------------------------------------------------------------

def scenario_smoke(ce):
    """AM echo, aggregation, one-sided get, barrier — pure CE layer."""
    from parsec_tpu_torch.comm.engine import TAG_USER_BASE

    got = []
    ce.register_am(TAG_USER_BASE, lambda src, p: got.append((src, p)))
    ce.barrier()
    # every rank sends 3 AMs to every other rank (per-peer batching)
    for dst in range(ce.nranks):
        if dst != ce.rank:
            for i in range(3):
                ce.send_am(TAG_USER_BASE, dst, {"from": ce.rank, "i": i})
    deadline = time.time() + 30
    while len(got) < 3 * (ce.nranks - 1):
        time.sleep(0.005)
        assert time.time() < deadline, f"only {len(got)} AMs arrived"
    assert sorted(p["i"] for _, p in got) == sorted(list(range(3)) * (ce.nranks - 1))

    # one-sided get of a large registered buffer
    payload = np.arange(65536, dtype=np.float64) + ce.rank
    ce.mem_register(("blk", ce.rank), payload)
    ce.barrier()
    pulled = []
    src = (ce.rank + 1) % ce.nranks
    ce.get(src, ("blk", src), lambda buf: pulled.append(buf))
    deadline = time.time() + 30
    while not pulled:
        time.sleep(0.005)
        assert time.time() < deadline, "get never completed"
    np.testing.assert_array_equal(pulled[0], np.arange(65536, dtype=np.float64) + src)
    ce.barrier()
    return {"ams": len(got), "get_bytes": int(ce.stats["get_bytes"])}


def _ctx(ce, **kw):
    from parsec_tpu_torch import Context

    return Context(nb_cores=2, rank=ce.rank, nranks=ce.nranks, comm=ce, **kw)


def _chain_ptg(name, coll="D"):
    from parsec_tpu_torch.dsl.ptg import INOUT, PTG

    ptg = PTG(name)
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity(f"{coll}(k)")
    step.flow("X", INOUT,
              f"<- (k == 0) ? {coll}(0) : X step(k-1)",
              f"-> (k < N-1) ? X step(k+1) : {coll}(k)")
    return ptg, step


def scenario_ptg_chain(ce):
    """Cross-rank PTG chain: every dependency crosses the real wire."""
    from parsec_tpu_torch.data import LocalCollection

    n = 12
    seen = []
    ctx = _ctx(ce)
    dc = LocalCollection("D", shape=(n,), nodes=ce.nranks, myrank=ce.rank,
                         init=lambda k: np.zeros(4))
    dc.rank_of = lambda *key: dc.data_key(*key) % ce.nranks
    ptg, step = _chain_ptg("chain")

    def body(X, k):
        seen.append(k)
        X += 1.0

    step.body(cpu=body)
    tp = ptg.taskpool(N=n, D=dc)
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=90), "taskpool did not quiesce"
    assert seen == list(range(ce.rank, n, ce.nranks)), seen
    if dc.rank_of(n - 1) == ce.rank:
        final = dc.data_of(n - 1).newest_copy().payload
        np.testing.assert_array_equal(final, np.full(4, float(n)))
    ce.barrier()
    ctx.fini()
    return {"seen": seen}


def scenario_ptg_bigpayload(ce):
    """Broadcast with a payload above the short limit: GET path on wire."""
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl.ptg import IN, INOUT, PTG
    from parsec_tpu_torch.utils import mca_param

    mca_param.set_param("runtime", "comm_short_limit", 64)
    got = []
    ctx = _ctx(ce)
    dc = LocalCollection("D", shape=(8,), nodes=ce.nranks, myrank=ce.rank,
                         init=lambda k: np.arange(1024.0))
    dc.rank_of = lambda *key: dc.data_key(*key) % ce.nranks
    ptg = PTG("big")
    src = ptg.task_class("src")
    src.affinity("D(0)")
    src.flow("X", INOUT, "<- D(0)", "-> X sink(0 .. NR-1)")
    src.body(cpu=lambda X: X.__imul__(3.0))
    sink = ptg.task_class("sink", r="0 .. NR-1")
    sink.affinity("D(r)")
    sink.flow("X", IN, "<- X src()")
    sink.body(cpu=lambda X, r: got.append(X.copy()))
    tp = ptg.taskpool(NR=ce.nranks, D=dc)
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=90)
    assert len(got) == 1, f"expected 1 local sink, got {len(got)}"
    np.testing.assert_array_equal(got[0], np.arange(1024.0) * 3.0)
    stats = {"get_issued": int(ctx.comm.remote_dep.stats["get_issued"])}
    if ce.rank != 0:
        assert stats["get_issued"] >= 1, "big payload should use GET path"
    ce.barrier()
    ctx.fini()
    return stats


def scenario_dtd_gemm(ce):
    """Distributed DTD tiled GEMM: shadow-task protocol, epoch transfers
    and cross-rank flush on the wire.  Ragged N=80/NB=32 makes 8192-,
    4096- and 2048-byte tiles around the 4096-byte short limit, so both
    the inline and the GET paths carry traffic."""
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import AFFINITY, IN, INOUT, DTDTaskpool
    from parsec_tpu_torch.utils import mca_param

    mca_param.set_param("runtime", "comm_short_limit", 4096)
    N, NB = 80, 32
    p = 2 if ce.nranks % 2 == 0 else 1
    q = ce.nranks // p
    rng = np.random.default_rng(11)
    A0 = rng.standard_normal((N, N))
    B0 = rng.standard_normal((N, N))
    C_ref = A0 @ B0
    ctx = _ctx(ce)

    def mk(nm):
        return TwoDimBlockCyclic(N, N, NB, NB, p=p, q=q, nodes=ce.nranks,
                                 myrank=ce.rank, name=nm)

    A, B, C = mk("tA"), mk("tB"), mk("tC")
    A.from_array(A0)
    B.from_array(B0)
    dtd = DTDTaskpool(ctx, name="tcp_gemm")

    def gemm(a, b, c):
        c += a @ b

    nt = A.nt
    for i in range(nt):
        for j in range(nt):
            for k in range(nt):
                dtd.insert_task(gemm, (A.data_of(i, k), IN), (B.data_of(k, j), IN),
                                (C.data_of(i, j), INOUT | AFFINITY))
    dtd.flush_all()
    dtd.close()
    for (i, j) in C.local_tiles():
        h, w = C.tile_shape(i, j)
        got = np.asarray(C.data_of(i, j).newest_copy().payload)[:h, :w]
        np.testing.assert_allclose(got, C_ref[i * NB:i * NB + h, j * NB:j * NB + w],
                                   atol=1e-9)
    st = ce.remote_dep.stats
    out = {"dtd_sent": int(st["dtd_sent"]), "dtd_recv": int(st["dtd_recv"]),
           "dtd_inline": int(st["dtd_inline_sent"]),
           "dtd_get": int(st["dtd_get_advertised"])}
    ce.barrier()
    ctx.fini()
    return out


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def scenario_dist_dpotrf(ce):
    """Distributed dpotrf on host bodies; config via env PERF_N, PERF_NB,
    PERF_P (grid rows; cols = nranks // P).  Each rank checks its diagonal
    tiles against numpy at the reference test's tolerance and, with
    OUT_DIR set, writes its local tiles to ``OUT_DIR/rank<r>.npz``."""
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.ops import cholesky_ptg

    N = int(os.environ.get("PERF_N", "512"))
    nb = int(os.environ.get("PERF_NB", "32"))
    p = int(os.environ.get("PERF_P", "1"))
    q = max(1, ce.nranks // p)
    rng = np.random.default_rng(3)  # the reference driver's seed and draw
    M = rng.standard_normal((N, N))
    SPD = M @ M.T + N * np.eye(N)
    ctx = _ctx(ce)
    A = TwoDimBlockCyclic(N, N, nb, nb, p=p, q=q, myrank=ce.rank, name="A")
    A.from_array(SPD)
    tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
    ce.barrier()
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)
    ok = tp.wait(timeout=600)
    dt = time.perf_counter() - t0
    assert ok, "dpotrf did not quiesce"
    ce.barrier()
    L = np.linalg.cholesky(SPD)
    tiles = {}
    for (i, j) in A.local_tiles():
        c = np.asarray(A.data_of(i, j).newest_copy().payload)
        tiles[f"{i}_{j}"] = c
        if i == j:
            np.testing.assert_allclose(np.tril(c), L[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb],
                                       rtol=1e-6, atol=1e-8)
    if os.environ.get("OUT_DIR"):
        np.savez(os.path.join(os.environ["OUT_DIR"], f"rank{ce.rank}.npz"), **tiles)
    ctx.fini()
    nt = N // nb
    return {"elapsed": dt, "ntasks": nt * (nt + 1) * (nt + 2) // 6,
            "acts": int(ce.remote_dep.stats.get("activations_sent", 0))}


def scenario_dist_segchol(ce):
    """Distributed panel-segmented Cholesky: panel columns 1D
    block-cyclic, the factored column broadcast down the activation
    trees, per-owner trailing updates; every local column against
    numpy."""
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.ops.segmented_chol_dist import dist_segmented_cholesky_ptg

    n, nb = int(os.environ.get("SEG_N", "256")), int(os.environ.get("SEG_NB", "32"))
    rng = np.random.default_rng(7)
    m = rng.standard_normal((n, n)).astype(np.float32)
    SPD = m @ m.T + n * np.eye(n, dtype=np.float32)
    # host-only ranks: the panel's CPU body is the fallback of contexts
    # without a CUDA module (the reference driver's CPU-device ranks)
    ctx = _ctx(ce, devices=["cpu"])
    dc = LocalCollection(
        "C", shape=(n, nb), dtype=np.float32, nodes=ce.nranks, myrank=ce.rank,
        init=lambda j: np.ascontiguousarray(SPD[:, j * nb:(j + 1) * nb]))
    dc.rank_of = lambda j: j % ce.nranks
    NT = n // nb
    tp = dist_segmented_cholesky_ptg(n, nb, use_cuda=False).taskpool(
        NT=NT, C=dc, TILE_SHAPE=(n, nb), TILE_DTYPE=np.float32)
    ce.barrier()
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)
    ok = tp.wait(timeout=300)
    dt = time.perf_counter() - t0
    ce.barrier()
    assert ok, "dist segchol did not quiesce"
    ref = np.linalg.cholesky(SPD.astype(np.float64))
    err = 0.0
    for j in range(NT):
        if j % ce.nranks != ce.rank:
            continue
        col = np.asarray(dc.data_of(j).newest_copy().payload, dtype=np.float64)
        err = max(err, float(np.abs(col - np.tril(ref)[:, j * nb:(j + 1) * nb]).max()))
    ctx.fini()
    return {"elapsed": dt, "err": err / float(np.abs(ref).max()),
            "acts": int(ce.remote_dep.stats.get("activations_sent", 0))}


def scenario_dtt_pingpong(ce):
    """dtt_bug_replicator-class regression over the real activation path:
    one flow ping-pongs between two processes while each hop rebinds its
    payload to another layout (an F-order transposed array, a stride-2
    embedded view, contiguous), through the inline or the GET path (NB
    around the short limit).  Pins: activation counts, the receiver's
    payload byte sums (CommProfiler trace), datatype-packed sends, and
    the final values after 2*NT-1 increments."""
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl.ptg import INOUT, PTG
    from parsec_tpu_torch.profiling import CommProfiler, Trace
    from parsec_tpu_torch.utils import mca_param

    NB = int(os.environ.get("DTT_NB", "48"))
    NT = 6
    mca_param.set_param("runtime", "comm_short_limit", 4096)
    tile_bytes = NB * NB * 8
    prof = CommProfiler(Trace()).install()
    rng = np.random.default_rng(33)
    A0 = rng.standard_normal((NB, NB))
    B0 = rng.standard_normal((NB, NB))
    inits = {0: A0, 1: B0, 2: np.zeros((NB, NB))}
    ctx = _ctx(ce)
    try:
        dc = LocalCollection("D", shape=(NB, NB), nodes=ce.nranks, myrank=ce.rank,
                             init=lambda k: inits[k].copy())
        dc.rank_of = lambda *key: 0 if dc.data_key(*key) < 2 else 1
        ptg = PTG("dtt_pingpong")
        ping = ptg.task_class("ping", k="0 .. NT-1")
        ping.affinity("D(0)")
        ping.flow("A", INOUT, "<- (k == 0) ? D(0) : A pong(k-1)",
                  "-> (k < NT-1) ? A pong(k) : D(0)")
        ping.flow("B", INOUT, "<- (k == 0) ? D(1) : B pong(k-1)",
                  "-> (k < NT-1) ? B pong(k) : D(1)")

        def ping_body(A, B, k):
            bigr = np.zeros((2 * NB, NB))
            bigr[::2] = A + 1.0
            A_out = bigr[::2]  # a row-strided view: wire-packed
            assert not A_out.flags.c_contiguous
            return A_out, B + 1.0

        ping.body(cpu=ping_body)
        pong = ptg.task_class("pong", k="0 .. NT-2")
        pong.affinity("D(2)")
        pong.flow("A", INOUT, "<- A ping(k)", "-> A ping(k+1)")
        pong.flow("B", INOUT, "<- B ping(k)", "-> B ping(k+1)")

        def pong_body(A, B, k):
            big = np.zeros((NB, 2 * NB))
            big[:, ::2] = A + 1.0
            A_out = big[:, ::2]  # a column stride-2 view
            assert not A_out.flags.c_contiguous
            B_out = np.asfortranarray(B + 1.0)
            assert B_out.flags.f_contiguous and not B_out.flags.c_contiguous
            return A_out, B_out

        pong.body(cpu=pong_body)
        tp = ptg.taskpool(NT=NT, D=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=90), "dtt pingpong did not quiesce"
        ce.barrier()
        if ce.rank == 0:
            for key, base in ((0, A0), (1, B0)):
                out = np.asarray(dc.data_of(key).newest_copy().payload)
                np.testing.assert_allclose(out, base + (2 * NT - 1), rtol=0, atol=1e-12)
        df = prof.trace.to_dataframe()
        act = df[df["name"] == "MPI_ACTIVATE"]
        pld = df[df["name"] == "MPI_DATA_PLD"]
        n_in = NT - 1
        assert len(pld) == 2 * n_in, (len(pld), n_in)
        assert int(pld["bytes"].sum()) == 2 * n_in * tile_bytes
        assert len(act) == n_in, len(act)
        sent = int(ctx.comm.remote_dep.stats["activations_sent"])
        assert sent == n_in, sent
        packed = int(ce.stats.get("dt_packed", 0))
        assert packed >= n_in, packed
        return {"pld_bytes": int(pld["bytes"].sum()),
                "pld_kinds": sorted(set(pld["kind"])), "dt_packed": packed}
    finally:
        ctx.fini()
        prof.uninstall()


def scenario_ptg_qr(ce):
    """Distributed tiled QR: NEW-flow Q transfers and cross-rank final
    write-backs on the wire."""
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.ops.qr import qr_ptg

    N, nb, p, q = 64, 16, 2, ce.nranks // 2
    A0 = np.random.default_rng(21).standard_normal((N, N))
    ctx = _ctx(ce)
    try:
        A = TwoDimBlockCyclic(N, N, nb, nb, p=p, q=q, myrank=ce.rank, name="A")
        A.from_array(A0)
        tp = qr_ptg(use_cuda=False).taskpool(
            NT=A.mt, A=A, TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float64,
            QSHAPE2=(np.float64, (2 * nb, 2 * nb)))
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=120), "qr taskpool did not quiesce"
        ce.barrier()
        Rnp = np.linalg.qr(A0, mode="r")
        bad = 0
        for (i, j) in A.local_tiles():
            tile = np.asarray(A.data_of(i, j).newest_copy().payload)
            ref = Rnp[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            ok = (np.abs(tile).max() < 1e-9 if i > j
                  else np.allclose(np.abs(tile), np.abs(ref), rtol=1e-7, atol=1e-7))
            bad += 0 if ok else 1
        assert bad == 0, f"rank {ce.rank}: {bad} bad tiles"
        return {"tiles": len(list(A.local_tiles()))}
    finally:
        ctx.fini()


def scenario_multipool(ce):
    """A distributed dpotrf, a no-pivot LU and a cross-rank chain run at
    once on one context per rank over the wire; every local tile is
    bit-identical to a one-rank run in this process and each pool's
    termdet closes its books."""
    from parsec_tpu_torch import Context
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.datadist import TiledMatrix, TwoDimBlockCyclic
    from parsec_tpu_torch.ops.cholesky import cholesky_ptg
    from parsec_tpu_torch.ops.lu import lu_ptg

    N, nb = 64, 16
    rng = np.random.default_rng(42)
    M = rng.standard_normal((N, N))
    SPD = M @ M.T + N * np.eye(N)
    LUIN = rng.standard_normal((N, N)) + N * np.eye(N)
    refs = {}
    for key, data, build in (("chol", SPD, cholesky_ptg), ("lu", LUIN, lu_ptg)):
        sctx = Context(nb_cores=2)
        try:
            A = TiledMatrix(N, N, nb, nb, name=f"solo_{key}")
            A.from_array(data)
            stp = build(use_cuda=False).taskpool(NT=A.mt, A=A)
            sctx.add_taskpool(stp)
            assert stp.wait(timeout=120), f"solo {key} hung"
            refs[key] = A.to_array()
        finally:
            sctx.fini()
    ctx = _ctx(ce)
    try:
        A = TwoDimBlockCyclic(N, N, nb, nb, p=ce.nranks, q=1, myrank=ce.rank, name="mpA")
        A.from_array(SPD)
        B = TwoDimBlockCyclic(N, N, nb, nb, p=1, q=ce.nranks, myrank=ce.rank, name="mpB")
        B.from_array(LUIN)
        dc = LocalCollection("mpD", shape=(1,), nodes=ce.nranks, myrank=ce.rank,
                             init=lambda k: np.zeros(2))
        dc.rank_of = lambda *key: dc.data_key(*key) % ce.nranks
        nchain = 10
        ptg, step = _chain_ptg("mpchain")
        step.body(cpu=lambda X, k: X.__iadd__(1.0))
        pools = [("chol", cholesky_ptg(use_cuda=False).taskpool(NT=A.mt, A=A)),
                 ("lu", lu_ptg(use_cuda=False).taskpool(NT=B.mt, A=B)),
                 ("chain", ptg.taskpool(N=nchain, D=dc))]
        ce.barrier()
        for _, tp in pools:
            ctx.add_taskpool(tp)
        for key, tp in pools:
            assert tp.wait(timeout=240), f"{key} hung concurrently"
            nbt = getattr(tp.tdm, "_nb_tasks", None)
            assert not isinstance(nbt, int) or nbt <= 0, (key, nbt)
            assert not tp.failed
        ce.barrier()
        bad = 0
        for key, coll in (("chol", A), ("lu", B)):
            for (i, j) in coll.local_tiles():
                got = np.asarray(coll.data_of(i, j).newest_copy().payload)
                if not np.array_equal(got, refs[key][i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]):
                    bad += 1
        assert bad == 0, f"rank {ce.rank}: {bad} tiles differ from solo"
        if dc.rank_of(nchain - 1) == ce.rank:
            np.testing.assert_array_equal(dc.data_of(nchain - 1).newest_copy().payload,
                                          np.full(2, float(nchain)))
        return {"tiles_checked": len(list(A.local_tiles())) + len(list(B.local_tiles()))}
    finally:
        ctx.fini()


def scenario_barrier_close(ce):
    """Barrier releases queued just before close() are flushed: late
    ranks enter the barrier while the early ones are already past it and
    closing."""
    if ce.rank >= ce.nranks // 2:
        time.sleep(1.0)
    ce.barrier()
    return {}


def scenario_send_then_close(ce):
    """An AM sent immediately before close() still reaches a peer that is
    not reading yet: close() returns only once every queued frame is
    deliverable (the peer's FIN received)."""
    from parsec_tpu_torch.comm.engine import TAG_USER_BASE

    got = []
    ce.register_am(TAG_USER_BASE, lambda src, p: got.append((src, p)))
    ce.barrier()
    if ce.rank == 0:
        for dst in range(1, ce.nranks):
            ce.send_am(TAG_USER_BASE, dst, {"fin_race": dst})
        return {"got": 0}
    time.sleep(1.5)
    deadline = time.time() + 30
    while not got:
        time.sleep(0.005)
        assert time.time() < deadline, "last-breath AM never arrived"
    assert got[0][1] == {"fin_race": ce.rank}
    return {"got": len(got)}


def scenario_bcast(ce):
    """1 -> R broadcast of an above-short-limit payload, topology from
    PARSEC_MCA_runtime_bcast_topo: async GETs and forwarding from inside
    GET callbacks."""
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl.ptg import IN, INOUT, PTG

    got = []
    ctx = _ctx(ce)
    dc = LocalCollection("D", shape=(65536,), nodes=ce.nranks, myrank=ce.rank,
                         init=lambda k: np.full(65536, 7.0))
    dc.rank_of = lambda *key: dc.data_key(*key) % ce.nranks
    ptg = PTG("bcast")
    src = ptg.task_class("src")
    src.affinity("D(0)")
    src.flow("X", INOUT, "<- D(0)", "-> X sink(0 .. NR-1)")
    src.body(cpu=lambda X: X.__iadd__(35.0))
    sink = ptg.task_class("sink", r="0 .. NR-1")
    sink.affinity("D(r)")
    sink.flow("X", IN, "<- X src()")
    sink.body(cpu=lambda X, r: got.append(float(X[0])))
    tp = ptg.taskpool(NR=ce.nranks, D=dc)
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=90)
    assert got == [42.0], got
    ce.barrier()
    st = ce.remote_dep.stats
    out = {"sent": int(st["activations_sent"]), "recv": int(st["activations_recv"]),
           "fwd": int(st["forwarded"]), "get_adv": int(st["get_advertised"]),
           "mem_left": len(ce._mem)}
    ctx.fini()
    return out


def scenario_coll(ce):
    """Runtime collectives over the wire: ring allreduce of a payload
    that pipelines in segments, reduce-scatter, allgather, binomial
    bcast — numerics per rank, every staging registration reclaimed."""
    N = ce.nranks
    _ = ce.coll  # register the ctl op on every rank before any advert
    ce.barrier()
    n = 65536
    h = ce.coll_allreduce(np.arange(n, dtype=np.float64) * (ce.rank + 1))
    assert h.wait(timeout=90)
    np.testing.assert_array_equal(h.result(),
                                  np.arange(n, dtype=np.float64) * sum(range(1, N + 1)))
    h = ce.coll_reduce_scatter(np.arange(64, dtype=np.float64) + 100.0 * ce.rank)
    assert h.wait(timeout=90)
    full = sum(np.arange(64, dtype=np.float64) + 100.0 * r for r in range(N))
    b0, b1 = ce.rank * 64 // N, (ce.rank + 1) * 64 // N
    np.testing.assert_array_equal(h.result(), full[b0:b1])
    h = ce.coll_allgather(np.full(8, float(ce.rank)))
    assert h.wait(timeout=90)
    np.testing.assert_array_equal(h.result(), np.repeat(np.arange(float(N)), 8))
    arr = np.arange(256.0) if ce.rank == 1 else np.zeros(256)
    h = ce.coll_bcast(arr, root=1)
    assert h.wait(timeout=90)
    np.testing.assert_array_equal(h.result(), np.arange(256.0))
    ce.barrier()
    s = ce.coll.summary()
    assert s["ops_done"] == s["ops_started"] == 4, s
    assert s["segments_inflight"] == 0, s
    assert not ce._mem, list(ce._mem)
    return {"ops": s["ops_done"], "bytes": s["bytes"], "segs": s["segments"]}


def scenario_jobtrace(ce):
    """One serve job on a 2-rank mesh — an eager and a rendezvous
    cross-rank chain and one allreduce task a rank — traced per process
    (``RankTraceSet(nranks=1, base_rank=rank)``) with the clock handshake
    over TCP, dumped to TRACE_DIR for the parent to merge."""
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl.ptg import INOUT, PTG
    from parsec_tpu_torch.profiling.binary import RankTraceSet
    from parsec_tpu_torch.profiling.merge import clock_handshake
    from parsec_tpu_torch.serve import RuntimeService
    from parsec_tpu_torch.utils import mca_param

    mca_param.set_param("runtime", "comm_eager_limit", 2048)
    traces = RankTraceSet(nranks=1, base_rank=ce.rank).install()
    ctx = _ctx(ce)
    traces.set_clock_offset(ce.rank, clock_handshake(ce))
    n = 8

    def coll(name, width, rank_of=None):
        dc = LocalCollection(name, shape=(n if rank_of is None else ce.nranks,),
                             nodes=ce.nranks, myrank=ce.rank,
                             init=lambda k: np.zeros(width))
        dc.rank_of = rank_of or (lambda *key: dc.data_key(*key) % ce.nranks)
        return dc

    ds, db = coll("DS", 8), coll("DB", 4096)
    dr = LocalCollection("DR", shape=(ce.nranks,), nodes=ce.nranks, myrank=ce.rank,
                         init=lambda k: np.full(16, float(ce.rank + 1)))
    dr.rank_of = lambda *key: dr.data_key(*key)
    ptg = PTG("jt_tcp_job")
    for cls, d in (("jt_small", "DS"), ("jt_big", "DB")):
        t = ptg.task_class(cls, k="0 .. N-1")
        t.affinity(f"{d}(k)")
        t.flow("X", INOUT, f"<- (k == 0) ? {d}(0) : X {cls}(k-1)",
               f"-> (k < N-1) ? X {cls}(k+1) : {d}(k)")
        t.body(cpu=lambda X, k: X.__iadd__(1.0))
    ar = ptg.task_class("jt_ar", r=f"0 .. {ce.nranks - 1}")
    ar.affinity("DR(r)")
    ar.flow("X", INOUT, "<- DR(r)", "-> DR(r)")

    def ar_body(X, r):
        h = ctx.comm.coll.allreduce(np.ascontiguousarray(X), cid=("jt_tcp", 1))
        assert h.wait(timeout=60), h.state()
        X[...] = np.asarray(h.result()).reshape(X.shape)

    ar.body(cpu=ar_body)
    svc = RuntimeService(context=ctx, fairness=False)
    ce.barrier()
    h = svc.submit("acme", ptg.taskpool(N=n, DS=ds, DB=db, DR=dr))
    assert h.wait(timeout=120), h.status()
    trace_id = h.trace_id
    ce.barrier()
    assert svc.close(timeout=60)
    ctx.fini()
    paths = traces.dump(os.environ["TRACE_DIR"])
    traces.uninstall()
    traces.close()
    return {"trace_id": f"{trace_id:016x}", "paths": paths}


def main() -> int:
    from parsec_tpu_torch.comm import endpoint_from_env

    scenario = sys.argv[1]
    ce = endpoint_from_env()
    out = globals()[f"scenario_{scenario}"](ce)
    ce.close()
    print(json.dumps({"rank": ce.rank, "ok": True, **(out or {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())


# ---------------------------------------------------------------------------
# the tests (pytest)
# ---------------------------------------------------------------------------

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.comm import remote_dep as ref_rd  # noqa: E402
from parsec_tpu.comm import tcp as ref_tcp  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu_torch.comm import inproc as port_inproc  # noqa: E402
from parsec_tpu_torch.comm import remote_dep as port_rd  # noqa: E402
from parsec_tpu_torch.comm import tcp as port_tcp  # noqa: E402
from parsec_tpu_torch.comm.engine import TAG_USER_BASE  # noqa: E402
from parsec_tpu_torch.comm.launch import launch, main as launch_main  # noqa: E402
from parsec_tpu_torch.profiling import pins as port_pins  # noqa: E402
from test_torch_comm_protocol import _SinkPool  # noqa: E402

REF = dict(tcp=ref_tcp, rd=ref_rd, pins=ref_pins)
PORT = dict(tcp=port_tcp, rd=port_rd, pins=port_pins)
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def run_scenario(name, nranks, timeout=120, extra_env=None, driver=HERE, env=None):
    """Launch ``driver <name>`` as ``nranks`` port processes; returns each
    rank's JSON line (rank order), every one ``ok``."""
    results = launch(nranks, [driver, name], timeout=timeout,
                     env={**(PORT_ENV if env is None else env), **(extra_env or {})})
    out = [json.loads(r.stdout.strip().splitlines()[-1]) for r in results]
    assert all(o["ok"] for o in out)
    return out


# -- the scenarios of tests/runtime/test_tcp.py -------------------------------

@pytest.mark.parametrize("nranks,ams", [(2, 3), (4, 9)])
def test_tcp_smoke(nranks, ams):
    """AM batching, one-sided GET, barrier across processes."""
    out = run_scenario("smoke", nranks)
    assert all(o["ams"] == ams for o in out)
    assert all(o["get_bytes"] == 65536 * 8 for o in out)


def test_tcp_ptg_chain_2ranks():
    out = run_scenario("ptg_chain", 2)
    assert sorted(k for o in out for k in o["seen"]) == list(range(12))


def test_tcp_ptg_bigpayload_get():
    out = run_scenario("ptg_bigpayload", 2)
    assert any(o["get_issued"] >= 1 for o in out if o["rank"] != 0)


def test_tcp_dtd_gemm_4ranks():
    out = run_scenario("dtd_gemm", 4, timeout=180)
    sent = sum(o["dtd_sent"] for o in out)
    assert sent > 0 and sent == sum(o["dtd_recv"] for o in out)
    assert sum(o["dtd_inline"] for o in out) > 0
    assert sum(o["dtd_get"] for o in out) > 0


def test_tcp_ptg_qr_4ranks():
    out = run_scenario("ptg_qr", 4)
    assert sum(o["tiles"] for o in out) == 16


def test_tcp_barrier_then_immediate_close():
    run_scenario("barrier_close", 4)


def test_tcp_send_then_immediate_close():
    out = run_scenario("send_then_close", 4)
    assert all(o["got"] == 1 for o in out if o["rank"] != 0)


def test_tcp_multipool_2ranks():
    out = run_scenario("multipool", 2, timeout=180)
    assert all(o["tiles_checked"] > 0 for o in out)


def test_tcp_jobtrace_propagation_2ranks(tmp_path):
    """A job served on a 2-process TCP mesh: per-process trace sets, the
    clock handshake over TCP, and the merge of the dumps — every exec and
    wire span of the job carries its trace id on both ranks, one track
    group for the job, and ``critpath --job`` attributes its phases."""
    from parsec_tpu_torch.profiling import critpath
    from parsec_tpu_torch.profiling.merge import merge_traces

    out = run_scenario("jobtrace", 2, extra_env={"TRACE_DIR": str(tmp_path)})
    hexid = out[0]["trace_id"]
    assert all(o["trace_id"] == hexid for o in out)
    paths = [os.path.join(str(tmp_path), f"rank{r}.pbt") for r in range(2)]
    assert all(os.path.exists(p) for p in paths), paths
    doc = merge_traces(paths)
    evs = doc["traceEvents"]
    for pid in (0, 1):
        execs = [e for e in evs if e.get("name") == "exec" and e.get("pid") == pid
                 and e.get("ph") in ("B", "E")]
        assert execs and all(e["args"].get("trace_id") == hexid for e in execs)
        for kind in ("jobwire_eager", "jobwire_rdv", "jobwire_send"):
            hits = [e for e in evs if e.get("name") == kind and e.get("pid") == pid]
            assert hits, f"rank {pid}: no {kind} events"
            assert all(e["args"]["trace_id"] == hexid for e in hits)
    coll = [e for e in evs if e.get("name") == "jobcoll"]
    assert {e.get("pid") for e in coll} == {0, 1}
    assert all(e["args"]["trace_id"] == hexid for e in coll)
    groups = [e for e in evs if e.get("name") == "process_name" and e.get("ph") == "M"
              and e["args"].get("name") == f"job {hexid}"]
    assert len(groups) == 1
    assert doc["metadata"]["jobs"][hexid]["ranks"] == [0, 1]
    rep = critpath.analyze(evs, job=hexid)
    assert rep["n_tasks"] > 0 and rep["job"] == hexid
    ph = rep["phases"]
    assert ph["run_us"] > 0
    for key in ("queue_us", "admit_us", "drain_us", "total_us"):
        assert ph[key] is not None and ph[key] >= 0, (key, ph)
    assert ph["total_us"] >= ph["run_us"]


# -- the launcher -------------------------------------------------------------

def _script(tmp_path, body):
    path = tmp_path / "rank.py"
    path.write_text(body)
    return str(path)


def test_launch_passes_ranks_and_cli_prefixes_output(tmp_path, capsys):
    """Each child gets its rank, the job's size and one rendezvous
    directory, and the checkout's root first on its PYTHONPATH; the CLI
    prints each rank's lines prefixed with its rank."""
    script = _script(tmp_path, (
        "import os, sys\n"
        "print(os.environ['PARSEC_TPU_RANK'], os.environ['PARSEC_TPU_NRANKS'],"
        " os.environ['PARSEC_TPU_RDV'], os.environ['PYTHONPATH'].split(os.pathsep)[0],"
        " sys.argv[1])\n"))
    res = launch(3, [script, "x"], timeout=60)
    fields = [r.stdout.split() for r in res]
    root = os.path.dirname(os.path.dirname(HERE))
    assert [f[0] for f in fields] == ["0", "1", "2"]
    assert {f[1] for f in fields} == {"3"} and len({f[2] for f in fields}) == 1
    assert {f[3] for f in fields} == {root} and {f[4] for f in fields} == {"x"}
    assert not os.path.exists(fields[0][2])  # the launcher's own rdv dir is gone
    assert launch_main(["-n", "2", "--", script, "y"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["[rank", "0]"], ["[rank", "1]"]]


def test_launch_failed_rank_dooms_the_job_and_deadline_kills(tmp_path):
    """A rank that exits non-zero gets the others killed at once (not at
    the deadline), and the error carries its stderr; a job past its
    deadline is killed and reported as a timeout."""
    script = _script(tmp_path, (
        "import os, sys, time\n"
        "if os.environ['PARSEC_TPU_RANK'] == '1':\n"
        "    sys.stderr.write('rank one gives up\\n'); sys.exit(3)\n"
        "time.sleep(60)\n"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        launch(3, [script], timeout=50)
    assert time.monotonic() - t0 < 20
    msg = str(ei.value)
    assert "3/3 ranks failed" in msg and "rank one gives up" in msg
    assert "--- rank 1 (exit 3)" in msg and "killed after rank 1 failed" in msg
    sleeper = _script(tmp_path, "import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 0 \(timeout\)"):
        launch(2, [sleeper], timeout=1.0)
    assert time.monotonic() - t0 < 20


# -- the wire: tests/runtime/test_tcp_wire.py on both packages ---------------

def _pair(P):
    rdv = tempfile.mkdtemp()
    ces = [None, None]

    def mk(r):
        ces[r] = P["tcp"].TCPComm(r, 2, rendezvous_dir=rdv)

    ts = [threading.Thread(target=mk, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert all(ces), "bootstrap failed"
    return ces


def _close_all(ces):
    ts = [threading.Thread(target=ce.close) for ce in ces if ce is not None]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)


def _wait(pred, timeout=20):
    deadline = time.time() + timeout
    while not pred():
        time.sleep(0.005)
        assert time.time() < deadline, "timed out"


@BOTH
def test_wire_arrays_out_of_band_and_arena_recv(P):
    """Array payloads ship as raw out-of-band bytes and land in arena
    slots; the slots recycle once the delivered arrays die."""
    import gc

    ces = _pair(P)
    try:
        got = []
        ces[1].register_am(TAG_USER_BASE, lambda src, p: got.append(p))
        big = np.arange(32768.0)

        def send_and_check(lo, hi):
            ces[0].send_am(TAG_USER_BASE, 1, [{"i": i, "arr": big * i} for i in range(lo, hi)])
            _wait(lambda: got)
            for i, p in zip(range(lo, hi), got[0]):
                assert p["i"] == i
                np.testing.assert_array_equal(p["arr"], big * i)
            got.clear()

        send_and_check(0, 4)
        assert ces[0].stats["frames_sent"] >= 1
        assert ces[1]._rx_arenas, "no receive arenas were created"
        created1 = sum(a.stats()["created"] for a in ces[1]._rx_arenas.values())
        assert created1 > 0
        gc.collect()
        _wait(lambda: all(a.stats()["used"] == 0 for a in ces[1]._rx_arenas.values()))
        send_and_check(4, 8)
        gc.collect()
        _wait(lambda: all(a.stats()["used"] == 0 for a in ces[1]._rx_arenas.values()))
        created2 = sum(a.stats()["created"] for a in ces[1]._rx_arenas.values())
        assert created2 == created1, f"no recycling: {created1} -> {created2}"
    finally:
        _close_all(ces)


@BOTH
def test_wire_noncontiguous_payload_packs_via_datatype(P):
    ces = _pair(P)
    try:
        got = []
        ces[1].register_am(TAG_USER_BASE, lambda src, p: got.append(p))
        tile = np.arange(64.0 * 64).reshape(64, 64)[8:24, 4:20]
        assert not tile.flags.c_contiguous
        ces[0].send_am(TAG_USER_BASE, 1, {"tile": tile})
        _wait(lambda: got)
        np.testing.assert_array_equal(got[0]["tile"], tile)
        assert ces[0].stats["dt_packed"] >= 1
    finally:
        _close_all(ces)


@BOTH
def test_wire_rejects_oversized_frames(P):
    ces = _pair(P)
    try:
        ces[1].max_frame = 1024  # receiver-side cap
        got = []
        ces[1].register_am(TAG_USER_BASE, lambda src, p: got.append(p))
        ces[0].send_am(TAG_USER_BASE, 1, {"arr": np.zeros(65536)})
        _wait(lambda: 0 not in ces[1]._socks, timeout=10)
        assert not got
    finally:
        _close_all(ces)


@BOTH
def test_wire_empty_array_payload(P):
    ces = _pair(P)
    try:
        got = []
        ces[1].register_am(TAG_USER_BASE, lambda src, p: got.append(p))
        ces[0].send_am(TAG_USER_BASE, 1, {"empty": np.empty(0), "arr": np.arange(4.0)})
        _wait(lambda: got)
        assert got[0]["empty"].size == 0
        np.testing.assert_array_equal(got[0]["arr"], np.arange(4.0))
        assert 0 in ces[1]._socks
    finally:
        _close_all(ces)


def test_wire_bf16_tensor_out_of_band_round_trip():
    """A bfloat16 torch CPU tensor (C-order, F-order, strided and empty)
    ships out of band as its raw bits under its wire header, is rebuilt as
    a bfloat16 tensor over the receive slot (bit for bit), and holds the
    slot until it dies; no tensor is pickled in band."""
    import gc
    import pickle

    gen = torch.Generator().manual_seed(23)
    t = torch.randn((48, 40), generator=gen).to(torch.bfloat16)
    payload = {"c": t, "f": t.mT, "strided": t[::2, 1::3], "empty": t[:0],
               "f32": torch.arange(6.0).reshape(2, 3)}
    # nothing of the tensors rides in the control pickle
    bufs = []
    stats = {"dt_packed": 0}
    blob = pickle.dumps(port_tcp._pack_arrays(payload, stats), protocol=5,
                        buffer_callback=lambda pb: bufs.append(pb.raw()) and None)
    assert len(blob) < 1024 and stats["dt_packed"] == 1
    assert sum(b.nbytes for b in bufs) == 2 * (2 * t.numel() + t[::2, 1::3].numel()) + 24
    ces = _pair(PORT)
    try:
        got = []
        ces[1].register_am(TAG_USER_BASE, lambda src, p: got.append(p))
        ces[0].send_am(TAG_USER_BASE, 1, payload)
        _wait(lambda: got)
        for k, v in payload.items():
            assert isinstance(got[0][k], torch.Tensor) and got[0][k].dtype == v.dtype, k
            assert torch.equal(got[0][k], v), k
        assert not got[0]["f"].is_contiguous()  # the layout crossed as it was
        arenas = ces[1]._rx_arenas
        assert any(a.stats()["used"] for a in arenas.values())
        del got
        gc.collect()
        _wait(lambda: all(a.stats()["used"] == 0 for a in arenas.values()))
    finally:
        _close_all(ces)


def test_wire_refuses_a_cuda_tensor(monkeypatch):
    """A CUDA tensor reaching the wire raises ``TypeError`` on the sender's
    thread (a hidden device move otherwise) and nothing is queued; the
    CPU stands in for the card through a stubbed ``is_device_array``."""
    def looks_cuda(obj):
        return isinstance(obj, torch.Tensor) and getattr(obj, "_on_card", False)

    monkeypatch.setattr(port_tcp, "is_device_array", looks_cuda)
    ces = _pair(PORT)
    try:
        got = []
        ces[1].register_am(TAG_USER_BASE, lambda src, p: got.append(p))
        card = torch.ones(4)
        card._on_card = True
        for payload in (card, {"flows": {0: {"data": card}}}, [np.zeros(2), (card,)]):
            with pytest.raises(TypeError, match="cannot cross the TCP wire"):
                ces[0].send_am(TAG_USER_BASE, 1, payload)
        assert ces[0].stats[f"am_sent_{TAG_USER_BASE}"] == 0
        assert ces[0].termdet_sent == 0
        ces[0].send_am(TAG_USER_BASE, 1, {"host": torch.ones(4)})
        _wait(lambda: got)
        assert len(got) == 1 and torch.equal(got[0]["host"], torch.ones(4))
        ces[0].send_am(TAG_USER_BASE, 0, card)  # a self-send never serializes
    finally:
        _close_all(ces)


# -- tests/runtime/test_comm_protocol.py's TCP cases --------------------------

@BOTH
def test_subthreshold_zero_get_roundtrips_pinned(P):
    """A sub-threshold payload over the TCP wire makes no GET round trip:
    no DATA_CTL event, no pull stats, one eager DATA_PLD, and the
    internal GET_REQ/GET_ANS tags never fire — on both packages."""
    pins = P["pins"]
    seen = {"ctl": [], "pld": []}

    def ctl_cb(es, info):
        seen["ctl"].append(info)

    def pld_cb(es, info):
        seen["pld"].append(info)

    pins.subscribe(pins.COMM_DATA_CTL, ctl_cb)
    pins.subscribe(pins.COMM_DATA_PLD, pld_cb)
    ces = _pair(P)
    try:
        rds = [P["rd"].RemoteDepManager(ce) for ce in ces]
        pools = [_SinkPool(), _SinkPool()]
        rds[0].new_taskpool(pools[0])
        rds[1].new_taskpool(pools[1])
        payload = np.arange(512, dtype=np.float64)
        rds[0].send_activations(pools[0], "cls", (7,), {1: 1}, {0: payload})
        _wait(lambda: pools[1].got)
        np.testing.assert_array_equal(pools[1].got[0]["flow_data"][0], payload)
        assert seen["ctl"] == []
        assert [p["proto"] for p in seen["pld"]] == ["eager"]
        assert rds[1].stats["rdv_pulls"] == 0
        assert rds[0].stats["get_advertised"] == 0
        tcp = P["tcp"]
        for ce in ces:
            assert ce.stats[f"am_sent_{tcp.TAG_GET_REQ}"] == 0
            assert ce.stats[f"am_sent_{tcp.TAG_GET_ANS}"] == 0
    finally:
        pins.unsubscribe(pins.COMM_DATA_CTL, ctl_cb)
        pins.unsubscribe(pins.COMM_DATA_PLD, pld_cb)
        _close_all(ces)


def _protocol_pins(ces, rd_mod, pins):
    """One two-rank activation with one sub- and one above-threshold flow;
    returns the received flows and the protocol pins, sorted."""
    events = []

    def on(site):
        def cb(es, info):
            events.append((site, str(info.get("proto")),
                           -1 if info.get("chunk") is None else info["chunk"],
                           -1 if info.get("nchunks") is None else info["nchunks"],
                           int(info.get("bytes", 0))))
        return cb

    subs = [(pins.COMM_DATA_PLD, on("pld")), (pins.COMM_DATA_CTL, on("ctl"))]
    for site, cb in subs:
        pins.subscribe(site, cb)
    try:
        rds = [rd_mod.RemoteDepManager(ce) for ce in ces]
        pools = [_SinkPool("parity"), _SinkPool("parity")]
        rds[0].new_taskpool(pools[0])
        rds[1].new_taskpool(pools[1])
        small = np.arange(256, dtype=np.float64)
        big = np.arange(64 << 7, dtype=np.float64)
        rds[0].send_activations(pools[0], "cls", (1,), {1: 0b11}, {0: small, 1: big})
        deadline = time.time() + 20
        while not pools[1].got:
            for ce in ces:
                ce.progress_nonblocking()
            time.sleep(0.005)
            assert time.time() < deadline, "activation never delivered"
        flows = pools[1].got[0]["flow_data"]
        np.testing.assert_array_equal(flows[0], small)
        np.testing.assert_array_equal(flows[1], big)
    finally:
        for site, cb in subs:
            pins.unsubscribe(site, cb)
    return sorted(events)


def test_engine_parity_same_protocol_pins():
    """The same activation over the port's TCP wire and over its
    in-process fabric takes the same regime decisions: the same received
    flows and the same protocol-pin sequence (site, proto, chunk shape,
    bytes) — one eager landing, one rendezvous advert and its chunk."""
    seqs = {"inproc": _protocol_pins(port_inproc.InprocFabric(2).endpoints(),
                                     port_rd, port_pins)}
    ces = _pair(PORT)
    try:
        seqs["tcp"] = _protocol_pins(ces, port_rd, port_pins)
    finally:
        _close_all(ces)
    assert [e for e in seqs["tcp"] if e[0] == "pld"] == sorted(
        [("pld", "eager", -1, -1, 2048), ("pld", "rdv", 0, 1, 64 << 10)])
    assert seqs["tcp"] == seqs["inproc"]


def test_endpoint_from_env_reads_the_launcher_variables(monkeypatch, tmp_path):
    """``endpoint_from_env`` builds this process's endpoint from
    ``PARSEC_TPU_RANK``/``_NRANKS``/``_RDV`` (``_PEERS`` wins over the
    directory); a one-rank job needs no peer."""
    monkeypatch.setenv("PARSEC_TPU_RANK", "0")
    monkeypatch.setenv("PARSEC_TPU_NRANKS", "1")
    monkeypatch.setenv("PARSEC_TPU_RDV", str(tmp_path))
    ce = port_tcp.endpoint_from_env()
    try:
        assert (ce.rank, ce.nranks, ce.device_payloads, ce.pull_bytes_in_frames) == \
            (0, 1, False, True)
        ce.barrier()  # one rank: returns at once
        assert ce.progress_nonblocking() == 0
        h = ce.coll_allreduce(np.arange(3.0))
        assert h.wait(timeout=5)
        np.testing.assert_array_equal(h.result(), np.arange(3.0))
    finally:
        ce.close()
    ce = port_tcp.TCPComm(0, 1)
    try:
        with pytest.raises(ValueError, match="internal band"):
            ce.register_am(port_tcp.TAG_FIN, lambda s, p: None)
    finally:
        ce.close()
