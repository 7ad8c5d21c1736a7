"""The port's DTD front-end (parsec_tpu_torch.dsl.dtd, ptg_to_dtd) against
the JAX package's.

Every case of the reference's ``tests/dsl/test_dtd.py`` and
``tests/dsl/test_dtd_war_untie.py`` runs here on both packages, from the
same seeded numpy inputs, and their outputs must be ``np.array_equal``:
both do the same host arithmetic in the same order.  The port's contexts
are host-only (``devices=["cpu"]``) for CPU bodies.

Device chores run on the port's CUDA module bound to the torch CPU device
(``cuda_device="cpu"``: its copies are real, its kernel wrappers take
their plain versions): the reference's TPU-module DTD cases
(``tests/runtime/test_tpu_device.py``), WAR renaming across device
versions, and dpotrf inserted through DTD (B1 f32/bf16, B2 with trtri)
with an insertion window below the task count, held to the reference's
``cholesky_ptg(use_pallas=True)`` in Pallas interpret mode at
``tests/test_torch_cholesky.py``'s tolerances and ``torch.equal`` to the
port's own ``cholesky_ptg``.  Multi-rank DTD runs in
``test_torch_dtd_multirank.py``; here, an early tile version's parking.
"""

import threading
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu.dsl as ref_dsl  # noqa: E402
import parsec_tpu_torch  # noqa: E402
import parsec_tpu_torch.dsl as port_dsl  # noqa: E402
from parsec_tpu.data import data_create as ref_data_create  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch import DEV_CPU, DEV_CUDA, mca_param  # noqa: E402
from parsec_tpu_torch.data import data_create  # noqa: E402
from parsec_tpu_torch.datadist import (TiledMatrix, TwoDimBlockCyclic,  # noqa: E402
                                       from_numpy_tiles)
from parsec_tpu_torch.dsl.dtd import stage_to_cpu  # noqa: E402
from parsec_tpu_torch.ops import (cholesky_ptg, dpotrf_task_count,  # noqa: E402
                                  insert_dpotrf, kernels)

REF = types.SimpleNamespace(
    name="ref", dsl=ref_dsl, data_create=ref_data_create, mca=ref_mca,
    TiledMatrix=RefTiledMatrix, TwoDimBlockCyclic=RefBC,
    Context=lambda n: parsec_tpu.Context(nb_cores=n, devices=["cpu"]))
PORT = types.SimpleNamespace(
    name="port", dsl=port_dsl, data_create=data_create, mca=mca_param,
    TiledMatrix=TiledMatrix, TwoDimBlockCyclic=TwoDimBlockCyclic,
    Context=lambda n: parsec_tpu_torch.Context(nb_cores=n, devices=["cpu"]))


def both(scenario, nb_cores=4):
    """``scenario(P, ctx)`` on the reference, then on the port; returns the
    two results, each checked by the scenario itself."""
    out = []
    for P in (REF, PORT):
        ctx = P.Context(nb_cores)
        try:
            out.append(scenario(P, ctx))
        finally:
            ctx.fini()
    return out


def assert_same(results):
    ref, port = results
    assert type(ref) is type(port)
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(port)
        for a, b in zip(ref, port):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)
    else:
        assert np.array_equal(np.asarray(ref), np.asarray(port)), (ref, port)


def payload(d):
    return np.array(d.newest_copy().payload)


# ---------------------------------------------------------------------------
# tests/dsl/test_dtd.py
# ---------------------------------------------------------------------------

def test_insert_simple_chain():
    """RAW chain on one tile must serialize in insertion order."""
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.zeros(1))
        tp = P.dsl.DTDTaskpool(ctx)

        def bump(x):
            x += 1

        for _ in range(30):
            tp.insert_task(bump, (d, P.dsl.INOUT))
        assert tp.wait(timeout=30)
        assert payload(d)[0] == 30
        return payload(d)

    assert_same(both(scenario))


def test_readers_parallel_writer_serialized():
    """WAR: readers between writers all see the writer's value."""
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.array([7.0]))
        seen = []
        lock = threading.Lock()
        tp = P.dsl.DTDTaskpool(ctx)

        def read(x):
            with lock:
                seen.append(float(x[0]))

        def write(x):
            x[0] = 42.0

        for _ in range(8):
            tp.insert_task(read, (d, P.dsl.IN))
        tp.insert_task(write, (d, P.dsl.INOUT))
        for _ in range(8):
            tp.insert_task(read, (d, P.dsl.IN))
        assert tp.wait(timeout=30)
        assert sorted(seen) == [7.0] * 8 + [42.0] * 8
        return sorted(seen)

    assert_same(both(scenario))


def test_value_and_scratch_args():
    def scenario(P, ctx):
        d = P.data_create("acc", payload=np.zeros(4))
        tp = P.dsl.DTDTaskpool(ctx)

        def body(out, scratch, k):
            scratch[:] = k
            out += scratch

        tp.insert_task(body, (d, P.dsl.INOUT), (((4,), np.float64), P.dsl.SCRATCH),
                       (2.5, P.dsl.VALUE))
        tp.insert_task(body, (d, P.dsl.INOUT), (((4,), np.float64), P.dsl.SCRATCH),
                       1.5)  # bare value
        assert tp.wait(timeout=30)
        np.testing.assert_allclose(payload(d), 4.0)
        return payload(d)

    assert_same(both(scenario))


def _times_ten(x):
    return x * 10.0


def test_functional_body_return():
    """A body may return replacement outputs instead of mutating."""
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.ones(3))
        tp = P.dsl.DTDTaskpool(ctx)
        tp.insert_task(_times_ten, (d, P.dsl.INOUT))
        assert tp.wait(timeout=30)
        np.testing.assert_allclose(payload(d), 10.0)
        return payload(d)

    assert_same(both(scenario))


def test_dtd_tiled_gemm():
    """The reference's dtd_test_simple_gemm: C = A@B over block-cyclic
    tiles, verified against numpy."""
    rng = np.random.default_rng(42)
    Adense = rng.standard_normal((48, 48))
    Bdense = rng.standard_normal((48, 48))

    def scenario(P, ctx):
        nb = 16
        A = P.TiledMatrix(48, 48, nb, nb, name="A").from_array(Adense)
        B = P.TiledMatrix(48, 48, nb, nb, name="B").from_array(Bdense)
        C = P.TwoDimBlockCyclic(48, 48, nb, nb, p=1, q=1, name="C")
        tp = P.dsl.DTDTaskpool(ctx)

        def gemm(a, b, c):
            c += a @ b

        for i in range(A.mt):
            for j in range(B.nt):
                for k in range(A.nt):
                    tp.insert_task(gemm, (A.data_of(i, k), P.dsl.IN),
                                   (B.data_of(k, j), P.dsl.IN),
                                   (C.data_of(i, j), P.dsl.INOUT | P.dsl.AFFINITY),
                                   name="gemm")
        tp.flush_all()
        tp.close()
        assert ctx.wait(timeout=60)
        np.testing.assert_allclose(C.to_array(), Adense @ Bdense, rtol=1e-10)
        return C.to_array()

    assert_same(both(scenario))


def test_out_mode_overwrites():
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.array([1.0]))
        order = []
        tp = P.dsl.DTDTaskpool(ctx)

        def w1(x):
            order.append("w1")
            x[0] = 5.0

        def w2(x):
            order.append("w2")
            x[0] = 9.0

        tp.insert_task(w1, (d, P.dsl.OUT))
        tp.insert_task(w2, (d, P.dsl.OUT))  # WAW serialized
        assert tp.wait(timeout=30)
        assert order == ["w1", "w2"]
        return payload(d)

    assert_same(both(scenario))


def test_window_throttling_bounds_inflight():
    def scenario(P, ctx):
        P.mca.set_param("dtd", "window_size", 32)
        P.mca.set_param("dtd", "threshold_size", 16)
        try:
            d = [P.data_create(i, payload=np.zeros(1)) for i in range(4)]
            tp = P.dsl.DTDTaskpool(ctx)
            max_seen = [0]

            def body(x):
                max_seen[0] = max(max_seen[0], tp._inserted - tp._retired)
                x += 1

            for k in range(400):
                tp.insert_task(body, (d[k % 4], P.dsl.INOUT))
            assert tp.wait(timeout=60)
            assert max_seen[0] <= 64  # window kept the DAG bounded
            return [payload(t) for t in d]
        finally:
            P.mca.params.unset("dtd", "window_size")
            P.mca.params.unset("dtd", "threshold_size")

    res = both(scenario, nb_cores=2)
    assert_same(res)
    assert sum(float(x[0]) for x in res[1]) == 400


def _noop(x):
    return None


def test_insert_after_close_raises():
    def scenario(P, ctx):
        tp = P.dsl.DTDTaskpool(ctx)
        d = P.data_create("x", payload=np.zeros(1))
        tp.insert_task(_noop, (d, P.dsl.IN))
        tp.close()
        with pytest.raises(RuntimeError, match="closed"):
            tp.insert_task(_noop, (d, P.dsl.IN))
        assert ctx.wait(timeout=30)
        return tp.nb_retired

    assert_same(both(scenario))


def test_ctl_arg_orders_without_passing():
    """A CTL-flagged tile orders after its last writer but is not passed to
    the body."""
    def scenario(P, ctx):
        guard = P.data_create("guard", payload=np.zeros(1))
        out = P.data_create("out", payload=np.zeros(1))
        order = []
        tp = P.dsl.DTDTaskpool(ctx)

        def writer(g):
            order.append("w")
            g[0] = 1.0

        def reader(x):  # exactly ONE arg: the CTL tile must not appear
            order.append("r")
            x[0] = 99.0

        tp.insert_task(writer, (guard, P.dsl.INOUT))
        tp.insert_task(reader, (out, P.dsl.INOUT), (guard, P.dsl.CTL))
        assert tp.wait(timeout=30)
        assert order == ["w", "r"]
        return [payload(out), payload(guard)]

    assert_same(both(scenario))


def test_raising_body_fails_pool_and_discards_successors():
    """A raising body fails the pool: wait() returns False promptly, the
    successors are discarded, and the context stays usable."""
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.zeros(1))
        ran = []
        tp = P.dsl.DTDTaskpool(ctx)

        def boom(x):
            raise ValueError("kaboom")

        def after(x):
            ran.append(1)
            x += 1

        tp.insert_task(boom, (d, P.dsl.INOUT))
        tp.insert_task(after, (d, P.dsl.INOUT))
        assert tp.wait(timeout=30) is False
        assert tp.failed
        with pytest.raises(RuntimeError):
            tp.insert_task(after, (d, P.dsl.INOUT))  # failed pool rejects inserts
        tp2 = P.dsl.DTDTaskpool(ctx)
        tp2.insert_task(after, (d, P.dsl.INOUT))
        assert tp2.wait(timeout=30)
        deadline = time.time() + 5
        while not ran and time.time() < deadline:
            time.sleep(0.01)
        assert ran == [1]  # only the fresh pool's task ran
        return payload(d)

    assert_same(both(scenario))


def test_wait_zero_timeout_polls():
    def scenario(P, ctx):
        P.data_create("x", payload=np.zeros(1))
        tp = P.dsl.DTDTaskpool(ctx)
        return tp.wait(timeout=0)  # nothing inserted: immediately quiet

    assert both(scenario) == [True, True]


def _incr(x):
    x += 1


def test_wait_reopenable():
    """wait() quiesces but the pool accepts more tasks after."""
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.zeros(1))
        tp = P.dsl.DTDTaskpool(ctx)
        tp.insert_task(_incr, (d, P.dsl.INOUT))
        assert tp.wait(timeout=30)
        first = payload(d)
        tp.insert_task(_incr, (d, P.dsl.INOUT))
        assert tp.wait(timeout=30)
        tp.close()
        assert ctx.wait(timeout=30)
        return [first, payload(d)]

    res = both(scenario)
    assert_same(res)
    assert [float(x[0]) for x in res[1]] == [1.0, 2.0]


# ---------------------------------------------------------------------------
# tests/dsl/test_dtd_war_untie.py
# ---------------------------------------------------------------------------

def test_war_rename_overlaps_readers_with_writer():
    """Slow readers of version 1 must not delay the next writer; readers
    observe the old version while the writer updates a renamed buffer."""
    def scenario(P, ctx):
        d = P.data_create("t", payload=np.zeros(4))
        dtd = P.dsl.DTDTaskpool(ctx)
        times = {}
        seen = []
        lock = threading.Lock()
        dtd.insert_task(_plus_one, (d, P.dsl.INOUT), name="w1")

        def slow_reader(X, idx):
            with lock:
                seen.append(np.array(X))
            time.sleep(0.4)
            with lock:
                times[f"r{idx}"] = time.monotonic()

        for i in range(3):
            dtd.insert_task(slow_reader, (d, P.dsl.IN), i, name="reader")

        def w2(X):
            X += 10.0
            times["w2"] = time.monotonic()

        dtd.insert_task(w2, (d, P.dsl.INOUT), name="w2")
        dtd.flush_all()
        dtd.close()
        for s in seen:
            np.testing.assert_allclose(s, 1.0)
        assert times["w2"] < max(times[f"r{i}"] for i in range(3))
        return [payload(d)] + seen

    assert_same(both(scenario))


def _plus_one(X):
    X += 1.0


def test_war_serialized_when_rename_disabled():
    def scenario(P, ctx):
        P.mca.set_param("dtd", "war_rename", False)
        try:
            d = P.data_create("t2", payload=np.zeros(2))
            dtd = P.dsl.DTDTaskpool(ctx)
            order = []
            lock = threading.Lock()
            dtd.insert_task(_plus_one, (d, P.dsl.INOUT))

            def reader(X):
                time.sleep(0.2)
                with lock:
                    order.append("r")

            dtd.insert_task(reader, (d, P.dsl.IN))

            def writer(X):
                with lock:
                    order.append("w")
                X += 10.0

            dtd.insert_task(writer, (d, P.dsl.INOUT))
            dtd.flush_all()
            dtd.close()
            assert order == ["r", "w"]  # strict WAR serialization
            return payload(d)
        finally:
            P.mca.set_param("dtd", "war_rename", True)

    assert_same(both(scenario))


def test_atomic_write_commutes_and_orders_vs_readers():
    def scenario(P, ctx):
        d = P.data_create("acc", payload=np.zeros(1))
        dtd = P.dsl.DTDTaskpool(ctx)
        final = {}
        dtd.insert_task(_plus_one, (d, P.dsl.INOUT))
        for _ in range(8):
            dtd.insert_task(_plus_one, (d, P.dsl.ATOMIC_WRITE))
        dtd.insert_task(lambda X: final.update(v=float(X[0])), (d, P.dsl.IN))
        dtd.flush_all()
        dtd.close()
        assert final["v"] == 9.0
        return [final["v"], payload(d)]

    assert_same(both(scenario))


def test_untied_generator_body_releases_worker():
    def scenario(P, ctx):
        d = P.data_create("u", payload=np.zeros(1))
        dtd = P.dsl.DTDTaskpool(ctx)
        slices = []

        def untied(X):
            for i in range(5):
                slices.append(i)
                yield
            X += 42.0
            return None

        dtd.insert_task(untied, (d, P.dsl.INOUT))
        dtd.flush_all()
        dtd.close()
        assert slices == [0, 1, 2, 3, 4]
        return payload(d)

    assert_same(both(scenario))


def test_untied_many_tasks_fewer_workers():
    """More untied tasks than workers: slicing lets them interleave."""
    def scenario(P, ctx):
        dtd = P.dsl.DTDTaskpool(ctx)
        datas = [P.data_create(f"u{i}", payload=np.zeros(1)) for i in range(6)]
        progress = []
        lock = threading.Lock()

        def make(idx):
            def untied(X):
                for s in range(3):
                    with lock:
                        progress.append((idx, s))
                    yield
                X += idx
            return untied

        for i, d in enumerate(datas):
            dtd.insert_task(make(i), (d, P.dsl.INOUT))
        dtd.flush_all()
        dtd.close()
        assert len(progress) == 18
        return [payload(d) for d in datas]

    assert_same(both(scenario, nb_cores=2))


# ---------------------------------------------------------------------------
# multi-rank: the shadow-task protocol's parking of early arrivals
# ---------------------------------------------------------------------------

def test_multirank_dtd_raises_naming_a8():
    """Multi-rank DTD is ported (ROADMAP A.8a; the runs are in
    test_torch_dtd_multirank.py): a tile version that arrives before its
    recv task exists is parked under (tile, epoch), as the JAX package
    parks it, and its payload is the delivered one, not a copy."""
    key, arr = ("A", (0, 0)), np.arange(3.0)
    for tp in (port_dsl.DTDTaskpool(None), ref_dsl.DTDTaskpool(None)):
        tp.dtd_incoming(key, 1, arr)
        assert tp._recv == {(key, 1): {"payload": arr, "task": None}}


# ---------------------------------------------------------------------------
# device chores on the CUDA module bound to the torch CPU device
# (the reference's tests/runtime/test_tpu_device.py cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def dctx():
    c = parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")
    yield c
    c.fini()


def _cuda_dev(ctx):
    dev = ctx.devices[1]
    assert dev.device_type == DEV_CUDA and dev.tdev == torch.device("cpu")
    return dev


def _ref_device_run(build):
    """The reference's TPU-module run of the same insertions (JAX's CPU
    backend); ``build(tp, DEV)`` inserts with the reference's device type."""
    with parsec_tpu.Context(nb_cores=2) as ctx:
        tp = ref_dsl.DTDTaskpool(ctx)
        out = build(tp, parsec_tpu.DEV_TPU)
        assert tp.wait(timeout=60)
        tp.flush_all()
        return out


def _twice(x):
    return x * 2.0


def _plus_one_f(x):
    return x + 1.0


def test_device_body_executes_on_device(dctx):
    dev = _cuda_dev(dctx)
    d = data_create("x", payload=np.full((8, 8), 3.0))
    tp = port_dsl.DTDTaskpool(dctx)
    tp.insert_task({DEV_CUDA: _twice}, (d, port_dsl.INOUT))
    assert tp.wait(timeout=60)
    c = d.get_copy(dev.data_index)
    assert c is not None and c.version == d.newest_copy().version
    assert isinstance(c.payload, torch.Tensor)
    ref = ref_data_create("x", payload=np.full((8, 8), 3.0))
    _ref_device_run(lambda t, D: t.insert_task({D: lambda x: x * 2.0},
                                               (ref, ref_dsl.INOUT)))
    assert np.array_equal(stage_to_cpu(d), np.asarray(ref.newest_copy().payload))
    assert dev.stats["executed_tasks"] == 1
    assert dev.stats["bytes_in"] == 8 * 8 * 8


def test_device_chain_stays_resident(dctx):
    """RAW chain on device: one stage-in, no intermediate host bounce."""
    dev = _cuda_dev(dctx)
    d = data_create("x", payload=np.ones((16,)))
    tp = port_dsl.DTDTaskpool(dctx)
    for _ in range(10):
        tp.insert_task({DEV_CUDA: _plus_one_f}, (d, port_dsl.INOUT))
    assert tp.wait(timeout=60)
    assert dev.stats["bytes_in"] == 16 * 8  # exactly one H2D
    np.testing.assert_array_equal(stage_to_cpu(d), 11.0)


def _times_three_cpu(x):
    x *= 3.0


def _times_three(x):
    return x * 3.0


def test_mixed_cpu_cuda_chores(dctx):
    """CPU and CUDA incarnations: either may be picked, results agree."""
    d = data_create("x", payload=np.arange(8.0))
    tp = port_dsl.DTDTaskpool(dctx)
    tp.insert_task({DEV_CPU: _times_three_cpu, DEV_CUDA: _times_three},
                   (d, port_dsl.INOUT))
    assert tp.wait(timeout=60)
    np.testing.assert_array_equal(stage_to_cpu(d), np.arange(8.0) * 3.0)


def _gemm_dev(a, b, c):
    return c + a @ b


def test_gemm_on_device_matches_reference(dctx):
    rng = np.random.default_rng(7)
    Ad = rng.standard_normal((64, 64))
    Bd = rng.standard_normal((64, 64))

    def insert(tp, dsl, Cls, dev, body):
        A = Cls(64, 64, 32, 32, name="A").from_array(Ad)
        B = Cls(64, 64, 32, 32, name="B").from_array(Bd)
        C = Cls(64, 64, 32, 32, name="C")
        for i in range(2):
            for j in range(2):
                for k in range(2):
                    tp.insert_task({dev: body}, (A.data_of(i, k), dsl.IN),
                                   (B.data_of(k, j), dsl.IN),
                                   (C.data_of(i, j), dsl.INOUT), name="gemm")
        return C

    tp = port_dsl.DTDTaskpool(dctx)
    C = insert(tp, port_dsl, TiledMatrix, DEV_CUDA, _gemm_dev)
    assert tp.wait(timeout=120)
    tp.flush_all()
    Cref = _ref_device_run(lambda t, D: insert(
        t, ref_dsl, RefTiledMatrix, D, lambda a, b, c: c + jnp.dot(
            a, b, precision="highest")))
    np.testing.assert_allclose(C.to_array(), Ad @ Bd, rtol=1e-10)
    np.testing.assert_allclose(C.to_array(), Cref.to_array(), rtol=1e-10)


def _touch(x):
    return x + 0.0


def test_lru_eviction_under_budget_pressure(dctx):
    dev = _cuda_dev(dctx)
    dev.mem_budget = 4 * 1024 * 8  # room for ~4 tiles of 1024 f64
    tiles = [data_create(i, payload=np.full((1024,), float(i))) for i in range(12)]
    tp = port_dsl.DTDTaskpool(dctx)
    for t in tiles:
        tp.insert_task({DEV_CUDA: _touch}, (t, port_dsl.INOUT))
    assert tp.wait(timeout=60)
    assert dev.stats["evictions"] > 0
    assert dev.mem_used <= dev.mem_budget * 2  # bounded residency
    for i, t in enumerate(tiles):
        np.testing.assert_array_equal(stage_to_cpu(t), float(i))


def _plus_three(x):
    return x + 3.0


def test_out_only_flow_skips_stage_in(dctx):
    dev = _cuda_dev(dctx)
    d = data_create("x", payload=np.full(64, -1.0))
    tp = port_dsl.DTDTaskpool(dctx)
    tp.insert_task({DEV_CUDA: _plus_three}, (d, port_dsl.OUT))
    assert tp.wait(timeout=60)
    assert dev.stats["bytes_in"] == 0  # no stage-in for OUT-only
    np.testing.assert_array_equal(stage_to_cpu(d), 3.0)  # zeros + 3


def _cpu_add(x):
    x += 1.0


def test_restage_does_not_leak_device_accounting(dctx):
    """Alternating CPU/CUDA writes re-stage one tile; the replaced device
    copy's bytes are reclaimed, and every version is seen in order."""
    dev = _cuda_dev(dctx)
    d = data_create("x", payload=np.zeros(128))
    tp = port_dsl.DTDTaskpool(dctx)
    for _ in range(6):
        tp.insert_task(_cpu_add, (d, port_dsl.INOUT))
        tp.insert_task({DEV_CUDA: _twice}, (d, port_dsl.INOUT))
    assert tp.wait(timeout=60)
    assert dev.mem_used <= 2 * 128 * 8  # one tile resident, not six
    want = 0.0
    for _ in range(6):
        want = (want + 1.0) * 2.0
    np.testing.assert_array_equal(stage_to_cpu(d), want)


def _scaled_by_scratch(x, s, k):
    s += k  # a zeroed device scratch buffer
    return x + s


def test_device_scratch_and_interleaved_values(dctx):
    """DTD keeps the caller's argument order: a value and a SCRATCH buffer
    between data arguments reach the device body where they were put."""
    d = data_create("x", payload=np.ones(4))
    tp = port_dsl.DTDTaskpool(dctx)
    tp.insert_task({DEV_CUDA: _scaled_by_scratch}, (d, port_dsl.INOUT),
                   (((4,), np.float64), port_dsl.SCRATCH), (2.0, port_dsl.VALUE))
    assert tp.wait(timeout=60)
    np.testing.assert_array_equal(stage_to_cpu(d), 3.0)


def test_device_scratch_in_the_wave_signature(dctx):
    """A DTD task's wave signature holds its scratch buffer's shape and
    dtype and its values in argument order, and the scratch bytes count
    toward a chunk's size."""
    dev = _cuda_dev(dctx)
    d = data_create("x", payload=np.ones(4))
    tp = port_dsl.DTDTaskpool(dctx)
    task = tp.insert_task({DEV_CUDA: _scaled_by_scratch}, (d, port_dsl.INOUT),
                          (((4,), np.float64), port_dsl.SCRATCH), (2.0, port_dsl.VALUE))
    assert tp.wait(timeout=60)
    sig = dev._wave_signature(task)
    assert sig[0] is _scaled_by_scratch
    assert sig[1][0] == "data" and sig[2] == ("scratch", (4,), torch.float64)
    assert sig[3] == ("value", "float", 2.0)
    dev._chunk_bytes = 3 * 4 * 8  # the data tile in and out, the scratch in
    assert dev._chunk_cap(sig) == 1


def _dev_read(x, out):
    return out + x


def test_war_rename_with_device_versions(dctx):
    """WAR renaming when the newest version lives on the device: the
    rename copy must take the device version (by Data versions), not the
    stale host copy; readers see the old version, the home tile gets the
    writer's at flush.  Same values as the reference's host-only run."""
    def scenario(dsl, mk, bodies):
        inc, rd = bodies
        d = mk("t", payload=np.full(4, 1.0))
        outs = [mk(("o", i), payload=np.zeros(4)) for i in range(3)]
        return d, outs, [
            ((inc, (d, dsl.INOUT)), {}),
            *[((rd, (d, dsl.IN), (o, dsl.INOUT)), {}) for o in outs],
            ((inc, (d, dsl.INOUT)), {}),
        ]

    tp = port_dsl.DTDTaskpool(dctx)
    d, outs, ins = scenario(port_dsl, data_create,
                            ({DEV_CUDA: _twice}, {DEV_CUDA: _dev_read}))
    for args, kw in ins:
        tp.insert_task(*args, **kw)
    tp.flush_all()
    tp.close()
    assert dctx.wait(timeout=60)
    renamed = [st for st in tp._tiles.values()]
    assert renamed == []  # flushed
    with parsec_tpu.Context(nb_cores=2) as rctx:
        rtp = ref_dsl.DTDTaskpool(rctx)
        rd_, routs, rins = scenario(ref_dsl, ref_data_create,
                                    (lambda x: x * 2.0, lambda x, out: out + x))
        for args, kw in rins:
            rtp.insert_task(*args, **kw)
        rtp.flush_all()
        rtp.close()
        assert rctx.wait(timeout=60)
    assert np.array_equal(stage_to_cpu(d), np.asarray(rd_.newest_copy().payload))
    np.testing.assert_array_equal(stage_to_cpu(d), 4.0)
    for o, ro in zip(outs, routs):
        assert np.array_equal(stage_to_cpu(o), np.asarray(ro.newest_copy().payload))
        np.testing.assert_array_equal(stage_to_cpu(o), 2.0)


# ---------------------------------------------------------------------------
# dpotrf through DTD, against the reference's Pallas path
# ---------------------------------------------------------------------------

def _spd(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


# (port kwargs, reference kwargs, |LL^T - S| bound, port-vs-reference
# bound): tests/test_torch_cholesky.py's
_VARIANTS = {
    "kernels": (dict(use_kernels=True), dict(use_pallas=True), 2e-3, 1e-4),
    "kernels_trtri": (dict(use_kernels=True, use_trtri=True),
                      dict(use_pallas=True, use_trtri=True), 2e-3, 1e-4),
    "kernels_bf16": (dict(use_kernels=True, bf16_updates=True),
                     dict(use_pallas=True, bf16_updates=True), 2e-2, 2e-2),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_dtd_dpotrf_matches_reference_and_ptg(variant):
    port_kw, ref_kw, bound, ref_bound = _VARIANTS[variant]
    n, nb = 256, 64
    S = _spd(n, seed=3)
    ref_A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    host_tiles = {k: np.array(ref_A.data_of(*k).newest_copy().payload)
                  for k in ref_A.tiles()}
    ref_tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False, **ref_kw).taskpool(
        NT=ref_A.mt, A=ref_A)
    with parsec_tpu.Context(nb_cores=2) as ctx:
        ctx.add_taskpool(ref_tp)
        assert ref_tp.wait(timeout=120)
    L_ref = np.tril(ref_A.to_array())

    # the port's PTG dynamic path
    P = from_numpy_tiles(host_tiles, nb, nb)
    ptg_tp = cholesky_ptg(use_cuda=True, use_cpu=False, **port_kw).taskpool(
        NT=P.mt, A=P)
    with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
        ctx.add_taskpool(ptg_tp)
        assert ptg_tp.wait(timeout=60)
    L_ptg = np.tril(P.to_array())

    # DTD, with the window below the task count: the inserter executes
    A = from_numpy_tiles(host_tiles, nb, nb)
    ntasks = dpotrf_task_count(A.mt, use_trtri=port_kw.get("use_trtri", False))
    mca_param.set_param("dtd", "window_size", 8)
    mca_param.set_param("dtd", "threshold_size", 4)
    kernels.reset_counts()
    try:
        with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
            dev = _cuda_dev(ctx)
            tp = port_dsl.DTDTaskpool(ctx)
            assert insert_dpotrf(tp, A, **port_kw) == ntasks
            assert ntasks > tp.window
            tp.flush_all()
            tp.close()
            assert ctx.wait(timeout=120)
            assert not tp.failed
            executed = dev.stats["executed_tasks"]
    finally:
        mca_param.params.unset("dtd", "window_size")
        mca_param.params.unset("dtd", "threshold_size")
    L = np.tril(A.to_array())

    assert executed == tp.nb_retired == ntasks  # every task on the CUDA module
    nt = A.mt
    assert kernels.matmul_update.calls == nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    trtri = port_kw.get("use_trtri", False)
    assert kernels.matmul.calls == (nt * (nt - 1) // 2 if trtri else 0)
    assert torch.equal(torch.from_numpy(L), torch.from_numpy(L_ptg))
    scale = np.abs(L_ref).max()
    assert np.abs(L - L_ref).max() / scale < ref_bound
    err = np.abs(L @ L.T - S).max() / np.abs(S).max()
    assert err < bound, err


def test_dtd_dpotrf_host_bodies_match_reference_bitwise():
    """Host chores only (a host-only context): the port's DTD dpotrf does
    the reference's numpy arithmetic in the same order."""
    n, nb = 128, 32
    S = _spd(n, dtype=np.float64, seed=4)
    ref_A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
    tiles0 = {k: np.array(ref_A.data_of(*k).newest_copy().payload)
              for k in ref_A.tiles()}
    with parsec_tpu.Context(nb_cores=3) as ctx:
        tp = ref_cholesky_ptg(use_tpu=False).taskpool(NT=ref_A.mt, A=ref_A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    A = from_numpy_tiles(tiles0, nb, nb)
    with parsec_tpu_torch.Context(nb_cores=3, devices=["cpu"]) as ctx:
        tp = port_dsl.DTDTaskpool(ctx)
        insert_dpotrf(tp, A)
        tp.flush_all()
        tp.close()
        assert ctx.wait(timeout=60)
    assert np.array_equal(np.tril(A.to_array()), np.tril(ref_A.to_array()))


# ---------------------------------------------------------------------------
# ptg_to_dtd (the reference's test_jdf.py replay case is in
# test_torch_jdf.py; tests/collections/test_qr.py's here)
# ---------------------------------------------------------------------------

def test_qr_via_dtd_replay():
    """The DTD replay honors per-flow NEW shapes ([type=QSHAPE2]); its
    factor equals the reference replay's bit for bit."""
    from parsec_tpu.dsl.ptg_to_dtd import replay_via_dtd as ref_replay_via_dtd
    from parsec_tpu.ops.qr import qr_ptg as ref_qr_ptg
    from parsec_tpu_torch.ops.qr import qr_ptg

    n, nb = 96, 32
    rng = np.random.default_rng(11)
    A0 = rng.standard_normal((n, n))
    consts = dict(TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float64,
                  QSHAPE2=(np.float64, (2 * nb, 2 * nb)))
    ref_A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(A0)
    with parsec_tpu.Context(nb_cores=4) as ctx:
        ref_replay_via_dtd(
            ref_qr_ptg(use_tpu=False, use_cpu=True).taskpool(
                NT=ref_A.mt, A=ref_A, **consts), ctx)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(A0)
    with parsec_tpu_torch.Context(nb_cores=4, devices=["cpu"]) as ctx:
        port_dsl.replay_via_dtd(
            qr_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A, **consts),
            ctx)
    R = np.triu(A.to_array())
    assert np.array_equal(R, np.triu(ref_A.to_array()))
    np.testing.assert_allclose(np.abs(np.diag(R)),
                               np.abs(np.diag(np.linalg.qr(A0)[1])), rtol=1e-9)
