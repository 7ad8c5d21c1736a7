"""The port's NativeDTD (parsec_tpu_torch.dsl.dtd_native: DTD insertion
streamed into the g++-built engine) against the JAX package's.

Every case of the reference's ``tests/dsl/test_dtd_native.py`` runs on
both packages from the same seeded numpy inputs; the arrays they leave
must be ``np.array_equal`` (the same host bodies run in the same
dependency order).  NativeDTD's bodies are host bodies by design: no card
is involved.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from parsec_tpu import native as ref_native  # noqa: E402
from parsec_tpu.dsl import dtd_native as ref_dn  # noqa: E402
from parsec_tpu.utils.mca_param import params as ref_params  # noqa: E402
from parsec_tpu_torch.dsl import dtd_native as port_dn  # noqa: E402
from parsec_tpu_torch.utils.mca_param import params as port_params  # noqa: E402


def both(scenario):
    """``scenario(dn, params)`` on the reference module then the port's;
    the reference half needs its own native core."""
    if not ref_native.available():
        pytest.fail(f"reference native core unavailable: {ref_native.build_error()}")
    return [scenario(ref_dn, ref_params), scenario(port_dn, port_params)]


def assert_same(res):
    ref, port = res
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


def _bump(a):
    a += 1


def _double(a):
    a *= 2


def test_raw_chain_orders():
    """1000-link increment chain on one tile: any misordering changes the
    final value."""
    def scenario(dn, _p):
        x = np.zeros(4)
        with dn.NativeDTD(nthreads=4) as tp:
            for i in range(500):
                tp.insert_task(_bump, (x, dn.INOUT))
                tp.insert_task(_double if i == 249 else _bump, (x, dn.INOUT))
        return [x]

    res = both(scenario)
    assert_same(res)
    want = np.zeros(4)
    for i in range(500):
        want += 1
        want = want * 2 if i == 249 else want + 1
    np.testing.assert_array_equal(res[1][0], want)


def test_readers_run_between_writers():
    """WAR: readers of version k all observe version k even though a later
    writer is already inserted."""
    def scenario(dn, _p):
        x = np.zeros(1)
        seen = []
        lock = threading.Lock()

        def write(a, v):
            a[0] = v

        def read(a):
            with lock:
                seen.append(a[0])

        with dn.NativeDTD(nthreads=4) as tp:
            tp.insert_task(write, (x, dn.INOUT), 1.0)
            for _ in range(8):
                tp.insert_task(read, (x, dn.IN))
            tp.insert_task(write, (x, dn.INOUT), 2.0)
        assert seen == [1.0] * 8
        return [x, seen]

    assert_same(both(scenario))


def _gemm(c, a, b):
    c += a @ b


def test_tiled_gemm_matches_numpy():
    rng = np.random.default_rng(0)
    nt, nb = 4, 32
    n = nt * nb
    A = rng.standard_normal((n, n))
    B = rng.standard_normal((n, n))

    def scenario(dn, _p):
        Ca = [[np.zeros((nb, nb)) for _ in range(nt)] for _ in range(nt)]
        At = [[np.ascontiguousarray(A[i*nb:(i+1)*nb, k*nb:(k+1)*nb]) for k in range(nt)]
              for i in range(nt)]
        Bt = [[np.ascontiguousarray(B[k*nb:(k+1)*nb, j*nb:(j+1)*nb]) for j in range(nt)]
              for k in range(nt)]
        with dn.NativeDTD(nthreads=4) as tp:
            for i in range(nt):
                for j in range(nt):
                    for k in range(nt):
                        tp.insert_task(_gemm, (Ca[i][j], dn.INOUT),
                                       (At[i][k], dn.IN), (Bt[k][j], dn.IN))
        return [np.block(Ca)]

    res = both(scenario)
    assert_same(res)
    np.testing.assert_allclose(res[1][0], A @ B, rtol=1e-10, atol=1e-10)


def test_execution_overlaps_insertion():
    """Streaming: early tasks retire while insertion is still running."""
    def scenario(dn, _p):
        x = np.zeros(1)
        first_done = threading.Event()

        def mark(a):
            a += 1
            first_done.set()

        tp = dn.NativeDTD(nthreads=2)
        tp.insert_task(mark, (x, dn.INOUT))
        assert first_done.wait(timeout=10), "first task did not run before seal"
        y = np.zeros(1)
        tp.insert_task(mark, (y, dn.INOUT))
        assert tp.wait(timeout=30)
        tp.close()
        return [x, y]

    assert_same(both(scenario))


def test_body_error_propagates():
    def scenario(dn, _p):
        def boom(a):
            raise ValueError("native dtd body failed")

        tp = dn.NativeDTD(nthreads=2)
        tp.insert_task(boom, (np.zeros(1), dn.INOUT))
        with pytest.raises(ValueError, match="native dtd body failed"):
            tp.wait()
        return [tp.inserted]

    assert_same(both(scenario))


def _nothing(a):
    return None


def test_insert_after_seal_rejected():
    def scenario(dn, _p):
        tp = dn.NativeDTD(nthreads=1)
        tp.insert_task(_nothing, (np.zeros(1), dn.INOUT))
        assert tp.wait()
        with pytest.raises(RuntimeError, match="sealed"):
            tp.insert_task(_nothing, (np.zeros(1), dn.INOUT))
        tp.close()
        return [tp.inserted]

    assert_same(both(scenario))


def _addself(a, b):
    a += b + 1


def test_same_array_in_two_args_no_self_deadlock():
    """(x, INOUT), (x, IN) must not create a self-edge (which would never
    be satisfied and would hang wait())."""
    def scenario(dn, _p):
        x = np.zeros(2)
        with dn.NativeDTD(nthreads=2) as tp:
            tp.insert_task(_addself, (x, dn.INOUT), (x, dn.IN))
            tp.insert_task(_addself, (x, dn.INOUT), (x, dn.INOUT))
        return [x]

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(res[1][0], [3.0, 3.0])  # 0+0+1, then 1+1+1


def test_dont_track_scratch_and_ctl():
    def scenario(dn, _p):
        x = np.zeros(1)
        order = []

        def writer(a):
            time.sleep(0.02)
            a[0] = 1
            order.append("w")

        def untracked(a, scratch):
            assert scratch.shape == (4,)
            order.append("u")

        with dn.NativeDTD(nthreads=2) as tp:
            tp.insert_task(writer, (x, dn.INOUT))
            # DONT_TRACK: no dependency on the writer; SCRATCH: a per-task
            # buffer, never tracked
            tp.insert_task(untracked, (x, dn.IN | dn.DONT_TRACK),
                           (((4,), np.float64), dn.SCRATCH))
        assert sorted(order) == ["u", "w"]
        # CTL: ordering without a body argument
        y = np.zeros(1)
        seen = []

        def w2(a):
            a[0] = 7

        def ctl_only():
            seen.append(y[0])

        with dn.NativeDTD(nthreads=2) as tp:
            tp.insert_task(w2, (y, dn.INOUT))
            tp.insert_task(ctl_only, (y, dn.CTL_MODE))
        assert seen == [7.0]
        return [x, y, seen]

    assert_same(both(scenario))


def test_window_throttle_bounds_in_flight():
    def scenario(dn, params):
        params.set("dtd", "window_size", 64)
        params.set("dtd", "threshold_size", 32)
        try:
            x = np.zeros(1)
            tp = dn.NativeDTD(nthreads=2)
            for _ in range(1000):
                tp.insert_task(_bump, (x, dn.INOUT))
            assert tp.wait(timeout=60)
            # retired closures are freed (memory bounded by the window)
            assert all(b is None for b in tp._bodies)
            tp.close()
            return [x]
        finally:
            params.set("dtd", "window_size", 2048)
            params.set("dtd", "threshold_size", 1024)

    res = both(scenario)
    assert_same(res)
    assert res[1][0][0] == 1000
