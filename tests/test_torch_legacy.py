"""The port's legacy ASYNC-chore protocol (ROADMAP A.10a) and the native
engine's vpmaps against the JAX package's.

* ``NativeGraph.run_async`` / ``task_done`` (parsec_tpu_torch.native): the
  ASYNC hand-over from another thread, the double-completion guard, a
  raising body reported ASYNC (never "done": its successors are released
  once), an unknown id, a closed graph, the NATIVE_TASK_DONE site — each
  held to the reference's ``NativeGraph`` on the same graph;
* dpotrf through ``NativeExecutor(native_device=True)`` on the CUDA module
  bound to the torch CPU device under ``runtime_native_sched=off`` and
  under ``device_cuda_eager_complete=0``: ``torch.equal`` to the pump's
  factor (the same bodies in the same per-tile order), one trampoline
  entry and one completion callback a task; within the reference
  test's 1e-10 of ``S`` and of the JAX package's legacy factor in float64;
* mixed DAGs (``tests/dsl/test_native_device.py:133``): a CPU-only class
  runs on the host through the ``Data`` staging discipline, its newer host
  version survives the device's detach; a dpotrf whose ``potrf`` class
  has no CUDA body, within 1e-3 of the pump's factor (PERF.md §2's
  gate); a fused run retires each region with one ``task_done``;
* contained failure (``:162``): a raising device body or host body fails
  the run loudly;
* the hierarchical steal (``tests/dsl/test_native_sched.py:168``) and
  ``runtime_vpmap`` on every native run.

Every run goes through :func:`_within`, so a hang fails its test instead
of stalling the suite.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu import native as ref_native  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import native_exec as ref_native_exec  # noqa: E402
from parsec_tpu.dsl.dtd import stage_to_cpu as ref_stage  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.ops.cholesky import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import AccessMode, DEV_CUDA, mca_param, native  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import PTG  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor, run_native  # noqa: E402
from parsec_tpu_torch.dsl.ptg import stage_to_cpu  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count  # noqa: E402
from parsec_tpu_torch.profiling import pins  # noqa: E402

#: seconds any one run may take before its test fails as hung
RUN_LIMIT = 120


def _within(fn, limit=RUN_LIMIT):
    """Run ``fn`` on a daemon thread; fail the test if it does not return
    within ``limit`` seconds (a deadlocked run then fails this test and
    leaves the suite going).  Returns ``fn``'s result or re-raises."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed below
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(limit)
    if th.is_alive():
        pytest.fail(f"run did not finish within {limit} s (hang)")
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture
def cpu_device():
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


@pytest.fixture
def port_param():
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


# ---------------------------------------------------------------------------
# NativeGraph.run_async / task_done
# ---------------------------------------------------------------------------

def _chain_graph(m, n=6):
    """A chain 0 -> 1 -> ... -> n-1 in package ``m``'s NativeGraph."""
    g = m.NativeGraph()
    ids = [g.add_task(0, i) for i in range(n)]
    for a, b in zip(ids, ids[1:]):
        g.add_dep(a, b)
    for i in ids:
        g.commit(i)
    g.seal()
    return g, ids


@pytest.mark.parametrize("m", [ref_native, native], ids=["ref", "port"])
def test_run_async_completes_from_another_thread(m):
    """Odd tasks go ASYNC and complete from a helper thread: the chain
    still runs in order, every task once."""
    g, ids = _chain_graph(m, 8)
    order = []
    lock = threading.Lock()

    def body(tid, tag):
        with lock:
            order.append(tag)
        if tag % 2:
            threading.Timer(0.01, g.task_done, args=(tid,)).start()
            return True
        return False

    assert _within(lambda: g.run_async(body, nthreads=3)) == 8
    assert order == list(range(8)) and g.double_completes == 0
    g.close()


def test_double_release_guard_matches_reference():
    """A second completion signal for one task is refused (False) and
    counted, an unknown id raises, a closed graph answers False — in both
    packages, and the NATIVE_TASK_DONE payloads agree."""
    seen = []
    for m, p in ((ref_native, ref_pins), (native, pins)):
        got = []
        cb = lambda es, payload: got.append((payload["task"], payload["accepted"]))  # noqa: E731
        p.subscribe(p.NATIVE_TASK_DONE, cb)
        try:
            g, ids = _chain_graph(m, 3)
            signals = []

            def body(tid, tag):
                if tag == 1:
                    signals.append(g.task_done(tid))
                    signals.append(g.task_done(tid))  # the double release
                    return True
                return False

            assert _within(lambda: g.run_async(body, nthreads=2)) == 3
            with pytest.raises(ValueError, match="unknown task id"):
                g.task_done(99)
            dc = g.double_completes
            g.close()
            signals.append(g.task_done(ids[0]))  # closed graph
        finally:
            p.unsubscribe(p.NATIVE_TASK_DONE, cb)
        seen.append((signals, dc, got))
    assert seen[0] == seen[1] == ([True, False, False], 1, [(1, True), (1, False)])


@pytest.mark.parametrize("m", [ref_native, native], ids=["ref", "port"])
def test_raising_body_after_its_own_task_done_releases_once(m):
    """A body that completed its task through task_done and then raised
    (an inline manager drain does exactly that) is reported ASYNC: the
    successor is not released a second time, the run fails and the error
    re-raises."""
    g, ids = _chain_graph(m, 3)
    ran = []

    def body(tid, tag):
        ran.append(tag)
        if tag == 0:
            g.task_done(tid)
            raise KeyError("after completion")
        return False

    with pytest.raises(KeyError, match="after completion"):
        _within(lambda: g.run_async(body, nthreads=2))
    assert g.double_completes == 0 and ran.count(0) == 1
    g.close()


@pytest.mark.parametrize("m", [ref_native, native], ids=["ref", "port"])
def test_async_task_never_completed_with_failure_does_not_hang(m):
    """A body that raises before any completion fails the graph: the run
    returns (raising) instead of waiting for the completion."""
    g, ids = _chain_graph(m, 4)

    def body(tid, tag):
        if tag == 2:
            raise RuntimeError("boom")
        return False

    with pytest.raises(RuntimeError, match="boom"):
        _within(lambda: g.run_async(body, nthreads=2))
    g.close()


# ---------------------------------------------------------------------------
# dpotrf under the legacy protocol
# ---------------------------------------------------------------------------

def _spd(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


def _dpotrf(S, nb, *, trtri=False, kernels=True, mixed=False, fusion=None):
    """One native-device dpotrf of ``S``; returns (factor, tasks reported,
    executor stats, device stats, pump?, the pool)."""
    n = S.shape[0]
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=S.dtype).from_array(S)
    ptg = cholesky_ptg(use_kernels=kernels, use_trtri=trtri)
    if mixed:
        del ptg.classes["potrf"].bodies[DEV_CUDA]
    consts = {"TILE_SHAPE": (nb, nb), "TILE_DTYPE": S.dtype} if trtri else {}
    tp = ptg.taskpool(NT=A.mt, A=A, **consts)
    ex = NativeExecutor(tp, native_device=True, fusion=fusion)
    try:
        ran = _within(lambda: ex.run(nthreads=4))
        stats = dict(ex.stats)
    finally:
        ex.close()
    return A, ran, stats, dict(ex.device.stats), ex._pump, tp


@pytest.mark.parametrize("trtri", [False, True], ids=["kernels", "kernels_trtri"])
@pytest.mark.parametrize("protocol", ["native_sched_off", "eager_complete_0"])
def test_legacy_dpotrf_equals_the_pump(protocol, trtri, cpu_device, port_param):
    S = _spd(192)
    A0, ran0, st0, _, pump, _ = _dpotrf(S, 32, trtri=trtri)
    assert pump and st0["trampoline_entries"] == st0["completion_callbacks"] == 0
    if protocol == "native_sched_off":
        port_param("runtime", "native_sched", "off")
    else:
        port_param("device", "cuda_eager_complete", 0)
    A, ran, st, dev, pump, tp = _dpotrf(S, 32, trtri=trtri)
    n_tasks = dpotrf_task_count(6, use_trtri=trtri)
    assert not pump and ran == ran0 == n_tasks
    assert torch.equal(torch.from_numpy(A.to_array()), torch.from_numpy(A0.to_array()))
    # two interpreter entries a task, none for dependency bookkeeping
    assert st["trampoline_entries"] == st["completion_callbacks"] == n_tasks
    assert st["pop_batches"] == st["done_batches"] == 0
    assert dev["executed_tasks"] == n_tasks and tp.nb_retired == n_tasks


def test_legacy_dpotrf_matches_the_jax_packages_legacy_run(cpu_device, port_param):
    """float64, the CUDA-module bodies (torch) against the reference's
    legacy run on its TPU module (jnp): within the reference test's 1e-10
    of S and of each other."""
    S = _spd(128, np.float64, seed=1)
    port_param("runtime", "native_sched", "off")
    A, ran, st, _, pump, _ = _dpotrf(S, 16, kernels=False)
    ref_mca_param.set_param("runtime", "native_sched", "off")
    try:
        RA = RefTiledMatrix(128, 128, 16, 16, name="A", dtype=np.float64).from_array(S)
        tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False).taskpool(NT=RA.mt, A=RA)
        ex = ref_native_exec.NativeExecutor(tp, native_device=True)
        assert not ex._pump
        assert _within(lambda: ex.run(nthreads=4)) == ran == 120
        ref_stats = dict(ex.stats)
    finally:
        ref_mca_param.unset("runtime", "native_sched")
    L = np.tril(A.to_array())
    np.testing.assert_allclose(L @ L.T, S, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(L, np.tril(RA.to_array()), rtol=1e-10, atol=1e-10)
    assert st["completion_callbacks"] == ref_stats["completion_callbacks"] == 120


def test_legacy_fused_regions_retire_with_one_task_done(cpu_device, port_param):
    S = _spd(192, seed=2)
    A0 = _dpotrf(S, 32)[0]
    port_param("runtime", "native_sched", "off")
    A, ran, st, dev, pump, _ = _dpotrf(S, 32, fusion="auto")
    assert not pump and ran == 56
    assert dev["fused_submits"] > 0
    # one trampoline entry and one task_done per native node: a region
    # counts once, its members retire together
    nodes = 56 - dev["fused_tasks"] + dev["fused_submits"]
    assert st["trampoline_entries"] == st["completion_callbacks"] == nodes < 56
    assert torch.equal(torch.from_numpy(A.to_array()), torch.from_numpy(A0.to_array()))


# ---------------------------------------------------------------------------
# mixed CPU/device DAGs
# ---------------------------------------------------------------------------

def _mixed_pool(m, LC, P):
    coll = LC("B", shape=(4,), dtype=np.float32)
    ptg = P("mixed_native")
    d = ptg.task_class("d", i="0 .. 3")
    d.affinity("B(i)")
    d.flow("X", AccessMode.INOUT, "<- B(i)", "-> X c(i)")
    c = ptg.task_class("c", i="0 .. 3")
    c.affinity("B(i)")
    c.flow("X", AccessMode.INOUT, "<- X d(i)", "-> B(i)")
    c.body(cpu=_cpu_times_three)
    return ptg, coll, d


def _cpu_times_three(X, i):
    X *= 3.0


def test_mixed_dag_stays_coherent(cpu_device):
    """A device class feeding a CPU-only class, in both packages: the host
    body reads the device's version, and the device's detach does not
    roll the newer host version back (the write-back version guard)."""
    ptg, coll, d = _mixed_pool(None, RefLocalCollection, RefPTG)
    d.body(tpu=lambda X, i: X + 2.0)
    assert _within(lambda: ref_native_exec.run_native(
        ptg.taskpool(B=coll), nthreads=2, native_device=True)) == 8
    want = [np.array(ref_stage(coll.data_of(i))) for i in range(4)]

    ptg, coll, d = _mixed_pool(None, LocalCollection, PTG)
    d.body(cuda=lambda X, i: X + 2.0)
    tp = ptg.taskpool(B=coll)
    ex = NativeExecutor(tp, native_device=True)
    assert not ex._pump  # a host class rules the pump out
    try:
        assert _within(lambda: ex.run(nthreads=2)) == 8
        versions = [coll.data_of(i).get_copy(0).version for i in range(4)]
        assert all(coll.data_of(i).newest_copy().device_index == 0 for i in range(4))
    finally:
        ex.close()
    for i in range(4):
        host = coll.data_of(i).get_copy(0)
        assert host.version == versions[i]
        np.testing.assert_array_equal(stage_to_cpu(coll.data_of(i)), 6.0)
        assert np.array_equal(host.payload, want[i])
    assert ex.stats["trampoline_entries"] == 8 and ex.stats["completion_callbacks"] == 4


def test_mixed_dpotrf_host_potrf(cpu_device):
    """dpotrf with the potrf class's CUDA body taken away: its tasks run on
    the host, the rest through the B1 wrappers; within 1e-3 of the pump's
    factor (PERF.md §2), and the host versions of the diagonal tiles
    survive the detach."""
    S = _spd(192, seed=3)
    A0 = _dpotrf(S, 32)[0].to_array()
    n = S.shape[0]
    A = TiledMatrix(n, n, 32, 32, name="A", dtype=np.float32).from_array(S)
    ptg = cholesky_ptg(use_kernels=True)
    del ptg.classes["potrf"].bodies[DEV_CUDA]
    ex = NativeExecutor(ptg.taskpool(NT=A.mt, A=A), native_device=True)
    try:
        assert _within(lambda: ex.run(nthreads=4)) == 56
        diag = {k: (A.data_of(k, k).get_copy(0).version,
                    np.array(A.data_of(k, k).get_copy(0).payload)) for k in range(6)}
        assert all(A.data_of(k, k).newest_copy().device_index == 0 for k in range(6))
    finally:
        ex.close()
    for k, (v, tile) in diag.items():
        assert A.data_of(k, k).get_copy(0).version == v
        assert np.array_equal(A.data_of(k, k).get_copy(0).payload, tile)
    L = A.to_array()
    assert np.abs(L - A0).max() / np.abs(A0).max() < 1e-3
    Lt = np.tril(L).astype(np.float64)
    assert np.abs(Lt @ Lt.T - S).max() / np.abs(S).max() < 1e-3
    assert ex.stats["trampoline_entries"] == 56
    assert ex.stats["completion_callbacks"] == 56 - 6
    assert ex.device.stats["executed_tasks"] == 50


# ---------------------------------------------------------------------------
# contained failure
# ---------------------------------------------------------------------------

def _boom(X, i):
    raise RuntimeError("device body exploded")


@pytest.mark.parametrize("protocol", ["native_sched_off", "eager_complete_0", "mixed"])
def test_failure_contained(protocol, cpu_device, port_param):
    """A raising body fails the legacy run loudly instead of hanging the
    workers on a completion that never comes."""
    coll = LocalCollection("A", shape=(4,), dtype=np.float32)
    ptg = PTG("boom_native")
    tc = ptg.task_class("t", i="0 .. 3")
    tc.affinity("A(i)")
    tc.flow("X", AccessMode.INOUT, "<- A(i)", "-> A(i)")
    if protocol == "mixed":
        tc.body(cpu=_boom)
        other = ptg.task_class("u", i="0 .. 0")
        other.flow("Y", AccessMode.INOUT, "<- A(0)", "-> A(0)")
        other.body(cuda=lambda Y, i: Y)
        match = "device body exploded"
    else:
        tc.body(cuda=_boom)
        if protocol == "native_sched_off":
            port_param("runtime", "native_sched", "off")
        else:
            port_param("device", "cuda_eager_complete", 0)
        match = "native device run failed.*exploded"
    with pytest.raises(RuntimeError, match=match):
        _within(lambda: run_native(ptg.taskpool(A=coll), nthreads=2,
                                   native_device=True))


# ---------------------------------------------------------------------------
# the hierarchical steal and runtime_vpmap
# ---------------------------------------------------------------------------

def _run_fan(m, vpmap):
    ng = m.NativeGraph()
    # a root fanning out to many small tasks: the completing worker keeps
    # one and floods its local heap; the others must steal
    root = ng.add_task(priority=0, user_tag=0)
    for _ in range(200):
        ng.add_dep(root, ng.add_task(priority=0, user_tag=0))
    for tid in range(201):
        ng.commit(tid)
    ng.seal()
    if vpmap is not None:
        ng.set_vpmap(vpmap)

    def body(tid, tag):
        x = 0.0
        for i in range(200):
            x += i * 1.0

    assert _within(lambda: ng.run(body, nthreads=4)) == 201
    out = ng.steals, ng.steals_remote
    ng.close()
    return out


@pytest.mark.parametrize("m", [ref_native, native], ids=["ref", "port"])
def test_hierarchical_steal_vpmap(m):
    """With a vpmap, victims in the same VP are tried first: one VP for
    all makes every steal local, one VP a worker makes every steal cross;
    flat leaves the remote counter unused."""
    s, r = _run_fan(m, [0, 0, 0, 0])
    assert r == 0
    s2, r2 = _run_fan(m, [0, 1, 2, 3])
    assert s2 == r2
    assert _run_fan(m, None)[1] == 0


def _chain_numpy_pool(LC, P):
    coll = LC("D", shape=(3,), dtype=np.float64)
    ptg = P("vp_chain")
    s = ptg.task_class("s", k="0 .. 15")
    s.flow("X", AccessMode.INOUT, "<- (k == 0) ? D(0) : X s(k-1)",
           "-> (k < 15) ? X s(k+1) : D(0)")
    s.body(cpu=_add_k)
    return ptg.taskpool(D=coll), coll


def _add_k(X, k):
    X += k


@pytest.mark.parametrize("spec", ["flat", "nb:2", "0,1;2,3"])
def test_runtime_vpmap_on_every_native_run(spec, cpu_device, port_param):
    """``runtime_vpmap`` reaches the engine on the CPU regime, the pump and
    the legacy run; results equal the flat run's and the reference's."""
    tp, coll = _chain_numpy_pool(RefLocalCollection, RefPTG)
    ref_mca_param.set_param("runtime", "vpmap", spec)
    try:
        _within(lambda: ref_native_exec.run_native(tp, nthreads=4))
    finally:
        ref_mca_param.unset("runtime", "vpmap")
    want = np.array(coll.data_of(0).newest_copy().payload)
    port_param("runtime", "vpmap", spec)
    tp, coll = _chain_numpy_pool(LocalCollection, PTG)
    _within(lambda: run_native(tp, nthreads=4))
    assert np.array_equal(coll.data_of(0).newest_copy().payload, want)
    S = _spd(96, seed=4)
    got = [_dpotrf(S, 32)[0].to_array()]
    port_param("runtime", "native_sched", "off")
    got.append(_dpotrf(S, 32)[0].to_array())
    assert np.array_equal(got[0], got[1])


def test_invalid_runtime_vpmap_raises(port_param):
    port_param("runtime", "vpmap", "nb:0")
    tp, _ = _chain_numpy_pool(LocalCollection, PTG)
    with pytest.raises(ValueError, match="invalid runtime_vpmap"):
        run_native(tp, nthreads=2)
