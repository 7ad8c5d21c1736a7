"""The port's native engine (parsec_tpu_torch.native, dsl.graph and
dsl.native_exec) against the JAX package's.

* capture: the port's captured DAG equals ``parsec_tpu.dsl.graph.capture``
  node for node (priorities, in-edge counts, out-edges, flow sources,
  write-backs) for dpotrf, flash attention and the stencil;
* the CPU trampoline (``run_native`` with CPU bodies) lands tiles
  bit-identical to the reference's ``run_native``;
* the pump (``native_device=True``) on the port's CUDA device module bound
  to the torch CPU device (``PARSEC_MCA_device_cuda_torch_device=cpu``;
  the kernel wrappers take their plain versions) gives tiles bit-identical
  to the port's dynamic path under four seeded pop orders, within the
  reference pump's 2e-3 (tests/test_torch_cholesky.py's bound), with no
  per-task interpreter entry;
* ``run_flash_attention_native`` is bit-identical to the port's
  ``run_flash_attention`` and within 2e-5 of the reference's native run;
* failures are loud: a raising body, each unported hook, a failed g++
  build;
* the ABI spec matches the reference's, the sources and the built library.

The library is built by g++ from ``native/src/*.cpp`` into
``parsec_tpu_torch/_build/`` on first use (a few seconds).
"""

import ctypes
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu_torch  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import graph as ref_graph  # noqa: E402
from parsec_tpu.dsl import native_exec as ref_native_exec  # noqa: E402
from parsec_tpu.native import abi as ref_abi  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu_torch import AccessMode, mca_param, native  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import PTG, graph  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor, run_native  # noqa: E402
from parsec_tpu_torch.native import abi  # noqa: E402
from parsec_tpu_torch.ops import (  # noqa: E402
    attention,
    cholesky_ptg,
    dpotrf_task_count,
    kernels,
    stencil,
)
from parsec_tpu_torch.profiling import pins  # noqa: E402

SEEDS = (0, 1, 7, 42)  # the reference's four schedule-explorer seeds
# |LL^T - S| and port-vs-reference bound of the f32 kernel variants
# (tests/test_torch_cholesky.py, from tests/dsl/test_xla_lower.py:95-96)
TOL_DPOTRF = 2e-3
# tests/runtime/test_attention_graph.py's f32 bound (allclose: atol = rtol)
TOL_ATTN = 2e-5


def _spd(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


@pytest.fixture
def cpu_device():
    """Bind the pump's CUDA device module to the torch CPU device."""
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


@pytest.fixture
def port_param():
    """Set port MCA params for one test; unset them after."""
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


# -- capture parity -----------------------------------------------------------

def _dpotrf_pools(trtri):
    n, nb = 96, 24
    S = _spd(n, np.float64, seed=5)
    consts = {"TILE_SHAPE": (nb, nb), "TILE_DTYPE": np.float64} if trtri else {}
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
    mine = cholesky_ptg(use_trtri=trtri).taskpool(NT=A.mt, A=A, **consts)
    rA = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
    theirs = ref_cholesky_ptg(use_trtri=trtri).taskpool(NT=rA.mt, A=rA, **consts)
    return mine, theirs


def _attention_pools(causal):
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 40, 2, 8)).astype(np.float32) for _ in range(3))
    mine, _ = attention.build_flash_attention(
        q, k, v, causal=causal, q_block=16, kv_block=8)
    theirs, _ = ref_attention.build_flash_attention(
        q, k, v, causal=causal, q_block=16, kv_block=8)
    return mine, theirs


def _stencil_pools():
    grid = np.random.default_rng(1).standard_normal((24, 36))
    mine = stencil.stencil_ptg().taskpool(
        T=3, MT=3, NT=3, A=stencil.StencilBuffers(grid, 3, 3))
    theirs = ref_stencil.stencil_ptg().taskpool(
        T=3, MT=3, NT=3, A=ref_stencil.StencilBuffers(grid, 3, 3))
    return mine, theirs


_CAPTURE_CASES = {
    "dpotrf": lambda: _dpotrf_pools(False),
    "dpotrf_trtri": lambda: _dpotrf_pools(True),
    "attention": lambda: _attention_pools(False),
    "attention_causal": lambda: _attention_pools(True),
    "stencil": _stencil_pools,
}


def _graph_view(g):
    return {tid: (n.priority, n.rank, n.in_edges, n.remote_out,
                  list(n.out_edges), dict(n.flow_sources), list(n.write_backs))
            for tid, n in g.nodes.items()}


@pytest.mark.parametrize("case", sorted(_CAPTURE_CASES))
def test_capture_matches_reference(case):
    mine_tp, theirs_tp = _CAPTURE_CASES[case]()
    mine = mine_tp.capture()
    theirs = ref_graph.capture(theirs_tp)
    assert list(mine.nodes) == list(theirs.nodes)  # same set, same order
    assert _graph_view(mine) == _graph_view(theirs)
    assert mine.global_ranks == theirs.global_ranks
    assert graph.find_cycle(mine) == []
    for tid, node in mine.nodes.items():
        for fname in node.flow_sources:
            assert graph.source_tile(mine, tid, fname) == \
                ref_graph.source_tile(theirs, tid, fname)


def test_find_cycle_names_a_cycle():
    ptg = PTG("loop")
    a = ptg.task_class("a", k="0 .. 1")
    a.flow("X", AccessMode.INOUT, "<- X a((k + 1) % 2)", "-> X a((k + 1) % 2)")
    a.body(cpu=lambda X, k: None)
    g = ptg.taskpool().capture()
    cyc = graph.find_cycle(g)
    assert sorted(cyc) == [("a", (0,)), ("a", (1,))]


# -- the CPU trampoline -------------------------------------------------------

def test_cpu_trampoline_dpotrf_bit_identical_to_reference():
    n, nb = 128, 16  # 8 x 8 tiles: 120 tasks
    S = _spd(n, np.float64)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
    tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
    ex = NativeExecutor(tp)
    try:
        ran = ex.run(nthreads=4)
        stats = dict(ex.stats)
    finally:
        ex.close()
    rA = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
    ref_ran = ref_native_exec.run_native(
        ref_cholesky_ptg(use_tpu=False, use_cpu=True).taskpool(NT=rA.mt, A=rA),
        nthreads=4)
    assert ran == ref_ran == 120
    assert stats["trampoline_entries"] == 120 and stats["pop_batches"] == 0
    np.testing.assert_array_equal(A.to_array(), rA.to_array())


def test_cpu_trampoline_stencil_bit_identical_to_reference():
    grid = np.random.default_rng(1).standard_normal((24, 36))
    mt, nt, iters = 3, 3, 4
    A = stencil.StencilBuffers(grid, mt, nt)
    ran = stencil.stencil_ptg().taskpool(T=iters, MT=mt, NT=nt, A=A).run_native(nthreads=4)
    rA = ref_stencil.StencilBuffers(grid, mt, nt)
    ref_ran = ref_native_exec.run_native(
        ref_stencil.stencil_ptg().taskpool(T=iters, MT=mt, NT=nt, A=rA), nthreads=4)
    assert ran == ref_ran == iters * mt * nt
    np.testing.assert_array_equal(A.to_array(iters % 2), rA.to_array(iters % 2))
    np.testing.assert_allclose(A.to_array(iters % 2),
                               stencil.reference_stencil(grid, iters), rtol=1e-12)


# -- the pump on the CUDA device module (torch CPU device) ---------------------

_PUMP_VARIANTS = {
    "kernels": (dict(use_kernels=True), dict(use_pallas=True)),
    "kernels_trtri": (dict(use_kernels=True, use_trtri=True),
                      dict(use_pallas=True, use_trtri=True)),
}
_N, _NB = 128, 32
_dynamic_cache = {}


def _dynamic_factor(variant, S):
    """The port's dynamic-path factor of ``S`` (Context/add_taskpool/wait
    on the CUDA module bound to the torch CPU device) and the reference
    pump's factor, once per variant."""
    if variant not in _dynamic_cache:
        port_kw, ref_kw = _PUMP_VARIANTS[variant]
        A = TiledMatrix(_N, _N, _NB, _NB, name="A", dtype=np.float32).from_array(S)
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **port_kw).taskpool(NT=A.mt, A=A)
        with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120), tp.fail_reason
        rA = RefTiledMatrix(_N, _N, _NB, _NB, name="A", dtype=np.float32).from_array(S)
        ref_tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False, **ref_kw).taskpool(
            NT=rA.mt, A=rA)
        ref_native_exec.run_native(ref_tp, native_device=True)
        _dynamic_cache[variant] = (A.to_array(), rA.to_array())
    return _dynamic_cache[variant]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", sorted(_PUMP_VARIANTS))
def test_pump_dpotrf_bit_identical_to_dynamic_path(variant, seed, cpu_device, port_param):
    port_kw, _ = _PUMP_VARIANTS[variant]
    S = _spd(_N, seed=3)
    dynamic, reference = _dynamic_factor(variant, S)
    A = TiledMatrix(_N, _N, _NB, _NB, name="A", dtype=np.float32).from_array(S)
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, **port_kw).taskpool(NT=A.mt, A=A)
    port_param("sched", "rnd_seed", seed)
    kernels.reset_counts()
    ex = NativeExecutor(tp, native_device=True)
    try:
        assert ex.device.tdev == torch.device("cpu")
        ran = ex.run()
        stats, dev_stats = dict(ex.stats), dict(ex.device.stats)
    finally:
        ex.close()
    trtri = port_kw.get("use_trtri", False)
    ntasks = dpotrf_task_count(A.mt, use_trtri=trtri)
    assert ran == ntasks == dev_stats["executed_tasks"] == stats["pumped_tasks"]
    assert tp.nb_retired == ntasks
    # the zero-interpreter pin: no trampoline, no completion callback
    assert stats["trampoline_entries"] == stats["completion_callbacks"] == 0
    assert 0 < stats["pop_batches"] == stats["done_batches"] <= ntasks
    nt = A.mt
    assert kernels.matmul_update.calls == nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    assert kernels.matmul.calls == (nt * (nt - 1) // 2 if trtri else 0)
    L = A.to_array()
    np.testing.assert_array_equal(L, dynamic)
    Lr = np.tril(L)
    scale = np.abs(reference).max()
    assert np.abs(Lr - np.tril(reference)).max() / scale < TOL_DPOTRF
    np.testing.assert_allclose(Lr @ Lr.T, S, rtol=TOL_DPOTRF, atol=TOL_DPOTRF)


def test_pump_seeded_orders_actually_differ(cpu_device, port_param):
    """Different seeds give different dispatch orders through the native
    queue (identical results mean something only if the schedules
    explored are distinct), and the same seed replays its order."""
    orders = []
    for s in SEEDS + (SEEDS[0],):
        S = _spd(128, seed=2)
        A = TiledMatrix(128, 128, 16, 16, name="A", dtype=np.float32).from_array(S)
        tp = cholesky_ptg(use_cuda=True, use_cpu=False).taskpool(NT=A.mt, A=A)
        order = []
        cb = lambda es, task: order.append(repr(task))  # noqa: E731
        pins.subscribe(pins.EXEC_BEGIN, cb)
        port_param("sched", "rnd_seed", s)
        try:
            assert run_native(tp, native_device=True) == 120
        finally:
            pins.unsubscribe(pins.EXEC_BEGIN, cb)
        assert len(order) == 120
        orders.append(tuple(order))
    assert orders[-1] == orders[0]
    assert len(set(orders[:-1])) >= 2, "seeds did not perturb the native queue"


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_native_bit_identical_to_dynamic(causal, cpu_device):
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 48, 2, 16)).astype(np.float32) for _ in range(3))
    kw = dict(causal=causal, q_block=16, kv_block=16)
    kernels.reset_counts()
    out = attention.run_flash_attention_native(q, k, v, **kw)
    steps = kernels.flash_attention_block.calls
    assert steps == attention.attention_task_count(1, 48, 48, 2, 16, 16, causal=causal) - 2 * 3
    with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
        dynamic = attention.run_flash_attention(ctx, q, k, v, use_cpu=False, **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    assert torch.equal(out, dynamic)
    theirs = ref_attention.run_flash_attention_native(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), rtol=TOL_ATTN, atol=TOL_ATTN)


def test_flash_attention_native_rejects_host_options():
    with pytest.raises(ValueError, match="use_cpu"):
        attention.run_flash_attention_native(None, None, None, use_cpu=True)


@pytest.mark.parametrize("regime", ["cpu", "pump"])
def test_cross_tile_write_back_lands_home(regime, cpu_device):
    """A flow whose chain starts at D(k) and ends at E(k) lands in E(k)'s
    host tile at its producer's retirement (the pump: ``land_into_home``
    from the device copy), as on the dynamic path."""
    ptg = PTG("wb")
    s = ptg.task_class("s", k="0 .. 2")
    s.flow("X", AccessMode.INOUT, "<- D(k)", "-> E(k)")

    def cpu(X, k):
        X *= 2
        X += k

    s.body(**({"cpu": cpu} if regime == "cpu" else
              {"cuda": lambda X, k: X * 2 + k}))

    def pool():
        return ptg.taskpool(
            D=LocalCollection("D", shape=(3,), init=lambda k: np.arange(3.0) + k),
            E=LocalCollection("E", shape=(3,)))

    native_tp, dynamic_tp = pool(), pool()
    assert run_native(native_tp, native_device=regime == "pump") == 3
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        ctx.add_taskpool(dynamic_tp)
        assert dynamic_tp.wait(timeout=30), dynamic_tp.fail_reason
    for k in range(3):
        want = (np.arange(3.0) + k) * 2 + k
        for tp in (native_tp, dynamic_tp):
            home = tp.constants["E"].data_of(k).get_copy(0)
            np.testing.assert_array_equal(home.payload, want)
            np.testing.assert_array_equal(
                tp.constants["D"].data_of(k).newest_copy().payload, want)


# -- failures -------------------------------------------------------------------

def _boom_pool(device_body):
    ptg = PTG("boom")
    s = ptg.task_class("s", k="0 .. 3")
    s.flow("X", AccessMode.INOUT, "<- (k == 0) ? D(0) : X s(k-1)",
           "-> (k < 3) ? X s(k+1) : D(0)")

    def body(X, k):
        if k == 2:
            raise ValueError("boom")
        return X + 1 if device_body else None

    s.body(**({"cuda": body} if device_body else {"cpu": body}))
    return ptg.taskpool(D=LocalCollection("D", shape=(2,)))


def test_raising_cpu_body_fails_the_run():
    with pytest.raises(ValueError, match="boom"):
        run_native(_boom_pool(False))


def test_raising_device_body_fails_the_pump(cpu_device):
    with pytest.raises(RuntimeError, match="native device run failed.*boom"):
        run_native(_boom_pool(True), native_device=True)


def _device_dpotrf():
    A = TiledMatrix(64, 64, 32, 32, name="A", dtype=np.float32).from_array(_spd(64))
    return cholesky_ptg(use_cuda=True, use_cpu=False).taskpool(NT=A.mt, A=A)


def _unported_hook(case, port_param):
    """Arrange one unported hook; returns (callable, ROADMAP item)."""
    if case == "fusion_arg":
        return lambda: NativeExecutor(_device_dpotrf(), native_device=True,
                                      fusion="chains"), "A.4"
    if case == "fusion_param":
        port_param("runtime", "fusion", "auto")
        return lambda: NativeExecutor(_device_dpotrf(), native_device=True), "A.4"
    if case == "native_sched_off":
        port_param("runtime", "native_sched", "off")
        return lambda: run_native(_device_dpotrf(), native_device=True), "A.10"
    if case == "eager_complete_0":
        port_param("device", "cuda_eager_complete", 0)
        return lambda: run_native(_device_dpotrf(), native_device=True), "A.10"
    if case == "cpu_only_class":
        A = TiledMatrix(64, 64, 32, 32, name="A", dtype=np.float64).from_array(
            _spd(64, np.float64))
        tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
        return lambda: run_native(tp, native_device=True), "A.10"
    if case == "taskpool_list":
        return lambda: run_native([_device_dpotrf(), _device_dpotrf()]), "A.9"
    assert case == "dep_decrement_observer"

    def run():
        cb = lambda es, payload: None  # noqa: E731
        pins.subscribe(pins.DEP_DECREMENT, cb)
        try:
            run_native(_device_dpotrf(), native_device=True)
        finally:
            pins.unsubscribe(pins.DEP_DECREMENT, cb)
    return run, "A.9"


@pytest.mark.parametrize("case", [
    "fusion_arg", "fusion_param", "native_sched_off", "eager_complete_0",
    "cpu_only_class", "taskpool_list", "dep_decrement_observer"])
def test_unported_native_hooks_raise(case, cpu_device, port_param):
    fn, item = _unported_hook(case, port_param)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        fn()


def test_build_without_sources_raises(tmp_path):
    with pytest.raises(RuntimeError, match="sources missing"):
        native.build_library(str(tmp_path / "src"), str(tmp_path / "build"))


def test_failed_compile_raises_with_compiler_output(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(abi.SRC_DIR, src)
    with open(src / "graph.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build_library(str(src), str(tmp_path / "build"))
    assert "graph.cpp" in str(err.value)
    assert not os.listdir(tmp_path / "build")  # no partial library published


def test_loader_without_library_has_no_fallback(tmp_path, monkeypatch):
    """Pointed at an empty source directory, the loader raises and the
    executor does not carry on by another path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    A = TiledMatrix(64, 64, 32, 32, name="A", dtype=np.float64).from_array(
        _spd(64, np.float64))
    tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
    with pytest.raises(RuntimeError, match="sources missing"):
        tp.run_native()
    with pytest.raises(RuntimeError, match="sources missing"):
        native.NativeGraph()


def test_build_publishes_once_and_reuses(tmp_path):
    out = native.build_library(abi.SRC_DIR, str(tmp_path))
    mtime = os.path.getmtime(out)
    assert native.build_library(abi.SRC_DIR, str(tmp_path)) == out
    assert os.path.getmtime(out) == mtime  # up to date: not rebuilt
    assert os.listdir(tmp_path) == [native.LIB_NAME]


# -- the ABI --------------------------------------------------------------------

def test_abi_spec_matches_reference_and_sources():
    assert list(abi.SPEC) == list(ref_abi.SPEC)
    for name in abi.SPEC:
        assert abi.spec_signature(name) == ref_abi._spec_sig(name), name
        assert abi.SPEC[name]["threads"] == ref_abi.SPEC[name]["threads"], name
    assert abi.parse_source_prototypes() == ref_abi.parse_source_prototypes()
    protos = abi.parse_source_prototypes()
    assert set(protos) == set(abi.SPEC)
    for name in abi.SPEC:
        assert protos[name] == abi.spec_signature(name), name


def test_built_library_exports_every_symbol():
    lib = native.load()
    assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert "native/build" not in lib._name.replace(os.sep, "/")
    for name in abi.required_symbols():
        fn = getattr(lib, name)
        ent = abi.SPEC[name]
        assert fn.restype == abi.TOKENS[ent["ret"]][0], name
        assert list(fn.argtypes) == [abi.TOKENS[t][0] for t in ent["args"]], name


def test_native_graph_pump_control_plane():
    """pop_batch/done_batch by hand: priority order, successor release,
    quiescence, and a second completion of one task refused."""
    g = native.NativeGraph()
    try:
        g.sched_config()
        a, b, c = g.add_task(1), g.add_task(5), g.add_task(9)
        g.add_dep(a, c)
        for t in (a, b, c):
            g.commit(t)
        g.seal()
        buf = (ctypes.c_int64 * 8)()
        n = g.pop_batch(buf)
        assert list(buf[:n]) == [b, a]  # c waits for a
        assert g.done_batch(buf, n) == 2
        assert g.done_batch(buf, 1) == 0  # b already retired
        n = g.pop_batch(buf)
        assert list(buf[:n]) == [c] and not g.quiesced()
        assert g.done_batch(buf, n) == 1
        assert g.quiesced() and g.sched_pending() == 0 and g.executed == 3
    finally:
        g.close()


def test_native_graph_fail_aborts_a_run_that_cannot_finish():
    """A run whose last task is never committed cannot quiesce: fail()
    from another thread makes the idle workers exit, and run() reports
    that the graph did not quiesce instead of waiting forever."""
    import threading

    g = native.NativeGraph()
    try:
        a, b = g.add_task(), g.add_task()
        g.commit(a)  # b is never committed
        g.seal()
        ran, errors = [], []

        def drive():
            try:
                g.run(lambda task_id, _tag: ran.append(task_id), nthreads=2)
            except RuntimeError as e:
                errors.append(e)

        th = threading.Thread(target=drive)
        th.start()
        th.join(timeout=0.3)
        assert th.is_alive()  # waiting on b
        g.fail()
        th.join(timeout=10)
        assert not th.is_alive()
        assert ran == [a] and g.executed == 1
        assert len(errors) == 1 and "did not quiesce" in str(errors[0])
    finally:
        g.close()
