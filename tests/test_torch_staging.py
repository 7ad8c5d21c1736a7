"""The port's asynchronous staging pipeline (parsec_tpu_torch.device.staging,
the transfer engine and batched staging of device/cuda.py, the zone
allocator and the pump's prefetch window) against the JAX package's.

* the :class:`WritebackCommitter` unit surface, run against a stub device
  for BOTH packages' committers (same cases, same expectations): per-tile
  dedup, the drain watermark, ``wait_for``, the version guard, and the
  STICKY failure discipline;
* the device-level contracts of ``tests/runtime/test_staging_pipeline.py``
  on the CUDA module bound to the torch CPU device: ``detach`` commits
  each dirty tile exactly once, custom stage hooks compose with deferred
  write-backs, a packed copy is never flushed home, a committer death
  fails the pool (and ``Context.fini`` / ``NativeExecutor.close``) instead
  of hanging, eviction goes through the committer;
* the explorer digests of ``tests/dsl/test_staging_explorer.py``: stage
  depth {1, 2, 4} x four ``sched_rnd_seed`` x {dpotrf ``kernels``,
  ``kernels_trtri``, flash attention, the stencil} through the pump land
  bit-identical results to depth 1 and to the port's dynamic path, within
  the reference pump's bound (dpotrf, at the same depth) or 2e-5 of the
  reference's ``attention_reference``;
* the zone allocator's own cases (``tests/class/test_native.py``) on both
  packages' bindings, its accounting in the device, and no fallback when
  the library cannot be built.

On the torch CPU device streams, events and pinning are skipped; the lane
and committer threads run as on the card, so their logic is exercised
here.  What only the card shows — copy-stream ordering, pinned buffers —
``chip_smoke.py`` checks (every path ``torch.equal`` across depths).
"""

import threading
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu_torch  # noqa: E402
from parsec_tpu import native as ref_native  # noqa: E402
from parsec_tpu.data import data_create as ref_data_create  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.device import staging as ref_staging  # noqa: E402
from parsec_tpu.dsl import native_exec as ref_native_exec  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu.parallel import attention_reference  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import AccessMode, mca_param, native  # noqa: E402
from parsec_tpu_torch.data import LocalCollection, data_create, host_array  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.device import ADVICE_PREFETCH, ADVICE_WARMUP  # noqa: E402
from parsec_tpu_torch.device import cuda as cuda_mod  # noqa: E402
from parsec_tpu_torch.device import staging  # noqa: E402
from parsec_tpu_torch.dsl import PTG  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import attention, cholesky_ptg, stencil  # noqa: E402
from parsec_tpu_torch.profiling import pins  # noqa: E402

SEEDS = (0, 1, 7, 42)  # the reference's four schedule-explorer seeds
DEPTHS = (1, 2, 4)     # off (the default) / double-buffered / deep window
# tests/test_torch_native.py's bounds: the f32 dpotrf kernel variants
# against the reference's pump, and f32 attention (allclose atol = rtol)
TOL_DPOTRF = 2e-3
TOL_ATTN = 2e-5
INOUT, IN = AccessMode.INOUT, AccessMode.IN


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


@pytest.fixture
def cpu_device(port_param):
    """Bind the pump's CUDA device module to the torch CPU device."""
    port_param("device", "cuda_torch_device", "cpu")


@pytest.fixture
def depth2(port_param):
    """The staging pipeline on (``runtime_stage_depth`` 2; the default is
    1): the lane and the write-back committer armed."""
    port_param("runtime", "stage_depth", 2)


@pytest.fixture
def eager_lane(port_param):
    """Re-slice every first-touch ready wave of four tasks or more, so that
    its later slices go through the transfer lane at these small sizes (at
    the default ``runtime_stage_split_kb`` a wave must stage 256 KiB; the
    oldest batch always stages in its own submit)."""
    port_param("runtime", "stage_split_kb", 0)


def _ctx():
    return parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")


def _spd(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


# -- the committer's unit surface, both packages ---------------------------------

class _StubDev:
    """The exact surface the committer drives: name for the thread,
    data_index for the dirty-copy lookup, the job its spans carry (the
    port's), snapshot/D2H/commit halves."""

    name = "stub"
    data_index = 1
    context = None
    job = 0

    def __init__(self):
        self.commits = []  # (data_id, version) in commit order
        self.fail = None
        self.d2h_calls = 0

    def _wb_snapshot(self, data):
        with data.lock:
            c = data.get_copy(self.data_index)
            if c is None or c.payload is None:
                return None
            hc = data.get_copy(0)
            if hc is not None and hc.payload is not None and hc.version >= c.version:
                return None
            return (c.payload, c.version)

    def _d2h_batch(self, payloads):
        self.d2h_calls += 1
        if self.fail is not None:
            raise self.fail
        return [np.array(p, copy=True) for p in payloads]

    def _commit_host(self, data, version, host):
        with data.lock:
            hc = data.get_copy(0)
            if hc is not None and hc.payload is not None and hc.version >= version:
                return False
            hc = data.attach_copy(0, host)
            hc.version = version
        self.commits.append((data.data_id, version))
        return True


#: impl -> (committer class, data_create) of each package
IMPLS = {"reference": (ref_staging.WritebackCommitter, ref_data_create),
         "port": (staging.WritebackCommitter, data_create)}


def _dirty(impl, key, value, version=2, n=16):
    """A Data whose device copy (index 1) is ``version`` ahead of the host
    copy — what an epilog leaves behind."""
    d = IMPLS[impl][1](key, payload=np.zeros(n))
    c = d.attach_copy(1, np.full(n, float(value)))
    c.version = version
    return d


def _committer(impl):
    dev = _StubDev()
    return dev, IMPLS[impl][0](dev)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_dedup_commits_newest_version_once(impl):
    dev, com = _committer(impl)
    try:
        d = _dirty(impl, "a", 1.0, version=2)
        t1 = com.enqueue(d)
        # re-dirty while pending: ONE entry; the drain snapshots the newest
        with d.lock:
            d.get_copy(1).payload = np.full(16, 9.0)
            d.get_copy(1).version = 3
        assert com.enqueue(d) > t1
        assert com.stats["enqueued"] == 2 and com.pending() == 1
        com.flush()
        assert dev.commits == [(d.data_id, 3)]
        np.testing.assert_array_equal(d.get_copy(0).payload, 9.0)
        assert com.stats["committed"] == 1
    finally:
        com.close(flush=False)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_watermark_defers_below_window(impl):
    """Small dirty bytes sit pending (no eager D2H flood); the flush
    barrier drains them."""
    dev, com = _committer(impl)  # default: the reference's 32 MB, the port's none
    try:
        for i in range(4):
            com.enqueue(_dirty(impl, i, float(i)))
        time.sleep(0.4)  # > the committer's poll interval
        assert com.pending() == 4 and dev.d2h_calls == 0
        com.flush()
        assert com.pending() == 0
        assert com.stats["committed"] == com.drained() == 4
    finally:
        com.close(flush=False)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_wait_for_drains_one_tile(impl):
    _dev, com = _committer(impl)
    try:
        d = _dirty(impl, "v", 5.0)
        com.enqueue(d)
        assert com.wait_for(d.data_id, timeout=30.0)
        np.testing.assert_array_equal(d.get_copy(0).payload, 5.0)
    finally:
        com.close(flush=False)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_stale_entry_dropped_not_committed(impl):
    """Host at (or past) the device version: the version guard drops the
    entry — a deferred commit never rolls a tile back."""
    dev, com = _committer(impl)
    try:
        d = _dirty(impl, "s", 7.0, version=2)
        d.get_copy(0).version = 5
        com.enqueue(d)
        com.flush()
        assert dev.commits == [] and com.stats["dropped_stale"] == 1
    finally:
        com.close(flush=False)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_committer_failure_is_sticky_and_loud(impl):
    """A D2H failure kills the committer; the stored error re-raises on
    the next enqueue AND on flush — callers fail, they do not hang."""
    dev, com = _committer(impl)
    dev.fail = RuntimeError("injected D2H loss")
    try:
        com.enqueue(_dirty(impl, "f0", 1.0))
        com.kick()
        deadline = time.monotonic() + 30
        while com.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert com.error is not None and not com.healthy
        with pytest.raises(RuntimeError, match="committer failed"):
            com.enqueue(_dirty(impl, "f1", 2.0))
        with pytest.raises(RuntimeError, match="committer failed"):
            com.flush()
    finally:
        com.close(flush=False)


def test_committer_wait_for_takes_the_victim_first():
    """An eviction's ``wait_for`` moves its victim to the head of the
    queue: one drain of ``runtime_wb_batch`` tiles lands it, however many
    tiles were enqueued before it, and (with no watermark, the port's
    default) the rest stay pending."""
    dev, com = _committer("port")
    n = com._batch + 8
    try:
        tiles = [_dirty("port", f"q{i}", float(i)) for i in range(n)]
        for d in tiles:
            com.enqueue(d)
        assert com.wait_for(tiles[-1].data_id, timeout=30.0)
        assert dev.commits[0] == (tiles[-1].data_id, 2)
        assert com.pending() == n - com._batch
        com.flush()
        assert com.stats["committed"] == n
    finally:
        com.close(flush=False)


# -- the device module with the pipeline on (torch CPU device) ---------------------

def _add_pool(nt, n, body):
    """``nt`` independent tasks, each ``X <- body(X, k)`` on tile A(k)."""
    dc = LocalCollection("A", shape=(n, n))
    ptg = PTG("addk")
    t = ptg.task_class("t", k=f"0 .. {nt - 1}")
    t.affinity("A(k)")
    t.flow("X", INOUT, "<- A(k)", "-> A(k)")
    t.body(cuda=body)
    return dc, ptg


def test_detach_after_async_writeback_commits_exactly_once(port_param, depth2):
    """Tiles the committer landed mid-run are not committed again by
    detach's batched flush: bytes_out counts each dirty tile once, and the
    values are the final versions."""
    NT, N = 4, 512  # 512x512 f64 = 2 MB a tile > the 1 MB watermark
    port_param("runtime", "wb_window_mb", 1)
    dc, ptg = _add_pool(NT, N, lambda X, k: X + float(k + 1))
    tp = ptg.taskpool(A=dc)
    ctx = _ctx()
    try:
        dev = ctx.devices[1]
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
        com = dev._wb_committer()
        assert com is not None, "stage depth 2 arms the committer"
        com.flush()
        assert com.stats["committed"] > 0, "the watermark never drained mid-run"
    finally:
        ctx.fini()
    assert dev.stats["bytes_out"] == NT * N * N * 8
    for k in range(NT):
        hc = dc.data_of(k).get_copy(0)
        np.testing.assert_array_equal(hc.payload, float(k + 1))
        assert hc.version == dc.data_of(k).newest_copy().version


def test_custom_stage_hooks_compose_with_deferred_writeback(port_param, depth2):
    """The epilog runs stage_out (scatter) before it enqueues, so the
    deferred commits are home layout — one per task output — and the
    values land exact."""
    port_param("runtime", "wb_window_mb", 1)
    N, NT = 512, 3
    base = np.arange(float(N * N)).reshape(N, N)
    dc = LocalCollection("A", shape=(N, N), init=lambda k: base.copy())

    def pack(data, device):
        return torch.from_numpy(host_array(data.newest_copy().payload)[:, ::2].copy())

    def scatter(arr, data, device):
        full = torch.from_numpy(host_array(data.get_copy(0).payload))
        full[:, ::2] = arr
        return full

    ptg = PTG("stagewb")
    t = ptg.task_class("t", k=f"0 .. {NT - 1}")
    t.affinity("A(k)")
    t.flow("X", INOUT, "<- A(k)", "-> A(k)")
    t.stage("X", stage_in=pack, stage_out=scatter)
    t.body(cuda=lambda X, k: X * 10.0)
    tp = ptg.taskpool(A=dc)
    with _ctx() as ctx:
        dev = ctx.devices[1]
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
        com = dev._wb_committer()
        com.flush()
        assert com.stats["committed"] == NT
    expect = base.copy()
    expect[:, ::2] *= 10.0
    for k in range(NT):
        np.testing.assert_array_equal(host_array(dc.data_of(k).newest_copy().payload), expect)


def test_packed_read_copy_never_flushed_home(depth2):
    """A READ flow's pack hook leaves a PACKED device copy (no epilog
    unpacks it): the committer drops it — flushing a packed representation
    home would corrupt the tile."""
    N = 8
    base = np.arange(float(N * N)).reshape(N, N)
    dc = LocalCollection("A", shape=(N, N), init=lambda k: base.copy())

    def pack(data, device):
        return torch.from_numpy(host_array(data.newest_copy().payload)[:, ::2].copy())

    ptg = PTG("pkro")
    t = ptg.task_class("t", k="0 .. 0")
    t.affinity("A(0)")
    t.flow("X", IN, "<- A(0)")
    t.stage("X", stage_in=pack)
    t.body(cuda=lambda X, k: ())
    tp = ptg.taskpool(A=dc)
    with _ctx() as ctx:
        dev = ctx.devices[1]
        com = dev._wb_committer()
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30), tp.fail_reason
        d = dc.data_of(0)
        assert d.get_copy(dev.data_index) is not None  # the packed copy
        before = d.get_copy(0).payload.copy()
        com.enqueue(d)
        com.flush()
        assert com.stats["dropped_stale"] >= 1
        np.testing.assert_array_equal(d.get_copy(0).payload, before)


def _chain_pool(n=512, steps=10):
    """``steps`` INOUT updates chained on one 2 MB tile."""
    ptg = PTG("chain")
    s = ptg.task_class("s", k=f"0 .. {steps - 1}")
    s.flow("X", INOUT, "<- (k == 0) ? D(0) : X s(k-1)",
           f"-> (k < {steps - 1}) ? X s(k+1) : D(0)")
    s.body(cuda=lambda X, k: X + 1.0)
    return ptg.taskpool(D=LocalCollection("D", shape=(n, n)))


def test_committer_death_fails_pool_not_hang(port_param, depth2):
    """An injected D2H failure in the committer thread surfaces as a pool
    failure (the next epilog enqueue re-raises the sticky error) or at the
    flush barrier — the run ends, it does not wedge."""
    port_param("runtime", "wb_window_mb", 1)
    ctx = _ctx()
    try:
        dev = ctx.devices[1]
        com = dev._wb_committer()
        orig = dev._d2h_batch
        state = {"boomed": False}

        def boom(payloads):
            if not state["boomed"]:
                state["boomed"] = True
                raise RuntimeError("injected D2H failure")
            return orig(payloads)

        dev._d2h_batch = boom
        tp = _chain_pool()
        ctx.add_taskpool(tp)
        if tp.wait(timeout=60):
            # the pool drained before a failing drain met an enqueue:
            # force it — the failure must still surface at the flush
            com.kick()
            deadline = time.monotonic() + 30
            while com.error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(RuntimeError, match="committer"):
                com.flush()
        else:
            assert state["boomed"] and "committer" in tp.fail_reason
        assert not com.healthy
        # teardown must not trip over the dead committer: drop it and
        # restore the D2H (detach then takes the synchronous batch)
        dev._d2h_batch = orig
        com.close(flush=False)
        dev._committer = None
    finally:
        ctx.fini()


@pytest.mark.parametrize("regime", ["context", "pump"])
def test_teardown_reraises_a_committer_error(regime, cpu_device, depth2):
    """``Context.fini`` and ``NativeExecutor.close`` flush through the
    committer before the host reads; a committer that fails there raises
    (pre-run host tiles must not be handed back silently)."""
    tp = _chain_pool(n=8, steps=3)  # tiny: everything stays below the watermark
    if regime == "context":
        holder = _ctx()
        dev = holder.devices[1]
        holder.add_taskpool(tp)
        assert tp.wait(timeout=30), tp.fail_reason
        teardown = holder.fini
    else:
        holder = NativeExecutor(tp, native_device=True)
        dev = holder.device
        holder.run()
        teardown = holder.close
    assert dev._committer is not None and dev._committer.pending() > 0

    def boom(payloads):
        raise RuntimeError("injected D2H failure")

    dev._d2h_batch = boom
    with pytest.raises(RuntimeError, match="committer"):
        teardown()
    assert dev._committer is None  # discarded: a shared device re-arms


def test_eviction_writeback_routes_through_committer(depth2):
    """Under budget pressure the LRU victim's dirty copy is committed by
    the committer (kick + wait), not the blocking per-tile path, and every
    tile survives eviction."""
    dc, ptg = _add_pool(12, 1, lambda X, k: X + 0.0)
    for k in range(12):
        dc.data_of(k).get_copy(0).payload[:] = float(k)
    tp = ptg.taskpool(A=dc)
    with _ctx() as ctx:
        dev = ctx.devices[1]
        com = dev._wb_committer()
        dev.mem_budget = 4 * 8  # room for 4 one-element f64 tiles
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
        assert dev.stats["evictions"] > 0
        assert com.drained() > 0, "eviction write-backs bypassed the committer"
        assert dev.stats["wb_sync_fallbacks"] == 0
    for k in range(12):
        np.testing.assert_array_equal(host_array(dc.data_of(k).newest_copy().payload), k)


# -- digests across stage depths: the pump, the dynamic path, the reference -------

_DPOTRF = {"kernels": (dict(use_kernels=True), dict(use_pallas=True)),
           "kernels_trtri": (dict(use_kernels=True, use_trtri=True),
                             dict(use_pallas=True, use_trtri=True))}
_N, _NB = 128, 32
_GRID = np.random.default_rng(1).standard_normal((24, 36))
_ST = dict(T=4, MT=3, NT=3)
_QKV = [np.random.default_rng(9).standard_normal((1, 48, 2, 16)).astype(np.float32)
        for _ in range(3)]
_ATTN = dict(causal=True, q_block=16, kv_block=16)
_cache = {}


def _set_depth(depth):
    mca_param.set_param("runtime", "stage_depth", depth)


def _dpotrf_pool(variant):
    A = TiledMatrix(_N, _N, _NB, _NB, name="A", dtype=np.float32).from_array(_spd(_N, seed=3))
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, **_DPOTRF[variant][0]).taskpool(
        NT=A.mt, A=A)
    return tp, A.to_array


def _stencil_pool():
    A = stencil.StencilBuffers(_GRID, _ST["MT"], _ST["NT"])
    tp = stencil.stencil_ptg(use_kernels=True, use_cpu=False).taskpool(A=A, **_ST)
    return tp, lambda: A.to_array(_ST["T"] % 2)


def _path_result(path, regime):
    """One run of ``path`` at the current stage depth: through the pump
    (``regime == "pump"``) or the dynamic path; the result as numpy."""
    if path == "attention":
        if regime == "pump":
            return attention.run_flash_attention_native(*_QKV, **_ATTN).numpy()
        with _ctx() as ctx:
            return attention.run_flash_attention(ctx, *_QKV, use_cpu=False, **_ATTN).numpy()
    tp, result = _stencil_pool() if path == "stencil" else _dpotrf_pool(path)
    if regime == "pump":
        ex = NativeExecutor(tp, native_device=True)
        try:
            ex.run()
        finally:
            ex.close()
    else:
        with _ctx() as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60), tp.fail_reason
    return result()


def _baseline(path, regime, depth):
    key = (path, regime, depth)
    if key not in _cache:
        _set_depth(depth)
        try:
            _cache[key] = _path_result(path, regime)
        finally:
            mca_param.unset("runtime", "stage_depth")
    return _cache[key]


def _reference_pump(variant, depth):
    """The JAX package's pump factor at the same stage depth (wave
    batching off: its vmapped waves need not match singles bitwise)."""
    key = ("reference", variant, depth)
    if key not in _cache:
        rA = RefTiledMatrix(_N, _N, _NB, _NB, name="A", dtype=np.float32).from_array(
            _spd(_N, seed=3))
        tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False, **_DPOTRF[variant][1]).taskpool(
            NT=rA.mt, A=rA)
        ref_mca_param.params.set("runtime", "stage_depth", depth)
        ref_mca_param.params.set("device", "tpu_wave_batch", 0)
        try:
            ref_native_exec.run_native(tp, native_device=True)
        finally:
            ref_mca_param.params.unset("runtime", "stage_depth")
            ref_mca_param.params.unset("device", "tpu_wave_batch")
        _cache[key] = rA.to_array()
    return _cache[key]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("path", ["kernels", "kernels_trtri", "attention", "stencil"])
def test_pump_digests_identical_across_stage_depths(path, depth, seed, cpu_device,
                                                    port_param, eager_lane):
    """4 seeds x 3 depths per path: the prefetch window (the lane staging
    re-sliced waves) and deferred commits never leak into the results —
    each run is bit-identical to the depth-1 pump and to the dynamic path,
    and within the reference's bound."""
    port_param("sched", "rnd_seed", seed)
    port_param("runtime", "stage_depth", depth)
    out = _path_result(path, "pump")
    np.testing.assert_array_equal(out, _baseline(path, "pump", 1))
    np.testing.assert_array_equal(out, _baseline(path, "dynamic", 2))
    if path in _DPOTRF:
        ref = np.tril(_reference_pump(path, depth))
        L = np.tril(out)
        assert np.abs(L - ref).max() / np.abs(ref).max() < TOL_DPOTRF
    elif path == "attention":
        want = np.asarray(attention_reference(*_QKV, causal=True))
        np.testing.assert_allclose(out, want, rtol=TOL_ATTN, atol=TOL_ATTN)
    else:
        want = ref_stencil.reference_stencil(_GRID, _ST["T"])
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("path", ["kernels", "kernels_trtri", "attention", "stencil"])
def test_dynamic_digests_identical_pipeline_on_vs_off(path):
    """The dynamic path at stage depth 1 (synchronous transfers, no
    committer) and 2 (deferred write-backs) lands bit-identical results."""
    np.testing.assert_array_equal(_baseline(path, "dynamic", 1),
                                  _baseline(path, "dynamic", 2))


def _pump_stats(depth, port_param):
    port_param("runtime", "stage_depth", depth)
    tp, result = _stencil_pool()
    ex = NativeExecutor(tp, native_device=True)
    try:
        ex.run()
        stats, dev_stats = dict(ex.stats), dict(ex.device.stats)
        armed = ex.device._committer is not None
    finally:
        ex.close()
    return result(), stats, dev_stats, armed


def test_pump_prefetch_window_engages(cpu_device, port_param, eager_lane,
                                      monkeypatch):
    """Depth 2 arms the transfer lane and the committer: the pump reports
    prefetched batches and the device prestaged tiles; depth 1 keeps the
    synchronous shape.  The pump waits for the lane to finish each job
    before the batch's submit stops it, so the lane stages in every run:
    otherwise whether it reaches a job before the pump does is a race
    between two threads (under a loaded host the lane may not run at
    all before the pump stops it)."""
    stop_after_chunk = staging._StageJob.wait

    def wait_for_the_lane(job):
        job.done.wait(timeout=60)
        stop_after_chunk(job)

    monkeypatch.setattr(staging._StageJob, "wait", wait_for_the_lane)
    out2, stats, dev_stats, armed = _pump_stats(2, port_param)
    assert stats["prefetched_batches"] > 0 and dev_stats["prefetched_tiles"] > 0
    assert stats["submit_s"] > 0 and dev_stats["prestage_s"] > 0
    assert dev_stats["stage_batched_tiles"] > 0 and armed
    out1, stats, dev_stats, armed = _pump_stats(1, port_param)
    assert stats["prefetched_batches"] == 0 and dev_stats["prefetched_tiles"] == 0
    assert not armed
    np.testing.assert_array_equal(out1, out2)


def test_default_window_commits_only_final_versions(cpu_device, port_param):
    """With no watermark (the default) the depth-2 pump drains nothing
    mid-run: the D2H copies all come at ``close()``, as many as at depth 1,
    so no intermediate version of a rewritten tile travels home."""
    counts = {}
    for depth in (1, 2):
        port_param("runtime", "stage_depth", depth)
        tp, result = _stencil_pool()
        ex = NativeExecutor(tp, native_device=True)
        try:
            ex.run()
            assert ex.device.stats["d2h_copies"] == 0
        finally:
            ex.close()
        counts[depth] = (ex.device.stats["d2h_copies"], ex.device.stats["bytes_out"])
        np.testing.assert_array_equal(result(), _baseline("stencil", "pump", 1))
    assert counts[2] == counts[1] and counts[1][0] > 0


def test_pump_resplits_a_wide_ready_wave(cpu_device, port_param):
    """Each of the small stencil's ready waves fits one pop.  Under the
    default ``runtime_stage_split_kb`` (its few KB are too few) no wave is
    re-sliced and each stages in its own submit: nothing goes to the lane.
    With a threshold of 0 KB the waves with tiles to stage are re-sliced
    across the window and the lane prestages the later slice while the
    first is dispatched: one more retired batch than pops for each, the
    same result."""
    _out, stats, _dev, _armed = _pump_stats(2, port_param)
    assert stats["prefetched_batches"] == 0
    assert stats["done_batches"] == stats["pop_batches"]
    port_param("runtime", "stage_split_kb", 0)
    out, stats, _dev, _armed = _pump_stats(2, port_param)
    assert stats["prefetched_batches"] > 0
    assert stats["done_batches"] == stats["pop_batches"] + stats["prefetched_batches"]
    assert stats["pumped_tasks"] == _ST["T"] * _ST["MT"] * _ST["NT"]
    np.testing.assert_array_equal(out, _baseline("stencil", "pump", 1))


@pytest.fixture
def ref_param():
    """Set the JAX package's MCA params for one test; unset them after."""
    touched = []

    def set_(framework, name, value):
        ref_mca_param.params.set(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        ref_mca_param.params.unset(framework, name)


def _wave_pool(pkg, nt=8, n=16):
    """One ready wave: ``nt`` independent ``X + 1`` tasks on the n x n f64
    tiles A(k) (2 KiB each at n = 16), built with either package."""
    if pkg == "port":
        dc, ptg = _add_pool(nt, n, lambda X, k: X + 1.0)
        return ptg.taskpool(A=dc), dc
    from parsec_tpu import AccessMode as RefAccessMode
    from parsec_tpu.data import LocalCollection as RefLocalCollection
    from parsec_tpu.dsl import PTG as RefPTG

    dc = RefLocalCollection("A", shape=(n, n))
    ptg = RefPTG("addk")
    t = ptg.task_class("t", k=f"0 .. {nt - 1}")
    t.affinity("A(k)")
    t.flow("X", RefAccessMode.INOUT, "<- A(k)", "-> A(k)")
    t.body(tpu=lambda X, k: X + 1.0)
    return ptg.taskpool(A=dc), dc


def _wave_run(pkg, on_quiesce=None):
    """The wave through each package's pump at stage depth 2 (the port's
    is set by the caller; 2 is the reference's default); ``on_quiesce``
    sees the device after the run, before ``close`` flushes it."""
    tp, dc = _wave_pool(pkg)
    make = NativeExecutor if pkg == "port" else ref_native_exec.NativeExecutor
    ex = make(tp, native_device=True)
    try:
        ex.run()
        seen = on_quiesce(ex.device) if on_quiesce is not None else None
    finally:
        ex.close()
    for k in range(8):
        np.testing.assert_array_equal(np.asarray(dc.data_of(k).newest_copy().payload),
                                      np.ones((16, 16)))
    return dict(ex.stats), seen


def test_stage_split_kb_resplits_the_wave_as_in_the_reference(cpu_device, port_param,
                                                              ref_param, depth2):
    """ROADMAP C.13: ``runtime_stage_split_kb`` is the re-slice threshold on
    both packages.  The 16 KiB wave stays one batch under the default
    256 KB and is re-sliced across the depth-2 window at 1 KB: one more
    retired batch than pops, on the port as on the reference."""
    resliced = {}
    for kb in (None, 1):
        if kb is not None:
            port_param("runtime", "stage_split_kb", kb)
            ref_param("runtime", "stage_split_kb", kb)
        for pkg in ("port", "reference"):
            stats, _ = _wave_run(pkg)
            assert stats["pop_batches"] == 1
            resliced[pkg, kb] = stats["done_batches"] - stats["pop_batches"]
    assert resliced == {("port", None): 0, ("reference", None): 0,
                        ("port", 1): 1, ("reference", 1): 1}


def test_wb_batch_caps_a_committer_drain_as_in_the_reference(cpu_device, port_param,
                                                             ref_param, depth2):
    """ROADMAP C.13: ``runtime_wb_batch`` caps the tiles one committer drain
    takes on both packages.  After the wave, its 8 dirty tiles wait in the
    committer (below either package's watermark); one kick (eviction's
    call) makes the committer's thread take one drain: all 8 at the
    default of 32, 3 at 3.  ``close`` flushes the rest home."""
    def one_drain(dev):
        com = dev._committer
        assert com.pending() == 8 and com.stats["committed"] == 0
        com.kick()
        deadline = time.monotonic() + 30
        while com.pending() == 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        return com.stats["committed"], com.pending()

    drained = {}
    for batch in (None, 3):
        if batch is not None:
            port_param("runtime", "wb_batch", batch)
            ref_param("runtime", "wb_batch", batch)
        for pkg in ("port", "reference"):
            drained[pkg, batch] = _wave_run(pkg, one_drain)[1]
    assert drained == {("port", None): (8, 0), ("reference", None): (8, 0),
                       ("port", 3): (3, 5), ("reference", 3): (3, 5)}


def test_staging_spans_and_hb_edges_fire(cpu_device, port_param, eager_lane):
    """A depth-2 pump run fires the STAGE_IN span on the lane, WRITEBACK
    spans around committer drains and the final flush, and the
    happens-before edges (prestage, enqueue, commit)."""
    sites = (pins.STAGE_IN_BEGIN, pins.STAGE_IN_END, pins.WRITEBACK_BEGIN,
             pins.WRITEBACK_END, pins.HB_STAGE_IN, pins.HB_WB_ENQUEUE,
             pins.HB_WB_COMMIT)
    seen = {s: 0 for s in sites}
    cbs = {s: (lambda es, payload, s=s: seen.__setitem__(s, seen[s] + 1)) for s in sites}
    for s, cb in cbs.items():
        pins.subscribe(s, cb)
    try:
        _pump_stats(2, port_param)
    finally:
        for s, cb in cbs.items():
            pins.unsubscribe(s, cb)
    assert all(seen.values()), seen
    assert seen[pins.STAGE_IN_BEGIN] == seen[pins.STAGE_IN_END]
    assert seen[pins.WRITEBACK_BEGIN] == seen[pins.WRITEBACK_END]


@pytest.mark.parametrize("depth", [2, 4])
def test_tight_budget_pump_evicts_through_the_pipeline(depth, cpu_device, port_param,
                                                       eager_lane):
    """A budget of four tiles under the pump's prefetch window: the device
    evicts and commits while the lane prestages, with no synchronous
    fallback, and the factor is unchanged."""
    port_param("runtime", "stage_depth", depth)
    want = _baseline("kernels", "pump", 1)
    tp, result = _dpotrf_pool("kernels")
    dev = NativeExecutor._make_device()
    dev.mem_budget = 4 * _NB * _NB * 4
    ex = NativeExecutor(tp, native_device=True, device=dev)
    try:
        ex.run()
        assert dev.mem_used <= dev.mem_budget
    finally:
        ex.close()
    assert dev.stats["evictions"] > 0 and dev.stats["bytes_out"] > 0
    assert dev.stats["wb_sync_fallbacks"] == 0
    np.testing.assert_array_equal(result(), want)


def test_lane_copy_superseded_in_flight_is_dropped():
    """The lane copies outside the residency lock; a device copy that
    landed meanwhile at a newer version (an epilog) wins, and the lane's
    staged copy is dropped — attaching it would roll the tile back."""
    d = data_create("x", payload=np.arange(4.0))
    newer = torch.full((4,), 9.0, dtype=torch.float64)
    with _ctx() as ctx:
        dev = ctx.devices[1]
        copy_in = dev._copy_in

        def racing(srcs):
            out = copy_in(srcs)
            c = d.attach_copy(dev.data_index, newer)  # the epilog lands
            c.version = 5
            return out

        dev._copy_in = racing
        assert dev._stage_in_batch([d]) == 0
        assert d.get_copy(dev.data_index).payload is newer
        assert d.get_copy(dev.data_index).version == 5


class _Reads:
    """The surface ``prestage_batch`` reads of a task: a chore without
    stage hooks and read-only data flows."""

    def __init__(self, datas):
        self.selected_chore = types.SimpleNamespace(body_fn=None)
        self.body_args = [("data", d, IN) for d in datas]


def test_lane_stops_after_the_chunk_in_flight(monkeypatch):
    """When the pump reaches a batch it stops the lane: the chunk in flight
    lands, the rest is left to the batch's own submit."""
    datas = [data_create(f"c{i}", payload=np.full(4, float(i))) for i in range(6)]
    monkeypatch.setattr(cuda_mod, "_LANE_CHUNK_BYTES", 2 * 32)  # two 32-byte tiles
    stop = threading.Event()
    with _ctx() as ctx:
        dev = ctx.devices[1]
        stage = dev._stage_in_batch

        def pump_arrives(part):
            moved = stage(part)
            stop.set()
            return moved

        dev._stage_in_batch = pump_arrives
        dev.prestage_batch([_Reads(datas)], stop)
        assert [d.get_copy(dev.data_index) is not None for d in datas] == [True] * 2 + [False] * 4
        assert dev.stats["prefetched_tiles"] == 2
        dev.prestage_batch([_Reads(datas)], stop)  # stopped before it starts
        assert dev.stats["prefetched_tiles"] == 2


def test_advise_prefetch_warmup_and_drop_residency():
    d = data_create("adv", payload=np.arange(4.0))
    with _ctx() as ctx:
        dev = ctx.devices[1]
        dev.data_advise(d, ADVICE_PREFETCH)
        c = d.get_copy(dev.data_index)
        assert c is not None and c.version == d.get_copy(0).version
        np.testing.assert_array_equal(c.payload.numpy(), np.arange(4.0))
        assert d.data_id in dev._lru_clean and dev.mem_used > 0
        dev.data_advise(d, ADVICE_WARMUP)
        assert next(reversed(dev._lru_clean)) == d.data_id
        dev.drop_residency(d)
        assert d.get_copy(dev.data_index) is None and dev.mem_used == 0
        assert dev.stats["evictions"] == 0  # handed over, not evicted


# -- the pinned ring ---------------------------------------------------------------

class _FakeEvent:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_pinned_ring_reuses_waits_and_stays_bounded(monkeypatch):
    """A buffer returns to the ring only after its copy's event; a full
    ring waits on the oldest copy instead of growing; an oversized request
    is served alone and trimmed when it comes back; typed views are cached
    per buffer."""
    monkeypatch.setattr(cuda_mod, "_pinned_empty",
                        lambda n: torch.empty(n, dtype=torch.uint8))
    ring = cuda_mod._PinnedRing(4096)
    bufs = [ring.get(1024) for _ in range(4)]
    events = [_FakeEvent() for _ in bufs]
    for b, e in zip(bufs, events):
        ring.put([b], e)
    assert ring.allocated == ring.peak == 4096
    again = ring.get(1024)  # full: waits on the oldest copy, reuses it
    assert events[0].done and not events[1].done
    assert again.data_ptr() == bufs[0].data_ptr() and ring.allocated == 4096
    v = ring.view(again, torch.float32, (16, 16))
    assert v.shape == (16, 16) and v.data_ptr() == again.data_ptr()
    assert ring.view(again, torch.float32, (16, 16)) is v
    big = ring.get(8192)  # over capacity: waits, drops the free ones, serves
    assert all(e.done for e in events) and ring.peak == 1024 + 8192  # `again` held
    done = _FakeEvent()
    done.done = True
    ring.put([big, again], done)
    assert ring.allocated == 1024  # the oversized buffer trimmed on its return
    assert ring.get(1024).data_ptr() == again.data_ptr()


def test_capacity_chunks_bound_each_batch_of_copies():
    """The copy engine moves tiles in chunks of at most the ring's
    capacity, in order; a tile larger than the capacity goes alone."""
    chunks = cuda_mod._capacity_chunks
    assert chunks([3, 3, 3, 10, 1], 6) == [[0, 1], [2], [3], [4]]
    assert chunks([2] * 6, 4) == [[0, 1], [2, 3], [4, 5]]
    assert chunks([], 4) == []


# -- the zone allocator ----------------------------------------------------------

ZONES = {"reference": ref_native.ZoneAllocator, "port": native.ZoneAllocator}


@pytest.mark.parametrize("impl", sorted(ZONES))
def test_zone_alloc_release_coalesce(impl):
    z = ZONES[impl](1 << 20)
    a, b, c = z.alloc(1000), z.alloc(2000), z.alloc(4000)
    assert len({a, b, c}) == 3
    assert z.used == 1000 + 2000 + 4000
    # free the middle, then the neighbours: everything coalesces back
    z.release(b)
    z.release(a)
    z.release(c)
    assert z.used == 0 and z.largest_free == z.capacity
    z.close()


@pytest.mark.parametrize("impl", sorted(ZONES))
def test_zone_alignment_and_exhaustion(impl):
    z = ZONES[impl](4096)
    off = z.alloc(100, align=256)
    assert off % 256 == 0
    assert z.alloc(1 << 30) is None  # larger than the capacity
    got = []
    while True:
        o = z.alloc(512, align=1)
        if o is None:
            break
        got.append(o)
    assert z.alloc(512, align=1) is None
    for o in got:
        z.release(o)
    assert z.used >= 100  # the aligned first block is still accounted
    z.release(off)
    assert z.used == 0
    z.close()


@pytest.mark.parametrize("impl", sorted(ZONES))
def test_zone_unknown_offset_rejected(impl):
    z = ZONES[impl](1024)
    with pytest.raises(ValueError):
        z.release(12345)
    z.close()


@pytest.mark.parametrize("impl", sorted(ZONES))
def test_zone_threaded_stress(impl):
    import threading

    z = ZONES[impl](1 << 22)
    errs = []

    def churn(seed):
        rng = np.random.default_rng(seed)
        mine = []
        try:
            for _ in range(500):
                if mine and rng.random() < 0.45:
                    z.release(mine.pop(rng.integers(len(mine))))
                else:
                    o = z.alloc(int(rng.integers(64, 4096)))
                    if o is not None:
                        mine.append(o)
            for o in mine:
                z.release(o)
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    ts = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and not errs
    assert z.used == 0
    z.close()


def test_zone_accounts_device_bytes(cpu_device):
    """With the zone (the default) the device's residency slots are zone
    offsets: used bytes follow the slots during a run and drop to 0 when
    ``close`` releases the accounting."""
    tp, _result = _dpotrf_pool("kernels")
    ex = NativeExecutor(tp, native_device=True)
    dev = ex.device
    try:
        ex.run()
        assert dev._zone is not None and dev._offsets
        assert dev.mem_used == dev._zone.used >= len(dev._offsets) * _NB * _NB * 4
    finally:
        ex.close()
    assert dev.mem_used == dev._zone.used == 0 and not dev._offsets


def test_zone_without_a_library_raises(tmp_path, monkeypatch):
    """No quiet fallback: the engine library not buildable fails the
    device's construction (the zone is its only accounting)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="sources missing"):
        _ctx()
