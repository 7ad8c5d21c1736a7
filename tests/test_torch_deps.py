"""The port's dependency storage (parsec_tpu_torch.core.deps: the hash
tracker, the dense index-array tracker, counter and mask modes) and the
PTG's choice between them (``PTG.dep_storage``, ``runtime_dep_storage``)
against the JAX package's.

Every case of the reference's ``tests/class/test_dense_deps.py`` runs the
same release stream through both packages' trackers: the fire patterns,
the data handed back, ``peek``, ``pending_keys`` and ``len`` must be
equal.  The PTG cases factor one seeded SPD matrix through both packages
under dense storage and under hash storage: the factors are
``np.array_equal`` (the same numpy bodies in the same per-tile order),
and within the reference's 1e-8 of ``S``.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.core import deps as ref_deps  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.ops.cholesky import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu_torch import AccessMode, mca_param  # noqa: E402
from parsec_tpu_torch.core import deps  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl.ptg import PTG  # noqa: E402
from parsec_tpu_torch.ops.cholesky import cholesky_ptg  # noqa: E402
from parsec_tpu_torch.profiling import pins  # noqa: E402

PACKAGES = (ref_deps, deps)


def both(scenario):
    """``scenario(deps_module)`` on the reference then on the port; the
    two results must be equal."""
    ref, port = (scenario(m) for m in PACKAGES)
    assert ref == port, (ref, port)
    return port


def test_counter_mode_fires_at_goal():
    def run(m):
        t = m.DenseDepTracker()
        t.register_class("f", ((0, 4), (0, 4)))
        key = ("f", (2, 3))
        out = [t.release_counter(key, 3) for _ in range(3)]
        # fire resets the slot: one release after firing starts afresh
        out.append(t.release_counter(key, 3))
        return out

    out = both(run)
    assert [o[0] for o in out] == [False, False, True, False]


def test_mask_mode_requires_all_goal_bits():
    def run(m):
        t = m.DenseDepTracker()
        t.register_class("g", ((0, 7),))
        key = ("g", (5,))
        return [t.release_mask(key, bit, 0b101)[0]
                for bit in (0b001, 0b001, 0b100, 0b100)]

    assert both(run) == [False, False, True, False]


def test_mask_mode_hash_backend():
    """The hash tracker's mask mode (the dense tracker's fallback)."""
    def run(m):
        t = m.DepTracker()
        key = ("h", (1, 2))
        return ([t.release_mask(key, bit, 0b110)[0]
                 for bit in (0b010, 0b010, 0b100, 0b100)], len(t))

    assert both(run) == ([False, False, True, False], 1)


def test_dense_and_hash_agree_on_duplicate_release_sequences():
    def run(m):
        dense = m.DenseDepTracker()
        dense.register_class("c", ((0, 2),))
        hashb = m.DepTracker()
        seq = [("c", (0,))] * 7 + [("c", (1,))] * 3 + [("c", (0,))] * 2
        return ([dense.release_counter(k, 3)[0] for k in seq],
                [hashb.release_counter(k, 3)[0] for k in seq])

    fires_d, fires_h = both(run)
    assert fires_d == fires_h


def test_data_is_dropped_on_fire():
    def run(m):
        t = m.DenseDepTracker()
        t.register_class("f", ((0, 3),))
        key = ("f", (1,))
        t.release_counter(key, 2, data="payload")
        became, d = t.release_counter(key, 2)
        return became, d, t.peek(key)

    assert both(run) == (True, "payload", None)


def test_out_of_box_keys_fall_back_to_hash():
    def run(m):
        t = m.DenseDepTracker()
        t.register_class("f", ((0, 3),))
        return [(t.release_counter(key, 2)[0], t.release_counter(key, 2)[0])
                for key in [("f", (17,)), ("h", (0, 0))]]

    assert both(run) == [(False, True), (False, True)]


@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_dense_matches_hash_under_concurrency(backend):
    """Eight threads each release one dependency of one key with goal 8:
    exactly one sees it ready, in both packages."""
    def run(m):
        tracker = m.DepTracker() if backend == "hash" else m.DenseDepTracker()
        if backend == "dense":
            tracker.register_class("c", ((0, 0),))
        fired = []
        barrier = threading.Barrier(8)

        def one():
            barrier.wait()
            if tracker.release_counter(("c", (0,)), 8)[0]:
                fired.append(1)

        ts = [threading.Thread(target=one) for _ in range(8)]
        [x.start() for x in ts]
        [x.join() for x in ts]
        return len(fired), len(tracker)

    assert both(run) == (1, 0)


def test_empty_or_negative_bounds_ignored():
    def run(m):
        t = m.DenseDepTracker()
        t.register_class("e", ((3, 2),))  # an empty dimension: not registered
        return t.release_counter(("e", (3,)), 1)[0]

    assert both(run) is True


def test_len_counts_live_entries():
    def run(m):
        t = m.DenseDepTracker()
        t.register_class("f", ((0, 3),))
        t.release_counter(("f", (0,)), 5)
        t.release_counter(("f", (1,)), 1)  # fires: not live
        t.release_counter(("x", (9,)), 5)  # the fallback's entry
        t.set_data(("f", (2,)), "scratch")  # a data-only entry
        return len(t), t.peek(("f", (2,))).data, t.peek(("f", (0,))).count

    assert both(run) == (3, "scratch", 1)


def test_pending_keys_reports_partial_releases():
    def run(m):
        out = [m.DepTracker().pending_keys(), m.DenseDepTracker().pending_keys()]
        h = m.DepTracker()
        h.release_counter(("f", (1,)), 3)
        out.append(h.pending_keys())
        h.release_counter(("f", (1,)), 3)
        h.release_counter(("f", (1,)), 3)  # fires: the entry goes
        out.append(h.pending_keys())
        dense = m.DenseDepTracker()
        dense.register_class("f", ((0, 3), (1, 4)))
        dense.release_counter(("f", (2, 3)), 2)  # dense-side pending
        dense.release_counter(("g", (9,)), 2)  # fallback pending
        out.append(sorted(dense.pending_keys()))
        dense.release_counter(("f", (2, 3)), 2)  # fires
        out.append(dense.pending_keys())
        return out

    assert both(run) == [[], [], [("f", (1,))], [],
                         [("f", (2, 3)), ("g", (9,))], [("g", (9,))]]


def test_dep_decrement_payload_shape():
    """The DEP_DECREMENT site fires under the entry's lock with the same
    payload in both packages ({"tracker","key","ready","mode"})."""
    def run(m, p):
        seen = []

        def cb(es, payload):
            seen.append((payload["key"], payload["ready"], payload["mode"],
                         isinstance(payload["tracker"], int)))

        p.subscribe(p.DEP_DECREMENT, cb)
        try:
            t = m.DenseDepTracker()
            t.register_class("f", ((0, 1),))
            t.release_counter(("f", (0,)), 2)
            t.release_counter(("f", (0,)), 2)
            t.release_mask(("g", (0,)), 1, 1)
        finally:
            p.unsubscribe(p.DEP_DECREMENT, cb)
        return seen

    from parsec_tpu.profiling import pins as ref_pins

    assert run(ref_deps, ref_pins) == run(deps, pins) == [
        (("f", (0,)), False, "counter", True), (("f", (0,)), True, "counter", True),
        (("g", (0,)), True, "mask", True)]


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def _factor(pkg, storage, S, nb):
    n = S.shape[0]
    if pkg == "ref":
        ptg = ref_cholesky_ptg(use_tpu=False, use_cpu=True)
        A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
        ctx = parsec_tpu.Context(nb_cores=4, devices=["cpu"])
        tracker = ref_deps.DenseDepTracker
    else:
        ptg = cholesky_ptg(use_cuda=False, use_cpu=True)
        A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(S)
        ctx = parsec_tpu_torch.Context(nb_cores=4, devices=["cpu"])
        tracker = deps.DenseDepTracker
    ptg.dep_storage = storage
    tp = ptg.taskpool(NT=A.mt, A=A)
    assert isinstance(tp.deps, tracker) == (storage == "dense")
    with ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=120)
    assert len(tp.deps) == 0 and tp.deps.pending_keys() == []
    return np.tril(A.to_array())


@pytest.mark.parametrize("storage", ["dense", "hash"])
def test_ptg_cholesky_dense_storage_matches_numpy(storage):
    """The flagship PTG under both storages, in both packages: equal
    factors, within 1e-8 of S (the reference test's bound)."""
    S = _spd(64)
    L = _factor("port", storage, S, 16)
    assert np.array_equal(L, _factor("ref", storage, S, 16))
    np.testing.assert_allclose(L @ L.T, S, rtol=1e-8, atol=1e-8)


def test_dense_counts_local_tasks_at_attach():
    """Dense mode registers every class's box and sets the exact task
    count at attach, before any release (the reference's boxes, equal);
    hash mode counts during startup."""
    S = _spd(48, seed=3)
    boxes = []
    for P, TM, kw, ctx_of in (
            (ref_cholesky_ptg, RefTiledMatrix, dict(use_tpu=False),
             lambda: parsec_tpu.Context(nb_cores=2, devices=["cpu"])),
            (cholesky_ptg, TiledMatrix, dict(use_cuda=False),
             lambda: parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]))):
        ptg = P(use_cpu=True, **kw)
        ptg.dep_storage = "dense"
        A = TM(48, 48, 16, 16, name="A", dtype=np.float64).from_array(S)
        tp = ptg.taskpool(NT=A.mt, A=A)
        counts = []
        set_nb = tp.tdm.taskpool_set_nb_tasks
        tp.tdm.taskpool_set_nb_tasks = lambda t, n: (counts.append(n), set_nb(t, n))
        with ctx_of() as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
        assert tp._counted and counts[0] == 10  # NT=3: 3 + 3 + 3 + 1
        boxes.append({k: v[0] for k, v in tp.deps._classes.items()})
    assert boxes[0] == boxes[1]
    assert boxes[1]["gemm"] == ((0, 0), (2, 2), (1, 1))


def test_mca_param_selects_dense():
    ptg = PTG("probe", N=1)
    tc = ptg.task_class("t", i="0 .. N-1")
    tc.flow("X", AccessMode.IN, "<- NONE")
    tc.body(cpu=lambda **kw: None)
    assert isinstance(ptg.taskpool(N=4).deps, deps.DepTracker)
    mca_param.set_param("runtime", "dep_storage", "dense")
    try:
        assert isinstance(ptg.taskpool(N=4).deps, deps.DenseDepTracker)
        mca_param.set_param("runtime", "dep_storage", "bogus")
        with pytest.raises(ValueError, match="unknown dep_storage"):
            ptg.taskpool(N=4)
    finally:
        mca_param.unset("runtime", "dep_storage")
