"""The port's runtime collectives (parsec_tpu_torch.comm.coll) against the
JAX package's (parsec_tpu.comm.coll), case for case with
``tests/runtime/test_coll.py`` and ``tests/runtime/test_coll_deferred_fail.py``,
``CollectiveTask`` as DTD nodes (``tests/dsl/test_collective_task.py``),
plus ``user_trigger`` termination across ranks
(``tests/runtime/test_termdet_user_trigger.py`` has no multi-rank case).

Every case that computes a value runs the same seeded numpy inputs over
each package's in-process fabric, one thread a rank, every thread joined
under a timeout.  A single add, multiply, max or min of two IEEE values
is exactly rounded in numpy and in torch alike, and both packages run the
same schedules, so the results are compared bit for bit
(``np.array_equal``) for every algorithm and op, in float32 and float64,
and the endpoints' counters (ops, segments, ``bytes_landed``) must match.
A torch CPU tensor stands in for the port's device contribution and a
``jax.Array`` for the reference's: both combine through their framework's
op (``jit_reduces``), a bfloat16 sum holds the same raw bits on both
sides, and the port's result is a tensor where its contribution lived.
The gather root folds in group order in the port and in arrival order in
the reference (ROADMAP C): the parity runs of ``gather`` start the ranks
one after the other, so the reference's arrival order is the group
order.
"""

import collections
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.comm import coll as ref_coll  # noqa: E402
from parsec_tpu.comm import inproc as ref_inproc  # noqa: E402
from parsec_tpu.core.lifecycle import DEV_CPU as REF_DEV_CPU  # noqa: E402
from parsec_tpu.core.lifecycle import HookReturn as RefHookReturn  # noqa: E402
from parsec_tpu.core.task import Chore as RefChore  # noqa: E402
from parsec_tpu.core.task import Task as RefTask  # noqa: E402
from parsec_tpu.core.task import TaskClass as RefTaskClass  # noqa: E402
from parsec_tpu.core.taskpool import Taskpool as RefTaskpool  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch.comm import CollError  # noqa: E402
from parsec_tpu_torch.comm import coll as port_coll  # noqa: E402
from parsec_tpu_torch.comm import inproc as port_inproc  # noqa: E402
from parsec_tpu_torch.core.lifecycle import DEV_CPU, HookReturn  # noqa: E402
from parsec_tpu_torch.core.task import Chore, Task, TaskClass  # noqa: E402
from parsec_tpu_torch.core.taskpool import Taskpool  # noqa: E402
from parsec_tpu_torch.utils import mca_param as port_mca  # noqa: E402

REF = dict(name="ref", inproc=ref_inproc, coll=ref_coll, mca=ref_mca,
           CollError=ref_coll.CollError, Context=parsec_tpu.Context,
           Taskpool=RefTaskpool, TaskClass=RefTaskClass, Task=RefTask,
           Chore=RefChore, DEV_CPU=REF_DEV_CPU, HookReturn=RefHookReturn,
           ctx_kw={})
PORT = dict(name="port", inproc=port_inproc, coll=port_coll, mca=port_mca,
            CollError=CollError, Context=parsec_tpu_torch.Context,
            Taskpool=Taskpool, TaskClass=TaskClass, Task=Task, Chore=Chore,
            DEV_CPU=DEV_CPU, HookReturn=HookReturn, ctx_kw={"devices": ["cpu"]})
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
N = 8
JOIN_S = 60


def _fabric(P, n=N):
    fab = P["inproc"].InprocFabric(n)
    engines = fab.endpoints()
    for e in engines:
        _ = e.coll  # register the ctl op before any advert can arrive
    return fab, engines


def _run_all(engines, fn, ranks=None, staged=False):
    """Run fn(rank, engine) on one thread per rank; return results,
    re-raising the first failure.  ``staged``: start the ranks one after
    the other, each once group[0]'s gather op has folded the contributions
    before it (the reference folds in arrival order)."""
    ranks = list(ranks if ranks is not None else range(len(engines)))
    out = {}
    errs = []

    def worker(r):
        try:
            out[r] = fn(r, engines[r])
        except Exception as e:
            errs.append((r, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in ranks]
    for k, t in enumerate(ts):
        t.start()
        if staged and k >= 1:
            _wait_folded(engines[ranks[0]], k, errs)
    for t in ts:
        t.join(timeout=JOIN_S)
    assert all(not t.is_alive() for t in ts), "collective wedged"
    if errs:
        raise errs[0][1]
    return out


def _wait_folded(root_ce, k, errs):
    """Wait until the root's one gather op folded k contributions."""
    deadline = time.monotonic() + JOIN_S
    while time.monotonic() < deadline and not errs:
        ops = list(root_ce.coll._ops.values())
        done = root_ce.coll.summary()["ops_done"]
        if done or (ops and getattr(ops[0], "contribs", 0) >= k):
            return
        time.sleep(0.001)
    raise AssertionError(f"the gather root never folded {k} contributions")


def _stats(engines):
    keys = ("ops_started", "ops_done", "ops_failed", "seg_done", "seg_req",
            "bytes_landed", "blocks_sent", "acks_sent", "jit_reduces")
    return [{k: int(ce.coll.stats[k]) for k in keys} for ce in engines]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _allreduce_both(contribs, staged=False, **kw):
    """The same allreduce over both packages: (ref results, port results,
    ref stats, port stats)."""
    outs, stats = [], []
    for P in (REF, PORT):
        _, engines = _fabric(P, len(contribs))

        def go(r, ce):
            h = ce.coll_allreduce(contribs[r].copy(), **kw)
            assert h.wait(timeout=30)
            return np.array(h.result())

        outs.append(_run_all(engines, go, staged=staged))
        stats.append(_stats(engines))
    return outs[0], outs[1], stats[0], stats[1]


# ---------------------------------------------------------------------------
# allreduce: every algorithm, every rank gets the same right answer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ring", "rd", "gather"])
def test_allreduce_parity_all_algorithms(algo):
    contribs = [np.arange(40, dtype=np.float64) * (r + 1) for r in range(N)]
    ref = sum(contribs)
    r_out, p_out, r_st, p_st = _allreduce_both(contribs, algo=algo,
                                               staged=algo == "gather")
    for r in range(N):
        np.testing.assert_array_equal(p_out[r], ref)
        assert np.array_equal(p_out[r], r_out[r])
    assert p_st == r_st
    _, engines = _fabric(PORT)

    def go(r, ce):
        h = ce.coll_allreduce(contribs[r].copy(), algo=algo)
        assert h.wait(timeout=30)

    _run_all(engines, go)
    # endpoint bookkeeping: every op retired, nothing in flight, every
    # staging registration reclaimed (fabric mem table empty)
    for ce in engines:
        s = ce.coll.summary()
        assert s["ops_done"] == s["ops_started"] == 1
        assert s["ops_inflight"] == 0 and s["segments_inflight"] == 0
        assert not ce.fabric.mem, ce.fabric.mem


@pytest.mark.parametrize("op,fn", [
    ("sum", np.sum), ("max", np.max), ("min", np.min), ("prod", np.prod),
])
def test_allreduce_reduction_ops(op, fn):
    contribs = [np.array([2.0, 3.0, 5.0]) + r for r in range(4)]
    ref = fn(np.stack(contribs), axis=0)
    r_out, p_out, r_st, p_st = _allreduce_both(contribs, op=op)
    for r in range(4):
        np.testing.assert_array_equal(p_out[r], ref)
        assert np.array_equal(p_out[r], r_out[r])
    assert p_st == r_st


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("algo", ["ring", "rd", "gather"])
def test_allreduce_random_inputs_bit_identical(algo, op, dtype):
    """Seeded random contributions (a ragged size, several segments under
    a 256-byte segment): every algorithm and op, f32 and f64, bit-identical
    to the reference on every rank, every rank equal to every other; the
    same segments, ops and bytes landed on both."""
    rng = np.random.default_rng(2026)
    contribs = [rng.standard_normal(301).astype(dtype) for _ in range(4)]
    with _segment(256):
        r_out, p_out, r_st, p_st = _allreduce_both(
            contribs, algo=algo, op=op, staged=algo == "gather")
    for r in range(4):
        assert np.array_equal(p_out[r], r_out[r]), (algo, op, r)
        assert np.array_equal(p_out[r], p_out[0])
        assert p_out[r].dtype == dtype
    assert p_st == r_st
    assert p_st[0]["seg_done"] > 1


class _segment:
    """``runtime_coll_segment`` set on both packages for a block."""

    def __init__(self, nbytes):
        self.nbytes = nbytes

    def __enter__(self):
        for P in (REF, PORT):
            P["mca"].set_param("runtime", "coll_segment", self.nbytes)

    def __exit__(self, *exc):
        for P in (REF, PORT):
            P["mca"].params.unset("runtime", "coll_segment")


def test_allreduce_2d_and_nondividing_sizes():
    """Shapes that don't divide by the group size partition unevenly
    (trailing blocks smaller/empty) and still reduce exactly."""
    for shape in [(3,), (5, 7), (1,), (13,)]:
        contribs = [np.full(shape, float(r + 1)) for r in range(N)]
        ref = sum(contribs)
        r_out, p_out, r_st, p_st = _allreduce_both(contribs)
        for r in range(N):
            np.testing.assert_array_equal(p_out[r], ref)
            assert p_out[r].shape == r_out[r].shape == shape
        assert p_st == r_st


def test_allreduce_group_subset():
    """Collectives over a strict subset of the mesh leave the other
    ranks untouched."""
    group = [1, 3, 5, 7]
    ref = sum(np.arange(8.0) + r for r in group)
    outs = []
    for P in (REF, PORT):
        _, engines = _fabric(P)

        def go(r, ce):
            h = ce.coll_allreduce(np.arange(8.0) + r, group=group)
            assert h.wait(timeout=30)
            return np.array(h.result())

        out = _run_all(engines, go, ranks=group)
        for r in group:
            np.testing.assert_array_equal(out[r], ref)
        for r in (0, 2, 4, 6):
            assert engines[r].coll.summary()["ops_started"] == 0
        outs.append(out)
    assert all(np.array_equal(outs[0][r], outs[1][r]) for r in group)


def test_allreduce_many_segments_pipeline():
    """A payload much larger than the segment size moves as a pipelined
    chunk train (window = comm_pipeline_depth) landing out of order into
    the one pool slot."""
    payload = np.arange(4096, dtype=np.float64)  # 32 KiB: 256 chunks
    ref = payload * sum(range(1, 5))
    with _segment(128):
        _, engines = _fabric(PORT, 4)
        for ce in engines:
            assert ce.coll.segment == 128
        r_out, p_out, r_st, p_st = _allreduce_both(
            [payload * (r + 1) for r in range(4)])
    for r in range(4):
        np.testing.assert_array_equal(p_out[r], ref)
        assert np.array_equal(p_out[r], r_out[r])
    # the train really was chunked, as many chunks as the reference's
    assert p_st[0]["seg_done"] > 10 and p_st == r_st


def test_allreduce_device_arrays_jit_reduce():
    """A device contribution — a ``jax.Array`` in the reference, a torch
    tensor in the port (here on the CPU) — combines through its
    framework's op: ``jit_reduces`` > 0 and equal on both, the results
    bit-identical; the port's result is a tensor on its contribution's
    device."""
    rng = np.random.default_rng(16)
    base = [rng.standard_normal(16).astype(np.float32) for _ in range(4)]
    outs, reduces = [], []
    for P, mk in ((REF, jnp.asarray), (PORT, torch.from_numpy)):
        _, engines = _fabric(P, 4)

        def go(r, ce, mk=mk):
            h = ce.coll_allreduce(mk(base[r].copy()))
            assert h.wait(timeout=30)
            return h.result()

        out = _run_all(engines, go)
        outs.append(out)
        reduces.append([int(ce.coll.stats["jit_reduces"]) for ce in engines])
    ref = base[0] + base[1] + base[2] + base[3]
    for r in range(4):
        np.testing.assert_allclose(_host(outs[1][r]), ref, rtol=1e-6)
        assert np.array_equal(_host(outs[1][r]), np.asarray(outs[0][r]))
        assert isinstance(outs[1][r], torch.Tensor)
        assert outs[1][r].device.type == "cpu" and outs[1][r].dtype == torch.float32
    assert sum(reduces[1]) > 0 and reduces[1] == reduces[0] == [3] * 4


def test_single_rank_and_empty_are_immediate():
    for P in (REF, PORT):
        _, engines = _fabric(P, 1)
        h = engines[0].coll_allreduce(np.arange(4.0))
        assert h.done and h.wait(timeout=1)
        np.testing.assert_array_equal(h.result(), np.arange(4.0))

        _, engines = _fabric(P, 2)

        def go(r, ce):
            h = ce.coll_allreduce(np.zeros(0))
            assert h.wait(timeout=5)
            return h.result()

        out = _run_all(engines, go)
        assert out[0].size == 0 and out[1].size == 0


# ---------------------------------------------------------------------------
# reduce-scatter / allgather / bcast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reduce_scatter_partitions(dtype):
    full = sum(np.arange(36, dtype=np.float64) * (r + 1) for r in range(N))
    rng = np.random.default_rng(7)
    rand = [rng.standard_normal(36).astype(dtype) for _ in range(N)]
    outs = []
    for P in (REF, PORT):
        _, engines = _fabric(P)

        def go(r, ce):
            h = ce.coll_reduce_scatter(np.arange(36, dtype=np.float64) * (r + 1))
            assert h.wait(timeout=30)
            h2 = ce.coll_reduce_scatter(rand[r].copy())
            assert h2.wait(timeout=30)
            return np.array(h.result()), np.array(h2.result())

        out = _run_all(engines, go)
        for r in range(N):  # 36 elements over 8 ranks: ragged partitions
            b0, b1 = r * 36 // N, (r + 1) * 36 // N
            np.testing.assert_array_equal(out[r][0], full[b0:b1])
        outs.append((out, _stats(engines)))
    for r in range(N):
        assert np.array_equal(outs[0][0][r][1], outs[1][0][r][1])
    assert outs[0][1] == outs[1][1]


def test_allgather_rank_order():
    exp = np.concatenate([np.full((2, 3), float(r)) for r in range(N)])
    outs = []
    for P in (REF, PORT):
        _, engines = _fabric(P)

        def go(r, ce):
            h = ce.coll_allgather(np.full((2, 3), float(r)))
            assert h.wait(timeout=30)
            return np.array(h.result())

        out = _run_all(engines, go)
        for r in range(N):
            np.testing.assert_array_equal(out[r], exp)
        outs.append(_stats(engines))
    assert outs[0] == outs[1]
    # a torch contribution gathers into a tensor
    _, engines = _fabric(PORT, 4)

    def tgo(r, ce):
        h = ce.coll_allgather(torch.full((2, 3), float(r)))
        assert h.wait(timeout=30)
        return h.result()

    out = _run_all(engines, tgo)
    for r in range(4):
        assert isinstance(out[r], torch.Tensor) and tuple(out[r].shape) == (8, 3)
        np.testing.assert_array_equal(out[r].numpy(), exp[:8])


def test_allgather_unequal_contribution_fails_loudly():
    """A rank bringing the wrong shape fails the collective on EVERY
    rank with a CollError (advert mismatch at whichever ring step first
    sees the skewed partition) — never a hang, never silent
    corruption."""
    for P in (REF, PORT):
        _, engines = _fabric(P, 4)

        def go(r, ce, P=P):
            size = 8 if r != 2 else 6  # rank 2 brings the wrong shape
            try:
                h = ce.coll_allgather(np.zeros(size))
                h.wait(timeout=10)
                return "ok"
            except P["CollError"] as e:
                return str(e)

        out = _run_all(engines, go)
        for r in range(4):
            assert out[r] != "ok" and "mismatch" in out[r], (P["name"], r, out[r])


@pytest.mark.parametrize("root", [0, 3])
def test_bcast_binomial(root):
    data = np.arange(100, dtype=np.float64) * 2.5
    sent = []
    for P in (REF, PORT):
        _, engines = _fabric(P)

        def go(r, ce):
            arr = data.copy() if r == root else np.zeros_like(data)
            h = ce.coll_bcast(arr, root=root)
            assert h.wait(timeout=30)
            return np.array(h.result())

        out = _run_all(engines, go)
        for r in range(N):
            np.testing.assert_array_equal(out[r], data)
        # binomial: the root stages to at most ceil(log2 N) children
        assert engines[root].coll.stats["blocks_sent"] <= 3
        sent.append(_stats(engines))
    assert sent[0] == sent[1]


# ---------------------------------------------------------------------------
# discipline: ordering, parking, errors, priority
# ---------------------------------------------------------------------------

@BOTH
def test_late_joiner_messages_park(P):
    """Rank 1 joins the collective long after rank 0's adverts arrived:
    they park at the manager and replay at bind (no drops, no hangs)."""
    _, engines = _fabric(P, 2)
    ref = np.arange(6.0) * 3

    def go(r, ce):
        if r == 1:
            time.sleep(0.3)  # rank 0's advert lands before our bind
            # drain what arrived while we were away
            ce.progress_nonblocking()
        h = ce.coll_allreduce(np.arange(6.0) * (r + 1), algo="rd")
        assert h.wait(timeout=30)
        return np.array(h.result())

    out = _run_all(engines, go)
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[1], ref)
    assert engines[1].coll.stats["parked"] >= 1


@BOTH
def test_same_cid_reuse_refused(P):
    _, engines = _fabric(P, 2)
    h = engines[0].coll.allreduce(np.arange(4.0), cid=("x",))
    with pytest.raises(P["CollError"], match="already in flight"):
        engines[0].coll.allreduce(np.arange(4.0), cid=("x",))
    # fail it so the endpoint unbinds (peer 1 never joins this one)
    h._fail("test teardown", notify_peers=False)
    assert engines[0].coll.summary()["ops_inflight"] == 0


@BOTH
def test_peer_failure_propagates(P):
    """A rank that fails its op notifies the group: every peer's wait()
    raises CollError naming the origin rather than timing out."""
    _, engines = _fabric(P, 4)

    def go(r, ce):
        h = ce.coll.allreduce(np.arange(8.0), cid=("f",))
        if r == 2:
            h._fail("synthetic wreck")
            return "failed"
        try:
            h.wait(timeout=20)
            return "ok"
        except P["CollError"] as e:
            return str(e)

    out = _run_all(engines, go)
    # every peer failed NAMING rank 2 — either via the err notification
    # ("peer rank 2: synthetic wreck") or, if its chunk pull raced the
    # wrecked rank's staging teardown, via the failed pull ("segment
    # pull ... from rank 2 failed"); never a timeout
    for r in (0, 1, 3):
        assert "rank 2" in out[r], (r, out[r])
    assert any("synthetic wreck" in out[r] for r in (0, 1, 3)), out


@BOTH
def test_unknown_reduction_op_rejected(P):
    _, engines = _fabric(P, 2)
    with pytest.raises(P["CollError"], match="unknown reduction op"):
        engines[0].coll.allreduce(np.arange(4.0), op="xor")


@BOTH
def test_rank_outside_group_rejected(P):
    _, engines = _fabric(P, 4)
    with pytest.raises(P["CollError"], match="not in collective group"):
        engines[0].coll.allreduce(np.arange(4.0), group=[1, 2])


@BOTH
def test_collective_sends_ride_below_activations(P):
    """Default collective priority is -1: every control/data message the
    op emits sorts BELOW dependency activations (priority 0+) in a
    coalesced frame, so bulk collectives never starve the critical
    path."""
    _, engines = _fabric(P, 2)
    prios = []
    orig = engines[0].send_am

    def spy(tag, dst, payload, priority=0, **kw):
        prios.append(priority)
        return orig(tag, dst, payload, priority=priority, **kw)

    engines[0].send_am = spy

    def go(r, ce):
        h = ce.coll_allreduce(np.arange(64.0) + r)
        assert h.wait(timeout=30)

    _run_all(engines, go)
    assert prios, "rank 0 sent no collective messages?"
    assert all(p == -1 for p in prios), prios


def test_rd_non_power_of_two_falls_back_to_ring():
    ref = sum(np.arange(10.0) + r for r in range(3))
    states = []
    for P in (REF, PORT):
        _, engines = _fabric(P, 3)

        def go(r, ce):
            h = ce.coll_allreduce(np.arange(10.0) + r, algo="rd")
            assert h.wait(timeout=30)
            return np.array(h.result()), h.state()

        out = _run_all(engines, go)
        for r in range(3):
            np.testing.assert_array_equal(out[r][0], ref)
            assert "[ring]" in out[r][1]  # the fallback really engaged
        states.append([out[r][1] for r in range(3)])
    assert states[0] == states[1]


# ---------------------------------------------------------------------------
# the port's own: bfloat16, a failed device combine, where results live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ring", "rd", "gather"])
def test_bf16_allreduce_same_raw_bits(algo):
    """A bfloat16 contribution travels as raw bits and combines as a
    bfloat16 op on both sides (jnp in the reference, torch in the port):
    after a sum both hold the same bits, near the float64 sum — and not
    the bits a ufunc on the ``uint16`` words would give."""
    rng = np.random.default_rng(22)
    f32 = [rng.standard_normal(97).astype(np.float32) for _ in range(4)]
    port_in = [torch.from_numpy(a).to(torch.bfloat16) for a in f32]
    ref_in = [jnp.asarray(a).astype(jnp.bfloat16) for a in f32]
    outs = []
    for P, contribs in ((REF, ref_in), (PORT, port_in)):
        _, engines = _fabric(P, 4)

        def go(r, ce, contribs=contribs):
            h = ce.coll_allreduce(contribs[r], algo=algo)
            assert h.wait(timeout=30)
            return h.result()

        outs.append(_run_all(engines, go, staged=algo == "gather"))
    wide = sum(t.double() for t in port_in).numpy()
    words = [t.view(torch.int16).numpy().view(np.uint16) for t in port_in]
    ufunc_bits = words[0] + words[1] + words[2] + words[3]
    for r in range(4):
        got = outs[1][r]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        bits = got.view(torch.int16).numpy().view(np.uint16)
        ref_bits = np.asarray(outs[0][r]).view(np.uint16)
        assert np.array_equal(bits, ref_bits), (algo, r)
        np.testing.assert_allclose(got.double().numpy(), wide, rtol=0.05, atol=0.05)
        assert not np.array_equal(bits, ufunc_bits)


def test_failed_device_combine_fails_every_rank():
    """A torch combine that raises fails the op on every rank (the
    failing rank notifies its peers); nothing falls back to the host
    ufunc and no result comes out."""
    _, engines = _fabric(PORT, 4)

    def broken(op):
        def fn(a, b, out=None):
            raise RuntimeError("injected combine failure")
        return fn

    engines[1].coll._torch_combiner = broken

    def go(r, ce):
        h = ce.coll_allreduce(torch.arange(64.0) + r)
        try:
            h.wait(timeout=20)
            return "ok", h.state()
        except CollError as e:
            return str(e), h.state()

    out = _run_all(engines, go)
    assert "device combine" in out[1][0] and "injected" in out[1][0]
    for r in (0, 2, 3):
        assert out[r][0] != "ok" and "rank 1" in out[r][0], (r, out[r])
    for ce in engines:
        assert ce.coll.summary()["ops_failed"] == 1
        assert ce.coll.summary()["ops_inflight"] == 0
    assert engines[1].coll.stats["jit_reduces"] == 0


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_result_lives_where_the_contribution_did(kind):
    """A host array's result is an ndarray (the reference's form); a
    tensor's is a tensor of its dtype on its device, for every kind."""
    _, engines = _fabric(PORT, 2)
    mk = (lambda a: a) if kind == "numpy" else torch.from_numpy

    def go(r, ce):
        res = []
        for call in (lambda: ce.coll_allreduce(mk(np.arange(6.0) + r)),
                     lambda: ce.coll_reduce_scatter(mk(np.arange(6.0) + r)),
                     lambda: ce.coll_allgather(mk(np.arange(6.0) + r)),
                     lambda: ce.coll_bcast(mk(np.arange(6.0) + r), root=1)):
            h = call()
            assert h.wait(timeout=30)
            res.append(h.result())
        return res

    out = _run_all(engines, go)
    want = [np.arange(6.0) * 2 + 1, None, np.concatenate([np.arange(6.0), np.arange(6.0) + 1]),
            np.arange(6.0) + 1]
    for r in range(2):
        for i, got in enumerate(out[r]):
            if kind == "numpy":
                assert isinstance(got, np.ndarray)
            else:
                assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
                assert got.dtype == torch.float64
            if want[i] is not None:
                np.testing.assert_array_equal(_host(got), want[i])
        np.testing.assert_array_equal(_host(out[r][1]), (np.arange(6.0) * 2 + 1)[3 * r:3 * r + 3])
    counts = [int(ce.coll.stats["jit_reduces"]) for ce in engines]
    assert counts == ([0, 0] if kind == "numpy" else [2, 2])


# ---------------------------------------------------------------------------
# tests/runtime/test_coll_deferred_fail.py
# ---------------------------------------------------------------------------

class _FakeMgr:
    def __init__(self, grace):
        self.err_grace = grace
        self.stats = collections.Counter()
        self.unbound = []

    def unbind(self, cid):
        self.unbound.append(cid)


class _FakeCE:
    rank = 1

    def send_am(self, *a, **k):
        raise AssertionError("single-rank group never notifies peers")

    def mem_unregister(self, handle):
        pass


def _op(P, grace=5.0):
    """A bare _BaseOp wired to fakes — only the failure plumbing under
    test, no endpoint, no wire."""
    op = object.__new__(P["coll"]._BaseOp)
    op.mgr = _FakeMgr(grace)
    op.ce = _FakeCE()
    op.cid = ("t", 1)
    op.kind = "allgather"
    op.token = 1
    op.priority = -1
    op.group = [1]
    op.trace = 0
    op._lock = threading.RLock()
    op._cv = threading.Condition(op._lock)
    op.done = False
    op.failed = False
    op.fail_reason = None
    op._pending_fail = None
    op._result = None
    op._holders = []
    op._staged = {}
    op.t0 = time.perf_counter()
    op.total_bytes = 0
    return op


@BOTH
def test_deferred_failure_waits_out_the_grace_window(P):
    op = _op(P, grace=30.0)
    op._fail_deferred("segment pull of 'h' from rank 0 failed")
    assert not op.failed                      # parked, not raised
    op._check_pending_fail()                  # deadline far away: no-op
    assert not op.failed and op.fail_reason is None


@BOTH
def test_peer_root_cause_wins_over_parked_reason(P):
    op = _op(P, grace=30.0)
    op._fail_deferred("segment pull of 'h' from rank 0 failed")
    # the origin's err notice lands (on_msg 'err' -> _fail with why)
    op._fail("peer rank 0: advert mismatch nbytes 48 != 64",
             notify_peers=False)
    assert op.failed and "advert mismatch" in op.fail_reason
    # the expired parked reason can never overwrite the root cause
    op._pending_fail = (op._pending_fail[0], time.monotonic() - 1)
    op._check_pending_fail()
    assert "advert mismatch" in op.fail_reason


@BOTH
def test_silent_peer_expires_to_the_parked_reason(P):
    op = _op(P, grace=0.0)                    # 0 = fail immediately
    op._fail_deferred("segment pull of 'h' from rank 0 failed")
    assert not op.failed                      # still parked until polled
    op._check_pending_fail()                  # wait() polls each lap
    assert op.failed and "segment pull" in op.fail_reason
    assert op.mgr.stats["ops_failed"] == 1 and op.mgr.unbound == [op.cid]


@BOTH
def test_second_deferral_and_completion_are_inert(P):
    op = _op(P, grace=0.0)
    op._fail_deferred("first")
    op._fail_deferred("second")               # first parked reason holds
    op.done = True                            # op completed meanwhile
    op._check_pending_fail()
    assert not op.failed                      # a done op never fails late


def test_mca_params_match_the_reference():
    """The four collective parameters: the same names, defaults and
    choices on both packages."""
    _, (rce,) = _fabric(REF, 1)
    _, (pce,) = _fabric(PORT, 1)
    for attr in ("algo", "segment", "pipeline_depth", "priority", "err_grace"):
        assert getattr(pce.coll, attr) == getattr(rce.coll, attr), attr
    for name in ("coll_algo", "coll_segment", "coll_priority", "coll_err_grace"):
        assert port_mca.params.get("runtime", name) == ref_mca.params.get("runtime", name)


# ---------------------------------------------------------------------------
# user_trigger termination across ranks
# ---------------------------------------------------------------------------

@BOTH
def test_user_trigger_each_rank_triggers_its_own_monitor(P):
    """Two ranks, each with a ``user_trigger`` pool of local tasks: no pool
    terminates before its rank's trigger; after each rank triggers its
    own monitor, both terminate."""
    ces = P["inproc"].InprocFabric(2).endpoints()
    ctxs = [P["Context"](nb_cores=2, rank=r, nranks=2, comm=ces[r], **P["ctx_kw"])
            for r in range(2)]
    try:
        pools, done = [], []
        for r, ctx in enumerate(ctxs):
            tp = P["Taskpool"]("ut_mr", termdet="user_trigger")
            tc = P["TaskClass"]("noop", chores=[P["Chore"](
                P["DEV_CPU"], lambda es, t: P["HookReturn"].DONE)])
            tc.release_deps = lambda es, t: []
            tp.add_task_class(tc)
            tp.on_complete = lambda _tp, r=r: done.append(r)
            tp.startup_hook = lambda c, _tp, tc=tc: [P["Task"](_tp, tc, (i,)) for i in range(8)]
            ctx.add_taskpool(tp)
            pools.append(tp)
        for tp in pools:
            assert not tp.wait(timeout=0.3)
        assert not done
        pools[0].tdm.trigger(pools[0])
        assert pools[0].wait(timeout=10)
        assert not pools[1].wait(timeout=0.3)
        pools[1].tdm.trigger(pools[1])
        assert pools[1].wait(timeout=10)
        assert sorted(done) == [0, 1]
    finally:
        for c in ctxs:
            c.fini()


# ---------------------------------------------------------------------------
# tests/dsl/test_collective_task.py: collectives as DTD graph nodes
# ---------------------------------------------------------------------------

from parsec_tpu.data import LocalCollection as RefLC  # noqa: E402
from parsec_tpu.dsl import CollectiveTask as RefCollectiveTask  # noqa: E402
from parsec_tpu.dsl import dtd as ref_dtd  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl import CollectiveTask  # noqa: E402
from parsec_tpu_torch.dsl import dtd as port_dtd  # noqa: E402

from test_torch_multirank import PORT as MR_PORT  # noqa: E402
from test_torch_multirank import REF as MR_REF  # noqa: E402
from test_torch_multirank import run_ranks  # noqa: E402

REF.update(LC=RefLC, CT=RefCollectiveTask, dtd=ref_dtd, mr=MR_REF)
PORT.update(LC=LocalCollection, CT=CollectiveTask, dtd=port_dtd, mr=MR_PORT)
NR = 4


def _mesh_collection(P, rank, name="C", shape=(8,)):
    """One tile per rank, owned by that rank."""
    dc = P["LC"](name, shape=shape, nodes=NR, myrank=rank,
                 init=lambda k: np.zeros(shape))
    dc.rank_of = lambda *key: key[0] % NR
    return dc


def _ctask_graph(P, kind):
    seen = {}
    d = P["dtd"]

    def build(rank, ctx):
        dc = _mesh_collection(P, rank)
        tiles = {r: dc.data_of(r) for r in range(NR)}
        tp = d.DTDTaskpool(ctx, name=f"ctask_{kind}")

        def produce(arr, _r=rank):
            if kind == "bcast":
                arr[:] = np.arange(8.0) * 7 if _r == 2 else 0.0
            elif kind == "seq":
                arr[:] = float(_r + 1)
            else:
                arr[:] = np.arange(8.0) * (_r + 1) / 3

        def consume(arr, _r=rank):
            seen[_r] = np.array(arr, copy=True)

        # SPMD: every rank inserts ALL ranks' produce/consume (remote
        # ones become shadow tasks), exactly like any distributed DTD
        for r in range(NR):
            tp.insert_task(produce if r == rank else (lambda a: None),
                           (tiles[r], d.INOUT | d.AFFINITY), name="produce")
        if kind == "bcast":
            P["CT"].bcast(tp, tiles, root=2)
        else:
            P["CT"].allreduce(tp, tiles)
            if kind == "seq":
                P["CT"].allreduce(tp, tiles, op="max")
        for r in range(NR):
            tp.insert_task(consume if r == rank else (lambda a: None),
                           (tiles[r], d.IN | d.AFFINITY), name="consume")
        return tp

    run_ranks(P["mr"], NR, build, timeout=60)
    return seen


@pytest.mark.parametrize("kind", ["allreduce", "bcast", "seq"])
def test_collective_task_nodes_order_in_graph(kind):
    """produce -> collective -> consume per rank (the reference's
    allreduce, bcast and two-allreduces-in-sequence cases): every consume
    observes the collective's result, the same bits as the reference's."""
    port, ref = _ctask_graph(PORT, kind), _ctask_graph(REF, kind)
    want = {"allreduce": sum(np.arange(8.0) * (r + 1) / 3 for r in range(NR)),
            "bcast": np.arange(8.0) * 7, "seq": np.full(8, 10.0)}[kind]
    for r in range(NR):
        np.testing.assert_allclose(port[r], want, rtol=1e-15)
        assert np.array_equal(port[r], ref[r])


@BOTH
def test_collective_task_needs_context(P):
    tp = P["dtd"].DTDTaskpool(None, name="bare")
    with pytest.raises(RuntimeError, match="context-attached"):
        P["CT"].allreduce(tp, {0: None})


@BOTH
def test_collective_task_single_rank_is_identity(P):
    """A 1-rank mesh: the allreduce node is the identity (and must not
    require a comm engine)."""
    seen = {}
    with P["Context"](nb_cores=2, **P["ctx_kw"]) as ctx:
        dc = P["LC"]("C", shape=(4,), init=lambda k: np.arange(4.0))
        tp = P["dtd"].DTDTaskpool(ctx, name="solo")
        P["CT"].allreduce(tp, {0: dc.data_of(0)}, group=[0])

        def consume(a):
            seen[0] = a.copy()

        tp.insert_task(consume, (dc.data_of(0), P["dtd"].IN), name="consume")
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    np.testing.assert_array_equal(seen[0], np.arange(4.0))


def _build_coll_graph(rank, ctx):
    """The explorer's build shape: (taskpool, user)."""
    nr = ctx.nranks
    dc = LocalCollection("X", shape=(6,), nodes=nr, myrank=rank,
                         init=lambda k: np.zeros(6))
    dc.rank_of = lambda *key: key[0] % nr
    tiles = {r: dc.data_of(r) for r in range(nr)}
    tp = port_dtd.DTDTaskpool(ctx, name="coll_explore")

    def produce(arr, _r=rank):
        arr[:] = np.arange(6.0) + 10.0 * _r

    for r in range(nr):
        tp.insert_task(produce if r == rank else (lambda a: None),
                       (tiles[r], port_dtd.INOUT | port_dtd.AFFINITY), name="produce")
    CollectiveTask.allreduce(tp, tiles)
    return tp, dc


def test_explorer_collective_graph_identical_and_raceless():
    """4 seeds of pop-order/timing/frame-delivery perturbation on the
    CollectiveTask graph: every seed quiesces, tiles are bit-identical,
    hb-check is clean (the collective's HB_FRAME edges order its
    completions)."""
    from parsec_tpu_torch.analysis.schedules import explore

    def snap(users):
        return [(u.myrank, np.asarray(u.data_of(u.myrank).newest_copy().payload).tobytes())
                for u in users]

    # the explorer's contexts attach the CUDA module as any Context does:
    # bind it to the torch CPU device
    port_mca.set_param("device", "cuda_torch_device", "cpu")
    try:
        res = explore(_build_coll_graph, nranks=2, seeds=range(4), timeout=90,
                      snapshot=snap)
    finally:
        port_mca.unset("device", "cuda_torch_device")
    assert res.identical
    assert res.race_findings() == []
    ref = (np.arange(6.0) + (np.arange(6.0) + 10.0)).tobytes()
    for rank, raw in res.digests[res.seeds[0]]:
        assert raw == ref, (rank, np.frombuffer(raw))
