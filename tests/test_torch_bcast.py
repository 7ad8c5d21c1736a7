"""Aggregated activations and broadcast topologies of the port's
remote-dep protocol (parsec_tpu_torch.comm.remote_dep) against the JAX
package's: the four cases of ``tests/runtime/test_bcast.py``, each on
both packages over the same seeded inputs, with the same comm counts
pinned — one activation per (task, rank) carrying each flow's payload
once; a lost payload failing the pool on every rank fast; exactly-once
delivery down star, chain and binomial trees with the task's priority
inherited by every forward; and the root's fan-out per topology.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_multirank import BOTH, run_ranks  # noqa: E402


class _params:
    def __init__(self, P, **kw):
        self.mca, self.kw = P["mca"], kw

    def __enter__(self):
        for k, v in self.kw.items():
            self.mca.set_param("runtime", k, v)

    def __exit__(self, *exc):
        for k in self.kw:
            self.mca.params.unset("runtime", k)


@BOTH
def test_activation_aggregation_one_message_per_rank(P):
    """Two data flows fanning out to three successors on one remote rank:
    ONE activation carrying both payloads once."""
    nranks = 2
    got = {}
    g_ = P["ptg"]

    def build(rank, ctx):
        dc = P["LC"]("D", shape=(4,), nodes=nranks, myrank=rank,
                     init=lambda k: np.full(4, 1.0 + k))
        dc.rank_of = lambda *key: 0 if key[0] < 2 else 1
        g = g_.PTG("agg")
        src = g.task_class("src")
        src.affinity("D(0)")
        src.flow("X", g_.INOUT, "<- D(0)", "-> X a(0)", "-> X b(0)")
        src.flow("Y", g_.INOUT, "<- D(1)", "-> Y a(0)")

        def src_body(X, Y):
            X += 10.0
            Y += 20.0

        src.body(cpu=src_body)

        def a_body(X, Y, i):
            got.setdefault("a", (float(X[0]), float(Y[0])))

        a = g.task_class("a", i="0 .. 0")
        a.affinity("D(2)")
        a.flow("X", g_.IN, "<- X src()")
        a.flow("Y", g_.IN, "<- Y src()")
        a.body(cpu=a_body)

        def b_body(X, i):
            got.setdefault("b", float(X[0]))

        b = g.task_class("b", i="0 .. 0")
        b.affinity("D(3)")
        b.flow("X", g_.IN, "<- X src()")
        b.body(cpu=b_body)
        return g.taskpool(D=dc)

    ctxs = run_ranks(P, nranks, build, timeout=30)
    assert got == {"a": (11.0, 22.0), "b": 11.0}
    rd0 = ctxs[0].comm.remote_dep
    assert rd0.stats["activations_sent"] == 1, dict(rd0.stats)
    assert rd0.stats["inline_sent"] == 2, dict(rd0.stats)
    assert ctxs[1].comm.remote_dep.stats["activations_recv"] == 1


@BOTH
def test_failed_get_fails_pool_fast(P):
    """A permanently lost payload (a pull against a never-registered
    handle) fails the pool promptly on every rank — the consumer and the
    owner of its write-back's home tile — never by exhausting wait()."""
    nranks = 3
    g_ = P["ptg"]
    with _params(P, comm_short_limit=8):
        fabric = P["comm"].InprocFabric(nranks)
        ces = fabric.endpoints()
        ces[0].mem_register = lambda *a, **k: None  # sabotage the producer
        ctxs = [P["Context"](nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                             **P["ctx_kw"]) for r in range(nranks)]
        waits = {}

        def build(rank, ctx):
            dc = P["LC"]("D", shape=(64,), nodes=nranks, myrank=rank,
                         init=lambda k: np.full(64, 1.0))
            dc.rank_of = lambda *key: dc.data_key(*key) % nranks
            g = g_.PTG("lost")
            src = g.task_class("src")
            src.affinity("D(0)")
            src.flow("X", g_.INOUT, "<- D(0)", "-> X sink(1)")
            src.body(cpu=lambda X: X.__iadd__(1.0))
            sink = g.task_class("sink", r="1 .. 1")
            sink.affinity("D(r)")
            sink.flow("X", g_.INOUT, "<- X src()", "-> D(2)")
            sink.body(cpu=lambda X, r: None)
            return g.taskpool(D=dc)

        def worker(r):
            tp = build(r, ctxs[r])
            ctxs[r].add_taskpool(tp)
            t0 = time.monotonic()
            ok = tp.wait(timeout=30)
            waits[r] = (ok, time.monotonic() - t0, tp)

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(nranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        try:
            for r in (1, 2):
                ok_r, dt_r, tp_r = waits[r]
                assert not ok_r and tp_r.failed, (r, waits)
                assert dt_r < 10.0, f"rank {r} fail-fast took {dt_r:.1f}s"
                assert ctxs[r].wait(timeout=5)
        finally:
            for c in ctxs:
                c.fini()


def _spied_fabric(P, nranks, sent, lock):
    from importlib import import_module

    TAG_ACTIVATE = import_module(P["comm"].__name__ + ".engine").TAG_ACTIVATE
    fabric = P["comm"].InprocFabric(nranks)
    ces = fabric.endpoints()
    for ce in ces:
        orig = ce.send_am

        def spy(tag, dst, payload, *, priority=0, _ce=ce, _orig=orig, **kw):
            if tag == TAG_ACTIVATE:
                with lock:
                    sent.append((_ce.rank, priority))
            return _orig(tag, dst, payload, priority=priority, **kw)

        ce.send_am = spy
    return ces


@pytest.mark.parametrize("topo", ["star", "chain", "binomial"])
@pytest.mark.parametrize("seed", [11, 23])
@BOTH
def test_broadcast_topology_random_destinations_parity(P, topo, seed):
    """Random destination subsets at 8 ranks: every topology delivers
    exactly once to every destination, and every forward inherits the
    completing task's priority."""
    nranks, prio = 8, 7
    g_ = P["ptg"]
    rng = np.random.default_rng(seed)
    dests = sorted(rng.choice(np.arange(1, nranks), size=5,
                              replace=False).tolist())
    nd = len(dests)
    with _params(P, comm_short_limit=64, bcast_topo=topo):
        sent, lock = [], threading.Lock()
        ces = _spied_fabric(P, nranks, sent, lock)
        ctxs = [P["Context"](nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                             **P["ctx_kw"]) for r in range(nranks)]
        got = {r: [] for r in range(nranks)}

        def build(rank, ctx):
            dc = P["LC"]("D", shape=(256,), nodes=nranks, myrank=rank,
                         init=lambda k: np.full(256, 7.0))
            dc.rank_of = lambda *key: 0 if key[0] == 0 else dests[key[0] - 1]
            g = g_.PTG("bcast_rand")
            src = g.task_class("src")
            src.affinity("D(0)")
            src.priority(str(prio))
            src.flow("X", g_.INOUT, "<- D(0)", "-> X sink(0 .. ND-1)")
            src.body(cpu=lambda X: X.__iadd__(35.0))
            sink = g.task_class("sink", r="0 .. ND-1")
            sink.affinity("D(r+1)")
            sink.flow("X", g_.IN, "<- X src()")
            sink.body(cpu=lambda X, r: got[rank].append(float(X[0])))
            return g.taskpool(ND=nd, D=dc)

        results = {}

        def worker(r):
            tp = build(r, ctxs[r])
            ctxs[r].add_taskpool(tp)
            results[r] = tp.wait(timeout=60)

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(nranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        try:
            assert all(results[r] for r in range(nranks)), results
            for r in range(nranks):
                assert got[r] == [42.0] * dests.count(r), (topo, r, got)
            rds = [c.comm.remote_dep for c in ctxs]
            for r in range(nranks):
                assert rds[r].stats["activations_recv"] == \
                    (1 if r in dests else 0), (topo, r)
            assert sum(rd.stats["activations_sent"] for rd in rds) == nd
            fwd = sum(rd.stats["forwarded"] for rd in rds)
            assert (fwd == 0) if topo == "star" else (fwd > 0), (topo, fwd)
            assert len(sent) == nd and all(p == prio for _r, p in sent)
            if topo != "star":
                assert any(r != 0 for r, _p in sent), (topo, sent)
        finally:
            for c in ctxs:
                c.fini()


@pytest.mark.parametrize("topo,root_sends,root_gets", [
    ("star", 7, 7),
    ("chain", 1, 1),
    ("binomial", 3, 3),   # ceil(log2(8)) payload sends at the root
])
@BOTH
def test_broadcast_topology_counts(P, topo, root_sends, root_gets):
    """1 -> 8 broadcast of an above-limit payload: the root's fan-out is
    the topology's, every rank pulls exactly once, and the use-counted
    registrations self-reclaim."""
    nranks = 8
    g_ = P["ptg"]
    with _params(P, comm_short_limit=64, bcast_topo=topo):
        got = {r: [] for r in range(nranks)}

        def build(rank, ctx):
            dc = P["LC"]("D", shape=(256,), nodes=nranks, myrank=rank,
                         init=lambda k: np.full(256, 7.0))
            dc.rank_of = lambda *key: dc.data_key(*key) % nranks
            g = g_.PTG("bcast")
            src = g.task_class("src")
            src.affinity("D(0)")
            src.flow("X", g_.INOUT, "<- D(0)", "-> X sink(0 .. NR-1)")
            src.body(cpu=lambda X: X.__iadd__(35.0))
            sink = g.task_class("sink", r="0 .. NR-1")
            sink.affinity("D(r)")
            sink.flow("X", g_.IN, "<- X src()")
            sink.body(cpu=lambda X, r: got[rank].append(float(X[0])))
            return g.taskpool(NR=nranks, D=dc)

        ctxs = run_ranks(P, nranks, build, timeout=60)
        for r in range(nranks):
            assert got[r] == [42.0], (r, got)
        rds = [c.comm.remote_dep for c in ctxs]
        for r in range(1, nranks):
            assert rds[r].stats["activations_recv"] == 1
        assert sum(rd.stats["activations_sent"] for rd in rds) == nranks - 1
        assert rds[0].stats["activations_sent"] == root_sends
        assert rds[0].stats["get_advertised"] == root_gets
        assert sum(rd.stats["get_issued"] for rd in rds) == nranks - 1
        fwd = sum(rd.stats["forwarded"] for rd in rds)
        assert (fwd == 0) if topo == "star" else (fwd > 0)
        assert not ctxs[0].comm.fabric.mem, ctxs[0].comm.fabric.mem
