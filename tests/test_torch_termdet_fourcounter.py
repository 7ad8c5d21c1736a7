"""The port's four-counter termination detector
(parsec_tpu_torch.comm.termdet_fourcounter) against the JAX package's: the
multi-rank cases of ``tests/runtime/test_termdet_recursive.py`` on both
packages — the wave protocol (two balanced, identical waves to conclude),
stale waves ignored, the piggyback channel (zero dedicated messages while
application traffic flows), the production wiring (a 2-rank PTG chain
under ``termdet="fourcounter"`` driven by the idle loop), and the
single-slot engine (a second pool falls back to local termdet; a dynamic
one is refused).  The dedicated-message and suppression counts are the
JAX package's, compared number for number.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import comm as ref_comm  # noqa: E402
from parsec_tpu.comm.termdet_fourcounter import TermDetFourCounter as RefFC  # noqa: E402
from parsec_tpu.core.termdet import TermDetLocal as RefLocal  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLC  # noqa: E402
from parsec_tpu.dsl import ptg as ref_ptg  # noqa: E402
from parsec_tpu_torch import comm as port_comm  # noqa: E402
from parsec_tpu_torch.comm.termdet_fourcounter import TermDetFourCounter  # noqa: E402
from parsec_tpu_torch.core.termdet import TermDetLocal  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl import ptg as port_ptg  # noqa: E402

REF = dict(comm=ref_comm, FC=RefFC, Local=RefLocal, LC=RefLC, ptg=ref_ptg,
           Context=parsec_tpu.Context, Taskpool=parsec_tpu.Taskpool,
           ctx_kw={})
PORT = dict(comm=port_comm, FC=TermDetFourCounter, Local=TermDetLocal,
            LC=LocalCollection, ptg=port_ptg, Context=parsec_tpu_torch.Context,
            Taskpool=parsec_tpu_torch.Taskpool, ctx_kw={"devices": ["cpu"]})
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


class _FakeTp:
    auto_count = False
    name = "fake"


def _mons(P, n, nb_tasks):
    ces = P["comm"].InprocFabric(n).endpoints()
    mons = [P["FC"]().bind(ces[r]) for r in range(n)]
    tps = [_FakeTp() for _ in range(n)]
    fired = []
    for r, m in enumerate(mons):
        m.monitor_taskpool(tps[r], lambda tp, r=r: fired.append(r))
        m.taskpool_set_nb_tasks(tps[r], nb_tasks)
        m.taskpool_ready(tps[r])
    return ces, mons, tps, fired


def _waves(P):
    ces, mons, tps, fired = _mons(P, 3, 1)
    steps = []

    def drain():
        for _ in range(5):
            for ce in ces:
                ce.progress_nonblocking()

    mons[0].initiate_wave(force=True)  # all ranks busy
    drain()
    steps.append(list(fired))
    mons[1].taskpool_addto_nb_tasks(tps[1], -1)
    mons[1].note_message_sent()
    mons[0].taskpool_addto_nb_tasks(tps[0], -1)
    mons[0].initiate_wave(force=True)  # rank 2 busy, counts unbalanced
    drain()
    steps.append(list(fired))
    mons[2].note_message_recv()
    mons[2].taskpool_addto_nb_tasks(tps[2], -1)
    mons[0].initiate_wave(force=True)  # first balanced wave: records
    drain()
    steps.append(list(fired))
    mons[0].initiate_wave(force=True)  # second identical one: terminates
    drain()
    steps.append(sorted(fired))
    assert all(m.is_terminated(tp) for m, tp in zip(mons, tps))
    return steps, [m.dedicated_sent for m in mons]


def test_fourcounter_waves_detect_quiescence():
    """Termination is declared only after the counts balance and two
    waves agree — at the same step, with the same dedicated messages, on
    both packages."""
    ref, port = _waves(REF), _waves(PORT)
    assert port[0] == [[], [], [], [0, 1, 2]]
    assert port == ref


@BOTH
def test_fourcounter_stale_wave_ignored(P):
    ces, mons, tps, fired = _mons(P, 2, 0)
    mons[0].initiate_wave()
    mons[0].initiate_wave()  # supersedes the first; its replies are stale
    for _ in range(6):
        for ce in ces:
            ce.progress_nonblocking()
    mons[0].initiate_wave()
    for _ in range(6):
        for ce in ces:
            ce.progress_nonblocking()
    assert sorted(set(fired)) == [0, 1]


def _piggyback(P):
    ces, mons, tps, fired = _mons(P, 3, 1)
    TAG_CTL = P["comm"].TAG_CTL
    for ce in ces:
        ce.register_am(TAG_CTL, lambda src, p: None)

    def drain():
        for ce in ces:
            ce.progress_nonblocking()

    for step in range(6):
        src, dst = step % 3, (step + 1) % 3
        mons[src].note_message_sent()
        ces[src].send_am(TAG_CTL, dst, {"step": step})
        drain()
        mons[dst].note_message_recv()
        mons[0].initiate_wave()
        drain()
    steady = ([m.dedicated_sent for m in mons], mons[0].waves_suppressed,
              2 in mons[0]._peer_states, list(fired))
    for r, m in enumerate(mons):
        m.taskpool_addto_nb_tasks(tps[r], -1)
    for _ in range(8):
        mons[0].initiate_wave()
        for _ in range(4):
            drain()
        if fired:
            break
    return steady, sorted(set(fired)), sum(m.dedicated_sent for m in mons)


def test_termdet_piggyback_zero_dedicated_in_steady_state():
    """While application traffic flows the detector sends ZERO dedicated
    messages (its state rides the app frames); dedicated traffic is the
    confirming waves alone — the JAX package's counts exactly."""
    ref, port = _piggyback(REF), _piggyback(PORT)
    (ded, suppressed, saw2, fired_early), fired, total = port
    assert ded == [0, 0, 0] and suppressed >= 6 and saw2 and not fired_early
    assert fired == [0, 1, 2] and 0 < total <= 3 * 2 * 2 + 2
    assert port == ref


def _chain_pool(P, r, nranks, n, name, local=False):
    g_ = P["ptg"]
    dc = P["LC"](f"D{name}", shape=(4,), nodes=nranks, myrank=r,
                 init=lambda k: np.zeros(4))
    dc.rank_of = (lambda *key: 0) if local \
        else (lambda *key: dc.data_key(*key) % nranks)
    g = g_.PTG(name)
    step = g.task_class("step", k=f"0 .. {n - 1}")
    step.affinity("D(k)")
    step.flow("X", g_.INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
              f"-> (k < {n - 1}) ? X step(k+1) : D(k)")
    step.body(cpu=lambda X, k: X.__iadd__(1.0))
    return g.taskpool(termdet="fourcounter", D=dc), dc


@BOTH
def test_fourcounter_production_wiring_end_to_end(P):
    """A 2-rank PTG chain under ``termdet="fourcounter"``: the monitor
    binds to the engine at add_taskpool, app messages are counted at the
    engine, the idle loop's wave driver concludes, and the engine's slot
    is released at the declaration."""
    nranks, n = 2, 8
    ces = P["comm"].InprocFabric(nranks).endpoints()
    ctxs = [P["Context"](nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                         **P["ctx_kw"]) for r in range(nranks)]
    oks, finals = [None] * nranks, {}

    def worker(r):
        tp, dc = _chain_pool(P, r, nranks, n, "fcchain")
        assert type(tp.tdm).__name__ == "TermDetFourCounter"
        ctxs[r].add_taskpool(tp)
        oks[r] = tp.wait(timeout=60)
        finals[r] = dc

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(nranks)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
    try:
        assert all(oks), oks
        assert getattr(ces[0], "_termdet_bound", None) is None
        got = finals[(n - 1) % nranks].data_of(n - 1).newest_copy().payload
        np.testing.assert_array_equal(np.asarray(got), np.full(4, float(n)))
    finally:
        for c in ctxs:
            c.fini()


@BOTH
def test_second_fourcounter_pool_falls_back_to_local(P):
    """The engine's termdet slot is single: a second concurrent managed
    pool falls back to local termdet; a dynamic one is refused."""
    nranks, n = 2, 6
    ces = P["comm"].InprocFabric(nranks).endpoints()
    ctxs = [P["Context"](nb_cores=2, rank=r, nranks=nranks, comm=ces[r],
                         **P["ctx_kw"]) for r in range(nranks)]
    oks = [None] * nranks

    def worker(r):
        tp1, _ = _chain_pool(P, r, nranks, n, "fc1")
        tp2, _ = _chain_pool(P, r, nranks, n, "fc2")
        ctxs[r].add_taskpool(tp1)
        ctxs[r].add_taskpool(tp2)
        assert isinstance(tp2.tdm, P["Local"]), type(tp2.tdm).__name__
        oks[r] = tp1.wait(timeout=60) and tp2.wait(timeout=60)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(nranks)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    for c in ctxs:
        c.fini()
    assert all(oks), oks

    ctx1 = P["Context"](nb_cores=2, rank=0, nranks=1,
                        comm=P["comm"].InprocFabric(1).endpoints()[0],
                        **P["ctx_kw"])
    try:
        hold = P["Taskpool"](name="hold", termdet="fourcounter", nb_tasks=0)
        hold.tdm.taskpool_addto_runtime_actions(hold, 1)  # keep it busy
        ctx1.add_taskpool(hold)
        dyn = P["Taskpool"](name="dyn", termdet="fourcounter")
        assert dyn.auto_count
        with pytest.raises(RuntimeError, match="fourcounter"):
            ctx1.add_taskpool(dyn)
        hold.tdm.taskpool_addto_runtime_actions(hold, -1)
        assert hold.wait(timeout=60)
    finally:
        ctx1.fini()
