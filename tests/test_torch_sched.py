"""The port's scheduler family (parsec_tpu_torch.core.sched), compound and
recursive taskpools, against the JAX package's.

* the reference's ``tests/runtime/test_chain.py`` cases (chain, the
  fan-out under every scheduler — all twelve here —, AGAIN, compose,
  scoped wait, dynamic counts), ``test_multichain.py`` and
  ``test_termdet_recursive.py``'s recursive-taskpool and lhq cases, each
  run on both packages with equal results;
* pop order: at one worker every scheduler runs a priority-mixed DAG in
  the same order in both packages (``rnd`` seeded by its MCA parameter),
  and with ``sched_native_queue=1`` ``spq`` and ``wdrr`` pop as their
  Python state does, and as the reference's native queue does;
* ``Context(scheduler=...)`` and ``PARSEC_MCA_mca_sched`` select each one.
"""

import threading
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import native as ref_native  # noqa: E402
from parsec_tpu.core.deps import DepTracker as RefDepTracker  # noqa: E402
from parsec_tpu.core.recursive import recursive_invoke as ref_recursive_invoke  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.dsl import compile_jdf as ref_compile_jdf  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch import mca_param, native  # noqa: E402
from parsec_tpu_torch.core.deps import DepTracker  # noqa: E402
from parsec_tpu_torch.core.recursive import recursive_invoke  # noqa: E402
from parsec_tpu_torch.core.sched.more import SchedLHQ  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl import compile_jdf  # noqa: E402
from parsec_tpu_torch.utils import component_names  # noqa: E402

SCHEDULERS = ["lfq", "gd", "ap", "ll", "rnd", "spq", "llp", "ltq", "pbq",
              "lhq", "ip", "wdrr"]

REF = types.SimpleNamespace(
    name="ref", pkg=parsec_tpu, mca=ref_mca, DepTracker=RefDepTracker,
    recursive_invoke=ref_recursive_invoke, LC=RefLocalCollection,
    compile_jdf=ref_compile_jdf,
    Context=lambda n, **kw: parsec_tpu.Context(nb_cores=n, devices=["cpu"], **kw))
PORT = types.SimpleNamespace(
    name="port", pkg=parsec_tpu_torch, mca=mca_param, DepTracker=DepTracker,
    recursive_invoke=recursive_invoke, LC=LocalCollection,
    compile_jdf=compile_jdf,
    Context=lambda n, **kw: parsec_tpu_torch.Context(nb_cores=n, devices=["cpu"], **kw))


def both(scenario):
    return [scenario(P) for P in (REF, PORT)]


def make_chain_taskpool(P, n, log, lock):
    pkg = P.pkg
    tp = pkg.Taskpool("chain", nb_tasks=n)

    def body(es, task):
        with lock:
            log.append(task.locals[0])
        return pkg.HookReturn.DONE

    tc = pkg.TaskClass("step", chores=[pkg.Chore(pkg.DEV_CPU, body)], nb_parameters=1)

    def release_deps(es, task):
        k = task.locals[0]
        return [pkg.Task(tp, tc, (k + 1,))] if k + 1 < n else []

    tc.release_deps = release_deps
    tp.add_task_class(tc)
    tp.startup_hook = lambda ctx, tp_: [pkg.Task(tp_, tc, (0,))]
    return tp


# ---------------------------------------------------------------------------
# tests/runtime/test_chain.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb_cores", [1, 4])
def test_chain_runs_in_order(nb_cores):
    def scenario(P):
        log, lock = [], threading.Lock()
        with P.Context(nb_cores) as ctx:
            ctx.add_taskpool(make_chain_taskpool(P, 50, log, lock))
            assert ctx.wait(timeout=30)
        return log

    res = both(scenario)
    assert res[0] == res[1] == list(range(50))


def fanout(P, sched, n=64, nb_cores=4):
    """Diamond: root -> n middles -> sink, counter-mode dep on the sink."""
    pkg = P.pkg
    done = []
    lock = threading.Lock()
    tp = pkg.Taskpool("fanout", nb_tasks=n + 2)
    deps = P.DepTracker()

    def mid_body(es, task):
        with lock:
            done.append(task.locals[0])
        return pkg.HookReturn.DONE

    def sink_body(es, task):
        with lock:
            done.append("sink")
        return pkg.HookReturn.DONE

    sink_tc = pkg.TaskClass("sink", chores=[pkg.Chore(pkg.DEV_CPU, sink_body)])
    mid_tc = pkg.TaskClass("mid", chores=[pkg.Chore(pkg.DEV_CPU, mid_body)],
                           nb_parameters=1)
    root_tc = pkg.TaskClass("root", chores=[pkg.Chore(
        pkg.DEV_CPU, lambda es, t: pkg.HookReturn.DONE)])

    def mid_release(es, task):
        ready, _ = deps.release_counter(("sink",), n)
        return [pkg.Task(tp, sink_tc)] if ready else []

    root_tc.release_deps = lambda es, t: [pkg.Task(tp, mid_tc, (i,), priority=(i * 7) % 13)
                                          for i in range(n)]
    mid_tc.release_deps = mid_release
    for tc in (root_tc, mid_tc, sink_tc):
        tp.add_task_class(tc)
    tp.startup_hook = lambda ctx, tp_: [pkg.Task(tp_, root_tc)]
    with P.Context(nb_cores, scheduler=sched) as ctx:
        assert ctx.scheduler.mca_name == sched
        ctx.add_taskpool(tp)
        assert ctx.wait(timeout=30)
    return done


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_all_schedulers_run_fanout(sched):
    res = both(lambda P: fanout(P, sched))
    for done in res:
        assert done[-1] == "sink"
        assert sorted(done[:-1]) == list(range(64))


def test_again_reschedules():
    """A task returning AGAIN runs again later (scheduling.c:495-502)."""
    def scenario(P):
        pkg = P.pkg
        attempts = []
        tp = pkg.Taskpool("again", nb_tasks=1)

        def body(es, task):
            attempts.append(task.priority)
            if len(attempts) < 3:
                return pkg.HookReturn.AGAIN
            return pkg.HookReturn.DONE

        tc = pkg.TaskClass("flaky", chores=[pkg.Chore(pkg.DEV_CPU, body)])
        tp.add_task_class(tc)
        tp.startup_hook = lambda ctx, tp_: [pkg.Task(tp_, tc, priority=5)]
        with P.Context(2) as ctx:
            ctx.add_taskpool(tp)
            assert ctx.wait(timeout=30)
        return attempts

    res = both(scenario)
    assert res[0] == res[1] == [5, 4, 3]  # each AGAIN demotes the priority


def test_compose_sequences_taskpools():
    def scenario(P):
        pkg = P.pkg
        order = []
        lock = threading.Lock()

        def mk(tag):
            tp = pkg.Taskpool(tag, nb_tasks=1)

            def body(es, task):
                with lock:
                    order.append(tag)
                return pkg.HookReturn.DONE

            tc = pkg.TaskClass(tag, chores=[pkg.Chore(pkg.DEV_CPU, body)])
            tp.add_task_class(tc)
            tp.startup_hook = lambda ctx, tp_: [pkg.Task(tp_, tc)]
            return tp

        comp = pkg.compose(pkg.compose(mk("a"), mk("b")), mk("c"))
        assert isinstance(comp, pkg.CompoundTaskpool)
        assert len(comp.members) == 3
        with P.Context(2) as ctx:
            ctx.add_taskpool(comp)
            assert ctx.wait(timeout=30)
        assert comp.nb_retired == 3
        return order

    res = both(scenario)
    assert res[0] == res[1] == ["a", "b", "c"]


def test_taskpool_wait_scoped():
    """Waiting on one pool while another is active."""
    def scenario(P):
        tp1 = make_chain_taskpool(P, 10, [], threading.Lock())
        log2 = []
        tp2 = make_chain_taskpool(P, 200, log2, threading.Lock())
        with P.Context(2) as ctx:
            ctx.add_taskpool(tp2)
            ctx.add_taskpool(tp1)
            assert tp1.wait(timeout=30)
            assert tp1.is_done()
            assert ctx.wait(timeout=30)
            assert tp2.is_done()
        return log2

    res = both(scenario)
    assert res[0] == res[1] == list(range(200))


def test_dynamic_task_counts():
    """A task count discovered at run time: nb_tasks grows as tasks are
    released from within tasks."""
    def scenario(P):
        pkg = P.pkg
        tp = pkg.Taskpool("dyn")
        tp.tdm.taskpool_set_nb_tasks(tp, 1)
        seen = []
        lock = threading.Lock()
        tc = pkg.TaskClass("t", nb_parameters=1)

        def body(es, task):
            with lock:
                seen.append(task.locals[0])
            return pkg.HookReturn.DONE

        def release(es, task):
            k = task.locals[0]
            if k < 20:
                tp.tdm.taskpool_addto_nb_tasks(tp, 1)
                return [pkg.Task(tp, tc, (k + 1,))]
            return []

        tc.chores.append(pkg.Chore(pkg.DEV_CPU, body))
        tc.release_deps = release
        tp.add_task_class(tc)
        tp.startup_hook = lambda ctx, tp_: [pkg.Task(tp_, tc, (0,))]
        with P.Context(2) as ctx:
            ctx.add_taskpool(tp)
            assert ctx.wait(timeout=30)
        return seen

    res = both(scenario)
    assert res[0] == res[1] == list(range(21))


# ---------------------------------------------------------------------------
# tests/runtime/test_multichain.py
# ---------------------------------------------------------------------------

MULTICHAIN = """
descA [ type = "collection" ]
descB [ type = "collection" ]
NI    [ type = int ]
NJ    [ type = int ]

HORIZONTAL(i)

i = 0 .. NI-1

: descA( i )

READ A <- descA( i )
       -> A VERTICAL( i, 0 )
RW   B <- (i == 0) ? descB( 0 ) : B HORIZONTAL( i-1 )
       -> (i != NI-1) ? B HORIZONTAL( i+1 )

BODY
{
    stamp("H", i, -1)
}
END

VERTICAL(i, j)

i = 0 .. NI-1
j = 0 .. NJ-1

: descA( i )

READ A <- (j == 0) ? A HORIZONTAL( i ) : A VERTICAL( i, j-1 )
       -> (j != NJ-1) ? A VERTICAL( i, j+1 )
RW   B <- (i == 0) ? descB( 1 ) : B VERTICAL( i-1, j )
       -> (i != NI-1) ? B VERTICAL( i+1, j )

BODY
{
    stamp("V", i, j)
}
END
"""


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_multichain_causality(sched, monkeypatch):
    """The scheduler is chosen by ``PARSEC_MCA_mca_sched``, as in the
    reference (which sweeps lfq and gd; the port sweeps all twelve)."""
    NI, NJ = 5, 4

    def scenario(P):
        monkeypatch.setenv("PARSEC_MCA_mca_sched", sched)
        P.mca.params.reset()
        clock = {"t": 0}
        order, counts = {}, {}
        lock = threading.Lock()

        def stamp(kind, i, j):
            with lock:
                clock["t"] += 1
                order[(kind, i, j)] = clock["t"]
                counts[(kind, i, j)] = counts.get((kind, i, j), 0) + 1

        j = P.compile_jdf(MULTICHAIN, "multichain", namespace={"stamp": stamp})
        descA = P.LC("descA", shape=(1,), init=lambda k: np.zeros(1))
        descB = P.LC("descB", shape=(1,), init=lambda k: np.zeros(1))
        try:
            with P.Context(4) as ctx:
                assert ctx.scheduler.mca_name == sched
                tp = j.new(descA=descA, descB=descB, NI=NI, NJ=NJ)
                ctx.add_taskpool(tp)
                assert tp.wait(timeout=60)
        finally:
            monkeypatch.delenv("PARSEC_MCA_mca_sched")
            P.mca.params.reset()
        assert len(order) == NI + NI * NJ
        assert all(c == 1 for c in counts.values())

        def before(a, b):
            assert order[a] < order[b], f"{a} must precede {b}"

        for i in range(NI):
            if i + 1 < NI:
                before(("H", i, -1), ("H", i + 1, -1))
            before(("H", i, -1), ("V", i, 0))
            for jj in range(NJ):
                if jj + 1 < NJ:
                    before(("V", i, jj), ("V", i, jj + 1))
                if i + 1 < NI:
                    before(("V", i, jj), ("V", i + 1, jj))
        return sorted(counts)

    res = both(scenario)
    assert res[0] == res[1]


# ---------------------------------------------------------------------------
# tests/runtime/test_termdet_recursive.py
# ---------------------------------------------------------------------------

def test_recursive_taskpool_completes_parent():
    def scenario(P):
        pkg = P.pkg
        order = []
        lock = threading.Lock()
        with P.Context(2) as ctx:
            parent = pkg.Taskpool("parent", nb_tasks=2)

            def leaf_body(es, task):
                with lock:
                    order.append(("leaf", task.locals[0]))
                return pkg.HookReturn.DONE

            def spawner_body(es, task):
                sub = pkg.Taskpool("sub", nb_tasks=3)
                ltc = pkg.TaskClass("leaf", chores=[pkg.Chore(pkg.DEV_CPU, leaf_body)],
                                    nb_parameters=1)
                sub.add_task_class(ltc)
                sub.startup_hook = lambda c, t: [pkg.Task(t, ltc, (i,)) for i in range(3)]
                return P.recursive_invoke(es, task, sub)

            def after_body(es, task):
                with lock:
                    order.append(("after",))
                return pkg.HookReturn.DONE

            spawn_tc = pkg.TaskClass("spawn", chores=[pkg.Chore(pkg.DEV_CPU, spawner_body)])
            after_tc = pkg.TaskClass("after", chores=[pkg.Chore(pkg.DEV_CPU, after_body)])
            spawn_tc.release_deps = lambda es, t: [pkg.Task(parent, after_tc)]
            parent.add_task_class(spawn_tc)
            parent.add_task_class(after_tc)
            parent.startup_hook = lambda c, t: [pkg.Task(t, spawn_tc)]
            ctx.add_taskpool(parent)
            assert ctx.wait(timeout=30)
        assert order[-1] == ("after",)
        return sorted(o[1] for o in order if o[0] == "leaf")

    res = both(scenario)
    assert res[0] == res[1] == [0, 1, 2]


def test_lhq_priority_order():
    """LHQ pops the highest priority first within a batch."""
    class _Ctx:
        nb_workers = 2

    class _ES:
        worker_id = 0

    out = []
    for cls in (parsec_tpu.core.sched.more.SchedLHQ, SchedLHQ):
        s = cls()
        s.install(_Ctx())
        s.schedule(_ES(), [types.SimpleNamespace(priority=p) for p in (1, 5, 3)],
                   distance=0)
        out.append([s.select(_ES()).priority for _ in range(3)])
    assert out[0] == out[1] == [5, 3, 1]


# ---------------------------------------------------------------------------
# pop order at one worker, both packages; the native ready queue
# ---------------------------------------------------------------------------

def pop_order(P, sched, tenants=None):
    """Execution order at ONE worker of a DAG whose ready sets mix
    priorities: a root releases 24 mids (priorities (7i) % 11), each mid
    ``i`` releases a leaf of priority ``i % 5``.  ``tenants`` runs two
    such pools at once, tagged (tenant, weight) each, for ``wdrr``."""
    pkg = P.pkg
    order = []
    pools = []
    for i, tenant in enumerate(tenants or [(None, 1)]):
        name = f"p{i}"
        tp = pkg.Taskpool(name, nb_tasks=1 + 24 + 24)
        if tenant[0] is not None:
            tp.tenant, tp.tenant_weight = tenant

        def body(es, task, _n=name):
            order.append((_n, task.task_class.name) + tuple(task.locals))
            return pkg.HookReturn.DONE

        leaf = pkg.TaskClass("leaf", chores=[pkg.Chore(pkg.DEV_CPU, body)], nb_parameters=1)
        mid = pkg.TaskClass("mid", chores=[pkg.Chore(pkg.DEV_CPU, body)], nb_parameters=1)
        root = pkg.TaskClass("root", chores=[pkg.Chore(pkg.DEV_CPU, body)])
        root.release_deps = (lambda _tp, _mid: lambda es, t: [
            pkg.Task(_tp, _mid, (i,), priority=(7 * i) % 11) for i in range(24)])(tp, mid)
        mid.release_deps = (lambda _tp, _leaf: lambda es, t: [
            pkg.Task(_tp, _leaf, t.locals, priority=t.locals[0] % 5)])(tp, leaf)
        for tc in (root, mid, leaf):
            tp.add_task_class(tc)
        tp.startup_hook = (lambda _root: lambda ctx, tp_: [pkg.Task(tp_, _root)])(root)
        pools.append(tp)
    with P.Context(1, scheduler=sched) as ctx:
        for tp in pools:
            ctx.add_taskpool(tp)
        assert ctx.wait(timeout=30)
    return order


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_one_worker_pop_order_matches_reference(sched):
    for P in (REF, PORT):
        P.mca.set_param("sched", "rnd_seed", 7)
    try:
        res = both(lambda P: pop_order(P, sched))
    finally:
        for P in (REF, PORT):
            P.mca.params.unset("sched", "rnd_seed")
    assert len(res[1]) == 49
    assert res[0] == res[1]


@pytest.mark.parametrize("sched,tenants", [
    ("spq", None),
    ("wdrr", None),
    ("wdrr", [("a", 1), ("b", 3)]),
])
def test_native_queue_pops_as_python_state(sched, tenants):
    """``sched_native_queue=1``: the ready-queue state lives in the native
    engine, and the pop order equals the Python state's, in the port and
    in the reference."""
    def with_queue(P, on):
        P.mca.set_param("sched", "native_queue", on)
        try:
            with P.Context(1, scheduler=sched) as ctx:
                assert (ctx.scheduler._nq is not None) == bool(on)
            return pop_order(P, sched, tenants)
        finally:
            P.mca.params.unset("sched", "native_queue")

    if not ref_native.available():
        pytest.fail(f"reference native core unavailable: {ref_native.build_error()}")
    py = with_queue(PORT, 0)
    nat = with_queue(PORT, 1)
    assert len(py) == 49 * (len(tenants) if tenants else 1)
    assert nat == py
    assert with_queue(REF, 1) == nat


def test_native_ready_queue_matches_reference():
    """The port's NativeReadyQueue over its own build of the engine pops a
    seeded push sequence exactly as the reference's does (prio and wdrr)."""
    rng = np.random.default_rng(3)
    pushes = [(int(p), int(d), int(t)) for p, d, t in zip(
        rng.integers(0, 5, 200), rng.integers(0, 3, 200), rng.integers(1, 4, 200))]
    for policy in ("prio", "wdrr"):
        outs = []
        for mod in (ref_native, native):
            q = mod.NativeReadyQueue(policy=policy, quantum=2)
            if policy == "wdrr":
                for t, w in ((1, 1), (2, 2), (3, 3)):
                    q.set_tenant_weight(t, w)
            popped = []
            for h, (p, d, t) in enumerate(pushes):
                q.push(p, h, distance=d, tenant=t)
                if h % 3 == 2:
                    popped.append(q.pop())
            assert q.count() == 200 - len(popped)
            while True:
                h = q.pop()
                if h < 0:
                    break
                popped.append(h)
            q.close()
            outs.append(popped)
        assert sorted(outs[1]) == list(range(200))
        assert outs[0] == outs[1]


def test_every_scheduler_selectable(monkeypatch):
    assert sorted(component_names("sched")) == sorted(SCHEDULERS)
    for sched in SCHEDULERS:
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"], scheduler=sched) as ctx:
            assert ctx.scheduler.mca_name == sched
    monkeypatch.setenv("PARSEC_MCA_mca_sched", "gd")
    mca_param.params.reset()
    try:
        with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
            assert ctx.scheduler.mca_name == "gd"
    finally:
        monkeypatch.delenv("PARSEC_MCA_mca_sched")
        mca_param.params.reset()
