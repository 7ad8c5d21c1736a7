"""The port's observability modules against the JAX package's: the JSON
tracer (``Trace``/``TaskProfiler``/``CommProfiler``), the DOT grapher (the
same DOT text for the same run), the SDE counters and alperf, the live
properties dictionary, ``PrintSteals``, the iterators checker (the
reference's seeded faults found, a clean graph clean), the job trace
helpers, the PINS site names and PINS's copy-on-write subscriber lists.
"""

import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.profiling import checkers as ref_checkers  # noqa: E402
from parsec_tpu.profiling import grapher as ref_grapher  # noqa: E402
from parsec_tpu.profiling import jobtrace as ref_jobtrace  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu.profiling import sde as ref_sde  # noqa: E402
from parsec_tpu.profiling import trace as ref_trace  # noqa: E402
from parsec_tpu_torch import Chore, Context, DEV_CPU, HookReturn, Task, TaskClass, Taskpool  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl.ptg import IN, INOUT, PTG  # noqa: E402
from parsec_tpu_torch.profiling import (AlperfModule, CommProfiler, DotGrapher,  # noqa: E402
                                        SDEModule, TaskProfiler, Trace, dictionary,
                                        jobtrace, pins, sde)
from parsec_tpu_torch.profiling.checkers import IteratorsChecker  # noqa: E402
from parsec_tpu_torch.profiling.print_steals import PrintSteals  # noqa: E402
from parsec_tpu_torch.profiling.trace import iter_spans  # noqa: E402


@pytest.fixture
def clean_sde():
    sde.reset()
    yield
    sde.reset()


def run_chain(ctx, n=10):
    tp = Taskpool("chain", nb_tasks=n)
    tc = TaskClass("step", chores=[Chore(DEV_CPU, lambda es, t: HookReturn.DONE)],
                   nb_parameters=1)

    def release(es, task):
        k = task.locals[0]
        return [Task(tp, tc, (k + 1,))] if k + 1 < n else []

    tc.release_deps = release
    tp.add_task_class(tc)
    tp.startup_hook = lambda c, t: [Task(t, tc, (0,))]
    ctx.add_taskpool(tp)
    assert ctx.wait(timeout=30)


def _chain_ptg(P, LC, n=10, name="chain"):
    dc = LC("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = P(name)
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", INOUT,
              "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")
    step.body(cpu=lambda X, k: X.__iadd__(1.0))
    return ptg.taskpool(N=n, D=dc)


def test_task_profiler_records_exec_spans(tmp_path):
    pytest.importorskip("pandas")
    prof = TaskProfiler().install()
    try:
        with Context(nb_cores=2, devices=["cpu"]) as ctx:
            run_chain(ctx, 10)
    finally:
        prof.uninstall()
    df = prof.trace.to_dataframe()
    execs = df[df["name"] == "exec"]
    assert len(execs) == 10 and (execs["dur_us"] >= 0).all()


def test_task_profiler_dump_is_chrome_json(tmp_path):
    prof = TaskProfiler().install()
    try:
        with Context(nb_cores=2, devices=["cpu"]) as ctx:
            run_chain(ctx, 10)
    finally:
        prof.uninstall()
    out = tmp_path / "trace.json"
    n = prof.trace.dump(str(out))
    assert n >= 20  # begin + end per task
    blob = json.loads(out.read_text())
    assert len(blob["traceEvents"]) == n
    assert set(blob["metadata"]["dictionary"]) == {
        "exec", "prepare_input", "complete_exec", "schedule", "select"}
    spans = [s for s in iter_spans(blob["traceEvents"]) if s["name"] == "exec"]
    assert len(spans) == 10 and all(s["tid"].startswith("worker-") for s in spans)


def test_trace_span_api_and_iter_spans_equal_the_reference():
    """The same event list pairs into the same spans in both packages."""
    t = Trace(rank=1)
    t.add_dictionary_keyword("k", color="red", info={"a": 1})
    t.begin("k", tid="x", a=1)
    t.instant("i", tid="x", b=2)
    t.end("k", tid="x")
    t.counter("c", 5)
    evs = t.events()
    assert [e["ph"] for e in evs] == ["B", "i", "E", "C"]
    assert iter_spans(evs) == ref_trace.iter_spans(evs)
    assert t.dictionary == {"k": {"color": "red", "info": {"a": 1}}}
    bare = [{"name": "op", "ph": "B", "ts": 1.0}, {"name": "op", "ph": "E", "ts": 4.0},
            {"name": "op", "ph": "E", "ts": 9.0}]
    assert iter_spans(bare) == ref_trace.iter_spans(bare)


def test_comm_profiler_records_the_comm_sites():
    """The comm sites are declared, so the comm profiler subscribes as the
    reference's does; nothing fires them before the comm layer, a fire
    lands as an instant named as the reference's validators expect."""
    cp = CommProfiler().install()
    try:
        pins.fire(pins.COMM_ACTIVATE, None, {"rank": 0, "bytes": 120})
        pins.fire(pins.COMM_DATA_PLD, None, {"rank": 0, "bytes": 4096})
    finally:
        cp.uninstall()
    names = [e["name"] for e in cp.trace.events()]
    assert names == ["MPI_ACTIVATE", "MPI_DATA_PLD"]
    assert (CommProfiler.ACTIVATE, CommProfiler.DATA_CTL, CommProfiler.DATA_PLD) == (
        ref_trace.CommProfiler.ACTIVATE, ref_trace.CommProfiler.DATA_CTL,
        ref_trace.CommProfiler.DATA_PLD)


def _dot_of(pkg, tmp_path):
    G = DotGrapher if pkg == "port" else ref_grapher.DotGrapher
    g = G().install()
    try:
        if pkg == "port":
            with Context(nb_cores=1, devices=["cpu"]) as ctx:
                tp = _chain_ptg(PTG, LocalCollection, 8)
                ctx.add_taskpool(tp)
                assert tp.wait(timeout=30)
        else:
            with parsec_tpu.Context(nb_cores=1, devices=["cpu"]) as ctx:
                tp = _chain_ptg(RefPTG, RefLocalCollection, 8)
                ctx.add_taskpool(tp)
                assert tp.wait(timeout=30)
    finally:
        g.uninstall()
    p = tmp_path / f"{pkg}.dot"
    g.dump(str(p))
    return g, p.read_text()


def test_dot_grapher_text_equals_the_reference(tmp_path):
    g, text = _dot_of("port", tmp_path)
    rg, ref_text = _dot_of("reference", tmp_path)
    assert text == ref_text
    assert (g.n_nodes, g.n_edges) == (rg.n_nodes, rg.n_edges) == (8, 7)
    assert "digraph" in text and '"step_0" -> "step_1"' in text


def test_dot_grapher_on_a_manual_chain():
    g = DotGrapher().install()
    try:
        with Context(nb_cores=2, devices=["cpu"]) as ctx:
            run_chain(ctx, 8)
    finally:
        g.uninstall()
    assert g.n_nodes == 8 and g.n_edges == 7


def test_dictionary_snapshot_and_a_failing_getter():
    with Context(nb_cores=2, devices=["cpu"]) as ctx:
        dictionary.register_context(ctx, prefix="t")
        try:
            snap = dictionary.snapshot()
            assert "t.pending_tasks" in snap
            assert isinstance(snap["t.executed_per_worker"], list)
            assert any(k.startswith("t.device.") for k in snap)
        finally:
            for name in list(dictionary.snapshot()):
                if name.startswith("t."):
                    dictionary.unregister_property(name)
    dictionary.register_property("bad", lambda: 1 / 0)
    try:
        assert dictionary.snapshot()["bad"].startswith("<error: ZeroDivisionError")
        assert "bad" not in dictionary.snapshot(exclude_prefix="ba")
    finally:
        dictionary.unregister_property("bad")


def test_aggregator_samples_the_dictionary(tmp_path):
    dictionary.register_property("agg.x", lambda: 7)
    try:
        path = tmp_path / "samples.jsonl"
        agg = dictionary.Aggregator(interval=0.01, path=str(path)).start()
        deadline = 100
        while not agg.samples and deadline:
            threading.Event().wait(0.01)
            deadline -= 1
        agg.stop()
        assert agg.samples and agg.samples[0]["agg.x"] == 7
        assert json.loads(path.read_text().splitlines()[0])["agg.x"] == 7
    finally:
        dictionary.unregister_property("agg.x")


def test_counter_registry(clean_sde):
    sde.counter_add("MY::COUNTER", 5)
    sde.counter_add("MY::COUNTER", 2.5)
    assert sde.read("MY::COUNTER") == 7.5
    sde.counter_set("MY::COUNTER", 1)
    assert sde.read("MY::COUNTER") == 1
    assert "MY::COUNTER" in sde.list_counters()
    assert sde.read("UNKNOWN") == 0
    sde.register_gauge("MY::GAUGE", lambda: 1 / 0)
    assert sde.read("MY::GAUGE") == 0.0  # a broken gauge reads as 0, logged once


def test_sde_counter_names_are_the_references():
    names = sorted(n for n in dir(ref_sde) if n.isupper())
    assert sorted(n for n in dir(sde) if n.isupper()) == names
    assert all(getattr(sde, n) == getattr(ref_sde, n) for n in names)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_sde_module_standard_counters(clean_sde, device):
    """On host chores and on the CUDA module (bound to the torch CPU
    device), whose EXEC pins fire around its own submit: every task
    enabled, retired and drained from the pending level once."""
    n = 12
    mod = SDEModule()
    try:
        if device == "cpu":
            with Context(nb_cores=2, devices=["cpu"]) as ctx:
                tp = _chain_ptg(PTG, LocalCollection, n)
                ctx.add_taskpool(tp)
                assert tp.wait(timeout=30)
        else:
            from parsec_tpu_torch.datadist import TiledMatrix
            from parsec_tpu_torch.ops import cholesky_ptg

            A = TiledMatrix(128, 128, 32, 32, name="A", dtype=np.float32)
            rng = np.random.default_rng(0)
            m = rng.standard_normal((128, 128))
            A.from_array((m @ m.T + 128 * np.eye(128)).astype(np.float32))
            with Context(nb_cores=2, cuda_device="cpu") as ctx:
                tp = cholesky_ptg(use_cuda=True, use_cpu=False).taskpool(NT=A.mt, A=A)
                ctx.add_taskpool(tp)
                assert tp.wait(timeout=60)
            n = 20
        assert sde.read(sde.TASKS_ENABLED) == n
        assert sde.read(sde.TASKS_RETIRED) == n
        assert sde.read(sde.PENDING_TASKS) == 0
        assert dictionary.snapshot()[f"sde.{sde.TASKS_RETIRED}"] == n
    finally:
        mod.disable()


def test_alperf_per_class_counts_and_measures(clean_sde):
    n = 8
    mod = AlperfModule()
    mod.declare_measure("flops", lambda task: 100.0)
    mod.declare_measure("broken", lambda task: 1 / 0)
    try:
        with Context(nb_cores=2, devices=["cpu"]) as ctx:
            tp = _chain_ptg(PTG, LocalCollection, n)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
        r = mod.report()
        assert r["tasks_total"] == n
        row = r["per_class"]["step"]
        assert row["tasks"] == n and row["time_s"] >= 0
        assert row["flops"] == 100.0 * n and "broken" not in row
        assert r["tasks_per_s"] > 0
        assert dictionary.snapshot()["alperf"]["tasks_total"] == n
    finally:
        mod.disable()
    assert "alperf" not in dictionary.snapshot()


def test_disabled_modules_cost_nothing(clean_sde):
    SDEModule().disable()
    with Context(nb_cores=2, devices=["cpu"]) as ctx:
        tp = _chain_ptg(PTG, LocalCollection, 5)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    assert sde.read(sde.TASKS_RETIRED) == 0


def _fan_tp(n):
    """One source, n independent workers: stealing under lfq."""
    dc = LocalCollection("D", shape=(4,), init=lambda k: np.zeros(4))
    ptg = PTG("fan")
    src = ptg.task_class("src")
    src.affinity("D(0)")
    src.flow("X", INOUT, "<- D(0)", "-> X work(0 .. N-1)")
    src.body(cpu=lambda X: X.__iadd__(1.0))
    work = ptg.task_class("work", w="0 .. N-1")
    work.affinity("D(0)")
    work.flow("X", IN, "<- X src()")

    def busy(X, w):
        acc = 0.0
        for _ in range(2000):
            acc += float(X[0])

    work.body(cpu=busy)
    return ptg.taskpool(N=n, D=dc)


@pytest.mark.parametrize("sched", ["lfq", "ll"])
def test_print_steals_report(monkeypatch, sched):
    from parsec_tpu_torch.utils.mca_param import params

    monkeypatch.setenv("PARSEC_MCA_mca_sched", sched)
    params.reset()
    ctx = Context(nb_cores=4, devices=["cpu"])
    try:
        assert ctx.scheduler.mca_name == sched
        mod = PrintSteals(ctx, auto=True)
        tp = _fan_tp(64)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        rows = mod.snapshot()
        assert len(rows) == 4
        assert sum(r["executed"] for r in rows) == 65
        assert sum(r["steals"] for r in rows) > 0
        rep = mod.report()
        assert "total steals" in rep and "worker" in rep
    finally:
        ctx.fini()  # the auto report runs at fini and must not raise
        params.reset()


def test_on_fini_callback_order():
    ctx = Context(nb_cores=2, devices=["cpu"])
    seen = []
    ctx.on_fini(lambda: seen.append(len(ctx.streams)))
    ctx.fini()
    assert seen == [2]


# ---------------------------------------------------------------------------
# the iterators checker: the reference's seeded faults
# ---------------------------------------------------------------------------

def _checked(pkg, n=10, nb_cores=4):
    if pkg == "port":
        tp, chk_cls, ctx = (_chain_ptg(PTG, LocalCollection, n), IteratorsChecker,
                            Context(nb_cores=nb_cores, devices=["cpu"]))
    else:
        tp, chk_cls, ctx = (_chain_ptg(RefPTG, RefLocalCollection, n),
                            ref_checkers.IteratorsChecker,
                            parsec_tpu.Context(nb_cores=nb_cores, devices=["cpu"]))
    try:
        with chk_cls() as chk:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
    finally:
        ctx.fini()
    return chk, tp


def _fault(chk, tp, kind):
    tpid = tp.taskpool_id
    if kind == "spurious_edge":
        chk.released.append((tpid, ("step", (2,)), ("step", (5,))))
    elif kind == "double_execution":
        chk.executed.append((tpid, "step", (3,)))
    elif kind == "unknown_task":
        chk.executed.append((tpid, "ghost", (0,)))
    elif kind == "double_release":
        chk.released.append((tpid, ("step", (3,)), ("step", (4,))))


@pytest.mark.parametrize("fault", [None, "spurious_edge", "double_execution",
                                   "unknown_task", "double_release"])
def test_iterators_checker_finds_the_references_faults(fault):
    out = []
    for pkg in ("port", "reference"):
        chk, tp = _checked(pkg)
        if fault:
            _fault(chk, tp, fault)
        out.append(chk.verify(tp))
    assert out[0] == out[1]
    assert (out[0] == []) == (fault is None)


def test_iterators_checker_catches_missing_execution():
    out = []
    for pkg, P, LC in (("port", PTG, LocalCollection),
                       ("reference", RefPTG, RefLocalCollection)):
        chk, _ = _checked(pkg)
        out.append(chk.verify(_chain_ptg(P, LC, 11)))
    assert out[0] == out[1]
    assert any("never executed" in e for e in out[0])


def test_iterators_checker_clean_dpotrf_on_the_cuda_module():
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops import cholesky_ptg

    A = TiledMatrix(128, 128, 32, 32, name="A", dtype=np.float32)
    rng = np.random.default_rng(1)
    m = rng.standard_normal((128, 128))
    A.from_array((m @ m.T + 128 * np.eye(128)).astype(np.float32))
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(NT=A.mt, A=A)
    with IteratorsChecker() as chk:
        with Context(nb_cores=4, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
    assert chk.verify(tp) == []
    assert len(chk.executed) == 20


# ---------------------------------------------------------------------------
# job trace ids, PINS names, copy-on-write subscriber lists
# ---------------------------------------------------------------------------

def test_trace_id_helpers_equal_the_reference():
    a = jobtrace.trace_id_of("poolA")
    assert a == jobtrace.trace_id_of("poolA") == ref_jobtrace.trace_id_of("poolA")
    assert a != jobtrace.trace_id_of("poolB") and 0 < a < (1 << 63)
    hx = jobtrace.hex_id(a)
    assert hx == ref_jobtrace.hex_id(a) and len(hx) == 16
    for form in (hx, f"job:{hx}", a):
        assert jobtrace.parse_trace_id(form) == ref_jobtrace.parse_trace_id(form) == a
    assert Taskpool("zzz").trace_id == jobtrace.trace_id_of("zzz")
    assert (jobtrace.PHASE_SUBMIT, jobtrace.PHASE_ADMIT, jobtrace.PHASE_DONE) == (
        ref_jobtrace.PHASE_SUBMIT, ref_jobtrace.PHASE_ADMIT, ref_jobtrace.PHASE_DONE)


def test_job_index_and_job_of_event_equal_the_reference():
    evs = [
        {"name": "job_map", "ph": "i", "ts": 0.0, "pid": 0, "args": {"event_id": 1, "info": 9}},
        {"name": "job:000000000000000a", "ph": "i", "ts": 0.0, "pid": 1,
         "args": {"event_id": 2}},
        {"name": "job_phase", "ph": "i", "ts": 5.0, "pid": 0, "args": {"event_id": 9, "info": 1}},
        {"name": "job_phase", "ph": "i", "ts": 3.0, "pid": 1, "args": {"event_id": 9, "info": 1}},
        {"name": "job_phase", "ph": "i", "ts": 8.0, "pid": 0, "args": {"event_id": 9, "info": 2}},
        {"name": "job_phase", "ph": "i", "ts": 50.0, "pid": 1, "args": {"event_id": 9, "info": 3}},
        {"name": "exec", "ph": "B", "ts": 9.0, "pid": 0, "args": {"event_id": 1}},
        {"name": "jobwire_eager", "ph": "i", "ts": 9.0, "pid": 0, "args": {"event_id": 9}},
        {"name": "exec", "ph": "B", "ts": 9.0, "pid": 1, "args": {"event_id": 1}},
        {"name": 7, "ph": "i"},
    ]
    idx = jobtrace.job_index(evs)
    assert idx == ref_jobtrace.job_index(evs)
    assert idx["phases"][9] == {"submit_us": 3.0, "admit_us": 8.0, "done_us": 50.0}
    assert [jobtrace.job_of_event(e, idx["token_to_job"]) for e in evs] == \
        [ref_jobtrace.job_of_event(e, idx["token_to_job"]) for e in evs]


def test_thread_trace_context():
    seen = []

    def body():
        seen.append(jobtrace.current())
        jobtrace.set_current(5)
        seen.append(jobtrace.current())

    th = threading.Thread(target=body)
    th.start()
    th.join()
    assert seen == [0, 5]


#: the 19 site names the port lacked before the binary tracer: the
#: subscribers wire themselves as the reference's do
NEW_SITES = ("ACTIVATE_CB_BEGIN", "ACTIVATE_CB_END", "COLL_BEGIN", "COLL_END", "COLL_SEG",
             "COMM_ACTIVATE", "COMM_DATA_CTL", "COMM_DATA_PLD", "COMM_RECV_BEGIN",
             "COMM_RECV_END", "COMM_SEND_BEGIN", "COMM_SEND_END", "COMPILE_BEGIN",
             "COMPILE_END", "DATA_FLUSH_BEGIN", "DATA_FLUSH_END", "JOB_ADMIT", "JOB_DONE",
             "JOB_SUBMIT")


@pytest.mark.parametrize("name", NEW_SITES)
def test_pins_site_names_are_the_references(name):
    assert getattr(pins, name) == getattr(ref_pins, name)
    assert getattr(pins, name) in pins.ALL_SITES


def test_pins_sites_are_all_the_references():
    """Every site of the reference, under its name, and beyond them only
    the port's own: the BEGIN and END of a job's spans (``pins.SPANS``)."""
    assert len(NEW_SITES) == 19
    ref = {n: getattr(ref_pins, n) for n in dir(ref_pins)
           if n.isupper() and isinstance(getattr(ref_pins, n), str)}
    mine = {n: getattr(pins, n) for n in dir(pins)
            if n.isupper() and isinstance(getattr(pins, n), str)}
    spans = {s for pair in pins.SPANS.values() for s in pair}
    own = {n: v for n, v in mine.items() if n not in ref}
    assert {n: v for n, v in mine.items() if n in ref} == ref
    assert own and set(own.values()) <= spans
    assert set(pins.ALL_SITES) == set(ref_pins.ALL_SITES) | set(own.values())


def test_binary_tracer_subscribes_every_site_the_reference_does():
    from parsec_tpu.profiling import binary as ref_binary
    from parsec_tpu_torch.profiling import binary

    def sites(mod, p):
        before = {s: len(p._subscribers.get(s, ())) for s in p.ALL_SITES}
        ts = mod.RankTraceSet(1).install()
        try:
            return {s for s in p.ALL_SITES if len(p._subscribers.get(s, ())) > before[s]}
        finally:
            ts.uninstall()
            ts.close()

    assert sites(binary, pins) == sites(ref_binary, ref_pins)


SITE = pins.EXEC_BEGIN


def test_subscribe_during_fire_threaded_stress():
    stop = threading.Event()
    fired = [0]
    errors = []

    def keeper(es, payload):
        fired[0] += 1

    pins.subscribe(SITE, keeper)

    def firehose():
        while not stop.is_set():
            pins.fire(SITE, None, None)

    def churn():
        def cb(es, payload):
            pass

        try:
            for _ in range(2000):
                pins.subscribe(SITE, cb)
                pins.unsubscribe(SITE, cb)
        except Exception as e:  # pragma: no cover - the failure signal
            errors.append(e)

    try:
        fire_threads = [threading.Thread(target=firehose) for _ in range(2)]
        churners = [threading.Thread(target=churn) for _ in range(4)]
        for t in fire_threads + churners:
            t.start()
        for t in churners:
            t.join(timeout=60)
        stop.set()
        for t in fire_threads:
            t.join(timeout=10)
    finally:
        stop.set()
        pins.unsubscribe(SITE, keeper)
    assert errors == [] and fired[0] > 0
    assert not pins.active(SITE)


def test_unsubscribe_self_during_fire_is_safe():
    calls = []

    def a(es, p):
        calls.append("a")
        pins.unsubscribe(SITE, a)

    def b(es, p):
        calls.append("b")

    pins.subscribe(SITE, a)
    pins.subscribe(SITE, b)
    try:
        pins.fire(SITE, None, None)
        assert calls == ["a", "b"]
        pins.fire(SITE, None, None)
        assert calls == ["a", "b", "b"]
    finally:
        pins.unsubscribe(SITE, b)
        pins.unsubscribe(SITE, a)


def test_subscribers_are_immutable_snapshots():
    def a(es, p):
        pass

    pins.subscribe(SITE, a)
    try:
        snap = pins._subscribers[SITE]
        assert isinstance(snap, tuple)
        pins.subscribe(SITE, a)
        assert pins._subscribers[SITE] is not snap
    finally:
        pins.unsubscribe(SITE, a)
        pins.unsubscribe(SITE, a)
    assert not pins.active(SITE)
