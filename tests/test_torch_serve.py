"""The serving plane of the port (``parsec_tpu_torch.serve``) held against
the JAX package's (``parsec_tpu.serve``): the same scenario runs through
both packages' ``RuntimeService`` — submit/wait/status, admission
queueing and quotas, cancel (queued and running, without poisoning
co-resident pools), drain, deadline expiry, graceful and timed close, the
composed priorities, the per-pool ``progress()``, compound pools, wdrr
fairness, the arena-budget gate, attention serving and concurrent
heterogeneous pools — and each outcome, count and document key is
compared.  The port's contexts bind the CUDA module to the torch CPU
device (``cuda_device="cpu"``).

Nothing here waits on a sleep alone: a gated first task holds a pool open
until the test sets its event, admission states are read right after the
synchronous submit, and waits go through ``JobHandle.wait`` or the
service's own counters (``wait_until``)."""

import os
import threading
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu.serve as ref_serve  # noqa: E402
import parsec_tpu_torch  # noqa: E402
import parsec_tpu_torch.serve as port_serve  # noqa: E402
from parsec_tpu.core.compound import CompoundTaskpool as RefCompound  # noqa: E402
from parsec_tpu.core.compound import compose as ref_compose  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocal  # noqa: E402
from parsec_tpu.data.arena import Arena as RefArena  # noqa: E402
from parsec_tpu.dsl.ptg import INOUT as REF_INOUT  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu_torch.core.compound import CompoundTaskpool as PortCompound  # noqa: E402
from parsec_tpu_torch.core.compound import compose as port_compose  # noqa: E402
from parsec_tpu_torch.data import LocalCollection as PortLocal  # noqa: E402
from parsec_tpu_torch.data.arena import Arena as PortArena  # noqa: E402
from parsec_tpu_torch.dsl.ptg import INOUT as PORT_INOUT  # noqa: E402
from parsec_tpu_torch.dsl.ptg import PTG as PortPTG  # noqa: E402


class _Pkg:
    def __init__(self, name, top, serve, local, ptg, inout, compound, compose, arena):
        self.name = name
        self.top = top
        self.serve = serve
        self.Local = local
        self.PTG = ptg
        self.INOUT = inout
        self.Compound = compound
        self.compose = compose
        self.Arena = arena

    def context(self, **kw):
        if self.name == "port":
            kw.setdefault("cuda_device", "cpu")
        return self.top.Context(**kw)

    def service(self, context=None, **kw):
        if context is None and self.name == "port":
            kw.setdefault("cuda_device", "cpu")
        kw.setdefault("nb_cores", 2) if context is None else None
        return self.serve.RuntimeService(context, **kw)


PKGS = {
    "port": _Pkg("port", parsec_tpu_torch, port_serve, PortLocal, PortPTG, PORT_INOUT,
                 PortCompound, port_compose, PortArena),
    "ref": _Pkg("ref", parsec_tpu, ref_serve, RefLocal, RefPTG, REF_INOUT,
                RefCompound, ref_compose, RefArena),
}


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def port_param():
    """Set port MCA params for one test; unset them after."""
    from parsec_tpu_torch import mca_param

    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


def chain_tp(pk, n, name="chain", gate=None, body_extra=None, started=None):
    """An n-task chain incrementing one tile; the FIRST task optionally
    signals ``started`` and blocks on ``gate`` (the pool held open until
    the test says go)."""
    dc = pk.Local("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = pk.PTG(name)
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", pk.INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")

    def body(X, k):
        if body_extra is not None:
            body_extra(k)
        if k == 0 and started is not None:
            started.set()
        if k == 0 and gate is not None:
            assert gate.wait(timeout=60)
        X += 1.0

    step.body(cpu=body)
    return ptg.taskpool(N=n, D=dc), dc


def final_value(dc):
    return float(dc.data_of(0).newest_copy().payload[0])


def wait_until(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


def _keys(doc):
    """The document's key tree (values' types coarsened), for key-by-key
    comparison across the two packages."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(v) for v in doc[:1]]
    return type(doc).__name__ if doc is not None else None


# ---------------------------------------------------------------------------
# tests/serve/test_service.py
# ---------------------------------------------------------------------------

def test_submit_wait_and_tenant_accounting(pkg):
    with pkg.service() as sv:
        handles = []
        for i in range(6):
            tp, dc = chain_tp(pkg, 5, name=f"job{i}")
            h = sv.submit("alice" if i % 2 else "bob", tp, priority=i)
            handles.append((h, dc))
        for h, dc in handles:
            assert h.wait(timeout=60), h.status()
            assert h.state == "done"
            assert h.latency_s is not None and h.latency_s >= 0
            assert h.queue_delay_s is not None and h.queue_delay_s >= 0
            assert final_value(dc) == 5.0
        doc = sv.status_doc()
        assert doc["jobs"]["done"] == 6
        assert doc["tenants"]["alice"]["completed"] == 3
        assert doc["tenants"]["bob"]["completed"] == 3
        assert doc["tenants"]["alice"]["retired"] == 15
        assert doc["scheduler"] == "wdrr" and doc["fairness"] is True


def test_backpressure_queues_then_admits_in_order(pkg):
    with pkg.service() as sv:
        sv.max_inflight_pools = 1
        gate = threading.Event()
        h0 = sv.submit("t", chain_tp(pkg, 3, "gated", gate=gate)[0])
        # submit admits synchronously when capacity allows: h0 runs, the
        # followers find the one slot taken and queue
        followers = [sv.submit("t", chain_tp(pkg, 2, f"f{i}")[0]) for i in range(3)]
        assert h0.state == "running"
        assert all(h.state == "queued" for h in followers)
        assert sv.status_doc()["jobs"]["queued"] == 3
        assert sv.counters()["queued"] == 3.0
        gate.set()
        for h in followers:
            assert h.wait(timeout=60), h.status()
        assert h0.wait(timeout=60)
        # FIFO admission: each follower admitted after the one before
        admits = [h.t_admit for h in followers]
        assert admits == sorted(admits)


def test_quota_rejection_and_service_queue_bound(pkg):
    with pkg.service() as sv:
        sv.max_inflight_pools = 1
        gate = threading.Event()
        h0 = sv.submit("noisy", chain_tp(pkg, 2, gate=gate)[0])
        sv.tenant("noisy", max_queued=1)
        h1 = sv.submit("noisy", chain_tp(pkg, 2)[0])
        with pytest.raises(pkg.serve.AdmissionError, match="max_queued"):
            sv.submit("noisy", chain_tp(pkg, 2)[0])
        h2 = sv.submit("polite", chain_tp(pkg, 2)[0])
        sv.max_queued = 2
        with pytest.raises(pkg.serve.AdmissionError, match="queue full"):
            sv.submit("polite", chain_tp(pkg, 2)[0])
        doc = sv.status_doc()
        assert doc["tenants"]["noisy"]["rejected"] == 1
        assert doc["jobs"]["rejected"] == 2
        gate.set()
        for h in (h0, h1, h2):
            assert h.wait(timeout=60)


def test_cancel_queued_and_running_without_poisoning_neighbors(pkg):
    with pkg.service() as sv:
        sv.max_inflight_pools = 2
        gate, buddy_gate = threading.Event(), threading.Event()
        victim_tp, _ = chain_tp(pkg, 4, "victim", gate=gate)
        buddy_tp, buddy_dc = chain_tp(pkg, 4, "buddy", gate=buddy_gate)
        victim = sv.submit("a", victim_tp)
        buddy = sv.submit("b", buddy_tp)
        queued = sv.submit("a", chain_tp(pkg, 2)[0])
        assert queued.state == "queued"
        assert queued.cancel()
        assert queued.state == "cancelled"
        assert victim.cancel()
        assert not victim.wait(timeout=30)
        assert victim.state == "cancelled"
        assert "cancelled by service" in victim.fail_reason
        buddy_gate.set()
        gate.set()
        assert buddy.wait(timeout=60), buddy.status()
        assert final_value(buddy_dc) == 4.0
        doc = sv.status_doc()
        assert doc["jobs"]["cancelled"] == 2
        assert doc["jobs"]["done"] == 1
        assert not victim.cancel()  # a second cancel changes nothing


def test_drain_tenant_leaves_other_tenants_alone(pkg):
    with pkg.service() as sv:
        sv.max_inflight_pools = 2
        gate = threading.Event()
        a_run = sv.submit("a", chain_tp(pkg, 3, "a0", gate=gate)[0])
        b_run = sv.submit("b", chain_tp(pkg, 3, "b0", gate=gate)[0])
        a_q = sv.submit("a", chain_tp(pkg, 2, "a1")[0])
        b_q = sv.submit("b", chain_tp(pkg, 2, "b1")[0])
        gate.set()
        assert sv.drain("a", timeout=60)
        assert a_run.state in ("done", "cancelled")
        assert a_q.state in ("cancelled", "done")
        assert b_q.state in ("queued", "running", "done")
        assert b_run.wait(timeout=60)
        assert b_q.wait(timeout=60)


def test_deadline_expires_queued_job(pkg):
    with pkg.service() as sv:
        sv.max_inflight_pools = 1
        gate = threading.Event()
        h0 = sv.submit("t", chain_tp(pkg, 2, gate=gate)[0])
        h1 = sv.submit("t", chain_tp(pkg, 2)[0], deadline=0.15)
        assert not h1.wait(timeout=30)
        assert h1.state == "failed"
        assert "deadline expired" in h1.fail_reason
        gate.set()
        assert h0.wait(timeout=60)
        assert sv.status_doc()["jobs"]["expired"] == 1
        # an expired job IS a latency outcome of its tenant
        assert sv.context.slo.hist("job_latency", ("tenant", "t")).count == 2


def test_graceful_close_runs_queued_jobs_to_completion(pkg):
    sv = pkg.service()
    sv.max_inflight_pools = 1
    gate = threading.Event()
    h0 = sv.submit("t", chain_tp(pkg, 2, gate=gate)[0])
    tp1, dc1 = chain_tp(pkg, 3)
    h1 = sv.submit("t", tp1)
    assert h1.state == "queued"
    gate.set()
    assert sv.close(timeout=60, cancel_queued=False)
    assert h0.state == "done" and h1.state == "done"
    assert final_value(dc1) == 3.0
    assert not sv._admitter.is_alive()


def test_failure_mentioning_cancelled_is_not_booked_as_cancellation(pkg):
    with pkg.service() as sv:
        dc = pkg.Local("F", shape=(1,), init=lambda k: np.zeros(1))
        ptg = pkg.PTG("poison")
        step = ptg.task_class("step", k="0 .. 2")
        step.affinity("F(0)")
        step.flow("X", pkg.INOUT, "<- (k == 0) ? F(0) : X step(k-1)",
                  "-> (k < 2) ? X step(k+1) : F(0)")

        def body(X, k):
            X += 1.0
            if k == 1:
                raise RuntimeError("request cancelled by upstream peer")

        step.body(cpu=body)
        h = sv.submit("t", ptg.taskpool(F=dc))
        assert not h.wait(timeout=60)
        assert h.state == "failed", h.status()
        assert "request cancelled by upstream peer" in h.fail_reason
        doc = sv.status_doc()
        assert doc["jobs"]["failed"] == 1
        assert doc["jobs"]["cancelled"] == 0
        assert doc["tenants"]["t"]["retired"] >= 1


def test_submit_after_close_rejected(pkg):
    sv = pkg.service()
    assert sv.close(timeout=30)
    with pytest.raises(pkg.serve.AdmissionError, match="closing"):
        sv.submit("t", chain_tp(pkg, 2)[0])
    assert sv.close(timeout=5)  # idempotent


def test_attach_failure_fails_pool_and_wakes_waiters(pkg):
    with pkg.service() as sv:
        orig = sv.context.add_taskpool

        def exploding(tp):
            raise RuntimeError("termdet slot taken")

        sv.context.add_taskpool = exploding
        try:
            tp, _ = chain_tp(pkg, 3, "doomed")
            waited = []
            h = sv.submit("t", tp)
            th = threading.Thread(target=lambda: waited.append(h.wait(timeout=30)))
            th.start()
            th.join(timeout=30)
            assert not th.is_alive(), "waiter hung on a never-attached pool"
            assert waited == [False]
            assert h.state == "failed"
            assert "add_taskpool raised" in h.fail_reason
            assert tp.failed and tp.is_done()
        finally:
            sv.context.add_taskpool = orig


def test_submit_with_tenant_object_registers_it(pkg):
    with pkg.service() as sv:
        t = pkg.serve.Tenant("gold", weight=4, max_queued=2)
        h = sv.submit(t, chain_tp(pkg, 3)[0])
        assert h.wait(timeout=60)
        assert sv.tenants["gold"] is t
        assert sv.status_doc()["tenants"]["gold"]["completed"] == 1
        h2 = sv.submit("gold", chain_tp(pkg, 3)[0])
        assert h2.wait(timeout=60) and h2.tenant is t
        with pytest.raises(pkg.serve.AdmissionError, match="different object"):
            sv.submit(pkg.serve.Tenant("gold", weight=1), chain_tp(pkg, 3)[0])


def test_backlog_of_instantly_empty_pools_does_not_recurse(pkg):
    njobs = 300
    with pkg.service() as sv:
        sv.max_inflight_pools = 1
        gate = threading.Event()
        holder = sv.submit("t", chain_tp(pkg, 2, gate=gate)[0])
        empties = [sv.submit("t", pkg.top.Taskpool(f"e{i}", nb_tasks=0))
                   for i in range(njobs)]
        assert all(h.state == "queued" for h in empties)
        gate.set()
        assert holder.wait(timeout=60)
        for h in empties:
            assert h.wait(timeout=60), h.status()
        assert sv._admitter.is_alive()
        assert sv.status_doc()["jobs"]["done"] == njobs + 1


@pytest.mark.parametrize("rerun", [False, True], ids=["quiet", "admitter_asks"])
def test_submit_fast_path_covers_only_its_own_job(rerun):
    """submit() admits its own job on the caller's thread and never
    another queued job's, even when the admitter asks for a pump while
    the caller's attach runs (``admitter_asks`` forces that request from
    another thread).  The port only: the reference's owning frame runs
    such a re-run over the whole queue on the caller's thread, so its own
    ``tests/serve/test_service.py::test_submit_fast_path_covers_only_its_own_job``
    fails when the admitter wakes during the attach (ROADMAP C)."""
    pk = PKGS["port"]
    with pk.service() as sv:
        sv.max_inflight_pools = 0  # park everything
        old = [sv.submit("a", chain_tp(pk, 2, f"old{i}")[0]) for i in range(2)]
        assert all(h.state == "queued" for h in old)
        attached_by = []
        orig = sv.context.add_taskpool

        def spy(tp):
            attached_by.append((threading.current_thread().name, tp.name))
            if rerun and tp.name == "mine":
                # a pump asked for from another thread while this one
                # owns the pump: it flags a re-run and returns
                t = threading.Thread(target=sv._pump)
                t.start()
                t.join()
                assert sv._pump_pending
            return orig(tp)

        sv.context.add_taskpool = spy
        try:
            sv.max_inflight_pools = 4
            mine = sv.submit("b", chain_tp(pk, 2, "mine")[0])
            assert mine.state == "running"
            me = threading.current_thread().name
            assert [nm for thr, nm in attached_by if thr == me] == ["mine"], attached_by
            assert mine.wait(timeout=60)
            for h in old:
                assert h.wait(timeout=60), h.status()
            assert sorted(nm for _thr, nm in attached_by) == ["mine", "old0", "old1"]
        finally:
            sv.context.add_taskpool = orig


def test_close_timeout_leaves_live_service_then_succeeds(pkg):
    sv = pkg.service()
    gate, started = threading.Event(), threading.Event()
    h = sv.submit("t", chain_tp(pkg, 3, gate=gate, started=started)[0])
    assert h.state == "running"
    # the gated body is on the context's worker, not on this thread
    # (close's drain would otherwise run it here and block on the gate)
    assert started.wait(timeout=30)
    assert sv.close(timeout=0.3) is False
    assert h.state == "running"
    gate.set()
    assert h.wait(timeout=60)
    assert sv.close(timeout=30) is True
    assert not sv._admitter.is_alive()


def test_cancel_racing_attach_does_not_leak_active_taskpools(pkg):
    with pkg.service() as sv:
        orig = sv.context.add_taskpool
        in_attach, release = threading.Event(), threading.Event()

        def slow_attach(tp):
            in_attach.set()
            assert release.wait(timeout=10)
            return orig(tp)

        sv.context.add_taskpool = slow_attach
        try:
            tp, _ = chain_tp(pkg, 3, "raced")
            t = threading.Thread(target=lambda: sv.submit("t", tp))
            t.start()
            assert in_attach.wait(timeout=10)
            wait_until(lambda: bool(sv._inflight), 10, "the handle in flight")
            h = next(iter(sv._inflight.values()))
            assert h.cancel()
            release.set()
            t.join(timeout=10)
            assert not h.wait(timeout=10)
            assert h.state == "cancelled"
        finally:
            sv.context.add_taskpool = orig
        with sv.context._cv:
            assert sv.context._active_taskpools == 0
        assert sv.context.test()


def test_wrapped_context_reports_fairness_honestly(pkg):
    ctx = pkg.context(nb_cores=2)  # the default scheduler, not wdrr
    try:
        sv = pkg.service(ctx)
        assert sv.fairness is False
        assert sv.status_doc()["fairness"] is False
        assert sv.status_doc()["scheduler"] == "lfq"
        h = sv.submit("t", chain_tp(pkg, 3)[0])
        assert h.wait(timeout=60)
        assert sv.close(timeout=30)
        assert ctx.serve is None
    finally:
        ctx.fini()  # close() must not have finalized a wrapped context


@pytest.mark.parametrize("weight,job,task", [
    (1, 0, 0), (2, 0, 0), (1, 5, 17), (3, -1, 4), (7, 1023, (1 << 20) - 1),
    (1, -1024, 0), (4, 2, 12345)])
def test_compose_priority_matches_the_reference(weight, job, task):
    assert port_serve.compose_priority(weight, job, task) == \
        ref_serve.compose_priority(weight, job, task)
    assert port_serve.JOB_PRIORITY_SPAN == ref_serve.JOB_PRIORITY_SPAN
    assert port_serve.TASK_PRIORITY_SPAN == ref_serve.TASK_PRIORITY_SPAN


def test_compose_priority_lexicographic_and_task_offset(pkg):
    cp = pkg.serve.compose_priority
    J, T = pkg.serve.JOB_PRIORITY_SPAN, pkg.serve.TASK_PRIORITY_SPAN
    assert cp(2, 0, 0) > cp(1, J - 1, T - 1)
    assert cp(1, 3, 0) > cp(1, 2, T - 1)
    assert cp(1, 2, 7) > cp(1, 2, 6)
    assert cp(1, -1, 0) < cp(1, 0, 0)
    tp = pkg.top.Taskpool("prio", nb_tasks=1)
    tp.priority_base = cp(3, 5)
    task = pkg.top.Task(tp, pkg.top.TaskClass("t"), (), priority=17)
    assert task.priority == cp(3, 5, 17)


def test_admission_sets_tenant_fields_on_pool(pkg):
    with pkg.service() as sv:
        sv.tenant("gold", weight=4)
        tp, _ = chain_tp(pkg, 3)
        h = sv.submit("gold", tp, priority=2)
        assert h.wait(timeout=60)
        assert tp.tenant == "gold"
        assert tp.tenant_weight == 4
        assert tp.job_priority == 2
        assert tp.priority_base == pkg.serve.compose_priority(4, 2)
        assert tp.progress()["tenant"] == "gold"


def test_progress_rate_is_per_pool_and_freezes_at_termination(pkg):
    ctx = pkg.context(nb_cores=2)
    try:
        fast_tp, _ = chain_tp(pkg, 5, "fast")
        gate, entered = threading.Event(), threading.Event()
        slow_tp, _ = chain_tp(pkg, 3, "slow", gate=gate,
                              body_extra=lambda k: entered.set())
        ctx.add_taskpool(slow_tp)
        ctx.start()
        assert entered.wait(timeout=30)
        ctx.add_taskpool(fast_tp)
        assert ctx.wait_taskpool(fast_tp, timeout=30)
        assert not slow_tp.is_done()
        p1 = fast_tp.progress()
        assert p1["done"] and p1["retired"] == 5 and p1["known"] == 5
        assert p1["rate_tasks_per_s"] > 0 and p1["eta_s"] == 0.0
        # the frozen window: a later read is the same document
        wait_until(lambda: time.monotonic() - fast_tp._t_terminated > 0.05,
                   what="time to pass")
        p2 = fast_tp.progress()
        assert p2["elapsed_s"] == p1["elapsed_s"]
        assert p2["rate_tasks_per_s"] == p1["rate_tasks_per_s"]
        ps = slow_tp.progress()
        assert ps["retired"] == 0 and ps["rate_tasks_per_s"] == 0.0
        assert ps["eta_s"] is None  # no rate: unknown, never inf
        gate.set()
        assert slow_tp.wait(timeout=30)
        assert slow_tp.progress()["rate_tasks_per_s"] > 0
    finally:
        ctx.fini()


def test_progress_document_keys_match_the_reference():
    docs = {}
    for name, pk in PKGS.items():
        ctx = pk.context(nb_cores=2)
        try:
            tp, _ = chain_tp(pk, 4, "p")
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
            docs[name] = tp.progress()
        finally:
            ctx.fini()
    assert _keys(docs["port"]) == _keys(docs["ref"])
    for k in ("name", "type", "tenant", "retired", "known", "done", "failed", "eta_s"):
        assert docs["port"][k] == docs["ref"][k], k


def _status_scenario(pk):
    """The same service history through either package: two tenants,
    one rejection, one cancel, a queue left at close."""
    sv = pk.service()
    try:
        sv.max_inflight_pools = 1
        sv.tenant("gold", weight=3, max_queued=1, slo_p95_ms=1e6)
        gate = threading.Event()
        h0 = sv.submit("gold", chain_tp(pk, 3, "g0", gate=gate)[0], priority=2)
        q1 = sv.submit("gold", chain_tp(pk, 2, "g1")[0])
        with pytest.raises(pk.serve.AdmissionError):
            sv.submit("gold", chain_tp(pk, 2, "g2")[0])
        q2 = sv.submit("free", chain_tp(pk, 2, "f0")[0])
        q2.cancel()
        live = sv.status_doc()
        gate.set()
        assert h0.wait(timeout=60) and q1.wait(timeout=60)
        done = sv.status_doc()
        return live, done, sv.counters(), h0.status()
    finally:
        sv.close(timeout=30)


def test_status_doc_and_counters_match_the_reference_key_by_key():
    port = _status_scenario(PKGS["port"])
    ref = _status_scenario(PKGS["ref"])
    for p, r in zip(port, ref):
        assert _keys(p) == _keys(r)
    live_p, done_p, cnt_p, st_p = port
    live_r, done_r, cnt_r, st_r = ref
    assert cnt_p == cnt_r
    for doc_p, doc_r in ((live_p, live_r), (done_p, done_r)):
        assert doc_p["jobs"] == doc_r["jobs"]
        assert doc_p["limits"] == doc_r["limits"]
        assert doc_p["scheduler"] == doc_r["scheduler"] == "wdrr"
        for t in ("gold", "free"):
            for k in ("weight", "max_inflight", "max_queued", "slo_p95_ms", "submitted",
                      "admitted", "completed", "failed", "cancelled", "rejected",
                      "inflight", "queued", "slo_violations"):
                assert doc_p["tenants"][t][k] == doc_r["tenants"][t][k], (t, k)
        assert [(j["tenant"], j["name"], j["state"], j["priority"])
                for j in doc_p["queue"] + doc_p["jobs_inflight"]] == \
            [(j["tenant"], j["name"], j["state"], j["priority"])
             for j in doc_r["queue"] + doc_r["jobs_inflight"]]
    assert done_p["tenants"]["gold"]["retired"] == done_r["tenants"]["gold"]["retired"] == 5
    for k in ("job_id", "tenant", "name", "trace_id", "state", "priority", "fail_reason"):
        assert st_p[k] == st_r[k], k


# ---------------------------------------------------------------------------
# tests/serve/test_compound_serve.py
# ---------------------------------------------------------------------------

def _compound_chain(pk, n, name, dc):
    ptg = pk.PTG(name)
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", pk.INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")

    def body(X, k):
        X += 1.0

    step.body(cpu=body)
    return ptg.taskpool(N=n, D=dc)


def test_compound_through_service_completes_with_accounting(pkg):
    dc = pkg.Local("D", shape=(1,), init=lambda k: np.zeros(1))
    a = _compound_chain(pkg, 3, "phase_a", dc)
    b = _compound_chain(pkg, 4, "phase_b", dc)
    comp = pkg.Compound(a, b, name="pipeline")
    with pkg.service() as sv:
        h = sv.submit("etl", comp, priority=2)
        assert h.wait(timeout=60), h.status()
        assert final_value(dc) == 7.0
        assert comp.nb_retired == 2
        for member in (a, b):
            assert member.tenant == "etl"
            assert member.priority_base == comp.priority_base
            assert member.progress()["tenant"] == "etl"
        assert a.nb_retired == 3 and b.nb_retired == 4
        row = sv.status_doc()["tenants"]["etl"]
        assert row["completed"] == 1 and row["failed"] == 0
        assert row["retired"] >= 2


def test_compose_through_service(pkg):
    dc = pkg.Local("D", shape=(1,), init=lambda k: np.zeros(1))
    comp = pkg.compose(_compound_chain(pkg, 2, "s1", dc), _compound_chain(pkg, 2, "s2", dc))
    with pkg.service() as sv:
        h = sv.submit("t", comp)
        assert h.wait(timeout=60)
        assert final_value(dc) == 4.0
        assert comp.is_done() and not comp.failed


# ---------------------------------------------------------------------------
# tests/serve/test_fairness.py
# ---------------------------------------------------------------------------

def test_wdrr_unit_fair_share_and_priority_within_tenant(pkg):
    sched_mod = __import__(f"{pkg.top.__name__}.core.sched.wdrr", fromlist=["SchedWDRR"])

    class _Ctx:
        nb_workers = 1

    sched = sched_mod.SchedWDRR()
    sched.install(_Ctx())

    def mk_pool(tenant, weight):
        tp = pkg.top.Taskpool(f"p_{tenant}", nb_tasks=1)
        tp.tenant, tp.tenant_weight = tenant, weight
        return tp

    tc = pkg.top.TaskClass("t")
    a, b = mk_pool("a", 1), mk_pool("b", 1)
    sched.schedule(None, [pkg.top.Task(a, tc, (i,), priority=i) for i in range(8)])
    sched.schedule(None, [pkg.top.Task(b, tc, (i,), priority=i) for i in range(8)])
    order = [sched._key_of(sched.select(None)) for _ in range(16)]
    assert sched.select(None) is None
    q = sched._quantum
    assert set(order[:2 * q]) == {"a", "b"}
    assert order.count("a") == order.count("b") == 8
    sched.install(_Ctx())
    heavy, light = mk_pool("h", 2), mk_pool("l", 1)
    sched.schedule(None, [pkg.top.Task(heavy, tc, (i,)) for i in range(12)])
    sched.schedule(None, [pkg.top.Task(light, tc, (i,)) for i in range(12)])
    first12 = [sched._key_of(sched.select(None)) for _ in range(12)]
    assert first12.count("h") == 2 * first12.count("l")
    sched.install(_Ctx())
    solo = mk_pool("s", 1)
    sched.schedule(None, [pkg.top.Task(solo, tc, (i,), priority=i) for i in range(5)])
    got = [sched.select(None).priority for _ in range(5)]
    assert got == sorted(got, reverse=True)


def _small_job(pk, i):
    dc = pk.Local("S", shape=(1,), init=lambda k: np.zeros(4))
    ptg = pk.PTG(f"small{i}")
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("S(0)")
    step.flow("X", pk.INOUT, "<- (k == 0) ? S(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : S(0)")
    step.body(cpu=lambda X, k: X.__iadd__(1.0))
    return ptg.taskpool(N=12, S=dc), dc


def test_small_jobs_not_starved_by_big_job():
    """The floor, read off counters instead of clocks: while a 5984-task
    dpotrf (NT=32) runs under wdrr, each small job submitted behind its
    backlog completes with the big job still far from done — under a
    starving order it would wait out the whole backlog first."""
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops import cholesky_ptg

    pk = PKGS["port"]
    rng = np.random.default_rng(5)
    M = rng.standard_normal((1024, 1024))
    A = TiledMatrix(1024, 1024, 32, 32, name="big", dtype=np.float64).from_array(
        M @ M.T + 1024 * np.eye(1024))
    big_tp = cholesky_ptg(use_cuda=False).taskpool(NT=A.mt, A=A)
    with pk.service(nb_cores=2) as sv:
        sv.tenant("batch", weight=1)
        sv.tenant("online", weight=1)
        big = sv.submit("batch", big_tp)
        wait_until(lambda: big_tp.nb_retired >= 50, 60, "the big job to flow")
        at_done = []
        for i in range(4):
            tp, dc = _small_job(pk, i)
            h = sv.submit("online", tp)
            assert h.wait(timeout=120), h.status()
            at_done.append(big_tp.nb_retired)
            assert float(dc.data_of(0).newest_copy().payload[0]) == 12.0
        assert big.wait(timeout=600), big.status()
        assert big_tp.nb_retired == 5984
    assert max(at_done) < 5984 // 2, at_done


# ---------------------------------------------------------------------------
# tests/serve/test_saturation.py
# ---------------------------------------------------------------------------

JOB_SHAPE = (128, 128)
JOB_BYTES = 128 * 128 * 8
NTASKS = 6


def _arena_job(pk, i, arena, held, hold):
    dc = pk.Local("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = pk.PTG(f"sat{i}")
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", pk.INOUT, "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")

    def body(X, k):
        if k == 0:
            held[i] = arena.allocate()
            assert held[i] is not None
            hold.wait(timeout=0.03)  # the working set is held a while
        X += 1.0
        if k == NTASKS - 1:
            arena.release(held.pop(i))

    step.body(cpu=body)
    return ptg.taskpool(N=NTASKS, D=dc), dc


def test_burst_queues_under_arena_budget_and_completes_bit_identical(pkg):
    arena = pkg.Arena(JOB_SHAPE, name=f"satjobs_{pkg.name}")
    held = {}
    hold = threading.Event()  # never set: each first body holds 30 ms
    budget = 3 * JOB_BYTES
    with pkg.service(nb_cores=4) as sv:
        sv.arena_budget = budget
        sv.max_inflight_pools = 64
        peak = [0]
        stop = threading.Event()

        def monitor():
            while not stop.is_set():
                peak[0] = max(peak[0], arena.stats()["bytes_in_use"])
                stop.wait(0.002)

        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        try:
            handles = []
            for i in range(10):
                tp, dc = _arena_job(pkg, i, arena, held, hold)
                handles.append((sv.submit("burst", tp, est_bytes=JOB_BYTES), dc))
            with sv._lock:
                queued_now = len(sv._queue)
            assert sv.status_doc()["jobs"]["rejected"] == 0
            assert queued_now > 0, "the burst was admitted wholesale"
            for h, dc in handles:
                assert h.wait(timeout=120), h.status()
                assert final_value(dc) == float(NTASKS)
        finally:
            stop.set()
            mon.join(timeout=5)
        assert not held
        assert peak[0] <= budget, peak[0]


def test_zero_budget_means_unbounded(pkg):
    arena = pkg.Arena(JOB_SHAPE, name=f"satjobs0_{pkg.name}")
    held = {}
    hold = threading.Event()
    with pkg.service(nb_cores=4) as sv:
        assert sv.arena_budget == 0
        hs = [sv.submit("burst", _arena_job(pkg, i, arena, held, hold)[0],
                        est_bytes=JOB_BYTES) for i in range(4)]
        # no gate: the burst is admitted at submit, nothing queues
        assert sv.counters()["queued"] == 0.0
        for h in hs:
            assert h.wait(timeout=60)


# ---------------------------------------------------------------------------
# tests/serve/test_attention_serving.py
# ---------------------------------------------------------------------------

H, D = 2, 8


def _qkv(sq, sk, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal((1, s, H, D)).astype(np.float32)  # noqa: E731
    return mk(sq), mk(sk), mk(sk)


def _attention_job(name, seed, decode, device_path=False):
    """A decode (4 query rows at the tail of 64 keys) or prefill (96)
    pool through ``name``'s builder; the port's ``device_path`` pool runs
    every step through the B5 wrapper on the CUDA module."""
    if decode:
        q_full, k, v = _qkv(64, 64, seed)
        q = np.ascontiguousarray(q_full[:, -4:])
        kw = dict(causal=True, q_block=4, kv_block=16)
    else:
        q, k, v = _qkv(96, 96, seed)
        kw = dict(causal=True, q_block=16, kv_block=16)
    if name == "ref":
        from parsec_tpu.ops.attention import build_flash_attention

        return build_flash_attention(q, k, v, use_tpu=False, use_cpu=True, **kw)
    from parsec_tpu_torch.ops import build_flash_attention

    if device_path:
        return build_flash_attention(q, k, v, use_cpu=False, **kw)
    return build_flash_attention(q, k, v, use_cuda=False, use_cpu=True, **kw)


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("device_path", [False, True], ids=["host", "cuda_module"])
def test_decode_stream_coresident_with_prefill_bit_identical(device_path):
    """Three decode jobs stream in beside a prefill under wdrr: every
    served output equals its solo run bit for bit, and the port's host
    chores equal the reference's served outputs (the B5 wrapper's plain
    version within the reference test's 2e-5)."""
    solo = []
    ctx = PKGS["port"].context(nb_cores=2)
    try:
        for i in range(3):
            tp, assemble = _attention_job("port", 100 + i, True, device_path)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
            solo.append(assemble())
    finally:
        ctx.fini()
    outs = {}
    for name in ("port", "ref"):
        with PKGS[name].service(nb_cores=4) as sv:
            big_tp, big_assemble = _attention_job(name, 7, False,
                                                  device_path and name == "port")
            big = sv.submit("batch", big_tp, priority=4)
            handles = []
            for i in range(3):
                tp, assemble = _attention_job(name, 100 + i, True, device_path and name == "port")
                handles.append((sv.submit("online", tp), assemble))
            outs[name] = []
            for h, assemble in handles:
                assert h.wait(timeout=300), h.status()
                outs[name].append(_as_np(assemble()))
                assert h.latency_s is not None and h.latency_s >= 0
            assert big.wait(timeout=600), big.status()
            big_assemble()
            doc = sv.status_doc()
            assert doc["tenants"]["online"]["completed"] == 3
            assert doc["tenants"]["batch"]["completed"] == 1
    for i in range(3):
        assert np.array_equal(outs["port"][i], _as_np(solo[i]))
        if device_path:
            np.testing.assert_allclose(outs["port"][i], outs["ref"][i], rtol=2e-5, atol=2e-5)
        else:
            assert np.array_equal(outs["port"][i], outs["ref"][i])


def test_decode_burst_queues_past_inflight_bound(pkg):
    with pkg.service() as sv:
        sv.max_inflight_pools = 2
        jobs = []
        for i in range(6):
            tp, assemble = _attention_job(pkg.name, 200 + i, True)
            jobs.append((sv.submit("online", tp), assemble))
        assert sv.counters()["rejected"] == 0
        for h, assemble in jobs:
            assert h.wait(timeout=300), h.status()
            assert np.all(np.isfinite(_as_np(assemble())))
        assert sv.counters()["done"] == 6


# ---------------------------------------------------------------------------
# tests/serve/test_concurrent_pools.py (single rank) and
# tests/serve/test_explorer_mixed.py (at the port's one rank)
# ---------------------------------------------------------------------------

N_CP, NB_CP = 64, 16
_cp_rng = np.random.default_rng(42)
_CP_M = _cp_rng.standard_normal((N_CP, N_CP))
SPD = _CP_M @ _CP_M.T + N_CP * np.eye(N_CP)
LUIN = _cp_rng.standard_normal((N_CP, N_CP)) + N_CP * np.eye(N_CP)
GRID = _cp_rng.standard_normal((32, 48))
ST_ITERS = 4


def _port_pool(kind):
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops import cholesky_ptg
    from parsec_tpu_torch.ops.lu import lu_ptg
    from parsec_tpu_torch.ops.stencil import StencilBuffers, stencil_ptg

    if kind.startswith("dpotrf"):
        A = TiledMatrix(N_CP, N_CP, NB_CP, NB_CP, name=f"A{kind}", dtype=np.float64).from_array(SPD)
        return cholesky_ptg(use_cuda=False).taskpool(NT=A.mt, A=A), A
    if kind.startswith("lu"):
        A = TiledMatrix(N_CP, N_CP, NB_CP, NB_CP, name=f"B{kind}", dtype=np.float64).from_array(LUIN)
        return lu_ptg(use_cuda=False).taskpool(NT=A.mt, A=A), A
    bufs = StencilBuffers(GRID, 4, 3)
    return stencil_ptg(use_cuda=False).taskpool(T=ST_ITERS, MT=4, NT=3, A=bufs), bufs


def _port_digest(kind, user):
    if kind.startswith("stencil"):
        parity = ST_ITERS % 2
        return {(i, j): np.asarray(user.data_of(parity, i, j).newest_copy().payload).tobytes()
                for i in range(user.mt) for j in range(user.nt)}
    return user.to_array().tobytes()


@pytest.mark.parametrize("kinds", [
    ["dpotrf0", "stencil0"],
    ["dpotrf0", "stencil0", "lu0"],
    ["dpotrf0", "stencil0", "lu0", "dpotrf1", "stencil1", "lu1", "dpotrf2", "lu2"],
], ids=["2pools", "3pools", "8pools"])
def test_concurrent_heterogeneous_pools_single_rank(kinds):
    solo = {}
    for kind in sorted(set(kinds)):
        ctx = PKGS["port"].context(nb_cores=2)
        try:
            tp, user = _port_pool(kind)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
            solo[kind] = _port_digest(kind, user)
        finally:
            ctx.fini()
    ctx = PKGS["port"].context(nb_cores=4)
    try:
        pools = [(kind, *_port_pool(kind)) for kind in kinds]
        for _, tp, _u in pools:
            ctx.add_taskpool(tp)
        ctx.start()
        for kind, tp, _u in pools:
            assert tp.wait(timeout=180), f"{kind} hung concurrently"
        for kind, tp, user in pools:
            assert tp.is_done() and not tp.failed
            assert tp.progress()["retired"] == tp.progress()["known"]
            assert _port_digest(kind, user) == solo[kind], kind
    finally:
        ctx.fini()


def test_mixed_2tenant_sweep_4seeds(port_param):
    """Two tenant-tagged pools co-resident on one context under the
    schedule explorer's seeded pop orders: every seed quiesces with the
    same tiles and no race."""
    from parsec_tpu_torch.analysis.schedules import explore, tile_digest
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.ops import cholesky_ptg

    port_param("device", "cuda_torch_device", "cpu")

    def tag(tp, tenant, weight, job):
        tp.tenant, tp.tenant_weight, tp.job_priority = tenant, weight, job
        tp.priority_base = port_serve.compose_priority(weight, job)
        return tp

    def build(rank, ctx):
        A = TiledMatrix(48, 48, 16, 16, name="expA", dtype=np.float64).from_array(SPD[:48, :48])
        big = tag(cholesky_ptg(use_cuda=False).taskpool(NT=A.mt, A=A), "batch", 1, 0)
        small, dc = _small_job(PKGS["port"], "x")
        return [big, tag(small, "online", 2, 1)], (A, dc)

    def snapshot(users):
        (A, dc), = users
        return [tile_digest(A), np.asarray(dc.data_of(0).newest_copy().payload).tobytes()]

    res = explore(build, nranks=1, seeds=range(4), snapshot=snapshot, timeout=180)
    assert res.identical and not res.race_findings(), res.summary()
    assert len(res.seeds) == 4 and not res.errors
