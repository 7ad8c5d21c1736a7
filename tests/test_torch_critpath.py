"""The port's critical-path analyzer (parsec_tpu_torch.profiling.critpath)
and straggler comparison (profiling.slo) against the JAX package's.

``analyze`` and ``render`` over fixed, seeded event lists — random DAGs
with exec spans, release edges, class/tenant/job instants, comm, coll,
compile and transfer spans, fused regions, wire-regime instants and
job phases, over several rank tracks — give reports ``==`` the
reference's (the same host arithmetic in the same order), stragglers
included; the reference's golden cases run against both packages; and a
real traced dynamic run walks its chain end to end.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from parsec_tpu.profiling import critpath as ref_critpath  # noqa: E402
from parsec_tpu.profiling import slo as ref_slo  # noqa: E402
from parsec_tpu_torch.profiling import critpath, slo  # noqa: E402

BOTH = pytest.mark.parametrize("cp", [critpath, ref_critpath], ids=["port", "reference"])


def _span(name, pid, b, e, tok=None, tid="w"):
    args = {} if tok is None else {"event_id": tok}
    return [
        {"name": name, "ph": "B", "ts": b, "pid": pid, "tid": tid, "args": dict(args)},
        {"name": name, "ph": "E", "ts": e, "pid": pid, "tid": tid, "args": dict(args)},
    ]


def _inst(name, pid, eid, info=None, ts=0.0):
    args = {"event_id": eid}
    if info is not None:
        args["info"] = info
    return {"name": name, "ph": "i", "ts": ts, "pid": pid, "tid": "w", "args": args}


def seeded_events(seed, nranks=3, ntasks=40):
    """A random DAG per rank track: tasks in topological order, each with
    an exec span after its predecessors' ends, release edges, classes
    (one class slowed on one rank: a straggler), tenants, job maps, a
    fused region, and overlapping comm/coll/compile/transfer spans."""
    rng = np.random.default_rng(seed)
    evs = []
    job = 0x1234ABCD
    for pid in range(nranks):
        ends = {}
        for t in range(1, ntasks + 1):
            preds = [p for p in range(1, t) if rng.random() < 0.15]
            begin = max([ends[p] for p in preds], default=0.0) + float(rng.integers(0, 40))
            cls = ["potrf", "trsm", "syrk", "gemm", "attn_step"][t % 5]
            dur = float(rng.integers(5, 60)) * (8.0 if (pid == 2 and cls == "gemm") else 1.0)
            ends[t] = begin + dur
            evs += _span("exec", pid, begin, ends[t], tok=t, tid=f"w{t % 3}")
            evs += [_inst("dep_edge", pid, p, t) for p in preds]
            evs.append(_inst(f"class:{cls}", pid, t))
            if t % 7 == 0:
                evs.append(_inst("tenant:alice" if t % 2 else "tenant:bob", pid, t))
            if t % 3 == 0:
                evs.append(_inst("job_map", pid, t, job))
            if t % 11 == 0:
                evs.append(_inst("fused_n", pid, t, int(rng.integers(2, 9))))
        for name, pair_by_id in (("ce_recv", False), ("compile", False),
                                 ("coll", True), ("stage_in", True), ("writeback", True)):
            for j in range(int(rng.integers(2, 6))):
                b = float(rng.uniform(0, max(ends.values())))
                e = b + float(rng.uniform(1, 50))
                evs += _span(name, pid, b, e, tok=j if pair_by_id else None,
                             tid=f"{name}{j % 2}")
        for j in range(int(rng.integers(1, 4))):
            evs.append(_inst("comm_recv_eager", pid, 1, int(rng.integers(1, 4096))))
            evs.append(_inst("comm_recv_rdv", pid, (j << 16) | 2, int(rng.integers(1, 1 << 20))))
    evs += [_inst("job_phase", 0, job, 1, ts=0.0), _inst("job_phase", 0, job, 2, ts=5.0),
            _inst("job_phase", 0, job, 3, ts=1e6)]
    order = rng.permutation(len(evs))
    return [evs[i] for i in order]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_analyze_and_render_equal_the_reference(seed):
    evs = seeded_events(seed)
    mine, ref = critpath.analyze(evs), ref_critpath.analyze(evs)
    assert mine == ref
    assert mine["n_tasks"] > 1
    assert critpath.render(mine) == ref_critpath.render(ref)


@pytest.mark.parametrize("seed", [0, 3])
def test_job_slice_equals_the_reference(seed):
    evs = seeded_events(seed)
    mine = critpath.analyze(evs, job="000000001234abcd")
    assert mine == ref_critpath.analyze(evs, job="000000001234abcd")
    assert mine["phases"] is not None and mine["job"] == "000000001234abcd"
    assert critpath.render(mine) == ref_critpath.render(mine)


@pytest.mark.parametrize("factor,min_samples", [(None, None), (1.5, 2), (20.0, 1)])
def test_stragglers_equal_the_reference(factor, min_samples):
    evs = seeded_events(7, nranks=4, ntasks=60)
    kw = dict(straggler_factor=factor, straggler_min_samples=min_samples)
    mine = critpath.analyze(evs, **kw)["stragglers"]
    assert mine == ref_critpath.analyze(evs, **kw)["stragglers"]
    if factor == 1.5:
        assert any(s["class"] == "gemm" and s["rank"] == 2 for s in mine)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_stragglers_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    by_class = {f"c{c}": {r: (int(rng.integers(0, 10)), float(rng.uniform(0.5, 10.0)))
                          for r in range(int(rng.integers(1, 6)))}
                for c in range(6)}
    for factor, min_samples in ((1.2, 1), (2.0, 3), (3.0, 5)):
        assert slo.mesh_stragglers(by_class, factor, min_samples) == \
            ref_slo.mesh_stragglers(by_class, factor, min_samples)


def test_straggler_params_are_the_references():
    assert slo.straggler_params() == ref_slo.straggler_params() == (3.0, 5)


def golden_events():
    """The reference's 3-task chain on rank 0: A[0,100] -> B[150,250] ->
    C[300,400], a ce_recv [100,130] covering 30 of the 50 us A->B gap,
    and a distractor D[0,390] on rank 1 that must not hijack the chain."""
    evs = []
    evs += _span("exec", 0, 0, 100, tok=1)
    evs += _span("exec", 0, 150, 250, tok=2)
    evs += _span("exec", 0, 300, 400, tok=3)
    evs += _span("ce_recv", 0, 100, 130, tid="comm")
    evs += [_inst("dep_edge", 0, 1, 2), _inst("dep_edge", 0, 2, 3)]
    evs += [_inst("class:panel", 0, 1), _inst("class:panel", 0, 2), _inst("class:update", 0, 3)]
    evs += _span("exec", 1, 0, 390, tok=1)
    return evs


@BOTH
def test_critpath_golden_chain(cp):
    rep = cp.analyze(golden_events())
    assert rep["n_tasks"] == 3
    assert rep["wall_us"] == pytest.approx(400.0)
    b = rep["buckets"]
    assert b["compute_us"] == pytest.approx(300.0)
    assert b["comm_us"] == pytest.approx(30.0)
    assert b["host_gap_us"] == pytest.approx(70.0)
    assert rep["coverage"] == pytest.approx(1.0)
    pc = rep["per_class"]
    assert pc["panel"]["count"] == 2
    assert pc["panel"]["compute_us"] == pytest.approx(200.0)
    assert pc["panel"]["comm_us"] == pytest.approx(30.0)
    assert pc["panel"]["host_gap_us"] == pytest.approx(20.0)
    assert pc["update"]["host_gap_us"] == pytest.approx(50.0)
    assert [r["token"] for r in rep["chain"]] == [1, 2, 3]
    assert rep["chain"][1]["gap_comm_us"] == pytest.approx(30.0)


@BOTH
def test_critpath_empty_and_render(cp):
    rep = cp.analyze([])
    assert rep["n_tasks"] == 0 and rep["wall_us"] == 0.0
    assert rep["per_label"] == {}
    text = cp.render(cp.analyze(golden_events()))
    assert "critical path: 3 tasks" in text
    assert "host_gap" in text and "update" in text


@BOTH
def test_critpath_compile_bucket(cp):
    """A gap under a ``compile`` span is cold-start cost, not host gap,
    and a microsecond double-covered by comm is never counted twice."""
    evs = golden_events() + _span("compile", 0, 260, 300, tid="mgr")
    rep = cp.analyze(evs)
    b = rep["buckets"]
    assert b["compile_us"] == pytest.approx(40.0)
    assert b["host_gap_us"] == pytest.approx(30.0)
    assert rep["per_class"]["update"]["compile_us"] == pytest.approx(40.0)
    assert rep["chain"][2]["gap_compile_us"] == pytest.approx(40.0)
    b2 = cp.analyze(golden_events() + _span("compile", 0, 100, 140, tid="mgr"))["buckets"]
    assert b2["comm_us"] == pytest.approx(30.0)
    assert b2["compile_us"] == pytest.approx(20.0)
    assert b2["comm_us"] + b2["compile_us"] + b2["host_gap_us"] == pytest.approx(100.0)
    assert "compile" in cp.render(rep)


@BOTH
def test_critpath_coll_and_transfer_buckets(cp):
    """``coll`` and the staging pipeline's ``stage_in``/``writeback``
    spans pair by event_id across threads; the precedence comm > coll >
    compile > transfer never attributes a microsecond twice."""
    evs = golden_events() + _span("coll", 0, 255, 295, tok=77, tid="issuer")
    b = cp.analyze(evs)["buckets"]
    assert b["coll_us"] == pytest.approx(40.0) and b["host_gap_us"] == pytest.approx(30.0)
    evs2 = golden_events() + [
        {"name": "stage_in", "ph": "B", "ts": 260.0, "pid": 0, "tid": "lane", "args": {"event_id": 9}},
        {"name": "stage_in", "ph": "E", "ts": 290.0, "pid": 0, "tid": "pump", "args": {"event_id": 9}}]
    b2 = cp.analyze(evs2)["buckets"]
    assert b2["transfer_us"] == pytest.approx(30.0)
    assert b2["host_gap_us"] == pytest.approx(40.0)
    evs3 = golden_events() + _span("writeback", 0, 100, 140, tok=5, tid="committer")
    b3 = cp.analyze(evs3)["buckets"]
    assert b3["comm_us"] == pytest.approx(30.0) and b3["transfer_us"] == pytest.approx(20.0)
    assert "transfer" in cp.render(cp.analyze(evs2))


@BOTH
def test_critpath_per_label_rollup(cp):
    evs = []
    evs += _span("exec", 0, 0, 100, tok=1)
    evs += _span("exec", 0, 120, 200, tok=2)
    evs += _span("exec", 0, 220, 260, tok=3)
    evs += [_inst("dep_edge", 0, 1, 2), _inst("dep_edge", 0, 2, 3)]
    evs += [_inst("class:attn_step", 0, 1), _inst("class:attn_rstep", 0, 2),
            _inst("class:potrf", 0, 3)]
    rep = cp.analyze(evs)
    lab = rep["per_label"]["attention"]
    assert lab["count"] == 2 and lab["compute_us"] == pytest.approx(180.0)
    assert set(rep["per_label"]) == {"attention"}
    assert "attention" in cp.render(rep)


@BOTH
def test_critpath_fused_golden(cp):
    ev = []
    ev += _span("exec", 0, 0.0, 100.0, tok=1)
    ev += _span("exec", 0, 120.0, 150.0, tok=2)
    ev += _span("exec", 0, 160.0, 170.0, tok=3)
    ev += [_inst("class:fused[attn_step+attn_out]", 0, 1),
           _inst("class:fused[attn_step+attn_out]", 0, 2), _inst("class:attn_out", 0, 3),
           _inst("fused_n", 0, 1, 8), _inst("fused_n", 0, 2, 4),
           _inst("dep_edge", 0, 1, 2), _inst("dep_edge", 0, 2, 3)]
    rep = cp.analyze(ev)
    assert rep["n_tasks"] == 3
    assert rep["fused"] == {"regions": 2, "tasks": 12, "dispatch_saved": 10}
    assert rep["per_label"]["attention"]["count"] == 3
    text = cp.render(rep)
    assert "fused dispatch saved: 10" in text and "2 fused regions" in text


@pytest.mark.parametrize("name,label", [
    ("fused[attn_step+attn_out]", "attention"), ("attn_step", "attention"),
    ("attn_out", "attention"), ("arr_matmul", "array"), ("potrf", None),
    ("fused[attn_step+potrf]", None), ("fused[potrf+syrk]", None)])
def test_label_of_equals_the_reference(name, label):
    assert critpath.label_of(name) == ref_critpath.label_of(name) == label


@BOTH
def test_job_phase_run_window_clamped_into_envelope(cp):
    tid = 0xABC
    evs = []
    evs += _span("exec", 0, -2, 100, tok=1)
    evs += _span("exec", 1, 150, 405, tok=2)
    evs += [_inst("dep_edge", 0, 1, 2), _inst("job_map", 0, 1, tid), _inst("job_map", 1, 2, tid),
            _inst("job_phase", 0, tid, 1, ts=0.0), _inst("job_phase", 0, tid, 2, ts=10.0),
            _inst("job_phase", 0, tid, 3, ts=400.0)]
    ph = cp.analyze(evs, job="abc")["phases"]
    assert ph["total_us"] == pytest.approx(400.0)
    assert ph["run_us"] == pytest.approx(400.0) and ph["run_us"] <= ph["total_us"]
    assert ph["drain_us"] == pytest.approx(0.0)
    assert ph["queue_us"] == pytest.approx(10.0)


def test_tools_critpath_cli_equals_the_reference(tmp_path, capsys):
    from parsec_tpu.profiling.tools import main as ref_main
    from parsec_tpu_torch.profiling.tools import main

    p = str(tmp_path / "t.json")
    with open(p, "w") as f:
        json.dump({"traceEvents": seeded_events(11)}, f)
    outs = []
    for fn in (main, ref_main):
        for extra in ([], ["--json"]):
            assert fn(["critpath", p, *extra]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert "critical path:" in outs[0]
    assert json.loads(outs[1]) == json.loads(json.dumps(critpath.analyze(seeded_events(11))))
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        json.dump({"traceEvents": []}, f)
    assert main(["critpath", empty]) == ref_main(["critpath", empty]) == 1


def test_critpath_on_a_real_dynamic_trace(tmp_path):
    """A real single-rank chain through the binary tracer and the
    measure_overlap scope: the chain is recovered end to end through the
    recorded edges and its wall is attributed across the buckets."""
    import parsec_tpu_torch
    from parsec_tpu_torch.core.lifecycle import AccessMode
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl.ptg import PTG
    from parsec_tpu_torch.profiling.overlap import measure_overlap

    K = 12
    stats = {}
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        with measure_overlap(stats, trace_dir=str(tmp_path)):
            web = PTG("critpath_chain")
            tc = web.task_class("link", k=f"0 .. {K - 1}")
            tc.affinity("D(0)")
            tc.flow("A", AccessMode.INOUT,
                    "<- (k == 0) ? D(0) : A link(k-1)",
                    f"-> (k == {K - 1}) ? D(0) : A link(k+1)")
            tc.body(cpu=lambda A, k: np.dot(np.ones((64, 64)), np.ones((64, 64))))
            tp = web.taskpool(D=LocalCollection("D", shape=(4,), dtype=np.float64))
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
    with open(stats["merged_trace"]) as f:
        doc = json.load(f)
    rep = critpath.analyze(doc["traceEvents"])
    assert rep["n_tasks"] == K
    assert rep["per_class"]["link"]["count"] == K
    assert rep["coverage"] >= 0.8 and rep["buckets"]["compute_us"] > 0
    assert rep["buckets"]["comm_us"] == 0.0
    # one rank, no comm layer: no comm events, the busy time still read
    assert stats["n_comm_events"] == 0 and stats["overlap_fraction"] == 0.0
    assert stats["busy_us"] > 0 and stats["trace_ranks"] == 1
    assert stats["overlap_per_rank"] == [None]


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_measure_overlap_beyond_one_rank(pkg, tmp_path):
    """``measure_overlap(nranks=2)`` around a 2-rank 2x1 dpotrf: one
    overlap fraction a rank (each rank's comm instants against its OWN
    exec spans), a merged trace with two tracks, and per-rank chains that
    ``analyze_ranks`` splits on each track.  The comm-event count is the
    protocol's, the same on both packages."""
    import parsec_tpu.profiling.overlap as ref_overlap
    from parsec_tpu_torch.profiling import overlap
    from test_torch_multirank import PORT, REF, run_ranks

    P = PORT if pkg == "port" else REF
    mod = overlap if pkg == "port" else ref_overlap
    n, nb, nranks = 32, 8, 2
    S = np.random.default_rng(3).standard_normal((n, n))
    S = S @ S.T + n * np.eye(n)

    def build(r, ctx):
        A = P["BC"](n, n, nb, nb, p=2, q=1, myrank=r, name="A")
        A.from_array(S)
        return P["chol"]().taskpool(NT=A.mt, A=A)

    stats = {}
    with mod.measure_overlap(stats, nranks=nranks, trace_dir=str(tmp_path)):
        run_ranks(P, nranks, build)
    assert stats["trace_ranks"] == nranks
    assert len(stats["overlap_per_rank"]) == nranks
    assert all(f is not None and 0.0 <= f <= 1.0 for f in stats["overlap_per_rank"])
    assert stats["overlap_min"] <= stats["overlap_fraction"] <= 1.0
    assert stats["n_comm_events"] > 0 and stats["busy_us"] > 0
    with open(stats["merged_trace"]) as f:
        doc = json.load(f)
    per = critpath.analyze_ranks(doc["traceEvents"])
    assert sorted(per) == [0, 1]
    for rep in per.values():
        w = rep["window"]
        assert rep["n_tasks"] >= 1 and w["exec_spans"] >= rep["n_tasks"]
        assert w["exec_us"] + w["comm_us"] <= w["window_us"] + 1e-6


def test_fused_run_trace_reports_dispatch_saved(tmp_path):
    """A fused dynamic prefill on the CUDA module (bound to the torch CPU
    device) through the binary tracer: the fused regions' ``fused_n``
    instants give the dispatches saved, and the fused chains roll up
    under the ``attention`` label."""
    import parsec_tpu_torch
    from parsec_tpu_torch import mca_param
    from parsec_tpu_torch.ops import run_flash_attention
    from parsec_tpu_torch.profiling.overlap import measure_overlap

    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 128, 2, 8)).astype(np.float32)
    mca_param.set_param("runtime", "fusion", "auto")
    stats = {}
    try:
        with measure_overlap(stats, trace_dir=str(tmp_path)):
            with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
                run_flash_attention(ctx, q, q, q, causal=True, q_block=32, kv_block=32,
                                    use_cpu=False)
    finally:
        mca_param.unset("runtime", "fusion")
    with open(stats["merged_trace"]) as f:
        doc = json.load(f)
    rep = critpath.analyze(doc.get("traceEvents", []))
    fu = rep["fused"]
    assert fu["regions"] > 0 and fu["tasks"] > fu["regions"]
    assert fu["dispatch_saved"] == fu["tasks"] - fu["regions"]
    assert rep["per_label"].get("attention", {}).get("count", 0) > 0
    assert "fused dispatch saved" in critpath.render(rep)
