"""The port's trace commands (parsec_tpu_torch.profiling.tools: ``info``,
``to-csv``, ``merge``, ``critpath``, ``hbcheck``, ``check``,
``check-comms``) and the merge module against the JAX package's.

On the same dumps — a traced dpotrf of the port on the native pump and
on the dynamic path, a dump the JAX package wrote, and the reference's
Chrome JSON cases — every command prints the same output and exits with
the same code as the reference's.  ``check`` (graph lint, ABI, model,
doc drift, tidy, hbcheck) passes on the tree; ``check-comms`` prints the
reference's table and exit codes, and the clock handshake runs over an
in-process fabric.  The reference's single-rank merge cases (epoch
alignment, a clock offset, job stitching of a standalone pool) run on
the port's tracer, and both packages merge the dumps to one document.
"""

import json
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.profiling import binary as ref_binary  # noqa: E402
from parsec_tpu.profiling import merge as ref_merge  # noqa: E402
from parsec_tpu.profiling.tools import main as ref_tools  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.dsl.ptg import INOUT, PTG  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402
from parsec_tpu_torch.profiling import binary, critpath, jobtrace, merge  # noqa: E402
from parsec_tpu_torch.profiling import TaskProfiler  # noqa: E402
from parsec_tpu_torch.profiling.tools import main as tools  # noqa: E402


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """One traced dpotrf (N=256, nb=64) a path: the port's pump and
    dynamic path on the CUDA module bound to the torch CPU device, and
    the JAX package's dynamic path on host chores."""
    root = tmp_path_factory.mktemp("dumps")
    out = {}
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    try:
        for path in ("pump", "dynamic"):
            A = TiledMatrix(256, 256, 64, 64, name="A", dtype=np.float32).from_array(
                _spd(256).astype(np.float32))
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
                NT=A.mt, A=A)
            ts = binary.RankTraceSet(1).install()
            try:
                if path == "pump":
                    ex = NativeExecutor(tp, native_device=True)
                    try:
                        ex.run()
                    finally:
                        ex.close()
                else:
                    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
                        ctx.add_taskpool(tp)
                        assert tp.wait(timeout=60)
            finally:
                ts.uninstall()
            out[path] = ts.dump(str(root / path))[0]
            ts.close()
    finally:
        mca_param.unset("device", "cuda_torch_device")
    A = RefTiledMatrix(256, 256, 64, 64, name="A").from_array(_spd(256))
    ts = ref_binary.RankTraceSet(1).install()
    try:
        with parsec_tpu.Context(nb_cores=2, devices=["cpu"]) as ctx:
            tp = ref_cholesky_ptg(use_tpu=False, use_cpu=True).taskpool(NT=A.mt, A=A)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
    finally:
        ts.uninstall()
    out["reference"] = ts.dump(str(root / "reference"))[0]
    ts.close()
    return out


def _both(capsys, argv, out=None):
    """(rc, stdout, file) of the port's and of the reference's command."""
    res = []
    for fn in (tools, ref_tools):
        rc = fn(argv)
        text = capsys.readouterr().out
        body = open(out).read() if out else None
        res.append((rc, text, body))
    return res


@pytest.mark.parametrize("which", ["pump", "dynamic", "reference"])
@pytest.mark.parametrize("cmd", ["info", "to-csv", "critpath", "critpath-json", "hbcheck"])
def test_command_output_equals_the_reference(dumps, capsys, cmd, which):
    argv = {"critpath-json": ["critpath", dumps[which], "--json"]}.get(cmd, [cmd, dumps[which]])
    mine, ref = _both(capsys, argv)
    assert mine == ref
    assert mine[0] == 0, mine[1]


@pytest.mark.parametrize("which", ["pump", "dynamic", "reference"])
def test_merge_output_equals_the_reference(dumps, capsys, tmp_path, which):
    out = str(tmp_path / "merged.json")
    mine, ref = _both(capsys, ["merge", dumps[which], "-o", out, "--overlap"], out=out)
    assert mine == ref and mine[0] == 0
    doc = json.loads(mine[2])
    assert doc["metadata"]["ranks"] == [0] and doc["metadata"]["aligned"] is True
    assert "1 trace(s), 1 rank track(s) [0]" in mine[1]


def test_to_csv_file_equals_the_reference(dumps, capsys, tmp_path):
    out = str(tmp_path / "spans.csv")
    mine, ref = _both(capsys, ["to-csv", dumps["pump"], "-o", out], out=out)
    assert mine == ref
    lines = mine[2].strip().split("\n")
    assert lines[0].startswith("name,pid,tid,begin_us,end_us,dur_us")
    assert sum(1 for ln in lines if ln.startswith("exec,")) == 20


def test_critpath_over_the_pump_dump_walks_the_longest_path(dumps):
    rep = critpath.analyze(binary.read_pbt(dumps["pump"]))
    assert rep["n_tasks"] == 10  # 3 (NT - 1) + 1 at NT = 4
    assert rep["coverage"] == pytest.approx(1.0)
    assert set(rep["per_class"]) == {"potrf", "trsm", "syrk"}


def test_check_gate_passes_on_the_tree(dumps, capsys):
    """The aggregate gate: graph lint over every registered graph, the ABI
    contract (ENG006's reader leg included), the lifecycle model, the MCA
    doc drift, tidy (skipped without clang-tidy) and hbcheck over a dump."""
    assert tools(["check", "--hbcheck", dumps["pump"]]) == 0
    out = capsys.readouterr().out
    for section in ("graph-lint", "abi", "model", "doc-drift", "tidy", "hbcheck"):
        assert section in out
    assert "check: 6 section(s), 0 error(s)" in out


def test_check_comms_equals_the_reference(tmp_path, capsys):
    """``check-comms`` over one Chrome trace of MPI_* spans: the same
    table, failures and exit codes as the reference's, for met, missed
    and malformed expectations."""
    evs = []
    for i, (name, nbytes) in enumerate([("MPI_ACTIVATE", 20)] * 4
                                       + [("MPI_DATA_PLD", 4096)] * 3
                                       + [("MPI_DATA_CTL", 0)]):
        for ph, ts in (("B", 10.0 * i), ("E", 10.0 * i + 5)):
            evs.append({"name": name, "ph": ph, "ts": ts, "pid": 0, "tid": "c",
                        "args": {"bytes": nbytes}})
    p = tmp_path / "comm.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    cases = [["--expect", "MPI_ACTIVATE:nb=4", "--expect", "MPI_DATA_PLD:lensum=12288"],
             ["--expect", "MPI_ACTIVATE:nb=5"],
             ["--expect", "MPI_ACTIVATE:count=4"],
             ["--expect", "MPI_DATA_PLD:lensum=x"]]
    for extra in cases:
        rc = tools(["check-comms", str(p), *extra])
        mine = capsys.readouterr()
        ref_rc = ref_tools(["check-comms", str(p), *extra])
        theirs = capsys.readouterr()
        assert (rc, mine.out, mine.err) == (ref_rc, theirs.out, theirs.err)
    assert [tools(["check-comms", str(p), *c]) for c in cases] == [0, 1, 2, 2]


@pytest.mark.parametrize("cmd", ["flightdump", "serve-status", "top"])
def test_live_plane_commands_wait_for_part_2(cmd, capsys):
    """Ported since A.9b's second half: against an endpoint nobody serves
    each command reports it and exits 1 (tests/test_torch_health.py drives
    them against a live one)."""
    argv = [cmd, "http://127.0.0.1:1"] + (["--once"] if cmd == "top" else [])
    assert tools(argv) == 1
    captured = capsys.readouterr()
    assert "127.0.0.1:1" in captured.out + captured.err


@pytest.mark.parametrize("name", ["HealthServer", "Watchdog", "FlightRecorder"])
def test_live_plane_names_wait_for_part_2(name):
    import parsec_tpu_torch.profiling as prof
    from parsec_tpu_torch.profiling import flight, health

    assert getattr(prof, name) is getattr(flight if name == "FlightRecorder" else health, name)
    assert name in prof.__all__


def test_commands_are_registered():
    for cmd in ("info", "to-csv", "check-comms", "merge", "critpath", "hbcheck", "check",
                "lint", "engine-verify", "cache", "autotune", "flightdump", "serve-status",
                "top"):
        with pytest.raises(SystemExit) as ei:
            tools([cmd, "--help"])
        assert ei.value.code == 0


# ---------------------------------------------------------------------------
# the reference's Chrome-JSON tool cases
# ---------------------------------------------------------------------------

def _chain_pool(n=10):
    dc = LocalCollection("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = PTG("chain")
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", INOUT,
              "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")
    step.body(cpu=lambda X, k: X.__iadd__(1.0))
    return ptg.taskpool(N=n, D=dc)


@pytest.fixture
def json_trace(tmp_path):
    prof = TaskProfiler().install()
    try:
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
            tp = _chain_pool()
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
        path = tmp_path / "trace.json"
        prof.trace.dump(str(path))
    finally:
        prof.uninstall()
    return path


def test_info_and_to_csv_on_a_json_trace(json_trace, tmp_path, capsys):
    mine, ref = _both(capsys, ["info", str(json_trace)])
    assert mine == ref and mine[0] == 0
    assert "event class" in mine[1] and "exec" in mine[1]
    out_csv = str(tmp_path / "spans.csv")
    mine, ref = _both(capsys, ["to-csv", str(json_trace), "-o", out_csv], out=out_csv)
    assert mine == ref
    assert sum(1 for ln in mine[2].split("\n") if ln.startswith("exec,")) == 10


def test_spans_tolerate_missing_pid_tid(tmp_path, capsys):
    path = tmp_path / "bare.json"
    path.write_text(json.dumps([{"name": "op", "ph": "B", "ts": 1.0},
                                {"name": "op", "ph": "E", "ts": 5.0}]))
    mine, ref = _both(capsys, ["info", str(path)])
    assert mine == ref and mine[0] == 0 and "op" in mine[1]


def test_comm_overlap_fraction_equals_the_reference():
    from parsec_tpu.profiling.tools import comm_overlap_fraction as ref_frac
    from parsec_tpu.profiling.tools import per_rank_overlap as ref_per_rank
    from parsec_tpu_torch.profiling.tools import comm_overlap_fraction, per_rank_overlap

    rng = np.random.default_rng(5)
    evs = []
    for pid in range(2):
        for t in range(30):
            b = float(rng.uniform(0, 1000))
            evs += [{"name": "exec", "ph": "B", "ts": b, "pid": pid, "tid": t % 3,
                     "args": {"event_id": t}},
                    {"name": "exec", "ph": "E", "ts": b + float(rng.uniform(1, 40)),
                     "pid": pid, "tid": t % 3, "args": {"event_id": t}}]
        evs += [{"name": "comm_recv", "ph": "i", "ts": float(rng.uniform(0, 1000)),
                 "pid": pid} for _ in range(20)]
    evs.sort(key=lambda e: e["ts"])
    assert comm_overlap_fraction(evs) == ref_frac(evs)
    assert per_rank_overlap(evs) == ref_per_rank(evs)


# ---------------------------------------------------------------------------
# merge: the reference's single-rank cases
# ---------------------------------------------------------------------------

# The reference's two alignment cases are timing-dependent there (its
# tracer reads its epoch after the native t0, so a stall between the two
# moves a trace); the port reads the epoch around the native t0.  They
# run on the port's tracer, and both packages merge the dumps.

def test_epoch_alignment_orders_cross_trace_events(tmp_path):
    """Two tracers made 50 ms apart each log at ts ~ 0: after the
    epoch-aligned merge the later one's events land ~50 ms after."""
    b, m = binary, merge
    t0 = b.BinaryTrace(rank=0)
    k0 = t0.keyword("exec")
    t0.begin(k0, 1)
    t0.end(k0, 1)
    time.sleep(0.05)
    t1 = b.BinaryTrace(rank=1)
    k1 = t1.keyword("exec")
    t1.begin(k1, 2)
    t1.end(k1, 2)
    p0, p1 = str(tmp_path / "rank0.pbt"), str(tmp_path / "rank1.pbt")
    t0.dump(p0)
    t1.dump(p1)
    out = str(tmp_path / "merged.json")
    doc = m.merge_traces([p0, p1], out=out)
    assert doc["metadata"]["aligned"] is True and doc["metadata"]["ranks"] == [0, 1]
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    by_rank = {r: [e["ts"] for e in evs if e["pid"] == r] for r in (0, 1)}
    assert min(by_rank[1]) - max(by_rank[0]) > 50e3 - m.ALIGN_TOLERANCE_US
    with open(out) as f:
        assert len(json.load(f)["traceEvents"]) == len(doc["traceEvents"])
    # the reference merges these dumps to the same document
    assert ref_merge.merge_traces([p0, p1]) == m.merge_traces([p0, p1])
    t0.close()
    t1.close()


def test_clock_offset_shifts_timeline(tmp_path):
    b, m = binary, merge
    a, c = b.BinaryTrace(rank=0), b.BinaryTrace(rank=1)
    for t in (a, c):
        k = t.keyword("exec")
        t.begin(k, 1)
        t.end(k, 1)
    c.clock_offset_ns = 2_000_000_000  # rank 1's clock 2 s ahead
    pa, pc = str(tmp_path / "a.pbt"), str(tmp_path / "c.pbt")
    a.dump(pa)
    c.dump(pc)
    doc = m.merge_traces([pa, pc])
    assert doc == ref_merge.merge_traces([pa, pc])
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    t_a = min(e["ts"] for e in evs if e["pid"] == 0)
    t_c = min(e["ts"] for e in evs if e["pid"] == 1)
    assert t_a - t_c > 2e6 - m.ALIGN_TOLERANCE_US
    a.close()
    c.close()


def test_clock_sync_points_piecewise_correction_equals_the_reference(tmp_path):
    """A sidecar carrying clock-sync samples is corrected piecewise: both
    packages place every event at the same merged time."""
    t = binary.BinaryTrace(rank=3)
    k = t.keyword("exec")
    for i in range(4):
        t.begin(k, i)
        t.end(k, i)
    t.sidecar_extra = {"clock_sync": [[t.epoch_ns, 1000], [t.epoch_ns + 10**6, 5000]]}
    p = str(tmp_path / "rank3.pbt")
    t.dump(p)
    t.close()
    assert merge.merge_traces([p]) == ref_merge.merge_traces([p])
    pts = [(0, 0), (10, 100)]
    for x in (-5, 0, 3, 10, 25):
        assert merge._offset_at(pts, x) == ref_merge._offset_at(pts, x)


def test_clock_handshake_at_one_rank_and_beyond():
    """At one rank both packages return 0 with no engine traffic; over a
    3-rank in-process fabric every rank's offset to rank 0 is within half
    its best round trip (+ the merge tolerance) of 0 — the ranks share
    one clock — and ``last_handshake`` keeps the sample that won."""
    from parsec_tpu import comm as ref_comm
    from parsec_tpu_torch import comm

    class One:
        nranks, rank = 1, 0

    assert merge.clock_handshake(One()) == ref_merge.clock_handshake(One()) == 0
    for mod, fab in ((merge, comm.InprocFabric), (ref_merge, ref_comm.InprocFabric)):
        ces = fab(3).endpoints()
        offs = [None] * 3
        ts = [threading.Thread(target=lambda r=r: offs.__setitem__(
            r, mod.clock_handshake(ces[r], pings=4))) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert offs[0] == 0 and all(isinstance(o, int) for o in offs)
        if mod is merge:
            for r in (1, 2):
                shake = merge.last_handshake(r)
                assert shake["offset_ns"] == offs[r] and shake["pings"] == 4
                assert 0 < shake["rtt_ns"] < 10e9
                assert abs(offs[r]) <= shake["rtt_ns"] / 2 + merge.ALIGN_TOLERANCE_US * 1e3
                assert merge.sync_points_for(r)[-1][1] == offs[r]
            assert merge.last_handshake(0) is None


def test_standalone_pool_tasks_are_job_tagged(tmp_path):
    """No serving plane: a bare taskpool still tags its spans with its
    name-derived trace id (merge annotates, no phase row), and critpath
    slices on it."""
    ts = binary.RankTraceSet(nranks=1).install()
    try:
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
            dc = LocalCollection("saD", shape=(1,), init=lambda k: np.zeros(1))
            ptg = PTG("standalone_jt")
            st = ptg.task_class("sa_step", k="0 .. N-1")
            st.affinity("D(0)")
            st.flow("X", INOUT, "<- (k == 0) ? D(0) : X sa_step(k-1)",
                    "-> (k < N-1) ? X sa_step(k+1) : D(0)")
            st.body(cpu=lambda X, k: X.__iadd__(1.0))
            tp = ptg.taskpool(N=4, D=dc)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
    finally:
        ts.uninstall()
    paths = ts.dump(str(tmp_path))
    ts.close()
    hexid = jobtrace.hex_id(tp.trace_id)
    doc = merge.merge_traces(paths)
    assert doc == ref_merge.merge_traces(paths)
    evs = doc["traceEvents"]
    assert [e for e in evs if e.get("name") == "exec" and e["args"].get("trace_id") == hexid]
    assert hexid in doc["metadata"]["jobs"]
    rep = critpath.analyze(evs, job=hexid)
    assert rep["n_tasks"] == 4
    assert rep["phases"]["queue_us"] is None and rep["phases"]["run_us"] > 0


def test_record_sync_points_feed_the_sidecar(tmp_path):
    merge.reset_sync_points()
    try:
        merge.record_sync_point(0, 5, 7)
        merge.record_sync_point(0, 1, 3)
        assert merge.sync_points_for(0) == [(1, 3), (5, 7)]
        t = binary.BinaryTrace(rank=0)
        p = str(tmp_path / "r.pbt")
        t.instant(t.keyword("x"))
        t.dump(p)
        t.close()
        assert binary.read_pbt_meta(p)["clock_sync"] == [[1, 3], [5, 7]]
        merge.reset_sync_points_for(0)
        assert merge.sync_points_for(0) == []
    finally:
        merge.reset_sync_points()


def test_concurrent_ranks_dump_their_own_streams(tmp_path):
    """Two traces logging from one thread each: each dump holds only its
    own thread's stream, named after it."""
    a, b = binary.BinaryTrace(rank=0), binary.BinaryTrace(rank=1)

    def log(t, name):
        k = t.keyword("exec")
        for i in range(50):
            t.begin(k, i)
            t.end(k, i)

    ths = [threading.Thread(target=log, args=(t, n), name=n)
           for t, n in ((a, "ra"), (b, "rb"))]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    pa, pb = str(tmp_path / "a.pbt"), str(tmp_path / "b.pbt")
    assert a.dump(pa) == b.dump(pb) == 100
    assert {e["tid"] for e in binary.read_pbt(pa)} == {"ra"}
    assert {e["tid"] for e in binary.read_pbt(pb)} == {"rb"}
    a.close()
    b.close()
