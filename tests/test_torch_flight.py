"""The port's flight recorder (``parsec_tpu_torch.profiling.flight``)
against the JAX package's: drop-oldest ring semantics, ``.fr.pbt``
snapshots in the ``PBTRACE1`` format that either package's ``read_pbt``
reads and the port's ``tools merge``/``critpath``/``hbcheck`` take
unmodified, the body-failure dump through ``PARSEC_TPU_FLIGHT=1``, the
``flightdump`` command over HTTP and in process, and the bounded ring.
Mirrors ``tests/profiling/test_flight.py``."""

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocal  # noqa: E402
from parsec_tpu.dsl.ptg import INOUT as REF_INOUT  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.profiling import binary as ref_binary  # noqa: E402
from parsec_tpu.profiling import flight as ref_flight  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl.ptg import INOUT, PTG  # noqa: E402
from parsec_tpu_torch.profiling import flight  # noqa: E402
from parsec_tpu_torch.profiling.binary import read_pbt, read_pbt_meta  # noqa: E402
from parsec_tpu_torch.profiling.flight import FlightRecorder, RingTrace  # noqa: E402
from parsec_tpu_torch.profiling.tools import main as tools_main  # noqa: E402


def _chain_tp(n, fail_at=None, ref=False):
    Local, P, io_ = (RefLocal, RefPTG, REF_INOUT) if ref else (LocalCollection, PTG, INOUT)
    dc = Local("D", shape=(1,), init=lambda k: np.zeros(1))
    ptg = P("frchain")
    step = ptg.task_class("step", k="0 .. N-1")
    step.affinity("D(0)")
    step.flow("X", io_, "<- (k == 0) ? D(0) : X step(k-1)",
              "-> (k < N-1) ? X step(k+1) : D(0)")

    def body(X, k):
        if fail_at is not None and k == fail_at:
            raise RuntimeError("synthetic body failure")
        X += 1.0

    step.body(cpu=body)
    return ptg.taskpool(N=n, D=dc), dc


def _ctx():
    return parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")


def _tools(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tools_main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("capacity,n", [(100, 250), (64, 64), (10, 5)])
def test_ringtrace_drop_oldest(tmp_path, capacity, n):
    tr = RingTrace(rank=0, capacity=capacity)
    k = tr.keyword("ev")
    for i in range(n):
        tr.instant(k, i)
    path = str(tmp_path / "ring.fr.pbt")
    kept = min(capacity, n)
    assert tr.dump(path) == kept
    evs = read_pbt(path)
    assert [e["args"]["event_id"] for e in evs] == list(range(n - kept, n))
    meta = read_pbt_meta(path)
    assert meta["flight_recorder"] is True
    assert meta["events_dropped"] == n - kept
    assert meta["ring_capacity"] == capacity
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)


def test_ring_dumps_read_alike_in_both_packages(tmp_path):
    """The two rings write one format: each package's reader reads each
    package's dump to the same events, and the sidecars carry the same
    keys."""
    dumps = {}
    for name, mod in (("port", flight), ("ref", ref_flight)):
        tr = mod.RingTrace(rank=0, capacity=8)
        ka, kb = tr.keyword("a"), tr.keyword("b")
        for i in range(12):
            tr.begin(ka, i, 7)
            tr.end(ka, i, 7)
            tr.instant(kb, i, i * 3)
        tr.counter(kb, 99)
        dumps[name] = str(tmp_path / f"{name}.fr.pbt")
        tr.dump(dumps[name])

    def strip(evs):
        return [(e["name"], e["ph"], e["args"].get("event_id"), e["args"].get("info"))
                for e in evs]

    for path in dumps.values():
        assert strip(read_pbt(path)) == strip(ref_binary.read_pbt(path))
    assert strip(read_pbt(dumps["port"])) == strip(read_pbt(dumps["ref"]))
    assert set(read_pbt_meta(dumps["port"])) == set(ref_binary.read_pbt_meta(dumps["ref"]))


def test_flight_dump_roundtrips_through_tools(tmp_path):
    fr = FlightRecorder(nranks=1).install()
    ctx = _ctx()
    try:
        tp, _ = _chain_tp(10)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    finally:
        ctx.fini()
        fr.uninstall()
    paths = fr.dump(str(tmp_path))
    assert paths == [str(tmp_path / "rank0.fr.pbt")]
    merged = str(tmp_path / "merged.json")
    rc, _ = _tools(["merge", paths[0], "-o", merged])
    assert rc == 0
    names = {e.get("name") for e in json.load(open(merged))["traceEvents"]}
    assert "exec" in names and "dep_edge" in names
    rc, out = _tools(["critpath", merged])
    assert rc == 0 and "step" in out
    rc, out = _tools(["hbcheck", paths[0]])
    assert rc == 0 and "0 race(s)" in out


def test_flight_dump_event_vocabulary_matches_the_reference(tmp_path):
    """The same chain under each package's recorder records the same
    event kinds (the lean set: no select or prepare_input spans)."""
    names = {}
    for name in ("port", "ref"):
        if name == "port":
            fr = FlightRecorder(nranks=1).install()
            ctx = _ctx()
        else:
            fr = ref_flight.FlightRecorder(nranks=1).install()
            ctx = parsec_tpu.Context(nb_cores=2)
        try:
            tp, _ = _chain_tp(8, ref=name == "ref")
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
        finally:
            ctx.fini()
            fr.uninstall()
        path = fr.dump(str(tmp_path / name))[0]
        names[name] = {e["name"] for e in read_pbt(path)}
    assert "select" not in names["port"] and "prepare_input" not in names["port"]
    for must in ("exec", "dep_edge", "class:step", "job_map"):
        assert must in names["port"] and must in names["ref"], must


def test_body_failure_dumps_flight_snapshot(tmp_path, monkeypatch):
    monkeypatch.setenv("PARSEC_TPU_FLIGHT", "1")
    monkeypatch.setenv("PARSEC_TPU_FLIGHT_DIR", str(tmp_path))
    flight._last_incident_dump[0] = float("-inf")  # no earlier incident's debounce
    ctx = _ctx()
    assert ctx.flight is not None and flight.installed()
    try:
        tp, _ = _chain_tp(6, fail_at=3)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30) is False
    finally:
        ctx.fini()
    assert ctx.flight is None
    snap = tmp_path / "rank0.fr.pbt"
    assert snap.exists(), "a body failure must dump the flight recorder"
    evs = read_pbt(str(snap))
    assert any(e["name"] == "exec" for e in evs)
    assert any(e["name"] == "class:step" for e in evs)


def test_incident_dumps_are_debounced_and_explicit_ones_are_not(tmp_path):
    fr = FlightRecorder(nranks=1, capacity=16).install()
    try:
        flight._last_incident_dump[0] = float("-inf")
        assert flight.dump_all(str(tmp_path / "a"), reason="x", debounce=30.0)
        # a second incident of the cascade within the window is dropped
        assert flight.dump_all(str(tmp_path / "b"), reason="y", debounce=30.0) == []
        # an explicit request always snapshots
        assert flight.dump_all(str(tmp_path / "c"))
    finally:
        fr.uninstall()
    assert flight.dump_all(str(tmp_path / "d")) == []  # nothing installed


def test_flightdump_cli_http_and_inprocess(tmp_path):
    from parsec_tpu_torch.profiling.health import HealthServer

    fr = FlightRecorder(nranks=1).install()
    ctx = _ctx()
    hs = HealthServer(ctx).start()
    try:
        assert hs.host == "127.0.0.1" and hs.port > 0
        tp, _ = _chain_tp(5)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
        out_http = tmp_path / "http"
        rc, out = _tools(["flightdump", hs.url, "-o", str(out_http)])
        assert rc == 0
        assert (out_http / "rank0.fr.pbt").exists() and "rank0.fr.pbt" in out
        out_local = tmp_path / "local"
        rc, _ = _tools(["flightdump", str(out_local)])
        assert rc == 0 and (out_local / "rank0.fr.pbt").exists()
    finally:
        hs.stop()
        ctx.fini()
        fr.uninstall()
    err = io.StringIO()
    with redirect_stdout(io.StringIO()), redirect_stderr(err):
        rc = tools_main(["flightdump", str(tmp_path / "none")])
    assert rc == 1 and "no flight recorder" in err.getvalue()


def test_ring_capacity_param_and_always_on_cost_shape():
    fr = FlightRecorder(nranks=1, capacity=64).install()
    ctx = _ctx()
    try:
        tp, _ = _chain_tp(50)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
        tr = fr.set.traces[0]
        assert tr.total_events <= 64 * len(tr._rings)
        assert tr._logged > tr.total_events
    finally:
        ctx.fini()
        fr.uninstall()
    assert fr.set._subs == []


def test_dump_carries_the_serving_state_and_tenant_tags(tmp_path):
    """A recorder owned by a serving context snapshots the service's
    tenants and jobs into the sidecar, and the ring holds the tasks'
    ``tenant:`` instants and the job lifecycle's ``job_phase`` ones."""
    from parsec_tpu_torch.serve import RuntimeService

    sv = RuntimeService(nb_cores=2, cuda_device="cpu")
    fr = FlightRecorder(nranks=1, context=sv.context).install()
    try:
        h = sv.submit("gold", _chain_tp(4)[0])
        assert h.wait(timeout=30)
        path = fr.dump(str(tmp_path))[0]
    finally:
        fr.uninstall()
        sv.close(timeout=30)
    meta = read_pbt_meta(path)
    assert meta["serve"]["tenants"]["gold"]["completed"] == 1
    assert meta["serve"]["jobs"]["done"] == 1
    names = [e["name"] for e in read_pbt(path)]
    assert "tenant:gold" in names and "job_phase" in names
