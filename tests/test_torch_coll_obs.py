"""Collective observability of the port (parsec_tpu_torch.comm.coll with
the profiling planes) against the JAX package's, case for case with
``tests/profiling/test_coll_observability.py``:

* per-collective spans in the binary traces (kind ``coll``, paired across
  ranks by the deterministic cid token, one ``coll_seg`` instant per
  landed segment) — the port's token and segment indices equal the
  reference's (both derive them from the same cid by blake2b);
* the ``coll`` block of ``context_status``, the ``parsec_coll_*``
  Prometheus series and the ``PARSEC::COLL::*`` SDE gauges, the same
  numbers on both packages;
* the watchdog's OBS007 wedged-collective finding naming the op kind,
  cid and step position, with the reference's text;
* the ``jobcoll`` spans of a ``CollectiveTask`` (the collective leg of
  ``tests/profiling/test_jobtrace.py``): the body's collective carries its
  pool's trace id on every rank, as the reference's does.
"""

import re
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.comm.inproc import InprocFabric as RefFabric  # noqa: E402
from parsec_tpu.profiling import binary as ref_binary  # noqa: E402
from parsec_tpu.profiling import health as ref_health  # noqa: E402
from parsec_tpu.profiling import merge as ref_merge  # noqa: E402
from parsec_tpu.profiling import sde as ref_sde  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch.comm.inproc import InprocFabric  # noqa: E402
from parsec_tpu_torch.profiling import binary, health, merge, sde  # noqa: E402
from parsec_tpu_torch.utils import mca_param  # noqa: E402

REF = dict(name="ref", Fabric=RefFabric, binary=ref_binary, health=ref_health,
           merge=ref_merge, sde=ref_sde, mca=ref_mca, Context=parsec_tpu.Context,
           ctx_kw={})
PORT = dict(name="port", Fabric=InprocFabric, binary=binary, health=health,
            merge=merge, sde=sde, mca=mca_param, Context=parsec_tpu_torch.Context,
            ctx_kw={"devices": ["cpu"]})
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def _native_or_skip():
    from parsec_tpu import native

    if not native.available():
        pytest.skip(f"the JAX package's native core is unavailable: "
                    f"{native.build_error()}")


def _run_all(engines, fn, ranks=None):
    ranks = list(ranks if ranks is not None else range(len(engines)))
    out, errs = {}, []

    def worker(r):
        try:
            out[r] = fn(r, engines[r])
        except Exception as e:
            errs.append((r, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in ranks]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert all(not t.is_alive() for t in ts), "collective wedged"
    if errs:
        raise errs[0][1]
    return out


def _traced_allreduce(P, tmp_path):
    nranks = 2
    P["mca"].set_param("runtime", "coll_segment", 64)
    traces = P["binary"].RankTraceSet(nranks).install()
    try:
        fab = P["Fabric"](nranks)
        engines = fab.endpoints()
        for e in engines:
            _ = e.coll
        payload = np.arange(128, dtype=np.float64)  # 1 KiB: 16 segments

        def go(r, ce):
            h = ce.coll_allreduce(payload * (r + 1))
            assert h.wait(timeout=30)

        _run_all(engines, go)
        paths = traces.dump(str(tmp_path))
    finally:
        traces.uninstall()
        traces.close()
        P["mca"].params.unset("runtime", "coll_segment")
    assert len(paths) == nranks
    evs = P["merge"].merge_traces(paths)["traceEvents"]
    spans = [e for e in evs if e["name"] == "coll"]
    tokens = {e["args"]["event_id"] for e in spans}
    assert len(tokens) == 1, tokens  # same cid token on every rank
    for rank in range(nranks):
        mine = [e for e in spans if e["pid"] == rank]
        assert [e["ph"] for e in sorted(mine, key=lambda e: e["ts"])] \
            == ["B", "E"], (rank, mine)
        b = next(e for e in mine if e["ph"] == "B")
        assert b["args"]["info"] == payload.nbytes
    segs = [e for e in evs if e["name"] == "coll_seg"]
    assert segs, "no coll_seg instants recorded"
    assert all(e["args"]["event_id"] in tokens for e in segs)
    # the chunk train really was segmented: distinct indices, both ranks
    idx = {}
    for rank in range(nranks):
        idx[rank] = sorted(e["args"]["info"] for e in segs if e["pid"] == rank)
        assert len(set(idx[rank])) > 1, (rank, idx[rank])
    landed = [int(ce.coll.stats["seg_done"]) for ce in engines]
    assert [len(idx[r]) for r in range(nranks)] == landed
    return tokens, idx


def test_coll_spans_and_segments_in_binary_trace(tmp_path):
    """A 2-rank allreduce under the rank tracer: every rank's trace
    carries ONE ``coll`` begin/end span whose event_id is the SAME
    deterministic token on both ranks, with the payload bytes in
    ``info``, plus one ``coll_seg`` instant per landed segment carrying
    its index — the same token and the same indices as the reference's."""
    _native_or_skip()
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = _traced_allreduce(REF, tmp_path / "ref")
    port = _traced_allreduce(PORT, tmp_path / "port")
    assert port == ref


def _metrics(P):
    nranks = 2
    fab = P["Fabric"](nranks)
    engines = fab.endpoints()
    ctxs = [P["Context"](nb_cores=1, rank=r, nranks=nranks, comm=engines[r],
                         **P["ctx_kw"]) for r in range(nranks)]
    unregister = P["health"].register_context_gauges(ctxs[0])
    try:
        # before any collective: nothing ran, gauges 0
        st0 = P["health"].context_status(ctxs[0])["coll"]
        assert st0 is None or st0["ops_started"] == 0
        assert P["sde"].read(P["sde"].COLL_OPS_DONE) == 0.0

        def go(r, ce):
            h = ce.coll_allreduce(np.arange(256.0) * (r + 1))
            assert h.wait(timeout=30)

        _run_all(engines, go)

        doc = P["health"].context_status(ctxs[0])
        assert doc["coll"]["ops_done"] == 1
        assert doc["coll"]["segments_inflight"] == 0
        assert doc["coll"]["bytes"] > 0
        text = P["health"].prometheus_text(ctxs[0])
        assert "parsec_coll_ops_started_total" in text
        assert 'parsec_coll_ops_done_total{rank="0"} 1' in text
        assert "parsec_coll_segments_total" in text
        assert 'parsec_coll_segments_inflight{rank="0"} 0' in text
        gauges = {name: P["sde"].read(getattr(P["sde"], name)) for name in
                  ("COLL_OPS_STARTED", "COLL_OPS_DONE", "COLL_BYTES",
                   "COLL_SEGMENTS_INFLIGHT")}
        assert gauges["COLL_OPS_DONE"] == 1.0 and gauges["COLL_BYTES"] > 0
        assert gauges["COLL_SEGMENTS_INFLIGHT"] == 0.0
        lines = sorted(ln for ln in text.splitlines() if ln.startswith("parsec_coll_"))
        return doc["coll"], lines, gauges
    finally:
        unregister()
        for c in ctxs:
            c.fini()


def test_coll_metrics_prometheus_and_sde_gauges():
    """After one collective, the health plane reports it: the ``coll``
    block in context_status, the ``parsec_coll_*`` series in the
    Prometheus text and the live PARSEC::COLL::* SDE gauges — the same
    block, series lines and gauge values as the reference's."""
    assert _metrics(PORT) == _metrics(REF)


def _wedged(P):
    nranks = 2
    fab = P["Fabric"](nranks)
    engines = fab.endpoints()
    ctxs = [P["Context"](nb_cores=1, rank=r, nranks=nranks, comm=engines[r],
                         **P["ctx_kw"]) for r in range(nranks)]
    try:
        # rank 0 starts an allreduce; rank 1 NEVER joins -> wedged at
        # ring step 0 (rank 0's advert parks at rank 1's endpoint)
        h = engines[0].coll.allreduce(np.arange(64.0), cid=("wedge",))
        assert not h.wait(timeout=0.2)

        wd = P["health"].Watchdog(ctxs[0], window=3600.0, poll=3600.0)
        try:
            rep = wd.diagnose()
        finally:
            wd.stop()
        codes = {f.code for f in rep.findings}
        assert "OBS007" in codes, codes
        msg = next(f for f in rep.findings if f.code == "OBS007").message
        assert "allreduce[ring]" in msg and "wedge" in msg, msg
        assert "step 0/" in msg, msg

        # unwedge: rank 1 joins late; the parked advert replays at bind
        def join():
            hj = engines[1].coll.allreduce(np.arange(64.0) * 2,
                                           cid=("wedge",))
            assert hj.wait(timeout=30)

        t = threading.Thread(target=join)
        t.start()
        assert h.wait(timeout=30)
        t.join(timeout=30)
        assert not t.is_alive()
        np.testing.assert_array_equal(h.result(), np.arange(64.0) * 3)
        # post-completion: nothing in flight, a fresh diagnosis is clean
        assert engines[0].coll.ops_in_flight() == []
        wd2 = P["health"].Watchdog(ctxs[0], window=3600.0, poll=3600.0)
        try:
            assert "OBS007" not in {f.code for f in wd2.diagnose().findings}
        finally:
            wd2.stop()
        return msg
    finally:
        for c in ctxs:
            c.fini()


def test_wedged_collective_diagnosed_obs007():
    """A collective whose peer never joins shows up in a stall diagnosis:
    OBS007 naming the op kind, cid and step position (the watchdog reads
    CollManager.ops_in_flight), in the reference's words."""
    port, ref = _wedged(PORT), _wedged(REF)
    assert re.sub(r"\d+", "#", port) == re.sub(r"\d+", "#", ref), (port, ref)
    assert port.startswith("rank 0: collective in flight at stall: "
                           "allreduce[ring] cid=('wedge',) step 0/2 recvd")


def _jobcoll(P, tmp_path):
    """A traced 2-rank DTD pool with a CollectiveTask allreduce: the
    collective runs inside a body, so it inherits the pool's trace id and
    each rank's trace carries it as a ``jobcoll`` span."""
    import importlib

    pkg = "parsec_tpu" if P is REF else "parsec_tpu_torch"
    dtd = importlib.import_module(f"{pkg}.dsl.dtd")
    LocalCollection = importlib.import_module(f"{pkg}.data").LocalCollection
    CollectiveTask = importlib.import_module(f"{pkg}.dsl").CollectiveTask
    jobtrace = importlib.import_module(f"{pkg}.profiling.jobtrace")
    nranks = 2
    traces = P["binary"].RankTraceSet(nranks).install()
    try:
        engines = P["Fabric"](nranks).endpoints()
        ctxs = [P["Context"](nb_cores=2, rank=r, nranks=nranks, comm=engines[r],
                             **P["ctx_kw"]) for r in range(nranks)]
        try:
            def go(r, ce):
                dc = LocalCollection("C", shape=(8,), nodes=nranks, myrank=r,
                                     init=lambda k: np.arange(8.0) + k)
                dc.rank_of = lambda *key: key[0] % nranks
                tp = dtd.DTDTaskpool(ctxs[r], name="ctask_job")
                CollectiveTask.allreduce(tp, {k: dc.data_of(k) for k in range(nranks)})
                assert tp.wait(timeout=60)
                return np.array(dc.data_of(r).newest_copy().payload)

            out = _run_all(engines, go)
        finally:
            for c in ctxs:
                c.fini()
        paths = traces.dump(str(tmp_path))
    finally:
        traces.uninstall()
        traces.close()
    for r in range(nranks):
        np.testing.assert_array_equal(out[r], 2 * np.arange(8.0) + 1)
    evs = P["merge"].merge_traces(paths)["traceEvents"]
    hexid = jobtrace.hex_id(jobtrace.trace_id_of("ctask_job"))
    coll = [e for e in evs if e.get("name") == "jobcoll"]
    assert {e.get("pid") for e in coll} == {0, 1}, coll
    assert all(e["args"]["trace_id"] == hexid for e in coll)
    return sorted((e["pid"], e["ph"]) for e in coll), hexid


def test_collective_task_carries_its_job_trace_id(tmp_path):
    """``jobcoll`` spans (tests/profiling/test_jobtrace.py's collective
    leg): a collective issued from a body inherits the running pool's
    trace id on every rank, as the reference's does."""
    _native_or_skip()
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    assert _jobcoll(PORT, tmp_path / "port") == _jobcoll(REF, tmp_path / "ref")
