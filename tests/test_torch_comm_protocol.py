"""The port's wire protocol (parsec_tpu_torch.comm: payload, engine,
inproc, remote_dep) against the JAX package's.

The in-process cases of ``tests/runtime/test_comm_protocol.py``, each run
on both packages with the same seeded inputs: the eager threshold
boundary, the zero-get eager round trip (pin-verified), rendezvous chunks
reassembled out of order, cross-thread chunk completions, a failed chunk,
raw framing and the protocol-parameter checks.  Both packages take the
same regime decisions and keep the same counters, compared key for key.

The port's own cases: a bfloat16 torch CPU tile and an F-order tile
through the rendezvous path (numpy has no bfloat16: the header names the
torch dtype and the bits travel raw), torch-tensor framing, the
in-process wire's copies (a receiver's in-place write never reaches the
sender's tile), and the names of the collectives, the TCP backend and
the launcher.  The TCP cases are ``tests/test_torch_tcp.py``'s.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.comm import engine as ref_engine  # noqa: E402
from parsec_tpu.comm import inproc as ref_inproc  # noqa: E402
from parsec_tpu.comm import payload as ref_payload  # noqa: E402
from parsec_tpu.comm import remote_dep as ref_rd  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch import comm as port_comm  # noqa: E402
from parsec_tpu_torch.comm import engine as port_engine  # noqa: E402
from parsec_tpu_torch.comm import inproc as port_inproc  # noqa: E402
from parsec_tpu_torch.comm import payload as port_payload  # noqa: E402
from parsec_tpu_torch.comm import remote_dep as port_rd  # noqa: E402
from parsec_tpu_torch.profiling import pins as port_pins  # noqa: E402
from parsec_tpu_torch.utils import mca_param as port_mca  # noqa: E402

REF = dict(engine=ref_engine, inproc=ref_inproc, payload=ref_payload,
           rd=ref_rd, pins=ref_pins, mca=ref_mca)
PORT = dict(engine=port_engine, inproc=port_inproc, payload=port_payload,
            rd=port_rd, pins=port_pins, mca=port_mca)
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def _wait(pred, timeout=20):
    deadline = time.time() + timeout
    while not pred():
        time.sleep(0.005)
        assert time.time() < deadline, "timed out"


class _params:
    """Set runtime MCA params on one package for a block."""

    def __init__(self, P, **kw):
        self.mca, self.kw = P["mca"], kw

    def __enter__(self):
        for k, v in self.kw.items():
            self.mca.set_param("runtime", k, v)

    def __exit__(self, *exc):
        for k in self.kw:
            self.mca.params.unset("runtime", k)


class _SinkPool:
    """Minimal taskpool surface for protocol-level tests."""

    def __init__(self, name="pp"):
        self.name = name
        self.got = []
        self.context = None

    def incoming_activation(self, **kw):
        self.got.append(kw)

    def incoming_writeback(self, *a, **kw):
        pass

    def _force_fail(self):
        return True


def _rd_pair(P):
    fabric = P["inproc"].InprocFabric(2)
    ces = fabric.endpoints()
    rds = [P["rd"].RemoteDepManager(ce) for ce in ces]
    pools = [_SinkPool(), _SinkPool()]
    rds[0].new_taskpool(pools[0])
    rds[1].new_taskpool(pools[1])
    return ces, rds, pools


def _counters(rd):
    return {k: int(v) for k, v in rd.stats.items()}


# ---------------------------------------------------------------------------
# eager threshold, zero-get fast path
# ---------------------------------------------------------------------------

def _boundary_run(P):
    ces, rds, pools = _rd_pair(P)
    limit = rds[0].eager_limit
    regimes = []
    for nbytes in (limit - 1, limit, limit + 1):
        e0 = int(rds[0].stats["eager_sent"])
        payload = np.arange(nbytes, dtype=np.uint8)
        rds[0].send_activations(pools[0], "cls", (nbytes,), {1: 1},
                                {0: payload})
        ces[1].progress_nonblocking()
        _wait(lambda: pools[1].got)
        kw = pools[1].got.pop()
        np.testing.assert_array_equal(np.asarray(kw["flow_data"][0]), payload)
        regimes.append("eager" if rds[0].stats["eager_sent"] == e0 + 1
                       else "rdv")
    # use-counted rendezvous registrations fully self-reclaimed
    assert not ces[0].fabric.mem
    return limit, regimes, _counters(rds[0]), _counters(rds[1])


def test_eager_threshold_boundary_matches_reference():
    """limit-1 and limit bytes ride eager; limit+1 goes rendezvous — on
    both packages, with every counter equal."""
    ref, port = _boundary_run(REF), _boundary_run(PORT)
    assert port[1] == ["eager", "eager", "rdv"]
    assert port == ref


@BOTH
def test_subthreshold_zero_get_roundtrip_pinned(P):
    """A sub-threshold payload makes no pull round trip: zero DATA_CTL
    events, zero pull counters, one DATA_PLD tagged proto=eager."""
    pins = P["pins"]
    seen = {"ctl": [], "pld": []}
    ctl_cb = lambda es, info: seen["ctl"].append(info)  # noqa: E731
    pld_cb = lambda es, info: seen["pld"].append(info)  # noqa: E731
    pins.subscribe(pins.COMM_DATA_CTL, ctl_cb)
    pins.subscribe(pins.COMM_DATA_PLD, pld_cb)
    try:
        ces, rds, pools = _rd_pair(P)
        payload = np.arange(512, dtype=np.float64)  # 4 KiB < 8 KiB limit
        rds[0].send_activations(pools[0], "cls", (7,), {1: 1}, {0: payload})
        ces[1].progress_nonblocking()
        _wait(lambda: pools[1].got)
        np.testing.assert_array_equal(pools[1].got[0]["flow_data"][0],
                                      payload)
        assert seen["ctl"] == []
        assert [p["proto"] for p in seen["pld"]] == ["eager"]
        assert rds[1].stats["rdv_pulls"] == 0
        assert rds[0].stats["get_advertised"] == 0
        assert ces[0].stats["get_bytes"] == 0
    finally:
        pins.unsubscribe(pins.COMM_DATA_CTL, ctl_cb)
        pins.unsubscribe(pins.COMM_DATA_PLD, pld_cb)


# ---------------------------------------------------------------------------
# rendezvous chunking
# ---------------------------------------------------------------------------

def _shuffled_engine(P, src):
    class _ShuffledEngine(P["engine"].CommEngine):
        """Defers chunk answers and releases them in reverse order;
        records the in-flight high-water mark."""

        rank, nranks = 1, 2
        device_payloads = False

        def __init__(self):
            self._init_protocol()
            self.src = P["payload"].as_bytes(src)
            self.pending = []
            self.inflight_max = 0

        def register_am(self, tag, cb):
            pass

        def get_part(self, src_rank, handle, offset, length, on_done,
                     fin=False, priority=0):
            self.pending.append((on_done, offset, length))
            self.inflight_max = max(self.inflight_max, len(self.pending))

        def release_all_reversed(self):
            while self.pending:
                batch, self.pending = self.pending[::-1], []
                for on_done, off, ln in batch:
                    on_done(self.src[off:off + ln].copy())

    return _ShuffledEngine()


def _pull(P, tile, ce):
    mgr = P["rd"].RemoteDepManager(ce)
    out = []
    P["rd"]._RdvPull(mgr, 0, {"handle": "h",
                              "hdr": P["payload"].wire_header(tile),
                              "nbytes": P["payload"].wire_header(tile)["nbytes"]},
                     out.append)
    return mgr, out


@BOTH
def test_rdv_chunks_reassemble_out_of_order(P):
    """Chunk answers landing in reverse order reassemble exactly, and the
    pull never exceeds comm_pipeline_depth requests in flight."""
    with _params(P, comm_rdv_chunk=1024, comm_pipeline_depth=3):
        tile = np.random.default_rng(5).standard_normal((40, 33))  # 10560 B
        ce = _shuffled_engine(P, tile)
        mgr, out = _pull(P, tile, ce)
        while ce.pending:
            ce.release_all_reversed()
        assert out and out[0] is not None
        np.testing.assert_array_equal(out[0], tile)
        assert ce.inflight_max <= 3
        assert mgr.stats["rdv_chunks_req"] == 11


def _threaded_engine(P, src):
    class _ThreadedEngine(P["engine"].CommEngine):
        """Answers every chunk from its own thread (the cross-thread shape
        that can lose a wakeup in the pump's re-entrancy flag)."""

        rank, nranks = 1, 2
        device_payloads = False

        def __init__(self):
            self._init_protocol()
            self.src = P["payload"].as_bytes(src)

        def register_am(self, tag, cb):
            pass

        def get_part(self, src_rank, handle, offset, length, on_done,
                     fin=False, priority=0):
            def answer():
                time.sleep(0.0005)
                on_done(self.src[offset:offset + length].copy())

            threading.Thread(target=answer, daemon=True).start()

    return _ThreadedEngine()


@BOTH
def test_rdv_cross_thread_completions_never_stall(P):
    with _params(P, comm_rdv_chunk=1024, comm_pipeline_depth=2):
        tile = np.random.default_rng(9).standard_normal(8192)  # 64 chunks
        ce = _threaded_engine(P, tile)
        done = threading.Event()
        out = []
        mgr = P["rd"].RemoteDepManager(ce)

        def cb(arr):
            out.append(arr)
            done.set()

        P["rd"]._RdvPull(mgr, 0, {"handle": "h",
                                  "hdr": P["payload"].wire_header(tile),
                                  "nbytes": tile.nbytes}, cb)
        assert done.wait(20), "rendezvous pull stalled (lost wakeup)"
        np.testing.assert_array_equal(out[0], tile)


@BOTH
def test_rdv_failed_chunk_reports_none_once(P):
    """A failed chunk resolves the transfer as None exactly once; the
    consumer releases its use of the registration with a zero-length fin
    read."""
    with _params(P, comm_rdv_chunk=16 << 10):
        tile = np.arange(4096, dtype=np.float64)  # 32 KiB -> 2 chunks
        ce = _shuffled_engine(P, tile)
        mgr, out = _pull(P, tile, ce)
        (cb0, *_), (cb1, *_) = ce.pending[0], ce.pending[1]
        cb0(None)
        cb1(None)  # straggler after the failure
        assert out == [None]
        assert any(ln == 0 for _cb, _off, ln in ce.pending)
        assert mgr.stats["rdv_pulls_failed"] == 1


@pytest.mark.parametrize("kind", ["bf16", "fortran", "bf16_fortran"])
def test_port_rdv_torch_and_fortran_tiles(kind):
    """The port's own rendezvous cases: a bfloat16 torch CPU tile (its
    header names the torch dtype, the bits travel raw) and an F-order
    tile (its layout is kept) reassemble bit for bit, out of order, with
    no pickle on the payload."""
    rng = np.random.default_rng(17)
    base = rng.standard_normal((48, 40)).astype(np.float32)
    if kind == "fortran":
        tile = np.asfortranarray(base)
    else:
        tile = torch.from_numpy(base).to(torch.bfloat16)
        if kind == "bf16_fortran":
            tile = tile.t().contiguous().t()
    hdr = port_payload.wire_header(tile)
    assert hdr["order"] == ("C" if kind == "bf16" else "F")
    with _params(PORT, comm_rdv_chunk=1000, comm_pipeline_depth=3):
        ce = _shuffled_engine(PORT, tile)
        mgr, out = _pull(PORT, tile, ce)
        while ce.pending:
            ce.release_all_reversed()
    got = out[0]
    if kind == "fortran":
        assert isinstance(got, np.ndarray) and got.flags.f_contiguous
        np.testing.assert_array_equal(got, tile)
    else:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert torch.equal(got, tile)
    assert mgr.stats["rdv_pulls_done"] == 1


def test_port_bf16_activation_through_rendezvous_on_the_fabric():
    """End to end over the in-process fabric: a bfloat16 flow above the
    eager limit is advertised, pulled in chunks and delivered as a torch
    CPU tensor equal bit for bit; the registration self-reclaims."""
    with _params(PORT, comm_eager_limit=64, comm_rdv_chunk=512):
        ces, rds, pools = _rd_pair(PORT)
        t = torch.arange(2000, dtype=torch.float32).to(torch.bfloat16)
        rds[0].send_activations(pools[0], "cls", (1,), {1: 1}, {0: t})
        ces[1].progress_nonblocking()
        _wait(lambda: pools[1].got)
        got = pools[1].got[0]["flow_data"][0]
        assert torch.equal(got, t)
        assert rds[0].stats["rdv_advertised"] == 1
        assert rds[1].stats["rdv_chunks_req"] == 8
        assert not ces[0].fabric.mem


# ---------------------------------------------------------------------------
# raw framing
# ---------------------------------------------------------------------------

@BOTH
def test_raw_framing_roundtrip_orders_and_fallback(P):
    pl = P["payload"]
    c = np.arange(12.0).reshape(3, 4)
    f = np.asfortranarray(c)
    z = np.empty((0, 5), dtype=np.float32)
    for arr in (c, f, z, np.float32(3.5) * np.ones(7)):
        assert pl.raw_framable(arr)
        back = pl.from_wire(pl.wire_header(arr), pl.as_bytes(arr).copy())
        np.testing.assert_array_equal(back, arr)
        assert back.dtype == arr.dtype and back.shape == arr.shape
    assert not pl.raw_framable(c[:, ::2])
    assert not pl.raw_framable(np.array([{"a": 1}], dtype=object))
    assert not pl.raw_framable([1, 2, 3])


def test_numpy_headers_equal_the_reference():
    """A numpy tile's header is the reference's, field for field."""
    for arr in (np.arange(12.0).reshape(3, 4),
                np.asfortranarray(np.ones((5, 3), np.float32)),
                np.empty((0, 5), dtype=np.int16)):
        assert port_payload.wire_header(arr) == ref_payload.wire_header(arr)
        assert (port_payload.as_bytes(arr).tobytes()
                == ref_payload.as_bytes(arr).tobytes())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.int64])
def test_port_torch_framing_roundtrip(dtype):
    """A torch CPU tensor frames by its torch dtype name (bfloat16 by its
    raw bits) in C and F order and rebuilds as a tensor over the landed
    bytes; a strided view is not framable; a zero-size tensor is."""
    t = (torch.arange(30, dtype=torch.float32) * 1.5).reshape(5, 6).to(dtype)
    for arr in (t, t.t().contiguous().t(), t[:0]):
        assert port_payload.raw_framable(arr)
        hdr = port_payload.wire_header(arr)
        assert hdr["dtype"] == str(dtype)
        back = port_payload.from_wire(hdr, port_payload.as_bytes(arr).copy())
        assert back.dtype == dtype and tuple(back.shape) == tuple(arr.shape)
        assert torch.equal(back, arr)
    assert not port_payload.raw_framable(t[:, ::2])
    assert port_payload.byte_slice(t, 0, 4).tobytes() == \
        port_payload.as_bytes(t)[:4].tobytes()


def test_port_to_wire_and_prefetch_on_cpu_tensors():
    """``to_wire`` gives a CPU tensor's wire form (numpy, or a torch CPU
    tensor for bfloat16); ``prefetch_to_host`` leaves host payloads
    alone.  Neither ever holds a CUDA tensor here."""
    a = torch.arange(6, dtype=torch.float32)
    b = a.to(torch.bfloat16)
    n = np.arange(3.0)
    port_payload.prefetch_to_host([a, b, n])
    assert isinstance(port_payload.to_wire(a), np.ndarray)
    assert isinstance(port_payload.to_wire(b), torch.Tensor)
    assert port_payload.to_wire(n) is n
    assert not any(port_payload.is_device_array(x) for x in (a, b, n))


# ---------------------------------------------------------------------------
# the in-process wire copies (ranks never alias each other's memory)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "torch", "bf16"])
def test_port_wire_never_aliases_the_sender(kind):
    """A receiver's in-place write to a delivered payload — a numpy array
    or a torch CPU tensor, eager or pulled — leaves the sender's tile
    unchanged."""
    for limit in (1 << 20, 0):  # eager, then everything through rendezvous
        with _params(PORT, comm_eager_limit=limit):
            ces, rds, pools = _rd_pair(PORT)
            if kind == "numpy":
                src = np.arange(64.0).reshape(8, 8)
            else:
                src = torch.arange(64.0).reshape(8, 8)
                if kind == "bf16":
                    src = src.to(torch.bfloat16)
            keep = src.copy() if kind == "numpy" else src.clone()
            rds[0].send_activations(pools[0], "cls", (1,), {1: 1}, {0: src})
            ces[1].progress_nonblocking()
            _wait(lambda: pools[1].got)
            got = pools[1].got[0]["flow_data"][0]
            # a float32 tensor pulled through rendezvous lands as its wire
            # form, an ndarray; bfloat16 stays a tensor
            if isinstance(got, np.ndarray):
                got[...] = -1
            else:
                got.fill_(-1)
            if kind == "numpy":
                np.testing.assert_array_equal(src, keep)
            else:
                assert torch.equal(src, keep)


@BOTH
def test_wire_copy_of_numpy_payloads(P):
    """The reference's hygiene rule on both packages: a numpy payload is
    copied at the wire."""
    a = np.arange(4.0)
    msg = P["inproc"]._wire_copy({"x": (a, [a])})
    assert msg["x"][0] is not a and msg["x"][1][0] is not a
    np.testing.assert_array_equal(msg["x"][0], a)


# ---------------------------------------------------------------------------
# MCA validation, the comm package's names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,bad", [
    ("comm_pipeline_depth", 0),
    ("comm_pipeline_depth", -2),
    ("comm_eager_limit", -1),
    ("comm_rdv_chunk", 0),
])
@BOTH
def test_protocol_params_validated_at_construction(P, name, bad):
    with _params(P, **{name: bad}):
        with pytest.raises(ValueError, match=name):
            P["inproc"].InprocFabric(2).endpoints()
    P["inproc"].InprocFabric(2).endpoints()  # healthy again after the unset


@pytest.mark.parametrize("name", ["CollManager", "CollOp", "RedistOp",
                                  "CollError", "TCPComm",
                                  "endpoint_from_env", "launch"])
def test_port_a8b_names_raise(name):
    """The names of ROADMAP A.8b — the collectives (part 1), the TCP
    backend and the launcher (part 2) — are the reference's, and none
    raises since part 2.  A one-rank endpoint's allreduce completes at
    once."""
    from parsec_tpu import comm as ref_comm
    from parsec_tpu.comm import launch as ref_launch

    ref = ref_launch.launch if name == "launch" else getattr(ref_comm, name)
    assert getattr(port_comm, name).__name__ == ref.__name__
    ce = port_comm.InprocFabric(1).endpoints()[0]
    h = ce.coll_allreduce(np.arange(3.0))
    assert h.done and h.wait(timeout=5)
    np.testing.assert_array_equal(h.result(), np.arange(3.0))


@BOTH
def test_inproc_pair_same_protocol_pins(P):
    """One two-rank graph with one sub- and one above-threshold flow: the
    same results and the same protocol-pin sequence on both packages
    (the in-process half of the reference's engine-parity case)."""
    pins = P["pins"]
    events = []

    def on(site):
        def cb(es, info):
            events.append((site, info.get("proto"), info.get("chunk"),
                           info.get("nchunks"), int(info.get("bytes", 0))))
        return cb

    cbs = {pins.COMM_DATA_PLD: on("pld"), pins.COMM_DATA_CTL: on("ctl")}
    for site, cb in cbs.items():
        pins.subscribe(site, cb)
    try:
        ces, rds, pools = _rd_pair(P)
        small = np.arange(256, dtype=np.float64)
        big = np.arange(64 << 7, dtype=np.float64)
        rds[0].send_activations(pools[0], "cls", (1,), {1: 0b11},
                                {0: small, 1: big})
        ces[1].progress_nonblocking()
        _wait(lambda: pools[1].got)
        kw = pools[1].got[0]
        np.testing.assert_array_equal(kw["flow_data"][0], small)
        np.testing.assert_array_equal(kw["flow_data"][1], big)
    finally:
        for site, cb in cbs.items():
            pins.unsubscribe(site, cb)
    key = lambda e: tuple(str(x) for x in e)  # noqa: E731
    pld = sorted((e for e in events if e[0] == "pld"), key=key)
    assert pld == sorted([("pld", "eager", None, None, 2048),
                          ("pld", "rdv", 0, 1, 64 << 10)], key=key)
