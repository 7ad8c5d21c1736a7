"""The port's reshape engine (parsec_tpu_torch.data.reshape and the PTG's
dep property blocks) against the JAX package's, case for case with
``tests/collections/test_reshape.py``: the datacopy future, the lazy
cached promise and its fast path, a consumer dep's ``[dtype=…]`` and
``[type=NAME]`` at one rank and on a remote read across two ranks, the
promise's invalidation on a new source version, and an unknown type name
left as a wire tag.  Every converted payload is compared with the
reference's, bit for bit.

The port's own cases: a bfloat16 target (``torch.bfloat16``, the name
``bfloat16``, or a ``[type=NAME]`` constant holding it) converts a host
tile into a bfloat16 torch tensor and casts a torch tensor with a torch op
where it lives, into a tensor of its own (never an alias of the source).
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLC  # noqa: E402
from parsec_tpu.data import reshape as ref_reshape  # noqa: E402
from parsec_tpu.data.data import data_create as ref_data_create  # noqa: E402
from parsec_tpu.dsl import ptg as ref_ptg  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.data import reshape  # noqa: E402
from parsec_tpu_torch.data.data import data_create  # noqa: E402
from parsec_tpu_torch.dsl import ptg as port_ptg  # noqa: E402

from test_torch_multirank import PORT as MR_PORT  # noqa: E402
from test_torch_multirank import REF as MR_REF  # noqa: E402
from test_torch_multirank import run_ranks  # noqa: E402

REF = dict(name="ref", rs=ref_reshape, data_create=ref_data_create, LC=RefLC,
           ptg=ref_ptg, Context=parsec_tpu.Context, ctx_kw={}, mr=MR_REF)
PORT = dict(name="port", rs=reshape, data_create=data_create, LC=LocalCollection,
            ptg=port_ptg, Context=parsec_tpu_torch.Context,
            ctx_kw={"devices": ["cpu"]}, mr=MR_PORT)
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _clear_cache():
    for P in (REF, PORT):
        P["rs"].reshape_cache_clear()
    yield
    for P in (REF, PORT):
        P["rs"].reshape_cache_clear()


def _ctx(P):
    return P["Context"](nb_cores=2, **P["ctx_kw"])


@BOTH
def test_future_lazy_trigger_once(P):
    calls = []

    def trig():
        calls.append(1)
        d = P["data_create"]("x", payload=np.ones(3))
        return d.get_copy(0)

    f = P["rs"].DataCopyFuture(trig)
    assert not f.is_ready()
    got = []
    f.on_ready(lambda c: got.append(c))
    c1 = f.get()
    c2 = f.get()
    assert c1 is c2 and calls == [1] and got == [c1]


@BOTH
def test_future_threads_race_single_resolution(P):
    ev = threading.Event()

    def trig():
        ev.wait(1)
        d = P["data_create"]("y", payload=np.zeros(2))
        return d.get_copy(0)

    f = P["rs"].DataCopyFuture(trig)
    results = []
    ts = [threading.Thread(target=lambda: results.append(f.get(5))) for _ in range(4)]
    for t in ts:
        t.start()
    ev.set()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert len(results) == 4 and len(set(map(id, results))) == 1


@BOTH
def test_reshape_fast_path_no_conversion(P):
    d = P["data_create"]("a", payload=np.ones((4, 4), np.float32))
    spec = P["rs"].ReshapeSpec(dtype=np.float32, shape=(4, 4))
    assert P["rs"].get_copy_reshape(d, spec) is d


def _lazy(P):
    rng = np.random.default_rng(4)
    d = P["data_create"]("b", payload=rng.standard_normal(8))
    spec = P["rs"].ReshapeSpec(dtype=np.float32, shape=(2, 4))
    r = P["rs"].get_copy_reshape(d, spec)
    assert r is not d
    assert r.newest_copy() is None  # not materialised yet
    P["rs"].materialize(r)
    out = r.newest_copy().payload
    assert out.dtype == np.float32 and out.shape == (2, 4)
    # shared promise: same spec → same reshaped Data
    assert P["rs"].get_copy_reshape(
        d, P["rs"].ReshapeSpec(dtype="float32", shape=(2, 4))) is r
    return out


def test_reshape_lazy_dtype_and_shape():
    port, ref = _lazy(PORT), _lazy(REF)
    assert isinstance(port, np.ndarray) and np.array_equal(port, ref)


def _ptg_input_dep(P):
    seen = {}
    dc = P["LC"]("D", shape=(4,), init=lambda k: np.arange(4, dtype=np.float64) / 3)

    ptg = P["ptg"].PTG("reshape")
    prod = ptg.task_class("prod")
    prod.flow("X", P["ptg"].INOUT, "<- D(0)", "-> X cons()")
    prod.body(cpu=lambda X: X.__iadd__(1.0))

    cons = ptg.task_class("cons")
    cons.flow("X", P["ptg"].IN, "<- X prod() [dtype=float32]")

    def cbody(X):
        seen["dtype"] = X.dtype
        seen["val"] = np.array(X)

    cons.body(cpu=cbody)
    tp = ptg.taskpool(D=dc)
    with _ctx(P) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    assert seen["dtype"] == np.float32
    np.testing.assert_allclose(seen["val"], np.arange(4) / 3 + 1.0, rtol=1e-6)
    # the home tile keeps the producer's dtype
    assert dc.data_of(0).newest_copy().payload.dtype == np.float64
    return seen["val"]


def test_ptg_input_dep_reshape():
    """A consumer's input dep carries [dtype=...]: it sees the converted
    tile while the producer's deposit keeps its own dtype (reference
    local_input_reshape.jdf)."""
    assert np.array_equal(_ptg_input_dep(PORT), _ptg_input_dep(REF))


def _ptg_type_prop(P, spec):
    seen = {}
    dc = P["LC"]("D", shape=(6,), init=lambda k: np.arange(6.0) * 0.5)

    ptg = P["ptg"].PTG("typed")
    a = ptg.task_class("a")
    a.flow("X", P["ptg"].INOUT, "<- D(0)", "-> X b()")
    a.body(cpu=lambda X: None)
    b = ptg.task_class("b")
    b.flow("X", P["ptg"].IN, "<- X a() [type=HALF]")
    b.body(cpu=lambda X: seen.update(dtype=X.dtype, shape=tuple(X.shape),
                                     val=X.clone() if isinstance(X, torch.Tensor)
                                     else np.array(X)))
    tp = ptg.taskpool(D=dc, HALF=spec)
    with _ctx(P) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    return seen


def test_ptg_type_prop_from_constants():
    """[type=NAME] resolves through taskpool constants (reference arena
    datatype registry)."""
    port = _ptg_type_prop(PORT, reshape.ReshapeSpec(dtype=np.float32, shape=(2, 3)))
    ref = _ptg_type_prop(REF, ref_reshape.ReshapeSpec(dtype=np.float32, shape=(2, 3)))
    assert port["dtype"] == ref["dtype"] == np.float32
    assert port["shape"] == ref["shape"] == (2, 3)
    assert np.array_equal(port["val"], ref["val"])


def test_ptg_bfloat16_type_prop_casts_host_tile():
    """A ``[type=NAME]`` constant holding ``torch.bfloat16``: the host
    tile arrives as a bfloat16 torch tensor, the value ``.to(bfloat16)``
    gives."""
    seen = _ptg_type_prop(PORT, torch.bfloat16)
    assert seen["dtype"] == torch.bfloat16 and seen["shape"] == (6,)
    assert torch.equal(seen["val"], torch.from_numpy(np.arange(6.0) * 0.5).to(torch.bfloat16))


@BOTH
def test_reshape_promise_invalidated_on_new_version(P):
    """A materialised promise must not serve a stale version after the
    source tile is rewritten (repo-entry-lifetime semantics)."""
    d = P["data_create"]("c", payload=np.arange(4, dtype=np.float64))
    spec = P["rs"].ReshapeSpec(dtype=np.float32)
    r1 = P["rs"].materialize(P["rs"].get_copy_reshape(d, spec))
    np.testing.assert_allclose(r1.newest_copy().payload, np.arange(4))
    # producer rewrites the tile (new version)
    c = d.get_copy(0)
    c.payload = np.arange(4, dtype=np.float64) + 100
    d.version_bump(0)
    r2 = P["rs"].materialize(P["rs"].get_copy_reshape(d, spec))
    np.testing.assert_allclose(r2.newest_copy().payload, np.arange(4) + 100)


@BOTH
def test_reshape_unknown_type_name_is_wire_tag(P):
    """[type=NAME] with no registered constant is a comm-layout tag, not a
    local reshape — from_props must ignore it."""
    assert P["rs"].ReshapeSpec.from_props({"type": "DEFAULT"}, {}) is None
    assert P["rs"].ReshapeSpec.from_props({"type": "bfloat16"}, {}) is None


def _remote_read(P):
    seen = {}
    lock = threading.Lock()
    homes = {}

    def build(rank, ctx):
        dc = P["LC"]("D", shape=(4,), nodes=2, myrank=rank,
                     init=lambda k: np.arange(4, dtype=np.float64) / 7)
        dc.rank_of = lambda *key: (key[0] if key else 0) % 2
        homes[rank] = dc

        ptg = P["ptg"].PTG("rreshape")
        prod = ptg.task_class("prod")
        prod.affinity("D(0)")  # rank 0
        prod.flow("X", P["ptg"].INOUT, "<- D(0)", "-> X cons()")
        prod.body(cpu=lambda X: X.__iadd__(1.0))

        cons = ptg.task_class("cons")
        cons.affinity("D(1)")  # rank 1
        cons.flow("X", P["ptg"].IN, "<- X prod() [dtype=float32]")

        def cbody(X):
            with lock:
                seen["dtype"] = X.dtype
                seen["val"] = np.array(X)

        cons.body(cpu=cbody)
        return ptg.taskpool(D=dc)

    run_ranks(P["mr"], 2, build)
    assert seen["dtype"] == np.float32
    np.testing.assert_allclose(seen["val"], np.arange(4) / 7 + 1.0, rtol=1e-6)
    # producer home tile untouched by the consumer-side conversion
    assert homes[0].data_of(0).newest_copy().payload.dtype == np.float64
    return seen["val"]


def test_remote_read_reshape_multirank():
    """Reshape on reception: the consumer rank receives the producer's
    payload over the comm engine and its dep [dtype=...] converts it at
    prepare_input — the reference remote_read_reshape.jdf case. The
    producer's home tile keeps its own dtype (no re-reshape upstream,
    remote_no_re_reshape.jdf)."""
    assert np.array_equal(_remote_read(PORT), _remote_read(REF))


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16"])
def test_bfloat16_spec_casts_tensors_where_they_live(dtype):
    """A torch tensor converts with a torch op on its own device into a
    tensor of its own; an ndarray into a bfloat16 torch CPU tensor; a
    matching payload takes the fast path."""
    spec = reshape.ReshapeSpec(dtype=dtype, shape=(2, 3))
    assert spec.dtype is torch.bfloat16
    src = torch.arange(6, dtype=torch.float32) / 3
    d = data_create("t", payload=src)
    r = reshape.materialize(reshape.get_copy_reshape(d, spec))
    out = r.newest_copy().payload
    assert isinstance(out, torch.Tensor) and out.device == src.device
    assert torch.equal(out, src.to(torch.bfloat16).reshape(2, 3))
    assert out.data_ptr() != src.data_ptr()
    host = reshape.ReshapeSpec(dtype=dtype).apply(np.arange(6.0) / 3)
    assert torch.equal(host, torch.from_numpy(np.arange(6.0) / 3).to(torch.bfloat16))
    same = reshape.ReshapeSpec(shape=(6,)).apply(src)
    assert torch.equal(same, src) and same.data_ptr() != src.data_ptr()
    assert reshape.get_copy_reshape(data_create("u", payload=out), spec).newest_copy().payload is out


def test_reshape_on_a_writable_flow_refused():
    """A reshape block on a writable flow would divert its writes into the
    converted copy: both packages refuse it when the task prepares."""
    for P in (REF, PORT):
        dc = P["LC"]("D", shape=(2,), init=lambda k: np.zeros(2))
        ptg = P["ptg"].PTG("rw")
        a = ptg.task_class("a")
        a.flow("X", P["ptg"].INOUT, "<- D(0)", "-> X b()")
        a.body(cpu=lambda X: None)
        b = ptg.task_class("b")
        b.flow("X", P["ptg"].INOUT, "<- X a() [dtype=float32]", "-> D(0)")
        b.body(cpu=lambda X: None)
        tp = ptg.taskpool(D=dc)
        with _ctx(P) as ctx:
            ctx.add_taskpool(tp)
            assert not tp.wait(timeout=30)
        assert "writable flow" in str(tp.fail_reason), (P["name"], tp.fail_reason)
