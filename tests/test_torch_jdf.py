"""The port's JDF front-end (parsec_tpu_torch.dsl.jdf, jdfc) against the
JAX package's.

Every case of the reference's ``tests/dsl/test_jdf.py`` and
``tests/dsl/test_jdf_reference_cases.py`` compiles the same JDF text in
both packages and runs it from the same seeded numpy inputs; the tiles
and counters they leave must be ``np.array_equal``.  Cases the port
refuses (multi-rank) are replaced by the refusal; the template-device
case runs on both packages' template modules.

Beyond those: the dynamic cases of ``test_jdf_cholesky.py`` and
``test_jdf_lu.py``; the port's own ``examples/jdf/cholesky.jdf`` (its
``[type=CUDA]`` bodies on the CUDA module bound to the torch CPU device,
B1 f32 and bf16) held to the reference's ``cholesky_ptg(use_pallas=True)``
in Pallas interpret mode and ``torch.equal`` to the port's
``cholesky_ptg`` on the dynamic path, the pump and a ``GraphExecutor``
replay; the captured DAG of a JDF equal node for node in both packages;
and ``JDF.verify`` and ``jdfc --lint/--strict`` giving the JAX package's
findings.
"""

import collections
import importlib.util
import os
import sys
import threading
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.core.recursive import recursive_invoke as ref_recursive_invoke  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.data import data_create as ref_data_create  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.dsl import graph as ref_graph  # noqa: E402
from parsec_tpu.dsl import jdf as ref_jdf  # noqa: E402
from parsec_tpu.dsl import jdfc as ref_jdfc  # noqa: E402
from parsec_tpu.dsl import ptg as ref_ptg  # noqa: E402
from parsec_tpu.dsl.dtd import DTDTaskpool as RefDTD, stage_to_cpu as ref_stage  # noqa: E402
from parsec_tpu.dsl.ptg_to_dtd import replay_via_dtd as ref_replay  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu_torch import DEV_CUDA, mca_param  # noqa: E402
from parsec_tpu_torch.core.recursive import recursive_invoke  # noqa: E402
from parsec_tpu_torch.data import LocalCollection, data_create  # noqa: E402
from parsec_tpu_torch.datadist import TwoDimBlockCyclic, from_numpy_tiles  # noqa: E402
from parsec_tpu_torch.dsl import GraphExecutor, graph, jdf, jdfc, ptg  # noqa: E402
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, stage_to_cpu  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import run_native  # noqa: E402
from parsec_tpu_torch.dsl.ptg_to_dtd import replay_via_dtd  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg, kernels  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples", "jdf")
PORT_EXAMPLES = os.path.join(os.path.dirname(parsec_tpu_torch.__file__),
                             "examples", "jdf")

REF = types.SimpleNamespace(
    name="ref", jdf=ref_jdf, jdfc=ref_jdfc, ptg=ref_ptg, LC=RefLocalCollection,
    BC=RefBC, data_create=ref_data_create, DTD=RefDTD, stage=ref_stage,
    replay=ref_replay, recursive_invoke=ref_recursive_invoke,
    DEV="tpu", DEV_KEY=parsec_tpu.DEV_TPU,
    Context=lambda n: parsec_tpu.Context(nb_cores=n, devices=["cpu"]),
    DevContext=lambda n: parsec_tpu.Context(nb_cores=n))
PORT = types.SimpleNamespace(
    name="port", jdf=jdf, jdfc=jdfc, ptg=ptg, LC=LocalCollection,
    BC=TwoDimBlockCyclic, data_create=data_create, DTD=DTDTaskpool,
    stage=stage_to_cpu, replay=replay_via_dtd, recursive_invoke=recursive_invoke,
    DEV="CUDA", DEV_KEY=DEV_CUDA,
    Context=lambda n: parsec_tpu_torch.Context(nb_cores=n, devices=["cpu"]),
    DevContext=lambda n: parsec_tpu_torch.Context(nb_cores=n, cuda_device="cpu"))


def both(scenario, nb_cores=4, device=False):
    """``scenario(P, ctx)`` on the reference then on the port (each in a
    context of its own); returns both results."""
    out = []
    for P in (REF, PORT):
        ctx = (P.DevContext if device else P.Context)(nb_cores)
        try:
            out.append(scenario(P, ctx))
        finally:
            ctx.fini()
    return out


def assert_same(res):
    ref, port = res
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


def run(ctx, tp, timeout=60):
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=timeout)


def tiles_of(dc, keys):
    return [np.array(dc.data_of(k).newest_copy().payload) for k in keys]


class Counter:
    def __init__(self):
        self.v = 0
        self._l = threading.Lock()

    def inc(self):
        with self._l:
            self.v += 1


CHAIN = """
extern "C" %{
BUMP = 2.0
%}

mydata  [ type = "collection" ]
NB      [ type = int ]

Task(k)

k = 0 .. NB

: mydata( k )

RW  A <- (k == 0)  ? mydata( k ) : A Task( k-1 )
      -> (k == NB) ? mydata( k ) : A Task( k+1 )

BODY
{
    A += BUMP
}
END
"""


def _zeros1(_k):
    return np.zeros(1)


# ---------------------------------------------------------------------------
# tests/dsl/test_jdf.py
# ---------------------------------------------------------------------------

def test_chain_compile_and_run():
    """Ex04_ChainData shape: NB+1 chained increments of one datum."""
    def scenario(P, ctx):
        j = P.jdf.compile_jdf(CHAIN, "chain")
        dc = P.LC("mydata", shape=(1,), init=_zeros1)
        run(ctx, j.new(mydata=dc, NB=9))
        return tiles_of(dc, [0])

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(res[1][0], 20.0)


def test_chain_example_file():
    def scenario(P, ctx):
        j = P.jdf.compile_jdf_file(os.path.join(EXAMPLES, "chaindata.jdf"))
        dc = P.LC("mydata", shape=(1,), init=_zeros1)
        run(ctx, j.new(mydata=dc, NB=4))
        return tiles_of(dc, [0])

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(res[1][0], 5.0)


def test_required_globals():
    for P in (REF, PORT):
        j = P.jdf.compile_jdf(CHAIN, "chain")
        assert j.required_globals() == ["mydata", "NB"]
        with pytest.raises(TypeError, match="missing globals"):
            j.new(NB=3)


def test_definitions_interleaved_and_priority():
    """Derived locals between parameter ranges and a priority expression;
    definitions are visible in deps and the body."""
    src = """
D   [ type = "collection" ]
N   [ type = int ]

t(i, j)

i = 0 .. N-1
half = %{ i // 2 %}
j = 0 .. half
tag = i * 10 + j

: D( i )

RW X <- D( i )
     -> D( i )

; 100 - tag

BODY
{
    X[:] = tag
}
END
"""

    def scenario(P, ctx):
        j = P.jdf.compile_jdf(src, "defs")
        dc = P.LC("D", shape=(1,), init=_zeros1)
        tp = j.new(D=dc, N=5)
        tids = list(tp.ptg.classes["t"].param_space(tp.constants))
        assert tids == [(i, jj) for i in range(5) for jj in range(i // 2 + 1)]
        prios = [tp.ptg.classes["t"].priority_of(t, tp.constants) for t in tids]
        run(ctx, tp)
        assert dc.data_of(4).newest_copy().payload[0] in {40.0, 41.0, 42.0}
        return [tids, prios]

    assert_same(both(scenario, nb_cores=2))


def test_prologue_helpers_and_inline_escapes():
    src = """
%{
def double(x):
    return 2 * x
BASE = 5
%}

D   [ type = "collection" ]
N   [ type = int default = %{ BASE - 2 %} ]

t(k)

k = 0 .. N-1
kk = %{ double(k) %}

: D( k )

RW X <- D( k )
     -> D( k )

BODY
{
    X[:] = kk
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("D", shape=(1,), init=_zeros1)
        run(ctx, P.jdf.compile_jdf(src, "helpers").new(D=dc))  # N = 3
        return tiles_of(dc, range(3))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), [0.0, 2.0, 4.0])


def test_ctl_gather_and_range_broadcast():
    """Range output dep fans out; CTL flow gathers the fan back in."""
    src = """
D   [ type = "collection" ]
N   [ type = int ]

src()

: D( 0 )

RW X <- D( 0 )
     -> X work( 0 .. N-1 )

BODY
{
    X += 1.0
}
END

work(w)

w = 0 .. N-1

: D( 0 )

READ X <- X src()
CTL  c -> c sink()

BODY
{
    pass
}
END

sink()

: D( 0 )

CTL c <- c work( 0 .. N-1 )

BODY
{
    pass
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("D", shape=(2,), init=lambda k: np.zeros(2))
        tp = P.jdf.compile_jdf(src, "gather").new(D=dc, N=6)
        run(ctx, tp)
        return [tp.nb_retired]

    assert_same(both(scenario))


def test_c_operators_in_guards():
    """Reference JDF guards use C && / || / ! — accepted verbatim."""
    src = """
D   [ type = "collection" ]
N   [ type = int ]

t(k)

k = 0 .. N-1

: D( k )

RW X <- (k == 0 || !(k > 0)) ? D( k ) : D( k )
     -> (k >= 0 && k < N) ? D( k ) : NONE

BODY
{
    X += 1.0
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("D", shape=(1,), init=_zeros1)
        run(ctx, P.jdf.compile_jdf(src, "cops").new(D=dc, N=3))
        return tiles_of(dc, range(3))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), 1.0)


def test_dep_properties_preserved():
    """`[ type_remote = LR ]` property blocks parse and land on the dep."""
    for P in (REF, PORT):
        j = P.jdf.compile_jdf_file(os.path.join(EXAMPLES, "stencil_1d.jdf"))
        al = next(f for f in j.ptg.classes["step"].flows if f.name == "AL")
        assert al.deps_in[0].props.get("type_remote") == "LR"


def test_stencil_example_runs():
    """The stencil JDF runs to completion, equal in both packages and to a
    numpy replay of the update rule (CPU body)."""
    NT, ITER, W = 4, 3, 8
    init = {n: np.arange(W, dtype=float) + 10.0 * n for n in range(NT)}

    def scenario(P, ctx):
        j = P.jdf.compile_jdf_file(os.path.join(EXAMPLES, "stencil_1d.jdf"))
        dc = P.LC("descA", shape=(W,), init=lambda k: init[k[1]].copy()
                  if k[0] == 0 else np.zeros(W))
        run(ctx, j.new(descA=dc, NT=NT, ITER=ITER))
        return tiles_of(dc, [(ITER % 2, n) for n in range(NT)])

    res = both(scenario)
    assert_same(res)
    prev = [init[n].copy() for n in range(NT)]
    for t in range(1, ITER + 1):
        cur = []
        for n in range(NT):
            acc, cnt = prev[n] * 0.5, 2.0
            if t > 1 and n > 0:
                acc, cnt = acc + prev[n - 1][-1] * 0.25, cnt + 1.0
            if t > 1 and n < NT - 1:
                acc, cnt = acc + prev[n + 1][0] * 0.25, cnt + 1.0
            cur.append(acc * (4.0 / cnt))
        prev = cur
    for n in range(NT):
        np.testing.assert_allclose(res[1][n], prev[n], rtol=1e-6)


DEVICE_SRC = """
D   [ type = "collection" ]

t(k)

k = 0 .. 2

: D( k )

RW X <- D( k )
     -> D( k )

BODY [ type = {dev} ]
{{
    return X * 2.0 + k
}}
END
"""


def test_device_body():
    """A functional device BODY — ``[type=tpu]`` jax in the reference,
    ``[type=CUDA]`` torch in the port, the same text — run by the device
    module, returning the new value of the writable flow."""
    def scenario(P, ctx):
        j = P.jdf.compile_jdf(DEVICE_SRC.format(dev=P.DEV), "dev")
        dc = P.LC("D", shape=(4,), init=lambda k: np.full(4, 1.0 + k))
        run(ctx, j.new(D=dc))
        if P is PORT:
            assert ctx.devices[1].stats["executed_tasks"] == 3
        return [np.asarray(P.stage(dc.data_of(k))) for k in range(3)]

    res = both(scenario, nb_cores=2, device=True)
    assert_same(res)
    for k in range(3):
        np.testing.assert_array_equal(res[1][k], (1.0 + k) * 2 + k)


def test_multirank_chain_refused():
    """The chain JDF distributed over 2 ranks (the reference's
    ``test_multirank_chain``; refused until ROADMAP A.8a): affinity
    mydata(k) alternates ranks, activations ride the comm engine, and the
    final value lands home on both packages alike."""
    from test_torch_multirank import PORT as MR_PORT, REF as MR_REF, run_ranks

    NB = 7
    out = {}
    for name, P, comp, LC in (("ref", MR_REF, ref_jdf.compile_jdf,
                               RefLocalCollection),
                              ("port", MR_PORT, jdf.compile_jdf,
                               LocalCollection)):
        finals = {}

        def build(rank, ctx, comp=comp, LC=LC, finals=finals):
            dc = LC("mydata", shape=(1,), nodes=2, myrank=rank,
                    init=lambda k: np.zeros(1))
            dc.rank_of = lambda *key: (key[0] if key else 0) % 2
            finals[rank] = dc
            return comp(CHAIN, "chain").new(mydata=dc, NB=NB)

        run_ranks(P, 2, build)
        out[name] = np.asarray(
            finals[NB % 2].data_of(NB).newest_copy().payload)
    np.testing.assert_allclose(out["port"], (NB + 1) * 2.0)
    np.testing.assert_array_equal(out["port"], out["ref"])


def test_python_operators_survive_comment_stripping():
    """`//` is a C comment in structural text but floor division inside
    BODY blocks and %{ %} escapes."""
    src = """
D   [ type = "collection" ]

t(k)   /* block comment
          spanning lines */

k = 0 .. 3          // trailing comment
half = %{ k // 2 %} // escape keeps floor division

: D( k )

RW X <- D( k )
     -> D( k )

BODY
{
    # Python comment with // and && inside the body
    q = k // 2
    assert q == half, "bang! && bars || survive in strings"
    X[:] = q
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("D", shape=(1,), init=_zeros1)
        run(ctx, P.jdf.compile_jdf(src, "ops").new(D=dc))
        return tiles_of(dc, range(4))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), [0, 0, 1, 1])


HP_SRC = """
D [ type = "collection" ]

t(k) [ high_priority = on ]

k = 0 .. 1

: D( k )

RW X <- D( k )
     -> D( k )

BODY
{
    pass
}
END
"""


def test_high_priority_property():
    for P in (REF, PORT):
        pc = P.jdf.compile_jdf(HP_SRC, "hp").ptg.classes["t"]
        assert pc.properties.get("high_priority") == "on"
        assert pc.priority_of((0,), {}) == 1 << 20


def test_ptg_to_dtd_replay_with_definitions():
    """The DTD replay harness passes derived definitions to bodies too."""
    src = """
D [ type = "collection" ]
N [ type = int ]

t(k)

k = 0 .. N-1
kk = k * 2

: D( k )

RW X <- D( k )
     -> D( k )

BODY
{
    X[:] = kk
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("D", shape=(1,), init=_zeros1)
        P.replay(P.jdf.compile_jdf(src, "replay").new(D=dc, N=4), ctx)
        return tiles_of(dc, range(4))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), [0.0, 2.0, 4.0, 6.0])


def test_single_line_prologue_and_chained_defaults():
    src = """
%{ BASE = 3 %}

D [ type = "collection" ]
M [ type = int default = %{ BASE + 1 %} ]
N [ type = int default = %{ M * 2 %} ]

t(k)

k = 0 .. N-1

: D( k )

RW X <- D( k )
     -> D( k )

BODY
{
    X[:] = 1.0
}
END
"""

    def scenario(P, ctx):
        j = P.jdf.compile_jdf(src, "defaults")
        assert j.ptg.constants["M"] == 4 and j.ptg.constants["N"] == 8
        dc = P.LC("D", shape=(1,), init=_zeros1)
        run(ctx, j.new(D=dc))
        return tiles_of(dc, range(8))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), 1.0)


@pytest.mark.parametrize("case", ["missing_range", "missing_body",
                                  "heading_order", "duplicate_body"])
def test_syntax_errors_match_reference(case):
    """The reference's four error cases: the same exception type and the
    same message from both parsers."""
    src, exc, match = {
        "missing_range": ("t(k)\n: D(0)\nBODY\npass\nEND\n", "syntax",
                          "have no range"),
        "missing_body": ("t(k)\nk = 0 .. 3\n: D(k)\nRW X <- D(k)\n", "syntax",
                         None),
        "heading_order": ("t(a, b)\nb = 0 .. 1\na = 0 .. 1\n: D(a)\nBODY\n"
                          "pass\nEND\n", "syntax", "heading order"),
        "duplicate_body": ("t(k)\nk = 0 .. 1\n: D(k)\nBODY\npass\nEND\nBODY\n"
                           "pass\nEND\n", "value", "duplicate BODY"),
    }[case]
    msgs = []
    for P in (REF, PORT):
        cls = P.jdf.JDFSyntaxError if exc == "syntax" else ValueError
        with pytest.raises(cls, match=match) as ei:
            P.jdf.compile_jdf(src, "bad")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _import_generated(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def test_jdfc_codegen_roundtrip(tmp_path):
    """generate() emits a runnable module whose taskpool computes what the
    runtime-compiled JDF computes, in both packages."""
    def scenario(P, ctx):
        out = tmp_path / f"chain_{P.name}_ptg.py"
        out.write_text(P.jdfc.generate(CHAIN, "chain", source="chain.jdf"))
        mod = _import_generated(str(out), f"chain_ptg_{P.name}")
        dc = P.LC("mydata", shape=(1,), init=_zeros1)
        run(ctx, mod.new(mydata=dc, NB=9))
        with pytest.raises(TypeError, match="missing globals"):
            mod.new(NB=1)
        return tiles_of(dc, [0])

    res = both(scenario)
    assert_same(res)
    assert "parsec_tpu_torch.dsl.ptg" in (tmp_path / "chain_port_ptg.py").read_text()
    assert "import parsec_tpu." not in (tmp_path / "chain_port_ptg.py").read_text()


def test_jdfc_cli(tmp_path, capsys):
    jdf_path = tmp_path / "chain.jdf"
    jdf_path.write_text(CHAIN)
    for P in (REF, PORT):
        out_path = tmp_path / f"gen_{P.name}.py"
        assert P.jdfc.main([str(jdf_path), "-o", str(out_path)]) == 0
        assert "def new(" in out_path.read_text()
        assert P.jdfc.main(["--check", str(jdf_path)]) == 0
        assert "OK" in capsys.readouterr().out


def test_jdfc_preserves_properties_and_priority(tmp_path):
    src = """
%{ BASE = 2 %}
D [ type = "collection" ]
M [ type = int default = %{ BASE + 2 %} ]
N [ type = int default = M ]

t(k) [ high_priority = on ]

k = 0 .. N-1

: D( k )

RW X <- D( k )
     -> D( k )

BODY
{
    pass
}
END
"""
    for P in (REF, PORT):
        out = tmp_path / f"hp_{P.name}_ptg.py"
        out.write_text(P.jdfc.generate(src, "hp", source="hp.jdf"))
        built = _import_generated(str(out), f"hp_ptg_{P.name}").build()
        pc = built.classes["t"]
        assert pc.properties.get("high_priority") == "on"
        assert pc.priority_of((0,), {}) == 1 << 20
        assert built.constants["M"] == 4 and built.constants["N"] == 4


def _plus_one_dev(x):
    return x + 1.0


def _times_three(x):
    return x * 3.0


def test_host_writeback_after_device_write():
    """The reference's ``test_template_device_writeback_after_tpu``: a tile
    the accelerator module wrote (its newest copy on the device), then a
    template-device body: the template must read the device's version
    and publish its own on host copy 0.  Both packages attach their
    template module by name beside their accelerator module."""
    def scenario(P, ctx):
        d = P.data_create("x", payload=np.full(4, 1.0))
        tp = P.DTD(ctx)
        tp.insert_task({P.DEV_KEY: _plus_one_dev}, (d, P.jdf.INOUT))
        tp.insert_task({"template": _times_three}, (d, P.jdf.INOUT))
        assert tp.wait(timeout=60)
        tdev = next(x for x in ctx.devices if x.mca_name == "template")
        return [np.asarray(P.stage(d)), tdev.stats["executed_tasks"],
                d.newest_copy().device_index]

    res = []
    for P, ctx in ((REF, parsec_tpu.Context(nb_cores=2, devices=["tpu", "template"])),
                   (PORT, parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu",
                                                   devices=["cuda", "template"]))):
        try:
            res.append(scenario(P, ctx))
        finally:
            ctx.fini()
    assert_same(res)
    np.testing.assert_array_equal(res[1][0], 6.0)
    assert res[1][1:] == [1, 0]


def test_jdfc_stencil_roundtrip(tmp_path):
    with open(os.path.join(EXAMPLES, "stencil_1d.jdf")) as f:
        text = f.read()

    def scenario(P, ctx):
        out = tmp_path / f"stencil_{P.name}_ptg.py"
        out.write_text(P.jdfc.generate(text, "stencil_1d", source="stencil_1d.jdf"))
        mod = _import_generated(str(out), f"stencil_ptg_{P.name}")
        dc = P.LC("descA", shape=(4,), init=lambda k: np.full(4, float(k[1])))
        run(ctx, mod.new(descA=dc, NT=2, ITER=2))
        return tiles_of(dc, [(0, 0), (0, 1)])

    assert_same(both(scenario, nb_cores=2))


# ---------------------------------------------------------------------------
# tests/dsl/test_jdf_reference_cases.py
# ---------------------------------------------------------------------------

def test_branching():
    """branching.jdf: TA(k) fans out to TB(2k),TB(2k+1); TB routes to TC's
    T1 or T2 flow by parity; counts must be NT/2NT/NT."""
    src = """
A  [ type = "collection" ]
NT [ type = int ]

TA(k)

zero = 0
nt = NT
k = zero .. nt-1

: A( k )

RW T <- A( k )
     -> T TB( 2*k .. 2*k+1 )

BODY
{
    nbA.inc()
}
END

TB(k)

k = 0 .. 2*NT-1
kh = %{ k // 2 %}

: A( k % NT )

RW T <- T TA( kh )
     -> (k % 2 == 0) ? T1 TC( kh ) : T2 TC( kh )

BODY
{
    nbB.inc()
}
END

TC(k)

k = 0 .. NT-1

: A( k )

RW   T1 <- T TB( 2*k )
        -> A( k )
READ T2 <- T TB( 2*k+1 )

BODY
{
    nbC.inc()
}
END
"""

    def scenario(P, ctx):
        c = [Counter(), Counter(), Counter()]
        j = P.jdf.compile_jdf(src, "branching", namespace=dict(zip(("nbA", "nbB", "nbC"), c)))
        run(ctx, j.new(A=P.LC("A", shape=(1,), init=_zeros1), NT=6))
        return [x.v for x in c]

    res = both(scenario)
    assert_same(res)
    assert res[1] == [6, 12, 6]


CHOICE = """
A        [ type = "collection" ]
NT       [ type = int ]

Choice(k)

k = 0 .. NT

: A( k )

RW D <- (k == 0) ? A( k )
     <- (k > 0 && decision[k-1] == 1) ? D TA( k-1 )
     <- (k > 0 && decision[k-1] == 2) ? D TB( k-1 )
     -> (k < NT && decision[k] == 1) ? D TA( k )
     -> (k < NT && decision[k] == 2) ? D TB( k )
     -> (k == NT) ? A( k )

BODY
{
    if k < NT:
        decision[k] = choose(k)
        this_task.taskpool.addto_nb_tasks(-1)
    D += 1.0
}
END

TA(k)

k = 0 .. NT-1

: A( k )

RW D <- D Choice( k )
     -> D Choice( k+1 )

BODY
{
    took["A"].inc()
}
END

TB(k)

k = 0 .. NT-1

: A( k )

RW D <- D Choice( k )
     -> D Choice( k+1 )

BODY
{
    took["B"].inc()
}
END
"""


def test_choice_dynamic_guards():
    """choice.jdf: each Choice(k) picks TA or TB at RUN time by writing
    decision[k]; the guards read that array at release time."""
    NT = 9
    rng = np.random.default_rng(7)
    choices = [int(rng.integers(1, 3)) for _ in range(NT)]

    def scenario(P, ctx):
        took = {"A": Counter(), "B": Counter()}
        j = P.jdf.compile_jdf(CHOICE, "choice", namespace={
            "decision": np.zeros(NT + 1, dtype=int), "took": took,
            "choose": lambda k: choices[k]})
        dc = P.LC("A", shape=(1,), init=_zeros1)
        run(ctx, j.new(A=dc, NT=NT))
        return [took["A"].v, took["B"].v] + tiles_of(dc, [NT])

    res = both(scenario)
    assert_same(res)
    assert res[1][:2] == [choices.count(1), choices.count(2)]
    np.testing.assert_array_equal(res[1][2], NT + 1)


def test_local_indices():
    src = """
A  [ type = "collection" ]
NT [ type = int ]

t(k)

zero = 0
last = NT - 1
k = zero .. last

: A( k )

RW X <- A( k )
     -> A( k )

BODY
{
    X[:] = k + last
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("A", shape=(1,), init=_zeros1)
        run(ctx, P.jdf.compile_jdf(src, "locidx").new(A=dc, NT=5))
        return tiles_of(dc, range(5))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), np.arange(5) + 4)


def test_globals_visible_in_bodies():
    src = """
A  [ type = "collection" ]
NT [ type = int ]
SCALE [ type = float default = 2.5 ]

t(k)

k = 0 .. NT-1

: A( k )

RW X <- A( k )
     -> A( k )

BODY
{
    X[:] = k * SCALE + NT
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("A", shape=(1,), init=_zeros1)
        run(ctx, P.jdf.compile_jdf(src, "glob").new(A=dc, NT=4))
        return tiles_of(dc, range(4))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), np.arange(4) * 2.5 + 4)


def test_global_shadowed_by_flow_and_local():
    src = """
A  [ type = "collection" ]
X  [ type = int default = 7 ]
m  [ type = int default = 9 ]
NT [ type = int ]

t(k)

k = 0 .. NT-1
m = k + 1

: A( k )

RW X <- A( k )
     -> A( k )

BODY
{
    X[:] = m * 10.0
}
END
"""

    def scenario(P, ctx):
        dc = P.LC("A", shape=(1,), init=_zeros1)
        run(ctx, P.jdf.compile_jdf(src, "shadow").new(A=dc, NT=3))
        return tiles_of(dc, range(3))

    res = both(scenario)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), [10.0, 20.0, 30.0])


def test_use_globals_collision_rejected():
    for P in (REF, PORT):
        p = P.ptg.PTG("clash")
        t = p.task_class("t", k="0 .. 1")
        t.flow("X", P.ptg.INOUT, "<- D(k)", "-> D(k)")
        t.use_globals("X")
        t.body(cpu=lambda X, k: None)
        with pytest.raises(ValueError, match="collide"):
            p.taskpool(D=P.LC("D", shape=(1,), init=_zeros1), X=5)


def test_multisize_bcast():
    src = """
A  [ type = "collection" ]
NS [ type = int ]
NL [ type = int ]

src()

: A( 0 )

RW X <- A( 0 )
     -> X small( 0 .. NS-1 )
     -> X large( 0 .. NL-1 )

BODY
{
    X += 1.0
}
END

small(i)

i = 0 .. NS-1

: A( 0 )

READ X <- X src()

BODY
{
    seen.inc()
}
END

large(i)

i = 0 .. NL-1

: A( 0 )

READ X <- X src()

BODY
{
    seen.inc()
}
END
"""

    def scenario(P, ctx):
        seen = Counter()
        j = P.jdf.compile_jdf(src, "msbcast", namespace={"seen": seen})
        run(ctx, j.new(A=P.LC("A", shape=(2,), init=lambda k: np.zeros(2)),
                       NS=3, NL=11))
        return [seen.v]

    res = both(scenario)
    assert_same(res)
    assert res[1] == [14]


def test_controlgather():
    src = """
A  [ type = "collection" ]
NT [ type = int ]
WS [ type = int default = 1 ]

TA(k)

k = 0 .. NT-1

: A( k % WS )

CTL X -> X TC(0)

BODY
{
    order.append(("TA", k))
}
END

TB(k)

k = 0 .. NT-1

: A( k % WS )

CTL X -> Y TC(0)

BODY
{
    order.append(("TB", k))
}
END

TC(k)

k = 0 .. 0

: A( 0 )

CTL X <- X TA(0 .. NT-1)
CTL Y <- X TB(0 .. NT-1)

BODY
{
    order.append(("TC", k))
}
END
"""

    def scenario(P, ctx):
        lock = threading.Lock()

        class SafeList(list):
            def append(self, x):
                with lock:
                    list.append(self, x)

        order = SafeList()
        j = P.jdf.compile_jdf(src, "ctlgat", namespace={"order": order})
        run(ctx, j.new(A=P.LC("A", shape=(1,), init=_zeros1), NT=5))
        kinds = [k for k, _ in order]
        assert kinds[-1] == "TC"
        return [kinds.count("TA"), kinds.count("TB"), kinds.count("TC")]

    res = both(scenario)
    assert_same(res)
    assert res[1] == [5, 5, 1]


def test_startup_stress_priorities():
    src = """
A   [ type = "collection" ]
NI  [ type = int ]
NJ  [ type = int ]
NK  [ type = int ]
pri [ type = int default = 0 hidden = on ]

STARTUP(i, j, k)

  i = 0 .. NI-1
  j = 0 .. NJ-1
  k = 0 .. NK-1

  valid1 = i == 1 and j == 1
  valid2 = (i == 1) and (j == 1)
  prio = %{ rnd(i, j, k) if pri == 2 else (NJ*NK*i + NK*j + k)*pri %}

: A( i )

READ X <- A( i )
       -> A( i )

; prio

BODY
{
    assert valid1 == valid2
    seen.inc()
}
END
"""
    import random

    def scenario(P, ctx):
        counts = []
        for pri in (-1, 0, 1, 2):
            seen = Counter()
            rng = random.Random(pri)
            j = P.jdf.compile_jdf(src, f"startup{pri}", namespace={
                "seen": seen, "rnd": lambda i, j, k: rng.randint(0, 1 << 20)})
            run(ctx, j.new(A=P.LC("A", shape=(1,), init=_zeros1),
                           NI=4, NJ=4, NK=4, pri=pri))
            counts.append(seen.v)
        return counts

    res = both(scenario)
    assert_same(res)
    assert res[1] == [64] * 4


def test_strange_chain():
    src = """
descA    [ type = "collection" ]
N        [ type = int ]
VAL      [ type = object ]
perm     [ type = object hidden = on default = None ]
nextpos  [ type = object hidden = on default = None ]
second   [ type = float hidden = on default = 5.2 ]

START(k)

 k = %{ VAL[0] %} .. %{ VAL[0] %}

: descA( %{ perm[0] %} )

RW A <- descA( %{ perm[0] %} )
     -> A TASK( 0, 0 )

BODY
{
    trace.append(("start", k, second))
}
END

TASK(pos, only)

 pos = 0 .. %{ N %} - 1 .. %{ 1 %}
 only = 0 .. N .. (N+1)
 n = %{ pos + 1 %}
 m = %{ pos + 1 %}

: descA( %{ perm[pos] %} )

RW A <- (0 == pos) ? A START(0) : A TASK( %{ nextpos[pos] - 2 %}, only )
     -> (pos < (N-1)) ? A TASK( %{ nextpos[pos] %}, only ) : descA( %{ perm[pos] %} )

BODY
{
    assert n == m
    trace.append(("task", perm[pos], VAL[0]))
    VAL[0] += 1
}
END
"""
    import random

    N = 8
    perm = list(range(N))
    random.Random(7).shuffle(perm)

    def scenario(P, ctx):
        VAL, trace = [0], []
        j = P.jdf.compile_jdf(src, "strange", namespace={"trace": trace})
        run(ctx, j.new(descA=P.LC("descA", shape=(1,), init=_zeros1), N=N,
                       VAL=VAL, perm=perm, nextpos=[p + 1 for p in range(N)]))
        assert trace[0][0] == "start" and trace[0][2] == 5.2
        tasks = [(e, v) for tag, e, v in trace if tag == "task"]
        return [[e for e, _ in tasks], [v for _, v in tasks], VAL[0]]

    res = both(scenario)
    assert_same(res)
    assert res[1] == [perm, list(range(N)), N]


UDF = """
A  [ type = "collection" ]
MT [ type = int ]
NT [ type = int ]

NOUD(m, n)
  m = 0 .. MT-1 .. %{ logger("nblocal") %}
  n = 0 .. NT-1 .. %{ logger("nblocal") %}

: A( m )

READ X <- A( m )

BODY
{
    ran.inc()
}
END

UD_EVAL(m, n)
  m = 0 .. MT-1
  n = 0 .. NT-1

: A( m )

READ X <- A( m )

BODY [ evaluate = never_here
       type = CUDA ]
{
    cuda_ran.inc()
}
END

BODY [ type = CPU
       evaluate = always_here ]
{
    cpu_ran.inc()
}
END
"""


def test_user_defined_functions():
    """Per-BODY ``evaluate`` hooks select among incarnations (the CUDA one
    is skipped every time, on a context that has the CUDA module),
    stride expressions with side effects count enumerations."""
    import collections

    def scenario(P, ctx):
        counts = collections.Counter()

        def logger(kind):
            counts[kind] += 1
            return 1

        ran, cpu_ran, cuda_ran = Counter(), Counter(), Counter()
        j = P.jdf.compile_jdf(UDF, "udf", namespace={
            "logger": logger, "ran": ran, "cpu_ran": cpu_ran,
            "cuda_ran": cuda_ran, "never_here": lambda task: False,
            "always_here": lambda task: True})
        run(ctx, j.new(A=P.LC("A", shape=(1,), init=_zeros1), MT=3, NT=4))
        assert counts["nblocal"] >= 3
        return [ran.v, cpu_ran.v, cuda_ran.v]

    res = both(scenario, device=True)
    assert_same(res)
    assert res[1] == [12, 12, 0]


WRITE_CHECK = """
V     [ type = "collection" ]
NT    [ type = int ]
BLOCK [ type = int ]

STARTUP(k)
  k = 0 .. NT-1

: V( k )

  WRITE A1 -> A2 TASK1(k)

BODY
{
    A1[:] = k * BLOCK + np.arange(BLOCK)
}
END

TASK1(k)
  k = 0 .. NT-1

: V( k )

  WRITE A3 -> A1 TASK2(k)
  RW    A1 <- V( k )
           -> A2 TASK2(k)
  READ  A2 <- A1 STARTUP(k)

BODY
{
    A1[:] += 1.0
    A3[:] = A2
}
END

TASK2(k)
  k = 0 .. NT-1

: V( k )

  READ A1 <- A3 TASK1(k)
  RW   A2 <- A1 TASK1(k)
          -> V( k )

BODY
{
    A2[:] += A1
}
END
"""


def test_vector_collection_write_check():
    NT, BLOCK = 6, 10

    def scenario(P, ctx):
        class VectorCollection(P.LC):
            def rank_of(self, *key):
                return key[0] % max(1, self.nodes)

        dc = VectorCollection("V", shape=(BLOCK,), init=lambda k: np.ones(BLOCK))
        j = P.jdf.compile_jdf(WRITE_CHECK, "write_check", namespace={"np": np})
        run(ctx, j.new(V=dc, NT=NT, BLOCK=BLOCK, TILE_SHAPE=(BLOCK,)))
        return tiles_of(dc, range(NT))

    res = both(scenario)
    assert_same(res)
    for k in range(NT):
        np.testing.assert_array_equal(res[1][k], 2.0 + k * BLOCK + np.arange(BLOCK))


COMPLEX_DEPS = """
A  [ type = "collection" ]
NI [ type = int ]
NK [ type = int ]

FCT1(i, k)

  i = 0 .. NI-1
  k = 0 .. NK-1

: A( i )

    READ A <- (0 == k) ? A(i) : A FCT1(i, k-1)
         -> (NK != k+1) ? A FCT1(i, k+1)
         -> A FCT5(i, k)                         [displ_remote = 10]
    RW   B <- (0 == k) ? A(i) : B FCT1(i, k-1)
         -> A FCT2(i, k, k .. NK)                [displ_remote = 0]
         -> A FCT3(i, k, k .. NK)                [displ_remote = 10]
         -> A FCT4(i, k)
         -> (NK != k+1) ? B FCT1(i, k+1)

BODY
{
    counts.inc("FCT1")
}
END

FCT2(i, k, j)

  i = 0 .. NI-1
  k = 0 .. NK-1
  j = k .. NK

: A( i )

  READ A <- B FCT1(i, k)
         -> B FCT3(i, j, k)

BODY
{
    counts.inc("FCT2")
}
END

FCT3(i, k, j)

  i = 0 .. NI-1
  k = 0 .. NK-1
  j = k .. NK

: A( i )

  READ A <- B FCT1(i, k)
  READ B <- A FCT2(i, j, k)

BODY
{
    counts.inc("FCT3")
}
END

FCT4(i, k)

  i = 0 .. NI-1
  k = 0 .. NK-1

: A( i )

  READ A <- B FCT1(i, k)

BODY
{
    counts.inc("FCT4")
}
END

FCT5(i, k)

  i = 0 .. NI-1
  k = 0 .. NK-1

: A( i )

  READ A <- A FCT1(i, k)

BODY
{
    counts.inc("FCT5")
}
END
"""


def test_complex_deps():
    import collections

    def scenario(P, ctx):
        lock = threading.Lock()
        data = collections.Counter()

        class Counts:
            def inc(self, name):
                with lock:
                    data[name] += 1

        j = P.jdf.compile_jdf(COMPLEX_DEPS, "cdeps", namespace={"counts": Counts()})
        run(ctx, j.new(A=P.LC("A", shape=(4,), init=lambda k: np.zeros(4)),
                       NI=2, NK=3))
        return [data[f"FCT{i}"] for i in range(1, 6)]

    res = both(scenario)
    assert_same(res)
    fan = 2 * sum(3 - k + 1 for k in range(3))
    assert res[1] == [6, fan, fan, 6, 6]


RECURSIVE = """
A     [ type = "collection" ]
level [ type = int ]
NI    [ type = int ]

DO_SOMETHING(i)

  i = 0 .. NI-1

: A( i )

RW X <- A( i )
     -> A( i )

BODY
{
    if level == 0:
        X[:] = X + 1.0
        return
    sub = make_sub(level - 1)
    return recursive_invoke(None, this_task, sub)
}
END
"""


def test_recursive_body():
    """A BODY spawns a nested taskpool of the same JDF one level down and
    completes when it quiesces; one worker keeps the count exact."""
    NI, LEVEL = 2, 2

    def scenario(P, ctx):
        dc = P.LC("A", shape=(2,), init=lambda k: np.zeros(2))
        holder = {}

        def make_sub(lvl):
            return holder["jdf"].new(A=dc, level=lvl, NI=NI)

        holder["jdf"] = P.jdf.compile_jdf(RECURSIVE, "recjdf", namespace={
            "make_sub": make_sub, "recursive_invoke": P.recursive_invoke})
        run(ctx, holder["jdf"].new(A=dc, level=LEVEL, NI=NI))
        return tiles_of(dc, range(NI))

    res = both(scenario, nb_cores=1)
    assert_same(res)
    np.testing.assert_array_equal(np.concatenate(res[1]), float(NI ** LEVEL))


# ---------------------------------------------------------------------------
# tests/dsl/test_jdf_cholesky.py and test_jdf_lu.py, dynamic
# ---------------------------------------------------------------------------

def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


def _dd(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


@pytest.mark.parametrize("source", ["reference_file", "port_file"])
def test_jdf_cholesky_dynamic(source):
    """The reference's examples/jdf/cholesky.jdf on its CPU bodies, through
    both packages, and the port's own copy through the port: the factors
    are bit-identical and factor the matrix."""
    N, NB = 128, 32
    SPD = _spd(N)
    port_path = os.path.join(EXAMPLES if source == "reference_file"
                             else PORT_EXAMPLES, "cholesky.jdf")

    def scenario(P, ctx):
        A = P.BC(N, N, NB, NB, name="A").from_array(SPD)
        path = port_path if P is PORT else os.path.join(EXAMPLES, "cholesky.jdf")
        run(ctx, P.jdf.compile_jdf_file(path).new(A=A, NT=A.mt), timeout=120)
        return [np.tril(A.to_array())]

    res = both(scenario)
    assert_same(res)
    L = res[1][0]
    np.testing.assert_allclose(L @ L.T, SPD, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("source", ["reference_file", "port_file"])
def test_jdf_lu_dynamic(source):
    N, NB = 96, 32
    A0 = _dd(N)
    port_path = os.path.join(EXAMPLES if source == "reference_file"
                             else PORT_EXAMPLES, "lu.jdf")

    def scenario(P, ctx):
        A = P.BC(N, N, NB, NB, name="A").from_array(A0)
        path = port_path if P is PORT else os.path.join(EXAMPLES, "lu.jdf")
        run(ctx, P.jdf.compile_jdf_file(path).new(A=A, NT=A.mt), timeout=120)
        return [A.to_array()]

    res = both(scenario)
    assert_same(res)
    packed = res[1][0]
    L = np.tril(packed, -1) + np.eye(N)
    np.testing.assert_allclose(L @ np.triu(packed), A0, rtol=1e-9,
                               atol=1e-9 * np.abs(A0).max())


def test_jdf_lu_cuda_bodies_match_lu_ptg():
    """The port's lu.jdf ``[type=CUDA]`` bodies (B1 trailing update) on the
    CUDA module: the factor equals ``lu_ptg(use_kernels=True)``'s."""
    from parsec_tpu_torch.ops.lu import lu_ptg

    N, NB = 96, 32
    A0 = _dd(N, seed=2).astype(np.float32)
    out = []
    for build in (lambda A: jdf.compile_jdf_file(os.path.join(PORT_EXAMPLES, "lu.jdf")).new(
                      A=A, NT=A.mt, KERNELS=1),
                  lambda A: lu_ptg(use_cuda=True, use_cpu=False,
                                   use_kernels=True).taskpool(NT=A.mt, A=A)):
        A = TwoDimBlockCyclic(N, N, NB, NB, name="A", dtype=np.float32).from_array(A0)
        tp = build(A)
        with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
            assert ctx.devices[1].stats["executed_tasks"] == tp.nb_retired
        out.append(A.to_array())
    assert torch.equal(torch.from_numpy(out[0]), torch.from_numpy(out[1]))
    packed = out[0].astype(np.float64)
    L = np.tril(packed, -1) + np.eye(N)
    np.testing.assert_allclose(L @ np.triu(packed), A0, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the port's cholesky.jdf on the CUDA module
# ---------------------------------------------------------------------------

_JDF_VARIANTS = {
    "kernels": (dict(KERNELS=1), dict(use_kernels=True), dict(use_pallas=True),
                2e-3, 1e-4),
    "kernels_bf16": (dict(KERNELS=1, BF16=1), dict(use_kernels=True, bf16_updates=True),
                     dict(use_pallas=True, bf16_updates=True), 2e-2, 2e-2),
}


def _chol_jdf():
    return jdf.compile_jdf_file(os.path.join(PORT_EXAMPLES, "cholesky.jdf"))


@pytest.mark.parametrize("variant", sorted(_JDF_VARIANTS))
def test_port_cholesky_jdf_matches_reference_and_ptg(variant):
    jdf_kw, port_kw, ref_kw, bound, ref_bound = _JDF_VARIANTS[variant]
    n, nb = 256, 64
    S = _spd(n, np.float32, seed=3)
    ref_A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    host = {k: np.array(ref_A.data_of(*k).newest_copy().payload) for k in ref_A.tiles()}
    ref_tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False, **ref_kw).taskpool(
        NT=ref_A.mt, A=ref_A)
    with parsec_tpu.Context(nb_cores=2) as ctx:
        ctx.add_taskpool(ref_tp)
        assert ref_tp.wait(timeout=120)
    L_ref = np.tril(ref_A.to_array())

    factors = {}
    for path, build in (
            ("jdf", lambda A: _chol_jdf().new(A=A, NT=A.mt, **jdf_kw)),
            ("ptg", lambda A: cholesky_ptg(use_cuda=True, use_cpu=False,
                                           **port_kw).taskpool(NT=A.mt, A=A))):
        A = from_numpy_tiles(host, nb, nb)
        kernels.reset_counts()
        tp = build(A)
        with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
            assert ctx.devices[1].stats["executed_tasks"] == tp.nb_retired
        factors[path] = (np.tril(A.to_array()), kernels.matmul_update.calls)
    (L, b1), (L_ptg, b1_ptg) = factors["jdf"], factors["ptg"]
    assert b1 == b1_ptg == 4 * 3 // 2 + 4 * 3 * 2 // 6
    assert torch.equal(torch.from_numpy(L), torch.from_numpy(L_ptg))
    assert np.abs(L - L_ref).max() / np.abs(L_ref).max() < ref_bound
    assert np.abs(L @ L.T - S).max() / np.abs(S).max() < bound


@pytest.fixture
def cuda_module_on_cpu():
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    try:
        yield
    finally:
        mca_param.params.unset("device", "cuda_torch_device")


@pytest.mark.parametrize("path", ["pump", "graph"])
def test_port_cholesky_jdf_pump_and_graph_equal_ptg(path, cuda_module_on_cpu):
    """The JDF's taskpool through the native pump and as a GraphExecutor
    replay: each factor ``torch.equal`` to ``cholesky_ptg``'s on the same
    path, with the same B1 calls."""
    n, nb = 128, 32
    S = _spd(n, np.float32, seed=5)
    out = []
    for build in (lambda A: _chol_jdf().new(A=A, NT=A.mt, KERNELS=1),
                  lambda A: cholesky_ptg(use_cuda=True, use_cpu=False,
                                         use_kernels=True).taskpool(NT=A.mt, A=A)):
        A = TwoDimBlockCyclic(n, n, nb, nb, name="A", dtype=np.float32,
                              uplo="lower").from_array(S)
        tp = build(A)
        kernels.reset_counts()
        if path == "pump":
            run_native(tp, native_device=True)
        else:
            GraphExecutor(tp, device="cpu")()
        out.append((np.tril(A.to_array()), kernels.matmul_update.calls))
    assert out[0][1] == out[1][1] == 4 * 3 // 2 + 4 * 3 * 2 // 6
    assert torch.equal(torch.from_numpy(out[0][0]), torch.from_numpy(out[1][0]))
    L = out[0][0].astype(np.float64)
    assert np.abs(L @ L.T - S).max() / np.abs(S).max() < 2e-3


def test_jdfc_module_of_port_cholesky_equals_ptg(tmp_path):
    """A module generated by jdfc from the port's cholesky.jdf runs on the
    CUDA module and equals ``cholesky_ptg(use_kernels=True)``."""
    n, nb = 128, 32
    S = _spd(n, np.float32, seed=6)
    out_py = tmp_path / "chol_ptg.py"
    assert jdfc.main([os.path.join(PORT_EXAMPLES, "cholesky.jdf"), "-o", str(out_py)]) == 0
    mod = _import_generated(str(out_py), "chol_ptg_generated")
    res = []
    for build in (lambda A: mod.new(A=A, NT=A.mt, KERNELS=1),
                  lambda A: cholesky_ptg(use_cuda=True, use_cpu=False,
                                         use_kernels=True).taskpool(NT=A.mt, A=A)):
        A = TwoDimBlockCyclic(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
        tp = build(A)
        with parsec_tpu_torch.Context(nb_cores=3, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
        res.append(np.tril(A.to_array()))
    assert torch.equal(torch.from_numpy(res[0]), torch.from_numpy(res[1]))


@pytest.mark.parametrize("name", ["cholesky", "lu"])
def test_captured_dag_equal_in_both_packages(name):
    """The reference's .jdf compiled in both packages, and the port's own
    copy, capture the same DAG: nodes, priorities, in-degrees, out-edges,
    flow sources and write-backs."""
    NT, NB = 4, 8
    ref_A = RefBC(NT * NB, NT * NB, NB, NB, name="A")
    A = TwoDimBlockCyclic(NT * NB, NT * NB, NB, NB, name="A")
    ref_g = ref_graph.capture(ref_jdf.compile_jdf_file(
        os.path.join(EXAMPLES, f"{name}.jdf")).new(A=ref_A, NT=NT))
    for path in (os.path.join(EXAMPLES, f"{name}.jdf"),
                 os.path.join(PORT_EXAMPLES, f"{name}.jdf")):
        g = graph.capture(jdf.compile_jdf_file(path).new(A=A, NT=NT))
        assert set(g.nodes) == set(ref_g.nodes)
        for tid, node in g.nodes.items():
            rn = ref_g.nodes[tid]
            assert node.priority == rn.priority
            assert node.in_edges == rn.in_edges
            assert sorted(node.out_edges) == sorted(rn.out_edges)
            assert node.flow_sources == rn.flow_sources
            assert sorted(node.write_backs) == sorted(rn.write_backs)


def test_tpu_bodies_are_never_selected():
    """A reference ``[type=TPU]`` BODY stays under device type ``tpu``,
    which no module of the port serves: the CPU BODY runs even with the
    CUDA module attached, and the tpu body's JAX code never runs."""
    src = DEVICE_SRC.format(dev="tpu").replace("END\n", """END

BODY
{
    X[:] = X * 5.0
}
END
""", 1)
    j = jdf.compile_jdf(src, "tpu_never")
    assert set(j.ptg.classes["t"].bodies) == {"tpu", "cpu"}
    dc = LocalCollection("D", shape=(4,), init=lambda k: np.full(4, 1.0 + k))
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        run(ctx, j.new(D=dc))
        assert ctx.devices[1].stats["executed_tasks"] == 0
    for k in range(3):
        np.testing.assert_array_equal(stage_to_cpu(dc.data_of(k)), (1.0 + k) * 5.0)


def test_verify_and_lint_refused_naming_a9b(tmp_path):
    """Once refused naming A.9b; since the graph linter is ported,
    ``JDF.verify`` and ``jdfc --lint/--strict`` give the JAX package's
    answers on the same JDF."""
    def key(fs):
        return collections.Counter(
            (f.code, f.severity, f.task, f.flow, f.env, f.dep, f.count) for f in fs)

    j, rj = jdf.compile_jdf(CHAIN, "chain"), ref_jdf.compile_jdf(CHAIN, "chain")
    assert key(j.verify()) == key(rj.verify())
    consts = {"NB": 3, "mydata": LocalCollection("mydata")}
    ref_consts = {"NB": 3, "mydata": RefLocalCollection("mydata")}
    assert key(j.verify(consts)) == key(rj.verify(ref_consts))
    path = tmp_path / "chain.jdf"
    path.write_text(CHAIN)
    assert jdfc.main(["--lint", str(path)]) == ref_jdfc.main(["--lint", str(path)]) == 0
    outs = [tmp_path / "port_ptg.py", tmp_path / "ref_ptg.py"]
    assert (jdfc.main(["--strict", str(path), "-o", str(outs[0])])
            == ref_jdfc.main(["--strict", str(path), "-o", str(outs[1])]) == 0)
    assert all(p.exists() for p in outs)
    assert jdfc.generate(CHAIN, "chain", lint=True, strict=True)
