"""The port's array front end (parsec_tpu_torch.array) at graph level,
against the JAX package's (parsec_tpu.array).

* the lowering cases of the reference's ``tests/array/test_lowering.py``
  (all but the redistribute-algo resolver, which comes with
  ``datadist.redistribute``, ROADMAP A.8): the canonical programs verify
  clean, the chain is PTG060-fusible, the ``arr_`` prefix, readers only on
  distributed grids, private copies only when needed, the Cholesky input
  survives, the row-aligned solve needs no readers, scalar ops and lazy
  zeros, shape and tiling validation;
* generated-graph parity: for ``canonical_program`` mixed, chain and dist
  and for the reference test's ad hoc programs, the port's PTG equals the
  reference's class by class — names, parameter ranges, affinity,
  priority, flows and every dep string — and the body incarnations are
  the same names with ``_tpu`` read as ``_cuda``;
* ``PTGTaskClass.add_dep``: appends to a flow, raises on an unknown flow,
  and refuses once the definition built a taskpool;
* the lint registry's ``array.*`` graphs and ``tools lint array:<name>``;
* the vector and tabular distributions against the reference's
  (``tests/collections/test_block_cyclic.py:67-97``), and the package
  version.
"""

import io
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import array as ref_pa  # noqa: E402
from parsec_tpu.analysis import verify_ptg as ref_verify_ptg  # noqa: E402
from parsec_tpu.datadist import TwoDimTabular as RefTabular  # noqa: E402
from parsec_tpu.datadist import VectorTwoDimCyclic as RefVector  # noqa: E402
from parsec_tpu_torch import Context  # noqa: E402
from parsec_tpu_torch import array as pa  # noqa: E402
from parsec_tpu_torch.analysis import registry, verify_ptg  # noqa: E402
from parsec_tpu_torch.analysis.findings import errors_of  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.datadist import TwoDimTabular, VectorTwoDimCyclic  # noqa: E402
from parsec_tpu_torch.dsl import PTG  # noqa: E402
from parsec_tpu_torch.ops.tiles import check_tiling  # noqa: E402
from parsec_tpu_torch.profiling import tools  # noqa: E402


def _args(a):
    return (a.lo.src, None if a.hi is None else a.hi.src,
            None if a.step is None else a.step.src)


def _body_names(pc):
    """(device, module.body) per incarnation, ``tpu`` read as ``cuda``."""
    return sorted((dev.replace("tpu", "cuda"),
                   f"{fn.__module__.rsplit('.', 1)[-1]}."
                   f"{fn.__name__.replace('_tpu', '_cuda')}")
                  for dev, fn in pc.bodies.items())


def ptg_shape(ptg):
    """Everything the synthesis decides, as plain values: per class its
    declarations, affinity, priority, flows with their dep strings, and
    the body incarnations (device name and body name, ``_tpu`` read as
    ``_cuda``)."""
    out = {}
    for name, pc in ptg.classes.items():
        aff = pc._affinity
        out[name] = {
            "decls": [(n, _args(a), p) for n, a, p in pc.decls],
            "affinity": None if aff is None else (aff.collection_name,
                                                  [_args(a) for a in aff.args]),
            "priority": None if pc._priority is None else pc._priority.src,
            "flows": [(f.name, int(f.mode), [d.src for d in f.deps_in],
                       [d.src for d in f.deps_out]) for f in pc.flows],
            "bodies": _body_names(pc),
        }
    return out


def _const_shape(consts):
    """Collections by name, with their geometry and placement class."""
    return {k: (type(v).__name__, v.m, v.n, v.mb, v.nb, v.nodes,
                str(v.default_dtype))
            for k, v in sorted(consts.items())}


# ---------------------------------------------------------------------------
# generated-graph parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["mixed", "chain", "dist"])
def test_canonical_program_equals_the_reference_class_by_class(which):
    port, ref = pa.canonical_program(which), ref_pa.canonical_program(which)
    assert list(port.ptg.classes) == list(ref.ptg.classes)
    mine, theirs = ptg_shape(port.ptg), ptg_shape(ref.ptg)
    for name in theirs:
        assert mine[name] == theirs[name], name
    assert port.ptg.name == ref.ptg.name and port.nranks == ref.nranks
    assert _const_shape(port.constants) == _const_shape(ref.constants)


@pytest.mark.parametrize("which", ["mixed", "chain", "dist"])
def test_canonical_programs_verify_clean(which):
    """The acceptance gate: generated graphs pass PTG.verify with zero
    findings — and with the reference's findings under fusion hints."""
    prog = pa.canonical_program(which)
    assert prog.verify() == []
    ref = ref_pa.canonical_program(which)
    key = lambda fs: sorted((f.code, f.severity) for f in fs)  # noqa: E731
    assert key(verify_ptg(prog.ptg, prog.constants, fusion_hints=True)) == \
        key(ref_verify_ptg(ref.ptg, ref.constants, fusion_hints=True))


def _adhoc(P, kw):
    """The reference tests' ad hoc programs, built through package ``P``."""
    G = np.eye(12) * 12.0
    Z = np.zeros((12, 12))
    rng = np.random.default_rng(3)
    H = rng.standard_normal((18, 10))
    progs = {}
    A = P.from_numpy(G, 4)
    progs["chol_leaf"] = P.lower([A.cholesky()], **kw)
    B, Zd = P.from_numpy(G, 4), P.from_numpy(Z, 4)
    progs["chol_ew"] = P.lower([(B + Zd).cholesky()], **kw)
    C = P.from_numpy(G, 4)
    m = C + Zd
    progs["chol_materialized"] = P.lower([m.cholesky(), m], **kw)
    X, Y = P.from_numpy(H, 8, 4), P.from_numpy(H * 2, 8, 4)
    progs["ew_chain_t"] = P.lower([((X + Y) * 0.25 - Y).T], **kw)
    Lm = np.tril(np.ones((16, 16))) + 16 * np.eye(16)
    for q in (1, 2):
        dist = P.BlockCyclic(2, 1) if q == 1 else P.BlockCyclic(1, 2)
        Ld = P.from_numpy(Lm, 4, dist=dist)
        bd = P.from_numpy(np.ones((16, 2)), 4, 2, dist=dist)
        progs[f"solve_q{q}"] = P.lower([Ld.solve(bd)], **kw)
    Rr = P.from_numpy(H, 8, 4)
    progs["redist"] = P.lower([Rr.redistribute(P.BlockCyclic(1, 1)) + Rr], **kw)
    S1 = P.from_numpy(np.ones((4, 4)), 4)
    progs["single_tile"] = P.lower([S1.cholesky().solve(P.from_numpy(np.ones((4, 1)), 4, 1)),
                                    ], **kw)
    Rep = P.from_numpy(np.ones((16, 1)), 4, 1, dist=P.Replicated())
    A2 = P.from_numpy(np.eye(16) * 16, 4, dist=P.Block1D(2))
    progs["replicated_rhs"] = P.lower([(A2 @ A2.T + A2).cholesky().solve(Rep)], **kw)
    return progs


def test_adhoc_programs_equal_the_reference_class_by_class():
    port = _adhoc(pa, dict(use_cuda=False))
    ref = _adhoc(ref_pa, dict(use_tpu=False))
    assert list(port) == list(ref)
    for key in ref:
        assert list(port[key].ptg.classes) == list(ref[key].ptg.classes), key
        assert ptg_shape(port[key].ptg) == ptg_shape(ref[key].ptg), key
        assert port[key].verify() == [], key


def test_device_bodies_are_the_references_read_as_cuda():
    """With device bodies on, every class carries the CPU body and the
    ``*_cuda`` counterpart of the reference's ``*_tpu``; the reduction's
    partials stay host-only in both."""
    G = np.eye(8) * 8.0
    port = pa.lower([(pa.from_numpy(G, 4) @ pa.from_numpy(G, 4)).cholesky()])
    ref = ref_pa.lower([(ref_pa.from_numpy(G, 4) @ ref_pa.from_numpy(G, 4)).cholesky()],
                       use_tpu=True)
    assert ptg_shape(port.ptg) == ptg_shape(ref.ptg)
    for pc in port.ptg.classes.values():
        assert set(pc.bodies) == {"cpu", "cuda"}, pc.name

    def reduce_prog(P, node_cls, **kw):
        n = P.from_numpy(np.ones((8, 8)), 4)._node
        red = node_cls("reduce", [n], (n.mt, n.nt), 1, 1, np.float64, n.dist,
                       n.myrank, reduce_op="sumsq")
        return P.lower([red], **kw)

    from parsec_tpu.array.expr import Node as RefNode
    from parsec_tpu_torch.array.expr import Node

    port_red = reduce_prog(pa, Node)
    assert ptg_shape(port_red.ptg) == ptg_shape(reduce_prog(ref_pa, RefNode,
                                                            use_tpu=True).ptg)
    assert list(port_red.ptg.classes["arr_ps1"].bodies) == ["cpu"]
    with pytest.raises(ValueError, match="use_cpu or use_cuda"):
        pa.lower([pa.from_numpy(G, 4) + pa.from_numpy(G, 4)], use_cpu=False,
                 use_cuda=False)


def test_elementwise_chain_is_ptg060_fusible():
    prog = pa.canonical_program("chain")
    findings = verify_ptg(prog.ptg, prog.constants, fusion_hints=True)
    assert findings and not errors_of(findings)
    assert any(f.code == "PTG060" for f in findings)


def test_all_classes_carry_array_prefix():
    from parsec_tpu_torch.profiling.critpath import label_of

    prog = pa.canonical_program("mixed")
    assert prog.ptg.classes
    for name in prog.ptg.classes:
        assert label_of(name) == "array", name


def test_single_rank_has_no_readers_distributed_does():
    single = pa.canonical_program("mixed")
    assert not [c for c in single.ptg.classes if c.startswith("arr_ld")]
    dist = pa.canonical_program("dist")
    assert [c for c in dist.ptg.classes if c.startswith("arr_ld")]


def test_private_copy_only_when_needed():
    G = np.eye(12) * 12.0
    A = pa.from_numpy(G, 4)
    p1 = pa.lower([A.cholesky()], use_cuda=False)
    assert any(c.startswith("arr_cp") for c in p1.ptg.classes)
    B = pa.from_numpy(G, 4)
    Z = pa.from_numpy(np.zeros((12, 12)), 4)
    p2 = pa.lower([(B + Z).cholesky()], use_cuda=False)
    assert not any(c.startswith("arr_cp") for c in p2.ptg.classes)
    assert p2.verify() == []
    C = pa.from_numpy(G, 4)
    m = C + Z
    p3 = pa.lower([m.cholesky(), m], use_cuda=False)
    assert any(c.startswith("arr_cp") for c in p3.ptg.classes)
    assert p3.verify() == []


def test_cholesky_input_survives():
    rng = np.random.default_rng(41)
    G = rng.standard_normal((12, 12))
    spd = G @ G.T + 12 * np.eye(12)
    A = pa.from_numpy(spd, 4)
    C = A.cholesky()
    with Context(nb_cores=2, devices=["cpu"]) as ctx:
        C.compute(ctx, use_cuda=False)
    assert np.array_equal(A.to_numpy(), spd), "input was mutated"
    assert np.allclose(np.tril(C.to_numpy()), np.linalg.cholesky(spd))


def test_solve_row_aligned_leaf_L_needs_no_readers():
    L = np.tril(np.ones((16, 16))) + 16 * np.eye(16)
    rhs = np.ones((16, 2))
    for q, want_readers in ((1, False), (2, True)):
        dist = pa.BlockCyclic(2, 1) if q == 1 else pa.BlockCyclic(1, 2)
        Ld = pa.from_numpy(L, 4, dist=dist, myrank=0)
        bd = pa.from_numpy(rhs, 4, 2, dist=dist, myrank=0)
        prog = pa.lower([Ld.solve(bd)], use_cuda=False)
        readers = [c for c in prog.ptg.classes if c.startswith("arr_ld")]
        assert bool(readers) == want_readers, (q, readers)
        assert prog.verify() == []


def test_scalar_ops_and_lazy_zeros():
    A = pa.from_numpy(np.ones((8, 8)), 4)
    with pytest.raises(TypeError, match="scalar"):
        A + 1.0
    with pytest.raises(TypeError, match="scalar"):
        A - 1.0
    Z = pa.zeros((8, 8), 4)
    assert Z.computed and Z._node.coll.materialized_keys() == []
    with pytest.raises(ValueError, match="eager datadist path"):
        A.redistribute(pa.BlockCyclic(1, 1), algo="coll")
    # the zeros materialize on first touch, as zeros, one tile at a time
    assert np.array_equal(Z._node.coll.data_of(1, 0).newest_copy().payload,
                          np.zeros((4, 4)))
    assert Z._node.coll.materialized_keys() == [(1, 0)]


def test_shape_and_tiling_validation():
    A = pa.from_numpy(np.zeros((8, 8)), 4)
    B = pa.from_numpy(np.zeros((8, 8)), 2)
    with pytest.raises(ValueError, match="tilings"):
        A + B
    with pytest.raises(ValueError, match="inner"):
        A @ pa.from_numpy(np.zeros((4, 8)), 4)
    with pytest.raises(ValueError, match="square"):
        pa.from_numpy(np.zeros((8, 4)), 4).cholesky()
    with pytest.raises(ValueError, match="mixes rank grids"):
        a2 = pa.from_numpy(np.zeros((8, 8)), 4, dist=pa.Block1D(2))
        a4 = pa.from_numpy(np.zeros((8, 8)), 4, dist=pa.Block1D(4))
        pa.lower([a2 + a4])
    with pytest.raises(ValueError, match="positive"):
        pa.from_numpy(np.zeros((8, 8)), 0)
    with pytest.raises(ValueError, match="1-D/2-D"):
        pa.from_numpy(np.zeros((2, 2, 2)), 1)


def test_check_tiling_contract():
    assert check_tiling(16, 4) == 4
    assert check_tiling(20, 8, allow_ragged=True) == 3
    with pytest.raises(ValueError, match="not divisible"):
        check_tiling(20, 8)
    with pytest.raises(ValueError, match="positive"):
        check_tiling(16, 0)


def test_dtype_promotion_matches_the_reference():
    """Node dtypes follow numpy promotion; bfloat16 is named by torch's
    dtype or its name and promotes as the JAX lattice does."""
    f32 = pa.from_numpy(np.ones((4, 4), np.float32), 2)
    f64 = pa.from_numpy(np.ones((4, 4)), 2)
    assert (f32 + f64).dtype == np.float64
    assert (f32 @ f32).dtype == np.float32
    for name in (torch.bfloat16, "bfloat16"):
        bf = pa.from_numpy(np.ones((4, 4), np.float32), 2, dtype=name)
        assert bf.dtype is torch.bfloat16
        assert (bf + bf).dtype is torch.bfloat16
        assert (bf @ f32).dtype == np.float32
        assert (f64 - bf).dtype == np.float64
    zb = pa.zeros((4, 4), 2, dtype="bfloat16")
    t = zb._node.coll.data_of(0, 0).newest_copy().payload
    assert isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16


# ---------------------------------------------------------------------------
# PTGTaskClass.add_dep (the reference's parsec_tpu/dsl/ptg.py:436-452)
# ---------------------------------------------------------------------------

def _two_classes():
    ptg = PTG("adddep")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(k)")
    a.flow("X", AccessMode.INOUT, "<- D(k)")
    b = ptg.task_class("b", k="0 .. 1")
    b.affinity("D(k)")
    b.flow("X", AccessMode.INOUT, "<- X a(k)", "-> D(k)")
    return ptg, a, b


def test_add_dep_appends_and_closes_reciprocity():
    from parsec_tpu_torch.data import LocalCollection

    ptg, a, _b = _two_classes()
    consts = {"D": LocalCollection("D", shape=(2,))}
    before = ptg.verify(consts)
    assert errors_of(before), "the unmirrored edge must be a reciprocity error"
    assert a.add_dep("X", "-> X b(k)") is a
    assert [d.src for d in a.flows[0].deps_out] == ["-> X b(k)"]
    assert ptg.verify(consts) == []
    with pytest.raises(ValueError, match="no flow 'Y'"):
        a.add_dep("Y", "-> X b(k)")


def test_add_dep_refuses_after_a_taskpool_was_built():
    """Dense dep boxes, the fusion partition cache (keyed by the
    definition) and a graph executor's digest derive from built pools:
    an edge added after one would leave them stale."""
    from parsec_tpu_torch.data import LocalCollection

    ptg, a, _b = _two_classes()
    a.add_dep("X", "-> X b(k)")
    assert not ptg.instantiated
    ptg.taskpool(D=LocalCollection("D", shape=(2,)))
    assert ptg.instantiated
    with pytest.raises(RuntimeError, match="after PTG 'adddep' built a taskpool"):
        a.add_dep("X", "-> D(k)")


# ---------------------------------------------------------------------------
# the lint registry and `tools lint array:<name>`
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["mixed", "chain", "dist"])
def test_registry_builds_the_canonical_program(which):
    ptg, consts = registry.build(f"array.{which}")
    assert list(ptg.classes) == list(pa.canonical_program(which).ptg.classes)
    assert errors_of(verify_ptg(ptg, consts)) == []


@pytest.mark.parametrize("which", ["mixed", "chain", "dist"])
def test_tools_lint_array_target_exits_clean(which):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(["lint", f"array:{which}"])
    assert rc == 0, buf.getvalue()
    assert f"array:{which}" in buf.getvalue()


def test_unknown_canonical_program_raises():
    with pytest.raises(KeyError, match="unknown canonical array program"):
        pa.canonical_program("nope")


# ---------------------------------------------------------------------------
# distributions and the package version
# ---------------------------------------------------------------------------

def test_vector_two_dim_cyclic_matches_the_reference():
    for p, q, kp in ((1, 1, 1), (2, 1, 1), (2, 3, 2), (4, 1, 3)):
        v = VectorTwoDimCyclic(100, 8, p=p, q=q, kp=kp, name="v")
        r = RefVector(100, 8, p=p, q=q, kp=kp, name="v")
        assert (v.mt, v.nt, v.nodes) == (r.mt, r.nt, r.nodes)
        for i in range(v.mt):
            assert v.rank_of(i) == r.rank_of(i), (p, q, kp, i)
            assert v.tile_shape(i) == r.tile_shape(i)
            assert v.data_key(i) == r.data_key(i) == (i, 0)
    with pytest.raises(ValueError, match="incompatible"):
        VectorTwoDimCyclic(10, 2, p=2, q=2, nodes=3)
    seg = np.arange(20.0).reshape(20, 1)
    v = VectorTwoDimCyclic(20, 8, name="v").from_array(seg)
    assert v.data_of(2).newest_copy().payload.shape == (4, 1)
    assert np.array_equal(v.to_array(), seg)


def test_two_dim_tabular_matches_the_reference():
    table = {(i, j): (3 * i + j) % 4 for i in range(3) for j in range(3)}
    fn = lambda i, j: (i + 2 * j) % 3  # noqa: E731
    for spec in (table, fn):
        t = TwoDimTabular(12, 12, 4, 4, rank_table=spec, nodes=4, myrank=1)
        r = RefTabular(12, 12, 4, 4, rank_table=spec, nodes=4, myrank=1)
        for key in r.tiles():
            assert t.rank_of(*key) == r.rank_of(*key), key
        assert list(t.local_tiles()) == list(r.local_tiles())


def test_package_version_is_the_references():
    assert parsec_tpu_torch.__version__ == parsec_tpu.__version__ == "0.1.0"
    assert "__version__" in parsec_tpu_torch.__all__
    from parsec_tpu_torch.version import __version__

    assert __version__ == parsec_tpu_torch.__version__


def test_array_all_is_the_references():
    assert sorted(pa.__all__) == sorted(ref_pa.__all__)
    for name in pa.__all__:
        assert hasattr(pa, name), name
