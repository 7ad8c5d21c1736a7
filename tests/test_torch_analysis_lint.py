"""The port's graph verifier (parsec_tpu_torch.analysis.linter) against
the JAX package's.

Every case of the reference's ``tests/analysis/test_lint_broken.py``
(one seeded defect per code), ``test_lint_clean.py``,
``test_lint_cli.py`` and ``test_inrepo_graphs.py`` builds the same graph
in both packages and verifies it: the finding multisets must be equal as
(code, severity, task class, flow, env, dep, count).  Message text is not
compared (it may name a module path), but the reference's own assertions
on it are held on the port's findings too.
"""

import collections
import types

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu_torch  # noqa: E402
from parsec_tpu import analysis as ref_analysis  # noqa: E402
from parsec_tpu.analysis import linter as ref_linter  # noqa: E402
from parsec_tpu.analysis import registry as ref_registry  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist.matrix import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import jdf as ref_jdf  # noqa: E402
from parsec_tpu.dsl import jdfc as ref_jdfc  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.profiling import tools as ref_tools  # noqa: E402
from parsec_tpu_torch import analysis  # noqa: E402
from parsec_tpu_torch.analysis import CODES, Finding, LintError  # noqa: E402
from parsec_tpu_torch.analysis import linter, registry  # noqa: E402
from parsec_tpu_torch.analysis.linter import SynthCollection  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist.matrix import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import jdf, jdfc  # noqa: E402
from parsec_tpu_torch.dsl.ptg import PTG  # noqa: E402
from parsec_tpu_torch.profiling import tools  # noqa: E402

IN = AccessMode.IN
OUT = AccessMode.OUT
INOUT = AccessMode.INOUT

# the two packages behind one surface; AccessMode flags are equal ints
PORT = types.SimpleNamespace(
    name="port", PTG=PTG, LocalCollection=LocalCollection,
    TiledMatrix=TiledMatrix, verify_ptg=analysis.verify_ptg, linter=linter,
    synthesize_collections=analysis.synthesize_collections,
    SynthCollection=SynthCollection)
REF = types.SimpleNamespace(
    name="ref", PTG=RefPTG, LocalCollection=RefLocalCollection,
    TiledMatrix=RefTiledMatrix, verify_ptg=ref_analysis.verify_ptg,
    linter=ref_linter,
    synthesize_collections=ref_analysis.synthesize_collections,
    SynthCollection=ref_linter.SynthCollection)


def key(findings):
    """The finding multiset, as (code, severity, task class, flow, env,
    dep, count)."""
    return collections.Counter(
        (f.code, f.severity, f.task, f.flow, f.env, f.dep, f.count)
        for f in findings)


def codes(findings):
    return {f.code for f in findings}


def find(findings, code):
    hits = [f for f in findings if f.code == code]
    assert hits, f"no {code} in {[str(f) for f in findings]}"
    return hits[0]


# ---------------------------------------------------------------------------
# one seeded defect per code (tests/analysis/test_lint_broken.py)
# ---------------------------------------------------------------------------

def _chain(P, n=3):
    ptg = P.PTG("broken")
    prod = ptg.task_class("prod", k=f"0 .. {n - 1}")
    prod.affinity("D(k)")
    prod.flow("X", INOUT, "<- D(k)", "-> X cons(k)")
    cons = ptg.task_class("cons", k=f"0 .. {n - 1}")
    cons.affinity("D(k)")
    cons.flow("X", IN, "<- X prod(k)")
    return ptg


def _clean_baseline(P, mp):
    fs = _chain(P).verify({"D": P.LocalCollection("D")})
    assert fs == []
    return fs


def _ptg001(P, mp):
    ptg = P.PTG("broken")
    prod = ptg.task_class("prod", k="0 .. 2")
    prod.affinity("D(k)")
    prod.flow("X", INOUT, "<- D(k)", "-> X cons(k)")
    cons = ptg.task_class("cons", k="0 .. 2")
    cons.affinity("D(k)")
    cons.flow("X", IN, "<- D(k)")  # should be '<- X prod(k)'
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG001")
    assert f.task == "prod" and f.flow == "X" and f.env == (0,)
    assert f.is_error and f.count == 3 and "cons" in f.message
    return fs


def _ptg002(P, mp):
    ptg = P.PTG("broken")
    prod = ptg.task_class("prod", k="0 .. 2")
    prod.affinity("D(k)")
    prod.flow("X", INOUT, "<- D(k)", "-> D(k)")  # no '-> X cons(k)'
    cons = ptg.task_class("cons", k="0 .. 2")
    cons.affinity("D(k)")
    cons.flow("Y", IN, "<- X prod(k)")
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG002")
    assert f.task == "cons" and f.flow == "Y" and f.env == (0,)
    assert "prod" in f.message
    return fs


def _ptg010(P, mp):
    ptg = P.PTG("waw")
    for name in ("w1", "w2"):
        tc = ptg.task_class(name, k="0 .. 0")
        tc.affinity("D(0)")
        tc.flow("X", INOUT, "<- D(0)")  # both mutate tile D(0), unordered
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG010")
    assert "D(0,)" in f.message and "w1" in f.message and "w2" in f.message
    return fs


def _ptg011(P, mp):
    ptg = P.PTG("raw")
    w = ptg.task_class("writer", k="0 .. 0")
    w.affinity("D(0)")
    w.flow("X", INOUT, "<- D(0)")
    r = ptg.task_class("reader", k="0 .. 0")
    r.affinity("D(0)")
    r.flow("X", IN, "<- D(0)")
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG011")
    assert f.task == "reader" and f.flow == "X" and f.env == (0,)
    assert "writer" in f.message
    return fs


def _ptg020(P, mp):
    ptg = P.PTG("cyc")
    a = ptg.task_class("a", k="0 .. 0")
    a.affinity("D(0)")
    a.flow("X", INOUT, "<- Y b(k)", "-> Y b(k)")
    b = ptg.task_class("b", k="0 .. 0")
    b.affinity("D(0)")
    b.flow("Y", INOUT, "<- X a(k)", "-> X a(k)")
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG020")
    assert "cycle" in f.message and f.task in ("a", "b") and f.env == (0,)
    return fs


def _dead(P):
    ptg = P.PTG("dead")
    a = ptg.task_class("a", k="0 .. 2")
    a.affinity("D(0)")
    a.flow("X", IN, "<- (k > 99) ? D(0)")  # no branch ever matches
    return ptg


def _ptg021(P, mp):
    fs = _dead(P).verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG021")
    assert f.task == "a" and f.flow == "X" and f.env == (0,) and f.count == 3
    return fs


def _ptg021_ignored(P, mp):
    fs = _dead(P).verify({"D": P.LocalCollection("D")}, ignore=("PTG021",))
    assert fs == []
    return fs


def _ignore_bare_string(P, mp):
    fs = _dead(P).verify({"D": P.LocalCollection("D")}, ignore="PTG021")
    assert fs == []
    return fs


def _ptg022(P, mp):
    ptg = P.PTG("ambig")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(k)")
    a.flow("X", IN, "<- D(k)", "<- (k == 0) ? D(k)")  # both match at k=0
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG022")
    assert f.severity == "warning" and f.env == (0,) and f.count == 1
    return fs


def _ptg030(P, mp):
    ptg = P.PTG("unbound")
    a = ptg.task_class("a", k="0 .. ZZ")  # ZZ never supplied
    a.affinity("D(0)")
    a.flow("X", IN, "<- D(qq)")  # qq unbound
    fs = ptg.verify({"D": P.LocalCollection("D")})
    assert codes(fs) == {"PTG030"}
    assert any("ZZ" in f.message and f.task == "a" for f in fs)
    assert any("qq" in f.message and f.flow == "X" for f in fs)
    return fs


def _ptg031(P, mp):
    A = P.TiledMatrix(8, 8, 2, 2)  # 4 x 4 tiles
    ptg = P.PTG("oob")
    a = ptg.task_class("a", k="0 .. 3")
    a.affinity("A(k, k+1)")  # k=3 -> (3, 4): off the grid
    a.flow("X", IN, "<- A(k, k)")
    fs = ptg.verify({"A": A})
    f = find(fs, "PTG031")
    assert f.task == "a" and f.env == (3,) and "(3, 4)" in f.message
    return fs


def _ptg032(P, mp):
    ptg = P.PTG("noc")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(0)")
    a.flow("X", IN, "<- NOSUCH(k)")
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG032")
    assert f.task == "a" and f.flow == "X" and "NOSUCH" in f.message
    return fs


def _ptg033(P, mp):
    ptg = P.PTG("badref")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(0)")
    a.flow("X", IN, "<- Q nope(k)")      # unknown class
    a.flow("Y", IN, "<- X a(k, 1)")      # arity mismatch
    a.flow("Z", OUT, "-> W a(k)")        # consumer has no flow W
    fs = ptg.verify({"D": P.LocalCollection("D")})
    msgs = [f.message for f in fs if f.code == "PTG033"]
    assert len(msgs) == 3
    assert any("nope" in m for m in msgs)
    assert any("2 argument(s)" in m for m in msgs)
    assert any("no flow 'W'" in m for m in msgs)
    return fs


def _ptg034(P, mp):
    ptg = P.PTG("rng")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(0)")
    a.flow("X", IN, "<- X a(0 .. k)")
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG034")
    assert f.task == "a" and f.flow == "X"
    return fs


def _ptg035(P, mp):
    ptg = P.PTG("noin")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(0)")
    a.flow("X", IN)
    fs = ptg.verify({"D": P.LocalCollection("D")})
    f = find(fs, "PTG035")
    assert f.severity == "warning" and f.flow == "X"
    return fs


def _ptg040(P, mp):
    class TwoRank(P.LocalCollection):
        def rank_of(self, *key):
            return int(key[0]) % 2

    ptg = P.PTG("xrank")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(0)")  # every task on rank 0...
    a.flow("X", INOUT, "<- D(k)", "-> D(k)")  # ...but k=1 writes rank 1
    fs = ptg.verify({"D": TwoRank("D", nodes=2)})
    f = find(fs, "PTG040")
    assert f.severity == "warning" and f.env == (1,)
    return fs


def _ptg050(P, mp):
    ptg = P.PTG("huge")
    a = ptg.task_class("a", k="0 .. 9999")
    a.affinity("D(0)")
    a.flow("X", INOUT, "<- D(0)")
    fs = P.verify_ptg(ptg, {"D": P.LocalCollection("D")}, max_tasks=100)
    assert codes(fs) == {"PTG050"}
    return fs


def _ptg051(P, mp):
    ptg = P.PTG("boom")
    a = ptg.task_class("a", k="0 .. NT // ZERO")  # ZeroDivisionError
    a.affinity("D(0)")
    a.flow("X", INOUT, "<- D(0)", "-> D(0)")
    fs = ptg.verify({"NT": 4, "ZERO": 0, "D": P.LocalCollection("D")})
    assert "ZeroDivisionError" in find(fs, "PTG051").message
    return fs


def _static_known(P, mp):
    ptg = P.PTG("stat")
    a = ptg.task_class("a", k="0 .. NT-1")
    a.affinity("A(k)")
    a.flow("X", INOUT, "<- A(k)", "-> A(k)")
    fs = P.verify_ptg(ptg, None, level="static", known={"NT"},
                      collections={"A"})
    assert fs == []
    fs = P.verify_ptg(ptg, None, level="static", known=set(),
                      collections={"A"})
    assert codes(fs) == {"PTG030"}
    with pytest.raises(ValueError):
        P.verify_ptg(ptg, None, level="nope")
    return fs


def _hazard_budget(P, mp):
    ptg = P.PTG("chain_haz")
    t = ptg.task_class("t", k="0 .. 49")
    t.affinity("D(0)")
    t.flow("X", INOUT,
           "<- (k == 0) ? D(0) : X t(k-1)",
           "-> (k == 49) ? D(0) : X t(k+1)")
    consts = {"D": P.LocalCollection("D")}
    assert ptg.verify(consts) == []  # within budget: fully checked
    mp.setattr(P.linter, "HAZARD_WORK_LIMIT", 10)
    fs = ptg.verify(consts)
    assert [f.code for f in fs] == ["PTG050"] and "hazard" in fs[0].message
    return fs


def _ignoring_static_code(P, mp):
    ptg = P.PTG("gated")
    a = ptg.task_class("a", k="0 .. ZZ")  # ZZ unbound -> PTG030
    a.affinity("D(0)")
    a.flow("X", INOUT, "<- D(0)", "-> D(0)")
    consts = {"D": P.LocalCollection("D")}
    assert codes(ptg.verify(consts)) == {"PTG030"}
    fs = ptg.verify(consts, ignore=("PTG030",))
    assert fs and codes(fs) == {"PTG051"}  # anything but a clean []
    return fs


def _hazard_distinct_tiles(P, mp):
    ptg = P.PTG("two_tiles")
    for name in ("w1", "w2"):
        tc = ptg.task_class(name, k="0 .. 0")
        tc.affinity("D(0)")
        tc.flow("X", INOUT, "<- D(0)")
        tc.flow("Y", INOUT, "<- E(0)")
    fs = ptg.verify({"D": P.LocalCollection("D"),
                     "E": P.LocalCollection("E")})
    waw = [f for f in fs if f.code == "PTG010"]
    assert len(waw) == 2 and {f.dep for f in waw} == {"D(0,)", "E(0,)"}
    return fs


BROKEN = {
    "clean_baseline": _clean_baseline, "ptg001": _ptg001, "ptg002": _ptg002,
    "ptg010": _ptg010, "ptg011": _ptg011, "ptg020": _ptg020,
    "ptg021": _ptg021, "ptg021_ignored": _ptg021_ignored,
    "ignore_bare_string": _ignore_bare_string, "ptg022": _ptg022,
    "ptg030": _ptg030, "ptg031": _ptg031, "ptg032": _ptg032,
    "ptg033": _ptg033, "ptg034": _ptg034, "ptg035": _ptg035,
    "ptg040": _ptg040, "ptg050": _ptg050, "ptg051": _ptg051,
    "static_level_known_names": _static_known,
    "hazard_work_budget": _hazard_budget,
    "ignoring_static_code_keeps_instance_checks": _ignoring_static_code,
    "hazards_on_distinct_tiles_do_not_collapse": _hazard_distinct_tiles,
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_seeded_defect_findings_match_the_reference(case, monkeypatch):
    port = BROKEN[case](PORT, monkeypatch)
    ref = BROKEN[case](REF, monkeypatch)
    assert key(port) == key(ref)


def test_every_code_is_the_references():
    """Codes are append-only: the port's table is the reference's, code
    for code and severity for severity."""
    assert {c: sev for c, (sev, _) in CODES.items()} == \
        {c: sev for c, (sev, _) in ref_analysis.CODES.items()}
    for code, (sev, desc) in CODES.items():
        assert sev in ("error", "warning", "info") and desc
    assert Finding("PTG999", "x").severity == "error"


# ---------------------------------------------------------------------------
# clean graphs and the runtime hooks (tests/analysis/test_lint_clean.py)
# ---------------------------------------------------------------------------

def test_cholesky_builder_is_clean():
    from parsec_tpu.ops.cholesky import cholesky_ptg as ref_cholesky_ptg
    from parsec_tpu_torch.ops.cholesky import cholesky_ptg

    for kw, ref_kw in (({"use_cuda": False}, {"use_tpu": False}),
                       ({"use_kernels": True, "use_trtri": True},
                        {"use_pallas": True, "use_trtri": True})):
        fs = cholesky_ptg(**kw).verify({"NT": 4, "A": TiledMatrix(8, 8, 2, 2)})
        ref = ref_cholesky_ptg(**ref_kw).verify(
            {"NT": 4, "A": RefTiledMatrix(8, 8, 2, 2)})
        assert fs == [] and key(fs) == key(ref)


def test_segmented_lu_builder_is_clean():
    from parsec_tpu_torch.ops.segmented_chol import n_segments
    from parsec_tpu_torch.ops.segmented_lu import segmented_lu_ptg

    consts = {"NT": n_segments(8, 4, tail=4), "A": LocalCollection("A")}
    assert segmented_lu_ptg(8, 4, tail=4).verify(consts) == []


def test_verify_accepts_kwargs_and_merges_ptg_constants():
    for P in (PORT, REF):
        ptg = P.PTG("kw", NT=3)
        a = ptg.task_class("a", k="0 .. NT-1")
        a.affinity("D(k)")
        a.flow("X", INOUT, "<- D(k)", "-> D(k)")
        assert ptg.verify(D=P.LocalCollection("D")) == []
        assert ptg.verify({"D": P.LocalCollection("D")}, level="static") == []


def test_synthesize_collections():
    for P in (PORT, REF):
        ptg = P.PTG("syn")
        a = ptg.task_class("a", k="0 .. 1")
        a.affinity("D(k)")
        a.flow("X", INOUT, "<- D(k)", "-> E(k)")
        consts, added = P.synthesize_collections(ptg, {"NT": 2})
        assert added == ["D", "E"]
        assert all(isinstance(consts[n], P.SynthCollection) for n in added)
        assert consts["D"].rank_of(5) == 0
        with pytest.raises(RuntimeError):
            consts["D"].data_of(0)
        assert P.verify_ptg(ptg, consts) == []


def _broken_pool(P=PORT):
    ptg = P.PTG("broken_env")
    prod = ptg.task_class("prod", k="0 .. 1")
    prod.affinity("D(k)")
    prod.flow("X", INOUT, "<- D(k)", "-> X cons(k)")
    cons = ptg.task_class("cons", k="0 .. 1")
    cons.affinity("D(k)")
    cons.flow("X", IN, "<- D(k)")  # missing reciprocal input
    return ptg.taskpool(D=P.LocalCollection("D"))


def test_env_lint_off_by_default(monkeypatch):
    monkeypatch.delenv("PARSEC_TPU_LINT", raising=False)
    _broken_pool()._maybe_lint()  # no-op
    monkeypatch.setenv("PARSEC_TPU_LINT", "0")
    _broken_pool()._maybe_lint()


def test_env_lint_warn_mode_does_not_raise(monkeypatch):
    monkeypatch.setenv("PARSEC_TPU_LINT", "1")
    _broken_pool()._maybe_lint()


def test_env_lint_strict_mode_raises_as_the_reference(monkeypatch):
    monkeypatch.setenv("PARSEC_TPU_LINT", "strict")
    with pytest.raises(LintError) as port:
        _broken_pool()._maybe_lint()
    with pytest.raises(ref_analysis.LintError) as ref:
        _broken_pool(REF)._maybe_lint()
    assert any(f.code == "PTG001" for f in port.value.findings)
    assert key(port.value.findings) == key(ref.value.findings)


def test_env_lint_strict_passes_clean_pool(monkeypatch):
    monkeypatch.setenv("PARSEC_TPU_LINT", "strict")
    ptg = PTG("clean_env")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(k)")
    a.flow("X", INOUT, "<- D(k)", "-> D(k)")
    ptg.taskpool(D=LocalCollection("D"))._maybe_lint()


def test_strict_lint_runs_end_to_end_in_context(monkeypatch):
    """The startup hook fires from Context.add_taskpool: a broken PTG is
    rejected before a single task is scheduled, the pool fails, and the
    context stays usable."""
    monkeypatch.setenv("PARSEC_TPU_LINT", "strict")
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        tp = _broken_pool()
        with pytest.raises(LintError):
            ctx.add_taskpool(tp)
        assert tp.failed and "lint" in tp.fail_reason
        ptg = PTG("after")
        a = ptg.task_class("a", k="0 .. 1")
        a.affinity("D(k)")
        a.flow("X", INOUT, "<- D(k)", "-> D(k)")
        a.body(cpu=lambda X, k: None)
        ok = ptg.taskpool(D=LocalCollection("D", shape=(2,)))
        ctx.add_taskpool(ok)
        assert ok.wait(timeout=30)


def test_static_verify_of_builder_ptg_without_globals_is_clean():
    from parsec_tpu_torch.ops.cholesky import cholesky_ptg

    assert cholesky_ptg(use_cuda=False).verify(level="static") == []
    for P in (PORT, REF):
        ptg = P.PTG("structbad")
        a = ptg.task_class("a", k="0 .. NT-1")
        a.affinity("D(k)")
        a.flow("X", IN, "<- Q nope(k)")
        assert codes(ptg.verify(level="static")) == {"PTG033"}
        assert "PTG030" in codes(ptg.verify(level="static", known=set(),
                                            collections={"D"}))


def test_verify_forwards_lint_kwargs_not_as_globals():
    ptg = PTG("cap")
    a = ptg.task_class("a", k="0 .. 999")
    a.affinity("D(0)")
    a.flow("X", INOUT, "<- D(0)", "-> D(0)")
    fs = ptg.verify({"D": LocalCollection("D")}, max_tasks=10)
    assert codes(fs) == {"PTG050"}


def test_env_lint_ignore_keeps_strict_usable(monkeypatch):
    ptg = PTG("dyn")
    a = ptg.task_class("a", k="0 .. 1")
    a.affinity("D(0)")
    a.flow("X", IN, "<- (k > 99) ? D(0)")  # PTG021 under static guards
    tp = ptg.taskpool(D=LocalCollection("D"))
    monkeypatch.setenv("PARSEC_TPU_LINT", "strict")
    with pytest.raises(LintError):
        tp._maybe_lint()
    monkeypatch.setenv("PARSEC_TPU_LINT_IGNORE", "PTG021, PTG040")
    tp._maybe_lint()  # suppressed: the pool is allowed to start


# ---------------------------------------------------------------------------
# the in-repo registry (tests/analysis/test_inrepo_graphs.py)
# ---------------------------------------------------------------------------

#: registry graphs that wait for another layer, with its ROADMAP item
WAITING = {"ops.attention_ring": "A.8", "ops.attention_ring_bcast": "A.8",
           "ops.segmented_chol_dist": "A.8"}


def test_registry_names_are_the_references():
    assert registry.names() == ref_registry.names()


@pytest.mark.parametrize("name", registry.names())
def test_inrepo_graph_lints_clean(name):
    """Every buildable registry graph verifies to zero error and warning
    findings and to the reference's findings, fusion hints (PTG060,
    advisory) included; a graph whose layer is not ported raises naming
    its ROADMAP item."""
    if name in WAITING:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {WAITING[name]}"):
            registry.build(name)
        return
    ptg, consts = registry.build(name)
    fs = analysis.verify_ptg(ptg, consts, fusion_hints=True)
    real = [f for f in fs if f.severity != "info"]
    assert real == [], f"{name}: " + "; ".join(str(f) for f in real)
    ref_ptg, ref_consts = ref_registry.build(name)
    assert key(fs) == key(ref_analysis.verify_ptg(ref_ptg, ref_consts,
                                                  fusion_hints=True))


def test_registry_sweep_reports_fusion_hints():
    ptg, consts = registry.build("ops.cholesky")
    hints = [f for f in analysis.verify_ptg(ptg, consts, fusion_hints=True)
             if f.code == "PTG060"]
    assert hints and all(f.severity == "info" for f in hints)
    assert any("save" in f.message for f in hints)


def test_registry_unknown_name():
    with pytest.raises(KeyError):
        registry.build("no.such.graph")


def test_exists_counter_counts_linter_validity_checks():
    """The linter's reciprocity checks go through ``valid``: its work
    shows on the port's existence counter as on the reference's."""
    from parsec_tpu.dsl import ptg as ref_ptg_mod
    from parsec_tpu_torch.dsl import ptg as ptg_mod

    works = []
    for mod, P in ((ptg_mod, PORT), (ref_ptg_mod, REF)):
        mod.reset_exists_eval_count()
        assert _chain(P).verify({"D": P.LocalCollection("D")}) == []
        works.append(mod.exists_eval_count())
    assert works[0] == works[1] > 0


# ---------------------------------------------------------------------------
# the CLI surfaces (tests/analysis/test_lint_cli.py)
# ---------------------------------------------------------------------------

CLEAN_JDF = """\
A  [ type = "collection" ]
NB [ type = int ]

Task(k)
k = 0 .. NB
: A( k )
RW X <- (k == 0)  ? A( k ) : X Task( k-1 )
     -> (k == NB) ? A( k ) : X Task( k+1 )
BODY
  pass
END
"""

BROKEN_JDF = CLEAN_JDF.replace(
    "RW X <- (k == 0)  ? A( k ) : X Task( k-1 )", "RW X <- A( k )")

SYNTAX_ERR_JDF = "Task(k\n"


@pytest.fixture
def jdf_files(tmp_path):
    paths = {}
    for name, text in (("clean", CLEAN_JDF), ("broken", BROKEN_JDF),
                       ("syntax", SYNTAX_ERR_JDF),
                       ("unbound", CLEAN_JDF.replace("k = 0 .. NB",
                                                     "k = 0 .. MISSING"))):
        p = tmp_path / f"{name}.jdf"
        p.write_text(text)
        paths[name] = str(p)
    return paths


def _both(argv, capsys, port_argv=None):
    """(port rc, port stdout, port stderr), then the reference's rc for
    the same arguments."""
    rc = tools.main(port_argv or argv)
    out = capsys.readouterr()
    ref_rc = ref_tools.main(argv)
    capsys.readouterr()
    return rc, out.out, out.err, ref_rc


LINT_CASES = {
    # name: (argv with {clean}/{broken}/... placeholders, port rc, check)
    "clean_jdf_strict": (["lint", "{clean}", "-D", "NB=3", "--strict"], 0,
                         lambda o, e: "OK" in o
                         and "synthesized collection(s): A" in o),
    "broken_jdf_strict": (["lint", "{broken}", "-D", "NB=3", "--strict"], 1,
                          lambda o, e: "PTG001" in o and "Task(1,)" in o
                          and ".X" in o),
    "broken_jdf": (["lint", "{broken}", "-D", "NB=3"], 1, None),
    "missing_globals_static": (["lint", "{clean}"], 0,
                               lambda o, e: "missing globals" in o
                               and "['NB']" in o),
    "registry_name": (["lint", "jdf.chaindata"], 0, lambda o, e: "OK" in o),
    "ignore": (["lint", "{broken}", "-D", "NB=3", "--ignore",
                "PTG001,PTG011"], 0, None),
    "no_targets": (["lint"], 2, None),
    "unparsable": (["lint", "{syntax}"], 1, lambda o, e: "FAILED" in e),
}


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_cli_matches_the_reference(case, jdf_files, capsys):
    argv, want, check = LINT_CASES[case]
    argv = [a.format(**jdf_files) for a in argv]
    rc, out, err, ref_rc = _both(argv, capsys)
    assert rc == ref_rc == want
    if check is not None:
        assert check(out, err), (out, err)


def test_lint_module_builder_target(capsys):
    rc, out, _, ref_rc = _both(
        ["lint", "parsec_tpu.ops.cholesky:cholesky_ptg", "-D", "NT=3"], capsys,
        ["lint", "parsec_tpu_torch.ops.cholesky:cholesky_ptg", "-D", "NT=3"])
    assert rc == ref_rc == 0 and "OK" in out


def test_lint_module_builder_without_globals_falls_back_to_static(capsys):
    rc, out, _, ref_rc = _both(
        ["lint", "parsec_tpu.ops.cholesky:cholesky_ptg"], capsys,
        ["lint", "parsec_tpu_torch.ops.cholesky:cholesky_ptg"])
    assert rc == ref_rc == 0
    assert "missing globals" in out and "NT" in out and "OK" in out


def test_lint_all_reports_the_waiting_graphs(capsys):
    """``--all`` lints every buildable registry graph clean and reports
    the ones that wait for an unported layer, without failing."""
    rc = tools.main(["lint", "jdf.chaindata", "--all"])
    out = capsys.readouterr().out
    assert rc == 0
    n = len(registry.names())
    assert f"lint: {n} graph(s), 0 error(s), 0 warning(s)" in out
    assert f"{len(WAITING)} waiting" in out
    for name, item in WAITING.items():
        assert f"{name}: waiting:" in out and f"ROADMAP {item}" in out
    # named explicitly, a waiting graph fails the run
    assert tools.main(["lint", "ops.attention_ring"]) == 1
    assert "FAILED" in capsys.readouterr().err


def test_jdfc_parse_error_exits_nonzero_without_traceback(jdf_files, capsys):
    rc = jdfc.main([jdf_files["syntax"], "-o", "/dev/null"])
    err = capsys.readouterr().err
    assert rc == 1 and "jdfc:" in err and "Traceback" not in err


def test_jdfc_missing_file_exits_nonzero(capsys):
    assert jdfc.main(["/no/such/file.jdf"]) == 1
    assert "jdfc:" in capsys.readouterr().err


def test_jdfc_lint_flag_clean(jdf_files, capsys):
    assert jdfc.main(["--lint", jdf_files["clean"]]) == 0
    assert "OK" in capsys.readouterr().out


def test_jdfc_lint_flag_static_error(jdf_files, capsys):
    assert jdfc.main(["--lint", jdf_files["unbound"]]) == 1
    assert "PTG030" in capsys.readouterr().err
    assert ref_jdfc.main(["--lint", jdf_files["unbound"]]) == 1


def test_jdfc_generate_emits_despite_warnings_unless_strict(jdf_files, tmp_path,
                                                           capsys):
    out = tmp_path / "gen.py"
    rc = jdfc.main([jdf_files["unbound"], "-o", str(out)])
    captured = capsys.readouterr()
    assert rc == 0 and out.exists()          # findings are warnings...
    assert "PTG030" in captured.err          # ...printed to stderr
    out2 = tmp_path / "gen2.py"
    rc = jdfc.main([jdf_files["unbound"], "-o", str(out2), "--strict"])
    assert rc == 1 and not out2.exists()     # --strict fails the build


def test_jdfc_generate_clean_roundtrip(jdf_files, tmp_path, capsys):
    out = tmp_path / "task_ptg.py"
    assert jdfc.main([jdf_files["clean"], "-o", str(out)]) == 0
    assert out.exists() and "PTG" not in capsys.readouterr().err


def test_jdf_verify_method():
    """JDF.verify mirrors PTG.verify: static without globals, full with;
    the findings are the reference's."""
    broken, ref_broken = (jdf.compile_jdf(BROKEN_JDF, "broken"),
                          ref_jdf.compile_jdf(BROKEN_JDF, "broken"))
    assert broken.verify() == []  # reciprocity needs concrete globals
    fs = broken.verify({"NB": 3, "A": LocalCollection("A")})
    assert any(f.code == "PTG001" for f in fs)
    assert key(fs) == key(ref_broken.verify({"NB": 3, "A": RefLocalCollection("A")}))
    clean = jdf.compile_jdf(CLEAN_JDF, "clean")
    assert clean.verify({"NB": 3, "A": LocalCollection("A")}) == []


def test_jdfc_unwritable_output_exits_nonzero(jdf_files, capsys):
    rc = jdfc.main([jdf_files["clean"], "-o", "/nonexistent/dir/out.py"])
    assert rc == 1 and "jdfc:" in capsys.readouterr().err
