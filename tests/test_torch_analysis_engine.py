"""The port's engine verifier (parsec_tpu_torch.analysis.engine_verify
and the ABI lint of parsec_tpu_torch.native.abi) against the JAX
package's.

The cases of the reference's ``tests/analysis/test_engine_verify.py``:
the lifecycle model checker explores the same states and transitions as
the reference's on every seed DAG and is silent on the healthy model;
every seeded mutation fires the same codes; the conformance automaton
gives the same answers on faithful and doctored streams and certifies
real pump loops on the port's g++-built engine (at nt=16 too, the
dpotrf path's DAG, with the same event count as the reference's
engine); the ABI lint passes the port's spec, sources and library and
catches seeded drift; a missing clang-tidy is an explicit ENG021 skip.
Every native run has its own time limit.
"""

import os
import shutil
import threading

import pytest

jax = pytest.importorskip("jax")

from parsec_tpu.analysis import engine_verify as ref_ev  # noqa: E402
from parsec_tpu.native import abi as ref_abi  # noqa: E402
from parsec_tpu_torch import native  # noqa: E402
from parsec_tpu_torch.analysis import engine_verify as ev  # noqa: E402
from parsec_tpu_torch.native import abi  # noqa: E402
from parsec_tpu_torch.profiling import tools  # noqa: E402

RUN_LIMIT = 240


def _within(fn, limit=RUN_LIMIT):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the test thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"run did not finish within {limit} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def codes(findings):
    return sorted((f.code, f.severity, f.task) for f in findings)


# ---------------------------------------------------------------------------
# model checker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [2, 3])
def test_healthy_model_is_silent_and_explores_the_references_states(workers):
    findings, stats = ev.model_findings(workers=workers)
    ref_findings, ref_stats = ref_ev.model_findings(workers=workers)
    assert findings == [] == ref_findings
    assert [d.name for d in ev.SEED_DAGS] == [d.name for d in ref_ev.SEED_DAGS]
    for dag in ev.SEED_DAGS:
        st = stats[dag.name]
        assert st.states > 0 and st.terminals > 0 and not st.truncated, dag.name
        assert vars(st) == vars(ref_stats[dag.name]), dag.name


def test_state_budget_truncation_is_flagged():
    m = ev.EngineModel(ev.SEED_DAGS[2], policy="prio")
    c = ev.ModelChecker(m, workers=2, max_states=3)
    c.run()
    assert c.stats.truncated


_MUTATION_CODE = {
    "lost_retire": "ENG010",
    "double_retire": "ENG010",
    "early_quiesce": "ENG011",
    "double_publish": "ENG012",
    "drop_event": "ENG012",
    "retire_before_deps": "ENG012",
    "wdrr_lose_bin": "ENG013",
}


def test_mutation_table_matches_module():
    assert set(_MUTATION_CODE) == set(ev.MUTATIONS) == set(ref_ev.MUTATIONS)


@pytest.mark.parametrize("mutation", sorted(_MUTATION_CODE))
def test_seeded_mutation_fires_the_references_codes(mutation):
    findings, _ = ev.model_findings(mutate=mutation)
    ref_findings, _ = ref_ev.model_findings(mutate=mutation)
    assert _MUTATION_CODE[mutation] in {f.code for f in findings}
    assert codes(findings) == codes(ref_findings)


# ---------------------------------------------------------------------------
# conformance replay
# ---------------------------------------------------------------------------

def _stream(m):
    return ((m.EVT_PUBLISH, 0, 0), (m.EVT_DEP_DEC, 1, 1), (m.EVT_PUBLISH, 1, 0),
            (m.EVT_RETIRE, 0, 1), (m.EVT_RETIRE, 1, 1))


@pytest.mark.parametrize("doctor, what", [
    (lambda s: s, "faithful"),
    (lambda s: s[:-1], "dropped final retire"),
    (lambda s: s + (s[-1],), "duplicated retire"),
    (lambda s: s[1:], "publish lost"),
    (lambda s: (s[0], s[2]) + s[1:], "publish before ready dep-dec"),
    (lambda s: s, "engine says quiesced=False"),
])
def test_conformance_matches_the_reference(doctor, what):
    quiesced = what != "engine says quiesced=False"
    port = ev.conformance_findings(ev.SeedDag("chain2", 2, ((0, 1),)),
                                   doctor(_stream(ev)), quiesced=quiesced)
    ref = ref_ev.conformance_findings(ref_ev.SeedDag("chain2", 2, ((0, 1),)),
                                      doctor(_stream(ref_ev)), quiesced=quiesced)
    assert codes(port) == codes(ref)
    if what == "faithful":
        assert port == []
    else:
        assert port and all(f.code == "ENG014" for f in port), what


def test_native_graph_event_api_matches_the_references():
    assert (native.NativeGraph.EVT_DEP_DEC, native.NativeGraph.EVT_PUBLISH,
            native.NativeGraph.EVT_RETIRE) == (ev.EVT_DEP_DEC, ev.EVT_PUBLISH,
                                               ev.EVT_RETIRE)


@pytest.mark.parametrize("nt, seeds", [(3, (0, 1)), (16, (0, 1, 2, 3))])
def test_native_conformance_certifies_real_pump_runs(nt, seeds):
    """Real pump loops on the port's library, the nt=16 dpotrf DAG of the
    chip's path included: no finding, and the reference's DAG shape."""
    findings, stats = _within(lambda: ev.native_conformance(nt=nt, seeds=seeds))
    assert findings == []
    n, edges, _ = ref_ev.dpotrf_dag(nt)
    assert stats["runs"] == len(seeds)
    assert (stats["tasks"], stats["edges"]) == (n, len(edges))
    # every task publishes and retires once; every edge decrements once
    assert stats["events"] == len(seeds) * (2 * n + len(edges))


# ---------------------------------------------------------------------------
# ABI contract lint
# ---------------------------------------------------------------------------

def test_port_abi_is_clean():
    lib = _within(native.build_library)
    assert abi.abi_findings(lib, native.SRC_DIR) == []
    assert abi.TRACE_RECORD == ref_abi.TRACE_RECORD
    assert abi.parse_source_record_layout() == abi.TRACE_RECORD
    exported = set(abi.elf_exported_functions(lib))
    assert set(abi.SPEC) <= exported


def _drifted_tree(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    return src, src / "graph.cpp"


def test_abi_catches_signature_drift(tmp_path):
    src, graph = _drifted_tree(tmp_path)
    body = graph.read_text()
    assert "void pz_graph_seal(void* gp)" in body
    body = body.replace("void pz_graph_seal(void* gp)",
                        "void pz_graph_seal(void* gp, int32_t hard)")
    body += '\nextern "C" {\nvoid pz_graph_rogue(void* gp) { (void)gp; }\n}\n'
    graph.write_text(body)
    findings = abi.abi_findings(None, str(src))
    assert {"ENG003", "ENG002"} <= {f.code for f in findings}
    assert any("pz_graph_seal" in f.message for f in findings if f.code == "ENG003")
    assert codes(findings) == codes(ref_abi.abi_findings(None, str(src)))


def test_abi_catches_dropped_definition(tmp_path):
    src, graph = _drifted_tree(tmp_path)
    graph.write_text(graph.read_text().replace("pz_graph_seal", "pz_graph_sea1"))
    assert "ENG004" in {f.code for f in abi.abi_findings(None, str(src))}


def test_abi_catches_record_layout_drift(tmp_path):
    src, _ = _drifted_tree(tmp_path)
    trace = src / "trace.cpp"
    trace.write_text(trace.read_text().replace("int32_t reserved;", "int64_t reserved;"))
    assert [f.code for f in abi.abi_findings(None, str(src))] == ["ENG006"]


def test_abi_flags_a_stale_library(tmp_path):
    """A library older than its sources is ENG005; one that is not an ELF
    file cannot be read (ENG001)."""
    lib = tmp_path / native.LIB_NAME
    shutil.copy(_within(native.build_library), lib)
    old = os.path.getmtime(os.path.join(native.SRC_DIR, "graph.cpp")) - 100
    os.utime(lib, (old, old))
    assert [f.code for f in abi.abi_findings(str(lib))] == ["ENG005"]
    lib.write_bytes(b"not an ELF")
    assert "ENG001" in {f.code for f in abi.abi_findings(str(lib))}


def test_required_symbols_derive_from_spec():
    assert set(abi.required_symbols()) <= set(abi.SPEC)


# ---------------------------------------------------------------------------
# clang-tidy leg and the aggregate
# ---------------------------------------------------------------------------

def test_tidy_absence_is_explicit_skip(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert [f.code for f in ev.tidy_findings()] == ["ENG021"]


def test_tidy_failure_to_run_is_explicit_skip(tmp_path):
    bogus = tmp_path / "clang-tidy"
    bogus.write_text("")  # exists but not executable
    findings = ev.tidy_findings(binary=str(bogus))
    assert findings and all(f.code == "ENG021" for f in findings)


def test_verify_engine_runs_requested_legs_only():
    findings, stats = _within(lambda: ev.verify_engine(legs=("abi", "model")))
    assert set(stats) == {"abi", "model"}
    assert findings == [] and stats["abi"] == {"symbols": len(abi.SPEC), "findings": 0}


def test_tools_engine_verify_abi_model_exits_zero(capsys):
    assert _within(lambda: tools.main(["engine-verify", "--abi", "--model"])) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out
    for dag in ev.SEED_DAGS:
        assert f"model {dag.name}:" in out


def test_tools_engine_verify_tidy_skip_is_not_fatal(capsys, monkeypatch):
    monkeypatch.setattr(ev.shutil, "which", lambda name: None)
    assert tools.main(["engine-verify", "--tidy"]) == 0
    out = capsys.readouterr().out
    assert "ENG021" in out and "1 skipped" in out
    assert tools.main(["engine-verify", "--tidy", "--strict"]) == 0


def test_tools_engine_verify_all_legs_at_the_paths_dag(capsys, monkeypatch):
    monkeypatch.setattr(ev.shutil, "which", lambda name: None)
    rc = _within(lambda: tools.main(["engine-verify", "--nt", "16"]))
    out = capsys.readouterr().out
    assert rc == 0
    assert "'tasks': 816" in out and "abi+model+conformance+tidy: 0 error(s)" in out


@pytest.mark.parametrize("mode", ["1", "strict"])
def test_abi_check_switch_on_context(mode, monkeypatch, tmp_path):
    """``PARSEC_TPU_ABI_CHECK`` certifies the engine at Context start;
    under ``strict`` a drifted spec raises before the context is up."""
    import parsec_tpu_torch
    from parsec_tpu_torch.analysis import LintError

    monkeypatch.setenv("PARSEC_TPU_ABI_CHECK", mode)
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]):
        pass
    src, graph = _drifted_tree(tmp_path)
    graph.write_text(graph.read_text().replace("pz_graph_seal", "pz_graph_sea1"))
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    if mode == "strict":
        with pytest.raises(LintError, match="ABI spec"):
            parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"])
    else:
        with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]):
            pass
