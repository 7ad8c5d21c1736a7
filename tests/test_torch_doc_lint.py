"""The port's parameter-table lint (parsec_tpu_torch.analysis.doc_lint)
against the JAX package's.

The port's registered MCA parameters and ``parsec_tpu_torch/OPERATIONS.md``
are drift-free in both directions, and the reference's synthetic drift
cases (an undocumented registration, a documented ghost knob, a prose
mention, a non-parameter table) give both packages' lints the same
codes.
"""

import pytest

jax = pytest.importorskip("jax")

from parsec_tpu.analysis import doc_lint as ref_doc_lint  # noqa: E402
from parsec_tpu_torch.analysis import doc_lint  # noqa: E402


def test_shipped_tree_is_drift_free():
    assert doc_lint.doc_findings() == []


def test_registered_params_sees_the_real_registry():
    regs = doc_lint.registered_params()
    # anchors: the port's own CUDA knobs and defaults that differ
    for key in (("device", "cuda_wave_batch"), ("device", "cuda_torch_device"),
                ("runtime", "stage_depth"), ("runtime", "wb_window_mb"),
                ("sched", "rnd_seed"), ("mca", "sched")):
        assert key in regs, key
    # the port scans its own package, never the JAX package's sources
    assert all(not path.startswith("parsec_tpu/") for path in regs.values())


def test_table_lists_the_defaults_that_differ():
    """The port's defaults that differ from the reference's carry both
    values in the table (ROADMAP A, "Defaults that differ")."""
    rows, _ = doc_lint.documented_params()
    text = open(doc_lint.os.path.join(doc_lint._pkg_root(), "OPERATIONS.md")).read()
    for full, port, ref in (("runtime_stage_depth", "1", "2"),
                            ("runtime_wb_window_mb", "0", "32")):
        line = next(ln for ln in text.splitlines() if f"`{full}`" in ln)
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert cells[1:3] == [port, ref], line
    assert ("device", "cuda_wave_batch") in rows


def test_build_output_is_not_source(tmp_path):
    """Files under ``_build/`` (build output: compiled libraries, copies of
    a tree) are not scanned."""
    src, ops = _tree(tmp_path, 'mca_param.register("runtime", "alpha", 1)\n', _DOC_OK)
    build = tmp_path / "src" / "_build" / "tree"
    build.mkdir(parents=True)
    (build / "copy.py").write_text('mca_param.register("runtime", "ghost", 0)\n')
    assert doc_lint.doc_findings(src, ops) == []


def _tree(tmp_path, source, doc):
    src = tmp_path / "src"
    src.mkdir()
    (src / "knobs.py").write_text(source)
    ops = tmp_path / "OPERATIONS.md"
    ops.write_text(doc)
    return str(src), str(ops)


_DOC_OK = """\
| param | default | meaning |
|---|---|---|
| `runtime_alpha` | 1 | documented knob |
"""

DRIFT = {
    "undocumented_registration": (
        'mca_param.register("runtime", "alpha", 1)\n'
        'mca_param.register("runtime", "ghost", 0, help="undocumented")\n',
        _DOC_OK, ["DOC001"], "runtime_ghost"),
    "bare_name_prose_mention": (
        'mca_param.register("runtime", "beta", 2)\n',
        "set `beta` to taste\n", [], None),
    "documented_ghost_knob": (
        'mca_param.register("runtime", "alpha", 1)\n',
        _DOC_OK + "| `runtime_removed_knob` | 9 | no longer exists |\n",
        ["DOC002"], "runtime_removed_knob"),
    "non_mca_tables_are_ignored": (
        'mca_param.register("runtime", "alpha", 1)\n',
        _DOC_OK + "| `obs_queue_p99` | gauge | a metric, not a knob |\n",
        [], None),
}


@pytest.mark.parametrize("case", sorted(DRIFT))
def test_synthetic_drift_matches_the_reference(case, tmp_path):
    source, doc, want, named = DRIFT[case]
    src, ops = _tree(tmp_path, source, doc)
    port = doc_lint.doc_findings(src, ops)
    ref = ref_doc_lint.doc_findings(src, ops)
    assert [f.code for f in port] == [f.code for f in ref] == want
    assert [f.dep for f in port] == [f.dep for f in ref]
    if named:
        assert named in port[0].message


def test_device_knobs_are_operator_facing(tmp_path):
    """The port also holds its ``device``, ``dtd`` and ``mca`` knobs to
    the table (the CUDA module's parameters have no reference row)."""
    src, ops = _tree(tmp_path,
                     'mca_param.register("runtime", "alpha", 1)\n'
                     'mca_param.register("device", "cuda_new_knob", 0)\n',
                     _DOC_OK)
    assert [f.code for f in doc_lint.doc_findings(src, ops)] == ["DOC001"]
