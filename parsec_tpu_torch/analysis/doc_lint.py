"""MCA-parameter doc-drift lint: the port's registered params <-> its
parameter table.

The port of :mod:`parsec_tpu.analysis.doc_lint`.  Every tunable the port
registers (``mca_param.register``) is an operator-facing contract: it is
env-overridable as ``PARSEC_MCA_<framework>_<name>``, and operators read
the port's table, ``parsec_tpu_torch/OPERATIONS.md``, to learn it exists
and what its default is (several differ from the reference's).  The two
drift apart silently — a param lands without a row, or a row survives
the param's removal.

This lint closes the loop in BOTH directions, statically (a regex scan
over ``parsec_tpu_torch/**/*.py`` for ``register("<framework>",
"<name>", ...)`` call sites — no imports, so params registered by
rarely-loaded modules are still seen):

* DOC001 — a registered param of an operator framework is not
  mentioned in the table;
* DOC002 — the table documents a param (a ``framework_name`` row in an
  ``| MCA param |`` table) that no source registers.

A param counts as documented when the table backticks either its full
``framework_name`` or its bare ``name``.  The port's operator frameworks
are the reference's plus ``device`` (the CUDA module's knobs), ``dtd``
and ``mca`` (the scheduler selection).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set, Tuple

from .findings import Finding

#: frameworks whose params are operator-facing contracts; params
#: registered under other frameworks (e.g. test-local ones) are exempt
FRAMEWORKS = ("runtime", "sched", "serve", "comm", "coll", "profiling",
              "device", "dtd", "mca")

#: ``register("fw", "name"`` — module alias, method, and keyword forms
_REGISTER_RE = re.compile(
    r"""\bregister\(\s*
        ['"](?P<fw>[a-z_]+)['"]\s*,\s*
        ['"](?P<name>[a-z0-9_]+)['"]""",
    re.VERBOSE | re.DOTALL)

#: a documented table row: | `runtime_fusion` | default | meaning |
_DOC_ROW_RE = re.compile(r"^\|\s*`(?P<fw>[a-z]+)_(?P<name>[a-z0-9_]+)`\s*\|",
                         re.MULTILINE)

#: any backticked token (bare-name prose mentions)
_TICKED_RE = re.compile(r"`([A-Za-z0-9_.]+)`")


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def registered_params(src_root: str = None) -> Dict[Tuple[str, str], str]:
    """Scan ``parsec_tpu_torch/**/*.py`` for register() call sites;
    returns ``(framework, name) -> relative source path`` (first site
    wins).  ``_build/`` (build output) is not source and is skipped."""
    if src_root is None:
        src_root = _pkg_root()
    out: Dict[Tuple[str, str], str] = {}
    for dirpath, dirs, files in os.walk(src_root):
        dirs[:] = [d for d in dirs if d != "_build"]
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
            for m in _REGISTER_RE.finditer(text):
                key = (m.group("fw"), m.group("name"))
                if key[0] in FRAMEWORKS:
                    out.setdefault(key, os.path.relpath(path, src_root))
    return out


def documented_params(ops_path: str = None
                      ) -> Tuple[Dict[Tuple[str, str], int], Set[str]]:
    """Parse the parameter table; returns (table rows keyed (fw, name) ->
    line number, set of every backticked token for prose mentions)."""
    if ops_path is None:
        ops_path = os.path.join(_pkg_root(), "OPERATIONS.md")
    with open(ops_path, "r", encoding="utf-8") as f:
        text = f.read()
    rows: Dict[Tuple[str, str], int] = {}
    for m in _DOC_ROW_RE.finditer(text):
        key = (m.group("fw"), m.group("name"))
        rows.setdefault(key, text.count("\n", 0, m.start()) + 1)
    ticked = set(_TICKED_RE.findall(text))
    return rows, ticked


def doc_findings(src_root: str = None, ops_path: str = None
                 ) -> List[Finding]:
    regs = registered_params(src_root)
    rows, ticked = documented_params(ops_path)
    out: List[Finding] = []
    for (fw, name), src in sorted(regs.items()):
        full = f"{fw}_{name}"
        if full not in ticked and name not in ticked:
            out.append(Finding(
                "DOC001", f"MCA param {full} (registered in {src}) is "
                "not documented in parsec_tpu_torch/OPERATIONS.md",
                dep=full))
    row_fw_ok = {(fw, name) for fw, name in regs}
    # a doc row `fw_rest` may split ambiguously (fw_a, b_c): accept it
    # when ANY registered param's full name equals the row's token
    full_names = {f"{fw}_{name}" for fw, name in regs}
    for (fw, name), line in sorted(rows.items(), key=lambda kv: kv[1]):
        if fw not in FRAMEWORKS:
            continue  # metric tables etc. share the | `...` | shape
        full = f"{fw}_{name}"
        if full not in full_names and (fw, name) not in row_fw_ok:
            out.append(Finding(
                "DOC002", f"parsec_tpu_torch/OPERATIONS.md line {line} documents MCA "
                f"param {full} but no source registers it (removed knob, "
                "or a typo in the row)",
                dep=full))
    return out
