"""``jdfc`` — ahead-of-time JDF → Python code generator (CLI).

The port of :mod:`parsec_tpu.dsl.jdfc`: the analogue of the reference's
``parsec_ptgpp`` compiler driver (``parsec/interfaces/ptg/ptg-compiler/
main.c:49-52``: ``parsec_ptgpp -i in.jdf -o out`` emits ``out.c``/
``out.h``).  Here the target is a Python module that reconstructs the
task-class tables through the port's PTG builder
(:mod:`parsec_tpu_torch.dsl.ptg`) — inspectable, importable, and free of
any runtime JDF parsing.  The emitted module exposes:

* ``build() -> PTG`` — the problem-size-independent PTG definition;
* ``new(**globals) -> PTGTaskpool`` — the generated constructor
  (``parsec_<name>_new`` analogue, ``jdf2c.c:4637``).

Usage::

    python -m parsec_tpu_torch.dsl.jdfc -i chain.jdf -o chain_ptg.py
    python -m parsec_tpu_torch.dsl.jdfc chain.jdf      # writes chain_ptg.py

Generation lints the compiled definition with the static graph verifier
(:mod:`parsec_tpu_torch.analysis`) first; ``--lint`` runs only the lint
and ``--strict`` makes any finding fatal.
"""

from __future__ import annotations

import argparse
import re
import sys
import textwrap
from typing import List

from .jdf import _MODES, JDFAst, JDFTaskClass, compile_jdf
from .ptg import CTL

_MODE_NAMES = {"RW": "INOUT", "INOUT": "INOUT", "READ": "IN", "IN": "IN",
               "WRITE": "OUT", "OUT": "OUT", "CTL": "CTL"}


def _body_fn_name(tc: JDFTaskClass, device: str) -> str:
    return f"_{tc.name}_{device}_body"


from .jdf import scalar_globals_for as _tc_globals  # shared shadowing rule


def _emit_body(tc: JDFTaskClass, body, device: str, tc_globals) -> str:
    args = [f.name for f in tc.flows if _MODES[f.mode] != CTL]
    args += [n for n, _ in tc.decls]
    args += list(tc_globals)  # prefiltered by _tc_globals
    from .jdf import uses_this_task

    if device == "cpu" and uses_this_task(body.code):
        args.append("this_task")
    code = textwrap.indent(body.code.strip("\n") or "pass", "    ")
    return f"def {_body_fn_name(tc, device)}({', '.join(args)}):\n{code}\n"


def generate(text: str, name: str, source: str = "<jdf>", *,
             lint: bool = True, strict: bool = False) -> str:
    """JDF source text → Python module source.

    ``lint`` (default on) runs the static graph verifier
    (:mod:`parsec_tpu_torch.analysis`) over the compiled definition — the
    ``jdf_sanity_checks`` analogue of the reference compiler — printing
    findings to stderr; ``strict`` turns any finding into a
    :class:`parsec_tpu_torch.analysis.LintError` instead of emitting
    code."""
    # validate by fully compiling (prologue exec + builder lowering): the
    # generated module should never be the first place an error surfaces
    jdf = compile_jdf(text, name)
    if lint:
        from ..analysis import lint_jdf
        from ..analysis.findings import LintError

        findings = lint_jdf(jdf)
        for f in findings:
            print(f"{source}: {f}", file=sys.stderr)
        if strict and findings:
            raise LintError(
                f"{source}: {len(findings)} lint finding(s) under --strict",
                findings)
    ast: JDFAst = jdf.ast

    out: List[str] = []
    w = out.append
    w(f'"""Generated by parsec_tpu_torch.dsl.jdfc from {source} — edit the'
      ' .jdf, not this file."""')
    w("")
    w("from parsec_tpu_torch.dsl.ptg import PTG, IN, OUT, INOUT, CTL")
    w("")
    if ast.prologues:
        w("# ---- JDF prologue blocks ----")
        for chunk in ast.prologues:
            w(chunk.strip("\n"))
            w("")
    w("_EXCLUDE = {'PTG', 'IN', 'OUT', 'INOUT', 'CTL', 'build', 'new'}")
    w("")
    w("")
    w("def _prologue_ns():")
    w("    return {k: v for k, v in globals().items()")
    w("            if not k.startswith('_') and k not in _EXCLUDE}")
    w("")
    w("")
    w("# ---- BODY incarnations ----")
    scalar_globals = [g.name for g in ast.globals
                      if not g.is_collection]
    body_refs = {}
    for tc in ast.classes:
        tc_globals = _tc_globals(tc, scalar_globals)
        for b in tc.bodies:
            dev = b.device
            body_refs[(tc.name, dev)] = _body_fn_name(tc, dev)
            w("")
            w(_emit_body(tc, b, dev, tc_globals))
    w("")
    w("def build():")
    w(f"    ptg = PTG({ast.name!r})")
    w("    ptg.constants.update(_prologue_ns())")
    for opt, val in ast.options.items():
        w(f"    # %option {opt} = {val}")
    for g in ast.globals:
        if g.has_default:
            # defaults may reference prologue names and earlier globals'
            # defaults: evaluate against the accumulating constants dict
            # (matching JDF._lower)
            w(f"    ptg.constants.setdefault({g.name!r}, "
              f"eval({g.props['default']!r}, dict(ptg.constants)))")
    for tc in ast.classes:
        v = f"_{tc.name}"
        w(f"    {v} = ptg.task_class({tc.name!r})")
        if tc.props:
            w(f"    {v}.properties.update({tc.props!r})")
        params = set(tc.params)
        for dname, dexpr in tc.decls:
            meth = "param" if dname in params else "define"
            w(f"    {v}.{meth}({dname!r}, {dexpr!r})")
        tc_globals = _tc_globals(tc, scalar_globals)
        if tc_globals:
            w(f"    {v}.use_globals(*{tc_globals!r})")
        if tc.partitioning:
            w(f"    {v}.affinity({tc.partitioning!r})")
        for f in tc.flows:
            deps = ", ".join(repr(d) for d in f.deps)
            sep = ", " if deps else ""
            w(f"    {v}.flow({f.name!r}, {_MODE_NAMES[f.mode]}{sep}{deps})")
        if tc.priority:
            w(f"    {v}.priority({tc.priority!r})")
        elif tc.props.get("high_priority", "").lower() in ("on", "yes", "true", "1"):
            w(f"    {v}.priority('{1 << 20}')  # [ high_priority = on ]")
        kw = ", ".join(
            f"{dev}={fn}" for (cn, dev), fn in body_refs.items() if cn == tc.name)
        w(f"    {v}.body({kw})")
    w("    return ptg")
    w("")
    w("")
    required = [g.name for g in ast.globals if not g.has_default]
    w("def new(**globals_):")
    w(f"    _required = {required!r}")
    w("    ptg = build()")
    w("    missing = [n for n in _required")
    w("               if n not in globals_ and n not in ptg.constants]")
    w("    if missing:")
    w(f"        raise TypeError(f'{ast.name}.new(): missing globals {{missing}}')")
    w("    return ptg.taskpool(**globals_)")
    w("")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="jdfc", description="JDF → Python PTG module compiler "
        "(parsec_ptgpp analogue)")
    p.add_argument("input", nargs="?", help="input .jdf file")
    p.add_argument("-i", "--in", dest="input_flag", help="input .jdf file")
    p.add_argument("-o", "--out", help="output .py path (default: <stem>_ptg.py)")
    p.add_argument("--check", action="store_true",
                   help="parse + compile only, emit nothing")
    p.add_argument("--lint", action="store_true",
                   help="parse + compile + static graph verification only, "
                   "emit nothing (findings to stderr)")
    p.add_argument("--strict", action="store_true",
                   help="treat lint findings as fatal (non-zero exit, no "
                   "module emitted)")
    args = p.parse_args(argv)
    path = args.input_flag or args.input
    if not path:
        p.error("no input file")
    from ..analysis.findings import LintError, errors_of

    try:
        with open(path) as f:
            text = f.read()
        stem = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        name = re.sub(r"\W", "_", stem)
        if args.check:
            compile_jdf(text, name)
            print(f"{path}: OK")
            return 0
        if args.lint:
            from ..analysis import lint_jdf

            findings = lint_jdf(compile_jdf(text, name))
            for fi in findings:
                print(f"{path}: {fi}", file=sys.stderr)
            if errors_of(findings) or (args.strict and findings):
                return 1
            print(f"{path}: OK ({len(findings)} warning(s))"
                  if findings else f"{path}: OK")
            return 0
        src = generate(text, name, source=path, strict=args.strict)
        out_path = args.out or f"{stem}_ptg.py"
        with open(out_path, "w") as f:
            f.write(src)
    except LintError:
        return 1  # findings already printed by generate()
    except OSError as e:
        print(f"jdfc: {e}", file=sys.stderr)
        return 1
    except (ValueError, SyntaxError) as e:
        # JDFSyntaxError (a ValueError) from the parser, SyntaxError from
        # prologue/BODY compilation: a compiler CLI reports diagnostics
        # and exits non-zero — it never dumps a traceback on bad input
        print(f"jdfc: {path}: {e}", file=sys.stderr)
        return 1
    print(f"{path} -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
