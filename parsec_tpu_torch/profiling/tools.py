"""Command-line tools of the port: ``cache``, ``autotune``, ``lint`` and
``engine-verify``.

The port of those commands of :mod:`parsec_tpu.profiling.tools`; the
reference's other commands (the trace readers, merge, critpath, hbcheck,
check, the serving dashboards) come with the rest of profiling (ROADMAP
A.9b, second half) and are not registered.

* ``cache`` — ``ls`` / ``stats`` / ``purge`` / ``verify`` over the port's
  persistent artifacts: the autotuner's winners (``<root>/autotune``,
  :func:`..compile_cache.cache_root`; ``--dir`` names another root) and
  the libraries compiled into ``parsec_tpu_torch/_build/`` (``--build-dir``
  names another): the nvcc kernel library
  ``libparsec_tpu_torch_kernels_<tag>.so``, whose tag is the content
  address of its sources and flags (another tag is stale), and the g++
  engine ``libparsec_core.so`` (stale when older than a source).  A
  library that is not an ELF file, or a tuning document that does not
  parse, is corrupt.  Captured programs stay in their process
  (:mod:`..compile_cache`): none is on disk.
* ``autotune`` — the timed nb / attention-block / wave-batch searches of
  :mod:`..tuning`, on the card unless ``--device cpu``.
* ``lint`` — the ahead-of-time PTG/JDF graph verifier
  (:mod:`..analysis`) over ``.jdf`` files, ``module:callable`` builders
  and registry names; ``--all`` sweeps :mod:`..analysis.registry`, where
  the graphs that wait for another layer are reported as waiting.
* ``engine-verify`` — the native engine's ABI contract, the lifecycle
  model checker, the conformance replay of a real pump loop on the
  g++-built library, and the clang-tidy gate
  (:mod:`..analysis.engine_verify`).

Usage::

    python -m parsec_tpu_torch.profiling.tools lint --all
    python -m parsec_tpu_torch.profiling.tools engine-verify --nt 16
    python -m parsec_tpu_torch.profiling.tools cache stats
    python -m parsec_tpu_torch.profiling.tools autotune --op dpotrf_seg --n 32768 --nb 256,512,1024
    python -m parsec_tpu_torch.profiling.tools autotune --attention --n 4096
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Tuple

_ELF = b"\x7fELF"


def _artifacts(build_dir: str) -> List[Dict[str, Any]]:
    """Each compiled library in ``build_dir``: its name, path, kind
    (``kernels`` or ``engine``), size and state (``current``, ``stale`` or
    ``corrupt``)."""
    from .. import native
    from ..native import abi
    from ..ops import kernels

    try:
        names = sorted(os.listdir(build_dir))
    except OSError:
        return []
    rows = []
    for name in names:
        path = os.path.join(build_dir, name)
        if name.startswith(kernels.LIBRARY_PREFIX) and name.endswith(".so"):
            kind = "kernels"
            current = name == f"{kernels.LIBRARY_PREFIX}{kernels.library_tag()}.so"
        elif name == native.LIB_NAME:
            kind = "engine"
            current = os.path.getmtime(path) >= max(
                os.path.getmtime(os.path.join(native.SRC_DIR, s)) for s in abi.SOURCES)
        else:
            continue
        with open(path, "rb") as f:
            elf = f.read(4) == _ELF
        rows.append({"name": name, "path": path, "kind": kind,
                     "size": os.path.getsize(path),
                     "state": "current" if elf and current else "stale" if elf else "corrupt"})
    return rows


def _stores(args) -> Tuple[Any, str]:
    """(tuning store, build directory) for the CLI: the store under
    ``--dir``'s root when given, else the resolved default."""
    from .. import native, tuning

    store = (tuning.TuningStore(os.path.join(args.dir, "autotune")) if args.dir
             else tuning.default_store())
    return store, args.build_dir or native.BUILD_DIR


def _corrupt_docs(store) -> List[str]:
    """The tuning documents in ``store`` that do not read back."""
    try:
        names = sorted(os.listdir(store.dir))
    except OSError:
        return []
    return [os.path.join(store.dir, n) for n in names
            if n.endswith(".json") and store.load(n[:-5]) is None]


def _entries(n: int, what: str = "") -> str:
    return f"{n} {what}entr{'y' if n == 1 else 'ies'}"


def cmd_cache(args) -> int:
    """Inspect and maintain the persistent artifacts: compiled libraries
    and tuning winners."""
    store, build_dir = _stores(args)
    op = args.op
    if op == "ls":
        rows = _artifacts(build_dir)
        for r in rows:
            print(f"{r['name']}  {r['size']:>10}  {r['state']:<8} {r['kind']}")
        print(f"{_entries(len(rows))} in {build_dir}")
        docs = store.entries()
        for d in docs:
            print(f"{d['key']}  best={d.get('best')}  timings_s={d.get('timings_s')}")
        print(f"{_entries(len(docs), 'tuning ')} in {store.dir}")
        return 0
    if op == "stats":
        rows = _artifacts(build_dir)
        stale = sum(r["state"] == "stale" for r in rows)
        corrupt = sum(r["state"] == "corrupt" for r in rows)
        print(f"build dir:      {build_dir}")
        print(f"libraries:      {len(rows)} ({stale} stale, {corrupt} corrupt)")
        print(f"bytes:          {sum(r['size'] for r in rows)}")
        print(f"tuning store:   {store.dir}")
        print(f"tuning entries: {len(store.entries())}")
        return 0
    if op == "purge":
        gone = [r for r in _artifacts(build_dir)
                if not args.stale or r["state"] != "current"]
        for r in gone:
            os.unlink(r["path"])
        print(f"purged {len(gone)} librar{'y' if len(gone) == 1 else 'ies'}")
        if args.tuning:
            print(f"purged {_entries(store.purge(), 'tuning ')}")
        return 0
    if op == "verify":
        rows = _artifacts(build_dir)
        bad_libs = [r["path"] for r in rows if r["state"] == "corrupt"]
        bad = bad_libs + _corrupt_docs(store)
        for path in bad:
            print(f"CORRUPT {path}")
        ok = len(rows) - len(bad_libs) + len(store.entries())
        print(f"verify: {ok} ok, {len(bad)} corrupt"
              + (" (removed)" if bad and args.delete else ""))
        if args.delete:
            for path in bad:
                os.unlink(path)
        return 1 if bad else 0
    print(f"unknown cache op {op!r}", file=sys.stderr)
    return 2


def _print_doc(what: str, param: str, doc: Dict[str, Any]) -> None:
    print(f"{what} {doc['dtype']} on {doc['device_kind']}: best {param}={doc['best']}")
    for k, v in sorted(doc["timings_s"].items(), key=lambda kv: kv[1]):
        print(f"  {param}={k:>5}  {v:.3f}s")
    for k, why in doc.get("failures", {}).items():
        print(f"  {param}={k:>5}  FAILED: {why}")


def cmd_autotune(args) -> int:
    """Search nb, the attention blocks or the wave-batch minimum by timed
    short runs; the winners persist and the ops' "auto" values read
    them."""
    from .. import tuning

    cands = [int(x) for x in args.nb.split(",")] if args.nb else None
    if args.attention:
        docs = tuning.autotune_attention(args.n, dtype=args.dtype, candidates=cands,
                                         reps=args.reps, device=args.device)
        for param, doc in docs.items():
            _print_doc(f"attention S={args.n}", param, doc)
        print('persisted; the attention graphs pick the winners up via '
              'q_block="auto" / kv_block="auto"')
        return 0
    if args.wave:
        doc = tuning.autotune_wave(n=args.n, nb=cands[0] if cands else 64,
                                   dtype=args.dtype, reps=args.reps, device=args.device)
        _print_doc(f"wave search on dpotrf N={args.n}", "cuda_wave_batch", doc)
        return 0
    doc = tuning.autotune_nb(args.op, args.n, args.dtype, candidates=cands,
                             reps=args.reps, device=args.device)
    _print_doc(f"{args.op} N={args.n}", "nb", doc)
    print('persisted; ops pick it up via nb="auto"')
    return 0


def _parse_defines(defs) -> Dict[str, Any]:
    """``-D NAME=VALUE`` pairs; values are Python literals when they
    parse as one (``-D NT=4``, ``-D SHAPE='(2,2)'``), strings otherwise."""
    import ast as _ast

    out: Dict[str, Any] = {}
    for d in defs or []:
        name, eq, val = d.partition("=")
        if not eq or not name.strip():
            raise SystemExit(f"bad -D {d!r}: want NAME=VALUE")
        try:
            out[name.strip()] = _ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[name.strip()] = val
    return out


def _lint_one(target: str, overrides: Dict[str, Any], ignore):
    """Resolve one lint target -> (display name, findings, notes)."""
    import importlib

    from ..analysis import lint_jdf, synthesize_collections, verify_ptg

    notes: List[str] = []
    if target.endswith(".jdf") or os.path.isfile(target):
        from ..dsl.jdf import compile_jdf_file

        jdf = compile_jdf_file(target)
        consts = dict(jdf.ptg.constants)
        consts.update(overrides)
        consts, synth = synthesize_collections(jdf.ptg, consts)
        if synth:
            notes.append(f"synthesized collection(s): {', '.join(synth)}")
        missing = [g.name for g in jdf.ast.globals
                   if not g.has_default and g.name not in consts]
        if missing:
            notes.append(f"missing globals {missing} (pass -D NAME=VALUE): "
                         "static checks only")
            return target, lint_jdf(jdf, ignore=ignore), notes
        return target, lint_jdf(jdf, consts, ignore=ignore,
                                fusion_hints=True), notes
    if target.startswith("array:"):
        raise NotImplementedError(
            f"lint target {target}: the array front end is not ported yet "
            "(ROADMAP A.7b)")
    if ":" in target:
        from ..analysis.linter import collection_names, free_symbols

        mod_name, _, fn_name = target.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        ptg = fn() if callable(fn) else fn
        consts = dict(ptg.constants)
        consts.update(overrides)
        consts, synth = synthesize_collections(ptg, consts)
        if synth:
            notes.append(f"synthesized collection(s): {', '.join(synth)}")
        missing = sorted(free_symbols(ptg) - set(consts))
        if missing:
            # a builder PTG declares its globals only implicitly: lint
            # statically against the full referenced-symbol universe
            # instead of flagging every unsupplied scalar as unbound
            notes.append(f"missing globals {missing} (pass -D NAME=VALUE): "
                         "static checks only")
            findings = verify_ptg(
                ptg, None, level="static",
                known=free_symbols(ptg) | set(consts),
                collections=collection_names(ptg), ignore=ignore)
            return target, findings, notes
        return target, verify_ptg(ptg, consts, ignore=ignore,
                                  fusion_hints=True), notes
    from ..analysis import registry

    ptg, consts = registry.build(target)
    consts = dict(consts)
    consts.update(overrides)
    return target, verify_ptg(ptg, consts, ignore=ignore,
                              fusion_hints=True), notes


def cmd_lint(args) -> int:
    """Ahead-of-time graph verifier CLI (see parsec_tpu_torch.analysis).
    A registry graph ``--all`` adds that needs an unported layer is
    reported as waiting (its ROADMAP item) and does not fail the run; a
    target named explicitly that cannot be built fails it."""
    from ..analysis import errors_of, registry
    from ..analysis.findings import infos_of

    ignore = tuple(c for arg in (args.ignore or [])
                   for c in arg.split(",") if c)
    explicit = list(args.targets or [])
    targets = list(explicit)
    if args.all:
        targets.extend(registry.names())
        targets = list(dict.fromkeys(targets))  # explicit + --all overlap
    if not targets:
        print("lint: no targets (pass .jdf files, module:callable specs, "
              f"registry names, or --all; registry: {registry.names()})",
              file=sys.stderr)
        return 2
    overrides = _parse_defines(args.define)
    n_err = n_warn = n_info = n_wait = 0
    failed = False
    for target in targets:
        try:
            name, findings, notes = _lint_one(target, overrides, ignore)
        except NotImplementedError as e:
            if target in explicit:
                print(f"{target}: FAILED to build: {e}", file=sys.stderr)
                failed = True
            else:
                print(f"{target}: waiting: {e}")
                n_wait += 1
            continue
        except Exception as e:
            print(f"{target}: FAILED to build/parse: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            failed = True
            continue
        for note in notes:
            print(f"{name}: note: {note}")
        for f in findings:
            print(f"{name}: {f}")
        errs = len(errors_of(findings))
        infos = len(infos_of(findings))
        n_err += errs
        n_info += infos
        n_warn += len(findings) - errs - infos
        if errs == 0 and errs + infos == len(findings):
            # advisory-only graphs are still clean
            print(f"{name}: OK"
                  + (f" ({infos} advisory)" if infos else ""))
    print(f"lint: {len(targets)} graph(s), {n_err} error(s), "
          f"{n_warn} warning(s), {n_info} advisory, {n_wait} waiting")
    if failed or n_err:
        return 1
    # advisory findings (PTG060 fusion hints) NEVER fail --strict
    if args.strict and n_warn:
        return 1
    return 0


def cmd_engine_verify(args) -> int:
    """Verify the native engine: ABI contract lint, exhaustive lifecycle
    model checking, conformance replay of a real pump loop, clang-tidy
    gate (see parsec_tpu_torch.analysis.engine_verify)."""
    from ..analysis import errors_of
    from ..analysis.engine_verify import verify_engine
    from ..analysis.findings import infos_of

    legs = [leg for leg in ("abi", "model", "conformance", "tidy")
            if getattr(args, leg)]
    if args.all or not legs:
        legs = ["abi", "model", "conformance", "tidy"]
    findings, stats = verify_engine(
        legs, workers=args.workers, conformance_nt=args.nt,
        conformance_seeds=tuple(range(args.seeds)))
    for f in findings:
        print(f)
    for leg in legs:
        st = stats.get(leg)
        if leg == "model" and isinstance(st, dict):
            for dag, s in st.items():
                print(f"engine-verify: model {dag}: {s['states']} "
                      f"state(s), {s['transitions']} transition(s), "
                      f"{s['sleep_skips']} sleep-skip(s)"
                      + (" TRUNCATED" if s["truncated"] else ""))
        elif st:
            print(f"engine-verify: {leg}: {st}")
    errs = len(errors_of(findings))
    infos = len(infos_of(findings))
    print(f"engine-verify: {'+'.join(legs)}: {errs} error(s), "
          f"{len(findings) - errs - infos} warning(s), {infos} skipped")
    if errs:
        return 1
    if args.strict and len(findings) - infos:
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="parsec_tpu_torch.profiling.tools",
        description="the port's persistent artifacts (cache), autotuner "
        "(autotune), graph verifier (lint) and engine verifier (engine-verify)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser(
        "cache", help="compiled libraries and tuning winners: list, stats, purge, "
        "integrity verify (PARSEC_TPU_COMPILE_CACHE governs the tuning root)")
    pe.add_argument("op", choices=("ls", "stats", "purge", "verify"))
    pe.add_argument("--dir", help="the tuning winners under this cache root "
                    "instead of the resolved default")
    pe.add_argument("--build-dir", help="the compiled libraries in this directory "
                    "instead of parsec_tpu_torch/_build")
    pe.add_argument("--stale", action="store_true",
                    help="purge: only libraries that are stale or corrupt")
    pe.add_argument("--tuning", action="store_true",
                    help="purge: also drop the autotune winners")
    pe.add_argument("--delete", action="store_true",
                    help="verify: remove what fails validation")
    pe.set_defaults(fn=cmd_cache)
    pa = sub.add_parser(
        "autotune", help="search nb (tile size), the attention blocks or the "
        'wave-batch minimum by timed short runs; winners apply via "auto"')
    pa.add_argument("--op", default="dpotrf",
                    help="workload to tune (built-in: dpotrf, dpotrf_seg, "
                    "getrf_seg, geqrf_seg; the _seg names are the keys the "
                    'segmented drivers\' nb="auto" reads)')
    pa.add_argument("--n", type=int, default=1024, help="matrix size (sequence "
                    "length with --attention)")
    pa.add_argument("--nb", help="comma-separated candidates (default: divisors "
                    "of N from 64..1024; block sizes up to 512 with --attention)")
    pa.add_argument("--dtype", default="float32")
    pa.add_argument("--reps", type=int, default=2,
                    help="timed reps per candidate (median wins)")
    pa.add_argument("--wave", action="store_true",
                    help="search the device wave-batch minimum instead of nb")
    pa.add_argument("--attention", action="store_true",
                    help="search the attention graphs' q_block/kv_block at "
                    "sequence length --n (--nb supplies block candidates)")
    pa.add_argument("--device", default=None,
                    help="torch device to tune on (default: the current card; "
                    "'cpu' for the torch CPU device)")
    pa.set_defaults(fn=cmd_autotune)
    pl = sub.add_parser(
        "lint", help="ahead-of-time PTG/JDF graph verifier: edge "
        "reciprocity, data hazards, deadlock/liveness, expression lint "
        "— no task body executes")
    pl.add_argument("targets", nargs="*",
                    help=".jdf file, module:callable returning a PTG, or "
                    "in-repo registry name")
    pl.add_argument("-D", "--define", action="append", metavar="NAME=VALUE",
                    help="bind a graph global (Python literal or string; "
                    "repeatable); undeclared collections are synthesized")
    pl.add_argument("--all", action="store_true",
                    help="also lint every in-repo graph "
                    "(parsec_tpu_torch.analysis.registry)")
    pl.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too, not just errors")
    pl.add_argument("--ignore", action="append", metavar="CODES",
                    help="comma-separated finding codes to suppress "
                    "(e.g. PTG021 for dynamic-guard graphs)")
    pl.set_defaults(fn=cmd_lint)
    pv = sub.add_parser(
        "engine-verify", help="verify the native engine: ABI contract "
        "lint (spec vs .so exports vs C++ prototypes), exhaustive "
        "lifecycle model checking with DPOR reduction, conformance "
        "replay of a real pump loop, clang-tidy zero-warning gate "
        "(ENG0xx findings)")
    pv.add_argument("--abi", action="store_true",
                    help="ABI contract lint only")
    pv.add_argument("--model", action="store_true",
                    help="lifecycle model checker only")
    pv.add_argument("--conformance", action="store_true",
                    help="real-engine conformance replay only")
    pv.add_argument("--tidy", action="store_true",
                    help="clang-tidy gate only")
    pv.add_argument("--all", action="store_true",
                    help="every leg (the default when none is picked)")
    pv.add_argument("--workers", type=int, default=2,
                    help="model worker threads to interleave (default 2)")
    pv.add_argument("--nt", type=int, default=4,
                    help="conformance dpotrf tile count (default 4)")
    pv.add_argument("--seeds", type=int, default=4,
                    help="conformance schedule-explorer seeds (default 4)")
    pv.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too (skips exempt)")
    pv.set_defaults(fn=cmd_engine_verify)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
