"""Command-line tools of the port: the offline trace readers and
analyses, the graph and engine verifiers, the aggregate gate, the program
cache and the autotuner.

The port of :mod:`parsec_tpu.profiling.tools` (reference role: the C
readers of ``tools/profiling/`` — ``dbpreader.c``, ``dbpinfos.c`` — and
the ``pbt2ptt``/``profile2h5`` stack).  Trace inputs are binary ``.pbt``
dumps of :class:`~.binary.RankTraceSet` (detected by their magic) or
Chrome/Perfetto JSON.

* ``info``    — summary a la ``dbpinfos``: ranks, threads, dictionary,
  event counts/durations per class;
* ``to-csv``  — flatten spans to CSV;
* ``merge``   — stitch per-rank ``.pbt`` dumps into ONE clock-aligned
  Chrome/Perfetto trace, one process track per rank (:mod:`.merge`);
* ``critpath`` — reconstruct the task-dependency critical path from a
  trace and attribute its wall time to compute / comm / coll / compile /
  transfer / host-gap buckets per task class (:mod:`.critpath`);
* ``hbcheck`` — vector-clock happens-before race detection over ``.pbt``
  dumps (:mod:`..analysis.hb`);
* ``check`` — the aggregate gate: graph lint over every registered
  graph, the ABI contract, the lifecycle model, the MCA doc-drift lint,
  clang-tidy, and hbcheck over ``--hbcheck`` dumps: one table, one exit
  code;
* ``lint`` — the ahead-of-time PTG/JDF graph verifier
  (:mod:`..analysis`) over ``.jdf`` files, ``module:callable`` builders
  and registry names; ``--all`` sweeps :mod:`..analysis.registry`, where
  the graphs that wait for another layer are reported as waiting;
* ``engine-verify`` — the native engine's ABI contract, the lifecycle
  model checker, the conformance replay of a real pump loop on the
  g++-built library, and the clang-tidy gate
  (:mod:`..analysis.engine_verify`);
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
  (:mod:`..compile_cache`): none is on disk;
* ``autotune`` — the timed nb / attention-block / wave-batch searches of
  :mod:`..tuning`, on the card unless ``--device cpu``.

``check-comms`` is registered and raises: the comm-protocol events it
counts come with the comm layer (ROADMAP A.8).  The live planes:

* ``flightdump`` — snapshot the flight recorder through a live health
  endpoint's ``/flightdump`` (or the recorders of this process into a
  directory);
* ``serve-status`` — the per-tenant serving table of a live ``/status``;
* ``top`` — the live terminal dashboard (:mod:`.top`) over ``/status``.

Usage::

    python -m parsec_tpu_torch.profiling.tools info trace/rank0.pbt
    python -m parsec_tpu_torch.profiling.tools to-csv trace/rank0.pbt -o spans.csv
    python -m parsec_tpu_torch.profiling.tools merge trace/rank*.pbt -o merged.json
    python -m parsec_tpu_torch.profiling.tools critpath trace/rank0.pbt
    python -m parsec_tpu_torch.profiling.tools hbcheck trace/rank0.pbt
    python -m parsec_tpu_torch.profiling.tools check --hbcheck trace/rank0.pbt
    python -m parsec_tpu_torch.profiling.tools lint --all
    python -m parsec_tpu_torch.profiling.tools engine-verify --nt 16
    python -m parsec_tpu_torch.profiling.tools cache stats
    python -m parsec_tpu_torch.profiling.tools autotune --op dpotrf_seg --n 32768 --nb 256,512,1024
    python -m parsec_tpu_torch.profiling.tools autotune --attention --n 4096
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
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


def load(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        head = f.read(8)
    if head == b"PBTRACE1":  # native binary trace (profiling/binary.py)
        from .binary import to_chrome_events

        return {"traceEvents": to_chrome_events(path), "metadata": {}}
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, list):  # bare event array is also legal Chrome JSON
        doc = {"traceEvents": doc, "metadata": {}}
    return doc


def _spans(events: List[dict]) -> List[dict]:
    from .trace import iter_spans

    return iter_spans(events)


def comm_overlap_fraction(events: List[dict], *, exec_name: str = "exec",
                          comm_names=("comm_recv", "comm_send")):
    """Comm/compute overlap from trace timestamps (the reference's
    stencil overlap study, ``tests/apps/stencil/testing_stencil_1D.c`` —
    overlap % is the headline metric of BASELINE.json's 64-chip config).

    Exec busy time is the union of ``exec_name`` begin/end spans across
    all streams; comm events (instants stamped at activation/payload
    send/receive) that land INSIDE that union were serviced while
    compute was running — i.e. their latency was hidden.  Returns
    ``(overlap_fraction, n_comm_events, busy_us)``."""
    open_: Dict[Any, float] = {}
    intervals: List[tuple] = []
    comm_ts: List[float] = []
    for e in events:
        name, ph = e.get("name"), e.get("ph")
        if name == exec_name:
            key = (e.get("pid"), e.get("tid"),
                   e.get("args", {}).get("event_id"))
            if ph == "B":
                open_[key] = e["ts"]
            elif ph == "E":
                t0 = open_.pop(key, None)
                if t0 is not None:
                    intervals.append((t0, e["ts"]))
        elif name in comm_names and ph == "i":
            comm_ts.append(e["ts"])
    # merge the busy intervals
    intervals.sort()
    merged: List[List[float]] = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    if not comm_ts:
        return 0.0, 0, busy
    import bisect

    starts = [a for a, _ in merged]
    ends = [b for _, b in merged]
    inside = 0
    for t in comm_ts:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ends[i]:
            inside += 1
    return inside / len(comm_ts), len(comm_ts), busy


def per_rank_overlap(events: List[dict], *, exec_name: str = "exec",
                     comm_names=("comm_recv", "comm_send")
                     ) -> Dict[Any, tuple]:
    """Per-rank view of :func:`comm_overlap_fraction` over a MERGED
    trace: group events by ``pid`` (one process track per rank, the
    ``profiling.merge`` convention) and compute each rank's overlap
    against its OWN exec spans.  Returns ``{pid: (fraction, n_comm,
    busy_us)}`` — the non-tautological replacement for unioning every
    rank's compute (round-5 VERDICT weak #2)."""
    by_pid: Dict[Any, List[dict]] = defaultdict(list)
    for e in events:
        by_pid[e.get("pid")].append(e)
    return {pid: comm_overlap_fraction(evs, exec_name=exec_name,
                                       comm_names=comm_names)
            for pid, evs in sorted(by_pid.items(), key=lambda kv: str(kv[0]))}


def cmd_info(args) -> int:
    doc = load(args.trace)
    evs = doc.get("traceEvents", [])
    spans = _spans(evs)
    pids = sorted({e.get("pid") for e in evs}, key=str)
    tids = sorted({str(e.get("tid")) for e in evs})
    print(f"trace: {args.trace}")
    print(f"ranks (pids): {len(pids)} {pids}")
    print(f"streams (tids): {len(tids)}")
    dictionary = doc.get("metadata", {}).get("dictionary", {})
    if dictionary:
        print(f"dictionary: {', '.join(sorted(dictionary))}")
    per: Dict[str, List[float]] = defaultdict(list)
    for s in spans:
        per[s["name"]].append(s["dur_us"])
    print(f"{'event class':<24}{'count':>8}{'total_ms':>12}{'avg_us':>10}"
          f"{'p50_us':>10}{'p95_us':>10}{'max_us':>10}")
    for name in sorted(per):
        durs = sorted(per[name])
        total = sum(durs)
        n = len(durs)
        # nearest-rank percentiles: index ceil(q*n) - 1
        p50 = durs[max(0, -(-n * 50 // 100) - 1)]
        p95 = durs[max(0, -(-n * 95 // 100) - 1)]
        print(f"{name:<24}{n:>8}{total/1e3:>12.3f}{total/n:>10.1f}"
              f"{p50:>10.1f}{p95:>10.1f}{durs[-1]:>10.1f}")
    return 0


def cmd_to_csv(args) -> int:
    import csv

    doc = load(args.trace)
    spans = _spans(doc.get("traceEvents", []))
    arg_keys = sorted({k for s in spans for k in s["args"]})
    cols = ["name", "pid", "tid", "begin_us", "end_us", "dur_us"] + arg_keys
    out = open(args.out, "w", newline="") if args.out else sys.stdout
    try:
        w = csv.writer(out)
        w.writerow(cols)
        for s in spans:
            w.writerow([s[c] for c in cols[:6]] +
                       [s["args"].get(k, "") for k in arg_keys])
    finally:
        if args.out:
            out.close()
    if args.out:
        print(f"{len(spans)} spans -> {args.out}")
    return 0


def cmd_check_comms(args) -> int:
    """The comm-protocol validator (reference ``check-comms.py``): its
    MPI_ACTIVATE / MPI_DATA_CTL / MPI_DATA_PLD events come with the comm
    layer."""
    raise NotImplementedError(
        "check-comms counts comm-protocol events, which the comm layer "
        "records; it is not ported yet (ROADMAP A.8)")


def cmd_merge(args) -> int:
    from .merge import merge_traces

    doc = merge_traces(args.traces, out=args.out)
    meta = doc["metadata"]
    n_events = len(doc["traceEvents"])
    dest = args.out or "(not written; pass -o)"
    print(f"{len(args.traces)} trace(s), {len(meta['ranks'])} rank "
          f"track(s) {meta['ranks']}, {n_events} events, "
          f"aligned={meta['aligned']} -> {dest}")
    if args.overlap:
        for pid, (frac, n, busy) in per_rank_overlap(
                doc["traceEvents"]).items():
            if n:
                print(f"  rank {pid}: overlap {frac:.2f} "
                      f"({n} comm events, busy {busy / 1e3:.1f} ms)")
    return 0


def cmd_critpath(args) -> int:
    from . import critpath

    doc = load(args.trace)
    report = critpath.analyze(doc.get("traceEvents", []),
                              exec_name=args.exec_name,
                              job=args.job or None)
    if args.json:
        print(json.dumps(report))
    else:
        print(critpath.render(report))
    return 0 if report["n_tasks"] else 1


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
        # canonical array-front-end programs (parsec_tpu_torch.array): lint
        # the GENERATED graph exactly as lower() emits it
        from ..array import canonical_program

        prog = canonical_program(target.partition(":")[2] or "mixed")
        consts = prog.constants
        consts.update(overrides)
        return target, verify_ptg(prog.ptg, consts, ignore=ignore,
                                  fusion_hints=True), notes
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


def cmd_hbcheck(args) -> int:
    """Happens-before race check over binary trace dump(s)
    (see parsec_tpu.analysis.hb; live flavor: PARSEC_TPU_HBCHECK=1)."""
    from ..analysis import errors_of
    from ..analysis.hb import analyze_events, events_from_trace

    events = events_from_trace(args.traces)
    if not events:
        print("hbcheck: no happens-before events in "
              f"{args.traces} (record with a RankTraceSet, or set "
              "PARSEC_TPU_HBCHECK=1 for the live checker)",
              file=sys.stderr)
        return 2
    findings = analyze_events(events)
    for f in findings:
        print(f)
    errs = len(errors_of(findings))
    print(f"hbcheck: {len(events)} event(s), {errs} race(s), "
          f"{len(findings) - errs} warning(s)")
    if errs:
        return 1
    if args.strict and findings:
        return 1
    return 0


def cmd_check(args) -> int:
    """One-shot aggregate gate: graph lint over every registered PTG,
    the ABI contract lint, the lifecycle model checker, the MCA
    doc-drift lint, and clang-tidy when present — one summary table,
    one exit code."""
    import types as _types

    from ..analysis import errors_of
    from ..analysis.doc_lint import doc_findings
    from ..analysis.engine_verify import verify_engine
    from ..analysis.findings import infos_of

    rows = []  # (section, errors, warnings, skipped)

    def _run(section, fn):
        try:
            findings = fn()
        except Exception as e:  # a crashed checker is a failed gate
            print(f"check: {section}: FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            rows.append((section, 1, 0, 0))
            return
        for f in findings:
            print(f"{section}: {f}")
        errs = len(errors_of(findings))
        infos = len(infos_of(findings))
        rows.append((section, errs, len(findings) - errs - infos, infos))

    lint_args = _types.SimpleNamespace(targets=[], all=True, strict=False,
                                       ignore=args.ignore, define=None)
    rc_lint = cmd_lint(lint_args)
    rows.append(("graph-lint", 1 if rc_lint else 0, 0, 0))
    _run("abi", lambda: verify_engine(("abi",))[0])
    _run("model", lambda: verify_engine(
        ("model",), workers=args.workers)[0])
    _run("doc-drift", doc_findings)
    _run("tidy", lambda: verify_engine(("tidy",))[0])
    if args.hbcheck:
        hb_args = _types.SimpleNamespace(traces=args.hbcheck, strict=False)
        rc_hb = cmd_hbcheck(hb_args)
        rows.append(("hbcheck", 1 if rc_hb == 1 else 0, 0, 0))

    width = max(len(r[0]) for r in rows)
    print(f"\n{'section'.ljust(width)}  errors  warnings  skipped  verdict")
    n_err = 0
    for section, errs, warns, infos in rows:
        n_err += errs
        verdict = "FAIL" if errs else ("skip" if infos and not warns
                                       else "ok")
        print(f"{section.ljust(width)}  {errs:6d}  {warns:8d}  "
              f"{infos:7d}  {verdict}")
    print(f"check: {len(rows)} section(s), {n_err} error(s)")
    return 1 if n_err else 0


def cmd_flightdump(args) -> int:
    """Trigger + collect a flight-recorder snapshot.

    ``target`` is either the base URL of a live health endpoint (the
    server process writes ``rank<r>.fr.pbt`` files and reports their
    paths) or, for embedded use, an output DIRECTORY — in which case the
    recorders installed in THIS process are dumped."""
    import os

    target = args.target
    out_dir = args.out
    if target.startswith(("http://", "https://")):
        import json as _json
        import urllib.error
        import urllib.parse
        import urllib.request

        url = target.rstrip("/") + "/flightdump"
        if out_dir:
            url += "?" + urllib.parse.urlencode(
                {"dir": os.path.abspath(out_dir)})
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                doc = _json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            print(f"flightdump: {e.code} from {url}: {body}",
                  file=sys.stderr)
            return 1
        except OSError as e:
            print(f"flightdump: cannot reach {url}: {e}", file=sys.stderr)
            return 1
        paths = doc.get("paths", [])
        for p in paths:
            print(p)
        print(f"flightdump: {len(paths)} snapshot(s) "
              f"(load with: tools merge/critpath/hbcheck)")
        return 0 if paths else 1
    from . import flight

    if not flight.installed():
        print("flightdump: no flight recorder installed in this process "
              "(set PARSEC_TPU_FLIGHT=1, or pass a live health endpoint "
              "URL)", file=sys.stderr)
        return 1
    paths = flight.dump_all(out_dir or target, reason="tools flightdump")
    for p in paths:
        print(p)
    return 0 if paths else 1


def cmd_serve_status(args) -> int:
    """Render the per-tenant serving table of a live ``/status``
    endpoint (the ``serve`` section ``serve.RuntimeService`` exports)."""
    import json as _json
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/") + "/status"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            doc = _json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        print(f"serve-status: {e.code} from {url}", file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"serve-status: cannot read {url}: {e}", file=sys.stderr)
        return 1
    sv = doc.get("serve")
    if not sv:
        print(f"serve-status: rank {doc.get('rank')} at {args.url} has "
              "no serving plane attached (not a RuntimeService context)",
              file=sys.stderr)
        return 1
    j = sv["jobs"]
    print(f"rank {doc.get('rank')} serve: scheduler={sv['scheduler']} "
          f"fairness={'on' if sv['fairness'] else 'off'}"
          f"{' CLOSING' if sv['closing'] else ''}")
    lim = sv["limits"]
    print(f"  limits: inflight<={lim['max_inflight_pools']} "
          f"backlog<={lim['max_ready_backlog']} "
          f"arena<={lim['arena_budget'] or 'inf'} "
          f"queue<={lim['max_queued']}")
    print(f"  jobs: {j['inflight']} in flight, {j['queued']} queued, "
          f"{j['done']} done, {j['failed']} failed, "
          f"{j['cancelled']} cancelled, {j['rejected']} rejected, "
          f"{j['expired']} expired")
    hdr = (f"  {'tenant':<16}{'w':>3}{'run':>5}{'queue':>6}{'done':>6}"
           f"{'fail':>5}{'rej':>5}{'retired':>9}{'tasks/s':>9}"
           f"{'eta_s':>7}")
    print(hdr)
    import math as _math

    for name in sorted(sv["tenants"]):
        t = sv["tenants"][name]
        # unknown ETA (no rate yet, or a non-finite extrapolation from a
        # 0-rate window) renders as "--", never "inf"
        eta = ("--" if t["eta_s"] is None
               or not _math.isfinite(float(t["eta_s"]))
               else f"{float(t['eta_s']):.1f}")
        print(f"  {name:<16}{t['weight']:>3}{t['inflight']:>5}"
              f"{t['queued']:>6}{t['completed']:>6}{t['failed']:>5}"
              f"{t['rejected']:>5}{t['retired']:>9}"
              f"{t['rate_tasks_per_s']:>9.1f}{eta:>7}")
    return 0


def cmd_top(args) -> int:
    """Live terminal dashboard over one or more /status endpoints
    (see :mod:`.top`; the live counterpart of one-shot serve-status)."""
    from .top import run_top

    return run_top(args.urls, interval=args.interval, once=args.once,
                   max_updates=args.max_updates)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="parsec_tpu_torch.profiling.tools",
        description="offline trace tools, graph and engine verifiers, the "
        "aggregate gate, the program cache and the autotuner")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("info", help="trace summary (dbpinfos analogue)")
    pi.add_argument("trace")
    pi.set_defaults(fn=cmd_info)
    pc = sub.add_parser("to-csv", help="flatten spans to CSV")
    pc.add_argument("trace")
    pc.add_argument("-o", "--out")
    pc.set_defaults(fn=cmd_to_csv)
    pk = sub.add_parser("check-comms", help="comm protocol validator "
                        "(needs the comm layer, ROADMAP A.8)")
    pk.add_argument("trace")
    pk.add_argument("--expect", action="append",
                    help="NAME:nb=N or NAME:lensum=BYTES")
    pk.set_defaults(fn=cmd_check_comms)
    pm = sub.add_parser(
        "merge", help="merge per-rank .pbt/.json traces into one "
        "clock-aligned Chrome trace (one track per rank)")
    pm.add_argument("traces", nargs="+",
                    help="per-rank trace files (rank0.pbt rank1.pbt ...)")
    pm.add_argument("-o", "--out", help="merged Chrome JSON output path")
    pm.add_argument("--overlap", action="store_true",
                    help="also print per-rank comm/compute overlap")
    pm.set_defaults(fn=cmd_merge)
    pp = sub.add_parser(
        "critpath", help="critical-path report: attribute wall time to "
        "compute / comm / host-gap per task class")
    pp.add_argument("trace", help="trace with dep_edge events "
                    "(a RankTraceSet dump or a merge output)")
    pp.add_argument("--exec-name", default="exec",
                    help="span name of task execution (default: exec)")
    pp.add_argument("--json", action="store_true",
                    help="emit the raw report as JSON")
    pp.add_argument("--job", default=None,
                    help="slice to ONE job by trace id (hex16, as shown "
                    "by tools merge): only that "
                    "job's tasks enter the chain walk, and the report "
                    "gains a queue/admit/run/drain phase attribution")
    pp.set_defaults(fn=cmd_critpath)
    ph = sub.add_parser(
        "hbcheck", help="happens-before race check over binary .pbt "
        "trace dumps: unordered tile-version writes, arena "
        "double-recycles, late dep releases, double completions "
        "(RTxxx findings; static counterpart: lint)")
    ph.add_argument("traces", nargs="+",
                    help=".pbt dumps (one per rank: rank0.pbt rank1.pbt "
                    "... of one run)")
    ph.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too, not just races")
    ph.set_defaults(fn=cmd_hbcheck)
    pg = sub.add_parser(
        "check", help="aggregate verification gate: graph lint --all + "
        "ABI lint + lifecycle model checker + MCA doc-drift lint + "
        "clang-tidy if present (+ hbcheck over traces you pass); one "
        "summary table, one exit code")
    pg.add_argument("--hbcheck", nargs="+", metavar="TRACE",
                    help="also run the happens-before checker over "
                    "these .pbt dumps")
    pg.add_argument("--workers", type=int, default=2,
                    help="model worker threads to interleave (default 2)")
    pg.add_argument("--ignore", action="append", metavar="CODES",
                    help="comma-separated graph-lint finding codes to "
                    "suppress")
    pg.set_defaults(fn=cmd_check)
    pf = sub.add_parser(
        "flightdump", help="snapshot a live mesh's flight recorder "
        "(rank<r>.fr.pbt per rank): pass a health endpoint URL "
        "(PARSEC_TPU_HEALTH=1 in the app) or an output directory for "
        "in-process recorders")
    pf.add_argument("target",
                    help="http://host:port of a live health endpoint, or "
                    "an output directory (in-process mode)")
    pf.add_argument("-o", "--out",
                    help="directory the snapshots land in (URL mode: the "
                    "SERVER process writes there; default: its cwd or "
                    "PARSEC_TPU_FLIGHT_DIR)")
    pf.set_defaults(fn=cmd_flightdump)
    ps = sub.add_parser(
        "serve-status", help="per-tenant serving table of a live "
        "RuntimeService mesh: jobs in flight/queued/done, retired "
        "tasks, rates and ETAs per tenant (reads /status of a "
        "PARSEC_TPU_HEALTH endpoint)")
    ps.add_argument("url", help="http://host:port of a live health "
                    "endpoint whose context carries a RuntimeService")
    ps.set_defaults(fn=cmd_serve_status)
    pt = sub.add_parser(
        "top", help="live terminal dashboard (curses-free) over one or "
        "more /status endpoints: tenants, in-flight jobs with phase + "
        "ETA + trace id, per-rank straggler flags, SLO histogram "
        "sparklines — refreshed in place")
    pt.add_argument("urls", nargs="+",
                    help="http://host:port of live health endpoints "
                    "(one per rank, or just rank 0's)")
    pt.add_argument("--interval", type=float, default=1.0,
                    help="refresh period in seconds (default 1.0)")
    pt.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clear)")
    pt.add_argument("--max-updates", type=int, default=0,
                    help="stop after N refreshes (0 = forever)")
    pt.set_defaults(fn=cmd_top)
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
