"""Command-line tools of the port: ``cache`` and ``autotune``.

The port of those two commands of :mod:`parsec_tpu.profiling.tools`; the
reference's other commands (the trace readers, merge, critpath, lint,
hbcheck, the serving dashboards) come with the rest of profiling and
analysis (ROADMAP A.9b) and are not registered.

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

Usage::

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="parsec_tpu_torch.profiling.tools",
        description="the port's persistent artifacts (cache) and autotuner (autotune)")
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
