"""Multi-process launcher for the TCP backend.

The port of :mod:`parsec_tpu.comm.launch`.  Reference analog: the ctest
harness launches "multi-node" tests as ``mpiexec -np N`` on one node
(``CMakeLists.txt:967-983``).  Here the launcher spawns N Python
processes, hands each a rank via the environment (``PARSEC_TPU_RANK``,
``PARSEC_TPU_NRANKS``, ``PARSEC_TPU_RDV``; :func:`.tcp.endpoint_from_env`
reads them), and lets them rendezvous through a shared directory; it works
unchanged across hosts when ``rendezvous_dir`` sits on a shared filesystem
or an explicit ``host:port`` peer list is given.  Each child's
``PYTHONPATH`` starts with the checkout's root, so ``import
parsec_tpu_torch`` resolves to this package.

One deadline covers the whole job, and a failed rank dooms it: the moment
one rank exits non-zero the others are killed, and :func:`launch` raises
with every failed rank's output.  Every rank's standard output and error
are drained while it runs, so a chatty rank never blocks on a full pipe.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence


def _drain(stream, sink: List[str]) -> None:
    sink.append(stream.read())
    stream.close()


def launch(
    nranks: int,
    argv: Sequence[str],
    *,
    rendezvous_dir: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    timeout: float = 300.0,
    python: Optional[str] = None,
) -> List[subprocess.CompletedProcess]:
    """Run ``python argv...`` once per rank; returns per-rank results (in
    rank order).

    Raises ``RuntimeError`` on a non-zero exit or when the job outlives
    ``timeout`` seconds, with each failing rank's stdout and the tail of
    its stderr; every rank still running is killed first.  A rendezvous
    directory the launcher made is removed after the job."""
    rdv = rendezvous_dir or tempfile.mkdtemp(prefix="parsec_tpu_rdv_")
    try:
        return _run(nranks, argv, rdv, env, timeout, python)
    finally:
        if rendezvous_dir is None:
            shutil.rmtree(rdv, ignore_errors=True)


def _run(nranks, argv, rdv, env, timeout, python):
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs, outs, errs, drains = [], [], [], []
    for r in range(nranks):
        child_env = dict(os.environ)
        prev = child_env.get("PYTHONPATH")
        child_env["PYTHONPATH"] = pkg_root + (os.pathsep + prev if prev else "")
        child_env.update(env or {})
        child_env.update({
            "PARSEC_TPU_RANK": str(r),
            "PARSEC_TPU_NRANKS": str(nranks),
            "PARSEC_TPU_RDV": rdv,
        })
        p = subprocess.Popen(
            [python or sys.executable, *argv],
            env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        procs.append(p)
        out: List[str] = []
        err: List[str] = []
        outs.append(out)
        errs.append(err)
        for stream, sink in ((p.stdout, out), (p.stderr, err)):
            t = threading.Thread(target=_drain, args=(stream, sink), daemon=True)
            t.start()
            drains.append(t)

    deadline = time.monotonic() + timeout  # one job-wide deadline, not per rank
    why: Dict[int, str] = {}
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0) and r not in why:
                why[r] = f"exit {c}"
        if all(c is not None for c in codes):
            break
        if why or time.monotonic() > deadline:
            # a failed rank dooms the collective job; reap the rest fast
            cause = ("timeout" if not why else
                     f"killed after rank {min(why)} failed")
            for r, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    why.setdefault(r, cause)
            for p in procs:
                p.wait()
            break
        time.sleep(0.02)
    for t in drains:
        t.join()
    results = [subprocess.CompletedProcess(p.args, p.returncode,
                                           "".join(outs[r]), "".join(errs[r]))
               for r, p in enumerate(procs)]
    if why:
        msgs = "\n".join(
            f"--- rank {r} ({why[r]}) ---\nstdout:\n{results[r].stdout}\n"
            f"stderr:\n{results[r].stderr[-4000:]}"
            for r in sorted(why))
        raise RuntimeError(f"{len(why)}/{nranks} ranks failed:\n{msgs}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m parsec_tpu_torch.comm.launch -n 4 app.py [args...]``
    — the ``mpiexec -np N`` analogue.  Prints each rank's output after the
    job completes, prefixed with its rank."""
    import argparse

    p = argparse.ArgumentParser(
        prog="parsec_tpu_torch.comm.launch",
        description="run a script as N communicating ranks (mpiexec analogue)")
    p.add_argument("-n", "--np", dest="nranks", type=int, required=True,
                   help="number of ranks")
    p.add_argument("--rdv", help="rendezvous directory (shared fs for "
                   "multi-host); default: a fresh temp dir")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="job-wide timeout in seconds")
    p.add_argument("argv", nargs=argparse.REMAINDER,
                   help="script and its arguments")
    args = p.parse_args(argv)
    if not args.argv:
        p.error("no script given")
    # strip only a LEADING "--" (argparse REMAINDER separator); later "--"
    # tokens belong to the launched script's own argument parsing
    cmd = args.argv[1:] if args.argv[0] == "--" else list(args.argv)
    if not cmd:
        p.error("no script given")
    try:
        results = launch(args.nranks, cmd, rendezvous_dir=args.rdv,
                         timeout=args.timeout)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    for r, res in enumerate(results):
        for line in (res.stdout or "").splitlines():
            print(f"[rank {r}] {line}")
        for line in (res.stderr or "").splitlines():
            print(f"[rank {r}] {line}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
