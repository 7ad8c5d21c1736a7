"""Live runtime monitor (CLI) — reference ``tools/aggregator_visu``.

The port of :mod:`parsec_tpu.profiling.monitor`.

The reference ships a Python GUI that polls runtime properties exported
through a shared-memory dictionary.  Two sources serve that role here:

* a JSONL file streamed by the :class:`~parsec_tpu_torch.profiling.dictionary.
  Aggregator` from inside the running application (tailed incrementally;
  truncation/rotation of the file is detected and the tail reopens from
  the start);
* the HTTP ``/status`` endpoint of a live
  :class:`~parsec_tpu_torch.profiling.health.HealthServer` — pass an
  ``http://host:port`` URL instead of a path and the monitor polls the
  health plane directly (no file needed).

Usage::

    # in the app
    from parsec_tpu_torch.profiling import dictionary
    dictionary.register_context(ctx)
    agg = dictionary.Aggregator(interval=0.25, path="live.jsonl").start()

    # in another terminal
    python -m parsec_tpu_torch.profiling.monitor live.jsonl --follow
    # or against the live health endpoint (PARSEC_TPU_HEALTH=1)
    python -m parsec_tpu_torch.profiling.monitor http://127.0.0.1:8471 --follow
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional


def read_samples(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail write of a live file
    return out


def render(samples: List[Dict[str, Any]], total: Optional[int] = None) -> str:
    """Latest values plus rates over the sampling window; ``total``
    overrides the displayed sample count (follow mode keeps only a
    2-sample window but tracks the running total)."""
    if not samples:
        return "(no samples)"
    last = samples[-1]
    n = total if total is not None else len(samples)
    lines = [f"sample @ t={last.get('t', 0):.3f} ({n} samples)"]
    prev = samples[-2] if len(samples) > 1 else None
    dt = (last.get("t", 0) - prev.get("t", 0)) if prev else 0.0
    for key in sorted(last):
        if key == "t":
            continue
        val = last[key]
        rate = ""
        if prev and dt > 0 and isinstance(val, (int, float)) \
                and isinstance(prev.get(key), (int, float)):
            rate = f"  ({(val - prev[key]) / dt:+.1f}/s)"
        lines.append(f"  {key:<44} = {_fmt(val)}{rate}")
    return "\n".join(lines)


def _fmt(v: Any) -> str:
    s = json.dumps(v) if isinstance(v, (dict, list)) else repr(v)
    return s if len(s) <= 60 else s[:57] + "..."


class TailReader:
    """Incremental JSONL tail with truncation/rotation handling: parse
    only appended bytes per poll; when the file SHRINKS (a logrotate
    copytruncate, or the app restarting its Aggregator) reopen from the
    start instead of silently waiting at a stale offset past EOF."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.partial = ""

    def poll(self) -> List[Dict[str, Any]]:
        """New complete samples since the last poll (may be empty).
        Never raises on file-system races: the file can vanish between
        the stat and the open mid-rotation — that is exactly a moment
        this tail exists to ride out."""
        try:
            size = os.stat(self.path).st_size
            if size < self.offset:
                # truncated/rotated: everything we knew is gone — restart
                self.offset = 0
                self.partial = ""
            with open(self.path) as f:
                f.seek(self.offset)
                chunk = f.read()
                self.offset = f.tell()
        except OSError:
            return []
        lines = (self.partial + chunk).split("\n")
        self.partial = lines.pop()  # last element: incomplete tail (or "")
        out = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return out


def _flatten(obj: Any, prefix: str, out: Dict[str, Any]) -> None:
    """Dotted-key flattening of a /status document into a render()-able
    sample (numbers keep rate arithmetic; everything else displays as
    its JSON)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, list):
        if prefix.endswith("taskpools"):
            # per-taskpool progress keeps its identity in the key
            for p in obj:
                if isinstance(p, dict) and "taskpool_id" in p:
                    _flatten({k: v for k, v in p.items()
                              if k not in ("taskpool_id", "name")},
                             f"{prefix}[{p['taskpool_id']}:{p.get('name')}]",
                             out)
                else:
                    out[prefix] = obj
                    return
        else:
            out[prefix] = obj
    else:
        out[prefix] = obj


def poll_status(url: str, timeout: float = 5.0) -> Dict[str, Any]:
    """One sample from a health endpoint's ``/status`` (flattened)."""
    import urllib.request

    base = url.rstrip("/")
    if not base.endswith("/status"):
        base += "/status"
    with urllib.request.urlopen(base, timeout=timeout) as resp:
        doc = json.loads(resp.read().decode())
    out: Dict[str, Any] = {}
    _flatten(doc, "", out)
    out.setdefault("t", time.time())
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="parsec_tpu_torch.profiling.monitor",
        description="tail an Aggregator JSONL stream, or poll a live "
                    "health endpoint's /status (aggregator_visu role)")
    p.add_argument("path", help="JSONL file written by "
                   "dictionary.Aggregator, or an http://host:port health "
                   "endpoint (PARSEC_TPU_HEALTH=1)")
    p.add_argument("--follow", "-f", action="store_true",
                   help="keep polling and re-rendering")
    p.add_argument("--interval", type=float, default=0.5)
    p.add_argument("--max-updates", type=int, default=0,
                   help="stop after N renders in --follow mode (0 = forever)")
    args = p.parse_args(argv)
    updates = 0
    is_http = args.path.startswith(("http://", "https://"))
    tail = None if is_http else TailReader(args.path)
    count = 0
    window: List[Dict[str, Any]] = []
    warned_unreadable = False
    while True:
        if is_http:
            import http.client

            try:
                window.append(poll_status(args.path))
                count += 1
                if len(window) > 2:
                    window.pop(0)
            except (OSError, ValueError, http.client.HTTPException) as e:
                # ValueError covers a torn JSON body, HTTPException an
                # IncompleteRead from a restarting app — follow mode
                # rides those out like the file tail rides out rotation
                print(f"cannot poll {args.path}: {e}", file=sys.stderr)
                if not args.follow:
                    return 1
        else:
            try:
                open(tail.path).close()
            except OSError as e:
                if not args.follow:  # one-shot: loud, like before
                    print(f"cannot read {args.path}: {e}",
                          file=sys.stderr)
                    return 1
                if not warned_unreadable and count == 0:
                    # follow mode rides out mid-run rotation silently,
                    # but a path that was NEVER readable is probably a
                    # typo — say so once instead of an empty dashboard
                    print(f"waiting for {args.path}: {e}",
                          file=sys.stderr)
                    warned_unreadable = True
            for s in tail.poll():
                window.append(s)
                count += 1
                if len(window) > 2:
                    window.pop(0)
        print(render(window, total=count))
        updates += 1
        if not args.follow or (args.max_updates and
                               updates >= args.max_updates):
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
