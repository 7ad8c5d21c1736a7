"""``tools top`` — a live, curses-free terminal dashboard over /status.

The port of :mod:`parsec_tpu.profiling.top`.

The one-shot ``tools serve-status`` answers "what is the mesh doing" at
a single instant; operators babysitting a serving mesh want the live
view: tenants, in-flight jobs with phase + ETA, per-rank straggler
flags, and the shape of the latency distributions — refreshed in place.
This module polls one or more health endpoints' ``/status``
(``PARSEC_TPU_HEALTH=1``) and renders with nothing but ANSI escapes
(no curses: works in CI logs, dumb terminals and `watch`-style capture;
``--once`` prints a single frame and exits, which is also what the
tests drive).

Usage::

    python -m parsec_tpu_torch.profiling.tools top http://127.0.0.1:8471
    python -m parsec_tpu_torch.profiling.tools top URL1 URL2 --interval 2
    python -m parsec_tpu_torch.profiling.tools top URL --once
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

#: unicode block ramp for histogram sparklines
_BLOCKS = " ▁▂▃▄▅▆▇█"
#: ANSI: clear screen + home (the whole "no curses" story)
CLEAR = "\x1b[2J\x1b[H"


def sparkline(counts: List[int], width: int = 24) -> str:
    """Render bucket counts as a fixed-width unicode sparkline (buckets
    are folded down to ``width`` columns; log-ish visual scale via
    max-normalization)."""
    if not counts:
        return " " * width
    n = len(counts)
    cols: List[int] = []
    for c in range(width):
        lo = c * n // width
        hi = max(lo + 1, (c + 1) * n // width)
        cols.append(sum(counts[lo:hi]))
    peak = max(cols)
    if peak <= 0:
        return " " * width
    out = []
    for v in cols:
        idx = 0 if v <= 0 else max(1, round(v / peak * (len(_BLOCKS) - 1)))
        out.append(_BLOCKS[idx])
    return "".join(out)


def fetch_status(url: str, timeout: float = 5.0) -> Dict[str, Any]:
    base = url.rstrip("/")
    if not base.endswith("/status"):
        base += "/status"
    with urllib.request.urlopen(base, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _fmt_eta(v) -> str:
    if v is None:
        return "--"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "--"
    return f"{f:.1f}s" if f == f and f not in (float("inf"),) else "--"


def _phase_of(job: Dict[str, Any]) -> str:
    """Coarse job phase for the live table: queued | starting | running
    (xx%) | draining — derived from state + progress."""
    state = job.get("state", "?")
    if state != "running":
        return state
    prog = job.get("progress") or {}
    retired, known = prog.get("retired", 0), prog.get("known")
    if not retired:
        return "starting"
    if known and retired >= known:
        return "draining"
    if known:
        return f"running {100 * retired // max(1, known)}%"
    return "running"


def render_status(docs: List[Dict[str, Any]]) -> str:
    """One dashboard frame over the per-rank ``/status`` documents."""
    lines: List[str] = []
    t = time.strftime("%H:%M:%S")
    ranks = [d.get("rank", "?") for d in docs]
    lines.append(f"parsec_tpu_torch top — {t} — {len(docs)} rank(s) {ranks}")

    # mesh summary row
    ready = sum(int(d.get("scheduler", {}).get("ready_tasks", 0))
                for d in docs)
    executed = sum(int(d.get("workers", {}).get("executed", 0))
                   for d in docs)
    pools = sum(int(d.get("active_taskpools", 0)) for d in docs)
    lines.append(f"  ready {ready} | executed {executed} | "
                 f"active pools {pools}")

    # watchdog / straggler flags per rank
    flags: List[str] = []
    for d in docs:
        r = d.get("rank", "?")
        wd = d.get("watchdog") or {}
        if wd.get("stalled"):
            flags.append(f"rank {r}: STALLED")
        for peer, age in (wd.get("last_heard_age_s") or {}).items():
            if float(age) > 10.0:
                flags.append(f"rank {r}: peer {peer} silent {age}s")
        slo = d.get("slo") or {}
        for s in slo.get("stragglers", []):
            jobs = f" (stalling {', '.join(s['jobs'])})" if s.get("jobs") \
                else ""
            flags.append(
                f"rank {s['rank']}: STRAGGLER on {s['class']} "
                f"{s['factor']}x median{jobs}")
    if flags:
        lines.append("  ⚠ " + "; ".join(sorted(set(flags))))

    # serve: tenants + live jobs (first doc carrying a serve section —
    # single-service meshes; multi-endpoint mode shows each rank's)
    for d in docs:
        sv = d.get("serve")
        if not sv:
            continue
        r = d.get("rank", "?")
        j = sv["jobs"]
        lines.append(
            f"  rank {r} serve: {j['inflight']} running, "
            f"{j['queued']} queued, {j['done']} done, "
            f"{j['failed']} failed, {j['rejected']} rejected"
            + (" [CLOSING]" if sv.get("closing") else ""))
        tenants = sv.get("tenants", {})
        if tenants:
            lines.append(f"    {'tenant':<14}{'w':>3}{'run':>5}{'q':>4}"
                         f"{'done':>6}{'viol':>6}{'p95_ms':>9}"
                         f"{'slo_ms':>8}{'tasks/s':>9}")
            for name in sorted(tenants):
                tn = tenants[name]
                p95 = tn.get("p95_ms")
                slo_t = tn.get("slo_p95_ms")
                lines.append(
                    f"    {name:<14}{tn['weight']:>3}"
                    f"{tn['inflight']:>5}{tn['queued']:>4}"
                    f"{tn['completed']:>6}"
                    f"{tn.get('slo_violations', 0):>6}"
                    f"{p95 if p95 is not None else '--':>9}"
                    f"{slo_t if slo_t else '--':>8}"
                    f"{tn['rate_tasks_per_s']:>9.1f}")
        jobs = list(sv.get("jobs_inflight", [])) + list(sv.get("queue", []))
        if jobs:
            lines.append(f"    {'job':>5} {'tenant':<12}{'name':<18}"
                         f"{'phase':<14}{'eta':>8}  trace")
            for job in jobs:
                prog = job.get("progress") or {}
                lines.append(
                    f"    #{job['job_id']:>4} {job['tenant']:<12}"
                    f"{str(job.get('name', ''))[:17]:<18}"
                    f"{_phase_of(job):<14}"
                    f"{_fmt_eta(prog.get('eta_s')):>8}  "
                    f"{job.get('trace_id') or '--'}")

    # SLO histogram sparklines (mesh-merged per family: fixed bucket
    # boundaries make the cross-rank merge an element-wise add)
    fams: Dict[str, List[int]] = {}
    counts_n: Dict[str, int] = {}
    for d in docs:
        slo = d.get("slo") or {}
        for name, snap in (slo.get("histograms") or {}).items():
            cur = fams.get(name)
            if cur is None:
                fams[name] = list(snap["counts"])
            else:
                for i, c in enumerate(snap["counts"]):
                    if i < len(cur):
                        cur[i] += int(c)
            counts_n[name] = counts_n.get(name, 0) + int(snap["count"])
    if fams:
        lines.append("  latency histograms (0.1ms..840s log buckets):")
        for name in sorted(fams):
            lines.append(f"    {name:<44} "
                         f"{sparkline(fams[name])} n={counts_n[name]}")
    return "\n".join(lines)


def run_top(urls: List[str], interval: float = 1.0, once: bool = False,
            max_updates: int = 0,
            out=None) -> int:
    """The ``tools top`` loop: poll, clear, render.  Returns the exit
    code (1 when every endpoint is unreachable on a one-shot run)."""
    out = out or sys.stdout
    updates = 0
    while True:
        docs: List[Dict[str, Any]] = []
        errors: List[str] = []
        for url in urls:
            try:
                docs.append(fetch_status(url))
            except (OSError, ValueError) as e:
                errors.append(f"{url}: {e}")
        if not once:
            out.write(CLEAR)
        if docs:
            out.write(render_status(docs) + "\n")
        for err in errors:
            out.write(f"  unreachable: {err}\n")
        out.flush()
        updates += 1
        if once or (max_updates and updates >= max_updates):
            return 0 if docs else 1
        time.sleep(interval)
