"""Offline critical-path analysis over a (merged) task trace.

The port of :mod:`parsec_tpu.profiling.critpath`: walk the recorded
dependency edges backwards from the last-finishing task, and attribute
every microsecond on the chain to one bucket —

* **compute** — the task's own ``exec`` span.  On the card this is the
  host's submit of the task (staging, launch, epilog enqueue), not the
  kernel's run on the device: the device work of a chain overlaps its
  host gaps;
* **comm**    — the part of the pre-task gap covered by transport
  activity on the SAME rank track (``ce_recv`` / ``ce_send`` spans the
  per-rank trace set records from each rank's comm engine);
* **compile** — the part covered by ``compile`` spans (a CUDA-graph
  capture that missed the program cache);
* **coll**    — the part covered by runtime-collective spans (``coll``);
* **transfer** — the part covered by the staging pipeline's
  ``stage_in`` / ``writeback`` spans;
* **host gap** — the rest: scheduler select, release bookkeeping,
  dispatch latency — time nobody computes and nothing is on the wire.

Inputs are Chrome-trace events in the conventions of
``profiling.binary`` / ``profiling.merge``: ``exec`` spans carry a task
token in ``args.event_id``; ``dep_edge`` instants carry producer token
in ``args.event_id`` and successor token in ``args.info``;
``class:<name>`` instants map tokens to task classes.  Edges are
INTRA-RANK (``pid``): a remote release has no producer task on the
receiving rank, so a cross-rank dependency shows as transport spans in
the gap before the released task — the comm bucket.  On a merged
multi-rank trace :func:`analyze` walks the chain inside the rank that
finishes last; :func:`analyze_ranks` walks each rank track's own chain
and splits its gap into comm, coll, compile, transfer and the rest.  On
the dynamic path a ``dep_edge`` is a release (the predecessor whose
completion made the successor ready); the native pump publishes every
edge of its captured DAG once before its run.

CLI: ``python -m parsec_tpu_torch.profiling.tools critpath trace.pbt``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: transport span names that count as wire time in gap attribution
COMM_SPAN_NAMES = ("ce_recv", "ce_send")
#: program-cache span names that count as compilation time in gap
#: attribution (a GraphExecutor capture that missed the cache fires them)
COMPILE_SPAN_NAMES = ("compile",)
#: runtime-collective span names that count as collective time in gap
#: attribution (fired by comm/coll)
COLL_SPAN_NAMES = ("coll",)
#: staging-pipeline span names that count as host<->device transfer
#: time in gap attribution (device/staging.py fires them around
#: prefetch stage-in and deferred write-back batches)
TRANSFER_SPAN_NAMES = ("stage_in", "writeback")

#: workload labels: task-class names (exact, or by prefix) aggregate
#: into a ``per_label`` section next to ``per_class`` — e.g. every
#: attention class (``attn_step``/``attn_rstep``/``attn_out``/…) rolls
#: up under one ``attention`` row, so "how much of the chain is
#: attention" reads off one line however many classes the graph has
CLASS_LABELS: Dict[str, str] = {}
PREFIX_LABELS: Tuple[Tuple[str, str], ...] = (
    ("attn_", "attention"),
    ("arr_", "array"),  # generated array-front-end classes
)


def label_of(cls: str) -> Optional[str]:
    """Workload label of a task-class name, or None.  A fused supertask
    (``fused[a+b]``, :mod:`parsec_tpu_torch.dsl.fusion`) carries its member
    classes in the name: it takes the members' common label — a fused
    attention chain rolls up under ``attention`` exactly like its
    unfused members would."""
    if cls.startswith("fused[") and cls.endswith("]"):
        labs = {label_of(m) for m in cls[6:-1].split("+")}
        return labs.pop() if len(labs) == 1 else None
    lab = CLASS_LABELS.get(cls)
    if lab is not None:
        return lab
    for prefix, lab in PREFIX_LABELS:
        if cls.startswith(prefix):
            return lab
    return None


def _merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    iv.sort()
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(lo: float, hi: float, merged: Sequence[Tuple[float, float]]) -> float:
    if hi <= lo:
        return 0.0
    total = 0.0
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        total += min(b, hi) - max(a, lo)
    return total


def analyze(events: List[dict], *, exec_name: str = "exec",
            comm_names: Sequence[str] = COMM_SPAN_NAMES,
            compile_names: Sequence[str] = COMPILE_SPAN_NAMES,
            coll_names: Sequence[str] = COLL_SPAN_NAMES,
            transfer_names: Sequence[str] = TRANSFER_SPAN_NAMES,
            job=None, straggler_factor: Optional[float] = None,
            straggler_min_samples: Optional[int] = None) -> dict:
    """Reconstruct the dependency critical path and attribute its wall
    time.  Returns a report dict::

        {"wall_us", "n_tasks", "coverage",
         "buckets": {"compute_us", "comm_us", "coll_us", "compile_us",
                     "transfer_us", "host_gap_us"},
         "per_class": {cls: {"count", "compute_us", "comm_us", "coll_us",
                             "compile_us", "host_gap_us"}},
         "chain": [{"token", "pid", "class", "begin_us", "end_us",
                    "gap_us", "gap_comm_us", "gap_coll_us",
                    "gap_compile_us"}]}

    ``coverage`` is the attributed fraction of the chain's wall clock —
    1.0 when every pre-task gap is non-negative (async device completion
    can overlap a successor's release with its producer's span, which
    clamps that gap to 0 and lowers coverage).

    ``job`` (a trace id: int, hex16 string, or ``job:<hex16>``) SLICES
    the analysis to one job (profiling.jobtrace): only that job's tasks
    enter the chain walk, ``per_job`` rolls chain time up by job, and a
    ``phases`` section attributes the job's end-to-end latency across
    queue (submit->admit), admit (admit->first task), run (first->last
    task, itself split by the buckets) and drain (last task->done) from
    the serve-fired ``job_phase`` instants.

    A ``stragglers`` section compares per-(class, rank) mean exec time
    against the mesh median of per-rank means over the WHOLE trace:
    the offline counterpart of the live OBS010 finding, through the
    SAME comparison (``profiling.slo.mesh_stragglers``) and the same
    MCA-tuned thresholds (``runtime_straggler_factor`` /
    ``runtime_straggler_min_samples``) unless overridden here."""
    from .jobtrace import hex_id, job_index, parse_trace_id

    job_id: Optional[int] = None
    if job is not None:
        job_id = parse_trace_id(job)
    jidx = job_index(events)
    token_to_job = jidx["token_to_job"]

    exec_open: Dict[Tuple[Any, Any], float] = {}
    tasks: Dict[Tuple[Any, int], dict] = {}
    classes: Dict[Tuple[Any, int], str] = {}
    #: fused supertasks: token -> member count (``fused_n`` instants,
    #: profiling.binary) — the dispatch-amortization evidence
    fused: Dict[Tuple[Any, int], int] = {}
    #: serving-plane attribution: ``tenant:<name>`` instants map tokens
    #: to the tenant whose job the task belonged to (profiling.binary)
    tenants: Dict[Tuple[Any, int], str] = {}
    preds: Dict[Tuple[Any, int], List[Tuple[Any, int]]] = defaultdict(list)
    comm_open: Dict[Tuple[Any, Any, str], float] = {}
    comm_iv: Dict[Any, List[Tuple[float, float]]] = defaultdict(list)
    compile_open: Dict[Tuple[Any, Any, str], float] = {}
    compile_iv: Dict[Any, List[Tuple[float, float]]] = defaultdict(list)
    # collective spans pair B/E by event_id (the deterministic cid
    # token), not tid: the begin fires on the issuing thread and the end
    # on whichever comm callback completed the op
    coll_open: Dict[Tuple[Any, Any, str], float] = {}
    coll_iv: Dict[Any, List[Tuple[float, float]]] = defaultdict(list)
    # staging spans pair B/E by event_id (the batch's process-wide span
    # id) like collectives: the committer thread ends what it began,
    # but the id pairing stays robust across lane/committer/detach
    transfer_open: Dict[Tuple[Any, Any, str], float] = {}
    transfer_iv: Dict[Any, List[Tuple[float, float]]] = defaultdict(list)
    #: protocol-regime accounting from the tagged payload instants
    #: (comm_recv_eager / comm_recv_rdv, profiling.binary): events +
    #: bytes per wire regime, so comm time on the chain can be read
    #: against HOW the bytes travelled
    regimes = {"eager": {"events": 0, "bytes": 0},
               "rdv": {"events": 0, "bytes": 0, "chunks": 0,
                       "transfers": 0}}

    for e in sorted(events, key=lambda e: e.get("ts", 0.0)):
        name, ph = e.get("name"), e.get("ph")
        pid = e.get("pid")
        args = e.get("args", {}) or {}
        if name == "comm_recv_eager" and ph == "i":
            regimes["eager"]["events"] += 1
            regimes["eager"]["bytes"] += int(args.get("info", 0) or 0)
        elif name == "comm_recv_rdv" and ph == "i":
            r = regimes["rdv"]
            r["events"] += 1
            r["chunks"] += 1
            r["bytes"] += int(args.get("info", 0) or 0)
            # event_id packs (chunk_index << 16 | chunk_count): count a
            # transfer at its chunk 0
            if (int(args.get("event_id", 0) or 0) >> 16) == 0:
                r["transfers"] += 1
        if name == exec_name:
            tok = args.get("event_id")
            key = (pid, e.get("tid"), tok)
            if ph == "B":
                exec_open[key] = e["ts"]
            elif ph == "E":
                b = exec_open.pop(key, None)
                if b is not None and tok is not None:
                    tasks[(pid, tok)] = {"begin": b, "end": e["ts"]}
        elif name == "dep_edge" and ph == "i":
            src, dst = args.get("event_id"), args.get("info")
            if src is not None and dst is not None:
                preds[(pid, dst)].append((pid, src))
        elif name == "fused_n" and ph == "i":
            n = int(args.get("info", 0) or 0)
            if n > 1:
                fused[(pid, args.get("event_id"))] = n
        elif isinstance(name, str) and name.startswith("class:") and ph == "i":
            classes[(pid, args.get("event_id"))] = name[6:]
        elif isinstance(name, str) and name.startswith("tenant:") and ph == "i":
            tenants[(pid, args.get("event_id"))] = name[7:]
        elif name in comm_names:
            ckey = (pid, e.get("tid"), name)
            if ph == "B":
                comm_open[ckey] = e["ts"]
            elif ph == "E":
                b = comm_open.pop(ckey, None)
                if b is not None:
                    comm_iv[pid].append((b, e["ts"]))
        elif name in compile_names:
            ckey = (pid, e.get("tid"), name)
            if ph == "B":
                compile_open[ckey] = e["ts"]
            elif ph == "E":
                b = compile_open.pop(ckey, None)
                if b is not None:
                    compile_iv[pid].append((b, e["ts"]))
        elif name in coll_names:
            ckey = (pid, args.get("event_id"), name)
            if ph == "B":
                coll_open[ckey] = e["ts"]
            elif ph == "E":
                b = coll_open.pop(ckey, None)
                if b is not None:
                    coll_iv[pid].append((b, e["ts"]))
        elif name in transfer_names:
            ckey = (pid, args.get("event_id"), name)
            if ph == "B":
                transfer_open[ckey] = e["ts"]
            elif ph == "E":
                b = transfer_open.pop(ckey, None)
                if b is not None:
                    transfer_iv[pid].append((b, e["ts"]))

    # fusion summary over the WHOLE trace (not just the chain): every
    # fused dispatch is one device enqueue standing in for N member
    # tasks — "dispatch saved" is the amortization the fusion pass buys
    fused_summary = {
        "regions": len(fused),
        "tasks": int(sum(fused.values())),
        "dispatch_saved": int(sum(fused.values()) - len(fused)),
    }
    # offline straggler attribution over the WHOLE trace (before any
    # job slicing): per-(class, rank) mean exec vs the mesh median of
    # per-rank means — the offline counterpart of the live OBS010
    stragglers = _find_stragglers(tasks, classes, straggler_factor,
                                  straggler_min_samples)

    empty = {"wall_us": 0.0, "n_tasks": 0, "coverage": 0.0,
             "buckets": {"compute_us": 0.0, "comm_us": 0.0,
                         "coll_us": 0.0, "compile_us": 0.0,
                         "transfer_us": 0.0, "host_gap_us": 0.0},
             "per_class": {}, "per_label": {}, "per_tenant": {},
             "per_job": {}, "chain": [], "comm_regimes": regimes,
             "fused": fused_summary, "stragglers": stragglers,
             "job": hex_id(job_id) if job_id is not None else None,
             "phases": None}
    if job_id is not None:
        # slice to ONE job: only its tasks enter the chain walk (edges
        # restrict implicitly — the walk only follows tokens in `tasks`)
        tasks = {k: v for k, v in tasks.items()
                 if token_to_job.get(k) == job_id}
    if not tasks:
        return empty
    comm_merged = {pid: _merge_intervals(iv) for pid, iv in comm_iv.items()}
    compile_merged = {pid: _merge_intervals(iv)
                      for pid, iv in compile_iv.items()}
    coll_merged = {pid: _merge_intervals(iv)
                   for pid, iv in coll_iv.items()}
    transfer_merged = {pid: _merge_intervals(iv)
                       for pid, iv in transfer_iv.items()}

    # backward walk from the last-finishing task: at each step pick the
    # predecessor that finished last (the binding one)
    cur = max(tasks, key=lambda k: tasks[k]["end"])
    chain: List[Tuple[Any, int]] = [cur]
    seen = {cur}
    while True:
        cands = [p for p in preds.get(cur, ()) if p in tasks and p not in seen]
        if not cands:
            break
        cur = max(cands, key=lambda k: tasks[k]["end"])
        seen.add(cur)
        chain.append(cur)
    chain.reverse()

    buckets = {"compute_us": 0.0, "comm_us": 0.0, "coll_us": 0.0,
               "compile_us": 0.0, "transfer_us": 0.0, "host_gap_us": 0.0}
    per_class: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "compute_us": 0.0, "comm_us": 0.0,
                 "coll_us": 0.0, "compile_us": 0.0, "transfer_us": 0.0,
                 "host_gap_us": 0.0})
    per_tenant: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "compute_us": 0.0, "comm_us": 0.0,
                 "coll_us": 0.0, "compile_us": 0.0, "transfer_us": 0.0,
                 "host_gap_us": 0.0})
    per_job: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "compute_us": 0.0, "comm_us": 0.0,
                 "coll_us": 0.0, "compile_us": 0.0, "transfer_us": 0.0,
                 "host_gap_us": 0.0})
    rows = []
    prev_end: Optional[float] = None
    for key in chain:
        t = tasks[key]
        pid, tok = key
        cls = classes.get(key, "?")
        dur = t["end"] - t["begin"]
        gap = 0.0 if prev_end is None else max(0.0, t["begin"] - prev_end)
        gap_comm = _overlap(t["begin"] - gap, t["begin"],
                            comm_merged.get(pid, ()))
        gap_coll = _overlap(t["begin"] - gap, t["begin"],
                            coll_merged.get(pid, ()))
        gap_compile = _overlap(t["begin"] - gap, t["begin"],
                               compile_merged.get(pid, ()))
        gap_transfer = _overlap(t["begin"] - gap, t["begin"],
                                transfer_merged.get(pid, ()))
        # comm/coll/compile/transfer windows can overlap the same gap (a
        # manager compiling while a frame drains, a collective streaming
        # over the transport it is itself a span above, a stage-in batch
        # racing the committer): never attribute a microsecond twice —
        # each later bucket is capped by what the earlier ones left over
        # (comm wins, then coll, then compile, then transfer)
        gap_coll = min(gap_coll, max(0.0, gap - gap_comm))
        gap_compile = min(gap_compile,
                          max(0.0, gap - gap_comm - gap_coll))
        gap_transfer = min(gap_transfer,
                           max(0.0, gap - gap_comm - gap_coll
                               - gap_compile))
        attributed_gap = gap_comm + gap_coll + gap_compile + gap_transfer
        buckets["compute_us"] += dur
        buckets["comm_us"] += gap_comm
        buckets["coll_us"] += gap_coll
        buckets["compile_us"] += gap_compile
        buckets["transfer_us"] += gap_transfer
        buckets["host_gap_us"] += gap - attributed_gap
        pc = per_class[cls]
        pc["count"] += 1
        pc["compute_us"] += dur
        pc["comm_us"] += gap_comm
        pc["coll_us"] += gap_coll
        pc["compile_us"] += gap_compile
        pc["transfer_us"] += gap_transfer
        pc["host_gap_us"] += gap - attributed_gap
        tenant = tenants.get(key)
        if tenant is not None:
            pt = per_tenant[tenant]
            pt["count"] += 1
            pt["compute_us"] += dur
            pt["comm_us"] += gap_comm
            pt["coll_us"] += gap_coll
            pt["compile_us"] += gap_compile
            pt["transfer_us"] += gap_transfer
            pt["host_gap_us"] += gap - attributed_gap
        tid = token_to_job.get(key)
        if tid is not None:
            pj = per_job[hex_id(tid)]
            pj["count"] += 1
            pj["compute_us"] += dur
            pj["comm_us"] += gap_comm
            pj["coll_us"] += gap_coll
            pj["compile_us"] += gap_compile
            pj["transfer_us"] += gap_transfer
            pj["host_gap_us"] += gap - attributed_gap
        rows.append({"token": tok, "pid": pid, "class": cls,
                     "tenant": tenant,
                     "trace_id": hex_id(tid) if tid is not None else None,
                     "begin_us": t["begin"], "end_us": t["end"],
                     "gap_us": gap, "gap_comm_us": gap_comm,
                     "gap_coll_us": gap_coll,
                     "gap_compile_us": gap_compile,
                     "gap_transfer_us": gap_transfer})
        prev_end = max(t["end"], prev_end or t["end"])
    wall = tasks[chain[-1]]["end"] - tasks[chain[0]]["begin"]
    attributed = sum(buckets.values())
    # workload rollup: per_class rows aggregated by label (label_of) —
    # the `attention` bucket of the attention graphs lives here
    per_label: Dict[str, Dict[str, float]] = {}
    for cls, pc in per_class.items():
        lab = label_of(cls)
        if lab is None:
            continue
        agg = per_label.setdefault(
            lab, {"count": 0, "compute_us": 0.0, "comm_us": 0.0,
                  "coll_us": 0.0, "compile_us": 0.0, "transfer_us": 0.0,
                  "host_gap_us": 0.0})
        for key in agg:
            agg[key] += pc[key]
    # job phase attribution: the serve-fired job_phase instants bound
    # queue/admit/drain; the run window is the chain walk itself
    phases = None
    if job_id is not None:
        ph = jidx["phases"].get(job_id, {})
        first = min(t["begin"] for t in tasks.values())
        last = max(t["end"] for t in tasks.values())
        submit, admit = ph.get("submit_us"), ph.get("admit_us")
        done = ph.get("done_us")
        # Remote ranks' exec spans carry residual cross-rank clock-
        # correction error (merge's piecewise alignment is ~us-accurate,
        # not exact), so a corrected remote end can land just past the
        # submitting rank's done instant.  The job_phase envelope bounds
        # the job's true lifetime by construction: clamp the run window
        # into it so the partition stays self-consistent (run <= total,
        # drain >= 0) instead of reporting a run that outlives its job.
        if submit is not None:
            first, last = max(first, submit), max(last, submit)
        if done is not None:
            first, last = min(first, done), min(last, done)
        phases = {
            "queue_us": max(0.0, admit - submit)
            if submit is not None and admit is not None else None,
            "admit_us": max(0.0, first - admit)
            if admit is not None else None,
            "run_us": max(0.0, last - first),
            "drain_us": max(0.0, done - last)
            if done is not None else None,
            "total_us": max(0.0, done - submit)
            if submit is not None and done is not None else None,
        }
    return {
        "wall_us": wall,
        "n_tasks": len(chain),
        "coverage": (attributed / wall) if wall > 0 else 0.0,
        "buckets": buckets,
        "per_class": {k: dict(v) for k, v in per_class.items()},
        "per_label": per_label,
        "per_tenant": {k: dict(v) for k, v in per_tenant.items()},
        "per_job": {k: dict(v) for k, v in per_job.items()},
        "chain": rows,
        "comm_regimes": regimes,
        "fused": fused_summary,
        "stragglers": stragglers,
        "job": hex_id(job_id) if job_id is not None else None,
        "phases": phases,
    }


def _find_stragglers(tasks: Dict[Tuple[Any, int], dict],
                     classes: Dict[Tuple[Any, int], str],
                     factor: Optional[float],
                     min_samples: Optional[int]) -> List[dict]:
    """Per-(class, rank) exec-mean outliers over the trace — the SAME
    comparison and MCA thresholds as the live OBS010 plane
    (``profiling.slo.mesh_stragglers``), fed trace-derived means."""
    from .slo import mesh_stragglers, straggler_params

    mca_factor, mca_min = straggler_params()
    if factor is None:
        factor = mca_factor
    if min_samples is None:
        min_samples = mca_min
    acc: Dict[Tuple[str, Any], List[float]] = defaultdict(
        lambda: [0, 0.0])  # (cls, pid) -> [count, sum_us]
    for key, t in tasks.items():
        cls = classes.get(key, "?")
        a = acc[(cls, key[0])]
        a[0] += 1
        a[1] += t["end"] - t["begin"]
    by_class: Dict[str, Dict[Any, Tuple[int, float]]] = defaultdict(dict)
    for (cls, pid), (n, total) in acc.items():
        if n:
            by_class[cls][pid] = (int(n), total / n)
    return [{"class": cls, "rank": pid,
             "mean_us": round(mean, 1),
             "mesh_median_us": round(med, 1),
             "factor": round(ratio, 2)}
            for cls, pid, mean, med, ratio in mesh_stragglers(
                by_class, factor, min_samples)]


def analyze_ranks(events: List[dict], **kw) -> Dict[Any, dict]:
    """:func:`analyze` on each rank track (``pid``) of a merged trace
    alone: ``{rank: {"wall_us", "n_tasks", "coverage", "buckets",
    "window"}}`` for every rank that executed a task.  Each rank's chain
    is walked over its own edges and its own comm/coll/compile/transfer
    spans, so a rank's host gap reads against its own wire time, not the
    mesh's; ``window`` splits the rank's whole window the same way
    (:func:`_rank_window`).  A remote release has no producer task on the
    receiving rank, so a chain on a rank ends at the first task a peer's
    activation made ready: on a block-cyclic grid the window is the
    rank's fuller picture."""
    by_pid: Dict[Any, List[dict]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "M":
            by_pid[e.get("pid")].append(e)
    out: Dict[Any, dict] = {}
    for pid in sorted(by_pid, key=lambda p: (not isinstance(p, int), str(p))):
        rep = analyze(by_pid[pid], **kw)
        if rep["n_tasks"]:
            out[pid] = {k: rep[k] for k in ("wall_us", "n_tasks",
                                           "coverage", "buckets")}
            out[pid]["window"] = _rank_window(
                by_pid[pid], **{k: v for k, v in kw.items() if k in (
                    "exec_name", "comm_names", "compile_names",
                    "coll_names", "transfer_names")})
    return out


def _rank_window(events: List[dict], exec_name: str = "exec",
                 comm_names: Sequence[str] = COMM_SPAN_NAMES,
                 compile_names: Sequence[str] = COMPILE_SPAN_NAMES,
                 coll_names: Sequence[str] = COLL_SPAN_NAMES,
                 transfer_names: Sequence[str] = TRANSFER_SPAN_NAMES
                 ) -> Dict[str, float]:
    """One rank's whole window (first exec begin to last exec end) split
    like a chain's gap: the union of its exec spans, then the time outside
    them covered by its transport, collective, compile and transfer spans
    (each capped by what the earlier ones left, as :func:`analyze` caps
    a gap), and the rest (select, release bookkeeping, waits on the
    interpreter).  Spans pair as :func:`analyze` pairs them.  Returns
    ``{"window_us", "exec_us", "comm_us", "coll_us", "compile_us",
    "transfer_us", "rest_us", "exec_spans"}``."""
    kinds = {exec_name: "exec"}
    kinds.update({n: "comm" for n in comm_names})
    kinds.update({n: "compile" for n in compile_names})
    kinds.update({n: "coll" for n in coll_names})
    kinds.update({n: "transfer" for n in transfer_names})
    opened: Dict[Tuple[Any, Any, str], float] = {}
    iv: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in sorted(events, key=lambda e: e.get("ts", 0.0)):
        name, ph = e.get("name"), e.get("ph")
        kind = kinds.get(name)
        if kind is None or ph not in ("B", "E"):
            continue
        args = e.get("args", {}) or {}
        if kind == "exec":
            key = (e.get("tid"), args.get("event_id"), name)
        elif kind in ("coll", "transfer"):
            key = (None, args.get("event_id"), name)
        else:
            key = (e.get("tid"), None, name)
        if ph == "B":
            opened[key] = e["ts"]
        else:
            b = opened.pop(key, None)
            if b is not None:
                iv[kind].append((b, e["ts"]))
    out = {"window_us": 0.0, "exec_us": 0.0, "comm_us": 0.0, "coll_us": 0.0,
           "compile_us": 0.0, "transfer_us": 0.0, "rest_us": 0.0,
           "exec_spans": len(iv["exec"])}
    if not iv["exec"]:
        return out
    lo = min(b for b, _ in iv["exec"])
    hi = max(e for _, e in iv["exec"])
    covered = _merge_intervals(iv["exec"])
    out["window_us"] = hi - lo
    out["exec_us"] = sum(e - b for b, e in covered)
    for kind in ("comm", "coll", "compile", "transfer"):
        spans = _merge_intervals([(max(b, lo), min(e, hi)) for b, e in iv[kind]
                                  if e > lo and b < hi])
        # each kind gets only what exec and the earlier kinds left
        out[f"{kind}_us"] = sum((e - b) - _overlap(b, e, covered)
                                for b, e in spans)
        covered = _merge_intervals(covered + spans)
    out["rest_us"] = max(0.0, out["window_us"] - sum(
        out[k] for k in ("exec_us", "comm_us", "coll_us", "compile_us",
                         "transfer_us")))
    return out


def render_ranks(per_rank: Dict[Any, dict]) -> str:
    """One line a rank of :func:`analyze_ranks`: its chain's wall, and
    its compute and gap buckets in ms."""
    lines = ["per rank (each rank's own chain, ms):"]
    for pid, rep in per_rank.items():
        b = rep["buckets"]
        lines.append(
            f"  rank {pid}: {rep['n_tasks']} tasks, wall "
            f"{rep['wall_us'] / 1e3:.3f}; " + ", ".join(
                f"{k[:-3]} {b.get(k, 0.0) / 1e3:.3f}"
                for k in ("compute_us", "comm_us", "coll_us", "compile_us",
                          "transfer_us", "host_gap_us")))
        w = rep.get("window")
        if w:
            lines.append(
                f"    window {w['window_us'] / 1e3:.3f}: exec "
                f"{w['exec_us'] / 1e3:.3f}, outside exec: " + ", ".join(
                    f"{k} {w[k + '_us'] / 1e3:.3f}"
                    for k in ("comm", "coll", "compile", "transfer",
                              "rest")))
    return "\n".join(lines)


def render(report: dict) -> str:
    """Human-readable report (the tools CLI's default output)."""
    wall = report["wall_us"]
    b = report["buckets"]
    lines = [
        f"critical path: {report['n_tasks']} tasks, "
        f"wall {wall / 1e3:.3f} ms, "
        f"coverage {report['coverage']:.1%}",
    ]
    if report.get("job"):
        lines[0] = f"job {report['job']} " + lines[0]
    ph = report.get("phases")
    if ph:
        def _ms(v):
            return "--" if v is None else f"{v / 1e3:.3f}"
        lines.append(
            f"  phases: queue {_ms(ph['queue_us'])} ms -> admit "
            f"{_ms(ph['admit_us'])} ms -> run {_ms(ph['run_us'])} ms "
            f"-> drain {_ms(ph['drain_us'])} ms  (total "
            f"{_ms(ph['total_us'])} ms)")
    for k in ("compute_us", "comm_us", "coll_us", "compile_us",
              "transfer_us", "host_gap_us"):
        frac = b.get(k, 0.0) / wall if wall > 0 else 0.0
        lines.append(f"  {k[:-3]:<10} {b.get(k, 0.0) / 1e3:>10.3f} ms"
                     f"  {frac:>6.1%}")
    fu = report.get("fused")
    if fu and fu.get("regions"):
        lines.append(
            f"  fused dispatch saved: {fu['dispatch_saved']} "
            f"({fu['regions']} fused regions covering {fu['tasks']} "
            "member tasks)")
    reg = report.get("comm_regimes")
    if reg and (reg["eager"]["events"] or reg["rdv"]["events"]):
        ev_e, ev_r = reg["eager"]["events"], reg["rdv"].get("transfers", 0)
        hit = ev_e / (ev_e + ev_r) if (ev_e + ev_r) else 1.0
        lines.append(
            f"  wire: eager {ev_e} payloads / {reg['eager']['bytes']} B, "
            f"rdv {ev_r} transfers / {reg['rdv'].get('chunks', 0)} chunks"
            f" / {reg['rdv']['bytes']} B  (eager hit-rate {hit:.1%})")
    if report["per_class"]:
        lines.append(f"  {'class':<18}{'count':>6}{'compute_ms':>12}"
                     f"{'comm_ms':>10}{'host_ms':>10}{'host_us/task':>14}")
        for cls in sorted(report["per_class"]):
            pc = report["per_class"][cls]
            per_task = pc["host_gap_us"] / max(pc["count"], 1)
            lines.append(
                f"  {cls:<18}{pc['count']:>6}"
                f"{pc['compute_us'] / 1e3:>12.3f}"
                f"{pc['comm_us'] / 1e3:>10.3f}"
                f"{pc['host_gap_us'] / 1e3:>10.3f}{per_task:>14.1f}")
    if report.get("per_label"):
        lines.append(f"  {'label':<18}{'count':>6}{'compute_ms':>12}"
                     f"{'comm_ms':>10}{'host_ms':>10}")
        for lab in sorted(report["per_label"]):
            pl = report["per_label"][lab]
            lines.append(
                f"  {lab:<18}{pl['count']:>6}"
                f"{pl['compute_us'] / 1e3:>12.3f}"
                f"{pl['comm_us'] / 1e3:>10.3f}"
                f"{pl['host_gap_us'] / 1e3:>10.3f}")
    if report.get("per_tenant"):
        lines.append(f"  {'tenant':<18}{'count':>6}{'compute_ms':>12}"
                     f"{'comm_ms':>10}{'host_ms':>10}")
        for ten in sorted(report["per_tenant"]):
            pt = report["per_tenant"][ten]
            lines.append(
                f"  {ten:<18}{pt['count']:>6}"
                f"{pt['compute_us'] / 1e3:>12.3f}"
                f"{pt['comm_us'] / 1e3:>10.3f}"
                f"{pt['host_gap_us'] / 1e3:>10.3f}")
    if report.get("per_job") and not report.get("job"):
        lines.append(f"  {'job':<18}{'count':>6}{'compute_ms':>12}"
                     f"{'comm_ms':>10}{'host_ms':>10}")
        for jid in sorted(report["per_job"]):
            pj = report["per_job"][jid]
            lines.append(
                f"  {jid:<18}{pj['count']:>6}"
                f"{pj['compute_us'] / 1e3:>12.3f}"
                f"{pj['comm_us'] / 1e3:>10.3f}"
                f"{pj['host_gap_us'] / 1e3:>10.3f}")
    for s in report.get("stragglers") or ():
        lines.append(
            f"  STRAGGLER rank {s['rank']}: class {s['class']!r} "
            f"{s['factor']}x the mesh median ({s['mean_us'] / 1e3:.3f} ms"
            f" vs {s['mesh_median_us'] / 1e3:.3f} ms)")
    return "\n".join(lines)
