"""Runtime health plane: live metrics export and the stall watchdog.

The port of :mod:`parsec_tpu.profiling.health`.  PaRSEC's L7 layer exports
live runtime properties (``dictionary.c`` / ``aggregator_visu``) and named
SDE counters that monitors read while the runtime runs
(``papi_sde.c``).  This module is the serving side of that idea:

* :class:`HealthServer` — a stdlib-HTTP exporter thread per
  :class:`~parsec_tpu_torch.core.context.Context`, bound to 127.0.0.1,
  serving

  - ``/metrics``   — Prometheus text: ready-queue depth, arena bytes in
    use and high water, device wave occupancy and staging counters, the
    program cache, per-taskpool retired/known/rate/ETA
    (``Taskpool.progress``), the serving plane's ``parsec_serve_jobs_*``
    and per-tenant families, the SLO histograms, every registered SDE
    counter and numeric dictionary property;
  - ``/status``    — the same as one JSON document (plus the watchdog's
    state);
  - ``/healthz``   — 200 while healthy, 503 once the watchdog declared a
    stall;
  - ``/flightdump`` — snapshot the flight recorder(s) of the process
    (:mod:`.flight`) and return the paths.

* :func:`register_context_gauges` — registers the serving-side gauge set
  (``PARSEC::SCHEDULER::READY_TASKS``, ``PARSEC::ARENA::*``,
  ``PARSEC::DEVICE::*``, ``PARSEC::SERVE::*``, ... ; see
  ``parsec_tpu_torch/OPERATIONS.md``) into the SDE registry.

* :class:`Watchdog` — a per-context progress-epoch monitor: it samples
  tasks retired and executed, device tasks, body starts and the
  write-back committer's drain, and when no epoch advances for
  ``runtime_watchdog_window`` seconds while a taskpool is live, emits a
  structured hang diagnosis (``OBS0xx`` findings: the stalled tenant
  (OBS008), pending dep counters per class, ready tasks not retiring, a
  wedged committer, breached SLOs) — and in strict mode fails the stalled
  pools with the report attached.

The comm layer's parts — the comm and collective summaries, rank
heartbeats, clock re-sync and the rendezvous, collective, fourcounter and
silent-rank findings — come with it (ROADMAP A.8): a context carries no
comm engine, so the summaries read None.

Env wiring (read by ``Context.__init__``): ``PARSEC_TPU_HEALTH=1``
(ephemeral port) or ``=<port>`` starts a :class:`HealthServer`;
``PARSEC_TPU_WATCHDOG=1|strict`` installs a :class:`Watchdog`;
``PARSEC_TPU_FLIGHT=1`` installs a flight recorder.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from ..analysis.findings import Finding, errors_of
from ..utils import debug, mca_param
from . import dictionary, sde

__all__ = ["HealthServer", "Watchdog", "StallReport",
           "register_context_gauges", "context_status"]


# ---------------------------------------------------------------------------
# context introspection (shared by /metrics, /status and the gauges)
# ---------------------------------------------------------------------------

def _comm_summary(ctx) -> Optional[Dict[str, Any]]:
    """The comm engine's counters: None — a context carries no comm engine
    until the comm layer is ported (ROADMAP A.8)."""
    return None


def _coll_summary(ctx) -> Optional[Dict[str, Any]]:
    """The collective endpoint's counters: None without a comm engine
    (ROADMAP A.8)."""
    return None


def _array_summary() -> Dict[str, Any]:
    """Array-front-end synthesis counters (``parsec_array_*`` on
    /metrics, the ``PARSEC::ARRAY::*`` SDE gauges).  Process-wide and
    import-light: a scrape never imports the array package, and reads
    zeros until the first program lowers."""
    import sys

    mod = sys.modules.get("parsec_tpu_torch.array.lower")
    if mod is None:  # never imported: nothing lowered, report zeros
        return {"programs_lowered": 0, "classes_generated": 0,
                "taskpools_built": 0}
    return mod.counters()


def _device_summary(dev) -> Dict[str, Any]:
    s = getattr(dev, "stats", {})
    waves = int(s.get("wave_submits", 0))
    return {
        "name": dev.name,
        "type": getattr(dev, "device_type", "?"),
        "executed_tasks": int(s.get("executed_tasks", 0)),
        "wave_submits": waves,
        "wave_tasks": int(s.get("wave_tasks", 0)),
        # mean ready-wave width actually batched per device enqueue —
        # the "how full are my waves" serving gauge
        "wave_occupancy": (s.get("wave_tasks", 0) / waves) if waves else 0.0,
        "bytes_in": int(s.get("bytes_in", 0)),
        "bytes_out": int(s.get("bytes_out", 0)),
        # staging pipeline: prefetched tile count, batched
        # put/get activity and the async committer's live queue state —
        # zeros with the pipeline off (stage_depth=1) or on devices
        # without one
        "staging": _staging_summary(dev),
    }


def _staging_summary(dev) -> Dict[str, Any]:
    s = getattr(dev, "stats", {})
    com = getattr(dev, "_committer", None)
    out = {
        "depth": int(getattr(dev, "stage_depth", 1) or 1),
        "prefetched_tiles": int(s.get("prefetched_tiles", 0)),
        "batched_puts": int(s.get("stage_batched_puts", 0)),
        "batched_put_tiles": int(s.get("stage_batched_tiles", 0)),
        "wb_batches": int(s.get("wb_batches", 0)),
        "wb_pending": 0, "wb_pending_bytes": 0,
        "wb_committed": 0, "wb_dropped_stale": 0,
    }
    if com is not None:
        out["wb_pending"] = int(com.pending())
        out["wb_pending_bytes"] = int(com.pending_bytes())
        out["wb_committed"] = int(com.stats.get("committed", 0))
        out["wb_dropped_stale"] = int(com.stats.get("dropped_stale", 0))
    return out


def context_status(ctx) -> Dict[str, Any]:
    """One JSON-able health document for a context (the ``/status``
    payload; ``/metrics`` renders the same numbers as Prometheus text)."""
    from ..data import arena as arena_mod

    with ctx._cv:
        pools = list(ctx._taskpools.values())
    wd = getattr(ctx, "watchdog", None)
    # this context's OWN registered gauges are skipped in the sde section:
    # their values are already in the scheduler/comm/arena/devices
    # sections above — re-invoking them would sample the same state twice
    # per scrape (every arena lock walked again) and export every number
    # under two metric families
    own = getattr(ctx, "_sde_gauge_names", ())
    doc: Dict[str, Any] = {
        "rank": ctx.rank,
        "nranks": ctx.nranks,
        "t": time.time(),
        "scheduler": {
            "name": ctx.scheduler.mca_name,
            "ready_tasks": int(ctx.scheduler.pending_estimate()),
        },
        "workers": {
            "n": ctx.nb_workers,
            "executed": sum(es.stats["executed"] for es in ctx.streams),
            "per_worker": [dict(es.stats) for es in ctx.streams],
        },
        "taskpools": [tp.progress() for tp in pools],
        "active_taskpools": len(pools),
        "arena": arena_mod.global_stats(),
        "comm": _comm_summary(ctx),
        "coll": _coll_summary(ctx),
        "array": _array_summary(),
        "devices": [_device_summary(d) for d in ctx.devices],
        "sde": {name: sde.read(name) for name in sde.list_counters()
                if name not in own},
        "compile_cache": (None if getattr(ctx, "compile_cache", None)
                          is None else ctx.compile_cache.snapshot()),
        "watchdog": None if wd is None else wd.status(),
        # multi-tenant serving plane (serve.RuntimeService hangs itself
        # off ctx.serve): per-tenant jobs/retired/rate/ETA table
        "serve": (None if getattr(ctx, "serve", None) is None
                  else ctx.serve.status_doc()),
        # SLO plane (profiling.slo): mergeable histograms, per-tenant
        # targets/violations, straggler flags
        "slo": (None if getattr(ctx, "slo", None) is None
                else ctx.slo.status()),
    }
    return doc


# ---------------------------------------------------------------------------
# the standard SDE gauge set (OPERATIONS.md's "SDE counters" table)
# ---------------------------------------------------------------------------

def register_context_gauges(ctx) -> Callable[[], None]:
    """Register the serving-side gauges for ``ctx`` into the SDE
    registry (rank 0 / single-rank contexts own the canonical names;
    other in-process ranks are prefixed ``PARSEC::RANK<r>::`` so N
    contexts in one process do not fight over one registry slot).
    Returns an unregister callable."""
    from ..data import arena as arena_mod

    def qual(name: str) -> str:
        if ctx.rank == 0:
            return name
        return name.replace("PARSEC::", f"PARSEC::RANK{ctx.rank}::", 1)

    def comm_val(key: str, default=0):
        def get():
            c = _comm_summary(ctx)
            return float(c.get(key, default)) if c else float(default)
        return get

    def dev_occupancy() -> float:
        infos = [_device_summary(d) for d in ctx.devices]
        waves = sum(i["wave_submits"] for i in infos)
        tasks = sum(i["wave_tasks"] for i in infos)
        return (tasks / waves) if waves else 0.0

    names: List[str] = []

    def gauge(name: str, fn) -> None:
        qname = qual(name)
        sde.register_gauge(qname, fn)
        names.append(qname)

    gauge(sde.READY_TASKS,
          lambda: float(ctx.scheduler.pending_estimate()))
    gauge(sde.COMM_WIRE_BYTES, comm_val("wire_bytes"))
    gauge(sde.COMM_EAGER_HIT_RATE, comm_val("eager_hit_rate", 1.0))
    gauge(sde.COMM_RDV_PULLS_INFLIGHT, comm_val("rdv_pulls_inflight"))
    gauge(sde.ARENA_BYTES_IN_USE,
          lambda: float(arena_mod.global_stats()["bytes_in_use"]))
    gauge(sde.ARENA_BYTES_HIGH_WATER,
          lambda: float(arena_mod.global_stats()["bytes_hw"]))
    gauge(sde.DEVICE_WAVE_OCCUPANCY, dev_occupancy)
    gauge(sde.DEVICE_TASKS_EXECUTED,
          lambda: float(sum(int(d.stats.get("executed_tasks", 0))
                            for d in ctx.devices)))

    # staging-pipeline gauges (device/staging.py): prefetched tiles +
    # the async write-back committer's live queue — zeros with the
    # pipeline off, registered unconditionally so the doc'd set is live
    def staging_val(key: str):
        def get() -> float:
            return float(sum(int(_staging_summary(d).get(key, 0))
                             for d in ctx.devices))
        return get

    gauge(sde.DEVICE_STAGE_PREFETCHED, staging_val("prefetched_tiles"))
    gauge(sde.DEVICE_WRITEBACKS_PENDING, staging_val("wb_pending"))
    gauge(sde.DEVICE_WRITEBACKS_COMMITTED, staging_val("wb_committed"))
    gauge(sde.DEVICE_WRITEBACKS_DROPPED_STALE,
          staging_val("wb_dropped_stale"))

    # executable-cache counters (compile_cache.ExecutableCache.stats):
    # cache effectiveness + the compile-once-ship-serialized channel
    def cc_val(key: str):
        def get() -> float:
            cc = getattr(ctx, "compile_cache", None)
            if cc is None:
                return 0.0
            return float(cc.snapshot().get(key, 0))
        return get

    gauge(sde.COMPILE_CACHE_HITS, cc_val("hits"))
    gauge(sde.COMPILE_CACHE_MISSES, cc_val("misses"))
    gauge(sde.COMPILE_CACHE_BYTES, cc_val("bytes"))
    gauge(sde.COMPILE_BCAST_SENT, cc_val("bcast_sent"))
    gauge(sde.COMPILE_BCAST_RECV, cc_val("bcast_recv"))
    gauge(sde.COMPILE_LOCAL_ONLY, cc_val("local_only"))

    # collective-endpoint counters (comm/coll.py): ops/bytes/segments —
    # zero until the first collective builds the manager
    def coll_val(key: str):
        def get() -> float:
            c = _coll_summary(ctx)
            return float(c.get(key, 0)) if c else 0.0
        return get

    gauge(sde.COLL_OPS_STARTED, coll_val("ops_started"))
    gauge(sde.COLL_OPS_DONE, coll_val("ops_done"))
    gauge(sde.COLL_BYTES, coll_val("bytes"))
    gauge(sde.COLL_SEGMENTS_INFLIGHT, coll_val("segments_inflight"))

    # supertask-fusion device counters (dsl.fusion; accumulated by the
    # device layer at fused dispatch): zero with runtime_fusion=off —
    # registered unconditionally so the doc'd gauge set is always live
    def fusion_val(key: str):
        def get() -> float:
            return float(sum(int(d.stats.get(key, 0))
                             for d in ctx.devices))
        return get

    gauge(sde.FUSION_REGIONS_DISPATCHED, fusion_val("fused_submits"))
    gauge(sde.FUSION_TASKS_FUSED, fusion_val("fused_tasks"))
    gauge(sde.FUSION_DISPATCH_SAVED,
          lambda: float(sum(
              int(d.stats.get("fused_tasks", 0))
              - int(d.stats.get("fused_submits", 0))
              for d in ctx.devices)))

    # array-front-end synthesis counters: zero until the array front end
    # is ported — registered unconditionally so the doc'd gauge set is
    # always live
    def array_val(key: str):
        def get() -> float:
            # import-light like _array_summary: a metrics scrape must not
            # pull the array package into a process that never used it
            return float(_array_summary().get(key, 0))
        return get

    gauge(sde.ARRAY_PROGRAMS_LOWERED, array_val("programs_lowered"))
    gauge(sde.ARRAY_CLASSES_GENERATED, array_val("classes_generated"))
    gauge(sde.ARRAY_TASKPOOLS_BUILT, array_val("taskpools_built"))

    # serving-plane counters (serve.RuntimeService on ctx.serve): zero
    # until a service attaches — registered unconditionally so external
    # monitors can alert on them before the first job arrives
    def serve_val(key: str):
        def get() -> float:
            sv = getattr(ctx, "serve", None)
            if sv is None:
                return 0.0
            return sv.counters().get(key, 0.0)
        return get

    gauge(sde.SERVE_JOBS_QUEUED, serve_val("queued"))
    gauge(sde.SERVE_JOBS_INFLIGHT, serve_val("inflight"))
    gauge(sde.SERVE_JOBS_DONE, serve_val("done"))
    gauge(sde.SERVE_JOBS_REJECTED, serve_val("rejected"))
    gauge(sde.SERVE_TENANTS, serve_val("tenants"))

    # SLO-plane counters (profiling.slo.SloPlane on ctx.slo): zero
    # until a plane installs (PARSEC_TPU_SLO=1, or any RuntimeService)
    def slo_violations() -> float:
        sp = getattr(ctx, "slo", None)
        return float(sp.violations_total()) if sp is not None else 0.0

    def slo_stragglers() -> float:
        sp = getattr(ctx, "slo", None)
        if sp is None:
            return 0.0
        return float(len({s["rank"] for s in sp.stragglers()}))

    gauge(sde.SLO_VIOLATIONS, slo_violations)
    gauge(sde.SLO_STRAGGLER_RANKS, slo_stragglers)

    # lets context_status/prometheus_text skip this context's own gauges
    # (exported under first-class names) instead of sampling them twice
    ctx._sde_gauge_names = tuple(names)

    def unregister() -> None:
        for n in names:
            sde.unregister_counter(n)
        if getattr(ctx, "_sde_gauge_names", None) == tuple(names):
            ctx._sde_gauge_names = ()

    return unregister


# ---------------------------------------------------------------------------
# Prometheus rendering
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name).strip("_").lower()


def _esc(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _line(out: List[str], name: str, labels: Dict[str, Any],
          value: Any) -> None:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return
    if v != v:  # NaN renders as NaN in prom text but helps nobody
        return
    lab = ",".join(f'{k}="{_esc(x)}"' for k, x in labels.items())
    body = f"{{{lab}}}" if lab else ""
    if v == int(v) and abs(v) < 2 ** 53:
        out.append(f"{name}{body} {int(v)}")
    else:
        out.append(f"{name}{body} {v}")


def prometheus_text(ctx) -> str:
    """Render a context's health document in Prometheus text exposition
    format (version 0.0.4)."""
    doc = context_status(ctx)
    r = {"rank": doc["rank"]}
    out: List[str] = []

    out.append("# HELP parsec_ready_tasks queued ready tasks per scheduler")
    out.append("# TYPE parsec_ready_tasks gauge")
    _line(out, "parsec_ready_tasks",
          {**r, "sched": doc["scheduler"]["name"]},
          doc["scheduler"]["ready_tasks"])

    out.append("# TYPE parsec_workers_tasks_executed_total counter")
    _line(out, "parsec_workers_tasks_executed_total", r,
          doc["workers"]["executed"])
    _line(out, "parsec_active_taskpools", r, doc["active_taskpools"])

    out.append("# HELP parsec_taskpool_retired_total tasks retired per "
               "taskpool (see parsec_taskpool_known_tasks for the total)")
    out.append("# TYPE parsec_taskpool_retired_total counter")
    for p in doc["taskpools"]:
        lab = {**r, "taskpool": p["taskpool_id"], "name": p["name"]}
        if p.get("tenant"):
            lab["tenant"] = p["tenant"]
        _line(out, "parsec_taskpool_retired_total", lab, p["retired"])
        if p["known"] is not None:
            _line(out, "parsec_taskpool_known_tasks", lab, p["known"])
        _line(out, "parsec_taskpool_rate_tasks_per_s", lab,
              p["rate_tasks_per_s"])
        if p["eta_s"] is not None:
            _line(out, "parsec_taskpool_eta_seconds", lab, p["eta_s"])

    a = doc["arena"]
    out.append("# TYPE parsec_arena_bytes_in_use gauge")
    _line(out, "parsec_arena_bytes_in_use", r, a["bytes_in_use"])
    _line(out, "parsec_arena_bytes_high_water", r, a["bytes_hw"])
    _line(out, "parsec_arena_buffers_in_use", r, a["used"])

    # the comm layer's families (parsec_comm_*) come with it (ROADMAP A.8)

    out.append("# TYPE parsec_device_wave_occupancy gauge")
    for d in doc["devices"]:
        lab = {**r, "device": d["name"]}
        _line(out, "parsec_device_wave_occupancy", lab,
              d["wave_occupancy"])
        _line(out, "parsec_device_tasks_executed_total", lab,
              d["executed_tasks"])
        st = d.get("staging") or {}
        if st:
            _line(out, "parsec_device_staging_depth", lab,
                  st.get("depth", 1))
            _line(out, "parsec_device_staging_prefetched_tiles_total",
                  lab, st.get("prefetched_tiles", 0))
            _line(out, "parsec_device_staging_batched_puts_total", lab,
                  st.get("batched_puts", 0))
            _line(out, "parsec_device_staging_wb_pending", lab,
                  st.get("wb_pending", 0))
            _line(out, "parsec_device_staging_wb_pending_bytes", lab,
                  st.get("wb_pending_bytes", 0))
            _line(out, "parsec_device_staging_wb_committed_total", lab,
                  st.get("wb_committed", 0))
            _line(out, "parsec_device_staging_wb_dropped_stale_total",
                  lab, st.get("wb_dropped_stale", 0))

    cc = doc.get("compile_cache")
    if cc is not None:
        out.append("# TYPE parsec_compile_cache_hits_total counter")
        _line(out, "parsec_compile_cache_hits_total", r, cc.get("hits", 0))
        _line(out, "parsec_compile_cache_misses_total", r,
              cc.get("misses", 0))
        _line(out, "parsec_compile_cache_bytes_total", r,
              cc.get("bytes", 0))
        _line(out, "parsec_compile_bcast_sent_total", r,
              cc.get("bcast_sent", 0))
        _line(out, "parsec_compile_bcast_recv_total", r,
              cc.get("bcast_recv", 0))
        _line(out, "parsec_compile_local_only_total", r,
              cc.get("local_only", 0))

    # and so do the collectives' (parsec_coll_*)

    sv = doc.get("serve")
    if sv is not None:
        j = sv["jobs"]
        out.append("# TYPE parsec_serve_jobs_queued gauge")
        _line(out, "parsec_serve_jobs_queued", r, j["queued"])
        _line(out, "parsec_serve_jobs_inflight", r, j["inflight"])
        out.append("# TYPE parsec_serve_jobs_done_total counter")
        _line(out, "parsec_serve_jobs_done_total", r, j["done"])
        _line(out, "parsec_serve_jobs_failed_total", r, j["failed"])
        _line(out, "parsec_serve_jobs_cancelled_total", r,
              j["cancelled"])
        _line(out, "parsec_serve_jobs_rejected_total", r, j["rejected"])
        out.append("# HELP parsec_tenant_retired_total tasks retired "
                   "per tenant (completed + in-flight jobs)")
        out.append("# TYPE parsec_tenant_retired_total counter")
        for name, t in sorted(sv["tenants"].items()):
            lab = {**r, "tenant": name}
            _line(out, "parsec_tenant_retired_total", lab, t["retired"])
            _line(out, "parsec_tenant_weight", lab, t["weight"])
            _line(out, "parsec_tenant_jobs_inflight", lab, t["inflight"])
            _line(out, "parsec_tenant_jobs_queued", lab, t["queued"])
            _line(out, "parsec_tenant_jobs_done_total", lab,
                  t["completed"])
            _line(out, "parsec_tenant_jobs_rejected_total", lab,
                  t["rejected"])
            _line(out, "parsec_tenant_rate_tasks_per_s", lab,
                  t["rate_tasks_per_s"])
            if t["eta_s"] is not None:
                _line(out, "parsec_tenant_eta_seconds", lab, t["eta_s"])

    ar = doc.get("array") or {}
    if ar:
        out.append("# TYPE parsec_array_programs_total counter")
        _line(out, "parsec_array_programs_total", r,
              ar.get("programs_lowered", 0))
        _line(out, "parsec_array_classes_total", r,
              ar.get("classes_generated", 0))
        _line(out, "parsec_array_taskpools_total", r,
              ar.get("taskpools_built", 0))

    # SLO plane: real Prometheus histogram families (_bucket/_sum/_count
    # with cumulative le labels) + the violations counter — rendered
    # straight off the plane's state (the /status doc carries the same
    # numbers as JSON snapshots)
    sp = getattr(ctx, "slo", None)
    if sp is not None:
        sp.prometheus_lines(doc["rank"], out)

    wd = doc["watchdog"]
    _line(out, "parsec_watchdog_stalled", r,
          1 if (wd and wd["stalled"]) else 0)

    # every registered SDE counter/gauge, named like the PAPI-SDE string
    for name, val in sorted(doc["sde"].items()):
        _line(out, "parsec_sde", {**r, "counter": name}, val)

    # numeric live-properties (sde.* excluded UNSAMPLED — exported above)
    for name, val in sorted(dictionary.snapshot(
            exclude_prefix="sde.").items()):
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        _line(out, "parsec_prop", {**r, "name": name}, val)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# HTTP exporter
# ---------------------------------------------------------------------------

class HealthServer:
    """One exporter thread per context.  ``port=0`` binds an ephemeral
    port (read it back from :attr:`port` / :attr:`url`); binds localhost
    only: a deployment fronts it with its own fabric."""

    def __init__(self, context, port: int = 0, host: str = "127.0.0.1"):
        self.context = context
        self.host = host
        self._want_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._unregister_gauges: Optional[Callable[[], None]] = None
        self.t0 = time.monotonic()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "HealthServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                debug.verbose(4, "health", "rank %d http: " + fmt,
                              server.context.rank, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                try:
                    url = urlparse(self.path)
                    route = url.path.rstrip("/") or "/"
                    if route == "/metrics":
                        body = prometheus_text(server.context).encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif route == "/status":
                        doc = context_status(server.context)
                        doc["uptime_s"] = round(
                            time.monotonic() - server.t0, 3)
                        self._send(200, json.dumps(doc).encode(),
                                   "application/json")
                    elif route == "/healthz":
                        wd = getattr(server.context, "watchdog", None)
                        stalled = bool(wd is not None and wd.stalled)
                        body = json.dumps({
                            "ok": not stalled,
                            "rank": server.context.rank,
                            "stalled": stalled,
                        }).encode()
                        self._send(503 if stalled else 200, body,
                                   "application/json")
                    elif route == "/flightdump":
                        from . import flight

                        if not flight.installed():
                            self._send(404, json.dumps({
                                "error": "no flight recorder installed "
                                         "(PARSEC_TPU_FLIGHT=1)"}).encode(),
                                "application/json")
                            return
                        q = parse_qs(url.query)
                        d = q.get("dir", [None])[0]
                        paths = flight.dump_all(
                            d, reason="flightdump request")
                        self._send(200, json.dumps(
                            {"paths": paths}).encode(), "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:  # the exporter must never die
                    debug.warning("health endpoint %s raised: %s",
                                  self.path, e)
                    try:
                        self._send(500, json.dumps(
                            {"error": str(e)}).encode(),
                            "application/json")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"parsec-health-r{self.context.rank}", daemon=True)
        self._thread.start()
        self._unregister_gauges = register_context_gauges(self.context)
        debug.verbose(2, "health", "rank %d health endpoint at %s",
                      self.context.rank, self.url)
        return self

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._unregister_gauges is not None:
            self._unregister_gauges()
            self._unregister_gauges = None
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------

class StallReport:
    """Structured hang diagnosis: OBS0xx findings + a rendered text."""

    def __init__(self, rank: int, window: float, findings: List[Finding]):
        self.rank = rank
        self.window = window
        self.findings = findings
        self.t = time.time()

    @property
    def errors(self) -> List[Finding]:
        return errors_of(self.findings)

    def render(self) -> str:
        lines = [f"=== watchdog stall report (rank {self.rank}, "
                 f"window {self.window:g}s) ==="]
        lines.extend(str(f) for f in self.findings)
        return "\n".join(lines)

    __str__ = render


class Watchdog:
    """Per-context progress-epoch monitor.

    The *progress epoch* is a tuple of everything that moves when the
    runtime moves: tasks retired per pool (+ per-worker executed counts),
    device tasks, body starts, termdet counter transitions and the
    write-back committer's drain (frames delivered and rank heartbeats
    join with the comm layer, ROADMAP A.8).
    While at least one taskpool is attached and non-terminated, a frozen
    epoch for ``window`` seconds is a stall: the watchdog emits a
    :class:`StallReport` (and in strict mode fails the stalled pools
    with the report as their ``fail_reason``, so ``wait()`` returns
    promptly with an explanation instead of hanging CI).  The flight
    recorder — when installed — is dumped at first firing, so every
    stall leaves trace artifacts."""

    def __init__(self, context, window: Optional[float] = None,
                 poll: Optional[float] = None, strict: bool = False,
                 on_stall: Optional[Callable[[StallReport], None]] = None):
        # rank heartbeats and the periodic clock re-sync ride the comm
        # engine's control channel (ROADMAP A.8): a context carries none
        if getattr(context, "comm", None) is not None:
            raise NotImplementedError(
                "watchdog heartbeats and clock re-sync need the comm layer "
                "(ROADMAP A.8)")
        self.context = context
        if window is None:
            window = float(mca_param.register(
                "runtime", "watchdog_window", 30.0,
                help="seconds without any progress-epoch advance (while "
                     "a taskpool is non-terminated) before the watchdog "
                     "emits a stall diagnosis"))
        self.window = float(window)
        self.poll = float(poll) if poll is not None \
            else max(0.05, self.window / 4)
        self.strict = strict
        self.on_stall = on_stall
        self.stalled = False
        self.last_report: Optional[StallReport] = None
        #: wall-clock time a heartbeat was last received, per peer rank
        self.last_heard: Dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_progress = time.monotonic()
        self._last_epoch: Any = None
        self.t_started = time.monotonic()
        # body-start liveness: counters move on task COMPLETION, so a
        # single body longer than the window would read as a stall.  An
        # EXEC_BEGIN subscription folds body *starts* into the epoch
        # (the window then bounds one body's SILENT run, which is the
        # documented tuning contract) and lets the diagnosis say how
        # many bodies are genuinely in flight.
        self._exec_begins = 0
        self._exec_ends = 0
        from . import pins as _pins

        def _mine(es, task) -> bool:
            # pins are process-global; an in-process mesh runs several
            # contexts, and another rank's bodies must not advance THIS
            # rank's epoch (its stall would hide behind a busy neighbor)
            ctx = getattr(es, "context", None) or getattr(
                getattr(task, "taskpool", None), "context", None)
            return ctx is None or ctx is self.context

        def _on_exec_begin(es, task):
            if _mine(es, task):
                self._exec_begins += 1

        def _on_exec_end(es, task):
            if _mine(es, task):
                self._exec_ends += 1

        self._pins_subs = [(_pins.EXEC_BEGIN, _on_exec_begin),
                           (_pins.EXEC_END, _on_exec_end)]
        for site, cb in self._pins_subs:
            _pins.subscribe(site, cb)
        #: latest clock-sync estimate against rank 0 (comm layer only)
        self.clock_sync: Optional[Dict[str, float]] = None

    # -- epoch ------------------------------------------------------------
    def _active_pools(self) -> List[Any]:
        with self.context._cv:
            return list(self.context._taskpools.values())

    def _epoch(self) -> tuple:
        ctx = self.context
        executed = sum(es.stats["executed"] for es in ctx.streams)
        dev = sum(int(d.stats.get("executed_tasks", 0))
                  for d in ctx.devices)
        # delivered application frames join the epoch with the comm
        # layer (ROADMAP A.8)
        frames = 0
        pools = tuple(sorted(
            (tp.taskpool_id, tp.nb_retired,
             int(getattr(tp.tdm, "_nb_tasks", -1) or 0),
             int(getattr(tp.tdm, "_runtime_actions", -1) or 0))
            for tp in self._active_pools()))
        # async write-back committer drain progress: drained() (committed
        # + dropped-stale) advances whenever the committer lands a batch,
        # so a run blocked on flush() still shows progress while the
        # queue drains — and a WEDGED committer (pending > 0, drained
        # static) lets the stall be declared and diagnosed (OBS011)
        # instead of hanging silently
        wb = 0
        for d in ctx.devices:
            com = getattr(d, "_committer", None)
            if com is not None:
                wb += int(com.drained())
        # NB: a fourcounter's probing waves are deliberately NOT part of
        # the epoch — an unconcludable wave repeats forever on a wedged
        # mesh; its counter transitions surface through the pool tuples
        return (executed, dev, frames, self._exec_begins, wb, pools)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run,
                name=f"parsec-watchdog-r{self.context.rank}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        from . import pins as _pins

        for site, cb in getattr(self, "_pins_subs", ()):
            _pins.unsubscribe(site, cb)
        self._pins_subs = []

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            try:
                self._tick()
            except Exception as e:  # monitoring must never kill the run
                debug.warning("watchdog tick raised: %s", e)

    def _tick(self) -> None:
        epoch = self._epoch()
        now = time.monotonic()
        if epoch != self._last_epoch:
            self._last_epoch = epoch
            self._t_progress = now
            self.stalled = False
            return
        pools = self._active_pools()
        if not pools:
            self._t_progress = now  # idle mesh: nothing CAN progress
            return
        if now - self._t_progress < self.window or self.stalled:
            return
        self.stalled = True
        report = self.diagnose(pools)
        self.last_report = report
        debug.error("%s", report.render())
        from . import flight

        flight.dump_on_failure(f"watchdog stall on rank "
                               f"{self.context.rank}")
        if self.on_stall is not None:
            try:
                self.on_stall(report)
            except Exception as e:
                debug.warning("watchdog on_stall callback raised: %s", e)
        if self.strict:
            self._fail_pools(pools, report)

    def _fail_pools(self, pools: List[Any], report: StallReport) -> None:
        if getattr(self.context, "nranks", 1) > 1:
            raise NotImplementedError(
                "failing stalled pools across ranks needs the comm layer "
                "(ROADMAP A.8)")
        why = ("watchdog: stalled for >= %gs with no progress; %s"
               % (self.window, report.render()))
        for tp in pools:
            try:
                tp.fail(why)
            except Exception as e:
                debug.warning("watchdog could not fail pool %s: %s",
                              getattr(tp, "name", tp), e)

    # -- diagnosis --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        now = time.time()
        return {
            "installed": True,
            "strict": self.strict,
            "window_s": self.window,
            "stalled": self.stalled,
            "last_progress_age_s": round(
                time.monotonic() - self._t_progress, 3),
            # dict() snapshot: the comm thread inserts first-heard peers
            # concurrently, and a growing dict kills a bare iteration
            "last_heard_age_s": {
                r: round(now - t, 3) for r, t in
                sorted(dict(self.last_heard).items())},
            "clock_sync": self.clock_sync,
            "report": self.last_report.render()
            if self.last_report is not None else None,
        }

    def diagnose(self, pools: Optional[List[Any]] = None) -> StallReport:
        """Build the structured hang diagnosis (callable on demand, not
        only from the monitor thread)."""
        ctx = self.context
        if pools is None:
            pools = self._active_pools()
        findings: List[Finding] = []
        age = time.monotonic() - self._t_progress
        pool_names = ", ".join(
            f"{tp.name}#{tp.taskpool_id}" for tp in pools) or "(none)"
        inflight = max(0, self._exec_begins - self._exec_ends)
        # an idle context (no live pool, no declared stall) has nothing
        # that could progress: no OBS001, as _tick never declares it
        if pools or self.stalled:
            findings.append(Finding(
                "OBS001",
                f"rank {ctx.rank}: no progress for {age:.1f}s (window "
                f"{self.window:g}s); non-terminated taskpool(s): "
                f"{pool_names}; {inflight} task bod"
                + ("y" if inflight == 1 else "ies")
                + " in flight (a body silent longer than the window looks "
                  "identical to a wedge — raise runtime_watchdog_window if "
                  "that is legitimate here)"))

        # serving plane: name the tenant whose pool is wedged FIRST —
        # on a multi-tenant mesh "which client is stuck" is the page
        # the operator acts on before any protocol-level finding
        for tp in pools:
            tenant = getattr(tp, "tenant", None)
            if not tenant:
                continue
            prog = tp.progress()
            pos = f"{prog['retired']}"
            if prog["known"] is not None:
                pos += f"/{prog['known']}"
            findings.append(Finding(
                "OBS008",
                f"tenant {tenant!r}: job pool "
                f"{tp.name}#{tp.taskpool_id} stalled at {pos} tasks "
                f"retired (job priority "
                f"{getattr(tp, 'job_priority', 0)}, tenant weight "
                f"{getattr(tp, 'tenant_weight', 1)})",
                task=tenant))

        for tp in pools:
            prog = tp.progress()
            remaining = None
            if prog["known"] is not None:
                remaining = prog["known"] - prog["retired"]
            # pending tasks per class + nonzero dep counters
            deps = getattr(tp, "deps", None)
            pending = []
            if deps is not None and hasattr(deps, "pending_keys"):
                try:
                    pending = deps.pending_keys()
                except Exception as e:
                    debug.verbose(3, "health",
                                  "pending_keys raised: %s", e)
            if pending:
                per_class: Dict[str, int] = {}
                sample: Dict[str, Any] = {}
                for key in pending:
                    cname = str(key[0]) if isinstance(key, tuple) \
                        and len(key) == 2 else "?"
                    per_class[cname] = per_class.get(cname, 0) + 1
                    sample.setdefault(cname, key)
                for cname in sorted(per_class):
                    findings.append(Finding(
                        "OBS002",
                        f"taskpool {tp.name}#{tp.taskpool_id}: "
                        f"{per_class[cname]} partially-released dep "
                        f"counter(s) on class {cname!r} (e.g. "
                        f"{sample[cname]!r}) — a released-by-subset "
                        f"task is waiting on a producer that never "
                        f"fired",
                        task=cname, count=per_class[cname]))
            elif remaining:
                findings.append(Finding(
                    "OBS001",
                    f"taskpool {tp.name}#{tp.taskpool_id}: "
                    f"{prog['retired']}/{prog['known']} tasks retired, "
                    f"{remaining} outstanding with NO pending dep "
                    f"counters — the missing tasks were never released "
                    f"(lost activation, or startup never enumerated "
                    f"them)"))

        # rendezvous pulls (OBS003), collectives (OBS007), the fourcounter
        # (OBS005) and silent ranks (OBS004) come with the comm layer
        # (ROADMAP A.8)

        # scheduler backlog frozen?
        backlog = int(ctx.scheduler.pending_estimate())
        if backlog > 0:
            findings.append(Finding(
                "OBS006",
                f"rank {ctx.rank}: {backlog} ready task(s) queued but "
                f"none retiring", count=backlog))

        # wedged async write-back committer (OBS011): deferred commits
        # pending but the drain counter is static (the epoch tuple
        # carries drained(), so pending-with-progress never lands here —
        # diagnose only runs once the WHOLE epoch froze)
        for d in ctx.devices:
            com = getattr(d, "_committer", None)
            if com is None:
                continue
            pending = int(com.pending())
            if pending > 0 or not com.healthy:
                state = "dead" if not com.healthy else "wedged"
                err = getattr(com, "error", None)
                findings.append(Finding(
                    "OBS011",
                    f"device {d.name}: async write-back committer "
                    f"{state} with {pending} deferred commit(s) "
                    f"pending ({int(com.pending_bytes())} bytes; "
                    f"{int(com.drained())} drained so far"
                    + (f"; error: {err!r}" if err is not None else "")
                    + ") — detach()/flush() would block until the "
                      "capacity timeout", count=pending))

        # SLO plane: breached per-tenant p95 targets (OBS009) and
        # straggling (class, rank) pairs incl. late heartbeaters
        # (OBS010) — the serving-side "why is THIS slow" findings
        slo = getattr(ctx, "slo", None)
        if slo is not None:
            try:
                findings.extend(slo.slo_findings())
                now = time.time()
                ages = {r: now - t
                        for r, t in dict(self.last_heard).items()}
                findings.extend(slo.straggler_findings(
                    heartbeat_ages=ages,
                    late_after=max(2.0, 3 * self.poll)))
            except Exception as e:  # diagnosis must never raise
                debug.warning("slo findings failed: %s", e)

        return StallReport(ctx.rank, self.window, findings)
