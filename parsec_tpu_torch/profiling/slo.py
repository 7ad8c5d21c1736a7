"""SLO plane: mergeable latency histograms, targets, straggler digests.

The port of :mod:`parsec_tpu.profiling.slo`.  Latency *distributions* as
histograms with FIXED log-spaced bucket bounds, so a mesh-wide view is an
element-wise add of per-rank bucket arrays (the Prometheus
classic-histogram model: ``_bucket``/``_sum``/``_count`` families render
off the same state):

* :class:`Histogram` — log-bucketed, one uncontended lock per observe,
  mergeable because every instance shares :data:`BUCKET_BOUNDS_S`;
* :class:`SloPlane` — the per-context recorder: task exec time per class
  (EXEC pins), and job latency and queue delay per tenant (fed by
  :class:`~parsec_tpu_torch.serve.RuntimeService`).  Per-tenant targets
  (MCA ``serve_slo_p95_ms``, or ``Tenant.slo_p95_ms``) are evaluated
  continuously: every job past its target counts into
  ``parsec_slo_violations_total``, and a tenant whose live p95 exceeds its
  target is an **OBS009** finding in the watchdog's report;
* **straggler attribution** (:func:`mesh_stragglers`, shared with the
  offline ``profiling.critpath`` report) — per-(class, rank) exec digests
  against the mesh median, **OBS010**.

The collective-segment observer (COLL pins, fired by the collectives:
``parsec_coll_segment_seconds``) and the comm round-trip observer are
subscribed.  Peer digests arrive on the watchdog's heartbeats
and round-trip times on its clock re-syncs.  Exported through the
health plane: histogram families on ``/metrics``, a ``slo`` section in
``/status``, and the findings in the watchdog's report.  Enable standalone
with ``PARSEC_TPU_SLO=1`` (a ``RuntimeService`` installs one on its
context unless ``PARSEC_TPU_SLO=0``).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.findings import Finding
from ..utils import debug, mca_param
from . import pins

__all__ = ["BUCKET_BOUNDS_S", "Histogram", "SloPlane"]

#: FIXED histogram bucket upper bounds, seconds (log-spaced, 2x steps:
#: 100 µs .. ~839 s; the last implicit bucket is +Inf).  Fixed-for-all
#: is what makes rank merges element-wise adds — never make these
#: configurable per instance.
BUCKET_BOUNDS_S: Tuple[float, ...] = tuple(1e-4 * (2.0 ** i)
                                           for i in range(24))


class Histogram:
    """A log-bucketed latency histogram over :data:`BUCKET_BOUNDS_S`.

    ``counts`` has ``len(BUCKET_BOUNDS_S) + 1`` slots; slot ``i`` counts
    observations ``v <= BUCKET_BOUNDS_S[i]`` (last slot: overflow, the
    +Inf bucket).  Two histograms merge by element-wise adding counts
    (+ sum/count) — the cross-rank aggregation contract the tests pin."""

    __slots__ = ("counts", "sum", "count", "_lock")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS_S) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        if v < 0 or v != v:  # negative clock skew / NaN: drop, not poison
            return
        i = bisect_left(BUCKET_BOUNDS_S, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def merge(self, other: "Histogram") -> None:
        snap = other.snapshot()
        self.merge_snapshot(snap)

    def merge_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fold a :meth:`snapshot` (possibly from another rank/process)
        in: element-wise bucket adds — boundaries are fixed, so there is
        nothing to reconcile."""
        counts = snap["counts"]
        if len(counts) != len(self.counts):
            raise ValueError(
                f"histogram shape mismatch: {len(counts)} buckets vs "
                f"{len(self.counts)} (different BUCKET_BOUNDS_S?)")
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += int(c)
            self.sum += float(snap["sum"])
            self.count += int(snap["count"])

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1) by linear interpolation inside
        the holding bucket (the Prometheus ``histogram_quantile``
        estimator); None when empty.  The +Inf bucket reports the last
        finite bound."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total <= 0:
            return None
        rank = q * total
        acc = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            if acc + c >= rank:
                hi = BUCKET_BOUNDS_S[i] if i < len(BUCKET_BOUNDS_S) \
                    else BUCKET_BOUNDS_S[-1]
                lo = BUCKET_BOUNDS_S[i - 1] if i > 0 else 0.0
                frac = (rank - acc) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            acc += c
        return BUCKET_BOUNDS_S[-1]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counts": list(self.counts), "sum": self.sum,
                    "count": self.count}


def mesh_stragglers(by_class: Dict[str, Dict[Any, Tuple[int, float]]],
                    factor: float, min_samples: int
                    ) -> List[Tuple[str, Any, float, float, float]]:
    """THE straggler comparison, shared by the live plane
    (:meth:`SloPlane.stragglers`, heartbeat-gossiped digests) and the
    offline one (``profiling.critpath``, trace-derived means) so the
    two reports cannot drift: per class, per-rank mean exec times
    (``{cls: {rank: (count, mean)}}``, any consistent time unit) are
    compared against the mesh median of per-rank means.  Pairs need
    ``min_samples`` observations, a class needs >= 2 reporting ranks (a
    median of one is a tautology).  Returns sorted
    ``(cls, rank, mean, median, ratio)`` tuples for ratios past
    ``factor``."""
    out: List[Tuple[str, Any, float, float, float]] = []
    for cls, per_rank in sorted(by_class.items()):
        means = sorted(m for (n, m) in per_rank.values()
                       if n >= min_samples)
        if len(means) < 2:
            continue
        med = means[len(means) // 2]
        if med <= 0:
            continue
        for rank, (n, mean) in sorted(per_rank.items(),
                                      key=lambda kv: str(kv[0])):
            if n >= min_samples and mean / med > factor:
                out.append((cls, rank, mean, med, mean / med))
    return out


def straggler_params() -> Tuple[float, int]:
    """The MCA-tuned (factor, min_samples) thresholds — one source for
    the live OBS010 plane and the offline critpath report."""
    factor = float(mca_param.register(
        "runtime", "straggler_factor", 3.0,
        help="a rank running a task class this many times slower "
             "than the mesh median of per-rank means is flagged as "
             "a straggler (OBS010)"))
    min_samples = int(mca_param.register(
        "runtime", "straggler_min_samples", 5,
        help="per-(class, rank) exec samples required before the "
             "straggler comparison considers the pair"))
    return factor, min_samples


def prometheus_histogram_lines(name: str, labels: Dict[str, Any],
                               snap: Dict[str, Any],
                               out: List[str]) -> None:
    """Append one classic Prometheus histogram family member
    (cumulative ``_bucket`` series with ``le`` labels + ``_sum`` +
    ``_count``) rendered from a :meth:`Histogram.snapshot`."""
    def esc(v: Any) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    base = ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())
    cum = 0
    for i, c in enumerate(snap["counts"]):
        cum += int(c)
        le = f"{BUCKET_BOUNDS_S[i]:.6g}" if i < len(BUCKET_BOUNDS_S) \
            else "+Inf"
        lab = (base + "," if base else "") + f'le="{le}"'
        out.append(f"{name}_bucket{{{lab}}} {cum}")
    body = f"{{{base}}}" if base else ""
    out.append(f"{name}_sum{body} {float(snap['sum']):.9g}")
    out.append(f"{name}_count{body} {int(snap['count'])}")


# the exported histogram families (OPERATIONS.md "SLO histograms")
FAMILIES = {
    "job_latency": ("parsec_job_latency_seconds",
                    "submit-to-done wall clock per job"),
    "job_queue_delay": ("parsec_job_queue_delay_seconds",
                        "submit-to-admit queueing delay per job"),
    "task_exec": ("parsec_task_exec_seconds",
                  "task body execution time per class"),
    "comm_rtt": ("parsec_comm_rtt_seconds",
                 "comm-engine round-trip time (clock handshakes and "
                 "watchdog re-syncs)"),
    "coll_segment": ("parsec_coll_segment_seconds",
                     "runtime-collective per-segment landing time"),
}


class SloPlane:
    """Per-context SLO recorder (hangs off ``ctx.slo``).  Installation
    subscribes the EXEC / COLL pins; uninstall is symmetric.  All hot
    paths are a dict lookup + one histogram observe."""

    def __init__(self, context):
        self.context = context
        self.factor, self.min_samples = straggler_params()
        self.default_slo_ms = float(mca_param.register(
            "serve", "slo_p95_ms", 0.0,
            help="default per-tenant p95 job-latency SLO target in "
                 "milliseconds (0 = no target; a Tenant's slo_p95_ms "
                 "field overrides per tenant).  Violations count into "
                 "parsec_slo_violations_total and surface as OBS009"))
        self._lock = threading.Lock()
        #: (family, label-items tuple) -> Histogram
        self._hists: Dict[Tuple[str, Tuple], Histogram] = {}
        #: class -> [count, sum_seconds] exec digest (straggler currency)
        self._exec: Dict[str, List[float]] = {}
        #: peer rank -> {"t": wall, "exec": {cls: (count, mean_s)}}
        self._peers: Dict[int, Dict[str, Any]] = {}
        #: tenant -> violation count / target / last p95
        self._violations: Dict[str, int] = {}
        self._targets: Dict[str, float] = {}
        self._t0: Dict[int, int] = {}          # id(task) -> exec t0 ns
        self._coll_last: Dict[int, float] = {}  # coll token -> last ts
        self._subs: List[Any] = []
        self._installed = False
        self.install()

    # -- lifecycle --------------------------------------------------------
    def install(self) -> "SloPlane":
        if self._installed:
            return self
        self._installed = True

        def sub(site, cb):
            pins.subscribe(site, cb)
            self._subs.append((site, cb))

        def _mine(es, task) -> bool:
            ctx = getattr(es, "context", None) or getattr(
                getattr(task, "taskpool", None), "context", None)
            return ctx is None or ctx is self.context

        def on_exec_begin(es, task):
            if _mine(es, task):
                self._t0[id(task)] = time.monotonic_ns()

        # per-class histogram cache: the exec-end path runs once per
        # task — skip the generic (family, labels) tuple key on repeats
        exec_hists: Dict[str, Histogram] = {}

        def on_exec_end(es, task):
            t0 = self._t0.pop(id(task), None)
            if t0 is None or not _mine(es, task):
                return
            dt = (time.monotonic_ns() - t0) / 1e9
            cls = getattr(getattr(task, "task_class", None), "name",
                          type(task).__name__)
            h = exec_hists.get(cls)
            if h is None:
                h = exec_hists[cls] = self.hist("task_exec",
                                                ("class", cls))
            h.observe(dt)
            with self._lock:
                d = self._exec.setdefault(cls, [0, 0.0])
                d[0] += 1
                d[1] += dt

        sub(pins.EXEC_BEGIN, on_exec_begin)
        sub(pins.EXEC_END, on_exec_end)

        rank = getattr(self.context, "rank", 0)

        def on_coll_begin(es, p):
            p = p or {}
            if p.get("rank", rank) == rank:
                self._coll_last[int(p.get("id", 0))] = time.monotonic()

        def on_coll_seg(es, p):
            p = p or {}
            if p.get("rank", rank) != rank:
                return
            tok = int(p.get("id", 0))
            now = time.monotonic()
            last = self._coll_last.get(tok)
            self._coll_last[tok] = now
            if last is not None:
                self.hist("coll_segment", ()).observe(now - last)

        def on_coll_end(es, p):
            p = p or {}
            if p.get("rank", rank) == rank:
                self._coll_last.pop(int(p.get("id", 0)), None)

        sub(pins.COLL_BEGIN, on_coll_begin)
        sub(pins.COLL_SEG, on_coll_seg)
        sub(pins.COLL_END, on_coll_end)
        return self

    def uninstall(self) -> None:
        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        self._subs = []
        self._installed = False

    # -- observation API --------------------------------------------------
    def hist(self, family: str, *label_items: Tuple[str, Any]) -> Histogram:
        key = (family, tuple(label_items))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(key, Histogram())
        return h

    def observe_rtt(self, seconds: float) -> None:
        self.hist("comm_rtt", ()).observe(seconds)

    def observe_job(self, tenant: str, latency_s: Optional[float],
                    queue_delay_s: Optional[float],
                    target_ms: Optional[float] = None) -> None:
        """One terminal job outcome.  ``target_ms`` None falls back to
        the ``serve_slo_p95_ms`` default; a latency past the target is
        one SLO violation (the counter is monotonic — Prometheus
        contract)."""
        tgt = self.default_slo_ms if target_ms is None else float(target_ms)
        with self._lock:
            if tgt > 0:
                self._targets[tenant] = tgt
        if queue_delay_s is not None:
            self.hist("job_queue_delay",
                      ("tenant", tenant)).observe(queue_delay_s)
        if latency_s is None:
            return
        self.hist("job_latency", ("tenant", tenant)).observe(latency_s)
        if tgt > 0 and latency_s * 1e3 > tgt:
            with self._lock:
                self._violations[tenant] = \
                    self._violations.get(tenant, 0) + 1
            debug.verbose(2, "health",
                          "slo violation: tenant %r job latency %.1f ms "
                          "> target %.1f ms", tenant, latency_s * 1e3, tgt)

    # -- straggler digests ------------------------------------------------
    def exec_digest(self) -> Dict[str, Tuple[int, float]]:
        """{class: (count, mean_seconds)} for THIS rank — the compact
        form the watchdog piggybacks on its heartbeats."""
        with self._lock:
            return {cls: (int(d[0]), d[1] / d[0])
                    for cls, d in self._exec.items() if d[0] > 0}

    def note_peer_digest(self, rank: int, digest: Dict[str, Any]) -> None:
        """Fold a peer rank's heartbeat digest in (comm thread)."""
        try:
            parsed = {str(c): (int(v[0]), float(v[1]))
                      for c, v in dict(digest).items()}
        except (TypeError, ValueError, IndexError):
            return  # malformed gossip must never hurt the receiver
        with self._lock:
            self._peers[int(rank)] = {"t": time.time(), "exec": parsed}

    def _mesh_exec(self) -> Dict[str, Dict[int, Tuple[int, float]]]:
        """{class: {rank: (count, mean_s)}} across self + heard peers."""
        out: Dict[str, Dict[int, Tuple[int, float]]] = {}
        my_rank = getattr(self.context, "rank", 0)
        for cls, cm in self.exec_digest().items():
            out.setdefault(cls, {})[my_rank] = cm
        with self._lock:
            peers = {r: dict(p["exec"]) for r, p in self._peers.items()}
        for r, digest in peers.items():
            for cls, cm in digest.items():
                out.setdefault(cls, {})[r] = cm
        return out

    def stragglers(self) -> List[Dict[str, Any]]:
        """Per-(class, rank) outliers vs the mesh median of per-rank
        means (:func:`mesh_stragglers` — shared with the offline
        critpath report): ``[{class, rank, mean_ms, mesh_median_ms,
        factor, jobs}]``."""
        return [{
            "class": cls, "rank": r,
            "mean_ms": round(mean * 1e3, 3),
            "mesh_median_ms": round(med * 1e3, 3),
            "factor": round(ratio, 2),
            "jobs": self._jobs_with_class(cls),
        } for cls, r, mean, med, ratio in mesh_stragglers(
            self._mesh_exec(), self.factor, self.min_samples)]

    def _jobs_with_class(self, cls: str) -> List[str]:
        """In-flight serve jobs whose pools carry ``cls`` — the 'jobs it
        is currently stalling' attribution of OBS010."""
        sv = getattr(self.context, "serve", None)
        if sv is None:
            return []
        jobs: List[str] = []
        try:
            with sv._lock:
                inflight = list(sv._inflight.values())
            for h in inflight:
                classes = {tc.name for tc in
                           h.taskpool.task_classes.values()}
                if cls in classes:
                    jobs.append(f"{h.tenant.name}/#{h.job_id}")
        except Exception as e:  # diagnosis must never raise
            debug.verbose(3, "health", "job attribution failed: %s", e)
        return jobs

    # -- findings (watchdog report + /status) -----------------------------
    def slo_findings(self) -> List[Finding]:
        """OBS009 per tenant whose live p95 exceeds its target."""
        findings: List[Finding] = []
        with self._lock:
            targets = dict(self._targets)
            violations = dict(self._violations)
        for tenant, tgt in sorted(targets.items()):
            h = self._hists.get(("job_latency", (("tenant", tenant),)))
            if h is None:
                continue
            p95 = h.percentile(0.95)
            if p95 is None:
                continue
            n_viol = violations.get(tenant, 0)
            if p95 * 1e3 > tgt and n_viol > 0:
                findings.append(Finding(
                    "OBS009",
                    f"tenant {tenant!r}: job latency p95 "
                    f"{p95 * 1e3:.1f} ms exceeds the "
                    f"{tgt:g} ms SLO target ({n_viol} violating job(s) "
                    f"of {h.count})", task=tenant, count=n_viol))
        return findings

    def straggler_findings(
            self, heartbeat_ages: Optional[Dict[int, float]] = None,
            late_after: Optional[float] = None) -> List[Finding]:
        """OBS010 per straggling (class, rank) pair; with heartbeat ages
        (watchdog ``last_heard``) also flags late-but-not-silent ranks."""
        findings: List[Finding] = []
        for s in self.stragglers():
            stalling = (" — stalling job(s): " + ", ".join(s["jobs"])) \
                if s["jobs"] else ""
            findings.append(Finding(
                "OBS010",
                f"rank {s['rank']}: class {s['class']!r} runs "
                f"{s['factor']}x slower than the mesh median "
                f"({s['mean_ms']:g} ms vs {s['mesh_median_ms']:g} ms "
                f"median){stalling}", task=s["class"]))
        if heartbeat_ages and late_after:
            for r, age in sorted(heartbeat_ages.items()):
                if age >= late_after:
                    findings.append(Finding(
                        "OBS010",
                        f"rank {r}: heartbeating late — last heard "
                        f"{age:.1f}s ago (>= {late_after:g}s)"))
        return findings

    # -- export -----------------------------------------------------------
    def violations_total(self) -> int:
        with self._lock:
            return sum(self._violations.values())

    def violations_by_tenant(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._violations)

    def tenant_p95_ms(self, tenant: str) -> Optional[float]:
        h = self._hists.get(("job_latency", (("tenant", tenant),)))
        p = h.percentile(0.95) if h is not None else None
        return round(p * 1e3, 3) if p is not None else None

    def status(self) -> Dict[str, Any]:
        """The ``slo`` section of ``/status`` (JSON-ready)."""
        with self._lock:
            hists = {f"{fam}{dict(lbl) or ''}": h.snapshot()
                     for (fam, lbl), h in sorted(self._hists.items(),
                                                 key=lambda kv: str(kv[0]))}
            targets = dict(self._targets)
            violations = dict(self._violations)
        return {
            "bucket_bounds_s": list(BUCKET_BOUNDS_S),
            "histograms": hists,
            "targets_ms": targets,
            "violations": violations,
            "violations_total": sum(violations.values()),
            "stragglers": self.stragglers(),
            "straggler_factor": self.factor,
        }

    def prometheus_lines(self, rank: int, out: List[str]) -> None:
        """Append the histogram families + the violations counter in
        Prometheus text form (called by ``health.prometheus_text``)."""
        with self._lock:
            items = sorted(self._hists.items(), key=lambda kv: str(kv[0]))
        by_family: Dict[str, List] = {}
        for (fam, lbl), h in items:
            by_family.setdefault(fam, []).append((dict(lbl), h.snapshot()))
        for fam, (prom, help_) in FAMILIES.items():
            members = by_family.get(fam)
            if not members:
                continue
            out.append(f"# HELP {prom} {help_}")
            out.append(f"# TYPE {prom} histogram")
            for labels, snap in members:
                prometheus_histogram_lines(
                    prom, {"rank": rank, **labels}, snap, out)
        out.append("# TYPE parsec_slo_violations_total counter")
        viol = self.violations_by_tenant()
        out.append(f'parsec_slo_violations_total{{rank="{rank}"}} '
                   f"{sum(viol.values())}")
        for tenant, n in sorted(viol.items()):
            out.append(
                f'parsec_slo_violations_total{{rank="{rank}",'
                f'tenant="{tenant}"}} {n}')
        stragglers = self.stragglers()
        out.append("# TYPE parsec_straggler_ranks gauge")
        out.append(f'parsec_straggler_ranks{{rank="{rank}"}} '
                   f"{len({s['rank'] for s in stragglers})}")


def merge_status_histograms(snaps: List[Dict[str, Any]]) -> Histogram:
    """Fold several :meth:`Histogram.snapshot` dicts (e.g. the same
    family scraped from every rank's ``/status``) into one histogram —
    the element-wise mesh aggregation ``tools top`` renders."""
    h = Histogram()
    for s in snaps:
        h.merge_snapshot(s)
    return h
