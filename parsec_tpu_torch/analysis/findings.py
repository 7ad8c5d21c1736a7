"""Finding model for the ahead-of-time PTG/JDF graph verifier and the
runtime checkers.

The port of :mod:`parsec_tpu.analysis.findings`: the same stable codes,
severities and locations, so tools and tests key on codes instead of
message text.  The reference's ``jdfc`` compiler rejects malformed
``.jdf`` graphs at compile time (unconnected flows, unbound locals —
``jdf.c:jdf_sanity_checks``); findings carry the same role for the
runtime-built PTGs (``tools lint``, ``jdfc --strict``,
``PARSEC_TPU_LINT``), for the happens-before and lock-order checkers
(``RTxxx``), the engine verifier (``ENGxxx``) and the parameter-table
lint (``DOCxxx``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

ERROR = "error"
WARNING = "warning"
#: advisory findings: surfaced by tools and sweeps, never fatal — not
#: even under ``--strict`` (the contract of PTG060 fusion hints)
INFO = "info"

#: stable code -> (severity, one-line description).  Codes are append-only:
#: tools and user suppressions (``ignore=("PTG021",)``) depend on them.
CODES = {
    "PTG001": (ERROR, "output dependency has no reciprocal input on the "
                      "consumer flow"),
    "PTG002": (ERROR, "input dependency has no reciprocal output on the "
                      "producer flow (asymmetric deps: the consumer would "
                      "hang or hit a repo miss)"),
    "PTG010": (ERROR, "write-after-write hazard: two tasks write the same "
                      "collection tile with no dependency path between them"),
    "PTG011": (ERROR, "unordered read/write hazard (RAW/WAR): a read of a "
                      "collection tile races a write with no dependency path"),
    "PTG020": (ERROR, "dependency cycle: the instantiated task DAG cannot "
                      "be topologically ordered"),
    "PTG021": (ERROR, "no input dependency matches: with static guards the "
                      "task can never fire (add an explicit '<- NONE' "
                      "fallback, or ignore this code for dynamic guards)"),
    "PTG022": (WARNING, "ambiguous input: more than one guard-true non-NONE "
                        "input dependency (single-assignment: first wins)"),
    "PTG030": (ERROR, "unbound symbol in a dependency/range/affinity/"
                      "priority expression"),
    "PTG031": (ERROR, "collection key out of bounds for the collection's "
                      "declared tile grid"),
    "PTG032": (ERROR, "unknown collection in a data reference"),
    "PTG033": (ERROR, "bad task reference: unknown task class, unknown "
                      "flow, or wrong argument count"),
    "PTG034": (ERROR, "range expression in a data-flow input argument "
                      "(data inputs are single-assignment scalars)"),
    "PTG035": (WARNING, "readable flow declares no input dependencies"),
    "PTG040": (WARNING, "write-back target is owned by a different rank "
                        "than the task's affinity (extra cross-rank "
                        "traffic)"),
    "PTG050": (WARNING, "parameter space exceeds the lint cap; "
                        "instance-level checks were skipped"),
    "PTG051": (ERROR, "graph instantiation failed while evaluating "
                      "dependency expressions"),
    "PTG060": (INFO, "fusible chain/wave: the supertask partitioner "
                     "(dsl.fusion) would coarsen these tasks into one "
                     "dispatch under runtime_fusion; advisory only"),
    # RT0xx: RUNTIME findings (analysis.hb happens-before checker,
    # analysis.lockdep) — unordered pairs of runtime events, not graph
    # defects.  Same append-only contract as PTGxxx.
    "RT001": (ERROR, "unordered conflicting writes to the same tile "
                     "version: two version commits with no happens-before "
                     "path between them (the payload writes race)"),
    "RT002": (ERROR, "arena slot recycled twice with no intervening "
                     "allocation (a finalizer racing an explicit release "
                     "would corrupt the free list)"),
    "RT003": (ERROR, "dependency counter decremented after its task "
                     "already fired (duplicate or late release: the "
                     "successor ran without this input, or would fire "
                     "twice)"),
    "RT004": (WARNING, "comm frame delivered with no matching send event "
                       "(incomplete trace, or a transport path bypassing "
                       "the frame protocol)"),
    "RT005": (ERROR, "native task_done accepted twice for one task "
                     "(double-complete guard bypassed: successors would "
                     "double-release)"),
    "RT010": (ERROR, "inconsistent lock acquisition order between two "
                     "lock sites (A->B and B->A both observed: potential "
                     "deadlock)"),
    # OBS0xx: OBSERVABILITY findings (profiling.health watchdog) — the
    # structured hang diagnosis a stalled mesh emits instead of a silent
    # timeout.  Same append-only contract as PTGxxx/RTxxx.
    "OBS001": (ERROR, "stalled run: no progress epoch advance (tasks "
                      "retired, frames delivered, termdet transitions) "
                      "within the watchdog window while a taskpool is "
                      "non-terminated"),
    "OBS002": (ERROR, "dependency counters pending at stall: a task was "
                      "released by only a strict subset of its producers "
                      "(the runtime signature of the asymmetric-deps "
                      "defects ptg-lint flags as PTG001/PTG002)"),
    "OBS003": (WARNING, "rendezvous pulls still in flight at stall: "
                        "payload chunks were requested but never landed "
                        "(lost GET answer, or a wedged peer)"),
    "OBS004": (WARNING, "silent rank: no heartbeat heard from a peer "
                        "within the watchdog window (dead process, or a "
                        "wedged delivery path toward this rank)"),
    "OBS005": (WARNING, "distributed termination detection cannot "
                        "conclude: the piggybacked picture stays busy or "
                        "the sent/recv totals never balance (a message "
                        "is counted in flight forever)"),
    "OBS006": (WARNING, "ready tasks queued but none retiring: the "
                        "scheduler backlog is frozen (workers wedged, or "
                        "every ready task blocked inside its body)"),
    "OBS007": (WARNING, "collective operation in flight at stall: a "
                        "started allreduce/reduce-scatter/allgather/"
                        "bcast/redistribution never completed (a group "
                        "rank never joined, or its segments stopped "
                        "landing) — the finding names the op and its "
                        "step position"),
    "OBS008": (ERROR, "tenant job stalled: a serving-plane taskpool "
                      "stopped progressing — the finding names the "
                      "tenant, the job, and its retired/known position, "
                      "so the operator knows WHOSE workload is wedged "
                      "(and which client to page) before reading the "
                      "protocol-level findings"),
    "OBS009": (ERROR, "SLO violation: a tenant's observed p95 job "
                      "latency exceeds its serve_slo_p95_ms target "
                      "(profiling.slo histograms; the finding names the "
                      "tenant, the measured p95 and the violating job "
                      "count — parsec_slo_violations_total carries the "
                      "monotone counter)"),
    "OBS010": (WARNING, "straggler rank: a rank runs a task class "
                        "runtime_straggler_factor times slower than the "
                        "mesh median of per-rank means (or its "
                        "heartbeats arrive late) — the finding names "
                        "the rank, the class, and the in-flight jobs "
                        "it is currently stalling"),
    "OBS011": (WARNING, "wedged write-back committer: deferred "
                        "device->host commits are pending but the "
                        "committer's drain counter is static (or the "
                        "committer thread died) — detach()/flush() "
                        "would block; the finding names the device, "
                        "the pending count/bytes and any stored error"),
    # ENG0xx: NATIVE-ENGINE findings (native.abi ABI contract lint,
    # analysis.engine_verify lifecycle model checker + conformance
    # replay + clang-tidy gate) — defects of the C++ engine, its ctypes
    # boundary, or its event drain.  Same append-only contract.
    "ENG001": (ERROR, "ABI: a symbol the spec declares is missing from "
                      "the built native library (stale .so, or the "
                      "definition was dropped)"),
    "ENG002": (ERROR, "ABI: the native core exports a pz_*/pt_* entry "
                      "point the ABI spec does not declare (undeclared "
                      "export: ctypes callers would bind it blind)"),
    "ENG003": (ERROR, "ABI: signature drift between the declarative "
                      "spec and the extern \"C\" prototype in "
                      "native/src/ (argument or return type mismatch "
                      "at the ctypes boundary corrupts silently)"),
    "ENG004": (ERROR, "ABI: the spec declares an entry point that "
                      "native/src/ does not define"),
    "ENG005": (WARNING, "ABI: the built native library is older than "
                        "native/src/ (stale build — rebuild before "
                        "trusting any engine behavior)"),
    "ENG006": (ERROR, "ABI: trace record layout drift between the "
                      "spec, trace.cpp's struct Record, and the "
                      "Python .pbt reader (on-disk corruption)"),
    "ENG010": (ERROR, "model: a task did not retire exactly once "
                      "(lost or duplicated retire in an explored "
                      "interleaving)"),
    "ENG011": (ERROR, "model: quiescence declared while a task was "
                      "still in flight (early quiesce would drop "
                      "in-flight work on the floor)"),
    "ENG012": (ERROR, "model: event-drain defect — an EVT_DEP_DEC/"
                      "EVT_PUBLISH/EVT_RETIRE was dropped, duplicated, "
                      "or drained in an order inconsistent with "
                      "happens-before (the drain lied; every RT0xx "
                      "verdict built on it is untrustworthy)"),
    "ENG013": (ERROR, "model: wdrr starvation — a nonempty tenant bin "
                      "was never served while another tenant popped "
                      "(deficit round robin lost a bin)"),
    "ENG014": (ERROR, "conformance: the real engine's drained event "
                      "stream diverges from the lifecycle model "
                      "(infeasible count, order, or quiescence edge)"),
    "ENG020": (ERROR, "clang-tidy diagnostic in native/src/ (the "
                      "zero-warning gate: fix it or add a documented "
                      "suppression)"),
    "ENG021": (INFO, "clang tooling unavailable: the C++ static-"
                     "analysis leg was skipped, not passed"),
    # DOC0xx: DOCUMENTATION-DRIFT findings (analysis.doc_lint) — the
    # operator-facing docs and the source tree disagree.
    "DOC001": (ERROR, "registered MCA param is not documented in "
                      "the parameter table (operators cannot discover "
                      "the knob)"),
    "DOC002": (ERROR, "the parameter table documents an MCA param no "
                      "source registers (removed knob, or a typo in "
                      "the row)"),
}


@dataclass(frozen=True)
class Finding:
    """One verifier diagnostic.

    ``task``/``flow``/``env`` locate the finding: the task class name, the
    flow name, and the concrete parameter binding (locals tuple) of the
    first offending instance (``None`` for purely static findings).
    ``dep`` is the offending dependency's source text when one exists
    (for hazard findings, which have no single dep, it anchors the
    conflicting collection tile instead), ``count`` how many instances
    exhibited the same defect (findings are deduplicated per
    (code, task, flow, dep))."""

    code: str
    message: str
    task: Optional[str] = None
    flow: Optional[str] = None
    env: Optional[Tuple] = None
    dep: Optional[str] = None
    count: int = 1

    @property
    def severity(self) -> str:
        return CODES.get(self.code, (ERROR, ""))[0]

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self) -> str:
        where = ""
        if self.task is not None:
            where = self.task
            if self.env is not None:
                where += repr(tuple(self.env))
            if self.flow is not None:
                where += f".{self.flow}"
            where = f" {where}:"
        dep = f" [{self.dep}]" if self.dep else ""
        more = f" (+{self.count - 1} more instance(s))" if self.count > 1 else ""
        return f"{self.code} {self.severity}:{where} {self.message}{dep}{more}"


class LintError(ValueError):
    """Raised by strict-mode entry points (``jdfc --strict``,
    ``PARSEC_TPU_LINT=strict``) when the verifier reports findings."""

    def __init__(self, msg: str, findings):
        super().__init__(msg)
        self.findings = list(findings)


def dedup(findings) -> "list[Finding]":
    """Collapse identical defects found on many instances into one
    finding carrying the first instance's env and a count."""
    out = []
    index = {}
    for f in findings:
        # instance findings (env set) collapse per offending dep — their
        # messages embed the concrete instance; static findings (env
        # None) keep the message in the key, since one class can carry
        # several distinct static defects on the same location
        key = (f.code, f.task, f.flow, f.dep,
               f.message if f.env is None else None)
        i = index.get(key)
        if i is None:
            index[key] = len(out)
            out.append(f)
        else:
            prev = out[i]
            out[i] = Finding(prev.code, prev.message, prev.task, prev.flow,
                             prev.env, prev.dep, prev.count + 1)
    return out


def errors_of(findings):
    return [f for f in findings if f.is_error]


def infos_of(findings):
    """Advisory (info-severity) findings — reported, never fatal."""
    return [f for f in findings if f.severity == INFO]
