"""hb-check — vector-clock happens-before race detection for the runtime.

The port of :mod:`parsec_tpu.analysis.hb`.  The static
linter (:mod:`.linter`) proves the *declared* graph is sound; this module
checks the *executed schedule*: every pair of conflicting runtime events
(two version commits to one tile, an arena slot recycle racing another,
a dependency counter decremented after its task fired, a native
``task_done`` accepted twice) must be ordered by a happens-before path,
or the run only worked by luck of the interleaving.

Events come from the PINS sites the runtime fires
(:mod:`parsec_tpu_torch.profiling.pins`: ``DEP_DECREMENT``,
``DATA_VERSION_BUMP``, ``ARENA_ALLOC``/``RECYCLE``, ``NATIVE_TASK_DONE``,
the staging pipeline's ``HB_STAGE_IN``/``HB_WB_ENQUEUE``/``HB_WB_COMMIT``,
and ``HB_FRAME_SEND``/``DELIVER``, which the in-process comm fabric
fires).  The checker builds one vector clock per thread; cross-thread edges
are:

* ``dep_edge`` (``RELEASE_DEPS_END``): producer -> released successor,
  joined at the successor's ``EXEC_BEGIN`` (the scheduler hand-off);
* ``EXEC_END`` -> ``COMPLETE_EXEC_BEGIN`` per task (a device manager
  thread completing a task it did not execute);
* the transfer lane's prestage -> the task's exec, and a write-back's
  enqueue -> the committer landing it;
* frame send -> frame deliver per comm frame (cross-rank ordering);
* successive dependency-counter decrements of one key (serialized by the
  tracker's shard lock) chain, so the firing decrement's clock covers
  every producer — exactly the synchronization the counter provides.

:class:`HBRecorder` is the live, in-process front-end: it subscribes to
PINS, records events (with compact stacks), and ``analyze()`` returns
:class:`~parsec_tpu_torch.analysis.findings.Finding` objects with
``RTxxx`` codes.  ``PARSEC_TPU_HBCHECK=1`` installs a process-wide
recorder whose findings are reported at ``Context.fini`` (``strict``
raises).  The post-hoc front-end reads the same event kinds out of
binary ``.pbt`` dumps of a :class:`~parsec_tpu_torch.profiling.binary.
RankTraceSet` (:func:`events_from_trace`, :func:`analyze_trace`, ``tools
hbcheck``).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .findings import CODES, Finding, LintError, dedup, errors_of

__all__ = [
    "HBEvent", "HBRecorder", "analyze_events", "analyze_trace",
    "ensure_live", "live_recorder", "live_report",
]


class HBEvent:
    """One recorded runtime event.  ``obj`` identifies the site the event
    touches (a tile, a counter key, an arena slot, a frame id, a task
    token); ``where`` is a compact call-site summary (live mode only)."""

    __slots__ = ("seq", "thread", "kind", "obj", "info", "where", "clock")

    def __init__(self, seq: int, thread: str, kind: str, obj: Any,
                 info: Any = None, where: str = ""):
        self.seq = seq
        self.thread = thread
        self.kind = kind
        self.obj = obj
        self.info = info
        self.where = where
        self.clock: Optional[Dict[str, int]] = None

    def describe(self) -> str:
        w = f" at {self.where}" if self.where else ""
        info = f" {self.info}" if self.info not in (None, {}) else ""
        return f"{self.kind}[{self.thread}]#{self.seq}{info}{w}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"HBEvent({self.describe()}, obj={self.obj!r})"


def _leq(a: Dict[str, int], b: Dict[str, int]) -> bool:
    """a happens-before-or-equals b, componentwise."""
    return all(v <= b.get(t, 0) for t, v in a.items())


def _join(dst: Dict[str, int], src: Optional[Dict[str, int]]) -> None:
    if not src:
        return
    for t, v in src.items():
        if v > dst.get(t, 0):
            dst[t] = v


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

def analyze_events(events: Iterable[HBEvent]) -> List[Finding]:
    """Run the vector-clock pass over ``events`` (any iterable; consumed
    in ``seq`` order) and return the race findings, deduplicated and
    errors first."""
    evs = sorted(events, key=lambda e: e.seq)
    clocks: Dict[str, Dict[str, int]] = {}
    store: Dict[Any, Dict[str, int]] = {}
    last_writes: Dict[Any, Dict[str, HBEvent]] = {}
    fired: Dict[Any, HBEvent] = {}
    arena_live: Dict[Any, bool] = {}       # slot -> currently allocated
    arena_recycled: Dict[Any, HBEvent] = {}
    done_seen: Dict[Any, HBEvent] = {}
    saw_frame_send = False
    findings: List[Finding] = []

    def report(code: str, obj: Any, a: HBEvent, b: HBEvent,
               missing: str = "") -> None:
        msg = CODES[code][1]
        detail = (f"{msg}; first: {a.describe()}, second: {b.describe()}")
        if missing:
            detail += f"; missing edge: {missing}"
        findings.append(Finding(code, detail, dep=_site_name(obj)))

    for ev in evs:
        c = clocks.setdefault(ev.thread, {})
        c[ev.thread] = c.get(ev.thread, 0) + 1
        kind = ev.kind

        # -- acquire side: join incoming edges ---------------------------
        if kind == "exec_begin":
            _join(c, store.get(("task", ev.obj)))
        elif kind == "complete_begin":
            _join(c, store.get(("done", ev.obj)))
        elif kind == "wb_commit":
            # deferred write-back landing: join the enqueueing thread's
            # clock (which already covers the task's exec/epilog) so
            # exec happens-before commit
            _join(c, store.get(("wb", ev.obj)))
        elif kind == "frame_deliver":
            src = store.get(("frame", ev.obj))
            if src is None:
                if saw_frame_send:
                    findings.append(Finding(
                        "RT004", CODES["RT004"][1] +
                        f"; deliver: {ev.describe()}",
                        dep=f"frame {ev.obj}"))
            else:
                _join(c, src)
        elif kind == "dep_dec":
            # counter decrements chain through the tracker's lock: join
            # every earlier decrementer's clock, then publish the merge
            key = ("dep", ev.obj)
            _join(c, store.get(key))
            store[key] = dict(c)
            prev = fired.get(ev.obj)
            if prev is not None:
                report("RT003", ev.obj, prev, ev,
                       "the counter already fired; this release belongs "
                       "to a task that was already scheduled")
            if ev.info and ev.info.get("ready"):
                fired[ev.obj] = ev
        elif kind in ("arena_alloc", "arena_recycle"):
            key = ("arena", ev.obj)
            _join(c, store.get(key))
            store[key] = dict(c)
            if kind == "arena_alloc":
                arena_live[ev.obj] = True
                arena_recycled.pop(ev.obj, None)
            else:
                prev = arena_recycled.get(ev.obj)
                if prev is not None and not arena_live.get(ev.obj, False):
                    report("RT002", ev.obj, prev, ev,
                           "no allocation between the two recycles")
                arena_live[ev.obj] = False
                arena_recycled[ev.obj] = ev
        elif kind == "task_done":
            accepted = bool(ev.info.get("accepted", True)) if ev.info else True
            if accepted:
                prev = done_seen.get(ev.obj)
                if prev is not None:
                    report("RT005", ev.obj, prev, ev,
                           "the second completion should have been "
                           "rejected by the double-complete guard")
                else:
                    done_seen[ev.obj] = ev
        elif kind == "ver_bump":
            ev.clock = dict(c)
            lw = last_writes.setdefault(ev.obj, {})
            for t, prev in list(lw.items()):
                if t == ev.thread:
                    continue
                if not _leq(prev.clock, ev.clock):
                    report("RT001", ev.obj, prev, ev,
                           "no dependency edge, completion hand-off, or "
                           "frame path orders these two writers")
            lw[ev.thread] = ev

        # -- release side: publish outgoing edges ------------------------
        if kind in ("dep_edge", "task_publish", "stage_in"):
            # dep_edge: producer released this successor; task_publish:
            # some thread handed the (now-ready) task to the scheduler —
            # covers hand-offs that bypass RELEASE_DEPS (remote
            # activations decrementing counters directly); stage_in: the
            # transfer lane finished prestaging this task's inputs (the
            # pump only submits after the stage job completes), so
            # stage_in happens-before the task's exec
            dst_tok = ev.obj[1] if kind == "dep_edge" else ev.obj
            key = ("task", dst_tok)
            merged = store.get(key)
            if merged is None:
                merged = store[key] = {}
            _join(merged, c)
        elif kind == "exec_end":
            store[("done", ev.obj)] = dict(c)
        elif kind == "wb_enqueue":
            # the epilog thread hands this output to the async committer:
            # publish its clock under the ticket so the later wb_commit
            # joins it (exec happens-before write-back commit)
            store[("wb", ev.obj)] = dict(c)
        elif kind == "frame_send":
            saw_frame_send = True
            store[("frame", ev.obj)] = dict(c)

    out = dedup(findings)
    out.sort(key=lambda f: (not f.is_error, f.code))
    return out


def _site_name(obj: Any) -> str:
    if isinstance(obj, tuple) and obj and isinstance(obj[0], str):
        return f"{obj[0]} {obj[1:]!r}"
    return repr(obj)


# ---------------------------------------------------------------------------
# live recorder (PINS front-end)
# ---------------------------------------------------------------------------

def _caller() -> str:
    """Compact call-site summary: the innermost non-instrumentation
    frames, newest first."""
    out = []
    f = sys._getframe(2)
    depth = 0
    while f is not None and len(out) < 3 and depth < 14:
        # exact-basename match ("test_hb.py" must not be skipped)
        base = os.path.basename(f.f_code.co_filename)
        if base not in ("pins.py", "hb.py"):
            out.append(f"{base}:{f.f_lineno} in {f.f_code.co_name}")
        f = f.f_back
        depth += 1
    return " < ".join(out)


class HBRecorder:
    """Live happens-before recorder: a PINS module collecting
    :class:`HBEvent` streams from a running context (or several — the
    in-process multi-rank harness records every rank into one recorder,
    threads keep the streams apart).

    Usage::

        with HBRecorder() as rec:
            ... run taskpools ...
        findings = rec.analyze()     # [] on a clean schedule
    """

    def __init__(self, stacks: bool = True, max_events: int = 2_000_000):
        self.stacks = stacks
        self.max_events = max_events
        self.dropped = 0
        self._events: List[HBEvent] = []
        self._seq = itertools.count(1)
        self._tok = itertools.count(1)
        self._subs: List[Tuple[str, Any]] = []
        self._installed = False

    # -- recording --------------------------------------------------------
    def _rec(self, kind: str, obj: Any, info: Any = None) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        where = _caller() if self.stacks else ""
        # identity = name + ident: several in-process Contexts all name
        # their workers "parsec-worker-<i>" — keying by name alone would
        # merge different ranks' threads into one clock and hide every
        # cross-context race
        thread = (f"{threading.current_thread().name}"
                  f"#{threading.get_ident()}")
        self._events.append(HBEvent(
            next(self._seq), thread, kind, obj, info, where))

    def _task_token(self, task) -> int:
        prof = task.prof
        t = prof.get("hb_token")
        if t is None:
            t = prof["hb_token"] = next(self._tok)
        return t

    # -- lifecycle --------------------------------------------------------
    def install(self) -> "HBRecorder":
        if self._installed:
            return self
        self._installed = True
        from ..profiling import pins

        def sub(site, cb):
            pins.subscribe(site, cb)
            self._subs.append((site, cb))

        sub(pins.DEP_DECREMENT, lambda es, p: self._rec(
            "dep_dec", (p["tracker"], p["key"]), {"ready": p["ready"]}))
        sub(pins.DATA_VERSION_BUMP, lambda es, p: self._rec(
            "ver_bump", ("data", p["data"]),
            {"key": p.get("key"), "version": p.get("version")}))
        sub(pins.ARENA_ALLOC, lambda es, p: self._rec(
            "arena_alloc", ("slot", p["slot"]), {"arena": p.get("arena")}))
        sub(pins.ARENA_RECYCLE, lambda es, p: self._rec(
            "arena_recycle", ("slot", p["slot"]), {"arena": p.get("arena")}))
        sub(pins.HB_FRAME_SEND, lambda es, p: self._rec(
            "frame_send", p["frame"], {"peer": p.get("peer")}))
        sub(pins.HB_FRAME_DELIVER, lambda es, p: self._rec(
            "frame_deliver", p["frame"], {"peer": p.get("peer")}))
        sub(pins.NATIVE_TASK_DONE, lambda es, p: self._rec(
            "task_done", (p["graph"], p["task"]),
            {"accepted": p["accepted"]}))

        def on_release(es, payload):
            task, ready = payload
            src = self._task_token(task)
            for succ in ready or ():
                self._rec("dep_edge", (src, self._task_token(succ)))

        sub(pins.RELEASE_DEPS_END, on_release)

        def on_schedule(es, batch):
            for t in batch or ():
                self._rec("task_publish", self._task_token(t))

        sub(pins.SCHEDULE_BEGIN, on_schedule)
        sub(pins.EXEC_BEGIN, lambda es, task: self._rec(
            "exec_begin", self._task_token(task)))
        sub(pins.EXEC_END, lambda es, task: self._rec(
            "exec_end", self._task_token(task)))
        sub(pins.COMPLETE_EXEC_BEGIN, lambda es, task: self._rec(
            "complete_begin", self._task_token(task)))
        # device-manager epilog: join the task's exec clock BEFORE the
        # manager commits outputs (version bumps) — same join as
        # complete_begin, fired earlier on the retirement path
        sub(pins.DEVICE_EPILOG_BEGIN, lambda es, task: self._rec(
            "complete_begin", self._task_token(task)))
        # staging-pipeline edges: the transfer lane finishing
        # a task's prestage happens-before that task's exec; a task's
        # epilog handing an output to the async committer happens-before
        # the committer landing it on the host
        sub(pins.HB_STAGE_IN, lambda es, p: self._rec(
            "stage_in", self._task_token(p["task"])))
        sub(pins.HB_WB_ENQUEUE, lambda es, p: self._rec(
            "wb_enqueue", p["ticket"]))

        def on_wb_commit(es, p):
            for t in p.get("tickets") or ():
                self._rec("wb_commit", t)

        sub(pins.HB_WB_COMMIT, on_wb_commit)
        return self

    def uninstall(self) -> None:
        from ..profiling import pins

        for site, cb in self._subs:
            pins.unsubscribe(site, cb)
        self._subs.clear()
        self._installed = False

    def __enter__(self) -> "HBRecorder":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- results ----------------------------------------------------------
    @property
    def events(self) -> List[HBEvent]:
        return self._events

    def clear(self) -> None:
        self._events = []

    def analyze(self) -> List[Finding]:
        return analyze_events(list(self._events))


# ---------------------------------------------------------------------------
# process-wide live mode (PARSEC_TPU_HBCHECK=1|strict)
# ---------------------------------------------------------------------------

_live: Optional[HBRecorder] = None
_live_lock = threading.Lock()
_live_reported: set = set()
_live_dropped_warned = False


def ensure_live() -> HBRecorder:
    """Install (once per process) the env-var driven live recorder."""
    global _live
    with _live_lock:
        if _live is None:
            _live = HBRecorder().install()
        return _live


def live_recorder() -> Optional[HBRecorder]:
    return _live


def live_report(strict: Optional[bool] = None) -> List[Finding]:
    """Analyze the live recorder (no-op empty list when not installed)
    and return the findings that are NEW since the previous report — the
    recorder spans the whole process, so a later context's fini must not
    re-attribute (or re-raise on) an earlier context's findings.  Logs
    each new finding; strict mode raises on new error findings.  Called
    from ``Context.fini`` when ``PARSEC_TPU_HBCHECK`` is set."""
    global _live_dropped_warned
    rec = _live
    if rec is None:
        return []
    if strict is None:
        strict = os.environ.get("PARSEC_TPU_HBCHECK") == "strict"
    new = []
    with _live_lock:
        for f in rec.analyze():
            key = (f.code, f.dep, f.message)
            if key not in _live_reported:
                _live_reported.add(key)
                new.append(f)
    if rec.dropped and not _live_dropped_warned:
        _live_dropped_warned = True
        from ..utils import debug

        debug.warning(
            "hb-check: event cap reached, %d event(s) dropped — later "
            "races may be unreported (raise HBRecorder.max_events or "
            "scope the run)", rec.dropped)
    if new:
        from ..utils import debug

        for f in new:
            debug.warning("hb-check: %s", f)
        if strict and errors_of(new):
            raise LintError(
                f"hb-check: {len(errors_of(new))} runtime race "
                "finding(s)", new)
    return new


# ---------------------------------------------------------------------------
# post-hoc trace front-end (tools hbcheck)
# ---------------------------------------------------------------------------

#: trace keyword -> analyzer kind, for the hb_* instants RankTraceSet
#: records (:mod:`parsec_tpu_torch.profiling.binary`)
TRACE_KINDS = {
    "hb_dep_dec": "dep_dec",
    "hb_ver_bump": "ver_bump",
    "hb_arena_alloc": "arena_alloc",
    "hb_arena_recycle": "arena_recycle",
    "hb_frame_send": "frame_send",
    "hb_frame_deliver": "frame_deliver",
    "hb_task_done": "task_done",
    "hb_stage_in": "stage_in",
    "hb_wb_enqueue": "wb_enqueue",
    "hb_wb_commit": "wb_commit",
}


def events_from_trace(paths: Iterable[str]) -> List[HBEvent]:
    """Decode hb-relevant events out of one or more ``.pbt`` dumps (one
    per rank; same-process ranks share the monotonic clock so timestamps
    interleave correctly; multi-process dumps should be clock-aligned by
    ``tools merge`` conventions first)."""
    from ..profiling.binary import read_pbt

    raw: List[Tuple[float, int, HBEvent]] = []
    n = itertools.count(1)
    for path in paths:
        for e in read_pbt(path):
            name, ph = e["name"], e["ph"]
            pid = e.get("pid", 0)
            thread = f"r{pid}/{e.get('tid')}"
            args = e.get("args", {})
            eid, info = args.get("event_id", 0), args.get("info", 0)
            kind = obj = None
            extra: Any = None
            if name in TRACE_KINDS and ph == "i":
                kind = TRACE_KINDS[name]
                if kind == "dep_dec":
                    obj, extra = ("dep", pid, eid), {"ready": bool(info)}
                elif kind == "ver_bump":
                    obj, extra = ("data", pid, eid), {"version": info}
                elif kind in ("arena_alloc", "arena_recycle"):
                    obj = ("slot", pid, eid)
                elif kind in ("frame_send", "frame_deliver"):
                    obj = eid
                elif kind == "task_done":
                    obj, extra = ("ntask", eid), {"accepted": bool(info)}
                elif kind == "stage_in":
                    obj = eid          # task token (same space as exec)
                elif kind in ("wb_enqueue", "wb_commit"):
                    obj = eid          # committer ticket
            elif name == "dep_edge" and ph == "i":
                kind, obj = "dep_edge", (eid, info)
            elif name == "sched_publish" and ph == "i":
                kind, obj = "task_publish", eid
            elif name == "exec" and ph in ("B", "E"):
                kind = "exec_begin" if ph == "B" else "exec_end"
                obj = eid
            elif name == "complete_exec" and ph == "B":
                kind, obj = "complete_begin", eid
            if kind is None:
                continue
            idx = next(n)
            raw.append((e["ts"], idx, HBEvent(idx, thread, kind, obj, extra)))
    raw.sort(key=lambda t: (t[0], t[1]))
    out = []
    for seq, (_ts, _i, ev) in enumerate(raw, 1):
        ev.seq = seq
        out.append(ev)
    return out


def analyze_trace(paths) -> List[Finding]:
    """``tools hbcheck`` core: happens-before analysis over binary trace
    dump(s)."""
    if isinstance(paths, str):
        paths = [paths]
    return analyze_events(events_from_trace(paths))
