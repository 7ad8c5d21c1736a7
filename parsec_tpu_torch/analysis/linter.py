"""Ahead-of-time PTG/JDF graph verifier (``ptg-lint``).

The port of :mod:`parsec_tpu.analysis.linter`: the same checks, codes and
locations over the port's PTG definitions.  The reference's ``jdfc``
compiler rejects malformed graphs at compile time
(``jdf.c:jdf_sanity_checks``: unconnected flows, unbound locals, bad task
references); a runtime-built PTG would surface the same bugs only as
hangs, repo-miss RuntimeErrors, or wrong answers — and only after a full
execution.  This module checks a :class:`PTG`
definition against concrete globals **without executing a single task
body**:

* **edge reciprocity** — every output dep ``A.F -> B.G`` must be mirrored
  by a guard-true input dep on ``B.G`` resolving back to ``A.F`` under the
  same env, and vice versa (PTG001/PTG002).  Dependency counting and repo
  deposits are producer-driven, so an asymmetric pair means a double
  release or a guaranteed hang;
* **data hazards** — two tasks writing the same collection tile (directly
  or through an aliasing flow chain) with no dependency path between them
  is a WAW race (PTG010); an unordered read/write pair is a RAW/WAR race
  (PTG011);
* **deadlock / liveness** — cycles over the instantiated DAG (PTG020) and
  readable flows whose guards admit no producer and no data-collection
  source, so the task can never fire under static guards (PTG021);
* **expression / affinity lint** — unbound symbols (PTG030), out-of-bounds
  collection keys (PTG031), unknown collections (PTG032), bad task
  references (PTG033), ranges where scalars are required (PTG034), and
  write-backs whose owner differs from the task's affinity rank (PTG040).

Entry points: :func:`verify_ptg` (and ``PTG.verify``), :func:`lint_jdf`
for compiled JDF modules, the ``tools lint`` CLI subcommand
(:mod:`parsec_tpu_torch.profiling.tools`), and the ``PARSEC_TPU_LINT`` startup
hook on ``PTGTaskpool``.
"""

from __future__ import annotations

import ast
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.lifecycle import AccessMode
from ..dsl.graph import find_cycle, source_tile
from ..dsl.ptg import (
    CTL,
    _SAFE_BUILTINS,
    _c_to_py,
    _DataRef,
    _expand_args,
    _NewRef,
    _NoneRef,
    _TaskRef,
    PTG,
    PTGTaskClass,
)
from .edges import Reachability, count_instances, declared_dag
from .findings import Finding, dedup, errors_of

#: instance-check cap: beyond this many task instances the linter reports
#: PTG050 and skips instantiation (lint problem sizes, not production NT)
DEFAULT_MAX_TASKS = 50_000

#: data-hazard work budget: the hazard pass runs one BFS per distinct
#: writer/reader node of a conflicted tile, each O(V + E) — quadratic
#: when most tasks touch one tile (chaindata-style chains).  Beyond
#: sources * V of this budget the pass reports PTG050 and skips, instead
#: of grinding for hours near DEFAULT_MAX_TASKS; every other check
#: (reciprocity, cycles, liveness, bounds) is near-linear and unaffected.
HAZARD_WORK_LIMIT = 30_000_000


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _expr_names(src: str) -> Set[str]:
    """Free variable names of a dependency/range expression (real NAME
    loads only — attribute names and comprehension bindings excluded)."""
    try:
        tree = ast.parse(_c_to_py(src), mode="eval")
    except SyntaxError:
        return set()
    loads: Set[str] = set()
    stores: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            (stores if isinstance(n.ctx, ast.Store) else loads).add(n.id)
    return loads - stores


def _arg_exprs(aexpr) -> Iterable:
    for e in (aexpr.lo, aexpr.hi, aexpr.step):
        if e is not None:
            yield e


def _is_collection(v: Any) -> bool:
    return hasattr(v, "rank_of") and hasattr(v, "data_of")


def _dep_targets(dep):
    for t in (dep.then, dep.otherwise):
        if t is not None:
            yield t


def free_symbols(ptg: PTG) -> Set[str]:
    """Every name the definition's expressions reference beyond its own
    locals — the implicit taskpool-global surface of a builder PTG (a
    ``.jdf`` declares its globals; a runtime-built PTG only implies them
    by use).  Used as the default ``known`` set for a no-globals static
    verify."""
    names: Set[str] = set()
    for pc in ptg.classes.values():
        cls_names: Set[str] = set()

        def add(src: str, _acc=cls_names) -> None:
            _acc.update(_expr_names(src))

        local = {n for n, _, _ in pc.decls}
        for (_n, aexpr, _p) in pc.decls:
            for e in _arg_exprs(aexpr):
                add(e.src)
        if pc._priority is not None:
            add(pc._priority.src)
        refs = []
        if pc._affinity is not None:
            refs.append(pc._affinity)
        for f in pc.flows:
            for dep in f.deps_in + f.deps_out:
                if dep.guard is not None:
                    add(dep.guard.src)
                refs.extend(t for t in _dep_targets(dep)
                            if isinstance(t, (_DataRef, _TaskRef)))
        for t in refs:
            for a in t.args:
                for e in _arg_exprs(a):
                    add(e.src)
        names |= cls_names - local  # locals shadow per-class only
    return names


def collection_names(ptg: PTG) -> Set[str]:
    """Every name the definition uses as a data collection (affinity and
    dependency data references)."""
    names: Set[str] = set()
    for pc in ptg.classes.values():
        if pc._affinity is not None:
            names.add(pc._affinity.collection_name)
        for f in pc.flows:
            for dep in f.deps_in + f.deps_out:
                for t in _dep_targets(dep):
                    if isinstance(t, _DataRef):
                        names.add(t.collection_name)
    return names


class SynthCollection:
    """Placement-only stand-in for a collection the linter was not given:
    everything lives on rank 0 and any key is in bounds.  Lets ``tools
    lint`` verify a definition whose real collections only exist at
    runtime (``data_of`` is never called — no body executes)."""

    def __init__(self, name: str):
        self.name = name

    def rank_of(self, *key) -> int:
        return 0

    def vpid_of(self, *key) -> int:
        return 0

    def data_key(self, *key):
        return key if len(key) != 1 else key[0]

    def data_of(self, *key):
        raise RuntimeError(
            f"synthesized lint collection {self.name!r} holds no data")


def synthesize_collections(ptg: PTG, constants: Dict[str, Any],
                           ) -> Tuple[Dict[str, Any], List[str]]:
    """Fill in :class:`SynthCollection` stubs for every collection the
    definition references but ``constants`` does not provide.  Returns
    ``(augmented constants, names synthesized)``."""
    merged = dict(constants)
    added = []
    for name in sorted(collection_names(ptg)):
        if name not in merged:
            merged[name] = SynthCollection(name)
            added.append(name)
    return merged, added


# ---------------------------------------------------------------------------
# static (source-level) checks — no parameter-space enumeration
# ---------------------------------------------------------------------------

def _static_lint(ptg: PTG, known: Set[str],
                 collections: Optional[Set[str]],
                 constants: Optional[Dict[str, Any]]) -> List[Finding]:
    F: List[Finding] = []

    def chk_names(src: str, visible: Set[str], pc, flow, dep_src) -> None:
        missing = _expr_names(src) - visible
        if missing:
            F.append(Finding(
                "PTG030",
                f"unbound symbol(s) {sorted(missing)} in expression {src!r}",
                pc.name, flow, dep=dep_src))

    def chk_dataref(t: _DataRef, pc, flow, dep_src, visible) -> None:
        name = t.collection_name
        if constants is not None:
            v = constants.get(name)
            if v is None:
                F.append(Finding(
                    "PTG032", f"unknown collection {name!r}",
                    pc.name, flow, dep=dep_src))
            elif not _is_collection(v):
                F.append(Finding(
                    "PTG032",
                    f"{name!r} is not a collection "
                    f"(got {type(v).__name__})", pc.name, flow, dep=dep_src))
        elif name not in known and (collections is None
                                    or name not in collections):
            F.append(Finding(
                "PTG032", f"unknown collection {name!r}",
                pc.name, flow, dep=dep_src))
        for a in t.args:
            if a.hi is not None:
                F.append(Finding(
                    "PTG034",
                    f"range {a.lo.src!r}..{a.hi.src!r} in collection key of "
                    f"{name!r} (keys are scalars)", pc.name, flow,
                    dep=dep_src))
            for e in _arg_exprs(a):
                chk_names(e.src, visible, pc, flow, dep_src)

    def chk_taskref(t: _TaskRef, pc, flow, dep_src, visible,
                    is_input: bool, flow_mode) -> None:
        tc = ptg.classes.get(t.class_name)
        if tc is None:
            F.append(Finding(
                "PTG033", f"unknown task class {t.class_name!r}",
                pc.name, flow, dep=dep_src))
        else:
            # input deps name the PRODUCER's flow; output deps name the
            # CONSUMER's receiving flow — either way it must exist there
            role = "producer" if is_input else "consumer"
            if t.flow_name not in {g.name for g in tc.flows}:
                F.append(Finding(
                    "PTG033",
                    f"{role} class {t.class_name!r} has no flow "
                    f"{t.flow_name!r}", pc.name, flow, dep=dep_src))
            if len(t.args) != len(tc.param_names):
                F.append(Finding(
                    "PTG033",
                    f"task reference {t.class_name}(...) has {len(t.args)} "
                    f"argument(s), class declares "
                    f"{len(tc.param_names)} parameter(s)",
                    pc.name, flow, dep=dep_src))
        for a in t.args:
            if a.hi is not None and is_input and flow_mode != CTL:
                F.append(Finding(
                    "PTG034",
                    f"range {a.lo.src!r}..{a.hi.src!r} in a data-flow "
                    "input argument (single-assignment inputs are "
                    "scalars; only CTL gathers and outputs may range)",
                    pc.name, flow, dep=dep_src))
            for e in _arg_exprs(a):
                chk_names(e.src, visible, pc, flow, dep_src)

    for pc in ptg.classes.values():
        visible = set(known)
        for (name, aexpr, _is_param) in pc.decls:
            for e in _arg_exprs(aexpr):
                chk_names(e.src, visible, pc, None, None)
            visible.add(name)
        if pc._affinity is not None:
            chk_dataref(pc._affinity, pc, None,
                        f": {pc._affinity.collection_name}(...)", visible)
        if pc._priority is not None:
            chk_names(pc._priority.src, visible, pc, None, None)
        for f in pc.flows:
            readable = f.mode != CTL and bool(f.mode & AccessMode.IN)
            if readable and not (f.mode & AccessMode.OUT) and not f.deps_in:
                F.append(Finding(
                    "PTG035",
                    f"flow {f.name!r} is read-only but declares no input "
                    "dependencies (its value is always None)",
                    pc.name, f.name))
            for dep, is_input in ([(d, True) for d in f.deps_in]
                                  + [(d, False) for d in f.deps_out]):
                if dep.guard is not None:
                    chk_names(dep.guard.src, visible, pc, f.name, dep.src)
                for t in _dep_targets(dep):
                    if isinstance(t, _DataRef):
                        chk_dataref(t, pc, f.name, dep.src, visible)
                    elif isinstance(t, _TaskRef):
                        chk_taskref(t, pc, f.name, dep.src, visible,
                                    is_input, f.mode)
    return F


# ---------------------------------------------------------------------------
# instantiated checks — enumerate the parameter space, no body execution
# ---------------------------------------------------------------------------

def _bounds_check(F: List[Finding], t: _DataRef, env, constants,
                  pc, flow, env_key, dep_src) -> None:
    """PTG031: key outside a tiled collection's declared grid.  Only
    collections exposing an ``mt``/``nt`` tile grid are bounded; keyed
    stores (LocalCollection, SynthCollection) accept any key."""
    dc = constants.get(t.collection_name)
    if dc is None:
        return  # PTG032 already reported statically
    mt, nt = getattr(dc, "mt", None), getattr(dc, "nt", None)
    if mt is None or nt is None:
        return
    try:
        key = t.key(env)
    except ValueError:
        return  # range key: PTG034 already reported statically
    try:
        ck = dc.data_key(*key)
    except Exception:
        F.append(Finding(
            "PTG031",
            f"key {key!r} is not a valid {t.collection_name!r} tile key",
            pc.name, flow, env_key, dep=dep_src))
        return
    if not (isinstance(ck, tuple) and len(ck) == 2):
        return  # not a 2-D tile grid (e.g. parity-keyed buffers): unbounded
    i, j = ck
    if not (0 <= i < mt and 0 <= j < nt):
        F.append(Finding(
            "PTG031",
            f"key {tuple(key)!r} out of bounds for {t.collection_name!r} "
            f"({mt} x {nt} tiles)", pc.name, flow, env_key, dep=dep_src))


def _flow_of(pc: PTGTaskClass, name: str):
    for f in pc.flows:
        if f.name == name:
            return f
    return None


def _has_reciprocal_output(classes, src_pc: PTGTaskClass, kp: Tuple,
                           src_flow: str, cons_class: str, cons_flow: str,
                           kc: Tuple, constants) -> bool:
    """Does producer instance ``src_pc(kp)`` declare a guard-true output
    on flow ``src_flow`` that targets ``cons_class(kc)`` receiving on
    ``cons_flow``?  (The producer side drives counting and deposits.)"""
    sf = _flow_of(src_pc, src_flow)
    if sf is None:
        return True  # missing flow: PTG033 already reported
    ep = src_pc.env_of(kp, constants)
    for dep in sf.deps_out:
        t = dep.target(ep)
        if (isinstance(t, _TaskRef) and t.class_name == cons_class
                and t.flow_name == cons_flow):
            for locs in _expand_args(t.args, ep):
                if tuple(locs) == tuple(kc):
                    return True
    return False


def _has_reciprocal_input(classes, cons_pc: PTGTaskClass, kc: Tuple,
                          cons_flow: str, src_class: str, src_flow: str,
                          kp: Tuple, constants) -> bool:
    """Does consumer instance ``cons_pc(kc)`` resolve its input on
    ``cons_flow`` back to producer ``src_class(kp)`` flow ``src_flow``?
    Data flows must resolve THROUGH the single active input dep; CTL
    flows gather, so any guard-true dep may carry the edge."""
    cf = _flow_of(cons_pc, cons_flow)
    if cf is None:
        return True  # PTG033 already reported
    ec = cons_pc.env_of(kc, constants)
    if cf.mode == CTL:
        for dep in cf.deps_in:
            t = dep.target(ec)
            if (isinstance(t, _TaskRef) and t.class_name == src_class
                    and t.flow_name == src_flow):
                for locs in _expand_args(t.args, ec):
                    if tuple(locs) == tuple(kp):
                        return True
        return False
    dt = cons_pc.active_input_dep(cf, ec)
    if dt is None:
        return False
    t = dt[1]
    if not (isinstance(t, _TaskRef) and t.class_name == src_class
            and t.flow_name == src_flow):
        return False
    try:
        return tuple(a.scalar(ec) for a in t.args) == tuple(kp)
    except ValueError:
        return False


def _check_instance(ptg: PTG, pc: PTGTaskClass, tid, env,
                    constants) -> List[Finding]:
    F: List[Finding] = []
    classes = ptg.classes
    key = tid[1]
    if pc._affinity is not None:
        _bounds_check(F, pc._affinity, env, constants, pc, None, key,
                      f": {pc._affinity.collection_name}(...)")
    for f in pc.flows:
        readable = f.mode != CTL and bool(f.mode & AccessMode.IN)
        # liveness / ambiguity over the input deps
        if readable and f.deps_in:
            matched = [(d, d.target(env)) for d in f.deps_in]
            matched = [(d, t) for d, t in matched if t is not None]
            if not matched:
                F.append(Finding(
                    "PTG021",
                    "no input dependency matches: under static guards "
                    "this task can never fire (dynamic-guard graphs: "
                    "ignore=('PTG021',), or add an explicit '<- NONE')",
                    pc.name, f.name, key))
            else:
                live = [(d, t) for d, t in matched
                        if not isinstance(t, _NoneRef)]
                if len(live) > 1:
                    F.append(Finding(
                        "PTG022",
                        "more than one guard-true non-NONE input "
                        "dependency (single-assignment: the first wins)",
                        pc.name, f.name, key, dep=live[1][0].src))
        # input side: bounds + reciprocity
        if f.mode == CTL:
            for dep in f.deps_in:
                t = dep.target(env)
                if not isinstance(t, _TaskRef):
                    continue
                src_pc = classes.get(t.class_name)
                if src_pc is None:
                    continue
                for kp in _expand_args(t.args, env):
                    if (len(kp) != len(src_pc.param_names)
                            or not src_pc.valid(kp, constants)):
                        continue
                    if not _has_reciprocal_output(
                            classes, src_pc, kp, t.flow_name,
                            pc.name, f.name, key, constants):
                        F.append(Finding(
                            "PTG002",
                            f"input from {t.class_name}{tuple(kp)} flow "
                            f"{t.flow_name!r} has no reciprocal output "
                            "dep on the producer", pc.name, f.name, key,
                            dep=dep.src))
        else:
            dt = pc.active_input_dep(f, env)
            if dt is not None:
                dep, t = dt
                if isinstance(t, _DataRef):
                    _bounds_check(F, t, env, constants, pc, f.name, key,
                                  dep.src)
                elif isinstance(t, _TaskRef):
                    src_pc = classes.get(t.class_name)
                    if src_pc is not None:
                        try:
                            kp = tuple(a.scalar(env) for a in t.args)
                        except ValueError:
                            kp = None  # PTG034 already reported
                        if (kp is not None
                                and len(kp) == len(src_pc.param_names)
                                and src_pc.valid(kp, constants)
                                and not _has_reciprocal_output(
                                    classes, src_pc, kp, t.flow_name,
                                    pc.name, f.name, key, constants)):
                            F.append(Finding(
                                "PTG002",
                                f"input from {t.class_name}{kp} flow "
                                f"{t.flow_name!r} has no reciprocal "
                                "output dep on the producer (the "
                                "dependency goal would never be "
                                "reached, or the repo lookup would "
                                "miss)", pc.name, f.name, key,
                                dep=dep.src))
        # output side: bounds, owner affinity, reciprocity
        for dep in f.deps_out:
            t = dep.target(env)
            if t is None or isinstance(t, (_NoneRef, _NewRef)):
                continue
            if isinstance(t, _DataRef):
                _bounds_check(F, t, env, constants, pc, f.name, key, dep.src)
                if f.mode != CTL:
                    dc = constants.get(t.collection_name)
                    if dc is not None and _is_collection(dc):
                        try:
                            owner = dc.rank_of(*t.key(env))
                        except Exception:
                            owner = None
                        if owner is not None \
                                and owner != pc.rank_of(key, constants):
                            F.append(Finding(
                                "PTG040",
                                f"write-back {t.collection_name}"
                                f"{tuple(t.key(env))} is owned by rank "
                                f"{owner} but the task runs on rank "
                                f"{pc.rank_of(key, constants)} "
                                "(cross-rank final write-back)",
                                pc.name, f.name, key, dep=dep.src))
                continue
            # task reference: every valid expanded successor must read back
            cons_pc = classes.get(t.class_name)
            if cons_pc is None:
                continue
            for locs in _expand_args(t.args, env):
                if (len(locs) != len(cons_pc.param_names)
                        or not cons_pc.valid(locs, constants)):
                    continue  # out-of-space refs don't exist (by design)
                if not _has_reciprocal_input(
                        classes, cons_pc, tuple(locs), t.flow_name,
                        pc.name, f.name, key, constants):
                    F.append(Finding(
                        "PTG001",
                        f"output to {t.class_name}{tuple(locs)} flow "
                        f"{t.flow_name!r} has no reciprocal input dep on "
                        "the consumer (the release would be unaccounted: "
                        "premature or duplicate execution)",
                        pc.name, f.name, key, dep=dep.src))
    return F


def _hazard_lint(ptg: PTG, g, constants) -> List[Finding]:
    """PTG010/PTG011: order every pair of conflicting accesses to the
    same collection tile by a dependency path.  A task "writes" a tile
    when a writable flow's input chain ultimately aliases it
    (:func:`source_tile` — PTG flows thread one datum through in-place
    bodies) or when it write-backs into it; it "reads" it when a
    read-only flow's chain aliases it."""
    F: List[Finding] = []
    classes = ptg.classes
    writers: Dict[Tuple, Set] = defaultdict(set)
    readers: Dict[Tuple, Set] = defaultdict(set)
    for tid, node in g.nodes.items():
        pc = classes[tid[0]]
        for f in pc.flows:
            if f.mode == CTL:
                continue
            try:
                st = source_tile(g, tid, f.name)
            except RuntimeError:
                continue  # cyclic chain: PTG020 already covers it
            if st[0] != "data":
                continue
            tile = (st[1], tuple(st[2]))
            if f.mode & AccessMode.OUT:
                writers[tile].add(tid)
            else:
                readers[tile].add((tid, f.name))
        for (fname, cname, wkey) in node.write_backs:
            wf = _flow_of(pc, fname)
            if wf is not None and wf.mode != CTL:
                writers[(cname, tuple(wkey))].add(tid)
    # one BFS per distinct access node of a conflicted tile: bound the
    # quadratic worst case (every task touching one tile) explicitly
    n_sources = sum(
        max(0, len(ws) - 1) + len(readers.get(tile, ()))
        for tile, ws in writers.items() if len(ws) > 1 or readers.get(tile))
    if n_sources * max(1, len(g.nodes)) > HAZARD_WORK_LIMIT:
        F.append(Finding(
            "PTG050",
            f"data-hazard checks skipped: {n_sources} conflicting "
            f"accesses over {len(g.nodes)} tasks exceed the hazard work "
            "budget (lint a smaller problem size — the checks are "
            "size-generic)"))
        return F
    pos = {tid: i for i, tid in enumerate(g.topo_order())}
    reach = Reachability(g, pos)
    for tile in sorted(writers, key=repr):
        ws = sorted(writers[tile], key=pos.__getitem__)
        cname, tkey = tile
        ordered = True
        tile_anchor = f"{cname}{tkey}"  # in `dep`: distinct tiles must
        # never dedup into one finding (hazards have no single dep text)
        for w1, w2 in zip(ws, ws[1:]):
            if not reach.reachable(w1, w2):
                F.append(Finding(
                    "PTG010",
                    f"WAW race on {cname}{tkey}: {w1[0]}{tuple(w1[1])} and "
                    f"{w2[0]}{tuple(w2[1])} both write it with no "
                    "dependency path between them",
                    w1[0], None, w1[1], dep=tile_anchor))
                ordered = False
                break
        if not ordered:
            continue  # don't cascade reader findings onto a broken tile
        for (r, fname) in sorted(readers.get(tile, ()), key=repr):
            if r in writers[tile]:
                continue  # same task reads and writes the tile
            rp = pos[r]
            w_prev = None
            w_next = None
            for w in ws:  # ws is topo-sorted
                if pos[w] < rp:
                    w_prev = w
                elif w_next is None:
                    w_next = w
            racer = None
            if w_prev is not None and not reach.reachable(w_prev, r):
                racer = w_prev
            elif w_next is not None and not reach.reachable(r, w_next):
                racer = w_next
            if racer is not None:
                F.append(Finding(
                    "PTG011",
                    f"unordered read/write on {cname}{tkey}: read by "
                    f"{r[0]}{tuple(r[1])} races the write by "
                    f"{racer[0]}{tuple(racer[1])} (no dependency path)",
                    r[0], fname, r[1], dep=tile_anchor))
    return F


def _fusion_hints(ptg: PTG, g, constants) -> List[Finding]:
    """PTG060 (advisory, info severity): chains/waves the supertask
    partitioner (:mod:`parsec_tpu_torch.dsl.fusion`) would coarsen into
    one dispatch each under ``runtime_fusion`` — with the estimated
    dispatch count saved.  Device-body eligibility is deliberately ignored
    here (the hint describes the graph's SHAPE; whether the classes carry
    accelerator bodies is a deployment choice), and the horizon is the
    fixed :data:`~parsec_tpu_torch.dsl.fusion.DEFAULT_HORIZON` so hints are
    stable across hosts and tuning stores."""
    from ..dsl.fusion import DEFAULT_HORIZON, partition

    try:
        regions = partition(g, ptg.classes, mode="auto",
                            max_tasks=DEFAULT_HORIZON,
                            eligible=lambda name: True)
    except Exception:
        return []  # advisory only: a partitioner hiccup is not a finding
    groups: Dict[Tuple, List] = {}
    for r in regions:
        classes = []
        for t in r.members:
            if t[0] not in classes:
                classes.append(t[0])
        groups.setdefault((r.kind, tuple(classes)), []).append(r)
    F: List[Finding] = []
    for (kind, classes), rs in sorted(groups.items(), key=repr):
        ntasks = sum(len(r.members) for r in rs)
        head = rs[0].members[0]
        F.append(Finding(
            "PTG060",
            f"fusible {kind}(s) of {'+'.join(classes)}: {len(rs)} "
            f"region(s), {ntasks} tasks -> {len(rs)} dispatches "
            f"(runtime_fusion would save {ntasks - len(rs)} dispatches)",
            head[0], None, head[1], dep=f"{kind}:{'+'.join(classes)}"))
    return F


def _instance_lint(ptg: PTG, constants: Dict[str, Any],
                   max_tasks: int, fusion_hints: bool = False) -> List[Finding]:
    # NOTE the enumeration cost: the cap pre-count, the capture, and the
    # per-node env re-evaluation below each walk the parameter space —
    # correctness-first on an opt-in lint path (the cap MUST precede
    # capture, and capture stays env-free for its other consumers); fold
    # them only if startup-attach lint ever becomes a default.
    F: List[Finding] = []
    try:
        n = count_instances(ptg, constants, max_tasks)
    except Exception as e:
        # range/definition expressions can raise only at instantiation
        # time (e.g. a division by a zero-valued global): a finding, not
        # a linter crash
        F.append(Finding(
            "PTG051",
            f"enumerating the parameter space failed: "
            f"{type(e).__name__}: {e}"))
        return F
    if n > max_tasks:
        F.append(Finding(
            "PTG050",
            f"parameter space exceeds {max_tasks} task instances; "
            "instance-level checks skipped (raise max_tasks, or lint a "
            "smaller problem size — the checks are size-generic)"))
        return F
    try:
        g = declared_dag(ptg, constants)
    except Exception as e:
        F.append(Finding(
            "PTG051",
            f"capturing the declared DAG failed: "
            f"{type(e).__name__}: {e}"))
        return F
    cycle = find_cycle(g)
    if cycle:
        shown = cycle[:6]
        arrow = " -> ".join(f"{c}{tuple(k)}" for c, k in shown)
        if len(cycle) > len(shown):
            arrow += f" -> ... ({len(cycle)} tasks)"
        F.append(Finding(
            "PTG020",
            f"dependency cycle: {arrow} -> (back to start)",
            cycle[0][0], None, cycle[0][1]))
    for tid in g.nodes:
        pc = ptg.classes[tid[0]]
        try:
            env = pc.env_of(tid[1], constants)
            F.extend(_check_instance(ptg, pc, tid, env, constants))
        except Exception as e:
            F.append(Finding(
                "PTG051",
                f"evaluating dependencies failed: "
                f"{type(e).__name__}: {e}", tid[0], None, tid[1]))
    if not cycle:
        F.extend(_hazard_lint(ptg, g, constants))
        if fusion_hints:
            F.extend(_fusion_hints(ptg, g, constants))
    return F


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_ptg(ptg: PTG, constants: Optional[Dict[str, Any]] = None, *,
               level: str = "full", known: Iterable[str] = (),
               collections: Optional[Set[str]] = None,
               ignore: Sequence[str] = (),
               max_tasks: int = DEFAULT_MAX_TASKS,
               fusion_hints: bool = False) -> List[Finding]:
    """Verify a PTG definition.  ``constants`` are the concrete globals a
    taskpool would be instantiated with (problem sizes + collections);
    with ``constants=None`` (or ``level="static"``) only source-level
    checks run, with ``known``/``collections`` naming the symbols that
    will be supplied later.  ``ignore`` suppresses finding codes.
    ``fusion_hints`` adds the advisory PTG060 findings (info severity,
    never strict-fatal): chains/waves the supertask partitioner would
    fuse, with the dispatch count saved.  Findings are deduplicated per
    (code, task, flow, dep) with an instance count; nothing here
    executes a task body."""
    if level not in ("static", "full"):
        raise ValueError(f"verify_ptg: unknown level {level!r} "
                         "(expected 'static' or 'full')")
    # a bare string is a natural misuse of Sequence[str] — treat
    # ignore="PTG021" as one code, not five characters
    ignored = {ignore} if isinstance(ignore, str) else set(ignore)
    known_names = set(_SAFE_BUILTINS) | set(known)
    if constants is not None:
        known_names |= set(constants)
    # the ignore filter applies BEFORE the static-error gate: suppressing
    # a static code must not silently disable the instance checks (an
    # ignored defect that still breaks evaluation surfaces as PTG051)
    findings = [f for f in _static_lint(ptg, known_names, collections,
                                        constants)
                if f.code not in ignored]
    if level == "full" and constants is not None \
            and not errors_of(findings):
        # instance checks evaluate the very expressions static errors
        # indict — running them anyway would only add PTG051 noise
        findings.extend(f for f in _instance_lint(ptg, constants, max_tasks,
                                                  fusion_hints=fusion_hints)
                        if f.code not in ignored)
    return dedup(findings)


def lint_jdf(jdf, constants: Optional[Dict[str, Any]] = None, *,
             level: Optional[str] = None, **kw) -> List[Finding]:
    """Verify a compiled :class:`parsec_tpu_torch.dsl.jdf.JDF`.  Without
    ``constants`` this is the static level over the declared globals
    (what ``jdfc.generate`` runs); with concrete globals the full
    instance checks run, exactly as ``PTG.verify`` would."""
    known = {g.name for g in jdf.ast.globals} | set(jdf.ptg.constants)
    colls = {g.name for g in jdf.ast.globals if g.is_collection}
    if constants is None:
        return verify_ptg(jdf.ptg, None, level="static",
                          known=known, collections=colls, **kw)
    merged = dict(jdf.ptg.constants)
    merged.update(constants)
    return verify_ptg(jdf.ptg, merged, level=level or "full",
                      known=known, collections=colls, **kw)
