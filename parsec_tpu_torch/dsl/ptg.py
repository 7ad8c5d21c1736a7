"""PTG — Parameterized Task Graph front-end (dynamic path).

The port of :mod:`parsec_tpu.dsl.ptg`.  The reference expresses PTG in
``.jdf`` files compiled ahead-of-time to C by ``parsec_ptgpp``; here the
same algebraic model — task classes with integer parameter ranges,
affinity, guarded dataflow dependencies with task-reference ranges, control
flows, priorities, multiple body incarnations — is built **at runtime**,
with dependency expressions written as Python expressions in a compact
JDF-like syntax:

    ptg = PTG("cholesky")
    potrf = ptg.task_class("potrf", k="0 .. NT-1")
    potrf.affinity("A(k, k)")
    potrf.flow("T", INOUT,
               "<- (k == 0) ? A(k, k) : A syrk(k-1, k)",
               "-> T trsm(k, k+1 .. NT-1)",
               "-> A(k, k)")
    potrf.body(cpu=potrf_cpu, cuda=potrf_cuda)
    tp = ptg.taskpool(NT=8, A=A)     # problem-size independent, like JDF

Dependency syntax (reference JDF dependency grammar, ``parsec.y``):
  ``<-`` input, ``->`` output;
  optional guard ``(cond) ? TARGET`` or ternary ``(cond) ? T1 : T2``;
  TARGET is ``FLOW class(args)`` (task reference), ``collection(args)``
  (memory reference), ``NEW`` (fresh tile), or ``NONE``;
  an arg may be an inclusive range ``lo .. hi`` (as in JDF) — ranges in
  output deps broadcast to many successors;
  a trailing ``[key=value ...]`` property block is accepted (JDF parity)
  and stashed on the dep;
  expressions are Python, evaluated over task params + taskpool constants.

Execution model: startup enumerates the parameter space and schedules every
task whose active input deps are all memory references; prepare_input
resolves inputs to collection tiles or to the producing task's deposited
flow data (per-class, usage-counted repos); completion deposits outputs,
enumerates the guard-true output task refs and decrements each successor's
counter — successors reaching their goal are scheduled.

Whole-DAG capture (:meth:`PTGTaskpool.capture`, :mod:`.graph`), the
native engine (:meth:`PTGTaskpool.run_native`, :mod:`.native_exec`) and
the whole-DAG CUDA graph (:class:`.cuda_graph.GraphExecutor`) run the same
definitions outside the dynamic path.

Supertask fusion (:mod:`.fusion`, ``runtime_fusion``) is read at attach:
fused regions dispatch as one supertask each.

Ahead-of-time verification (:meth:`PTG.verify`, and ``PARSEC_TPU_LINT``
at attach) runs the graph linter of :mod:`parsec_tpu_torch.analysis`.

Across ranks (a context with a comm engine), a rank enumerates only its
local tasks; remote successors get one aggregated activation per rank and
a final value of a remote home tile goes home through a write-back
(:mod:`parsec_tpu_torch.comm.remote_dep`), each pre-counted by its
receiver.

A ``[type=…]``/``[shape=…]``/``[dtype=…]`` property block on an incoming
dep of a read-only flow asks for the data in another form: it resolves
through :func:`~parsec_tpu_torch.data.reshape.get_copy_reshape` (one
lazy, cached conversion, on the card for a CUDA tile), at one rank and on
a remote read alike; on a ``<- NEW`` dep the block names the new tile's
shape and dtype.
"""

from __future__ import annotations

import inspect
import itertools
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.deps import DenseDepTracker, DepTracker
from ..core.lifecycle import AccessMode, HookReturn, DEV_CPU, DEV_CUDA
from ..core.task import Chore, Flow, Task, TaskClass
from ..core.taskpool import Taskpool
from ..data.data import Data, data_create, host_array, land_into_home
from ..data.datarepo import DataRepo
from ..data.reshape import ReshapeSpec, get_copy_reshape, materialize
from ..profiling import pins
from ..utils import mca_param

IN = AccessMode.IN
OUT = AccessMode.OUT
INOUT = AccessMode.INOUT
CTL = AccessMode.CTL


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_SAFE_BUILTINS = {
    "min": min, "max": max, "abs": abs, "int": int, "range": range,
    "len": len, "divmod": divmod, "True": True, "False": False,
}
#: shared eval globals — expression evaluation is the startup hot path
#: (tens of thousands of calls per attach); a per-call dict alloc is
#: measurable there
_EVAL_GLOBALS = {"__builtins__": _SAFE_BUILTINS}

#: cumulative existence/validity predicate WORK units: one per direct
#: ``instance_exists`` evaluation (memo misses + unmemoized calls), one
#: per O(1) range-membership check inside ``valid``, and one per
#: MATERIALIZED candidate value when a parameter's range has to be
#: expanded — so an implementation that enumerates a producer's
#: parameter span scales this counter with the span.  Monotone,
#: process-wide, incremented under the GIL; read via
#: :func:`exists_eval_count` and difference around a run — the
#: deterministic measure tests pin the O(#params) law on, instead of a
#: wall-clock ratio.
_exists_evals = 0


def exists_eval_count() -> int:
    """Current value of the existence-predicate work counter."""
    return _exists_evals


def reset_exists_eval_count() -> int:
    """Zero the process-global existence-predicate work counter and
    return the value it had, so work from earlier taskpools in the same
    process cannot bleed into a measurement."""
    global _exists_evals
    old = _exists_evals
    _exists_evals = 0
    return old


def _c_to_py(src: str) -> str:
    """Accept the C boolean operators of reference JDF expressions
    (``parsec.y`` expr grammar): ``&&`` → ``and``, ``||`` → ``or``,
    ``!`` → ``not`` (but not ``!=``). Everything else is Python.
    String literals pass through untouched."""
    out: List[str] = []
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if ch in "\"'":
            j = i + 1
            while j < n and src[j] != ch:
                j += 2 if src[j] == "\\" else 1
            out.append(src[i : min(j + 1, n)])
            i = j + 1
        elif src.startswith("&&", i):
            out.append(" and ")
            i += 2
        elif src.startswith("||", i):
            out.append(" or ")
            i += 2
        elif ch == "!" and not src.startswith("!=", i):
            out.append(" not ")
            i += 1
        else:
            out.append(ch)
            i += 1
    return "".join(out)


class _Expr:
    """A compiled Python expression over task params + constants."""

    __slots__ = ("src", "code")

    def __init__(self, src: str):
        self.src = src.strip()
        self.code = compile(_c_to_py(self.src), f"<ptg:{self.src}>", "eval")

    def __call__(self, env: Dict[str, Any]) -> Any:
        return eval(self.code, _EVAL_GLOBALS, env)

    def __repr__(self) -> str:
        return f"_Expr({self.src!r})"


def _split_top(s: str, sep: str) -> List[str]:
    """Split on ``sep`` at paren/bracket depth 0."""
    parts: List[str] = []
    depth, cur, i = 0, [], 0
    while i < len(s):
        ch = s[i]
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if depth == 0 and s.startswith(sep, i):
            parts.append("".join(cur))
            cur = []
            i += len(sep)
            continue
        cur.append(ch)
        i += 1
    parts.append("".join(cur))
    return parts


class _ArgExpr:
    """Scalar expression or inclusive range ``lo .. hi`` with optional
    stride ``lo .. hi .. step`` (reference jdf_expr ranges — e.g.
    strange.jdf's ``step = 0 .. N .. (N+1)``, a stride larger than the
    span yielding a single value; udf.jdf strides through inline calls
    whose side effect counts enumerations)."""

    __slots__ = ("lo", "hi", "step")

    def __init__(self, src: str):
        parts = _split_top(src, "..")
        if len(parts) == 1:
            self.lo, self.hi, self.step = _Expr(parts[0]), None, None
        elif len(parts) == 2:
            self.lo, self.hi, self.step = _Expr(parts[0]), _Expr(parts[1]), None
        elif len(parts) == 3:
            self.lo, self.hi = _Expr(parts[0]), _Expr(parts[1])
            self.step = _Expr(parts[2])
        else:
            raise ValueError(f"bad range expression {src!r}")

    def values(self, env: Dict[str, Any]) -> Iterable[int]:
        if self.hi is None:
            v = self.lo(env)
            return v if isinstance(v, range) else (v,)
        step = 1 if self.step is None else int(self.step(env))
        if step <= 0:
            raise ValueError(
                f"range {self.lo.src}..{self.hi.src} stride must be positive")
        return range(int(self.lo(env)), int(self.hi(env)) + 1, step)

    def scalar(self, env: Dict[str, Any]) -> Any:
        if self.hi is not None:
            raise ValueError(f"range {self.lo.src}..{self.hi.src} used as scalar")
        return self.lo(env)


# ---------------------------------------------------------------------------
# dependency targets & parsing
# ---------------------------------------------------------------------------

class _TaskRef:
    __slots__ = ("flow_name", "class_name", "args")

    def __init__(self, flow_name: str, class_name: str, args: List[_ArgExpr]):
        self.flow_name, self.class_name, self.args = flow_name, class_name, args


class _DataRef:
    __slots__ = ("collection_name", "args")

    def __init__(self, collection_name: str, args: List[_ArgExpr]):
        self.collection_name, self.args = collection_name, args

    def key(self, env: Dict[str, Any]) -> Tuple:
        return tuple(a.scalar(env) for a in self.args)


class _NewRef:
    __slots__ = ()


class _NoneRef:
    __slots__ = ()


_TARGET_RE = re.compile(
    r"^\s*(?:(?P<flow>[A-Za-z_]\w*)\s+)?(?P<name>[A-Za-z_]\w*)\s*\((?P<args>.*)\)\s*$",
    re.S,
)


def _parse_target(s: str):
    s = s.strip()
    if s in ("NEW", "new"):
        return _NewRef()
    if s in ("NONE", "NULL", "none"):
        return _NoneRef()
    m = _TARGET_RE.match(s)
    if not m:
        raise ValueError(f"cannot parse dependency target {s!r}")
    argsrc = m.group("args").strip()
    args = [_ArgExpr(a) for a in (_split_top(argsrc, ",") if argsrc else [])]
    if m.group("flow"):
        return _TaskRef(m.group("flow"), m.group("name"), args)
    return _DataRef(m.group("name"), args)


class _Dep:
    """One guarded dependency (reference ``jdf_dep_t``)."""

    __slots__ = ("is_input", "guard", "then", "otherwise", "props", "src")

    def __init__(self, is_input, guard, then, otherwise=None, props=None,
                 src=""):
        self.is_input = is_input
        self.guard = guard
        self.then = then
        self.otherwise = otherwise
        self.props = props or {}
        #: original dependency source text — diagnostics (analysis
        #: findings, runtime errors) point at the exact offending dep
        self.src = src

    def target(self, env: Dict[str, Any]):
        if self.guard is None:
            return self.then
        return self.then if self.guard(env) else self.otherwise


def _parse_dep(spec: str) -> _Dep:
    spec = spec.strip()
    orig = spec
    props: Dict[str, str] = {}
    pm = re.search(r"\[(.*?)\]\s*$", spec)
    if pm:
        # JDF property blocks allow spaces around '=' and parenthesized
        # values with internal spaces: normalize, then split at depth 0
        body = re.sub(r"\s*=\s*", "=", pm.group(1).strip())
        depth, cur = 0, []
        tokens: List[str] = []
        for ch in body:
            if ch in "([":
                depth += 1
            elif ch in ")]":
                depth -= 1
            if ch.isspace() and depth == 0:
                if cur:
                    tokens.append("".join(cur))
                    cur = []
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
        for kv in tokens:
            if "=" in kv:
                k, v = kv.split("=", 1)
                props[k] = v.strip('"').strip("'")
        spec = spec[: pm.start()].strip()
    if spec.startswith("<-"):
        is_input, rest = True, spec[2:].strip()
    elif spec.startswith("->"):
        is_input, rest = False, spec[2:].strip()
    else:
        raise ValueError(f"dependency must start with '<-' or '->': {spec!r}")
    qparts = _split_top(rest, "?")
    if len(qparts) == 2:
        cond = qparts[0].strip()
        if not (cond.startswith("(") and cond.endswith(")")):
            raise ValueError(f"guard must be parenthesized: {spec!r}")
        guard = _Expr(cond[1:-1])
        branches = _split_top(qparts[1], ":")
        then = _parse_target(branches[0])
        otherwise = _parse_target(branches[1]) if len(branches) == 2 else None
        return _Dep(is_input, guard, then, otherwise, props, src=orig)
    if len(qparts) > 2:
        raise ValueError(f"bad ternary in {spec!r}")
    return _Dep(is_input, None, _parse_target(rest), None, props, src=orig)


def _expand_args(args: Sequence[_ArgExpr], env: Dict[str, Any]) -> Iterable[Tuple]:
    pools = [tuple(a.values(env)) for a in args]
    return itertools.product(*pools)


# ---------------------------------------------------------------------------
# declarations (problem-size independent, like a .jdf file)
# ---------------------------------------------------------------------------

class _PTGFlow:
    __slots__ = ("name", "mode", "deps_in", "deps_out", "index")

    def __init__(self, name: str, mode: AccessMode, index: int):
        self.name, self.mode, self.index = name, mode, index
        self.deps_in: List[_Dep] = []
        self.deps_out: List[_Dep] = []

    def add_deps(self, deps: Sequence[str]) -> None:
        """Parse ``deps`` and append each to the input or output list."""
        for d in deps:
            dep = _parse_dep(d)
            (self.deps_in if dep.is_input else self.deps_out).append(dep)


class PTGTaskClass:
    """Declarative task class (reference ``jdf_function_entry_t``).

    Locals come in two kinds, in declaration order (reference ``jdf_def_t``
    list): **parameters** (named in the task heading, each with an integer
    range — they form the task key) and **definitions** (derived scalars
    like ``m = t % NT``, usable in later ranges, dependencies, affinity,
    priority, and the body)."""

    def __init__(self, ptg: "PTG", name: str, params: Dict[str, str]):
        self.ptg = ptg
        self.name = name
        # (name, expr, is_param) in declaration order
        self.decls: List[Tuple[str, _ArgExpr, bool]] = [
            (k, _ArgExpr(v), True) for k, v in params.items()
        ]
        self.flows: List[_PTGFlow] = []
        self._affinity: Optional[_DataRef] = None
        self._priority: Optional[_Expr] = None
        self.bodies: Dict[str, Callable] = {}
        #: per-device incarnation applicability predicates (reference
        #: BODY [evaluate = fn]: HOOK_RETURN_NEXT skips the incarnation)
        self.chore_evaluate: Dict[str, Callable] = {}
        #: flow name -> (stage_in, stage_out) custom device staging
        self.stage_hooks: Dict[str, Tuple[Optional[Callable],
                                          Optional[Callable]]] = {}
        #: taskpool-constant names passed to bodies by name (JDF globals
        #: are visible inside reference BODY blocks as C globals)
        self.body_globals: List[str] = []
        #: the JDF heading's property block (``[ high_priority = on ]``)
        self.properties: Dict[str, Any] = {}

    @property
    def param_names(self) -> List[str]:
        return [n for n, _, p in self.decls if p]

    @property
    def def_names(self) -> List[str]:
        return [n for n, _, p in self.decls if not p]

    def define(self, name: str, expr: str) -> "PTGTaskClass":
        """Append a derived-local definition (JDF ``name = expr`` line)."""
        self.decls.append((name, _ArgExpr(expr), False))
        return self

    def use_globals(self, *names: str) -> "PTGTaskClass":
        """Declare taskpool constants the bodies receive as keyword args."""
        self.body_globals.extend(n for n in names if n not in self.body_globals)
        return self

    def param(self, name: str, range_src: str) -> "PTGTaskClass":
        """Append a parameter range in declaration order (JDF ``k = lo..hi``
        for a name listed in the task heading)."""
        self.decls.append((name, _ArgExpr(range_src), True))
        return self

    def affinity(self, spec: str) -> "PTGTaskClass":
        t = _parse_target(spec)
        if not isinstance(t, _DataRef):
            raise ValueError("affinity must be a collection reference")
        self._affinity = t
        return self

    def priority(self, expr: str) -> "PTGTaskClass":
        self._priority = _Expr(expr)
        return self

    def flow(self, name: str, mode: AccessMode, *deps: str) -> "PTGTaskClass":
        f = _PTGFlow(name, mode, len(self.flows))
        f.add_deps(deps)
        self.flows.append(f)
        return self

    def add_dep(self, flow_name: str, *deps: str) -> "PTGTaskClass":
        """Append dependencies to an EXISTING flow.  Graph-synthesis front
        ends (:mod:`parsec_tpu_torch.array`) build producer classes before
        their consumers exist, then mirror the consumer edges back onto the
        producer once they are known — JDF reciprocity demands both sides,
        but a synthesizer discovers them one at a time.

        Only valid before the definition's first ``taskpool()``: the dense
        dep boxes, fusion's partition cache (keyed by the definition) and a
        captured graph's digest are all derived from a built pool, so an
        edge added after one would leave them describing another graph."""
        if self.ptg.instantiated:
            raise RuntimeError(
                f"class {self.name}: add_dep after PTG {self.ptg.name!r} "
                "built a taskpool — derived structures would go stale")
        for f in self.flows:
            if f.name == flow_name:
                f.add_deps(deps)
                return self
        raise ValueError(f"class {self.name}: no flow {flow_name!r}")

    def ctl(self, name: str, *deps: str) -> "PTGTaskClass":
        return self.flow(name, CTL, *deps)

    def body(self, cpu: Optional[Callable] = None, cuda: Optional[Callable] = None,
             **others: Callable) -> "PTGTaskClass":
        """Register BODY incarnations by device type: ``cpu`` bodies are
        numpy and mutate their tiles in place; ``cuda`` bodies are
        functional torch (tensors in, fresh tensors out for the writable
        flows, in declaration order)."""
        if cpu is not None:
            self.bodies[DEV_CPU] = cpu
        if cuda is not None:
            self.bodies[DEV_CUDA] = cuda
        self.bodies.update(others)
        return self

    def evaluate_hook(self, device: str, fn: Callable) -> "PTGTaskClass":
        """Attach an applicability predicate to one device's incarnation
        (reference BODY ``[evaluate = fn]``): ``fn(task) -> bool``; False
        skips this incarnation at device selection."""
        self.chore_evaluate[device] = fn
        return self

    def stage(self, flow_name: str, stage_in: Optional[Callable] = None,
              stage_out: Optional[Callable] = None) -> "PTGTaskClass":
        """Custom per-flow device staging (reference BODY
        ``stage_in=``/``stage_out=`` properties reaching the GPU task,
        ``device_gpu.h:62-94``).

        ``stage_in(data, device) -> torch.Tensor`` replaces the default
        whole-tile H2D staging — pack a strided subtile, convert layout —
        and its result becomes the flow's device copy.
        ``stage_out(tensor, data, device) -> torch.Tensor`` transforms the
        body's output for that flow before it is committed as the new
        device copy (e.g. scatter the packed subtile back)."""
        if flow_name not in {f.name for f in self.flows}:
            raise ValueError(f"class {self.name}: no flow {flow_name!r}")
        self.stage_hooks[flow_name] = (stage_in, stage_out)
        return self

    # -- evaluation over a constants dict --------------------------------
    def env_of(self, locals_: Tuple, constants: Dict[str, Any]) -> Dict[str, Any]:
        """Bind params from the task key and evaluate definitions in
        declaration order (definitions may reference earlier locals)."""
        env = dict(constants)
        it = iter(locals_)
        for name, expr, is_param in self.decls:
            env[name] = next(it) if is_param else expr.scalar(env)
        return env

    def param_space(self, constants: Dict[str, Any]) -> Iterable[Tuple]:
        def rec(i: int, env: Dict[str, Any], acc: Tuple):
            if i == len(self.decls):
                yield acc
                return
            name, expr, is_param = self.decls[i]
            if is_param:
                for v in expr.values(env):
                    e2 = dict(env)
                    e2[name] = v
                    yield from rec(i + 1, e2, acc + (v,))
            else:
                e2 = dict(env)
                e2[name] = expr.scalar(env)
                yield from rec(i + 1, e2, acc)

        yield from rec(0, dict(constants), ())

    def valid(self, locals_: Tuple, constants: Dict[str, Any]) -> bool:
        """Membership of ``locals_`` in the parameter space: O(#params),
        with O(1) range membership per parameter (each check one unit of
        :func:`exists_eval_count`; a range that must be materialized
        counts its candidates)."""
        global _exists_evals
        env = dict(constants)
        it = iter(locals_)
        for name, expr, is_param in self.decls:
            if is_param:
                v = next(it)
                vals = expr.values(env)
                if isinstance(vals, range):
                    _exists_evals += 1
                else:
                    vals = tuple(vals)
                    _exists_evals += max(len(vals), 1)
                if v not in vals:
                    return False
                env[name] = v
            else:
                env[name] = expr.scalar(env)
        return True

    def active_input(self, f: _PTGFlow, env: Dict[str, Any]):
        t = self.active_input_dep(f, env)
        return t[1] if t is not None else None

    def active_input_dep(self, f: _PTGFlow, env: Dict[str, Any]):
        """The guard-true input dep and its target, or None."""
        for dep in f.deps_in:
            t = dep.target(env)
            if t is not None and not isinstance(t, _NoneRef):
                return dep, t
        return None

    def input_defined(self, f: _PTGFlow, env: Dict[str, Any]) -> bool:
        """True when some input dep *matches* under env — including an
        explicit NONE branch ("this flow has no input here", defined).
        False means no guard matched at all: with dynamic guards the route
        simply isn't decided yet."""
        for dep in f.deps_in:
            if dep.target(env) is not None:
                return True
        return False

    def goal_of(self, locals_: Tuple, constants: Dict[str, Any],
                memo: Optional[Dict] = None) -> int:
        """Counter-mode dependency goal. Data flows have exactly one active
        source (guarded alternatives, JDF single-assignment); CTL flows
        *gather*: every guard-true dep contributes one dependency per
        instance of its (possibly ranged) task reference."""
        env = self.env_of(locals_, constants)
        goal = 0
        for f in self.flows:
            if f.mode == CTL:
                for dep in f.deps_in:
                    t = dep.target(env)
                    if isinstance(t, _TaskRef):
                        src_pc = self.ptg.classes[t.class_name]
                        for locs in _expand_args(t.args, env):
                            if len(locs) == len(src_pc.param_names) and src_pc.valid(locs, constants):
                                goal += 1
            else:
                t = self.active_input(f, env)
                if isinstance(t, _TaskRef):
                    # an input whose producer reference falls OUTSIDE the
                    # producer's parameter space does not exist — it must
                    # not count toward the goal
                    src_pc = self.ptg.classes[t.class_name]
                    locs = tuple(a.scalar(env) for a in t.args)
                    if src_pc.instance_exists(locs, constants, memo):
                        goal += 1
        return goal

    def instance_exists(self, key: Tuple, constants: Dict[str, Any],
                        memo: Optional[Dict] = None) -> bool:
        """True when ``key`` names a real instance of this class — the
        ONE predicate behind goal counting and input resolution.  ``memo``
        (the taskpool's per-instance dict, safe because existence depends
        only on the taskpool constants) bounds it to one evaluation per
        distinct (class, key).  Every direct evaluation (memo miss
        included) counts one unit of :func:`exists_eval_count`."""
        global _exists_evals
        if memo is not None:
            mk = (self.name, key)
            r = memo.get(mk)
            if r is None:
                _exists_evals += 1
                r = memo[mk] = (len(key) == len(self.param_names)
                                and self.valid(key, constants))
            return r
        _exists_evals += 1
        return len(key) == len(self.param_names) and self.valid(key, constants)

    def rank_of(self, locals_: Tuple, constants: Dict[str, Any]) -> int:
        if self._affinity is None:
            return 0
        env = self.env_of(locals_, constants)
        dc = constants[self._affinity.collection_name]
        return dc.rank_of(*self._affinity.key(env))

    def priority_of(self, locals_: Tuple, constants: Dict[str, Any]) -> int:
        if self._priority is None:
            return 0
        return int(self._priority(self.env_of(locals_, constants)))


class PTG:
    """A PTG definition. ``taskpool(**constants)`` instantiates it — the
    analogue of the generated ``parsec_<name>_new(...)``, reusable with
    different problem sizes."""

    def __init__(self, name: str, *, dep_storage: Optional[str] = None,
                 **constants: Any):
        self.name = name
        #: dependency-storage backend: "hash" | "dense" | None (= the
        #: ``runtime_dep_storage`` MCA param; reference: ``jdf2c -M``
        #: dynamic-hash-table vs index-array, ``ptg-compiler/main.c:37``)
        self.dep_storage = dep_storage
        self.constants: Dict[str, Any] = dict(constants)
        self.classes: Dict[str, PTGTaskClass] = {}
        #: True once ``taskpool()`` built a pool: the class deps are final
        #: from then on (:meth:`PTGTaskClass.add_dep` refuses)
        self.instantiated = False

    def task_class(self, name: str, **params: str) -> PTGTaskClass:
        c = PTGTaskClass(self, name, params)
        self.classes[name] = c
        return c

    def taskpool(self, termdet: Optional[str] = None,
                 **constants: Any) -> "PTGTaskpool":
        """A pool of this PTG over ``constants``.  The pool's ``job`` is a
        fresh job id (:func:`..profiling.pins.new_job`), or the job of a
        span open on this thread (a front end building the pool inside its
        own ``taskpool`` span); its construction is a ``taskpool`` span."""
        merged = dict(self.constants)
        merged.update(constants)
        self.instantiated = True
        job = pins.current_job() or pins.new_job()
        with pins.span("taskpool", job=job):
            tp = PTGTaskpool(self, merged, termdet=termdet)
        tp.job = job
        return tp

    def verify(self, globals_: Optional[Dict[str, Any]] = None, *,
               level: str = "full", ignore: Sequence[str] = (),
               known: Optional[Iterable[str]] = None,
               collections: Optional[set] = None,
               max_tasks: Optional[int] = None,
               **more: Any):
        """Ahead-of-time graph verification (the jdfc sanity-check
        analogue): enumerate the parameter space under the given concrete
        globals WITHOUT executing any task body and check edge
        reciprocity, data hazards, cycles/liveness, and expression/
        affinity sanity.  Returns a list of
        :class:`parsec_tpu_torch.analysis.Finding` (empty = clean).

        ``level``: ``"full"`` (default) runs every check; ``"static"``
        runs only source-level lint (no parameter-space enumeration).
        ``ignore`` suppresses finding codes (e.g. ``("PTG021",)`` for
        graphs with dynamic guards).  ``known``/``collections`` name the
        symbols a later taskpool() call will supply (without them, a
        no-globals static verify treats every referenced symbol as
        known).  ``max_tasks`` caps the instance enumeration (PTG050
        beyond it).  Extra keyword arguments are graph globals, mirroring
        ``taskpool(**constants)``."""
        from ..analysis import verify_ptg
        from ..analysis.linter import collection_names, free_symbols

        kw: Dict[str, Any] = {"level": level, "ignore": ignore}
        if max_tasks is not None:
            kw["max_tasks"] = max_tasks
        if globals_ is None and not more:
            # no concrete globals: static-only lint of the definition,
            # judged against the caller's names or, by default, every
            # symbol the definition references
            if known is None:
                known = free_symbols(self) | set(self.constants)
            if collections is None:
                collections = collection_names(self)
            return verify_ptg(self, None, known=known,
                              collections=collections, **kw)
        if known is not None:
            kw["known"] = known
        if collections is not None:
            kw["collections"] = collections
        merged = dict(self.constants)
        merged.update(globals_ or {})
        merged.update(more)
        return verify_ptg(self, merged, **kw)


# ---------------------------------------------------------------------------
# the instantiated taskpool (what jdf2c generates)
# ---------------------------------------------------------------------------

class PTGTaskpool(Taskpool):
    def __init__(self, ptg: PTG, constants: Dict[str, Any],
                 termdet: Optional[str] = None):
        super().__init__(name=ptg.name, termdet=termdet)
        self.taskpool_type = Taskpool.TYPE_PTG
        self.ptg = ptg
        self.constants = constants
        self.deps = self._make_dep_tracker()
        self.repos: Dict[str, DataRepo] = {}
        self._built: Dict[str, TaskClass] = {}
        self._local_cache: Dict[str, List[Tuple]] = {}
        #: per class, the inclusive (lo, hi) bounding box of its parameter
        #: space: the dense dependency storage's array shape
        self._class_box: Dict[str, Tuple] = {}
        #: True once attach counted the local tasks up front (dense mode)
        self._counted = False
        self._new_tiles: Dict[Tuple, Data] = {}
        self._new_lock = threading.Lock()
        #: exactly-once guard for GOAL-0 tasks: the chunked startup scan
        #: and a producer release (possible with dynamic guards) may both
        #: decide to schedule one — whoever claims first wins
        self._source_claims: set = set()
        self._claims_lock = threading.Lock()
        #: (class_name, key) -> bool existence memo shared by goal
        #: counting and repo-miss resolution: existence depends only on
        #: the taskpool constants
        self._exists_memo: Dict[Tuple[str, Tuple], bool] = {}
        #: supertask-fusion table (:class:`.fusion.FusionTable`), built at
        #: attach when ``runtime_fusion`` is on: routes fused members'
        #: releases to region counters and dispatches each region as ONE
        #: device chore; None = per-task dispatch (the default); and the
        #: seconds the attach spent building it (a capture, partition and
        #: lowering, or the partition cache's lookup)
        self._fusion = None
        self.fusion_setup_s = 0.0
        for pc in ptg.classes.values():
            self.repos[pc.name] = DataRepo(nb_flows=len(pc.flows))
            self._build_class(pc)
        self.startup_hook = self._startup
        # the PTG manages task accounting itself: the chunked startup
        # scan's incremental adds (reference task_startup_iter/chunk,
        # parsec.c:669-676) — never per-schedule auto counting
        self.auto_count = False

    def capture(self, ranks: Optional[Sequence[int]] = None):
        """Materialize this taskpool's full DAG (see
        :func:`parsec_tpu_torch.dsl.graph.capture`): the entry point of the
        native executor."""
        from .graph import capture as _capture

        return _capture(self, ranks)

    def run_native(self, *, nthreads: int = 4, native_device: bool = False,
                   device=None, fusion: Optional[str] = None) -> int:
        """Execute this (unstarted) taskpool on the native C++ engine —
        dependency counting, scheduling and termination never enter the
        interpreter.  CPU bodies by default; ``native_device=True`` runs
        every task through the CUDA device module driven by the native
        pump, fused regions as one dispatch each (``fusion``, None: the
        ``runtime_fusion`` MCA param).  See
        :class:`parsec_tpu_torch.dsl.native_exec.NativeExecutor`."""
        from .native_exec import run_native as _run_native

        return _run_native(self, nthreads=nthreads, native_device=native_device,
                           device=device, fusion=fusion)

    def _make_dep_tracker(self):
        """The dependency-storage backend (reference: per-class ``-M``
        choice between the dynamic hash table and the dense index-array,
        ``ptg-compiler/main.c:37`` / ``parsec_internal.h:359-362``).  The
        dense boxes are registered at attach, by the enumeration that
        counts the local tasks (:meth:`_count_local`)."""
        mode = self.ptg.dep_storage
        if mode is None:
            mode = mca_param.register(
                "runtime", "dep_storage", "hash",
                help="PTG dependency-tracking storage: hash (dynamic hash "
                     "table) or dense (index array over each class's "
                     "parameter box)")
        if mode not in ("hash", "dense"):
            raise ValueError(
                f"PTG {self.ptg.name}: unknown dep_storage {mode!r} "
                "(expected 'hash' or 'dense')")
        return DenseDepTracker() if mode == "dense" else DepTracker()

    def _local_space(self, pc: PTGTaskClass,
                     rank: Optional[int] = None) -> List[Tuple]:
        """The class's tasks placed on ``rank`` (default: this context's),
        recording the whole class's parameter box on the way."""
        if rank is None:
            rank = self.context.rank if self.context else 0
        cached = self._local_cache.get(pc.name)
        if cached is None:
            cached = []
            lo = hi = None
            for loc in pc.param_space(self.constants):
                if lo is None:
                    lo, hi = list(loc), list(loc)
                else:
                    for i, v in enumerate(loc):
                        lo[i] = min(lo[i], v)
                        hi[i] = max(hi[i], v)
                if pc.rank_of(loc, self.constants) == rank:
                    cached.append(loc)
            if lo is not None:
                self._class_box[pc.name] = tuple(
                    (int(a), int(b)) for a, b in zip(lo, hi))
            self._local_cache[pc.name] = cached
        return cached

    def _count_local(self, rank: int) -> int:
        """Enumerate every class's tasks on ``rank``, register the dense
        boxes, and return the exact local task count."""
        self._local_cache.clear()
        n = sum(len(self._local_space(pc, rank))
                for pc in self.ptg.classes.values())
        if isinstance(self.deps, DenseDepTracker):
            for name, box in self._class_box.items():
                self.deps.register_class(name, box)
        return n

    def attached(self, context) -> None:
        # PARSEC_TPU_LINT: a strict failure fails this pool (the context
        # stays usable) and raises before any task is scheduled
        try:
            self._maybe_lint()
        except Exception as e:
            self.context = context
            self.fail(f"startup lint failed: {e}")
            raise
        # supertask fusion (runtime_fusion): capture, partition and lower
        # before any task is scheduled.  A failure fails this pool (the
        # context stays usable) and raises: per-task dispatch never
        # replaces a requested fusion in silence
        from .fusion import build_fusion_table

        t0 = time.perf_counter()
        try:
            self._fusion = build_fusion_table(self, context)
            self.fusion_setup_s = time.perf_counter() - t0
        except Exception as e:
            self.context = context
            self.fail(f"supertask fusion failed: {type(e).__name__}: {e}")
            raise
        if self._fusion is not None:
            for d in context.devices:
                d.set_aside(self._fusion.room)
        if isinstance(self.deps, DenseDepTracker):
            # dense mode: the class boxes must be registered before ANY
            # release (a counter split between the hash fallback and the
            # dense array never reaches its goal), and the same
            # enumeration yields the exact local count: scan up front
            self.tdm.taskpool_set_nb_tasks(self, self._count_local(context.rank))
            self._counted = True
        else:
            # hash mode: no pre-scan — the chunked startup pass counts
            # local tasks incrementally while the first chunks already
            # execute (add_taskpool holds a runtime action across startup,
            # so the transiently-small count cannot quiesce)
            self.tdm.taskpool_set_nb_tasks(self, 0)
            self._counted = False
        if context.nranks > 1:
            # the final values remote tasks write into tiles this rank
            # owns: each arrival is one pre-counted runtime action, so
            # the pool cannot quiesce before the data lands
            n_wb = self._count_expected_writebacks(context.rank)
            if n_wb:
                self.tdm.taskpool_addto_runtime_actions(self, n_wb)
        super().attached(context)

    def _maybe_lint(self) -> None:
        """Opt-in startup verification (``PARSEC_TPU_LINT``): ``1``/``warn``
        logs findings and continues; ``strict``/``2`` raises
        :class:`..analysis.LintError` on error-severity findings before
        any task is scheduled.  ``PARSEC_TPU_LINT_IGNORE`` suppresses
        codes (comma/space separated, e.g. ``PTG021`` for dynamic-guard
        graphs).  Off by default: the verifier re-enumerates the
        parameter space."""
        import os

        mode = os.environ.get("PARSEC_TPU_LINT", "").strip().lower()
        if mode in ("", "0", "off"):
            return
        from ..analysis import verify_ptg
        from ..analysis.findings import LintError, errors_of
        from ..utils import debug

        ignore = tuple(
            c for c in os.environ.get("PARSEC_TPU_LINT_IGNORE", "")
            .replace(",", " ").split() if c)
        findings = verify_ptg(self.ptg, self.constants, ignore=ignore)
        for f in findings:
            debug.warning("lint %s: %s", self.ptg.name, f)
        if mode in ("strict", "2") and errors_of(findings):
            raise LintError(
                f"PARSEC_TPU_LINT=strict: taskpool {self.ptg.name} has "
                f"{len(errors_of(findings))} lint error(s)", findings)

    # -- vtable construction (the jdf2c analogue) ------------------------
    def _build_class(self, pc: PTGTaskClass) -> None:
        taken = {f.name for f in pc.flows} | {n for n, _, _ in pc.decls}
        clash = [n for n in pc.body_globals if n in taken]
        if clash:
            raise ValueError(
                f"class {pc.name}: use_globals names {clash} collide with "
                "a flow or local — bodies would receive the wrong value")
        flows = [Flow(f.name, f.mode, f.index) for f in pc.flows]
        tc = TaskClass(pc.name, flows=flows, nb_parameters=len(pc.param_names))
        tc.prepare_input = self._make_prepare_input(pc)
        tc.release_deps = self._make_release_deps(pc)
        for dev_type, fn in pc.bodies.items():
            if dev_type == DEV_CPU:
                chore = Chore(DEV_CPU, _make_cpu_hook(pc, fn))
            else:
                chore = Chore(dev_type, _accel_hook)
                chore.body_fn = _wrap_device_body(pc, fn)
            chore.evaluate = pc.chore_evaluate.get(dev_type)
            tc.add_chore(chore)
        self._built[pc.name] = tc
        self.add_task_class(tc)

    #: local tasks discovered per accounting/scheduling step of the
    #: chunked startup scan (reference task_startup_chunk, parsec.c:669)
    STARTUP_CHUNK = 256

    def _startup(self, context, tp) -> List[Task]:
        # chunked startup: ONE pass over the task space per class doing
        # local-count + source detection, releasing each chunk to the
        # schedulers as it is found — execution overlaps the remainder of
        # the enumeration (reference task_startup_iter/chunk,
        # jdf2c.c:3036).  Dynamic-input tasks are held back via the
        # `undefined` path and released by their producers.
        from ..core import scheduling

        if self._counted:
            # dense mode counted at attach: the cache holds the local
            # space and the count is final — only pick the sources
            out: List[Task] = []
            for pc in self.ptg.classes.values():
                undefined = claimed = 0
                for loc in self._local_space(pc):
                    if pc.goal_of(loc, self.constants, self._exists_memo) != 0:
                        continue
                    if not self._is_startup(pc, loc, goal_known_zero=True):
                        undefined += 1
                    elif self._claim_source(pc.name, loc):
                        t = self._route_source(pc, loc)
                        if t is not None:
                            out.append(t)
                    else:
                        claimed += 1  # a producer beat the scan to it: fine
                self._warn_undefined(pc, undefined, claimed)
            return out

        myrank = context.rank if context is not None else 0
        for pc in self.ptg.classes.values():
            cached: List[Tuple] = []
            ready: List[Task] = []
            pending = 0
            undefined = claimed = 0
            for loc in pc.param_space(self.constants):
                if pc.rank_of(loc, self.constants) != myrank:
                    continue
                cached.append(loc)
                pending += 1
                if pc.goal_of(loc, self.constants, self._exists_memo) == 0:
                    if not self._is_startup(pc, loc, goal_known_zero=True):
                        undefined += 1
                    elif self._claim_source(pc.name, loc):
                        t = self._route_source(pc, loc)
                        if t is not None:
                            ready.append(t)
                    else:
                        claimed += 1  # a producer beat the scan to it: fine
                if pending >= self.STARTUP_CHUNK:
                    # count BEFORE scheduling: a chunk task retiring
                    # instantly must never see an unaccounted self
                    self.tdm.taskpool_addto_nb_tasks(self, pending)
                    pending = 0
                    if ready:
                        scheduling.schedule_ready(context, None, ready)
                        ready = []
            if pending:
                self.tdm.taskpool_addto_nb_tasks(self, pending)
            if ready:
                scheduling.schedule_ready(context, None, ready)
            self._local_cache[pc.name] = cached
            self._warn_undefined(pc, undefined, claimed)
        return []

    def _route_source(self, pc: PTGTaskClass, loc: Tuple) -> Optional[Task]:
        """Claimed startup source → a schedulable task: the task itself,
        or for a fused member one region-readiness event (the supertask,
        exactly once, when the region's last event lands)."""
        if self._fusion is not None:
            handled, supertask = self._fusion.route_ready(pc.name, loc)
            if handled:
                return supertask
        return self._make_task(pc, loc)

    def _claim_source(self, name: str, locs: Tuple) -> bool:
        """Atomically claim the right to schedule a goal-0 task.  Closes
        the race between the chunked startup scan and a concurrent
        producer release firing into the same task (dynamic guards)."""
        key = (name, locs)
        with self._claims_lock:
            if key in self._source_claims:
                return False
            self._source_claims.add(key)
            return True

    def _warn_undefined(self, pc: PTGTaskClass, undefined: int,
                        claimed: int = 0) -> None:
        from ..utils import debug

        if undefined:
            # goal 0 but some readable flow had no matched input dep:
            # legitimate with dynamic guards (a producer releases the
            # task later), a guaranteed hang if the guards are static
            debug.verbose(
                2, "ptg",
                "%s: %d task(s) held back from startup — a readable "
                "flow matched no input dep; if its guards are static, "
                "add an explicit '<- NONE' fallback", pc.name, undefined)
        if claimed:
            debug.verbose(
                3, "ptg",
                "%s: %d source task(s) already claimed by producer "
                "releases during the startup scan", pc.name, claimed)

    def _is_startup(self, pc: PTGTaskClass, loc: Tuple,
                    goal_known_zero: bool = False) -> bool:
        """A task starts immediately only when its dependency goal is zero
        AND every readable flow that declares input deps has a guard-true
        one right now (dynamic guards may hold it back)."""
        if not goal_known_zero and pc.goal_of(loc, self.constants, self._exists_memo) != 0:
            return False
        env = pc.env_of(loc, self.constants)
        for f in pc.flows:
            if f.mode == CTL or not (f.mode & AccessMode.IN):
                continue
            if f.deps_in and not pc.input_defined(f, env):
                return False
        return True

    def _make_task(self, pc: PTGTaskClass, locals_: Tuple) -> Task:
        return Task(self, self._built[pc.name], locals_,
                    priority=pc.priority_of(locals_, self.constants))

    # -- data resolution -------------------------------------------------
    def _make_prepare_input(self, pc: PTGTaskClass):
        def prepare_input(es, task: Task) -> HookReturn:
            env = pc.env_of(task.locals, self.constants)
            specs: List[Tuple[str, Any, AccessMode]] = []
            for f in pc.flows:
                if f.mode == CTL:
                    specs.append(("ctl", None, CTL))
                    continue
                dt = pc.active_input_dep(f, env)
                dep, target = dt if dt is not None else (None, None)
                data = self._resolve_input(pc, f, target, env, task)
                if (data is not None and dep is not None and dep.props
                        and not isinstance(target, _NewRef)):
                    # dep-level reshape request (reference
                    # parsec_get_copy_reshape_from_dep, parsec_reshape.c);
                    # input-side reshape only makes sense for read-only
                    # flows — a writable flow would divert its writes into
                    # the converted copy and corrupt the home tile
                    rspec = ReshapeSpec.from_props(dep.props, self.constants)
                    if rspec is not None:
                        if f.mode & AccessMode.OUT:
                            raise ValueError(
                                f"{pc.name}.{f.name}: reshape props "
                                f"{dep.props} on a writable flow are not "
                                "supported (reads would be diverted)")
                        data = materialize(get_copy_reshape(data, rspec))
                specs.append(("data", data, f.mode))
                task.data_in[f.index] = data.newest_copy() if data is not None else None
            for name in pc.param_names + pc.def_names + pc.body_globals:
                specs.append(("value", env[name], AccessMode.VALUE))
            task.body_args = specs
            return HookReturn.DONE

        return prepare_input

    def _resolve_input(self, pc: PTGTaskClass, f: _PTGFlow, target, env, task: Task) -> Optional[Data]:
        if target is None or isinstance(target, _NoneRef):
            if f.mode & AccessMode.OUT:
                return self._new_tile(pc, f, task.locals)  # pure output, no source
            return None
        if isinstance(target, _NewRef):
            return self._new_tile(pc, f, task.locals)
        if isinstance(target, _DataRef):
            dc = self.constants[target.collection_name]
            return dc.data_of(*target.key(env))
        # task reference: producer deposited the flow data in its repo
        src_pc = self.ptg.classes[target.class_name]
        key = tuple(a.scalar(env) for a in target.args)
        entry = self.repos[src_pc.name].consume(key)
        if entry is None:
            # miss: either an out-of-range producer reference (the input
            # does not exist — goal_of excluded it) or a real
            # asymmetric-deps bug
            if not src_pc.instance_exists(key, self.constants, self._exists_memo):
                if f.mode & AccessMode.OUT:
                    return self._new_tile(pc, f, task.locals)
                return None
            raise RuntimeError(
                f"{task!r}: producer {target.class_name}{key} left no repo "
                f"entry for flow {target.flow_name!r} (asymmetric deps?)")
        src_flow = next(sf for sf in src_pc.flows if sf.name == target.flow_name)
        data = entry.copies[src_flow.index]
        if data is None:
            raise RuntimeError(
                f"{task!r}: producer {target.class_name}{key} deposited no "
                f"data for flow {target.flow_name!r}")
        return data

    def new_tile_spec(self, pc_name: str, flow_name: str) -> Tuple[Tuple, Any]:
        """(shape, dtype) for a flow's ``<- NEW`` tile: a ``[shape=…]`` /
        ``[dtype=…]`` / ``[type=NAME]`` property block on the NEW dep wins
        (NAME resolves through the taskpool constants, so shapes may
        depend on problem parameters; :meth:`ReshapeSpec.from_props`);
        otherwise the taskpool-wide ``TILE_SHAPE``/``TILE_DTYPE``
        constants."""
        shape = self.constants.get("TILE_SHAPE", (1,))
        dtype = self.constants.get("TILE_DTYPE", np.float64)
        pc = self.ptg.classes.get(pc_name)
        for f in (pc.flows if pc is not None else ()):
            if f.name != flow_name:
                continue
            for dep in f.deps_in:
                # NEW may sit in either branch of a guarded dep
                if dep.props and (isinstance(dep.then, _NewRef)
                                  or isinstance(dep.otherwise, _NewRef)):
                    rspec = ReshapeSpec.from_props(dep.props, self.constants)
                    if rspec is not None:
                        shape = rspec.shape or shape
                        dtype = rspec.dtype or dtype
            break
        return tuple(shape), dtype

    def _new_tile(self, pc: PTGTaskClass, f: _PTGFlow, locals_: Tuple) -> Data:
        key = (pc.name, tuple(locals_), f.name)
        with self._new_lock:
            d = self._new_tiles.get(key)
            if d is None:
                shape, dtype = self.new_tile_spec(pc.name, f.name)
                d = data_create(key, payload=np.zeros(shape, dtype))
                self._new_tiles[key] = d
            return d

    # -- completion / successor release ----------------------------------
    def _make_release_deps(self, pc: PTGTaskClass):
        def release_deps(es, task: Task) -> List[Task]:
            flow_data: List[Optional[Data]] = [None] * len(pc.flows)
            if task.body_args is not None:
                for f in pc.flows:
                    if f.mode != CTL:
                        flow_data[f.index] = task.body_args[f.index][1]
            return self._release_deps_core(pc, task.locals, flow_data,
                                           task.priority)

        return release_deps

    def _release_deps_core(self, pc: PTGTaskClass, locals_: Tuple,
                           flow_data: List[Optional[Data]],
                           priority: int = 0,
                           origin_region=None) -> List[Task]:
        """Successor release for one (possibly fused) completed task:
        write-backs, repo deposits, remote activations and
        dependency-counter decrements.
        ``flow_data[f.index]`` is the Data behind each non-CTL flow.
        ``origin_region`` (a member-tid set) is the supertask's release:
        successors inside the producer's own region ran inside the fused
        body, never consume the repo and are not released (a decrement
        would schedule the region twice)."""
        env = pc.env_of(locals_, self.constants)
        repo = self.repos[pc.name]
        fusion = self._fusion
        entry = None
        nb_consumers = 0
        myrank = self.context.rank if self.context else 0
        succ_list: List[Tuple[PTGTaskClass, Tuple]] = []
        # per-destination-rank output masks + one payload per flow: ONE
        # aggregated activation per rank, however many successors live
        # there (reference parsec_remote_deps_t, remote_dep.h:132)
        rank_masks: Dict[int, int] = {}
        flow_payloads: Dict[int, Any] = {}
        for f in pc.flows:
            data = None
            if f.mode != CTL:
                data = flow_data[f.index]
            for dep in f.deps_out:
                t = dep.target(env)
                if t is None or isinstance(t, (_NoneRef, _NewRef)):
                    continue
                if isinstance(t, _DataRef):
                    if f.mode != CTL:
                        # CTL flows carry no data: never written back, and
                        # _count_expected_writebacks skips them too (count
                        # and send must agree or the owner never quiesces)
                        self._write_back(t, env, data)
                    continue
                succ_pc = self.ptg.classes[t.class_name]
                for locs in _expand_args(t.args, env):
                    if len(locs) != len(succ_pc.param_names):
                        continue
                    if not succ_pc.valid(locs, self.constants):
                        continue
                    if origin_region is not None \
                            and (t.class_name, locs) in origin_region:
                        continue  # intra-region edge: ran in the fused body
                    rank = succ_pc.rank_of(locs, self.constants)
                    if rank != myrank:
                        rank_masks[rank] = rank_masks.get(rank, 0) | (1 << f.index)
                        if (f.mode != CTL and data is not None
                                and f.index not in flow_payloads):
                            src = data.newest_copy()
                            if src is not None:
                                # the raw payload (a CUDA tensor stays
                                # one: the fabric clones it on the card)
                                flow_payloads[f.index] = src.payload
                        continue
                    if f.mode != CTL:
                        if entry is None:
                            entry = repo.lookup_and_create(locals_)
                        entry.copies[f.index] = data
                        nb_consumers += 1
                    succ_list.append((succ_pc, locs))
        if entry is not None:
            repo.set_usage_limit(locals_, nb_consumers)
        # remote successors: one aggregated activation per rank, routed
        # down the broadcast topology (reference
        # parsec_remote_dep_activate + propagate, SURVEY.md §3.4)
        if rank_masks:
            comm = self.context.comm if self.context else None
            if comm is None:
                raise RuntimeError(
                    f"task {pc.name}{locals_} has remote successors on "
                    f"ranks {sorted(rank_masks)} but the context has no "
                    "comm engine")
            if not getattr(comm, "device_payloads", False):
                # serializing transport: overlap the D2H copies of every
                # device-resident flow, then convert once each
                from ..comm.payload import prefetch_to_host, to_wire

                prefetch_to_host(flow_payloads.values())
                flow_payloads = {k: to_wire(v)
                                 for k, v in flow_payloads.items()}
            comm.remote_dep.send_activations(
                self, pc.name, locals_, rank_masks, flow_payloads,
                priority=priority)
        ready: List[Task] = []
        for succ_pc, locs in succ_list:
            if fusion is not None:
                ext = fusion.ext_goal(succ_pc.name, locs)
                if ext is not None:
                    # fused member: its counter runs with the EXTERNAL goal
                    # (intra-region producers never fire) and readiness
                    # feeds the region.  An ext-goal-0 member needs the
                    # exactly-once claim of a goal-0 successor: a duplicate
                    # region event would dispatch the supertask early
                    became, _ = self.deps.release_counter((succ_pc.name, locs), ext)
                    if became and (ext != 0 or self._claim_source(succ_pc.name, locs)):
                        _, supertask = fusion.route_ready(succ_pc.name, locs)
                        if supertask is not None:
                            ready.append(supertask)
                    continue
            goal = succ_pc.goal_of(locs, self.constants, self._exists_memo)
            became, _ = self.deps.release_counter((succ_pc.name, locs), goal)
            if became and (goal != 0
                           or self._claim_source(succ_pc.name, locs)):
                # goal-0 successors (dynamic guards) race the chunked
                # startup scan: the claim keeps execution exactly-once
                ready.append(self._make_task(succ_pc, locs))
        return ready

    def _write_back(self, t: _DataRef, env, data: Optional[Data]) -> None:
        """Final value of a flow into its home tile's host copy — unless
        the flow IS its home tile (the usual case: its device copy stays
        resident and dirty until eviction or detach writes it home).  A
        home tile on another rank gets the value through a write-back
        its owner pre-counted."""
        dc = self.constants[t.collection_name]
        key = t.key(env)
        if self.context is not None and self.context.nranks > 1:
            owner = dc.rank_of(*key)
            if owner != self.context.rank:
                # a flow that resolved to no data still sends a
                # payload-less retire so the owner's count drains
                src = data.newest_copy() if data is not None else None
                self.context.comm.remote_dep.send_writeback(
                    self, t.collection_name, key,
                    src.payload if src is not None else None, owner)
                return
        if data is None:
            return
        home = dc.data_of(*key)
        if home is data:
            return  # flow aliases its home tile
        src = data.newest_copy()
        if src is None:
            return
        dst = home.get_copy(0)
        buf = host_array(src.payload)
        if dst is None or dst.payload is None:
            home.attach_copy(0, buf)
        else:
            np.copyto(dst.payload, buf)
        home.version_bump(0)


    def incoming_writeback(self, cname: str, key: Tuple, payload) -> None:
        """Receiver half of the cross-rank final write-back: store the
        arrived value into the home tile and retire one expected-arrival
        runtime action (armed in :meth:`attached`).  ``payload=None`` is a
        pure retire: the producer's flow resolved to no data, but the
        arrival was pre-counted so it must still drain the counter."""
        if payload is not None:
            land_into_home(self.constants[cname].data_of(*key), payload)
        self.tdm.taskpool_addto_runtime_actions(self, -1)

    def _count_expected_writebacks(self, rank: int) -> int:
        """How many remote tasks write their final flow value into a tile
        ``rank`` owns — each is one pre-counted termdet runtime action."""
        n = 0
        for pc in self.ptg.classes.values():
            # static pre-filter: only deps that CAN resolve to a data
            # reference matter here
            wb_deps = [
                (f, dep)
                for f in pc.flows if f.mode != CTL
                for dep in f.deps_out
                if isinstance(dep.then, _DataRef)
                or isinstance(getattr(dep, "otherwise", None), _DataRef)
            ]
            if not wb_deps:
                continue
            for loc in pc.param_space(self.constants):
                if pc.rank_of(loc, self.constants) == rank:
                    continue  # local task: local write-back
                env = pc.env_of(loc, self.constants)
                for _f, dep in wb_deps:
                    t = dep.target(env)
                    if isinstance(t, _DataRef):
                        dc = self.constants[t.collection_name]
                        if dc.rank_of(*t.key(env)) == rank:
                            n += 1
        return n

    def incoming_activation(self, *, src_class: str, src_locals: Tuple,
                            mask: int, flow_data: Dict[int, Any]) -> None:
        """Receiver half of the aggregated activation protocol (reference
        ``remote_dep_release_incoming``): re-derive which of MY tasks the
        masked output flows of ``(src_class, src_locals)`` release — the
        receiver runs iterate_successors itself, so successor lists never
        travel the wire — deposit the arrived flow payloads in the
        producer-class repo (usage-limited to the local consumer count,
        like the local release path), and decrement dependency counters.
        Like the reference, dynamic guards reading body-mutated state must
        be rank-local or producer and consumer can disagree."""
        pc = self.ptg.classes[src_class]
        env = pc.env_of(src_locals, self.constants)
        myrank = self.context.rank if self.context else 0
        repo = self.repos[src_class]
        entry = None
        nb_consumers = 0
        ready: List[Task] = []
        for f in pc.flows:
            if not (mask >> f.index) & 1:
                continue
            payload = flow_data.get(f.index)
            deposited = False
            for dep in f.deps_out:
                t = dep.target(env)
                if t is None or isinstance(t, (_NoneRef, _NewRef, _DataRef)):
                    continue  # write-backs are the producer's business
                succ_pc = self.ptg.classes[t.class_name]
                for locs in _expand_args(t.args, env):
                    if len(locs) != len(succ_pc.param_names):
                        continue
                    if not succ_pc.valid(locs, self.constants):
                        continue
                    if succ_pc.rank_of(locs, self.constants) != myrank:
                        continue
                    if f.mode != CTL and payload is not None:
                        if not deposited:
                            if entry is None:
                                entry = repo.lookup_and_create(src_locals)
                            if entry.copies[f.index] is None:
                                entry.copies[f.index] = self._deposit_payload(
                                    (src_class, src_locals, f.index), payload)
                            deposited = True
                        nb_consumers += 1
                    if self._fusion is not None:
                        ext = self._fusion.ext_goal(t.class_name, locs)
                        if ext is not None:
                            # remote producers are always external to a
                            # (rank-local) fused region
                            became, _ = self.deps.release_counter(
                                (t.class_name, locs), ext)
                            if became and (ext != 0 or self._claim_source(
                                    t.class_name, locs)):
                                _, supertask = self._fusion.route_ready(
                                    t.class_name, locs)
                                if supertask is not None:
                                    ready.append(supertask)
                            continue
                    goal = succ_pc.goal_of(locs, self.constants, self._exists_memo)
                    became, _ = self.deps.release_counter(
                        (t.class_name, locs), goal)
                    if became and (goal != 0
                                   or self._claim_source(t.class_name, locs)):
                        ready.append(self._make_task(succ_pc, locs))
        if entry is not None:
            repo.set_usage_limit(src_locals, nb_consumers)
        if ready and self.context is not None:
            self.context.schedule(ready, es=self.context.current_es())

    def _deposit_payload(self, key, payload) -> Data:
        """Land an arrived flow payload as the host-slot copy of a fresh
        Data, AS-IS.  A CUDA tensor (the fabric's clone on the card) stays
        one: a device consumer's stage-in copies it device-to-device
        (``bytes_d2d``, behind the clone's ready event) INSIDE the device
        module, where residency accounting lives; a CPU consumer's
        :func:`stage_to_cpu` turns it into a host array lazily.  Landing
        it eagerly here would bounce it through the host from the comm
        thread and bypass the budget."""
        return data_create(key, payload=payload)


# ---------------------------------------------------------------------------
# body hooks
# ---------------------------------------------------------------------------

def stage_to_cpu(data: Data) -> np.ndarray:
    """Materialize the newest version of ``data`` as its CPU copy and
    return that ndarray (CPU bodies mutate it in place).  A device copy is
    copied device->host into a private writable array
    (:func:`~parsec_tpu_torch.data.data.host_array`) — the reference's
    ``np.asarray`` would fail on a CUDA tensor and alias a torch CPU one."""
    newest = data.newest_copy()
    if newest is None:
        raise RuntimeError(f"{data!r} has no valid copy")
    if newest.device_index == 0 and isinstance(newest.payload, np.ndarray):
        return newest.payload
    host = host_array(newest.payload)
    if newest.device_index == 0:
        newest.payload = host
        return host
    c = data.attach_copy(0, host)
    c.version = newest.version
    return host


def _accel_hook(es, task):
    return task.selected_device.kernel_scheduler(es, task)


def _value_reads(fn: Callable, names: List[str]) -> Tuple[bool, ...]:
    """Which of the value ``names`` the body ``fn`` may read: a name it
    takes as a parameter, or every name when it has a ``**kwargs``
    catch-all not named ``_`` (``**_`` discards what it catches).  The
    wave signature holds the values a body reads: a captured CUDA graph
    bakes them in."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):  # builtins / C callables
        return (True,) * len(names)
    named = {p.name for p in params
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    catch_all = any(p.kind is p.VAR_KEYWORD and p.name != "_" for p in params)
    return tuple(catch_all or n in named for n in names)


def _wrap_device_body(pc: PTGTaskClass, fn: Callable):
    """The device module passes positional args (non-CTL flows, then
    params); re-map to the uniform keyword signature body(FLOW=..., k=...).
    ``_graph_key`` (the function and the names, which determine the
    wrapper) lets taskpools of one PTG share wave graphs;
    ``_value_reads`` marks the params the function reads."""
    flow_names = [f.name for f in pc.flows if f.mode != CTL]
    value_names = pc.param_names + pc.def_names + pc.body_globals
    names = flow_names + value_names

    def wrapped(*pos):
        return fn(**dict(zip(names, pos)))

    wrapped.__name__ = getattr(fn, "__name__", pc.name)
    wrapped._graph_key = (fn, tuple(names))
    wrapped._value_reads = _value_reads(fn, value_names)
    if getattr(fn, "_donate_args", None):
        # an in-place body (the segmented factorizations): the device
        # module never runs it twice for one task, and it joins no wave
        wrapped._donate_args = fn._donate_args
    if pc.stage_hooks:
        # per-flow custom staging, indexed by the data-arg position the
        # device module sees (non-CTL flow declaration order)
        data_flows = [f.name for f in pc.flows if f.mode != CTL]
        wrapped._stage_in = {
            i: si for i, name in enumerate(data_flows)
            for si, _ in (pc.stage_hooks.get(name, (None, None)),)
            if si is not None}
        wrapped._stage_out = {
            i: so for i, name in enumerate(data_flows)
            for _, so in (pc.stage_hooks.get(name, (None, None)),)
            if so is not None}
    return wrapped


def _make_cpu_hook(pc: PTGTaskClass, fn: Callable):
    # reference BODY blocks see `this_task` implicitly; here it is opt-in
    # by naming it in the body signature (CPU incarnations only)
    try:
        wants_this_task = "this_task" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables
        wants_this_task = False

    def cpu_hook(es, task: Task) -> HookReturn:
        kw: Dict[str, Any] = {}
        writable: List[Data] = []
        for f in pc.flows:
            if f.mode == CTL:
                continue
            data: Optional[Data] = task.body_args[f.index][1]
            if data is None:
                kw[f.name] = None
                continue
            arr = stage_to_cpu(data)
            data.transfer_ownership(0, f.mode & AccessMode.INOUT)
            kw[f.name] = arr
            if f.mode & AccessMode.OUT:
                writable.append(data)
        values = [s[1] for s in task.body_args if s[0] == "value"]
        kw.update(zip(pc.param_names + pc.def_names + pc.body_globals, values))
        if wants_this_task:
            kw["this_task"] = task
        result = fn(**kw)
        if isinstance(result, HookReturn):
            # a body may return a hook status (ASYNC, NEXT, AGAIN) — those
            # bypass the commit.  DONE falls THROUGH: the normal post-body
            # commit (payload rebinds + version bumps) must still run.
            if result is not HookReturn.DONE:
                return result
            result = None
        if result is not None:
            outs = result if isinstance(result, (tuple, list)) else (result,)
            if len(outs) != len(writable):
                raise ValueError(
                    f"{task!r}: body returned {len(outs)} outputs for "
                    f"{len(writable)} writable flows")
            for data, new in zip(writable, outs):
                data.get_copy(0).payload = np.asarray(new)
        for data in writable:
            data.version_bump(0)
        return HookReturn.DONE

    return cpu_hook
