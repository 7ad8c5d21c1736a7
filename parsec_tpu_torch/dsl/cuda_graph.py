"""Whole-DAG CUDA-graph capture: run an entire PTG taskpool as ONE captured
CUDA graph, replayed.

The port of :mod:`parsec_tpu.dsl.xla_lower`, whose whole-DAG XLA program
names CUDA-graph capture as its analogue.  Capture the static graph
(:mod:`.graph`), order it (:meth:`.graph.TaskGraph.topo_order`), and emit
every task's functional ``cuda`` body in that order as pure dataflow —
tensors in, fresh tensors out, keyed by producer flow.  On the card the
first call runs that plan eagerly once (the warm-up: kernel modules
loaded, library handles and workspaces made, on the capture stream) and
captures it into one ``torch.cuda.CUDAGraph`` over static input tensors;
every call replays it: no Python dispatch, no scheduler, one launch.
Unlike XLA, a replay runs the kernels the bodies launched, in capture
order: nothing is fused or reordered.  The captured graph is kept in the
program cache (:mod:`..compile_cache`) under the plan's content digest,
as the reference keys its whole-DAG program: an executor built again on
a same-shaped pool replays it instead of capturing anew.

``batch_levels=True`` runs the reference's level batches: each
dependency level's tasks of one class and one flow signature run as one
``torch.func.vmap`` of their body over the stacked member flows, and each
hand kernel in that body as one launch over the members (the kernels'
batch grid dimension, entered through their custom ops' vmap rules, see
:mod:`..ops.kernels`); library bodies (``torch.linalg``, elementwise ops)
vmap natively.  The warm-up decides which groups cannot be vmapped and
runs them per task; the capture and every replay repeat those decisions.

The dynamic runtime stays the tool for irregular DAGs, multi-pool
composition and distributed execution; :class:`GraphExecutor` is the path
for regular single-device taskpools.
"""

from __future__ import annotations

import functools
import hashlib
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import compile_cache
from ..core.lifecycle import AccessMode, DEV_CUDA
from ..profiling import jobtrace, pins
from ..utils import debug
from .graph import TaskGraph, capture as capture_dag
from .ptg import CTL, PTGTaskpool

Key = Tuple[str, Tuple]  # (collection name, tile key)


# -- the executor ---------------------------------------------------------------

class _Step:
    __slots__ = ("tid", "body", "flow_inputs", "flow_names", "writable", "params",
                 "write_backs", "drops")

    def __init__(self, tid, body, flow_inputs, flow_names, writable, params, write_backs):
        self.tid = tid
        self.body = body
        #: [(flow name, source tuple)] for non-CTL flows
        self.flow_inputs = flow_inputs
        self.flow_names = flow_names
        self.writable = writable
        self.params = params
        self.write_backs = write_backs
        #: the flow values no later step reads, dropped after this step
        self.drops: List[Tuple[Tuple, str]] = []


class _Unbatchable(Exception):
    """A group's members cannot be stacked: a param that is not a number
    differs between them, or their flows differ in shape."""


#: the beginnings of torch's messages for a body that cannot run under
#: vmap: functorch's own refusals (data-dependent control flow on a
#: stacked value, ``.item()`` of one, a random op) and an op it has no
#: batching rule for
_UNBATCHABLE = ("vmap:", "vmap(", "Batching rule not implemented")


def _unbatchable(e: BaseException) -> bool:
    """Whether ``e`` says that a group's body cannot be vmapped, the only
    failures a group falls back per task for: any other error (a kernel
    launch, an out-of-memory error, a body's own bug) propagates."""
    if isinstance(e, _Unbatchable):
        return True
    return isinstance(e, (RuntimeError, ValueError)) and str(e).startswith(_UNBATCHABLE)


def _same(a, b) -> bool:
    try:
        return type(a) is type(b) and bool(a == b)
    except (TypeError, ValueError, RuntimeError):  # arrays, tensors: not a scalar
        return False


class _Group:
    """One group of a level: ``kind`` ``"batch"`` (one vmapped body over
    ``steps``), ``"task"`` (a singleton or a donating body, per task) or
    ``"fallback"`` (a group the warm-up could not vmap, per task)."""
    __slots__ = ("steps", "kind", "stacked", "shared", "none_flows", "const", "pstack")

    def __init__(self, steps: List[_Step], kind: str):
        self.steps = steps
        self.kind = kind
        #: flows stacked along a new leading dimension, flows every member
        #: reads from one source (passed unbatched), flows that are None
        self.stacked: List[str] = []
        self.shared: List[str] = []
        self.none_flows: List[str] = []
        #: params equal across the members (Python values) and the
        #: differing ones, stacked on the device
        self.const: Dict[str, Any] = {}
        self.pstack: Dict[str, torch.Tensor] = {}


def resolve_device(device, who: str = "GraphExecutor") -> torch.device:
    """``device``, or the current CUDA device; without a GPU and without an
    explicit request, raise (the port runs on the card unless asked for
    the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: torch.cuda.is_available() is False; ask for "
                "the torch CPU device explicitly (device='cpu')")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"GraphExecutor cannot run on {device!r}")
    return dev


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()  # torch.from_numpy wants a writable array
    return torch.from_numpy(x)


class _CapturedDAG(compile_cache.Program):
    """One whole-DAG program in the cache: the graph, the static tensors it
    reads and writes, the kernel launches a replay makes, the card bytes
    its private pool took, and what the capturing executor decided and
    holds that the graph reads by address — the level plan's groups (the
    differing params were made on the device at the warm-up) and the plan
    itself (bodies whose closures may hold device tensors)."""

    def __init__(self, graph, static_in, static_out, launches, pool_bytes, owner):
        super().__init__(pool_bytes + sum(int(t.nbytes) for t in static_in))
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.groups = owner._groups
        self.batch_fallbacks = owner.batch_fallbacks
        self.stack_bytes = owner.stack_bytes
        self.plan = owner._plan


class GraphExecutor:
    """Run a PTG taskpool's whole DAG as one captured CUDA graph.

    ``ex = GraphExecutor(tp)`` then ``outs = ex()`` (pulls the input tiles
    from the taskpool's collections and attaches the results to them) or
    ``outs = ex.apply(feeds)`` for explicit feeds
    (``feeds[(collection name, key)]`` = tensor or array).

    ``device`` defaults to the current CUDA device; the torch CPU device
    runs only when asked for (``device="cpu"``), and without a GPU and
    without that request the constructor raises.  ``capture=True`` (the
    reference's ``jit``): on the card the first call warms up, captures
    and replays, every later call replays; a capture that fails raises,
    nothing runs eagerly in its place.  On the CPU, or with
    ``capture=False``, the plan runs eagerly every call.  ``donate`` is
    kept for the reference's signature: the static inputs are the
    executor's own copies already, so there is nothing to donate and it
    changes nothing.

    The capture goes through the process's program cache
    (:func:`..compile_cache.default_cache`), keyed by
    :attr:`program_digest`, ``batch_levels``, the inputs' shapes and
    dtypes and the card: an executor built later on a same-shaped pool
    (the same bodies, params and dataflow) warms up and replays the cached
    graph instead of capturing its own (``cache_hit``).  Live executors
    sharing a graph take turns: a call holds the program's lock.

    Either way, ``apply`` never writes through to a caller's tensor (the
    feeds are copied into the executor's inputs, one ``_foreach_copy_``)
    and returns fresh tensors that a later call does not overwrite.
    Each flow value is dropped after its last consumer (computed from the
    plan), so the graph's pool holds the live tiles, not every
    intermediate.  ``ops.kernels``' launch counters see every replay
    (:func:`parsec_tpu_torch.device.cuda.capture_graph`).

    ``batch_levels=True`` runs the plan level by level (the reference's
    ``_level_plan``: longest path from a source), each level's tasks of
    one class and one flow signature as one vmapped body: flows the
    members read from one source pass unbatched, the others are stacked
    (a copy, unless they are an earlier group's outputs in order), params
    equal across the group pass as Python values and differing ones as
    tensors made on the device at the first run.  Singletons and bodies
    marked ``_donate_args`` run per task.  The first run (the warm-up on
    the card) decides which groups cannot be vmapped (``batch_fallbacks``
    counts them) and runs them per task; later runs repeat its decisions.
    A value is dropped after the level of its last reader, and a member's
    slice keeps its whole stack alive until every member is dropped (the
    graph pool holds it).  ``group_counts()`` and ``stack_bytes`` (bytes
    copied into stacks a call) describe the batching.
    """

    def __init__(self, tp: PTGTaskpool, *, device=None, donate: bool = True,
                 capture: bool = True, batch_levels: bool = False):
        self.device = resolve_device(device)
        self.taskpool = tp
        self.donate = donate
        self.graph: TaskGraph = capture_dag(tp)
        order = self.graph.topo_order()

        plan: List[_Step] = []
        homes_in: List[Key] = []
        homes_out: List[Key] = []
        seen_in, seen_out = set(), set()
        for tid in order:
            pc = tp.ptg.classes[tid[0]]
            node = self.graph.nodes[tid]
            body = pc.bodies.get(DEV_CUDA)
            if body is None:
                raise ValueError(
                    f"class {tid[0]} has no functional ({DEV_CUDA!r}) body; "
                    "whole-DAG capture needs functional incarnations")
            flow_inputs, flow_names, writable = [], [], []
            for f in pc.flows:
                if f.mode == CTL:
                    continue
                src = node.flow_sources.get(f.name)
                flow_inputs.append((f.name, src))
                flow_names.append(f.name)
                if f.mode & AccessMode.OUT:
                    writable.append(f.name)
                if src is not None and src[0] == "data":
                    hk = (src[1], tuple(src[2]))
                    if hk not in seen_in:
                        seen_in.add(hk)
                        homes_in.append(hk)
            penv = pc.env_of(tid[1], tp.constants)
            params = {n: penv[n] for n in pc.param_names + pc.def_names + pc.body_globals}
            wbs = [(fn_, cn, tuple(k)) for (fn_, cn, k) in node.write_backs]
            for (_fn, cn, k) in wbs:
                if (cn, k) not in seen_out:
                    seen_out.add((cn, k))
                    homes_out.append((cn, k))
            plan.append(_Step(tid, body, flow_inputs, flow_names, writable, params, wbs))

        # liveness: each flow value lives until its last reader — a
        # consumer's input, or its own step's write-back
        last: Dict[Tuple[Tuple, str], int] = {}
        for i, step in enumerate(plan):
            for fname in step.flow_names:
                last[(step.tid, fname)] = i
            for _fname, src in step.flow_inputs:
                if src is not None and src[0] == "task":
                    last[(src[1], src[2])] = i
        for vkey, i in last.items():
            plan[i].drops.append(vkey)

        self.input_keys: List[Key] = homes_in
        self.output_keys: List[Key] = homes_out
        self._plan = plan
        self._tp = tp

        # dependency level per task (longest path from a source): the
        # reference's level plan; steps in one level are mutually
        # independent, so same-class groups can run as one vmapped body
        self.batch_levels = batch_levels
        self._level_plan: Optional[List[List[_Step]]] = None
        #: per level, its groups: decided by the first run, repeated after
        self._groups: Optional[List[List[_Group]]] = None
        #: groups the first run could not vmap and ran per task
        self.batch_fallbacks = 0
        #: bytes the last run copied into member stacks
        self.stack_bytes = 0
        if batch_levels:
            step_of = {st.tid: st for st in plan}
            level: Dict[Tuple, int] = {tid: 0 for tid in order}
            for tid in order:
                for (_f, succ, _sf) in self.graph.nodes[tid].out_edges:
                    level[succ] = max(level[succ], level[tid] + 1)
            buckets: List[List[_Step]] = [[] for _ in range(1 + max(level.values(), default=0))]
            for tid in order:
                buckets[level[tid]].append(step_of[tid])
            self._level_plan = buckets
            # liveness by level: a value is dropped after the level of its
            # last reader (the groups of a level run in any order)
            last_level: Dict[Tuple[Tuple, str], int] = {}
            for li, steps in enumerate(buckets):
                for step in steps:
                    for fname in step.flow_names:
                        last_level[(step.tid, fname)] = li
                    for _fname, src in step.flow_inputs:
                        if src is not None and src[0] == "task":
                            last_level[(src[1], src[2])] = li
            self._level_drops: List[List[Tuple[Tuple, str]]] = [[] for _ in buckets]
            for vkey, li in last_level.items():
                self._level_drops[li].append(vkey)
        self.capture = capture and self.device.type == "cuda"
        #: the program cache this executor's capture goes through
        self.cache = compile_cache.default_cache()
        #: the captured program (the cache's entry) once the first call ran
        self._prog: Optional[_CapturedDAG] = None
        #: whether that program came from the cache (another executor's)
        self.cache_hit = False
        #: kernel launches one replay makes, per (wrapper, mode)
        self.launches: Dict[Tuple[str, str], int] = {}
        #: seconds of the first call's warm-up + capture (a cache hit: the
        #: lookup), and the bytes the card reserved while capturing (the
        #: graph's private pool)
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        self.replays = 0

    # ------------------------------------------------------------------
    def _flows(self, step: _Step, env, vals, names=None) -> Dict[str, Any]:
        """``step``'s flow values (those in ``names`` where given): inputs,
        producers' outputs, NEW tiles."""
        kw: Dict[str, Any] = {}
        for fname, src in step.flow_inputs:
            if names is not None and fname not in names:
                continue
            if src is None:
                v = None
            elif src[0] == "data":
                v = env[(src[1], tuple(src[2]))]
            elif src[0] == "new":
                shape, dtype = self.taskpool.new_tile_spec(step.tid[0], fname, step.tid[1])
                v = torch.zeros(shape, dtype=_torch_dtype(dtype), device=self.device)
            else:
                v = vals[(src[1], src[2])]
            kw[fname] = v
        return kw

    @staticmethod
    def _record(step: _Step, kw: Dict[str, Any], outs, env, vals) -> None:
        """Keep ``step``'s flow values (read flows pass through) and its
        write-backs."""
        for fname in step.flow_names:
            vals[(step.tid, fname)] = kw[fname]
        if outs is not None:
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            if len(outs) != len(step.writable):
                raise ValueError(
                    f"{step.tid}: body returned {len(outs)} values for "
                    f"{len(step.writable)} writable flows")
            for fname, out in zip(step.writable, outs):
                vals[(step.tid, fname)] = out
        for (fname, cn, k) in step.write_backs:
            env[(cn, k)] = vals[(step.tid, fname)]

    def _run_step(self, step: _Step, env, vals) -> None:
        kw = self._flows(step, env, vals)
        kw.update(step.params)
        self._record(step, kw, step.body(**kw), env, vals)

    def _run(self, ins: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The plan, eagerly, over ``ins`` (in ``input_keys`` order)."""
        if self.batch_levels:
            return self._run_levels(ins)
        env: Dict[Key, Any] = dict(zip(self.input_keys, ins))
        vals: Dict[Tuple[Tuple, str], Any] = {}
        for step in self._plan:
            self._run_step(step, env, vals)
            for vkey in step.drops:
                del vals[vkey]
        return tuple(env[k] for k in self.output_keys)

    # -- level batching ------------------------------------------------------
    def _run_levels(self, ins: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The level plan over ``ins``: each level's groups, batched or per
        task.  The first run buckets each level and decides which groups
        cannot be vmapped; later runs (the capture) repeat its decisions
        and retry nothing."""
        env: Dict[Key, Any] = dict(zip(self.input_keys, ins))
        vals: Dict[Tuple[Tuple, str], Any] = {}
        decide = self._groups is None
        if decide:
            self._groups = []
        #: id(member output) -> (weak member, weak stack, index): a later
        #: group whose members are one earlier stack, in order, reuses it
        origin: Dict[int, Tuple[Any, Any, int]] = {}
        self.stack_bytes = 0
        for li, steps in enumerate(self._level_plan):
            if decide:
                self._groups.append(self._bucket(steps, env, vals))
            for group in self._groups[li]:
                if group.kind != "batch":
                    for step in group.steps:
                        self._run_step(step, env, vals)
                    continue
                try:
                    self._run_group(group, env, vals, origin)
                except (_Unbatchable, RuntimeError, ValueError) as e:
                    if not (decide and _unbatchable(e)):
                        raise
                    group.kind = "fallback"
                    self.batch_fallbacks += 1
                    debug.verbose(2, "cuda_graph",
                                  "batch_levels: group of %d %s tasks fell back to "
                                  "per-task dispatch (%s: %s)", len(group.steps),
                                  group.steps[0].tid[0], type(e).__name__, e)
                    for step in group.steps:
                        self._run_step(step, env, vals)
            for vkey in self._level_drops[li]:
                del vals[vkey]
        return tuple(env[k] for k in self.output_keys)

    def _bucket(self, steps: List[_Step], env, vals) -> List[_Group]:
        """One level's groups, the reference's bucketing: by class and each
        flow's (shape, dtype) or None.  A singleton, and a body that
        donates its inputs (``_donate_args``), runs per task."""
        buckets: Dict[Tuple, List[_Step]] = {}
        for step in steps:
            if getattr(step.body, "_donate_args", None):
                buckets[("donate", step.tid)] = [step]
                continue
            kw = self._flows(step, env, vals)
            sig = (step.tid[0], tuple(
                (f, None if kw[f] is None else (tuple(kw[f].shape), kw[f].dtype))
                for f in step.flow_names))
            buckets.setdefault(sig, []).append(step)
        groups = []
        for members in buckets.values():
            if len(members) == 1:
                groups.append(_Group(members, "task"))
                continue
            group = _Group(members, "batch")
            try:
                self._plan_group(group)
            except _Unbatchable as e:
                group.kind = "fallback"
                self.batch_fallbacks += 1
                debug.verbose(2, "cuda_graph", "batch_levels: group of %d %s tasks runs "
                              "per task (%s)", len(members), members[0].tid[0], e)
            groups.append(group)
        return groups

    def _plan_group(self, group: _Group) -> None:
        """Which flows a group stacks, shares or leaves None, and its
        params: equal ones as Python values, differing numbers stacked
        on the device now (a host-to-device copy cannot be captured)."""
        step0 = group.steps[0]
        for i, fname in enumerate(step0.flow_names):
            srcs = [st.flow_inputs[i][1] for st in group.steps]
            if srcs[0] is None:
                group.none_flows.append(fname)
            elif all(src == srcs[0] for src in srcs[1:]):
                group.shared.append(fname)  # one producer or input tile: one tensor
            else:
                group.stacked.append(fname)
        for pname in step0.params:
            vs = [st.params[pname] for st in group.steps]
            if all(_same(v, vs[0]) for v in vs[1:]):
                group.const[pname] = vs[0]
            elif all(isinstance(v, (bool, int, float, np.bool_, np.number)) for v in vs):
                # numpy's promotion: bool, int64 or float64, as Python's
                group.pstack[pname] = torch.as_tensor(np.asarray(vs)).to(self.device)
            else:
                raise _Unbatchable(f"param {pname!r} differs and is not a number")
        if not group.stacked and not group.pstack:
            # members that differ in nothing vmap over their stacked flows
            group.stacked, group.shared = group.shared, []
            if not group.stacked:
                group.kind = "task"

    def _stack(self, tensors: List[torch.Tensor], origin) -> torch.Tensor:
        """The members' values stacked: an earlier group's output stack as
        it is where the values are its members in order, else a copy."""
        hit = origin.get(id(tensors[0]))
        base = hit[1]() if hit is not None else None
        if base is not None and base.shape[0] == len(tensors) and all(
                (h := origin.get(id(t))) is not None and h[0]() is t and h[1]() is base
                and h[2] == i for i, t in enumerate(tensors)):
            return base
        shape, dtype = tensors[0].shape, tensors[0].dtype
        if any(t.shape != shape or t.dtype != dtype for t in tensors[1:]):
            raise _Unbatchable(f"ragged stack of {[tuple(t.shape) for t in tensors]}")
        self.stack_bytes += sum(t.nbytes for t in tensors)
        return torch.stack(tensors)

    def _run_group(self, group: _Group, env, vals, origin) -> None:
        """One batched group: stack the member flows, vmap the body once,
        give each member its slice of every output."""
        kws = [self._flows(st, env, vals, group.stacked) for st in group.steps]
        flows = {f: self._stack([kw[f] for kw in kws], origin) for f in group.stacked}
        # one value for all: resolved once (a shared NEW tile is made once)
        shared = self._flows(group.steps[0], env, vals, group.shared + group.none_flows)
        for kw in kws:
            kw.update(shared)
        body = group.steps[0].body

        def grouped(stacked, params):
            kw = dict(stacked)
            kw.update(shared)
            kw.update(group.const)
            kw.update(params)
            outs = body(**kw)
            if outs is None:
                return ()
            return tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)

        outs = torch.func.vmap(grouped)(flows, group.pstack)
        members = [o.unbind(0) for o in outs]
        for o, views in zip(outs, members):
            ref = weakref.ref(o)
            for i, view in enumerate(views):
                origin[id(view)] = (weakref.ref(view), ref, i)
        for i, (step, kw) in enumerate(zip(group.steps, kws)):
            self._record(step, kw, tuple(views[i] for views in members) if outs else None,
                         env, vals)

    def group_counts(self) -> Dict[str, Dict[str, int]]:
        """Per class: ``batched`` groups (one vmapped body each) and their
        ``members``, and ``per_task`` tasks (singletons, donating bodies and
        fallen-back groups' members), as the first run decided them."""
        if self._groups is None:
            raise RuntimeError("group_counts: the executor has not run yet")
        out: Dict[str, Dict[str, int]] = {}
        for groups in self._groups:
            for g in groups:
                row = out.setdefault(g.steps[0].tid[0],
                                     {"batched": 0, "members": 0, "per_task": 0})
                if g.kind == "batch":
                    row["batched"] += 1
                    row["members"] += len(g.steps)
                else:
                    row["per_task"] += len(g.steps)
        return out

    @functools.cached_property
    def program_digest(self) -> str:
        """Content digest of the plan: every step's body fingerprint,
        params (a tensor or array by its content), dataflow sources and
        write-backs, the NEW-tile specs, the executor's input/output key
        order and ``batch_levels``.  The program cache's key
        (:meth:`_build`); computed on first read."""
        tp = self._tp
        h = hashlib.sha256()
        for step in self._plan:
            h.update(repr((step.tid, compile_cache.body_fingerprint(step.body),
                           sorted((k, compile_cache.value_fingerprint(v))
                                  for k, v in step.params.items()),
                           step.flow_inputs, step.writable, step.write_backs)).encode())
            for fname, src in step.flow_inputs:
                if src is not None and src[0] == "new":
                    h.update(repr(("new", fname, tp.new_tile_spec(step.tid[0], fname,
                                                                  step.tid[1]))).encode())
        h.update(repr(("io", self.input_keys, self.output_keys)).encode())
        h.update(repr(("batch_levels", self.batch_levels)).encode())
        return h.hexdigest()[:32]

    def _fingerprint(self, ins: List[torch.Tensor]) -> str:
        return compile_cache.fingerprint(
            ("graph", self.program_digest, self.batch_levels), compile_cache.argsig(ins),
            backend=compile_cache._platform(self.device))

    def _warm_up(self, ins: List[torch.Tensor], stream) -> List[torch.Tensor]:
        """The plan run once eagerly on ``stream`` over a copy of ``ins``
        (kernel modules loaded, library handles and workspaces made; the
        level plan's group decisions taken where none are given), its
        outputs dropped.  Returns the copy."""
        own = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in ins]
        torch._foreach_copy_(own, ins)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._run(own)
        torch.cuda.synchronize(self.device)
        return own

    def _build(self, ins: List[torch.Tensor]) -> None:
        """The first call on the card: the program cache's entry for this
        plan and these input shapes, or a new one — the warm-up, then the
        capture over static inputs, on a stream of their own.  A hit warms
        up and captures nothing: it replays the entry's graph, over the
        entry's static tensors, and takes the entry's launches, pool bytes
        and level-batching decisions (its groups, with their device-made
        params, which the graph reads).  ``capture_s``: the warm-up and
        the capture, or on a hit the lookup."""
        from ..device.cuda import capture_graph

        t0 = time.perf_counter()
        fp = self._fingerprint(ins)
        prog = self.cache.get(fp)
        stream = torch.cuda.Stream(self.device)
        hit = prog is not None
        if hit:
            self.capture_s = time.perf_counter() - t0
            # the entry's level decisions (equal digests: equal plans), so
            # the warm-up repeats them and decides nothing
            self._groups = prog.groups
            self._warm_up(ins, stream)
        else:
            # a miss is a compile: one COMPILE_BEGIN/END span around the
            # warm-up and the capture (the reference's payload keys; a hit
            # fires nothing), so a trace's critical path shows the capture
            span = pins.active(pins.COMPILE_BEGIN) or pins.active(pins.COMPILE_END)
            payload = {"rank": getattr(getattr(self.taskpool, "context", None), "rank", 0),
                       "fp": fp, "key": f"graph:{self.program_digest}",
                       "trace": jobtrace.current(), "job": pins.current_job()}
            if span:
                pins.fire(pins.COMPILE_BEGIN, None, dict(payload))
            try:
                static_in = self._warm_up(ins, stream)
                reserved = torch.cuda.memory_reserved(self.device)
                graph, static_out, launches = capture_graph(lambda: self._run(static_in), stream)
                pool = torch.cuda.memory_reserved(self.device) - reserved
                prog = _CapturedDAG(graph, static_in, static_out, launches, pool, self)
                self.cache.put(fp, prog)
            finally:
                self.capture_s = time.perf_counter() - t0
                if span:
                    pins.fire(pins.COMPILE_END, None,
                              dict(payload, kind="miss", seconds=self.capture_s))
        prog.hold(self)
        self._prog = prog
        self.launches = prog.launches
        self.graph_pool_bytes = prog.pool_bytes
        self.batch_fallbacks = prog.batch_fallbacks
        self.stack_bytes = prog.stack_bytes
        self.cache_hit = hit

    def apply(self, feeds: Dict[Key, Any]) -> Dict[Key, torch.Tensor]:
        """Run on explicit feeds: ``feeds[(collection_name, key)]`` = a
        tensor or an array.  Returns fresh tensors on the device."""
        ins = [_as_tensor(feeds[k]) for k in self.input_keys]
        if not self.capture:
            own = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in ins]
            torch._foreach_copy_(own, ins)
            return dict(zip(self.output_keys, self._run(own)))
        from ..ops import kernels

        with torch.cuda.device(self.device):
            if self._prog is None:
                self._build(ins)
            prog = self._prog
            # another live executor may replay the same graph: its static
            # tensors take one call at a time
            with prog.lock:
                torch._foreach_copy_(prog.static_in, ins)
                prog.graph.replay()
                outs = [torch.empty_like(x) for x in prog.static_out]
                torch._foreach_copy_(outs, list(prog.static_out))
        kernels.add_launches(self.launches)
        self.replays += 1
        return dict(zip(self.output_keys, outs))

    def _collection(self, name: str):
        dc = self.taskpool.constants.get(name)
        if dc is None:
            raise KeyError(f"collection {name!r} not in taskpool constants")
        return dc

    def __call__(self, *, write_back: bool = True, block: bool = False):
        """Pull the input tiles from the taskpool's collections, run, and
        (by default) attach each result to its collection tile as a
        device-resident copy, bumping its version."""
        feeds = {}
        for (cname, key) in self.input_keys:
            c = self._collection(cname).data_of(*key).newest_copy()
            if c is None:
                raise RuntimeError(f"tile {cname}{key} has no valid copy")
            feeds[(cname, key)] = c.payload
        outs = self.apply(feeds)
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if write_back:
            for (cname, key), arr in outs.items():
                d = self._collection(cname).data_of(*key)
                c = d.get_copy(0)
                if c is None:
                    d.attach_copy(0, arr)
                else:
                    c.payload = arr
                d.version_bump(0)
        return outs
