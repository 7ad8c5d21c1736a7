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
order: nothing is fused or reordered.

The dynamic runtime stays the tool for irregular DAGs, multi-pool
composition and distributed execution; :class:`GraphExecutor` is the path
for regular single-device taskpools.  Not ported yet:
``batch_levels=True`` (the reference's vmapped level batches; a
ctypes-launched kernel cannot be vmapped: the kernels need a batch grid
dimension first, ROADMAP A.4c).
"""

from __future__ import annotations

import functools
import hashlib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.lifecycle import AccessMode, DEV_CUDA
from .graph import TaskGraph, capture as capture_dag
from .ptg import CTL, PTGTaskpool

Key = Tuple[str, Tuple]  # (collection name, tile key)


# -- content fingerprints (the port's copy of the reference's
# compile_cache.code_fingerprint and _scrub) ---------------------------------

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def _scrub(s: str) -> str:
    """Drop memory addresses from reprs: ``<fn at 0x7f..>`` must
    fingerprint identically across processes."""
    return _ADDR_RE.sub("0xX", s)


def _code_parts(code, out: List[str], depth: int = 0) -> None:
    if depth > 6:  # pathological nesting: stop, stay stable
        return
    out.append(code.co_name)
    out.append(hashlib.sha1(code.co_code).hexdigest())
    out.append(repr(code.co_names))
    out.append(repr(code.co_varnames[:code.co_argcount]))
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            _code_parts(const, out, depth + 1)
        else:
            out.append(_scrub(repr(const)))


def _value_part(v, out: List[str], depth: int = 0) -> None:
    """Stable description of a closure or default value."""
    if depth > 4:
        out.append(f"<deep:{type(v).__name__}>")
    elif callable(v) and hasattr(v, "__code__"):
        _callable_parts(v, out)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        a = v.detach().cpu().contiguous().numpy() if isinstance(v, torch.Tensor) \
            else np.ascontiguousarray(v)
        out.append(f"nd:{a.shape}:{a.dtype}:{hashlib.sha1(a.tobytes()).hexdigest()}")
    elif isinstance(v, (tuple, list)):
        out.append(f"{type(v).__name__}[")
        for x in v:
            _value_part(x, out, depth + 1)
        out.append("]")
    elif isinstance(v, dict):
        out.append("{")
        for k in sorted(v, key=repr):
            out.append(_scrub(repr(k)))
            _value_part(v[k], out, depth + 1)
        out.append("}")
    else:
        out.append(_scrub(repr(v)))


def _callable_parts(fn: Callable, out: List[str]) -> None:
    fn = getattr(fn, "__wrapped__", fn)
    if isinstance(fn, functools.partial):
        out.append("partial")
        _value_part(fn.args, out)
        _value_part(fn.keywords, out)
        _callable_parts(fn.func, out)
        return
    code = getattr(fn, "__code__", None)
    if code is None:
        out.append(_scrub(repr(fn)))
        return
    out.append(getattr(fn, "__qualname__", ""))
    _code_parts(code, out)
    for d in (getattr(fn, "__defaults__", None) or ()):
        _value_part(d, out)
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            _value_part(cell.cell_contents, out)
        except ValueError:  # empty cell
            out.append("<empty-cell>")


def code_fingerprint(fn: Callable) -> str:
    """Stable content hash of a callable: bytecode (through nested code
    objects), names, defaults and closure values, through
    ``functools.partial`` too.  Changing a body's code or a baked
    parameter changes it; re-importing the same source does not."""
    out: List[str] = []
    _callable_parts(fn, out)
    return hashlib.sha256("|".join(out).encode()).hexdigest()[:24]


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

    Either way, ``apply`` never writes through to a caller's tensor (the
    feeds are copied into the executor's inputs, one ``_foreach_copy_``)
    and returns fresh tensors that a later call does not overwrite.
    Each flow value is dropped after its last consumer (computed from the
    plan), so the graph's pool holds the live tiles, not every
    intermediate.  ``ops.kernels``' launch counters see every replay
    (:func:`parsec_tpu_torch.device.cuda.capture_graph`).
    """

    def __init__(self, tp: PTGTaskpool, *, device=None, donate: bool = True,
                 capture: bool = True, batch_levels: bool = False):
        if batch_levels:
            raise NotImplementedError(
                "GraphExecutor(batch_levels=True): level batching is not "
                "ported yet (ROADMAP A.4c)")
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
        self.capture = capture and self.device.type == "cuda"
        self._graph = None
        self._static_in: List[torch.Tensor] = []
        self._static_out: Tuple[torch.Tensor, ...] = ()
        #: kernel launches one replay makes, per (wrapper, mode)
        self.launches: Dict[Tuple[str, str], int] = {}
        #: seconds of the first call's warm-up + capture, and the bytes
        #: the card reserved while capturing (the graph's private pool)
        self.capture_s = 0.0
        self.graph_pool_bytes = 0
        self.replays = 0

    # ------------------------------------------------------------------
    def _run(self, ins: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The plan, eagerly, over ``ins`` (in ``input_keys`` order)."""
        tp = self.taskpool
        env: Dict[Key, Any] = dict(zip(self.input_keys, ins))
        vals: Dict[Tuple[Tuple, str], Any] = {}
        for step in self._plan:
            kw: Dict[str, Any] = {}
            for fname, src in step.flow_inputs:
                if src is None:
                    v = None
                elif src[0] == "data":
                    v = env[(src[1], tuple(src[2]))]
                elif src[0] == "new":
                    shape, dtype = tp.new_tile_spec(step.tid[0], fname)
                    v = torch.zeros(shape, dtype=_torch_dtype(dtype), device=self.device)
                else:
                    v = vals[(src[1], src[2])]
                kw[fname] = v
            for fname in step.flow_names:  # read flows pass through
                vals[(step.tid, fname)] = kw[fname]
            kw.update(step.params)
            outs = step.body(**kw)
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
            for vkey in step.drops:
                del vals[vkey]
        return tuple(env[k] for k in self.output_keys)

    @functools.cached_property
    def program_digest(self) -> str:
        """Content digest of the plan: every step's body fingerprint,
        resolved params, dataflow sources and write-backs, the NEW-tile
        specs and the executor's input/output key order.  Computed on
        first read: nothing in the port keys on it until a compile cache
        does (ROADMAP A.5)."""
        tp = self._tp
        h = hashlib.sha256()
        fps: Dict[int, str] = {}
        for step in self._plan:
            fp = fps.get(id(step.body))
            if fp is None:
                fp = fps[id(step.body)] = code_fingerprint(step.body)
            h.update(repr((step.tid, fp,
                           sorted((k, _scrub(repr(v))) for k, v in step.params.items()),
                           step.flow_inputs, step.writable, step.write_backs)).encode())
            for fname, src in step.flow_inputs:
                if src is not None and src[0] == "new":
                    h.update(repr(("new", fname, tp.new_tile_spec(step.tid[0], fname))).encode())
        h.update(repr(("io", self.input_keys, self.output_keys)).encode())
        return h.hexdigest()[:32]

    def _build(self, ins: List[torch.Tensor]) -> None:
        """The first call on the card: static inputs, the warm-up on the
        capture stream, the capture."""
        from ..device.cuda import capture_graph

        t0 = time.perf_counter()
        self._static_in = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                           for x in ins]
        torch._foreach_copy_(self._static_in, ins)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._run(self._static_in)  # the warm-up: its outputs are dropped
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        self._graph, self._static_out, self.launches = capture_graph(
            lambda: self._run(self._static_in), stream)
        self.graph_pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0

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
            if self._graph is None:
                self._build(ins)
            else:
                torch._foreach_copy_(self._static_in, ins)
            self._graph.replay()
            outs = [torch.empty_like(x) for x in self._static_out]
            torch._foreach_copy_(outs, list(self._static_out))
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
