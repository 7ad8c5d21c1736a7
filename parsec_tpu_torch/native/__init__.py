"""The native C++ engine (ctypes bindings), built on first use.

The port of :mod:`parsec_tpu.native`.  The engine's sources are the
shared, framework-neutral ``native/src/{zone,graph,trace}.cpp``; this
module compiles them with g++ into ``parsec_tpu_torch/_build/`` the first
time a consumer asks for the library, and binds the result through the
port's own ABI spec (:mod:`parsec_tpu_torch.native.abi`).  It never loads
the JAX package's ``native/build/`` library.

:class:`NativeGraph` is the dependency-counting dataflow engine (atomic
counters, priority pool, native worker threads, and the batched
pop/done control plane of the pump; reference role:
``parsec/scheduling.c`` + ``mca/sched``).  :class:`ZoneAllocator` is the
offset allocator the CUDA device module accounts device bytes with
(first fit, alignment, coalescing; reference role: ``zone_malloc.c``).
:meth:`NativeGraph.order` linearises a captured DAG for whole-DAG capture
(:mod:`parsec_tpu_torch.dsl.cuda_graph`).  :class:`NativeReadyQueue` is
the ready-queue state of the ``spq`` and ``wdrr`` schedulers under
``sched_native_queue=1`` (the pump's own SchedQ, A.10e).
:class:`NativeTracer` is the binary event tracer under
:mod:`parsec_tpu_torch.profiling.binary` (one native buffer per thread,
``steady_clock`` timestamps taken in C++, ``PBTRACE1`` dumps).

There is no fallback.  A missing source, a failed g++ run or a library
that lacks a declared symbol raises ``RuntimeError`` carrying the cause
(the compiler's output included); nothing carries on through the dynamic
path.  :meth:`NativeGraph.run_async` / :meth:`NativeGraph.task_done` are
the legacy ASYNC-chore protocol (the reference's
``PARSEC_HOOK_RETURN_ASYNC``): a body hands its task to a device manager,
whose completion signals the engine from any thread.
:meth:`NativeGraph.set_vpmap` groups the workers into virtual processes
for the hierarchical steal.  :meth:`NativeGraph.events_enable` /
:meth:`NativeGraph.events_drain` buffer and drain the engine's lifecycle
events (``EVT_DEP_DEC``, ``EVT_PUBLISH``, ``EVT_RETIRE``), which the
pump republishes into PINS for the hb checker and the engine verifier
replays against its model.  :meth:`NativeGraph.sched_config` takes the
pump's policy (``prio`` or the per-tenant ``wdrr`` of the serve executor,
with :meth:`NativeGraph.set_task_tenant` and
:meth:`NativeGraph.set_tenant_weight`), and :meth:`NativeGraph.reset`
rewinds a quiesced graph for a same-shaped rerun, and
:meth:`NativeGraph.run_noop` runs a graph with a native no-op body (the
engine's dispatch ceiling, no interpreter in the loop).

:func:`build_tsan_library` compiles the same sources with
``-fsanitize=thread`` into ``_build/libparsec_core_tsan.so`` (never loaded
here: a TSan library needs the sanitizer runtime preloaded); run it with
``TSAN_OPTIONS=suppressions=<tsan_suppressions_path()>``.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
import threading
import time
from typing import Any, Callable, List, Optional

from ..profiling import pins
from . import abi
from .abi import ASYNC_BODY_FN, BODY_FN

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SRC_DIR = abi.SRC_DIR
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libparsec_core.so"
TSAN_LIB_NAME = "libparsec_core_tsan.so"

_lib = None
_lib_lock = threading.Lock()


def build_library(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR,
                  timeout: int = 300, *, lib_name: str = LIB_NAME,
                  extra_flags=()) -> str:
    """Compile ``src_dir``'s engine sources into ``build_dir`` unless the
    library there is newer than every source; returns its path.
    ``lib_name`` / ``extra_flags`` name and flag another flavor of the
    same sources (:func:`build_tsan_library`).

    Concurrent builds (test workers, several processes on one host)
    each compile into a temp file of their own and publish it with an
    atomic ``os.replace``, so a reader never maps a half-written file.
    Raises RuntimeError with the cause — missing sources, or g++'s own
    output — on failure."""
    srcs = [os.path.join(src_dir, s) for s in abi.SOURCES]
    missing = [s for s in srcs if not os.path.exists(s)]
    if missing:
        raise RuntimeError(
            f"native engine sources missing under {src_dir}: {missing}")
    out_path = os.path.join(build_dir, lib_name)
    if os.path.exists(out_path) and os.path.getmtime(out_path) >= max(
            os.path.getmtime(p) for p in srcs):
        return out_path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
           *extra_flags, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native engine build: g++ did not run: {e}")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"native engine build: g++ failed (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out_path)
    return out_path


def build_tsan_library(timeout: int = 300) -> str:
    """Compile the ThreadSanitizer flavor of the engine (the CI smoke leg:
    the TSan build of the async engine still compiles) into
    ``_build/libparsec_core_tsan.so``, beside the default flavor and never
    over it; returns the path.  Raises RuntimeError with the compiler's
    output when the toolchain lacks ``-fsanitize=thread`` or the sources
    fail under it.  Does NOT load the library into this process."""
    return build_library(SRC_DIR, BUILD_DIR, timeout, lib_name=TSAN_LIB_NAME,
                         extra_flags=("-g", "-fsanitize=thread"))


def tsan_suppressions_path() -> str:
    """The shared suppressions file for the TSan flavor (pass as
    ``TSAN_OPTIONS=suppressions=<path>``)."""
    return os.path.join(os.path.dirname(SRC_DIR), "tsan.supp")


def load(src_dir: Optional[str] = None,
         build_dir: Optional[str] = None) -> ctypes.CDLL:
    """The bound engine library, built on first use (see
    :func:`build_library`).  Raises RuntimeError when it cannot be built
    or lacks a symbol of the ABI spec."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build_library(src_dir or SRC_DIR, build_dir or BUILD_DIR)
        lib = ctypes.CDLL(path)
        missing = [s for s in abi.required_symbols() if not hasattr(lib, s)]
        if missing:
            raise RuntimeError(
                f"native engine library {path} lacks symbol(s) "
                f"{', '.join(missing)}: delete {os.path.dirname(path)} to "
                "force a rebuild")
        abi.bind(lib)
        _lib = lib
        return lib


class ZoneAllocator:
    """Offset allocator over a byte budget (native first fit + coalesce).
    The device owns the real memory (torch's caching allocator places the
    tensors); the zone models the budget's segments, alignment and
    fragmentation, so an allocation can fail under budget and trigger
    eviction.  Raises when the library cannot be built: there is no
    fallback."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._z = self._lib.pz_zone_new(capacity)
        if not self._z:
            raise MemoryError("pz_zone_new failed")

    def alloc(self, nbytes: int, align: int = 256) -> Optional[int]:
        """A byte offset, or None when fragmented or full."""
        off = self._lib.pz_zone_alloc(self._z, nbytes, align)
        return None if off < 0 else off

    def release(self, offset: int) -> None:
        if self._lib.pz_zone_release(self._z, offset) != 0:
            raise ValueError(f"unknown offset {offset}")

    @property
    def used(self) -> int:
        return self._lib.pz_zone_used(self._z)

    @property
    def capacity(self) -> int:
        return self._lib.pz_zone_capacity(self._z)

    @property
    def largest_free(self) -> int:
        return self._lib.pz_zone_largest_free(self._z)

    @property
    def num_live(self) -> int:
        return self._lib.pz_zone_num_live(self._z)

    def close(self) -> None:
        z = getattr(self, "_z", None)
        if z:
            self._z = None
            self._lib.pz_zone_destroy(z)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeGraph:
    """A dataflow graph executed by the native engine.

    Build with ``add_task``/``add_dep``, ``commit`` every task once all
    its in-edges are declared, ``seal``, then either ``run(body)`` (native
    worker threads enter ``body(task_id, user_tag)`` through a ctypes
    trampoline), ``run_async(body)`` (the same, with bodies that may hand
    their task to a device manager, whose completion calls
    :meth:`task_done`) or drive the pump control plane: ``sched_config``
    before the commits, then ``pop_batch``/``done_batch`` until
    ``quiesced``."""

    #: stable per-graph tokens for the NATIVE_TASK_DONE site: ``id(self)``
    #: would be reused after GC and mix up sequential graphs' task ids
    _HB_TOKENS = itertools.count(1)

    def __init__(self):
        self._lib = load()
        self._g = self._lib.pz_graph_new()
        if not self._g:
            raise MemoryError("pz_graph_new failed")
        #: callback objects native threads may still call: a collected
        #: CFUNCTYPE object would leave them a dangling function pointer
        self._keepalive: List = []
        self._n = 0
        self.hb_token = next(NativeGraph._HB_TOKENS)

    def add_task(self, priority: int = 0, user_tag: int = 0) -> int:
        self._n += 1
        return self._lib.pz_graph_add_task(self._g, priority, user_tag)

    def add_dep(self, pred: int, succ: int) -> bool:
        """True if the edge was recorded, False if pred already ran."""
        rc = self._lib.pz_graph_add_dep(self._g, pred, succ)
        if rc < 0:
            raise ValueError(f"bad task id in edge {pred}->{succ}")
        return rc == 1

    def commit(self, task_id: int) -> None:
        self._lib.pz_graph_task_commit(self._g, task_id)

    def order(self) -> List[int]:
        """Priority-greedy topological order of a build-mode graph (tasks
        added, never committed): the highest priority first among the
        ready, ties in insertion order.  Raises on a cycle."""
        buf = (ctypes.c_int64 * max(self._n, 1))()
        n = self._lib.pz_graph_order(self._g, buf, self._n)
        if n < 0:
            raise RuntimeError("cycle detected (or graph already executed)")
        return list(buf[:n])

    def seal(self) -> None:
        self._lib.pz_graph_seal(self._g)

    def run_noop(self, nthreads: int = 2) -> int:
        """Dispatch-bound run with a NATIVE no-op body (no interpreter in
        the loop): the engine's pure scheduling throughput.  Returns the
        executed count; raises when the graph did not quiesce."""
        n = self._lib.pz_graph_run_noop(self._g, nthreads)
        if n < 0:
            raise RuntimeError("graph did not quiesce")
        return n

    def run(self, body: Callable[[int, int], None], nthreads: int = 2) -> int:
        """Execute until quiescence on ``nthreads`` native workers; returns
        the executed count.  An exception in ``body`` is captured and
        re-raised here once the run drained."""
        errors: List[BaseException] = []

        @BODY_FN
        def trampoline(task_id, user_tag, _ctx):
            try:
                body(task_id, user_tag)
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                errors.append(e)

        self._keepalive.append(trampoline)
        n = self._lib.pz_graph_run(self._g, trampoline, None, nthreads)
        if errors:
            raise errors[0]
        if n < 0:
            raise RuntimeError(
                "graph did not quiesce (cycle or uncommitted task)")
        return n

    def run_async(self, body: Callable[[int, int], Any],
                  nthreads: int = 2) -> int:
        """Execute with an ASYNC-capable body (the reference's
        ``PARSEC_HOOK_RETURN_ASYNC`` protocol): ``body(task_id, user_tag)``
        returns falsy when the task completed synchronously, truthy when a
        device manager took it — its completion must then be signalled
        through :meth:`task_done`, which releases the successors natively.
        Blocks until every task, the ASYNC ones included, completed.  A
        raising body fails the run (:meth:`fail`), so completions that
        will never arrive cannot hang the workers, and the error re-raises
        here."""
        errors: List[BaseException] = []

        @ASYNC_BODY_FN
        def trampoline(task_id, user_tag, _ctx):
            try:
                return 1 if body(task_id, user_tag) else 0
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                errors.append(e)
                self._lib.pz_graph_fail(self._g)
                # report ASYNC, never "done": a body may raise AFTER its
                # task already completed through task_done (a manager
                # draining inline completes tasks before it returns), and
                # a 0 here would complete it a second time and release its
                # successors twice.  The fail() above ends the run anyway.
                return 1

        self._keepalive.append(trampoline)
        n = self._lib.pz_graph_run_async(self._g, trampoline, None, nthreads)
        if errors:
            raise errors[0]
        if n < 0:
            raise RuntimeError(
                "graph did not quiesce (cycle, uncommitted task, or a "
                "failed run with ASYNC completions outstanding)")
        return n

    def task_done(self, task_id: int) -> bool:
        """Signal an ASYNC task's completion: successor release, ready
        pushes and quiescence accounting run natively (``pz_task_done``).
        Callable from any thread.  Returns False when the task had already
        completed (the engine's double-completion guard refused the
        signal) or the graph is closed (a straggler racing shutdown —
        never a NULL handle into C); raises on an unknown id."""
        g = self._g  # snapshot: close() may clear it under our feet
        if not g:
            return False
        rc = self._lib.pz_task_done(g, task_id)
        if rc == -1:
            raise ValueError(f"task_done: unknown task id {task_id}")
        if pins.active(pins.NATIVE_TASK_DONE):
            pins.fire(pins.NATIVE_TASK_DONE, None,
                      {"graph": self.hb_token, "task": int(task_id),
                       "accepted": rc == 0})
        return rc == 0

    @property
    def double_completes(self) -> int:
        """Completion signals the double-completion guard refused."""
        return self._lib.pz_graph_double_completes(self._g)

    def set_vpmap(self, vp_of_worker) -> None:
        """Assign each worker id of the NEXT run to a virtual process (a
        locality domain): the steal path tries same-VP victims first, then
        crosses domains (reference lfq hierarchy with the vpmap,
        ``sched_local_queues_utils.h:22-36``)."""
        n = len(vp_of_worker)
        arr = (ctypes.c_int32 * n)(*[int(v) for v in vp_of_worker])
        self._lib.pz_graph_set_vpmap(self._g, arr, n)

    @property
    def steals(self) -> int:
        return self._lib.pz_graph_steals(self._g)

    @property
    def steals_remote(self) -> int:
        """The cross-VP share of ``steals`` (0 without a vpmap)."""
        return self._lib.pz_graph_steals_remote(self._g)

    # ---- zero-interpreter lifecycle (pump mode) ----------------------
    #: lifecycle event kinds from :meth:`events_drain` (graph.cpp EvtKind)
    EVT_DEP_DEC, EVT_PUBLISH, EVT_RETIRE = 0, 1, 2

    SCHED_POLICIES = {"prio": 0, "wdrr": 1}

    def sched_config(self, policy: str = "prio", quantum: int = 0,
                     seed: int = -1) -> None:
        """Route ready pushes and pops through the native pump scheduler.
        ``prio`` pops (priority desc, insertion seq asc), the spq order;
        ``wdrr`` runs weighted deficit round robin over tenant bins (see
        :meth:`set_task_tenant`, :meth:`set_tenant_weight`; ``quantum`` is
        the credits a weight-1 tenant gains a visit); ``seed >= 0``
        applies the schedule explorer's deterministic pop-order
        perturbation.  Must be called BEFORE tasks commit."""
        self._lib.pz_graph_sched_config(
            self._g, self.SCHED_POLICIES[policy], int(quantum), int(seed))

    def set_task_tenant(self, task_id: int, tenant: int) -> None:
        """Put a task in a wdrr tenant bin (before its commit)."""
        self._lib.pz_graph_task_tenant(self._g, task_id, int(tenant))

    def set_tenant_weight(self, tenant: int, weight: int) -> None:
        """(Re-)tune a tenant bin's wdrr weight (at least 1)."""
        self._lib.pz_graph_tenant_weight(self._g, int(tenant), int(weight))

    POLICIES = {"lfq": 0, "gd": 1}

    def set_policy(self, policy: str) -> None:
        """Worker-run scheduling policy: ``lfq`` (per-worker bounded heaps
        and hierarchical steal, the default) or ``gd`` (one global
        priority heap)."""
        self._lib.pz_graph_set_policy(self._g, self.POLICIES[policy])

    def reset(self) -> None:
        """Rewind a QUIESCED graph for a rerun over the same structure:
        every task returns to uncommitted and the caller re-commits as
        after construction.  Raises while tasks are outstanding."""
        if self._lib.pz_graph_reset(self._g) != 0:
            raise RuntimeError("cannot reset: tasks still outstanding")

    def pop_batch(self, buf) -> int:
        """Pop up to ``len(buf)`` ready ids into ``buf`` (a preallocated
        ``ctypes.c_int64`` array); returns the count (0 = none ready)."""
        return self._lib.pz_graph_pop_batch(self._g, buf, len(buf))

    def done_batch(self, buf, n: int) -> int:
        """Retire ``buf[:n]`` in one native call: successor release,
        ready pushes and retire counting never enter the interpreter.
        Returns the number accepted (a double completion is refused)."""
        return self._lib.pz_graph_done_batch(self._g, buf, n)

    def quiesced(self) -> bool:
        return bool(self._lib.pz_graph_quiesced(self._g))

    def sched_pending(self) -> int:
        return self._lib.pz_graph_sched_pending(self._g)

    def events_enable(self, on: bool) -> None:
        """Buffer (or stop buffering) the engine's lifecycle events."""
        self._lib.pz_graph_events_enable(self._g, 1 if on else 0)

    def events_drain(self, kinds, a, b) -> int:
        """Drain buffered lifecycle events into three preallocated
        parallel ctypes arrays (c_int32 kinds, c_int64 a/b); returns the
        count.  Kinds: :data:`EVT_DEP_DEC` (a=succ id, b=ready),
        :data:`EVT_PUBLISH` (a=task id, b=priority), :data:`EVT_RETIRE`
        (a=task id, b=accepted)."""
        return self._lib.pz_graph_events_drain(self._g, kinds, a, b,
                                               len(kinds))

    def fail(self) -> None:
        """Abort a live run: workers drain their current body and exit,
        and ``run`` reports non-quiescence.  No-op on a closed graph."""
        g = self._g
        if g:
            self._lib.pz_graph_fail(g)

    @property
    def executed(self) -> int:
        return self._lib.pz_graph_executed(self._g)

    def close(self) -> None:
        """Destroy the native graph.  Callers close only after ``run`` or
        the pump returned: no native thread is left to touch it."""
        g = getattr(self, "_g", None)
        if g:
            self._g = None
            self._lib.pz_graph_destroy(g)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeReadyQueue:
    """Standalone native ready queue — the queue STATE of a Python
    scheduler, with pop ORDER decided natively (one shared implementation
    with the pump disciplines in graph.cpp, so worker-based and
    pump-based runs order identically).

    Ownership handoff: the caller keeps its task objects in a dict keyed
    by the integer ``handle`` it pushes; :meth:`pop` returns the handle
    whose task the caller then owns again.  ``policy``: ``prio`` orders
    (priority desc, distance asc, insertion seq asc) — the spq key;
    ``wdrr`` runs deficit round robin over tenant bins."""

    POLICIES = {"prio": 0, "wdrr": 1}

    def __init__(self, policy: str = "prio", quantum: int = 0,
                 seed: int = -1):
        self._lib = load()
        self._q = self._lib.pz_rq_new(self.POLICIES[policy], int(quantum),
                                      int(seed))
        if not self._q:
            raise MemoryError("pz_rq_new failed")

    def set_tenant_weight(self, tenant: int, weight: int) -> None:
        self._lib.pz_rq_tenant_weight(self._q, int(tenant), int(weight))

    def push(self, priority: int, handle: int, distance: int = 0,
             tenant: int = 0) -> None:
        self._lib.pz_rq_push(self._q, int(priority), int(distance),
                             int(tenant), int(handle))

    def pop(self) -> int:
        """Next handle under the discipline, or -1 when empty."""
        return self._lib.pz_rq_pop(self._q)

    def count(self) -> int:
        return self._lib.pz_rq_count(self._q)

    def clear(self) -> None:
        self._lib.pz_rq_clear(self._q)

    def close(self) -> None:
        q = getattr(self, "_q", None)
        if q:
            self._q = None
            self._lib.pz_rq_destroy(q)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeTracer:
    """Binary event tracer with native per-stream buffers and
    steady-clock nanosecond timestamps (reference role:
    ``parsec/profiling.c`` per-thread dbp buffers).

    A stream is claimed per thread on its first log (a
    ``threading.local`` per tracer: the CUDA module's manager, the pump,
    the stage lane and the write-back committer each log into their own);
    a dump writes a ``PBTRACE1`` file of every stream's records, readable
    by :func:`parsec_tpu_torch.profiling.binary.read_pbt`.  The streams
    belong to the native tracer, not to their threads: a thread that has
    exited keeps its records until the tracer is destroyed.  Keyword names
    live Python-side (:class:`~parsec_tpu_torch.profiling.binary.BinaryTrace`
    pairs the dump with a sidecar).  There is no fallback: an engine that
    cannot be built, a failed allocation or a failed dump raises."""

    PHASE_BEGIN, PHASE_END, PHASE_INSTANT, PHASE_COUNTER = 0, 1, 2, 3

    def __init__(self):
        self._lib = load()
        # the native t0 (steady_clock, CLOCK_MONOTONIC on Linux) is taken
        # inside pt_tracer_new: the midpoint of the monotonic clock read
        # on either side of the call places it within half the call's span
        before = time.monotonic_ns()
        self._t = self._lib.pt_tracer_new()
        #: absolute monotonic ns of the native timestamps' zero
        self.epoch_ns = (before + time.monotonic_ns()) // 2
        if not self._t:
            raise MemoryError("pt_tracer_new failed")
        self._tls = threading.local()
        self._streams_lock = threading.Lock()
        self._stream_names: List[str] = []

    def _stream(self, t):
        s = getattr(self._tls, "s", None)
        if s is None:
            s = self._lib.pt_stream_new(t)
            if not s:
                raise MemoryError("pt_stream_new failed")
            self._tls.s = s
            # the name goes at the NATIVE stream id: two threads racing
            # their first log must not cross-label each other's events
            sid = self._lib.pt_stream_id(s)
            with self._streams_lock:
                while len(self._stream_names) <= sid:
                    self._stream_names.append("")
                self._stream_names[sid] = threading.current_thread().name
        return s

    def log(self, keyword: int, phase: int, event_id: int = 0,
            info: int = 0) -> None:
        # close() only detaches the handle (the native buffers go when this
        # object is collected): a logger still subscribed while the tracer
        # closes either sees None and logs nothing, or logs into live
        # native memory
        t = self._t
        if t is None:
            return
        self._lib.pt_log(t, self._stream(t), keyword, phase, event_id, info)

    def stream_names(self) -> List[str]:
        with self._streams_lock:
            return list(self._stream_names)

    @property
    def total_events(self) -> int:
        if self._t is None:
            return 0
        return self._lib.pt_total_events(self._t)

    def dump(self, path: str) -> int:
        if self._t is None:
            raise OSError("tracer is closed")
        n = self._lib.pt_dump(self._t, path.encode())
        if n < 0:
            raise OSError(f"cannot write trace to {path}")
        return n

    def close(self) -> None:
        """Detach: later logs do nothing and a dump raises.  The native
        buffers are destroyed only when this object is collected, so a
        logger racing the close (it holds a reference through its bound
        callback) never touches freed memory."""
        t = getattr(self, "_t", None)
        if t:
            self._t = None
            self._closed_handle = t

    def __del__(self):  # pragma: no cover
        try:
            t = getattr(self, "_t", None) or getattr(self, "_closed_handle", None)
            if t:
                self._t = None
                self._closed_handle = None
                self._lib.pt_tracer_destroy(t)
        except Exception:
            pass
