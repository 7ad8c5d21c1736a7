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

There is no fallback.  A missing source, a failed g++ run or a library
that lacks a declared symbol raises ``RuntimeError`` carrying the cause
(the compiler's output included); nothing carries on through the dynamic
path.  Not ported yet: the standalone native ready queue, the legacy
ASYNC entry points ``run_async`` / ``task_done`` (A.10) and the binary
tracer (A.9).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, List, Optional

from . import abi
from .abi import BODY_FN

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SRC_DIR = abi.SRC_DIR
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libparsec_core.so"

_lib = None
_lib_lock = threading.Lock()


def build_library(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR,
                  timeout: int = 300) -> str:
    """Compile ``src_dir``'s engine sources into ``build_dir`` unless the
    library there is newer than every source; returns its path.

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
    out_path = os.path.join(build_dir, LIB_NAME)
    if os.path.exists(out_path) and os.path.getmtime(out_path) >= max(
            os.path.getmtime(p) for p in srcs):
        return out_path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
           "-o", tmp, *srcs]
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
    trampoline) or drive the pump control plane: ``sched_config`` before
    the commits, then ``pop_batch``/``done_batch`` until ``quiesced``."""

    def __init__(self):
        self._lib = load()
        self._g = self._lib.pz_graph_new()
        if not self._g:
            raise MemoryError("pz_graph_new failed")
        #: callback objects native threads may still call: a collected
        #: CFUNCTYPE object would leave them a dangling function pointer
        self._keepalive: List = []

    def add_task(self, priority: int = 0, user_tag: int = 0) -> int:
        return self._lib.pz_graph_add_task(self._g, priority, user_tag)

    def add_dep(self, pred: int, succ: int) -> bool:
        """True if the edge was recorded, False if pred already ran."""
        rc = self._lib.pz_graph_add_dep(self._g, pred, succ)
        if rc < 0:
            raise ValueError(f"bad task id in edge {pred}->{succ}")
        return rc == 1

    def commit(self, task_id: int) -> None:
        self._lib.pz_graph_task_commit(self._g, task_id)

    def seal(self) -> None:
        self._lib.pz_graph_seal(self._g)

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

    # ---- zero-interpreter lifecycle (pump mode) ----------------------
    def sched_config(self, seed: int = -1) -> None:
        """Route ready pushes and pops through the native pump scheduler's
        priority policy: pops go (priority desc, insertion seq asc);
        ``seed >= 0`` applies the schedule explorer's deterministic
        pop-order perturbation.  Must be called BEFORE tasks commit.  The
        engine's per-tenant ``wdrr`` policy waits for the serve executor
        (ROADMAP A.9)."""
        self._lib.pz_graph_sched_config(self._g, 0, 0, int(seed))

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
