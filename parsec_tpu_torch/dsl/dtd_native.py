"""NativeDTD: dynamic task discovery scheduled by the C++ engine.

The port of :mod:`parsec_tpu.dsl.dtd_native`.  The reference's DTD
front-end inserts tasks into a *native* runtime (``insert_function.c``
feeding ``scheduling.c``); the full-featured
:class:`~parsec_tpu_torch.dsl.dtd.DTDTaskpool` instead feeds the Python
dynamic runtime (untied bodies, WAR renaming, ATOMIC_WRITE, CUDA chores).
This module is the native-runtime counterpart for the *flat* case — single
rank, host bodies, exclusive/shared access — where dispatch overhead
dominates: insertion infers dependencies per tile (last-writer / readers,
exactly the reference's ``insert_function_internal.h:199-209`` tile
tracking) and streams tasks into the live C++ graph (the engine's
streaming mode, ``native/src/graph.cpp``: tasks execute on native workers
WHILE later tasks are still being inserted — the reference's
compute/discovery overlap).

Its bodies are host bodies by design: a native worker thread calls them
with numpy arrays, so it runs no kernel and needs no card.  Use
:class:`~parsec_tpu_torch.dsl.dtd.DTDTaskpool` when you need renaming,
untied tasks or CUDA chores; use this when you need raw task throughput
on one host.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.lifecycle import AccessMode
from ..profiling import pins
from ..utils.mca_param import params as mca_param

IN = AccessMode.IN
OUT = AccessMode.OUT
INOUT = AccessMode.INOUT
VALUE = AccessMode.VALUE
SCRATCH = AccessMode.SCRATCH
DONT_TRACK = AccessMode.DONT_TRACK
CTL_MODE = AccessMode.CTL


class _TileMap(dict):
    """Plain dict, but weakref-able (builtin dict is not)."""

    __slots__ = ("__weakref__",)


class _Tile:
    __slots__ = ("last_writer", "readers", "_wr")

    def __init__(self) -> None:
        self.last_writer: int = -1   # native task id
        self.readers: List[int] = []
        self._wr: Any = None         # weakref keeping the id()-key honest


class NativeDTD:
    """Streaming DTD pool over the native engine.

    >>> with NativeDTD(nthreads=4) as tp:
    ...     tp.insert_task(body, (a, INOUT), (b, IN), 3.5)
    ...
    (exiting the ``with`` waits for quiescence)

    Bodies are positional: tracked arrays pass as (possibly mutated)
    numpy arrays, bare values pass through. Execution starts immediately;
    ``wait()`` (or context exit) seals the stream and joins.
    """

    def __init__(self, nthreads: int = 4):
        from .. import native

        # raises with the cause when the engine cannot be built
        self._ng = native.NativeGraph()
        self._tiles: Dict[int, _Tile] = _TileMap()
        self._bodies: List[Optional[Callable[[], None]]] = []
        self._errors: List[BaseException] = []
        self._nthreads = max(1, nthreads)
        self._inserted = 0
        self._retired = 0
        self._retired_lock = threading.Lock()
        self._sealed = False
        # insertion throttle, same knobs as the Python DTD (reference
        # window/threshold MCA params): bounds live closures + their
        # argument arrays to tasks in flight, not tasks ever inserted
        self.window = mca_param.register(
            "dtd", "window_size", 2048,
            help="max in-flight inserted tasks before the inserter helps execute")
        self.threshold = mca_param.register(
            "dtd", "threshold_size", 1024,
            help="in-flight level the inserter drains down to when the window fills")

        def trampoline(_tid: int, user_tag: int) -> None:
            body = self._bodies[user_tag]
            try:
                body()
            finally:
                # retired closures (and the arrays they capture) are freed
                self._bodies[user_tag] = None
                with self._retired_lock:
                    self._retired += 1

        self._runner = threading.Thread(
            target=self._run, args=(trampoline,), name="native-dtd", daemon=True)
        self._started = False
        self._trampoline = trampoline
        self._ret: Optional[int] = None

    def _run(self, trampoline) -> None:
        try:
            self._ret = self._ng.run(trampoline, nthreads=self._nthreads)
        except BaseException as e:  # noqa: BLE001 - reported in wait()
            self._errors.append(e)

    def _tile(self, arr: np.ndarray) -> _Tile:
        """Tile state keyed by id(arr).  A weakref callback evicts the
        entry the moment the array dies, so a recycled id can never
        inherit a dead tile's last_writer/readers (and the dict stays
        bounded by *live* tracked arrays, not arrays ever inserted).
        The callback captures the tile map WEAKLY — a strong ``self``
        would keep the whole retired pool alive as long as any tracked
        array lives."""
        key = id(arr)
        t = self._tiles.get(key)
        if t is None:
            t = self._tiles[key] = _Tile()
            tiles_ref = weakref.ref(self._tiles)

            def _evict(_r, k=key, m=tiles_ref):
                d = m()
                if d is not None:
                    d.pop(k, None)

            try:
                t._wr = weakref.ref(arr, _evict)
            except TypeError:
                t._wr = None  # non-weakreffable objects: caller keeps alive
        return t

    def insert_task(self, body: Callable, *args: Any, priority: int = 0) -> int:
        """Insert one task; returns its native id. Dependencies are
        inferred from tracked ``(ndarray, mode)`` arguments: readers order
        after the last writer, writers after last writer + all readers.
        ``(arr, mode | DONT_TRACK)`` passes the array untracked;
        ``((shape, dtype), SCRATCH)`` allocates a per-task buffer;
        ``(arr, CTL)`` tracks a control dependency with no body argument."""
        if self._sealed:
            raise RuntimeError("pool sealed (wait() already called)")
        call_args: List[Any] = []
        # same array in several tracked args = ONE dependency site with the
        # union of modes (also prevents a reader arg from chaining onto the
        # writer arg of its own task — a self-edge would never satisfy)
        tracked: Dict[int, Tuple[np.ndarray, AccessMode]] = {}
        for a in args:
            if (isinstance(a, tuple) and len(a) == 2
                    and isinstance(a[1], AccessMode)):
                arr, mode = a
                if mode & AccessMode.SCRATCH:
                    shape, dtype = arr
                    call_args.append(np.empty(shape, dtype))
                    continue
                if not (mode & AccessMode.CTL):
                    call_args.append(arr)
                if mode & (AccessMode.VALUE | AccessMode.DONT_TRACK):
                    continue
                prev = tracked.get(id(arr))
                tracked[id(arr)] = (arr, mode | (prev[1] if prev else mode))
            else:
                call_args.append(a)

        if pins.active(pins.EXEC_BEGIN) or pins.active(pins.COMPLETE_EXEC_END):
            from .native_exec import _TaskInfo

            info = _TaskInfo(getattr(body, "__name__", "dtd_task"),
                             f"#{self._inserted}")

            def task_body(_body=body, _args=tuple(call_args)) -> None:
                pins.fire(pins.EXEC_BEGIN, None, info)
                _body(*_args)
                pins.fire(pins.EXEC_END, None, info)
                pins.fire(pins.COMPLETE_EXEC_BEGIN, None, info)
                pins.fire(pins.COMPLETE_EXEC_END, None, info)
        else:
            def task_body(_body=body, _args=tuple(call_args)) -> None:
                _body(*_args)

        tag = len(self._bodies)
        self._bodies.append(task_body)
        tid = self._ng.add_task(priority=priority, user_tag=tag)
        for arr, mode in tracked.values():
            t = self._tile(arr)
            if mode & (AccessMode.OUT | AccessMode.ATOMIC_WRITE):
                if t.last_writer >= 0 and t.last_writer != tid:
                    self._ng.add_dep(t.last_writer, tid)
                for r in t.readers:
                    if r != tid:
                        self._ng.add_dep(r, tid)
                t.last_writer = tid
                t.readers = []
            else:  # reader (IN / CTL)
                if t.last_writer >= 0 and t.last_writer != tid:
                    self._ng.add_dep(t.last_writer, tid)
                t.readers.append(tid)
        self._ng.commit(tid)
        self._inserted += 1
        if not self._started:
            self._started = True
            self._runner.start()
        self._throttle()
        return tid

    def _throttle(self) -> None:
        """Reference window throttling: when in-flight tasks exceed the
        window, the inserter stalls until workers drain to the threshold
        (bounds memory to tasks in flight)."""
        with self._retired_lock:
            in_flight = self._inserted - self._retired
        if in_flight <= self.window:
            return
        while True:
            time.sleep(0.0005)
            with self._retired_lock:
                if self._inserted - self._retired <= self.threshold:
                    return
            if self._errors or not self._runner.is_alive():
                return

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Seal the stream and block until every inserted task retired.
        Re-raises the first body exception."""
        if not self._sealed:
            self._sealed = True
            self._ng.seal()
            if not self._started:
                self._started = True
                self._runner.start()
        self._runner.join(timeout)
        if self._runner.is_alive():
            return False
        if self._errors:
            raise self._errors[0]
        if self._ret is not None and self._ret != self._inserted:
            raise RuntimeError(
                f"native DTD retired {self._ret}/{self._inserted} tasks")
        return True

    @property
    def inserted(self) -> int:
        return self._inserted

    def close(self) -> None:
        ng = getattr(self, "_ng", None)
        if ng is not None and self._sealed and not self._runner.is_alive():
            ng.close()
            self._ng = None

    def __enter__(self) -> "NativeDTD":
        return self

    def __exit__(self, exc_type, *_exc) -> None:
        if exc_type is None:
            self.wait()
        self.close()
