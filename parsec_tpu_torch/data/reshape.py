"""Reshape engine: lazy conversion of flow data between shapes/dtypes.

The port of :mod:`parsec_tpu.data.reshape`.  Reference:
``parsec/parsec_reshape.c`` and the datacopy futures backing it
(``class/parsec_datacopy_future.c``).  A flow dependency may request the
data under a different *shape* (in the reference: a different MPI
datatype/count/displacement; here: a different array shape/dtype).
Rather than converting eagerly at the producer, the runtime creates a
**reshape promise** — a future that converts lazily, once, the first time
any consumer actually needs the reshaped copy
(``parsec_get_copy_reshape_from_dep``, ``parsec_internal.h:668-686``; the
local-reshape trigger is ``parsec_local_reshape_cb``, ``remote_dep.h:113``).

Promises are cached per (source data, spec) so that many consumers asking
for the same shape share one conversion — the reference caches them in the
repo entries of the producing task.

Where a conversion runs: on a torch tensor it is a torch cast/reshape on
the tensor's own device — a CUDA tile is cast on the card and its result,
a CUDA tensor, is the reshaped copy (the CUDA module then stages it
device-to-device); a host ndarray converts with numpy.  A dtype is a
numpy dtype or ``torch.bfloat16`` (numpy has none), as the port's tiles
are: the name ``bfloat16`` maps to it, and a host tile converted to
bfloat16 becomes a torch CPU tensor.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .data import (Coherency, Data, DataCopy, ready_event, set_ready_event,
                   torch_dtype)


def _tile_dtype(dtype) -> Any:
    """A dtype in the port's tile form: ``torch.bfloat16`` for any
    bfloat16 (the torch dtype, the name ``"bfloat16"``), else a numpy
    dtype (a torch dtype maps to its numpy counterpart)."""
    if dtype is torch.bfloat16 or getattr(dtype, "name", dtype) == "bfloat16":
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class DataCopyFuture:
    """A single-assignment future resolving to a :class:`DataCopy`
    (reference ``parsec_datacopy_future_t``): carries a trigger callback
    that produces the value on first demand, and notifies completion
    callbacks exactly once."""

    __slots__ = ("_lock", "_value", "_exc", "_done", "_trigger", "_callbacks", "_event")

    def __init__(self, trigger: Optional[Callable[[], DataCopy]] = None):
        self._lock = threading.Lock()
        self._value: Optional[DataCopy] = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self._trigger = trigger
        self._callbacks: List[Callable[[DataCopy], None]] = []
        self._event = threading.Event()

    def is_ready(self) -> bool:
        return self._done and self._exc is None

    def set(self, value: DataCopy) -> None:
        with self._lock:
            if self._done:
                raise RuntimeError("datacopy future already resolved")
            self._value = value
            self._done = True
            cbs, self._callbacks = self._callbacks, []
        self._event.set()
        for cb in cbs:
            cb(value)

    def set_exception(self, exc: BaseException) -> None:
        """Resolve exceptionally: every current and future waiter re-raises
        (a stranded waiter is worse than a propagated error)."""
        with self._lock:
            if self._done:
                return
            self._exc = exc
            self._done = True
            self._callbacks = []
        self._event.set()

    def on_ready(self, cb: Callable[[DataCopy], None]) -> None:
        with self._lock:
            if not self._done:
                self._callbacks.append(cb)
                return
        if self._exc is None:
            cb(self._value)  # already resolved

    def get(self, timeout: Optional[float] = None) -> DataCopy:
        """Demand the value, running the lazy trigger if nobody has yet."""
        trig = None
        with self._lock:
            if not self._done and self._trigger is not None:
                trig, self._trigger = self._trigger, None
        if trig is not None:
            try:
                value = trig()
            except BaseException as e:
                self.set_exception(e)
                raise
            self.set(value)
        if not self._event.wait(timeout):
            raise TimeoutError("datacopy future not resolved")
        if self._exc is not None:
            raise self._exc
        return self._value


class ReshapeSpec:
    """Requested target form of a flow's data (the analogue of the
    reference's ``(datatype, count, displ)`` triple on a dep)."""

    __slots__ = ("dtype", "shape")

    def __init__(self, dtype: Any = None, shape: Optional[Tuple[int, ...]] = None):
        self.dtype = _tile_dtype(dtype) if dtype is not None else None
        self.shape = tuple(int(s) for s in shape) if shape is not None else None

    @classmethod
    def from_props(cls, props: Dict[str, str], constants: Dict[str, Any]) -> Optional["ReshapeSpec"]:
        """Build a spec from a dep's ``[k=v ...]`` property block.  Accepted
        keys (JDF parity: ``[type=...]`` names a registered arena datatype):

        * ``dtype=float32``        — a dtype name (``bfloat16`` included)
        * ``shape=4x8``            — target shape, ``x``-separated
        * ``type=NAME``            — look up ``NAME`` in the taskpool
          constants; the value may be a ``ReshapeSpec``, a dtype (``torch.
          bfloat16`` included), or a ``(dtype, shape)`` tuple.
        """
        dtype = shape = None
        if "type" in props:
            name = props["type"]
            if name not in constants:
                # a [type=NAME] with no registered constant is a wire-layout
                # tag (the reference's arena-datatype name for comm packing),
                # not a local reshape request — ignore it here
                v = None
            else:
                v = constants[name]
            if v is None:
                pass
            elif isinstance(v, ReshapeSpec):
                dtype, shape = v.dtype, v.shape
            elif isinstance(v, tuple) and len(v) == 2:
                dtype, shape = v
            else:
                dtype = v
        if "dtype" in props:
            dtype = props["dtype"]
        if "shape" in props:
            shape = tuple(int(x) for x in props["shape"].replace("(", "").replace(")", "").split("x"))
        if dtype is None and shape is None:
            return None
        return cls(dtype, shape)

    def matches(self, payload: Any) -> bool:
        if payload is None:
            return False
        if self.dtype is not None:
            have = getattr(payload, "dtype", None)
            if have is None or _tile_dtype(have) != self.dtype:
                return False
        if self.shape is not None and tuple(getattr(payload, "shape", ())) != self.shape:
            return False
        return True

    def apply(self, payload: Any) -> Any:
        """Convert a payload.  A torch tensor is cast and reshaped on its
        own device (a CUDA tile stays on the card) into a tensor of its
        own — never an alias of the source; an ndarray goes through numpy,
        or becomes a torch CPU tensor for a bfloat16 target."""
        out = payload
        if isinstance(out, torch.Tensor):
            stream = None
            if out.is_cuda:
                # after the source's producer (its ready event, when it has
                # one); the result's own event orders its readers
                stream = torch.cuda.current_stream(out.device)
                ev = ready_event(out)
                if ev is not None:
                    stream.wait_event(ev)
            if self.dtype is not None:
                out = out.to(torch_dtype(self.dtype))
            if self.shape is not None:
                out = out.reshape(self.shape)
            if out.data_ptr() == payload.data_ptr():
                out = out.clone()
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
                set_ready_event(out, done)
            return out
        out = np.asarray(out)
        if self.dtype is torch.bfloat16:
            out = torch.from_numpy(np.ascontiguousarray(out)).to(torch.bfloat16)
            return out.reshape(self.shape) if self.shape is not None else out
        if self.dtype is not None and out.dtype != self.dtype:
            out = out.astype(self.dtype)
        if self.shape is not None and out.shape != self.shape:
            out = np.reshape(out, self.shape)
        return out

    def _key(self) -> Tuple:
        return (str(self.dtype), self.shape)

    def __eq__(self, other) -> bool:
        return isinstance(other, ReshapeSpec) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"ReshapeSpec(dtype={self.dtype}, shape={self.shape})"


# promise cache: (data_id, spec) -> (future, reshaped Data); entries are
# evicted when the source Data is garbage-collected (weakref.finalize).
# RLock: the finalizer can fire from a GC pass triggered by an allocation
# made while get_copy_reshape already holds the lock on the same thread.
_promises: Dict[Tuple[int, ReshapeSpec], Tuple[DataCopyFuture, Data]] = {}
_promises_lock = threading.RLock()
_finalized: set = set()


def _evict_promises_of(data_id: int) -> None:
    with _promises_lock:
        _finalized.discard(data_id)
        for k in [k for k in _promises if k[0] == data_id]:
            del _promises[k]


def get_copy_reshape(data: Data, spec: ReshapeSpec, device_index: int = 0) -> Data:
    """Return a :class:`Data` holding ``data`` under ``spec``'s form
    (reference ``parsec_get_copy_reshape_from_dep``).  If the newest copy
    already matches, the original is returned unchanged (the reference's
    *no-reshape-needed* fast path, ``parsec_reshape.c``); otherwise a cached
    lazy promise is created and its (possibly not-yet-materialised) Data
    returned.  The conversion runs on first access; its result is attached
    at ``device_index`` (the host slot by default, as in the reference — a
    CUDA result there is staged device-to-device by the CUDA module)."""
    src = data.newest_copy()
    if src is not None and spec.matches(src.payload):
        return data

    key = (data.data_id, spec)
    with _promises_lock:
        hit = _promises.get(key)
        if hit is not None:
            fut, reshaped = hit
            rc = reshaped.newest_copy()
            # a materialised promise is only reusable while it still holds
            # the source's current version (the reference caches promises in
            # the producing task's repo entry, so they die with the version;
            # here we compare versions and rebuild when the source moved on)
            if (not fut.is_ready()
                    or src is None
                    or (rc is not None and rc.version >= src.version)):
                return reshaped
            del _promises[key]
        else:
            # evict this source's promises when the Data is collected so the
            # process-global cache cannot grow without bound
            if data.data_id not in _finalized:
                _finalized.add(data.data_id)
                weakref.finalize(data, _evict_promises_of, data.data_id)
        reshaped = Data((data.key, "reshape", spec._key()),
                        shape=spec.shape or data.shape,
                        dtype=spec.dtype or data.dtype)
        # the trigger must not pin the source: cache -> future -> trigger ->
        # data would keep every source alive and the finalizer would never run
        dref = weakref.ref(data)

        def trigger() -> DataCopy:
            d = dref()
            if d is None:
                raise RuntimeError("reshape source Data was collected")
            s = d.newest_copy()
            if s is None:
                raise RuntimeError(f"reshape of {d!r}: no valid source copy")
            out = spec.apply(s.payload)
            c = reshaped.attach_copy(s.device_index if device_index is None else device_index, out)
            c.coherency = Coherency.SHARED
            c.version = s.version
            return c

        fut = DataCopyFuture(trigger)
        reshaped.user = fut  # the promise rides on the Data (lazy hook)
        _promises[key] = (fut, reshaped)
        return reshaped


def materialize(data: Data) -> Data:
    """Force a reshape promise attached to ``data`` (no-op otherwise)."""
    fut = getattr(data, "user", None)
    if isinstance(fut, DataCopyFuture):
        fut.get()
    return data


def reshape_cache_clear() -> None:
    with _promises_lock:
        _promises.clear()
