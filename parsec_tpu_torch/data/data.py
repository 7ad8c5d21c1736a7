"""Data and per-device copies with coherency and versioning.

Reference: ``parsec/data.{c,h}``, ``data_internal.h`` —
``parsec_data_t`` is a meta-object keyed into a collection holding one
``parsec_data_copy_t`` per device; copies carry a MOESI-like
``coherency_state`` (INVALID/OWNED/EXCLUSIVE/SHARED), a ``version``, and
ownership flags (``data.h:27-60``). Ownership transfer on access is
``parsec_data_transfer_ownership_to_copy`` (``data.h:119-130``).

Payloads: numpy arrays on the CPU device, ``torch.Tensor`` on the CUDA
device module (a CUDA tensor, or a torch CPU tensor when the module is
bound to the torch CPU device).
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Any, Dict, Optional, TYPE_CHECKING

import numpy as np
import torch

from ..core.lifecycle import AccessMode
from ..profiling import pins

if TYPE_CHECKING:  # pragma: no cover
    from .collection import DataCollection


class Coherency(enum.Enum):
    """Reference PARSEC_DATA_COHERENCY_* (data.h:39-44)."""

    INVALID = "invalid"      # content stale; must be refreshed before use
    OWNED = "owned"          # this device has the authoritative, dirty copy
    EXCLUSIVE = "exclusive"  # sole valid copy, clean
    SHARED = "shared"        # valid copy, possibly replicated


class DataCopy:
    """One device-resident replica of a Data (reference
    ``parsec_data_copy_t``)."""

    __slots__ = (
        "data",
        "device_index",
        "payload",
        "coherency",
        "version",
        "readers",
        "flags",
        "arena",
        "staged_by",
    )

    def __init__(self, data: "Data", device_index: int, payload: Any = None):
        self.data = data
        self.device_index = device_index
        self.payload = payload
        self.coherency = Coherency.INVALID if payload is None else Coherency.SHARED
        self.version: int = 0
        self.readers: int = 0
        self.flags: int = 0
        self.arena = None  # owning arena, for recycled temp buffers
        #: the custom stage_in hook that produced this copy's payload, if
        #: any — a packed/converted representation is only reusable by
        #: the SAME hook (device/cuda.py _stage_in_custom fast path)
        self.staged_by = None

    @property
    def nbytes(self) -> int:
        p = self.payload
        return int(getattr(p, "nbytes", 0))

    def __repr__(self) -> str:
        return (
            f"DataCopy(key={self.data.key}, dev={self.device_index}, "
            f"{self.coherency.value}, v{self.version})"
        )


class Data:
    """The device-agnostic data meta-object (reference ``parsec_data_t``)."""

    _ids = itertools.count()

    __slots__ = (
        "key",
        "collection",
        "copies",
        "owner_device",
        "preferred_device",
        "nb_elts",
        "shape",
        "dtype",
        "lock",
        "data_id",
        "user",
        "__weakref__",
    )

    def __init__(
        self,
        key: Any,
        collection: Optional["DataCollection"] = None,
        *,
        shape=None,
        dtype=None,
        nb_elts: int = 0,
    ):
        self.key = key
        self.collection = collection
        self.copies: Dict[int, DataCopy] = {}
        self.owner_device: int = -1
        self.preferred_device: int = -1
        self.nb_elts = nb_elts
        self.shape = shape
        self.dtype = dtype
        self.lock = threading.RLock()
        self.data_id = next(self._ids)
        self.user: Any = None

    # -- copy management --------------------------------------------------
    def attach_copy(self, device_index: int, payload: Any) -> DataCopy:
        """Reference ``parsec_data_copy_attach``."""
        with self.lock:
            c = DataCopy(self, device_index, payload)
            existing = self.copies.get(device_index)
            if existing is not None:
                c.version = existing.version
            self.copies[device_index] = c
            if self.owner_device < 0:
                self.owner_device = device_index
                c.coherency = Coherency.EXCLUSIVE
            return c

    def detach_copy(self, device_index: int) -> Optional[DataCopy]:
        with self.lock:
            c = self.copies.pop(device_index, None)
            if c is not None and self.owner_device == device_index:
                self.owner_device = next(iter(self.copies), -1)
            return c

    def get_copy(self, device_index: int) -> Optional[DataCopy]:
        with self.lock:
            return self.copies.get(device_index)

    def newest_copy(self) -> Optional[DataCopy]:
        with self.lock:
            best = None
            for c in self.copies.values():
                if c.coherency is Coherency.INVALID:
                    continue
                if best is None or c.version > best.version:
                    best = c
            return best

    # -- coherency protocol ----------------------------------------------
    def transfer_ownership(self, device_index: int, access: AccessMode) -> DataCopy:
        """MOESI-like ownership transition before ``device_index`` touches
        the data (reference ``parsec_data_transfer_ownership_to_copy``,
        ``data.c``). Returns the target copy (payload may still need a
        stage-in by the caller if its version lags)."""
        with self.lock:
            copy = self.copies.get(device_index)
            if copy is None:
                copy = DataCopy(self, device_index)
                self.copies[device_index] = copy
            if access & AccessMode.OUT:
                # writer: invalidate all other replicas, become OWNED
                for di, c in self.copies.items():
                    if di != device_index:
                        c.coherency = Coherency.INVALID
                copy.coherency = Coherency.OWNED
                self.owner_device = device_index
            else:
                # reader: join the sharers; demote an exclusive owner
                if copy.coherency is Coherency.INVALID:
                    copy.coherency = Coherency.SHARED
                owner = self.copies.get(self.owner_device)
                if owner is not None and owner is not copy and owner.coherency is Coherency.EXCLUSIVE:
                    owner.coherency = Coherency.SHARED
                copy.readers += 1
            return copy

    def version_bump(self, device_index: int) -> int:
        """After a write completes on ``device_index``: new authoritative
        version (reference: epilog version bump, ``device_gpu.c:2343``)."""
        with self.lock:
            copy = self.copies[device_index]
            newv = max((c.version for c in self.copies.values()), default=0) + 1
            copy.version = newv
            copy.coherency = Coherency.OWNED
            self.owner_device = device_index
        # happens-before site: a write to this tile retired.  The hb
        # checker flags two bumps with no dependency/completion/frame
        # path between them (RT001) — the version counter itself is
        # lock-serialized, but the payload writes it summarizes are not.
        if pins.active(pins.DATA_VERSION_BUMP):
            pins.fire(pins.DATA_VERSION_BUMP, None,
                      {"data": self.data_id, "key": self.key,
                       "version": newv, "device": device_index})
        return newv

    def __repr__(self) -> str:
        return f"Data(key={self.key}, copies={list(self.copies)})"


class ScratchData(Data):
    """A task-made tile: the data of a ``<- NEW`` flow that no collection
    holds, made by its producer and read by its successors (the native
    executor's device path, :meth:`..dsl.native_exec.NativeExecutor.
    _data_for`).  It starts with no copy anywhere; ``shape`` and ``dtype``
    are its flow's ``new_tile_spec``.  A device module gives it its first
    home on the card (``torch.empty`` for a producer that writes it
    whole, device zeros for one that reads it first), never fills it on
    the host nor stages it in, and drops it instead of writing it back
    when it detaches; only an eviction takes it home.  A host body that
    touches it first gets host zeros (:meth:`host_zeros`)."""

    __slots__ = ()

    def host_zeros(self):
        """Attach and return a host copy of zeros (the first touch of a
        host body)."""
        c = self.attach_copy(0, new_tile(self.shape, self.dtype))
        return c.payload


def _tile_dtype(dtype) -> Any:
    """A dtype in the port's tile form: ``torch.bfloat16`` for any
    bfloat16 (the torch dtype, the name ``"bfloat16"``), else a numpy
    dtype (a torch dtype maps to its numpy counterpart)."""
    if dtype is torch.bfloat16 or getattr(dtype, "name", dtype) == "bfloat16":
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def new_tile(shape, dtype):
    """A zero tile of ``shape`` in the tile dtype ``dtype`` on the host:
    an ndarray, or a torch CPU tensor for bfloat16 (numpy has none)."""
    dt = _tile_dtype(dtype)
    if dt is torch.bfloat16:
        return torch.zeros(tuple(shape), dtype=dt)
    return np.zeros(shape, dt)


def set_ready_event(tensor: torch.Tensor, event) -> None:
    """Record that ``tensor``'s value is complete once ``event`` (a
    ``torch.cuda.Event`` recorded after the copy or the body that produced
    it) has completed.  Readers on other streams wait on it instead of on
    the whole device."""
    tensor._ptt_ready = event


def ready_event(tensor: torch.Tensor):
    """The event :func:`set_ready_event` attached to ``tensor``, or None."""
    return getattr(tensor, "_ptt_ready", None)


#: device index -> the side stream host reads of CUDA tensors run on
_read_streams: Dict[int, Any] = {}
_read_lock = threading.Lock()


def _read_stream(device: torch.device):
    idx = device.index if device.index is not None else torch.cuda.current_device()
    with _read_lock:
        s = _read_streams.get(idx)
        if s is None:
            s = _read_streams[idx] = torch.cuda.Stream(device=idx)
        return s


def host_array(payload):
    """A private, writable host copy of ``payload``'s value: an ndarray, or a
    torch CPU tensor for a bfloat16 tensor (numpy has no bfloat16).

    A CUDA tensor is copied device->host on a side stream that first waits
    on the tensor's ready event (:func:`set_ready_event`) — or, for a
    tensor without one, on everything queued on the device's default
    stream, where the port's bodies run — so the read blocks on that copy
    alone, never on the whole device.  A torch CPU tensor's ``.numpy()`` —
    like ``np.asarray`` of an ndarray — ALIASES the source, and host copies
    are mutated in place by CPU bodies, so the result is always a fresh
    copy."""
    if isinstance(payload, np.ndarray):
        return np.array(payload, copy=True)
    if isinstance(payload, torch.Tensor):
        t = payload.detach()
        if t.is_cuda:
            stream = _read_stream(t.device)
            event = ready_event(payload)
            with torch.cuda.stream(stream):
                if event is not None:
                    stream.wait_event(event)
                else:
                    stream.wait_stream(torch.cuda.default_stream(t.device))
                t = t.cpu()  # blocking: ``payload`` is held until it is done
        else:
            t = t.clone()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(payload, copy=True)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a tile dtype: a torch dtype as it is (bfloat16
    tiles are torch tensors), a numpy dtype as torch names it."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def land_into_home(home: "Data", payload) -> None:
    """Store a flow's final value into its home tile's host copy and bump
    the version (the write-back of a flow whose chain ends away from its
    home tile).  The value goes through :func:`host_array`: the
    reference's ``np.asarray`` would fail on a CUDA tensor."""
    if payload is None:
        return
    buf = host_array(payload)
    dst = home.get_copy(0)
    if dst is None or dst.payload is None:
        home.attach_copy(0, buf)
    elif isinstance(dst.payload, torch.Tensor):
        dst.payload.copy_(torch.as_tensor(buf))
    else:
        np.copyto(dst.payload, buf)
    home.version_bump(0)


def data_create(key: Any, collection=None, payload=None, device_index: int = 0, **kw) -> Data:
    """Reference ``parsec_data_create``: make a Data with an initial
    device-0 (CPU) copy."""
    d = Data(key, collection, **kw)
    if payload is not None:
        d.attach_copy(device_index, payload)
        if d.shape is None:
            d.shape = getattr(payload, "shape", None)
        if d.dtype is None:
            d.dtype = getattr(payload, "dtype", None)
    return d
