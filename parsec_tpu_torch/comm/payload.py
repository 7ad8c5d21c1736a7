"""Wire-payload helpers: the device-native data path (SURVEY §5.8).

The reference's comm engine moves GPU buffers without a host bounce when
the fabric allows (``parsec_comm_engine.h:176-199`` is the vtable seam
for device-aware backends).  Here:

* **device-capable transports** (``CommEngine.device_payloads = True``,
  the in-process fabric): a CUDA tensor crosses the wire as ONE
  device-to-device clone made at send, queued behind its producer on the
  compute stream (a CUDA tensor is mutable — bodies and the B1 kernel
  update tiles in place — so passing it by reference would let one rank's
  write change another rank's input).  The receiver's CUDA module lands it
  device-to-device (``bytes_d2d``), never through host memory;
* **serializing transports**: exactly one D2H per payload, and when an
  activation carries several flows their copies are started
  asynchronously first (:func:`prefetch_to_host`) so they overlap; each
  then materializes through :func:`to_wire`.

Host payloads are numpy arrays or, for bfloat16 (numpy has none), torch
CPU tensors.  The raw framing below carries both: the header names a
numpy dtype by its portable ``str`` form and a torch dtype by its torch
name (``torch.bfloat16`` travels as its raw bits), and an F-ordered tile
keeps its layout.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


def is_device_array(obj) -> bool:
    """True for a CUDA tensor (the reference: a ``jax.Array``)."""
    return isinstance(obj, torch.Tensor) and obj.is_cuda


def prefetch_to_host(arrs: Iterable) -> None:
    """Start an asynchronous D2H copy of every CUDA payload into pinned
    memory, queued behind everything on its device's compute stream; the
    later :func:`to_wire` conversions then complete copies that already
    overlapped.  Host payloads need nothing."""
    for a in arrs:
        if is_device_array(a) and getattr(a, "_ptt_host", None) is None:
            stream = torch.cuda.current_stream(a.device)
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            with torch.cuda.stream(stream):
                host.copy_(a, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            a._ptt_host = (host, done)


def to_wire(arr):
    """The wire form of one payload: an ndarray, or a torch CPU tensor for
    bfloat16.  A CUDA payload takes one D2H copy (the prefetched one when
    :func:`prefetch_to_host` started it); a host payload is returned as it
    is (the reference's ``np.asarray`` aliases on its CPU backend too)."""
    if is_device_array(arr):
        pre = getattr(arr, "_ptt_host", None)
        if pre is not None:
            host, done = pre
            done.synchronize()
            arr._ptt_host = None
        else:
            host = arr.detach().cpu()
        return host if host.dtype == torch.bfloat16 else host.numpy()
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(arr)


# -- header + raw-bytes framing (the zero-copy wire form) -----------------
#
# A contiguous host array crosses the wire as a tiny picklable HEADER
# (shape/dtype/order) plus its raw bytes — the receiver rebuilds a view over
# whatever buffer the bytes landed in (an arena slot, a rendezvous buffer)
# without ever invoking pickle on the payload.

def _f_order(arr) -> bool:
    """True when ``arr`` (ndim > 1) is Fortran-ordered and not also
    C-ordered."""
    if isinstance(arr, torch.Tensor):
        if arr.dim() < 2 or arr.is_contiguous():
            return False
        return arr.permute(*range(arr.dim() - 1, -1, -1)).is_contiguous()
    return (arr.ndim > 1 and arr.flags.f_contiguous
            and not arr.flags.c_contiguous)


def raw_framable(arr) -> bool:
    """True when ``arr`` can ship as header+raw-bytes: a contiguous (C or
    F), non-object-dtype numpy ndarray, or a contiguous torch CPU tensor
    (zero-size included — its raw form is simply zero bytes)."""
    if isinstance(arr, torch.Tensor):
        return (arr.device.type == "cpu"
                and (arr.is_contiguous() or _f_order(arr)))
    return (isinstance(arr, np.ndarray)
            and arr.dtype != object
            and (arr.flags.c_contiguous or arr.flags.f_contiguous))


def wire_header(arr) -> dict:
    """Self-describing header for a raw-framed array: a numpy dtype rides
    as its portable ``str`` form, a torch dtype as its torch name
    (``"torch.bfloat16"``); ``order`` records Fortran layout so
    column-major tiles round-trip without a transpose copy."""
    if isinstance(arr, torch.Tensor):
        return {
            "shape": tuple(arr.shape),
            "dtype": str(arr.dtype),
            "order": "F" if _f_order(arr) else "C",
            "nbytes": arr.numel() * arr.element_size(),
        }
    return {
        "shape": arr.shape,
        "dtype": arr.dtype.str,
        "order": "F" if _f_order(arr) else "C",
        "nbytes": arr.nbytes,
    }


def as_bytes(arr) -> np.ndarray:
    """Flat uint8 alias of a contiguous array's memory (no copy): an
    ndarray's, or a torch CPU tensor's (bfloat16 by its raw bits)."""
    if _f_order(arr):
        # the raw bytes ARE column-major; the header says so
        arr = (arr.permute(*range(arr.dim() - 1, -1, -1))
               if isinstance(arr, torch.Tensor) else arr.T)
    if isinstance(arr, torch.Tensor):
        return arr.detach().reshape(-1).view(torch.uint8).numpy()
    return arr.reshape(-1).view(np.uint8)


def byte_slice(buf, offset: int, length: int) -> np.ndarray:
    """Byte-range view of a registered buffer (rendezvous chunk serve).
    Registered rendezvous buffers are flat uint8 views already; anything
    else is reduced to its raw bytes first."""
    if not (isinstance(buf, np.ndarray) and buf.dtype == np.uint8
            and buf.ndim == 1):
        buf = as_bytes(buf.contiguous() if isinstance(buf, torch.Tensor)
                       else np.ascontiguousarray(buf))
    return buf[offset:offset + length]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name[len("torch."):], None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"wire header names an unknown torch dtype {name!r}")
    return dt


def from_wire(header: dict, buf):
    """Rebuild the array as a VIEW over ``buf`` (any byte-addressable
    buffer of at least ``header['nbytes']`` bytes — an arena slot, a
    rendezvous buffer): an ndarray for a numpy dtype, a torch CPU tensor
    for a torch one.  No pickle touches the payload.  The result aliases
    ``buf`` and keeps it alive; buffer lifetime is the caller's business
    (arena slots self-release via finalizers)."""
    shape = tuple(header["shape"])
    nbytes = int(header["nbytes"])
    fortran = header.get("order") == "F"
    if str(header["dtype"]).startswith("torch."):
        dt = _torch_dtype(header["dtype"])
        if nbytes == 0:
            flat = torch.empty(0, dtype=dt)
        else:
            flat = torch.frombuffer(memoryview(buf)[:nbytes], dtype=dt)
        if fortran:
            return flat.reshape(shape[::-1]).permute(
                *range(len(shape) - 1, -1, -1))
        return flat.reshape(shape)
    dt = np.dtype(header["dtype"])
    flat = np.frombuffer(memoryview(buf)[:nbytes], dtype=dt)
    if fortran:
        return flat.reshape(shape[::-1]).T
    return flat.reshape(shape)
