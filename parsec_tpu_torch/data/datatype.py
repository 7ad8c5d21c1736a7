"""Datatype layer: typed memory layouts for flow data and the wire.

The port of :mod:`parsec_tpu.data.datatype`.  Reference:
``parsec/datatype.h`` and ``parsec/datatype/`` — a thin wrapper over MPI
datatypes (``parsec_type_create_contiguous`` / ``_vector`` / ``_resized``
…) so the DSLs and the comm engine can describe non-contiguous data (a
LAPACK-layout tile is a strided column or row panel of a bigger array)
without touching MPI directly.

A :class:`Datatype` describes an element type and a layout over a flat
buffer.  ``view()`` materialises it as a zero-copy strided numpy view;
``pack()``/``unpack()`` serialize between that layout and contiguous wire
bytes (the comm engine's pack/unpack slots in the reference,
``parsec_comm_engine.h:176-199``).  It speaks of host buffers only: the
port's host copies are numpy arrays, and device copies are torch tensors
whose layout the device module owns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Datatype",
    "Contiguous",
    "Vector",
    "type_create_contiguous",
    "type_create_vector",
    "type_of_array",
]


class Datatype:
    """Abstract layout descriptor.

    ``size``   — bytes of actual data (sum of block payloads);
    ``extent`` — bytes spanned in the source buffer (>= size, like the MPI
    extent: the footprint between the first and one-past-last element).
    """

    base: np.dtype

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def extent(self) -> int:
        raise NotImplementedError

    @property
    def count(self) -> int:
        """Number of base elements in the data (size / itemsize)."""
        return self.size // self.base.itemsize

    def view(self, buffer: np.ndarray, offset: int = 0) -> np.ndarray:
        """Zero-copy strided view of this layout over ``buffer`` (a 1-D
        array of ``base`` dtype) starting at element ``offset``."""
        raise NotImplementedError

    def pack(self, buffer: np.ndarray, offset: int = 0) -> np.ndarray:
        """Gather the layout into a fresh contiguous 1-D array (the wire
        representation). Contiguous layouts return a zero-copy view."""
        v = self.view(buffer, offset)
        return np.ascontiguousarray(v).reshape(-1)

    def unpack(self, raw: np.ndarray, buffer: np.ndarray, offset: int = 0) -> None:
        """Scatter contiguous wire data ``raw`` back into ``buffer``
        according to the layout."""
        v = self.view(buffer, offset)
        np.copyto(v, np.asarray(raw, dtype=self.base).reshape(v.shape))


class Contiguous(Datatype):
    """``count`` consecutive elements of ``base``
    (reference ``parsec_type_create_contiguous``)."""

    def __init__(self, count: int, base=np.float64):
        self._count = int(count)
        self.base = np.dtype(base)
        if self._count < 0:
            raise ValueError("negative count")

    @property
    def size(self) -> int:
        return self._count * self.base.itemsize

    @property
    def extent(self) -> int:
        return self.size

    def view(self, buffer: np.ndarray, offset: int = 0) -> np.ndarray:
        buffer = _as_flat(buffer, self.base)
        _check_span(buffer, offset, self._count, self)
        return buffer[offset:offset + self._count]

    def pack(self, buffer: np.ndarray, offset: int = 0) -> np.ndarray:
        return self.view(buffer, offset)  # already contiguous: zero-copy

    def __repr__(self) -> str:
        return f"Contiguous({self._count}, {self.base.name})"


class Vector(Datatype):
    """``blocks`` blocks of ``blocklen`` elements, start-to-start distance
    ``stride`` elements (reference ``parsec_type_create_vector``) — the
    layout of a LAPACK-storage tile: one block per column, stride = lda.
    """

    def __init__(self, blocks: int, blocklen: int, stride: int, base=np.float64):
        self.blocks = int(blocks)
        self.blocklen = int(blocklen)
        self.stride = int(stride)
        self.base = np.dtype(base)
        if self.blocks < 0 or self.blocklen < 0:
            raise ValueError("negative vector dims")
        if self.blocks > 1 and self.stride < self.blocklen:
            raise ValueError(
                f"stride {self.stride} < blocklen {self.blocklen}: "
                "blocks would overlap")

    @property
    def size(self) -> int:
        return self.blocks * self.blocklen * self.base.itemsize

    @property
    def extent(self) -> int:
        if self.blocks == 0:
            return 0
        return ((self.blocks - 1) * self.stride + self.blocklen) * self.base.itemsize

    def view(self, buffer: np.ndarray, offset: int = 0) -> np.ndarray:
        buffer = _as_flat(buffer, self.base)
        _check_span(buffer, offset, self.extent // self.base.itemsize, self)
        it = self.base.itemsize
        return np.lib.stride_tricks.as_strided(
            buffer[offset:],
            shape=(self.blocks, self.blocklen),
            strides=(self.stride * it, it),
            writeable=buffer.flags.writeable,
        )

    def __repr__(self) -> str:
        return (f"Vector(blocks={self.blocks}, blocklen={self.blocklen}, "
                f"stride={self.stride}, {self.base.name})")


def _check_span(flat: np.ndarray, offset: int, need_elems: int, dt) -> None:
    """An undersized buffer must fail loudly here — as_strided would hand
    out an out-of-bounds view (heap corruption on write), and a silent
    short slice would put truncated payloads on the wire."""
    if offset < 0 or flat.shape[0] - offset < need_elems:
        raise ValueError(
            f"buffer too small for {dt!r}: need {need_elems} element(s) at "
            f"offset {offset}, have {flat.shape[0]}")


def _as_flat(buffer: np.ndarray, base: np.dtype) -> np.ndarray:
    a = np.asarray(buffer)
    if a.dtype != base:
        a = a.view(base)
    if a.ndim != 1:
        if not a.flags.c_contiguous:
            raise ValueError(
                "datatype views need a flat (or C-contiguous) backing buffer")
        a = a.reshape(-1)
    return a


# -- factories (the reference's construction API) ---------------------------

def type_create_contiguous(count: int, base=np.float64) -> Contiguous:
    return Contiguous(count, base)


def type_create_vector(blocks: int, blocklen: int, stride: int,
                       base=np.float64) -> Vector:
    return Vector(blocks, blocklen, stride, base)


def type_of_array(a: np.ndarray) -> Datatype:
    """Describe an existing 1-D/2-D array as a datatype over its own base
    buffer (2-D C-order arrays with row padding become Vectors)."""
    a = np.asarray(a)
    if a.ndim == 1:
        return Contiguous(a.shape[0], a.dtype)
    if a.ndim == 2:
        it = a.dtype.itemsize
        if a.strides[1] != it:
            raise ValueError("inner dimension must be unit-stride")
        return Vector(a.shape[0], a.shape[1], a.strides[0] // it, a.dtype)
    raise ValueError("only 1-D/2-D arrays describable")
