"""``shard_map`` over a :class:`~.mesh.Mesh`: one thread a position.

The port's counterpart of the ``shard_map`` that
:mod:`parsec_tpu.parallel._compat` re-exports.  ``shard_map(fn, mesh,
in_specs, out_specs)(*args)`` splits each input by its
:class:`~.mesh.PartitionSpec` onto the positions' devices (every position
gets its own copy), runs ``fn`` once a position, each in a thread of its
own with that position's axis indices in a thread-local context, and joins
the outputs by ``out_specs`` into tensors on the mesh's first device.

Inside ``fn`` the collectives below meet at an in-process exchange:
:func:`ppermute`, :func:`psum`, :func:`psum_scatter`, :func:`all_gather`
and :func:`all_to_all`, with :func:`axis_index` and :func:`axis_size`.  A
collective along an axis groups the positions that share every other
coordinate.  Its semantics are ``jax.lax``'s:

* a ``ppermute`` with a partial permutation gives zeros at the positions
  that receive nothing;
* a sum adds the contributions in position order, so every position gets
  the same bits and a rerun repeats them;
* a sender's tensor is copied when it enters the exchange (on its own
  device, on its thread's current stream) and a receiver never aliases
  it; a receiver on another device takes it with ``.to(device)``.
  Positions on one card all enqueue on that card's current stream (the
  default stream unless the caller set another for every position), so a
  copy enqueued before the rendezvous is ordered before every read after
  it.

Every rendezvous waits at most ``timeout`` seconds.  A position that
raises aborts the exchange: the others raise :class:`ShardMapAborted` at
their next rendezvous, and the call raises the first position's error.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .mesh import Mesh, P, PartitionSpec

__all__ = ["shard_map", "P", "PartitionSpec", "ShardMapAborted", "axis_index",
           "axis_size", "ppermute", "psum", "psum_scatter", "all_gather", "all_to_all"]

#: seconds a position waits at one rendezvous before the call fails
DEFAULT_TIMEOUT = 300.0

Axes = Union[str, Sequence[str]]


class ShardMapAborted(RuntimeError):
    """Raised at a rendezvous once another position failed."""


class _Exchange:
    """The rendezvous of one ``shard_map`` call: contributions keyed by
    (collective sequence number, axes, the group's fixed coordinates)."""

    def __init__(self, timeout: float):
        self.timeout = timeout
        self.cv = threading.Condition()
        self.slots: Dict[Tuple, Dict[int, Any]] = {}
        self.readers: Dict[Tuple, int] = {}
        self.error: Optional[Tuple[Tuple[int, ...], BaseException]] = None

    def abort(self, coords: Tuple[int, ...], exc: BaseException) -> None:
        with self.cv:
            if self.error is None:
                self.error = (coords, exc)
            self.cv.notify_all()

    def _raise_aborted(self, coords) -> None:
        where, exc = self.error
        raise ShardMapAborted(f"shard_map position {coords}: position {where} failed "
                              f"({type(exc).__name__}: {exc})")

    def exchange(self, key: Tuple, me: int, n: int, value: Any,
                 coords: Tuple[int, ...]) -> Dict[int, Any]:
        """Deposit ``value`` as member ``me`` of an ``n``-member group and
        return every member's contribution once all are in."""
        deadline = time.monotonic() + self.timeout
        with self.cv:
            if self.error is not None:
                self._raise_aborted(coords)
            slot = self.slots.setdefault(key, {})
            slot[me] = value
            if len(slot) == n:
                self.cv.notify_all()
            while len(slot) < n:
                if self.error is not None:
                    self._raise_aborted(coords)
                left = deadline - time.monotonic()
                if left <= 0:
                    exc = TimeoutError(
                        f"shard_map position {coords}: collective {key[1]} #{key[0]} "
                        f"waited {self.timeout} s for {n - len(slot)} of {n} positions")
                    if self.error is None:
                        self.error = (coords, exc)
                    self.cv.notify_all()
                    raise exc
                self.cv.wait(left)
            got = dict(slot)
            left_readers = self.readers.get(key, n) - 1
            if left_readers == 0:
                del self.slots[key]
                self.readers.pop(key, None)
            else:
                self.readers[key] = left_readers
            return got


class _Position:
    """A running position: its mesh coordinates, device and exchange."""

    def __init__(self, mesh: Mesh, coords: Tuple[int, ...], exch: _Exchange):
        self.mesh = mesh
        self.coords = coords
        self.device = mesh.devices[coords]
        self.exch = exch
        self.seq = 0


_local = threading.local()


def _position() -> _Position:
    pos = getattr(_local, "pos", None)
    if pos is None:
        raise RuntimeError("a mesh collective runs only inside a shard_map-ed function")
    return pos


def _dims(mesh: Mesh, axes: Axes) -> List[int]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    try:
        return [mesh.axis_names.index(a) for a in names]
    except ValueError:
        raise ValueError(f"unknown mesh axis in {names}; the mesh has "
                         f"{mesh.axis_names}") from None


def axis_size(axes: Axes) -> int:
    """Positions along ``axes`` (a name or a tuple of names)."""
    pos = _position()
    return int(np.prod([pos.mesh.devices.shape[d] for d in _dims(pos.mesh, axes)]))


def axis_index(axes: Axes) -> int:
    """This position's index along ``axes`` (row-major over a tuple)."""
    pos = _position()
    idx = 0
    for d in _dims(pos.mesh, axes):
        idx = idx * pos.mesh.devices.shape[d] + pos.coords[d]
    return idx


def _gather(axes: Axes, value: Any) -> Tuple[int, int, List[Any]]:
    """One rendezvous of the group along ``axes``: returns (my index, the
    group's size, every member's contribution in index order)."""
    pos = _position()
    dims = _dims(pos.mesh, axes)
    n = int(np.prod([pos.mesh.devices.shape[d] for d in dims]))
    me = axis_index(axes)
    fixed = tuple(c for d, c in enumerate(pos.coords) if d not in dims)
    key = (pos.seq, tuple(pos.mesh.axis_names[d] for d in dims), fixed)
    pos.seq += 1
    if isinstance(value, torch.Tensor):
        value = value.clone()  # the sender's own copy: never aliased
    got = pos.exch.exchange(key, me, n, value, pos.coords)
    return me, n, [got[i] for i in range(n)]


def _here(t: Any) -> Any:
    """A received contribution on this position's device."""
    dev = _position().device
    if isinstance(t, torch.Tensor) and t.device != dev:
        return t.to(dev)
    return t


def ppermute(x: torch.Tensor, axis: Axes, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from ``src`` to ``dst`` for each pair of ``perm`` along
    ``axis``; a position no pair sends to gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if len({s for s, _ in perm}) != len(perm) or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    me, n, got = _gather(axis, x)
    src = [s for s, d in perm if d == me]
    if not src:
        return torch.zeros_like(x)
    return _here(got[src[0]])


def psum(x, axis: Axes):
    """Sum over the positions along ``axis``, in position order."""
    _me, _n, got = _gather(axis, x)
    out = _here(got[0])
    for c in got[1:]:
        out = out + _here(c)
    return out


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split into {n} tiles")
    return t.narrow(dim, i * (size // n), size // n)


def psum_scatter(x: torch.Tensor, axis: Axes, *, scatter_dimension: int = 0) -> torch.Tensor:
    """Sum over ``axis`` and keep this position's tile of
    ``scatter_dimension`` (tiled: the dimension shrinks by the axis size),
    the contributions added in position order."""
    me, n, got = _gather(axis, x)
    out = _here(_chunk(got[0], scatter_dimension, n, me))
    for c in got[1:]:
        out = out + _here(_chunk(c, scatter_dimension, n, me))
    return out.contiguous()


def all_gather(x: torch.Tensor, axis_name: Axes, *, axis: int = 0) -> torch.Tensor:
    """Every position's ``x`` concatenated along ``axis`` in position order
    (tiled)."""
    _me, _n, got = _gather(axis_name, x)
    return torch.cat([_here(c) for c in got], dim=axis)


def all_to_all(x: torch.Tensor, axis_name: Axes, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``x`` along ``split_axis`` into one tile a position, send tile
    j to position j, and concatenate what arrives along ``concat_axis`` in
    position order (tiled)."""
    me, n, got = _gather(axis_name, x)
    return torch.cat([_here(_chunk(c, split_axis, n, me)) for c in got], dim=concat_axis)


# ---------------------------------------------------------------------------
# splitting inputs and joining outputs
# ---------------------------------------------------------------------------

def _spec_blocks(mesh: Mesh, spec: PartitionSpec, ndim: int, coords):
    """Per dimension of an ``ndim`` array: (number of blocks, this
    position's block index) under ``spec`` (``coords`` None: the counts
    only, index 0)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec!r} has more entries than the array's {ndim} dims")
    out = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append((1, 0))
            continue
        dims = _dims(mesh, entry)
        n, idx = 1, 0
        for md in dims:
            n *= mesh.devices.shape[md]
            idx = idx * mesh.devices.shape[md] + (coords[md] if coords is not None else 0)
        out.append((n, idx))
    return out


def _used_dims(mesh: Mesh, spec: PartitionSpec) -> set:
    used = set()
    for entry in spec:
        if entry is not None:
            used.update(_dims(mesh, entry))
    return used


def _local_block(x: torch.Tensor, mesh: Mesh, spec: PartitionSpec, coords,
                 device: torch.device) -> torch.Tensor:
    """This position's block of ``x`` under ``spec``, copied onto
    ``device``, contiguous."""
    view = x
    for d, (n, idx) in enumerate(_spec_blocks(mesh, spec, x.dim(), coords)):
        if n > 1:
            view = _chunk(view, d, n, idx)
    out = torch.empty(view.shape, dtype=view.dtype, device=device)
    out.copy_(view)
    return out


def _join(outs: Dict[Tuple[int, ...], torch.Tensor], mesh: Mesh, spec: PartitionSpec,
          device: torch.device) -> torch.Tensor:
    """One tensor on ``device`` from the positions' outputs: each
    position that is at coordinate 0 on every mesh axis ``spec`` does not
    name places its block (the others hold replicas)."""
    used = _used_dims(mesh, spec)
    first = outs[next(iter(outs))]
    if not isinstance(first, torch.Tensor):
        return first
    counts = _spec_blocks(mesh, spec, first.dim(), None)
    full = [s * n for s, (n, _) in zip(first.shape, counts)]
    out = torch.empty(full, dtype=first.dtype, device=device)
    for coords, blk in outs.items():
        if any(c != 0 for d, c in enumerate(coords) if d not in used):
            continue
        view = out
        for d, (n, idx) in enumerate(_spec_blocks(mesh, spec, first.dim(), coords)):
            if n > 1:
                view = view.narrow(d, idx * blk.shape[d], blk.shape[d])
        if tuple(view.shape) != tuple(blk.shape):
            raise ValueError(f"shard_map: position {coords} returned {tuple(blk.shape)}, "
                             f"expected a {tuple(view.shape)} block")
        view.copy_(blk)
    return out


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, an array through numpy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs, *,
              timeout: float = DEFAULT_TIMEOUT) -> Callable:
    """``fn`` as an SPMD program over ``mesh``: returns a callable taking
    the global inputs.  ``in_specs``: one :class:`PartitionSpec` an input
    (or one for all); ``out_specs``: one for the output, or a tuple
    matching a tuple output."""
    def call(*args):
        specs = (in_specs,) * len(args) if isinstance(in_specs, PartitionSpec) \
            else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"shard_map: {len(args)} inputs, {len(specs)} in_specs")
        tensors = [as_tensor(a) for a in args]
        exch = _Exchange(timeout)
        coords_all = list(itertools.product(*(range(s) for s in mesh.devices.shape)))
        locals_ = {c: [_local_block(t, mesh, s, c, mesh.devices[c])
                       for t, s in zip(tensors, specs)] for c in coords_all}
        results: Dict[Tuple[int, ...], Any] = {}
        errors: List[Tuple[float, Tuple[int, ...], BaseException]] = []
        done = threading.Semaphore(0)

        def run(coords):
            pos = _Position(mesh, coords, exch)
            _local.pos = pos
            try:
                dev = pos.device
                ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
                with ctx:
                    results[coords] = fn(*locals_.pop(coords))
            except BaseException as e:  # surfaced on the calling thread
                errors.append((time.monotonic(), coords, e))
                exch.abort(coords, e)
            finally:
                _local.pos = None
                done.release()

        threads = [threading.Thread(target=run, args=(c,), daemon=True,
                                    name=f"shard_map-{'-'.join(map(str, c))}")
                   for c in coords_all]
        for t in threads:
            t.start()
        # every position ends (an aborted one at its next rendezvous); once
        # one failed, the rest get one timeout's grace before the call
        # raises without them
        finished, deadline = 0, None
        while finished < len(threads):
            if done.acquire(timeout=0.05):
                finished += 1
                continue
            if errors and deadline is None:
                deadline = time.monotonic() + timeout
            if deadline is not None and time.monotonic() > deadline:
                break
        if errors:
            roots = [e for e in errors if not isinstance(e[2], ShardMapAborted)]
            raise min(roots or errors, key=lambda e: e[0])[2]
        dev0 = mesh.devices.flat[0]
        first = results[coords_all[0]]
        if isinstance(first, tuple):
            ospecs = (out_specs,) * len(first) if isinstance(out_specs, PartitionSpec) \
                else tuple(out_specs)
            if len(ospecs) != len(first):
                raise ValueError(f"shard_map: {len(first)} outputs, {len(ospecs)} out_specs")
            return tuple(_join({c: r[i] for c, r in results.items()}, mesh, s, dev0)
                         for i, s in enumerate(ospecs))
        if not isinstance(out_specs, PartitionSpec):
            raise ValueError("shard_map: one output needs one PartitionSpec in out_specs")
        return _join(results, mesh, out_specs, dev0)

    return call

