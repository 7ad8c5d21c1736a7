"""Device meshes: the (p, q) grid of positions an SPMD program runs on.

The port of :mod:`parsec_tpu.parallel.mesh`.  A :class:`Mesh` is a 2D
object array of ``torch.device``s with an axis name per dimension; its
``(p, q)`` axes align with the 2D block-cyclic process grids of the
collections layer (``datadist.TwoDimBlockCyclic(p=..., q=...)``), as the
reference's do.  :func:`~.shard_map.shard_map` runs one thread a position,
each on its own device.

A device may appear more than once: ``make_mesh((4, 1), devices=["cuda:0"]
* 4)`` puts four positions on one card (the reference's ``jax.sharding.Mesh``
refuses duplicates; ROADMAP C).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """How an array's dimensions map onto mesh axes: one entry a leading
    dimension, each ``None`` (not split), an axis name, or a tuple of axis
    names (split over their product, row-major); trailing dimensions
    without an entry are not split.  ``P()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


class Mesh:
    """``devices``: a 2D object array of ``torch.device``; ``axis_names``:
    one name a dimension; ``shape``: axis name -> size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dimensions needs as many axis "
                             f"names, got {tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def best_grid(n: int) -> Tuple[int, int]:
    """Most-square (p, q) factorization of n, p <= q."""
    p = int(np.sqrt(n))
    while n % p:
        p -= 1
    return p, n // p


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    *,
    axes: Tuple[str, str] = ("p", "q"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D mesh (most-square by default) over ``devices`` (torch
    devices or their names; one may repeat), by default the host's CUDA
    cards.  A host without one raises: pass ``devices=["cpu"] * n`` for
    CPU positions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: this host has no CUDA device; pass "
                               "devices= (e.g. ['cpu'] * 8) for CPU positions")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if shape is None:
        shape = best_grid(len(devs))
    p, q = shape
    if p * q > len(devs):
        raise ValueError(f"mesh {shape} needs {p*q} devices, have {len(devs)}")
    arr = np.empty(p * q, dtype=object)
    arr[:] = devs[: p * q]
    return Mesh(arr.reshape(p, q), axes)


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a 2D array in blocks over the (p, q) mesh axes."""
    return NamedSharding(mesh, P(*mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
