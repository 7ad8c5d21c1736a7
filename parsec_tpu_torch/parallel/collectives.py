"""Collective-communication building blocks over mesh axes.

The port of :mod:`parsec_tpu.parallel.collectives`.  The reference
runtime's dependency broadcasts travel down host-chosen topology trees —
star, chain-pipeline, binomial — re-rooted at the sender (MCA
``runtime_comm_coll_bcast``).  These helpers express the same three
topologies as rounds of :func:`~.shard_map.ppermute`, plus thin wrappers
over the standard collectives.

All functions are meant to be called *inside* a
:func:`~.shard_map.shard_map`-ed function with the named axis in scope.
An axis index is a Python int here (a traced scalar in the reference).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import mca_param
from .shard_map import all_gather, axis_index, ppermute, psum, psum_scatter
from .shard_map import axis_size as _axis_size


def axis_size(axis: str) -> int:
    return _axis_size(axis)


def my_index(axis: str) -> int:
    return axis_index(axis)


def shift(x, axis: str, offset: int = 1):
    """Ring rotation by ``offset`` along a mesh axis (a neighbour hop)."""
    n = axis_size(axis)
    perm = [(i, (i + offset) % n) for i in range(n)]
    return ppermute(x, axis, perm)


def bcast_star(x, axis: str, root: int = 0):
    """Star broadcast: root reaches everyone in one logical round (the
    reference's default flat topology).  The one-to-all round is a masked
    psum, as in the reference."""
    contrib = x if my_index(axis) == root else torch.zeros_like(x)
    return psum(contrib, axis)


def bcast_chain(x, axis: str, root: int = 0):
    """Chain-pipeline broadcast: n-1 neighbour hops; each round forwards to
    the next rank (reference chain topology, best for large payloads on a
    ring interconnect)."""
    n = axis_size(axis)
    cur = x
    for r in range(n - 1):
        src = (root + r) % n
        dst = (root + r + 1) % n
        recv = ppermute(cur, axis, [(src, dst)])
        cur = recv if my_index(axis) == dst else cur
    return cur


def bcast_binomial(x, axis: str, root: int = 0):
    """Binomial-tree broadcast: ceil(log2 n) rounds, round r has the first
    2^r holders forward to holders 2^r..2^(r+1)-1 (reference binomial
    topology, latency-optimal for small activation messages)."""
    n = axis_size(axis)
    rounds = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    cur = x
    for r in range(rounds):
        span = 1 << r
        perm = []
        for i in range(span):
            j = i + span
            if j < n:
                perm.append(((root + i) % n, (root + j) % n))
        if not perm:
            break
        recv = ppermute(cur, axis, perm)
        idx = (my_index(axis) - root) % n
        cur = recv if span <= idx < 2 * span else cur
    return cur


def bcast(x, axis: str, root: int = 0, topology: Optional[str] = None):
    """Topology-selectable broadcast (MCA ``runtime_comm_coll_bcast``:
    ``star``, ``chain`` or ``binomial``)."""
    topo = topology or mca_param.register(
        "runtime", "comm_coll_bcast", "binomial",
        help="broadcast topology of the parallel layer: star|chain|binomial")
    fn = {"star": bcast_star, "chain": bcast_chain, "binomial": bcast_binomial}[topo]
    return fn(x, axis, root)


# thin standard wrappers (named for discoverability next to the trees)

def allreduce_sum(x, axis: str):
    return psum(x, axis)


def reduce_scatter_sum(x, axis: str, tiled_axis: int = 0):
    return psum_scatter(x, axis, scatter_dimension=tiled_axis)


def allgather(x, axis: str, tiled_axis: int = 0):
    return all_gather(x, axis, axis=tiled_axis)
