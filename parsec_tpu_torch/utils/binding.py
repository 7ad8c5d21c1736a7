"""Thread-to-core binding and virtual-process maps.

Reference: ``parsec/parsec_hwloc.c`` + ``bindthread.c`` (topology discovery
and per-thread core pinning) and ``vpmap.c`` (virtual processes
partitioning cores into locality domains — NUMA in the reference).  The
port of :mod:`parsec_tpu.utils.binding`: hwloc is replaced by
``os.sched_getaffinity``/``sched_setaffinity`` (Linux); elsewhere binding
is a logged no-op.  :class:`~parsec_tpu_torch.core.context.Context` reads
``runtime_vpmap``/``runtime_bind_threads``, and the native engine's steal
path takes the same map (``NativeGraph.set_vpmap``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from . import debug, mca_param


def available_cores() -> List[int]:
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover (non-Linux)
        return list(range(os.cpu_count() or 1))


def bind_current_thread(core: int) -> bool:
    """Pin the calling thread to one core (reference parsec_bindthread)."""
    try:
        os.sched_setaffinity(0, {core})
        return True
    except (AttributeError, OSError) as e:
        debug.verbose(4, "core", "bind to core %d failed: %s", core, e)
        return False


class VPMap:
    """Partition of worker ids into virtual processes (locality domains).

    Construction mirrors the reference's init modes (``parsec.c:548-583``):
    ``flat`` (one VP over all cores), ``nb`` (round-robin into N VPs), or an
    explicit per-VP core list.
    """

    def __init__(self, assignments: List[List[int]]):
        self.vps = assignments

    @classmethod
    def flat(cls, nb_workers: int) -> "VPMap":
        return cls([list(range(nb_workers))])

    @classmethod
    def from_nb_vps(cls, nb_workers: int, nb_vps: int) -> "VPMap":
        vps: List[List[int]] = [[] for _ in range(nb_vps)]
        for w in range(nb_workers):
            vps[w % nb_vps].append(w)
        return cls(vps)

    @classmethod
    def from_spec(cls, spec: str) -> "VPMap":
        """``"0,1;2,3"`` → two VPs with workers [0,1] and [2,3]."""
        return cls([[int(x) for x in part.split(",") if x] for part in spec.split(";") if part])

    @classmethod
    def from_param(cls, nb_workers: int) -> "VPMap":
        """The map ``runtime_vpmap`` asks for over ``nb_workers`` workers:
        ``flat``, ``nb:<k>`` or an explicit ``'0,1;2,3'`` (the reference's
        init modes, ``parsec.c:548-583``).  An invalid spec raises
        ValueError naming it: a silently flat run would pass for a
        hierarchical one."""
        spec = str(mca_param.register(
            "runtime", "vpmap", "flat",
            help="vp map: flat | nb:<k> | explicit '0,1;2,3' worker lists"))
        try:
            if spec.startswith("nb:"):
                k = int(spec[3:])
                if k < 1:
                    raise ValueError("vp count must be >= 1")
                return cls.from_nb_vps(nb_workers, k)
            if ";" in spec or "," in spec:
                return cls.from_spec(spec)
        except ValueError as e:
            raise ValueError(f"invalid runtime_vpmap {spec!r}: {e}") from None
        return cls.flat(nb_workers)

    def nb_vps(self) -> int:
        return len(self.vps)

    def vp_of(self, worker_id: int) -> int:
        for v, members in enumerate(self.vps):
            if worker_id in members:
                return v
        return 0

    def core_for(self, worker_id: int, cores: Optional[Sequence[int]] = None) -> int:
        """Pick a core honouring the VP partition: the core set is split
        into contiguous blocks, one per VP (the reference pins a VP's
        threads inside one NUMA domain), and a worker round-robins within
        its VP's block."""
        cores = list(cores) if cores is not None else available_cores()
        nv = self.nb_vps()
        if nv <= 1 or len(cores) < nv:
            return cores[worker_id % len(cores)]
        block = len(cores) // nv
        v = self.vp_of(worker_id)
        pool = cores[v * block:(v + 1) * block] or cores
        members = self.vps[v]
        idx = members.index(worker_id) if worker_id in members else worker_id
        return pool[idx % len(pool)]
