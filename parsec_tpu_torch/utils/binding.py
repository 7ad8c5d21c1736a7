"""Virtual-process maps.

Reference: ``parsec/vpmap.c`` (virtual processes partitioning cores into
locality domains).  The port carries only the flat map the context needs:
every worker in one virtual process.  The ``nb:<k>``/explicit maps and
per-thread core binding of :mod:`parsec_tpu.utils.binding` are not
ported yet (ROADMAP A.11).
"""

from __future__ import annotations

from typing import List


class VPMap:
    """Partition of worker ids into virtual processes (locality domains)."""

    def __init__(self, assignments: List[List[int]]):
        self.vps = assignments

    @classmethod
    def flat(cls, nb_workers: int) -> "VPMap":
        return cls([list(range(nb_workers))])

    def nb_vps(self) -> int:
        return len(self.vps)

    def vp_of(self, worker_id: int) -> int:
        for v, members in enumerate(self.vps):
            if worker_id in members:
                return v
        return 0
