"""``rnd`` — random-order global queue (reference ``mca/sched/rnd/
sched_rnd_module.c:107``): inserts at random positions; a scheduler-
robustness fuzzer more than a production policy.

MCA param ``sched_rnd_seed`` (env ``PARSEC_MCA_sched_rnd_seed``): any
value >= 0 seeds the scheduler's own ``random.Random`` at install (the
global generator is never used), so a schedule replays deterministically;
the default (-1) stays unseeded — fresh entropy per install, the fuzzing
behavior.  The native pump reads the same parameter
(:mod:`parsec_tpu_torch.dsl.native_exec`).
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from ...utils import mca_param, register_component
from .base import Scheduler


@register_component("sched")
class SchedRND(Scheduler):
    mca_name = "rnd"
    mca_priority = 1

    def install(self, context) -> None:
        super().install(context)
        self._items: list = []
        self._lock = threading.Lock()
        seed = int(mca_param.register(
            "sched", "rnd_seed", -1,
            help="seed for the rnd scheduler's RNG (>=0 replays one "
                 "schedule deterministically — the schedule explorer's "
                 "replay hook; -1 = unseeded fuzzing)"))
        self.seed: Optional[int] = None if seed < 0 else seed
        self._rng = random.Random(self.seed)  # Random(None) = fresh entropy

    def schedule(self, es, tasks, distance: int = 0) -> None:
        with self._lock:
            for t in tasks:
                pos = self._rng.randint(0, len(self._items))
                self._items.insert(pos, t)

    def select(self, es) -> Optional["object"]:
        with self._lock:
            if self._items:
                return self._items.pop()
        return None

    def pending_estimate(self) -> int:
        return len(self._items)
