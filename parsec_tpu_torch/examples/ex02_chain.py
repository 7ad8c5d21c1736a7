"""Ex02 — a chain of sequentially dependent tasks.

Reference analog: ``examples/Ex02_Chain.jdf`` — tasks ``Task(k)`` for
``k = 0 .. NB-1`` where each task depends on its predecessor through a
control flow: no data moves, only ordering.  Output dep guards
(``(k < NB-1) ?``) cut the chain at the last task.
"""

import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG


def main(device=None, *, nb: int = 12) -> dict:
    log = []
    dc = LocalCollection("T", shape=(1,), init=lambda k: np.zeros(1))

    ptg = PTG("chain")
    step = ptg.task_class("step", k="0 .. NB-1")
    step.affinity("T(k)")
    # pure-control chain: <- from predecessor, -> to successor, guarded
    step.ctl("c",
             "<- (k > 0) ? c step(k-1)",
             "-> (k < NB-1) ? c step(k+1)")
    step.body(cpu=lambda k: log.append(k))

    with Context(nb_cores=4, cuda_device=device) as ctx:
        tp = ptg.taskpool(NB=nb, T=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=15)

    # despite 4 workers, control deps force strict sequential order
    assert log == list(range(nb)), log
    print(f"ex02: {nb} chained tasks ran in order on 4 workers")
    return {"order": log}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
