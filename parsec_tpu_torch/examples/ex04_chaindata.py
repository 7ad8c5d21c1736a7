"""Ex04 — a chain that threads real data through an RW flow.

Reference analog: ``examples/Ex04_ChainData.jdf`` — each ``Task(k)``
reads flow ``A`` from its predecessor (or from the data collection for
``k == 0``), increments it, and forwards it; the final task writes it
back to memory.  This is the smallest example of the repo/data-resolution
machinery: intermediate flow data lives in the per-class usage-counted
repo, only the endpoints touch collection storage.
"""

import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG, INOUT


def main(device=None, *, nb: int = 10) -> dict:
    dc = LocalCollection("D", shape=(4,), init=lambda k: np.zeros(4))

    ptg = PTG("chaindata")
    step = ptg.task_class("step", k="0 .. NB-1")
    step.affinity("D(0)")
    step.flow("A", INOUT,
              "<- (k == 0) ? D(0) : A step(k-1)",
              "-> (k < NB-1) ? A step(k+1) : D(0)")
    step.body(cpu=lambda A, k: A.__iadd__(1.0))

    with Context(nb_cores=4, cuda_device=device) as ctx:
        tp = ptg.taskpool(NB=nb, D=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=15)

    final = dc.data_of(0).newest_copy().payload
    np.testing.assert_allclose(final, np.full(4, float(nb)))
    print(f"ex04: datum visited {nb} tasks, final value {final[0]:.0f}")
    return {"final": np.array(final)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
