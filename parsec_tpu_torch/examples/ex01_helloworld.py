"""Ex01 — hello world: one PTG task class, one task.

Reference analog: ``examples/Ex01_HelloWorld.jdf`` — a task class with a
single-point execution space ``k = 0 .. 0``, placed by affinity onto a
data collection.  A task class always carries (1) an execution space,
(2) a placement/affinity, (3) at least one flow; a pure side-effect task
uses a CTL-style empty flow set, exactly like the reference's
``HelloWorld(k)`` with no real data.
"""

import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG


def main(device=None) -> dict:
    said = []
    dc = LocalCollection("world", shape=(1,), init=lambda k: np.zeros(1))

    ptg = PTG("hello")
    hello = ptg.task_class("hello", k="0 .. 0")  # one-point space
    hello.affinity("world(k)")                   # owner-computes placement
    hello.body(cpu=lambda k: said.append(f"Hello world (k={k})"))

    with Context(nb_cores=2, cuda_device=device) as ctx:
        tp = ptg.taskpool(world=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=10)

    assert said == ["Hello world (k=0)"], said
    print("ex01:", said[0])
    return {"said": said}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
