"""Ex05 — broadcast: one producer, many consumers via an output range.

Reference analog: ``examples/Ex05_Broadcast.jdf`` — a root task emits
its flow to ``Task(0 .. NB-1)`` in one output dependency; the runtime
expands the range into a multicast (and, multi-rank, routes it down a
broadcast topology — star/chain/binomial).  Consumers each get the same
payload version.
"""

import sys
import threading

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG, IN, INOUT


def main(device=None, *, nb: int = 16) -> dict:
    got = []
    lock = threading.Lock()
    dc = LocalCollection("D", shape=(4,), init=lambda k: np.full(4, 2.0))

    ptg = PTG("broadcast")
    root = ptg.task_class("root")
    root.affinity("D(0)")
    root.flow("A", INOUT, "<- D(0)", "-> A leaf(0 .. NB-1)")  # range = bcast
    root.body(cpu=lambda A: A.__imul__(21.0))  # 2 * 21 = 42

    leaf = ptg.task_class("leaf", k="0 .. NB-1")
    leaf.affinity("D(0)")
    leaf.flow("A", IN, "<- A root()")

    def leaf_body(A, k):
        with lock:
            got.append((k, float(A[0])))

    leaf.body(cpu=leaf_body)

    with Context(nb_cores=4, cuda_device=device) as ctx:
        tp = ptg.taskpool(NB=nb, D=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=15)

    assert sorted(k for k, _ in got) == list(range(nb))
    assert all(v == 42.0 for _, v in got), got
    print(f"ex05: root broadcast one tile to {nb} consumers")
    return {"got": sorted(got)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
