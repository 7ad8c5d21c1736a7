"""Ex06 — the read-after-write (anti-dependency) problem, demonstrated.

Reference analog: ``examples/Ex06_RAW.jdf`` — a producer broadcasts its
flow both to a set of readers AND to an updater that overwrites it
in place.  Nothing orders the updater relative to the readers, so this
DAG is intentionally *racy*: a reader may observe the broadcast value or
the updated one depending on scheduling — the classic anti-dependency
hazard the reference tutorial stages on purpose.  ``ex07_raw_ctl`` shows
the cure: CTL flows that order the updater after every reader.
"""

import sys
import threading

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG, IN, INOUT

BCAST_VAL, UPDATED_VAL = 10.0, 1000.0


def main(device=None, *, nb: int = 8) -> dict:
    seen = []
    lock = threading.Lock()
    dc = LocalCollection("D", shape=(2,), init=lambda k: np.full(2, 1.0))

    ptg = PTG("raw")
    bcast = ptg.task_class("bcast")
    bcast.affinity("D(0)")
    bcast.flow("A", INOUT,
               "<- D(0)",
               "-> A update()",
               "-> A recv(0 .. NB-1)")
    bcast.body(cpu=lambda A: A.__imul__(BCAST_VAL))

    # updater overwrites the flow in place and commits it to memory —
    # with no ordering against the readers this is an anti-dependency race
    update = ptg.task_class("update")
    update.affinity("D(0)")
    update.flow("A", INOUT, "<- A bcast()", "-> D(0)")
    update.priority("100")  # runs early
    update.body(cpu=lambda A: A.__iadd__(UPDATED_VAL - BCAST_VAL))

    recv = ptg.task_class("recv", k="0 .. NB-1")
    recv.affinity("D(0)")
    recv.flow("A", IN, "<- A bcast()")

    def recv_body(A, k):
        with lock:
            seen.append(float(A[0]))

    recv.body(cpu=recv_body)

    with Context(nb_cores=4, cuda_device=device) as ctx:
        tp = ptg.taskpool(NB=nb, D=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=15)

    # the DAG completes, but WHAT each reader saw is schedule-dependent
    assert all(v in (BCAST_VAL, UPDATED_VAL) for v in seen), seen
    final = np.array(dc.data_of(0).newest_copy().payload)
    np.testing.assert_allclose(final, UPDATED_VAL)
    racy = sum(1 for v in seen if v == UPDATED_VAL)
    print(f"ex06: anti-dependency race staged — {racy}/{nb} readers observed "
          f"the updater's value (see ex07 for the CTL fix)")
    return {"seen": seen, "racy": racy, "final": final}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
