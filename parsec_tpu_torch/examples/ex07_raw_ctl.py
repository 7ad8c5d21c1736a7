"""Ex07 — resolving read-after-write hazards with explicit CTL flows.

Reference analog: ``examples/Ex07_RAW_CTL.jdf`` — same dataflow as Ex06,
but instead of relying on versioned copies, CTL dependencies *order* the
updater after every reader: each ``recv(k)`` emits a control token the
updater gathers (a control-gather over the range), so the update is
guaranteed to run last.  CTL flows carry no data — only ordering.
"""

import sys
import threading
import time

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG, IN, INOUT


def main(device=None, *, nb: int = 8) -> dict:
    order = []
    lock = threading.Lock()
    dc = LocalCollection("D", shape=(2,), init=lambda k: np.full(2, 1.0))

    ptg = PTG("rawctl")
    bcast = ptg.task_class("bcast")
    bcast.affinity("D(0)")
    bcast.flow("A", INOUT,
               "<- D(0)",
               "-> A update()",
               "-> A recv(0 .. NB-1)")
    bcast.body(cpu=lambda A: A.__imul__(10.0))

    recv = ptg.task_class("recv", k="0 .. NB-1")
    recv.affinity("D(0)")
    recv.flow("A", IN, "<- A bcast()")
    recv.ctl("done", "-> c update()")  # token: "I have read"

    def recv_body(A, k):
        time.sleep(0.001)  # make readers slow — update must still wait
        with lock:
            order.append("recv")

    recv.body(cpu=recv_body)

    update = ptg.task_class("update")
    update.affinity("D(0)")
    update.flow("A", INOUT, "<- A bcast()", "-> D(0)")
    update.ctl("c", "<- done recv(0 .. NB-1)")  # control-gather: wait for all

    def update_body(A):
        with lock:
            order.append("update")
        A += 990.0

    update.priority("100")  # high prio, still ordered by the CTL gather
    update.body(cpu=update_body)

    with Context(nb_cores=4, cuda_device=device) as ctx:
        tp = ptg.taskpool(NB=nb, D=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=15)

    assert order == ["recv"] * nb + ["update"], order
    final = np.array(dc.data_of(0).newest_copy().payload)
    np.testing.assert_allclose(final, 1000.0)
    print(f"ex07: CTL gather forced the updater after all {nb} readers")
    return {"order": order, "final": final}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
