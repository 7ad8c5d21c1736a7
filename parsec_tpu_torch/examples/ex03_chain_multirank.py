"""Ex03 — the chain distributed across ranks over the comm engine.

Reference analog: ``examples/Ex03_ChainMPI.jdf`` — same chain as Ex02,
but the data collection round-robins tiles over ranks, so every link of
the chain crosses the wire: task completion on rank r activates the
successor on rank r+1 through the remote-dep protocol (activation
message + payload transfer), exactly the reference's
``parsec_remote_dep_activate`` path.

Here the "ranks" are full runtime contexts talking through the
in-process fabric (the reference's analog is mpiexec-on-one-node), each
with its CUDA module on the one card; the same code runs over real
sockets, one process a rank, via ``parsec_tpu_torch.comm.tcp``.
"""

import sys
import threading

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.comm import InprocFabric
from parsec_tpu_torch.data import LocalCollection
from parsec_tpu_torch.dsl.ptg import PTG, INOUT


def main(device=None, *, nranks: int = 4, n: int = 12) -> dict:
    fabric = InprocFabric(nranks)
    ces = fabric.endpoints()
    ctxs = [Context(nb_cores=2, rank=r, nranks=nranks, comm=ces[r], cuda_device=device)
            for r in range(nranks)]
    ran = {r: [] for r in range(nranks)}
    oks = [False] * nranks
    errors = []

    def rank_main(rank: int) -> None:
        dc = LocalCollection("D", shape=(2,), nodes=nranks, myrank=rank,
                             init=lambda k: np.zeros(2))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks

        ptg = PTG("chainmpi")
        step = ptg.task_class("step", k="0 .. N-1")
        step.affinity("D(k)")  # task k runs on rank k % nranks
        step.flow("X", INOUT,
                  "<- (k == 0) ? D(0) : X step(k-1)",
                  "-> (k < N-1) ? X step(k+1) : D(k)")

        def body(X, k):
            ran[rank].append(k)
            X += 1.0

        step.body(cpu=body)
        tp = ptg.taskpool(N=n, D=dc)
        ctxs[rank].add_taskpool(tp)
        oks[rank] = tp.wait(timeout=60)

    def guarded(rank: int) -> None:
        try:
            rank_main(rank)
        except Exception as e:  # surface per-rank failures after join
            errors.append((rank, e))

    threads = [threading.Thread(target=guarded, args=(r,)) for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    acts = sum(ce.remote_dep.stats["activations_sent"] for ce in ces)
    for c in ctxs:
        c.fini()

    if errors:
        raise errors[0][1]
    assert all(oks), oks
    for r in range(nranks):
        assert ran[r] == list(range(r, n, nranks)), ran
    print(f"ex03: chain of {n} hopped across {nranks} ranks "
          f"({n - 1} remote activations)")
    return {"ran": ran, "activations": acts}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
