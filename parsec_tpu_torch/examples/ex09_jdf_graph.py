"""Ex09 — a .jdf program end to end: runtime compile, dynamic execution,
AND whole-DAG capture of the same source.

The stencil JDF (``jdf/stencil_1d.jdf`` beside this file, the reference's
``tests/apps/stencil/stencil_1D.jdf`` shape) carries two BODY
incarnations: a CPU one (in-place numpy) and a functional
``type = CUDA`` one on torch tensors.  The dynamic runtime schedules tasks
one by one on host bodies; :class:`~parsec_tpu_torch.dsl.GraphExecutor`
runs the same taskpool's entire DAG through the CUDA bodies as ONE
captured CUDA graph on the card.  Both paths must agree.
"""

import os
import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import LocalCollection, host_array
from parsec_tpu_torch.dsl import GraphExecutor, compile_jdf_file

JDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jdf", "stencil_1d.jdf")


def _collections(nt: int, w: int):
    init = {n: np.linspace(0, 1, w) + n for n in range(nt)}
    return LocalCollection(
        "descA", shape=(w,),
        init=lambda k: init[k[1]].copy() if k[0] == 0 else np.zeros(w))


def main(device=None, *, nt: int = 4, iters: int = 5, w: int = 32) -> dict:
    jdf = compile_jdf_file(JDF)

    # 1) dynamic runtime (CPU bodies, task-by-task scheduling)
    dc_dyn = _collections(nt, w)
    with Context(nb_cores=4, devices=["cpu"]) as ctx:
        tp = jdf.new(descA=dc_dyn, NT=nt, ITER=iters)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)

    # 2) whole-DAG capture (CUDA bodies, one captured graph)
    dc_cap = _collections(nt, w)
    tp2 = jdf.new(descA=dc_cap, NT=nt, ITER=iters)
    ex = GraphExecutor(tp2, device=device)
    ex(write_back=True, block=True)

    worst = 0.0
    rows = []
    for n in range(nt):
        a = dc_dyn.data_of(iters % 2, n).newest_copy().payload
        b = host_array(dc_cap.data_of(iters % 2, n).newest_copy().payload)
        rows.append(np.array(b))
        worst = max(worst, float(np.max(np.abs(a - b))))
    assert worst < 1e-6, worst
    print(f"ex09 jdf+graph: dynamic and captured runs agree "
          f"(NT={nt}, ITER={iters}, max|diff|={worst:.2e}): OK")
    return {"captured": np.stack(rows), "max_abs_diff": worst,
            "tasks": len(ex.graph.nodes)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
