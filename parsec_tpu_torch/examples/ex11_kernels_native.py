"""Ex11 — hand-written CUDA chores and the native execution engine.

Two ways this framework exceeds per-task Python dispatch (the port of the
JAX package's ``ex11_pallas_native.py``):

1. **Kernel chores** — the hot BODYs (dpotrf's syrk/gemm updates) as the
   hand-written Hopper kernel ``matmul_update`` (B1,
   ``parsec_tpu_torch/csrc/matmul.cu`` through ``ops.kernels``), the
   reference's CUDA BODY incarnations (``tests/runtime/cuda/nvlink.jdf``).
   Swapped in with ``cholesky_ptg(use_kernels=True)`` and run here under
   whole-DAG capture (:class:`~parsec_tpu_torch.dsl.GraphExecutor`): on
   the card every update is one B1 launch inside the captured graph; on
   the torch CPU device the wrapper runs its plain version.

2. **Native engine** — for dispatch-bound DAGs (many tiny CPU tasks),
   ``run_native`` executes the captured DAG on the C++ core: dependency
   counting, priority scheduling and worker threads stay native, Python
   is entered once per BODY (the reference's native-runtime /
   generated-bodies split, ``scheduling.c`` + ``mca/sched``).  The engine
   is built by g++ on first use; a missing toolchain raises.
"""

import sys
import time

import numpy as np

from parsec_tpu_torch.datadist import TiledMatrix
from parsec_tpu_torch.dsl.native_exec import run_native
from parsec_tpu_torch.examples.ex08_cuda_graph import factor_graph, recon_err, spd
from parsec_tpu_torch.ops import cholesky_ptg


def main(device=None, *, n: int = 256, nb: int = 64, S=None, use_kernels: bool = True,
         native: bool = True, native_nb: int = 32) -> dict:
    S = spd(n) if S is None else S

    # 1. kernel chores through the whole-DAG capture path
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    ex, factor = factor_graph(A, device, use_kernels=use_kernels)
    err = recon_err(factor, S, ex.device) / float(np.abs(S).max())
    chore = "kernel" if use_kernels else "library"
    print(f"{chore}-chored dpotrf: {len(ex.taskpool.ptg.classes)} task classes, "
          f"rel err {err:.2e}")
    assert err < 1e-4
    out = {"factor": factor, "rel_err": err, "tasks": len(ex.graph.nodes),
           "replay_launches": dict(ex.launches)}
    if not native:
        return out

    # 2. native engine on a dispatch-bound DAG (CPU bodies)
    S2 = spd(n, np.float64)
    A2 = TiledMatrix(n, n, native_nb, native_nb, name="A", dtype=np.float64).from_array(S2)
    tp2 = cholesky_ptg(use_cuda=False).taskpool(NT=A2.mt, A=A2)
    t0 = time.perf_counter()
    ntasks = run_native(tp2, nthreads=4)
    dt = time.perf_counter() - t0
    L2 = np.tril(A2.to_array())
    assert np.allclose(L2 @ L2.T, S2, rtol=1e-8, atol=1e-8)
    print(f"native engine: {ntasks} tasks in {dt*1e3:.1f} ms "
          f"({ntasks/max(dt,1e-9):.0f} tasks/s)")
    out.update(native_tasks=ntasks, native_factor=L2, native_s=dt)
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
