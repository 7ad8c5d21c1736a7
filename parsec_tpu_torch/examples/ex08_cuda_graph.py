"""Ex08 — whole-DAG capture: the card's native execution mode.

No reference analog — this is where the framework goes beyond the
reference (the port of the JAX package's ``ex08_tpu_graph.py``).  For
regular DAGs (dense linear algebra, stencils) per-task dispatch is wasted
motion on a GPU: :class:`~parsec_tpu_torch.dsl.GraphExecutor` captures the
PTG taskpool's entire tile DAG, runs every task body (a torch function)
once to warm up, records the whole plan as ONE ``torch.cuda.CUDAGraph``
and replays it.  Dispatch cost: one graph launch for the whole
factorization.  On the torch CPU device (``device="cpu"``) the same plan
runs eagerly.

The dynamic scheduler path (ex01-ex07) remains the tool for irregular /
data-dependent DAGs; this is the fast path for algebraic ones.
"""

import sys

import numpy as np
import torch

from parsec_tpu_torch.datadist import TiledMatrix
from parsec_tpu_torch.dsl import GraphExecutor
from parsec_tpu_torch.ops import cholesky_ptg


def spd(n: int, dtype=np.float32) -> np.ndarray:
    """M M^T + n I from ``default_rng(0)``: the JAX examples' SPD input."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((n, n)).astype(dtype)
    return (m @ m.T + n * np.eye(n, dtype=dtype)).astype(dtype)


def factor_graph(A, device, **ptg_kw):
    """dpotrf of TiledMatrix ``A`` through one GraphExecutor call (every
    task a CUDA chore); returns the executor and the host factor
    (``A.to_array()``, lower triangle L)."""
    tp = cholesky_ptg(use_cuda=True, use_cpu=False, **ptg_kw).taskpool(NT=A.mt, A=A)
    ex = GraphExecutor(tp, device=device)  # captures the DAG, plans the graph
    ex()                                   # the whole factorization, one replay
    return ex, A.to_array()


def recon_err(factor: np.ndarray, S: np.ndarray, dev) -> float:
    """max |L L^T - S|, in float64 on ``dev``."""
    L = torch.from_numpy(factor).to(dev).double().tril()
    return (L @ L.mT - torch.from_numpy(S).to(dev).double()).abs().max().item()


def main(device=None, *, n: int = 256, nb: int = 64, S=None) -> dict:
    S = spd(n) if S is None else S
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    ex, factor = factor_graph(A, device)
    err = recon_err(factor, S, ex.device)
    assert err <= 2e-2 * n, err
    ntasks = len(ex.graph.nodes)
    how = "CUDA graph" if ex.device.type == "cuda" else "captured plan"
    print(f"ex08: {ntasks}-task dpotrf DAG ran as one {how}")
    return {"factor": factor, "tasks": ntasks, "max_abs_err": err,
            "replay_launches": dict(ex.launches)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
