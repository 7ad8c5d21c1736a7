"""Staging-pipeline depth 1 against depth 2 through the native pump, on a GPU.

Runs dpotrf ``kernels`` (N=8192, nb=512, float32) and the stencil (8192^2
float32 in 1024^2 tiles, 20 steps) through
``NativeExecutor(tp, native_device=True)`` at ``runtime_stage_depth`` 1 and 2
in turns (1, 2, 2, 1, 1, 2, ...), after one unmeasured run at each depth, and
prints for each path and each torch intra-op thread count the median wall
(``ex.run()`` + synchronize) of each depth, their ratio, the median of the
pump's dispatch seconds (``submit_s``) at each depth and of the lane's
prestage seconds at depth 2.

``--per-run`` runs the stencil alone at depths 1, 2, 2, 1, 2, 1 and prints
each run's wall and ``close()`` seconds, the pump's clocks and, by method,
the seconds and calls the device module spent in its staging methods.

Usage (one card)::

    python3 stage_depth_diag.py --threads 8,1,8,1 --runs 5
    python3 stage_depth_diag.py --per-run
"""

from __future__ import annotations

import argparse
import collections
import functools
import gc
import statistics
import sys
import threading
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", default="8,8",
                    help="torch intra-op thread counts, one measured set each")
    ap.add_argument("--runs", type=int, default=6, help="measured runs a depth")
    ap.add_argument("--per-run", action="store_true",
                    help="the stencil's runs one by one, staging methods timed")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("stage_depth_diag: needs a GPU", file=sys.stderr)
        return 2
    from parsec_tpu_torch import mca_param
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.device import cuda as cuda_mod
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg, kernels, stencil

    kernels.build()
    rng = np.random.default_rng(0)
    m = rng.standard_normal((8192, 8192)).astype(np.float32)
    spd = (m @ m.T) / 8192 + np.eye(8192, dtype=np.float32) * 2
    grid = rng.standard_normal((8192, 8192)).astype(np.float32)

    def run(tp, depth):
        ex = NativeExecutor(tp, native_device=True)
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats, dev_stats = dict(ex.stats), dict(ex.device.stats)
        t0 = time.perf_counter()
        ex.close()
        return wall, time.perf_counter() - t0, stats, dev_stats

    def dpotrf(depth):
        mca_param.set_param("runtime", "stage_depth", depth)
        A = TiledMatrix(8192, 8192, 512, 512, name="A", dtype=np.float32).from_array(spd)
        return run(cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True)
                   .taskpool(NT=A.mt, A=A), depth)

    def stencil_pump(depth):
        mca_param.set_param("runtime", "stage_depth", depth)
        A = stencil.StencilBuffers(grid, 8, 8)
        return run(stencil.stencil_ptg(use_kernels=True, use_cpu=False)
                   .taskpool(T=20, MT=8, NT=8, A=A), depth)

    if args.per_run:
        seconds = collections.defaultdict(float)
        calls = collections.defaultdict(int)

        def timed(owner, name):
            fn = getattr(owner, name)

            @functools.wraps(fn)
            def wrapper(*a, **k):
                key = f"{name}@{threading.current_thread().name[:5]}"
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    seconds[key] += time.perf_counter() - t0
                    calls[key] += 1

            setattr(owner, name, wrapper)

        for name in ("_stage_in_batch", "_h2d_batch", "_d2h_batch", "_stage_plan",
                     "prestage_bytes", "submit_batch"):
            timed(cuda_mod.CudaDevice, name)
        timed(cuda_mod._PinnedRing, "get")
        timed(cuda_mod, "_pinned_empty")
        for depth in (1, 2, 2, 1, 2, 1):
            seconds.clear()
            calls.clear()
            wall, close, stats, _dev = stencil_pump(depth)
            print("depth", depth, "wall", round(wall, 4), "close", round(close, 4),
                  {k: round(v, 4) for k, v in stats.items() if isinstance(v, float)},
                  flush=True)
            print("   ", {k: (round(seconds[k], 4), calls[k]) for k in sorted(seconds)},
                  flush=True)
        return 0

    order = [d for i in range(args.runs) for d in ((1, 2) if i % 2 == 0 else (2, 1))]
    for threads in (int(t) for t in args.threads.split(",")):
        torch.set_num_threads(threads)
        for fn in (dpotrf, stencil_pump):
            fn(1)
            fn(2)
            res = {1: [], 2: []}
            for depth in order:
                wall, _close, stats, dev_stats = fn(depth)
                res[depth].append((wall, stats["submit_s"], dev_stats["prestage_s"]))
            med = {d: statistics.median(r[0] for r in res[d]) for d in res}
            print(fn.__name__, "threads", torch.get_num_threads(),
                  "median1", round(med[1], 4), "median2", round(med[2], 4),
                  "ratio", round(med[2] / med[1], 3),
                  "submit1", round(statistics.median(r[1] for r in res[1]), 4),
                  "submit2", round(statistics.median(r[1] for r in res[2]), 4),
                  "prestage2", round(statistics.median(r[2] for r in res[2]), 4),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
