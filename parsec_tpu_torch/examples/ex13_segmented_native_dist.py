"""Segmented factorizations through the runtime, and the distributed
native engine.

Part 1 runs the panel-segmented Cholesky/QR/LU through taskpool +
scheduler + the CUDA device module (one task a panel segment over an
in-place device matrix — the compile-scales-with-panels law of
``ops/segmented_*.py``).

Part 2 factorizes a block-cyclic matrix on 2 in-process ranks where each
rank's partition executes on the C++ native engine and cross-rank
dependencies ride the activation wire (``dsl/native_dist.py``).  The
engine is built by g++ on first use; a missing toolchain raises.

Run:  python -m parsec_tpu_torch.examples.ex13_segmented_native_dist [--cpu]
"""

import sys
import threading

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.comm import InprocFabric
from parsec_tpu_torch.datadist import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.native_dist import NativeDistExecutor
from parsec_tpu_torch.ops import SegmentedCholesky, SegmentedLU, SegmentedQR, cholesky_ptg


def part1_segmented(device=None, n: int = 512, nb: int = 128, strip: int = 256) -> dict:
    rng = np.random.default_rng(1)
    M = rng.standard_normal((n, n)).astype(np.float32)
    SPD = M @ M.T + n * np.eye(n, dtype=np.float32)

    with Context(nb_cores=2, cuda_device=device) as ctx:
        L = SegmentedCholesky(ctx, n, nb, strip=strip)(SPD)
        err = np.abs(L @ L.T - SPD).max() / np.abs(SPD).max()
        assert err < 1e-3, err
        print(f"segmented cholesky: rel err {err:.2e}")

        Q, R = SegmentedQR(ctx, n, nb, strip=strip)(M)
        rec = np.abs(Q @ R - M).max() / np.abs(M).max()
        orth = np.abs(Q.T @ Q - np.eye(n)).max()
        assert rec < 1e-3 and orth < 1e-3, (rec, orth)
        print(f"segmented QR (BCGS+CQR2): rec {rec:.2e}, orth {orth:.2e}")

        Ldd, U = SegmentedLU(ctx, n, nb, strip=strip)(SPD)  # dd input
        lu_err = np.abs(Ldd @ U - SPD).max() / np.abs(SPD).max()
        assert lu_err < 1e-3, lu_err
        print(f"segmented LU: rel err {lu_err:.2e}")
    return {"chol_err": err, "qr_rec": rec, "qr_orth": orth, "lu_err": lu_err}


def part2_native_dist(nranks: int = 2, n: int = 128, nb: int = 16) -> dict:
    rng = np.random.default_rng(2)
    M = rng.standard_normal((n, n))
    SPD = M @ M.T + n * np.eye(n)
    fabric = InprocFabric(nranks)
    ces = fabric.endpoints()
    mats, counts, errors = {}, {}, []

    def worker(r):
        try:
            A = TwoDimBlockCyclic(n, n, nb, nb, p=1, q=nranks, myrank=r, name="A")
            A.from_array(SPD)
            mats[r] = A
            tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
            counts[r] = NativeDistExecutor(tp, ces[r]).run(nthreads=2)
        except Exception as e:  # surfaced below: a silent join would
            errors.append((r, e))  # let a broken run still "pass"

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(nranks)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    counts = dict(sorted(counts.items()))

    out = np.zeros((n, n))
    for r, A in mats.items():
        for (i, j) in A.local_tiles():
            out[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = \
                A.data_of(i, j).newest_copy().payload
    err = np.abs(np.tril(out) - np.linalg.cholesky(SPD)).max()
    nt = n // nb
    assert sum(counts.values()) == nt * (nt + 1) * (nt + 2) // 6, counts
    assert err < 1e-8, err
    acts = sum(ce.remote_dep.stats["activations_sent"] for ce in ces)
    print(f"native-dist cholesky on {nranks} ranks: tasks {counts}, "
          f"{acts} activations crossed the wire, err {err:.2e}")
    return {"tasks": counts, "activations": acts, "factor": np.tril(out), "err": err}


def main(device=None, *, n: int = 512, nb: int = 128, strip: int = 256, nranks: int = 2,
         dist_n: int = 128, dist_nb: int = 16) -> dict:
    return {"segmented": part1_segmented(device, n, nb, strip),
            "native_dist": part2_native_dist(nranks, dist_n, dist_nb)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
