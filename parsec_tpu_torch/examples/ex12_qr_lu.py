"""Ex12 — the QR and LU flagship taskpools.

Same PTG machinery as the dpotrf tour (ex08/ex11), two more dense
factorizations: tiled Householder QR (dense Q blocks on NEW flows; the
tile updates are matrix products, the Householder chains stay inside the
small panel tasks) and no-pivot LU for diagonally dominant systems
(DPLASMA getrf_nopiv analog).  Both run first on host bodies
(``use_cuda=False``, the JAX example's run, numpy tile bodies); on the
card they run once more on device bodies (``use_cpu=False``: every task
a CUDA chore of torch tile bodies), gated the same way.
"""

import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.datadist import TiledMatrix
from parsec_tpu_torch.ops import run_lu, run_qr


def _qr_resid(ctx, A0, nb, **kw):
    n = A0.shape[0]
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(A0)
    run_qr(ctx, A, **kw)
    R = A.to_array()
    # R^T R == A^T A proves the factorization without tracking Q
    resid = np.abs(R.T @ R - A0.T @ A0).max() / np.abs(A0.T @ A0).max()
    return A, R, resid


def _lu_resid(ctx, B0, nb, **kw):
    n = B0.shape[0]
    B = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float64).from_array(B0)
    run_lu(ctx, B, **kw)
    packed = B.to_array()
    L = np.tril(packed, -1) + np.eye(n)
    U = np.triu(packed)
    return packed, np.abs(L @ U - B0).max() / np.abs(B0).max()


def main(device=None, *, n: int = 128, nb: int = 32, device_bodies=None) -> dict:
    rng = np.random.default_rng(0)
    out = {}

    with Context(nb_cores=4, cuda_device=device) as ctx:
        cuda = next(d for d in ctx.devices if d.mca_name == "cuda")
        if device_bodies is None:
            device_bodies = cuda.tdev.type == "cuda"
        A0 = rng.standard_normal((n, n))
        A, R, resid = _qr_resid(ctx, A0, nb, use_cuda=False)
        print(f"qr: {A.mt}x{A.nt} tiles, A^T A vs R^T R rel residual {resid:.2e}")
        assert resid < 1e-10

        # LU (no pivoting, diagonally dominant): L @ U reconstructs A
        B0 = rng.standard_normal((n, n)) + n * np.eye(n)
        packed, lu_resid = _lu_resid(ctx, B0, nb, use_cuda=False)
        print(f"lu: L@U reconstruction rel residual {lu_resid:.2e}")
        assert lu_resid < 1e-12
        out.update(A0=A0, R=R, qr_resid=resid, B0=B0, LU=packed, lu_resid=lu_resid)

        if device_bodies:
            _, R_dev, resid_dev = _qr_resid(ctx, A0, nb, use_cpu=False)
            packed_dev, lu_resid_dev = _lu_resid(ctx, B0, nb, use_cpu=False)
            print(f"qr and lu on device bodies ({cuda.tdev}): rel residuals "
                  f"{resid_dev:.2e} and {lu_resid_dev:.2e}")
            assert resid_dev < 1e-10 and lu_resid_dev < 1e-12
            out.update(R_device=R_dev, qr_resid_device=resid_dev, LU_device=packed_dev,
                       lu_resid_device=lu_resid_dev)
    return out


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
