"""DISTRIBUTED panel-segmented Cholesky: the panel-granular formulation
of :mod:`.segmented_chol` spread over ranks, with the panel column
broadcast as a device payload.

The port of :mod:`parsec_tpu.ops.segmented_chol_dist`.  Layout: 1D
block-cyclic by column panel — ``rank_of(j) = j % R``; each rank holds its
column blocks as full-height ``(n, nb)`` tiles.  Per step k:

    panel(k)   on owner(k): L_kk = chol(D_k); column solve; the factored
               full-height column P broadcasts to every rank owning a
               trailing block (the runtime's activation broadcast trees;
               on the card the payload is a CUDA tensor the in-process
               fabric clones device to device — no host bounce);
    upd(k, j)  on owner(j), j > k: C_j -= P  P[j-rows]^T — one gemm per
               (k, j); feeds panel(j) when j == k+1, else upd(k+1, j).

Junk-row discipline: the column solve runs at FULL height, rows above the
panel are zeroed in the stored factor, and the trailing update touches
full columns — every out-of-range row lands in the strictly-upper
triangle, which no Cholesky step reads and the assembly tril()s away.

The device bodies are torch library calls (``cholesky_ex``, a triangular
solve, ``matmul``/``addmm``): the reference's are XLA (``jnp.matmul``),
not a Pallas kernel, so no hand-written kernel is on this path.  float32
runs in full FP32 (the CUDA device module turns TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lifecycle import DEV_CUDA, AccessMode
from ..dsl.ptg import PTG
from .panel_chol import chol_inv

IN = AccessMode.IN
INOUT = AccessMode.INOUT
OUT = AccessMode.OUT


def _make_panel_body(n: int, nb: int):
    def panel(M, P, k, **_):
        k0 = int(k) * nb
        L, W = chol_inv(M[k0:k0 + nb, :])
        C = M @ W.mT                    # full-height column solve
        C[k0:k0 + nb, :] = torch.tril(L)
        C[:k0, :] = 0.0                 # junk rows above the panel: zero
        # M' (the home block) and P' (the broadcast payload): two tensors,
        # so the home copy and the payload never alias
        return C, C.clone()

    return panel


def _make_upd_body(n: int, nb: int):
    def upd(T, P, k, j, **_):
        j0 = int(j) * nb
        # full height: junk rows land in the strictly-upper triangle
        return torch.addmm(T, P, P[j0:j0 + nb, :].mT, alpha=-1.0)

    return upd


def _make_panel_body_cpu(n: int, nb: int):
    def panel(M, P, k, **_):
        k0 = k * nb
        D = M[k0:k0 + nb, :]
        L = np.linalg.cholesky(D)
        W = np.linalg.inv(L)
        C = M @ W.T  # full-height column solve (junk rows above: upper)
        C[k0:k0 + nb, :] = np.tril(L)
        C[:k0, :] = 0.0
        M[:] = C
        P[:] = C

    return panel


def _make_upd_body_cpu(n: int, nb: int):
    def upd(T, P, k, j, **_):
        j0 = j * nb
        T -= P @ P[j0:j0 + nb, :].T

    return upd


def _cpu_is_fallback_only(task) -> bool:
    """CPU incarnation evaluate hook: eligible only when the context has
    no enabled CUDA device — a FALLBACK, never a competitor that the
    selector could route hot-path panels onto."""
    ctx = task.taskpool.context
    return not any(d.device_type == DEV_CUDA and d.enabled
                   for d in (ctx.devices if ctx is not None else ()))


def _select_bodies(pc, cuda_body, cpu_body, use_cuda: bool,
                   use_cpu: bool) -> None:
    bodies = {}
    if use_cuda:
        bodies["cuda"] = cuda_body
    if use_cpu:
        bodies["cpu"] = cpu_body
        pc.evaluate_hook("cpu", _cpu_is_fallback_only)
    if not bodies:
        raise ValueError(f"{pc.name}: no BODY selected (use_cuda={use_cuda}, "
                         f"use_cpu={use_cpu})")
    pc.body(**bodies)


def dist_segmented_cholesky_ptg(n: int, nb: int, *, use_cuda: bool = True,
                                use_cpu: bool = True) -> PTG:
    """Build the distributed segmented dpotrf PTG.  Instantiate with
    ``.taskpool(NT=n//nb, C=collection, TILE_SHAPE=(n, nb))`` where
    ``C(j)`` is the full-height column block j, distributed by the
    collection's ``rank_of``.  The CUDA (functional torch) incarnation is
    primary; the CPU (in-place numpy) incarnation is a FALLBACK gated by
    an evaluate hook — eligible only in contexts with no CUDA device."""
    from .tiles import check_tiling

    check_tiling(n, nb, op="distributed segmented cholesky")
    ptg = PTG("dpotrf_seg_dist")
    panel = ptg.task_class("panel", k="0 .. NT-1")
    panel.affinity("C(k)")
    panel.priority("2 * (NT - k)")  # panels ARE the critical path
    panel.flow("M", INOUT,
               "<- (k == 0) ? C(k) : T upd(k-1, k)",
               "-> C(k)")
    panel.flow("P", OUT,
               "-> (k < NT-1) ? P upd(k, k+1 .. NT-1)")
    _select_bodies(panel, _make_panel_body(n, nb),
                   _make_panel_body_cpu(n, nb), use_cuda, use_cpu)

    upd = ptg.task_class("upd", k="0 .. NT-2", j="k+1 .. NT-1")
    upd.affinity("C(j)")
    upd.priority("NT - k")
    upd.flow("T", INOUT,
             "<- (k == 0) ? C(j) : T upd(k-1, j)",
             "-> (j == k+1) ? M panel(j) : T upd(k+1, j)")
    upd.flow("P", IN, "<- P panel(k)")
    _select_bodies(upd, _make_upd_body(n, nb),
                   _make_upd_body_cpu(n, nb), use_cuda, use_cpu)
    return ptg


def run_dist_segmented_cholesky(nranks: int, n: int, nb: int, *,
                                fabric=None, nb_cores: int = 2,
                                timeout: float = 300,
                                seed: int = 7,
                                dtype=np.float32,
                                trace_pins: bool = False,
                                devices=None, cuda_device=None):
    """Drive the distributed segmented dpotrf over ``nranks`` in-process
    ranks (one Context per rank, each on the card unless ``devices`` /
    ``cuda_device`` say otherwise; a one-card host binds every rank to
    ``cuda:0``).  Returns ``(err, stats)``: ``err`` is the max-abs error
    of the assembled factor against the float64 Cholesky of the same
    matrix, relative to its largest entry — numpy's for host chores, else
    torch's on rank 0's CUDA module's device; ``stats``
    are :func:`~parsec_tpu_torch.multirank.run_multirank_perf`'s, with
    ``trace_pins`` the per-rank comm/compute overlap included."""
    from ..data import LocalCollection
    from ..multirank import run_multirank_perf

    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    SPD = m @ m.T + n * np.eye(n, dtype=dtype)
    NT = n // nb
    host_only = devices is not None and "cuda" not in devices
    #: the torch device each rank's CUDA module binds (None: host only)
    tdevs = [None] * nranks

    def build(r, ctx):
        tdevs[r] = next((d.tdev for d in ctx.devices
                         if d.device_type == DEV_CUDA), None)
        dc = LocalCollection(
            "C", shape=(n, nb), dtype=dtype, nodes=nranks, myrank=r,
            init=lambda j: np.ascontiguousarray(
                SPD[:, j * nb:(j + 1) * nb]))
        dc.rank_of = lambda j: j % nranks
        ptg = dist_segmented_cholesky_ptg(n, nb, use_cuda=not host_only)
        tp = ptg.taskpool(NT=NT, C=dc, TILE_SHAPE=(n, nb), TILE_DTYPE=dtype)
        return tp, dc

    # gflops = USEFUL dpotrf flops (n^3/3); the full-height formulation
    # executes more raw flops — this is the comparable figure
    cols, stats = run_multirank_perf(
        nranks, build, nb_cores=nb_cores, timeout=timeout, fabric=fabric,
        overlap=trace_pins, flops=n**3 / 3, devices=devices,
        cuda_device=cuda_device)
    out = np.zeros((n, n), dtype)
    for r, dc in enumerate(cols):
        for j in range(NT):
            if j % nranks != r:
                continue
            c = dc.data_of(j).newest_copy()
            out[:, j * nb:(j + 1) * nb] = _host(c.payload)
    if host_only or tdevs[0] is None:
        ref = np.linalg.cholesky(SPD.astype(np.float64))
        err = float(np.abs(np.tril(out).astype(np.float64) - ref).max()
                    / np.abs(ref).max())
    else:
        tdev = tdevs[0]
        ref = torch.linalg.cholesky(torch.from_numpy(SPD).to(tdev).double())
        got = torch.from_numpy(out).to(tdev).double().tril()
        err = float(((got - ref).abs().max() / ref.abs().max()).item())
        del ref, got
    return err, stats


def _host(payload) -> np.ndarray:
    if isinstance(payload, torch.Tensor):
        return payload.detach().cpu().numpy()
    return np.asarray(payload)
