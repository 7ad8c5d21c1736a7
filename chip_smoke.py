#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (parsec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from ``parsec_tpu_torch/csrc``;
3. kernel phase: runs every mode of ``matmul_update`` (B1) and ``matmul``
   (B2) at the dpotrf tile shape (512 x 512 x 512) and at a ragged shape,
   holds each against its plain PyTorch version on the card (float32
   1e-4 relative, bf16 operands 1e-3: only the summation order differs),
   and times kernel, plain version and the one-call PyTorch yardstick
   (``torch.addmm``; with ``out_dtype=float32`` for bf16 operands);
4. main path: tiled dpotrf at N=8192 nb=512 float32 through
   ``Context`` / ``add_taskpool`` / ``wait`` with every task on the CUDA
   device module — hand kernels for the updates, then the ``use_trtri``
   variant (trsm as a B2 product), then ``bf16_updates`` — checking the
   factor, the task counts and the kernel launch counts of each run;
5. device-module phase: a 2048 x 2048 dpotrf with event-polled
   completion and one under an 8 MB residency budget (eviction
   write-back), each checked against a float64 Cholesky;
6. with ``--profile``, runs the two f32 variants once more under
   ``torch.profiler`` and prints the device busy time and idle share;
7. prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero.  Without a GPU, or
without the port beside it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N, NB = 8192, 512          # bench.py's accelerator configuration
TILE = (512, 512, 512)     # (m, n, k) of every update on the main path
RAGGED = (500, 300, 200)
TOL_F32, TOL_BF16, TOL_SPLIT_F64 = 1e-4, 1e-3, 1e-5

#: dense peaks from NVIDIA's data sheets: FP32 on the CUDA cores, BF16 on
#: the tensor cores, and device-memory bandwidth.  The SXM row is the
#: default; a card whose name says PCIe takes the PCIe row.
PEAKS = {
    "sxm": {"f32": 67e12, "bf16": 989e12, "bytes": 3.35e12},
    "pcie": {"f32": 51e12, "bf16": 756e12, "bytes": 2.0e12},
}


def say(tag: str, **fields) -> None:
    print(f"{tag} " + json.dumps(fields, sort_keys=True), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from parsec_tpu_torch import Context, mca_param
        from parsec_tpu_torch.datadist import TiledMatrix
        from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count, kernels
    except ImportError as e:
        print(f"chip_smoke: the parsec_tpu_torch package is not importable "
              f"({e}); run from the root of a checkout", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False  # true FP32 products,
    torch.backends.cudnn.allow_tf32 = False        # never TF32
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    peaks = PEAKS["pcie" if "pcie" in kind.lower() else "sxm"]

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.build()
    say("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas " + line.strip(), file=sys.stderr)

    # -- kernel phase -------------------------------------------------------
    gen = torch.Generator(device=dev)

    def rand(shape, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def time_ms(fn, reps=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    def bound(flops, nbytes, op_type):
        t_ops = flops / peaks[op_type] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")

    def library_update(C, A, B, alpha, tb):
        """One PyTorch call computing C + alpha * A @ op(B) in f32: cuBLAS
        SGEMM for f32 operands (split_f32 computes the same function), and
        for bf16 operands a bf16 GEMM with f32 output and accumulation
        (bf16 x bf16 products are exact in f32).  Timed only."""
        b = B.mT if tb else B
        if A.dtype == torch.float32:
            return (lambda: torch.addmm(C, A, b, alpha=alpha)), "torch.addmm"
        return ((lambda: torch.addmm(C, A, b, out_dtype=torch.float32, alpha=alpha)),
                "torch.addmm(out_dtype=float32)")

    results = {}
    seed = 100
    for (m, n, k) in (TILE, RAGGED):
        for mode in ("f32", "f32_nt", "bf16", "split", "split_nt"):
            seed += 1
            tb = not mode.endswith("_nt")
            op_dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            split = mode.startswith("split")
            alpha = -1.0 if tb else 1.0
            C = rand((m, n), seed)
            A = rand((m, k), seed + 1000, op_dtype)
            B = rand((n, k) if tb else (k, n), seed + 2000, op_dtype)
            kw = dict(alpha=alpha, transpose_b=tb, split_f32=split)
            out = kernels.matmul_update(C, A, B, **kw)
            ref = kernels.matmul_update_plain(C, A, B, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            tol = TOL_BF16 if mode == "bf16" else TOL_F32
            check(bool(torch.isfinite(out).all()) and rel < tol,
                  f"matmul_update[{mode}] {m}x{n}x{k}: rel err {rel} >= {tol}")
            row = {"shape": [m, n, k], "max_abs_err": err, "rel_err": rel, "tol": tol}
            if split:
                b64 = B.double().mT if tb else B.double()
                r64 = C.double() + alpha * (A.double() @ b64)
                rel64 = ((out.double() - r64).abs().max() / r64.abs().max()).item()
                check(rel64 < TOL_SPLIT_F64,
                      f"matmul_update[{mode}] vs f64: {rel64} >= {TOL_SPLIT_F64}")
                row["rel_err_vs_f64"] = rel64
            if (m, n, k) == TILE:
                row["ms"] = time_ms(lambda: kernels.matmul_update(C, A, B, **kw))
                row["plain_ms"] = time_ms(lambda: kernels.matmul_update_plain(C, A, B, **kw))
                lib_fn, row["library_call"] = library_update(C, A, B, alpha, tb)
                lib_rel = ((lib_fn() - ref).abs().max() / ref.abs().max()).item()
                check(lib_rel < tol, f"library {row['library_call']} disagrees "
                                     f"with matmul_update_plain[{mode}]: {lib_rel}")
                row["library_ms"] = time_ms(lib_fn)
                isz = 2 if op_dtype == torch.bfloat16 else 4
                passes = 3 if split else 1
                row["bound_ms"], row["bound_by"] = bound(
                    passes * 2 * m * n * k + 2 * m * n,
                    (m * k + n * k) * isz + 2 * m * n * 4,
                    "bf16" if (op_dtype == torch.bfloat16 or split) else "f32")
            results[("matmul_update", mode, (m, n, k))] = row
            say("kernel", name="matmul_update", mode=mode, **row)
        for mode in ("f32", "f32_nt"):
            seed += 1
            tb = mode == "f32"
            A = rand((m, k), seed + 3000)
            B = rand((n, k) if tb else (k, n), seed + 4000)
            out = kernels.matmul(A, B, transpose_b=tb)
            ref = kernels.matmul_plain(A, B, transpose_b=tb)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            check(bool(torch.isfinite(out).all()) and rel < TOL_F32,
                  f"matmul[{mode}] {m}x{n}x{k}: rel err {rel} >= {TOL_F32}")
            row = {"shape": [m, n, k], "max_abs_err": err, "rel_err": rel, "tol": TOL_F32}
            if (m, n, k) == TILE:
                b = B.mT if tb else B
                row["ms"] = time_ms(lambda: kernels.matmul(A, B, transpose_b=tb))
                row["plain_ms"] = time_ms(lambda: kernels.matmul_plain(A, B, transpose_b=tb))
                row["library_ms"] = time_ms(lambda: torch.matmul(A, b))
                row["bound_ms"], row["bound_by"] = bound(
                    2 * m * n * k, (m * k + n * k + m * n) * 4, "f32")
            results[("matmul", mode, (m, n, k))] = row
            say("kernel", name="matmul", mode=mode, **row)

    # -- main path: dpotrf N=8192 nb=512 on the CUDA device module ----------
    # SPD input made from a numpy seed as bench.py makes it (M M^T + N I),
    # the product taken on the card; the oracle is a float64 Cholesky
    rng = np.random.default_rng(0)
    Mg = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32)).to(dev)
    Sg = Mg @ Mg.mT + N * torch.eye(N, device=dev)
    del Mg
    S = Sg.cpu().numpy()
    S64 = Sg.double()
    L_ref = torch.linalg.cholesky(S64)
    L_ref_last = L_ref[-NB:, -NB:].tril()
    scale = max(1.0, L_ref.abs().max().item())
    del L_ref
    s_max = S64.abs().max().item()
    # warm the solver libraries at tile size (handle creation is set-up,
    # not dpotrf time)
    tile = Sg[:NB, :NB].contiguous()
    torch.linalg.cholesky_ex(tile)
    torch.linalg.solve_triangular(tile, tile, upper=False)
    torch.cuda.synchronize()

    variants = [
        ("kernels", dict(use_kernels=True), 1e-3),
        ("kernels_trtri", dict(use_kernels=True, use_trtri=True), 1e-3),
        ("kernels_bf16", dict(use_kernels=True, bf16_updates=True), 2e-2),
    ]
    nt = N // NB

    def run_dpotrf(kw, S_in=S):
        """One dpotrf through Context/add_taskpool/wait; returns the
        factored matrix, wall seconds, kernel launches and the CUDA device
        module's stats."""
        n_in = S_in.shape[0]
        A = TiledMatrix(n_in, n_in, NB, NB, name="A", dtype=np.float32).from_array(S_in)
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            check(cuda_dev.tdev.type == "cuda", f"CUDA module bound to {cuda_dev.tdev}")
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
            kernels.reset_counts()
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"matmul_update": kernels.matmul_update.launches,
                      "matmul": kernels.matmul.launches}
        finally:
            ctx.fini()
        check(ok, f"dpotrf {kw}: taskpool failed ({tp.fail_reason})")
        return A, wall, counts, dict(cuda_dev.stats)

    launches = {}
    for name, kw, recon_tol in variants:
        trtri = kw.get("use_trtri", False)
        ntasks = dpotrf_task_count(nt, use_trtri=trtri)
        A, wall, counts, stats = run_dpotrf(kw)
        executed = stats["executed_tasks"]
        check(executed == ntasks, f"{name}: {executed} tasks on the CUDA device, expected {ntasks}")
        n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
        check(counts["matmul_update"] == n_upd,
              f"{name}: {counts['matmul_update']} matmul_update launches, expected {n_upd}")
        n_mm = nt * (nt - 1) // 2 if trtri else 0
        check(counts["matmul"] == n_mm,
              f"{name}: {counts['matmul']} matmul launches, expected {n_mm}")
        launches[name] = counts
        L = torch.from_numpy(A.to_array()).to(dev).double().tril()
        check(bool(torch.isfinite(L).all()), f"{name}: non-finite factor")
        recon = ((L @ L.mT - S64).abs().max() / s_max).item()
        last = ((L[-NB:, -NB:] - L_ref_last).abs().max() / scale).item()
        del L
        check(last < 1e-3, f"{name}: last-tile error {last} >= 1e-3")
        check(recon < recon_tol, f"{name}: ||LL^T-S||max/||S||max {recon} >= {recon_tol}")
        say("dpotrf", variant=name, N=N, nb=NB, tasks=ntasks, wall_s=wall,
            gflops=N ** 3 / 3 / wall / 1e9, tasks_per_s=ntasks / wall,
            launches=counts, last_tile_err=last, recon_err=recon,
            recon_tol=recon_tol)

    # -- device-module phase: the CUDA module's GPU-only paths ----------------
    # event-polled completion (cuda_eager_complete=0) and eviction with
    # device->host write-back (an 8 MB budget for 10 MB of tiles), on the
    # leading 2048 x 2048 block of S (SPD as every leading block is)
    n_small = 2048
    S_small = np.ascontiguousarray(S[:n_small, :n_small])
    L_small = torch.linalg.cholesky(Sg[:n_small, :n_small].double())
    small_scale = L_small.abs().max().item()
    for label, params in (("event_polled", {"cuda_eager_complete": 0}),
                          ("eviction", {"cuda_mem_budget_mb": 8})):
        for key, value in params.items():
            mca_param.set_param("device", key, value)
        try:
            A, wall, _counts, stats = run_dpotrf(dict(use_kernels=True), S_small)
        finally:
            for key in params:
                mca_param.unset("device", key)
        L = torch.from_numpy(A.to_array()).to(dev).double().tril()
        err = ((L - L_small).abs().max() / small_scale).item()
        check(err < 1e-3, f"device module [{label}]: factor error {err} >= 1e-3")
        check(stats["executed_tasks"] == dpotrf_task_count(n_small // NB),
              f"device module [{label}]: {stats['executed_tasks']} tasks")
        if label == "eviction":
            check(stats["evictions"] > 0 and stats["bytes_out"] > 0,
                  f"device module [eviction]: no eviction write-back ({stats})")
        say("device_module", check=label, N=n_small, nb=NB, wall_s=wall,
            factor_err=err, evictions=stats["evictions"],
            bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])

    if "--profile" in sys.argv[1:]:
        # where the time goes: one extra run of each f32 variant under
        # torch.profiler; device busy = the summed device time of every
        # kernel and copy (all on one stream, so they never overlap)
        from torch.profiler import ProfilerActivity, profile

        for name, kw, _tol in variants[:2]:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _A, wall, _c, _e = run_dpotrf(kw)
            rows = []
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                rows.append((us, ev.count, ev.key))
            busy_ms = sum(r[0] for r in rows) / 1e3
            rows.sort(reverse=True)
            say("profile", variant=name, wall_s=wall, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / 1e3 / wall,
                top=[{"kernel": k[:90], "count": c, "ms": us / 1e3}
                     for us, c, k in rows[:8]])

    def entry(name, mode, n_launch):
        row = results[(name, mode, TILE)]
        return {"name": f"{name}[{mode}]", "route": "cuda",
                "source": "parsec_tpu_torch/csrc/matmul.cu",
                "replaces": "parsec_tpu/ops/pallas_kernels.py:"
                            + ("70" if name == "matmul_update" else "158"),
                "launches": n_launch, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    table = [
        entry("matmul_update", "f32", launches["kernels"]["matmul_update"]
              + launches["kernels_trtri"]["matmul_update"]),
        entry("matmul_update", "bf16", launches["kernels_bf16"]["matmul_update"]),
        entry("matmul", "f32", launches["kernels_trtri"]["matmul"]),
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
