#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (parsec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from ``parsec_tpu_torch/csrc`` and
   prints ptxas's registers and spills per kernel (stderr), then the native
   engine library from ``native/src`` (g++);
3. kernel phase: runs every mode of ``matmul_update`` (B1: f32, bf16,
   split_f32) and ``matmul`` (B2: f32, bf16), each with and without
   ``transpose_b``, at the dpotrf tile shape (512 x 512 x 512), a ragged
   shape, one 64 x 64 x 16 slab and a shape whose row pitches are not
   16-byte multiples;
   ``flash_attention_block`` (B5) in f32 and bf16 at the attention path's
   blocks (the prefill's full and diagonal blocks, the decode step's
   ragged 96 x 416 tail) and at a ragged (100, 300) with head dimensions
   37, 64 and 256, causal and not (every head-dimension template and the
   predicated copies), the wide kernel at (100, 300) and (512, 512) with
   D = 320 and 512, a float16 and a mixed-dtype case (the f32 engine on
   float32 copies); ``stencil_5pt`` (B3) in f32, f64, f16 and bf16 at its
   tile, ragged and at an unaligned shape (the scalar variant), timed
   L2-warm and L2-cold; ``stencil_5pt_fused`` (B4) in each mode (smem:
   512^2, 999^2 (a ragged last strip) and 2048^2 f32, 1024^2 f64 and f16;
   global: 2048^2 f64), timed at
   100 steps and at one.  Holds each against its plain PyTorch
   version on the card at the tolerances of
   tests/runtime/test_pallas_kernels.py (B1/B2 float32 1e-4 relative, bf16
   operands 1e-3: only the summation order differs; B2 with bf16 output
   one bf16 ulp; B5 1e-4 for its carry taken to the
   plain version's running max, and B5's masked-at-init update exactly, in
   both dtypes and at D = 512), B3 and B4 bit for bit
   (``torch.equal``); holds every f32-class B1/B2 mode against a float64
   product (< 1e-5, and the f32 modes at the tile within 2x of the plain
   version's, cuBLAS FP32, error) and every B5 case against the update in
   float64 (< 1e-4; the f32 mode at the full and diagonal blocks also
   within 2x of the plain version's error); checks that two launches on
   the same inputs are bit-identical; and times kernel, plain version and,
   for B1/B2, the one-call PyTorch yardstick (``torch.addmm``,
   ``torch.matmul``);
4. dpotrf path: tiled dpotrf at N=8192 nb=512 float32 through
   ``Context`` / ``add_taskpool`` / ``wait`` with every task on the CUDA
   device module — hand kernels for the updates, then the ``use_trtri``
   variant (trsm as a B2 product), then ``bf16_updates`` — checking the
   factor, the task counts and the kernel launch counts of each run, per
   operand mode; ``kernels`` and ``kernels_trtri`` at
   ``runtime_stage_depth`` 1 (the default: no committer) and 2 (the
   write-back committer) in turns (1, 2, 2, 1, 1, 2), the factors
   ``torch.equal``; ``kernels_bf16`` at depth 2;
   then, through the native pump (``NativeExecutor(tp, native_device=True)``:
   the captured DAG on the C++ engine built by g++ from ``native/src``,
   one ``pop_batch`` and one ``done_batch`` per batch, no per-task
   interpreter entry), ``kernels`` and ``kernels_trtri`` at stage depth 1
   and 2 (the prefetch window) in turns (1, 2, 2, 1, 1, 2), each factor
   ``torch.equal`` to the dynamic run's and its B1/B2 launches per mode
   equal to the dynamic run's; then the pump's ``kernels`` under a 96 MB
   device budget (below
   the 256 MiB matrix: eviction and write-back under the pipeline), its
   factor ``torch.equal`` too, with evictions and no synchronous
   write-back fallback;
5. device-module phase: a 2048 x 2048 dpotrf with event-polled
   completion and one under an 8 MB residency budget (eviction
   write-back), each checked against a float64 Cholesky;
6. attention path: ``run_flash_attention`` at Llama-2-7B's attention
   geometry (32 heads x 128, B=1), causal prefill of 4096 tokens in
   512-blocks in float32 and in bfloat16, and a 96-token decode against
   4000 keys, each checked against ``attention_reference`` in float64, with
   its task and B5 launch counts (the bf16 prefill and the decode at
   stage depth 2), the f32 prefill at stage depth 1 and 2 in turns, each
   output ``torch.equal`` to the first;
   ``scaled_dot_product_attention`` on the prefill problem is timed beside
   it as the yardstick; then the f32 prefill through
   ``run_flash_attention_native`` at stage depth 1 and 2 in turns (and
   once more through its pieces, to time capture and build apart), each
   output ``torch.equal`` to ``run_flash_attention``'s;
7. stencil path: ``stencil_ptg(use_kernels=True)`` on an 8192^2 float32
   grid in 1024^2 tiles for 20 steps (B3 launches counted), through
   ``Context`` at stage depth 1 and 2 in turns and then through the native
   pump at stage depth 1 and 2 in turns (and at 2 with the reference's
   32 MB write-back watermark: the committer draining mid-run beside the
   kernels), each grid ``torch.equal`` to the first; then B4 on the leading 2048^2
   block for 100 steps (one smem-mode launch), all against a float64
   reference;
8. transfer phase: the stencil's 64 tiles of 4 MiB, twice, host->device
   and back through the device module's copy engine (pinned buffers, copy
   streams) and through pageable ``.to()`` / ``.cpu()``, in turns, each
   direction's GB/s printed;
9. with ``--profile``, runs the two f32 dpotrf variants, the f32 prefill
   and the stencil (through ``Context`` and through the pump, each at
   stage depth 1 and 2) once more under ``torch.profiler``, and the
   pump's dpotrf ``kernels`` (at stage depth 1 and 2) and f32 prefill,
   and prints the device busy time (the union of the kernels' and
   copies' intervals, beside their sum), the idle share, H2D/D2H device
   ms and GB/s, and how much of the copy time overlaps kernel time;
10. prints each path's walls at stage depth 1 and 2 (``stage_depth_walls``,
   with the ratio of their medians), the kernel table as one JSON line, the
   card line, and last ``{"ok": true, "device": {...}}``.

Every run of the CUDA device module must end with no synchronous
write-back fallback (``wb_sync_fallbacks == 0``).

Kernel times are device times: the timed launches are queued behind a
spin kernel sized to outlast their enqueue, so the CUDA events measure
back-to-back execution, not the host's launch rate.

Any failed check raises, and the script exits non-zero.  Without a GPU, or
without the port beside it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
import types

N, NB = 8192, 512          # bench.py's accelerator configuration
TILE = (512, 512, 512)     # (m, n, k) of every update on the main path
RAGGED = (500, 300, 200)
TINY = (64, 64, 16)        # one slab of one output tile
UNALIGNED = (130, 70, 37)  # row pitches that are not 16-byte multiples
SHAPES = (TILE, RAGGED, TINY, UNALIGNED)
TOL_F32, TOL_BF16, TOL_SPLIT_F64 = 1e-4, 1e-3, 1e-5
# B2 with bfloat16 output rounds the f32 sum once: one bf16 ulp at the
# largest element
TOL_BF16_OUT = 2.0 ** -7
# the f32 modes against float64 at the tile: at most this many times the
# plain version's (cuBLAS FP32) error
F64_GATE_FACTOR = 2.0
# B5, tests/runtime/test_pallas_kernels.py's tolerance (B3/B4 are held
# bit-identical to their plain versions)
TOL_ATTN = 1e-4

# attention path: Llama-2-7B's attention layer (Hugging Face
# meta-llama/Llama-2-7b-hf config.json: 32 heads, hidden 4096 -> head_dim
# 128, 4096 positions), B=1, in the kernel's own default 512-row blocks;
# the decode step puts 96 queries at the tail of 4000 keys
ATTN_B, ATTN_S, ATTN_H, ATTN_D, ATTN_BLOCK = 1, 4096, 32, 128, 512
DEC_SQ, DEC_SK = 96, 4000
# tests/runtime/test_attention_graph.py's bounds (allclose form: atol and
# rtol both the bound)
TOL_ATTN_F32, TOL_ATTN_BF16 = 2e-5, 5e-2
# stencil path: an 8192^2 float32 grid in 8 x 8 tiles of 1024^2, 20 steps;
# the fused kernel on the leading 2048^2 block for 100 steps
ST_N, ST_TILES, ST_T = 8192, 8, 20
FUSED_N, FUSED_ITERS = 2048, 100
TOL_STENCIL_PATH = 1e-5
# the stage depths each path runs at, in this order: three runs a depth in
# turns (A B B A A B) so that a drift over the run weighs on both depths
# alike, compared by their medians; the first at the default depth 1
STAGE_DEPTHS = (1, 2, 2, 1, 1, 2)

#: dense peaks from NVIDIA's data sheets: FP32 and FP64 on the CUDA cores,
#: BF16 and TF32 on the tensor cores, and device-memory bandwidth.  The SXM row is
#: the default; a card whose name says PCIe takes the PCIe row.
PEAKS = {
    "sxm": {"f32": 67e12, "f64": 34e12, "bf16": 989e12, "tf32": 495e12,
            "bytes": 3.35e12},
    "pcie": {"f32": 51e12, "f64": 26e12, "bf16": 756e12, "tf32": 378e12,
             "bytes": 2.0e12},
}


def say(tag: str, **fields) -> None:
    print(f"{tag} " + json.dumps(fields, sort_keys=True), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def stage_depth(mca_param, depth: int):
    """Run the block at ``runtime_stage_depth`` ``depth`` (read when a
    device module is built: a Context, or a NativeExecutor's own)."""
    mca_param.set_param("runtime", "stage_depth", depth)
    try:
        yield
    finally:
        mca_param.unset("runtime", "stage_depth")


class DepthWalls:
    """Each path's walls at stage depth 1 and 2, from this run; printed as
    one ``stage_depth_walls`` line a path, with the ratio of the medians."""

    def __init__(self):
        self.walls = {}

    def add(self, path: str, depth: int, wall: float) -> None:
        self.walls.setdefault(path, {1: [], 2: []})[depth].append(wall)

    def report(self) -> None:
        for path, by_depth in self.walls.items():
            med = {d: statistics.median(w) for d, w in by_depth.items()}
            say("stage_depth_walls", path=path, depth1_s=by_depth[1],
                depth2_s=by_depth[2], median1_s=med[1], median2_s=med[2],
                depth2_over_depth1=med[2] / med[1])


def device_stats(dev, **extra) -> dict:
    """A CUDA device module's counters after a run, with its pinned bytes."""
    stats = dict(dev.stats, **extra)
    stats["pinned_bytes"], stats["pinned_peak_bytes"] = dev.pinned_bytes
    return stats


def pipeline_fields(stats) -> dict:
    """The staging counters of a run's :func:`device_stats`."""
    keys = ("bytes_in", "bytes_out", "h2d_copies", "d2h_copies", "prefetched_tiles",
            "stage_batched_tiles", "wb_batches", "wb_sync_fallbacks", "wb_committed",
            "wb_dropped_stale", "wb_capacity_waits", "wb_drains", "wb_drain_s",
            "prestage_s", "evictions", "pinned_bytes", "pinned_peak_bytes", "flush_s",
            "detach_s", "lane_wait_s", "submit_s", "retire_s")
    return {k: stats[k] for k in keys if k in stats}


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
        from parsec_tpu_torch.ops import (
            StencilBuffers,
            attention_task_count,
            cholesky_ptg,
            dpotrf_task_count,
            build_flash_attention,
            kernels,
            run_flash_attention,
            run_flash_attention_native,
            stencil_ptg,
        )
        from parsec_tpu_torch import native
        from parsec_tpu_torch.dsl.native_exec import NativeExecutor
        from parsec_tpu_torch.parallel import attention_reference
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
    say("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name,
        torch=torch.__version__, cuda=torch.version.cuda)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas " + line.strip(), file=sys.stderr)
    # the native engine (g++ over native/src), built here so that no
    # pump run's capture + build time includes the compile
    t0 = time.perf_counter()
    engine = native.load()
    say("build_native", seconds=round(time.perf_counter() - t0, 3), library=engine._name)

    # -- kernel phase -------------------------------------------------------
    gen = torch.Generator(device=dev)

    def rand(shape, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # spin-kernel calibration: device clock cycles per millisecond
    s, e = events()
    torch.cuda._sleep(1 << 20)
    s.record()
    torch.cuda._sleep(1 << 24)
    e.record()
    e.synchronize()
    cycles_per_ms = (1 << 24) / s.elapsed_time(e)

    def time_ms(fn, reps=50):
        """Device milliseconds per call: warm up, then queue ``reps`` calls
        behind a spin kernel that outlasts their enqueue (three times the
        slowest of three measured host times of one call, per call, plus
        2 ms), so the events time the calls back to back on the device."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host_s = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            host_s = max(host_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
        s, e = events()
        torch.cuda._sleep(int(cycles_per_ms * (3e3 * host_s * reps + 2.0)))
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

    def rel_err(out, ref):
        return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()

    # B1/B2: every mode at every shape; a failed gate is recorded and the
    # phase raises once every row is printed
    results = {}
    failures = []
    seed = 100
    for (m, n, k) in SHAPES:
        for name in ("matmul_update", "matmul"):
            modes = (("f32", "f32_nt", "bf16", "bf16_nt", "split", "split_nt")
                     if name == "matmul_update" else ("f32", "f32_nt", "bf16", "bf16_nt"))
            for mode in modes:
                seed += 1
                tb = not mode.endswith("_nt")
                op_dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
                split = mode.startswith("split")
                alpha = -1.0 if tb else 1.0
                A = rand((m, k), seed + 1000, op_dtype)
                B = rand((n, k) if tb else (k, n), seed + 2000, op_dtype)
                b = B.mT if tb else B
                if name == "matmul_update":
                    C = rand((m, n), seed)
                    kw = dict(alpha=alpha, transpose_b=tb, split_f32=split)
                    run = lambda: kernels.matmul_update(C, A, B, **kw)  # noqa: E731
                    plain = lambda: kernels.matmul_update_plain(C, A, B, **kw)  # noqa: E731
                    lib_fn, lib_call = library_update(C, A, B, alpha, tb)
                    tol = TOL_BF16 if op_dtype == torch.bfloat16 else TOL_F32
                else:
                    C, alpha = None, 1.0
                    run = lambda: kernels.matmul(A, B, transpose_b=tb)  # noqa: E731
                    plain = lambda: kernels.matmul_plain(A, B, transpose_b=tb)  # noqa: E731
                    lib_fn, lib_call = (lambda: torch.matmul(A, b)), "torch.matmul"
                    tol = TOL_BF16_OUT if op_dtype == torch.bfloat16 else TOL_F32
                label = f"{name}[{mode}] {m}x{n}x{k}"
                out, out2, ref = run(), run(), plain()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                rel = rel_err(out, ref)
                row = {"shape": [m, n, k], "max_abs_err": err, "rel_err": rel, "tol": tol,
                       "bit_identical": bool(torch.equal(out, out2))}
                if not (bool(torch.isfinite(out).all()) and rel < tol):
                    failures.append(f"{label}: rel err {rel} >= {tol}")
                if not row["bit_identical"]:
                    failures.append(f"{label}: two launches on the same inputs differ")
                if op_dtype == torch.float32:
                    # f32-class modes against a float64 product: < 1e-5 at
                    # every shape; the f32 modes at the tile also within 2x
                    # of the plain version's (cuBLAS FP32, TF32 off) error
                    r64 = A.double() @ b.double()
                    if C is not None:
                        r64 = C.double() + alpha * r64
                    row["rel_err_vs_f64"] = rel_err(out, r64)
                    row["plain_rel_err_vs_f64"] = rel_err(ref, r64)
                    if row["rel_err_vs_f64"] >= TOL_SPLIT_F64:
                        failures.append(f"{label} vs f64: {row['rel_err_vs_f64']} "
                                        f">= {TOL_SPLIT_F64}")
                    if (not split and (m, n, k) == TILE and row["rel_err_vs_f64"]
                            > F64_GATE_FACTOR * row["plain_rel_err_vs_f64"]):
                        failures.append(f"{label} vs f64: {row['rel_err_vs_f64']} > "
                                        f"{F64_GATE_FACTOR} x the plain version's "
                                        f"{row['plain_rel_err_vs_f64']}")
                if (m, n, k) == TILE:
                    row["config"] = kernels._mm_config(
                        m, n, k, operand_dtype=A.dtype, out_dtype=out.dtype,
                        transpose_b=tb, split_f32=split, a_ptr=A.data_ptr(),
                        b_ptr=B.data_ptr(), o_ptr=out.data_ptr(),
                        c_ptr=None if C is None else C.data_ptr())._asdict()
                    row["ms"] = time_ms(run)
                    row["plain_ms"] = time_ms(plain)
                    lib_rel = rel_err(lib_fn(), ref)
                    if lib_rel >= tol:
                        failures.append(f"library {lib_call} disagrees with the plain "
                                        f"{label}: {lib_rel}")
                    row["library_call"] = lib_call
                    row["library_ms"] = time_ms(lib_fn)
                    isz = A.element_size()
                    c_bytes = 2 * m * n * 4 if C is not None else m * n * out.element_size()
                    nbytes = (m * k + n * k) * isz + c_bytes
                    flops = 2 * m * n * k + (2 * m * n if C is not None else 0)
                    if op_dtype == torch.bfloat16:
                        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "bf16")
                    elif split:
                        row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, "bf16")
                    else:
                        # f32: three TF32 tensor-core passes (this design);
                        # true FP32 on the CUDA cores printed beside it
                        row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, "tf32")
                        row["bound_fp32_ms"], _ = bound(flops, nbytes, "f32")
                results[(name, mode, (m, n, k))] = row
                say("kernel", name=name, mode=mode, **row)
    check(not failures, "B1/B2 kernel phase:\n  " + "\n  ".join(failures))

    # -- B5 flash_attention_block at the attention path's blocks ----------------
    def attn_pairs(sq, sk, q_off, k_off, causal):
        """(query, key) pairs the update needs: all of them, or under the
        causal mask those with q_off + row >= k_off + col."""
        if not causal:
            return sq * sk
        rows = torch.arange(sq, dtype=torch.int64)
        return int((q_off + rows - k_off + 1).clamp(0, sk).sum())

    # (label, Sq, Sk, D, dtype, causal, q_off, k_off): the path's blocks
    # (the prefill's full and diagonal blocks, the decode step's ragged
    # tail), then every head-dimension template and the predicated copies
    # (D = 37: f32 row pitches that are not 16-byte multiples) at a ragged
    # (100, 300)
    f32, bf16 = torch.float32, torch.bfloat16
    dec_k_off = (DEC_SK - 1) // ATTN_BLOCK * ATTN_BLOCK
    attn_cases = [
        ("f32", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, f32, False, 0, 0),
        ("f32_causal_diag", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, f32, True, 0, 0),
        ("f32_ragged", DEC_SQ, DEC_SK - dec_k_off, ATTN_D, f32, True,
         DEC_SK - DEC_SQ, dec_k_off),
        ("bf16", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, bf16, True, ATTN_BLOCK, 0),
        ("bf16_causal_diag", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, bf16, True, 0, 0),
        ("bf16_ragged", DEC_SQ, DEC_SK - dec_k_off, ATTN_D, bf16, True,
         DEC_SK - DEC_SQ, dec_k_off),
    ] + [(f"{name}_d{d}{'_causal' if causal else ''}", 100, 300, d, dt, causal,
          250 if causal else 0, 0)
         for d in (37, 64, 256) for name, dt in (("f32", f32), ("bf16", bf16))
         for causal in (False, True)]
    # the wide kernel (D > 256): the ragged (100, 300) and the path's block
    # size, causal (the diagonal) and not, in both engine dtypes
    attn_cases += [(f"{name}_{sq}x{sk}_d{d}{'_causal' if causal else ''}", sq, sk, d, dt,
                    causal, (250 if sq == 100 else 0) if causal else 0, 0)
                   for sq, sk in ((100, 300), (ATTN_BLOCK, ATTN_BLOCK)) for d in (320, 512)
                   for name, dt in (("f32", f32), ("bf16", bf16)) for causal in (False, True)]
    # operands the f32 engine takes as float32 copies: float16 at the
    # path's block, and mixed q/k/v on the wide kernel
    attn_cases += [("f16_causal_diag", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, torch.float16, True,
                    0, 0),
                   ("mixed_d320_causal", 100, 300, 320, (f32, bf16, torch.float16), True,
                    250, 0)]
    f64_gated = ("f32", "f32_causal_diag")

    def max_err(out, ref):
        return max((o.double() - r.double()).abs().max().item() for o, r in zip(out, ref))

    def carry_err(out, ref):
        """Distance of the kernel's carry from the plain version's as the
        carries they are: (acc, m, l) and (acc e^-d, m + d, l e^-d) are the
        same carry, so acc and l are taken to the plain version's running
        max first (m is compared as it is).  Two f32 versions disagree on
        the largest logit of a row by ~1e-6, which moves an l of ~100 by
        ~1e-4 without changing what the carry holds."""
        acc_k, m_k, l_k = (t.double() for t in out)
        acc_p, m_p, l_p = (t.double() for t in ref)
        shift = torch.exp(m_k - m_p)
        return max_err((acc_k * shift, m_k, l_k * shift), (acc_p, m_p, l_p))

    failures = []
    for label, sq, sk, d, dt, causal, q_off, k_off in attn_cases:
        seed += 1
        dts = dt if isinstance(dt, tuple) else (dt,) * 3
        q, k, v = (rand((n, d), seed + off, t)
                   for n, off, t in zip((sq, sk, sk), (0, 1000, 2000), dts))
        mode = kernels._attention_mode(*dts, d)
        acc = rand((sq, d), seed + 3000)
        m = rand((sq, 1), seed + 4000)
        l = rand((sq, 1), seed + 5000).abs()
        kw = dict(causal=causal, scale=d ** -0.5)
        args = (q, k, v, acc, m, l, q_off, k_off)
        run = lambda: kernels.flash_attention_block(*args, **kw)  # noqa: E731
        plain = lambda: kernels.flash_attention_block_plain(*args, **kw)  # noqa: E731
        out, out2, ref = run(), run(), plain()
        r64 = kernels.flash_attention_block_plain(*args, **kw, compute_dtype=torch.float64)
        torch.cuda.synchronize()
        row = {"shape": [sq, sk, d], "causal": causal, "q_off": q_off, "kernel": mode,
               "k_off": k_off, "tol": TOL_ATTN,
               "max_abs_err": max((o - r).abs().max().item() for o, r in zip(out, ref)),
               "carry_err": carry_err(out, ref),
               "err_vs_f64": max_err(out, r64), "plain_err_vs_f64": max_err(ref, r64),
               "bit_identical": all(torch.equal(a, b) for a, b in zip(out, out2))}
        if not all(bool(torch.isfinite(o).all()) for o in out):
            failures.append(f"{label}: non-finite output")
        if row["err_vs_f64"] >= TOL_ATTN:
            failures.append(f"{label}: max abs err vs the update in float64 "
                            f"{row['err_vs_f64']} >= {TOL_ATTN}")
        if row["carry_err"] >= TOL_ATTN:
            failures.append(f"{label}: carry differs from the plain version's by "
                            f"{row['carry_err']} >= {TOL_ATTN}")
        if not row["bit_identical"]:
            failures.append(f"{label}: two launches on the same inputs differ")
        if label in f64_gated:
            # the f32 mode against the update in float64: at most
            # F64_GATE_FACTOR x the plain version's (cuBLAS FP32) error
            if row["err_vs_f64"] > F64_GATE_FACTOR * row["plain_err_vs_f64"]:
                failures.append(f"{label} vs f64: {row['err_vs_f64']} > "
                                f"{F64_GATE_FACTOR} x the plain version's "
                                f"{row['plain_err_vs_f64']}")
        row["ms"] = time_ms(run)
        row["plain_ms"] = time_ms(plain)
        row["library_ms"], row["library_call"] = None, "none"
        # the bound of this design: f32 as three TF32 passes of each
        # product; bf16 one pass of q.k and two (p's hi and lo) of p.v;
        # f32 on the CUDA cores (the FP32-FMA design) beside it; the wide kernel
        # on the CUDA cores, its logits once per 128-column slab beside it
        pairs = attn_pairs(sq, sk, q_off, k_off, causal)
        nbytes = (q.numel() * q.element_size() + k.numel() * k.element_size()
                  + v.numel() * v.element_size() + 2 * sq * d * 4 + 4 * sq * 4)
        if mode.endswith("_wide"):
            row["bound_ms"], row["bound_by"] = bound(4 * d * pairs, nbytes, "f32")
            row["bound_design_ms"], _ = bound(
                2 * d * pairs * (1 + -(-d // 128)), nbytes, "f32")
        elif mode == "bf16":
            row["bound_ms"], row["bound_by"] = bound(6 * d * pairs, nbytes, "bf16")
        else:
            row["bound_ms"], row["bound_by"] = bound(3 * 4 * d * pairs, nbytes, "tf32")
            row["bound_fp32_ms"], _ = bound(4 * d * pairs, nbytes, "f32")
        results[("flash_attention_block", label)] = row
        say("kernel", name="flash_attention_block", mode=label, **row)

    # the exact no-op, in both dtypes: a fully masked block met while the
    # carry is still at its -1e30/0/0 init leaves acc = 0, l = 0 and m
    # bit-identical
    for name, dt, d in (("f32", f32, ATTN_D), ("bf16", bf16, ATTN_D), ("f32_d512", f32, 512),
                        ("bf16_d512", bf16, 512)):
        q, k, v = (rand((ATTN_BLOCK, d), seed + off, dt) for off in (6000, 7000, 8000))
        acc0 = torch.zeros((ATTN_BLOCK, d), device=dev)
        m0 = torch.full((ATTN_BLOCK, 1), -1e30, device=dev)
        l0 = torch.zeros((ATTN_BLOCK, 1), device=dev)
        acc1, m1, l1 = kernels.flash_attention_block(q, k, v, acc0, m0, l0, 0,
                                                     ATTN_BLOCK, causal=True, scale=0.1)
        torch.cuda.synchronize()
        exact = (acc1.abs().max().item() == 0.0 and l1.abs().max().item() == 0.0
                 and torch.equal(m1, m0))
        if not exact:
            failures.append(f"masked_at_init_{name}: the carry changed")
        say("kernel", name="flash_attention_block", mode=f"masked_at_init_{name}",
            exact=exact)
    check(not failures, "B5 kernel phase:\n  " + "\n  ".join(failures))

    # -- B3 stencil_5pt: every dtype at the path's tile, ragged, unaligned --
    # each output torch.equal to the plain version's and to a second launch
    # (the same additions in the same order, in the grid's dtype)
    st_tile = ST_N // ST_TILES
    dtypes = {"f32": torch.float32, "f64": torch.float64, "f16": torch.float16,
              "bf16": torch.bfloat16}
    st_cases = [(name, (st_tile, st_tile), dt) for name, dt in dtypes.items()] + [
        ("f32_ragged", (1000, 600), torch.float32),
        ("f32_unaligned", (37, 130), torch.float32),     # a 520-byte row pitch
        ("f16_unaligned", (37, 130), torch.float16)]

    def halo_args(h, w, dt, seed):
        old = rand((h, w), seed, dt)
        up, down = rand((1, w), seed + 1000, dt), rand((1, w), seed + 2000, dt)
        # halo columns as the path passes them: edge columns of neighbour
        # tiles, strided views
        left = rand((h, 8), seed + 3000, dt)[:, -1:]
        right = rand((h, 8), seed + 4000, dt)[:, :1]
        return old, up, down, left, right

    failures = []
    for label, (h, w), dt in st_cases:
        seed += 1
        args = halo_args(h, w, dt, seed)
        out, out2 = kernels.stencil_5pt(*args), kernels.stencil_5pt(*args)
        ref = kernels.stencil_5pt_plain(*args)
        torch.cuda.synchronize()
        err = (out.double() - ref.double()).abs().max().item()
        vec = kernels._stencil_vec(w, args[0].element_size(), args[0].data_ptr(),
                                   args[1].data_ptr(), args[2].data_ptr(), out.data_ptr())
        row = {"shape": [h, w], "vec": vec, "max_abs_err": err,
               "equal_plain": bool(torch.equal(out, ref)),
               "bit_identical": bool(torch.equal(out, out2)),
               "ms": time_ms(lambda: kernels.stencil_5pt(*args)),
               "plain_ms": time_ms(lambda: kernels.stencil_5pt_plain(*args)),
               "library_ms": None, "library_call": "none"}
        if not (row["equal_plain"] and row["bit_identical"]):
            failures.append(f"stencil_5pt[{label}]: equal to plain {row['equal_plain']}, "
                            f"two launches equal {row['bit_identical']}")
        isz = args[0].element_size()
        nbytes = (2 * h * w + 2 * (h + w)) * isz
        row["bound_ms"], row["bound_by"] = bound(
            4 * h * w, nbytes, "f64" if dt == torch.float64 else "f32")
        if (h, w) == (st_tile, st_tile):
            # cold L2: rotate over enough distinct inputs and outputs (each
            # output kept alive until its slot comes round again) to exceed
            # twice the 50 MB L2
            n_sets = -(-2 * 50 * 2 ** 20 // (2 * h * w * isz)) + 1
            sets = [halo_args(h, w, dt, seed + 10000 * (i + 1)) for i in range(n_sets)]
            outs = [None] * n_sets
            turn = [0]

            def cold():
                i = turn[0] = (turn[0] + 1) % n_sets
                outs[i] = None
                outs[i] = kernels.stencil_5pt(*sets[i])

            row["cold_ms"] = time_ms(cold, 4 * n_sets)
            row["cold_sets"] = n_sets
            del sets, outs
        results[("stencil_5pt", label)] = row
        say("kernel", name="stencil_5pt", mode=label, **row)
    check(not failures, "B3 kernel phase:\n  " + "\n  ".join(failures))

    # -- B4 stencil_5pt_fused: each mode, dtype by dtype ---------------------
    # (label, n, dtype, expected mode); each torch.equal to the plain
    # version; iters = 1 timed too, so one step costs (t(100) - t(1)) / 99
    sms, smem_optin = kernels._stencil_device_limits(dev)
    fused_cases = [("smem_f32_512", 512, torch.float32, "smem"),
                   ("smem_f32", FUSED_N, torch.float32, "smem"),
                   ("smem_f32_999", 999, torch.float32, "smem"),  # a ragged last strip
                   ("smem_f64_1024", 1024, torch.float64, "smem"),
                   ("smem_f16_1024", 1024, torch.float16, "smem"),
                   ("global_f64", FUSED_N, torch.float64, "global")]
    for label, n, dt, want in fused_cases:
        seed += 1
        grid = rand((n, n), seed, dt)
        cfg = kernels._fused_mode(n, n, grid.element_size(), sms, smem_optin)
        check(cfg.mode == want, f"stencil_5pt_fused[{label}]: mode {cfg}, expected {want}")
        kernels.reset_counts()
        out = kernels.stencil_5pt_fused(grid, FUSED_ITERS)
        out2 = kernels.stencil_5pt_fused(grid, FUSED_ITERS)
        by_mode = dict(kernels.stencil_5pt_fused.launches_by_mode)
        ref = kernels.stencil_5pt_fused_plain(grid, FUSED_ITERS)
        one = kernels.stencil_5pt_fused(grid, 1)
        torch.cuda.synchronize()
        err = (out.double() - ref.double()).abs().max().item()
        vec = cfg.mode == "smem" and kernels._stencil_vec(n, grid.element_size(),
                                                          out.data_ptr())
        row = {"shape": [n, n], "iters": FUSED_ITERS, "config": cfg._asdict(), "vec": vec,
               "max_abs_err": err, "equal_plain": bool(torch.equal(out, ref)),
               "bit_identical": bool(torch.equal(out, out2)),
               "iters1_equal_plain": bool(torch.equal(
                   one, kernels.stencil_5pt_fused_plain(grid, 1))),
               "ms": time_ms(lambda: kernels.stencil_5pt_fused(grid, FUSED_ITERS), 10),
               "iters1_ms": time_ms(lambda: kernels.stencil_5pt_fused(grid, 1), 20),
               "plain_ms": time_ms(lambda: kernels.stencil_5pt_fused_plain(grid, FUSED_ITERS), 3),
               "library_ms": None, "library_call": "none"}
        row["step_ms"] = (row["ms"] - row["iters1_ms"]) / (FUSED_ITERS - 1)
        check(by_mode[want] == 2 and sum(by_mode.values()) == 2,
              f"stencil_5pt_fused[{label}]: launches by mode {by_mode}")
        check(row["equal_plain"] and row["bit_identical"] and row["iters1_equal_plain"],
              f"stencil_5pt_fused[{label}]: equal to plain {row['equal_plain']}, two "
              f"launches equal {row['bit_identical']}, one step equal "
              f"{row['iters1_equal_plain']} (max abs err {err})")
        row["bound_ms"], row["bound_by"] = bound(
            4 * n * n * FUSED_ITERS, 2 * n * n * grid.element_size(),
            "f64" if dt == torch.float64 else "f32")
        results[("stencil_5pt_fused", label)] = row
        say("kernel", name="stencil_5pt_fused", mode=label, **row)
        del grid, out, out2, ref, one

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
        factored matrix, wall seconds, kernel launches per operand mode and
        the CUDA device module's stats, with ``flush_s``: the seconds of
        ctx.fini(), which writes the factor home after the window."""
        n_in = S_in.shape[0]
        A = TiledMatrix(n_in, n_in, NB, NB, name="A", dtype=np.float32).from_array(S_in)
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            check(cuda_dev.tdev.type == "cuda", f"CUDA module bound to {cuda_dev.tdev}")
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
            kernels.reset_counts()
            gc.collect()  # each timed window starts with no garbage pending
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                      for fn in (kernels.matmul_update, kernels.matmul)}
        finally:
            # the write-back home (committer flush + batched D2H), timed
            # apart from fini's teardown; fini's own detach finds it done
            t0 = time.perf_counter()
            cuda_dev.detach()
            detach_s = time.perf_counter() - t0
            ctx.fini()
            flush = time.perf_counter() - t0
        check(ok, f"dpotrf {kw}: taskpool failed ({tp.fail_reason})")
        stats = device_stats(cuda_dev, flush_s=flush, detach_s=detach_s)
        check(stats["wb_sync_fallbacks"] == 0, f"dpotrf {kw}: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return A, wall, counts, stats

    launches = {}
    dyn_factor, dyn_wall = {}, {}
    depth_walls = DepthWalls()
    for name, kw, recon_tol in variants:
        trtri = kw.get("use_trtri", False)
        ntasks = dpotrf_task_count(nt, use_trtri=trtri)
        # the f32 variants at the default stage depth 1 (no committer) and
        # at depth 2 (the write-back committer), in turns
        depths = STAGE_DEPTHS if name in ("kernels", "kernels_trtri") else (2,)
        for rep, depth in enumerate(depths):
            with stage_depth(mca_param, depth):
                A, wall, counts, stats = run_dpotrf(kw)
            if rep == 0:
                dyn_wall[name] = wall
            if len(depths) > 1:
                depth_walls.add(f"dpotrf {name}", depth, wall)
            executed = stats["executed_tasks"]
            check(executed == ntasks,
                  f"{name}: {executed} tasks on the CUDA device, expected {ntasks}")
            n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
            n_mm = nt * (nt - 1) // 2 if trtri else 0
            upd_mode = "bf16" if kw.get("bf16_updates") else "f32"
            expected = {"matmul_update": dict(f32=0, bf16=0, split=0, total=n_upd),
                        "matmul": dict(f32=n_mm, bf16=0, total=n_mm)}
            expected["matmul_update"][upd_mode] = n_upd
            check(counts == expected, f"{name}: launches {counts}, expected {expected}")
            launches[name if rep == 0 else f"{name}_{rep}"] = counts
            factor = A.to_array()
            if name in ("kernels", "kernels_trtri"):
                if rep == 0:
                    dyn_factor[name] = factor  # every other run must equal it
                else:
                    check(np.array_equal(factor, dyn_factor[name]),
                          f"{name} at depth {depth}: the factor differs from the "
                          "first run's")
            L = torch.from_numpy(factor).to(dev).double().tril()
            check(bool(torch.isfinite(L).all()), f"{name}: non-finite factor")
            recon = ((L @ L.mT - S64).abs().max() / s_max).item()
            last = ((L[-NB:, -NB:] - L_ref_last).abs().max() / scale).item()
            del L
            check(last < 1e-3, f"{name}: last-tile error {last} >= 1e-3")
            check(recon < recon_tol,
                  f"{name}: ||LL^T-S||max/||S||max {recon} >= {recon_tol}")
            say("dpotrf", variant=name, stage_depth=depth, rep=rep, N=N, nb=NB,
                tasks=ntasks, wall_s=wall, gflops=N ** 3 / 3 / wall / 1e9,
                tasks_per_s=ntasks / wall, launches=counts, last_tile_err=last,
                recon_err=recon, recon_tol=recon_tol, equal_first_run=True,
                **pipeline_fields(stats))
            del factor

    # -- native phase: the same dpotrf through the native pump ---------------
    def run_dpotrf_native(kw):
        """One dpotrf through NativeExecutor(native_device=True).  Capture
        and build stay outside the timed window (as bench.py's
        dynamic_native_leg); the window is ex.run() + synchronize; close()
        (the write-back home) follows it, as ctx.fini() does for the
        dynamic path.  The dynamic window holds the startup enumeration
        that capture + build replace, so set-up + wall is what compares
        with the dynamic wall.  Returns the matrix, tasks run, wall and
        set-up seconds, launches per operand mode and the executor's stats
        merged with its device module's (:func:`device_stats`, ``flush_s``
        the seconds of close())."""
        A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S)
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
        gc.collect()  # each timed window starts with no garbage pending
        t0 = time.perf_counter()
        ex = NativeExecutor(tp, native_device=True)
        setup = time.perf_counter() - t0
        try:
            check(ex.device.tdev.type == "cuda", f"pump device bound to {ex.device.tdev}")
            kernels.reset_counts()
            t0 = time.perf_counter()
            ran = ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                      for fn in (kernels.matmul_update, kernels.matmul)}
            stats = dict(ex.stats)
        finally:
            t0 = time.perf_counter()
            ex.close()
            flush = time.perf_counter() - t0
        stats.update(device_stats(ex.device, flush_s=flush))
        check(stats["wb_sync_fallbacks"] == 0, f"native dpotrf {kw}: synchronous "
              f"write-back fallbacks {stats['wb_sync_fallbacks']}")
        return A, ran, wall, setup, counts, stats

    def pump_gates(label, ran, ntasks, stats):
        check(ran == ntasks, f"{label}: the pump ran {ran} tasks, expected {ntasks}")
        check(stats["trampoline_entries"] == 0 and stats["completion_callbacks"] == 0,
              f"{label}: per-task interpreter entries in pump mode ({stats})")
        check(stats["pop_batches"] > 0 and stats["pumped_tasks"] == ntasks,
              f"{label}: pump stats {stats}")

    def native_dpotrf_checks(label, kw, recon_tol, A, ran, counts, stats, dyn_name):
        """The pump run's gates: tasks, launches and factor equal to the
        dynamic run's; returns the factor's errors."""
        pump_gates(label, ran, dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False)),
                   stats)
        check(counts == launches[dyn_name],
              f"{label}: launches {counts}, dynamic path {launches[dyn_name]}")
        factor = A.to_array()
        check(np.array_equal(factor, dyn_factor[dyn_name]),
              f"{label}: factor differs from the dynamic path's")
        L = torch.from_numpy(factor).to(dev).double().tril()
        recon = ((L @ L.mT - S64).abs().max() / s_max).item()
        last = ((L[-NB:, -NB:] - L_ref_last).abs().max() / scale).item()
        del L, factor
        check(last < 1e-3, f"{label}: last-tile error {last} >= 1e-3")
        check(recon < recon_tol, f"{label}: ||LL^T-S||max/||S||max {recon} >= {recon_tol}")
        return last, recon

    for name, kw, recon_tol in variants[:2]:
        for rep, depth in enumerate(STAGE_DEPTHS):
            with stage_depth(mca_param, depth):
                A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
            label = f"native {name} depth {depth}"
            last, recon = native_dpotrf_checks(label, kw, recon_tol, A, ran, counts,
                                               stats, name)
            check((stats["prefetched_batches"] > 0) == (depth > 1),
                  f"{label}: {stats['prefetched_batches']} prefetched batches")
            launches[f"native_{name}_{rep}"] = counts
            depth_walls.add(f"dpotrf {name} pump", depth, wall)
            # wall_s is ex.run() alone; the dynamic wall also holds its
            # startup enumeration, so set-up + run is the window that
            # compares with it (the dynamic run at the default depth 1)
            say("native", path="dpotrf", variant=name, stage_depth=depth, rep=rep,
                N=N, nb=NB, tasks=ran, wall_s=wall, capture_build_s=setup,
                tasks_per_s=ran / wall,
                host_ms_per_task=wall / ran * 1e3, pop_batches=stats["pop_batches"],
                prefetched_batches=stats["prefetched_batches"],
                setup_plus_wall_s=setup + wall, dynamic_wall_s=dyn_wall[name],
                same_window_ratio=(setup + wall) / dyn_wall[name],
                same_window_host_ms_per_task=(setup + wall) / ran * 1e3,
                dynamic_host_ms_per_task=dyn_wall[name] / ran * 1e3,
                launches=counts, equal_dynamic=True, last_tile_err=last, recon_err=recon,
                **pipeline_fields(stats))

    # eviction under pressure: a 96 MB device budget, below the 256 MiB
    # matrix, so the pump's device evicts and commits under the pipeline
    name, kw, recon_tol = variants[0]
    mca_param.set_param("device", "cuda_mem_budget_mb", 96)
    try:
        with stage_depth(mca_param, 2):
            A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
    finally:
        mca_param.unset("device", "cuda_mem_budget_mb")
    last, recon = native_dpotrf_checks(f"native {name} under 96 MB", kw, recon_tol,
                                       A, ran, counts, stats, name)
    check(stats["evictions"] > 0, f"native {name} under 96 MB: no eviction ({stats})")
    launches[f"native_{name}_pressure"] = counts
    say("native", path="dpotrf", variant=name, stage_depth=2, budget_mb=96, N=N, nb=NB,
        tasks=ran, wall_s=wall, capture_build_s=setup, setup_plus_wall_s=setup + wall,
        pop_batches=stats["pop_batches"], prefetched_batches=stats["prefetched_batches"],
        launches=counts, equal_dynamic=True, last_tile_err=last, recon_err=recon,
        **pipeline_fields(stats))
    del dyn_factor

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
            factor_err=err, **pipeline_fields(stats))

    # -- attention path: run_flash_attention on the CUDA device module -------
    # q/k/v from numpy seed 9 as bench.py makes them; the decode step's
    # queries are the last DEC_SQ rows of a DEC_SK-row q, so its oracle is
    # the tail of the full causal attention
    rng = np.random.default_rng(9)
    mk = lambda s_len: rng.standard_normal(  # noqa: E731
        (ATTN_B, s_len, ATTN_H, ATTN_D)).astype(np.float32)
    pre_q, pre_k, pre_v = mk(ATTN_S), mk(ATTN_S), mk(ATTN_S)
    dec_q, dec_k, dec_v = mk(DEC_SK), mk(DEC_SK), mk(DEC_SK)

    def on_card(*arrays, dtype=torch.float32):
        return [torch.from_numpy(a).to(dev).to(dtype) for a in arrays]

    def allclose_gate(out, ref, tol):
        """max(|out - ref| - tol*|ref|): <= tol is allclose(rtol=tol, atol=tol)."""
        diff = (out.to(dev).double() - ref).abs()
        return (diff - tol * ref.abs()).max().item(), diff.max().item()

    def run_attention(q, k, v, **kw):
        """One run_flash_attention through Context/add_taskpool/wait with
        every task on the CUDA device module; returns the output, wall
        seconds (build, run and assemble: the whole entry-point call), B5
        launches and the CUDA module's stats with ``flush_s``, the seconds
        of ctx.fini()."""
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            check(cuda_dev.tdev.type == "cuda", f"CUDA module bound to {cuda_dev.tdev}")
            kernels.reset_counts()
            gc.collect()  # each timed window starts with no garbage pending
            t0 = time.perf_counter()
            out = run_flash_attention(ctx, q, k, v, use_cpu=False, **kw)
            wall = time.perf_counter() - t0
            n_launch = dict(kernels.flash_attention_block.launches_by_mode,
                            total=kernels.flash_attention_block.launches)
        finally:
            # the write-back home (committer flush + batched D2H), timed
            # apart from fini's teardown; fini's own detach finds it done
            t0 = time.perf_counter()
            cuda_dev.detach()
            detach_s = time.perf_counter() - t0
            ctx.fini()
            flush = time.perf_counter() - t0
        stats = device_stats(cuda_dev, flush_s=flush, detach_s=detach_s)
        check(stats["wb_sync_fallbacks"] == 0, f"attention {kw}: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return out, wall, n_launch, stats

    attn_runs = [  # (name, q, k, v, dtype, kwargs, tolerance)
        ("attn_prefill_f32", (pre_q, pre_k, pre_v), torch.float32,
         dict(causal=True, q_block=ATTN_BLOCK, kv_block=ATTN_BLOCK), TOL_ATTN_F32),
        ("attn_prefill_bf16", (pre_q, pre_k, pre_v), torch.bfloat16,
         dict(causal=True, q_block=ATTN_BLOCK, kv_block=ATTN_BLOCK), TOL_ATTN_BF16),
        ("attn_decode", (dec_q[:, -DEC_SQ:], dec_k, dec_v), torch.float32,
         dict(causal=True, q_block="auto", kv_block=ATTN_BLOCK), TOL_ATTN_F32),
    ]
    attn_launches = {}
    attn_out, attn_wall = {}, {}
    for name, (q_np, k_np, v_np), dt, kw, tol in attn_runs:
        q_in, k_in, v_in = (torch.from_numpy(a).to(dt) for a in (q_np, k_np, v_np))
        sq, sk = q_in.shape[1], k_in.shape[1]
        qb = ATTN_BLOCK if kw["q_block"] != "auto" else min(128, sq)
        ntasks = attention_task_count(ATTN_B, sq, sk, ATTN_H, qb, kw["kv_block"],
                                      causal=True)
        n_steps = ntasks - ATTN_B * ATTN_H * (-(-sq // qb))
        expected = dict.fromkeys(kernels.flash_attention_block.launches_by_mode, 0)
        expected.update({"bf16" if dt == torch.bfloat16 else "f32": n_steps, "total": n_steps})
        # the f32 prefill at the default stage depth 1 and at depth 2, in turns
        depths = STAGE_DEPTHS if name == "attn_prefill_f32" else (2,)
        runs = []
        for rep, depth in enumerate(depths):
            with stage_depth(mca_param, depth):
                out, wall, n_launch, stats = run_attention(q_in, k_in, v_in, **kw)
            check(tuple(out.shape) == tuple(q_in.shape) and out.dtype == dt,
                  f"{name}: output {tuple(out.shape)} {out.dtype}")
            check(stats["executed_tasks"] == ntasks,
                  f"{name}: {stats['executed_tasks']} tasks on the CUDA device, "
                  f"expected {ntasks}")
            check(n_launch == expected,
                  f"{name}: flash_attention_block launches {n_launch}, expected {expected}")
            attn_launches[name if rep == 0 else f"{name}_{rep}"] = n_launch
            if rep == 0:
                first, attn_wall[name] = out, wall
            else:
                check(torch.equal(out, first),
                      f"{name} at depth {depth}: output differs from the first run's")
            if len(depths) > 1:
                depth_walls.add(name, depth, wall)
            runs.append((depth, wall, stats))
            del out
        out = first
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        # float64 oracle on the inputs the run saw (bf16-rounded for bf16)
        if name == "attn_decode":
            q64, k64, v64 = on_card(dec_q, dec_k, dec_v, dtype=torch.float64)
            ref = attention_reference(q64, k64, v64, causal=True)[:, -DEC_SQ:]
        else:
            q64, k64, v64 = (t.to(dev).double() for t in (q_in, k_in, v_in))
            ref = attention_reference(q64, k64, v64, causal=True)
        del q64, k64, v64
        gate, max_err = allclose_gate(out, ref, tol)
        del ref
        check(gate <= tol, f"{name}: |out - ref| - {tol}|ref| reaches {gate} > {tol}")
        flops = 4.0 * ATTN_B * ATTN_H * sq * sk * ATTN_D
        if name == "attn_prefill_f32":
            attn_out[name] = out  # the pump's output must equal it
        for rep, (depth, wall, stats) in enumerate(runs):
            say("attention", run=name, stage_depth=depth, rep=rep, B=ATTN_B, Sq=sq,
                Sk=sk, H=ATTN_H, D=ATTN_D, dtype=str(dt), q_block=qb,
                kv_block=kw["kv_block"], tasks=ntasks, launches=n_steps, wall_s=wall,
                nominal_gflops=flops / wall / 1e9, tasks_per_s=ntasks / wall,
                max_abs_err=max_err, gate=gate, tol=tol, equal_first_run=True,
                **pipeline_fields(stats))
        del out, first
        torch.cuda.empty_cache()

    # -- native phase: the f32 prefill through the native pump ----------------
    pf_name, (q_np, k_np, v_np), dt, pf_kw, tol = attn_runs[0]
    pf_in = [torch.from_numpy(a).to(dt) for a in (q_np, k_np, v_np)]
    pf_tasks = attention_task_count(ATTN_B, ATTN_S, ATTN_S, ATTN_H, ATTN_BLOCK,
                                    ATTN_BLOCK, causal=True)
    pf_steps = pf_tasks - ATTN_B * ATTN_H * (ATTN_S // ATTN_BLOCK)

    def run_attention_native():
        """run_flash_attention_native, the user entry point: build, capture,
        pump and assemble in one call, on a device module of its own so
        its staging counters can be read.  Returns the output, wall
        seconds, B5 launches per mode and the device's stats."""
        kernels.reset_counts()
        gc.collect()  # each timed window starts with no garbage pending
        t0 = time.perf_counter()
        pump_dev = NativeExecutor._make_device()
        out = run_flash_attention_native(*pf_in, device=pump_dev, **pf_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = device_stats(pump_dev, flush_s=0.0)
        check(stats["wb_sync_fallbacks"] == 0, "native prefill: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return out, wall, dict(kernels.flash_attention_block.launches_by_mode,
                               total=kernels.flash_attention_block.launches), stats

    def b5_gates(label, out, n_launch):
        expected = dict.fromkeys(kernels.flash_attention_block.launches_by_mode, 0)
        expected.update({"f32": pf_steps, "total": pf_steps})
        check(n_launch == expected,
              f"{label}: flash_attention_block launches {n_launch}, expected {expected}")
        check(torch.equal(out, attn_out[pf_name]),
              f"{label}: output differs from run_flash_attention's")

    ref = attention_reference(*(t.to(dev).double() for t in pf_in), causal=True)
    for rep, depth in enumerate(STAGE_DEPTHS):
        with stage_depth(mca_param, depth):
            out, wall_total, n_launch, stats = run_attention_native()
        b5_gates(f"native attn_prefill_f32 depth {depth}", out, n_launch)
        attn_launches[f"{pf_name}_native_{rep}"] = n_launch
        depth_walls.add(f"{pf_name} pump", depth, wall_total)
        gate, max_err = allclose_gate(out, ref, tol)
        del out
        check(gate <= tol, f"native {pf_name} depth {depth}: |out - ref| - {tol}|ref| "
                           f"reaches {gate} > {tol}")
        # the whole entry-point call against the whole dynamic call
        say("native", path="attention", run=pf_name, stage_depth=depth, rep=rep,
            entry_point_wall_s=wall_total, dynamic_wall_s=attn_wall[pf_name],
            same_window_ratio=wall_total / attn_wall[pf_name],
            launches=n_launch["total"], equal_dynamic=True, max_abs_err=max_err,
            gate=gate, tol=tol, **pipeline_fields(stats))
    del ref
    # the default depth's entry-point wall, the median of its runs
    wall_total = statistics.median(depth_walls.walls[f"{pf_name} pump"][2])
    # the same call's pieces, to time each apart: the graph's build, capture
    # + engine build, the pump, close() and assemble()
    t0 = time.perf_counter()
    tp, assemble = build_flash_attention(*pf_in, use_cpu=False, **pf_kw)
    t1 = time.perf_counter()
    ex = NativeExecutor(tp, native_device=True)
    t2 = time.perf_counter()
    graph_s, setup = t1 - t0, t2 - t1
    try:
        kernels.reset_counts()
        t0 = time.perf_counter()
        ran = ex.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = dict(kernels.flash_attention_block.launches_by_mode,
                        total=kernels.flash_attention_block.launches)
        stats = dict(ex.stats)
    finally:
        t0 = time.perf_counter()
        ex.close()
        close_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = assemble()
    assemble_s = time.perf_counter() - t0
    stats.update(device_stats(ex.device, flush_s=close_s))
    check(stats["wb_sync_fallbacks"] == 0, f"native {pf_name} (pieces): synchronous "
          f"write-back fallbacks {stats['wb_sync_fallbacks']}")
    pump_gates(f"native {pf_name} (pieces)", ran, pf_tasks, stats)
    b5_gates(f"native {pf_name} (pieces)", out, n_launch)
    del out
    attn_launches[f"{pf_name}_native_pieces"] = n_launch
    # wall_s is ex.run() alone; the dynamic wall is the whole
    # run_flash_attention call (build, run, assemble), so the whole
    # run_flash_attention_native call is the window that compares with it
    say("native", path="attention", run=pf_name, tasks=ran, wall_s=wall,
        capture_build_s=setup, tasks_per_s=ran / wall, host_ms_per_task=wall / ran * 1e3,
        pop_batches=stats["pop_batches"], graph_build_s=graph_s, close_s=close_s,
        assemble_s=assemble_s, entry_point_wall_s=wall_total,
        dynamic_wall_s=attn_wall[pf_name], same_window_ratio=wall_total / attn_wall[pf_name],
        same_window_host_ms_per_task=wall_total / ran * 1e3,
        dynamic_host_ms_per_task=attn_wall[pf_name] / ran * 1e3,
        prefetched_batches=stats["prefetched_batches"], launches=n_launch["total"],
        equal_dynamic=True, **pipeline_fields(stats))
    del tp, assemble, ex, attn_out
    torch.cuda.empty_cache()

    # the yardstick users would otherwise call: PyTorch's fused attention on
    # the whole f32 prefill problem ([B, H, S, D] layout), timed only
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous()
                  for t in on_card(pre_q, pre_k, pre_v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True)
    sdpa_out = sdpa().permute(0, 2, 1, 3)
    ref = attention_reference(*on_card(pre_q, pre_k, pre_v, dtype=torch.float64),
                              causal=True)
    sdpa_rel = ((sdpa_out.double() - ref).abs().max() / ref.abs().max()).item()
    del ref, sdpa_out
    check(sdpa_rel < 1e-3, f"scaled_dot_product_attention disagrees with the "
                           f"reference: {sdpa_rel}")
    sdpa_ms = time_ms(sdpa, 10)
    say("attention_yardstick", call="torch.nn.functional.scaled_dot_product_attention"
        "(is_causal=True)", shape=[ATTN_B, ATTN_H, ATTN_S, ATTN_D], dtype="float32",
        ms=sdpa_ms, rel_err=sdpa_rel,
        nominal_gflops=4.0 * ATTN_B * ATTN_H * ATTN_S ** 2 * ATTN_D / sdpa_ms / 1e6)
    del qh, kh, vh
    torch.cuda.empty_cache()

    # -- stencil path: the stencil PTG with the B3 chore, then B4 ----------
    grid = np.random.default_rng(0).standard_normal((ST_N, ST_N)).astype(np.float32)
    g64 = torch.from_numpy(grid).to(dev).double()
    zr = torch.zeros((1, ST_N), dtype=torch.float64, device=dev)
    zc = torch.zeros((ST_N, 1), dtype=torch.float64, device=dev)
    st_ref = g64
    for _ in range(ST_T):
        st_ref = kernels.stencil_5pt_plain(st_ref, zr, zr, zc, zc)
    n_tasks_st = ST_T * ST_TILES * ST_TILES

    def run_stencil():
        """One stencil PTG run (B3 chores, every task on the CUDA device
        module); returns the buffers, wall seconds, B3 launches, stats with
        ``flush_s``, the seconds of ctx.fini()."""
        A = StencilBuffers(grid, ST_TILES, ST_TILES)
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            tp = stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
                T=ST_T, MT=ST_TILES, NT=ST_TILES, A=A)
            kernels.reset_counts()
            gc.collect()  # each timed window starts with no garbage pending
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = kernels.stencil_5pt.launches
        finally:
            # the write-back home (committer flush + batched D2H), timed
            # apart from fini's teardown; fini's own detach finds it done
            t0 = time.perf_counter()
            cuda_dev.detach()
            detach_s = time.perf_counter() - t0
            ctx.fini()
            flush = time.perf_counter() - t0
        check(ok, f"stencil: taskpool failed ({tp.fail_reason})")
        stats = device_stats(cuda_dev, flush_s=flush, detach_s=detach_s)
        check(stats["wb_sync_fallbacks"] == 0, "stencil: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return A, wall, n_launch, stats

    def run_stencil_native():
        """The same stencil through NativeExecutor(native_device=True): set-up
        (capture + build) outside the window, the window ex.run() +
        synchronize, then close() (the write-back home).  Returns the
        buffers, tasks run, wall and set-up seconds, B3 launches and the
        executor's stats merged with its device module's."""
        A = StencilBuffers(grid, ST_TILES, ST_TILES)
        tp = stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
            T=ST_T, MT=ST_TILES, NT=ST_TILES, A=A)
        gc.collect()  # each timed window starts with no garbage pending
        t0 = time.perf_counter()
        ex = NativeExecutor(tp, native_device=True)
        setup = time.perf_counter() - t0
        try:
            check(ex.device.tdev.type == "cuda", f"pump device bound to {ex.device.tdev}")
            kernels.reset_counts()
            t0 = time.perf_counter()
            ran = ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = kernels.stencil_5pt.launches
            stats = dict(ex.stats)
        finally:
            t0 = time.perf_counter()
            ex.close()
            flush = time.perf_counter() - t0
        stats.update(device_stats(ex.device, flush_s=flush))
        check(stats["wb_sync_fallbacks"] == 0, "native stencil: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return A, ran, wall, setup, n_launch, stats

    # through Context at the default stage depth 1 and at depth 2, in turns
    st_launch_total = 0
    for rep, depth in enumerate(STAGE_DEPTHS):
        with stage_depth(mca_param, depth):
            A, wall, st_launches, stats = run_stencil()
        check(stats["executed_tasks"] == n_tasks_st,
              f"stencil: {stats['executed_tasks']} tasks on the CUDA device, "
              f"expected {n_tasks_st}")
        check(st_launches == n_tasks_st,
              f"stencil: {st_launches} stencil_5pt launches, expected {n_tasks_st}")
        st_launch_total += st_launches
        depth_walls.add("stencil", depth, wall)
        if rep == 0:
            st_dyn, st_wall = A.to_array(ST_T % 2), wall
            got = torch.from_numpy(st_dyn).to(dev).double()
            st_gate, st_err = allclose_gate(got, st_ref, TOL_STENCIL_PATH)
            del got
            check(st_gate <= TOL_STENCIL_PATH, f"stencil: |out - ref| - tol|ref| "
                                               f"reaches {st_gate} > {TOL_STENCIL_PATH}")
        else:
            check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
                  f"stencil at depth {depth}: grid differs from the first run's")
        say("stencil", N=ST_N, tile=ST_N // ST_TILES, T=ST_T, tasks=n_tasks_st,
            launches=st_launches, wall_s=wall, stage_depth=depth, rep=rep,
            gcells_per_s=ST_N * ST_N * ST_T / wall / 1e9, max_abs_err=st_err,
            gate=st_gate, tol=TOL_STENCIL_PATH, equal_first_run=True,
            **pipeline_fields(stats))
        del A
    # the stencil through the native pump, at stage depth 1 and 2 in turns,
    # then at depth 2 with the reference's 32 MB write-back watermark (the
    # committer then drains mid-run, beside the kernels)
    for rep, (depth, window_mb) in enumerate([(d, None) for d in STAGE_DEPTHS]
                                             + [(2, 32)]):
        if window_mb is not None:
            mca_param.set_param("runtime", "wb_window_mb", window_mb)
        try:
            with stage_depth(mca_param, depth):
                A, ran, wall, setup, n_launch, stats = run_stencil_native()
        finally:
            if window_mb is not None:
                mca_param.unset("runtime", "wb_window_mb")
        label = f"native stencil depth {depth}" + (f" window {window_mb} MB"
                                                   if window_mb else "")
        pump_gates(label, ran, n_tasks_st, stats)
        check(n_launch == n_tasks_st,
              f"{label}: {n_launch} stencil_5pt launches, expected {n_tasks_st}")
        check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
              f"{label}: grid differs from the dynamic path's")
        check((stats["prefetched_batches"] > 0) == (depth > 1),
              f"{label}: {stats['prefetched_batches']} prefetched batches")
        st_launch_total += n_launch
        if window_mb is None:
            depth_walls.add("stencil pump", depth, wall)
        say("native", path="stencil", stage_depth=depth, rep=rep,
            wb_window_mb=window_mb or 0, N=ST_N, tile=ST_N // ST_TILES,
            T=ST_T, tasks=ran, launches=n_launch, wall_s=wall, capture_build_s=setup,
            setup_plus_wall_s=setup + wall, dynamic_wall_s=st_wall,
            same_window_ratio=(setup + wall) / st_wall, host_ms_per_task=wall / ran * 1e3,
            pop_batches=stats["pop_batches"], prefetched_batches=stats["prefetched_batches"],
            equal_dynamic=True, **pipeline_fields(stats))
        del A
    del st_ref, zr, zc

    g_lead = torch.from_numpy(np.ascontiguousarray(grid[:FUSED_N, :FUSED_N])).to(dev)
    f_ref = g_lead.double()
    zr = torch.zeros((1, FUSED_N), dtype=torch.float64, device=dev)
    zc = torch.zeros((FUSED_N, 1), dtype=torch.float64, device=dev)
    for _ in range(FUSED_ITERS):
        f_ref = kernels.stencil_5pt_plain(f_ref, zr, zr, zc, zc)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    f_out = kernels.stencil_5pt_fused(g_lead, FUSED_ITERS)
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    fused_launches = dict(kernels.stencil_5pt_fused.launches_by_mode)
    check(fused_launches == {"smem": 1, "global": 0},
          f"stencil fused: launches by mode {fused_launches}, expected one smem launch")
    f_gate, f_err = allclose_gate(f_out, f_ref, TOL_STENCIL_PATH)
    check(f_gate <= TOL_STENCIL_PATH,
          f"stencil fused: |out - ref| - tol|ref| reaches {f_gate} > {TOL_STENCIL_PATH}")
    say("stencil_fused", N=FUSED_N, iters=FUSED_ITERS, launches=fused_launches["smem"],
        wall_s=f_wall, gcells_per_s=FUSED_N * FUSED_N * FUSED_ITERS / f_wall / 1e9,
        max_abs_err=f_err, gate=f_gate, tol=TOL_STENCIL_PATH)
    del g64, f_ref, f_out, g_lead
    torch.cuda.empty_cache()

    # -- transfer phase: the copy engine against pageable copies --------------
    # the stencil's 64 tiles of 4 MiB, twice (512 MiB each way), through the
    # device module's engine (pinned ring, copy streams; in batches of 32,
    # as the lane and the committer move them) and through pageable .to() /
    # .cpu(), in turns: pageable, engine, engine, pageable
    xfer_dev = NativeExecutor._make_device()
    tile = ST_N // ST_TILES
    host_tiles = [np.ascontiguousarray(grid[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile])
                  for i in range(ST_TILES) for j in range(ST_TILES)] * 2
    xfer_bytes = sum(t.nbytes for t in host_tiles)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gbps = {"h2d_pageable": [], "h2d_engine": [], "d2h_pageable": [], "d2h_engine": []}
    for how in ("pageable", "engine", "engine", "pageable"):
        if how == "engine":
            d_tiles, secs = timed(lambda: [d for i in range(0, len(host_tiles), 32)
                                           for d in xfer_dev._h2d_batch(host_tiles[i:i + 32])])
            d2h = lambda: [h for i in range(0, len(d_tiles), 32)  # noqa: E731
                           for h in xfer_dev._d2h_batch(d_tiles[i:i + 32])]
        else:
            d_tiles, secs = timed(lambda: [torch.from_numpy(t).to(dev) for t in host_tiles])
            d2h = lambda: [t.cpu().numpy() for t in d_tiles]  # noqa: E731
        gbps[f"h2d_{how}"].append(xfer_bytes / secs / 1e9)
        hosts, secs = timed(d2h)
        gbps[f"d2h_{how}"].append(xfer_bytes / secs / 1e9)
        check(all(np.array_equal(h, t) for h, t in zip(hosts, host_tiles)),
              f"transfer [{how}]: the round trip changed a tile")
        del d_tiles, hosts
    say("transfer", tiles=len(host_tiles), tile_bytes=host_tiles[0].nbytes,
        bytes_each_way=xfer_bytes, gbps=gbps, pinned_peak_bytes=xfer_dev.pinned_bytes[1],
        h2d_copies=xfer_dev.stats["h2d_copies"], d2h_copies=xfer_dev.stats["d2h_copies"])
    del host_tiles, xfer_dev
    torch.cuda.empty_cache()

    if "--profile" in sys.argv[1:]:
        # where the time goes: one extra run of each f32 dpotrf variant, the
        # f32 prefill and the stencil under torch.profiler.  Copies run on
        # their own streams and may overlap kernels, so device busy is the
        # UNION of every kernel's and copy's device interval (their sum is
        # printed beside it), and the copy time that overlaps kernel time is
        # union(copies) + union(kernels) - union(all).  `run` returns the
        # seconds its busy time is counted against — the timed window plus
        # the write-back home that follows it (ctx.fini() / close()), whose
        # copies the profiler sees too — and those seconds' parts, with
        # the bytes each direction moved
        from torch.profiler import ProfilerActivity, profile

        def union_us(spans):
            total, end = 0.0, None
            for s0, s1 in sorted(spans):
                if end is None or s0 > end:
                    total += s1 - s0
                    end = s1
                elif s1 > end:
                    total += s1 - end
                    end = s1
            return total

        def profiled(label, run):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall, parts = run()
            spans = {"h2d": [], "d2h": [], "kernel": []}
            rows = {}
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                what = ("h2d" if ev.name.startswith("Memcpy HtoD") else
                        "d2h" if ev.name.startswith("Memcpy DtoH") else "kernel")
                spans[what].append((ev.time_range.start, ev.time_range.end))
                row = rows.setdefault(ev.name, [0.0, 0])
                row[0] += ev.time_range.end - ev.time_range.start
                row[1] += 1
            copies = spans["h2d"] + spans["d2h"]
            busy_us = union_us(copies + spans["kernel"])
            copy_us, kernel_us = union_us(copies), union_us(spans["kernel"])
            overlap_us = copy_us + kernel_us - busy_us
            h2d_ms = sum(e - b for b, e in spans["h2d"]) / 1e3
            d2h_ms = sum(e - b for b, e in spans["d2h"]) / 1e3
            top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
            say("profile", variant=label, window_s=wall, device_busy_ms=busy_us / 1e3,
                busy_sum_ms=sum(e - b for v in spans.values() for b, e in v) / 1e3,
                device_idle_share=1.0 - busy_us / 1e6 / wall,
                h2d_ms=h2d_ms, h2d_count=len(spans["h2d"]),
                d2h_ms=d2h_ms, d2h_count=len(spans["d2h"]),
                h2d_gbps=parts.get("bytes_in", 0) / h2d_ms / 1e6 if h2d_ms else None,
                d2h_gbps=parts.get("bytes_out", 0) / d2h_ms / 1e6 if d2h_ms else None,
                kernel_ms=kernel_us / 1e3, copy_kernel_overlap_ms=overlap_us / 1e3,
                copy_overlap_share=overlap_us / copy_us if copy_us else None,
                parts=parts, top=[{"kernel": k[:90], "count": c, "ms": us / 1e3}
                                  for k, (us, c) in top])

        def with_flush(wall, stats):
            return wall + stats["flush_s"], dict(
                wall_s=wall, flush_s=stats["flush_s"], bytes_in=stats["bytes_in"],
                bytes_out=stats["bytes_out"])

        def native_window(r):
            stats = r[-1]
            setup, wall = r[3], r[2]
            return setup + wall + stats["flush_s"], dict(
                capture_build_s=setup, wall_s=wall, flush_s=stats["flush_s"],
                bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])

        for name, kw, _tol in variants[:2]:
            profiled(name, lambda: with_flush(*run_dpotrf(kw)[1::2]))
        name, arrays, dt, kw, _tol = attn_runs[0]
        profiled(name, lambda: with_flush(*run_attention(
            *(torch.from_numpy(a).to(dt) for a in arrays), **kw)[1::2]))
        # the stencil's staging, through Context and the pump, at each depth
        for depth in (1, 2):
            with stage_depth(mca_param, depth):
                profiled(f"stencil_depth{depth}",
                         lambda: with_flush(*run_stencil()[1::2]))
                profiled(f"stencil_native_depth{depth}",
                         lambda: native_window(run_stencil_native()))
        # set-up + run + close(): the same span as the dynamic run's window
        # (startup enumeration inside it) plus its fini(); at each depth
        for depth in (1, 2):
            with stage_depth(mca_param, depth):
                profiled(f"kernels_native_depth{depth}",
                         lambda: native_window(run_dpotrf_native(variants[0][1])))

        def prefill_native():
            _out, wall, _n, stats = run_attention_native()
            return wall, dict(bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])

        # the whole entry-point call: close() and assemble() are inside it
        profiled("attn_prefill_f32_native", prefill_native)

    def entry(name, mode, n_launch, source="matmul.cu", line="70", key=None):
        row = results[key or (name, mode, TILE)]
        out = {"name": f"{name}[{mode}]", "route": "cuda",
               "source": f"parsec_tpu_torch/csrc/{source}",
               "replaces": f"parsec_tpu/ops/pallas_kernels.py:{line}",
               "launches": n_launch, "max_abs_err": row["max_abs_err"],
               "ms": row["ms"], "plain_ms": row["plain_ms"],
               "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
               "library_ms": row["library_ms"], "library_call": row["library_call"]}
        return out

    def mm_launches(name, mode):
        """launches of one B1/B2 mode over every dpotrf run (dynamic at
        both depths, the pump at both depths and under the 96 MB budget);
        split_f32 and B2 with bf16 operands run on no ported path (the
        reference's callers of them, segmented LU and QR, are not ported
        yet)"""
        return sum(counts[name][mode] for counts in launches.values())

    table = [
        entry("matmul_update", "f32", mm_launches("matmul_update", "f32")),
        entry("matmul_update", "bf16", mm_launches("matmul_update", "bf16")),
        entry("matmul_update", "split", mm_launches("matmul_update", "split")),
        entry("matmul", "f32", mm_launches("matmul", "f32"), line="158"),
        entry("matmul", "bf16", mm_launches("matmul", "bf16"), line="158"),
        entry("stencil_5pt", "f32", st_launch_total, "stencil.cu", "219",
              ("stencil_5pt", "f32")),
        entry("stencil_5pt_fused", "smem", fused_launches["smem"], "stencil.cu", "239",
              ("stencil_5pt_fused", "smem_f32")),
        entry("stencil_5pt_fused", "global", fused_launches["global"], "stencil.cu", "239",
              ("stencil_5pt_fused", "global_f64")),
    ] + [
        entry("flash_attention_block", mode, sum(n[mode] for n in attn_launches.values()),
              "attention.cu", "283", ("flash_attention_block", case))
        for mode, case in (("f32", "f32"), ("bf16", "bf16"), ("f32_wide", "f32_512x512_d512"),
                           ("bf16_wide", "bf16_512x512_d512"))
    ]
    depth_walls.report()
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
