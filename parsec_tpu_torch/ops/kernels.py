"""Hand-written CUDA kernels for the hot tile ops, each beside its plain
PyTorch version.

The port of :mod:`parsec_tpu.ops.pallas_kernels` for the kernels on the
dpotrf path (the source, ``csrc/matmul.cu``, notes what bounds them on an
H100 and what the design does about it):

* :func:`matmul_update` (B1) replaces ``pallas_kernels.matmul_update``:
  ``C + alpha * A @ op(B)`` — the syrk/gemm tile updates, with f32,
  bf16-operand and ``split_f32`` modes;
* :func:`matmul` (B2) replaces ``pallas_kernels.matmul``: ``A @ op(B)`` —
  trsm as one product against the trtri inverse.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty`` and, for CUDA tensors, launches the kernel on
``torch.cuda.current_stream()`` — or raises.  Tensors on the CPU take the
plain version (the CPU tests' path; no GPU kernel can run there).  There
is no fallback from a failed launch to the plain version.

``wrapper.launches`` counts kernel launches and nothing else;
``wrapper.calls`` counts every call, CPU ones included.

The kernels build at first use, from the sources in this checkout, with
``nvcc`` into ``parsec_tpu_torch/_build/`` (one shared library with a
plain C interface, bound with ctypes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

__all__ = [
    "matmul_update",
    "matmul_update_plain",
    "matmul",
    "matmul_plain",
    "build",
]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "matmul.cu",)
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc's output of the last build in this process (ptxas register and
#: shared-memory usage per kernel)
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile the kernel sources into a shared library (once per source
    content; reused while the sources are unchanged) and return its
    path."""
    global build_log
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    lib = _BUILD_DIR / f"libparsec_tpu_torch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ptt_matmul_update.argtypes = [i, i, i, i, i, i, p, p, p, p,
                                              ctypes.c_float, p]
            lib.ptt_matmul_update.restype = i
            lib.ptt_matmul.argtypes = [i, i, i, i, i, p, p, p, p]
            lib.ptt_matmul.restype = i
            _lib = lib
        return _lib


_count_lock = threading.Lock()


def _count(fn, attr: str) -> None:
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


_OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, A: torch.Tensor, B: torch.Tensor, transpose_b: bool,
           *others: torch.Tensor):
    """Shared validation: 2-D, contiguous, one device, matching inner
    dimension.  Returns ``(m, n, k)``."""
    tensors = (A, B) + others
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected 2-D operands, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (row-major)")
        if t.device != A.device:
            raise ValueError(f"{name}: operands on {A.device} and {t.device}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {A.device}")
    if A.dtype not in _OPERAND_DTYPES or B.dtype != A.dtype:
        raise TypeError(f"{name}: A and B must both be float32 or both "
                        f"bfloat16, got {A.dtype} and {B.dtype}")
    m, ka = A.shape
    n, kb = B.shape if transpose_b else (B.shape[1], B.shape[0])
    if ka != kb:
        raise ValueError(f"{name}: inner dimensions differ: A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)} (transpose_b={transpose_b})")
    return int(m), int(n), int(ka)


def _split(x: torch.Tensor):
    """(hi, lo) bfloat16 halves of an f32 tensor, as f32 values."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


# -- B1: matmul_update ------------------------------------------------------

def matmul_update_plain(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
                        alpha: float = -1.0, transpose_b: bool = True,
                        split_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul_update`: the same function,
    products in f32 (bf16 operands are widened first — a product of two
    bf16 values is exact in f32)."""
    b = B.mT if transpose_b else B
    if split_f32:
        a_hi, a_lo = _split(A)
        b_hi, b_lo = _split(b)
        prod = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    else:
        prod = A.float() @ b.float()
    return C + alpha * prod


def matmul_update(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
                  alpha: float = -1.0, transpose_b: bool = True,
                  split_f32: bool = False) -> torch.Tensor:
    """``C + alpha * (A @ B.T)`` (or ``A @ B``) as one kernel: C is read
    once and the result written once.

    ``C`` is (m, n) float32; ``A`` is (m, k) and ``B`` (n, k) — or (k, n)
    when ``transpose_b=False`` — both float32 or both bfloat16, with f32
    accumulation.  ``split_f32`` (f32 operands only) sums the three
    significant cross terms of a bf16 (hi, lo) split of each operand, the
    reference's single-kernel ``Precision.HIGH`` decomposition."""
    m, n, k = _check("matmul_update", A, B, transpose_b, C)
    if C.dtype != torch.float32 or tuple(C.shape) != (m, n):
        raise ValueError(f"matmul_update: C must be float32 of shape {(m, n)}, "
                         f"got {C.dtype} {tuple(C.shape)}")
    if split_f32 and A.dtype != torch.float32:
        raise TypeError("matmul_update: split_f32 needs float32 operands")
    _count(matmul_update, "calls")
    if C.device.type == "cpu":
        return matmul_update_plain(C, A, B, alpha=alpha, transpose_b=transpose_b,
                                   split_f32=split_f32)
    out = torch.empty_like(C)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        rc = lib.ptt_matmul_update(
            int(A.dtype == torch.bfloat16), int(transpose_b), int(split_f32),
            m, n, k, C.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(),
            float(alpha), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_update kernel launch failed: cudaError {rc}")
    _count(matmul_update, "launches")
    return out


matmul_update.calls = 0
matmul_update.launches = 0


# -- B2: matmul -------------------------------------------------------------

def matmul_plain(A: torch.Tensor, B: torch.Tensor, *,
                 transpose_b: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul`: f32 products, result in
    A's dtype."""
    b = B.mT if transpose_b else B
    return (A.float() @ b.float()).to(A.dtype)


def matmul(A: torch.Tensor, B: torch.Tensor, *,
           transpose_b: bool = True) -> torch.Tensor:
    """``A @ B.T`` (or ``A @ B``) as one kernel, zero-initialised
    accumulation in f32, output in A's dtype (float32 or bfloat16)."""
    m, n, k = _check("matmul", A, B, transpose_b)
    _count(matmul, "calls")
    if A.device.type == "cpu":
        return matmul_plain(A, B, transpose_b=transpose_b)
    out = torch.empty((m, n), dtype=A.dtype, device=A.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.ptt_matmul(int(A.dtype == torch.bfloat16), int(transpose_b),
                            m, n, k, A.data_ptr(), B.data_ptr(),
                            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {rc}")
    _count(matmul, "launches")
    return out


matmul.calls = 0
matmul.launches = 0


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches``."""
    with _count_lock:
        for fn in (matmul_update, matmul):
            fn.calls = 0
            fn.launches = 0
