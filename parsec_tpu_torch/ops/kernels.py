"""Hand-written CUDA kernels for the hot tile ops, each beside its plain
PyTorch version.

The port of :mod:`parsec_tpu.ops.pallas_kernels` (each source under
``csrc/`` notes what bounds its kernels on an H100 and what the design does
about it):

* :func:`matmul_update` (B1) replaces ``pallas_kernels.matmul_update``:
  ``C + alpha * A @ op(B)`` — the syrk/gemm tile updates, with f32,
  bf16-operand and ``split_f32`` modes (``csrc/matmul.cu``);
* :func:`matmul` (B2) replaces ``pallas_kernels.matmul``: ``A @ op(B)`` —
  trsm as one product against the trtri inverse (``csrc/matmul.cu``);
* :func:`stencil_5pt` (B3) replaces ``pallas_kernels.stencil_5pt``: one
  5-point Jacobi step of a tile with halo rows and columns spliced in at
  its edges — the stencil PTG's device chore (``csrc/stencil.cu``);
* :func:`stencil_5pt_fused` (B4) replaces
  ``pallas_kernels.stencil_5pt_fused``: ``iters`` zero-boundary steps of a
  whole grid in one launch, the grid resident in shared memory where it
  fits (``csrc/stencil.cu``);
* :func:`flash_attention_block` (B5) replaces
  ``pallas_kernels.flash_attention_block``: one online-softmax update of
  the carry ``(acc, m, l)`` — the flash-attention PTG's device chore
  (``csrc/attention.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and, for CUDA tensors, launches the kernel on
``torch.cuda.current_stream()`` — or raises.  Tensors on the CPU take the
plain version (the CPU tests' path; no GPU kernel can run there).  There
is no fallback from a failed launch to the plain version.

``wrapper.launches`` counts kernel launches and nothing else;
``wrapper.calls`` counts every call, CPU ones included.  Each wrapper
also counts its launches per mode, ``wrapper.launches_by_mode``: B1 and
B2 by operand mode and layout, ``f32``, ``bf16``, ``split`` for ``A @
B.T`` (``transpose_b=True``) and the same with ``_nt`` for ``A @ B``
(``transpose_b=False``, the tiled LU and QR updates); B3 ``step``; B4
per mode (``smem``, ``global``), B5 per kernel (``f32``, ``bf16``,
``f32_wide``, ``bf16_wide``).  Inside a captured CUDA graph a wrapper
runs at capture and its kernel at every replay: the capturer moves the
counts with :func:`launch_counts` and :func:`add_launches`, so the
counters stay the launches the card ran.

B1, B2, B3 and B5 have a batch axis (grid z): called under
``torch.func.vmap`` — as a level-batched whole-DAG replay calls them
(``GraphExecutor(batch_levels=True)``) — a wrapper enters its custom op
(``torch.ops.parsec_tpu_torch.*``), whose vmap rule launches the kernel
once over every member, an operand the members share at batch stride 0.
A batched launch counts once under its mode with ``_b`` appended
(``f32_b``, ``f32_nt_b``, ``step_b``, ...); ``wrapper.members`` counts
the members of batched launches.  Outside a functorch transform the
wrappers launch directly and never pay the op's dispatch.

The kernels build at first use, from the sources in this checkout, with
``nvcc`` into ``parsec_tpu_torch/_build/``: one object per source, all
compiled at once, linked into one shared library with a plain C
interface, bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "matmul_update",
    "matmul_update_plain",
    "matmul",
    "matmul_plain",
    "stencil_5pt",
    "stencil_5pt_plain",
    "stencil_5pt_fused",
    "stencil_5pt_fused_plain",
    "flash_attention_block",
    "flash_attention_block_plain",
    "ATTENTION_ENGINE_D",
    "build",
    "reset_counts",
    "launch_counts",
    "add_launches",
]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = tuple(_PKG / "csrc" / name
                 for name in ("matmul.cu", "attention.cu", "stencil.cu"))
_BUILD_DIR = _PKG / "_build"
#: compile flags of every source; the objects are linked with -shared
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


#: the kernel library's file name is this prefix, its content tag, ".so"
LIBRARY_PREFIX = "libparsec_tpu_torch_kernels_"


def library_tag() -> str:
    """The kernel library's content address: the sources and the flags
    (a library under another tag was built from other sources)."""
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel sources into a shared library (once per source
    content; reused while the sources are unchanged) and return its path.
    One ``nvcc`` per source, all started together, then one link."""
    global build_log
    tag = library_tag()
    lib = _BUILD_DIR / f"{LIBRARY_PREFIX}{tag}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    pid = os.getpid()
    objs = [_BUILD_DIR / f"{src.stem}_{tag}.{pid}.o" for src in _SOURCES]
    procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(_SOURCES, objs)]
    logs, failed = [], []
    for src, proc in zip(_SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    tmp = lib.with_suffix(f".{pid}.tmp")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "".join(logs))
        link = subprocess.run([nvcc, *_NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               + link.stdout + link.stderr)
    finally:
        build_log = "".join(logs)
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            mm_cfg = [i] * 3  # vec_a, vec_b, vec_c
            # every entry point but B4's takes a batch count and a pointer
            # to the members' strides (null: batch 1)
            lib.ptt_matmul_update.argtypes = [i, i, i, i, i, i, i, p, p, p, p,
                                              ctypes.c_float, *mm_cfg, p, p]
            lib.ptt_matmul_update.restype = i
            lib.ptt_matmul.argtypes = [i, i, i, i, i, i, p, p, p, *mm_cfg, p, p]
            lib.ptt_matmul.restype = i
            ll, f = ctypes.c_longlong, ctypes.c_float
            lib.ptt_flash_attention_block.argtypes = [i, i, i, i, i, p, p, p, p, p, p,
                                                      p, p, p, ll, ll, i, f, p, p, ll, p, ll,
                                                      p]
            lib.ptt_flash_attention_block.restype = i
            lib.ptt_stencil_5pt.argtypes = [i, i, i, i, i, p, p, p, p, ll, p, ll, p, p, p]
            lib.ptt_stencil_5pt.restype = i
            lib.ptt_stencil_5pt_fused.argtypes = [i, i, i, i, i, i, i, p, p, p, p, p]
            lib.ptt_stencil_5pt_fused.restype = i
            lib.ptt_stencil_device.argtypes = [ctypes.POINTER(i)] * 2
            lib.ptt_stencil_device.restype = i
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


# -- B1/B2 launch configuration ----------------------------------------------

class MMConfig(NamedTuple):
    """What one B1/B2 launch runs: operand mode (``bf16``; ``split``, three
    bf16 passes; ``f32``, three TF32 passes), 16-byte operand loads
    (``vec_a``, ``vec_b``) and paired C/O accesses (``vec_c``).  The tile
    (64 x 64) and its shared memory are fixed by the kernel."""
    mode: str
    vec_a: bool
    vec_b: bool
    vec_c: bool


def _mm_config(m: int, n: int, k: int, *, operand_dtype: torch.dtype,
               out_dtype: torch.dtype, transpose_b: bool, split_f32: bool,
               a_ptr: int, b_ptr: int, o_ptr: int,
               c_ptr: Optional[int] = None) -> MMConfig:
    """The launch configuration of one B1/B2 call, a pure function of the
    shapes, dtypes and base addresses (so the CPU tests can check it).

    Operand loads are 16-byte vectors only where the operand's row pitch
    and base address are 16-byte multiples (a vector then lies wholly in or
    out of range); else predicated scalar loads.  C and O are accessed in
    pairs where ``n`` is even and their bases are aligned to a pair."""
    bf16 = operand_dtype == torch.bfloat16
    mode = "bf16" if bf16 else "split" if split_f32 else "f32"
    isz = 2 if bf16 else 4
    osz = 2 if out_dtype == torch.bfloat16 else 4
    b_pitch = (k if transpose_b else n) * isz
    pair = [o_ptr % (2 * osz) == 0] + ([c_ptr % 8 == 0] if c_ptr is not None else [])
    return MMConfig(mode=mode,
                    vec_a=(k * isz) % 16 == 0 and a_ptr % 16 == 0,
                    vec_b=b_pitch % 16 == 0 and b_ptr % 16 == 0,
                    vec_c=n % 2 == 0 and all(pair))


def _mm_launch(out: torch.Tensor, C: Optional[torch.Tensor], A: torch.Tensor,
               B: torch.Tensor, *, alpha: float, transpose_b: bool,
               split_f32: bool, batch: int = 1,
               strides: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> str:
    """Launch the B1 (``C`` given) or B2 kernel into ``out`` on the current
    stream and return its mode; raises if the launch fails.  ``batch``
    members, each operand stepping by its element stride in ``strides``
    (A, B, C, O; 0 for an operand the members share).  Counts nothing: the
    wrappers do."""
    m, k = A.shape[-2:]
    n = out.shape[-1]
    sa, sb, sc, so = strides
    isz, osz = A.element_size(), out.element_size()
    # a vector flag must hold for every member: the base and the batch
    # stride in bytes both aligned, so they are OR-ed (every alignment
    # asked is a power of two)
    cfg = _mm_config(m, n, k, operand_dtype=A.dtype, out_dtype=out.dtype,
                     transpose_b=transpose_b, split_f32=split_f32,
                     a_ptr=A.data_ptr() | sa * isz, b_ptr=B.data_ptr() | sb * isz,
                     o_ptr=out.data_ptr() | so * osz,
                     c_ptr=None if C is None else C.data_ptr() | sc * 4)
    lib = _library()
    vecs = (int(cfg.vec_a), int(cfg.vec_b), int(cfg.vec_c))
    bf16 = int(A.dtype == torch.bfloat16)
    arr = (ctypes.c_longlong * 4)(*strides)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if C is not None:
            rc = lib.ptt_matmul_update(bf16, int(transpose_b), int(split_f32), batch, m, n, k,
                                       C.data_ptr(), A.data_ptr(), B.data_ptr(),
                                       out.data_ptr(), float(alpha), *vecs,
                                       ctypes.addressof(arr), stream)
        else:
            rc = lib.ptt_matmul(bf16, int(transpose_b), batch, m, n, k, A.data_ptr(),
                                B.data_ptr(), out.data_ptr(), *vecs, ctypes.addressof(arr),
                                stream)
    if rc != 0:
        name = "matmul_update" if C is not None else "matmul"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} ({cfg}, "
                           f"batch {batch})")
    return cfg.mode


def _count_mode(fn, mode: str, members: int = 0) -> None:
    """One launch under ``mode``; a batched launch (``members`` > 0, its
    mode ending in ``_b``) also counts its members."""
    with _count_lock:
        fn.launches += 1
        fn.launches_by_mode[mode] += 1
        if members:
            fn.members += members


# -- the batch axis: custom ops whose vmap rules make one launch -------------
#
# A whole-DAG replay with level batching (dsl/cuda_graph.py) runs each
# group of same-class tasks as one torch.func.vmap of the task body.  A
# wrapper called under vmap enters its custom op (``parsec_tpu_torch::*``),
# whose vmap rule launches the kernel once over the stacked members (on the
# CPU: the plain version over the stacked members).  Outside a functorch
# transform the wrappers never enter the ops: per-task calls pay no op
# dispatch.  Inside a rule, an operand the members share arrives unbatched
# (batch stride 0), a stacked one with its batch dimension moved first.

#: the most members of one batched launch (the kernels' grid z)
MAX_BATCH = 65535


def _vmapping() -> bool:
    """Whether a functorch transform is running (the wrappers then enter
    their custom ops)."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _lead(t, dim):
    """A vmap rule's operand with its batch dimension first (``dim`` None:
    shared by every member, left as it is)."""
    if dim is None or not isinstance(t, torch.Tensor):
        return t
    return t.movedim(dim, 0)


# every operand of B1, B2, B3 and B5 is 2-D a member: a batched one is
# (members, rows, cols), a shared one (rows, cols)

def _member(t: torch.Tensor) -> torch.Tensor:
    """One member of a batched operand (its first), or the shared operand."""
    return t[0] if t.dim() > 2 else t


def _members_rowmajor(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each member row-major: as it is where it already is (a
    stack of contiguous tiles, a shared contiguous tile), else a copy."""
    return t if _member(t).is_contiguous() else t.contiguous()


def _batch_stride(t: torch.Tensor) -> int:
    """The element stride between members (0 for a shared operand)."""
    return t.stride(0) if t.dim() > 2 else 0


def _check_batch(name: str, n: int, *tensors: torch.Tensor) -> None:
    if not 1 <= n <= MAX_BATCH:
        raise ValueError(f"{name}: a batched launch takes 1 to {MAX_BATCH} members, got {n}")
    for t in tensors:
        if t.dim() > 2 and t.shape[0] != n:
            raise ValueError(f"{name}: a batched operand of {t.shape[0]} members in a "
                             f"batch of {n}")


# -- B1: matmul_update ------------------------------------------------------

def matmul_update_plain(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
                        alpha: float = -1.0, transpose_b: bool = True,
                        split_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul_update`: the same function,
    products in f32 (bf16 operands are widened first — a product of two
    bf16 values is exact in f32).  Operands with a leading batch dimension
    broadcast against shared 2-D ones."""
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
    reference's single-kernel ``Precision.HIGH`` decomposition.  Under
    ``torch.func.vmap`` one batched launch runs every member."""
    if _vmapping():
        return _matmul_update_op(C, A, B, float(alpha), bool(transpose_b), bool(split_f32))
    return _matmul_update(C, A, B, alpha, transpose_b, split_f32)


def _check_update(C, A, B, transpose_b, split_f32):
    m, n, k = _check("matmul_update", A, B, transpose_b, C)
    if C.dtype != torch.float32 or tuple(C.shape) != (m, n):
        raise ValueError(f"matmul_update: C must be float32 of shape {(m, n)}, "
                         f"got {C.dtype} {tuple(C.shape)}")
    if split_f32 and A.dtype != torch.float32:
        raise TypeError("matmul_update: split_f32 needs float32 operands")
    return m, n, k


def _matmul_update(C, A, B, alpha, transpose_b, split_f32) -> torch.Tensor:
    m, n, k = _check_update(C, A, B, transpose_b, split_f32)
    _count(matmul_update, "calls")
    if C.device.type == "cpu":
        return matmul_update_plain(C, A, B, alpha=alpha, transpose_b=transpose_b,
                                   split_f32=split_f32)
    out = torch.empty_like(C)
    if m == 0 or n == 0:
        return out
    mode = _mm_launch(out, C, A, B, alpha=alpha, transpose_b=transpose_b,
                      split_f32=split_f32)
    _count_mode(matmul_update, _layout_mode(mode, transpose_b))
    return out


def _matmul_update_batched(n_members: int, C, A, B, alpha, transpose_b,
                           split_f32) -> torch.Tensor:
    """``n_members`` updates in one launch (a vmap rule's body); each of C,
    A, B stacked ``(members, ...)`` or shared 2-D."""
    C, A, B = (_members_rowmajor(t) for t in (C, A, B))
    _check_batch("matmul_update", n_members, C, A, B)
    m, n, k = _check_update(_member(C), _member(A), _member(B), transpose_b, split_f32)
    _count(matmul_update, "calls")
    if A.device.type == "cpu":
        return matmul_update_plain(C, A, B, alpha=alpha, transpose_b=transpose_b,
                                   split_f32=split_f32).expand(n_members, m, n)
    out = torch.empty((n_members, m, n), dtype=torch.float32, device=A.device)
    if m == 0 or n == 0:
        return out
    mode = _mm_launch(out, C, A, B, alpha=alpha, transpose_b=transpose_b,
                      split_f32=split_f32, batch=n_members,
                      strides=(_batch_stride(A), _batch_stride(B), _batch_stride(C),
                               out.stride(0)))
    _count_mode(matmul_update, _layout_mode(mode, transpose_b) + "_b", n_members)
    return out


@torch.library.custom_op("parsec_tpu_torch::matmul_update", mutates_args=())
def _matmul_update_op(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, alpha: float,
                      transpose_b: bool, split_f32: bool) -> torch.Tensor:
    return _matmul_update(C, A, B, alpha, transpose_b, split_f32)


def _matmul_update_vmap(info, in_dims, C, A, B, alpha, transpose_b, split_f32):
    C, A, B = (_lead(t, d) for t, d in zip((C, A, B), in_dims))
    return _matmul_update_batched(info.batch_size, C, A, B, alpha, transpose_b,
                                  split_f32), 0


torch.library.register_vmap(_matmul_update_op, _matmul_update_vmap)


def _layout_mode(mode: str, transpose_b: bool) -> str:
    """The ``launches_by_mode`` key of a B1/B2 launch: its operand mode,
    with ``_nt`` when B is not transposed (and ``_b`` after it for a
    batched launch)."""
    return mode if transpose_b else mode + "_nt"


def _with_batched(modes) -> dict:
    """Launch counters of ``modes`` and of their batched forms (``_b``)."""
    return dict.fromkeys((*modes, *(mode + "_b" for mode in modes)), 0)


matmul_update.calls = 0
matmul_update.launches = 0
matmul_update.members = 0
matmul_update.launches_by_mode = _with_batched(
    ("f32", "bf16", "split", "f32_nt", "bf16_nt", "split_nt"))


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
    accumulation in f32, output in A's dtype (float32 or bfloat16).  Under
    ``torch.func.vmap`` one batched launch runs every member."""
    if _vmapping():
        return _matmul_op(A, B, bool(transpose_b))
    return _matmul(A, B, transpose_b)


def _matmul(A, B, transpose_b) -> torch.Tensor:
    m, n, k = _check("matmul", A, B, transpose_b)
    _count(matmul, "calls")
    if A.device.type == "cpu":
        return matmul_plain(A, B, transpose_b=transpose_b)
    out = torch.empty((m, n), dtype=A.dtype, device=A.device)
    if m == 0 or n == 0:
        return out
    mode = _mm_launch(out, None, A, B, alpha=1.0, transpose_b=transpose_b,
                      split_f32=False)
    _count_mode(matmul, _layout_mode(mode, transpose_b))
    return out


def _matmul_batched(n_members: int, A, B, transpose_b) -> torch.Tensor:
    """``n_members`` products in one launch (a vmap rule's body)."""
    A, B = _members_rowmajor(A), _members_rowmajor(B)
    _check_batch("matmul", n_members, A, B)
    m, n, k = _check("matmul", _member(A), _member(B), transpose_b)
    _count(matmul, "calls")
    if A.device.type == "cpu":
        return matmul_plain(A, B, transpose_b=transpose_b).expand(n_members, m, n)
    out = torch.empty((n_members, m, n), dtype=A.dtype, device=A.device)
    if m == 0 or n == 0:
        return out
    mode = _mm_launch(out, None, A, B, alpha=1.0, transpose_b=transpose_b,
                      split_f32=False, batch=n_members,
                      strides=(_batch_stride(A), _batch_stride(B), 0, out.stride(0)))
    _count_mode(matmul, _layout_mode(mode, transpose_b) + "_b", n_members)
    return out


@torch.library.custom_op("parsec_tpu_torch::matmul", mutates_args=())
def _matmul_op(A: torch.Tensor, B: torch.Tensor, transpose_b: bool) -> torch.Tensor:
    return _matmul(A, B, transpose_b)


def _matmul_vmap(info, in_dims, A, B, transpose_b):
    A, B = (_lead(t, d) for t, d in zip((A, B), in_dims))
    return _matmul_batched(info.batch_size, A, B, transpose_b), 0


torch.library.register_vmap(_matmul_op, _matmul_vmap)

matmul.calls = 0
matmul.launches = 0
matmul.members = 0
matmul.launches_by_mode = _with_batched(("f32", "bf16", "f32_nt", "bf16_nt"))


# -- B3: stencil_5pt --------------------------------------------------------

#: the grid dtypes of B3/B4 and their codes in the C entry points; the
#: kernels compute in the grid's own dtype, as the reference's do
_STENCIL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}
#: cudaErrorNotSupported: the fused stencil's answer on a card without
#: cooperative launches
_CUDA_ERROR_NOT_SUPPORTED = 801


def _check_grid(name: str, grid: torch.Tensor) -> None:
    if not isinstance(grid, torch.Tensor):
        raise TypeError(f"{name}: expected tensors, got {type(grid).__name__}")
    if grid.dim() != 2 or grid.shape[0] == 0 or grid.shape[1] == 0:
        raise ValueError(f"{name}: expected a non-empty 2-D grid, got shape "
                         f"{tuple(grid.shape)}")
    if not grid.is_contiguous():
        raise ValueError(f"{name}: the grid must be contiguous (row-major)")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {grid.device}")
    if grid.dtype not in _STENCIL_DTYPES:
        raise TypeError(f"{name}: grid must be float32, float64, float16 or "
                        f"bfloat16, got {grid.dtype}")
    if grid.numel() >= 2 ** 31:
        raise ValueError(f"{name}: grid of {grid.numel()} elements exceeds the "
                         "kernel's 32-bit indexing")


def _stencil_vec(w: int, itemsize: int, *ptrs: int) -> bool:
    """Whether one B3 launch takes 16-byte column groups: the row pitch
    and the bases of ``old``, ``up``, ``down`` and the output are 16-byte
    multiples (so a group lies wholly inside a row); else one element a
    thread with scalar accesses.  B4's smem mode asks the same of its
    output (its shared rows are aligned).  A pure function, checked on the
    CPU."""
    return (w * itemsize) % 16 == 0 and all(p % 16 == 0 for p in ptrs)


def stencil_5pt_plain(old: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                      left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`stencil_5pt`: the Pallas kernel's
    shifted copies with the halos spliced in, summed in its order (each
    partial sum rounded to the grid's dtype).  Takes a leading batch
    dimension where every operand has it."""
    u = torch.cat([up, old[..., :-1, :]], dim=-2)
    d = torch.cat([old[..., 1:, :], down], dim=-2)
    lf = torch.cat([left, old[..., :, :-1]], dim=-1)
    rt = torch.cat([old[..., :, 1:], right], dim=-1)
    return 0.25 * (u + d + lf + rt)


def stencil_5pt(old: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi step of an ``(h, w)`` tile as one kernel: one read
    of ``old``, one write of the result.

    ``up``/``down`` are contiguous ``(1, w)`` halo rows and ``left``/
    ``right`` ``(h, 1)`` halo columns (zeros at physical boundaries), all in
    ``old``'s dtype: float32, float64, float16 or bfloat16, computed in that
    dtype.  A halo column may be a strided view — the edge column of a
    neighbour tile, ``LEFT[:, -1:]`` — and is read through its row stride,
    not copied; any other non-contiguous input is rejected.  Under
    ``torch.func.vmap`` one batched launch steps every member."""
    if _vmapping():
        return _stencil_5pt_op(old, up, down, left, right)
    return _stencil_5pt(old, up, down, left, right)


def _check_stencil(old, up, down, left, right) -> Tuple[int, int]:
    _check_grid("stencil_5pt", old)
    h, w = old.shape
    for label, t, shape in (("up", up, (1, w)), ("down", down, (1, w)),
                            ("left", left, (h, 1)), ("right", right, (h, 1))):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"stencil_5pt: {label} must be a tensor, got "
                            f"{type(t).__name__}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stencil_5pt: {label} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != old.dtype:
            raise TypeError(f"stencil_5pt: {label} is {t.dtype}, old is {old.dtype}")
        if t.device != old.device:
            raise ValueError(f"stencil_5pt: {label} on {t.device}, old on {old.device}")
        if shape[0] == 1 and not t.is_contiguous():
            raise ValueError(f"stencil_5pt: halo row {label} must be contiguous")
    return int(h), int(w)


def _stencil_launch(n_members: int, old, up, down, left, right, out,
                    strides: Tuple[int, ...]) -> None:
    """Launch B3 into ``out`` on the current stream: ``n_members`` tiles,
    each operand stepping by its element stride in ``strides`` (old, up,
    down, left, right, out; 0 for an operand the members share).  The
    16-byte groups are decided over every member's addresses (bases and
    batch strides OR-ed)."""
    h, w = old.shape[-2:]
    isz = old.element_size()
    s_old, s_up, s_down, _sl, _sr, s_out = strides
    vec = _stencil_vec(w, isz, old.data_ptr() | s_old * isz, up.data_ptr() | s_up * isz,
                       down.data_ptr() | s_down * isz, out.data_ptr() | s_out * isz)
    lib = _library()
    arr = (ctypes.c_longlong * 6)(*strides)
    with torch.cuda.device(old.device):
        stream = torch.cuda.current_stream(old.device).cuda_stream
        rc = lib.ptt_stencil_5pt(_STENCIL_DTYPES[old.dtype], int(vec), n_members, h, w,
                                 old.data_ptr(), up.data_ptr(), down.data_ptr(),
                                 left.data_ptr(), left.stride(-2),
                                 right.data_ptr(), right.stride(-2),
                                 out.data_ptr(), ctypes.addressof(arr), stream)
    if rc != 0:
        raise RuntimeError(f"stencil_5pt kernel launch failed: cudaError {rc} "
                           f"(batch {n_members})")


def _stencil_5pt(old, up, down, left, right) -> torch.Tensor:
    _check_stencil(old, up, down, left, right)
    _count(stencil_5pt, "calls")
    if old.device.type == "cpu":
        return stencil_5pt_plain(old, up, down, left, right)
    out = torch.empty_like(old)
    _stencil_launch(1, old, up, down, left, right, out, (0,) * 6)
    _count_mode(stencil_5pt, "step")
    return out


def _stencil_5pt_batched(n_members: int, old, up, down, left, right) -> torch.Tensor:
    """``n_members`` steps in one launch (a vmap rule's body): ``old`` and
    the halo rows with each member row-major, the halo columns read
    through their row stride."""
    old, up, down = (_members_rowmajor(t) for t in (old, up, down))
    _check_batch("stencil_5pt", n_members, old, up, down, left, right)
    h, w = _check_stencil(*(_member(t) for t in (old, up, down, left, right)))
    _count(stencil_5pt, "calls")
    if old.device.type == "cpu":
        return stencil_5pt_plain(*(t.expand(n_members, *t.shape[-2:])
                                   for t in (old, up, down, left, right)))
    out = torch.empty((n_members, h, w), dtype=old.dtype, device=old.device)
    _stencil_launch(n_members, old, up, down, left, right, out,
                    (*(_batch_stride(t) for t in (old, up, down, left, right)),
                     out.stride(0)))
    _count_mode(stencil_5pt, "step_b", n_members)
    return out


@torch.library.custom_op("parsec_tpu_torch::stencil_5pt", mutates_args=())
def _stencil_5pt_op(old: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                    left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return _stencil_5pt(old, up, down, left, right)


def _stencil_5pt_vmap(info, in_dims, old, up, down, left, right):
    args = (_lead(t, d) for t, d in zip((old, up, down, left, right), in_dims))
    return _stencil_5pt_batched(info.batch_size, *args), 0


torch.library.register_vmap(_stencil_5pt_op, _stencil_5pt_vmap)

stencil_5pt.calls = 0
stencil_5pt.launches = 0
stencil_5pt.members = 0
stencil_5pt.launches_by_mode = _with_batched(("step",))


# -- B4: stencil_5pt_fused --------------------------------------------------

#: B4's smem mode: threads of a block and columns per thread at most by
#: itemsize (``csrc/stencil.cu``'s ``FUSED_SMEM_THREADS`` and
#: ``fused_slots``)
_FUSED_SMEM_THREADS = 512
_FUSED_SLOTS = {8: 2, 4: 4, 2: 4}


class FusedConfig(NamedTuple):
    """What one B4 launch runs: ``smem`` (the grid resident in shared
    memory, ``rows`` grid rows on each of ``blocks`` persistent blocks) or
    ``global`` (grid-stride passes over L2 with a grid barrier a step;
    ``rows`` and ``blocks`` 0)."""
    mode: str
    rows: int
    blocks: int


def _fused_mode(h: int, w: int, itemsize: int, sms: int,
                smem_per_block: int) -> FusedConfig:
    """The B4 mode for an ``(h, w)`` grid, a pure function (so the CPU
    tests can check it): ``smem`` when the grid split into ``sms`` strips
    of ``ceil(h / sms)`` rows fits a block's opt-in shared memory (the
    strip, two halo rows, and two copies of each 32-column span's two
    edge columns) and its threads' column slots (``512 * slots``
    columns); ``global`` otherwise."""
    rows = -(-h // sms)
    spans = -(-w // 32)
    fits = (w <= _FUSED_SMEM_THREADS * _FUSED_SLOTS[itemsize]
            and ((rows + 2) * w + 4 * spans * rows) * itemsize <= smem_per_block)
    if not fits:
        return FusedConfig("global", 0, 0)
    return FusedConfig("smem", rows, -(-h // rows))


_device_limits: dict = {}


def _stencil_device_limits(device: torch.device):
    """(SM count, opt-in shared memory per block) of a CUDA device, asked
    of the runtime once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _device_limits:
        lib = _library()
        sms, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            rc = lib.ptt_stencil_device(ctypes.byref(sms), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"stencil_5pt_fused: device query failed: cudaError {rc}")
        _device_limits[index] = (sms.value, smem.value)
    return _device_limits[index]


def stencil_5pt_fused_plain(grid: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`stencil_5pt_fused`: ``iters`` plain
    steps with zero halos."""
    h, w = grid.shape
    zr = torch.zeros((1, w), dtype=grid.dtype, device=grid.device)
    zc = torch.zeros((h, 1), dtype=grid.dtype, device=grid.device)
    g = grid.clone()
    for _ in range(iters):
        g = stencil_5pt_plain(g, zr, zr, zc, zc)
    return g


def stencil_5pt_fused(grid: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` 5-point Jacobi steps of a whole ``(h, w)`` grid with zero
    boundaries, in one cooperative launch, in the grid's dtype (float32,
    float64, float16 or bfloat16).  The grid stays in shared memory on one
    persistent block per SM where it fits (:func:`_fused_mode`), else each
    step is a pass over L2.  The input is not written; ``iters=0`` returns
    a copy.  Raises if the card does not support cooperative launches."""
    _check_grid("stencil_5pt_fused", grid)
    if int(iters) != iters or iters < 0:
        raise ValueError(f"stencil_5pt_fused: iters must be a non-negative "
                         f"integer, got {iters!r}")
    iters = int(iters)
    _count(stencil_5pt_fused, "calls")
    if grid.device.type == "cpu":
        return stencil_5pt_fused_plain(grid, iters)
    if iters == 0:
        return grid.clone()
    h, w = grid.shape
    cfg = _fused_mode(h, w, grid.element_size(), *_stencil_device_limits(grid.device))
    out = torch.empty_like(grid)
    # smem mode takes 16-byte column groups where B3 would
    vec = cfg.mode == "smem" and _stencil_vec(w, grid.element_size(), out.data_ptr())
    tmp = xbuf = out
    if cfg.mode == "global" and iters > 1:
        tmp = torch.empty_like(grid)
    if cfg.mode == "smem" and iters > 1:
        # the edge-row exchange: 8-byte words (two per float64 value), zero
        # so that no word carries a step's tag before that step writes it
        words = 2 if grid.element_size() == 8 else 1
        xbuf = torch.zeros((2, cfg.blocks, 2, w * words), dtype=torch.int64,
                           device=grid.device)
    lib = _library()
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        rc = lib.ptt_stencil_5pt_fused(_STENCIL_DTYPES[grid.dtype],
                                       int(cfg.mode == "smem"), int(vec), h, w, iters, cfg.rows,
                                       grid.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                                       xbuf.data_ptr(), stream)
    if rc == _CUDA_ERROR_NOT_SUPPORTED:
        raise RuntimeError("stencil_5pt_fused: this device does not support "
                           "cooperative launches (cudaDevAttrCooperativeLaunch)")
    if rc != 0:
        raise RuntimeError(f"stencil_5pt_fused kernel launch failed: cudaError {rc} ({cfg})")
    _count_mode(stencil_5pt_fused, cfg.mode)
    return out


stencil_5pt_fused.calls = 0
stencil_5pt_fused.launches = 0
stencil_5pt_fused.launches_by_mode = dict.fromkeys(("smem", "global"), 0)


# -- B5: flash_attention_block ----------------------------------------------

#: head dimensions above this run on the wide kernel (FP32 FMA over D in
#: slabs, one block per 128 output columns); up to it, on the mma.sync
#: engine, whose per-thread accumulator tile is sized for it
ATTENTION_ENGINE_D = 256
_ATTENTION_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _attention_mode(q_dtype: torch.dtype, k_dtype: torch.dtype,
                    v_dtype: torch.dtype, d: int) -> str:
    """The kernel one B5 launch runs, a pure function of the operand
    dtypes and the head dimension (so the CPU tests can check it):
    ``bf16`` when q, k and v are all bfloat16, else ``f32`` (float16,
    float64 and mixed operands are widened or narrowed to float32 copies
    first, the reference's ``astype(float32)``); ``_wide`` for ``d`` above
    :data:`ATTENTION_ENGINE_D`."""
    bf16 = q_dtype == k_dtype == v_dtype == torch.bfloat16
    return ("bf16" if bf16 else "f32") + ("_wide" if d > ATTENTION_ENGINE_D else "")


def _check_attention(q, k, v, acc, m, l):
    """Validation of one flash-attention block update; returns
    ``(sq, sk, d)``."""
    name = "flash_attention_block"
    tensors = dict(q=q, k=k, v=v, acc=acc, m=m, l=l)
    for label, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {label} must be a tensor, got {type(t).__name__}")
        if t.dim() != 2:
            raise ValueError(f"{name}: {label} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous (row-major)")
        if t.device != q.device:
            raise ValueError(f"{name}: {label} on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _ATTENTION_DTYPES:
            raise TypeError(f"{name}: {label} must be a float16, bfloat16, float32 "
                            f"or float64 tensor, got {t.dtype}")
    sq, d = q.shape
    sk = k.shape[0]
    if d < 1:
        raise ValueError(f"{name}: head dimension must be positive, got {d}")
    if tuple(k.shape) != (sk, d) or tuple(v.shape) != (sk, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"must both be ({sk}, {d})")
    for label, t, shape in (("acc", acc, (sq, d)), ("m", m, (sq, 1)),
                            ("l", l, (sq, 1))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be float32 of shape {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    return int(sq), int(sk), int(d)


def _position(off):
    """A block offset as the plain version broadcasts it: an int or a 0-d
    tensor as it is, the members' offsets (a 1-D tensor) as (n, 1, 1)."""
    if isinstance(off, torch.Tensor) and off.dim() == 1:
        return off[:, None, None]
    return off


def flash_attention_block_plain(q, k, v, acc, m, l, q_off, k_off, *,
                                causal: bool = False, scale: float = 1.0,
                                compute_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`flash_attention_block`: the Pallas
    kernel's arithmetic on the whole block at once, in f32
    (``compute_dtype=torch.float64`` gives the float64 update the f32
    kernel's accuracy is held against).  Takes a leading batch dimension
    on any operand, with the offsets an int or a tensor of the members'."""
    sq, sk = q.shape[-2], k.shape[-2]
    q, k, v, acc, m, l = (t.to(compute_dtype) for t in (q, k, v, acc, m, l))
    if sk == 0:
        return acc.clone(), m.clone(), l.clone()
    logits = (q @ k.mT) * scale
    if causal:
        qpos = _position(q_off) + torch.arange(sq, device=q.device)[:, None]
        kpos = _position(k_off) + torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, float("-inf"))
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - m_new)
    corr = torch.exp(m - m_new)
    return (acc * corr + p @ v, m_new,
            l * corr + p.sum(dim=-1, keepdim=True))


def flash_attention_block(q, k, v, acc, m, l, q_off, k_off, *,
                          causal: bool = False, scale: float = 1.0):
    """One online-softmax block update ``(q, k, v, acc, m, l) -> (acc, m,
    l)`` as one kernel.

    ``q`` is ``(Sq, D)``, ``k``/``v`` are ``(Sk, D)``, each float16,
    bfloat16, float32 or float64; the carry ``acc`` is ``(Sq, D)`` and
    ``m``/``l`` ``(Sq, 1)``, float32.  ``q_off``/``k_off`` are the global
    sequence positions of the two blocks' first rows, for the causal mask
    (masked logits are ``-inf``).  All-bfloat16 operands run the bf16
    engine; any other operands run the f32 engine, on float32 copies where
    they are not float32 already (:func:`_attention_mode`).  Up to
    :data:`ATTENTION_ENGINE_D` both products run on the tensor cores with
    f32 accumulation: float32 as three TF32 passes (f32-class, held
    against float64 on the card), bfloat16 ``q @ k.T`` exactly and ``p @
    v`` with the f32 ``p`` split into bf16 hi and lo.  A wider head runs
    the wide kernel: FP32 FMA on the CUDA cores.  Returns fresh tensors.

    Under ``torch.func.vmap`` one batched launch updates every member; an
    offset may then be a tensor (the members' positions, read by the
    kernel from device memory), else an int."""
    if _vmapping():
        qt, qi = (q_off, 0) if isinstance(q_off, torch.Tensor) else (None, int(q_off))
        kt, ki = (k_off, 0) if isinstance(k_off, torch.Tensor) else (None, int(k_off))
        return _flash_op(q, k, v, acc, m, l, qt, qi, kt, ki, bool(causal), float(scale))
    return _flash_attention_block(q, k, v, acc, m, l, int(q_off), int(k_off),
                                  causal, scale)


def _flash_launch(n_members: int, mode: str, q, k, v, acc, m, l, outs, q_off: int,
                  k_off: int, causal: bool, scale: float, strides: Tuple[int, ...],
                  q_offs: Optional[torch.Tensor] = None,
                  k_offs: Optional[torch.Tensor] = None) -> None:
    """Launch B5 into ``outs`` (acc, m, l) on the current stream:
    ``n_members`` updates, each operand stepping by its element stride in
    ``strides`` (q, k, v, acc, m, l and the three outputs; 0 for shared);
    member z's offsets from ``q_offs``/``k_offs`` (int64 on the device, one
    value for all or one a member) where given, else the ints."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    offs = []
    for t in (q_offs, k_offs):
        if t is None:
            offs += [None, 0]
            continue
        if t.numel() not in (1, n_members) or t.device != q.device:
            raise ValueError(f"flash_attention_block: {t.numel()} offsets on {t.device} "
                             f"for {n_members} members on {q.device}")
        offs += [t.data_ptr(), int(t.numel() > 1)]
    lib = _library()
    arr = (ctypes.c_longlong * 9)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ptt_flash_attention_block(
            int(mode.startswith("bf16")), n_members, sq, sk, d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            *(o.data_ptr() for o in outs), q_off, k_off, int(bool(causal)), float(scale),
            ctypes.addressof(arr), *offs, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_block kernel launch failed: "
                           f"cudaError {rc} ({mode}, batch {n_members})")


def _flash_attention_block(q, k, v, acc, m, l, q_off: int, k_off: int, causal, scale):
    sq, sk, d = _check_attention(q, k, v, acc, m, l)
    _count(flash_attention_block, "calls")
    if q.device.type == "cpu":
        return flash_attention_block_plain(q, k, v, acc, m, l, q_off, k_off,
                                           causal=causal, scale=scale)
    mode = _attention_mode(q.dtype, k.dtype, v.dtype, d)
    if not mode.startswith("bf16"):
        q, k, v = q.float(), k.float(), v.float()  # no copy for float32
    outs = (torch.empty_like(acc), torch.empty_like(m), torch.empty_like(l))
    if sq == 0:
        return outs
    _flash_launch(1, mode, q, k, v, acc, m, l, outs, q_off, k_off, causal, scale, (0,) * 9)
    _count_mode(flash_attention_block, mode)
    return outs


def _offsets(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The members' offsets as contiguous int64 (a device op: no copy to
    or from the host, so it may run inside a CUDA-graph capture)."""
    return None if t is None else t.to(torch.int64).reshape(-1).contiguous()


def _flash_batched(n_members: int, q, k, v, acc, m, l, q_offs, q_off: int, k_offs,
                   k_off: int, causal: bool, scale: float):
    """``n_members`` block updates in one launch (a vmap rule's body): each
    operand stacked ``(members, ...)`` or shared, each offset a tensor of
    the members' (or one shared) or an int."""
    q, k, v, acc, m, l = (_members_rowmajor(t) for t in (q, k, v, acc, m, l))
    _check_batch("flash_attention_block", n_members, q, k, v, acc, m, l)
    sq, sk, d = _check_attention(*(_member(t) for t in (q, k, v, acc, m, l)))
    _count(flash_attention_block, "calls")
    q_offs, k_offs = _offsets(q_offs), _offsets(k_offs)
    if q.device.type == "cpu":
        outs = flash_attention_block_plain(
            q, k, v, acc, m, l, q_off if q_offs is None else q_offs,
            k_off if k_offs is None else k_offs, causal=causal, scale=scale)
        return tuple(o.expand(n_members, *o.shape[-2:]) for o in outs)
    mode = _attention_mode(q.dtype, k.dtype, v.dtype, d)
    if not mode.startswith("bf16"):
        q, k, v = q.float(), k.float(), v.float()
    outs = tuple(torch.empty((n_members, sq, c), dtype=torch.float32, device=q.device)
                 for c in (d, 1, 1))
    if sq == 0:
        return outs
    _flash_launch(n_members, mode, q, k, v, acc, m, l, outs, q_off, k_off, causal, scale,
                  (*(_batch_stride(t) for t in (q, k, v, acc, m, l)),
                   *(o.stride(0) for o in outs)), q_offs, k_offs)
    _count_mode(flash_attention_block, mode + "_b", n_members)
    return outs


@torch.library.custom_op("parsec_tpu_torch::flash_attention_block", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, acc: torch.Tensor,
              m: torch.Tensor, l: torch.Tensor, q_offs: Optional[torch.Tensor], q_off: int,
              k_offs: Optional[torch.Tensor], k_off: int, causal: bool,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if (q_offs is None and k_offs is None) or q.device.type == "cpu":
        return _flash_attention_block(
            q, k, v, acc, m, l, q_off if q_offs is None else int(q_offs),
            k_off if k_offs is None else int(k_offs), causal, scale)
    # offsets on the card: read there by a one-member launch, never
    # brought to the host
    outs = _flash_batched(1, q, k, v, acc, m, l, q_offs, q_off, k_offs, k_off, causal, scale)
    return tuple(o[0].clone() for o in outs)


def _flash_vmap(info, in_dims, q, k, v, acc, m, l, q_offs, q_off, k_offs, k_off, causal,
                scale):
    q, k, v, acc, m, l, q_offs, k_offs = (
        _lead(t, d) for t, d in zip((q, k, v, acc, m, l, q_offs, k_offs),
                                    (*in_dims[:7], in_dims[8])))
    return _flash_batched(info.batch_size, q, k, v, acc, m, l, q_offs, q_off, k_offs, k_off,
                          causal, scale), (0, 0, 0)


torch.library.register_vmap(_flash_op, _flash_vmap)

flash_attention_block.calls = 0
flash_attention_block.launches = 0
flash_attention_block.members = 0
flash_attention_block.launches_by_mode = _with_batched(("f32", "bf16", "f32_wide", "bf16_wide"))

_WRAPPERS = (matmul_update, matmul, stencil_5pt, stencil_5pt_fused,
             flash_attention_block)


def reset_counts() -> None:
    """Zero every wrapper's ``calls`` and ``launches`` (per mode too)."""
    with _count_lock:
        for fn in _WRAPPERS:
            fn.calls = 0
            fn.launches = 0
            if hasattr(fn, "members"):
                fn.members = 0
            for mode in getattr(fn, "launches_by_mode", ()):
                fn.launches_by_mode[mode] = 0


def launch_counts() -> Dict[Tuple[str, str], int]:
    """Every wrapper's launches, ``(name, "total")`` and ``(name, mode)``
    per mode: a snapshot to difference around a CUDA-graph capture."""
    with _count_lock:
        out = {}
        for fn in _WRAPPERS:
            out[(fn.__name__, "total")] = fn.launches
            if hasattr(fn, "members"):
                out[(fn.__name__, "members")] = fn.members
            for mode, n in getattr(fn, "launches_by_mode", {}).items():
                out[(fn.__name__, mode)] = n
        return out


def add_launches(delta: Dict[Tuple[str, str], int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two :func:`launch_counts`)
    to the counters.  A capture runs the wrappers without launching a
    kernel, and a replay launches them without running a wrapper: a
    captured graph's launches are taken back at its capture
    (``times=-1``) and added at each replay, so ``launches`` counts what
    the card ran."""
    by_name = {fn.__name__: fn for fn in _WRAPPERS}
    with _count_lock:
        for (name, mode), n in delta.items():
            fn = by_name[name]
            if mode == "total":
                fn.launches += times * n
            elif mode == "members":
                fn.members += times * n
            else:
                fn.launches_by_mode[mode] += times * n
