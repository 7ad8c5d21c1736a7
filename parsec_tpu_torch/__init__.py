"""parsec_tpu_torch — the PyTorch/CUDA port of parsec_tpu.

A task-based runtime in the PaRSEC mould — DAGs of micro-tasks with
data-dependency edges, expressed as a Parameterized Task Graph (PTG, built
at run time or compiled from a ``.jdf`` file) or inserted task by task
(DTD), and executed by one of twelve multi-threaded schedulers — whose
accelerator bodies are torch on an NVIDIA GPU, with the hot tile kernels
written by hand in CUDA C++ for Hopper (``csrc/``).  Its user-facing
paths: tiled Cholesky (:func:`parsec_tpu_torch.ops.run_cholesky`),
blockwise flash attention (:func:`parsec_tpu_torch.ops.run_flash_attention`)
and the 2D 5-point stencil (:func:`parsec_tpu_torch.ops.stencil_ptg`).

This package never imports JAX or :mod:`parsec_tpu`: it keeps its own copy
of every framework-neutral layer it needs.  Its entry points run on the
GPU unless the caller asks for the CPU (``Context(cuda_device="cpu")``,
or ``Context(devices=["cpu"])`` for a host-only context).
"""

from .utils import debug, mca_param
from .core import (
    AccessMode,
    Chore,
    CompoundTaskpool,
    Context,
    Flow,
    HookReturn,
    Task,
    TaskClass,
    Taskpool,
    TaskStatus,
    compose,
    DEV_CPU,
    DEV_CUDA,
)
from . import device  # register device components  # noqa: F401

__all__ = [
    "debug",
    "mca_param",
    "AccessMode",
    "Chore",
    "CompoundTaskpool",
    "Context",
    "Flow",
    "HookReturn",
    "Task",
    "TaskClass",
    "Taskpool",
    "TaskStatus",
    "compose",
    "DEV_CPU",
    "DEV_CUDA",
]
