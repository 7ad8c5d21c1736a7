"""Device modules: the CPU cores (device 0) and the CUDA accelerator module
with its staging pipeline (:mod:`.staging`: the prefetch lane and the
write-back committer).

The template module of :mod:`parsec_tpu.device` is not ported yet.
"""

from .device import (
    ADVICE_PREFERRED_DEVICE,
    ADVICE_PREFETCH,
    ADVICE_WARMUP,
    CpuDevice,
    Device,
)
from .cuda import CudaDevice

__all__ = [
    "ADVICE_PREFERRED_DEVICE",
    "ADVICE_PREFETCH",
    "ADVICE_WARMUP",
    "CpuDevice",
    "CudaDevice",
    "Device",
]
