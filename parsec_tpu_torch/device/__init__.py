"""Device modules: the CPU cores (device 0) and the CUDA accelerator module.

The staging pipeline and the template module of :mod:`parsec_tpu.device`
are not ported yet (ROADMAP A.4).
"""

from .device import ADVICE_PREFERRED_DEVICE, CpuDevice, Device
from .cuda import CudaDevice

__all__ = [
    "ADVICE_PREFERRED_DEVICE",
    "CpuDevice",
    "CudaDevice",
    "Device",
]
