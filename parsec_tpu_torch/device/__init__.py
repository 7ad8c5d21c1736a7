"""Device modules: the CPU cores (device 0), the CUDA accelerator module
with its staging pipeline (:mod:`.staging`: the prefetch lane and the
write-back committer), and the template module (:mod:`.template`: the
skeleton of a new backend, inert unless selected; it runs bodies on the
host).
"""

from .device import (
    ADVICE_PREFERRED_DEVICE,
    ADVICE_PREFETCH,
    ADVICE_WARMUP,
    CpuDevice,
    Device,
    select_best_device,
)
from .cuda import CudaDevice
from .template import DEV_TEMPLATE, TemplateDevice

__all__ = [
    "ADVICE_PREFERRED_DEVICE",
    "ADVICE_PREFETCH",
    "ADVICE_WARMUP",
    "CpuDevice",
    "CudaDevice",
    "DEV_TEMPLATE",
    "Device",
    "TemplateDevice",
    "select_best_device",
]
