"""Template device module — the documented starting point for a new
accelerator backend.

The port of :mod:`parsec_tpu.device.template`.  Reference:
``parsec/mca/device/template/`` ships a skeleton component so a new
device type can be written by filling in the vtable.  This module is the
same thing for the port, and it runs: bodies execute synchronously on the
host, so it can be attached and watched before any real backend code
exists.

To build a real backend from this template:

1. copy the file, rename the class and ``mca_name``;
2. keep the ``@register_component("device")`` decorator — the component
   registry discovers it by type, and ``Context(devices=[..., "<name>"])``
   or ``PARSEC_MCA_device_enabled=<name>`` selects it (reference:
   ``parsec_mca_device_attach``, ``device.h:224``);
3. pick the ``device_type`` tag — task bodies are matched to devices by
   this string (one chore per incarnation);
4. implement the capability areas, in rough order of payoff:

   * **kernel_scheduler** (mandatory): called on a worker thread once the
     core selected this device (``scheduling.c:137``).  Return
     ``HookReturn.DONE`` for synchronous completion, or enqueue the task,
     return ``HookReturn.ASYNC`` and later call
     ``scheduling.complete_execution(...)`` from a manager thread — the
     reference GPU manager state machine (``device_gpu.c:2510-2730``;
     :mod:`.cuda` is the full version with staging, dual-LRU residency
     and the transfer pipeline);
   * **stage in/out**: move ``Data`` copies to and from the device's
     memory, keeping versions (``attach_copy``, ``version_bump``);
   * **time_estimate**: seconds a task would take here — the device
     selector minimizes load + estimate (``device.c:92-266``);
   * **memory_register/unregister** and per-taskpool warm-up, where the
     transport or the compiler needs them.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..core.lifecycle import AccessMode, HookReturn
from ..utils import mca_param, register_component
from .device import Device

if TYPE_CHECKING:  # pragma: no cover
    from ..core.task import Task

#: the device_type string task chores must carry to run here
DEV_TEMPLATE = "template"


@register_component("device")
class TemplateDevice(Device):
    """A minimal synchronous device: host execution, full accounting."""

    mca_name = "template"
    mca_priority = -1
    device_type = DEV_TEMPLATE

    @classmethod
    def available(cls) -> bool:
        """Inert unless asked for (the reference template never builds by
        default either): ``PARSEC_MCA_device_template_enabled=1``, or name
        it, as in ``Context(devices=[..., "template"])``."""
        return bool(mca_param.register(
            "device", "template_enabled", 0,
            help="attach the template (host-execution) device module"))

    def __init__(self, context, index: int):
        super().__init__(context, index)
        self.data_index = index
        # a modest rating: only tasks that carry a template chore and
        # nothing faster come here
        self.gflops_rating = 1.0

    def kernel_scheduler(self, es, task: "Task") -> HookReturn:
        """Synchronous exemplar: resolve the arguments as the CPU path
        does (the newest version staged to the host copy — a tile a CUDA
        body wrote is read after its ready event), run the chore's body,
        commit on host copy 0 and retire inline.  A real backend enqueues
        and returns ASYNC here."""
        from ..dsl.ptg import stage_to_cpu

        chore = task.selected_chore
        body = chore.body_fn
        if body is None:
            raise RuntimeError(f"template chore of {task!r} has no body")
        args = []
        writable = []
        for kind, payload, mode in task.body_args or ():
            if kind == "data":
                if payload is None:
                    args.append(None)
                    continue
                # the template's "device memory" is host memory
                args.append(stage_to_cpu(payload))
                payload.transfer_ownership(0, mode & AccessMode.INOUT)
                if mode & AccessMode.OUT:
                    writable.append(payload)
            elif kind == "value":
                args.append(payload)
            # "ctl" contributes no argument
        result = body(*args)
        # a returned value replaces the writable flows in order; the
        # commit is host copy 0 plus version_bump(0), as the CPU hook's
        if result is not None:
            outs = result if isinstance(result, (tuple, list)) else (result,)
            if len(outs) != len(writable):
                raise ValueError(
                    f"{task!r}: body returned {len(outs)} outputs for "
                    f"{len(writable)} writable flows")
            for data, new in zip(writable, outs):
                data.get_copy(0).payload = np.asarray(new)
        for data in writable:
            data.version_bump(0)
        # executed_tasks is counted at completion (core/scheduling.py)
        return HookReturn.DONE
