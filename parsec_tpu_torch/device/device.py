"""Device registry and best-device selection.

Reference: ``parsec/mca/device/device.{c,h}`` — device 0 is the CPU-cores
device, accelerators attach after; per-task placement picks the device
minimizing estimated-time-of-availability (device load + per-task time
estimate, with a load-balance skew factor), after honouring data
affinity: if a task's data is already resident on an accelerator, prefer
it (``parsec_select_best_device``, ``device.c:92-266``, skew ``:54-60``).

Unlike :func:`parsec_tpu.device.device.attach_devices`, which warns and
skips a module that fails to attach, the port lets the failure propagate:
a dpotrf asked to run on the GPU must never carry on silently on CPU
chores.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, TYPE_CHECKING

from ..utils import Component, debug, mca_param, register_component
from ..core.lifecycle import DEV_CPU, HookReturn

if TYPE_CHECKING:  # pragma: no cover
    from ..core.context import Context
    from ..core.task import Task


# data_advise advice values (reference device.h:76-78)
ADVICE_PREFETCH = 0x01
ADVICE_PREFERRED_DEVICE = 0x02
ADVICE_WARMUP = 0x03


class Device(Component):
    """Base device module (reference device vtable, ``device.h:142-158``)."""

    mca_type = "device"
    device_type: str = DEV_CPU

    def __init__(self, context: "Context", index: int):
        self.context = context
        self.index = index
        self.name = f"{self.mca_name}{index}"
        self._load_lock = threading.Lock()
        #: estimated completion horizon (seconds of queued work)
        self.device_load: float = 0.0
        #: relative throughput weight used by the default time estimate;
        #: reference derives GFLOPS ratings per device
        self.gflops_rating: float = 1.0
        self.stats: Dict[str, int] = {
            "executed_tasks": 0,
            "bytes_in": 0,
            "bytes_out": 0,
            "bytes_d2d": 0,  # device-to-device landings (no host bounce)
            "evictions": 0,
        }
        self.enabled = True

    # -- vtable ---------------------------------------------------------
    def attach(self) -> None:
        pass

    def detach(self) -> None:
        pass

    def taskpool_register(self, tp) -> None:
        pass

    def memory_register(self, data) -> None:
        pass

    def memory_unregister(self, data) -> None:
        pass

    def data_advise(self, data, advice: int) -> None:
        """Placement hint (reference ``device.h:76-78,328``):
        PREFERRED_DEVICE pins the selector's choice to this device."""
        if advice == ADVICE_PREFERRED_DEVICE:
            data.preferred_device = self.index

    def time_estimate(self, task: "Task") -> float:
        """Seconds this task would take here (lower = better)."""
        tc = task.task_class
        if tc.time_estimate is not None:
            return tc.time_estimate(task, self)
        return 1e-4 / self.gflops_rating

    def kernel_scheduler(self, es, task: "Task") -> HookReturn:
        """Accelerators override: take ownership of the task (ASYNC)."""
        raise NotImplementedError

    def add_load(self, dt: float) -> None:
        with self._load_lock:
            self.device_load += dt

    def sub_load(self, dt: float) -> None:
        with self._load_lock:
            self.device_load = max(0.0, self.device_load - dt)

    def count_executed(self, n: int = 1) -> None:
        """``n`` tasks retired here.  Locked: CPU-device completions arrive
        from every worker at once, and a bare ``+=`` loses updates."""
        with self._load_lock:
            self.stats["executed_tasks"] += n

    def resident_data(self, task: "Task") -> int:
        """Bytes of this task's input data already resident here (affinity)."""
        return 0

    def set_aside(self, nbytes: int) -> None:
        """Leave ``nbytes`` of this device's memory to work in flight that
        its residency accounting does not see (a fused region's interior
        values).  Devices with no memory budget have nothing to leave."""


@register_component("device")
class CpuDevice(Device):
    """Device 0: the worker cores themselves. CPU chores run inline in the
    calling worker, so the kernel_scheduler is never used."""

    mca_name = "cpu"
    mca_priority = 100
    device_type = DEV_CPU

    def kernel_scheduler(self, es, task):  # pragma: no cover - inline exec
        raise AssertionError("CPU chores execute inline")


def attach_devices(context: "Context", names: Optional[List[str]] = None) -> List[Device]:
    """Instantiate the CPU device plus every selected accelerator module
    (reference ``parsec_mca_device_init``/``attach``, ``parsec.c:809-815``).

    ``names`` (or the ``device_enabled`` MCA param) selects modules; the
    CPU device always attaches.  A selected module that cannot attach —
    the CUDA module on a host without a GPU and without an explicit CPU
    request — raises."""
    from ..utils import components_of_type

    sel = names
    if sel is None:
        sel_param = str(mca_param.register(
            "device", "enabled", "", help="comma list of device modules (empty=all)"))
        sel = [s.strip() for s in sel_param.split(",") if s.strip()] or None

    devices: List[Device] = []
    for cls in components_of_type("device"):
        explicit = sel is not None and cls.mca_name in sel
        if sel is not None and not explicit and cls.mca_name != "cpu":
            continue
        # naming a module trumps its availability probe: a module inert
        # by default (the template) attaches when asked for
        if not explicit and not cls.available():
            continue
        dev = cls(context, len(devices))
        dev.attach()
        devices.append(dev)
    if not devices or devices[0].device_type != DEV_CPU:
        raise RuntimeError("CPU device must attach first")
    if len(devices) == 1:
        debug.info("host-only context: no accelerator module attached "
                   "(devices=%s); only CPU chores can run", sel)
    context._device_skew = mca_param.register(
        "device", "load_balance_skew", 0.9,
        help="multiplier applied to accelerator ETAs (<1 favours accelerators)",
    )
    return devices


def detach_devices(context: "Context") -> None:
    """Detach every device, then re-raise the first failure: a detach that
    could not write the device's dirty tiles home (a dead write-back
    committer, a failed copy) leaves pre-run host tiles behind, and a
    caller reading them must not carry on.  Every device is detached
    before the raise."""
    first: Optional[BaseException] = None
    for dev in getattr(context, "devices", []):
        try:
            dev.detach()
        except Exception as e:
            debug.error("device %s detach failed: %s", dev.name, e)
            if first is None:
                first = e
    if first is not None:
        raise first


def _prefers_device(task: "Task", dev: Device) -> bool:
    args = task.body_args
    if not isinstance(args, (list, tuple)):
        return False
    for spec in args:
        if (isinstance(spec, (list, tuple)) and len(spec) >= 2
                and spec[0] == "data" and spec[1] is not None
                and getattr(spec[1], "preferred_device", -1) == dev.index):
            return True
    return False


def select_best_device(context: "Context", task: "Task") -> HookReturn:
    """Pick (device, chore) for a ready task; reference ``device.c:92-266``.

    Order of criteria:
      0. explicit preference (data_advise PREFERRED_DEVICE) on any input;
      1. data affinity — an accelerator already holding the task's inputs
         wins outright (saves device-memory traffic);
      2. minimal ETA = device_load + time_estimate, accelerators discounted
         by the load-balance skew parameter.
    """
    tc = task.task_class
    skew = getattr(context, "_device_skew", 0.9)
    eligible = []
    for dev in context.devices:
        if not dev.enabled:
            continue
        for ci, chore in enumerate(tc.chores):
            if not chore.enabled or chore.device_type != dev.device_type:
                continue
            if not (task.chore_mask & (1 << ci)):
                continue
            if chore.evaluate is not None and not chore.evaluate(task):
                continue
            eligible.append((dev, chore, ci))
            break
    if not eligible:
        return HookReturn.NEXT

    best = None
    for dev, chore, ci in eligible:
        if _prefers_device(task, dev):
            best = (dev, chore, ci)
            break
    best_bytes = 0
    if best is None:
        for dev, chore, ci in eligible:
            if dev.device_type == DEV_CPU:
                continue
            rb = dev.resident_data(task)
            if rb > best_bytes:
                best, best_bytes = (dev, chore, ci), rb
    if best is None:
        best_eta = None
        for dev, chore, ci in eligible:
            est = chore.time_estimate(task, dev) if chore.time_estimate else dev.time_estimate(task)
            eta = dev.device_load + est
            if dev.device_type != DEV_CPU:
                eta *= skew
            if best_eta is None or eta < best_eta:
                best_eta, best = eta, (dev, chore, ci)
    dev, chore, ci = best
    task.selected_device = dev
    task.selected_chore = chore
    task.selected_chore_idx = ci
    est = chore.time_estimate(task, dev) if chore.time_estimate else dev.time_estimate(task)
    dev.add_load(est)
    task.prof["est"] = est
    return HookReturn.DONE
