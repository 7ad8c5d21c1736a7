"""Ex00 — start/stop the runtime.

Reference analog: ``examples/Ex00_StartStop.c`` — ``parsec_init`` /
``parsec_fini`` with a worker-thread count.  Here the :class:`Context`
spawns the worker execution streams, installs the scheduler component,
and attaches the device roster (the CUDA module on the card, or on the
torch CPU device with ``device="cpu"``); ``fini`` quiesces and joins
everything.
"""

import sys

from parsec_tpu_torch import Context


def main(device=None, *, cores: int = 2) -> dict:
    # nb_cores plays the role of the reference's `parsec_init(cores, ...)`
    ctx = Context(nb_cores=cores, cuda_device=device)
    assert ctx.nb_workers == cores
    assert ctx.wait(timeout=5)  # nothing enqueued: immediate quiescence
    devices = [d.mca_name for d in ctx.devices]
    ctx.fini()

    # contexts are also context managers (init/fini pairing enforced)
    with Context(nb_cores=1, cuda_device=device) as ctx2:
        assert ctx2.wait(timeout=5)
    print("ex00: context started and stopped cleanly")
    return {"workers": cores, "devices": devices}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
