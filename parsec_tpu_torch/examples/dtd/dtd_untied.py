"""DTD untied tasks — long-running bodies that release their worker.

Reference analog:
``examples/interfaces/dtd/dtd_example_hello_world_untied.c`` (and
``tests/dsl/dtd/dtd_test_untie.c``) — a long-running task must not pin a
worker thread.  Here a body written as a *generator* runs in slices:
every ``yield`` returns the worker to the scheduler (other tasks
interleave), and the task resumes on whichever worker picks it up next
(``parsec_tpu_torch.dsl.dtd``'s untied-task support).
"""

import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import data_create
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, INOUT


def main(device=None, *, slices: int = 3) -> dict:
    interleaved = []
    with Context(nb_cores=1, cuda_device=device) as ctx:  # ONE worker: slicing must share it
        tile = data_create("x", payload=np.zeros(1))
        tp = DTDTaskpool(ctx, "untied")

        def long_task(x):
            for step in range(slices):
                interleaved.append(f"long{step}")
                yield                     # untied: release the worker
            x += 100.0

        def short_task():
            interleaved.append("short")

        tp.insert_task(long_task, (tile, INOUT))
        tp.insert_task(short_task)
        assert tp.wait(timeout=10)
        tp.close()
        val = float(tile.newest_copy().payload[0])

    assert val == 100.0
    # the short task ran between slices of the long one, on one worker
    assert "short" in interleaved and interleaved[0] == "long0", interleaved
    assert interleaved.index("short") < len(interleaved) - 1, interleaved
    print(f"dtd_untied: slices interleaved as {interleaved}")
    return {"interleaved": interleaved, "value": val}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
