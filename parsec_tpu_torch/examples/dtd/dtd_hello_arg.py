"""DTD with arguments — VALUE capture and tracked INOUT tiles.

Reference analog: ``examples/interfaces/dtd/dtd_example_hello_arg.c`` —
tasks receive by-value arguments and tracked data tiles; the runtime
infers the RAW chain on the tile from insertion order.
"""

import sys

import numpy as np

from parsec_tpu_torch import Context
from parsec_tpu_torch.data import data_create
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, INOUT, VALUE


def main(device=None, *, ntasks: int = 10) -> dict:
    with Context(nb_cores=2, cuda_device=device) as ctx:
        tile = data_create("acc", payload=np.zeros(1))
        tp = DTDTaskpool(ctx, "hello_arg")

        def add(acc, amount):          # tracked tile + value argument
            acc += amount

        for i in range(ntasks):
            tp.insert_task(add, (tile, INOUT), (float(i), VALUE))
        assert tp.wait(timeout=10)
        tp.close()

        total = float(tile.newest_copy().payload[0])
    assert total == sum(range(ntasks)), total
    print(f"dtd_hello_arg: {ntasks} inserted tasks accumulated {total:.0f}")
    return {"total": total}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
