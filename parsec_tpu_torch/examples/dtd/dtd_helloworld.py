"""DTD hello world — sequential-looking task insertion.

Reference analog: ``examples/interfaces/dtd/dtd_example_hello_world.c``
— create a DTD taskpool, insert one task with no tracked data, wait.
Dependencies are inferred at insertion time; with none, the task is
immediately ready.
"""

import sys

from parsec_tpu_torch import Context
from parsec_tpu_torch.dsl.dtd import DTDTaskpool


def main(device=None) -> dict:
    said = []
    with Context(nb_cores=2, cuda_device=device) as ctx:
        tp = DTDTaskpool(ctx, "hello")
        tp.insert_task(lambda: said.append("Hello world from a DTD task"))
        assert tp.wait(timeout=10)
        tp.close()              # end of insertion: pool can terminate
    assert said, "task did not run"
    print("dtd_helloworld:", said[0])
    return {"said": said}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
