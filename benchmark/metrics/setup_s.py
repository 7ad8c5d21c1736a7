"""setup_s: process start to the first timed job: imports, the CUDA
context, building or loading the program's libraries, the inputs made from
the seed, the answer slots and the warm-up jobs."""

UNIT = "s"


def read(run):
    return run.setup_s
