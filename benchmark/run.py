"""Run one cell of the benchmark of parsec_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  The cell's
configuration, traffic mix, limits and per-layer metrics are found by the
names in ``BENCHMARK.json`` (see ``benchmark/harness/spec.py``).  The last
line of standard output is the result as one JSON object; the compared
numbers and their limits are the last lines of standard error.  Without a
usable card, or without the program in the checkout, it prints no result
and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness.cell import log, run_cell, set_cache_env
    from benchmark.harness.spec import SpecError, load_cell

    set_cache_env()
    try:
        cell = load_cell(args.workload)
    except SpecError as e:
        log(f"cannot load the cell: {e}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this benchmark needs an NVIDIA GPU")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} GPU(s), torch sees {torch.cuda.device_count()}")
        return 2
    try:
        import parsec_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program parsec_tpu_torch is not importable here: {e}")
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                    t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
