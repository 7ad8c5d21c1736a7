"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, at the cell's own size, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--controls tf32] [--control-seeds 11,12,13]

For each seed it runs one job of the cell through the program (after one
warm-up job) and prints its compared numbers against the plain
reference.  For each control seed it also prints the numbers of each
control: the plain reference computed in that precision (``tf32``,
``fp8``) and put in the program's place.  One JSON line per seed.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def readings(cell, seeds, controls, control_seeds, device: str):
    """Yield one dict of readings per seed."""
    import torch

    from benchmark.harness.cell import Phases, bind_device

    bind_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = Phases(False)
    warmed = False
    for seed in seeds:
        t0 = time.perf_counter()
        job = cell.entry.Job(cell.config, cell.traffic, seed, device)
        if not warmed:
            job.warm(phases)
            warmed = True
        job.keep(job.run(job.fresh_input(), phases)["output"], 0)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = job.reference()
        row = {"seed": seed, "program": job.numbers(job.kept(1), ref)}
        for control in controls if seed in control_seeds else ():
            got = job.control(control)
            row[control] = job.numbers([got], ref)
            del got
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        del ref, job
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control-seeds", type=_ints, default=[])
    args = ap.parse_args(argv)

    from benchmark.harness.cell import set_cache_env
    from benchmark.harness.spec import load_cell

    set_cache_env()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(",") if c]
    for row in readings(cell, args.seeds, controls, set(args.control_seeds), "cuda"):
        print(json.dumps({"workload": cell.name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
