"""kernels_roofline: the least time the card could take for the traced
jobs' useful work (the larger of flops over the precision's peak and bytes
over HBM bandwidth, ``benchmark/roofline``), over the summed device time of
every kernel in the traced jobs, in percent.  It reads the same work
whichever kernel, fusion or library call does it.  Layer: kernels."""

from benchmark.roofline import work

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0 or t.jobs != len(run.jobs):
        return None
    n = len(run.jobs)
    least = work.least_seconds(run.flops * n, run.nbytes * n, run.precision, run.peaks)
    return 100.0 * least / t.kernel_s
