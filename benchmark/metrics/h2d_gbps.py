"""h2d_gbps: bytes the device module staged to the card (its
``stats['bytes_in']``, summed over the traced jobs) over the device time of
the ``Memcpy HtoD`` intervals in the trace.  Layer: staging and CUDA
device module."""

UNIT = "GB/s"


def read(run):
    t = run.trace
    if t is None or t.h2d_s <= 0 or t.jobs != len(run.jobs):
        return None
    return sum(j["bytes_in"] for j in run.jobs) / t.h2d_s / 1e9
