"""gflops: the useful flops of the jobs that started and finished inside
the window (``benchmark/roofline/work.py``) over the sum of their walls,
each wall from taskpool construction to the answer home on the host."""

UNIT = "GFLOP/s"


def read(run):
    counted = [j for j in run.jobs if j["counted"]]
    if not counted:
        return None
    return run.flops * len(counted) / sum(j["wall"] for j in counted) / 1e9
