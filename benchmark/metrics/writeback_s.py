"""writeback_s: seconds a job waits in ``NativeExecutor.close()`` for its
tiles to come home (the device module's flush), the harness's clock around
it, averaged over the window's jobs.  Layer: staging and CUDA device
module."""

UNIT = "s"


def read(run):
    spans = [j["writeback_s"] for j in run.jobs if "writeback_s" in j]
    return sum(spans) / len(spans) if spans else None
