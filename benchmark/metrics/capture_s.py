"""capture_s: seconds a job spends building its taskpool and its
``NativeExecutor`` (capture and build), the harness's clock around them,
averaged over the window's jobs.  Layer: entry points, PTG and capture."""

UNIT = "s"


def read(run):
    spans = [j["capture_s"] for j in run.jobs if "capture_s" in j]
    return sum(spans) / len(spans) if spans else None
