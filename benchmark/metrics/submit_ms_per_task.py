"""submit_ms_per_task: the pump's host milliseconds submitting a task to
the device module (``NativeExecutor.stats['submit_s']`` summed over the
window's jobs, over the tasks they ran).  Layer: native pump and engine."""

UNIT = "ms"


def read(run):
    tasks = sum(j["tasks"] for j in run.jobs)
    return sum(j["submit_s"] for j in run.jobs) / tasks * 1e3 if tasks else None
