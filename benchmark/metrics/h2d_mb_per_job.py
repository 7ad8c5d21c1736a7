"""h2d_mb_per_job: the bytes the device module staged to the card a job
(its ``stats['bytes_in']``, averaged over the window's jobs), in MB
(10^6 bytes).  Latent attention stages each input tile once a job: q, the
latent and rotary blocks and each head's weight rows once, the carries
once, and none of the K and V tiles its tasks make on the card; the number
rises if a task-made or shared tile is ever staged again.  Layer: staging
and CUDA device module."""

UNIT = "MB"


def read(run):
    jobs = [j for j in run.jobs if "bytes_in" in j]
    return sum(j["bytes_in"] for j in jobs) / len(jobs) / 1e6 if jobs else None
