"""mla_attn_roofline: the least time the card could take for the traced
jobs' attention work (``benchmark/roofline/mla.py``: ``2 * (Dqk + Dv)``
flops a kept pair and head, q, K, V and the output once), over the summed
device time of the kernels whose name holds ``flash_block_kernel`` in the
traced jobs, in percent: B5's share of its roofline at latent attention's
192 / 128.  None where no such kernel ran or the jobs carry no attention
work.  Layer: kernels."""

from benchmark.roofline import work

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or not run.jobs or t.jobs != len(run.jobs):
        return None
    kernel_s = sum(s for name, s in t.device_ops if "flash_block_kernel" in name)
    if kernel_s <= 0 or any("attn_flops" not in j for j in run.jobs):
        return None
    least = work.least_seconds(sum(j["attn_flops"] for j in run.jobs),
                               sum(j["attn_bytes"] for j in run.jobs), run.precision,
                               run.peaks)
    return 100.0 * least / kernel_s
