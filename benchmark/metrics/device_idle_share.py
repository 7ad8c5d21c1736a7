"""device_idle_share: the share of the traced jobs' walls in which no
kernel and no copy ran on the card (one less the union of the device
intervals over the window), in percent.  Layer: device."""

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
