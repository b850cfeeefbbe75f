"""Share of the traced stretch in which no kernel, copy or memset ran on
the card (``torch.profiler``, CUDA activity)."""

NAME = "device.idle_pct"
UNIT = "%"
LAYER = "device"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    t = records.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
