"""Card time in the traced stretch (the union of kernel, copy and memset
intervals) over the batches whose program ran in it, counted by their B1
launches, one a batch."""

NAME = "device.busy_ms"
UNIT = "ms"
LAYER = "device program"
MOVES = "reads_per_s"
BETTER = "lower"
KERNEL = "nw_band"


def read(records):
    t = records.trace
    if t is None or not t["kernels"][KERNEL]["n"] or t["busy_s"] <= 0:
        return None
    return t["busy_s"] / t["kernels"][KERNEL]["n"] * 1e3
