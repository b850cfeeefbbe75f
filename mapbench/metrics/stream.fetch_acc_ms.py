"""Host time of ``map_stream``'s fetch of the device accumulators (the
program's ``stream.fetch_acc`` span: coverage and the four tally planes to
the host as float64, once at the window's end when no checkpoint is
written), a batch on average over the window."""

from mapbench.spans import per_batch_ms

NAME = "stream.fetch_acc_ms"
UNIT = "ms"
LAYER = "stream"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "stream.fetch_acc")
