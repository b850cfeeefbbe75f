"""Host time of the accumulate program's eager enqueue (the program's
``finish.accumulate`` span: ``finish_acc`` calling ``device_accumulate``,
its sorts, segmented scans, delta windows and B5's launch), a batch on
average over the window.  A part of ``stream.finish_ms``."""

from mapbench.spans import per_batch_ms

NAME = "finish.accumulate_ms"
UNIT = "ms"
LAYER = "accumulate"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "finish.accumulate")
