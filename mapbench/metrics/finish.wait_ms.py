"""Host time the finish waits for the batch's blob (the program's
``finish.wait`` span: the copy's event and the host array;
``BatchStats.device_s``), a batch on average over the window.  A part of
``stream.finish_ms``."""

from mapbench.spans import per_batch_ms

NAME = "finish.wait_ms"
UNIT = "ms"
LAYER = "stream finish"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "finish.wait")
