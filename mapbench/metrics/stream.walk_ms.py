"""Host time of ``map_stream``'s per-read and per-hit loop (the program's
``stream.walk`` span), a batch on average over the window.  A part of
``stream.self_ms``."""

from mapbench.spans import per_batch_ms

NAME = "stream.walk_ms"
UNIT = "ms"
LAYER = "stream"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "stream.walk")
