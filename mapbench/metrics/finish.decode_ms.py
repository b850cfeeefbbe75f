"""Host time of the finish's work on the fetched blob (the program's
``finish.decode`` span: ``decode_tb_blob`` and its per-hit ``ReadHit``
objects; ``BatchStats.host_s``), a batch on average over the window.  A
part of ``stream.finish_ms``."""

from mapbench.spans import per_batch_ms

NAME = "finish.decode_ms"
UNIT = "ms"
LAYER = "stream finish"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "finish.decode")
