"""Host time of ``pack_reads`` (the program's ``submit.pack`` span), a
batch on average over the window.  A part of ``graphs.submit_ms``."""

from mapbench.spans import per_batch_ms

NAME = "graphs.pack_ms"
UNIT = "ms"
LAYER = "captured programs"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "submit.pack")
