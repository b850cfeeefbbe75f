"""Host time of the SAM formatter, ``format_sam_batch_native`` (the
program's ``stream.sam_format`` span: its per-hit lists and one native
call), a batch on average over the window.  A part of ``stream.self_ms``."""

from mapbench.spans import per_batch_ms

NAME = "stream.sam_ms"
UNIT = "ms"
LAYER = "stream"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "stream.sam_format")
