"""Host time of the native FASTQ chunk parse (the program's
``io.parse_chunk`` span: ``native_lib.parse_fastq_chunk`` in
``batch_reads_native``, up to four batches a call), a batch on average
over the window.  A part of ``io.parse_ms``."""

from mapbench.spans import per_batch_ms

NAME = "io.native_parse_ms"
UNIT = "ms"
LAYER = "io"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "io.parse_chunk")
