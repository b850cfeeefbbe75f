"""Host time of the batch iterator's ``next()`` (``batch_reads_native``
over the pool's FASTQ: the native parse into fixed-shape batches), a batch
on average over the window."""

NAME = "io.parse_ms"
UNIT = "ms"
LAYER = "io"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    if not records.n_batches:
        return None
    return records.span_s["parse"] / records.n_batches * 1e3
