"""Host time of ``TorchMapper.submit`` (``pack_reads``, the uploads into the
captured program's static inputs, the replay and the blob's copy back
enqueued), a batch on average over the window."""

NAME = "graphs.submit_ms"
UNIT = "ms"
LAYER = "captured programs"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    if not records.n_batches:
        return None
    return records.span_s["submit"] / records.n_batches * 1e3
