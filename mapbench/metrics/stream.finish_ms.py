"""Host time of ``TorchMapper.finish`` (the wait for the batch's blob,
``decode_tb_blob``; with device accumulation ``device_accumulate``'s eager
enqueue), a batch on average over the window."""

NAME = "stream.finish_ms"
UNIT = "ms"
LAYER = "stream finish"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    if not records.n_batches:
        return None
    return records.span_s["finish"] / records.n_batches * 1e3
