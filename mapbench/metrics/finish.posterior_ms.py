"""Host time of the decode's posterior step (the program's
``finish.posterior`` span, inside ``finish.decode``: ``decode_tb_blob``'s
dedupe by (read, strand, pos), the per-read weight normalisation and the
emission order), a batch on average over the window.  None on a checkout
whose program has no such span."""

from mapbench.spans import per_batch_ms

NAME = "finish.posterior_ms"
UNIT = "ms"
LAYER = "stream finish"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "finish.posterior")
