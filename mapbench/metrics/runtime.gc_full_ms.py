"""The Python collector's full (generation 2) pauses that started in the
window, a batch on average.  A part of ``runtime.gc_ms``."""

from mapbench.spans import gc_per_batch_ms

NAME = "runtime.gc_full_ms"
UNIT = "ms"
LAYER = "Python runtime"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return gc_per_batch_ms(records, generation=2)
