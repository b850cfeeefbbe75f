"""The Python collector's pauses, every generation, that started in the
window (the program's ``gc.callbacks`` record), a batch on average.  A
pause overlaps whichever span it interrupted."""

from mapbench.spans import gc_per_batch_ms

NAME = "runtime.gc_ms"
UNIT = "ms"
LAYER = "Python runtime"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return gc_per_batch_ms(records)
