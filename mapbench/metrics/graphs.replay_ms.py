"""Host time of the uploads into the captured program's static inputs and
its replay (the program's ``graphs.replay`` span; on the CPU the eager
program), a batch on average over the window.  A part of
``graphs.submit_ms``."""

from mapbench.spans import per_batch_ms

NAME = "graphs.replay_ms"
UNIT = "ms"
LAYER = "captured programs"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    return per_batch_ms(records, "graphs.replay")
