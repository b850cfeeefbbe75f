"""Host time of the captured programs' eager warm-ups and graph captures
before the window (the program's ``graphs.warm_up`` and ``graphs.capture``
spans, from the process's start), in total.  0 where nothing was captured
(on the CPU every program runs eagerly).  A part of ``setup_s``."""

from mapbench.spans import spans_ns, window_ns

NAME = "graphs.capture_ms"
UNIT = "ms"
LAYER = "captured programs"
MOVES = "setup_s"
BETTER = "lower"


def read(records):
    ns = spans_ns(("graphs.warm_up", "graphs.capture"), 0,
                  window_ns(records)[0])
    return None if ns is None else ns * 1e-6
