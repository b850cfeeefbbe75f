"""The window's time outside the parse, submit and finish spans (and the
profiler's own start and stop), a batch on average: ``map_stream``'s
per-read and per-hit loops, the SAM formatter and the sink's writes, and at
the end the accumulators' fetch."""

NAME = "stream.self_ms"
UNIT = "ms"
LAYER = "stream"
MOVES = "reads_per_s"
BETTER = "lower"


def read(records):
    if not records.n_batches:
        return None
    s = records.span_s
    rest = records.window_s - s["parse"] - s["submit"] - s["finish"] \
        - s["tracer"]
    return rest / records.n_batches * 1e3
