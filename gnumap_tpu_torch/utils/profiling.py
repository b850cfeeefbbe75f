"""Spans, collector pauses and counters of the port's host stream, and the
torch.profiler hooks: the counterpart of gnumap_tpu/utils/profiling.py
(SURVEY.md §5 "Tracing/profiling").

  * ``span(name)``: ``with span("finish.wait"): ...`` times a stretch of
    the stream's host work.  The name is one of ``SPANS``, the fixed table
    below, which says what each span covers.  A span stamps
    ``time.perf_counter_ns()`` when it opens and when it closes (the clock
    of the benchmark's own spans, mapbench/window.py) and stores
    (name, start, end) into ``RING``, a preallocated ring that is always
    on: two clock reads and one record store when no trace is active.
    Spans are opened on the stream's thread only, and may nest; the ring
    holds them in the order they close.  Its size holds several minutes
    of a stream; once it has wrapped, the overwritten records are counted
    (``Ring.lost``) and a reader of a range that one of them may have
    started in gets None, never a partial total.
  * The collector's pauses: a ``gc.callbacks`` hook stores each collection
    (generation, start, end, objects collected) into ``GC``, a ring of
    its own, because a collection can start inside a span's bookkeeping
    and must not take that span's slot.  A pause overlaps whichever span
    it interrupted.
  * ``COUNTS``: the counters of ``COUNTERS``, by name.
  * Readers, on the same clock (ns): ``total_ns(name, t0, t1)``,
    ``totals_ns(t0, t1)``, ``span_at(t)``, ``gc_ns(t0, t1, generation)``
    and ``counters()``.
  * ``trace(dir)``: a context manager capturing a torch.profiler trace
    (CPU activity, and the card's kernels and copies when there is a card)
    around any mapping region, exported as a Chrome trace
    ``<dir>/trace.<pid>.json`` (Perfetto-viewable).  Inside it every span
    also opens ``annotate(name)``, so the program's spans show in the
    trace beside the kernels;
  * ``annotate(name)``: a named region that shows up in such traces
    (torch.profiler.record_function) and, on a card, as an NVTX range.

Per-batch counts live in pipeline.mapper.BatchStats; its ``device_s`` and
``host_s`` are the ``finish.wait`` and ``finish.decode`` spans' seconds.
"""

from __future__ import annotations

import array
import contextlib
import gc
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

_now = time.perf_counter_ns

SPANS: Dict[str, str] = {
    "io.read": "batch_reads_native: the file read of one chunk and its "
               "concatenation to the last chunk's unparsed tail",
    "io.parse_chunk": "batch_reads_native: native_lib.parse_fastq_chunk, "
                      "up to four batches of reads",
    "io.tail": "batch_reads_native: the copy of the chunk's unparsed tail",
    "submit": "TorchMapper.submit, the whole call",
    "staging.acquire": "StagingRing.acquire: the wait for a free slot, "
                       "forced collections included",
    "submit.pack": "pack_reads on the batch's codes and qualities",
    "graphs.replay": "Programs.__call__ on a captured key: the uploads "
                     "into the static inputs and Captured.replay (on the "
                     "CPU: the uploads and the eager program)",
    "staging.fetch": "Slot.fetch: the device-to-host copy's enqueue",
    "graphs.warm_up": "Programs.__call__ on a new key: the eager warm-up "
                      "on the side stream",
    "graphs.capture": "Programs.__call__ on a new key: torch.cuda.graph's "
                      "capture",
    "finish": "TorchMapper.finish, the whole call",
    "finish.wait": "the finish's wait for the device: the copy's event "
                   "and the host array (BatchStats.device_s)",
    "finish.decode": "the finish's host work on the fetched arrays: "
                     "decode_tb_blob, or the host finish, or the "
                     "accumulators' fold (BatchStats.host_s)",
    "finish.host": "host_finish: retention and traceback on the host",
    "finish.accumulate": "finish_acc: device_accumulate's eager enqueue "
                         "(_apply_acc)",
    "stream.walk": "map_stream's per-read and per-hit loop",
    "stream.scatter": "map_stream's coverage and tally scatters",
    "stream.sam_format": "format_sam_batch_native",
    "stream.emit": "map_stream's write of a batch's SAM text",
    "stream.checkpoint": "map_stream's checkpoint: snapshot and the wait "
                         "for the previous write",
    "stream.fetch_acc": "map_stream's fetch of the device accumulators",
}
NAMES = tuple(SPANS)
_IDS = {n: i for i, n in enumerate(NAMES)}

COUNTERS: Dict[str, str] = {
    "gc.gen0": "collections of generation 0",
    "gc.gen1": "collections of generation 1",
    "gc.gen2": "full collections (generation 2)",
    "staging.forced_gc": "gc.collect() calls in StagingRing.acquire",
    "staging.waits": "acquires that waited on a slot's unfinished event",
    "io.chunks": "native_lib.parse_fastq_chunk calls",
    "finish.overflow": "capacity overflows that fell back to host_finish",
}
COUNTS: Dict[str, int] = dict.fromkeys(COUNTERS, 0)

# a 51 s benchmark window (about 800 batches of 12 spans and 11
# collections) fits ten times over
RING_SPANS = 1 << 17
RING_GC = 1 << 17


class Ring:
    """A preallocated ring of ``size`` int64 records of ``width`` fields:
    a name's index (a span) or a generation (a collection), start and end
    in ns, then any further fields.  Records are put in the order they
    end, by one thread at a time."""

    def __init__(self, size: int, width: int):
        if size & (size - 1):
            raise ValueError("ring size must be a power of two")
        self.size, self.width, self.mask = size, width, size - 1
        self.buf = array.array("q", bytes(8 * width * size))
        self.n = 0                   # records put, over the ring's life

    @property
    def lost(self) -> int:
        """Records overwritten."""
        return max(0, self.n - self.size)

    def since(self, t: int) -> Optional[np.ndarray]:
        """int64[k, width]: the records that ended at ``t`` or later, in
        the order they ended; None if an overwritten record may have (its
        end is at most the oldest kept record's)."""
        n, size = self.n, self.size
        a = np.frombuffer(self.buf, np.int64).reshape(size, self.width)
        if n > size:
            k = n & self.mask
            parts = (a[k:], a[:k])
            if t <= parts[0][0, 2]:
                return None
        else:
            parts = (a[:n],)
        return np.concatenate([p[np.searchsorted(p[:, 2], t):]
                               for p in parts])

    def rows(self, t0: int, t1: int) -> Optional[np.ndarray]:
        """The records that started in [t0, t1] (each ended at t0 or
        later), in the order they ended; None as ``since``."""
        r = self.since(t0)
        if r is None:
            return None
        return r[(r[:, 1] >= t0) & (r[:, 1] <= t1)]


RING = Ring(RING_SPANS, 3)
GC = Ring(RING_GC, 4)

_annotating = False


class span:
    """``with span(name):`` one record in ``RING`` (see the module
    docstring); ``seconds`` is its duration once closed."""

    __slots__ = ("sid", "t0", "t1", "_ann")

    def __init__(self, name: str):
        self.sid = _IDS[name]

    def __enter__(self) -> "span":
        self._ann = None
        if _annotating:
            self._ann = annotate(NAMES[self.sid])
            self._ann.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self.t1 = _now()
        r = RING
        k = (r.n & r.mask) * 3
        b = r.buf
        b[k] = self.sid
        b[k + 1] = self.t0
        b[k + 2] = t1
        r.n += 1
        if self._ann is not None:
            self._ann.__exit__(*exc)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


_gc_start = [0]
_GC_KEYS = ("gc.gen0", "gc.gen1", "gc.gen2")


def _on_gc(phase: str, info: dict) -> None:
    """The ``gc.callbacks`` hook: one record in ``GC`` a collection (a
    plain function, cheaper to call than a callable object)."""
    if phase == "start":
        _gc_start[0] = _now()
        return
    t1 = _now()
    gen = info["generation"]
    r = GC
    k = (r.n & r.mask) * 4
    b = r.buf
    b[k] = gen
    b[k + 1] = _gc_start[0]
    b[k + 2] = t1
    b[k + 3] = info["collected"]
    r.n += 1
    COUNTS[_GC_KEYS[gen]] += 1


gc.callbacks.append(_on_gc)


def total_ns(name: str, t0: int, t1: int) -> Optional[int]:
    """Summed durations of the spans named ``name`` that started in
    [t0, t1]; None if the ring lost a span that may have started there."""
    r = RING.rows(t0, t1)
    if r is None:
        return None
    sel = r[r[:, 0] == _IDS[name]]
    return int((sel[:, 2] - sel[:, 1]).sum())


def totals_ns(t0: int, t1: int) -> Optional[Dict[str, int]]:
    """``total_ns`` of every span name that started in [t0, t1], by name
    (names with no span left out); None as ``total_ns``."""
    r = RING.rows(t0, t1)
    if r is None:
        return None
    sums = np.bincount(r[:, 0], weights=r[:, 2] - r[:, 1],
                       minlength=len(NAMES))
    counts = np.bincount(r[:, 0], minlength=len(NAMES))
    return {NAMES[i]: int(sums[i]) for i in np.nonzero(counts)[0]}


def span_at(t: int) -> Optional[str]:
    """The innermost span open at ``t``; None if none was, or if the ring
    lost a span that may have been."""
    r = RING.since(t)
    if r is None:
        return None
    # of the spans open at t, the innermost started last
    r = r[r[:, 1] <= t]
    if not len(r):
        return None
    return NAMES[int(r[np.argmax(r[:, 1]), 0])]


def gc_ns(t0: int, t1: int, generation: Optional[int] = None
          ) -> Optional[int]:
    """Summed pauses of the collections (of ``generation``, or all) that
    started in [t0, t1]; None if the ring lost one that may have."""
    r = GC.rows(t0, t1)
    if r is None:
        return None
    if generation is not None:
        r = r[r[:, 0] == generation]
    return int((r[:, 2] - r[:, 1]).sum())


def counters() -> Dict[str, int]:
    """The counters' values now, by name."""
    return dict(COUNTS)


@contextlib.contextmanager
def trace(log_dir: str):
    global _annotating
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        _annotating = True
        try:
            yield prof
        finally:
            _annotating = False
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace.{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
