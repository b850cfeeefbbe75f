"""The measured window: ``map_stream`` over the pool's FASTQ for a fixed
time, observed from outside the program.

* ``Feed`` is the batch iterator: ``batch_reads_native`` over the FASTQ,
  opened again from the start whenever it runs out; each ``next()`` is a
  ``parse`` span.  Once the window's seconds have passed it stops, and the
  stream drains the batches in flight.
* ``MapperProxy`` stands in for the mapper: ``submit``, ``finish`` and
  ``fetch_accumulators`` are spans, everything else is the mapper's own.
* ``SamSink`` is the stream's SAM file: it counts bytes and records, and
  keeps the text of the batches the correctness check samples.
* A batch is complete when the stream comes back to the benchmark after
  its ``finish`` returned: its records have been emitted by then.
* ``cpu_use`` gives the CPU seconds the window's thread and the process
  got, so that a slow run can be told apart: descheduled, or given its
  CPU and slower on it.

Nothing inside the port is patched.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class BatchRecord:
    index: int
    n_reads: int
    submit_start: float = 0.0
    done: float = 0.0
    n_out: int = 0
    n_candidates: int = 0


class Recorder:
    """Host-clock spans and per-batch records of one window."""

    def __init__(self, seconds: float, keep_every: int, keep_phase: int,
                 tracer=None):
        self.seconds = seconds
        self.keep_every = keep_every
        self.keep_phase = keep_phase
        self.tracer = tracer
        self.t_start = 0.0
        self.t_end = 0.0
        self.spans: Dict[str, List[tuple]] = {
            "parse": [], "submit": [], "finish": [], "fetch": [],
            "tracer": []}
        self.batches: List[BatchRecord] = []
        self._by_id: Dict[int, BatchRecord] = {}
        self._pending: List[BatchRecord] = []
        self.last_finished: Optional[BatchRecord] = None

    def keeps(self, index: int) -> bool:
        """The first batch, and one in ``keep_every`` after it."""
        return index == 0 or index % self.keep_every == self.keep_phase

    def mark(self) -> None:
        now = time.perf_counter()
        for b in self._pending:
            b.done = now
        self._pending.clear()

    def due(self) -> bool:
        return time.perf_counter() - self.t_start < self.seconds

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans[name].append((t0, t1))

    def fed(self, batch) -> None:
        b = BatchRecord(len(self.batches), int(batch.n))
        self.batches.append(b)
        self._by_id[id(batch)] = b

    def record(self, batch) -> BatchRecord:
        return self._by_id[id(batch)]

    def finished(self, batch, n_out: int) -> BatchRecord:
        b = self._by_id.pop(id(batch))
        b.n_out = n_out
        self._pending.append(b)
        self.last_finished = b
        return b


class Feed:
    """The stream's batches, read from the FASTQ again and again until the
    window's seconds have passed."""

    def __init__(self, path: str, cfg, rec: Recorder):
        from gnumap_tpu_torch.io.fastq import batch_reads_native
        self._open = lambda: batch_reads_native(path, cfg)
        self._it = self._open()
        self.rec = rec

    def __iter__(self):
        return self

    def __next__(self):
        rec = self.rec
        rec.mark()
        if not rec.due():
            raise StopIteration
        t0 = time.perf_counter()
        try:
            batch = next(self._it)
        except StopIteration:
            self._it = self._open()
            batch = next(self._it)
        rec.span("parse", t0, time.perf_counter())
        rec.fed(batch)
        return batch


class MapperProxy:
    """The mapper as ``map_stream`` sees it, with spans around the calls the
    benchmark observes."""

    def __init__(self, mapper, rec: Recorder):
        self._m = mapper
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._m, name)

    def submit(self, batch):
        rec = self._rec
        rec.mark()
        b = rec.record(batch)
        if rec.tracer is not None:
            t0 = time.perf_counter()
            rec.tracer.before_submit(b.index)
            rec.span("tracer", t0, time.perf_counter())
        t0 = time.perf_counter()
        out = self._m.submit(batch)
        b.submit_start = t0
        rec.span("submit", t0, time.perf_counter())
        return out

    def finish(self, batch, dev_out, stats=None):
        rec = self._rec
        rec.mark()
        n0 = stats.n_candidates if stats is not None else 0
        t0 = time.perf_counter()
        out = self._m.finish(batch, dev_out, stats)
        t1 = time.perf_counter()
        rec.span("finish", t0, t1)
        b = rec.finished(batch, len(out))
        if stats is not None:
            b.n_candidates = stats.n_candidates - n0
        if rec.tracer is not None:
            rec.tracer.after_finish(b.index, rec)
        return out

    def fetch_accumulators(self):
        self._rec.mark()
        t0 = time.perf_counter()
        out = self._m.fetch_accumulators()
        self._rec.span("fetch", t0, time.perf_counter())
        return out


class SamSink:
    """The stream's SAM file: bytes and records counted, the sampled
    batches' text kept."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.n_bytes = 0
        self.records: Dict[int, int] = {}
        self.kept: Dict[int, List[str]] = {}

    def write(self, text: str) -> None:
        b = self.rec.last_finished
        self.n_bytes += len(text)
        self.records[b.index] = self.records.get(b.index, 0) + \
            text.count("\n")
        if self.rec.keeps(b.index):
            self.kept.setdefault(b.index, []).append(text)


def cpu_snapshot() -> tuple:
    """The wall clock, this thread's and this process's CPU seconds."""
    return time.perf_counter(), time.thread_time(), time.process_time()


def cpu_use(a: tuple, b: tuple) -> dict:
    """The CPU seconds the window's thread and the process got between two
    snapshots, and the thread's share of the wall time."""
    wall, thread, process = (y - x for x, y in zip(a, b))
    return dict(wall_s=wall, thread_cpu_s=thread, process_cpu_s=process,
                thread_cpu_share=thread / wall)


@dataclasses.dataclass
class Window:
    rec: Recorder
    result: object           # MapResult
    sink: Optional[SamSink]
    cpu: dict

    @property
    def seconds(self) -> float:
        return self.rec.t_end - self.rec.t_start

    @property
    def done(self) -> List[BatchRecord]:
        return [b for b in self.rec.batches if b.done > 0]

    def slice_rates(self, n: int) -> List[float]:
        """Reads completed a second in each of ``n`` equal slices of the
        window, a batch counted where it completed."""
        edges = self.rec.t_start + np.arange(n + 1) * self.seconds / n
        done = np.array([b.done for b in self.done])
        reads = np.array([b.n_out for b in self.done], np.float64)
        got, _ = np.histogram(done, bins=edges, weights=reads)
        return [float(x) for x in got / (self.seconds / n)]

    def latencies_ms(self) -> np.ndarray:
        return np.array([(b.done - b.submit_start) * 1e3 for b in self.done])


def run_window(mapper, path: str, cfg, seconds: float, keep_every: int,
               keep_phase: int, tracer=None) -> Window:
    """``map_stream`` on ``mapper`` for ``seconds``: from the call to the
    return, drain and final fetch included."""
    from gnumap_tpu_torch.pipeline.mapper import map_stream
    rec = Recorder(seconds, keep_every, keep_phase, tracer)
    if tracer is not None:
        tracer.bind(rec)
    sink = SamSink(rec) if cfg.sam_out else None
    proxy = MapperProxy(mapper, rec)
    feed = Feed(path, cfg, rec)
    before = cpu_snapshot()
    rec.t_start = time.perf_counter()
    result = map_stream(proxy, feed, collect_sam=False, sam_file=sink)
    rec.mark()
    rec.t_end = time.perf_counter()
    cpu = cpu_use(before, cpu_snapshot())
    if tracer is not None:
        tracer.close()
    return Window(rec, result, sink, cpu)
