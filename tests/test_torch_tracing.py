"""The port's spans, collector pauses and counters
(gnumap_tpu_torch/utils/profiling.py), on the CPU.

A stream of a few batches records each span once a batch, nested as the
stream calls them; ``BatchStats.device_s`` and ``host_s`` are the
``finish.wait`` and ``finish.decode`` spans; a full collection forced
inside a span, even inside its own bookkeeping, is recorded apart and
leaves the span's record whole; a ring that wrapped reads None for what it
lost; inside ``trace()`` every span shows by name in the Chrome trace on
the ring's clock, and outside it no profiler range is opened; a capacity
overflow is counted; the CLI's ``-v`` and ``done`` lines carry the spans.
"""

import gc
import glob
import json
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch

from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.core import packing
from gnumap_tpu_torch.index import builder
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.native import lib as native_lib
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.utils import profiling, sim

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FA = os.path.join(ROOT, "testdata", "phix_sim.fa")
FQ = os.path.join(ROOT, "testdata", "phix_sim_200.fastq")
# spans of the default stream (device finish, SAM through the native
# formatter), once a batch each
PER_BATCH = ("submit", "staging.acquire", "submit.pack", "graphs.replay",
             "staging.fetch", "finish", "finish.wait", "finish.decode",
             "stream.walk", "stream.sam_format", "stream.emit")
INSIDE = {"staging.acquire": "submit", "submit.pack": "submit",
          "graphs.replay": "submit", "staging.fetch": "submit",
          "finish.wait": "finish", "finish.decode": "finish"}


@pytest.fixture(scope="module")
def phix():
    if not native_lib.available():
        pytest.skip("native host library unavailable (no C++ compiler)")
    cfg = MapperConfig(mer_size=8, seed_jump=4, max_read_len=40,
                       batch_size=40)
    gen = builder.Genome.from_fasta(FA)
    return gen, builder.build_index(gen, cfg), cfg


def _stream(phix):
    """map_stream over the 200 phiX reads in 5 batches: (result, the ring's
    records of the stream by name, counters before, counters after)."""
    gen, idx, cfg = phix
    m = tm.TorchMapper(gen, idx, cfg, device="cpu")
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    res = tm.map_stream(m, io_fastq.batch_reads_native(FQ, cfg),
                        collect_sam=True)
    rows = profiling.RING.rows(t0, time.perf_counter_ns())
    by = {n: rows[rows[:, 0] == i][:, 1:] for i, n in
          enumerate(profiling.NAMES)}
    return res, by, before, profiling.counters()


def _within(inner, outer):
    """Each [start, end] of ``inner`` lies inside one of ``outer``."""
    k = np.searchsorted(outer[:, 0], inner[:, 0], side="right") - 1
    return bool((k >= 0).all() and (inner[:, 1] <= outer[k, 1]).all())


def test_stream_records_each_span_once_a_batch(phix):
    res, by, before, after = _stream(phix)
    n = 5
    assert res.stats.n_reads == 200
    assert "".join(res.sam_lines).count("\n") >= 200
    for name in PER_BATCH:
        assert len(by[name]) == n, name
    for name in ("graphs.warm_up", "graphs.capture", "finish.host",
                 "stream.checkpoint", "stream.fetch_acc"):
        assert len(by[name]) == 0, name
    assert len(by["io.parse_chunk"]) == \
        after["io.chunks"] - before["io.chunks"] >= 1
    assert after["finish.overflow"] == before["finish.overflow"]
    for name, outer in INSIDE.items():
        assert _within(by[name], by[outer]), name
    assert _within(by["io.parse_chunk"], by["io.parse_chunk"])
    # submit, finish and the stream's own spans do not overlap
    top = np.concatenate([by[k] for k in (
        "io.read", "io.parse_chunk", "submit", "finish", "stream.walk",
        "stream.sam_format", "stream.emit")])
    top = top[np.argsort(top[:, 0])]
    assert (top[1:, 0] >= top[:-1, 1]).all()
    # a batch's spans in stream order: its finish, walk, format, emission
    for a, b in (("finish", "stream.walk"), ("stream.walk",
                                              "stream.sam_format"),
                 ("stream.sam_format", "stream.emit")):
        assert (by[a][:, 1] <= by[b][:, 0]).all()


def test_stats_are_the_finish_spans(phix):
    res, by, _, _ = _stream(phix)
    wait = by["finish.wait"]
    decode = by["finish.decode"]
    assert res.stats.device_s == pytest.approx(
        (wait[:, 1] - wait[:, 0]).sum() * 1e-9, rel=1e-9, abs=1e-12)
    assert res.stats.host_s == pytest.approx(
        (decode[:, 1] - decode[:, 0]).sum() * 1e-9, rel=1e-9, abs=1e-12)
    assert res.stats.host_s > 0


def test_a_full_collection_inside_a_span_is_recorded_apart():
    """gc.collect(2) inside a span, and again inside the span's own store
    (the clock read that closes it): each is a generation-2 record of its
    own, and the span's record holds its own name and stamps."""
    t0 = time.perf_counter_ns()
    with profiling.span("stream.walk") as s:
        gc.collect(2)
    now = profiling._now
    armed, fired = [False], []

    def collecting_clock():
        t = now()
        if armed[0]:
            armed[0] = False
            fired.append(gc.collect(2))
        return t

    profiling._now = collecting_clock
    try:
        with profiling.span("stream.emit") as e:
            armed[0] = True
    finally:
        profiling._now = now
    t1 = time.perf_counter_ns()
    assert len(fired) == 1
    rows = profiling.RING.rows(t0, t1)
    assert [tuple(r) for r in rows] == [
        (profiling.NAMES.index("stream.walk"), s.t0, s.t1),
        (profiling.NAMES.index("stream.emit"), e.t0, e.t1)]
    pauses = profiling.GC.rows(t0, t1)
    full = pauses[pauses[:, 0] == 2]
    assert len(full) == 2
    assert s.t0 <= full[0, 1] <= full[0, 2] <= s.t1
    assert e.t0 <= full[1, 1] <= full[1, 2]
    assert profiling.gc_ns(t0, t1, 2) == \
        int((full[:, 2] - full[:, 1]).sum())
    assert profiling.gc_ns(t0, t1) >= profiling.gc_ns(t0, t1, 2) > 0
    assert profiling.total_ns("stream.walk", t0, t1) == s.t1 - s.t0


def test_a_wrapped_ring_reads_none_for_what_it_lost(monkeypatch):
    ring = profiling.Ring(4, 3)
    monkeypatch.setattr(profiling, "RING", ring)
    spans = []
    for name in ("submit", "finish", "submit", "finish", "submit",
                 "finish"):
        with profiling.span(name) as s:
            time.sleep(0.001)
        spans.append(s)
    assert ring.n == 6 and ring.lost == 2
    first, last = spans[0], spans[-1]
    assert profiling.total_ns("submit", first.t0, last.t1) is None
    assert profiling.totals_ns(spans[1].t0, last.t1) is None
    assert profiling.span_at(first.t0 + 1) is None
    # what the ring still holds whole: from after the oldest kept end
    t = spans[2].t1 + 1
    got = profiling.total_ns("finish", t, last.t1)
    assert got == sum(s.t1 - s.t0 for s in spans[3::2])
    assert profiling.totals_ns(t, last.t1) == {
        "submit": spans[4].t1 - spans[4].t0, "finish": got}
    assert profiling.span_at(spans[4].t0 + 1) == "submit"
    with pytest.raises(ValueError):
        profiling.Ring(6, 3)


def test_span_at_names_the_innermost_open_span():
    with profiling.span("finish") as outer:
        time.sleep(0.001)
        with profiling.span("finish.decode") as inner:
            time.sleep(0.001)
        time.sleep(0.001)
    assert profiling.span_at(inner.t0 + 1) == "finish.decode"
    assert profiling.span_at(outer.t0 + 1) == "finish"
    assert profiling.span_at(inner.t1 + 1) == "finish"
    assert profiling.span_at(outer.t1 + 1) is None


def test_spans_show_by_name_in_the_chrome_trace(phix, tmp_path):
    gen, idx, cfg = phix
    m = tm.TorchMapper(gen, idx, cfg, device="cpu")
    t0 = time.perf_counter_ns()
    with profiling.trace(str(tmp_path / "tr")):
        off = time.time_ns() - time.perf_counter_ns()
        tm.map_stream(m, io_fastq.batch_reads_native(FQ, cfg))
    rows = profiling.RING.rows(t0, time.perf_counter_ns())
    (path,) = glob.glob(str(tmp_path / "tr" / "trace.*.json"))
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    events = [e for e in trace["traceEvents"]
              if e.get("name") in profiling.SPANS and e.get("ph") == "X"]
    want = Counter(profiling.NAMES[i] for i in rows[:, 0])
    assert Counter(e["name"] for e in events) == want
    assert set(PER_BATCH) <= set(want)
    # the k-th event of a name is the k-th span of that name: the span's
    # stamps, moved to the trace's clock by one offset, lie inside it (the
    # range opens before the span's first stamp and closes after its
    # last), up to the offset's reading (1 ms)
    for name in want:
        i = profiling.NAMES.index(name)
        mine = rows[rows[:, 0] == i]
        mine = mine[np.argsort(mine[:, 1])]
        evs = sorted((e for e in events if e["name"] == name),
                     key=lambda e: e["ts"])
        for e, (_, s0, s1) in zip(evs, mine):
            a = base + e["ts"] * 1e3 - off
            b = a + e["dur"] * 1e3
            assert a - 1e6 <= s0 <= s1 <= b + 1e6, name


def test_no_profiler_range_without_a_trace(phix, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no trace")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)
    res, by, _, _ = _stream(phix)
    assert res.stats.n_reads == 200 and len(by["submit"]) == 5


def test_a_capacity_overflow_is_counted(caplog):
    """Reads of a genome of repeat families overflow the device finish's
    hit capacity: each such batch counts once, beside its warning, and is
    finished on the host (its own span)."""
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=16,
                       max_read_len=40, max_candidates=16, hit_capacity=1,
                       sam_out=True, sgr_out=True)
    g, spots = sim.random_genome_families(6000, seed=33, n_families=4,
                                          copies=8, unit_len=100)
    gen = builder.Genome.from_contigs([("a", g)])
    idx = builder.build_index(gen, cfg)
    inside = (np.concatenate(spots)[:, None] + np.arange(0, 60, 20)).ravel()
    reads = []
    for k in range(3):
        reads += sim.simulate_reads(
            g, 16, 36, seed=40 + k, sub_rate=0.01, contig="a",
            positions=inside if k == 1 else None)
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    m = tm.TorchMapper(gen, idx, cfg, device="cpu")
    n0 = profiling.counters()["finish.overflow"]
    t0 = time.perf_counter_ns()
    res = tm.map_stream(m, io_fastq.batch_reads(iter(recs), cfg))
    t1 = time.perf_counter_ns()
    warned = [r for r in caplog.records
              if "capacity overflow" in r.getMessage()]
    assert profiling.counters()["finish.overflow"] - n0 == len(warned) >= 1
    assert res.stats.n_reads == 48
    tot = profiling.totals_ns(t0, t1)
    assert tot["finish.host"] > 0
    assert len(profiling.RING.rows(t0, t1)) >= 3 * len(PER_BATCH)


def test_cli_lines_carry_the_spans(tmp_path, capsys):
    if not native_lib.available():
        pytest.skip("native host library unavailable (no C++ compiler)")
    rc = tcli.main(["-g", FA, "-o", str(tmp_path / "out"), "-m", "8",
                    "-j", "4", "-B", "64", "-L", "40", "--device", "cpu",
                    "-v", "--profile", str(tmp_path / "prof"), FQ])
    assert rc == 0
    cap = capsys.readouterr()
    lines = [json.loads(x) for x in cap.err.splitlines()
             if x.startswith('{"event": "batch"')]
    done = json.loads(cap.out.splitlines()[-1])
    assert len(lines) == 4 and done["event"] == "done"
    for line in lines:
        assert set(line["spans_ms"]) >= {"finish", "finish.wait",
                                         "finish.decode", "stream.walk"}
        assert len(line["gc_ms"]) == 3
    assert set(done["spans_ms"]) >= set(PER_BATCH)
    assert done["spans_ms"]["finish.wait"] == pytest.approx(
        done["device_s"] * 1e3, abs=1.0)
    assert set(done["counters"]) == set(profiling.COUNTERS)
    assert done["counters"]["io.chunks"] >= 1
    assert glob.glob(str(tmp_path / "prof" / "trace.*.json"))
