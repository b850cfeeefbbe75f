"""The per-layer metrics that read the program's own spans and collector
pauses (``mapbench/spans.py``, gnumap_tpu_torch/utils/profiling.py), on a
window cut to the CPU: each reads a number, each lies inside the outside
span it splits, the program's spans share the window's clock, and a
program without the readers reads nothing."""

import array
import time

import pytest

from mapbench import cell as cells
from mapbench import check
from mapbench import run as run_mod
from mapbench.tests import tiny
from mapbench.window import run_window

NEW = ("io.native_parse_ms", "graphs.pack_ms", "graphs.replay_ms",
       "graphs.capture_ms", "finish.wait_ms", "finish.decode_ms",
       "stream.walk_ms", "stream.sam_ms", "runtime.gc_ms",
       "runtime.gc_full_ms")
# each program metric beside the outside span it is a part of
PARTS = [(("finish.wait_ms", "finish.decode_ms"), "stream.finish_ms"),
         (("graphs.pack_ms", "graphs.replay_ms"), "graphs.submit_ms"),
         (("stream.walk_ms", "stream.sam_ms"), "stream.self_ms"),
         (("io.native_parse_ms",), "io.parse_ms")]


@pytest.fixture(scope="module")
def window():
    """A tiny window of the E. coli cell, its set-up and its per-layer
    metrics with no device trace."""
    spec = tiny.spec(tiny.BASE)
    sess = run_mod.RunSetup(spec, 2 ** 31 + 11, "cpu", False,
                            time.perf_counter())
    try:
        win = run_window(sess.mapper, sess.path, sess.cfg, 1.5,
                         check.KEEP_EVERY, 0)
        metrics = run_mod.per_layer(spec, sess, win, None)
    finally:
        sess.close()
    return spec, sess, win, metrics


def test_every_new_metric_reads_a_number(window):
    spec, _, win, metrics = window
    assert set(NEW) <= {m["name"] for m in spec.per_layer}
    assert len(win.done) >= 4
    for name in NEW:
        v = metrics[name]["value"]
        assert metrics[name]["unit"] == "ms" and v >= 0, name
    for name in ("io.native_parse_ms", "graphs.pack_ms", "graphs.replay_ms",
                 "finish.decode_ms", "stream.sam_ms"):
        assert metrics[name]["value"] > 0, name
    # on the CPU every program runs eagerly: nothing captured
    assert metrics["graphs.capture_ms"]["value"] == 0
    assert metrics["runtime.gc_full_ms"]["value"] <= \
        metrics["runtime.gc_ms"]["value"]


@pytest.mark.parametrize("parts,whole", PARTS,
                         ids=[w for _, w in PARTS])
def test_program_spans_lie_inside_the_outside_span(window, parts, whole):
    metrics = window[3]
    got = sum(metrics[p]["value"] for p in parts)
    assert 0 < got <= metrics[whole]["value"] + 1e-6


def test_program_finish_spans_lie_inside_benchmark_finish_spans(window):
    from gnumap_tpu_torch.utils import profiling
    _, _, win, _ = window
    rec = win.rec
    t0, t1 = int(rec.t_start * 1e9), int(rec.t_end * 1e9)
    rows = profiling.RING.rows(t0, t1)
    mine = rows[rows[:, 0] == profiling.NAMES.index("finish")]
    outside = rec.spans["finish"]
    assert len(mine) == len(outside) == len(win.done)
    # one microsecond for the float seconds of the benchmark's spans
    for (a, b), (_, s, e) in zip(outside, mine[:, :3]):
        assert a * 1e9 - 1e3 <= s <= e <= b * 1e9 + 1e3


def test_a_program_without_the_readers_reads_nothing(window, monkeypatch):
    """The parent of the program has no readers in its profiling module:
    every new metric then reads None and raises nothing."""
    from gnumap_tpu_torch.utils import profiling
    spec, sess, win, _ = window
    for name in ("total_ns", "gc_ns", "SPANS"):
        monkeypatch.delattr(profiling, name)
    records = run_mod.Records(sess, win, None)
    for name in NEW:
        assert cells.metric_module(name).read(records) is None, name


def test_a_wrapped_ring_reads_nothing(window, monkeypatch):
    """A ring that lost a span of the window reads None, never a part."""
    from gnumap_tpu_torch.utils import profiling
    spec, sess, win, _ = window
    records = run_mod.Records(sess, win, None)
    rec = win.rec
    rows = profiling.RING.rows(int(rec.t_start * 1e9),
                               int(rec.t_end * 1e9))
    ring = profiling.Ring(8, 3)
    for i, r in enumerate(rows):
        ring.buf[(i & 7) * 3:(i & 7) * 3 + 3] = array.array("q", r.tolist())
    ring.n = len(rows)
    assert ring.lost > 0
    monkeypatch.setattr(profiling, "RING", ring)
    for name in NEW[:8]:
        assert cells.metric_module(name).read(records) is None, name
