"""The GNUMAP-SNP pileup cell, ``ecoli-k12-100bp-snp.pileup-wgsim``, cut to
the CPU: faults of its timed path come out as not correct; its span
readers read numbers; B5's work formula equals ``chip_smoke.kernel_bound``'s
on fixed inputs; the B5 launches of a traced stretch are matched to the
blocks the program recorded for them; a program without the block record
reads nothing."""

import sys
import time

import numpy as np
import pytest
import torch

from mapbench import cell as cells
from mapbench import check, peaks
from mapbench import run as run_mod
from mapbench.tests import tiny
from mapbench.tests.test_mapbench_run import _half, _unchanged
from mapbench.window import Recorder, run_window

sys.path.insert(0, cells.ROOT)
import chip_smoke  # noqa: E402

CELL = "ecoli-k12-100bp-snp.pileup-wgsim"
NEW = ("finish.accumulate_ms", "stream.fetch_acc_ms", "b5_roofline")
N_BATCHES = 8


@pytest.mark.parametrize("fault", [_half, _unchanged],
                         ids=["half", "unchanged"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out, _ = tiny.run(CELL)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.fixture(scope="module")
def window():
    """A tiny window of the pileup cell, its set-up and its per-layer
    metrics with no device trace.  The window feeds ``N_BATCHES`` batches
    whatever the time they take, so that the host's load does not decide
    how many it holds."""
    spec = tiny.spec(CELL)
    sess = run_mod.RunSetup(spec, 2 ** 31 + 13, "cpu", False,
                            time.perf_counter())
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Recorder, "due",
                       lambda self: len(self.batches) < N_BATCHES)
            win = run_window(sess.mapper, sess.path, sess.cfg, 600.0,
                             check.KEEP_EVERY, 0)
        metrics = run_mod.per_layer(spec, sess, win, None)
    finally:
        sess.close()
    return spec, sess, win, metrics


def test_the_cell_reads_its_own_metrics_only(window):
    spec, _, win, metrics = window
    assert [m["name"] for m in spec.per_layer] == list(NEW)
    assert len(win.done) == N_BATCHES
    for name in NEW[:2]:
        assert metrics[name]["unit"] == "ms"
        assert metrics[name]["value"] > 0, name
    # no device trace, no roofline
    assert "b5_roofline" not in metrics


def _stretch(win, cfg, first, n):
    """The records a traced run hands the readers, for a stretch from
    batch ``first`` with ``n`` B5 launches of 1 ms in all."""
    rec = run_mod.Records.__new__(run_mod.Records)
    rec.window, rec.cfg, rec.peaks = win, cfg, peaks
    rec.trace = dict(first=first, kernels={
        "accum_rmw": dict(n=n, seconds=1e-3)})
    return rec


def test_b5_stretch_reads_the_blocks_of_its_launches(window):
    """A batch's B5 launch comes a stream depth of submits after its own:
    the blocks summed for a stretch from batch ``first`` are those the
    program recorded for the finishes of batches ``first - depth`` on."""
    from gnumap_tpu_torch.pipeline.mapper import STREAM_DEPTH
    from gnumap_tpu_torch.utils import profiling
    _, sess, win, _ = window
    rec = win.rec
    blocks = profiling.values("accumulate.blocks", int(rec.t_start * 1e9),
                              int(rec.t_end * 1e9))
    # one record a finished batch, none fell back to the host
    assert len(blocks) == len(win.done) > STREAM_DEPTH
    work = cells.work_module("accum_rmw")
    n = len(win.done) - STREAM_DEPTH
    records = _stretch(win, sess.cfg, STREAM_DEPTH, n)
    got = work.needs(records.stretch_batches("accum_rmw"), records)
    assert got == work.needs_of(int(blocks[:n].sum()),
                                work.delta_rows(sess.cfg), True)
    share = cells.metric_module("b5_roofline").read(records)
    want = 100 * max(got[0] / work.F32_OPS,
                     got[1] / peaks.HBM_BYTES) / 1e-3
    assert share == pytest.approx(want)
    # more launches than records after the first submit: nothing
    last = win.rec.batches[-1:]
    assert work.needs(last * (STREAM_DEPTH + 1), records) is not None
    assert work.needs(last * (STREAM_DEPTH + 2), records) is None


def test_a_program_without_the_block_record_reads_nothing(window,
                                                          monkeypatch):
    from gnumap_tpu_torch.utils import profiling
    _, sess, win, _ = window
    records = _stretch(win, sess.cfg, 1, 1)
    assert cells.metric_module("b5_roofline").read(records) is not None
    monkeypatch.delattr(profiling, "values")
    assert cells.metric_module("b5_roofline").read(records) is None
    records.trace = None
    assert cells.metric_module("b5_roofline").read(records) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b5_formula_equals_kernel_bound(seed):
    rng = np.random.default_rng(seed)
    from gnumap_tpu_torch.config import MapperConfig
    cfg = MapperConfig(max_read_len=104)
    work = cells.work_module("accum_rmw")
    cw = work.delta_rows(cfg)
    H, R = 512, 900
    n_real = int(rng.integers(50, H))
    base = torch.from_numpy(np.sort(rng.choice(
        R - cw, H, replace=False)).astype(np.int32))
    cov = torch.zeros((R, 128))
    tal = torch.zeros((4 * R, 128))
    cov_d = torch.zeros((H, cw, 128))
    tal_d = torch.zeros((H, 4 * cw, 128))
    want = chip_smoke.kernel_bound(
        "accum", (cov, tal, base, cov_d, tal_d, torch.tensor(n_real)), {})
    b = base[:n_real].long()
    tc = int(torch.unique(b[:, None] + torch.arange(cw)).numel())
    tt = int(torch.unique(b[:, None] * 4 + torch.arange(4 * cw)).numel())
    ops, nbytes = work.needs_of(n_real, cw, True, tc, tt)
    assert (ops, nbytes) == (want["ops"], want["bytes"])
    assert tc + tt == want["touched_rows"]
    assert (chip_smoke.F32_OPS, chip_smoke.HBM_BYTES) == (
        work.F32_OPS, peaks.HBM_BYTES)
    # the stream's form takes rows at their fewest: never a larger bound
    lo_ops, lo_bytes = work.needs_of(n_real, cw, True)
    assert lo_ops == ops and lo_bytes <= nbytes
    # coverage alone, as the single entry takes it
    one = chip_smoke.kernel_bound("accum", (cov, base, cov_d,
                                            torch.tensor(n_real)),
                                  dict(rowmul=1))
    assert work.needs_of(n_real, cw, False, tc) == (one["ops"],
                                                    one["bytes"])
