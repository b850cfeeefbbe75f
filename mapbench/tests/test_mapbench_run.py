"""A run of each cell and variant, cut to a CPU size: the result line's keys, the
control and the faults of the timed path coming out as not correct, the
per-layer readers, and no fallback to the CPU without a card."""

import json

import pytest
import torch

from mapbench import run as run_mod
from mapbench.tests import tiny
from mapbench.window import BatchRecord

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", tiny.RUNS)
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    lines = []
    out, judged = tiny.run(name, control=True, lines=lines)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"reads_per_s", "batch_p95_ms",
                                   "peak_dev_mem_gib", "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert judged["control_correct"] is False
    assert [l.split(" ", 1)[0] for l in lines] == ["setup", "window",
                                                   "check"]
    json.dumps(out)


def _half(monkeypatch):
    """Half of every batch left out: its reads reach the program as N."""
    from gnumap_tpu_torch.pipeline.mapper import TorchMapper
    orig = TorchMapper.submit

    def submit(self, batch):
        codes = batch.codes.copy()
        codes[batch.n // 2:] = 4
        return orig(self, type(batch)(batch.names, codes, batch.pwm_arr,
                                      batch.lens, batch.quals, batch.n))
    monkeypatch.setattr(TorchMapper, "submit", submit)


def _altered_sam(monkeypatch):
    """Every hit's position moved by one where the blob is decoded."""
    from gnumap_tpu_torch.pipeline import mapper as pl
    orig = pl.decode_tb_blob

    def decode(*a, **k):
        out = orig(*a, **k)
        if out is not None:
            for hits in out[0]:
                for h in hits:
                    h.pos += 1
        return out
    monkeypatch.setattr(pl, "decode_tb_blob", decode)


def _altered_acc(monkeypatch):
    """The coverage the stream returns scaled by 1 + 2^-8."""
    from gnumap_tpu_torch.pipeline.mapper import TorchMapper
    orig = TorchMapper.fetch_accumulators

    def fetch(self):
        cov, tal = orig(self)
        return cov * (1 + 2 ** -8), tal
    monkeypatch.setattr(TorchMapper, "fetch_accumulators", fetch)


def _unchanged(monkeypatch):
    """The accumulation step returns the accumulators unchanged."""
    from gnumap_tpu_torch.pipeline import mapper as pl

    def apply(self, rows, pwm2, n_keep):
        return pl.device_accumulate(
            self.cfg, pwm2.shape[0] // 2, pwm2, rows, self._cov_dev.clone(),
            self._tal_dev.clone(), n_live=n_keep)
    monkeypatch.setattr(pl.TorchMapper, "_apply_acc", apply)


FAULTS = [("ecoli-k12-100bp.sam-unique", _half),
          ("ecoli-k12-100bp.sam-unique", _altered_sam),
          ("sam-indel", _altered_sam),
          ("snp-repeat25", _half),
          ("snp-repeat25", _altered_acc),
          ("snp-repeat25", _unchanged),
          ("snp-unique", _unchanged)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out, judged = tiny.run(name)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_lost_reads_are_counted(monkeypatch):
    from gnumap_tpu_torch.pipeline.mapper import TorchMapper
    orig = TorchMapper.finish

    def finish(self, batch, dev_out, stats=None):
        return orig(self, batch, dev_out, stats)[:-1]
    monkeypatch.setattr(TorchMapper, "finish", finish)
    out, _ = tiny.run("snp-unique")
    assert out["correct"] is False and out["failed"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run_mod.main(["--workload", "ecoli-k12-100bp.sam-unique",
                       "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_the_tracer_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mapbench.trace import warm_profiler
    with pytest.raises((RuntimeError, AssertionError)):
        warm_profiler("cuda")


class _Rec:
    """Records as the traced run hands them to the readers."""

    def __init__(self, trace):
        from gnumap_tpu_torch.config import MapperConfig
        self.cfg = MapperConfig(mer_size=12, max_candidates=32,
                                max_read_len=104, batch_size=4096)
        self.read_len = 100
        self.n_batches = 10
        self.window_s = 2.0
        self.span_s = dict(parse=0.1, submit=0.3, finish=0.5, fetch=0.0,
                           tracer=0.2)
        self.trace = trace
        from mapbench import peaks
        self.peaks = peaks
        self.batches = [BatchRecord(i, 4096, n_candidates=40000)
                        for i in range(10)]

    def stretch_batches(self, kernel):
        n = self.trace["kernels"][kernel]["n"]
        return self.batches[self.trace["first"]:self.trace["first"] + n]


def test_per_layer_readers():
    from mapbench import cell as cells
    trace = dict(window_s=1.0, busy_s=0.05, first=2,
                 kernels={"nw_band": dict(n=4, seconds=0.001)})
    rec = _Rec(trace)
    got = {m: cells.metric_module(m).read(rec) for m in (
        "io.parse_ms", "graphs.submit_ms", "stream.finish_ms",
        "stream.self_ms", "device.idle_pct", "device.busy_ms",
        "b1_roofline")}
    assert got["io.parse_ms"] == pytest.approx(10.0)
    assert got["stream.self_ms"] == pytest.approx(90.0)
    assert got["device.idle_pct"] == pytest.approx(95.0)
    assert got["device.busy_ms"] == pytest.approx(12.5)
    cells_ = 4 * 40000 * 100 * 42
    assert got["b1_roofline"] == pytest.approx(
        100 * cells_ * 6 / 16.7e12 / 0.001)
    # nothing traced: the device readers return nothing, never 0
    rec.trace = None
    for m in ("device.idle_pct", "device.busy_ms", "b1_roofline"):
        assert cells.metric_module(m).read(rec) is None
    rec.trace = dict(trace, kernels={"nw_band": dict(n=0, seconds=0.0)})
    assert cells.metric_module("b1_roofline").read(rec) is None


def test_control_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mapbench import control
    assert control.main(["--workload", "ecoli-k12-100bp.sam-unique",
                         "--seeds", "1"]) == 2
    assert capsys.readouterr().out == ""
