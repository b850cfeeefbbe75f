"""The port's device accumulation (gnumap_tpu_torch: posterior/accum.py B5,
pipeline/mapper.py device_accumulate and TorchMapper(accumulate="device"),
the CLI's --accumulate device) held to the JAX package, each test of
tests/test_device_accum.py mirrored.

B5's plain version equals accum_pallas.apply_deltas(interpret=True) bit for
bit.  Device accumulation computes the JAX device path's [FROZEN v5.2] f32
arithmetic (f32 per-read totals, same-block deltas pre-coalesced in the
reference's scan order), so against it: equal counts, coverage and
tallies bit for bit; against the host path's frozen hit-ordered float64
contract: equal counts, coverage and tallies within rtol = atol = 1e-5
(f32 rounding of sums of weights <= 1 over a few dozen hits).  SAM records
are byte-identical to both.  Two runs of the port are bit-equal, and a
checkpoint resume, in flight or not, is exact.  The CUDA kernel itself
runs only on a card: tests/test_torch_cuda.py; tests/test_torch_accum_parity.py
holds the port to the JAX package bit for bit on a 100 bp pileup too.
"""

import os

import numpy as np
import pytest
import torch

from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.posterior import accum_pallas
from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.posterior import accum

from test_device_accum import _overflow_workload, _run as _run_jax, \
    _workload
from test_torch_bridge import port_iter, to_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rowmul,order", [(1, "sorted"), (4, "sorted"),
                                          (1, "any"), (4, "any")])
def test_plain_apply_deltas_equals_pallas(rowmul, order):
    """B5 plain == accum_pallas.apply_deltas(interpret=True), bit for bit:
    overlapping neighbouring spans, repeated blocks, n_real < H (the tail
    is skipped) and span starts in any order."""
    rng = np.random.default_rng(rowmul * 10 + len(order))
    H, nrows, R = 48, 2 * rowmul * 2, 64 * rowmul
    base = rng.integers(0, R // rowmul - nrows // rowmul, H)
    base[5:9] = base[4] + np.arange(1, 5) % 2          # neighbours, repeats
    if order == "sorted":
        base = np.sort(base)
    base = base.astype(np.int32)
    # magnitudes spread over 2^-20 .. 2^4, so the add order shows in the bits
    deltas = (rng.standard_normal((H, nrows, 128))
              * 2.0 ** rng.integers(-20, 5, (H, nrows, 128))).astype(
                  np.float32)
    arr = rng.standard_normal((R, 128)).astype(np.float32)
    n_real = H - 7
    want = np.asarray(accum_pallas.apply_deltas(
        arr, base, deltas, np.int32(n_real), rowmul=rowmul, ch=16,
        interpret=True))
    got = accum.apply_deltas(torch.from_numpy(arr.copy()),
                             torch.from_numpy(base), torch.from_numpy(deltas),
                             torch.tensor(n_real, dtype=torch.int32),
                             rowmul=rowmul).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, arr)


def _run(cfg, gen, idx, recs, accumulate, **kw):
    m = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu",
                       accumulate=accumulate)
    return tm.map_stream(m, port_iter(io_fastq.batch_reads(iter(recs), cfg)),
                         collect_sam=cfg.sam_out, **kw)


@pytest.fixture(scope="module")
def runs():
    """(workload, path) -> MapResult, each computed once."""
    cache = {}

    def get(name, path):
        key = (name, path)
        if key not in cache:
            wl = WORKLOADS[name]()
            if path == "jax":
                cache[key] = _run_jax(*wl, "device")
            else:
                cache[key] = _run(*wl, path)
        return cache[key]
    return get


WORKLOADS = {
    "coverage": lambda: _workload(snp=False),
    "snp_lazy_pwm": lambda: _workload(snp=True, lazy_pwm=True),
    "snp": lambda: _workload(snp=True),
    "sam": lambda: _workload(snp=False, sam=True),
}


def _same_counts(a, b):
    for f in ("n_reads", "n_mapped", "n_multi", "n_candidates"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f


def _close(got, want, ref):
    """Bit-equal to the JAX device path, within f32 tolerance of the
    float64 host path."""
    if ref == "jax":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ref", ["host", "jax"])
def test_device_accum_matches_coverage(ref, runs):
    rd, rr = runs("coverage", "device"), runs("coverage", ref)
    _same_counts(rd, rr)
    assert rd.tallies is None
    _close(rd.coverage, rr.coverage, ref)
    assert rd.coverage.sum() > 50


@pytest.mark.parametrize("ref", ["host", "jax"])
def test_device_accum_matches_snp_tallies(ref, runs):
    """Lazy-PWM batches (the PWM is rebuilt on the device)."""
    rd, rr = runs("snp_lazy_pwm", "device"), runs("snp_lazy_pwm", ref)
    _same_counts(rd, rr)
    _close(rd.coverage, rr.coverage, ref)
    _close(rd.tallies, rr.tallies, ref)
    assert rd.tallies.sum() > 0.9 * rr.tallies.sum() > 0


def test_device_accum_deterministic(runs):
    cfg, gen, idx, recs = WORKLOADS["snp"]()
    r1, r2 = runs("snp", "device"), _run(cfg, gen, idx, recs, "device")
    assert np.array_equal(r1.coverage, r2.coverage)
    assert np.array_equal(r1.tallies, r2.tallies)
    assert np.array_equal(r1.tallies, runs("snp", "jax").tallies)


def test_device_accum_checkpoint_resume(tmp_path, runs):
    """Stop after 1 of 2 batches (accumulators saved f32 -> f64), resume
    with a fresh mapper (reloaded f64 -> f32): equal to the uninterrupted
    run, bit for bit."""
    cfg, gen, idx, recs = WORKLOADS["snp"]()
    ck = str(tmp_path / "acc.ck.npz")
    batches = to_port(list(io_fastq.batch_reads(iter(recs), cfg)))
    assert len(batches) >= 2
    gen, idx, cfg = to_port((gen, idx, cfg))
    m = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate="device")
    tm.map_stream(m, iter(batches[:1]), collect_sam=False,
                  checkpoint_path=ck, checkpoint_every=1)
    m2 = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate="device")
    r2 = tm.map_stream(m2, iter(batches), collect_sam=False,
                       checkpoint_path=ck, checkpoint_every=1)
    r_ref = runs("snp", "device")
    assert np.array_equal(r2.coverage, r_ref.coverage)
    assert np.array_equal(r2.tallies, r_ref.tallies)


def test_device_accum_checkpoint_resume_inflight(tmp_path):
    """[FROZEN v5.1] a checkpoint taken while later batches are already
    submitted (map_stream keeps 3 in flight) holds exactly batches_done
    batches, so the resume replays the in-flight ones once."""
    cfg, gen, idx, recs = _workload(snp=True, n=320)
    ck = str(tmp_path / "acc2.ck.npz")
    r_ref = _run(cfg, gen, idx, recs, "device")

    class Boom(Exception):
        pass

    def cb(idx_b, s):
        if idx_b >= 2:          # interrupt with ~3 batches still in flight
            raise Boom()

    batches = to_port(list(io_fastq.batch_reads(iter(recs), cfg)))
    assert len(batches) >= 5
    gen, idx, cfg = to_port((gen, idx, cfg))
    m = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate="device")
    with pytest.raises(Boom):
        tm.map_stream(m, iter(batches), collect_sam=False,
                      checkpoint_path=ck, checkpoint_every=1,
                      batch_callback=cb)
    m2 = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate="device")
    r2 = tm.map_stream(m2, iter(batches), collect_sam=False,
                       checkpoint_path=ck, checkpoint_every=1)
    assert np.array_equal(r2.coverage, r_ref.coverage)
    assert np.array_equal(r2.tallies, r_ref.tallies)


@pytest.mark.parametrize("indels", [False, True])
def test_device_accum_overflow_falls_back(indels, caplog, monkeypatch):
    """n_keep > H (a repeat family) or n_indel > K (indel-heavy reads): the
    batch is detected before any delta is applied (device_accumulate never
    runs on it) and re-mapped on the exact host path; results match the
    host-accumulation run."""
    import logging
    cfg, gen, idx, recs = _overflow_workload(indels=indels)
    rh = _run(cfg, gen, idx, recs, "host")
    applied = []
    real = tm.device_accumulate

    def spy(cfg_, B, pwm2, rows, cov, tal, **kw):
        applied.append(int(rows["n_keep"]))
        return real(cfg_, B, pwm2, rows, cov, tal, **kw)

    monkeypatch.setattr(tm, "device_accumulate", spy)
    with caplog.at_level(logging.WARNING, "gnumap_tpu_torch.pipeline.mapper"):
        rd = _run(cfg, gen, idx, recs, "device")
    assert any("capacity overflow" in r.message for r in caplog.records)
    n_batches = len(list(io_fastq.batch_reads(iter(recs), cfg)))
    assert len(applied) < n_batches
    H = cfg.hit_capacity * 2 * cfg.batch_size
    assert all(k <= H for k in applied)
    assert rd.stats.n_mapped == rh.stats.n_mapped
    assert rd.stats.n_multi == rh.stats.n_multi
    np.testing.assert_allclose(rd.coverage, rh.coverage, **TOL)
    np.testing.assert_allclose(rd.tallies, rh.tallies, **TOL)


@pytest.mark.parametrize("ref", ["host", "jax"])
def test_device_accum_sam_records_identical(ref, runs):
    rd, rr = runs("sam", "device"), runs("sam", ref)
    assert rd.sam_lines == rr.sam_lines
    assert "".join(rd.sam_lines).count("\n") > 90
    _close(rd.coverage, rr.coverage, ref)


def test_accumulate_device_needs_device_finish():
    cfg, gen, idx, _ = _workload(snp=False, n=4)
    with pytest.raises(ValueError, match="finish_impl='device'"):
        tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu",
                       finish_impl="host", accumulate="device")


def _sgr_values(path):
    return np.loadtxt(path, usecols=2, ndmin=1)


def test_cli_accumulate_device_matches_host(tmp_path):
    """--accumulate device --snp through the CLI: the same SAM body, and
    SGR / SGREX coverage and tally values that match --accumulate host.
    Values are compared parsed, not as bytes: they agree within 1e-5
    before printing (the in-memory tests above), and the 4-decimal print
    turns that into at most one unit of the last place, 1e-4."""
    out = {}
    for acc in ("host", "device"):
        o = str(tmp_path / acc)
        assert tcli.main([
            "-g", os.path.join(ROOT, "testdata", "phix_sim.fa"), "-o", o,
            "-m", "8", "-j", "4", "-B", "64", "-L", "40", "--snp",
            "--device", "cpu", "--accumulate", acc,
            os.path.join(ROOT, "testdata", "phix_sim_200.fastq")]) == 0
        with open(o + ".sam") as f:
            sam = "".join(x for x in f if not x.startswith("@PG"))
        out[acc] = (sam, _sgr_values(o + ".sgr"),
                    np.loadtxt(o + ".sgrex", usecols=range(3, 8), ndmin=2))
    assert out["device"][0] == out["host"][0]
    for k in (1, 2):
        assert out["device"][k].shape == out["host"][k].shape
        np.testing.assert_allclose(out["device"][k], out["host"][k],
                                   rtol=0, atol=1e-4 + 1e-9)
    assert len(out["device"][1]) > 1000
