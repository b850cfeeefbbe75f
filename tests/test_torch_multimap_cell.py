"""The benchmark's multi-map cell ``multimap-40x20-100bp.sam-repeat25`` on
the CPU, and what the program records for it.

  * the cell, cut to the CPU by ``mapbench/tests/tiny.py``, through the
    harness's own run and check: the port's SAM (device finish at
    hit_capacity 8, secondary records with their posteriors) against
    ``mapbench/reference``'s plain torch mapping, read for read;
  * ``finish_devtb`` records each batch's ``finish.kept`` (n_keep) and
    ``finish.gapped`` (n_indel) once, an overflowing batch's too, and the
    SAM writer counts ``hits.multi`` (reads with more than one record) and
    ``sam.secondary`` (records with flag 256) as the written SAM holds
    them (utils/profiling.py);
  * ``mapbench/work/nw_pure.py`` counts B2's live work as
    ``chip_smoke.kernel_bound`` does, and in a window reads each batch's
    retained hits from the value ring; ``b2_roofline`` and
    ``finish.posterior_ms`` read nothing, never 0, from a program without
    the records.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from gnumap_tpu_torch.align import nw_pure
from gnumap_tpu_torch.align.nw_band import SENTINEL
from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.index import builder
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mapbench import cell as cells  # noqa: E402
from mapbench import check, window as window_mod  # noqa: E402
from mapbench import run as run_mod  # noqa: E402
from mapbench.genome import make_genome  # noqa: E402
from mapbench.tests import tiny  # noqa: E402
from mapbench.traffic import make_pool, write_fastq  # noqa: E402

torch.set_num_threads(1)

CELL = "multimap-40x20-100bp.sam-repeat25"
CONFIG, TRAFFIC = CELL.split(".", 1)


def _sam_counts(text: str):
    """(records with flag 256, reads with more than one record, records)
    of SAM text."""
    names, secondary, n = {}, 0, 0
    for line in text.splitlines():
        f = line.split("\t")
        names[f[0]] = names.get(f[0], 0) + 1
        secondary += bool(int(f[1]) & 256)
        n += 1
    return secondary, sum(k > 1 for k in names.values()), n


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 29])
def test_the_cell_matches_the_reference_through_the_harness(seed,
                                                            monkeypatch):
    spec = cells.cell(CELL)
    assert spec.config["mapper"]["hit_capacity"] == 8
    assert spec.config["families"] == {"n": 40, "unit_len": 300,
                                       "copies": 20}
    assert spec.mix["repeat_read_frac"] == 0.25
    written = []
    real_write = window_mod.SamSink.write

    def write(self, text):
        written.append(text)
        real_write(self, text)

    monkeypatch.setattr(window_mod.SamSink, "write", write)
    out, judged = tiny.run(CELL, seed=seed)
    assert out["correct"] is True
    assert out["checks"]["sam_reads_differ"]["value"] == 0
    assert out["checks"]["batches_short"]["value"] == 0
    assert judged["info"]["ref_multi"] > 0
    secondary, multi, n = _sam_counts("".join(written))
    assert secondary > 0 and multi > 0 and n > out["attempted"]


def _cut_stream(tmp_path, seed, hit_capacity, indel_rate):
    """The cell's configuration and traffic cut to the CPU: 40 kb, 3
    families of 6 copies, 512 reads in batches of 128."""
    config = cells.load_json(cells.config_file(CONFIG))
    mix = cells.load_json(cells.traffic_file(TRAFFIC))
    config = dict(config, genome_len=40_000,
                  families=dict(config["families"], n=3, copies=6))
    mix = dict(mix, indel_rate=indel_rate)
    cfg = MapperConfig(**dict(config["mapper"], batch_size=128, mer_size=10,
                              hit_capacity=hit_capacity))
    genome = make_genome(config, seed)
    pool = make_pool(genome, mix, seed, n_reads=512)
    path = str(tmp_path / "reads.fastq")
    write_fastq(pool, genome.contig, path, cfg.phred_offset)
    gen = builder.Genome.from_contigs([(genome.contig, genome.codes)])
    return cfg, gen, path


@pytest.mark.parametrize("hit_capacity,overflows", [(8, False), (1, True)])
def test_finish_records_and_sam_counters(tmp_path, monkeypatch,
                                         hit_capacity, overflows):
    """At hit_capacity 8 no batch overflows; at 1 batches do (about 2.25
    retained hits a read against 2 slots), and each records its values
    before the host fallback."""
    cfg, gen, path = _cut_stream(tmp_path, 5, hit_capacity, 0.05)
    m = tm.TorchMapper(gen, builder.build_index(gen, cfg), cfg,
                       device="cpu")
    blobs = []
    real = tm.decode_tb_blob

    def spy(cfg_, B, n, lens, blob):
        blobs.append((int(blob[-3]), int(blob[-1])))
        return real(cfg_, B, n, lens, blob)

    monkeypatch.setattr(tm, "decode_tb_blob", spy)
    c0 = profiling.counters()
    t0 = profiling._now()
    res = tm.map_stream(m, io_fastq.batch_reads(
        io_fastq.iter_fastq(path, cfg), cfg))
    t1 = profiling._now()
    c1 = profiling.counters()
    n_batches = 512 // cfg.batch_size
    assert len(blobs) == n_batches
    kept = profiling.values("finish.kept", t0, t1).tolist()
    gapped = profiling.values("finish.gapped", t0, t1).tolist()
    assert kept == [k for k, _ in blobs]
    assert gapped == [g for _, g in blobs]
    assert sum(gapped) > 0
    H = hit_capacity * 2 * cfg.batch_size
    over = c1["finish.overflow"] - c0["finish.overflow"]
    assert over == sum(k > H for k in kept)
    assert (over > 0) if overflows else (over == 0)
    secondary, multi, _ = _sam_counts("".join(res.sam_lines))
    assert c1["sam.secondary"] - c0["sam.secondary"] == secondary > 0
    assert c1["hits.multi"] - c0["hits.multi"] == multi == \
        res.stats.n_multi > 0


def _b2_inputs(seed, H, n_live, L=104):
    """B2's inputs as device_retain leaves them: the first n_live of H
    slots hold retained hits of 60-100 bp reads, the rest are empty."""
    rng = np.random.default_rng(seed)
    cands = np.full(H, SENTINEL, np.int32)
    lens = np.zeros(H, np.int32)
    scores = np.zeros(H, np.int32)
    cands[:n_live] = rng.integers(0, 10 ** 6, n_live)
    lens[:n_live] = rng.integers(60, 101, n_live)
    scores[:n_live] = rng.integers(1, 1 << 22, n_live)
    emis = torch.zeros((H, 5, L), dtype=torch.int32)
    return (emis, torch.from_numpy(cands), torch.from_numpy(lens),
            torch.from_numpy(scores))


@pytest.mark.parametrize("n_live", [1, 23_550])
def test_b2_work_equals_kernel_bound(n_live):
    H, L, W, bw = 65_536, 104, 128, 42
    a = _b2_inputs(n_live, H, n_live, L)
    want = chip_smoke.kernel_bound("nw_pure", a, dict(L=L, W=W, bw=bw))
    work = cells.work_module("nw_pure")
    got = work.needs_of(n_live, int(a[2][:n_live].sum()), H, L, W, bw)
    assert got == (want["ops"], want["bytes"])
    assert want["live"] == n_live
    assert work.CELL_OPS == chip_smoke.CELL_OPS["nw_pure"]
    assert work.SYMBOL == "nw_pure_kernel"


def test_b2_work_reads_each_window_batch_and_none_without_records(
        monkeypatch):
    """In a window of the cut cell, nw_pure.needs over the window's batches
    equals kernel_bound summed over the B2 calls those batches made; the
    two new metrics read numbers, and None once the program lacks its
    records."""
    calls = []
    real = nw_pure.nw_pure_banded

    def spy(emis, cands, lens, scores, genome, **kw):
        calls.append(((emis, cands.clone(), lens.clone(), scores.clone()),
                      dict(L=kw["L"], W=kw["W"], bw=kw["bw"])))
        return real(emis, cands, lens, scores, genome, **kw)

    monkeypatch.setattr(nw_pure, "nw_pure_banded", spy)
    spec = tiny.spec(CELL)
    sess = run_mod.RunSetup(spec, 2 ** 31 + 13, "cpu", False,
                            time.perf_counter())
    try:
        n_warm = len(calls)
        win = window_mod.run_window(sess.mapper, sess.path, sess.cfg, 3.0,
                                    check.KEEP_EVERY, 0)
    finally:
        sess.close()
    batches = win.rec.batches
    assert n_warm == run_mod.WARM_FEEDS and len(batches) >= 2
    assert len(calls) == n_warm + len(batches)
    want = [chip_smoke.kernel_bound("nw_pure", a, kw)
            for a, kw in calls[n_warm:]]
    assert all(w["live"] > 0 for w in want)
    records = run_mod.Records(sess, win, None)
    work = cells.work_module("nw_pure")
    pick = batches[-2:]
    assert work.needs(pick, records) == (
        sum(want[b.index]["ops"] for b in pick),
        sum(want[b.index]["bytes"] for b in pick))
    seconds = 1e-3
    records.trace = dict(first=pick[0].index, kernels={"nw_pure": dict(
        n=len(pick), seconds=seconds)})
    share = cells.metric_module("b2_roofline").read(records)
    bound = max(sum(want[b.index]["ops"] for b in pick)
                / chip_smoke.INT32_OPS,
                sum(want[b.index]["bytes"] for b in pick)
                / chip_smoke.HBM_BYTES)
    assert share == pytest.approx(100 * bound / seconds)
    posterior = cells.metric_module("finish.posterior_ms").read(records)
    decode = cells.metric_module("finish.decode_ms").read(records)
    assert 0 < posterior <= decode
    # a program without the new records: both read None and raise nothing
    monkeypatch.setattr(profiling, "VALUES", {
        k: v for k, v in profiling.VALUES.items() if k != "finish.kept"})
    monkeypatch.setattr(profiling, "SPANS", {
        k: v for k, v in profiling.SPANS.items() if k != "finish.posterior"})
    assert cells.metric_module("b2_roofline").read(records) is None
    assert cells.metric_module("finish.posterior_ms").read(records) is None
