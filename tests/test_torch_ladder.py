"""The reference's workload ladder in the port: chip_smoke.py's CONFIGS and
build_workload held to the reference's bench.py on the CPU at small sizes
(the same ladder configs; the same genome, contigs, reads, records and
index arrays), and the port's mapper on every ladder config, run the way
the reference's bench_config runs that config, held to the reference's
counts (reads, mapped, multi-mapped, DP cells, truth accuracy).  Every
comparison is exact.

Sizes: genomes of 5-300 kb and 96 reads in batches of 32 (the reference's
jnp pipeline compiles per batch shape); the configs of mer 12, 13 and the
bisulfite config of mer 16 build their seed tables at mer 11 (a dense
table of 4^13 or a base-3 pair of 3^16 buckets is 268-344 MB a package).
"""

import dataclasses
import json
import os
from collections import deque

import pytest
import torch

import bench as jbench
import chip_smoke
from gnumap_tpu_torch.dist.segments import GlobalSegmentedMapper
from gnumap_tpu_torch.io import fastq as io_fastq, sam as sam_io
from gnumap_tpu_torch.pipeline import mapper as tm

from test_torch_bridge import to_port
from test_torch_hostlib import same

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_MER = 11
GENOME = {1: 5_386, 2: 100_000, 3: 300_000, 4: 300_000, 5: 300_000,
          6: 100_000, 7: 300_000, 8: 300_000, 9: 100_000, 10: 300_000}


@pytest.fixture
def small_mer(monkeypatch):
    """Both ladders with every seed table at mer <= SMALL_MER."""
    for configs in (jbench.CONFIGS, chip_smoke.CONFIGS):
        for c in configs.values():
            if c["mer"] > SMALL_MER:
                monkeypatch.setitem(c, "mer", SMALL_MER)


def test_configs_equal_the_reference():
    assert chip_smoke.CONFIGS == jbench.CONFIGS


@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
def test_build_workload_equals_reference(config, small_mer):
    """Same MapperConfig, genome (codes, contigs), index arrays (CSR, the
    bisulfite CSR pair, FM; None for the segmented config) and read records
    (names, codes, quals, lazy PWMs)."""
    args = (96, GENOME[config], 32)
    jw = jbench.build_workload(*args, config=config)
    tw = chip_smoke.build_workload(*args, config=config)
    same(to_port(jw[0]), tw[0], "cfg")
    same(to_port(jw[1]), tw[1], "genome")
    if jw[2] is None:
        assert tw[2] is None and chip_smoke.CONFIGS[config].get("segments")
    else:
        same(to_port(jw[2]), tw[2], "index")
    assert len(tw[3]) == 96
    same(to_port(jw[3]), tw[3], "read records")


def _counts(stats, acc=None):
    return (stats.n_reads, stats.n_mapped, stats.n_multi, stats.dp_cells,
            None if acc is None else round(acc, 4))


def _pipeline(m, batches, depth=3):
    """submit / finish with ``depth`` batches in flight behind the one
    finished, as the reference's run_pipeline: (stats, accuracy by its
    rule, chip_smoke.bench_account)."""
    stats = tm.BatchStats()
    q, hits = deque(), []
    for b in batches:
        q.append((b, m.submit(b)))
        if len(q) > depth:
            pb, pf = q.popleft()
            hits.append(m.finish(pb, pf, stats))
    while q:
        pb, pf = q.popleft()
        hits.append(m.finish(pb, pf, stats))
    return stats, chip_smoke.bench_account(m.genome, batches, hits)[1]


def _stream(m, batches, sam_path=None):
    """The whole map_stream, SAM written to ``sam_path`` (the reference's
    run_stream_sam) or not at all (run_stream_snp, whose tallies must hold
    mass); returns its stats."""
    if sam_path is None:
        res = tm.map_stream(m, iter(batches), collect_sam=False)
        assert res.tallies is not None and res.tallies.sum() > 0
        return res.stats
    gen = m.genome
    with open(sam_path, "w", encoding="utf-8") as f:
        sam_io.write_header(f, gen.names, gen.lengths, cmd="bench")
        res = tm.map_stream(m, iter(batches), collect_sam=False, sam_file=f)
    assert os.path.getsize(sam_path) > 0
    return res.stats


@pytest.mark.parametrize("config", sorted(chip_smoke.CONFIGS))
def test_pipeline_counts_equal_reference(config, small_mer, tmp_path):
    """The port's mapper on the CPU (the kernels' plain versions) over
    chip_smoke.build_workload's data gives the reference's counts: reads,
    mapped, multi-mapped, DP cells and truth accuracy, each config through
    the runner the reference's bench_config gives it.  Configs 1-4, 6-8:
    submit / finish with three batches in flight (run_pipeline; config 7
    through GlobalSegmentedMapper with two segments), a second pass giving
    the same counts.  Config 9: map_stream writing SAM (run_stream_sam).
    Configs 5 and 10: the SNP map_stream (run_stream_snp), config 10 on
    both accumulation legs, each with the counts of the reference's host
    leg (its device leg needs the Pallas path).  Configs 5, 9 and 10 also
    take their accuracy from an untimed submit / finish pass, as
    bench_config does, with that pass's counts held to the reference's."""
    c = chip_smoke.CONFIGS[config]
    jw = jbench.build_workload(96, GENOME[config], 32, config=config)
    cfg, gen, idx, recs = chip_smoke.build_workload(96, GENOME[config], 32,
                                                    config=config)
    segs = c.get("segments", 0)
    sam = c.get("sam_stream", False)
    # the reference's untimed hit-returning pass runs with SAM off
    jcfg = dataclasses.replace(jw[0], sam_out=False)
    _, jst, _, jacc = jbench.run_pipeline(jcfg, *jw[1:], "jnp",
                                          n_segments=segs)
    want = _counts(jst, jacc)
    assert want[1] > 80
    pcfg = dataclasses.replace(cfg, sam_out=False)
    if segs:
        m = GlobalSegmentedMapper(gen, pcfg, device="cpu", n_segments=segs)
    else:
        m = tm.TorchMapper(gen, idx, pcfg, device="cpu")
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    assert len(batches) == 3
    assert _counts(*_pipeline(m, batches)) == want
    if not (sam or c.get("snp")):
        assert _counts(*_pipeline(m, batches)) == want
        return
    if sam:
        _, jst, _ = jbench.run_stream_sam(*jw, "jnp")
    else:
        _, jst = jbench.run_stream_snp(*jw, "jnp")[:2]
    want = _counts(jst)
    legs = ("host", "device") if c.get("accum_ab") else ("host",)
    for acc in legs:
        m = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate=acc)
        got = _stream(m, batches, tmp_path / "bench.sam" if sam else None)
        assert _counts(got) == want, acc
    if config == 10:
        assert want[2] > 0


def test_count_constants_equal_the_recorded_ladder():
    """chip_smoke's count gates are the reference's ladder as recorded in
    BENCH_r05.json (the ladder entries in the tail of its output, which
    begins inside config 1's entry: its fields from "value" on): configs 1,
    2, 3 and 8, mapped and multi-mapped, and config 3's accuracy with its
    one wrong read (CONFIG3_WRONG)."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    dec, ref = json.JSONDecoder(), {}
    i = first = tail.find('{"config": ')
    while i >= 0:
        entry, end = dec.raw_decode(tail, i)
        ref[entry["config"]] = entry
        i = tail.find('{"config": ', end)
    ref[1] = dec.raw_decode(
        "{" + tail[tail.find('"value": '):first].rstrip(", "))[0]
    assert sorted(ref) == list(range(1, 11))
    assert ref[1]["mapped"] == chip_smoke.CONFIG1_MAPPED
    for n, want in ((2, (chip_smoke.CONFIG2_MAPPED,
                         chip_smoke.CONFIG2_MULTI)),
                    (3, (chip_smoke.CONFIG3_MAPPED,
                         chip_smoke.CONFIG3_MULTI)),
                    (8, (chip_smoke.CONFIG8_MAPPED,
                         chip_smoke.CONFIG8_MULTI))):
        assert (ref[n]["mapped"], ref[n]["multi_mapped"]) == want, n
    assert ref[2]["accuracy"] == 1.0
    assert round(1 - len(chip_smoke.CONFIG3_WRONG)
                 / chip_smoke.CONFIG3_MAPPED, 4) == ref[3]["accuracy"]
