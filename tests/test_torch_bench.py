"""The port's benchmark driver (gnumap_tpu_torch/bench.py) held to the
reference's bench.py on the CPU at small sizes: the same ladder configs,
the same workloads (genome, contigs, reads, records, index arrays), the same
counts from the timed pipeline (reads, mapped, multi-mapped, truth accuracy,
DP cells), the kernel bit check on the plain versions, the per-stage split
of the device finish against the reference's GNUMAP_TB_MODE probes, and
the headline line's keys and exit codes.  Every comparison is exact.

Sizes: genomes of 50-300 kb and 96 reads in batches of 32 (the reference's
jnp pipeline compiles per batch shape); the configs of mer 13 and the
bisulfite config of mer 16 build their seed tables at mer 11 (a dense
table of 4^13 or a base-3 pair of 3^16 buckets is 268-344 MB a package).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from gnumap_tpu_torch import bench as tbench
from gnumap_tpu_torch.pipeline import mapper as tm

from test_torch_bridge import to_port
from test_torch_hostlib import same

torch.set_num_threads(1)

SMALL_MER = 11
GENOME = {1: 5_386, 2: 100_000, 3: 300_000, 4: 300_000, 5: 300_000,
          6: 100_000, 7: 300_000, 8: 300_000, 9: 100_000, 10: 300_000}
# bench.py's headline line (bench.py:835-874), key for key
HEADLINE_KEYS = (
    "metric", "value", "unit", "reads_per_s_device_time",
    "reads_per_s_sustained_outputs_on", "vs_baseline", "backend",
    "align_impl", "kernel_bitcheck", "kernel_bitcheck_n", "reads", "mapped",
    "accuracy", "mapped_rate", "multi_mapped", "dp_cells_per_s_device",
    "dp_unit", "device_s", "host_s", "wall_s", "profile", "ladder",
    "baseline_provenance")


@pytest.fixture
def small_mer(monkeypatch):
    """Both packages' ladders with every seed table at mer <= SMALL_MER."""
    for mod in (jbench, tbench):
        for n, c in mod.CONFIGS.items():
            if c["mer"] > SMALL_MER:
                monkeypatch.setitem(c, "mer", SMALL_MER)


def test_configs_equal_the_reference():
    assert tbench.CONFIGS == jbench.CONFIGS
    assert tbench.BENCH_READS_CPU == jbench.BENCH_READS_CPU


@pytest.mark.parametrize("config", sorted(tbench.CONFIGS))
def test_build_workload_equals_reference(config, small_mer):
    """Same MapperConfig, genome (codes, contigs), index arrays (CSR, the
    bisulfite CSR pair, FM; None for the segmented config) and read records
    (names, codes, quals, lazy PWMs)."""
    args = (96, GENOME[config], 32)
    jw = jbench.build_workload(*args, config=config)
    tw = tbench.build_workload(*args, config=config)
    same(to_port(jw[0]), tw[0], "cfg")
    same(to_port(jw[1]), tw[1], "genome")
    if jw[2] is None:
        assert tw[2] is None and tbench.CONFIGS[config].get("segments")
    else:
        same(to_port(jw[2]), tw[2], "index")
    assert len(tw[3]) == 96
    same(to_port(jw[3]), tw[3], "read records")


def _counts(stats, acc):
    return (stats.n_reads, stats.n_mapped, stats.n_multi, stats.dp_cells,
            round(acc, 4))


@pytest.mark.parametrize("config", [2, 7, 10])
def test_pipeline_counts_equal_reference(config, small_mer):
    """run_pipeline on the CPU (the kernels' plain versions) gives the
    reference's run_pipeline(..., "jnp") counts: reads, mapped,
    multi-mapped, DP cells and truth accuracy; repeats give the same
    counts.  Config 7 runs its two segments; config 10 runs the SNP
    map_stream on both accumulation legs (bench_config runs the host leg
    and then the device leg), each with the counts of the reference's host
    leg (its device leg needs the Pallas path), and bench_config's line
    carries them."""
    jw = jbench.build_workload(96, GENOME[config], 32, config=config)
    tw = tbench.build_workload(96, GENOME[config], 32, config=config)
    segs = tbench.CONFIGS[config].get("segments", 0)
    _, jst, _, jacc = jbench.run_pipeline(*jw, "jnp", n_segments=segs)
    want = _counts(jst, jacc)
    assert want[1] > 80
    best, walls = tbench.run_pipeline(*tw, "cpu", n_segments=segs,
                                      repeats=2)
    assert _counts(best.stats, best.accuracy) == want
    assert len(walls) == 2 and best.wall_s == min(walls)
    if config == 10:
        _, jsnp = jbench.run_stream_snp(*jw, "jnp")[:2]
        want = (jsnp.n_reads, jsnp.n_mapped, jsnp.n_multi, jsnp.dp_cells)
        assert want[2] > 0
        _, st = tbench.run_stream_snp(*tw, "cpu", acc_impl="device")
        assert (st.n_reads, st.n_mapped, st.n_multi, st.dp_cells) == want
    args = tbench.build_arg_parser().parse_args(
        ["--device", "cpu", "--reads", "96", "--genome-len",
         str(GENOME[config]), "--batch-size", "32"])
    line = tbench.bench_config(config, args, "cpu", with_baseline=False,
                               workload=tw)
    assert (line["reads"], line["mapped"], line["multi_mapped"],
            line["dp_cells"], line["accuracy"]) == (*want[:4],
                                                    round(jacc, 4))
    if config == 10:
        assert line["reads_per_s_device_accum"] > 0
        assert "device_accum_error" not in line


def test_kernel_bitcheck_on_the_plain_versions():
    ok, n, detail = tbench.kernel_bitcheck("cpu")
    assert (ok, detail) == (True, "ok")
    assert n > 300


def test_device_hit_rows_stages_equal_the_reference_probes(monkeypatch):
    """device_hit_rows split into device_retain, device_pure (B2) and
    device_traceback (B3): each stage's rows equal the reference's
    device_hit_rows at the GNUMAP_TB_MODE probe that stops there ("retain",
    "pure", "full"), hit for hit, and the blob built from the stages equals
    the mapper's and the reference's device blob."""
    from gnumap_tpu.align import nw_pallas
    from gnumap_tpu.pipeline import mapper as jm
    from test_devtb import _pipeline_workload
    import jax.numpy as jnp
    cfg, gen, idx, batches = _pipeline_workload(seed=55, n_reads=60,
                                                indel=1.0, ratio=0.6)
    tcfg, tgen, tidx = to_port((cfg, gen, idx))
    m = tm.TorchMapper(tgen, tidx, tcfg, device="cpu")
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="device")
    g = m.state["g_codes"]
    g_words = jnp.asarray(nw_pallas.pad_genome_words(
        np.asarray(gen.codes), cfg.window_width()))
    n_indel = n_pure = 0
    for b in batches:
        tb = to_port(b)
        out = m._device_map(torch.from_numpy(tb.codes),
                            torch.from_numpy(tb.pwm_arr),
                            torch.from_numpy(tb.lens))
        rows = tm.device_retain(tcfg, *out)
        pj = tm.device_pure(tcfg, rows, g)
        full = tm.device_traceback(tcfg, rows, pj, out[4], g)
        cands, valid, scores, max_sc, emis2_t, lens2 = (
            jnp.asarray(x.numpy()) for x in out)
        jargs = (cfg, cands, valid, scores, max_sc,
                 jnp.transpose(emis2_t, (0, 2, 1)), lens2, g_words, True)
        for mode in ("retain", "pure", "full"):
            monkeypatch.setenv("GNUMAP_TB_MODE", mode)
            want = {k: np.asarray(v) for k, v in
                    jm.device_hit_rows(*jargs).items()}
            if mode == "retain":
                for k in ("valid_h", "hit_flat", "row_h", "cand_h",
                          "score_h", "len_h", "n_keep", "n_valid"):
                    assert np.array_equal(rows[k].numpy(), want[k]), k
            elif mode == "pure":
                pure, jf = pj
                assert np.array_equal(
                    torch.where(pure, jf, 0).numpy(), want["jfin"])
                n_pure += int(pure.sum())
            else:
                assert np.array_equal(full["ops"].numpy(), want["ops"])
                assert np.array_equal(full["jfin"].numpy(), want["jfin"])
        blob = tm.device_tb_tail(tcfg, *out, g, rows=full).numpy()
        monkeypatch.setenv("GNUMAP_TB_MODE", "full")
        assert np.array_equal(blob, m.submit(tb)[0].numpy())
        assert np.array_equal(blob, np.asarray(ref.submit(b).result()))
        n_indel += int(blob[-1])
    assert n_indel > 0 and n_pure > 0


def test_profile_stages_on_the_cpu(small_mer):
    """Every stage key of the reference's profile, finite, from host-clock
    prefixes of the device program on the CPU; the stages telescope to
    sum_of_stages_ms."""
    w = tbench.build_workload(64, 50_000, 32, config=2)
    prof = tbench.profile_stages(*w, "cpu", reps=1)
    assert prof["batch"] == 32 and prof["clock"] == "host perf_counter"
    for k in tbench.PROFILE_KEYS + ("sum_of_stages_ms", "submit_ms",
                                    "submit_eager_ms"):
        assert np.isfinite(prof[k]), k
    t = prof["prefix_ms"]
    assert prof["sum_of_stages_ms"] == pytest.approx(t["full"])
    assert prof["seed_ms"] == pytest.approx(
        prof["seed_gather_ms"] + prof["seed_dedupe_ms"])
    assert prof["traceback_ms"] == pytest.approx(
        prof["tb_retain_ms"] + prof["tb_pure_kernel_ms"]
        + prof["tb_backwalk_ms"])


def _main(capsys, argv):
    rc = tbench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(x) for x in lines]


def test_main_headline_on_the_cpu(capsys, tmp_path, monkeypatch):
    """main --device cpu --config 2 --no-baseline --reads 256 (at 100 kb, in
    batches of 128) exits 0; its one line is the headline with every key of
    bench.py's, no device rate (nothing ran on a device) and no failure.
    main --cpu-baseline --device cpu measures the CPU rate and caches it in
    the temporary directory, where cpu_baseline finds it."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu", "--config", "2", "--reads", "256",
            "--genome-len", "100000", "--batch-size", "128"]
    rc, lines = _main(capsys, argv + ["--no-baseline"])
    assert rc == 0 and len(lines) == 1
    head = lines[0]
    assert set(HEADLINE_KEYS) <= set(head)
    assert head["failed"] == [] and head["kernel_bitcheck"] is True
    assert (head["backend"], head["align_impl"]) == ("cpu", "plain")
    assert head["reads"] == 256 and head["accuracy"] >= 0.99
    assert len(head["wall_s_repeats"]) == 3
    assert head["reads_per_s_device_time"] is None
    assert head["dp_cells_per_s_device"] is None and head["profile"] is None
    assert head["vs_baseline"] is None
    assert tbench.main(["--cpu-baseline", *argv, "--reads", "64"]) == 0
    cache = list(tmp_path.glob("gnumap_torch_bench_cpu_baseline.2.64.*"))
    assert len(cache) == 1
    base = tbench.cpu_baseline(64, 100_000, config=2)
    assert base["reads"] == 64 and base["cpu_reads_per_s"] > 0
    capsys.readouterr()


def test_main_fails_on_a_failing_config(capsys, monkeypatch):
    """A config that raises keeps its error line, the headline is still
    printed, and main exits 1; so does a reference whose counts differ."""
    def boom(*a, **k):
        raise RuntimeError("forced failure")

    argv = ["--device", "cpu", "--config", "1", "--reads", "64",
            "--no-baseline"]
    with monkeypatch.context() as mp:
        mp.setattr(tbench, "run_pipeline", boom)
        rc, lines = _main(capsys, argv)
    assert rc == 1
    assert lines[-1]["ladder"][0]["error"] == "RuntimeError: forced failure"
    assert any("forced failure" in f for f in lines[-1]["failed"])
    ref = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "BENCH_r05.json")
    rc, lines = _main(capsys, argv + ["--reference", ref])
    assert rc == 1 and lines[-1]["mapped"] == 64
    assert lines[-1]["reference"] == {"mapped": 9843, "multi_mapped": 0,
                                      "accuracy": 1.0}
    assert lines[-1]["counts_equal_reference"] is False


def test_reference_ladder_reads_the_recorded_tail():
    """The ladder of BENCH_r05.json, from its recorded output's tail: all
    ten configs, with config 2's 16,383 mapped of 16,384 reads."""
    ref = tbench.reference_ladder(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BENCH_r05.json"))
    assert sorted(ref) == list(range(1, 11))
    assert (ref[2]["mapped"], ref[2]["multi_mapped"]) == (16383, 0)
    assert ref[10]["reads_per_s_device_accum"] == 345.1


def test_main_refuses_a_missing_card_and_bad_depth():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA card"):
        tbench.main(["--config", "1"])
    with pytest.raises(SystemExit, match="--depth"):
        tbench.main(["--device", "cpu", "--depth", "9"])
    with pytest.raises(SystemExit, match="--device cpu"):
        tbench.main(["--cpu-baseline"])
