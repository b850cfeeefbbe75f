"""The port's device accumulation bit for bit against the JAX package's
[FROZEN v5.2] f32 order.

  * _segmented (gnumap_tpu_torch pipeline/mapper.py) against gnumap_tpu's,
    the combination tree of jax.lax.associative_scan, on the f32 bits;
  * device_accumulate on synthetic hit rows whose scores lie near 2^25, so
    that a read's f32 total rounds (exact integer totals differ there);
  * a 100 bp pileup (300 bp repeat units over half of a 60 kbp genome,
    512 reads, SNP mode) on which hundreds of hits share 128-blocks, so
    that the same-block pre-coalescing shows in the bits: coverage and
    tallies through TorchMapper, and both CLIs' --accumulate device --snp
    SGR / SGREX files, byte for byte.

Against the exact float64 host path the device path stays within rtol =
atol = 1e-5, with the same SAM body and counts.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import records_from_sim
from gnumap_tpu.cli import main as jcli
from gnumap_tpu.config import MapperConfig
from gnumap_tpu.index import builder
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.pipeline import mapper as tm

from test_device_accum import _run as _run_jax
from test_torch_accum import _run
from test_torch_bridge import to_port

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BIG = 2 ** 31 - 1
LENGTHS = [1, 2, 3, 7, 8, 9, 127, 128, 129, 1000]
COMBS = {"add": (jnp.add, torch.add), "max": (jnp.maximum, torch.maximum)}


def _layouts(n, rng):
    """Grouped segment ids: one segment, all singletons, random runs, and
    random runs ending in a BIG tail (the invalid hits' key)."""
    runs = np.sort(rng.integers(0, max(1, n // 6), n))
    tail = runs.copy()
    tail[n - n // 3:] = BIG
    return {"one": np.zeros(n, np.int64), "single": np.arange(n),
            "runs": runs, "big_tail": tail}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("ndim", [1, 3])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("comb", sorted(COMBS))
def test_segmented_equals_jax_bits(comb, reverse, ndim, n):
    """_segmented == gnumap_tpu.pipeline.mapper._segmented on the f32 bits,
    for values (n,) and (n, 2, 128) (ids broadcast as the reference
    reshapes them for the delta windows), every segment layout."""
    rng = np.random.default_rng(n * 8 + ndim * 2 + reverse)
    jcomb, tcomb = COMBS[comb]
    shape = (n,) if ndim == 1 else (n, 2, 128)
    # magnitudes 2^-20 .. 2^20, so the add order shows in the bits
    vals = (rng.standard_normal(shape)
            * 2.0 ** rng.integers(-20, 21, shape)).astype(np.float32)
    for name, seg in _layouts(n, rng).items():
        jseg = seg.astype(np.int32).reshape((n,) + (1,) * (ndim - 1))
        want = jm._segmented(jcomb, jnp.asarray(vals), jnp.asarray(jseg),
                             reverse=reverse)
        got = tm._segmented(tcomb, torch.from_numpy(vals),
                            torch.from_numpy(seg), reverse=reverse)
        assert np.array_equal(_bits(got), _bits(want)), name
        assert got.shape == vals.shape


@pytest.mark.parametrize("n", [1, 2, 5, 64, 127, 500, 999])
def test_segmented_prefix_equals_jax_prefix(n):
    """Position i of the reference's scan depends only on positions 0..i:
    _segmented of the first n elements == the first n of the reference's
    scan of all 1,000, on the bits (what device_accumulate's n_live relies
    on)."""
    rng = np.random.default_rng(n)
    vals = (rng.standard_normal((1000, 2, 128))
            * 2.0 ** rng.integers(-20, 21, (1000, 2, 128))).astype(np.float32)
    for name, seg in _layouts(1000, rng).items():
        want = jm._segmented(jnp.add, jnp.asarray(vals),
                             jnp.asarray(seg.astype(np.int32)[:, None, None]))
        got = tm._segmented(torch.add, torch.from_numpy(vals[:n]),
                            torch.from_numpy(seg[:n]))
        assert np.array_equal(_bits(got), _bits(want)[:n]), name


def test_segmented_order_shows_in_bits():
    """The test above can tell scan orders apart: on its inputs the serial
    running sum differs from the tree's in some bits, and the scan leaves
    its input untouched."""
    rng = np.random.default_rng(1)
    vals = (rng.standard_normal(1000)
            * 2.0 ** rng.integers(-20, 21, 1000)).astype(np.float32)
    t = torch.from_numpy(vals.copy())
    got = tm._segmented(torch.add, t, torch.zeros(1000, dtype=torch.int64))
    serial = torch.cumsum(torch.from_numpy(vals), 0)
    assert not np.array_equal(_bits(got), _bits(serial))
    assert np.array_equal(_bits(t), _bits(vals))


def _synthetic_rows(seed, n=100, B=4, L=104, H=128):
    """device_hit_rows-shaped rows for B reads: n live hits in the first
    of H slots, of the 2B read-strand rows on four neighbouring 128-blocks, duplicates of one
    (row, position) with equal and lower scores, one hit in nine gapped,
    and scores near 2^25 with random low bits, so that a read's f32 total
    rounds (f32 holds 24 bits)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 2 * B, H).astype(np.int32)
    cand = (rng.integers(1000, 1400, H) // 8 * 8).astype(np.int32)
    jfin = rng.integers(0, 30, H).astype(np.int32)
    score = rng.integers(2 ** 24, 2 ** 26, H).astype(np.int32)
    row[10:14], cand[10:14], jfin[10:14] = row[9], cand[9], jfin[9]
    score[10], score[11] = score[9], score[9] - 5
    ops = np.zeros((H, (L + 7) // 8 * 8), np.int16)
    for h in range(0, n, 9):
        ops[h, rng.integers(5, 90)] = rng.choice([1, 2, 4])
    valid = np.arange(H) < n
    lens = np.where(valid, rng.integers(90, L + 1, H), 0).astype(np.int32)
    rows = dict(valid_h=valid, row_h=np.where(valid, row, 0).astype(np.int32),
                cand_h=cand, score_h=np.where(valid, score, 0).astype(np.int32),
                len_h=lens, ops=ops, jfin=np.where(valid, jfin, 0),
                n_valid=np.int32(n + 17), n_keep=np.int32(n))
    pwm2 = rng.integers(0, 2 ** 10, (2 * B, L, 4)).astype(np.int32)
    return rows, pwm2


@pytest.mark.parametrize("n_live", [128, 100, 117])
@pytest.mark.parametrize("snp", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_accumulate_equals_jax_bits(seed, snp, n_live):
    """tm.device_accumulate == gnumap_tpu's device_accumulate (B5 in
    interpret mode) on the same rows and non-zero accumulators: coverage
    and tallies bit for bit, equal stats; over all 128 hit slots (the
    reference's H), or only the first n_live (100 hold every live hit, as
    n_keep, which TorchMapper passes)."""
    _device_accumulate_vs_jax(seed, snp, n_live, 100)


@pytest.mark.parametrize("snp", [True, False])
def test_device_accumulate_no_live_hit_equals_jax(snp):
    """A batch without a retained hit (n_keep = n_live = 0): accumulators
    unchanged, stats as the reference's."""
    _device_accumulate_vs_jax(3, snp, 0, 0)


@pytest.mark.parametrize("n", [127, 128, 129, 255, 300])
@pytest.mark.parametrize("snp", [True, False])
def test_device_accumulate_at_the_tier_equals_jax_bits(snp, n):
    """n live hits in H = 384 slots, on both sides of a tier edge:
    device_accumulate on acc_tier(n, H) slots (what TorchMapper runs) and
    on n slots both equal the reference over all H, bit for bit."""
    H = 384
    tier = tm.acc_tier(n, H)
    assert n <= tier <= H and tier % 128 == 0 and tier - n < 128
    for n_live in (tier, n):
        _device_accumulate_vs_jax(4, snp, n_live, n, H)


def _device_accumulate_vs_jax(seed, snp, n_live, n, H=128):
    cfg = MapperConfig(mer_size=10, batch_size=4, max_read_len=104,
                       hit_capacity=H // 8, snp_mode=snp)
    rows, pwm2 = _synthetic_rows(seed, n, H=H)
    rng = np.random.default_rng(seed + 10)
    Gpad = jm.acc_padded_len(cfg, 4096)
    cov = rng.random((Gpad // 128, 128)).astype(np.float32)
    tal = rng.random((Gpad * 4 // 128, 128)).astype(np.float32)
    jcov, jtal, jstats = jm.device_accumulate(
        cfg, 4, jnp.asarray(pwm2), {k: jnp.asarray(v) for k, v in
                                     rows.items()},
        jnp.asarray(cov), jnp.asarray(tal), snp, interpret=True)
    tcov, ttal = torch.from_numpy(cov.copy()), torch.from_numpy(tal.copy())
    stats, _ = tm.device_accumulate(
        to_port(cfg), 4, torch.from_numpy(pwm2),
        {k: torch.as_tensor(v) for k, v in rows.items()}, tcov,
        ttal if snp else None, n_live=n_live)
    assert stats.tolist() == np.asarray(jstats).tolist()
    assert np.array_equal(_bits(tcov), _bits(jcov))
    assert np.array_equal(_bits(tcov), _bits(cov)) == (n == 0)
    if snp:
        assert np.array_equal(_bits(ttal), _bits(jtal))
        assert np.array_equal(_bits(ttal), _bits(tal)) == (n == 0)


@pytest.fixture(scope="module")
def pileup():
    """100 bp reads on a repeat-rich genome in SNP mode: the workload on
    which adding every hit's window serially, without the pre-coalescing,
    differs from the reference's bits (48 coverage and 563 tally cells)."""
    cfg = MapperConfig(mer_size=10, seed_jump=5, batch_size=128,
                       max_read_len=104, align_score_ratio=0.8,
                       sgr_out=True, snp_mode=True, max_hits_per_seed=32)
    genome = sim.random_genome(60_000, seed=3, repeat_frac=0.5,
                               repeat_unit=300)
    gen = builder.Genome.from_contigs([("t", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 512, 100, seed=4, sub_rate=0.01,
                               indel_rate=0.05, contig="t")
    return cfg, gen, idx, records_from_sim(reads, cfg), genome, reads


@pytest.fixture(scope="module")
def pileup_runs(pileup):
    cfg, gen, idx, recs = pileup[:4]
    return {"jax": _run_jax(cfg, gen, idx, recs, "device"),
            "device": _run(cfg, gen, idx, recs, "device"),
            "host": _run(cfg, gen, idx, recs, "host")}


@pytest.mark.parametrize("field", ["coverage", "tallies"])
def test_pileup_device_accum_equals_jax_bits(field, pileup_runs):
    rd, rj = pileup_runs["device"], pileup_runs["jax"]
    for f in ("n_reads", "n_mapped", "n_multi", "n_candidates"):
        assert getattr(rd.stats, f) == getattr(rj.stats, f), f
    assert rd.stats.n_multi >= 10
    got, want = getattr(rd, field), getattr(rj, field)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.count_nonzero(got) > 20_000


def test_pileup_device_accum_near_host(pileup_runs):
    """Against the exact float64 host path: f32 tolerance, equal counts."""
    rd, rh = pileup_runs["device"], pileup_runs["host"]
    assert (rd.stats.n_mapped, rd.stats.n_multi) == (
        rh.stats.n_mapped, rh.stats.n_multi)
    np.testing.assert_allclose(rd.coverage, rh.coverage, **TOL)
    np.testing.assert_allclose(rd.tallies, rh.tallies, **TOL)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_pileup_cli_sgr_equal_jax(pileup, tmp_path):
    """Both CLIs' --accumulate device --snp write byte-equal .sgr and
    .sgrex files; the port's SAM body and done-line counts equal its
    --accumulate host run's."""
    genome, reads = pileup[4:]
    fa, fq = str(tmp_path / "g.fa"), str(tmp_path / "r.fastq")
    sim.write_fasta(fa, [("t", genome)])
    sim.write_fastq(fq, reads)
    argv = ["-g", fa, "-m", "10", "-j", "5", "-k", "32", "-a", "0.8",
            "-B", "128", "-L", "104", "--snp", fq]
    runs = {"jax": (jcli.main, ["--align-impl", "pallas",
                                "--accumulate", "device"]),
            "device": (tcli.main, ["--device", "cpu",
                                   "--accumulate", "device"]),
            "host": (tcli.main, ["--device", "cpu", "--accumulate", "host"])}
    done = {}
    for name, (main, extra) in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra + ["-o", str(tmp_path / name)]) == 0
        done[name] = json.loads(buf.getvalue().splitlines()[-1])
    for k in ("reads", "mapped", "multi_mapped", "candidates"):
        assert done["device"][k] == done["host"][k] == done["jax"][k], k
    for ext in (".sgr", ".sgrex"):
        want = _read(tmp_path / f"jax{ext}")
        assert _read(tmp_path / f"device{ext}") == want
        assert want.count(b"\n") > 20_000
    sam = {}
    for name in ("device", "host"):
        with open(tmp_path / f"{name}.sam") as f:
            sam[name] = "".join(x for x in f if not x.startswith("@PG"))
    assert sam["device"] == sam["host"]
    assert sam["device"].count("\n") > 500
