"""The port's mapper and CLI (gnumap_tpu_torch.pipeline / .cli) held to the
JAX package, exactly: equal ReadHits (strand, pos, score, cigar, weight),
an equal device blob, and byte-equal golden SAM / SGR / SGREX files (the
CLI runs the device finish; the host finish is TorchMapper(...,
finish_impl="host")).  The CPU runs the plain torch versions of the
kernels; no test here needs a card."""

import hashlib
import io
import os

import numpy as np
import pytest
import torch

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.index import builder, store
from gnumap_tpu.io import fastq as io_fastq, sam as sam_io
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.pipeline import checkpoint as tck
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


@pytest.fixture(scope="module")
def phix(small_cfg, phix_genome):
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    idx = builder.build_index(gen, small_cfg)
    return gen, idx


def test_map_batch_equals_tpu_mapper_jnp(small_cfg, phix, phix_reads):
    gen, idx = phix
    ref = jm.TpuMapper(gen, idx, small_cfg, align_impl="jnp")
    port = tm.TorchMapper(gen, idx, small_cfg, device="cpu",
                          finish_impl="host")
    recs = records_from_sim(phix_reads, small_cfg)
    n = 0
    for batch in io_fastq.batch_reads(iter(recs), small_cfg):
        s_ref, s_port = jm.BatchStats(), tm.BatchStats()
        want = ref.map_batch(batch, s_ref)
        got = port.map_batch(batch, s_port)
        assert _hits(got) == _hits(want)
        for f in ("n_reads", "n_mapped", "n_multi", "n_candidates",
                  "dp_cells", "dp_cells_banded"):
            assert getattr(s_port, f) == getattr(s_ref, f), f
        n += batch.n
    assert n == len(phix_reads)


def test_blob_and_hits_equal_pallas_host_finish(phix_genome):
    """One small batch against TpuMapper(pallas, finish_impl='host') with
    the Pallas kernel in interpret mode: equal [cands|scores|max_sc] blob
    (quality-derived reads, so the PWM is rebuilt on the device) and equal
    hits."""
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=16,
                       max_read_len=40, align_score_ratio=0.8,
                       max_candidates=8, pallas_band_rows=8)
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(phix_genome, 12, 36, seed=5, sub_rate=0.03,
                               indel_rate=0.3, contig="phiX_sim")
    recs = [io_fastq.ReadRecord(r.name, rec.codes, None, rec.quals)
            for r, rec in zip(reads, records_from_sim(reads, cfg))]
    batch = next(io_fastq.batch_reads(iter(recs), cfg))
    assert batch.pwm_arr is None
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="host")
    port = tm.TorchMapper(gen, idx, cfg, device="cpu", finish_impl="host")
    want_blob = np.asarray(ref.submit(batch).result())
    got_blob, _ = port.submit(batch)
    assert np.array_equal(got_blob.numpy(), want_blob)
    assert _hits(port.map_batch(batch)) == _hits(ref.map_batch(batch))


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_cli_reproduces_golden_outputs(tmp_path):
    rc = tcli.main([
        "-g", os.path.join(ROOT, "testdata", "phix_sim.fa"),
        "-o", str(tmp_path / "phix"), "-m", "8", "-j", "4", "-B", "128",
        "-L", "40", "--snp", "--device", "cpu",
        os.path.join(ROOT, "testdata", "phix_sim_200.fastq")])
    assert rc == 0
    golden = {}
    with open(os.path.join(GOLDEN, "SHA256SUMS")) as f:
        for line in f:
            h, p = line.split()
            golden[os.path.basename(p)] = h
    with open(tmp_path / "phix.sam") as f:
        body = "".join(x for x in f if not x.startswith("@PG"))
    with open(os.path.join(GOLDEN, "phix.sam")) as f:
        gbody = "".join(x for x in f if not x.startswith("@PG"))
    assert body == gbody
    for ext in ("sgr", "sgrex"):
        assert _sha(str(tmp_path / f"phix.{ext}")) == golden[f"phix.{ext}"]


def test_cuda_without_card_raises(small_cfg, phix):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    gen, idx = phix
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tm.TorchMapper(gen, idx, small_cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(["-g", os.path.join(ROOT, "testdata", "phix_sim.fa"),
                   "-o", "unused", "-m", "8", "-L", "40",
                   os.path.join(ROOT, "testdata", "phix_sim_200.fastq")])


@pytest.mark.parametrize("flags", [["--num-hosts", "2"], ["-c", "2"],
                                   ["--index-shards", "2"],
                                   ["--segments", "2"],
                                   ["--index-type", "fm"], ["-b"],
                                   ["--accumulate", "device"]])
def test_cli_unported_flags_raise(flags, tmp_path):
    """Flags of paths not yet ported raise before any output is written.
    --accumulate device is ported: it runs, and is refused with segments or
    shards as the JAX CLI refuses it."""
    argv = ["-g", os.path.join(ROOT, "testdata", "phix_sim.fa"),
            "-o", str(tmp_path / "x"), "-m", "8", "-L", "40",
            "--device", "cpu", *flags,
            os.path.join(ROOT, "testdata", "phix_sim_200.fastq")]
    if flags == ["--accumulate", "device"]:
        for extra in (["--segments", "2"], ["-c", "2"]):
            with pytest.raises(SystemExit, match="single-device"):
                tcli.main(argv + extra)
            assert not os.path.exists(tmp_path / "x.sam")
        assert tcli.main(argv) == 0
        assert os.path.getsize(tmp_path / "x.sgr") > 0
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcli.main(argv)
    assert not os.path.exists(tmp_path / "x.sam")


def test_mapper_unported_configs_raise(phix_genome):
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    cfg_bs = MapperConfig(mer_size=8, max_read_len=40, bisulfite=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tm.TorchMapper(gen, builder.build_bs_index(gen, cfg_bs), cfg_bs,
                       device="cpu")
    # unbanded scoring (gap_slack >= 14) is ported: it maps, and its device
    # finish gives the host finish's hits
    cfg_wide = MapperConfig(mer_size=8, max_read_len=40, gap_slack=16,
                            batch_size=16)
    assert cfg_wide.band() is None
    idx = builder.build_index(gen, cfg_wide)
    reads = sim.simulate_reads(phix_genome, 16, 36, seed=3, sub_rate=0.02,
                               indel_rate=0.2, contig="phiX_sim")
    batch = next(io_fastq.batch_reads(
        iter(records_from_sim(reads, cfg_wide)), cfg_wide))
    got = tm.TorchMapper(gen, idx, cfg_wide, device="cpu").map_batch(batch)
    want = tm.TorchMapper(gen, idx, cfg_wide, device="cpu",
                          finish_impl="host").map_batch(batch)
    assert _hits(got) == _hits(want) and sum(map(bool, got)) >= 8


def test_device_state_loads_saved_index(small_cfg, phix, tmp_path):
    """A .npz from index/store.save_index loads straight into
    device_state (the port's device-resident "weights")."""
    gen, idx = phix
    path = str(tmp_path / "idx.npz")
    store.save_index(path, gen, idx)
    gen2, idx2 = store.load_index(path)
    st = tm.device_state(gen2, idx2, small_cfg, "cpu")
    assert np.array_equal(st["bucket_start"].numpy(), idx.bucket_start)
    assert np.array_equal(st["positions"].numpy(), idx.positions)
    assert np.array_equal(st["g_codes"].numpy(), gen.codes)
    assert st["pwm_table"].shape == (128, 5, 4)


class Boom(Exception):
    pass


def test_checkpoint_resume_equals_uninterrupted(small_cfg, phix,
                                                phix_genome, tmp_path):
    """Kill/restart: a checkpointed run interrupted after batch 3 and
    resumed from disk writes the same SAM and coverage as one that was not
    interrupted."""
    gen, idx = phix
    m = tm.TorchMapper(gen, idx, small_cfg, device="cpu")
    reads = sim.simulate_reads(phix_genome, 160, 36, seed=9, sub_rate=0.02,
                               contig="phiX_sim")

    def batches():
        return io_fastq.batch_reads(iter(records_from_sim(reads, small_cfg)),
                                    small_cfg)

    with open(tmp_path / "ref.sam", "w") as f:
        sam_io.write_header(f, gen.names, gen.lengths, cmd="x")
        ref = tm.map_stream(m, batches(), collect_sam=False, sam_file=f)
    ck = str(tmp_path / "ck.npz")

    def boom(idx_, stats):
        if idx_ >= 3:
            raise Boom()
    with open(tmp_path / "out.sam", "w+") as f:
        sam_io.write_header(f, gen.names, gen.lengths, cmd="x")
        with pytest.raises(Boom):
            tm.map_stream(m, batches(), collect_sam=False, sam_file=f,
                          checkpoint_path=ck, checkpoint_every=2,
                          batch_callback=boom)
    assert tck.load(ck).batches_done == 2
    with open(tmp_path / "out.sam", "r+") as f:
        f.seek(0, 2)
        res = tm.map_stream(m, batches(), collect_sam=False, sam_file=f,
                            checkpoint_path=ck, checkpoint_every=2)
    np.testing.assert_array_equal(res.coverage, ref.coverage)
    assert (tmp_path / "out.sam").read_text() == \
        (tmp_path / "ref.sam").read_text()
    assert res.stats.n_reads == ref.stats.n_reads == 160


def test_map_stream_python_sam_equals_native(small_cfg, phix, phix_reads,
                                             monkeypatch):
    """map_stream's per-record io/sam.py path and the native batch
    formatter write the same SAM records."""
    gen, idx = phix
    m = tm.TorchMapper(gen, idx, small_cfg, device="cpu")

    def run():
        return tm.map_stream(m, io_fastq.batch_reads(
            iter(records_from_sim(phix_reads, small_cfg)), small_cfg))

    native = "".join(run().sam_lines)
    from gnumap_tpu.native import lib as native_lib
    monkeypatch.setattr(native_lib, "available", lambda: False)
    py = run()
    assert "".join(py.sam_lines) == native
    assert py.stats.n_reads == len(phix_reads)
