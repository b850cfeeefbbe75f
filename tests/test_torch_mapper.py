"""The port's mapper and CLI (gnumap_tpu_torch.pipeline / .cli) held to the
JAX package, exactly: equal ReadHits (strand, pos, score, cigar, weight),
an equal device blob, and byte-equal golden SAM / SGR / SGREX files (the
CLI runs the device finish; the host finish is TorchMapper(...,
finish_impl="host")).  The CPU runs the plain torch versions of the
kernels; no test here needs a card.  The port takes its own classes: the
JAX package's values are rebuilt from their fields (test_torch_bridge.to_port)."""

import contextlib
import hashlib
import io
import json
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
from gnumap_tpu_torch.index import store as tstore
from gnumap_tpu_torch.native import lib as tnative_lib
from gnumap_tpu_torch.pipeline import checkpoint as tck
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim
from test_torch_bridge import port_iter, to_port

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


@pytest.fixture(scope="module")
def tcfg(small_cfg):
    return to_port(small_cfg)


@pytest.fixture(scope="module")
def tphix(phix):
    return to_port(phix)


def test_map_batch_equals_tpu_mapper_jnp(small_cfg, phix, tcfg, tphix,
                                         phix_reads):
    gen, idx = phix
    ref = jm.TpuMapper(gen, idx, small_cfg, align_impl="jnp")
    port = tm.TorchMapper(*tphix, tcfg, device="cpu", finish_impl="host")
    recs = records_from_sim(phix_reads, small_cfg)
    n = 0
    for batch in io_fastq.batch_reads(iter(recs), small_cfg):
        s_ref, s_port = jm.BatchStats(), tm.BatchStats()
        want = ref.map_batch(batch, s_ref)
        got = port.map_batch(to_port(batch), s_port)
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
    port = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu",
                          finish_impl="host")
    want_blob = np.asarray(ref.submit(batch).result())
    got_blob, _ = port.submit(to_port(batch))
    assert np.array_equal(got_blob.numpy(), want_blob)
    assert _hits(port.map_batch(to_port(batch))) == \
        _hits(ref.map_batch(batch))


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


def test_cuda_without_card_raises(tcfg, tphix):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tm.TorchMapper(*tphix, tcfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(["-g", os.path.join(ROOT, "testdata", "phix_sim.fa"),
                   "-o", "unused", "-m", "8", "-L", "40",
                   os.path.join(ROOT, "testdata", "phix_sim_200.fastq")])


@pytest.mark.parametrize("flags", [["--index-type", "fm", "-c", "2"],
                                   ["-c", "2"],
                                   ["-c", "2", "--index-shards", "2",
                                    "--num-hosts", "2"],
                                   ["--accumulate", "device"]])
def test_cli_unported_flags_raise(flags, tmp_path):
    """The refusals of the sharded flags, made before any process group or
    output exists: the FM index with -c 2 (the JAX CLI's "single-device"
    refusal); -c R --index-shards S with a --num-hosts other than R * S (a
    rank owns one device); --accumulate device with segments or -c 2, as
    the JAX CLI refuses it, while it runs alone."""
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
    want = ("--index-type fm is single-device" if "fm" in flags
            else "R\\*S processes started with --num-hosts R\\*S")
    with pytest.raises(SystemExit, match=want):
        tcli.main(argv)
    assert not os.path.exists(tmp_path / "x.sam")


def _two_contig_fasta(phix_genome, path):
    from gnumap_tpu.utils import sim as jsim
    jsim.write_fasta(str(path), [("phiX_a", phix_genome[:2700]),
                                 ("phiX_b", phix_genome[2700:])])
    return str(path)


def _cli_outputs(main, argv, out):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv + ["-o", str(out)]) == 0
    done = json.loads(buf.getvalue().splitlines()[-1])
    with open(f"{out}.sam") as f:
        body = "".join(x for x in f if not x.startswith("@PG"))
    with open(f"{out}.sgr", "rb") as f:
        return body, f.read(), done


@pytest.mark.parametrize("flags", [["-b"], ["--index-type", "fm"],
                                   ["--segments", "2"],
                                   ["-b", "--index-type", "fm"]])
def test_cli_ported_flags_equal_jax(flags, phix_genome, tmp_path):
    """-b, --index-type fm and --segments 2 run on the CPU and write the
    JAX CLI's SAM body and SGR bytes for the same command (phiX split into
    two contigs, so --segments 2 makes two segments)."""
    from gnumap_tpu.cli import main as jcli
    argv = ["-g", _two_contig_fasta(phix_genome, tmp_path / "g.fa"),
            "-m", "8", "-j", "4", "-B", "128", "-L", "40", *flags,
            os.path.join(ROOT, "testdata", "phix_sim_200.fastq")]
    got = _cli_outputs(tcli.main, argv + ["--device", "cpu"],
                       tmp_path / "port")
    want = _cli_outputs(jcli.main, argv, tmp_path / "jax")
    assert got[:2] == want[:2]
    assert got[2]["segments"] == want[2]["segments"] == (
        2 if "--segments" in flags else 1)
    assert got[2]["mapped"] == want[2]["mapped"] > 100


@pytest.mark.parametrize("case", ["segments_npz", "segments_fm",
                                  "save_index_segmented"])
def test_cli_refusals_follow_jax(case, phix_genome, tmp_path):
    """The JAX CLI's refusals around the ported flags, with its messages:
    --segments with an .npz genome, --segments with --index-type fm,
    --save-index of a segmented genome."""
    from gnumap_tpu.cli import main as jcli
    fa = _two_contig_fasta(phix_genome, tmp_path / "g.fa")
    npz = str(tmp_path / "idx.npz")
    tcli.main(["-g", fa, "-m", "8", "-L", "40", "--save-index", npz])
    genome, extra = {"segments_npz": (npz, ["--segments", "2"]),
                     "segments_fm": (fa, ["--segments", "2",
                                          "--index-type", "fm"]),
                     "save_index_segmented": (
                         fa, ["--segments", "2", "--save-index",
                              str(tmp_path / "s.npz")])}[case]
    argv = ["-g", genome, "-o", str(tmp_path / "x"), "-m", "8", "-L", "40",
            *extra, os.path.join(ROOT, "testdata", "phix_sim_200.fastq")]
    msgs = []
    for main, dev in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and len(msgs[0]) > 20
    assert not os.path.exists(tmp_path / "x.sam")


def test_mapper_unported_configs_raise(phix_genome):
    # bisulfite mode (BsIndexPair) is ported: it maps, with the reference's
    # hits
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    cfg_bs = MapperConfig(mer_size=8, max_read_len=40, bisulfite=True,
                          batch_size=16)
    idx_bs = builder.build_bs_index(gen, cfg_bs)
    reads_bs = sim.simulate_reads(phix_genome, 16, 36, seed=3,
                                  sub_rate=0.02, contig="phiX_sim",
                                  bisulfite=True)
    batch_bs = next(io_fastq.batch_reads(
        iter(records_from_sim(reads_bs, cfg_bs)), cfg_bs))
    got_bs = tm.TorchMapper(*to_port((gen, idx_bs, cfg_bs)),
                            device="cpu").map_batch(to_port(batch_bs))
    assert _hits(got_bs) == _hits(jm.TpuMapper(gen, idx_bs, cfg_bs)
                                  .map_batch(batch_bs))
    assert sum(map(bool, got_bs)) >= 12
    # unbanded scoring (gap_slack >= 14) is ported: it maps, and its device
    # finish gives the host finish's hits
    cfg_wide = MapperConfig(mer_size=8, max_read_len=40, gap_slack=16,
                            batch_size=16)
    assert cfg_wide.band() is None
    idx = builder.build_index(gen, cfg_wide)
    reads = sim.simulate_reads(phix_genome, 16, 36, seed=3, sub_rate=0.02,
                               indel_rate=0.2, contig="phiX_sim")
    batch = to_port(next(io_fastq.batch_reads(
        iter(records_from_sim(reads, cfg_wide)), cfg_wide)))
    args = to_port((gen, idx, cfg_wide))
    got = tm.TorchMapper(*args, device="cpu").map_batch(batch)
    want = tm.TorchMapper(*args, device="cpu",
                          finish_impl="host").map_batch(batch)
    assert _hits(got) == _hits(want) and sum(map(bool, got)) >= 8


def test_device_state_loads_saved_index(tcfg, phix, tmp_path):
    """A .npz from the JAX package's index/store.save_index loads, through
    the port's store, straight into device_state (the port's
    device-resident "weights")."""
    gen, idx = phix
    path = str(tmp_path / "idx.npz")
    store.save_index(path, gen, idx)
    gen2, idx2 = tstore.load_index(path)
    st = tm.device_state(gen2, idx2, tcfg, "cpu")
    assert np.array_equal(st["bucket_start"].numpy(), idx.bucket_start)
    assert np.array_equal(st["positions"].numpy(), idx.positions)
    assert np.array_equal(st["g_codes"].numpy(), gen.codes)
    assert st["pwm_table"].shape == (128, 5, 4)


class Boom(Exception):
    pass


def test_checkpoint_resume_equals_uninterrupted(small_cfg, tcfg, tphix,
                                                phix_genome, tmp_path):
    """Kill/restart: a checkpointed run interrupted after batch 3 and
    resumed from disk writes the same SAM and coverage as one that was not
    interrupted."""
    gen, idx = tphix
    m = tm.TorchMapper(gen, idx, tcfg, device="cpu")
    reads = sim.simulate_reads(phix_genome, 160, 36, seed=9, sub_rate=0.02,
                               contig="phiX_sim")

    def batches():
        return port_iter(io_fastq.batch_reads(
            iter(records_from_sim(reads, small_cfg)), small_cfg))

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


def test_map_stream_python_sam_equals_native(small_cfg, tcfg, tphix,
                                             phix_reads, monkeypatch):
    """map_stream's per-record io/sam.py path and the native batch
    formatter write the same SAM records."""
    m = tm.TorchMapper(*tphix, tcfg, device="cpu")

    def run():
        return tm.map_stream(m, port_iter(io_fastq.batch_reads(
            iter(records_from_sim(phix_reads, small_cfg)), small_cfg)))

    if not tnative_lib.available():
        pytest.skip("native host library unavailable (no C++ compiler)")
    native = "".join(run().sam_lines)
    monkeypatch.setattr(tnative_lib, "available", lambda: False)
    py = run()
    assert "".join(py.sam_lines) == native
    assert py.stats.n_reads == len(phix_reads)


def test_profiling_trace_and_annotate(small_cfg, tcfg, tphix, phix_reads,
                                      tmp_path):
    """utils/profiling (the counterpart of gnumap_tpu/utils/profiling.py):
    trace(dir) writes a Chrome trace of the region, in which an
    annotate(name) region around a map_batch shows by name."""
    from gnumap_tpu_torch.utils import profiling
    batch = to_port(next(io_fastq.batch_reads(
        iter(records_from_sim(phix_reads[:8], small_cfg)), small_cfg)))
    m = tm.TorchMapper(*tphix, tcfg, device="cpu")
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("gnumap_map_batch"):
            out = m.map_batch(batch)
    assert len(out) == 8 and any(out)
    files = list((tmp_path / "tr").glob("trace.*.json"))
    assert len(files) == 1
    assert "gnumap_map_batch" in files[0].read_text()
