"""The port's own host modules (gnumap_tpu_torch: config, core, align.scoring,
index, io, oracle, posterior.snp, utils.sim, native) held to the modules of
the JAX package they were copied from, on the CPU at small sizes.  Every
comparison is exact: equal constants, equal arrays (dtype, shape, values),
equal strings and bytes.  Inputs come from a numpy seed and cross between
the packages as numpy arrays and plain values only (test_torch_bridge.to_port
rebuilds a dataclass from its fields).

Two deliberate differences from the JAX package, each pinned here: the
port's native SAM formatter takes names outside ASCII, as UTF-8 with byte
offsets, where the JAX package's raises UnicodeEncodeError, and checks
every snprintf (ROADMAP C.2); the port's genome-partitioned SAM merge
streams and refuses shards out of order, byte-equal to the JAX merge on
shards in the writer's order (ROADMAP C.3).
"""

import dataclasses
import io
import os

import numpy as np
import pytest

from gnumap_tpu import config as jconfig
from gnumap_tpu.align import scoring as jscoring
from gnumap_tpu.core import packing as jpacking, pwm as jpwm
from gnumap_tpu.index import builder as jbuilder, store as jstore
from gnumap_tpu.io import fastq as jfastq, sam as jsam, sgr as jsgr
from gnumap_tpu.native import lib as jnative
from gnumap_tpu.oracle import oracle as joracle
from gnumap_tpu.posterior import snp as jsnp
from gnumap_tpu.utils import sim as jsim
from gnumap_tpu_torch import _build, config as tconfig
from gnumap_tpu_torch.align import scoring as tscoring
from gnumap_tpu_torch.core import packing as tpacking, pwm as tpwm
from gnumap_tpu_torch.index import builder as tbuilder, store as tstore
from gnumap_tpu_torch.io import fastq as tfastq, sam as tsam, sgr as tsgr
from gnumap_tpu_torch.native import lib as tnative
from gnumap_tpu_torch.oracle import oracle as toracle
from gnumap_tpu_torch.posterior import snp as tsnp
from gnumap_tpu_torch.utils import sim as tsim

from test_torch_bridge import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FASTQ = os.path.join(ROOT, "testdata", "phix_sim_200.fastq")
FASTA = os.path.join(ROOT, "testdata", "phix_sim.fa")


def same(a, b, where="value"):
    """Assert a == b exactly, through dataclasses, sequences and arrays."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{k}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


CONFIGS = {
    "default": {},
    "small": dict(mer_size=8, seed_jump=4, batch_size=32, max_read_len=40,
                  align_score_ratio=0.8),
    "narrow_band": dict(gap_slack=0, max_read_len=24),
    "widest_band": dict(gap_slack=13, max_read_len=104),
    "unbanded": dict(gap_slack=16, max_read_len=104),
    "harsh": dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5),
    "bisulfite": dict(bisulfite=True, mer_size=16),
    "subst": dict(subst_matrix=((1.0, -1.0, -0.5, -1.0),
                                (-1.0, 1.0, -1.0, -0.5),
                                (-0.5, -1.0, 1.0, -1.0),
                                (-1.0, -0.5, -1.0, 1.0))),
}


def _cfgs(name):
    return (jconfig.MapperConfig(**CONFIGS[name]),
            tconfig.MapperConfig(**CONFIGS[name]))


def test_config_constants_and_fields():
    names = [n for n in dir(jconfig) if n.isupper()]
    assert {"PWM_SCALE", "S_SCALE", "SCORE_ONE", "WINDOW_ALIGN", "RATIO_BITS",
            "NEG_INF", "BASE_N", "N_BASES"} <= set(names)
    for n in names:
        same(getattr(jconfig, n), getattr(tconfig, n), n)
    jf = [(f.name, f.default) for f in dataclasses.fields(
        jconfig.MapperConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(
        tconfig.MapperConfig)]
    assert jf == tf
    same(to_port(jconfig.MapperConfig(mer_size=9)),
         tconfig.MapperConfig(mer_size=9))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_methods(name):
    jc, tc = _cfgs(name)
    for meth in ("gap_open_q", "gap_extend_q", "window_width", "band",
                 "ratio_q"):
        same(getattr(jc, meth)(), getattr(tc, meth)(), meth)
    for cand in (-40, -1, 0, 7, 8, 123456):
        same(jc.window_start(cand), tc.window_start(cand), "window_start")
    same(jc.window_start(np.array([-9, 5, 800])),
         tc.window_start(np.array([-9, 5, 800])), "window_start array")
    for ms in (0, 1, 36 * jconfig.SCORE_ONE, 2 ** 30 - 1):
        same(jc.threshold_for(ms), tc.threshold_for(ms), "threshold_for")


@pytest.mark.parametrize("bad", [dict(mer_size=0), dict(seed_jump=0),
                                 dict(max_candidates=7),
                                 dict(align_score_ratio=0.0)])
def test_config_rejects_what_the_original_rejects(bad):
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError):
            mod.MapperConfig(**bad)


def test_packing():
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGTNacgtnRY"), 301))
    codes = jpacking.encode(seq)
    same(codes, tpacking.encode(seq), "encode")
    same(jpacking.encode(seq.encode()), tpacking.encode(seq.encode()),
         "encode bytes")
    same(jpacking.decode(codes), tpacking.decode(codes), "decode")
    same(jpacking.revcomp(codes), tpacking.revcomp(codes), "revcomp")
    words = jpacking.pack_2bit(codes)
    same(words, tpacking.pack_2bit(codes), "pack_2bit")
    same(jpacking.unpack_2bit(words, len(codes)),
         tpacking.unpack_2bit(words, len(codes)), "unpack_2bit")
    for m in (1, 8, 13):
        same(jpacking.kmer_codes(codes, m), tpacking.kmer_codes(codes, m),
             f"kmer_codes {m}")


def test_pwm():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, (7, 40)).astype(np.int8)
    quals = rng.integers(0, 60, (7, 40))
    same(jpwm.pwm_table(), tpwm.pwm_table(), "pwm_table")
    same(jpwm.pwm_rows_from_table(codes, quals),
         tpwm.pwm_rows_from_table(codes, quals), "pwm_rows_from_table")
    for b in range(7):
        pq = jpwm.pwm_from_calls(codes[b], quals[b])
        same(pq, tpwm.pwm_from_calls(codes[b], quals[b]), "pwm_from_calls")
        same(jpwm.pwm_revcomp(pq), tpwm.pwm_revcomp(pq), "pwm_revcomp")
    same(jpwm.phred_to_prob(quals), tpwm.phred_to_prob(quals), "phred")
    probs = rng.dirichlet(np.ones(4), 50)
    same(jpwm.pwm_from_probs(probs), tpwm.pwm_from_probs(probs), "probs")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scoring_matrices(name):
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(3)
    same(jscoring.normal_matrix(jc), tscoring.normal_matrix(tc), "normal")
    same(jscoring.matrices_for_mode(jc), tscoring.matrices_for_mode(tc),
         "matrices_for_mode")
    for strand in ("+", "-"):
        same(jscoring.bisulfite_matrix(jc, strand),
             tscoring.bisulfite_matrix(tc, strand), "bisulfite " + strand)
    codes = rng.integers(0, 4, (5, 30)).astype(np.int8)
    pw = jpwm.pwm_rows_from_table(codes, rng.integers(2, 41, (5, 30)))
    je = jscoring.emission_int(pw, jscoring.normal_matrix(jc))
    same(je, tscoring.emission_int(pw, tscoring.normal_matrix(tc)), "emis")
    lens = np.array([30, 12, 0, 1, 29], np.int32)
    same(jscoring.max_read_score(je), tscoring.max_read_score(je), "max")
    same(jscoring.max_read_score(je, lens), tscoring.max_read_score(je, lens),
         "max lens")


@pytest.fixture(scope="module")
def genome20k():
    """A 20 kb genome in two contigs with a repeat and N runs."""
    g = jsim.random_genome(20_000, seed=5, repeat_frac=0.05, repeat_unit=90)
    g = g[:7000] + "N" * 30 + g[7030:]
    return [("chrA", g[:12_000]), ("chrB", g[12_000:])]


@pytest.mark.parametrize("kind", ["csr", "csr_numpy", "bisulfite"])
def test_builder_index_arrays(genome20k, kind, monkeypatch):
    jc, tc = _cfgs("small")
    jg = jbuilder.Genome.from_contigs(genome20k)
    tg = tbuilder.Genome.from_contigs(genome20k)
    same(jg, tg, "genome")
    pos = np.array([0, 11_999, 12_064, 20_050])
    same(jg.locate(pos), tg.locate(pos), "locate")
    if kind == "bisulfite":
        jc, tc = (jconfig.MapperConfig(mer_size=10, bisulfite=True),
                  tconfig.MapperConfig(mer_size=10, bisulfite=True))
        ji, ti = jbuilder.build_bs_index(jg, jc), tbuilder.build_bs_index(
            tg, tc)
        same(ji.mer_size, ti.mer_size, "mer_size")
    else:
        if kind == "csr_numpy":
            monkeypatch.setattr(jnative, "available", lambda: False)
            monkeypatch.setattr(tnative, "available", lambda: False)
        ji, ti = jbuilder.build_index(jg, jc), tbuilder.build_index(tg, tc)
        assert len(ti.positions) > 19_000
        same(ji.lookup(12345), ti.lookup(12345), "lookup")
        same(ji.n_buckets, ti.n_buckets, "n_buckets")
    same(ji, ti, "index")
    codes = jg.codes[:500]
    for mode in ("ct", "ga"):
        same(jbuilder.collapse_codes(codes, mode),
             tbuilder.collapse_codes(codes, mode), "collapse " + mode)
        same(jbuilder.kmer_codes_b3(codes, 9, mode),
             tbuilder.kmer_codes_b3(codes, 9, mode), "kmer_codes_b3")
    same(jbuilder.Genome.from_fasta(FASTA), tbuilder.Genome.from_fasta(FASTA),
         "from_fasta")


@pytest.mark.parametrize("kind", ["csr", "csr_bs", "fm", "fm_bs"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_round_trip(genome20k, kind, writer, tmp_path):
    """An index of each kind saved by either package loads in both, equal
    to what was saved; the shards are equal too."""
    from gnumap_tpu.index import fm as jfm
    jc = jconfig.MapperConfig(mer_size=8, bisulfite=kind.endswith("_bs"))
    jg = jbuilder.Genome.from_contigs(genome20k)
    ji = {"csr": jbuilder.build_index, "csr_bs": jbuilder.build_bs_index,
          "fm": jfm.build_fm_index,
          "fm_bs": jfm.build_bs_fm_index}[kind](jg, jc)
    path = str(tmp_path / "idx.npz")
    if writer == "jax":
        jstore.save_index(path, jg, ji)
    else:
        tstore.save_index(path, to_port(jg), to_port(ji))
    jg2, ji2 = jstore.load_index(path)
    tg2, ti2 = tstore.load_index(path)
    same(jg, tg2, "genome")
    same(jg2, tg2, "genome loaded twice")
    same(ji, ti2, "index")
    same(ji2, ti2, "index loaded twice")
    if kind == "csr":
        same(jstore.shard_index(ji, 3), tstore.shard_index(ti2, 3), "shards")


@pytest.mark.parametrize("sa", ["native", "numpy"])
def test_fm_index_numpy_half(genome20k, sa, monkeypatch, tmp_path):
    """index/fm.py's numpy half: suffix_array (native SA-IS and the numpy
    prefix doubling), pack_4bit, build_fm_index and build_bs_fm_index
    arrays, rank / search_range / lookup, save / load."""
    from gnumap_tpu.align import nw_pallas
    from gnumap_tpu.index import fm as jfm
    from gnumap_tpu_torch.index import fm as tfm
    if sa == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not (tnative.available() and jnative.available()):
        pytest.skip("native host library unavailable (no C++ compiler)")
    for name in ("OCC_BLOCK", "N_SYMS"):
        same(getattr(jfm, name), getattr(tfm, name), name)
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 5, 3001).astype(np.int8)
    codes[:600] = np.tile(codes[:40], 15)                 # repeats
    same(jfm.suffix_array(codes), tfm.suffix_array(codes), "suffix_array")
    for n in (0, 1, 7, 8, 9, 17):
        same(nw_pallas.pack_4bit(codes[:n]), tfm.pack_4bit(codes[:n]),
             f"pack_4bit {n}")
    jc, tc = (jconfig.MapperConfig(mer_size=7),
              tconfig.MapperConfig(mer_size=7))
    contigs = [(n, g[:4000]) for n, g in genome20k]
    jg, tg = (jbuilder.Genome.from_contigs(contigs),
              tbuilder.Genome.from_contigs(contigs))
    ji, ti = jfm.build_fm_index(jg, jc), tfm.build_fm_index(tg, tc)
    same(ji, ti, "fm index")
    same(jfm.build_bs_fm_index(jg, jc), tfm.build_bs_fm_index(tg, tc),
         "bs fm pair")
    same(ji.n, ti.n, "n")
    for i in (0, 1, 31, 32, 33, ti.n - 1, ti.n):
        for sym in range(6):
            same(ji.rank(sym, i), ti.rank(sym, i), f"rank {sym} {i}")
    for k in rng.integers(0, 4 ** 7, 60):
        same(ji.lookup(int(k)), ti.lookup(int(k)), f"lookup {k}")
        kc = rng.integers(0, 4, 5)
        same(ji.search_range(kc), ti.search_range(kc), "search_range")
    for writer, reader in ((jfm, tfm), (tfm, jfm)):
        p = str(tmp_path / f"{writer.__name__}.npz")
        writer.save(p, ji if writer is jfm else ti)
        same(ti if reader is tfm else ji, reader.load(p), "save / load")


@pytest.mark.parametrize("reader", ["native", "python", "adaptor"])
def test_fastq_batches_of_testdata(reader, monkeypatch):
    jc, tc = _cfgs("small")
    if reader == "native":
        jb = list(jfastq.batch_reads_native(FASTQ, jc))
        tb = list(tfastq.batch_reads_native(FASTQ, tc))
    elif reader == "python":
        jb = list(jfastq.batch_reads(jfastq.iter_fastq(FASTQ, jc), jc))
        tb = list(tfastq.batch_reads(tfastq.iter_fastq(FASTQ, tc), tc))
    else:
        ad = "ACGTAC"
        jb = list(jfastq.batch_reads(jfastq.apply_adaptor_trim(
            jfastq.iter_fastq(FASTQ, jc), jc, ad), jc))
        tb = list(tfastq.batch_reads(tfastq.apply_adaptor_trim(
            tfastq.iter_fastq(FASTQ, tc), tc, ad), tc))
        code = jpacking.encode(ad)
        same([jfastq.trim_adaptor_batch(b, code) for b in jb],
             [tfastq.trim_adaptor_batch(b, code) for b in tb], "trim batch")
    assert sum(b.n for b in tb) == 200 and len(tb) == 7
    same(jb, tb, "batches")
    same([b.pwm_q for b in jb], [b.pwm_q for b in tb], "pwm_q")
    same(jfastq.read_fasta(FASTA), tfastq.read_fasta(FASTA), "read_fasta")


def test_fastq_other_formats(tmp_path):
    jc, tc = _cfgs("small")
    rng = np.random.default_rng(7)
    prb = tmp_path / "s_1_prb.txt"
    with open(prb, "w") as f:
        for _ in range(5):
            f.write("\t".join(" ".join(str(int(x)) for x in rng.integers(
                -40, 41, 4)) for _ in range(20)) + "\n")
    same(list(jfastq.iter_prb(str(prb), jc)), list(tfastq.iter_prb(str(prb),
                                                                   tc)), "prb")
    intf = tmp_path / "s_1_int.txt"
    with open(intf, "w") as f:
        for k in range(5):
            f.write(f"1\t{k}\t10\t20\t" + "\t".join(
                " ".join(f"{x:.1f}" for x in rng.random(4) * 1000)
                for _ in range(20)) + "\n")
    same(list(jfastq.iter_int(str(intf), jc)), list(tfastq.iter_int(str(intf),
                                                                    tc)), "int")
    fa = tmp_path / "reads.fa"
    jsim.write_fasta(str(fa), [(f"r{k}", "ACGTTGCAAC" * 3) for k in range(4)])
    same(list(jfastq.iter_fasta_reads(str(fa), jc)),
         list(tfastq.iter_fasta_reads(str(fa), tc)), "fasta reads")


def test_sam_bytes(tmp_path):
    rng = np.random.default_rng(8)
    out = []
    for mod in (jsam, tsam):
        f = io.StringIO()
        mod.write_header(f, ["chrA", "chrB"], [12_000, 8_000], cmd="x y")
        rows = [mod.record("q%d" % k, 16 * (k % 2), "chrA", 100 + k,
                           mod.mapq_from_weight(wt), "36M", "ACGT" * 9,
                           "I" * 36, 9_000_000 + k, wt)
                for k, wt in enumerate((1.0, 0.5, 0.25, 1e-9, 0.999999,
                                        1.0 - 1e-13))]
        rows.append(mod.unmapped_record("q9", "ACGT", "IIII"))
        out.append((f.getvalue(), rows))
    same(out[0], out[1], "sam text")
    # sort_sam_file: the same shuffled file sorts to the same bytes
    lines = ["@HD\tVN:1.0\n", "@SQ\tSN:chrA\tLN:12000\n",
             "@SQ\tSN:chrB\tLN:8000\n"]
    recs = [f"q{k}\t0\t{'chrB' if k % 3 else 'chrA'}\t{int(p)}\t9\t4M\t*\t0"
            f"\t0\tACGT\tIIII\n" for k, p in enumerate(rng.integers(1, 7000,
                                                                    60))]
    recs.append("qu\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")
    got = []
    for name, mod in (("j.sam", jsam), ("t.sam", tsam)):
        path = tmp_path / name
        path.write_text("".join(lines + recs))
        mod.sort_sam_file(str(path), ["chrA", "chrB"])
        got.append(path.read_text())
    same(got[0], got[1], "sorted sam")
    assert got[0] != "".join(lines + recs)


@pytest.mark.parametrize("native", [True, False])
def test_sgr_bytes(genome20k, native, monkeypatch):
    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    rng = np.random.default_rng(9)
    jg = jbuilder.Genome.from_contigs(genome20k)
    tg = to_port(jg)
    G = len(jg.codes)
    cov = rng.random(G) * (rng.random(G) < 0.3)
    tal = rng.random((G, 4)) * cov[:, None]
    pv = jsnp.snp_pvalues(jg.codes, cov, tal)
    same(pv, tsnp.snp_pvalues(tg.codes, cov, tal), "snp_pvalues")
    same(jsnp.call_snps(jg.codes, cov, tal), tsnp.call_snps(tg.codes, cov,
                                                            tal), "call_snps")
    texts = []
    for mod, g in ((jsgr, jg), (tsgr, tg)):
        f, fx = io.StringIO(), io.StringIO()
        mod.write_sgr(f, g, cov, 1e-6)
        mod.write_sgrex(fx, g, cov, tal, pv, 1e-6)
        texts.append((f.getvalue(), fx.getvalue()))
    same(texts[0], texts[1], "sgr and sgrex text")
    assert texts[0][0].count("\n") > 5000


@pytest.mark.parametrize("name", ["default", "narrow_band", "widest_band",
                                  "unbanded", "harsh"])
def test_oracle_nw_align(name):
    """Banded and unbanded, with and without the traceback."""
    jc = dataclasses.replace(_cfgs(name)[0], max_read_len=36)
    tc = to_port(jc)
    rng = np.random.default_rng(10)
    W = jc.window_width()
    for k in range(12):
        L = int(rng.integers(1, 37))
        window = rng.integers(0, 5, W).astype(np.int8)
        codes = window[9:9 + L].copy() if k % 2 else rng.integers(
            0, 4, L).astype(np.int8)
        codes[codes == 4] = 0
        if k % 4 == 1 and L > 8:
            codes = np.delete(codes, 5)
        pq = jpwm.pwm_from_calls(codes, rng.integers(5, 41, len(codes)))
        emis = jscoring.emission_int(pq, jscoring.normal_matrix(jc))
        same(joracle.nw_align(emis, window, jc),
             toracle.nw_align(emis, window, tc), "score")
        same(joracle.nw_align(emis, window, jc, traceback=True),
             toracle.nw_align(emis, window, tc, traceback=True), "traceback")


@pytest.mark.parametrize("mode", ["normal", "bisulfite"])
def test_oracle_map_read(phix_genome, mode):
    kw = dict(mer_size=8, seed_jump=4, max_read_len=40,
              bisulfite=mode == "bisulfite")
    jc, tc = jconfig.MapperConfig(**kw), tconfig.MapperConfig(**kw)
    jgen = joracle.OracleGenome.from_contigs([("phiX_sim", phix_genome)])
    tgen = toracle.OracleGenome.from_contigs([("phiX_sim", phix_genome)])
    same(jgen, tgen, "oracle genome")
    same(jgen.window(-5, 30), tgen.window(-5, 30), "window")
    if mode == "bisulfite":
        jidx = joracle.build_oracle_bs_indexes(jgen, jc)
        tidx = toracle.build_oracle_bs_indexes(tgen, tc)
    else:
        jidx = joracle.build_oracle_index(jgen, jc)
        tidx = toracle.build_oracle_index(tgen, tc)
    same(jidx, tidx, "oracle index")
    reads = jsim.simulate_reads(phix_genome, 6, 36, seed=11, sub_rate=0.03,
                                indel_rate=0.2, contig="phiX_sim",
                                bisulfite=mode == "bisulfite")
    G = len(jgen.codes)
    cov = [np.zeros(G), np.zeros(G)]
    tal = [np.zeros((G, 4)), np.zeros((G, 4))]
    for r in reads:
        codes = jpacking.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int32) - 33
        pq = jpwm.pwm_from_calls(codes, q)
        jh = joracle.map_read(codes, pq, jgen, jidx, jc)
        th = toracle.map_read(codes, pq, tgen, tidx, tc)
        same(jh, th, "hits")
        joracle.accumulate(jh, codes, pq, cov[0], tal[0], jc)
        toracle.accumulate(th, codes, pq, cov[1], tal[1], tc)
    same(cov[0], cov[1], "coverage")
    same(tal[0], tal[1], "tallies")
    assert cov[0].sum() > 100


def test_sim():
    same(jsim.PHIX_LEN, tsim.PHIX_LEN, "PHIX_LEN")
    g = jsim.random_genome(5000, seed=3, repeat_frac=0.1, repeat_unit=70)
    same(g, tsim.random_genome(5000, seed=3, repeat_frac=0.1, repeat_unit=70),
         "random_genome")
    jf = jsim.random_genome_families(30_000, seed=4, n_families=3, copies=5,
                                     unit_len=200)
    same(jf, tsim.random_genome_families(30_000, seed=4, n_families=3,
                                         copies=5, unit_len=200), "families")
    starts = np.concatenate(jf[1])
    for kw in (dict(sub_rate=0.02), dict(sub_rate=0.01, indel_rate=0.3),
               dict(bisulfite=True), dict(positions=starts)):
        jr = jsim.simulate_reads(jf[0], 25, 50, seed=6, contig="c", **kw)
        tr = tsim.simulate_reads(jf[0], 25, 50, seed=6, contig="c", **kw)
        same(jr, tr, f"reads {sorted(kw)}")
        same([jsim.parse_truth(r.name) for r in jr],
             [tsim.parse_truth(r.name) for r in tr], "parse_truth")


def test_sim_writers(tmp_path):
    reads = jsim.simulate_reads(jsim.random_genome(800, seed=1), 9, 30,
                                seed=2, contig="c")
    for name, mod, rs in (("j", jsim, reads), ("t", tsim, to_port(reads))):
        mod.write_fasta(str(tmp_path / (name + ".fa")), [("c", "ACGT" * 50)])
        mod.write_fastq(str(tmp_path / (name + ".fq")), rs)
    for ext in (".fa", ".fq"):
        same((tmp_path / ("j" + ext)).read_bytes(),
             (tmp_path / ("t" + ext)).read_bytes(), ext)


@pytest.fixture
def native_libs():
    """Both packages' native host libraries, built at first use; a machine
    without a C++ compiler has neither and skips the comparison."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("native host library unavailable (no C++ compiler)")


def test_native_library_is_built_from_the_ports_sources(native_libs):
    """The port's host library comes from gnumap_tpu_torch/native/*.cpp,
    compiled into gnumap_tpu_torch/_build/, not from the JAX package."""
    so = _build.build_host()
    assert so == _build.HOST_SO and os.path.exists(so)
    assert os.path.dirname(so) == _build.BUILD_DIR
    srcs = sorted(os.path.basename(s) for s in _build._host_sources())
    assert srcs == ["fastio.cpp", "host_finish.cpp", "samfmt.cpp",
                    "suffix.cpp"]
    assert tnative.get_lib()._name == so


def test_native_build_without_compiler_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "HOST_SO", str(tmp_path / "libx.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert _build.build_host() is None
    assert "no C++ compiler" in _build.BUILD_LOG["gnumap_host"]


def _hit_inputs(rng, cfg, B, H, G):
    genome = rng.integers(0, 5, G).astype(np.int8)
    L = cfg.max_read_len
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    codes = np.zeros((B, L), np.int8)
    start = rng.integers(0, G - L, B)
    for b in range(B):
        seq = genome[start[b]:start[b] + lens[b]].copy()
        seq[seq == 4] = 0
        if b % 3 == 0:
            seq = np.delete(seq, 4)
            lens[b] -= 1
        codes[b, :lens[b]] = seq
    pw = jpwm.pwm_rows_from_table(codes, rng.integers(5, 41, (B, L)))
    pw = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None], pw,
                  0).astype(np.int32)
    read_idx = rng.integers(0, B, H).astype(np.int32)
    strand = rng.integers(0, 2, H).astype(np.int8)
    cand = (start[read_idx] + rng.integers(-2, 3, H)).astype(np.int32)
    cand[:3] = (-5, G - 3, 0)
    return genome, pw, lens, read_idx, strand, cand


@pytest.mark.parametrize("name", ["default", "narrow_band", "unbanded",
                                  "harsh", "bisulfite"])
def test_native_finish_hits_and_traceback(name, native_libs):
    jc = dataclasses.replace(_cfgs(name)[0], max_read_len=40)
    rng = np.random.default_rng(12)
    genome, pw, lens, read_idx, strand, cand = _hit_inputs(rng, jc, 9, 40,
                                                           3000)
    Sp, Sm = jscoring.matrices_for_mode(jc)
    args = (pw, lens, genome, Sp, Sm, read_idx, strand, cand,
            jc.max_read_len, jc.window_width(), jc.gap_slack,
            jc.gap_open_q(), jc.gap_extend_q(), jconfig.NEG_INF)
    for threads in (1, 3):
        same(jnative.finish_hits(*args, band=jc.band(), n_threads=threads),
             tnative.finish_hits(*args, band=jc.band(), n_threads=threads),
             "finish_hits")
    emis = jnative.emission_int(pw[1], Sp)
    same(emis, tnative.emission_int(pw[1], Sp), "emission_int")
    same(emis, tscoring.emission_int(pw[1], Sp), "emission_int vs numpy")
    window = genome[100:100 + jc.window_width()]
    targs = (emis[:lens[1]], window, jc.gap_open_q(), jc.gap_extend_q(),
             jconfig.NEG_INF)
    got = tnative.nw_traceback(*targs, band=jc.band())
    same(jnative.nw_traceback(*targs, band=jc.band()), got, "nw_traceback")
    same(toracle.nw_align(emis[:lens[1]], window, to_port(jc),
                          traceback=True), got, "nw_traceback vs oracle")


def test_native_sam_formatter(native_libs):
    rng = np.random.default_rng(13)
    B, L, Nh = 6, 30, 9
    codes = rng.integers(0, 5, (B, L)).astype(np.int8)
    quals = rng.integers(0, 41, (B, L)).astype(np.int16)
    lens = rng.integers(10, L + 1, B).astype(np.int32)
    names = [f"read_{k}/1" for k in range(B)]
    rnames = ["chrA", "a_much_longer_contig_name"]
    hit_read = np.sort(rng.integers(0, B - 1, Nh)).astype(np.int32)
    cigars = ["", "10M2D5M", "3M1I20M"] * 3
    args = (codes, quals, lens, names, rnames, hit_read,
            rng.choice([0, 16, 256, 272], Nh).astype(np.int32),
            rng.integers(0, 2, Nh).astype(np.int32),
            rng.integers(0, 10_000, Nh).astype(np.int64),
            rng.integers(0, 61, Nh).astype(np.int32), cigars,
            rng.integers(0, 2 ** 24, Nh).astype(np.int32), rng.random(Nh),
            rng.random(Nh), np.isin(np.arange(B), hit_read, invert=True))
    got = tnative.format_sam_batch(*args)
    same(jnative.format_sam_batch(*args), got, "format_sam_batch")
    assert got.count(b"\n") == Nh + 1
    skip = np.arange(B) % 2 == 0
    same(jnative.format_sam_batch(*args, skip=skip),
         tnative.format_sam_batch(*args, skip=skip), "format_sam_batch skip")
    pos = np.sort(rng.integers(1, 9000, 50)).astype(np.int64)
    val = rng.random(50) * 10.0 ** rng.integers(-6, 3, 50)
    same(jnative.format_sgr("chrA", pos, val),
         tnative.format_sgr("chrA", pos, val), "format_sgr")


def _sam_inputs(rng, names, rnames, xs_scale=1.0):
    """A batch for format_sam_batch: reads with N bases, forward and
    reverse hits with pure and gapped CIGARs, an unmapped read last."""
    B, L = len(names), 24
    codes = rng.integers(0, 5, (B, L)).astype(np.int8)
    quals = rng.integers(0, 41, (B, L)).astype(np.int16)
    lens = rng.integers(10, L + 1, B).astype(np.int32)
    hit_read = np.repeat(np.arange(B - 1), 2).astype(np.int32)
    Nh = len(hit_read)
    score = rng.integers(-50, 2 ** 20, Nh).astype(np.int32)
    return dict(
        codes=codes, quals=quals, lens=lens, names=names, rnames=rnames,
        hit_read=hit_read,
        hit_flag=np.array([0, 16, 272, 256] * B, np.int32)[:Nh],
        hit_rname=(np.arange(Nh) % len(rnames)).astype(np.int32),
        hit_pos=rng.integers(0, 10_000, Nh).astype(np.int64),
        hit_mapq=rng.integers(0, 61, Nh).astype(np.int32),
        cigars=["", "3M1I5M"] * (Nh // 2),
        hit_score=score,
        hit_xs=score / float(tconfig.SCORE_ONE) * xs_scale,
        hit_weight=rng.random(Nh),
        unmapped=(np.arange(B) == B - 1).astype(np.uint8))


def _python_sam(a):
    """The port's Python SAM writer (io/sam.py record / unmapped_record,
    as map_stream calls them) on _sam_inputs' batch, as one str."""
    out = []
    for b, name in enumerate(a["names"]):
        L = int(a["lens"][b])
        c = a["codes"][b, :L]
        seq = tpacking.decode(c)
        qual = (a["quals"][b, :L] + 33).astype(np.uint8).tobytes().decode()
        if a["unmapped"][b]:
            out.append(tsam.unmapped_record(name, seq, qual))
            continue
        for h in np.nonzero(a["hit_read"] == b)[0]:
            flag = int(a["hit_flag"][h])
            oseq, oqual = ((tpacking.decode(tpacking.revcomp(c)), qual[::-1])
                           if flag & 16 else (seq, qual))
            out.append(tsam.record(
                name, flag, a["rnames"][a["hit_rname"][h]],
                int(a["hit_pos"][h]), int(a["hit_mapq"][h]),
                a["cigars"][h] or f"{L}M", oseq, oqual,
                int(a["hit_score"][h]), float(a["hit_weight"][h])))
    return "".join(out)


def test_native_sam_formatter_non_ascii_names(native_libs):
    """ROADMAP C.2, a deliberate difference from the JAX package: a qname
    or contig name outside ASCII is written by the port's native formatter
    exactly as by its Python SAM writer, encoded as UTF-8 (name offsets
    count bytes, so every name after the first non-ASCII one lands where it
    belongs).  The JAX package's native path still encodes names as ASCII
    and raises UnicodeEncodeError on such a batch."""
    rng = np.random.default_rng(21)
    names = ["r\u00e9ad_1", "read_2", "\u540d\u524d_3", "read_4/1",
             "\u00fc_5"]
    for rnames in (["chrA", "a_much_longer_contig_name"],
                   ["chr\u00c4", "\u67d3\u8272\u4f53_2"]):
        a = _sam_inputs(rng, names, rnames)
        got = tnative.format_sam_batch(**a)
        assert got == _python_sam(a).encode("utf-8")
        assert got.count(b"\n") == len(a["hit_read"]) + 1
        with pytest.raises(UnicodeEncodeError):
            jnative.format_sam_batch(**a)
    ascii_case = _sam_inputs(rng, ["a", "b", "c"], ["chrA"])
    same(jnative.format_sam_batch(**ascii_case),
         tnative.format_sam_batch(**ascii_case), "ASCII bytes unchanged")


def test_native_sam_formatter_never_writes_past_its_capacity(native_libs):
    """ROADMAP C.2: every snprintf's return is checked.  A record whose
    XS / XP tail does not fit what is left of the buffer makes the
    formatter return -1 (the wrapper raises) and leaves every byte past
    the capacity untouched, at every capacity below the output's length;
    with room to spare it writes the whole batch.  The same holds for the
    SGR formatter."""
    import ctypes
    rng = np.random.default_rng(22)
    # XS values of ~300 digits: the tail outgrows the per-record margin
    a = _sam_inputs(rng, [f"q{k}" for k in range(10)], ["chrA"],
                    xs_scale=1e300)
    with pytest.raises(RuntimeError, match="capacity"):
        tnative.format_sam_batch(**a)
    args, _ = tnative._sam_batch_args(**a)
    lib, guard = tnative.get_lib(), 512

    def call(cap):
        buf = ctypes.create_string_buffer(b"\x5a" * (cap + guard),
                                          cap + guard)
        n = lib.format_sam_batch(*tnative._c_args(args), buf, cap)
        assert buf.raw[cap:] == b"\x5a" * guard, cap
        return buf.raw[:n] if n >= 0 else None

    want = call(1 << 16)
    assert want.count(b"\n") == len(a["hit_read"]) + 1
    for cap in [*range(0, len(want), 7), len(want) - 1]:
        assert call(cap) is None, cap
    with pytest.raises(RuntimeError, match="capacity"):
        tnative.format_sgr("chrA", np.array([7], np.int64),
                           np.array([1e300]))
    assert tnative.format_sgr("chrA", np.array([7], np.int64),
                              np.array([2.5])) == b"chrA\t7\t2.5000\n"


def _float_values():
    """XS:f / XP:f values for the exact float path: ties to even at four
    and six decimals, zeros, the smallest subnormal, either side of 1e9
    (just under it rounds up to 1000000000), the snprintf fallback's NaN
    and infinities, and 10,000 doubles of random exponents."""
    rng = np.random.default_rng(27)
    below = np.nextafter(1e9, 0.0)
    special = [0.03125, -0.03125, 1.03125, 0.0078125, 0.5078125, -0.0,
               0.0, 1.0, 0.99999995, 5e-324, -5e-324, 0.00005, 0.0000005,
               999999999.99995, below, -below, 1e9, -1e9,
               np.nextafter(1e9, 2e9), float("nan"), float("inf"),
               float("-inf")]
    rand = (np.ldexp(1.0 + rng.random(10_000), rng.integers(-60, 46, 10_000))
            * rng.choice([-1.0, 1.0], 10_000))
    return np.concatenate([special, rand])


@pytest.mark.parametrize("field,prec", [("XS", 4), ("XP", 6)])
def test_native_sam_float_fields_equal_python(field, prec, native_libs):
    """The native formatter's XS:f (four decimals) and XP:f (six) equal
    Python's format(x, '.4f') / format(x, '.6f') on every value: the
    integer path for finite |x| < 1e9, snprintf for the rest, which the
    formatter counts.  One hit a read, through the real C call."""
    x = _float_values()
    n = len(x)
    other = np.full(n, 0.5)
    view, n_slow = tnative.format_sam_batch_view(
        np.zeros((n, 4), np.int8), np.zeros((n, 4), np.int16),
        np.full(n, 4, np.int32), ["r"] * n, ["c"],
        np.arange(n, dtype=np.int32), np.zeros(n, np.int32),
        np.zeros(n, np.int32), np.zeros(n, np.int64), np.zeros(n, np.int32),
        [""] * n, np.zeros(n, np.int32), x if field == "XS" else other,
        x if field == "XP" else other, np.zeros(n, np.uint8))
    lines = bytes(view).decode().splitlines()
    assert len(lines) == n
    col = -2 if field == "XS" else -1
    got = [line.split("\t")[col] for line in lines]
    want = [f"{field}:f:" + format(v, f".{prec}f") for v in x.tolist()]
    assert got == want
    assert n_slow == int((~(np.abs(x) < 1e9)).sum()) > 0
    assert got[14] == f"{field}:f:1000000000." + "0" * prec


def _multimap_inputs(rng, B):
    """format_sam_batch's arguments for a batch of multi-map shape: every
    fourth read has 20 hits (its first primary, the rest flag 256), the
    others one; both strands; weights a read's scores over
    their sum, as the posterior gives them."""
    L = 100
    per = np.where(np.arange(B) % 4 == 0, 20, 1)
    hit_read = np.repeat(np.arange(B), per).astype(np.int32)
    Nh = len(hit_read)
    first = np.r_[True, hit_read[1:] != hit_read[:-1]]
    score = rng.integers(tconfig.SCORE_ONE // 2, tconfig.SCORE_ONE,
                         Nh).astype(np.int32)
    weight = score / np.bincount(hit_read, score)[hit_read]
    return dict(
        codes=rng.integers(0, 5, (B, L)).astype(np.int8),
        quals=rng.integers(2, 41, (B, L)).astype(np.int16),
        lens=np.full(B, L, np.int32),
        names=[f"sim_{b}_multimap_sim_{b * 977}_+" for b in range(B)],
        rnames=["multimap_sim"], hit_read=hit_read,
        hit_flag=(rng.choice([0, 16], Nh) | np.where(first, 0, 256)
                  ).astype(np.int32),
        hit_rname=np.zeros(Nh, np.int32),
        hit_pos=rng.integers(0, 46_000_000, Nh).astype(np.int64),
        hit_mapq=np.zeros(Nh, np.int32), cigars=[""] * Nh,
        hit_score=score, hit_xs=score / float(tconfig.SCORE_ONE),
        hit_weight=weight, unmapped=np.zeros(B, np.uint8))


def test_native_sam_output_buffer_is_reused_without_stale_bytes(
        native_libs):
    """The formatter writes into one per-thread buffer that is never
    zero-filled: a first batch makes it, a larger one grows it, a smaller
    one reuses it, and every batch's bytes are its own, equal to the JAX
    package's snprintf formatter and to the bytes format_sam_batch
    copies out.  The larger batch has the multi-map shape: 20 hits on a
    quarter of the reads, forward and reverse."""
    rng = np.random.default_rng(28)
    batches = [_sam_inputs(rng, [f"q{k}" for k in range(6)], ["chrA"]),
               _multimap_inputs(rng, 64),
               _sam_inputs(rng, [f"read_{k}" for k in range(4)],
                           ["chrA", "chrB"])]
    tnative._out.__dict__.pop("buf", None)
    bufs = []
    for a in batches:
        view, n_slow = tnative.format_sam_batch_view(**a)
        got = bytes(view)
        bufs.append(tnative._out.buf)
        assert n_slow == 0
        same(jnative.format_sam_batch(**a), got, "format_sam_batch view")
        assert tnative.format_sam_batch(**a) == got
        assert got.count(b"\n") == len(a["hit_read"]) + int(
            a["unmapped"].sum())
    assert bufs[1] is not bufs[0] and bufs[2] is bufs[1]
    assert len(bufs[2]) >= 2 * len(bufs[0])
    assert tnative._sam_batch_args(**batches[1])[1] > len(bufs[0])


def test_native_sam_float_slow_counter(native_libs):
    """The formatter's count of XS:f / XP:f fields written with snprintf:
    0 on ordinary scores and weights, and on the batch of ~300-digit XS
    values every XS field but the zero scores', once the batch fits."""
    import ctypes
    rng = np.random.default_rng(29)
    _, n_slow = tnative.format_sam_batch_view(
        **_sam_inputs(rng, [f"q{k}" for k in range(10)], ["chrA"]))
    assert n_slow == 0
    a = _sam_inputs(rng, [f"q{k}" for k in range(10)], ["chrA"],
                    xs_scale=1e300)
    args, _ = tnative._sam_batch_args(**a)
    buf = ctypes.create_string_buffer(1 << 16)
    assert tnative.get_lib().format_sam_batch(
        *tnative._c_args(args), buf, 1 << 16) > 0
    assert int(args[-1][0]) == int((a["hit_score"] != 0).sum()) > 0


@pytest.mark.parametrize("final", [True, False])
def test_native_fastq_parser(final, native_libs):
    with open(FASTQ, "rb") as f:
        chunk = f.read()
    if not final:
        chunk = chunk[:len(chunk) // 2 + 17]
    for max_reads, max_len in ((64, 40), (500, 30)):
        same(jnative.parse_fastq_chunk(chunk, max_reads, max_len, 33, final),
             tnative.parse_fastq_chunk(chunk, max_reads, max_len, 33, final),
             "parse_fastq_chunk")


def test_native_scatters_index_and_suffix_array(native_libs):
    rng = np.random.default_rng(14)
    G, H, B, L = 4000, 60, 8, 24
    codes = rng.integers(0, 5, G).astype(np.int8)
    same(jnative.build_csr_index(codes, 6), tnative.build_csr_index(codes, 6),
         "build_csr_index")
    same(jnative.suffix_array(codes[:700]), tnative.suffix_array(codes[:700]),
         "suffix_array")
    pos = rng.integers(0, G - 40, H)
    rl = rng.integers(10, 40, H)
    w = rng.random(H)
    cov = [rng.random(G), None]
    cov[1] = cov[0].copy()
    jnative.scatter_coverage(cov[0], pos, rl, w)
    tnative.scatter_coverage(cov[1], pos, rl, w)
    same(cov[0], cov[1], "scatter_coverage")
    pw = jpwm.pwm_rows_from_table(rng.integers(0, 4, (B, L)).astype(np.int8),
                                  rng.integers(5, 41, (B, L))).astype(np.int32)
    lens = rng.integers(12, L + 1, B).astype(np.int32)
    b_idx = rng.integers(0, B, H).astype(np.int32)
    cigars = [("" if k % 3 else f"5M1D{lens[b_idx[k]] - 6}M1I")
              for k in range(H)]
    tal = [np.zeros((G, 4)), np.zeros((G, 4))]
    for mod, t in ((jnative, tal[0]), (tnative, tal[1])):
        mod.scatter_tallies(t, pw, lens, b_idx, rng.integers(
            0, 2, H).astype(np.int8) * 0 + (np.arange(H) % 2).astype(np.int8),
            pos, w, cigars, float(jconfig.PWM_SCALE))
    same(tal[0], tal[1], "scatter_tallies")
    assert tal[0].sum() > 0


MULTIHOST_COPIES = ("strided", "_next_record_start", "fastq_ranges",
                    "shard_paths", "write_shard_index", "merge_sam_shards")


@pytest.mark.parametrize("name", MULTIHOST_COPIES)
def test_multihost_host_functions_are_copies(name):
    """dist/multihost.py's host-only functions are the JAX package's,
    line for line (its process group, barrier and allreduce_f64 are the
    torch.distributed port: tests/test_torch_multihost.py)."""
    import inspect
    from gnumap_tpu.dist import multihost as jmh
    from gnumap_tpu_torch.dist import multihost as tmh
    assert inspect.getsource(getattr(tmh, name)) == \
        inspect.getsource(getattr(jmh, name))


def test_multihost_partitions_and_merges(tmp_path):
    """The copies at work: equal byte ranges of the test FASTQ for 1-5
    hosts, equal batch strides, and equal merged SAM bytes from the same
    per-host shards, span-indexed and per-record (genome-partitioned), with
    the shards removed afterwards.  The per-record rows rise within each
    host, as the CLI writes them: the port's streaming merge refuses rows
    that do not (test_gp_merge_refuses_rows_out_of_order)."""
    from gnumap_tpu.dist import multihost as jmh
    from gnumap_tpu_torch.dist import multihost as tmh
    for n in range(1, 6):
        rj = jmh.fastq_ranges(FASTQ, n)
        same(rj, tmh.fastq_ranges(FASTQ, n), f"fastq_ranges {n}")
        assert rj[0][0] == 0 and rj[-1][1] == os.path.getsize(FASTQ)
        same(list(jmh.strided(range(11), n, n - 1)),
             list(tmh.strided(range(11), n, n - 1)), f"strided {n}")
    lines = [[f"r{h}_{i}\t0\tchr\t{i}\n" for i in range(5)] for h in (0, 1)]
    for mod in (jmh, tmh):
        for mode in ("spans", "gp"):
            out = str(tmp_path / f"{mod.__name__.split('.')[0]}_{mode}")
            for h in (0, 1):
                body, idx = mod.shard_paths(out, h)
                with open(body, "w") as f:
                    f.writelines(lines[h])
                if mode == "spans":
                    rows, off = [], 0
                    for i, ln in enumerate(lines[h]):
                        rows.append((2 * i + h, 0, off, off + len(ln)))
                        off += len(ln)
                else:
                    rows = [(i // 2, i % 2, 2 * i + h) for i in range(5)]
                mod.write_shard_index(idx, rows)
            merge = (mod.merge_sam_shards if mode == "spans"
                     else mod.merge_sam_shards_gp)
            merge(out, 2, "@HD\tVN:1.6\n")
            assert not any(os.path.exists(p) for h in (0, 1)
                           for p in mod.shard_paths(out, h))
    for mode in ("spans", "gp"):
        same((tmp_path / f"gnumap_tpu_{mode}.sam").read_bytes(),
             (tmp_path / f"gnumap_tpu_torch_{mode}.sam").read_bytes(), mode)


def _gp_shards(mod, out, rows_per_host):
    """Genome-partitioned shards as the CLI writes them: a record line and
    a (batch, read, key) index row each, in the host's own order."""
    for h, rows in enumerate(rows_per_host):
        body, idx = mod.shard_paths(out, h)
        with open(body, "w") as f:
            f.writelines(f"r{rd}_b{bt}\t{key}\th{h}\t\u00e9\n"
                         for bt, rd, key in rows)
        mod.write_shard_index(idx, rows)


def _gp_rows(rng, num_hosts, n_batches=4, n_reads=9):
    """Per-host rows in the writer's order: reads ascending in each batch,
    a read's keys (2 * pos + strand) ascending, coordinates partitioned
    across hosts (host h owns keys = h mod num_hosts), key -1 for the
    unmapped record host 0 writes."""
    rows = [[] for _ in range(num_hosts)]
    for bt in range(n_batches):
        for rd in range(n_reads):
            keys = np.sort(rng.choice(400, rng.integers(0, 5),
                                      replace=False))
            if not len(keys):
                rows[0].append((bt, rd, -1))
            for k in keys.tolist():
                rows[k % num_hosts].append((bt, rd, k))
    return rows


@pytest.mark.parametrize("num_hosts", [2, 3, 4])
def test_gp_merge_streams_equal_to_jax(num_hosts, tmp_path):
    """ROADMAP C.3: the port's merge_sam_shards_gp is a streaming k-way
    merge (heapq.merge over each host's records, shard and index read line
    by line together); on shards in the writer's order its bytes equal the
    JAX merge's (which loads every shard whole and sorts), and it removes
    the shards afterwards."""
    from gnumap_tpu.dist import multihost as jmh
    from gnumap_tpu_torch.dist import multihost as tmh
    rows = _gp_rows(np.random.default_rng(30 + num_hosts), num_hosts)
    assert all(rows)
    got = {}
    for mod in (jmh, tmh):
        out = str(tmp_path / mod.__name__.split(".")[0])
        _gp_shards(mod, out, rows)
        mod.merge_sam_shards_gp(out, num_hosts, "@HD\tVN:1.6\n")
        assert not any(os.path.exists(p) for h in range(num_hosts)
                       for p in mod.shard_paths(out, h))
        with open(out + ".sam", "rb") as f:
            got[mod.__name__] = f.read()
    same(got["gnumap_tpu.dist.multihost"],
         got["gnumap_tpu_torch.dist.multihost"], "merged bytes")
    body = got["gnumap_tpu_torch.dist.multihost"].split(b"\n")[1:-1]
    assert len(body) == sum(len(r) for r in rows)


@pytest.mark.parametrize("fault", ["falls", "repeats", "short_index"])
def test_gp_merge_refuses_rows_out_of_order(fault, tmp_path):
    """ROADMAP C.3: a host whose index rows fall or repeat, or whose index
    and shard differ in length, makes the merge raise RuntimeError naming
    the host and the line, never emit records out of order; the shards
    stay for inspection."""
    from gnumap_tpu_torch.dist import multihost as tmh
    rows = _gp_rows(np.random.default_rng(40), 2)
    bad = list(rows[1])
    if fault == "falls":
        bad[3], bad[4] = bad[4], bad[3]
        where = "line 5"
    elif fault == "repeats":
        bad[4] = bad[3]
        where = "line 5"
    out = str(tmp_path / "gp")
    _gp_shards(tmh, out, [rows[0], bad])
    if fault == "short_index":
        tmh.write_shard_index(tmh.shard_paths(out, 1)[1], bad[:-1])
        where = f"line {len(bad)}"
    with pytest.raises(RuntimeError, match=f"gp shard 1: .*{where}"):
        tmh.merge_sam_shards_gp(out, 2, "@HD\tVN:1.6\n")
    assert all(os.path.exists(p) for h in (0, 1)
               for p in tmh.shard_paths(out, h))
