"""The batch's hit table (gnumap_tpu_torch/pipeline/mapper.py BatchHits)
held to the per-read ReadHit lists it replaced, on the CPU.

``decode_tb_blob`` gives, field for field and bit for bit, what the list
decode gave (``_decode_lists`` below, the loop it replaced) on synthetic
device blobs: ties in score, both strands, gapped hits, unmapped reads,
padding rows, an empty batch, capacity overflow.  The native SAM writer
gives the same bytes from the table, from lists, through the list
formatter it replaced and through io/sam.py; the coverage and tally
scatters give the same bits from the table as from the rows they took
before.  Decoding and formatting a batch leaves a number of tracked
objects that does not grow with its hits, and a device-finish stream with
SAM builds no ReadHit list.
"""

import gc
import io
import os

import numpy as np
import pytest
import torch

from gnumap_tpu_torch.config import PWM_SCALE, SCORE_ONE, MapperConfig
from gnumap_tpu_torch.index import builder
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.align import nw_tb
from gnumap_tpu_torch.native import lib as native_lib
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.utils import profiling, sim

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FA = os.path.join(ROOT, "testdata", "phix_sim.fa")
FQ = os.path.join(ROOT, "testdata", "phix_sim_200.fastq")
L = 40


@pytest.fixture(scope="module")
def native():
    if not native_lib.available():
        pytest.skip("native host library unavailable (no C++ compiler)")


# ---------------------------------------------------------------------------
# the list versions the table replaced, kept as references
# ---------------------------------------------------------------------------

def _decode_lists(cfg, B, n, lens_np, blob):
    """decode_tb_blob as it was: one ReadHit a hit."""
    C = cfg.max_candidates
    H = cfg.hit_capacity * 2 * B
    K = max(64, H // 32)
    meta_all = blob[:4 * H].reshape(H, 4)
    n_keep, n_valid, n_indel = int(blob[-3]), int(blob[-2]), int(blob[-1])
    if n_keep > H or n_indel > K:
        return None
    meta = meta_all[:n_keep]
    ops_c = np.ascontiguousarray(
        blob[4 * H:-3].reshape(K, -1)).view(np.uint16)
    flat_idx = meta[:, 0] & ((1 << 21) - 1)
    jfin = (meta[:, 0] >> 21) & 0xFF
    rows = flat_idx // C
    b_idx = rows % B
    minus = (rows >= B).astype(np.int8)
    pos = cfg.window_start(meta[:, 1]) + jfin
    lens_h = lens_np[b_idx]
    islot = meta[:, 3]
    sc = meta[:, 2]
    out = [[] for _ in range(n)]
    idx = np.nonzero(b_idx < n)[0]
    if len(idx) == 0:
        return out, n_keep, n_valid
    order = idx[np.lexsort((-sc[idx], pos[idx], minus[idx], b_idx[idx]))]
    bo, mo, po = b_idx[order], minus[order], pos[order]
    first = np.empty(len(order), bool)
    first[0] = True
    first[1:] = (bo[1:] != bo[:-1]) | (mo[1:] != mo[:-1]) \
        | (po[1:] != po[:-1])
    winners = order[first]
    totals = np.bincount(b_idx[winners],
                         weights=sc[winners].astype(np.float64),
                         minlength=n)
    emit = winners[np.lexsort((minus[winners], pos[winners],
                               b_idx[winners]))]
    w_emit = sc[emit].astype(np.float64) / totals[b_idx[emit]]
    for j, h in enumerate(emit):
        b = int(b_idx[h])
        Lh = int(lens_h[h])
        if islot[h] >= 0:
            cigar, rl = nw_tb.decode_ops(ops_c[islot[h]], Lh)
        else:
            cigar, rl = f"{Lh}M", Lh
        out[b].append(tm.ReadHit("-" if minus[h] else "+", int(pos[h]),
                                 int(sc[h]), float(w_emit[j]), cigar, rl))
    return out, n_keep, n_valid


def _format_lists(gen, batch, hits_per_read, gp=None, host_id=0):
    """format_sam_batch_native as it was: six lists built per hit."""
    n, lens = batch.n, batch.lens
    b_idx, flags, pos_l, cigs, scores, weights = [], [], [], [], [], []
    unmapped = np.zeros(n, np.uint8)
    skip = np.zeros(n, np.uint8) if gp is not None else None
    for b, hits in enumerate(hits_per_read):
        if not hits:
            if gp is not None and (bool(gp["mapped"][b]) or host_id != 0):
                skip[b] = 1
            else:
                unmapped[b] = 1
            continue
        pure = f"{int(lens[b])}M"
        for hi, h in enumerate(hits):
            sec = (hi > 0) if h.primary is None else not h.primary
            b_idx.append(b)
            flags.append((16 if h.strand == "-" else 0)
                         | (256 if sec else 0))
            pos_l.append(h.pos)
            cigs.append("" if h.cigar == pure else h.cigar)
            scores.append(h.score)
            weights.append(h.weight)
    w = np.asarray(weights, np.float64)
    if len(b_idx):
        ci, off = gen.locate(np.asarray(pos_l, np.int64))
        ci, off = np.atleast_1d(ci), np.atleast_1d(off)
        with np.errstate(divide="ignore"):
            mq = np.where(
                w >= 1.0 - 1e-12, 60,
                np.clip(np.round(-10.0 * np.log10(
                    np.maximum(1e-12, 1.0 - w))), 0, 60)).astype(np.int32)
    else:
        ci = off = mq = np.zeros(0, np.int32)
    sc = np.asarray(scores, np.int32)
    return native_lib.format_sam_batch(
        batch.codes[:n], batch.quals[:n], lens[:n], batch.names[:n],
        gen.names, np.asarray(b_idx, np.int32), np.asarray(flags, np.int32),
        ci.astype(np.int32), off.astype(np.int64), mq, cigs, sc,
        sc.astype(np.float64) / SCORE_ONE, w, unmapped,
        skip=skip).decode("utf-8")


def _rows(batch, hits_per_read):
    """The coverage and tally rows map_stream built per hit before."""
    cov, tal = [], []
    for b, hits in enumerate(hits_per_read):
        Lb = int(batch.lens[b])
        for h in hits:
            cov.append((h.pos, h.ref_len, h.weight))
            tal.append((b, h.strand == "-", h.pos, h.weight,
                        None if h.cigar == f"{Lb}M" else h.cigar))
    return cov, tal


def _fields(lists):
    return [[(h.strand, h.pos, h.score, h.weight, h.cigar, h.ref_len,
              h.primary) for h in hits] for hits in lists]


def _types(lists):
    return {tuple(type(v) for v in (h.strand, h.pos, h.score, h.weight,
                                    h.cigar, h.ref_len))
            for hits in lists for h in hits}


# ---------------------------------------------------------------------------
# synthetic device blobs
# ---------------------------------------------------------------------------

def _cfg(hit_capacity=2):
    return MapperConfig(max_read_len=L, max_candidates=4,
                        hit_capacity=hit_capacity)


def _blob(cfg, B, n, n_hits, seed, gapped=0.25, pad_share=0.2,
          n_keep=None, n_indel=None):
    """A device_tb_tail blob of ``n_hits`` kept hits over B rows (reads b
    >= n are padding): anchors and scores from small sets, so reads repeat
    (strand, pos) with equal and unequal scores; a share of the hits carry
    indel ops rows.  Returns (blob, lens)."""
    rng = np.random.default_rng(seed)
    C = cfg.max_candidates
    H = cfg.hit_capacity * 2 * B
    K = max(64, H // 32)
    Wd = nw_tb.ops_width(cfg.max_read_len) // 2
    blob = np.zeros(tm.tb_blob_len(cfg, B), np.int32)
    meta = blob[:4 * H].reshape(H, 4)
    meta[:] = -1
    ops = blob[4 * H:-3].reshape(K, Wd).view(np.uint16)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    n_real = n_hits - int(round(pad_share * n_hits)) if B > n else n_hits
    b = np.concatenate([rng.integers(0, max(n, 1), n_real),
                        rng.integers(n, B, n_hits - n_real)
                        if B > n else np.zeros(0, np.int64)])
    strand = rng.integers(0, 2, n_hits)
    row = b + strand * B
    flat = row * C + rng.integers(0, C, n_hits)
    jfin = rng.integers(0, 12, n_hits)
    cand = 64 * rng.integers(1, 6, n_hits)
    score = rng.choice([5, 9, 9, 12, 30], n_hits)
    islot = np.full(n_hits, -1)
    k = 0
    for h in np.nonzero(rng.random(n_hits) < gapped)[0]:
        if k == K:
            break
        Lh = int(lens[b[h]])
        r = np.zeros(Wd * 2, np.uint16)
        r[:Lh] = ((rng.integers(0, 3, Lh) * (rng.random(Lh) < 0.15)) << 1)
        r[:Lh] |= (rng.random(Lh) < 0.1).astype(np.uint16)
        r[Lh - 1] &= 1                       # no trailing deletion
        ops[k] = r
        islot[h] = k
        k += 1
    meta[:n_hits] = np.stack([flat | (jfin << 21), cand, score, islot], 1)
    blob[-3] = n_hits if n_keep is None else n_keep
    blob[-2] = 3 * n_hits
    blob[-1] = k if n_indel is None else n_indel
    return blob, lens


CASES = {
    # B, n, hits, seed, gapped share
    "ties_both_strands": (16, 12, 30, 1, 0.0),
    "gapped": (16, 16, 28, 2, 0.6),
    "unmapped_and_padding": (32, 20, 12, 3, 0.3),
    "mixed_large": (64, 50, 200, 4, 0.25),
    "no_kept_hit": (8, 8, 0, 5, 0.0),
    "padding_only": (8, 3, 10, 6, 0.2),
    "no_real_read": (8, 0, 6, 7, 0.2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_decode_table_equals_list_decode(name):
    B, n, n_hits, seed, gapped = CASES[name]
    cfg = _cfg()
    pad = 1.0 if name == "padding_only" else 0.2
    blob, lens = _blob(cfg, B, n, n_hits, seed, gapped, pad_share=pad)
    want, keep_w, valid_w = _decode_lists(cfg, B, n, lens, blob)
    table, keep, valid = tm.decode_tb_blob(cfg, B, n, lens, blob)
    assert (keep, valid) == (keep_w, valid_w)
    assert isinstance(table, tm.BatchHits) and len(table) == n
    flat = [h for hits in want for h in hits]
    assert table.read.tolist() == [b for b, hits in enumerate(want)
                                   for _ in hits]
    assert table.counts().tolist() == [len(hits) for hits in want]
    assert table.minus.tolist() == [h.strand == "-" for h in flat]
    assert table.pos.tolist() == [h.pos for h in flat]
    assert table.score.tolist() == [h.score for h in flat]
    assert table.weight.tobytes() == np.asarray(
        [h.weight for h in flat], np.float64).tobytes()
    assert table.ref_len.tolist() == [h.ref_len for h in flat]
    assert table.primary.tolist() == [-1] * len(flat)
    cig = dict(zip(table.cig_idx.tolist(), table.cigars))
    assert [cig.get(i, f"{h.ref_len}M") for i, h in enumerate(flat)] == \
        [h.cigar for h in flat]
    # the lists: built once, by item access, iteration or to_lists
    assert table._lists is None
    c0 = profiling.counters()["hits.lists"]
    got = table.to_lists()
    assert _fields(got) == _fields(want) and _types(got) == _types(want)
    assert [table[b] for b in range(n)] == got == list(table)
    assert table.to_lists() is got
    assert profiling.counters()["hits.lists"] - c0 == 1
    if name == "ties_both_strands":
        assert {h.strand for h in flat} == {"+", "-"}
        assert len(flat) < n_hits       # duplicates were deduped
    if name == "gapped":
        assert any("D" in c or "I" in c for c in table.cigars)
    if name == "unmapped_and_padding":
        assert 0 in table.counts().tolist()


def test_decode_ties_keep_the_first_in_hit_order():
    """Two kept hits of one read at one (strand, pos) with equal scores
    and different CIGARs: the first in hit order wins, as before."""
    cfg = _cfg()
    B = 4
    blob, lens = _blob(cfg, B, B, 2, 8, gapped=0.0, pad_share=0.0)
    H = cfg.hit_capacity * 2 * B
    meta = blob[:4 * H].reshape(H, 4)
    meta[1, :3] = meta[0, :3]
    ops = blob[4 * H:-3].reshape(max(64, H // 32), -1).view(np.uint16)
    ops[1, :4] = [0, 1, 0, 0]                 # an insertion at base 2
    meta[1, 3] = 1
    blob[-1] = 2
    for first, second in ((-1, 1), (1, -1)):
        meta[0, 3], meta[1, 3] = first, second
        table = tm.decode_tb_blob(cfg, B, B, lens, blob)[0]
        want = _decode_lists(cfg, B, B, lens, blob)[0]
        assert _fields(table.to_lists()) == _fields(want)
        assert table.score.tolist() == [int(meta[0, 2])]
        assert (len(table.cigars) == 1) == (first == 1)


@pytest.mark.parametrize("which", ["n_keep", "n_indel"])
def test_decode_overflow_returns_none(which):
    cfg = _cfg()
    B = 8
    H = cfg.hit_capacity * 2 * B
    over = dict(n_keep=H + 1) if which == "n_keep" else \
        dict(n_indel=max(64, H // 32) + 1)
    blob, lens = _blob(cfg, B, B, 10, 9, **over)
    assert _decode_lists(cfg, B, B, lens, blob) is None
    assert tm.decode_tb_blob(cfg, B, B, lens, blob) is None


# ---------------------------------------------------------------------------
# SAM text and scatters
# ---------------------------------------------------------------------------

def _genome():
    return builder.Genome.from_contigs([("chrA", sim.random_genome(900, 1)),
                                        ("chrB", sim.random_genome(700, 2))])


def _batch(B, n, seed):
    rng = np.random.default_rng(seed)
    lens = np.zeros(B, np.int32)
    lens[:n] = rng.integers(L // 2, L + 1, n)
    codes = np.full((B, L), 4, np.int8)
    quals = np.zeros((B, L), np.int16)
    for b in range(n):
        codes[b, :lens[b]] = rng.integers(0, 4, lens[b])
        quals[b, :lens[b]] = rng.integers(2, 41, lens[b])
    names = [f"read_{b}" for b in range(B)]
    return io_fastq.ReadBatch(names, codes, None, lens, quals, n)


def _hit_lists(gen, batch, seed, primary):
    """Random per-read ReadHit lists over both contigs: a third of the
    reads unmapped, up to three hits a read, a quarter gapped; ``primary``
    None, or True on each read's last hit and False on the others."""
    rng = np.random.default_rng(seed)
    G = len(gen.codes)
    out = []
    for b in range(batch.n):
        Lb = int(batch.lens[b])
        hits = []
        if rng.random() > 0.33:
            for pos in sorted(rng.choice(G - 2 * L, rng.integers(1, 4),
                                         replace=False).tolist()):
                if rng.random() < 0.25:
                    cigar, rl = f"{Lb - 5}M2I2M1D1M", Lb - 1
                else:
                    cigar, rl = f"{Lb}M", Lb
                hits.append(tm.ReadHit("-" if rng.random() < 0.5 else "+",
                                       int(pos), int(rng.integers(1, 60)),
                                       0.0, cigar, rl))
            total = float(sum(h.score for h in hits))
            for i, h in enumerate(hits):
                h.weight = h.score / total
                if primary:
                    h.primary = i == len(hits) - 1
        out.append(hits)
    return out


@pytest.mark.parametrize("primary", [False, True])
@pytest.mark.parametrize("gp_host", [None, 0, 1])
def test_sam_text_equal_from_table_and_lists(native, primary, gp_host):
    """One batch's SAM text: the table, the lists (through from_lists),
    the list formatter it replaced and io/sam.py give the same bytes, with
    primary None / True / False and a genome-partitioned skip mask."""
    gen = _genome()
    batch = _batch(48, 40, 11 + primary)
    lists = _hit_lists(gen, batch, 12 + primary, primary)
    gp = None
    if gp_host is not None:
        rng = np.random.default_rng(13)
        gp = {"mapped": rng.random(batch.n) < 0.5}
    table = tm.BatchHits.from_lists(batch.n, lists)
    assert table.primary.tolist() == [
        -1 if h.primary is None else int(h.primary)
        for hits in lists for h in hits]
    host = gp_host or 0
    want = _format_lists(gen, batch, lists, gp=gp, host_id=host)
    got = tm.format_sam_batch_native(gen, batch, table, gp=gp, host_id=host)
    assert got == want
    assert tm.format_sam_batch_native(gen, batch, lists, gp=gp,
                                      host_id=host) == want
    py = []
    tm._emit_sam_py(py.append, gen, batch, table.to_lists(), gp, host)
    assert "".join(py) == want
    assert "M2I2M1D1M" in want
    assert "\t256\t" in want or "\t272\t" in want
    if gp is not None:
        n_unmapped = sum(1 for x in want.splitlines()
                         if x.split("\t")[1] == "4")
        assert n_unmapped == sum(
            1 for b, hits in enumerate(lists)
            if not hits and not gp["mapped"][b] and host == 0)


def test_sam_text_of_an_empty_and_an_unmapped_batch(native):
    gen = _genome()
    batch = _batch(8, 5, 3)
    want = _format_lists(gen, batch, [[] for _ in range(5)])
    assert tm.format_sam_batch_native(gen, batch,
                                      tm.BatchHits.empty(5)) == want
    assert want.count("\n") == 5
    assert tm.format_sam_batch_native(gen, _batch(8, 0, 3),
                                      tm.BatchHits.empty(0)) == ""


def test_sam_text_of_consecutive_batches_and_the_float_counter(native):
    """format_sam_batch_native on a batch, a larger one that outgrows the
    formatter's reused output buffer, then a smaller one: each text equals
    io/sam.py's records of its own batch, with nothing left over from the
    batch before.  ``sam.float_slow`` stays 0 on such scores and weights
    and counts a weight the snprintf fallback writes (inf)."""
    gen = _genome()
    native_lib._out.__dict__.pop("buf", None)
    c0 = profiling.COUNTS["sam.float_slow"]
    sizes = []
    for B, seed in ((6, 41), (48, 42), (5, 43)):
        batch = _batch(B, B, seed)
        table = tm.BatchHits.from_lists(
            B, _hit_lists(gen, batch, seed, False))
        got = tm.format_sam_batch_native(gen, batch, table)
        py = []
        tm._emit_sam_py(py.append, gen, batch, table.to_lists(), None, 0)
        assert got == "".join(py)
        sizes.append(len(native_lib._out.buf))
    assert sizes[0] < sizes[1] == sizes[2]
    assert profiling.COUNTS["sam.float_slow"] == c0
    table = tm.BatchHits.from_lists(B, table.to_lists())
    table.weight[0] = np.inf
    assert "\tXP:f:inf\n" in tm.format_sam_batch_native(gen, batch, table)
    assert profiling.COUNTS["sam.float_slow"] == c0 + 1


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("gapped", [False, True])
def test_scatters_equal_from_table_and_rows(use_native, gapped,
                                            monkeypatch):
    """Coverage and SNP tallies from the table, bit-equal to the rows
    map_stream built per hit (native ordered scatter, and its NumPy
    fallback), with and without gapped CIGARs."""
    if use_native and not native_lib.available():
        pytest.skip("native host library unavailable (no C++ compiler)")
    gen = _genome()
    batch = _batch(48, 40, 21)
    lists = _hit_lists(gen, batch, 22, False)
    if not gapped:
        lists = [[tm.ReadHit(h.strand, h.pos, h.score, h.weight,
                             f"{int(batch.lens[b])}M", int(batch.lens[b]))
                  for h in hits] for b, hits in enumerate(lists)]
    table = tm.BatchHits.from_lists(batch.n, lists)
    assert bool(table.cigars) == gapped
    G = len(gen.codes)
    cov_rows, tal_rows = _rows(batch, lists)
    if not use_native:
        monkeypatch.setattr(native_lib, "available", lambda: False)
    # the rows' scatter as it was: native over np.fromiter columns, or
    # the per-hit loop's definition
    want_cov = np.zeros(G)
    want_tal = np.zeros((G, 4))
    if use_native:
        native_lib.scatter_coverage(
            want_cov, *(np.asarray([r[i] for r in cov_rows])
                        for i in range(3)))
        native_lib.scatter_tallies(
            want_tal, batch.pwm_q, batch.lens,
            np.asarray([r[0] for r in tal_rows], np.int32),
            np.asarray([r[1] for r in tal_rows], np.int8),
            np.asarray([r[2] for r in tal_rows], np.int64),
            np.asarray([r[3] for r in tal_rows], np.float64),
            [r[4] or "" for r in tal_rows], PWM_SCALE)
    else:
        for pos, rl, w in cov_rows:
            want_cov[pos:pos + rl] += w
        _tally_loop(want_tal, batch, tal_rows)
    cov = np.zeros(G)
    tal = np.zeros((G, 4))
    tm._scatter_coverage(cov, table)
    tm._scatter_tallies(tal, batch, table)
    assert cov.tobytes() == want_cov.tobytes()
    assert tal.tobytes() == want_tal.tobytes()
    assert cov.sum() > 0 and tal.sum() > 0


def _tally_loop(tallies, batch, rows):
    """The per-hit tally loop the ordered scatter is defined by."""
    from gnumap_tpu_torch.core import pwm as pwm_mod
    from gnumap_tpu_torch.oracle import oracle
    for b, minus, pos, w, cigar in rows:
        Lb = int(batch.lens[b])
        p = batch.pwm_q[b, :Lb]
        p = pwm_mod.pwm_revcomp(p) if minus else p
        gp, i = pos, 0
        for num, op in oracle._iter_cigar(cigar or f"{Lb}M"):
            if op == "M":
                for k in range(num):
                    tallies[gp + k] += w * (p[i + k].astype(np.float64)
                                            / PWM_SCALE)
                gp += num
                i += num
            elif op == "D":
                gp += num
            else:
                i += num


# ---------------------------------------------------------------------------
# tracked objects and the lists counter
# ---------------------------------------------------------------------------

def _tracked_rise(native_gen, n):
    """Net rise of the collector's young count across decode_tb_blob and
    format_sam_batch_native on a batch of n reads, one hit each."""
    cfg = _cfg(hit_capacity=1)
    blob, lens = _blob(cfg, n, n, n, 31, gapped=0.02, pad_share=0.0)
    batch = _batch(n, n, 32)
    batch.lens[:] = lens
    gen = native_gen
    gc.collect()
    gc.disable()
    try:
        c0 = gc.get_count()[0]
        table = tm.decode_tb_blob(cfg, n, n, lens, blob)[0]
        text = tm.format_sam_batch_native(gen, batch, table)
        rise = gc.get_count()[0] - c0
    finally:
        gc.enable()
    assert text.count("\n") >= n
    return rise, len(table.read)


def test_decode_and_sam_leave_tracked_objects_flat(native):
    """The collector's young count rises by a constant across decode and
    SAM, not by the hits: 64 hits against 2,048 (a ReadHit and a list a
    hit read rose it by about 2 a read)."""
    gen = builder.Genome.from_contigs([("chrA",
                                        sim.random_genome(4096, 3))])
    _tracked_rise(gen, 64)           # first calls: imports, caches
    (small, h_small), (large, h_large) = (_tracked_rise(gen, 64),
                                          _tracked_rise(gen, 2048))
    assert h_large > 20 * h_small
    assert large - small <= 40, (small, large)


@pytest.fixture(scope="module")
def phix(native):
    cfg = MapperConfig(mer_size=8, seed_jump=4, max_read_len=40,
                       batch_size=40)
    gen = builder.Genome.from_fasta(FA)
    return gen, builder.build_index(gen, cfg), cfg


@pytest.mark.parametrize("finish_impl", ["device", "host"])
def test_stream_builds_no_hit_lists_on_the_device_finish(phix, finish_impl,
                                                         tmp_path):
    """hits.lists stays 0 over a device-finish stream writing SAM to a
    file, and counts every batch of the host finish; both SAMs equal."""
    gen, idx, cfg = phix
    m = tm.TorchMapper(gen, idx, cfg, device="cpu", finish_impl=finish_impl)
    c0 = profiling.counters()["hits.lists"]
    with open(tmp_path / "out.sam", "w") as f:
        res = tm.map_stream(m, io_fastq.batch_reads_native(FQ, cfg),
                            sam_file=f)
    n_lists = profiling.counters()["hits.lists"] - c0
    n_batches = -(-res.stats.n_reads // cfg.batch_size)
    assert res.stats.n_reads == 200 and res.stats.n_mapped > 150
    if finish_impl == "device":
        assert n_lists == 0
    else:
        assert n_lists == n_batches == 5
    text = (tmp_path / "out.sam").read_text()
    assert text.count("\n") >= 200
    # both finishes write the same records
    other = tm.TorchMapper(gen, idx, cfg, device="cpu",
                           finish_impl="host" if finish_impl == "device"
                           else "device")
    buf = io.StringIO()
    tm.map_stream(other, io_fastq.batch_reads_native(FQ, cfg), sam_file=buf)
    assert buf.getvalue() == text
