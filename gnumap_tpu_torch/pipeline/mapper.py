"""End-to-end batch mapper in PyTorch — the counterpart of
gnumap_tpu/pipeline/mapper.py on its single-device paths,
``TpuMapper(align_impl="pallas")`` with ``finish_impl="device"`` (the
default) or ``"host"`` and ``accumulate="host"`` (the default) or
``"device"``, on any of the four seed indexes (CSR, the bisulfite CSR pair,
FM, the bisulfite FM pair):

  device (torch, one explicit ``device``):
    * unpack reads + PWMs from the (qual, code) table (plain gathers)
    * both-strand expansion and integer emission tables (int32 multiply-adds)
    * seeding: k-mer codes (base-3 collapsed for the bisulfite CSR pair,
      base-4 of the collapsed read for the FM pair) -> CSR gather or FM
      backward search (index/fm.fm_hits) -> dedupe-cap ([FROZEN v2] votes)
    * scoring of every (read-strand, candidate) pair: banded, the CUDA
      kernel csrc/nw_band.cu on a card, its plain torch version on the CPU;
      unbanded when MapperConfig.band() is None (gap_slack >= 14),
      csrc/nw_full.cu
    * device finish: exact retention threshold, winner compaction,
      pure-diagonal detection (csrc/nw_pure.cu, banded only) and traceback
      of the gapped remainder, or of every retained hit without a band
      (csrc/nw_tb.cu), indel compaction into one int32 blob
      (device_tb_tail) — static shapes, no host sync
    * device accumulation: dedupe, posterior weights and span deltas of the
      retained hits, applied in order to device-resident coverage / tally
      arrays (device_accumulate, csrc/accum_rmw.cu)
    * host finish: one int32 blob [cands | scores | max_sc] per batch
  host (numpy / native C++, copied from the reference because it cannot be
  imported without jax; the golden semantics, kept line for line):
    * device finish: decode the blob (CIGARs, dedupe by (strand, pos),
      posterior weights); on capacity overflow the batch is re-mapped on
      the host-finish path, on the same device
    * host finish: retention threshold, traceback of retained loci, dedupe,
      posterior weights
    * coverage / SNP-tally scatter, SAM records

Genome segments (genomes past the int32 limit, ``--segments``) run one
TorchMapper a segment: dist/segments.py.  The reads x index mesh runs the
same device program a rank per mesh position: dist/collectives.py
(DistMapper, which map_stream drives through map_batch); the multi-host
layer is dist/multihost.py.
"""

from __future__ import annotations

import codecs
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from gnumap_tpu_torch.align import scoring
from gnumap_tpu_torch.config import NEG_INF, RATIO_BITS, MapperConfig
from gnumap_tpu_torch.core import packing, pwm as pwm_mod
from gnumap_tpu_torch.index.builder import BS_DIGITS, BsIndexPair, Genome
from gnumap_tpu_torch.index.fm import FmBsPair, FmIndex, fm_hits
from gnumap_tpu_torch.io import sam as sam_io
from gnumap_tpu_torch.io.fastq import ReadBatch
from gnumap_tpu_torch.oracle import oracle
from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_ref, nw_tb
from gnumap_tpu_torch.pipeline.graphs import AccPrograms, Programs
from gnumap_tpu_torch.pipeline.staging import StagingRing
from gnumap_tpu_torch.utils import profiling

SENTINEL = np.iinfo(np.int32).max
# batches map_stream keeps in flight behind the one it finishes
STREAM_DEPTH = 3
I32 = torch.int32


@dataclasses.dataclass
class ReadHit:
    strand: str
    pos: int            # global 0-based genome offset of first aligned base
    score: int
    weight: float
    cigar: str
    ref_len: int
    primary: Optional[bool] = None  # None = local order (hit 0 primary)


class BatchHits:
    """One batch's hits as columns, in emission order: read ascending, then
    (pos, '+' before '-') within a read.  Hit i belongs to read ``read[i]``;
    read b's hits are ``offsets[b]:offsets[b + 1]``.

      read int32, minus int8, pos int64, score int32, weight float64,
      ref_len int32, primary int8 (-1 = None: local order, hit 0 primary)
      cig_idx int64 + cigars list[str]: the CIGARs that are not
        f"{ref_len}M" (gapped hits), by hit index ascending; every other
        hit is a pure match of its whole read (M consumes the read, so
        its ref_len is the read's length), the native SAM writer's and
        tally scatter's "" CIGAR

    It is also the read-only sequence of per-read ``ReadHit`` lists the
    mappers returned before it: item access, iteration and ``to_lists()``
    build those lists once (counted by ``hits.lists``) and keep them; a
    caller that changes them owns what it changed, and ``of`` reads a
    batch's columns again from them."""

    __slots__ = ("n", "offsets", "read", "minus", "pos", "score", "weight",
                 "ref_len", "primary", "cig_idx", "cigars", "_lists")

    def __init__(self, n: int, read, minus, pos, score, weight, ref_len,
                 primary=None, cig_idx=None, cigars=()):
        self.n = n
        self.read = np.asarray(read, np.int32)
        self.offsets = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(self.read, minlength=n), out=self.offsets[1:])
        self.minus = np.asarray(minus, np.int8)
        self.pos = np.asarray(pos, np.int64)
        self.score = np.asarray(score, np.int32)
        self.weight = np.asarray(weight, np.float64)
        self.ref_len = np.asarray(ref_len, np.int32)
        self.primary = (np.full(len(self.read), -1, np.int8)
                        if primary is None else np.asarray(primary, np.int8))
        self.cig_idx = (np.zeros(0, np.int64) if cig_idx is None
                        else np.asarray(cig_idx, np.int64))
        self.cigars = list(cigars)
        self._lists = None

    @classmethod
    def empty(cls, n: int) -> "BatchHits":
        z = np.zeros(0)
        return cls(n, z, z, z, z, z, z)

    @classmethod
    def from_lists(cls, n: int, lists) -> "BatchHits":
        """The table of ``n`` per-read ReadHit lists (counted)."""
        if len(lists) != n:
            raise ValueError(f"{len(lists)} hit lists for {n} reads")
        profiling.COUNTS["hits.lists"] += 1
        flat = [h for hits in lists for h in hits]
        k = len(flat)
        gapped = [(i, h.cigar) for i, h in enumerate(flat)
                  if h.cigar != f"{h.ref_len}M"]
        return cls(
            n, np.repeat(np.arange(n, dtype=np.int32),
                         [len(hits) for hits in lists]),
            np.fromiter((h.strand == "-" for h in flat), np.int8, k),
            np.fromiter((h.pos for h in flat), np.int64, k),
            np.fromiter((h.score for h in flat), np.int32, k),
            np.fromiter((h.weight for h in flat), np.float64, k),
            np.fromiter((h.ref_len for h in flat), np.int32, k),
            np.fromiter((-1 if h.primary is None else bool(h.primary)
                         for h in flat), np.int8, k),
            [i for i, _ in gapped], [c for _, c in gapped])

    @classmethod
    def of(cls, hits) -> "BatchHits":
        """A finish result as a table: a table whose lists were never
        built as it is, anything else through ``from_lists``."""
        if isinstance(hits, cls):
            return hits if hits._lists is None else \
                cls.from_lists(hits.n, hits._lists)
        return cls.from_lists(len(hits), hits)

    def to_lists(self) -> List[List[ReadHit]]:
        """The per-read ReadHit lists, built at the first call (counted)."""
        if self._lists is None:
            profiling.COUNTS["hits.lists"] += 1
            rl = self.ref_len.tolist()
            cig = [f"{r}M" for r in rl]
            for i, c in zip(self.cig_idx.tolist(), self.cigars):
                cig[i] = c
            hits = list(map(
                ReadHit, ["-" if m else "+" for m in self.minus.tolist()],
                self.pos.tolist(), self.score.tolist(),
                self.weight.tolist(), cig, rl,
                [None if p < 0 else bool(p) for p in self.primary.tolist()]))
            off = self.offsets.tolist()
            self._lists = [hits[off[b]:off[b + 1]] for b in range(self.n)]
        return self._lists

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, b):
        return self.to_lists()[b]

    def __iter__(self):
        return iter(self.to_lists())

    def counts(self) -> np.ndarray:
        """int64[n]: hits a read."""
        return np.diff(self.offsets)


@dataclasses.dataclass
class BatchStats:
    n_reads: int = 0
    n_mapped: int = 0
    n_multi: int = 0
    n_candidates: int = 0
    dp_cells: int = 0          # rectangle-equivalent work: L x W per
                               # candidate
    dp_cells_banded: int = 0   # cells the banded kernel computes: L x bw
                               # per candidate
    device_s: float = 0.0      # the finish's wait for the device and its
                               # copy (finish.wait spans), not device time
    host_s: float = 0.0        # the finish's host work (finish.decode)


def _cells_per_cand(cfg: "MapperConfig"):
    """(rectangle, banded-computed) DP cells per (candidate, read-row)."""
    W = cfg.window_width()
    b = cfg.band()
    return W, (b[1] if b is not None else W)


# ---------------------------------------------------------------------------
# Device stages (plain torch; every tensor on the caller's device)
# ---------------------------------------------------------------------------

def revcomp_batch(codes, pwm_q, lens):
    """Length-aware reverse complement so the rc read still occupies
    positions [0, len) with N/zero padding at the tail."""
    B, L = codes.shape
    ar = torch.arange(L, device=codes.device)
    src = (lens.long()[:, None] - 1 - ar[None, :]).clamp(0, L - 1)
    in_read = ar[None, :] < lens[:, None]
    g = torch.gather(codes.to(I32), 1, src)
    pw = torch.gather(pwm_q, 1, src[:, :, None].expand(B, L, 4))
    rc_codes = torch.where(in_read, torch.where(g < 4, 3 - g, 4),
                           4).to(torch.int8)
    rc_pwm = torch.where(in_read[:, :, None], pw.flip(-1), 0)
    return rc_codes, rc_pwm


def seed_kmers(codes2, offsets, m):
    """k-mer codes at the static seed offsets + invalid (contains-N) mask."""
    code4 = torch.where(codes2 == 4, 0, codes2.to(I32))
    isn = codes2 == 4
    km = torch.zeros((codes2.shape[0], offsets.shape[0]), dtype=I32,
                     device=codes2.device)
    bad = torch.zeros_like(km, dtype=torch.bool)
    for k in range(m):
        km = km * 4 + code4[:, offsets + k]
        bad = bad | isn[:, offsets + k]
    return km, bad


def seed_kmers_b3(codes2, offsets, m, digits):
    """Base-3 collapsed k-mer codes at the static seed offsets (bisulfite
    seeding [FROZEN]; digit tables in index/builder.BS_DIGITS, int32 on the
    device)."""
    d = digits[codes2.long().clamp(0, 4)]
    isn = d < 0
    base = torch.where(isn, 0, d)
    km = torch.zeros((codes2.shape[0], offsets.shape[0]), dtype=I32,
                     device=codes2.device)
    bad = torch.zeros_like(km, dtype=torch.bool)
    for k in range(m):
        km = km * 3 + base[:, offsets + k]
        bad = bad | isn[:, offsets + k]
    return km, bad


def csr_hits(km, bad, bucket_start, positions, offsets, cfg):
    """Per-seed candidate anchors from a CSR table: (B2, S, caph) int32 with
    SENTINEL at invalid slots (plain element gathers)."""
    kml = km.long()
    start = bucket_start[kml]
    count = bucket_start[kml + 1] - start
    caph = cfg.max_hits_per_seed
    seed_ok = (~bad) & (count > 0) & (count <= caph)
    ar = torch.arange(caph, dtype=I32, device=km.device)
    hit_ok = seed_ok[:, :, None] & (ar < count[:, :, None])
    npos = positions.shape[0]
    if npos == 0:
        return torch.full(hit_ok.shape, SENTINEL, dtype=I32,
                          device=km.device)
    idx = (start.long()[:, :, None] + ar).clamp(0, npos - 1)
    cand = positions[idx] - offsets.to(I32)[None, :, None]
    return torch.where(hit_ok, cand, SENTINEL)


def dedupe_cap(cand, C):
    """Dedupe-cap per read: (B2, S*caph) -> (B2, C) ascending with SENTINEL
    padding.

    [FROZEN v2] Over C unique candidates, keep the C ranked best by (seed
    votes desc, position asc); votes = how many (seed offset, index hit)
    pairs anchored the candidate.  Output ascending by position.  The
    reference's two-key sort is one sort on an int64 key: votes in the high
    word, the position biased by 2^31 (anchors can be negative) in the low
    word."""
    flat = cand.reshape(cand.shape[0], -1)
    B2, N = flat.shape
    dev = flat.device
    s1 = torch.sort(flat, dim=1).values
    idxs = torch.arange(N, dtype=I32, device=dev)[None, :]
    uniq = torch.cat([torch.ones_like(s1[:, :1], dtype=torch.bool),
                      s1[:, 1:] != s1[:, :-1]], dim=1)
    # votes per run-start entry = distance to the next run start
    t = torch.where(uniq, idxs, N)
    nxt = torch.cat([torch.cummin(t.flip(1), dim=1).values.flip(1)[:, 1:],
                     torch.full((B2, 1), N, dtype=I32, device=dev)], dim=1)
    votes = nxt - idxs
    real = uniq & (s1 != SENTINEL)
    key_votes = torch.where(real, -votes, 1).long()
    key_pos = torch.where(real, s1, SENTINEL)
    key = (key_votes << 32) + (key_pos.long() + (1 << 31))
    order = torch.sort(key, dim=1, stable=True).indices
    top = torch.gather(key_pos, 1, order)[:, :C]
    if N < C:
        top = torch.cat([top, torch.full((B2, C - N), SENTINEL, dtype=I32,
                                         device=dev)], dim=1)
    return torch.sort(top, dim=1).values


def windows_for(cand_chunk, g_codes, cfg):
    """Gather genome windows for a chunk of candidates; OOB -> N."""
    return nw_band.gather_windows(cand_chunk, g_codes, cfg.window_width(),
                                  cfg.gap_slack)


def pack_reads(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """Host-side H2D packing: ONE uint8 array (B, L + ceil(L/4)) —
    columns [0, L) are Phred quals clipped to [0, 127] with 255 marking an
    N base; columns [L, ...) are 2-bit packed base codes.  Exact: the PWM
    table clamps quals to 127 anyway, and an N base's row is uniform."""
    codes = np.asarray(codes)
    q = np.asarray(quals)
    B, L = codes.shape
    L4 = (L + 3) // 4
    isn = codes >= 4
    q8 = np.where(isn, np.uint8(255),
                  np.clip(q, 0, 127).astype(np.uint8))
    c2 = np.where(isn, 0, codes).astype(np.uint8)
    if L4 * 4 != L:
        c2 = np.concatenate(
            [c2, np.zeros((B, L4 * 4 - L), np.uint8)], axis=1)
    c4 = c2.reshape(B, L4, 4)
    pc = (c4[:, :, 0] | (c4[:, :, 1] << 2)
          | (c4[:, :, 2] << 4) | (c4[:, :, 3] << 6)).astype(np.uint8)
    return np.concatenate([q8, pc], axis=1)


def device_unpack(packed, L: int):
    """Inverse of pack_reads, on the device."""
    p = packed.to(I32)
    q = p[:, :L]
    rep = p[:, L:].repeat_interleave(4, dim=1)[:, :L]
    sh = (torch.arange(L, dtype=I32, device=p.device) % 4) * 2
    c = (rep >> sh) & 3
    isn = q == 255
    codes = torch.where(isn, 4, c).to(torch.int8)
    quals = torch.where(isn, 0, q)
    return codes, quals


def device_pwm(codes, quals, lens, table):
    """PWM reconstruction on the device — equal to core/pwm.pwm_from_calls
    (the table is built with it) — with pad positions zeroed.  One plain
    (qual, code) table gather."""
    Q = table.shape[0]
    q = quals.long().clamp(0, Q - 1)
    c = codes.long().clamp(0, 4)
    pw = table[q, c]                                        # (B, L, 4)
    L = codes.shape[1]
    in_read = torch.arange(L, device=codes.device)[None, :] < lens[:, None]
    return torch.where(in_read[:, :, None], pw, 0)


def _emission(pwm_q, S):
    """int32 (B, L, 4) x (4, 5) as four multiply-adds (no int32 matmul on
    CUDA); PWM rows sum to 4096 and |S| <= 64 per unit, far inside int32."""
    e = pwm_q[..., 0:1] * S[0]
    for k in range(1, 4):
        e = e + pwm_q[..., k:k + 1] * S[k]
    return e


def strand_expand(codes, pwm_q, lens, S_plus, S_minus):
    """codes/pwm -> both-strand codes2 + integer emission tables."""
    rc_codes, rc_pwm = revcomp_batch(codes, pwm_q, lens)
    codes2 = torch.cat([codes, rc_codes], dim=0)
    emis2 = torch.cat([_emission(pwm_q, S_plus), _emission(rc_pwm, S_minus)],
                      dim=0)
    return codes2, emis2


def index_kind(index) -> str:
    """"csr", "csr_bs", "fm" or "fm_bs": the seed-lookup backend of an
    index (the reference's TpuMapper.index_kind)."""
    if isinstance(index, BsIndexPair):
        return "csr_bs"
    if isinstance(index, FmBsPair):
        return "fm_bs"
    if isinstance(index, FmIndex):
        return "fm"
    return "csr"


def _index_arrays(index) -> Dict[str, np.ndarray]:
    """The index's device arrays by name, in index/store.py's names (the
    minus strand's with a ``_minus`` suffix); the bisulfite CSR pair adds
    its two base-3 digit tables."""
    kind = index_kind(index)
    if kind in ("csr_bs", "fm_bs"):
        out = {}
        for strand, sfx in ((index.plus, ""), (index.minus, "_minus")):
            out.update({k + sfx: v for k, v in _index_arrays(strand).items()})
        if kind == "csr_bs":
            out.update(digits_ct=np.asarray(BS_DIGITS["ct"], np.int32),
                       digits_ga=np.asarray(BS_DIGITS["ga"], np.int32))
        return out
    if kind == "fm":
        return dict(sa=np.asarray(index.sa, np.int32),
                    bwt_words=np.asarray(index.bwt_words, np.int32),
                    occ=np.asarray(index.occ, np.int32),
                    c_table=np.asarray(index.c_table, np.int32))
    return dict(bucket_start=np.asarray(index.bucket_start, np.int32),
                positions=np.asarray(index.positions, np.int32))


def device_state(genome: Genome, index, cfg: MapperConfig,
                 device) -> Dict[str, torch.Tensor]:
    """The numpy arrays the device program reads (the reference's
    device-resident "weights"), on ``device``: the seed index (any of the
    four kinds, ``_index_arrays``), the int8 genome codes, both strands'
    substitution matrices, the PWM table and the seed offsets.
    ``index/store.load_index`` output loads straight in."""
    device = torch.device(device)
    S_plus, S_minus = scoring.matrices_for_mode(cfg)
    L, m = cfg.max_read_len, cfg.mer_size
    arrays = dict(
        _index_arrays(index),
        g_codes=np.asarray(genome.codes, np.int8),
        S_plus=np.asarray(S_plus, np.int32),
        S_minus=np.asarray(S_minus, np.int32),
        pwm_table=pwm_mod.pwm_table(),
        offsets=np.arange(0, L - m + 1, cfg.seed_jump, dtype=np.int64))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def device_threshold(max_sc, ratio_q: int):
    """Exact retention threshold ceil(ratio_q * max_sc / 2^RATIO_BITS),
    equal to MapperConfig.threshold_for: one int64 product (ratio_q <=
    2^32, |max_sc| < 2^31)."""
    return ((ratio_q * max_sc.long() + (1 << RATIO_BITS) - 1)
            >> RATIO_BITS).to(I32)


def _compact(mask, n_out: int, values):
    """dst[k] = values[i] for the k-th set entry i of mask, k < n_out; the
    other slots keep 0.  Static shapes: a cumsum and one scatter whose
    dropped entries land in a spare slot."""
    k = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    slot = torch.where(mask & (k < n_out), k, n_out).long()
    dst = torch.zeros(n_out + 1, dtype=values.dtype, device=values.device)
    return dst.scatter_(0, slot, values)[:n_out], k


def device_retain(cfg: MapperConfig, cands, valid, scores, max_sc,
                  emis2_t, lens2) -> dict:
    """Stage (a) of device_hit_rows: the exact retention threshold and the
    winner compaction into H = hit_capacity * B2 hit slots, in flat
    (row, candidate) order; -1 / SENTINEL / 0 in the empty slots.  The
    winners' emission tables (emis_h, int32[H, 5, L]) are gathered here."""
    B2, C = cands.shape
    H = cfg.hit_capacity * B2
    if B2 * C >= (1 << 21):
        raise ValueError("flat_idx must fit 21 bits (w0 packing)")
    if cfg.window_width() >= (1 << 8):
        raise ValueError("j_final must fit 8 bits (w0 packing): "
                         "max_read_len <= 223")
    dev = cands.device
    thr = device_threshold(max_sc, cfg.ratio_q())
    keep = (valid & (scores >= thr[:, None]) & (scores > 0)).reshape(-1)
    flat_idx = torch.arange(B2 * C, dtype=I32, device=dev)
    hit_flat, k = _compact(keep, H, flat_idx + 1)
    hit_flat = hit_flat - 1                      # -1 = empty slot
    valid_h = hit_flat >= 0
    safe = torch.where(valid_h, hit_flat, 0).long()
    row_h = safe // C
    return dict(valid_h=valid_h, hit_flat=hit_flat, row_h=row_h,
                cand_h=torch.where(valid_h, cands.reshape(-1)[safe],
                                   SENTINEL),
                score_h=torch.where(valid_h, scores.reshape(-1)[safe], 0),
                len_h=torch.where(valid_h, lens2[row_h], 0),
                emis_h=emis2_t[row_h], n_keep=k[-1] + 1,
                n_valid=valid.sum(dtype=I32))


def _tb_kw(cfg: MapperConfig) -> dict:
    return dict(L=cfg.max_read_len, W=cfg.window_width(), slack=cfg.gap_slack,
                open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())


def device_pure(cfg: MapperConfig, rows: dict, genome):
    """Stage (b) of device_hit_rows: [FROZEN v6] B2 (csrc/nw_pure.cu)
    proves the winners that are all-M pure, with their j_final:
    (pure bool[H], jf_pure int32[H]).  None when the traceback is not
    split (no band, or a zero gap penalty): stage (c) then traces every
    winner."""
    band = cfg.band()
    if not (band is not None and cfg.gap_open_q() > 0
            and cfg.gap_extend_q() > 0
            and os.environ.get("GNUMAP_TB_SPLIT", "1") != "0"):
        return None
    return nw_pure.nw_pure_banded(
        rows["emis_h"], rows["cand_h"], rows["len_h"], rows["score_h"],
        genome, boff=band[0], bw=band[1], **_tb_kw(cfg))


def device_traceback(cfg: MapperConfig, rows: dict, pure_jf, emis2_t,
                     genome) -> dict:
    """Stage (c) of device_hit_rows: the gap-bearing remainder (the
    winners stage (b) did not prove pure) compacted to the front, B3
    (csrc/nw_tb.cu) on it, its ops and j_final scattered back to their hit
    slots; without stage (b) (``pure_jf`` None), B3 on every winner.
    Returns ``rows`` with ops int16[H, Lp] and jfin int32[H]."""
    valid_h, H = rows["valid_h"], rows["valid_h"].shape[0]
    dev = valid_h.device
    kw = dict(band=cfg.band(), **_tb_kw(cfg))
    if pure_jf is None:
        ops, jfin = nw_tb.nw_traceback(rows["emis_h"], rows["cand_h"],
                                       rows["len_h"], genome, **kw)
    else:
        pure, jf_pure = pure_jf
        iota_h = torch.arange(H, dtype=I32, device=dev)
        src2, kk2 = _compact(valid_h & ~pure, H, iota_h)
        live = iota_h < kk2[-1] + 1
        src2l = src2.long()
        cand_c = torch.where(live, rows["cand_h"][src2l], SENTINEL)
        len_c = torch.where(live, rows["len_h"][src2l], 0)
        ops_c, jfin_c = nw_tb.nw_traceback(
            emis2_t[rows["row_h"][src2l]], cand_c, len_c, genome, **kw)
        tgt2 = torch.where(live, src2, H).long()
        ops = torch.zeros((H + 1, ops_c.shape[1]), dtype=ops_c.dtype,
                          device=dev)
        ops[tgt2] = ops_c
        jfin_tb = torch.zeros(H + 1, dtype=I32, device=dev)
        jfin_tb[tgt2] = jfin_c
        ops, jfin = ops[:H], torch.where(pure, jf_pure, jfin_tb[:H])
    return dict(rows, ops=ops, jfin=jfin)


def device_hit_rows(cfg: MapperConfig, cands, valid, scores, max_sc,
                    emis2_t, lens2, genome) -> dict:
    """Retention threshold + winner compaction + device traceback: the
    per-hit rows of the device finish (gnumap_tpu/pipeline/mapper.py
    device_hit_rows), as three stages that bench.profile_stages also times
    as prefixes: device_retain, device_pure (B2), device_traceback (B3).
    emis2_t int32[B2, 5, L] contiguous."""
    rows = device_retain(cfg, cands, valid, scores, max_sc, emis2_t, lens2)
    return device_traceback(cfg, rows, device_pure(cfg, rows, genome),
                            emis2_t, genome)


def device_tb_tail(cfg: MapperConfig, cands, valid, scores, max_sc,
                   emis2_t, lens2, genome, rows=None) -> torch.Tensor:
    """Retention threshold + winner compaction + traceback + indel-compacted
    blob, ONE flat int32 tensor (gnumap_tpu/pipeline/mapper.py
    device_tb_tail, word for word):

      blob[:4*H]    per-hit meta x H = hit_capacity*B2 rows:
                      w0 = flat_idx | (j_final << 21)   (-1 = empty slot)
                      w1 = cand,  w2 = score,  w3 = indel_slot (-1 = none)
      blob[4*H:-3]  compacted ops of the K = max(64, H // 32) indel-bearing
                    hits, two uint16 per int32 (overflow -> host fallback)
      blob[-3:]     [n_keep, n_valid, n_indel]

    ``rows``: device_hit_rows' output when the caller already has it.
    """
    H = cfg.hit_capacity * cands.shape[0]
    if rows is None:
        rows = device_hit_rows(cfg, cands, valid, scores, max_sc, emis2_t,
                               lens2, genome)
    valid_h, len_h, ops = rows["valid_h"], rows["len_h"], rows["ops"]
    Lp = ops.shape[1]
    K = max(64, H // 32)
    in_read = (torch.arange(Lp, dtype=I32, device=ops.device)[None, :]
               < len_h[:, None])
    has_indel = ((ops != 0) & in_read).any(dim=1) & valid_h
    src, ki = _compact(has_indel, K,
                       torch.arange(H, dtype=I32, device=ops.device))
    n_indel = ki[-1] + 1
    islot = torch.where(has_indel, ki, -1)
    ops32 = ops[src.long()].contiguous().view(torch.int32)   # (K, Lp // 2)
    w0 = torch.where(valid_h, rows["hit_flat"] | (rows["jfin"] << 21), -1)
    meta = torch.stack([w0, rows["cand_h"], rows["score_h"], islot], dim=1)
    tail = torch.stack([rows["n_keep"], rows["n_valid"], n_indel])
    return torch.cat([meta.reshape(-1), ops32.reshape(-1), tail])


def tb_blob_len(cfg: MapperConfig, B: int) -> int:
    """Host-side length of the device_tb_tail blob for a B-read batch."""
    H = cfg.hit_capacity * 2 * B
    K = max(64, H // 32)
    return 4 * H + K * (nw_tb.ops_width(cfg.max_read_len) // 2) + 3


def acc_span(cfg: MapperConfig) -> int:
    """Delta-window width for device accumulation: a 128-multiple covering
    the widest alignment span (bounded by the candidate window) plus one
    128 block, because span starts are floor-aligned to 128 positions and
    the pos % 128 residue shifts the delta inside the window."""
    return ((cfg.window_width() + 127) // 128) * 128 + 128


def acc_padded_len(cfg: MapperConfig, G: int) -> int:
    """Accumulator length: genome + room for every clipped span, rounded
    to 128."""
    span = acc_span(cfg)
    return ((G + 2 * span + 127) // 128) * 128


def _segmented(comb, vals, seg, reverse=False, inplace=False):
    """Segmented inclusive scan of vals (H, ...) under comb, restarting where
    the grouped ids seg (H,) change (gnumap_tpu/pipeline/mapper.py
    _segmented): the combination tree of jax.lax.associative_scan, so the
    f32 bits are the reference's.  That scan pairs (e[2k], e[2k+1]), scans
    the pairs recursively and combines each even e[2k] with the scanned
    pair before it; here the same tree runs in place on a copy (on vals
    itself with ``inplace``, forward only), level by level on strided
    views (level l's element j is the block of 2^l ends at
    position 2^l (j + 1) - 1, where its result also lands), with the
    reference's operator where(seg_a == seg_b, comb(a, b), b).  A combined
    element keeps the later id, so the ids never change.  (The reference
    interleaves by adding zero-padded halves, which would turn a -0.0 into
    +0.0; the values scanned here are never -0.0.)"""
    if reverse:
        return _segmented(comb, vals.flip(0), seg.flip(0)).flip(0)
    out = vals if inplace else vals.clone()
    n = out.shape[0]
    seg = seg.reshape((n,) + (1,) * (out.ndim - 1))

    def step(first, count, s):
        if count:
            a = slice(first - s, first - s + 2 * s * (count - 1) + 1, 2 * s)
            b = slice(first, first + 2 * s * (count - 1) + 1, 2 * s)
            vb = out[b]
            torch.where(seg[a] == seg[b], comb(out[a], vb), vb, out=vb)

    s = 1
    while n // s >= 2:          # up: pairs of level-l blocks
        step(2 * s - 1, n // s // 2, s)
        s *= 2
    while s > 1:                # down: each even block after the first
        s //= 2
        step(3 * s - 1, (n // s - 1) // 2, s)
    return out


def acc_tier(n_keep: int, H: int) -> int:
    """The hit slots the accumulate program runs on for a batch of n_keep
    retained hits in H slots: n_keep rounded up to a multiple of 128 (at
    least 128), at most H.  Any count from n_keep to H gives the same bits
    (device_accumulate's n_live); a few tiers let a few captured graphs
    (pipeline/graphs.py AccPrograms) serve every batch."""
    return min(H, 128 * max(1, -(-n_keep // 128)))


# the per-hit rows device_accumulate reads
ACC_ROW_KEYS = ("valid_h", "row_h", "score_h", "len_h", "ops", "jfin",
                "cand_h", "n_valid", "n_keep")


def device_accumulate(cfg: MapperConfig, B: int, pwm2, rows: dict, cov,
                      tal, n_live: int) -> torch.Tensor:
    """[FROZEN v5] On-device coverage / SNP-tally accumulation
    (gnumap_tpu/pipeline/mapper.py device_accumulate).

    Per retained hit: dedupe by (read-strand row, final position) keeping
    the max score (first in hit order on ties), posterior weight w = score /
    sum of the read's deduped scores, then

      coverage[pos : pos + ref_len]      += w                       (f32)
      tallies[genome_idx(read base i)]   += w * PWM[i] / PWM_SCALE  (f32)

    into the device-resident accumulators, in place.  cov is
    f32[Gpad / 128, 128] (position p at flat p) and tal f32[Gpad * 4 / 128,
    128] (flat 4p + b) or None; Gpad = acc_padded_len, whose pad absorbs
    spans clipped at the genome's ends.

    [FROZEN v5.2] f32 arithmetic, the reference's bit for bit:
      * one composite-key stable sort orders the hits by (read, strand,
        position, -score, slot), the reference's lax.sort; a read's total
        is the f32 segmented scan sum of its winners' f32 scores, broadcast
        back by a reverse segmented max, and w = score / max(total, 1);
      * each hit's coverage and tally delta is a dense span-wide window
        built with elementwise ops and one scatter with unique targets (a
        read base lands in at most one genome column);
      * the windows, sorted stably by their 128-block, pre-coalesce: a
        segmented scan sum over each block's run of hits (in slot order)
        leaves one delta per unique block at the run's end;
      * the ordered read-modify-write kernel (posterior/accum,
        csrc/accum_rmw.cu) adds the unique blocks' deltas, coverage and
        tallies in one launch.
    The segmented scans are _segmented, the reference's combination tree.
    Winner counts are exact integer index_adds.  Nothing here waits for the
    host, so a CUDA graph can hold the whole program (pipeline/graphs.py
    AccPrograms): every shape follows from n_live and the inputs' shapes,
    the tally scatter sends the read bases that land nowhere to a discard
    row past the last slot's window (no boolean mask, whose indices a card
    counts on the host), and the number of unique blocks, B5's live work,
    stays a device tensor, returned for the caller to bring home with the
    stats.

    n_live: a count of slots, known to the host, whose first slots hold
    every valid hit (the finish fetches n_keep, and the winners' compaction
    fills the first n_keep slots; TorchMapper passes acc_tier(n_keep, H)).
    Only those slots are sorted, scanned and windowed: the reference's H
    slots sort the invalid ones after them, and a position of a segmented
    scan depends only on the positions before it, so the rest change no
    bit.

    Returns (stats int32[4] = [n_mapped, n_multi, n_valid, n_keep],
    n_uniq int32[]: the unique 128-blocks handed to the ordered RMW)."""
    from gnumap_tpu_torch.config import PWM_SCALE
    from gnumap_tpu_torch.posterior import accum
    H = min(rows["valid_h"].shape[0], max(1, n_live))
    valid_h, row_h, score_h, len_h, ops, jfin, cand_h = (
        rows[k][:H] for k in ("valid_h", "row_h", "score_h", "len_h", "ops",
                              "jfin", "cand_h"))
    L = cfg.max_read_len
    span = acc_span(cfg)
    Gpad = cov.shape[0] * 128
    dev = valid_h.device
    i64 = torch.int64
    big = torch.iinfo(i64).max
    pos_h = (torch.div(cand_h.long() - cfg.gap_slack, 8,
                       rounding_mode="floor") * 8 + jfin.long())
    read_id = row_h.long() % B
    # dedupe + weights: order (read, strand, pos, -score, slot); row =
    # read + strand * B, so (read, row) order is (2 read + strand) order
    key = torch.where(valid_h, ((2 * read_id + row_h.long() // B) << 32)
                      + pos_h + (1 << 31), big)
    order = torch.sort(-score_h, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    sk = key[order]
    first = torch.ones(H, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    valid_s = valid_h[order]
    win = first & valid_s
    rid = read_id[order]
    rseg = torch.where(valid_s, rid, big)
    sc = torch.where(win, score_h[order].float(), 0.0)
    tot = _segmented(torch.maximum, _segmented(torch.add, sc, rseg), rseg,
                     reverse=True)
    w_sorted = torch.where(win, sc / torch.clamp_min(tot, 1.0), 0.0)
    w = torch.empty_like(w_sorted)
    w[order] = w_sorted
    n_win = torch.zeros(B, dtype=torch.int32, device=dev).index_add_(
        0, rid, win.int())
    stats = torch.stack([(n_win >= 1).sum(dtype=torch.int32),
                         (n_win >= 2).sum(dtype=torch.int32),
                         rows["n_valid"].to(torch.int32),
                         rows["n_keep"].to(torch.int32)])
    # genome index of read base i = pos + exclusive prefix of
    # ((1 - is_insertion) + deletions_after) over earlier rows: the
    # vectorized CIGAR walk of decode_ops
    opb = (ops[:, :L] & 1).long()
    in_read = (torch.arange(L, device=dev)[None, :] < len_h[:, None])
    step = torch.where(in_read, (1 - opb) + (ops[:, :L] >> 1).long(), 0)
    gidx = pos_h[:, None] + torch.cumsum(step, dim=1) - step
    ref_len = step.sum(dim=1)
    # the delta windows in (128-block, slot) order; invalid hits sort last
    base_units = torch.clamp(pos_h >> 7, 0, (Gpad - span) >> 7)
    bkey = torch.where(valid_h, base_units, big)
    perm = torch.sort(bkey, stable=True).indices
    skey = bkey[perm]
    # the unique blocks: the k-th run of equal blocks ends at srcu[k]
    ends = torch.ones(H, dtype=torch.bool, device=dev)
    ends[:-1] = skey[1:] != skey[:-1]
    ends &= skey != big
    ku = torch.cumsum(ends, 0) - 1
    n_uniq = (ku[-1] + 1).to(torch.int32)
    srcu = torch.zeros(H + 1, dtype=i64, device=dev)
    srcu[torch.where(ends, ku, H)] = torch.arange(H, device=dev)
    srcu = srcu[:H]
    base_u = torch.where(torch.arange(H, device=dev) < n_uniq, skey[srcu],
                         0).to(torch.int32)
    # coverage and tally windows side by side in one buffer, so that one
    # scan coalesces both (the scan is elementwise along the window)
    cw = span // 128
    # (SNP mode) four floats past the last window: the tally discard row
    nd = H * cw * (5 if tal is not None else 1) * 128
    flat = torch.zeros(nd + (4 if tal is not None else 0),
                       dtype=torch.float32, device=dev)
    deltas = flat[:nd].view(H, -1, 128)
    s = (pos_h - (base_units << 7))[perm]
    kk = torch.arange(span, device=dev)[None, :]
    deltas[:, :cw] = torch.where((kk >= s[:, None])
                                 & (kk < (s + ref_len[perm])[:, None]),
                                 w[perm][:, None], 0.0).reshape(H, cw, 128)
    if tal is not None:
        val = pwm2[row_h[perm].long()].float() \
            * (w[perm] * (1.0 / PWM_SCALE))[:, None, None]    # (H, L, 4)
        col = gidx[perm] - (base_units[perm] << 7)[:, None]
        ok = ((opb[perm] == 0) & in_read[perm] & (col >= 0) & (col < span))
        # row h's tallies are the (span, 4) rows from h * 5 span / 4 +
        # span / 4 of the buffer; row-major (span, 4) is the 4p + b lane
        # interleave.  The targets of ok bases are unique; every other base
        # goes to the discard row H * 5 span / 4, which nothing reads
        tgt = torch.where(ok, torch.arange(H, device=dev)[:, None]
                          * (5 * span // 4) + span // 4 + col,
                          H * (5 * span // 4))
        flat.view(-1, 4)[tgt] = val
        del val, col, ok, tgt
    # the windows' scan and B5's gathers are the program's peak of device
    # memory: no other per-hit window is alive there, and the scan runs in
    # the windows' own buffer
    del gidx, step, opb, in_read
    _segmented(torch.add, deltas, skey, inplace=True)
    if tal is None:
        accum.apply_deltas(cov, base_u, deltas[srcu], n_uniq, rowmul=1)
    else:
        # coverage and tallies in one launch, coverage first
        accum.apply_deltas_pair(cov, tal, base_u, deltas[:, :cw][srcu],
                                deltas[:, cw:][srcu], n_uniq)
    return stats, n_uniq


def decode_tb_blob(cfg: MapperConfig, B: int, n: int, lens_np, blob):
    """Decode one device_tb_tail blob into the batch's hit table.

    B = device batch rows, n = real reads, lens_np = int32[B] read lengths.
    Returns (BatchHits, n_keep, n_valid) or None on capacity overflow (the
    caller falls back to the host-finish path).  Dedupe by (read, strand,
    pos) keeps the max score, FIRST in hit order on ties (stable lexsort);
    weights are normalized over the deduped set in float64; each read's
    hits sorted by (pos, '+' before '-').  Only the indel-bearing hits'
    CIGARs are decoded (nw_tb.decode_ops); every other hit is a pure
    match of its read's length.  The span ``finish.posterior``
    (utils/profiling.py) covers the dedupe, the weights and the emission
    order."""
    C = cfg.max_candidates
    H = cfg.hit_capacity * 2 * B
    K = max(64, H // 32)
    meta_all = blob[:4 * H].reshape(H, 4)
    n_keep = int(blob[-3])
    n_valid = int(blob[-2])
    n_indel = int(blob[-1])
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
    real = b_idx < n
    idx = np.nonzero(real)[0]
    if len(idx) == 0:
        return BatchHits.empty(n), n_keep, n_valid
    with profiling.span("finish.posterior"):
        order = idx[np.lexsort((-sc[idx], pos[idx], minus[idx],
                                b_idx[idx]))]
        bo, mo, po = b_idx[order], minus[order], pos[order]
        first = np.empty(len(order), bool)
        first[0] = True
        first[1:] = (bo[1:] != bo[:-1]) | (mo[1:] != mo[:-1]) \
            | (po[1:] != po[:-1])
        winners = order[first]
        totals = np.bincount(b_idx[winners],
                             weights=sc[winners].astype(np.float64),
                             minlength=n)
        # emission order: (read, pos, strand) ascending
        emit = winners[np.lexsort((minus[winners], pos[winners],
                                   b_idx[winners]))]
        w_emit = sc[emit].astype(np.float64) / totals[b_idx[emit]]
    ref_len = lens_h[emit].astype(np.int32)
    gapped = np.nonzero(islot[emit] >= 0)[0]
    cigars = []
    for j in gapped.tolist():
        cigar, ref_len[j] = nw_tb.decode_ops(ops_c[islot[emit[j]]],
                                             int(ref_len[j]))
        cigars.append(cigar)
    return BatchHits(n, b_idx[emit], minus[emit], pos[emit], sc[emit],
                     w_emit, ref_len, None, gapped, cigars), n_keep, n_valid


def seed_csr(cfg: MapperConfig, st, codes2, lookup):
    """Candidate anchors (B2, S, caph) from the CSR table or the bisulfite
    CSR pair in device_state ``st``: k-mer codes at the seed offsets, then
    ``lookup(km, bad, sfx)``, the hits in the strand's table (sfx "" or
    "_minus").  Bisulfite [FROZEN]: plus rows seed C->T-collapsed against
    the C->T genome index, minus (revcomp) rows G->A (GNUMAP-bs —
    conversion never breaks a seed); base-3 k-mer codes."""
    off, m = st["offsets"], cfg.mer_size
    if "digits_ct" in st:
        B = codes2.shape[0] // 2
        kmp, badp = seed_kmers_b3(codes2[:B], off, m, st["digits_ct"])
        kmm, badm = seed_kmers_b3(codes2[B:], off, m, st["digits_ga"])
        return torch.cat([lookup(kmp, badp, ""),
                          lookup(kmm, badm, "_minus")], dim=0)
    km, bad = seed_kmers(codes2, off, m)
    return lookup(km, bad, "")


def score_pairs(cfg: MapperConfig, emis2_t, cands, lens2, g_codes):
    """Scores of every (read-strand, candidate) pair, int32[B2, C]: banded
    (csrc/nw_band.cu), or unbanded when cfg.band() is None
    (csrc/nw_full.cu); the plain versions on the CPU."""
    kw = dict(L=cfg.max_read_len, W=cfg.window_width(), slack=cfg.gap_slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    if cfg.band() is None:
        return nw_full.nw_scores_full(emis2_t, cands, lens2, g_codes, **kw)
    boff, bw = cfg.band()
    return nw_band.nw_scores_banded(emis2_t, cands, lens2, g_codes,
                                    boff=boff, bw=bw, **kw)


def device_map(cfg: MapperConfig, st, codes, pwm_q, lens, seed, score):
    """The map program up to the scores, on device_state ``st``: strand
    expansion, max scores, ``seed(codes2)`` -> (cands, valid) and
    ``score(emis2_t, cands, lens2)`` -> int32[B2, C].  Returns (cands,
    valid, scores, max_sc, emis2_t, lens2), NEG_INF at invalid slots."""
    codes2, emis2 = strand_expand(codes, pwm_q, lens, st["S_plus"],
                                  st["S_minus"])
    max_sc = nw_ref.max_read_scores(emis2)
    cands, valid = seed(codes2)
    lens2 = torch.cat([lens, lens], dim=0)
    emis2_t = emis2.transpose(1, 2).contiguous()
    scores = torch.where(valid, score(emis2_t, cands, lens2), NEG_INF)
    return cands, valid, scores, max_sc, emis2_t, lens2


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA "
                           "card (torch.cuda.is_available() is False)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    return device


class TorchMapper:
    """Device-resident genome/index and the map program on one device.

    The counterpart of ``TpuMapper(align_impl="pallas", finish_impl=...,
    accumulate=...)``; ``index`` is a CsrIndex, a BsIndexPair
    (``cfg.bisulfite``), an FmIndex or an FmBsPair (``cfg.bisulfite``).
    ``finish_impl="device"`` (the default, None) retains, tracebacks and
    compacts on the device and the host decodes one blob;
    ``finish_impl="host"`` returns [cands | scores | max_sc] and the
    host finishes each read.  ``accumulate="device"`` (device finish only)
    keeps coverage and SNP tallies on the device (device_accumulate), and
    map_stream fetches them only at checkpoints and at the end."""

    def __init__(self, genome: Genome, index, cfg: MapperConfig,
                 device="cuda", finish_impl: Optional[str] = None,
                 accumulate: str = "host"):
        self.device = _require_device(device)
        self.finish_impl = "device" if finish_impl is None else finish_impl
        if self.finish_impl not in ("device", "host"):
            raise ValueError(f"finish_impl {finish_impl!r}: use 'device' or "
                             "'host'")
        if accumulate not in ("host", "device"):
            raise ValueError(f"accumulate {accumulate!r}: use 'host' or "
                             "'device'")
        if accumulate == "device" and self.finish_impl != "device":
            raise ValueError("accumulate='device' requires "
                             "finish_impl='device'")
        self.accumulate = accumulate
        if index.mer_size != cfg.mer_size:
            raise ValueError("index mer_size != cfg.mer_size")
        # seed-lookup backend: CSR (dense hash-as-arrays), FM (BWT), or the
        # bisulfite per-strand collapsed pair of either; identical candidate
        # sets per backend (index/fm.py docstring, builder.BsIndexPair)
        self.index_kind = index_kind(index)
        if cfg.bisulfite != self.index_kind.endswith("_bs"):
            raise ValueError(
                "bisulfite mode seeds on the per-strand collapsed alphabet "
                "[FROZEN]: build the index with builder.build_bs_index or "
                "fm.build_bs_fm_index (and only for bisulfite=True)")
        if self.index_kind == "fm_bs" and cfg.mer_size > 15:
            raise ValueError("FM bisulfite k-mer codes are base-4 int32: "
                             "mer_size <= 15 (the CSR pair's base-3 table "
                             "supports up to 18)")
        self.genome = genome
        self.cfg = cfg
        S_plus, S_minus = scoring.matrices_for_mode(cfg)
        self.S_plus_np, self.S_minus_np = S_plus, S_minus
        # the index lives on the device only: no path reads a host copy
        # after the upload (on the CPU the state shares the index's arrays)
        self.state = device_state(genome, index, cfg, self.device)
        # staging for map_stream's window: STREAM_DEPTH batches in flight
        # and the one being finished; a slot of its own for the capacity-
        # overflow fallback, which stages from inside a finish
        self._ring = StagingRing(self.device, STREAM_DEPTH + 1)
        self._spare = StagingRing(self.device, 1)
        # the device programs the JAX package jits, captured on a card at
        # their first call for a batch shape and replayed after it
        self._programs = Programs(self.device)
        # the accumulate program, captured on a card for each staging slot
        # and tier of n_keep (acc_tier) and replayed after it
        self._acc_programs = AccPrograms(self.device)
        if accumulate == "device":
            self.reset_accumulators()

    # ------------------------------------------------------------------
    # Device program
    # ------------------------------------------------------------------
    def _seed(self, codes2):
        """Candidate anchors per (read x strand) from the seed index:
        int32[B2, C] + valid."""
        cands = dedupe_cap(self._seed_hits(codes2), self.cfg.max_candidates)
        return cands, cands != SENTINEL

    def _seed_hits(self, codes2):
        """Every seed's index hits, before the dedupe: int32[B2, S, caph]
        anchors, SENTINEL at invalid slots (CSR gather or FM search)."""
        cfg, st = self.cfg, self.state
        off, m = st["offsets"], cfg.mer_size
        kind = self.index_kind

        def fm_args(sfx):
            return [st[k + sfx] for k in ("sa", "bwt_words", "occ",
                                          "c_table")]

        if kind == "fm_bs":
            # bisulfite on the FM backend: collapse the read halves, search
            # each in its collapsed FM index (base-4 codes suffice — no
            # dense bucket table to size)
            B = codes2.shape[0] // 2
            cp = torch.where(codes2[:B] == 1, 3, codes2[:B]).to(torch.int8)
            cm = torch.where(codes2[B:] == 2, 0, codes2[B:]).to(torch.int8)
            kmp, badp = seed_kmers(cp, off, m)
            kmm, badm = seed_kmers(cm, off, m)
            cand = torch.cat([
                fm_hits(kmp, badp, *fm_args(""), off, cfg),
                fm_hits(kmm, badm, *fm_args("_minus"), off, cfg)], dim=0)
        elif kind == "fm":
            km, bad = seed_kmers(codes2, off, m)
            cand = fm_hits(km, bad, *fm_args(""), off, cfg)
        else:
            cand = seed_csr(cfg, st, codes2, lambda km, bad, sfx: csr_hits(
                km, bad, st["bucket_start" + sfx], st["positions" + sfx],
                off, cfg))
        return cand

    def _device_map(self, codes, pwm_q, lens):
        """Scoring of every (read-strand, candidate) pair: (cands, valid,
        scores, max_sc) plus the emission tables (int32[B2, 5, L],
        contiguous) and lengths of the read-strands, which the device
        finish reuses."""
        g = self.state["g_codes"]
        return device_map(self.cfg, self.state, codes, pwm_q, lens,
                          self._seed, lambda e, c, l2: score_pairs(
                              self.cfg, e, c, l2, g))

    def _device_map_packed(self, codes, pwm_q, lens):
        """All outputs in ONE int32 blob: [cands | scores | max_sc]."""
        cands, _, scores, max_sc, _, _ = self._device_map(codes, pwm_q, lens)
        return torch.cat([cands, scores, max_sc[:, None]], dim=1)

    def _device_map_tb(self, codes, pwm_q, lens):
        """Scoring + exact retention + winner compaction + device traceback
        + indel compaction: ONE flat int32 blob (device_tb_tail)."""
        return device_tb_tail(self.cfg, *self._device_map(codes, pwm_q, lens),
                              self.state["g_codes"])

    def _unpack_pwm(self, packed, lens):
        """Quality-derived batches: reads arrive as ONE pack_reads uint8
        array; codes/quals unpack and the PWM builds on the device."""
        codes, quals = device_unpack(packed, self.cfg.max_read_len)
        return codes, device_pwm(codes, quals, lens,
                                 self.state["pwm_table"])

    def _device_map_packed_q(self, packed, lens):
        return self._device_map_packed(*self._unpack_pwm(packed, lens), lens)

    def _device_map_tb_q(self, packed, lens):
        return self._device_map_tb(*self._unpack_pwm(packed, lens), lens)

    # ------------------------------------------------------------------
    # [FROZEN v5] device accumulation (see device_accumulate)
    # ------------------------------------------------------------------
    def reset_accumulators(self):
        """(Re)zero the device-resident coverage / tally arrays, padded so
        that spans clipped at the genome's ends land in the pad.  Once
        allocated they are only ever updated in place, so that their
        addresses stay those the accumulate program's graphs hold."""
        if getattr(self, "_cov_dev", None) is not None:
            self._cov_dev.zero_()
            if self._tal_dev is not None:
                self._tal_dev.zero_()
            return
        Gpad = acc_padded_len(self.cfg, len(self.genome.codes))
        self._cov_dev = torch.zeros((Gpad // 128, 128), dtype=torch.float32,
                                    device=self.device)
        self._tal_dev = (torch.zeros((Gpad * 4 // 128, 128),
                                     dtype=torch.float32, device=self.device)
                         if self.cfg.snp_mode else None)

    def fetch_accumulators(self):
        """Device f32 accumulators -> host float64 (the [FROZEN v5] fetch
        boundary).  Returns (coverage, tallies-or-None)."""
        G = len(self.genome.codes)
        cov = self._cov_dev.reshape(-1)[:G].cpu().numpy().astype(np.float64)
        tal = (self._tal_dev.reshape(-1, 4)[:G].cpu().numpy().astype(
                   np.float64)
               if self._tal_dev is not None else None)
        return cov, tal

    def load_accumulators(self, cov, tal=None):
        """Resume from checkpointed host arrays (f64 -> f32), copied into
        the device arrays in place (reset_accumulators)."""
        G = len(self.genome.codes)
        Gpad = acc_padded_len(self.cfg, G)
        if getattr(self, "_cov_dev", None) is None:
            self.reset_accumulators()
        c = np.zeros((Gpad,), np.float32)
        c[:G] = np.asarray(cov)[:G]
        self._cov_dev.copy_(torch.from_numpy(c.reshape(-1, 128)))
        if tal is not None and self.cfg.snp_mode:
            t = np.zeros((Gpad, 4), np.float32)
            t[:G] = np.asarray(tal)[:G]
            self._tal_dev.copy_(torch.from_numpy(t.reshape(-1, 128)))

    def _device_map_acc(self, codes, pwm_q, lens):
        """The map program of the accumulate path: scoring and the device
        finish, keeping the per-hit rows and the both-strand PWM on the
        device for _apply_acc.  nvk = [n_valid, n_keep, n_indel] lets
        finish_acc detect both capacity overflows before any delta is
        applied."""
        cfg = self.cfg
        cands, valid, scores, max_sc, emis2_t, lens2 = self._device_map(
            codes, pwm_q, lens)
        _, rc_pwm = revcomp_batch(codes, pwm_q, lens)
        pwm2 = torch.cat([pwm_q, rc_pwm], dim=0)
        g = self.state["g_codes"]
        rows = device_hit_rows(cfg, cands, valid, scores, max_sc, emis2_t,
                               lens2, g)
        blob = device_tb_tail(cfg, cands, valid, scores, max_sc, emis2_t,
                              lens2, g, rows=rows)
        nvk = torch.stack([rows["n_valid"], rows["n_keep"], blob[-1]])
        return blob, rows, nvk, pwm2

    def _device_map_acc_q(self, packed, lens):
        return self._device_map_acc(*self._unpack_pwm(packed, lens), lens)

    def _apply_acc(self, rows, pwm2, n_live: int):
        """The accumulate program: [FROZEN v5] dedupe, weights and the
        ordered RMW into the device accumulators (in place), on the first
        n_live hit slots, which hold every hit (finish_acc passes
        acc_tier(n_keep, H)).  Returns device_accumulate's (stats,
        n_uniq)."""
        return device_accumulate(self.cfg, pwm2.shape[0] // 2, pwm2, rows,
                                 self._cov_dev, self._tal_dev, n_live=n_live)

    def _submit_acc(self, batch: ReadBatch):
        """[FROZEN v5.1] submit runs ONLY the map program; the accumulate
        program (_apply_acc) waits for finish_acc, so that capacity
        overflow is detected before any delta reaches the accumulators, and
        a checkpoint sees exactly ``batches_done`` batches: a submitted
        batch in flight has not touched them, and a resume replays it
        without double counting."""
        slot = self._ring.acquire()
        blob, rows, nvk, pwm2 = self._run_program(
            slot, batch, self._device_map_acc_q, self._device_map_acc)
        # finish_acc reads rows and pwm2 after up to STREAM_DEPTH later
        # submits, and a replay's outputs are overwritten by the next one:
        # the batch copies them into device buffers of its staging slot,
        # at the addresses the slot's accumulate graphs read
        rows = {k: slot.keep(k, rows[k]) for k in ACC_ROW_KEYS}
        return (rows, slot.keep("pwm2", pwm2), slot.fetch("nvk", nvk),
                slot.fetch("blob", blob) if self.cfg.sam_out else None)

    def finish_acc(self, batch: ReadBatch, dev_out,
                   stats: Optional[BatchStats] = None
                   ) -> BatchHits:
        """[FROZEN v5.1] Apply this batch's accumulation (deferred from
        submit), then decode the blob (SAM on: records only) or read the
        stats vector (SAM off: the host does nothing else per batch; the
        same copy brings home B5's unique blocks, counted and recorded in
        utils/profiling.py).  A capacity overflow (n_keep > H or n_indel >
        K) is detected before any delta is applied and goes through
        _finish_acc_overflow.  The accumulate program runs on the batch's
        tier of slots (acc_tier, recorded in utils/profiling.py): on a card
        the replay of the graph captured for the batch's staging slot and
        tier (pipeline/graphs.py AccPrograms)."""
        cfg = self.cfg
        B = batch.codes.shape[0]
        H = cfg.hit_capacity * 2 * B
        K = max(64, H // 32)
        rows, pwm2, (nvk, nvk_done), blob_out = dev_out
        with profiling.span("finish.wait") as w0:
            if nvk_done is not None:
                nvk_done.synchronize()
            n_valid, n_keep, n_indel = (int(x) for x in nvk.tolist())
        if n_keep > H or n_indel > K:
            return self._finish_acc_overflow(batch, n_keep, n_indel,
                                             n_valid, stats, w0.seconds)
        tier = acc_tier(n_keep, H)
        profiling.record("accumulate.tier", tier)
        with profiling.span("finish.accumulate"):
            stvec, n_uniq = self._acc_programs(
                self._apply_acc, rows, pwm2, tier,
                state=(self._cov_dev, self._tal_dev))
        with profiling.span("finish.wait") as w1:
            if cfg.sam_out:
                blob, done = blob_out
                if done is not None:
                    done.synchronize()
                arr = blob.numpy()
            else:
                # waits for the accumulate program
                arr = torch.cat([stvec, n_uniq.reshape(1)]).cpu().numpy()
        with profiling.span("finish.decode") as d:
            if cfg.sam_out:
                out, n_keep, n_valid = decode_tb_blob(
                    cfg, B, batch.n, batch.lens, arr)   # caps checked
                n_mapped, n_multi = _mapped_multi(out)
            else:
                n_mapped, n_multi, n_valid, n_keep, blocks = (
                    int(x) for x in arr)
                profiling.COUNTS["accumulate.blocks"] += blocks
                profiling.record("accumulate.blocks", blocks)
                out = BatchHits.empty(batch.n)
        profiling.COUNTS["accumulate.hits"] += n_keep
        if stats is not None:
            _add_stats(stats, cfg, batch.n, n_mapped, n_multi, n_valid,
                       w0.seconds + w1.seconds, d.seconds)
        return out

    def _finish_acc_overflow(self, batch: ReadBatch, n_keep: int,
                             n_indel: int, n_valid: int,
                             stats: Optional[BatchStats], wait_s: float
                             ) -> BatchHits:
        """Capacity-overflow fallback: the batch's deltas were not applied,
        so it is re-mapped on the exact host-finish path and its float64
        contributions fold into the device accumulators (fetch -> ordered
        host scatter -> f32 again).  Raise cfg.hit_capacity if this fires
        on every batch.  ``wait_s``: the finish's wait so far."""
        import logging
        cfg = self.cfg
        H = cfg.hit_capacity * 2 * batch.codes.shape[0]
        logging.getLogger(__name__).warning(
            "device-accumulation capacity overflow (n_keep=%d > H=%d or "
            "n_indel=%d > K=%d): exact host-path fallback for this batch",
            n_keep, H, n_indel, max(64, H // 32))
        profiling.COUNTS["finish.overflow"] += 1
        fallback = BatchStats()
        out = self.finish_host(batch, self._remap_packed(batch), fallback)
        with profiling.span("finish.decode") as d:
            cov, tal = self.fetch_accumulators()
            _scatter_coverage(cov, out)
            if cfg.snp_mode:
                _scatter_tallies(tal, batch, out)
            self.load_accumulators(cov, tal)
        if stats is not None:
            _add_stats(stats, cfg, batch.n, *_mapped_multi(out), n_valid,
                       wait_s + fallback.device_s,
                       fallback.host_s + d.seconds)
        return out

    @staticmethod
    def unpack_blob(blob, C):
        cands = blob[:, :C]
        scores = blob[:, C:2 * C]
        max_sc = blob[:, 2 * C]
        return cands, cands != SENTINEL, scores, max_sc

    def _remap_packed(self, batch: ReadBatch):
        """The capacity-overflow fallback's device program: the batch's
        [cands | scores | max_sc] blob, staged in a slot of its own and on
        its way back (the pair finish_host takes)."""
        slot = self._spare.acquire()
        return slot.fetch("blob", self._programs(
            self._device_map_packed, slot,
            codes=np.asarray(batch.codes, np.int8),
            pwm=np.asarray(batch.pwm_q, np.int32),
            lens=np.asarray(batch.lens, np.int32)))

    def _run_program(self, slot, batch: ReadBatch, fn_q, fn):
        """``fn_q`` on the batch's packed reads (quality-derived batches,
        pwm_arr None) or ``fn`` on its codes and PWMs, with its lengths,
        staged through ``slot``: eager on the CPU, a captured program
        replayed on a card (pipeline/graphs.py)."""
        lens = np.asarray(batch.lens, np.int32)
        if batch.pwm_arr is None:
            with profiling.span("submit.pack"):
                packed = pack_reads(batch.codes, batch.quals)
            return self._programs(fn_q, slot, packed=packed, lens=lens)
        return self._programs(fn, slot,
                              codes=np.asarray(batch.codes, np.int8),
                              pwm=np.asarray(batch.pwm_arr, np.int32),
                              lens=lens)

    # ------------------------------------------------------------------
    # Host finishing
    # ------------------------------------------------------------------
    def submit(self, batch: ReadBatch):
        """Enqueue the device program and the blob's copy back; pair with
        finish().  The copies go through a slot of the mapper's staging
        ring (pipeline/staging.py): on a card the H2D copies leave pinned
        buffers with non_blocking, the D2H copy lands in a pinned buffer,
        and an event marks its end, so map_stream overlaps device work with
        the host finish of earlier batches.  Quality-derived batches
        (pwm_arr None) ship quals and rebuild the PWM on the device.  On a
        card the program is a captured graph, replayed once a batch
        (pipeline/graphs.py); the blob's copy follows the replay on the
        same stream, before the next replay can overwrite it."""
        with profiling.span("submit"):
            if self.accumulate == "device":
                return self._submit_acc(batch)
            slot = self._ring.acquire()
            if self.finish_impl == "device":
                fns = self._device_map_tb_q, self._device_map_tb
            else:
                fns = self._device_map_packed_q, self._device_map_packed
            return slot.fetch("blob", self._run_program(slot, batch, *fns))

    def finish(self, batch: ReadBatch, dev_out,
               stats: Optional[BatchStats] = None) -> BatchHits:
        with profiling.span("finish"):
            if self.accumulate == "device":
                return self.finish_acc(batch, dev_out, stats)
            if self.finish_impl == "device":
                return self.finish_devtb(batch, dev_out, stats)
            return self.finish_host(batch, dev_out, stats)

    def finish_host(self, batch: ReadBatch, dev_out,
                    stats: Optional[BatchStats] = None
                    ) -> BatchHits:
        with profiling.span("finish.wait") as w:
            blob, done = dev_out
            if done is not None:
                done.synchronize()
            arr = blob.numpy()
        with profiling.span("finish.decode") as d:
            outputs = self.unpack_blob(arr, self.cfg.max_candidates)
            with profiling.span("finish.host"):
                out = BatchHits.from_lists(batch.n, host_finish(
                    self.genome, self.S_plus_np, self.S_minus_np, self.cfg,
                    batch, *outputs))
        if stats is not None:
            _update_stats(stats, self.cfg, batch, out, int(outputs[1].sum()),
                          w.seconds, d.seconds)
        return out

    def finish_devtb(self, batch: ReadBatch, dev_out,
                     stats: Optional[BatchStats] = None
                     ) -> BatchHits:
        """Decode the device traceback blob into the batch's hit table
        (decode_tb_blob: dedupe by (strand, pos), posterior weights).  No
        DP on the host.  Records the batch's ``finish.kept`` (n_keep) and
        ``finish.gapped`` (n_indel) in utils/profiling.py's value ring once,
        before the decode, so a batch that overflows records them too."""
        cfg = self.cfg
        with profiling.span("finish.wait") as w:
            blob, done = dev_out
            if done is not None:
                done.synchronize()
            blob = blob.numpy()
        n_keep, n_indel = int(blob[-3]), int(blob[-1])
        profiling.record("finish.kept", n_keep)
        profiling.record("finish.gapped", n_indel)
        B = batch.codes.shape[0]
        with profiling.span("finish.decode") as d:
            decoded = decode_tb_blob(cfg, B, batch.n, batch.lens, blob)
        if decoded is None:
            # capacity overflow (extreme repeat / indel batch): re-map on
            # the host-finish path, on the same device — exact, just slower
            # (raise cfg.hit_capacity if this fires on every batch)
            import logging
            H = cfg.hit_capacity * 2 * B
            logging.getLogger(__name__).warning(
                "device-finish hit-capacity overflow "
                "(n_keep=%d n_indel=%d, H=%d K=%d): host-path fallback",
                n_keep, n_indel, H, max(64, H // 32))
            profiling.COUNTS["finish.overflow"] += 1
            return self.finish_host(batch, self._remap_packed(batch), stats)
        out, _, n_valid = decoded
        if stats is not None:
            _update_stats(stats, cfg, batch, out, n_valid, w.seconds,
                          d.seconds)
        return out

    def map_batch(self, batch: ReadBatch,
                  stats: Optional[BatchStats] = None) -> BatchHits:
        return self.finish(batch, self.submit(batch), stats)


def _window_np(g_codes: np.ndarray, start: int, width: int) -> np.ndarray:
    out = np.full(width, 4, dtype=np.int8)
    lo, hi = max(start, 0), min(start + width, len(g_codes))
    if hi > lo:
        out[lo - start:hi - start] = g_codes[lo:hi]
    return out


# ---------------------------------------------------------------------------
# Streaming: map a read stream, accumulate outputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MapResult:
    coverage: Optional[np.ndarray]   # None when no output needs it
    tallies: Optional[np.ndarray]
    sam_lines: List[str]
    stats: BatchStats


def map_stream(mapper: TorchMapper, batches: Iterable[ReadBatch],
               collect_sam: bool = True, sam_file=None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 16,
               batch_callback=None) -> MapResult:
    """Map a batch stream.  With ``checkpoint_path``, stream state is saved
    every ``checkpoint_every`` batches and a restart resumes after the last
    checkpointed batch (SAM truncated to the recorded offset);
    ``batch_callback(idx, stats)`` fires after each batch."""
    from gnumap_tpu_torch.pipeline import checkpoint as ckpt_mod
    cfg = mapper.cfg
    gen = mapper.genome
    # [FROZEN v5] device accumulation: coverage / tallies live on the device
    # and are fetched only at checkpoints and at the end: no host arrays,
    # no per-batch scatter
    dev_acc = getattr(mapper, "accumulate", "host") == "device"
    # coverage RSS must not scale with genome length when nothing consumes it
    need_cov = (cfg.sgr_out or cfg.sgrex_out or cfg.snp_mode) and not dev_acc
    coverage = (np.zeros(len(gen.codes), dtype=np.float64)
                if need_cov else None)
    tallies = (np.zeros((len(gen.codes), 4), dtype=np.float64)
               if cfg.snp_mode and not dev_acc else None)
    sam_lines: List[str] = []
    stats = BatchStats()
    start_batch = 0
    if checkpoint_path:
        state = ckpt_mod.load(checkpoint_path)
        if state is not None:
            if dev_acc:
                mapper.load_accumulators(state.coverage, state.tallies)
            if state.coverage is not None and coverage is not None:
                coverage = state.coverage.astype(np.float64).copy()
            if state.tallies is not None and tallies is not None:
                tallies = state.tallies.astype(np.float64).copy()
            stats = state.stats
            start_batch = state.batches_done
            if sam_file is not None and sam_file.seekable():
                sam_file.seek(state.sam_offset)
                sam_file.truncate()
        batches = (b for i, b in enumerate(batches) if i >= start_batch)

    def emit(line: str):
        if sam_file is not None:
            sam_file.write(line)
        elif collect_sam:
            sam_lines.append(line)

    def results(depth: int = STREAM_DEPTH):
        """Keep ``depth`` batches in flight: device work overlaps host
        finishing/parsing.  A mapper without ``submit`` (DistMapper, whose
        collectives make each batch synchronous) maps one batch at a time."""
        from collections import deque
        if not hasattr(mapper, "submit"):
            for batch in batches:
                yield batch, mapper.map_batch(batch, stats)
            return
        q = deque()

        def finish_oldest():
            # the finished batch's staging is dropped here, before the
            # yield, so that its slot is free for the next submit
            pb, pf = q.popleft()
            return pb, mapper.finish(pb, pf, stats)

        for batch in batches:
            q.append((batch, mapper.submit(batch)))
            if len(q) > depth:
                yield finish_oldest()
        while q:
            yield finish_oldest()

    # Native batch SAM formatter: one C call per batch, byte-identical to
    # the io/sam.py records.
    from gnumap_tpu_torch.native import lib as native_lib
    use_native_sam = cfg.sam_out and native_lib.available()
    batch_idx = start_batch
    _ck_fut: list = [None]
    try:
        for batch, result in results():
            with profiling.span("stream.walk"):
                # one table a batch, whatever the mapper returned
                hits = BatchHits.of(result)
                # genome-partitioned multi-host SAM: the mapper decides, per
                # read, whether THIS host owns its records
                # (segments.GlobalSegmentedMapper sets gp_sam each batch)
                gp = (getattr(mapper, "gp_sam", None)
                      if cfg.sam_out and getattr(mapper, "num_hosts", 1) > 1
                      else None)
                gp_host = getattr(mapper, "host_id", 0)
                if cfg.sam_out and not use_native_sam:
                    _emit_sam_py(emit, gen, batch, hits.to_lists(), gp,
                                 gp_host)
            if use_native_sam:
                with profiling.span("stream.sam_format"):
                    text = format_sam_batch_native(gen, batch, hits,
                                                   gp=gp, host_id=gp_host)
                with profiling.span("stream.emit"):
                    emit(text)
            if coverage is not None or tallies is not None:
                with profiling.span("stream.scatter"):
                    if coverage is not None:
                        _scatter_coverage(coverage, hits)
                    if tallies is not None:
                        _scatter_tallies(tallies, batch, hits)
            batch_idx += 1
            # callbacks run BEFORE the checkpoint: callback-written
            # artifacts must be on disk before a checkpoint state that
            # references this batch can become visible
            if batch_callback is not None:
                batch_callback(batch_idx, stats)
            if checkpoint_path and batch_idx % checkpoint_every == 0:
                # snapshot on the stream thread, serialize + write on a
                # background thread; one write in flight at most
                with profiling.span("stream.checkpoint"):
                    if _ck_fut[0] is not None:
                        _ck_fut[0].result()
                        _ck_fut[0] = None
                    off = 0
                    if sam_file is not None:
                        sam_file.flush()
                        off = sam_file.tell()
                    if dev_acc:
                        with profiling.span("stream.fetch_acc"):
                            cov_ck, tal_ck = mapper.fetch_accumulators()
                    else:
                        cov_ck = None if coverage is None else coverage.copy()
                        tal_ck = None if tallies is None else tallies.copy()
                    st_ck = ckpt_mod.StreamState(
                        batch_idx, cov_ck, tal_ck, dataclasses.replace(stats),
                        off)
                    _ck_fut[0] = _ck_pool().submit(
                        ckpt_mod.save, checkpoint_path, st_ck)
    finally:
        # join any in-flight checkpoint write so callers see a complete
        # on-disk state
        if _ck_fut[0] is not None:
            _ck_fut[0].result()
    if dev_acc:
        with profiling.span("stream.fetch_acc"):
            coverage, tallies = mapper.fetch_accumulators()
        if not (cfg.sgr_out or cfg.sgrex_out or cfg.snp_mode):
            coverage = None
    return MapResult(coverage, tallies, sam_lines, stats)


def _emit_sam_py(emit, gen: Genome, batch: ReadBatch, hits_per_read, gp,
                 gp_host: int) -> None:
    """One batch's SAM records through io/sam.py, a record at a time (no
    native library); ``gp`` as in format_sam_batch_native."""
    qbytes = (batch.quals[:batch.n] + 33).astype(np.uint8)
    for b, hits in enumerate(hits_per_read):
        L = int(batch.lens[b])
        codes = batch.codes[b, :L]
        seq = packing.decode(codes)
        qual = qbytes[b, :L].tobytes().decode("ascii")
        if not hits:
            if not (gp is not None
                    and (bool(gp["mapped"][b]) or gp_host != 0)):
                emit(sam_io.unmapped_record(batch.names[b], seq, qual))
            continue
        profiling.COUNTS["hits.multi"] += len(hits) > 1
        for hi, h in enumerate(hits):
            ci, off = gen.locate(h.pos)
            sec = (hi > 0) if h.primary is None else not h.primary
            profiling.COUNTS["sam.secondary"] += sec
            flag = (16 if h.strand == "-" else 0) | (256 if sec else 0)
            if h.strand == "-":
                oseq = packing.decode(packing.revcomp(codes))
                oqual = qual[::-1]
            else:
                oseq, oqual = seq, qual
            emit(sam_io.record(
                batch.names[b], flag, gen.names[int(ci)], int(off),
                sam_io.mapq_from_weight(h.weight), h.cigar, oseq, oqual,
                h.score, h.weight))


def format_sam_batch_native(gen: Genome, batch: ReadBatch, hits_per_read,
                            gp=None, host_id: int = 0) -> str:
    """One batch of SAM records via the native formatter — byte-identical
    to the per-record io/sam.py path.  ``hits_per_read``: the batch's
    BatchHits, or per-read ReadHit lists (through BatchHits.from_lists).
    ``gp``: genome-partitioned multi-host metadata (segments.gp_sam) — a
    read with no LOCAL hits emits nothing when another host owns its
    records (globally mapped, or unmapped with host_id != 0)."""
    from gnumap_tpu_torch.config import SCORE_ONE
    from gnumap_tpu_torch.native import lib as native_lib
    hits = BatchHits.of(hits_per_read)
    n = batch.n
    lens = batch.lens
    per_read = hits.counts()
    none = per_read == 0
    if gp is not None:
        skip = none & (np.asarray(gp["mapped"][:n], bool) | (host_id != 0))
        unmapped = (none & ~skip).astype(np.uint8)
        skip = skip.astype(np.uint8)
    else:
        unmapped, skip = none.astype(np.uint8), None
    # secondary: a hit after its read's first, or primary False
    rank = np.arange(len(hits.read)) - hits.offsets[hits.read]
    sec = np.where(hits.primary < 0, rank > 0, hits.primary == 0)
    profiling.COUNTS["sam.secondary"] += int(sec.sum())
    profiling.COUNTS["hits.multi"] += int((per_read > 1).sum())
    flags = hits.minus.astype(np.int32) * 16 | sec.astype(np.int32) * 256
    # CIGARs: "" (a pure match of the read's length) but where given
    cig_b = [c.encode() for c in hits.cigars]
    cig_len = np.zeros(len(hits.read), np.int64)
    cig_len[hits.cig_idx] = [len(c) for c in cig_b]
    cig_off = np.zeros(len(hits.read) + 1, np.int64)
    np.cumsum(cig_len, out=cig_off[1:])
    w = hits.weight
    if len(w):
        ci, off = gen.locate(hits.pos)
        ci, off = np.atleast_1d(ci), np.atleast_1d(off)
        # frozen mapq formula (io/sam.py mapq_from_weight): np.round is
        # round-half-even, same as Python round()
        with np.errstate(divide="ignore"):
            mq = np.where(
                w >= 1.0 - 1e-12, 60,
                np.clip(np.round(-10.0 * np.log10(
                    np.maximum(1e-12, 1.0 - w))), 0, 60)).astype(np.int32)
    else:
        ci = off = mq = np.zeros(0, np.int32)
    sc = hits.score
    view, n_slow = native_lib.format_sam_batch_view(
        batch.codes[:n], batch.quals[:n], lens[:n], batch.names[:n],
        gen.names, hits.read, flags, ci.astype(np.int32),
        off.astype(np.int64), mq, (b"".join(cig_b), cig_off), sc,
        sc.astype(np.float64) / SCORE_ONE, w, unmapped, skip=skip)
    profiling.COUNTS["sam.float_slow"] += n_slow
    # one pass from the reused output buffer to the str the sink takes
    return codecs.utf_8_decode(view)[0]


def _scatter_coverage(coverage: np.ndarray, hits: BatchHits) -> None:
    """One ordered scatter over all of a batch's hits, bit-identical to the
    per-hit ``coverage[pos:pos+ref_len] += w`` loop.  Native C++ when
    available; NumPy ordered np.add.at otherwise."""
    if not len(hits.pos):
        return
    G = coverage.shape[0]
    pos = hits.pos
    rl = hits.ref_len.astype(np.int64)
    w = hits.weight
    from gnumap_tpu_torch.native import lib as native_lib
    if native_lib.available():
        native_lib.scatter_coverage(coverage, pos, rl, w)
        return
    ar = np.arange(int(rl.max()) if len(rl) else 0, dtype=np.int64)
    idx = pos[:, None] + ar[None, :]
    ok = (ar[None, :] < rl[:, None]) & (idx >= 0) & (idx < G)
    np.add.at(coverage, np.where(ok, idx, 0).ravel(),
              np.where(ok, w[:, None], 0.0).ravel())


def _scatter_tallies(tallies: np.ndarray, batch: ReadBatch,
                     hits: BatchHits) -> None:
    """Batched SNP tally scatter-add (per-base fractional A/C/G/T counts)
    of a batch's hits in their order.  One ordered scatter, bit-identical
    to the per-hit loop."""
    from gnumap_tpu_torch.config import PWM_SCALE
    if not len(hits.pos):
        return
    G = tallies.shape[0]
    pw = batch.pwm_q
    Lmax = pw.shape[1]
    ar = np.arange(Lmax, dtype=np.int64)
    lens = batch.lens.astype(np.int64)
    from gnumap_tpu_torch.native import lib as native_lib
    if native_lib.available():
        cigars = [""] * len(hits.pos)
        for i, c in zip(hits.cig_idx.tolist(), hits.cigars):
            cigars[i] = c
        native_lib.scatter_tallies(
            tallies, pw, batch.lens, hits.read, hits.minus, hits.pos,
            hits.weight, cigars, PWM_SCALE)
        return
    if not hits.cigars:
        b_idx = hits.read.astype(np.int64)
        minus = hits.minus.astype(bool)
        pos = hits.pos
        w = hits.weight
        ln = lens[b_idx]
        sel = pw[b_idx]                                      # (H, Lmax, 4)
        # minus hits use the reverse-complemented PWM of rows [0, len)
        mrows = np.nonzero(minus)[0]
        if len(mrows):
            src = np.clip(ln[mrows, None] - 1 - ar[None, :], 0, Lmax - 1)
            sel[mrows] = np.take_along_axis(
                sel[mrows], src[:, :, None], axis=1)[:, :, ::-1]
        # value = w * (p / PWM_SCALE), masked positions contribute +0.0
        vals = sel.astype(np.float64)
        np.divide(vals, PWM_SCALE, out=vals)
        np.multiply(vals, w[:, None, None], out=vals)
        idx = pos[:, None] + ar[None, :]
        ok = (ar[None, :] < ln[:, None]) & (idx >= 0) & (idx < G)
        np.multiply(vals, ok[:, :, None], out=vals)
        np.add.at(tallies, np.where(ok, idx, 0).ravel(),
                  vals.reshape(-1, 4))
        return
    # mixed batch (gapped CIGARs present): per-hit chunks, still one
    # ordered scatter
    idx_chunks: List[np.ndarray] = []
    val_chunks: List[np.ndarray] = []
    cigar_of = dict(zip(hits.cig_idx.tolist(), hits.cigars))
    for h, (b, minus, pos, w) in enumerate(zip(
            hits.read.tolist(), hits.minus.tolist(), hits.pos.tolist(),
            hits.weight.tolist())):
        L = int(lens[b])
        p_np = pw[b, :L]
        p_s = (pwm_mod.pwm_revcomp(p_np) if minus else p_np)
        cigar = cigar_of.get(h, f"{L}M")
        gp, i = pos, 0
        for num, op in oracle._iter_cigar(cigar):
            if op == "M":
                gi = np.arange(gp, gp + num, dtype=np.int64)
                ok = (gi >= 0) & (gi < G)
                v = w * (p_s[i:i + num].astype(np.float64) / PWM_SCALE)
                idx_chunks.append(np.where(ok, gi, 0))
                val_chunks.append(np.where(ok[:, None], v, 0.0))
                gp += num
                i += num
            elif op == "D":
                gp += num
            elif op == "I":
                i += num
    if idx_chunks:
        np.add.at(tallies, np.concatenate(idx_chunks),
                  np.concatenate(val_chunks))


def _traceback(emis_np, window, cfg):
    """Native C++ traceback when available, bit-identical to
    oracle.nw_align."""
    from gnumap_tpu_torch.native import lib as native_lib
    if native_lib.available():
        return native_lib.nw_traceback(
            emis_np, window, cfg.gap_open_q(), cfg.gap_extend_q(), NEG_INF,
            band=cfg.band())
    return oracle.nw_align(emis_np, window, cfg, traceback=True)


def finish_read(genome: Genome, cfg: MapperConfig, strand_rows
                ) -> List[ReadHit]:
    """Threshold + traceback + dedupe + posterior for one read.

    strand_rows: {strand: (cands, valid, scores, max_sc, emis_np)}
    Frozen semantics identical to oracle.map_read.
    """
    retained: List[Tuple[str, int, int]] = []
    for strand, (cands, valid, scs, max_sc, _) in strand_rows.items():
        thr = cfg.threshold_for(int(max_sc))
        keep = valid & (scs >= thr) & (scs > 0)
        for c in np.nonzero(keep)[0]:
            retained.append((strand, int(cands[c]), int(scs[c])))
    if not retained:
        return []
    W = cfg.window_width()
    best: Dict[Tuple[str, int], ReadHit] = {}
    for strand, cand, score in retained:
        emis_np = strand_rows[strand][4]
        win_start = cfg.window_start(cand)
        window = _window_np(genome.codes, win_start, W)
        sc2, pos_in_w, cigar, ref_len = _traceback(emis_np, window, cfg)
        pos = win_start + pos_in_w
        key = (strand, pos)
        if key not in best or sc2 > best[key].score:
            best[key] = ReadHit(strand, pos, sc2, 0.0, cigar, ref_len)
    hits = list(best.values())
    total = float(sum(h.score for h in hits))
    for h in hits:
        h.weight = h.score / total
    hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
    return hits


_CK_POOL = None


def _ck_pool():
    """Single background writer for async stream checkpoints."""
    global _CK_POOL
    if _CK_POOL is None:
        import concurrent.futures
        _CK_POOL = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="gnumap-ckpt")
    return _CK_POOL


_FINISH_POOL = None


def _finish_pool():
    global _FINISH_POOL
    if _FINISH_POOL is None:
        import concurrent.futures
        n = min(4, max(1, (os.cpu_count() or 2)))
        _FINISH_POOL = concurrent.futures.ThreadPoolExecutor(n)
    return _FINISH_POOL


def host_finish(genome: Genome, S_plus_np, S_minus_np, cfg: MapperConfig,
                batch: ReadBatch, cands, valid, scores, max_sc
                ) -> List[List[ReadHit]]:
    """Per-read host finishing over canonical-layout device outputs
    (row b = '+' strand of read b, row b + B = '-' strand).

    Vectorized retention pre-pass selects the reads that need a traceback;
    those are finished by the native batch finisher, or on a thread pool
    (the native traceback releases the GIL)."""
    B = batch.codes.shape[0]
    n = batch.n
    # vectorized retention over the whole batch (exact integer rational,
    # same as MapperConfig.threshold_for)
    thr = (cfg.ratio_q() * max_sc.astype(np.int64)
           + (1 << RATIO_BITS) - 1) >> RATIO_BITS
    keep = valid & (scores >= thr[:, None]) & (scores > 0)
    any_keep = keep.any(axis=1)
    need = np.nonzero(any_keep[:B][:n] | any_keep[B:B + n])[0]

    out: List[List[ReadHit]] = [[] for _ in range(n)]

    from gnumap_tpu_torch.native import lib as native_lib
    if len(need) > 16 and native_lib.available():
        rows_k, cols_k = np.nonzero(keep)
        sel = (rows_k % B) < n
        rows_k, cols_k = rows_k[sel], cols_k[sel]
        read_idx = (rows_k % B).astype(np.int32)
        strand = (rows_k >= B).astype(np.int8)
        cand_arr = cands[rows_k, cols_k].astype(np.int32)
        scores2, pos_arr, rl_arr, cigars = native_lib.finish_hits(
            batch.pwm_q, batch.lens, genome.codes, S_plus_np, S_minus_np,
            read_idx, strand, cand_arr, cfg.max_read_len,
            cfg.window_width(), cfg.gap_slack, cfg.gap_open_q(),
            cfg.gap_extend_q(), NEG_INF, band=cfg.band())
        # group per read, dedupe by (strand, pos), normalize weights
        per_read: Dict[int, Dict[Tuple[str, int], ReadHit]] = {}
        for h in range(len(read_idx)):
            b = int(read_idx[h])
            st = "-" if strand[h] else "+"
            key = (st, int(pos_arr[h]))
            d = per_read.setdefault(b, {})
            sc2 = int(scores2[h])
            if key not in d or sc2 > d[key].score:
                d[key] = ReadHit(st, int(pos_arr[h]), sc2, 0.0,
                                 cigars[h], int(rl_arr[h]))
        for b, d in per_read.items():
            hits = list(d.values())
            total = float(sum(hh.score for hh in hits))
            for hh in hits:
                hh.weight = hh.score / total
            hits.sort(key=lambda hh: (hh.pos,
                                      0 if hh.strand == "+" else 1))
            out[b] = hits
        return out

    def work(b: int):
        L = int(batch.lens[b])
        p_np = batch.pwm_q[b, :L]
        rows = {}
        for si, strand in ((0, "+"), (1, "-")):
            r = b + si * B
            rows[strand] = (cands[r], valid[r], scores[r], max_sc[r],
                            scoring.emission_int(
                                p_np if strand == "+" else
                                pwm_mod.pwm_revcomp(p_np),
                                S_plus_np if strand == "+" else S_minus_np))
        return b, finish_read(genome, cfg, rows)

    if len(need) > 64:
        for b, hits in _finish_pool().map(work, need.tolist()):
            out[b] = hits
    else:
        for b in need.tolist():
            out[b] = work(b)[1]
    return out


def _mapped_multi(out) -> Tuple[int, int]:
    """(reads with a hit, reads with more than one) of a finish result."""
    if isinstance(out, BatchHits):
        k = out.counts()
        return int((k > 0).sum()), int((k > 1).sum())
    return sum(1 for h in out if h), sum(1 for h in out if len(h) > 1)


def _update_stats(stats: BatchStats, cfg: MapperConfig, batch: ReadBatch,
                  out, n_valid: int, device_s: float, host_s: float) -> None:
    _add_stats(stats, cfg, batch.n, *_mapped_multi(out), n_valid, device_s,
               host_s)


def _add_stats(stats: BatchStats, cfg: MapperConfig, n_reads: int,
               n_mapped: int, n_multi: int, n_valid: int, device_s: float,
               host_s: float) -> None:
    stats.n_reads += n_reads
    stats.n_mapped += n_mapped
    stats.n_multi += n_multi
    stats.n_candidates += n_valid
    rect, band = _cells_per_cand(cfg)
    stats.dp_cells += n_valid * cfg.max_read_len * rect
    stats.dp_cells_banded += n_valid * cfg.max_read_len * band
    stats.device_s += device_s
    stats.host_s += host_s
