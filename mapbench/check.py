"""What decides ``correct``: the window's own outputs held to the plain
reference (``mapbench/reference``) on a sample drawn from the seed, after
the window has closed and the program's device state is freed.

* Every run: each batch fed in the window came back with a result for each
  of its reads (``reads_lost``).
* SAM cells: every SAM cell's batches hold a record or more per read
  (``batches_short``), and ``SAM_SAMPLE`` reads drawn from the batches the
  sink kept have exactly the records the reference writes for them
  (``sam_reads_differ``): flag, contig, position, MAPQ, CIGAR, sequence,
  qualities, score and weight.
* SNP cells: at ``N_UNIQUE`` regions drawn anywhere and ``N_FAMILY`` regions
  drawn inside repeat-family copies, the coverage and the four tallies the
  stream returned lie within the limit of the reference's float64 sums of
  every read that can map there, each counted as often as the stream and
  the warm-up fed it (``cov_gap``, ``tally_gap``: the largest difference
  over max(|reference|, 1)).

The control, in the program's place, is the reference one precision down:
16-bit DP cells for the scores (``CONTROL_SHIFT``), bfloat16 accumulators
for the pileup.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from mapbench.genome import SimGenome, rng_for
from mapbench.reference import batched, oracle
from mapbench.reference.consts import SCORE_ONE, RefConfig
from mapbench.traffic import Pool, names_at

SAM_SAMPLE = 2048
KEEP_EVERY = 16
N_UNIQUE = 48
N_FAMILY = 4
REGION = 32
CONTROL_SHIFT = 10
_ACGT = "ACGTN"


@dataclasses.dataclass
class Context:
    """What the check needs besides the window: the inputs the benchmark
    made, the configuration and the warm-up's feeds."""
    genome: SimGenome
    pool: Pool
    ref_cfg: RefConfig
    batch: int
    warm_feeds: int
    device: str
    seed: int
    limits: Dict[str, float]


def ref_genome(ctx: Context) -> batched.RefGenome:
    og = oracle.OracleGenome.from_codes([(ctx.genome.contig,
                                          ctx.genome.codes)])
    return batched.RefGenome(og.codes, og.names, og.starts, ctx.device)


def n_pool_batches(ctx: Context) -> int:
    return ctx.pool.n // ctx.batch


def pool_rows(ctx: Context, index: int) -> np.ndarray:
    b = index % n_pool_batches(ctx)
    return np.arange(b * ctx.batch, (b + 1) * ctx.batch)


def base_checks(window) -> Dict[str, float]:
    rec = window.rec
    lost = sum(b.n_reads - (b.n_out if b.done > 0 else 0)
               for b in rec.batches)
    out = {"reads_lost": float(lost)}
    if window.sink is not None:
        out["batches_short"] = float(sum(
            1 for b in rec.batches
            if window.sink.records.get(b.index, 0) < b.n_reads))
    return out


# ---------------------------------------------------------------------------
# SAM cells
# ---------------------------------------------------------------------------

def mapq(w: float) -> int:
    if w >= 1.0 - 1e-12:
        return 60
    return max(0, min(60, int(round(-10.0 * math.log10(
        max(1e-12, 1.0 - w))))))


def sam_records(ctx: Context, rg: batched.RefGenome, i: int, name: str,
                hits: List[batched.RefHit]) -> List[str]:
    """The SAM records of pool read ``i``, as ``io/sam.py`` writes them."""
    codes, quals = ctx.pool.codes[i], ctx.pool.quals[i]
    seq = "".join(_ACGT[c] for c in codes)
    qual = "".join(chr(33 + int(q)) for q in quals)
    if not hits:
        return [f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}"]
    out = []
    for hi, h in enumerate(hits):
        ci, off = rg.locate(np.array([h.pos]))
        flag = (16 if h.strand == "-" else 0) | (256 if hi else 0)
        s, q = (seq, qual) if h.strand == "+" else (
            "".join(_ACGT[c] for c in oracle.revcomp(codes)), qual[::-1])
        out.append(f"{name}\t{flag}\t{rg.names[int(ci[0])]}\t"
                   f"{int(off[0]) + 1}\t{mapq(h.weight)}\t{h.cigar}\t*\t0\t0"
                   f"\t{s}\t{q}\tAS:i:{h.score}\t"
                   f"XS:f:{h.score / SCORE_ONE:.4f}\tXP:f:{h.weight:.6f}")
    return out


def _sam_sample(window, ctx: Context):
    """(window batch index, row) pairs drawn from the kept batches."""
    kept = sorted(window.sink.kept)
    pairs = [(k, r) for k in kept
             for r in range(window.rec.batches[k].n_reads)]
    rng = rng_for(ctx.seed, 2)
    pick = rng.choice(len(pairs), size=min(SAM_SAMPLE, len(pairs)),
                      replace=False)
    return [pairs[p] for p in np.sort(pick)]


def check_sam(window, ctx: Context, control: bool = False) -> dict:
    """``sam_reads_differ`` of the program (and of the control)."""
    sample = _sam_sample(window, ctx)
    by_batch: Dict[int, Dict[str, List[str]]] = {}
    for k in {k for k, _ in sample}:
        lines: Dict[str, List[str]] = {}
        for line in "".join(window.sink.kept[k]).splitlines():
            lines.setdefault(line.split("\t", 1)[0], []).append(line)
        by_batch[k] = lines
    idx = np.array([pool_rows(ctx, k)[r] for k, r in sample], np.int64)
    names = names_at(ctx.pool, ctx.genome.contig, idx)
    rg = ref_genome(ctx)
    uniq, inv = np.unique(idx, return_inverse=True)
    ref = batched.map_reads(ctx.pool.codes[uniq], ctx.pool.quals[uniq], rg,
                            ctx.ref_cfg)
    ctl = (batched.map_reads(ctx.pool.codes[uniq], ctx.pool.quals[uniq],
                             rg, ctx.ref_cfg, shift=CONTROL_SHIFT)
           if control else None)
    differ = ctl_differ = 0
    n_mapped = n_multi = n_gapped = 0
    for t, (k, _) in enumerate(sample):
        u = int(inv[t])
        want = sam_records(ctx, rg, int(idx[t]), names[t], ref[u])
        got = by_batch[k].get(names[t], [])
        differ += got != want
        n_mapped += bool(ref[u])
        n_multi += len(ref[u]) > 1
        n_gapped += any(("I" in h.cigar or "D" in h.cigar) for h in ref[u])
        if ctl is not None:
            ctl_differ += sam_records(ctx, rg, int(idx[t]), names[t],
                                      ctl[u]) != want
    out = dict(numbers={"sam_reads_differ": float(differ)},
               info=dict(sampled=len(sample), ref_mapped=n_mapped,
                         ref_multi=n_multi, ref_gapped=n_gapped,
                         kept_batches=len(window.sink.kept)))
    if control:
        out["control"] = {"sam_reads_differ": float(ctl_differ)}
    return out


def truth_accuracy(window, ctx: Context) -> Optional[float]:
    """The reference bench's rule on the kept batches' records: a mapped
    read is right when a co-best record lies within 3 bases of its truth
    on its strand."""
    if window.sink is None:
        return None
    best: Dict[str, list] = {}
    for texts in window.sink.kept.values():
        for line in "".join(texts).splitlines():
            f = line.split("\t")
            if f[1] == "4":
                continue
            w = float(f[13][5:])
            best.setdefault(f[0], []).append((w, int(f[3]) - 1,
                                              "-" if int(f[1]) & 16 else "+"))
    ok = 0
    for name, recs in best.items():
        parts = name.split("_")
        tpos, tstr = int(parts[-2]), parts[-1]
        top = max(w for w, _, _ in recs)
        ok += any(w == top and abs(p - tpos) <= 3 and s == tstr
                  for w, p, s in recs)
    return ok / max(len(best), 1)


# ---------------------------------------------------------------------------
# SNP cells
# ---------------------------------------------------------------------------

def _regions(ctx: Context) -> List[tuple]:
    rng = rng_for(ctx.seed, 3)
    g = ctx.genome
    G = len(g.codes)
    regs = [(int(s), int(s) + REGION)
            for s in rng.integers(0, G - REGION, size=N_UNIQUE)]
    if g.spots:
        for _ in range(N_FAMILY):
            f = int(rng.integers(0, len(g.spots)))
            c = int(rng.integers(0, len(g.spots[f])))
            o = int(rng.integers(0, g.unit_len - REGION + 1))
            s = int(g.spots[f][c]) + o
            regs.append((s, s + REGION))
    return regs


def _sites(ctx: Context, regions: List[tuple], margin: int) -> List[tuple]:
    """Every genome interval whose sequence a region's reads could match:
    the region, and where a family copy lies near it, the same stretch of
    every copy of that family."""
    g = ctx.genome
    sites = list(regions)
    if not g.spots:
        return sites
    ul = g.unit_len
    for lo, hi in regions:
        for spots in g.spots:
            near = spots[(spots < hi + margin) & (spots + ul > lo - margin)]
            for s in near:
                sites += [(int(t) + lo - int(s), int(t) + hi - int(s))
                          for t in spots]
    return sites


def _feeds(window, ctx: Context) -> List[np.ndarray]:
    """Feed ranks of every pool read: the warm-up's feeds of the first
    pool batch, then the window's batches in order."""
    events = [0] * ctx.warm_feeds + [b.index % n_pool_batches(ctx)
                                     for b in window.rec.batches]
    count = np.zeros(ctx.pool.n, np.int64)
    feeds: List[np.ndarray] = []
    for e, pb in enumerate(events):
        rows = np.arange(pb * ctx.batch, (pb + 1) * ctx.batch)
        t = count[rows[0]]
        if t == len(feeds):
            feeds.append(np.full(ctx.pool.n, -1, np.int64))
        feeds[t][rows] = e * ctx.batch + np.arange(ctx.batch)
        count[rows] += 1
    return feeds


def check_snp(window, ctx: Context, control: bool = False) -> dict:
    """``cov_gap`` and ``tally_gap`` of the program (and of the
    control)."""
    pool = ctx.pool
    L = pool.read_len
    margin = L + 2 * ctx.ref_cfg.gap_slack + 16
    regions = _regions(ctx)
    positions = np.unique(np.concatenate([np.arange(a, b)
                                          for a, b in regions]))
    order = np.argsort(pool.pos, kind="stable")
    spos = pool.pos[order]
    cand = []
    for lo, hi in _sites(ctx, regions, margin):
        a, b = np.searchsorted(spos, [lo - margin, hi + margin])
        cand.append(order[a:b])
    reads = np.unique(np.concatenate(cand))
    feeds = _feeds(window, ctx)
    mult = sum((f >= 0).astype(np.int64) for f in feeds)
    reads = reads[mult[reads] > 0]
    rg = ref_genome(ctx)
    hits = batched.map_reads(pool.codes[reads], pool.quals[reads], rg,
                             ctx.ref_cfg)
    lookup = np.full(len(rg.codes), -1, np.int64)
    lookup[positions] = np.arange(len(positions))
    pwm = oracle.pwm_from_calls(pool.codes[reads], pool.quals[reads])
    cov_t, tal_t = batched.contributions(hits, pwm, lookup)
    m = mult[reads]
    ref_cov = batched.sum_f64(cov_t, m, len(positions), None)
    ref_tal = batched.sum_f64(tal_t, m, len(positions), 4)
    res = window.result
    got_cov = np.asarray(res.coverage)[positions]
    got_tal = np.asarray(res.tallies)[positions]

    def gap(got, want):
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), 1.0)))

    out = dict(numbers={"cov_gap": gap(got_cov, ref_cov),
                        "tally_gap": gap(got_tal, ref_tal)},
               info=dict(positions=len(positions), reads=len(reads),
                         ref_hits=sum(len(h) for h in hits),
                         covered=int((ref_cov > 0).sum()),
                         ref_cov_sum=float(ref_cov.sum()),
                         ref_multi=sum(len(h) > 1 for h in hits)))
    if control:
        local = [f[reads] for f in feeds]
        ctl_cov = batched.sum_low(cov_t, local, len(positions), None)
        ctl_tal = batched.sum_low(tal_t, local, len(positions), 4)
        out["control"] = {"cov_gap": gap(ctl_cov, ref_cov),
                          "tally_gap": gap(ctl_tal, ref_tal)}
    return out


def judge(window, ctx: Context, control: bool = False) -> dict:
    """Every number compared, with its limit, and ``correct``."""
    base = base_checks(window)
    if window.sink is not None:
        part = check_sam(window, ctx, control)
    else:
        part = check_snp(window, ctx, control)
    numbers = dict(base, **part["numbers"])
    limits = {k: ctx.limits.get(k, 0.0) for k in numbers}
    out = dict(numbers=numbers, limits=limits, info=part["info"],
               correct=all(numbers[k] <= limits[k] for k in numbers))
    if control:
        ctl = dict(base, **part["control"])
        out["control"] = ctl
        out["control_correct"] = all(ctl[k] <= limits[k] for k in ctl)
    return out
