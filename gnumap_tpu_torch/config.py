"""MapperConfig — the single frozen configuration object for the whole mapper.

Mirrors the semantic knobs of the reference GNUMAP CLI (mer size ``-m``, seed
jump ``-j``, align-score ratio ``-a``, gap penalties, max hits cap, bisulfite
toggle, thread/shard counts...).  Reference provenance: the reference mount was
empty this round (SURVEY.md §0), so flag *semantics* come from the GNUMAP
papers (Clement et al. 2010; GNUMAP-bs; GNUMAP-SNP) as catalogued in
SURVEY.md §5 "Config / flag system"; exact default values are frozen here and
documented as OUR defaults.

All scoring is integer fixed-point so that the NumPy oracle, the jnp reference
aligner and the Pallas TPU kernel produce bit-identical scores on every
platform (SURVEY.md §7 "hard parts": bit-identical scores).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Fixed-point scales (frozen; change requires regenerating all golden files).
# ---------------------------------------------------------------------------
# Per-base probabilities are quantized to integers summing to PWM_SCALE.
PWM_SCALE = 1 << 12  # 4096
# Substitution-matrix entries are quantized in units of 1/S_SCALE.
S_SCALE = 1 << 6  # 64
# One "score unit" (a match score of 1.0) therefore equals PWM_SCALE * S_SCALE.
SCORE_ONE = PWM_SCALE * S_SCALE  # 262144
# Window starts are floor-aligned to this many bases (must equal the 4-bit
# packing factor in align/nw_pallas.py).
WINDOW_ALIGN = 8
# Retention-ratio fixed point (see MapperConfig.threshold_for).
RATIO_BITS = 32
# Sentinel for -infinity in int32 DP cells.  Chosen so that NEG_INF plus any
# legal emission/gap term stays far from int32 overflow.
NEG_INF = -(1 << 29)

# Base codes.  A=0 C=1 G=2 T=3, N/ambiguous = 4 (genome only; read ambiguity is
# expressed through the probability vector instead).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
N_BASES = 4
N_GENOME_CODES = 5


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Every knob that changes mapper output, in one frozen dataclass."""

    # --- seeding / index (reference: -m mer size, -j seed jump) ---
    mer_size: int = 10           # k-mer length for the seed index
    seed_jump: int = 5           # stride between seed k-mers along the read
    max_hits_per_seed: int = 64  # seeds hitting more loci than this are skipped
                                 # (repeat masking, GNUMAP's max-hits cap [PAPER])
    max_candidates: int = 128    # per (read, strand) candidate-locus cap

    # --- alignment (reference: gap penalties, subst matrix, -a ratio) ---
    match_score: float = 1.0
    mismatch_score: float = -1.0
    gap_open: float = 4.0        # positive penalty, subtracted
    gap_extend: float = 1.0      # positive penalty, subtracted
    gap_slack: int = 8           # genome window = read_len + 2*gap_slack
    align_score_ratio: float = 0.9  # reference -a: keep loci with
                                    # score >= a * max attainable score

    # --- modes ---
    bisulfite: bool = False       # GNUMAP-bs C->T asymmetric scoring
    snp_mode: bool = False        # GNUMAP-SNP per-base tallies + p-values
    subst_matrix: Optional[Tuple[Tuple[float, ...], ...]] = None
    # optional user 4x4 override (read base x genome base), reference's
    # substitution-file flag.

    # --- read handling ---
    max_read_len: int = 160      # static pad length for device batches
    batch_size: int = 4096       # reads per device batch
    phred_offset: int = 33

    # --- performance (non-semantic) ---
    # The pallas_* fields are the JAX package's TPU tile shapes.  The port
    # ignores them (its CUDA kernels pick their own blocks); they stay so
    # that a MapperConfig's field values carry across the two packages.
    pallas_sublanes: int = 256
    pallas_rpt: int = 64
    pallas_tb_sublanes: int = 128
    pallas_band_rows: int = 128
    pallas_band_unroll: int = 1
    hit_capacity: int = 1          # device-finish retained-hit capacity,
                                   # as a multiple of 2*batch (H = this x
                                   # 2B).  Raise for multi-map-heavy
                                   # workloads (repeat families average
                                   # >2 retained loci/read) to keep the
                                   # device-traceback fast path; capacity
                                   # overflow falls back to the exact
                                   # host path (or raises under device
                                   # accumulation)

    # --- parallelism (reference: -c threads, MPI ranks) ---
    read_shards: int = 1         # mesh axis "reads" (data parallelism)
    index_shards: int = 1        # mesh axis "index" (sharded genome index)

    # --- output ---
    sam_out: bool = True
    sgr_out: bool = True
    sgrex_out: bool = False      # per-base tallies (implied by snp_mode)
    min_coverage_emit: float = 1e-6  # SGR: positions below this are skipped

    def __post_init__(self):
        limit = 18 if self.bisulfite else 15
        if not (1 <= self.mer_size <= limit):
            raise ValueError(
                f"mer_size must be in [1, {limit}] "
                "(4^m index buckets; bisulfite seeds are base-3, 3^m)")
        if self.seed_jump < 1:
            raise ValueError("seed_jump must be >= 1")
        if self.max_candidates % 2:
            raise ValueError("max_candidates must be even (banded kernel "
                             "packs 2 candidate segments per register row)")
        if not (0.0 < self.align_score_ratio <= 1.0):
            raise ValueError("align_score_ratio in (0, 1]")

    # Quantized scoring pieces -------------------------------------------------
    def gap_open_q(self) -> int:
        return int(round(self.gap_open * SCORE_ONE))

    def gap_extend_q(self) -> int:
        return int(round(self.gap_extend * SCORE_ONE))

    # FROZEN candidate-window rule (shared by oracle, jnp and Pallas paths;
    # see align/nw_pallas.py docstring): starts floor-align to WINDOW_ALIGN
    # bases so windows can be fetched as whole 4-bit-packed words.
    def window_width(self) -> int:
        return self.max_read_len + 2 * self.gap_slack + WINDOW_ALIGN

    def window_start(self, cand):
        return ((cand - self.gap_slack) // WINDOW_ALIGN) * WINDOW_ALIGN

    # [FROZEN v4] DP band.  The affine NW recurrence is band-restricted:
    # for read row i >= 1, window column j >= 1 participates iff
    #   i - boff <= j <= i - boff + bw - 1,
    # i.e. M/Ix/Iy[i][j] are forced to exactly NEG_INF outside the band
    # (column 0 — the leading-insertion ramp — is exempt).  v4 tightens
    # v3's (2*slack, 64) to the geometric minimum: boff = slack + 1 and
    # bw = 4*slack + WINDOW_ALIGN + 2, which covers every alignment the
    # window model supports — start column in [0, 2*slack + WINDOW_ALIGN)
    # (floor-aligned window rule) plus path deviation within +-slack gives
    # j - i in [-(slack+1), 3*slack + WINDOW_ALIGN - 1].  The narrower
    # band lets the Pallas kernel pack 128 // bw candidate segments per
    # register row (3 at the default slack=8) instead of 2.  bw > 64
    # disables banding (None) and every DP implementation (oracle, nw_ref,
    # Pallas, native host finisher) falls back to the unbanded recurrence —
    # band identity is a pure function of this config, never of the
    # backend.  Within-band values are unchanged; retained (score >=
    # a*max) alignments fit the band whenever their net gap drift is
    # within +-slack (the window's own gap budget), so banding only
    # rewrites junk sub-threshold scores.
    def band(self) -> Optional[Tuple[int, int]]:
        bw = 4 * self.gap_slack + WINDOW_ALIGN + 2
        if bw <= 64:
            return (self.gap_slack + 1, bw)
        return None

    # FROZEN retention threshold: ceil(a * max_score) computed in exact
    # integer arithmetic with a quantized to RATIO_BITS binary digits, so
    # host NumPy and TPU int64 kernels agree bit-for-bit (float64 is
    # unavailable on TPU).
    def ratio_q(self) -> int:
        return int(round(self.align_score_ratio * (1 << RATIO_BITS)))

    def threshold_for(self, max_score: int) -> int:
        aq = self.ratio_q()
        return (aq * int(max_score) + (1 << RATIO_BITS) - 1) >> RATIO_BITS
