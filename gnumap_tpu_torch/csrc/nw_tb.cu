// Exact traceback of retained hits: the full-width affine-gap DP, with or
// without the [FROZEN v3] band mask, and 4 direction bits per cell, then the
// backwalk, on Hopper (sm_90a).  ops[h, i] = (deletions after read base
// i + 1 << 1) | (1 if that base is an insertion), jfin[h] = the oracle's
// pos_in_window.
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_tb_kernel (launched there by
// nw_traceback_pallas), banded (banded = 1) and unbanded (banded = 0)
// calls.  It keeps the reference's full-width recurrence and every tie rule,
// so ops and jfin are bit-identical without translating the tie rules into
// band coordinates:
//   * M's predecessor prefers M, then Ix, then Iy (bits 0..1); Ix-from-M
//     (bit 2) and Iy-open (bit 3) compare with >=;
//   * the end cell is the smallest column with M preferred over Ix, and
//     column 0 (the Ix ramp) wins ties;
//   * a deletion run resolves to the nearest open bit at or left of j - 1;
//   * at column 0 every step is an insertion.
//
// What bounds it: the int32 instruction rate.  A live hit (not SENTINEL,
// 0 < len <= L) costs len rows of W cells without a band; with the band
// mask the function needs only the len x min(W, bw) cells inside the band
// (the others are NEG_INF by definition), and the bound counts those.  The
// fewest instructions a cell needs, whatever a kernel's layout: the
// recurrence's 6 (nw_band_row.cuh: 4 add-max, 1 three-way max, 1 for the
// emission's address) and 4 compares.  The 4 direction bits are the outcomes
// of 4 comparisons of different 32-bit operand pairs (M - open against
// Ix - ext; M - open against Iy - ext; which of M, Ix, Iy the diagonal
// maximum equals takes two), so they are 4 independent bits.  The DPX
// instructions return the maximum and not which side won, an integer compare
// decides one comparison (its second predicate is the complement of the
// first), and the packed compares that decide several at once are 16 bits
// wide where a score needs 26.  So one compare per bit, none of them free,
// 10 in all.  Moving the outcomes into a word and packing nibbles is not
// counted (one predicate-to-register move can carry several cells'
// outcomes), so the count leans low, as a bound may.
//   bound = live hits x len x (W or min(W, bw)) x 10 / 16.7e12 int32
//   operations a second,
// or the bytes over 3.35 TB/s where that is larger: each live hit's emission
// table and window, candidates and lengths in, ops and jfin out, and half a
// byte of directions per cell.
//
// Design:
//   * A group of G = 16 lanes owns a hit, a warp two hits; a block is one
//     warp.  The forward row is nw_full_row.cuh's column-space row, shared
//     with the unbanded scoring kernel nw_full.cu: lane g owns NC =
//     ceil(W / 16) contiguous columns in registers and works one row behind
//     lane g - 1, so two shuffles a row cross a strip's edge.  Each hit's
//     emission table is staged in shared memory (nw_stage.cuh), so a cell's
//     emission is one shared load.  The direction store bounds the hits in
//     flight on a multiprocessor (below), so 16 lanes a hit, not 8, keep
//     twice the warps there; measured faster on every live-slot set.
//   * Each cell stores the direction bits about itself: the signs of four
//     differences of its own M, Ix, Iy and D, moved into a nibble by four
//     funnel shifts (nw_full_row.cuh).  The backwalk reads cell (i - 1,
//     j - 1), (i - 1, j) or (i, j - 1) where the reference's bit of cell
//     (i, j) looks at that neighbour; row 0 and column 0 are constants.  No
//     separate M / Ix / Iy arrays, no second pass, no shuffle per cell.  The
//     cell is 17 integer instructions where the function needs 10: the
//     scoring cell's 6, one add for u = M - open + ext, 4 subtractions, 4
//     funnel shifts, and the moves the compiler adds.
//   * With the band mask the row computes all W columns and masks those
//     outside the band, as the reference does: three selects a cell.  A
//     band layout (the banded scoring kernel's, with directions) would spend
//     a third of the cells, but its ties at the band's edge are not shown to
//     be the reference's, so it is not taken.
//   * Directions live in shared memory, half a byte a cell, L rows of
//     16 x ceil(NC / 4) 16-bit words a hit (10.0 KB at L = 104, W = 144,
//     where 9 columns a lane fill 3 words), plus the table (2.6 KB): 16
//     hits in flight on a multiprocessor; longer reads ask for up to 227 KB
//     of dynamic shared memory for a block's two hits.
//   * The forward pass stops at the hit's own length: a lane's state stays
//     as its last row left it.  The best end value is the group's max of D
//     over columns < W; the end cell is the smallest column whose D equals
//     it and whose own bits say M or Ix is that maximum.
//   * The whole group walks back.  Every lane holds the walk's state; on a
//     run of matches lane t looks at the cell t steps down the diagonal, a
//     ballot finds the first step whose predecessor is not M, and the walk
//     jumps there: 16 rows a round instead of one lane chasing one shared
//     load a row while its block's shared memory waits.  Deletion runs are
//     scanned the same way; insertions go a row at a time.  The ops rows are
//     zeroed first, so only rows with an insertion or deletions are written.
//   * SENTINEL slots, length 0 (and len > L) give ops 0 and jfin 0, as the
//     reference does for slots that never start a backwalk; a warp of such
//     slots leaves at once.
//
// C interface (ctypes): nw_tb_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported width (W > 256), -2 for bad sizes
// (negative gap costs, or a hit that does not fit 227 KB).  It launches on
// the given stream, does not synchronise and allocates nothing.

#define NW_GROUP_LANES 16
#include "nw_full_row.cuh"
#include "nw_stage.cuh"

namespace {

constexpr int HITS = 32 / G;    // hits per warp and block
// Above SOFT_SMEM a block takes fewer hits, so that blocks stay resident.
constexpr size_t SOFT_SMEM = 46 * 1024;

// bytes of one hit's direction store: L rows of G lanes x NH 16-bit words,
// padded so that the hits of a warp start 32 / HITS banks apart
inline size_t dir_bytes(int L, int nc) {
  const size_t b = (size_t)L * G * strip_words(nc) * 2;
  return b + (128 / HITS + 128 - b % 128) % 128;
}

inline size_t hit_bytes(int L, int nc) {
  return (size_t)table_stride(L) * 4 + dir_bytes(L, nc);
}

template <int NC, bool BANDED>
__global__ void __launch_bounds__(32)
nw_tb_kernel(const int32_t* __restrict__ emis_t,
             const int32_t* __restrict__ cands,
             const int32_t* __restrict__ lens,
             const int8_t* __restrict__ genome, long long Gn,
             int16_t* __restrict__ ops, int32_t* __restrict__ jfin_out,
             int H, int L, int Lp, int W, int slack, int boff, int bw,
             int open_q, int ext_q, int hpb, int dbytes) {
  constexpr int NH = strip_words(NC);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, g = lane & (G - 1), gi = lane / G;
  const int S = table_stride(L);
  const int h = blockIdx.x * hpb + gi;
  const bool have = gi < hpb && h < H;
  const int cand = have ? cands[h] : SENTINEL;
  const int len0 = have ? lens[h] : 0;
  const bool live = cand != SENTINEL && len0 > 0 && len0 <= L;
  const int len = live ? len0 : 0;
  if (have) {  // the walk writes only the rows that are not plain matches
    int16_t* ops_h = ops + (size_t)h * Lp;
    for (int r = g; r < Lp; r += G) ops_h[r] = 0;
    if (!live && g == 0) jfin_out[h] = 0;
  }
  const int steps = __reduce_max_sync(FULL, len) + G - 1;  // warp-uniform
  if (steps == G - 1) return;

  // stage the live hits' emission tables: [5][L] -> [L][6]
  int32_t* s_emis = reinterpret_cast<int32_t*>(smem);
  const unsigned livemask = __ballot_sync(FULL, live);
  for (int q = 0; q < hpb; ++q)
    if ((livemask >> (q * G)) & 1u)
      stage_tables<32>(s_emis + q * S,
                       emis_t + (size_t)(blockIdx.x * hpb + q) * 5 * L, 1, L,
                       S, lane);
  __syncwarp();

  unsigned short* sdir = reinterpret_cast<unsigned short*>(
      smem + (size_t)hpb * S * 4 + (size_t)gi * dbytes);
  const int c0 = g * NC;
  unsigned P[strip_words(NC)];
  int D[NC], T[NC];
  if (live)
    strip_init<NC>(D, T, P, genome, Gn, window_start(cand, slack), c0, W,
                   open_q);
  unsigned rowbase = (unsigned)(gi * S) * 4u;
  const auto emit = [&rowbase](unsigned word, int kk) {
    return *reinterpret_cast<const int32_t*>(
        smem + __dp4a(word, 1u << (8 * kk), rowbase));
  };
  unsigned short* srow = sdir + g;  // this lane's words of its current row
  const auto store = [&srow](int w, unsigned x) {
    srow[w * G] = (unsigned short)x;
  };
  int pd = 0, pq = NEG_INF;  // handed to lane g + 1 at the next step
  int d0 = 0;                // lane 0: max(M, Ix) of column 0, row above
  for (int s = 1; s <= steps; ++s) {
    const int in_d = __shfl_up_sync(FULL, pd, 1, G);
    const int in_q = __shfl_up_sync(FULL, pq, 1, G);
    const int row = s - g;
    if (row >= 1 && row <= len) {
      int d = g ? in_d : d0;
      int q = g ? in_q : NEG_INF;
      // strip columns k inside the band: lo <= c0 + k + 1 <= lo + bw - 1
      const int klo = row - boff - c0 - 1;
      strip_row<NC, true, BANDED>(D, T, P, d, q, emit, open_q, ext_q, klo,
                                  klo + bw - 1, store);
      pd = d;
      pq = q;
      d0 = max(row == 1 ? -open_q : d0 - ext_q, NEG_INF);
      rowbase += ECODES * 4;
      srow += NH * G;
    }
  }
  __syncwarp();

  // The stored nibble s3 s2 s1 s0 of cell (row r >= 1, window column c).
  const auto cell = [sdir](int r, int c) -> unsigned {
    const int gg = c / NC, k = c - gg * NC;
    const unsigned x = sdir[((r - 1) * NH + (k >> 2)) * G + gg];
    return (x >> (4 * (3 - (k & 3)))) & 15u;
  };

  // end cell: the smallest column < W whose D is the best and whose M or Ix
  // is that D (not s0 and s1 both)
  const int best = group_best<NC>(D, c0, live ? W : 0);
  int endc = INT32_MAX;
  if (live) {
#pragma unroll
    for (int k = NC - 1; k >= 0; --k)
      if (c0 + k < W && D[k] == best && (cell(len, c0 + k) & 3u) != 3u)
        endc = c0 + k;
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1)
    endc = min(endc, __shfl_xor_sync(FULL, endc, s, G));
  d0 = __shfl_sync(FULL, d0, 0, G);  // column 0's Ix at row len
  if (!live) return;

  // The backwalk, by the whole group: every lane holds the same state (row
  // r, DP column j, st = 0 M, 1 Ix, 2 Iy) and reads the reference's bits of
  // a cell where they were decided.  Row 0 holds M = 0, Ix = Iy = NEG_INF;
  // column 0 holds M = NEG_INF below row 0 and the Ix ramp, whose value at
  // row r is max(-open - (r - 1) ext, NEG_INF).  The ops rows are zero
  // already, so a run of matches costs no store, and the lanes look at the
  // next G steps of a run at once: lane t at the cell t steps ahead; a
  // ballot finds where the run ends.
  const int gshift = gi * G;
  const unsigned gbits = FULL >> (32 - G), gmask = gbits << gshift;
  const auto vote = [&](bool p) -> unsigned {
    return (__ballot_sync(gmask, p) >> gshift) & gbits;
  };
  const bool ix_row0 = -open_q >= NEG_INF - ext_q;  // bit 2 above row 1
  const bool iy_col0 = open_q <= ext_q;             // bit 3 right of column 0
  int16_t* ops_h = ops + (size_t)h * Lp;
  const bool at0 = d0 >= best;
  int j = at0 ? 0 : endc + 1;
  int st = at0 ? 1 : (int)(cell(len, endc) & 1u);
  int r = len;
  while (r >= 1) {  // the same trip count in every lane of the group
    int dcnt = 0;
    if (st == 2) {
      // deletion run: the nearest open bit (bit 3) at or left of j - 1, or
      // column 0; lane t looks at column j - 1 - t
      int c = j - 1 - g;
      unsigned stop;
      while (!(stop = vote(c < 0 || (c == 0 ? iy_col0
                                            : !(cell(r, c - 1) & 8u)))))
        c -= G;
      c = __shfl_sync(gmask, c, __ffs(stop) - 1, G);
      dcnt = j - c;
      j = c;
      st = 0;
    }
    if (st == 0) {
      // a run of matches down the diagonal: lane t stands at (r - t, j - t)
      // in state M and finds M's predecessor there (bits 0..1 of that cell:
      // which of M, Ix, Iy of (r - t - 1, j - t - 1) is the maximum); 3
      // past row 1
      const int rr = r - g, jj = j - g;
      int d;
      if (rr < 1) {
        d = 3;
      } else if (rr == 1 || jj < 1) {
        d = 0;
      } else if (jj == 1) {
        d = -(long long)open_q - (long long)(rr - 2) * ext_q > NEG_INF ? 1 : 0;
      } else {
        const unsigned x = cell(rr - 1, jj - 2);
        d = (x & 1u) ? ((x & 2u) ? 2 : 1) : 0;
      }
      if (dcnt && g == 0) ops_h[r - 1] = (int16_t)(dcnt << 1);
      const unsigned ends = vote(d != 0);
      if (!ends) {
        r -= G;
        j -= G;
        continue;
      }
      const int t = __ffs(ends) - 1;
      d = __shfl_sync(gmask, d, t, G);
      if (d == 3) {  // t == r: rows r .. 1 were matches
        j -= t;
        break;
      }
      r -= t + 1;
      j -= t + 1;
      st = d;
    } else {
      // an insertion: Ix at (r, j) came from M above (bit 2 of (r, j),
      // decided by cell (r - 1, j)) or extends
      if (g == 0) ops_h[r - 1] = 1;
      const bool from_m =
          j >= 1 && (r == 1 ? ix_row0 : !(cell(r - 1, j - 1) & 4u));
      st = from_m ? 0 : 1;
      r -= 1;
    }
  }
  if (g == 0) jfin_out[h] = j;
}

template <int NC, bool BANDED>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int8_t* genome, long long Gn,
                   int16_t* ops, int32_t* jfin, int H, int L, int Lp, int W,
                   int slack, int boff, int bw, int open_q, int ext_q,
                   int hpb, cudaStream_t stream) {
  const size_t smem = hpb * hit_bytes(L, NC);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nw_tb_kernel<NC, BANDED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  nw_tb_kernel<NC, BANDED><<<(H + hpb - 1) / hpb, 32, smem, stream>>>(
      emis_t, cands, lens, genome, Gn, ops, jfin, H, L, Lp, W, slack, boff,
      bw, open_q, ext_q, hpb, (int)dir_bytes(L, NC));
  return cudaGetLastError();
}

// Hits per block: HITS while they fit SOFT_SMEM, else as many as fit the
// card's limit for one block; 0 when one hit does not.
inline int hits_per_block(int L, int nc) {
  const size_t per = hit_bytes(L, nc);
  int hpb = HITS;
  while (hpb > 1 && hpb * per > SOFT_SMEM) --hpb;
  if (hpb * per > SOFT_SMEM) {
    hpb = (int)(HARD_SMEM / per);
    if (hpb > HITS) hpb = HITS;
  }
  return hpb;
}

template <int NC, bool BANDED>
int resident_blocks(size_t smem) {
  int n = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(nw_tb_kernel<NC, BANDED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -3;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, nw_tb_kernel<NC, BANDED>, 32, smem) != cudaSuccess)
    return -3;
  return n;
}

}  // namespace

// Hits in flight on one multiprocessor for this shape: resident blocks (of
// one warp) times the hits per block (-1 unsupported width, -2 bad sizes).
extern "C" int nw_tb_resident_hits(int W, int L, int banded) {
  if (W <= 0 || L <= 0) return -2;
  const int nc = strip_cols(W);
  if (nc > MAX_NC) return -1;
  const int hpb = hits_per_block(L, nc);
  if (hpb < 1) return -2;
  const size_t smem = hpb * hit_bytes(L, nc);
  int blocks = -1;
  switch (nc) {
#define NW_TB_CASE(N)                                        \
  case N:                                                    \
    blocks = banded ? resident_blocks<N, true>(smem)         \
                    : resident_blocks<N, false>(smem);       \
    break;
    NW_STRIP_WIDTHS(NW_TB_CASE)
#undef NW_TB_CASE
  }
  return blocks < 0 ? blocks : blocks * hpb;
}

extern "C" int nw_tb_launch(const void* emis_t, const void* cands,
                            const void* lens, const void* genome,
                            long long Gn, void* ops, void* jfin, int H, int L,
                            int Lp, int W, int slack, int banded, int boff,
                            int bw, int open_q, int ext_q, void* stream) {
  if (H <= 0) return 0;
  if (L <= 0 || Lp < L || W <= 0 || open_q < 0 || ext_q < 0) return -2;
  const int nc = strip_cols(W);
  if (nc > MAX_NC) return -1;
  const int hpb = hits_per_block(L, nc);
  if (hpb < 1) return -2;
  const auto* e = static_cast<const int32_t*>(emis_t);
  const auto* cd = static_cast<const int32_t*>(cands);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* gn = static_cast<const int8_t*>(genome);
  auto* o = static_cast<int16_t*>(ops);
  auto* j = static_cast<int32_t*>(jfin);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nc) {
#define NW_TB_CASE(N)                                                       \
  case N:                                                                   \
    return banded                                                           \
               ? (int)launch<N, true>(e, cd, ln, gn, Gn, o, j, H, L, Lp, W, \
                                      slack, boff, bw, open_q, ext_q, hpb,  \
                                      s)                                    \
               : (int)launch<N, false>(e, cd, ln, gn, Gn, o, j, H, L, Lp,   \
                                       W, slack, boff, bw, open_q, ext_q,   \
                                       hpb, s);
    NW_STRIP_WIDTHS(NW_TB_CASE)
#undef NW_TB_CASE
    default:
      return -1;
  }
}
