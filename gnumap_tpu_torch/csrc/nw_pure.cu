// Pure-diagonal detection over retained hits ([FROZEN v6] traceback split),
// on Hopper (sm_90a): pure[h] proves that the frozen backwalk of hit h emits
// an all-M CIGAR, with first aligned window column jfin[h].
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_band_pure_kernel (launched
// there by nw_pure_banded) together with its epilogue (nw_pallas.py:770-783).
// The exactness argument is the reference's (nw_pallas.py:554-583): in band
// coordinates a lane is a diagonal, so the gapless diagonal sum gl costs one
// add per lane per row; at the end row the smallest lane with
// max(M, Ix) == score is the oracle's end cell, and if M >= Ix and gl equals
// the score there, the walk follows that diagonal.
//
// What bounds it: the int32 instruction rate.  A live hit (not SENTINEL,
// 0 < len <= L, score > 0) costs len rows of BW band cells.  The fewest
// instructions a cell needs are B1's 6 (5 DPX and one for the emission's
// address, a single IDP.4A) and one more VIADDMNMX for gl, 7 in all.  So
//   bound = live hits x len x BW x 7 / 16.7e12 int32 operations a second,
// or the bytes (tables, candidates, lengths and scores in, pure and jfin out)
// over 3.35 TB/s where that is larger.
//
// Design.  The map path hands over 16,384 slots of which the first 8,192 are
// live: with a thread a hit that is 256 warps on a card with 528 warp
// schedulers, each running 100 rows of 42 cells in series.  So:
//   * A group of GROUP = 8 lanes owns a hit, in band coordinates: lane g owns
//     the S = ceil(BW / 8) contiguous band lanes b0 = g S .. b0 + S - 1 (6 at
//     bw 42) with B1's state D, T and the gapless sum gl in registers, 3 S
//     values.  Band lanes at and past BW (the last strip, or part of it) are
//     padding: they compute on bounded values that no real lane reads, see
//     below.  8,192 live hits are 2,048 warps.
//   * The recurrence is B1's (nw_band_row.cuh), value for value.  A cell
//     needs (row i - 1, lane b), (i - 1, b + 1) and (i, b' < b):
//       - M, mo, T and gl need the previous row only.  Lane b's Ix is
//         T[b + 1]: across a strip's edge one __shfl_down_sync hands the
//         neighbour's T[0] on, taken at the top of the row before any T is
//         overwritten.  Row 0 is not banded, so the last band lane reads row
//         0's column BW - boff at row 1 (Ix = -open there, as in
//         oracle.nw_align) and NEG_INF after: the owner of lane BW - 1 puts
//         that value where lane BW's T would be read, once a row.
//       - The Iy chain q' = max(q - ext, mo), q = NEG_INF before lane 0, is a
//         max-plus prefix: lane b reads
//           q_b = max over k < b of (mo_k - (b - 1 - k) ext)     (b >= 1)
//         exactly, with no floor lost: every mo_k >= NEG_INF, so the serial
//         chain's floor at NEG_INF never binds after its first term (the
//         proof of nw_band_row.cuh, read for each prefix).  Splitting the max
//         at the strip's first lane b0 gives
//           q_{b0 + j} = max(lq_j, q_{b0} - j ext),
//         where lq is the same chain run inside the strip from NEG_INF (lq_0
//         = NEG_INF, and q_{b0} >= NEG_INF is its own floor; for strip 0,
//         q_0 = NEG_INF and lq_j >= NEG_INF wins).  The strip carries obey
//         q_{b0 + S} = max(lq_S, q_{b0} - S ext): a log-step scan over the 8
//         lanes (3 shuffles, and one to shift it by a strip), then
//         D[j] = max(max3(M, Ix, lq_j), q_{b0} - j ext): one more VIADDMNMX a
//         cell.  All in int32 without overflow: values stay in
//         [NEG_INF - 64 ext, scores].
//     A cell is 9 instructions (IDP.4A, LDS, 6 VIADDMNMX, 1 VIMNMX3); a row
//     of 6 cells is about 110 with its 7 shuffles, the scan, the slide of the
//     codes and the loop, three times what the bound counts for a hit's row:
//     that, at 4 warps a scheduler, is what the kernel's time is made of.
//   * Padding lanes (b >= BW) carry the window codes down to the real lanes
//     and otherwise only feed lanes above them (the Iy carry runs upwards, Ix
//     comes from b + 1): the one value a real lane reads from them, T[BW], is
//     the one overridden above.  The end row ignores them.
//   * A hit's whole emission table is staged once, coalesced, into shared
//     memory as L rows of ECODES int32 (nw_stage.cuh's layout) by the warp
//     that owns the hit, with asynchronous 4-byte copies (cp.async) all in
//     flight at once: a warp waits one memory latency for its four tables,
//     not one a load.  So a cell's emission is one IDP.4A (code byte plus
//     the row's byte offset) and one shared load, and the row loop reads
//     nothing from device memory: the window codes that enter the band's
//     top lane, one a row, are staged beside the table, L + 1 bytes a hit (a
//     global load a row, though started before the row's arithmetic, was not
//     hidden by a 6-cell row: it cost more than the row).
//   * Dead slots cost no warp: a block takes 16 consecutive slots (fewer
//     when their tables would not fit), warp 0 compacts the live ones with a
//     ballot and writes (false, 0) to the rest, and group k takes the k-th
//     live hit; a block of dead slots leaves at once.  Small blocks, so that
//     a live prefix spreads over every multiprocessor (512 live blocks of 4
//     warps on 132 multiprocessors on the map path).
//   * The four groups of a warp run in lockstep to the warp's longest read
//     and every shuffle names the whole warp: a shuffle under a mask of 8
//     lanes made the compiler test, row by row, whether those lanes were
//     converged (17 instructions a row, and a slow path once a shorter read
//     had left).  A group takes its result at its own row len and computes
//     on after it; a group without a live hit rides along.
//   * The end row's "smallest lane with max(M, Ix) == score" is a min over
//     the group of (lane << 1 | pure) keys, taken after the loop.
//   * SENTINEL slots, length 0 (and len > L) and score <= 0 give
//     (false, 0), as the reference's epilogue does for them.
//   * Measured and not kept (same sets, one card): 1, 2, 4 and 16 lanes a
//     hit (all slower on the map path's shape; the tables bound a
//     multiprocessor to 80 hits whatever the group, so fewer lanes a hit are
//     fewer warps); keeping the end row's state and computing it after the
//     loop; the scan's constants held in registers; blocks of 8 slots; a
//     grid of resident blocks that pull chunks of slots off an atomic
//     counter until 16 live hits are pending (left-over hits cost most
//     blocks a second, nearly empty round).
//
// C interface (ctypes): nw_pure_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported band width, -2 for bad sizes.  It
// launches on the given stream, does not synchronise and allocates nothing.
// nw_pure_resident_warps(bw, L): warps the runtime keeps resident on one
// multiprocessor for that shape.

#include <cuda_pipeline.h>

#include "nw_stage.cuh"

namespace {

constexpr int GROUP = 8;                // lanes a hit
constexpr int GPW = 32 / GROUP;         // hits a warp
constexpr int MAX_HITS = 16;            // hit slots a block
constexpr int MAX_NT = MAX_HITS * GROUP;
// Above SOFT_SMEM a block takes fewer hits, so that blocks stay resident.
constexpr size_t SOFT_SMEM = 48 * 1024;
static_assert(MAX_HITS <= 32 && GROUP <= 32 && (GROUP & (GROUP - 1)) == 0,
              "warp 0 compacts a block's slots with one ballot");

__host__ __device__ constexpr int strip_lanes(int bw) {
  return (bw + GROUP - 1) / GROUP;
}

constexpr int NO_KEY = 0x7fffffff;

// A 32-bit load from shared memory at a 32-bit shared address: the row's
// address (IDP.4A) is used as it is, with no generic-address arithmetic.
__device__ __forceinline__ int lds32(unsigned addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

template <int BW>
__global__ void __launch_bounds__(MAX_NT, 4)
nw_pure_kernel(const int32_t* __restrict__ emis_t,
               const int32_t* __restrict__ cands,
               const int32_t* __restrict__ lens,
               const int32_t* __restrict__ scores,
               const int8_t* __restrict__ genome, long long G,
               uint8_t* __restrict__ pure_out, int32_t* __restrict__ jfin_out,
               int H, int L, int W, int slack, int boff, int open_q,
               int ext_q) {
  constexpr int S = strip_lanes(BW);
  constexpr int NWD = (S + 3) / 4;
  // the strip and the place in it of the last band lane, BW - 1
  constexpr int GL = (BW - 1) / S, JS = (BW - 1) % S;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_list[MAX_HITS], s_len[MAX_HITS], s_score[MAX_HITS];
  __shared__ int s_n;
  int32_t* s_emis = reinterpret_cast<int32_t*>(smem);
  unsigned char* s_code = smem + (size_t)(blockDim.x / GROUP) *
                                     table_stride(L) * 4;  // HB x (L + 4)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HB = blockDim.x / GROUP;  // hit slots of this block
  const int TS = table_stride(L);

  // warp 0 compacts the block's live slots; the dead ones get (false, 0)
  if (warp == 0) {
    const int h = blockIdx.x * HB + lane;
    bool live = false;
    if (lane < HB && h < H) {
      const int len = lens[h];
      live = cands[h] != SENTINEL && len > 0 && len <= L && scores[h] > 0;
      if (!live) {
        pure_out[h] = 0;
        jfin_out[h] = 0;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int at = __popc(bal & ((1u << lane) - 1u));
      s_list[at] = h;
      s_len[at] = lens[h];
      s_score[at] = scores[h];
    }
    if (lane == 0) s_n = __popc(bal);
  }
  __syncthreads();
  const int n = s_n;

  // each warp stages the tables of its own GPW hits: [5][L] -> [L][ECODES]
#pragma unroll 1
  for (int q = 0; q < GPW; ++q) {
    const int kq = warp * GPW + q;
    if (kq >= n) break;
    const int32_t* eg = emis_t + (size_t)s_list[kq] * 5 * L;
    int32_t* se = s_emis + kq * TS;
    for (int i = lane; i < L; i += 32) {
#pragma unroll
      for (int v = 0; v < 5; ++v)
        __pipeline_memcpy_async(se + i * ECODES + v, eg + v * L + i, 4);
      se[i * ECODES + 5] = DEEP;
    }
    // the window code that enters the group's top lane after row i
    const long long wsq = window_start(cands[s_list[kq]], slack);
    unsigned char* sc = s_code + kq * (L + 4);
    for (int i = lane; i <= L; i += 32)
      sc[i] = (unsigned char)code4_at(genome, G, wsq,
                                      i + GROUP * S - 1 - boff, W);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  // The warp's groups run in lockstep to its longest read, so that every
  // shuffle names the whole warp; a group takes its result at its own row
  // len and computes on after it, and a group without a hit (len 0) rides
  // along on the warp's first table: bounded values that nothing reads.
  if (warp * GPW >= n) return;
  const int kk = tid / GROUP, g = tid % GROUP;
  const bool live = kk < n;
  const int k = live ? kk : warp * GPW;
  const int len = live ? s_len[k] : 0;
  const int maxlen = __reduce_max_sync(0xffffffffu, len);
  const long long ws = window_start(cands[s_list[k]], slack);
  const int b0 = g * S;
  const bool owns_last = g == GL, top_lane = g == GROUP - 1;
  const int nopen = -open_q, next = -ext_q;

  // row 0 (M = 0 on window columns [0, W], Ix = Iy = NEG_INF) and row 1's
  // window codes, one byte (4 x code) per lane of the strip
  unsigned P[NWD];
  int D[S], T[S], gl[S];
#pragma unroll
  for (int w = 0; w < NWD; ++w) {
    unsigned x = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * w + c < S)
        x |= code4_at(genome, G, ws, b0 + 4 * w + c - boff, W) << (8 * c);
    P[w] = x;
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int col = b0 + j - boff;
    const int m = (col >= 0 && col <= W) ? 0 : NEG_INF;
    D[j] = m;
    T[j] = max(m - open_q, NEG_INF);
    gl[j] = 0;
  }
  // row 0's column BW - boff, which row 1's last band lane reads as Ix
  int tail = max(((BW - boff >= 0 && BW - boff <= W) ? 0 : NEG_INF) - open_q,
                 NEG_INF);
  unsigned rowbase =
      (unsigned)__cvta_generic_to_shared(smem) + (unsigned)(k * TS) * 4u;
  const unsigned char* s_top = s_code + k * (L + 4);
  int key = NO_KEY;

  for (int i = 1; i <= maxlen; ++i) {
    const unsigned top = s_top[i];
    int t_in = __shfl_down_sync(0xffffffffu, T[0], 1, GROUP);
    if (owns_last) {
      if (JS + 1 < S) T[(JS + 1 < S) ? JS + 1 : 0] = tail;
      else t_in = tail;
    }
    // the strip's cells; the Iy chain lq starts at NEG_INF in the strip
    int mn[S], ix[S];
    int lq = NEG_INF;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int e = lds32(__dp4a(P[j >> 2], 1u << (8 * (j & 3)), rowbase));
      mn[j] = addmax(e, D[j], NEG_INF);
      ix[j] = (j + 1 < S) ? T[(j + 1 < S) ? j + 1 : j] : t_in;
      D[j] = max3(mn[j], ix[j], lq);
      const int mo = addmax(mn[j], nopen, NEG_INF);
      lq = addmax(lq, next, mo);
      T[j] = addmax(ix[j], next, mo);
      gl[j] = addmax(gl[j], e, NEG_INF);
    }
    if (i == len) {
      // end row: the strip's smallest band lane with max(M, Ix) == score,
      // as key = lane << 1 | pure; the group's smallest key decides
      const int score = s_score[k];
#pragma unroll
      for (int j = S - 1; j >= 0; --j)
        if (b0 + j < BW && max(mn[j], ix[j]) == score)
          key = ((b0 + j) << 1) |
                ((mn[j] >= ix[j] && gl[j] == score) ? 1 : 0);
    }
    // the Iy carry into each strip: a scan of the strips' chains.  A lane
    // below the step gets its own value back, and x + d S next <= x.
    int x = lq;
#pragma unroll
    for (int d = 1; d < GROUP; d <<= 1)
      x = addmax(__shfl_up_sync(0xffffffffu, x, d, GROUP), d * S * next, x);
    int c = __shfl_up_sync(0xffffffffu, x, 1, GROUP);
    if (g == 0) c = NEG_INF;
#pragma unroll
    for (int j = 0; j < S; ++j) D[j] = addmax(c, j * next, D[j]);
    // slide the window codes one lane down, across the strips
    unsigned inc = __shfl_down_sync(0xffffffffu, P[0] & 255u, 1, GROUP);
    if (top_lane) inc = top;
#pragma unroll
    for (int w = 0; w + 1 < NWD; ++w)
      P[w] = __funnelshift_r(P[w], P[w + 1], 8);
    P[NWD - 1] = (P[NWD - 1] >> 8) | (inc << (8 * ((S - 1) & 3)));
    tail = NEG_INF;  // out of band from row 1 on
    rowbase += ECODES * 4;
  }

#pragma unroll
  for (int st = GROUP / 2; st > 0; st >>= 1)
    key = min(key, __shfl_xor_sync(0xffffffffu, key, st, GROUP));
  if (live && g == 0) {
    const int h = s_list[k];
    const bool pure = key != NO_KEY && (key & 1);
    pure_out[h] = pure ? 1 : 0;
    jfin_out[h] = pure ? (key >> 1) - boff : 0;
  }
}

// Hit slots a block takes and its shared memory: halved from MAX_HITS down to
// one warp's while the tables need more than SOFT_SMEM.  False when one
// warp's tables do not fit the card's limit.
inline bool block_hits(int L, int* hb, size_t* smem) {
  if (L <= 0) return false;
  *hb = MAX_HITS;
  // a hit's table and its L + 1 window codes
  const size_t hit = (size_t)table_stride(L) * 4 + L + 4;
  while (*hb > GPW && *hb * hit > SOFT_SMEM) *hb >>= 1;
  *smem = *hb * hit;
  return *smem <= HARD_SMEM;
}

template <int BW>
cudaError_t prepare(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(nw_pure_kernel<BW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int BW>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int32_t* scores,
                   const int8_t* genome, long long G, uint8_t* pure,
                   int32_t* jfin, int H, int L, int W, int slack, int boff,
                   int open_q, int ext_q, int hb, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t rc = prepare<BW>(smem);
  if (rc != cudaSuccess) return rc;
  nw_pure_kernel<BW><<<(H + hb - 1) / hb, hb * GROUP, smem, stream>>>(
      emis_t, cands, lens, scores, genome, G, pure, jfin, H, L, W, slack,
      boff, open_q, ext_q);
  return cudaGetLastError();
}

template <int BW>
int resident_warps(int hb, size_t smem) {
  int n = 0;
  if (prepare<BW>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, nw_pure_kernel<BW>, hb * GROUP, smem) != cudaSuccess)
    return -3;
  return n * hb * GROUP / 32;
}

}  // namespace

// bw = 4 * gap_slack + 10 for gap_slack 0..13 (MapperConfig.band)
#define NW_PURE_WIDTHS(X)                                                  \
  X(10) X(14) X(18) X(22) X(26) X(30) X(34) X(38) X(42) X(46) X(50) X(54) \
  X(58) X(62)

// Warps the runtime keeps resident on one multiprocessor for this band width
// and read length (-1 unsupported width, -2 bad sizes).
extern "C" int nw_pure_resident_warps(int bw, int L) {
  int hb;
  size_t smem;
  if (!block_hits(L, &hb, &smem)) return -2;
  switch (bw) {
#define NW_PURE_CASE(N) \
  case N:               \
    return resident_warps<N>(hb, smem);
    NW_PURE_WIDTHS(NW_PURE_CASE)
#undef NW_PURE_CASE
    default:
      return -1;
  }
}

extern "C" int nw_pure_launch(const void* emis_t, const void* cands,
                              const void* lens, const void* scores,
                              const void* genome, long long G, void* pure,
                              void* jfin, int H, int L, int W, int slack,
                              int boff, int bw, int open_q, int ext_q,
                              void* stream) {
  if (H <= 0) return 0;
  int hb;
  size_t smem;
  if (!block_hits(L, &hb, &smem)) return -2;
  const auto* e = static_cast<const int32_t*>(emis_t);
  const auto* cd = static_cast<const int32_t*>(cands);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* sc = static_cast<const int32_t*>(scores);
  const auto* g = static_cast<const int8_t*>(genome);
  auto* p = static_cast<uint8_t*>(pure);
  auto* j = static_cast<int32_t*>(jfin);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bw) {
#define NW_PURE_CASE(N)                                                    \
  case N:                                                                  \
    return (int)launch<N>(e, cd, ln, sc, g, G, p, j, H, L, W, slack, boff, \
                          open_q, ext_q, hb, smem, s);
    NW_PURE_WIDTHS(NW_PURE_CASE)
#undef NW_PURE_CASE
    default:
      return -1;
  }
}
