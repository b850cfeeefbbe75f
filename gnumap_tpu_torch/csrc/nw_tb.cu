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
// Design (simple first):
//   * One warp per hit, K = ceil(W / 32) contiguous window columns per lane;
//     the forward row is nw_full_row.cuh's, shared with the unbanded scoring
//     kernel nw_full.cu.  The next row's emissions are loaded before this
//     row runs.
//   * The direction nibbles of a row go to shared memory as one word per
//     lane (K nibbles): L * 32 * sizeof(word) bytes per hit, 6.5 KB at
//     L = 104, W = 128 and 13.3 KB once K >= 5 (W > 128, unbanded).  Warps
//     per block keep a block under 48 KB (3 warps at K >= 5, L = 104).
//   * The forward pass stops at the hit's own length: the end row is the
//     last one computed.  Lane 0 then walks back serially through shared
//     memory and writes ops and jfin; the other lanes zero the ops rows
//     past the read's end.
//   * SENTINEL slots, length 0 (and len > L) give ops 0 and jfin 0, as the
//     reference does for slots that never start a backwalk.
//
// What bounds it: the int32 instruction rate.  A live hit (not SENTINEL,
// 0 < len <= L) costs len rows of W cells.  The fewest instructions a cell
// needs, whatever a kernel's layout: the recurrence's 6 (nw_band_row.cuh: 4
// add-max, 1 three-way max, 1 for the emission's address) and 4 compares.
// The 4 direction bits are the outcomes of 4 comparisons of different 32-bit
// operand pairs (M - open against Ix - ext; M - open against Iy - ext; which
// of M, Ix, Iy the diagonal maximum equals takes two), so they are 4
// independent bits.  The DPX instructions return the maximum and not which
// side won, an integer compare decides one comparison (its second predicate
// is the complement of the first), and the packed compares that decide
// several at once are 16 bits wide where a score needs 26.  So one compare
// per bit, none of them free, 10 in all.  Moving the outcomes into a word
// and packing nibbles is not counted (one predicate-to-register move can
// carry several cells' outcomes), so the count leans low, as a bound may.
//   bound = live hits x len x W x 10 / 16.7e12 int32 operations a second,
// or the bytes over 3.35 TB/s where that is larger: each live hit's emission
// table and window, candidates and lengths in, ops and jfin out, and half a
// byte of directions per cell.  This kernel spends about 30 operations and
// shuffles per cell, plus the serial backwalk (len steps, one shared load
// each, more on a deletion run) on one lane of the warp.
//
// C interface (ctypes): nw_tb_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported width (W > 256), -2 for bad sizes.  It
// launches on the given stream, does not synchronise and allocates nothing.

#include "nw_full_row.cuh"

namespace {

constexpr int MAX_WARPS = 4;          // hits per block
constexpr int SMEM_LIMIT = 48 * 1024; // bytes of direction store per block

// One shared-memory word per lane and row: K direction nibbles.
template <int K> struct DirWord { using type = uint32_t; };
template <> struct DirWord<1> { using type = uint8_t; };
template <> struct DirWord<2> { using type = uint8_t; };
template <> struct DirWord<3> { using type = uint16_t; };
template <> struct DirWord<4> { using type = uint16_t; };

template <int K>
__global__ void __launch_bounds__(MAX_WARPS * 32)
nw_tb_kernel(const int32_t* __restrict__ emis_t,
             const int32_t* __restrict__ cands,
             const int32_t* __restrict__ lens,
             const int8_t* __restrict__ genome, long long G,
             int16_t* __restrict__ ops, int32_t* __restrict__ jfin_out,
             int H, int L, int Lp, int W, int slack, bool banded, int boff,
             int bw, int open_q, int ext_q) {
  using Dir = typename DirWord<K>::type;
  extern __shared__ unsigned char s_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.x * (blockDim.x >> 5) + warp;
  if (h >= H) return;  // warp-uniform
  Dir* sdir = reinterpret_cast<Dir*>(s_raw) + (size_t)warp * L * 32;
  const int cand = cands[h];
  const int len = lens[h];
  int16_t* ops_h = ops + (size_t)h * Lp;
  if (cand == SENTINEL || len <= 0 || len > L) {
    for (int r = lane; r < Lp; r += 32) ops_h[r] = 0;
    if (lane == 0) jfin_out[h] = 0;
    return;
  }
  for (int r = len + lane; r < Lp; r += 32) ops_h[r] = 0;

  const long long ws = window_start(cand, slack);
  const int c0 = lane * K;  // first owned window column index
  const unsigned codes = lane_codes<K>(genome, G, ws, c0, W);
  int M[K], Ix[K], Iy[K], m0, ix0;
  full_init<K>(M, Ix, Iy, m0, ix0);
  const int32_t* e_h = emis_t + (size_t)h * 5 * L;
  int ev_next = lane < 5 ? e_h[(size_t)lane * L] : NEG_INF;
  for (int i = 1; i <= len; ++i) {
    const int ev = ev_next;
    if (i < len && lane < 5) ev_next = e_h[(size_t)lane * L + i];
    sdir[(size_t)(i - 1) * 32 + lane] = (Dir)full_row<K, true>(
        M, Ix, Iy, m0, ix0, ev, codes, lane, banded, i - boff,
        i - boff + bw - 1, open_q, ext_q);
  }

  // end cell: the smallest column of the best max(M, Ix), M over Ix; the
  // column-0 ramp wins ties
  const int best = full_best<K>(M, Ix, c0, W);
  int endc = INT32_MAX;
#pragma unroll
  for (int k = K - 1; k >= 0; --k)
    if (c0 + k < W && max(M[k], Ix[k]) == best) endc = c0 + k;
  endc = __reduce_min_sync(FULL, endc);
  int m_at = 0, i_at = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (c0 + k == endc) {
      m_at = M[k];
      i_at = Ix[k];
    }
  m_at = __shfl_sync(FULL, m_at, endc / K);
  i_at = __shfl_sync(FULL, i_at, endc / K);
  __syncwarp();
  if (lane != 0) return;

  const bool at0 = ix0 >= best;
  int j = at0 ? 0 : endc + 1;
  int st = at0 ? 1 : (m_at >= i_at ? 0 : 1);  // 0 = M, 1 = Ix, 2 = Iy
  for (int r = len; r >= 1; --r) {
    const Dir* row = sdir + (size_t)(r - 1) * 32;
    const auto nib = [row](int c) -> unsigned {
      return ((unsigned)row[c / K] >> (4 * (c % K))) & 15u;
    };
    int dcnt = 0;
    if (st == 2) {  // deletion run: nearest open bit at or left of j - 1
      int c = j - 1;
      while (c >= 0 && !(nib(c) & 8u)) --c;
      dcnt = j - c;
      j = c;
      st = 0;
    }
    const int op_bit = st == 1 ? 1 : 0;
    const unsigned d = j >= 1 ? nib(j - 1) : 0u;
    if (st == 0) {
      st = (int)(d & 3u);
      j -= 1;
    } else {
      st = (j == 0) ? 1 : ((d & 4u) ? 0 : 1);
    }
    ops_h[r - 1] = (int16_t)((dcnt << 1) | op_bit);
  }
  jfin_out[h] = j;
}

template <int K>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int8_t* genome, long long G,
                   int16_t* ops, int32_t* jfin, int H, int L, int Lp, int W,
                   int slack, bool banded, int boff, int bw, int open_q,
                   int ext_q, cudaStream_t stream) {
  const size_t per_warp =
      (size_t)L * 32 * sizeof(typename DirWord<K>::type);
  int warps = (int)(SMEM_LIMIT / per_warp);
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  nw_tb_kernel<K><<<(H + warps - 1) / warps, warps * 32, warps * per_warp,
                    stream>>>(emis_t, cands, lens, genome, G, ops, jfin, H,
                              L, Lp, W, slack, banded, boff, bw, open_q,
                              ext_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nw_tb_launch(const void* emis_t, const void* cands,
                            const void* lens, const void* genome,
                            long long G, void* ops, void* jfin, int H, int L,
                            int Lp, int W, int slack, int banded, int boff,
                            int bw, int open_q, int ext_q, void* stream) {
  if (H <= 0) return 0;
  if (L <= 0 || Lp < L || W <= 0) return -2;
  if ((size_t)L * 32 * 4 > SMEM_LIMIT) return -2;
  const auto* e = static_cast<const int32_t*>(emis_t);
  const auto* cd = static_cast<const int32_t*>(cands);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* g = static_cast<const int8_t*>(genome);
  auto* o = static_cast<int16_t*>(ops);
  auto* j = static_cast<int32_t*>(jfin);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((W + 31) / 32) {
#define NW_TB_CASE(N)                                                      \
  case N:                                                                  \
    return (int)launch<N>(e, cd, ln, g, G, o, j, H, L, Lp, W, slack,       \
                          banded != 0, boff, bw, open_q, ext_q, s);
    NW_TB_CASE(1) NW_TB_CASE(2) NW_TB_CASE(3) NW_TB_CASE(4)
    NW_TB_CASE(5) NW_TB_CASE(6) NW_TB_CASE(7) NW_TB_CASE(8)
#undef NW_TB_CASE
    default:
      return -1;
  }
}
