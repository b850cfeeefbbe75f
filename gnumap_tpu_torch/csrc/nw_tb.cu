// Exact traceback of retained hits: the full-width affine-gap DP with the
// [FROZEN v3] band mask and 4 direction bits per cell, then the backwalk,
// on Hopper (sm_90a).  ops[h, i] = (deletions after read base i + 1 << 1)
// | (1 if that base is an insertion), jfin[h] = the oracle's pos_in_window.
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_tb_kernel (launched there by
// nw_traceback_pallas), banded call only.  It keeps the reference's
// full-width recurrence and every tie rule, so ops and jfin are
// bit-identical without translating the tie rules into band coordinates:
//   * M's predecessor prefers M, then Ix, then Iy (bits 0..1); Ix-from-M
//     (bit 2) and Iy-open (bit 3) compare with >=;
//   * the end cell is the smallest column with M preferred over Ix, and
//     column 0 (the Ix ramp) wins ties;
//   * a deletion run resolves to the nearest open bit at or left of j - 1;
//   * at column 0 every step is an insertion.
//
// Design (simple first):
//   * One warp per hit.  Lane t owns the K = ceil(W / 32) contiguous window
//     columns c = t K + k (DP column c + 1); columns c >= W read the poison
//     emission NEG_INF, as the Pallas kernel's lanes >= W do, and never
//     reach a column < W.
//   * The left shifts of M, Ix and max(M, Ix, Iy) cross lanes with one
//     __shfl_up_sync each; the Iy prefix max is a per-lane prefix plus a
//     5-step warp scan.  Column 0 (M = 0 on row 0, then NEG_INF; Ix the
//     ramp) is a warp-uniform scalar pair.
//   * The row's 5 emissions sit in lanes 0..4 (lane 5 holds NEG_INF); a
//     column's emission is one __shfl_sync from the lane of its window
//     code.  The next row's emissions are loaded before this row runs.
//   * The direction nibbles of a row go to shared memory as one word per
//     lane (K nibbles): L * 32 * sizeof(word) bytes per hit, 6.5 KB at
//     L = 104, W = 128.  Warps per block keep a block under 48 KB.
//   * The forward pass stops at the hit's own length: the end row is the
//     last one computed.  Lane 0 then walks back serially through shared
//     memory and writes ops and jfin; the other lanes zero the ops rows
//     past the read's end.
//   * SENTINEL slots, length 0 (and len > L) give ops 0 and jfin 0, as the
//     reference does for slots that never start a backwalk.
//
// Bound: int32 ALU and shuffle work, about 30 operations per cell over the
// full window width, plus the serial backwalk (len steps, one shared load
// each, more on a deletion run) on one lane of the warp.
//
// C interface (ctypes): nw_tb_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported width (W > 256), -2 for bad sizes.  It
// launches on the given stream, does not synchronise and allocates nothing.

#include "nw_band_row.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
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
             int H, int L, int Lp, int W, int slack, int boff, int bw,
             int open_q, int ext_q) {
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
  unsigned codes = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    codes |= code_at(genome, G, ws, c0 + k, W) << (4 * k);

  int M[K], Ix[K], Iy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    M[k] = 0;
    Ix[k] = NEG_INF;
    Iy[k] = NEG_INF;
  }
  int m0 = 0, ix0 = NEG_INF;  // column 0 of the previous row
  const int32_t* e_h = emis_t + (size_t)h * 5 * L;
  int ev_next = lane < 5 ? e_h[(size_t)lane * L] : NEG_INF;

  for (int i = 1; i <= len; ++i) {
    const int ev = ev_next;
    if (i < len && lane < 5) ev_next = e_h[(size_t)lane * L + i];
    // previous row, shifted one column right (lane 0 reads column 0)
    const int mL = __shfl_up_sync(FULL, M[K - 1], 1);
    const int ixL = __shfl_up_sync(FULL, Ix[K - 1], 1);
    const int iyL = __shfl_up_sync(FULL, Iy[K - 1], 1);
    const int lo = i - boff, hi = i - boff + bw - 1;  // band of columns
    int Mn[K], Ixn[K];
    unsigned dir = 0;
    int run = 0;  // prefix max of Mn + (c + 1) ext within the lane
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const int j = c + 1;
      int m_sh, ix_sh, dg;
      if (k == 0) {
        m_sh = lane ? mL : m0;
        ix_sh = lane ? ixL : ix0;
        dg = lane ? max(max(mL, ixL), iyL) : max(m0, ix0);
      } else {
        m_sh = M[k - 1];
        ix_sh = Ix[k - 1];
        dg = max(max(M[k - 1], Ix[k - 1]), Iy[k - 1]);
      }
      const unsigned m_dir = m_sh == dg ? 0u : (ix_sh == dg ? 1u : 2u);
      const unsigned ix_bit = (M[k] - open_q) >= (Ix[k] - ext_q) ? 1u : 0u;
      const int e = __shfl_sync(FULL, ev, (codes >> (4 * k)) & 15u);
      const bool off = j < lo || j > hi;
      Mn[k] = off ? NEG_INF : max(e + dg, NEG_INF);
      Ixn[k] = off ? NEG_INF
                   : max(max(M[k] - open_q, Ix[k] - ext_q), NEG_INF);
      const int pk = Mn[k] + j * ext_q;
      run = k ? max(run, pk) : pk;
      dir |= (m_dir | (ix_bit << 2)) << (4 * k);
    }
    // warp scan of the lanes' prefix maxima -> the prefix before this lane
    int scan = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(FULL, scan, s);
      if (lane >= s) scan = max(scan, y);
    }
    const int before = __shfl_up_sync(FULL, scan, 1);
    // Iy[c] = max(pm[c - 1] - open - c ext, NEG_INF), pm[-1] = NEG_INF
    int Iyn[K];
    int pm = lane ? before : NEG_INF;  // pm of the column left of c0
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + k;
      const int j = c + 1;
      const bool off = j < lo || j > hi;
      Iyn[k] = off ? NEG_INF : max(pm - open_q - c * ext_q, NEG_INF);
      const int pk = Mn[k] + j * ext_q;
      pm = max(pm, pk);  // pk > NEG_INF, so lane 0's fill never wins
    }
    // Iy-open bit: M[c - 1] - open >= Iy[c - 1] - ext (NEG_INF left of 0)
    const int mnL = __shfl_up_sync(FULL, Mn[K - 1], 1);
    const int iynL = __shfl_up_sync(FULL, Iyn[K - 1], 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ml = k ? Mn[k - 1] : (lane ? mnL : NEG_INF);
      const int il = k ? Iyn[k - 1] : (lane ? iynL : NEG_INF);
      dir |= ((ml - open_q) >= (il - ext_q) ? 8u : 0u) << (4 * k);
      M[k] = Mn[k];
      Ix[k] = Ixn[k];
      Iy[k] = Iyn[k];
    }
    sdir[(size_t)(i - 1) * 32 + lane] = (Dir)dir;
    ix0 = max(max(m0 - open_q, ix0 - ext_q), NEG_INF);
    m0 = NEG_INF;
  }

  // end cell: the smallest column of the best max(M, Ix), M over Ix; the
  // column-0 ramp wins ties
  int best = INT32_MIN;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (c0 + k < W) best = max(best, max(M[k], Ix[k]));
  best = __reduce_max_sync(FULL, best);
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
                   int slack, int boff, int bw, int open_q, int ext_q,
                   cudaStream_t stream) {
  const size_t per_warp =
      (size_t)L * 32 * sizeof(typename DirWord<K>::type);
  int warps = (int)(SMEM_LIMIT / per_warp);
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  nw_tb_kernel<K><<<(H + warps - 1) / warps, warps * 32, warps * per_warp,
                    stream>>>(emis_t, cands, lens, genome, G, ops, jfin, H,
                              L, Lp, W, slack, boff, bw, open_q, ext_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nw_tb_launch(const void* emis_t, const void* cands,
                            const void* lens, const void* genome,
                            long long G, void* ops, void* jfin, int H, int L,
                            int Lp, int W, int slack, int boff, int bw,
                            int open_q, int ext_q, void* stream) {
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
    return (int)launch<N>(e, cd, ln, g, G, o, j, H, L, Lp, W, slack, boff, \
                          bw, open_q, ext_q, s);
    NW_TB_CASE(1) NW_TB_CASE(2) NW_TB_CASE(3) NW_TB_CASE(4)
    NW_TB_CASE(5) NW_TB_CASE(6) NW_TB_CASE(7) NW_TB_CASE(8)
#undef NW_TB_CASE
    default:
      return -1;
  }
}
