// The full-width DP row shared by the traceback kernel (nw_tb.cu, which
// also stores 4 direction bits per cell) and the unbanded scoring kernel
// (nw_full.cu, which does not), so that both run one recurrence: the
// Pallas _nw_tb_kernel / _nw_kernel body, every term floored at NEG_INF.
//
// One warp per (read-strand, window) pair.  Lane t owns the K = ceil(W / 32)
// contiguous window columns c = t K + k (DP column j = c + 1); columns
// c >= W read the poison code 5, whose emission is NEG_INF, as the Pallas
// kernel's lanes >= W do, and never feed a column < W (shifts and the
// prefix max only move right).
//   * The left shifts of M, Ix and max(M, Ix, Iy) cross lanes with one
//     __shfl_up_sync each; the Iy prefix max is a per-lane prefix plus a
//     5-step warp scan.  Column 0 (M = 0 on row 0, then NEG_INF; Ix the
//     ramp) is a warp-uniform scalar pair (m0, ix0).
//   * The row's 5 emissions sit in lanes 0..4 (the other lanes hold
//     NEG_INF); a column's emission is one __shfl_sync from the lane of its
//     window code.

#pragma once

#include "nw_band_row.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The K window codes of the lane's columns c0 .. c0 + K - 1, 4 bits each.
template <int K>
__device__ __forceinline__ unsigned lane_codes(const int8_t* __restrict__ g,
                                               long long G, long long ws,
                                               int c0, int W) {
  unsigned codes = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) codes |= code_at(g, G, ws, c0 + k, W) << (4 * k);
  return codes;
}

// Row 0: M = 0 on every column, Ix = Iy = NEG_INF; column 0 m0 = 0,
// ix0 = NEG_INF.
template <int K>
__device__ __forceinline__ void full_init(int (&M)[K], int (&Ix)[K],
                                          int (&Iy)[K], int& m0, int& ix0) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    M[k] = 0;
    Ix[k] = NEG_INF;
    Iy[k] = NEG_INF;
  }
  m0 = 0;
  ix0 = NEG_INF;
}

// One DP row i >= 1.  ev is this lane's emission (lanes 0..4: codes 0..4,
// the others NEG_INF); codes the lane's window codes.  With banded, the
// [FROZEN v3] mask forces M, Ix and Iy to NEG_INF at DP columns outside
// [lo, hi].  With DIRS it returns the lane's K direction nibbles:
//   bits 0..1  M's diagonal predecessor: 0 = M, 1 = Ix, 2 = Iy, preferred in
//              that order on ties
//   bit  2     Ix came from M above (M - open >= Ix - ext)
//   bit  3     Iy opened from M on the left (M - open >= Iy - ext)
template <int K, bool DIRS>
__device__ __forceinline__ unsigned full_row(int (&M)[K], int (&Ix)[K],
                                             int (&Iy)[K], int& m0, int& ix0,
                                             int ev, unsigned codes, int lane,
                                             bool banded, int lo, int hi,
                                             int open_q, int ext_q) {
  const int c0 = lane * K;
  // previous row, shifted one column right (lane 0 reads column 0)
  const int mL = __shfl_up_sync(FULL, M[K - 1], 1);
  const int ixL = __shfl_up_sync(FULL, Ix[K - 1], 1);
  const int iyL = __shfl_up_sync(FULL, Iy[K - 1], 1);
  int Mn[K], Ixn[K];
  unsigned dir = 0;
  int run = 0;  // prefix max of Mn + (c + 1) ext within the lane
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = c0 + k + 1;
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
    if constexpr (DIRS) {
      const unsigned m_dir = m_sh == dg ? 0u : (ix_sh == dg ? 1u : 2u);
      const unsigned ix_bit = (M[k] - open_q) >= (Ix[k] - ext_q) ? 1u : 0u;
      dir |= (m_dir | (ix_bit << 2)) << (4 * k);
    }
    const int e = __shfl_sync(FULL, ev, (codes >> (4 * k)) & 15u);
    const bool off = banded && (j < lo || j > hi);
    Mn[k] = off ? NEG_INF : max(e + dg, NEG_INF);
    Ixn[k] = off ? NEG_INF : max(max(M[k] - open_q, Ix[k] - ext_q), NEG_INF);
    const int pk = Mn[k] + j * ext_q;
    run = k ? max(run, pk) : pk;
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
    const bool off = banded && (j < lo || j > hi);
    Iyn[k] = off ? NEG_INF : max(pm - open_q - c * ext_q, NEG_INF);
    pm = max(pm, Mn[k] + j * ext_q);  // > NEG_INF: lane 0's fill never wins
  }
  if constexpr (DIRS) {
    // Iy-open bit: M[c - 1] - open >= Iy[c - 1] - ext (NEG_INF left of 0)
    const int mnL = __shfl_up_sync(FULL, Mn[K - 1], 1);
    const int iynL = __shfl_up_sync(FULL, Iyn[K - 1], 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ml = k ? Mn[k - 1] : (lane ? mnL : NEG_INF);
      const int il = k ? Iyn[k - 1] : (lane ? iynL : NEG_INF);
      dir |= ((ml - open_q) >= (il - ext_q) ? 8u : 0u) << (4 * k);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    M[k] = Mn[k];
    Ix[k] = Ixn[k];
    Iy[k] = Iyn[k];
  }
  ix0 = max(max(m0 - open_q, ix0 - ext_q), NEG_INF);
  m0 = NEG_INF;
  return dir;
}

// The best end value over the window columns c < W: max over the warp of
// max(M, Ix), the same in every lane.
template <int K>
__device__ __forceinline__ int full_best(const int (&M)[K],
                                         const int (&Ix)[K], int c0, int W) {
  int best = INT32_MIN;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (c0 + k < W) best = max(best, max(M[k], Ix[k]));
  return __reduce_max_sync(FULL, best);
}

}  // namespace
