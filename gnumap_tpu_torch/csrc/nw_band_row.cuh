// The banded DP recurrence shared by the banded scoring kernel (nw_band.cu)
// and the pure-diagonal detection kernel (nw_pure.cu), so that both run one
// recurrence: B2's test "max(M, Ix) == score" compares its own end-row
// values with B1's scores.
//
// Diagonal-band state of one (read-strand, window) pair: lane b at read row
// i scores window column col = i + b - boff.  A thread keeps two register
// arrays of BW int32: D = max(M, Ix, Iy) (the next row's diagonal
// predecessor, same lane) and T = max(M - open, Ix - ext) (the next row's Ix
// source, lane b + 1).  Window codes live 4-bit packed in P and slide one
// lane per row.  See nw_band.cu for the derivation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 29);
constexpr int DEEP = -(1 << 30);
constexpr int SENTINEL = 0x7fffffff;
constexpr int EROW = 8;  // emission row: codes 0..4, then DEEP for code 5

// Window code at window index wi (0-based; DP column wi + 1): N (4) outside
// the genome, the DEEP poison code (5) outside window columns [1, W].
__device__ __forceinline__ unsigned code_at(const int8_t* __restrict__ g,
                                            long long G, long long ws, int wi,
                                            int W) {
  if (wi < 0 || wi >= W) return 5u;
  const long long p = ws + wi;
  if (p < 0 || p >= G) return 4u;
  return (unsigned)__ldg(g + p) & 15u;
}

// [FROZEN] window rule: ws = floor((cand - slack) / 8) * 8
__device__ __forceinline__ long long window_start(int cand, int slack) {
  const long long a = (long long)cand - slack;
  return (a >= 0 ? a / 8 : -((-a + 7) / 8)) * 8;
}

// Row 0 of the band and row 1's window codes.  Row 0: M = 0 on window
// columns [0, W], Ix = Iy = NEG_INF.  T keeps one lane past the band,
// T[BW], holding row 0's column BW - boff: row 0 is not banded ([FROZEN v3]
// masks rows >= 1 only), so row 1's last lane reads Ix = -open there, as in
// oracle.nw_align.  The caller sets T[BW] = NEG_INF after row 1.
template <int BW>
__device__ __forceinline__ void band_init(int (&D)[BW], int (&T)[BW + 1],
                                          unsigned (&P)[(BW + 7) / 8],
                                          const int8_t* __restrict__ g,
                                          long long G, long long ws, int W,
                                          int boff, int open_q, int ext_q) {
  constexpr int NWD = (BW + 7) / 8;
#pragma unroll
  for (int w = 0; w < NWD; ++w) {
    unsigned x = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x |= code_at(g, G, ws, 8 * w + k - boff, W) << (4 * k);
    P[w] = x;
  }
#pragma unroll
  for (int b = 0; b <= BW; ++b) {
    const int col = b - boff;
    const int m = (col >= 0 && col <= W) ? 0 : NEG_INF;
    if (b < BW) D[b] = m;
    T[b] = max(m - open_q, NEG_INF - ext_q);
  }
}

// After row i: slide the window codes one lane down; row i + 1's top lane
// reads window index i + TOP - boff.
template <int BW>
__device__ __forceinline__ void band_slide(unsigned (&P)[(BW + 7) / 8],
                                           const int8_t* __restrict__ g,
                                           long long G, long long ws, int i,
                                           int boff, int W) {
  constexpr int NWD = (BW + 7) / 8;
  constexpr int TOP = 8 * NWD - 1;
#pragma unroll
  for (int w = 0; w + 1 < NWD; ++w)
    P[w] = __funnelshift_r(P[w], P[w + 1], 4);
  P[NWD - 1] =
      (P[NWD - 1] >> 4) | (code_at(g, G, ws, i + TOP - boff, W) << 28);
}

// One DP row over the BW band lanes.  emit(code) is the row's emission for
// a window code (DEEP for code 5); lane(b, e, M, Ix) sees each lane's
// emission and its new M and Ix.  One ascending pass reads lane b + 1 of T
// before overwriting it, and carries the Iy gap chain as
// q = max(q - ext, M - open): the exact integer unrolling of the frozen
// prefix max.  Every term floors at NEG_INF.
template <int BW, class Emit, class Lane>
__device__ __forceinline__ void band_row(int (&D)[BW], int (&T)[BW + 1],
                                         const unsigned (&P)[(BW + 7) / 8],
                                         Emit emit, int open_q, int ext_q,
                                         Lane lane) {
  int q = 0;
#pragma unroll
  for (int b = 0; b < BW; ++b) {
    const unsigned code = (P[b >> 3] >> (4 * (b & 7))) & 15u;
    const int e = emit(code);
    const int mn = max(e + D[b], NEG_INF);
    const int ixn = max(T[b + 1], NEG_INF);
    const int iyn = (b > 0) ? max(q, NEG_INF) : NEG_INF;
    q = (b > 0) ? max(q - ext_q, mn - open_q) : mn - open_q;
    D[b] = max(max(mn, ixn), iyn);
    T[b] = max(mn - open_q, ixn - ext_q);
    lane(b, e, mn, ixn);
  }
}

}  // namespace
