// The banded DP recurrence of the banded scoring kernel (nw_band.cu).  The
// pure-diagonal detection kernel (nw_pure.cu) runs the same recurrence, value
// for value, split over a group of lanes (its strip_row), and takes the
// constants and helpers from here: B2's test "max(M, Ix) == score" compares
// its own end-row values with B1's scores.
//
// Diagonal-band state of one (read-strand, window) pair: lane b at read row
// i scores window column col = i + b - boff.  A thread keeps two register
// arrays of BW int32: D = max(M, Ix, Iy) (the next row's diagonal
// predecessor, same lane) and T = max(M - open, Ix - ext, NEG_INF) (the next
// row's Ix, lane b + 1).  Window codes live in P, one byte per lane holding
// 4 * code (the byte offset of the code's int32 in an emission row), and
// slide one lane per row.  See nw_band.cu for the derivation.
//
// A band cell is five integer instructions on Hopper (sm_90a), all DPX
// (VIADDMNMX = max(a + b, c), VIMNMX3 = max(a, b, c); exact integer
// operations), plus the emission fetch its caller supplies:
//   M   = max(e + D[b], NEG_INF)
//   D[b] = max(M, Ix, Iy)            Ix = T[b + 1], Iy = q
//   mo  = max(M - open, NEG_INF)
//   q   = max(q - ext, mo)           Iy of lane b + 1
//   T[b] = max(Ix - ext, mo)
// Every value is floored at NEG_INF where it is written, not where it is
// read: q and T are built on mo >= NEG_INF, so they never drop below it.
// That gives the frozen values exactly: with r the unfloored chain
// r' = max(r - ext, M - open) and q = max(r, NEG_INF), either r >= NEG_INF
// and q' = max(r', NEG_INF), or r < NEG_INF and both sides are
// max(M - open, NEG_INF) (ext >= 0); the same argument holds for T.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 29);
constexpr int DEEP = -(1 << 30);
constexpr int SENTINEL = 0x7fffffff;
constexpr int ECODES = 6;  // emission row: codes 0..4, then DEEP for code 5

__host__ __device__ constexpr int band_words(int bw) { return (bw + 3) / 4; }

// max(a + b, c) and max(a, b, c) as single DPX instructions.
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}
__device__ __forceinline__ int max3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}

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

// The band's byte for that code: 4 * code.
__device__ __forceinline__ unsigned code4_at(const int8_t* __restrict__ g,
                                             long long G, long long ws,
                                             int wi, int W) {
  return code_at(g, G, ws, wi, W) << 2;
}

// Lane k's byte of a word of P: 4 * code.
__device__ __forceinline__ unsigned code_byte(unsigned word, int k) {
  return (word >> (8 * k)) & 255u;
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
                                          unsigned (&P)[band_words(BW)],
                                          const int8_t* __restrict__ g,
                                          long long G, long long ws, int W,
                                          int boff, int open_q) {
#pragma unroll
  for (int w = 0; w < band_words(BW); ++w) {
    unsigned x = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x |= code4_at(g, G, ws, 4 * w + k - boff, W) << (8 * k);
    P[w] = x;
  }
#pragma unroll
  for (int b = 0; b <= BW; ++b) {
    const int col = b - boff;
    const int m = (col >= 0 && col <= W) ? 0 : NEG_INF;
    if (b < BW) D[b] = m;
    T[b] = max(m - open_q, NEG_INF);
  }
}

// Window index of the code that enters the top byte of P after row i: row
// i + 1's top lane.  Load it with code4_at before the row, so that the load
// is in flight while the row is computed, and hand it to band_slide.
template <int BW>
__device__ __forceinline__ int slide_index(int i, int boff) {
  return i + 4 * band_words(BW) - 1 - boff;
}

// After row i: slide the window codes one lane down and take in `top`.
template <int BW>
__device__ __forceinline__ void band_slide(unsigned (&P)[band_words(BW)],
                                           unsigned top) {
  constexpr int NWD = band_words(BW);
#pragma unroll
  for (int w = 0; w + 1 < NWD; ++w)
    P[w] = __funnelshift_r(P[w], P[w + 1], 8);
  P[NWD - 1] = (P[NWD - 1] >> 8) | (top << 24);
}

// One DP row over the BW band lanes.  emit(word, k) is the row's emission
// for lane 4 * w + k, whose code byte is byte k of word = P[w] (DEEP for
// code 5); lane(b, e, M, Ix) sees each lane's emission and its new M and
// Ix.  One ascending pass reads lane b + 1 of T before overwriting it, and
// carries the Iy gap chain in q: the exact integer unrolling of the frozen
// prefix max (see the head of this file).
template <int BW, class Emit, class Lane>
__device__ __forceinline__ void band_row(int (&D)[BW], int (&T)[BW + 1],
                                         const unsigned (&P)[band_words(BW)],
                                         Emit emit, int open_q, int ext_q,
                                         Lane lane) {
  const int nopen = -open_q, next = -ext_q;
  int q = NEG_INF;
#pragma unroll
  for (int b = 0; b < BW; ++b) {
    const int e = emit(P[b >> 2], b & 3);
    const int mn = addmax(e, D[b], NEG_INF);
    const int ixn = T[b + 1];
    D[b] = max3(mn, ixn, q);
    const int mo = addmax(mn, nopen, NEG_INF);
    q = addmax(q, next, mo);
    T[b] = addmax(ixn, next, mo);
    lane(b, e, mn, ixn);
  }
}

}  // namespace
