// The full-width DP row shared by the unbanded scoring kernel (nw_full.cu)
// and the traceback kernel (nw_tb.cu, which also stores 4 direction bits per
// cell), so that both run one recurrence: the Pallas _nw_kernel /
// _nw_tb_kernel body, every term floored at NEG_INF.
//
// Column space.  A group of G lanes owns one (read-strand, window) pair; the
// including kernel chooses G (NW_GROUP_LANES: 8 for scoring, 16 for the
// traceback, whose resident hits the direction store bounds, so that more
// lanes a hit keep more warps in flight).  Lane g owns the NC = ceil(W / G)
// contiguous window columns c = g NC + k (DP column j = c + 1) and keeps,
// for the row it finished last, two register arrays:
//   D[k] = max(M, Ix, Iy)                  the next row's diagonal
//                                          predecessor of column c + 1
//   T[k] = max(M - open, Ix - ext, NEG_INF)   the next row's Ix, same column
// Columns do not slide, so the lane's window codes are NC fixed bytes of
// 4 x code (the byte offset of the code's int32 in an emission row), loaded
// once; columns c >= W hold the poison code 5, whose emission is DEEP, and
// start at NEG_INF, so they stay at NEG_INF except for the Iy chain that
// passes through them and never feeds a column < W.
//
// One ascending pass per row: the cell is the banded kernel's
// (nw_band_row.cuh), five DPX instructions and the emission's address,
//   M    = max(e + d, NEG_INF)       d = the old D of the column to the left
//   D[k] = max(M, Ix, Iy)            Ix = T[k], Iy = q
//   mo   = max(M - open, NEG_INF)
//   q    = max(q - ext, mo)          Iy of the next column
//   T[k] = max(Ix - ext, mo)
// with the old D[k] kept one step as the next column's d.  The frozen Iy is
// the prefix max  Iy[c] = max(max_{c' < c}(M[c'] + (c' + 1) ext) - open
// - c ext, NEG_INF), floored once; the chain floors where it writes.  Both
// give the same values: with r the unfloored chain r' = max(r - ext,
// M - open) and q = max(r, NEG_INF), either r >= NEG_INF and q' = max(r',
// NEG_INF), or r < NEG_INF and both sides are max(M - open, NEG_INF)
// (ext >= 0); the same holds for T.  Column 0 never feeds Iy: the chain
// enters the first strip as NEG_INF.
//
// Skew.  Lane g works on row s - g at step s.  What crosses a strip's left
// edge is two values per row: the left strip's last-column D of the row
// above (kept when that lane overwrote it) and its q of this row, each by
// one __shfl_up_sync a step, whatever the group's length: no scan and no
// shuffle per cell.  A pair of len rows takes len + G - 1 steps.
//
// Column 0 (M = 0 on row 0, then NEG_INF; Ix the ramp) is a scalar of the
// group's first lane: d0 = max(M, Ix) of column 0 on the row above.
//
// Band mask ([FROZEN v3], traceback only): DP columns outside [lo, hi] get
// M = Ix = Iy = NEG_INF, so D and T are NEG_INF there.  The masked columns
// are a prefix and a suffix of the row; in the prefix every M is NEG_INF, so
// the chain stays at NEG_INF as the frozen prefix max does, and nothing reads
// the suffix's chain.
//
// Direction bits, stored by the cell that owns the values (DIRS).  Each of
// the frozen bits of cell (i, j) compares values of a neighbour cell:
//   bits 0..1  which of M, Ix, Iy of (i - 1, j - 1) is their maximum,
//              M, then Ix, then Iy on ties
//   bit  2     M - open >= Ix - ext at (i - 1, j)
//   bit  3     M - open >= Iy - ext at (i, j - 1)
// so a cell decides all four about itself when it has its own M, Ix, Iy and
// D in hand, and the backwalk reads them at the shifted index.  It stores
// the sign bits of four differences (a nibble s3 s2 s1 s0):
//   s0 = M < D      s1 = Ix < D      (M's predecessor: 0 if !s0, else 1 if
//                                     !s1, else 2)
//   s2 = M - open < Ix - ext         (the complement of bit 2)
//   s3 = M - open < Iy - ext         (the complement of bit 3)
// s2 and s3 are taken as u < Ix and u < Iy with u = M - open + ext.  Every
// difference is of two values in [NEG_INF - open, 2^28 + ext], so its sign
// is the comparison.  One funnel shift moves a sign bit into the nibble
// word; four cells make a 16-bit word, the first cell in the top nibble.

#pragma once

#include "nw_band_row.cuh"

namespace {

#ifndef NW_GROUP_LANES
#error "define NW_GROUP_LANES (lanes per pair: 8 or 16) before nw_full_row.cuh"
#endif

constexpr unsigned FULL = 0xffffffffu;
constexpr int G = NW_GROUP_LANES;  // lanes per pair
constexpr int MAX_W = 256;         // widest window served
constexpr int MAX_NC = MAX_W / G;  // columns per lane there

// 32-bit words of the NC code bytes, and 16-bit words of the NC nibbles.
__host__ __device__ constexpr int strip_words(int nc) { return (nc + 3) / 4; }

// Columns per lane for window width W.
__host__ __device__ constexpr int strip_cols(int W) { return (W + G - 1) / G; }

// The strip widths a kernel is built for: 1 .. MAX_NC.
#define NW_STRIP_WIDTHS_16(X)                                             \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16)
#if NW_GROUP_LANES == 16
#define NW_STRIP_WIDTHS(X) NW_STRIP_WIDTHS_16(X)
#elif NW_GROUP_LANES == 8
#define NW_STRIP_WIDTHS(X)                                                  \
  NW_STRIP_WIDTHS_16(X)                                                     \
  X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26) X(27) X(28) \
  X(29) X(30) X(31) X(32)
#else
#error "NW_GROUP_LANES must be 8 or 16"
#endif

// Row 0 of a strip and its window codes: M = 0, Ix = Iy = NEG_INF on window
// columns c < W; NEG_INF past them.
template <int NC>
__device__ __forceinline__ void strip_init(int (&D)[NC], int (&T)[NC],
                                           unsigned (&P)[strip_words(NC)],
                                           const int8_t* __restrict__ g,
                                           long long Gn, long long ws, int c0,
                                           int W, int open_q) {
#pragma unroll
  for (int w = 0; w < strip_words(NC); ++w) {
    unsigned x = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x |= code4_at(g, Gn, ws, c0 + 4 * w + k, W) << (8 * k);
    P[w] = x;
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool in = c0 + k < W;
    D[k] = in ? 0 : NEG_INF;
    T[k] = in ? max(-open_q, NEG_INF) : NEG_INF;
  }
}

// push the sign bit of x into the low end of acc
__device__ __forceinline__ unsigned push_sign(unsigned acc, int x) {
  return __funnelshift_l((unsigned)x, acc, 1);
}

// One DP row over the lane's NC columns.  d: in, the D of the column left of
// the strip on the row above; out, the strip's last-column D of the row
// above.  q: in, the Iy chain entering the strip; out, leaving it.
// emit(word, k) is the row's emission for the column whose code byte is
// byte k of word.  With BANDED, strip columns outside [klo, khi] are masked.
// With DIRS, store(w, x) gets the 16-bit word w of the row's nibbles.
template <int NC, bool DIRS, bool BANDED, class Emit, class Store>
__device__ __forceinline__ void strip_row(int (&D)[NC], int (&T)[NC],
                                          const unsigned (&P)[strip_words(NC)],
                                          int& d, int& q, Emit emit,
                                          int open_q, int ext_q, int klo,
                                          int khi, Store store) {
  const int nopen = -open_q, next = -ext_q;
  int dprev = d, qq = q;
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int e = emit(P[k >> 2], k & 3);
    int mn = addmax(e, dprev, NEG_INF);
    dprev = D[k];
    int ixn = T[k];
    int iy = qq;
    if constexpr (BANDED) {
      const bool off = k < klo || k > khi;
      mn = off ? NEG_INF : mn;
      ixn = off ? NEG_INF : ixn;
      iy = off ? NEG_INF : iy;
    }
    const int dn = max3(mn, ixn, iy);
    D[k] = dn;
    const int mo = addmax(mn, nopen, NEG_INF);
    qq = addmax(iy, next, mo);
    T[k] = addmax(ixn, next, mo);
    if constexpr (DIRS) {
      // M - open < Iy - ext and M - open < Ix - ext, as u < Iy and u < Ix
      const int u = mn + (ext_q - open_q);
      acc = push_sign(acc, u - iy);
      acc = push_sign(acc, u - ixn);
      acc = push_sign(acc, ixn - dn);
      acc = push_sign(acc, mn - dn);
      if ((k & 3) == 3)
        store(k >> 2, acc);
      else if (k == NC - 1)
        store(k >> 2, acc << (4 * (3 - (k & 3))));
    }
  }
  d = dprev;
  q = qq;
}

// max over the strip's window columns c < W of D, then over the group: the
// best end value max(M, Ix) of the row (Iy <= M - open of a column to its
// left, open >= 0, so it never exceeds it).  The same in every lane of the
// group; every lane of the warp calls it.
template <int NC>
__device__ __forceinline__ int group_best(const int (&D)[NC], int c0, int W) {
  int best = NEG_INF;
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if (c0 + k < W) best = max(best, D[k]);
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, s, G));
  return best;
}

}  // namespace
