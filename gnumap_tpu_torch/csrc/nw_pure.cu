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
// Design (simple first):
//   * One thread per retained hit; the band recurrence is B1's
//     (nw_band_row.cuh), so the end-row values are exactly those B1 scored,
//     including row 1's last lane (Ix = -open, as in oracle.nw_align).
//   * gl[BW] sits in registers beside B1's D and T: one add per lane per
//     row, floored at NEG_INF, DEEP outside window columns [1, W].
//   * The epilogue runs in the thread at row len, where M and Ix of every
//     lane are at hand, in ascending lane order, so no end-row capture
//     arrays are written.
//   * Each hit has its own read-strand emission table, so a thread stages
//     its row's 5 emissions in its own column of shared memory (row 5
//     holds DEEP) and a lane's emission is one shared load by window code.
//   * SENTINEL slots, length 0 (and len > L) and score <= 0 give
//     (false, 0) at once, as the reference's epilogue does for them.
//
// What bounds it: the int32 instruction rate.  A live hit (not SENTINEL,
// 0 < len <= L, score > 0) costs len rows of BW band cells.  The fewest
// instructions a cell needs are B1's 6 (5 DPX and one for the emission's
// address, which nw_band.cu forms with a single IDP.4A) and one more
// VIADDMNMX for gl, 7 in all.  So
//   bound = live hits x len x BW x 7 / 16.7e12 int32 operations a second,
// or the bytes (tables, candidates, lengths and scores in, pure and jfin out)
// over 3.35 TB/s where that is larger.  This kernel spends 8 a cell: its
// per-thread staging column takes 2 instructions for the address (byte
// extract, multiply-add), then the shared load; besides 5 global loads per
// row.  The band state is register-resident; at bw 62 (gap_slack 13) D, T
// and gl need about 190 registers, so a spill there is possible (the build
// reports it).
//
// C interface (ctypes): nw_pure_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported band width, -2 for bad sizes.  It
// launches on the given stream, does not synchronise and allocates nothing.

#include "nw_band_row.cuh"

namespace {

constexpr int NT = 128;  // hits per block

template <int BW>
__global__ void __launch_bounds__(NT)
nw_pure_kernel(const int32_t* __restrict__ emis_t,
               const int32_t* __restrict__ cands,
               const int32_t* __restrict__ lens,
               const int32_t* __restrict__ scores,
               const int8_t* __restrict__ genome, long long G,
               uint8_t* __restrict__ pure_out, int32_t* __restrict__ jfin_out,
               int H, int L, int W, int slack, int boff, int open_q,
               int ext_q) {
  __shared__ int32_t s_e[ECODES * NT];
  const int t = threadIdx.x;
  const int h = blockIdx.x * NT + t;
  if (h >= H) return;
  int32_t* se = s_e + t;  // this thread's column: se[v * NT], v = code
  se[5 * NT] = DEEP;
  const int cand = cands[h];
  const int len = lens[h];
  const int score = scores[h];
  bool pure = false;
  int end = 0;
  if (cand != SENTINEL && len > 0 && len <= L && score > 0) {
    const long long ws = window_start(cand, slack);
    const int32_t* e_h = emis_t + (size_t)h * 5 * L;
    // a byte of P is 4 * code: the code's row of s_e is NT int32 further
    const auto emit = [se](unsigned word, int k) {
      return *reinterpret_cast<const int32_t*>(
          reinterpret_cast<const unsigned char*>(se) + code_byte(word, k) * NT);
    };
    unsigned P[band_words(BW)];
    int D[BW], T[BW + 1], gl[BW];
    band_init<BW>(D, T, P, genome, G, ws, W, boff, open_q);
#pragma unroll
    for (int b = 0; b < BW; ++b) gl[b] = 0;
    for (int i = 1; i < len; ++i) {
      const unsigned top =
          code4_at(genome, G, ws, slide_index<BW>(i, boff), W);
#pragma unroll
      for (int v = 0; v < 5; ++v) se[v * NT] = e_h[(size_t)v * L + i - 1];
      band_row<BW>(D, T, P, emit, open_q, ext_q,
                   [&gl](int b, int e, int, int) {
                     gl[b] = addmax(gl[b], e, NEG_INF);
                   });
      T[BW] = NEG_INF;  // out of band from row 1 on
      band_slide<BW>(P, top);
    }
#pragma unroll
    for (int v = 0; v < 5; ++v) se[v * NT] = e_h[(size_t)v * L + len - 1];
    // end row: the smallest lane with max(M, Ix) == score is the end cell
    bool found = false;
    band_row<BW>(D, T, P, emit, open_q, ext_q,
                 [&](int b, int e, int mn, int ixn) {
                   const int g = addmax(gl[b], e, NEG_INF);
                   if (!found && max(mn, ixn) == score) {
                     found = true;
                     end = b;
                     pure = mn >= ixn && g == score;
                   }
                 });
  }
  pure_out[h] = pure ? 1 : 0;
  jfin_out[h] = pure ? end - boff : 0;
}

template <int BW>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int32_t* scores,
                   const int8_t* genome, long long G, uint8_t* pure,
                   int32_t* jfin, int H, int L, int W, int slack, int boff,
                   int open_q, int ext_q, cudaStream_t stream) {
  nw_pure_kernel<BW><<<(H + NT - 1) / NT, NT, 0, stream>>>(
      emis_t, cands, lens, scores, genome, G, pure, jfin, H, L, W, slack,
      boff, open_q, ext_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nw_pure_launch(const void* emis_t, const void* cands,
                              const void* lens, const void* scores,
                              const void* genome, long long G, void* pure,
                              void* jfin, int H, int L, int W, int slack,
                              int boff, int bw, int open_q, int ext_q,
                              void* stream) {
  if (H <= 0) return 0;
  if (L <= 0) return -2;
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
                          open_q, ext_q, s);
    // bw = 4 * gap_slack + 10 for gap_slack 0..13 (MapperConfig.band)
    NW_PURE_CASE(10) NW_PURE_CASE(14) NW_PURE_CASE(18) NW_PURE_CASE(22)
    NW_PURE_CASE(26) NW_PURE_CASE(30) NW_PURE_CASE(34) NW_PURE_CASE(38)
    NW_PURE_CASE(42) NW_PURE_CASE(46) NW_PURE_CASE(50) NW_PURE_CASE(54)
    NW_PURE_CASE(58) NW_PURE_CASE(62)
#undef NW_PURE_CASE
    default:
      return -1;
  }
}
