// Unbanded affine-gap probabilistic Needleman-Wunsch scores for every
// (read-strand, candidate) pair, on Hopper (sm_90a): the scoring path when
// MapperConfig.band() is None (gap_slack >= 14).
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_kernel (launched there by
// nw_scores_pallas).  It computes the same int32 scores; it does not copy
// the TPU layout (64-sublane tiles of rpt reads x tpc candidates, the
// candidate-count row sort, 4-bit window words, per-tile skip flags).
//
// Design (simple first):
//   * One warp per (read-strand, candidate) pair, K = ceil(W / 32)
//     contiguous window columns per lane; the row step is nw_full_row.cuh's,
//     the forward pass of the traceback kernel nw_tb.cu without its
//     direction bits.  SENTINEL warps write NEG_INF and exit at once.
//   * The score is latched at row len instead of running the Pallas
//     kernel's free pad rows up to L: on a pad row the emission and the
//     read-gap costs are 0, so Ix carries max(M, Ix) of every column down
//     unchanged, M only shifts earlier values right, Iy stays below the M
//     it came from, and column 0's ramp stops; max over columns < W of
//     max(M, Ix), and ix0, are the row-len values.
//   * Length 0 gives 0 (row 0: M = 0 on every column), as the Pallas
//     kernel's all-pad-row run does; such a pair is never retained, since
//     retention needs a score > 0.  len > L gives NEG_INF.
//   * Emissions are read by lanes 0..4 from device memory, one row ahead.
//
// What bounds it: the int32 instruction rate.  A live pair (not SENTINEL,
// 0 <= len <= L) costs len rows of W cells (W = L + 2 gap_slack + 8); the
// least a cell needs is the banded cell's 6 integer instructions
// (nw_band_row.cuh: 5 DPX and the emission's address).  So
//   bound = live pairs x len x W x 6 / 16.7e12 int32 operations a second,
// or the bytes over 3.35 TB/s where that is larger (each live row's emission
// table, each live pair's window, candidates and lengths in, scores out).
// This kernel spends about 20 operations and shuffles per cell.
//
// C interface (ctypes): nw_full_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported width (W > 256), -2 for bad sizes.  It
// launches on the given stream, does not synchronise and allocates nothing.

#include "nw_full_row.cuh"

namespace {

constexpr int WARPS = 4;  // pairs per block

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
nw_full_kernel(const int32_t* __restrict__ emis_t,
               const int32_t* __restrict__ cands,
               const int32_t* __restrict__ lens,
               const int8_t* __restrict__ genome, long long G,
               int32_t* __restrict__ out, long long P, int C, int L, int W,
               int slack, int open_q, int ext_q) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;  // warp-uniform
  const long long row = p / C;
  const int cand = cands[p];
  const int len = lens[row];
  if (cand == SENTINEL || len < 0 || len > L) {
    if (lane == 0) out[p] = NEG_INF;
    return;
  }
  const int c0 = lane * K;
  const unsigned codes =
      lane_codes<K>(genome, G, window_start(cand, slack), c0, W);
  int M[K], Ix[K], Iy[K], m0, ix0;
  full_init<K>(M, Ix, Iy, m0, ix0);
  const int32_t* e_h = emis_t + (size_t)row * 5 * L;
  int ev_next = lane < 5 ? e_h[(size_t)lane * L] : NEG_INF;
  for (int i = 1; i <= len; ++i) {
    const int ev = ev_next;
    if (i < len && lane < 5) ev_next = e_h[(size_t)lane * L + i];
    full_row<K, false>(M, Ix, Iy, m0, ix0, ev, codes, lane, false, 0, 0,
                       open_q, ext_q);
  }
  const int best = full_best<K>(M, Ix, c0, W);
  if (lane == 0) out[p] = max(best, ix0);
}

template <int K>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int8_t* genome, long long G,
                   int32_t* out, long long P, int C, int L, int W, int slack,
                   int open_q, int ext_q, cudaStream_t stream) {
  const long long blocks = (P + WARPS - 1) / WARPS;
  nw_full_kernel<K><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      emis_t, cands, lens, genome, G, out, P, C, L, W, slack, open_q, ext_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nw_full_launch(const void* emis_t, const void* cands,
                              const void* lens, const void* genome,
                              long long G, void* out, int B2, int C, int L,
                              int W, int slack, int open_q, int ext_q,
                              void* stream) {
  if (B2 <= 0 || C <= 0) return 0;
  if (L <= 0 || W <= 0) return -2;
  const long long P = (long long)B2 * C;
  if ((P + WARPS - 1) / WARPS > 0x7fffffffLL) return -2;
  const auto* e = static_cast<const int32_t*>(emis_t);
  const auto* cd = static_cast<const int32_t*>(cands);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* g = static_cast<const int8_t*>(genome);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((W + 31) / 32) {
#define NW_FULL_CASE(N)                                                    \
  case N:                                                                  \
    return (int)launch<N>(e, cd, ln, g, G, o, P, C, L, W, slack, open_q,   \
                          ext_q, s);
    NW_FULL_CASE(1) NW_FULL_CASE(2) NW_FULL_CASE(3) NW_FULL_CASE(4)
    NW_FULL_CASE(5) NW_FULL_CASE(6) NW_FULL_CASE(7) NW_FULL_CASE(8)
#undef NW_FULL_CASE
    default:
      return -1;
  }
}
