// Banded affine-gap probabilistic Needleman-Wunsch scores ([FROZEN v4]) for
// every (read-strand, candidate) pair, on Hopper (sm_90a).
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_band_kernel (launched there by
// nw_scores_banded).  It computes the same int32 scores; it does not copy the
// TPU layout (segment packing into 128 lanes, the rolled 4-bit window plane,
// SMEM meta, the unroll / peel / state-carry variants).
//
// Design (simple first):
//   * One block per read-strand row (grid.y splits C > 128 candidates);
//     thread c owns candidate c and exits at once on SENTINEL with NEG_INF.
//   * The row's L x 5 emission table is staged in shared memory as rows of 8
//     (codes 0..4, then DEEP for the poison code 5), so a lane's emission is
//     one shared load indexed by its window code.
//   * Diagonal-band state (the recurrence is in nw_band_row.cuh, shared
//     with nw_pure.cu): lane b at read row i scores window column
//     col = i + b - boff.  Each thread keeps two register arrays of BW int32:
//     D = max(M, Ix, Iy) (the next row's diagonal predecessor, same lane) and
//     T = max(M - open, Ix - ext) (the next row's Ix source, lane b + 1).
//     One ascending pass per row reads lane b + 1 before overwriting it, and
//     carries the Iy gap chain as q = max(q - ext, M_new - open) -- the exact
//     integer unrolling of the frozen prefix max.  Every term floors at
//     NEG_INF as in the Pallas body.
//   * Window codes come from the int8 genome codes in device memory: N (4)
//     outside the genome, the DEEP poison (5) outside window columns [1, W].
//     They live 4-bit packed in registers and slide one lane per row; one
//     new code is loaded per row.
//   * The column-0 ramp needs no state: where the band holds column 0 its lane
//     carries the ramp itself (so no col == 1 select is needed), and at the
//     last row ix0 = max(-(open + (len - 1) ext), NEG_INF) in closed form.
//   * Row 0 is not banded ([FROZEN v3] masks rows >= 1 only): T keeps one
//     lane past the band, T[BW], holding row 0's column BW - boff, so row 1's
//     last lane gets Ix = -open there as in oracle.nw_align / nw_ref (the
//     Pallas kernel floors it to NEG_INF; the two differ only where an
//     emission is below -open, and then only in unretained scores).
//   * The score is latched at row len: max over lanes of max(M, Ix), and ix0.
//     Length-0 reads (and len > L) give NEG_INF, as the Pallas kernel does.
//
// Bound: int32 ALU work, about 15 operations per band cell, BW cells per row
// per thread; the band state is register-resident (template on BW) but a
// warp holds only one read-strand's candidates, most of which are SENTINEL on
// the map path, so most lanes of a warp idle.  Making it fast is later work:
// a warp per pair with shuffles for the Ix / Iy shifts, and compaction of the
// live pairs.
//
// C interface (ctypes): nw_band_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported band width, -2 for bad sizes.  It launches
// on the given stream, does not synchronise and allocates nothing.

#include "nw_band_row.cuh"

namespace {

constexpr int MAX_THREADS = 128; // candidates per block

template <int BW>
__global__ void __launch_bounds__(MAX_THREADS)
nw_band_kernel(const int32_t* __restrict__ emis_t,
               const int32_t* __restrict__ cands,
               const int32_t* __restrict__ lens,
               const int8_t* __restrict__ genome, long long G,
               int32_t* __restrict__ out, int C, int L, int W, int slack,
               int boff, int open_q, int ext_q) {
  extern __shared__ int32_t s_emis[];
  const int row = blockIdx.x;
  const int len = lens[row];
  const int32_t* e_row = emis_t + (size_t)row * 5 * L;
  for (int k = threadIdx.x; k < L * EROW; k += blockDim.x) {
    const int i = k / EROW, v = k % EROW;
    s_emis[k] = v < 5 ? e_row[(size_t)v * L + i] : DEEP;
  }
  __syncthreads();
  const int c = blockIdx.y * MAX_THREADS + threadIdx.x;
  if (c >= C) return;
  const int cand = cands[(size_t)row * C + c];
  int32_t* dst = out + (size_t)row * C + c;
  if (cand == SENTINEL || len <= 0 || len > L) {
    *dst = NEG_INF;
    return;
  }
  const long long ws = window_start(cand, slack);
  unsigned P[(BW + 7) / 8];
  int D[BW], T[BW + 1];
  band_init<BW>(D, T, P, genome, G, ws, W, boff, open_q, ext_q);
  const auto none = [](int, int, int, int) {};
  for (int i = 1; i < len; ++i) {
    const int32_t* er = s_emis + (i - 1) * EROW;
    band_row<BW>(D, T, P, [er](unsigned code) { return er[code]; }, open_q,
                 ext_q, none);
    T[BW] = NEG_INF;  // out of band from row 1 on
    band_slide<BW>(P, genome, G, ws, i, boff, W);
  }
  // the score is latched at row len: max over lanes of max(M, Ix), and ix0
  const int32_t* er = s_emis + (len - 1) * EROW;
  int fin = NEG_INF;
  band_row<BW>(D, T, P, [er](unsigned code) { return er[code]; }, open_q,
               ext_q, [&fin](int, int, int mn, int ixn) {
                 fin = max(fin, max(mn, ixn));
               });
  const long long ix0 = -(long long)open_q - (long long)(len - 1) * ext_q;
  *dst = max(fin, (int)(ix0 > NEG_INF ? ix0 : NEG_INF));
}

template <int BW>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int8_t* genome, long long G,
                   int32_t* out, int B2, int C, int L, int W, int slack,
                   int boff, int open_q, int ext_q, cudaStream_t stream) {
  const int threads = C < MAX_THREADS ? (C + 31) / 32 * 32 : MAX_THREADS;
  const dim3 grid(B2, (C + MAX_THREADS - 1) / MAX_THREADS);
  const size_t smem = (size_t)L * EROW * sizeof(int32_t);
  nw_band_kernel<BW><<<grid, threads, smem, stream>>>(
      emis_t, cands, lens, genome, G, out, C, L, W, slack, boff, open_q,
      ext_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nw_band_launch(const void* emis_t, const void* cands,
                              const void* lens, const void* genome,
                              long long G, void* out, int B2, int C, int L,
                              int W, int slack, int boff, int bw, int open_q,
                              int ext_q, void* stream) {
  if (B2 <= 0 || C <= 0) return 0;
  if (L <= 0 || L * EROW * 4 > 48 * 1024) return -2;
  const auto* e = static_cast<const int32_t*>(emis_t);
  const auto* cd = static_cast<const int32_t*>(cands);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* g = static_cast<const int8_t*>(genome);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bw) {
#define NW_BAND_CASE(N)                                                    \
  case N:                                                                  \
    return (int)launch<N>(e, cd, ln, g, G, o, B2, C, L, W, slack, boff,   \
                          open_q, ext_q, s);
    // bw = 4 * gap_slack + 10 for gap_slack 0..13 (MapperConfig.band)
    NW_BAND_CASE(10) NW_BAND_CASE(14) NW_BAND_CASE(18) NW_BAND_CASE(22)
    NW_BAND_CASE(26) NW_BAND_CASE(30) NW_BAND_CASE(34) NW_BAND_CASE(38)
    NW_BAND_CASE(42) NW_BAND_CASE(46) NW_BAND_CASE(50) NW_BAND_CASE(54)
    NW_BAND_CASE(58) NW_BAND_CASE(62)
#undef NW_BAND_CASE
    default:
      return -1;
  }
}
