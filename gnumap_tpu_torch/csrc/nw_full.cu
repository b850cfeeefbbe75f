// Unbanded affine-gap probabilistic Needleman-Wunsch scores for every
// (read-strand, candidate) pair, on Hopper (sm_90a): the scoring path when
// MapperConfig.band() is None (gap_slack >= 14).
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_kernel (launched there by
// nw_scores_pallas).  It computes the same int32 scores; it does not copy
// the TPU layout (64-sublane tiles of rpt reads x tpc candidates, the
// candidate-count row sort, 4-bit window words, per-tile skip flags).
//
// What bounds it: the int32 instruction rate.  A live pair (not SENTINEL,
// 0 < len <= L) costs len rows of W cells (W = L + 2 gap_slack + 8); the
// least a cell needs is the banded cell's 6 integer instructions
// (nw_band_row.cuh: 5 DPX and the emission's address).  So
//   bound = live pairs x len x W x 6 / 16.7e12 int32 operations a second,
// or the bytes over 3.35 TB/s where that is larger (each live row's emission
// table, each live pair's window, candidates and lengths in, scores out).
//
// Design:
//   * Work follows live pairs, as in the banded kernel (nw_band.cu; the
//     staging and the compaction are nw_stage.cuh's): a block takes R = 16
//     consecutive read-strand rows (fewer when their tables do not fit),
//     stages their emission tables in shared memory, compacts the live
//     (row, c) slots into a list, writes the dead slots' values at once, and
//     walks the list.  No warp is spent on a SENTINEL.
//   * A group of G = 8 lanes owns a pair; a block of 128 threads takes 16
//     pairs of the list a round.  Lane g owns NC = ceil(W / 8) contiguous
//     columns in registers and runs nw_full_row.cuh's
//     column-space row, one row behind lane g - 1: two shuffles a row and
//     lane cross a strip's edge.  A cell is the banded kernel's: 4
//     VIADDMNMX, 1 VIMNMX3, 1 IDP.4A for the emission's shared address, and
//     the shared load; the compiler adds one register move a cell (the old
//     D[k] lives one step longer than its register).  With 8 lanes a pair a
//     W = 144 window is 18 columns a lane, 72 registers, and the skew costs
//     7 steps in 107; 16 lanes would double the skew and halve the cells
//     that share a row's two shuffles.
//   * __launch_bounds__(128, 4): 4 blocks a multiprocessor leave 128
//     registers a thread, enough for 32 columns a lane without a spill; the
//     tables (41.7 KB a block at L = 104) hold 5 blocks, 20 warps.
//   * Groups of one warp may hold reads of different length: the step loop
//     runs to the warp's longest pair, each lane works only on its own rows
//     1 .. len, and every lane executes the two shuffles of every step.
//   * The score is latched at row len instead of running the Pallas
//     kernel's free pad rows up to L: on a pad row the emission and the
//     read-gap costs are 0, so Ix carries max(M, Ix) of every column down
//     unchanged, M only shifts earlier values right, Iy stays below the M
//     it came from, and column 0's ramp stops.  A lane's state stays as its
//     last row left it; the score is the group's max of D over columns < W
//     (Iy never exceeds the M it opened from, nw_full_row.cuh) and the
//     column-0 ramp, which the first lane carries.
//   * Length 0 gives 0 (row 0: M = 0 on every column), as the Pallas
//     kernel's all-pad-row run does; such a pair is never retained, since
//     retention needs a score > 0.  len > L gives NEG_INF.
//
// C interface (ctypes): nw_full_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported width (W > 256), -2 for bad sizes
// (negative gap costs included).  It launches on the given stream, does not
// synchronise and allocates nothing.

#define NW_GROUP_LANES 8
#include "nw_full_row.cuh"
#include "nw_stage.cuh"

namespace {

constexpr int NT = 128;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int NGROUP = NT / G;  // pairs per round
// Shared memory a block may ask for: above SOFT_SMEM the rows per block are
// halved (four blocks a multiprocessor stay resident).
constexpr size_t SOFT_SMEM = 56 * 1024;

template <int NC>
__global__ void __launch_bounds__(NT, 4)
nw_full_kernel(const int32_t* __restrict__ emis_t,
               const int32_t* __restrict__ cands,
               const int32_t* __restrict__ lens,
               const int8_t* __restrict__ genome, long long Gn,
               int32_t* __restrict__ out, int B2, int C, int L, int W,
               int slack, int open_q, int ext_q, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wcnt[NWARP];
  const int S = table_stride(L);
  int32_t* s_emis = reinterpret_cast<int32_t*>(smem);           // R x S
  int* s_len = reinterpret_cast<int*>(s_emis + (size_t)R * S);  // R
  unsigned short* s_list =
      reinterpret_cast<unsigned short*>(s_len + R);             // R x C
  const int tid = threadIdx.x;
  const int g = tid & (G - 1), grp = tid / G;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B2 - row0);
  const int slots = nrows * C;
  const int32_t* cg = cands + (size_t)row0 * C;
  int32_t* og = out + (size_t)row0 * C;

  if (tid < nrows) s_len[tid] = lens[row0 + tid];
  stage_tables<NT>(s_emis, emis_t + (size_t)row0 * 5 * L, nrows, L, S, tid);
  __syncthreads();
  const int n = compact_live<NT, true>(cg, og, s_len, s_list, s_wcnt, slots,
                                       C, L);

  const int c0 = g * NC;
  const auto none = [](int, unsigned) {};
  for (int base = 0; base < n; base += NGROUP) {  // block-uniform
    const int k = base + grp;
    const bool have = k < n;
    const int slot = have ? s_list[k] : 0;
    const int r = slot / C;
    const int len = have ? s_len[r] : 0;
    unsigned P[strip_words(NC)];
    int D[NC], T[NC];
    if (have)
      strip_init<NC>(D, T, P, genome, Gn, window_start(cg[slot], slack), c0,
                     W, open_q);
    // byte offset in smem of the emission row of this lane's DP row
    unsigned rowbase = (unsigned)(r * S) * 4u;
    const auto emit = [&rowbase](unsigned word, int kk) {
      return *reinterpret_cast<const int32_t*>(
          smem + __dp4a(word, 1u << (8 * kk), rowbase));
    };
    const int steps = __reduce_max_sync(FULL, len) + G - 1;  // warp-uniform
    int pd = 0, pq = NEG_INF;  // handed to lane g + 1 at the next step
    int d0 = 0;                // lane 0: max(M, Ix) of column 0, row above
    for (int s = 1; s <= steps; ++s) {
      const int in_d = __shfl_up_sync(FULL, pd, 1, G);
      const int in_q = __shfl_up_sync(FULL, pq, 1, G);
      const int row = s - g;
      if (row >= 1 && row <= len) {
        int d = g ? in_d : d0;
        int q = g ? in_q : NEG_INF;
        strip_row<NC, false, false>(D, T, P, d, q, emit, open_q, ext_q, 0, 0,
                                    none);
        pd = d;
        pq = q;
        d0 = max(row == 1 ? -open_q : d0 - ext_q, NEG_INF);
        rowbase += ECODES * 4;
      }
    }
    // every lane's state is its row len; d0 is column 0's Ix there
    const int best = group_best<NC>(D, c0, have ? W : 0);
    if (have && g == 0) og[slot] = max(best, d0);
  }
}

template <int NC>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int8_t* genome, long long Gn,
                   int32_t* out, int B2, int C, int L, int W, int slack,
                   int open_q, int ext_q, int R, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nw_full_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  nw_full_kernel<NC><<<(B2 + R - 1) / R, NT, smem, stream>>>(
      emis_t, cands, lens, genome, Gn, out, B2, C, L, W, slack, open_q, ext_q,
      R);
  return cudaGetLastError();
}

template <int NC>
int resident_blocks(size_t smem) {
  int n = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(nw_full_kernel<NC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -3;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, nw_full_kernel<NC>, NT, smem) != cudaSuccess)
    return -3;
  return n;
}

}  // namespace

// Blocks of NT threads the runtime keeps resident on one multiprocessor for
// this window width and shape (-1 unsupported width, -2 bad sizes).
extern "C" int nw_full_resident_blocks(int W, int C, int L) {
  int R;
  size_t smem;
  if (W <= 0 || !block_shape(C, L, SOFT_SMEM, &R, &smem)) return -2;
  switch (strip_cols(W)) {
#define NW_FULL_CASE(N) \
  case N:               \
    return resident_blocks<N>(smem);
    NW_STRIP_WIDTHS(NW_FULL_CASE)
#undef NW_FULL_CASE
    default:
      return -1;
  }
}

extern "C" int nw_full_launch(const void* emis_t, const void* cands,
                              const void* lens, const void* genome,
                              long long Gn, void* out, int B2, int C, int L,
                              int W, int slack, int open_q, int ext_q,
                              void* stream) {
  if (B2 <= 0 || C <= 0) return 0;
  int R;
  size_t smem;
  if (W <= 0 || open_q < 0 || ext_q < 0 ||
      !block_shape(C, L, SOFT_SMEM, &R, &smem))
    return -2;
  const auto* e = static_cast<const int32_t*>(emis_t);
  const auto* cd = static_cast<const int32_t*>(cands);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* gn = static_cast<const int8_t*>(genome);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (strip_cols(W)) {
#define NW_FULL_CASE(N)                                                     \
  case N:                                                                   \
    return (int)launch<N>(e, cd, ln, gn, Gn, o, B2, C, L, W, slack, open_q, \
                          ext_q, R, smem, s);
    NW_STRIP_WIDTHS(NW_FULL_CASE)
#undef NW_FULL_CASE
    default:
      return -1;
  }
}
