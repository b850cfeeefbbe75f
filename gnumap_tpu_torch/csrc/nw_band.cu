// Banded affine-gap probabilistic Needleman-Wunsch scores ([FROZEN v4]) for
// every (read-strand, candidate) pair, on Hopper (sm_90a).
//
// Replaces gnumap_tpu/align/nw_pallas.py::_nw_band_kernel (launched there by
// nw_scores_banded).  It computes the same int32 scores; it does not copy the
// TPU layout (segment packing into 128 lanes, the rolled 4-bit window plane,
// SMEM meta, the unroll / peel / state-carry variants).
//
// What bounds it: the int32 instruction rate.  A live pair costs len rows
// of BW band cells, and a cell is 6 integer instructions and one shared load
// (counted in the SASS of the row loop: 4 VIADDMNMX, 1 VIMNMX3 and 1 IDP.4A
// that forms the emission's address, then LDS).  The bytes are nothing
// beside that: each emission table, candidate and score moves once.  So
//   bound = live pairs x len x BW x 6 / 16.7e12 int32 operations a second
// (64 lanes per multiprocessor per clock), or the bytes over 3.35 TB/s where
// that is larger.  Only live pairs count: SENTINEL slots and rows of length
// 0 or above L need no work.
//
// Design:
//   * Work follows live pairs, not slots.  A block takes R = 16 consecutive
//     read-strand rows (fewer when their tables do not fit), compacts the
//     live (row, c) slots of its R x C slots into a list in shared memory,
//     in slot order, with warp ballots and a scan over the warps' counts,
//     writes NEG_INF to the dead slots, and then its threads walk the list, a
//     pair per thread, in rounds of blockDim.  A warp's lanes hold
//     neighbouring pairs of the list, so they are all busy whatever the
//     SENTINEL placement, and mostly share a read.  No tensor beyond the
//     wrapper's, no second kernel, no host sync.  (Measured and not kept:
//     rotating the warp that starts the list with the block number, and
//     staging one (row, code) line per warp; both were slower on every set
//     with dead slots.)
//   * Lanes of a warp may hold reads of different length: each thread runs
//     its own len rows and latches its score at its own row len; the warp
//     reconverges after the row loop, so a round costs its longest read.
//   * The R rows' emission tables are staged in shared memory as rows of 6
//     int32 (codes 0..4, then DEEP for the poison code 5), row-major.  A
//     lane's emission is one shared load whose address one IDP.4A makes: the
//     lane's byte of P (4 x code) plus the row's byte offset.  Tables start
//     4 banks apart (the stride S is 4 mod 32), so lanes on different reads
//     that look up bases 0..3 hit different banks for up to 8 reads a warp;
//     lanes on the same read and code share one address.
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
//     They live one byte per lane in registers and slide one lane per row;
//     one new code is loaded per row, before the row's arithmetic.
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
//   * Registers: D, T and P are BW + BW + 1 + BW / 4 values; blocks of 128
//     threads, at least 4 a multiprocessor up to BW = 42 (128 registers a
//     thread) and 2 above (255).
//
// C interface (ctypes): nw_band_launch(...) returns cudaGetLastError() after
// the launch, -1 for an unsupported band width, -2 for bad sizes.  It launches
// on the given stream, does not synchronise and allocates nothing.

#include "nw_stage.cuh"

namespace {

constexpr int NT = 128;         // threads per block
constexpr int NWARP = NT / 32;
// Shared memory a block may ask for: above SOFT_SMEM the rows per block are
// halved (two blocks a multiprocessor stay resident).
constexpr size_t SOFT_SMEM = 112 * 1024;

template <int BW>
__global__ void __launch_bounds__(NT, BW <= 42 ? 4 : 2)
nw_band_kernel(const int32_t* __restrict__ emis_t,
               const int32_t* __restrict__ cands,
               const int32_t* __restrict__ lens,
               const int8_t* __restrict__ genome, long long G,
               int32_t* __restrict__ out, int B2, int C, int L, int W,
               int slack, int boff, int open_q, int ext_q, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wcnt[NWARP];
  const int S = table_stride(L);
  int32_t* s_emis = reinterpret_cast<int32_t*>(smem);         // R x S
  int* s_len = reinterpret_cast<int*>(s_emis + (size_t)R * S);  // R
  unsigned short* s_list =
      reinterpret_cast<unsigned short*>(s_len + R);           // R x C
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B2 - row0);
  const int slots = nrows * C;
  const int32_t* cg = cands + (size_t)row0 * C;
  int32_t* og = out + (size_t)row0 * C;

  // stage the rows' emission tables: global code-major [5][L] -> [L][6]
  if (tid < nrows) s_len[tid] = lens[row0 + tid];
  stage_tables<NT>(s_emis, emis_t + (size_t)row0 * 5 * L, nrows, L, S, tid);
  __syncthreads();

  // compact the live slots into s_list, in slot order; NEG_INF to the rest
  const int n = compact_live<NT, false>(cg, og, s_len, s_list, s_wcnt, slots,
                                        C, L);

  const auto none = [](int, int, int, int) {};
  for (int k = tid; k < n; k += NT) {
    const int slot = s_list[k];
    const int r = slot / C;
    const int len = s_len[r];
    const long long ws = window_start(cg[slot], slack);
    unsigned P[band_words(BW)];
    int D[BW], T[BW + 1];
    band_init<BW>(D, T, P, genome, G, ws, W, boff, open_q);
    // byte offset in smem of the emission row of DP row i (read base i - 1)
    unsigned rowbase = (unsigned)(r * S) * 4u;
    const auto emit = [&rowbase](unsigned word, int kk) {
      return *reinterpret_cast<const int32_t*>(
          smem + __dp4a(word, 1u << (8 * kk), rowbase));
    };
    for (int i = 1; i < len; ++i) {
      const unsigned top =
          code4_at(genome, G, ws, slide_index<BW>(i, boff), W);
      band_row<BW>(D, T, P, emit, open_q, ext_q, none);
      T[BW] = NEG_INF;  // out of band from row 1 on
      band_slide<BW>(P, top);
      rowbase += ECODES * 4;
    }
    // the score is latched at row len: max over lanes of max(M, Ix), and ix0
    int fin = NEG_INF;
    band_row<BW>(D, T, P, emit, open_q, ext_q,
                 [&fin](int, int, int mn, int ixn) {
                   fin = max3(fin, mn, ixn);
                 });
    const long long ix0 = -(long long)open_q - (long long)(len - 1) * ext_q;
    og[slot] = max(fin, (int)(ix0 > NEG_INF ? ix0 : NEG_INF));
  }
}

template <int BW>
cudaError_t launch(const int32_t* emis_t, const int32_t* cands,
                   const int32_t* lens, const int8_t* genome, long long G,
                   int32_t* out, int B2, int C, int L, int W, int slack,
                   int boff, int open_q, int ext_q, int R, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nw_band_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  nw_band_kernel<BW><<<(B2 + R - 1) / R, NT, smem, stream>>>(
      emis_t, cands, lens, genome, G, out, B2, C, L, W, slack, boff, open_q,
      ext_q, R);
  return cudaGetLastError();
}

template <int BW>
int resident_blocks(size_t smem) {
  int n = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(nw_band_kernel<BW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -3;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, nw_band_kernel<BW>, NT, smem) != cudaSuccess)
    return -3;
  return n;
}

}  // namespace

// bw = 4 * gap_slack + 10 for gap_slack 0..13 (MapperConfig.band)
#define NW_BAND_WIDTHS(X)                                                  \
  X(10) X(14) X(18) X(22) X(26) X(30) X(34) X(38) X(42) X(46) X(50) X(54) \
  X(58) X(62)

// Blocks of NT threads the runtime keeps resident on one multiprocessor for
// this band width and shape (-1 unsupported width, -2 bad sizes).
extern "C" int nw_band_resident_blocks(int bw, int C, int L) {
  int R;
  size_t smem;
  if (!block_shape(C, L, SOFT_SMEM, &R, &smem)) return -2;
  switch (bw) {
#define NW_BAND_CASE(N) \
  case N:               \
    return resident_blocks<N>(smem);
    NW_BAND_WIDTHS(NW_BAND_CASE)
#undef NW_BAND_CASE
    default:
      return -1;
  }
}

extern "C" int nw_band_launch(const void* emis_t, const void* cands,
                              const void* lens, const void* genome,
                              long long G, void* out, int B2, int C, int L,
                              int W, int slack, int boff, int bw, int open_q,
                              int ext_q, void* stream) {
  if (B2 <= 0 || C <= 0) return 0;
  int R;
  size_t smem;
  if (!block_shape(C, L, SOFT_SMEM, &R, &smem)) return -2;
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
                          open_q, ext_q, R, smem, s);
    NW_BAND_WIDTHS(NW_BAND_CASE)
#undef NW_BAND_CASE
    default:
      return -1;
  }
}
