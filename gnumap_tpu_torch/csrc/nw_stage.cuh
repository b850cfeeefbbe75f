// What a block does before its DP, shared by the scoring kernels that walk
// live pairs (nw_band.cu banded, nw_full.cu unbanded) and, for the tables,
// by the traceback kernel (nw_tb.cu):
//   * stage_tables: emission tables from device memory, code-major [5][L],
//     into shared memory as L rows of ECODES int32 (codes 0..4, then DEEP for
//     the poison code 5), so that a cell's emission is one shared load at
//     the row's byte offset plus the cell's code byte (4 x code);
//   * compact_live: the live (row, c) slots of a block's R x C slots as a
//     list in shared memory, in slot order, with warp ballots and a scan over
//     the warps' counts; dead slots get their value at once.  A warp's lanes
//     then hold neighbouring pairs of the list, whatever the SENTINEL
//     placement;
//   * block_shape: how many read-strand rows a block takes, so that their
//     tables and the list fit the shared memory it may ask for.

#pragma once

#include "nw_band_row.cuh"

namespace {

// int32 stride between two reads' emission tables: L rows of ECODES, padded
// to 4 mod 32 so that neighbouring tables start 4 banks apart.
__host__ __device__ inline int table_stride(int L) {
  const int s = L * ECODES;
  return s + (36 - s % 32) % 32;
}

constexpr int MAX_ROWS = 16;  // read-strand rows per block
// The card's limit of shared memory for one block.
constexpr size_t HARD_SMEM = 227 * 1024;

// Shared memory of a block of R rows x C slots: the tables, the rows'
// lengths and the list of 16-bit slot numbers.
inline size_t stage_bytes(int R, int C, int L) {
  return (size_t)R * table_stride(L) * 4 + (size_t)R * 4 + (size_t)R * C * 2;
}

// Rows per block and its shared memory: the list holds 16-bit slot numbers,
// and the rows are halved while the block would need more than `soft` bytes
// (so that several blocks stay resident).  False when even one row does not
// fit the card's limit.
inline bool block_shape(int C, int L, size_t soft, int* R, size_t* smem) {
  if (L <= 0 || C <= 0 || C > 65535) return false;
  *R = MAX_ROWS;
  while (*R > 1 && (*R * C > 65535 || stage_bytes(*R, C, L) > soft))
    *R >>= 1;
  *smem = stage_bytes(*R, C, L);
  return *smem <= HARD_SMEM;
}

// nrows tables, global code-major [nrows][5][L] -> s_emis[r * S + i * ECODES
// + v], by NT threads (tid = 0 .. NT - 1).  The caller synchronises.
template <int NT>
__device__ __forceinline__ void stage_tables(int32_t* s_emis,
                                             const int32_t* __restrict__ eg,
                                             int nrows, int L, int S,
                                             int tid) {
  for (int k = tid; k < nrows * 5 * L; k += NT) {
    const int r = k / (5 * L), rem = k - r * 5 * L;
    const int v = rem / L, i = rem - v * L;
    s_emis[r * S + i * ECODES + v] = eg[k];
  }
  for (int k = tid; k < nrows * L; k += NT) {
    const int r = k / L, i = k - r * L;
    s_emis[r * S + i * ECODES + 5] = DEEP;
  }
}

// Compacts the live slots of cg[0 .. slots) into s_list, in slot order, and
// returns their number (the same in every thread).  A slot is live when its
// candidate is not SENTINEL and its row's length is in [1, L]; a dead slot
// gets NEG_INF in og, or 0 where ZERO_AT_0 and the candidate is valid and
// the length 0 (row 0 of the unbanded DP: M = 0 on every column).  Every
// thread of the block of NT calls it; s_wcnt holds NT / 32 ints.
template <int NT, bool ZERO_AT_0>
__device__ __forceinline__ int compact_live(const int32_t* __restrict__ cg,
                                            int32_t* __restrict__ og,
                                            const int* s_len,
                                            unsigned short* s_list,
                                            int* s_wcnt, int slots, int C,
                                            int L) {
  constexpr int NWARP = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n = 0;
  for (int base = 0; base < slots; base += NT) {
    const int slot = base + tid;
    bool live = false;
    if (slot < slots) {
      const int len = s_len[slot / C];
      const bool valid = cg[slot] != SENTINEL;
      live = valid && len > 0 && len <= L;
      if (!live) og[slot] = (ZERO_AT_0 && valid && len == 0) ? 0 : NEG_INF;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = n;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const int cnt = s_wcnt[w];
      if (w < warp) before += cnt;
      n += cnt;
    }
    if (live)
      s_list[before + __popc(bal & ((1u << lane) - 1u))] =
          (unsigned short)slot;
    __syncthreads();
  }
  return n;
}

}  // namespace
