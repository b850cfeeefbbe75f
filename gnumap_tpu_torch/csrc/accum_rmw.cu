// Ordered span read-modify-write into device-resident f32 accumulators, on
// Hopper (sm_90a):
//
//   for h in [0, n_real), in order:  arr[rowmul u(h) : + nrows] += delta[h]
//
// with arr f32[R, 128] (coverage: position p at flat index p, rowmul 1;
// tallies: (p, base b) at flat 4p + b, rowmul 4), u(h) = base_units[h], a
// 128-position span start, and delta f32[H, nrows, 128].  Each accumulator
// element receives arr + d_h1 + d_h2 + ... in ascending h: the same f32 bits
// as the serial loop.  One launch serves one accumulator or two that share
// base_units and n_real (coverage and tallies of one batch): the jobs.
//
// Replaces gnumap_tpu/posterior/accum_pallas.py::_rmw_kernel (launched there
// by apply_deltas / _apply_deltas_seg).  It does not copy the TPU
// workarounds: the 16384-hit SEG chaining, the ch-hit tiles, the SMEM base
// table and the DMA round trip per hit.  It uses no float atomics (their
// order, like index_add_'s on a card, changes from run to run).
//
// What bounds it: bytes.  The first n_real delta windows are read once
// (nrows x 128 f32 each, and their span starts), and every accumulator row
// that a window touches is read once and written once:
//   bound = (n_real x nrows x 512 + 4 n_real + 2 x touched rows x 512)
//           / 3.35 TB/s
// for each job (the n_real x nrows x 128 float adds over 67 TFLOP/s are far
// below that).  At the map path's sizes that is under 0.01 ms, the size of a
// launch itself, so what the design must not do is add to the launch:
//
// Design:
//   * One cooperative launch of a fixed grid (the blocks the card keeps
//     resident, fewer when the slots need fewer), sized by the card and not
//     by the slot capacity H: n_real stays on the device, every block
//     reads it and strides over the work that exists.  With n_real = 0 the
//     kernel costs its launch and one grid barrier.
//   * Phase 1, the order check: the grid's threads stride over h < n_real and
//     flag base_units[h] < base_units[h - 1]; a grid barrier; every block
//     reads the flag.  A barrier, not a check by each block of the range it
//     needs: the owner rule below is sound only if the whole of [0, n_real)
//     is in order (with starts 5, 0, 5 the first and the last delta would
//     both own row 5), so the decision is global.  The flag lives in a
//     two-int scratch that alternates between launches of one stream: a
//     launch uses one slot and clears the other, so nothing but the kernel
//     ever writes it and no second barrier is needed.
//   * Phase 2, in order: a work item is one 128-float row of one delta
//     (n_real x nrows items a job, the jobs' items one after the other), a
//     warp an item, a lane one float4: 16-byte loads and stores, 512
//     contiguous bytes a warp.  Rows are whole: spans start at multiples of
//     128 floats, so ownership is a row's.  Item (h, r) on accumulator row a
//     = rowmul u(h) + r owns it iff delta h - 1 does not cover a; with
//     equal-length spans in non-decreasing order the deltas covering a row
//     are a run of consecutive h.  The owner reads the row once, adds the
//     run's rows in ascending h, and writes it once; the other items leave.
//     The span starts of deltas h - 1, h, ... are read 32 at a time (a lane
//     each, one ballot finds the run's end), so that the delta loads of a
//     pileup do not each wait for a span start; the item's own delta row is
//     loaded before the span starts arrive (its place does not depend on
//     them), so an item waits two memory latencies, not three.  Rows past
//     the accumulator's end are skipped.
//   * Any other order: accumulator row a belongs to warp a mod (the grid's
//     warps); every warp walks all of base_units, 32 deltas at a time, and
//     adds the delta rows that fall on its own accumulator rows, in ascending
//     h.  A row is only ever touched by one warp, in program order, so the
//     serial bits need no barrier; the price is that every warp reads every
//     span start (from the L2 cache).
//
// C interface (ctypes): accum_rmw_launch(...) returns cudaGetLastError()
// after the launch, -2 for bad sizes.  It launches on the given stream, does
// not synchronise and allocates nothing.  accum_rmw_resident_blocks():
// blocks of THREADS the runtime keeps resident on one multiprocessor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_JOBS = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long FAR = 0x7fffffffffffffffLL;  // no delta there

struct Job {
  float* arr;           // f32[R, 128]
  const float* deltas;  // f32[H, nrows, 128]
  long long R;
  int nrows, rowmul;
};

struct Jobs {
  Job job[MAX_JOBS];
  int n;
};

__global__ void __launch_bounds__(THREADS)
rmw(Jobs jobs, const int32_t* __restrict__ base,
    const int32_t* __restrict__ n_real, int H, int* flags, int slot) {
  cg::grid_group grid = cg::this_grid();
  const int n = max(0, min(*n_real, H));
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid == 0) flags[slot ^ 1] = 0;  // the next launch's
  bool bad = false;
  for (long long h = (long long)blockIdx.x * THREADS + tid + 1; h < n;
       h += (long long)gridDim.x * THREADS)
    bad |= base[h] < base[h - 1];
  if (bad) atomicOr(flags + slot, 1);
  grid.sync();
  const int lane = tid & 31;
  if (*reinterpret_cast<volatile int*>(flags + slot)) {
    // any order: accumulator row a belongs to warp a mod (warps of the
    // grid).  Every warp walks all of base_units, 32 deltas at a time, and
    // adds the rows that are its own, in ascending h.
    const int TW = gridDim.x * WARPS;
    const int w = blockIdx.x * WARPS + (tid >> 5);
    for (int jb = 0; jb < jobs.n; ++jb) {
      const Job J = jb ? jobs.job[1] : jobs.job[0];
      float4* rows = reinterpret_cast<float4*>(J.arr) + lane;
      const float4* dl = reinterpret_cast<const float4*>(J.deltas) + lane;
      for (int h0 = 0; h0 < n; h0 += 32) {
        const int gi = h0 + lane;
        const long long a0 = gi < n ? (long long)base[gi] * J.rowmul : 0;
        // the first row of delta gi that is this warp's: r0 = w - a0 mod TW
        int r0 = w - (int)(((a0 % TW) + TW) % TW);
        if (r0 < 0) r0 += TW;
        unsigned m = __ballot_sync(FULL, gi < n && r0 < J.nrows);
        while (m) {
          const int t = __ffs(m) - 1;
          m &= m - 1;
          const long long at = __shfl_sync(FULL, a0, t);
          for (int r = __shfl_sync(FULL, r0, t); r < J.nrows; r += TW) {
            const long long a = at + r;
            if (a < 0 || a >= J.R) continue;
            const float4 d =
                __ldg(dl + ((long long)(h0 + t) * J.nrows + r) * 32);
            float4 acc = rows[a * 32];
            acc.x += d.x;
            acc.y += d.y;
            acc.z += d.z;
            acc.w += d.w;
            rows[a * 32] = acc;
          }
        }
      }
    }
    return;
  }
  const long long items0 = (long long)n * jobs.job[0].nrows;
  const long long items =
      items0 + (jobs.n > 1 ? (long long)n * jobs.job[1].nrows : 0);
  for (long long it = (long long)blockIdx.x * WARPS + (tid >> 5); it < items;
       it += (long long)gridDim.x * WARPS) {
    const bool second = it >= items0;
    const Job J = second ? jobs.job[1] : jobs.job[0];
    const long long x = second ? it - items0 : it;
    const int h = (int)(x / J.nrows), r = (int)(x % J.nrows);
    const float4* dl = reinterpret_cast<const float4*>(J.deltas) + lane;
    // this delta's own row lies on the item's accumulator row whatever the
    // span starts are: load it while they arrive
    const float4 own = __ldg(dl + ((long long)h * J.nrows + r) * 32);
    // span starts (as accumulator rows) of deltas h - 1 + lane
    int gs = h - 1, skip = 1;
    int gi = gs + lane;
    long long bg = gi >= 0 && gi < n ? (long long)base[gi] * J.rowmul : FAR;
    const long long a = __shfl_sync(FULL, bg, 1) + r;  // accumulator row
    if (a < 0 || a >= J.R) continue;
    // owner iff delta h - 1 (start <= this one's) ends at or before row a
    if (h > 0 && __shfl_sync(FULL, bg, 0) + J.nrows > a) continue;
    float4* row = reinterpret_cast<float4*>(J.arr) + a * 32 + lane;
    float4 acc = *row;
    acc.x += own.x;
    acc.y += own.y;
    acc.z += own.z;
    acc.w += own.w;
    ++skip;  // delta h is in
    for (;;) {
      // the run's part among these 32 deltas, after the first `skip`
      const unsigned m = __ballot_sync(FULL, bg <= a) >> skip;
      const int cnt = m == FULL ? 32 : min(__ffs(~m) - 1, 32 - skip);
      const int off = (int)(a - bg);  // the row of delta gi that lies on a
#pragma unroll 8
      for (int t = 0; t < cnt; ++t) {
        const int o = __shfl_sync(FULL, off, t + skip);
        const float4 d =
            __ldg(dl + ((long long)(gs + skip + t) * J.nrows + o) * 32);
        acc.x += d.x;
        acc.y += d.y;
        acc.z += d.z;
        acc.w += d.w;
      }
      if (cnt < 32 - skip) break;
      gs += 32;
      skip = 0;
      gi = gs + lane;
      bg = gi < n ? (long long)base[gi] * J.rowmul : FAR;
    }
    *row = acc;
  }
}

int resident_blocks() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rmw, THREADS, 0) !=
      cudaSuccess)
    return -3;
  return n;
}

}  // namespace

extern "C" int accum_rmw_resident_blocks() { return resident_blocks(); }

// njobs = 1 or 2 accumulators; the second job's arguments are ignored when
// njobs is 1.  flags: int32[2], zero before the stream's first launch; slot:
// 0 and 1 in turns, launch by launch on that stream.
extern "C" int accum_rmw_launch(int njobs, void* arr0, long long R0,
                                const void* deltas0, int nrows0, int rowmul0,
                                void* arr1, long long R1, const void* deltas1,
                                int nrows1, int rowmul1, const void* base,
                                const void* n_real, int H, void* flags,
                                int slot, void* stream) {
  if (H <= 0) return 0;
  if (njobs < 1 || njobs > MAX_JOBS || (slot != 0 && slot != 1)) return -2;
  Jobs jobs;
  jobs.n = njobs;
  jobs.job[0] = Job{static_cast<float*>(arr0),
                    static_cast<const float*>(deltas0), R0, nrows0, rowmul0};
  jobs.job[1] = njobs > 1 ? Job{static_cast<float*>(arr1),
                                static_cast<const float*>(deltas1), R1,
                                nrows1, rowmul1}
                          : jobs.job[0];
  long long rows = 0;
  for (int j = 0; j < njobs; ++j) {
    const Job& J = jobs.job[j];
    if (J.R <= 0 || J.nrows <= 0 || J.rowmul <= 0) return -2;
    rows += (long long)H * J.nrows;
  }
  // the grid that fits the card, asked once a device
  static int fit_dev = -1;
  static long long fit = 0;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev != fit_dev) {
    int sms = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    const int per_sm = resident_blocks();
    if (per_sm <= 0) return -3;
    fit = (long long)sms * per_sm;
    fit_dev = dev;
  }
  const long long want = (rows + WARPS - 1) / WARPS;
  int grid = (int)(want < fit ? want : fit);
  if (grid < 1) grid = 1;
  const auto* b = static_cast<const int32_t*>(base);
  const auto* n = static_cast<const int32_t*>(n_real);
  auto* f = static_cast<int*>(flags);
  void* args[] = {&jobs, &b, &n, &H, &f, &slot};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rmw), dim3(grid),
                                   dim3(THREADS), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
