// Ordered span read-modify-write into a device-resident f32 accumulator, on
// Hopper (sm_90a):
//
//   for h in [0, n_real), in order:  arr[rowmul u(h) : + nrows] += delta[h]
//
// with arr f32[R, 128] (coverage: position p at flat index p, rowmul 1;
// tallies: (p, base b) at flat 4p + b, rowmul 4), u(h) = base_units[h], a
// 128-position span start, and delta f32[H, nrows, 128].  Each accumulator
// element receives arr + d_h1 + d_h2 + ... in ascending h: the same f32 bits
// as the serial loop.
//
// Replaces gnumap_tpu/posterior/accum_pallas.py::_rmw_kernel (launched there
// by apply_deltas / _apply_deltas_seg).  It does not copy the TPU
// workarounds: the 16384-hit SEG chaining, the ch-hit tiles, the SMEM base
// table and the DMA round trip per hit.  It uses no float atomics (their
// order, like index_add_'s on a card, changes from run to run).
//
// Design (simple first):
//   * order_check: one thread per h flags base_units[h] < base_units[h - 1]
//     for h < n_real (an int atomicOr on a flag the wrapper zeroes).
//   * rmw: when the spans are in non-decreasing order (the flag is clear),
//     one thread per (delta h, element k of its span).  With equal-length
//     spans in non-decreasing order, the deltas covering an element form a
//     run of consecutive h; the thread owns its element iff delta h - 1
//     does not cover it, reads it once, adds d_h, d_h+1, ... while they
//     cover it, and writes it once.  Threads of non-owning pairs exit.
//   * Any other order: block 0 runs the serial loop itself, one delta at a
//     time, its threads splitting the span, a barrier between deltas.
//   * n_real stays on the device: both kernels read it, so the caller never
//     waits for the host.  Elements past the accumulator's end are skipped.
//
// What bounds it: bytes.  The first n_real delta windows are read once
// (nrows x 128 f32 each, and their span starts), and every accumulator row
// that a window touches is read once and written once:
//   bound = (n_real x nrows x 512 + 4 n_real + 2 x touched rows x 512)
//           / 3.35 TB/s
// (the n_real x nrows x 128 float adds over 67 TFLOP/s are far below that).
// An owner's loop runs over the deltas stacked on its element (a pileup),
// with independent loads.
//
// C interface (ctypes): accum_rmw_launch(...) returns cudaGetLastError()
// after the two launches, -2 for bad sizes.  It launches on the given
// stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void order_check(const int32_t* __restrict__ base,
                            const int32_t* __restrict__ n_real, int H,
                            int* __restrict__ unordered) {
  const int h = blockIdx.x * THREADS + threadIdx.x + 1;
  const int n = min(*n_real, H);
  if (h < n && base[h] < base[h - 1]) atomicOr(unordered, 1);
}

__global__ void __launch_bounds__(THREADS)
rmw(float* __restrict__ arr, long long total,
    const int32_t* __restrict__ base, const float* __restrict__ deltas,
    const int32_t* __restrict__ n_real, int H, int span, int unit,
    const int* __restrict__ unordered) {
  const int n = min(*n_real, H);
  if (*unordered) {  // serial in block 0, any order
    if (blockIdx.x != 0) return;
    for (int h = 0; h < n; ++h) {
      const long long b = (long long)base[h] * unit;
      const float* d = deltas + (long long)h * span;
      for (int k = threadIdx.x; k < span; k += THREADS)
        if (b + k >= 0 && b + k < total) arr[b + k] += d[k];
      __syncthreads();
    }
    return;
  }
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int h = (int)(t / span);
  if (h >= n) return;
  const int k = (int)(t % span);
  const long long e = (long long)base[h] * unit + k;
  if (e < 0 || e >= total) return;
  // owner iff delta h - 1 (start <= e) ends at or before e
  if (h > 0 && (long long)base[h - 1] * unit + span > e) return;
  float acc = arr[e];
  for (int g = h; g < n; ++g) {
    const long long bg = (long long)base[g] * unit;
    if (bg > e) break;
    acc += deltas[(long long)g * span + (e - bg)];
  }
  arr[e] = acc;
}

}  // namespace

extern "C" int accum_rmw_launch(void* arr, long long R, const void* base,
                                const void* deltas, const void* n_real, int H,
                                int nrows, int rowmul, void* unordered,
                                void* stream) {
  if (H <= 0) return 0;
  if (R <= 0 || nrows <= 0 || rowmul <= 0) return -2;
  const int span = nrows * 128;
  const long long threads = (long long)H * span;
  if ((threads + THREADS - 1) / THREADS > 0x7fffffffLL) return -2;
  auto* a = static_cast<float*>(arr);
  const auto* b = static_cast<const int32_t*>(base);
  const auto* d = static_cast<const float*>(deltas);
  const auto* n = static_cast<const int32_t*>(n_real);
  auto* flag = static_cast<int*>(unordered);
  auto s = static_cast<cudaStream_t>(stream);
  order_check<<<(H + THREADS - 1) / THREADS, THREADS, 0, s>>>(b, n, H, flag);
  rmw<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      a, R * 128, b, d, n, H, span, rowmul * 128, flag);
  return (int)cudaGetLastError();
}
