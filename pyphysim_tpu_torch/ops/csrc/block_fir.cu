// Block-static sparse-tap FIR, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/fir_pallas.py:block_fir (body
// _kernel). Row r of x (R, block_size) is convolved with its own sparse
// complex kernel taps[r, :] (R, T) at the static offsets d_0 < ... < d_{T-1}:
//   y[r, m] = sum_i taps[r, i] * x[r, m - d_i]  over 0 <= m - d_i < block_size,
// for m in [0, block_size + D - 1), D = d_{T-1} + 1. Complex64 throughout
// (interleaved float2), where the TPU kernel worked on f32 real pairs.
//
// What bounds it on the card: memory bytes. At the flagship geometry
// (block_size 564, T = 16, D = 44, R = 8192 rows) the kernel must read x
// (37 MB) and the taps (1 MB) and write y (40 MB): ~23 us at 3.35 TB/s,
// against ~9 us for its 0.59 GFLOP at the 67 TFLOP/s f32 rate. So the
// design moves each byte once and keeps the arithmetic out of the way:
//   * one block per row; the row's samples are staged once in shared
//     memory (564 x 8 B = 4.5 KB), the taps and offsets beside them, with
//     coalesced float2 loads;
//   * threads sweep the output samples, each summing at most T complex
//     products from shared memory with the bounds test 0 <= m - d_i <
//     block_size (the TPU kernel's zero padding is not needed);
//   * coalesced float2 stores, each output written once;
//   * a ragged row count needs no padding: the grid has one block per row.
// The offsets are a fixed-size struct passed by value (T <= 64), so a
// launch copies nothing from the host. This simple form reaches about a
// third of the byte bound on an H100 SXM (PERF.md): each block waits for
// its row's loads before it computes. Keeping the next rows' loads in
// flight while one row computes is the way to the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;
constexpr int kThreads = 128;
constexpr int kMaxBlockSize = 6144;  // 48 KB of float2 in shared memory

struct TapOffsets {
  int n;
  int d[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads)
    block_fir_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ taps, float2* __restrict__ y,
                     int block_size, int out_len, TapOffsets offs) {
  extern __shared__ float2 xs[];
  __shared__ float2 ts[kMaxTaps];
  __shared__ int ds[kMaxTaps];
  const long long row = blockIdx.x;
  const float2* xr = x + row * block_size;
  for (int j = threadIdx.x; j < block_size; j += kThreads) xs[j] = xr[j];
  if (threadIdx.x < offs.n) {
    ts[threadIdx.x] = taps[row * offs.n + threadIdx.x];
    ds[threadIdx.x] = offs.d[threadIdx.x];
  }
  __syncthreads();

  float2* yr = y + row * out_len;
  for (int m = threadIdx.x; m < out_len; m += kThreads) {
    float re = 0.f, im = 0.f;
    for (int i = 0; i < offs.n; ++i) {
      const int j = m - ds[i];
      if (j >= 0 && j < block_size) {
        const float2 h = ts[i];
        const float2 v = xs[j];
        re = fmaf(h.x, v.x, re);
        re = fmaf(-h.y, v.y, re);
        im = fmaf(h.x, v.y, im);
        im = fmaf(h.y, v.x, im);
      }
    }
    yr[m] = make_float2(re, im);
  }
}

}  // namespace

// x (rows, block_size), taps (rows, num_taps) and y (rows, block_size +
// offsets[num_taps - 1]) are contiguous complex64 on the device; offsets is
// a HOST array of num_taps increasing non-negative ints, copied into the
// launch's parameters before this returns.
extern "C" int block_fir(const void* x, const void* taps, void* y, int rows,
                         int block_size, int num_taps, const void* offsets,
                         void* stream) {
  if (num_taps < 1 || num_taps > kMaxTaps || block_size < 1 ||
      block_size > kMaxBlockSize || rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int* d = static_cast<const int*>(offsets);
  TapOffsets offs = {};
  offs.n = num_taps;
  for (int i = 0; i < num_taps; ++i) offs.d[i] = d[i];
  const int out_len = block_size + d[num_taps - 1];
  block_fir_kernel<<<rows, kThreads, block_size * sizeof(float2),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(taps),
      static_cast<float2*>(y), block_size, out_len, offs);
  return (int)cudaGetLastError();
}
