// Square Gray-mapped M-QAM indices to constellation points in one pass, for
// Hopper (sm_90a): qam_map_kernel.
//
// No TPU kernel has this counterpart: the JAX step maps inside its fused
// program. Op by op in torch (modulators/fundamental.py QAM.modulate) the
// map takes ~15 element-wise launches, most of them in int64, each reading
// and writing the whole tensor. The plain PyTorch version, ops/qam.py
// qam_map_reference, is that arithmetic; the kernel rounds every float32
// operation as torch rounds it, so the two agree bit for bit:
//
//   col = i & (L - 1), row = i >> half, gray(x) = x ^ (x >> 1), in int64;
//   re = float(2 gray(col) - (L - 1)) * inv_scale, im = float((L - 1) -
//   2 gray(row)) * inv_scale, inv_scale the float32 value of the host's
//   1 / sqrt(2 (M - 1) / 3), which torch passes to its multiply; with a
//   gain (the MIMO step's 1 / sqrt(Nt) split) each part is multiplied by
//   its float32 value after that, as torch's complex-by-real product rounds
//   it.
//
// What bounds it on the card: bytes. It reads an int64 index and writes a
// complex64 point (16 B). A thread an element, loads and stores of a warp
// contiguous. (The decision with its bit count is sc_mmse_eq.cu's
// sc_decide, with a unit gain.)
#include <cuda_runtime.h>

#include "mmse.cuh"

namespace {

using namespace mmse;

constexpr int kMapThreads = 256;

// SCALED: each part also multiplied by gain, after inv_scale
template <bool SCALED>
__global__ void __launch_bounds__(kMapThreads)
    qam_map_kernel(const long long* __restrict__ indices,
                   float2* __restrict__ points, long long n, long long lm1,
                   int half, float inv_scale, float gain) {
  const long long i = (long long)blockIdx.x * kMapThreads + threadIdx.x;
  if (i >= n) return;
  const long long v = indices[i];
  const long long col = v & lm1;
  const long long row = v >> half;
  const long long jj = col ^ (col >> 1);
  const long long ii = row ^ (row >> 1);
  float re = mul((float)(2 * jj - lm1), inv_scale);
  float im = mul((float)(lm1 - 2 * ii), inv_scale);
  if constexpr (SCALED) {
    re = mul(re, gain);
    im = mul(im, gain);
  }
  points[i] = make_float2(re, im);
}

}  // namespace

// indices (n,) int64 in; points (n,) complex64 out. M a square QAM order
// (4, 16, ..., 2**30); inv_scale the float32 value of 1 / sqrt(2 (M - 1) / 3);
// scaled != 0: each part also multiplied by gain. Returns cudaGetLastError()
// after the launch; synchronises and allocates nothing.
extern "C" int qam_map(const void* indices, void* points, long long n, int M,
                       float inv_scale, float gain, int scaled, void* stream) {
  int half = 0;
  while (half < 15 && (1 << (2 * half)) < M) ++half;
  if (n < 1 || half < 1 || (1 << (2 * half)) != M ||
      (n + kMapThreads - 1) / kMapThreads > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + kMapThreads - 1) / kMapThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* in = static_cast<const long long*>(indices);
  float2* out = static_cast<float2*>(points);
  const long long lm1 = (1LL << half) - 1;
  if (scaled) {
    qam_map_kernel<true><<<blocks, kMapThreads, 0, st>>>(in, out, n, lm1, half,
                                                         inv_scale, gain);
  } else {
    qam_map_kernel<false><<<blocks, kMapThreads, 0, st>>>(in, out, n, lm1,
                                                          half, inv_scale, gain);
  }
  return (int)cudaGetLastError();
}
