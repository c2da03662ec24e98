// Per-resource-element linear MMSE detection of spatially multiplexed QAM,
// with the hard decision and the bit-error count fused, for Hopper (sm_90a).
//
// No TPU kernel has this counterpart: the JAX package's Blast filter is a
// batched jnp.linalg.solve. Its port, torch.linalg.solve, runs as
// cuSOLVER / cuBLAS batched LU and reads its error info back on the host,
// which a CUDA graph capture refuses. Per resource element (RE) s of
// attempt a, with H (Nr x Nt), y (Nr) and the sent indices (Nt):
//   A = H^H H + s2 I,  b = H^H y,  x = A^-1 b  (LDL^H, no square root),
//   decided = slicer(gain * x),  errors += popcount(decided ^ sent),
// Blast's MMSE filter (H^H H + s2 I)^-1 H^H times its gain sqrt(Nt), and
// QAM.demodulate_hard's slicer (round half to even, clamped to the grid,
// Gray index). The plain PyTorch version, ops/mimo_detect.py
// mimo_mmse_reference, runs the same float32 operations in the same order,
// each rounded on its own, so the two give the same counts bit for bit.
//
// What bounds it on the card: bytes. At 4 x 4 one RE reads H (128 B), y
// (32 B) and the indices (32 B, int64) and needs ~600 float32 operations
// (the Gram, H^H y, the solve, the decision): 192 B against 600 FLOP, ~3
// FLOP a byte, under the card's 20. The layout is planar, the RE index
// innermost: H (n, Nr, Nt, S), y (n, Nr, S), sent (n, Nt, S), so a thread
// an RE reads each of its Nr * Nt + Nr + Nt words with the warp's loads
// contiguous, and issues them all before it computes. A block sums its
// errors (shuffles, then one warp) and adds them to its attempt's count
// with one 64-bit atomic; counts must be zeroed before the launch. The
// noise variance s2 is read on the device, so a captured graph takes a new
// SNR by a write to that scalar.
#include <cuda_runtime.h>

#include "mmse.cuh"

namespace {

using namespace mmse;

constexpr int kThreads = 256;

template <int NR, int NT>
__global__ void __launch_bounds__(kThreads)
    mimo_mmse_kernel(const float2* __restrict__ h,
                     const float2* __restrict__ y,
                     const long long* __restrict__ sent,
                     const float* __restrict__ noise_var,
                     unsigned long long* __restrict__ counts, long long S,
                     Slicer q, float gain) {
  const long long a = blockIdx.y;
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned int errors = 0;
  if (s < S) {
    float2 H[NR][NT], Y[NR];
    long long tx[NT];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int t = 0; t < NT; ++t) H[r][t] = h[((a * NR + r) * NT + t) * S + s];
      Y[r] = y[(a * NR + r) * S + s];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) tx[t] = sent[(a * NT + t) * S + s];
    const float s2 = *noise_var;

    // A = H^H H + s2 I = L D L^H and b = H^H y (mmse.cuh), x = A^-1 b
    float Ad[NT], inv[NT];
    float2 Au[NT][NT], L[NT][NT], b[NT], x[NT];
    gram<NR, NT, true>(H, Y, s2, Ad, Au, b);
    ldl<NT>(Ad, Au, inv, L);
    solve<NT>(L, inv, b, x);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      errors += bit_errors(mul(x[t].x, gain), mul(x[t].y, gain), tx[t], q);
    }
  }
  add_block_errors<kThreads>(errors, counts + a);
}

template <int NR, int NT>
int launch(const void* h, const void* y, const void* sent,
           const void* noise_var, void* counts, int n, long long S,
           const Slicer& q, float gain, cudaStream_t stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)n);
  mimo_mmse_kernel<NR, NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(y),
      static_cast<const long long*>(sent),
      static_cast<const float*>(noise_var),
      static_cast<unsigned long long*>(counts), S, q, gain);
  return (int)cudaGetLastError();
}

}  // namespace

// counts (n,) int64, zeroed by the caller, gains each attempt's bit errors
// over its S resource elements; (nr, nt) one of (4, 4), (2, 2), (4, 2) and
// (2, 3), the instances built; M a square QAM order up to 256, n up to
// 65,535 attempts. Returns cudaGetLastError() after the launch;
// synchronises and allocates nothing.
extern "C" int mimo_mmse(const void* h, const void* y, const void* sent,
                         const void* noise_var, void* counts, int n,
                         long long S, int nr, int nt, int M, float gain,
                         void* stream) {
  const Slicer q = make_slicer(M);
  if (n < 1 || n > 65535 || S < 1 || q.lq == 0 ||
      (S + kThreads - 1) / kThreads > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr * 8 + nt) {
    case 4 * 8 + 4:
      return launch<4, 4>(h, y, sent, noise_var, counts, n, S, q, gain, st);
    case 2 * 8 + 2:
      return launch<2, 2>(h, y, sent, noise_var, counts, n, S, q, gain, st);
    case 4 * 8 + 2:
      return launch<4, 2>(h, y, sent, noise_var, counts, n, S, q, gain, st);
    case 2 * 8 + 3:
      return launch<2, 3>(h, y, sent, noise_var, counts, n, S, q, gain, st);
  }
  return (int)cudaErrorInvalidValue;
}
