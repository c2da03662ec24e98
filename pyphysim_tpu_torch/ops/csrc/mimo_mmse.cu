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

namespace {

constexpr int kThreads = 256;

struct Slicer {
  int lq;        // points a real axis: sqrt(M)
  int half;      // bits a real axis
  float scale;   // sqrt(2 (M - 1) / 3): the unit-energy grid's spacing / 2
  float gain;    // Blast's receive gain, sqrt(Nt)
};

// Every operation rounded on its own (no multiply-add contraction), in
// the plain version's order, so the two decide alike bit for bit.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(sub(mul(a.x, b.x), mul(a.y, b.y)),
                     add(mul(a.x, b.y), mul(a.y, b.x)));
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(add(mul(a.x, b.x), mul(a.y, b.y)),
                     sub(mul(a.x, b.y), mul(a.y, b.x)));
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(add(mul(a.x, b.x), mul(a.y, b.y)),
                     sub(mul(a.y, b.x), mul(a.x, b.y)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(add(a.x, b.x), add(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(sub(a.x, b.x), sub(a.y, b.y));
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(mul(a.x, s), mul(a.y, s));
}

__device__ __forceinline__ float abs2(float2 a) {
  return add(mul(a.x, a.x), mul(a.y, a.y));
}

__device__ __forceinline__ int inv_gray(int p) {
  return p ^ (p >> 1) ^ (p >> 2) ^ (p >> 3) ^ (p >> 4) ^ (p >> 5) ^ (p >> 6) ^
         (p >> 7);
}

// QAM.demodulate_hard on one axis: round((v * scale + (lq - 1)) / 2),
// clamped, each step rounded as torch rounds it.
__device__ __forceinline__ int level(float v, const Slicer& q) {
  const float t = mul(add(mul(v, q.scale), (float)(q.lq - 1)), 0.5f);
  return (int)fminf(fmaxf(rintf(t), 0.f), (float)(q.lq - 1));
}

template <int NR, int NT>
__global__ void __launch_bounds__(kThreads)
    mimo_mmse_kernel(const float2* __restrict__ h,
                     const float2* __restrict__ y,
                     const long long* __restrict__ sent,
                     const float* __restrict__ noise_var,
                     unsigned long long* __restrict__ counts, long long S,
                     Slicer q) {
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

    // A's diagonal (real), its upper triangle, and b = H^H y, each sum
    // taken over r in order
    float Ad[NT];
    float2 Au[NT][NT], b[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      float d = abs2(H[0][i]);
      float2 v = cmulc(H[0][i], Y[0]);
#pragma unroll
      for (int r = 1; r < NR; ++r) {
        d = add(d, abs2(H[r][i]));
        v = cadd(v, cmulc(H[r][i], Y[r]));
      }
      Ad[i] = add(d, s2);
      b[i] = v;
#pragma unroll
      for (int j = i + 1; j < NT; ++j) {
        float2 u = cmulc(H[0][i], H[0][j]);
#pragma unroll
        for (int r = 1; r < NR; ++r) u = cadd(u, cmulc(H[r][i], H[r][j]));
        Au[i][j] = u;
      }
    }

    // A = L D L^H, L unit lower: L[i][j] (i > j) from A[i][j] = conj(A[j][i])
    float D[NT], inv[NT];
    float2 L[NT][NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d = Ad[j];
#pragma unroll
      for (int k = 0; k < j; ++k) d = sub(d, mul(abs2(L[j][k]), D[k]));
      D[j] = d;
      inv[j] = __frcp_rn(d);
#pragma unroll
      for (int i = j + 1; i < NT; ++i) {
        float2 v = make_float2(Au[j][i].x, -Au[j][i].y);
#pragma unroll
        for (int k = 0; k < j; ++k) {
          v = csub(v, cscale(cmul_conj(L[i][k], L[j][k]), D[k]));
        }
        L[i][j] = cscale(v, inv[j]);
      }
    }
    // L z = b, then L^H x = z / D
    float2 z[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      float2 v = b[i];
#pragma unroll
      for (int k = 0; k < i; ++k) v = csub(v, cmul(L[i][k], z[k]));
      z[i] = v;
    }
    float2 x[NT];
#pragma unroll
    for (int i = NT - 1; i >= 0; --i) {
      float2 v = cscale(z[i], inv[i]);
#pragma unroll
      for (int k = i + 1; k < NT; ++k) v = csub(v, cmulc(L[k][i], x[k]));
      x[i] = v;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      // the real part rises with the column, the imaginary part falls
      // with the row: ((lq - 1) - im * scale) / 2 is -im's level
      const int col = level(mul(x[t].x, q.gain), q);
      const int row = level(-mul(x[t].y, q.gain), q);
      const long long got =
          (long long)((inv_gray(row) << q.half) | inv_gray(col));
      errors += __popcll((unsigned long long)(got ^ tx[t]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) errors += __shfl_down_sync(~0u, errors, o);
  __shared__ unsigned int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = errors;
  __syncthreads();
  if (warp == 0) {
    unsigned int v = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(~0u, v, o);
    if (lane == 0 && v) atomicAdd(counts + a, (unsigned long long)v);
  }
}

template <int NR, int NT>
int launch(const void* h, const void* y, const void* sent,
           const void* noise_var, void* counts, int n, long long S,
           const Slicer& q, cudaStream_t stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads), (unsigned)n);
  mimo_mmse_kernel<NR, NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(y),
      static_cast<const long long*>(sent),
      static_cast<const float*>(noise_var),
      static_cast<unsigned long long*>(counts), S, q);
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
  int half = 0;
  while ((1 << (2 * half)) < M) ++half;
  if (n < 1 || n > 65535 || S < 1 || (1 << (2 * half)) != M || half > 4 ||
      half < 1 || (S + kThreads - 1) / kThreads > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const Slicer q{1 << half, half, sqrtf((float)(M - 1) * 2.f / 3.f), gain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr * 8 + nt) {
    case 4 * 8 + 4:
      return launch<4, 4>(h, y, sent, noise_var, counts, n, S, q, st);
    case 2 * 8 + 2:
      return launch<2, 2>(h, y, sent, noise_var, counts, n, S, q, st);
    case 4 * 8 + 2:
      return launch<4, 2>(h, y, sent, noise_var, counts, n, S, q, st);
    case 2 * 8 + 3:
      return launch<2, 3>(h, y, sent, noise_var, counts, n, S, q, st);
  }
  return (int)cudaErrorInvalidValue;
}
