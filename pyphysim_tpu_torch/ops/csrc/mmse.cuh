// The per-resource-element MMSE arithmetic that mimo_mmse.cu and
// sc_mmse_eq.cu share: complex float32 operations each rounded on its own
// (no multiply-add contraction), the Gram A = H^H H + s2 I, its LDL^H
// factors without square roots, the two triangular solves, and the QAM
// slicer with its bit-error count and a block's sum of them. The plain
// PyTorch versions (ops/mimo_detect.py _gram, _ldl, _solve,
// _slice_errors) run the same operations in the same order, so kernel and
// plain version agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mmse {

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

// A = H^H H + s2 I: its diagonal Ad (real) and its upper triangle Au; with
// RHS also b = H^H y beside the diagonal, from the same loads; each sum
// taken over r in order
template <int NR, int NT, bool RHS>
__device__ __forceinline__ void gram(const float2 (&H)[NR][NT],
                                     const float2* Y, float s2,
                                     float (&Ad)[NT], float2 (&Au)[NT][NT],
                                     float2* b) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float d = abs2(H[0][i]);
    float2 v;
    if constexpr (RHS) v = cmulc(H[0][i], Y[0]);
#pragma unroll
    for (int r = 1; r < NR; ++r) {
      d = add(d, abs2(H[r][i]));
      if constexpr (RHS) v = cadd(v, cmulc(H[r][i], Y[r]));
    }
    Ad[i] = add(d, s2);
    if constexpr (RHS) b[i] = v;
#pragma unroll
    for (int j = i + 1; j < NT; ++j) {
      float2 u = cmulc(H[0][i], H[0][j]);
#pragma unroll
      for (int r = 1; r < NR; ++r) u = cadd(u, cmulc(H[r][i], H[r][j]));
      Au[i][j] = u;
    }
  }
}

// A = L D L^H, L unit lower: L[i][j] (i > j) from A[i][j] = conj(A[j][i]);
// inv = 1 / D
template <int NT>
__device__ __forceinline__ void ldl(const float (&Ad)[NT],
                                    const float2 (&Au)[NT][NT],
                                    float (&inv)[NT], float2 (&L)[NT][NT]) {
  float D[NT];
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
}

// x = A^-1 b: L z = b, then L^H x = z / D
template <int NT>
__device__ __forceinline__ void solve(const float2 (&L)[NT][NT],
                                      const float (&inv)[NT],
                                      const float2 (&b)[NT], float2 (&x)[NT]) {
  float2 z[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float2 v = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v = csub(v, cmul(L[i][k], z[k]));
    z[i] = v;
  }
#pragma unroll
  for (int i = NT - 1; i >= 0; --i) {
    float2 v = cscale(z[i], inv[i]);
#pragma unroll
    for (int k = i + 1; k < NT; ++k) v = csub(v, cmulc(L[k][i], x[k]));
    x[i] = v;
  }
}

// QAM.demodulate_hard's slicer: square Gray-mapped M-QAM of unit energy
struct Slicer {
  int lq;        // points a real axis: sqrt(M); 0 for an M it cannot take
  int half;      // bits a real axis
  float scale;   // sqrt(2 (M - 1) / 3): the unit-energy grid's spacing / 2
};

// M a square QAM order from 4 to 256
inline Slicer make_slicer(int M) {
  int half = 0;
  while ((1 << (2 * half)) < M) ++half;
  if ((1 << (2 * half)) != M || half < 1 || half > 4) return Slicer{0, 0, 0.f};
  return Slicer{1 << half, half, sqrtf((float)(M - 1) * 2.f / 3.f)};
}

__device__ __forceinline__ int inv_gray(int p) {
  return p ^ (p >> 1) ^ (p >> 2) ^ (p >> 3) ^ (p >> 4) ^ (p >> 5) ^ (p >> 6) ^
         (p >> 7);
}

// one axis: round((v * scale + (lq - 1)) / 2), clamped, each step rounded
// as torch rounds it (round half to even)
__device__ __forceinline__ int level(float v, const Slicer& q) {
  const float t = mul(add(mul(v, q.scale), (float)(q.lq - 1)), 0.5f);
  return (int)fminf(fmaxf(rintf(t), 0.f), (float)(q.lq - 1));
}

// the bits in which the decision on (re, im) differs from the sent index:
// the real part rises with the column, the imaginary part falls with the
// row, so ((lq - 1) - im * scale) / 2 is -im's level
__device__ __forceinline__ unsigned int bit_errors(float re, float im,
                                                   long long sent,
                                                   const Slicer& q) {
  const long long got =
      (long long)((inv_gray(level(-im, q)) << q.half) | inv_gray(level(re, q)));
  return (unsigned int)__popcll((unsigned long long)(got ^ sent));
}

// the block's errors summed (shuffles, then one warp) and added to *count
// with one 64-bit atomic (integers: the order does not change the sum)
template <int THREADS>
__device__ __forceinline__ void add_block_errors(unsigned int errors,
                                                 unsigned long long* count) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) errors += __shfl_down_sync(~0u, errors, o);
  __shared__ unsigned int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = errors;
  __syncthreads();
  if (warp == 0) {
    unsigned int v = lane < THREADS / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(~0u, v, o);
    if (lane == 0 && v) atomicAdd(count, (unsigned long long)v);
  }
}

}  // namespace mmse
