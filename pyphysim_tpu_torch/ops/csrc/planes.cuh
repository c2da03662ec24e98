// Small complex matrix helpers of the port's Monte Carlo solvers, over
// fixed-size register arrays: the CUDA counterpart of ops/planes.py (and of
// pyphysim_tpu/ops/pallas_planes.py). Every size is a template parameter and
// every loop is unrolled, so a matrix lives in registers and each helper
// accumulates in the same order as the Python one.
#pragma once

#include <cuda_runtime.h>

namespace planes {

constexpr float kEps = 1e-30f;

struct cf {
  float re, im;
};

__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// a * conj(b)
__device__ __forceinline__ cf cmulc(cf a, cf b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}

__device__ __forceinline__ cf cadd(cf a, cf b) {
  return {a.re + b.re, a.im + b.im};
}

__device__ __forceinline__ cf csub(cf a, cf b) {
  return {a.re - b.re, a.im - b.im};
}

__device__ __forceinline__ cf cscale(cf a, float s) {
  return {a.re * s, a.im * s};
}

__device__ __forceinline__ cf cconj(cf a) { return {a.re, -a.im}; }

__device__ __forceinline__ float cabs2(cf a) {
  return a.re * a.re + a.im * a.im;
}

// Conjugate transpose.
template <int M, int N>
__device__ __forceinline__ void mat_H(const cf (&A)[M][N], cf (&out)[N][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j][i] = cconj(A[i][j]);
  }
}

// (M, K) x (K, N), summed over K in order.
template <int M, int K, int N>
__device__ __forceinline__ void mat_mul(const cf (&A)[M][K],
                                        const cf (&B)[K][N],
                                        cf (&out)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      cf acc = cmul(A[i][0], B[0][j]);
#pragma unroll
      for (int t = 1; t < K; ++t) acc = cadd(acc, cmul(A[i][t], B[t][j]));
      out[i][j] = acc;
    }
  }
}

template <int M, int N>
__device__ __forceinline__ void mat_sub(const cf (&A)[M][N],
                                        const cf (&B)[M][N],
                                        cf (&out)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[i][j] = csub(A[i][j], B[i][j]);
  }
}

// A A^H of a (2, N) matrix as the 2x2 Hermitian (p, q, r).
template <int N>
__device__ __forceinline__ void gram_rows(const cf (&A)[2][N], float& p,
                                          cf& q, float& r) {
  p = cabs2(A[0][0]);
  r = cabs2(A[1][0]);
  q = cmulc(A[0][0], A[1][0]);
#pragma unroll
  for (int j = 1; j < N; ++j) {
    p = p + cabs2(A[0][j]);
    r = r + cabs2(A[1][j]);
    q = cadd(q, cmulc(A[0][j], A[1][j]));
  }
}

// A A^H of an (M, N) matrix, both triangles (the lower one conjugated).
template <int M, int N>
__device__ __forceinline__ void gram_full(const cf (&A)[M][N],
                                          cf (&out)[M][M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i; j < M; ++j) {
      cf acc = cmulc(A[i][0], A[j][0]);
#pragma unroll
      for (int t = 1; t < N; ++t) acc = cadd(acc, cmulc(A[i][t], A[j][t]));
      out[i][j] = acc;
      if (i != j) out[j][i] = cconj(acc);
    }
  }
}

// X = B^-1 Mx for Hermitian positive-definite (N, N) B and (N, C) Mx, by a
// square-root-free LDL^H factorization: N reciprocals, the rest
// multiply-add. Pivots are floored at kEps only to keep the arithmetic
// finite; callers guard validity with scale-relative tests.
template <int N, int C>
__device__ __forceinline__ void herm_solve_cols_ldl(const cf (&B)[N][N],
                                                    const cf (&Mx)[N][C],
                                                    cf (&X)[N][C]) {
  cf L[N][N];
  float D[N], Dinv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float d = B[j][j].re;
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - cabs2(L[j][k]) * D[k];
    d = fmaxf(d, kEps);
    D[j] = d;
    Dinv[j] = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      cf acc = B[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        acc = csub(acc, cscale(cmulc(L[i][k], L[j][k]), D[k]));
      }
      L[i][j] = cscale(acc, Dinv[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int t = 0; t < C; ++t) X[i][t] = Mx[i][t];
  }
  // forward substitution: L z = Mx (unit diagonal)
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
#pragma unroll
      for (int t = 0; t < C; ++t) X[i][t] = csub(X[i][t], cmul(L[i][j], X[j][t]));
    }
  }
  // diagonal scale
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int t = 0; t < C; ++t) X[i][t] = cscale(X[i][t], Dinv[i]);
  }
  // back substitution: L^H x = z, (L^H)[i][j > i] = conj(L[j][i])
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
#pragma unroll
      for (int t = 0; t < C; ++t) {
        X[i][t] = csub(X[i][t], cmulc(X[j][t], L[j][i]));
      }
    }
  }
}

// Both eigenvalues of the Hermitian 2x2 (p, q, r): l0 >= l1.
__device__ __forceinline__ void herm2_eigvals(float p, cf q, float r,
                                              float& l0, float& l1) {
  const float mid = 0.5f * (p + r);
  const float h = 0.5f * (p - r);
  const float root = sqrtf(h * h + cabs2(q));
  l0 = mid + root;
  l1 = mid - root;
}

}  // namespace planes
