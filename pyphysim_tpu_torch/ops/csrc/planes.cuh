// Small complex matrix helpers of the port's Monte Carlo solvers (BD, IA), over
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


// ---- vectors ------------------------------------------------------------

// M v for an (N, N) M.
template <int N>
__device__ __forceinline__ void matvec(const cf (&M)[N][N], const cf (&v)[N],
                                       cf (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cf acc = cmul(M[i][0], v[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) acc = cadd(acc, cmul(M[i][j], v[j]));
    out[i] = acc;
  }
}

// a^H b, summed in order.
template <int N>
__device__ __forceinline__ cf gdotc(const cf (&a)[N], const cf (&b)[N]) {
  cf acc = cmulc(b[0], a[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) acc = cadd(acc, cmulc(b[i], a[i]));
  return acc;
}

// v / max(||v||, kEps), in place.
template <int N>
__device__ __forceinline__ void vnormalize(cf (&v)[N]) {
  float n2 = cabs2(v[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) n2 = n2 + cabs2(v[i]);
  const float inv = 1.0f / fmaxf(sqrtf(n2), kEps);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = cscale(v[i], inv);
}

// Modified Gram-Schmidt of the C vectors cols[0..C), in order, in place.
template <int C, int N>
__device__ __forceinline__ void mgs(cf (&cols)[C][N]) {
#pragma unroll
  for (int l = 0; l < C; ++l) {
#pragma unroll
    for (int m = 0; m < l; ++m) {
      const cf proj = gdotc<N>(cols[m], cols[l]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        cols[l][i] = csub(cols[l][i], cmul(proj, cols[m][i]));
      }
    }
    vnormalize<N>(cols[l]);
  }
}

// NS orthonormal vectors after `iters` steps of orthogonal iteration on
// G = M^H M from the first NS unit vectors: the NS dominant right singular
// vectors of M once it converges. `iters` is a run-time loop.
template <int N, int NS>
__device__ __forceinline__ void orth_iter_init(const cf (&M)[N][N], int iters,
                                               cf (&cols)[NS][N]) {
  cf Mh[N][N], G[N][N];
  mat_H<N, N>(M, Mh);
  mat_mul<N, N, N>(Mh, M, G);
#pragma unroll
  for (int l = 0; l < NS; ++l) {
#pragma unroll
    for (int i = 0; i < N; ++i) cols[l][i] = {i == l ? 1.f : 0.f, 0.f};
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    cf next[NS][N];
#pragma unroll
    for (int l = 0; l < NS; ++l) matvec<N>(G, cols[l], next[l]);
    mgs<NS, N>(next);
#pragma unroll
    for (int l = 0; l < NS; ++l) {
#pragma unroll
      for (int i = 0; i < N; ++i) cols[l][i] = next[l][i];
    }
  }
}

// ---- Hermitian accumulation and solves ----------------------------------

// B += s v v^H for a full (N, N) B.
template <int N>
__device__ __forceinline__ void herm_add_outer(cf (&B)[N][N],
                                               const cf (&v)[N], float s) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) B[i][j] = cadd(B[i][j], cscale(cmulc(v[i], v[j]), s));
  }
}

// (p, q, r) += s v v^H for a Hermitian 2x2.
__device__ __forceinline__ void herm2_add_outer(float& p, cf& q, float& r,
                                                cf v0, cf v1, float s) {
  p = p + s * cabs2(v0);
  q = cadd(q, cscale(cmulc(v0, v1), s));
  r = r + s * cabs2(v1);
}

// (x0, x1) = (p, q, r)^-1 (v0, v1) by the adjugate, the determinant floored
// at kEps (callers normalize the result).
__device__ __forceinline__ void herm2_solve(float p, cf q, float r, cf v0,
                                            cf v1, cf& x0, cf& x1) {
  const float inv = 1.0f / fmaxf(p * r - cabs2(q), kEps);
  x0 = cscale(csub(cscale(v0, r), cmul(q, v1)), inv);
  x1 = cscale(csub(cscale(v1, p), cmulc(v0, q)), inv);
}

// re(v^H B v) for a Hermitian 2x2 (p, q, r).
__device__ __forceinline__ float herm2_quad(float p, cf q, float r, cf v0,
                                            cf v1) {
  const cf cross = cmulc(v1, v0);
  return p * cabs2(v0) + r * cabs2(v1) +
         2.0f * (q.re * cross.re - q.im * cross.im);
}

// Dominant right singular vector of a 2x2 M: the closed-form top
// eigenvector of M^H M; an already diagonal Gram matrix picks its larger
// axis.
__device__ __forceinline__ void dominant_right_singular(cf m00, cf m01, cf m10,
                                                        cf m11, cf (&v)[2]) {
  const float p = cabs2(m00) + cabs2(m10);
  const float r = cabs2(m01) + cabs2(m11);
  const cf q = cadd(cmulc(m01, m00), cmulc(m11, m10));
  const float half = 0.5f * (p - r);
  const float lam = 0.5f * (p + r) + sqrtf(half * half + cabs2(q));
  const float w = lam - p;
  const bool ok = cabs2(q) + w * w > 1e-12f * fmaxf(lam * lam, kEps);
  const float e0 = p >= r ? 1.f : 0.f;
  v[0] = ok ? q : cf{e0, 0.f};
  v[1] = cf{ok ? w : 1.f - e0, 0.f};
  vnormalize<2>(v);
}

}  // namespace planes
