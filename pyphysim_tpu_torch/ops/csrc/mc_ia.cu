// Max-SINR interference-alignment Monte Carlo, one capacity sum per
// (rep, tile), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/ia_pallas.py
// MonteCarloMaxSinr._solve_block / _solve_block_general, launched by
// _make_prng_call (in-kernel random bits) and build_inject (bits read from
// a device tensor). For every element (one K-user interference channel of
// N x N links) it computes:
//   * H[k][j], complex Gaussian links from erfinvf of clamped uniforms
//     (N(0, 1/2) per part), the planes in the JAX order (k, j, entry,
//     re/im);
//   * the init: at (N, Ns) = (2, 1) the closed-form dominant right singular
//     vector of H[k][k]; elsewhere init_iters steps of orthogonal iteration
//     on H[k][k]^H H[k][k], columns scaled by 1/sqrt(Ns);
//   * `iterations` Max-SINR rounds: receive filters u = normalize(Bkl^-1 d)
//     with Bkl = nv I + sum_j P (H_kj f_j)(H_kj f_j)^H - P d d^H and
//     d = H_kk f_k (Cadambe eq. 28), then precoders from the same update on
//     the reverse network H_rev[k][j] = H[j][k]^H at power P / Ns; then the
//     last receive filters;
//   * SINR P |u^H d|^2 / |re(u^H Bkl u)| per stream, the sum over users and
//     streams of log2(1 + SINR), and 0 for a non-finite draw.
//
// What bounds it on the card: instruction issue. In PRNG mode nothing is
// read per element. At the bench point (K, N, Ns) = (3, 2, 1) with 10
// iterations a solve issues ~13,100 SASS instructions, ~9,900 of them f32
// (63 user updates of ~150 each, 72 erfinvf, 18 Philox calls; ops/sass.py
// counts them in the built library and chip_smoke.py prints the count): one
// warp instruction per scheduler per clock is the limit, ahead of the FMA
// pipe.
// The design:
//   * one solve per thread, the closed-form body wholly in registers: the
//     channels are a fixed-size register array (72 floats at K = 3), every
//     user and matrix loop unrolled with K a template parameter, and only
//     the Max-SINR iteration loop a run-time loop; the reverse network reads
//     the same registers conjugate-transposed, so H is held once;
//   * the general body (N = 4) keeps H (K * K * 32 floats) in shared
//     memory, one plane per row of 32 threads (conflict-free), a block of
//     one warp so that 288 planes fit in 36 KB; its Bkl, LDL^H factors and
//     filters stay in registers;
//   * each thread draws its element's channel words with Philox in
//     registers; inject-mode loads are coalesced along the lane;
//   * a block sums its elements in a fixed order (a shuffle tree, then its
//     warps), writes one partial, and a second pass adds a (rep, tile)'s
//     partials in order. No float atomics: a rerun and another chunking give
//     the same bits.
// The prebuilt library holds the five geometries of launch_geometry below;
// any other (K, N, Ns) is built on its first use with -DMC_IA_K=..
// -DMC_IA_N=.. -DMC_IA_NS=.. (ops/_build.py) in the wide form,
// mc_ia_wide_kernel: either body, one warp a block, each thread's channels
// (K^2 N^2 2 floats) in a column at stride 32 as the general body keeps
// them. At K >= 5 the closed form's channel no longer fits in registers
// (200 floats at K = 5) and moves there too. The columns live in dynamic
// shared memory (opted in above 48 KB: 64 KB at (4, 4, Ns)) while a warp's
// fit in 227 KB, past that in the scratch buffer of wide.cuh
// (mc_ia_scratch_bytes says how large). The
// Philox calls that fill a column are a rolled loop; the bodies are the
// ones above, so Bkl, the LDL^H factors and the filters stay in registers
// (K N Ns complex values each for F and U) and spill at the largest
// geometries.
// chip_smoke.py prints ptxas's registers and spills for each instance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"
#include "wide.cuh"

namespace {

using planes::cabs2;
using planes::cadd;
using planes::cconj;
using planes::cf;
using planes::cmul;
using planes::cmulc;
using planes::cscale;
using planes::csub;

constexpr int kClosedThreads = 128;
constexpr int kGeneralThreads = 32;
constexpr uint32_t kChannelKey = 6u;  // ops/philox.py IA_CHANNEL_KEY

struct Params {
  const int* bits;  // inject mode: (reps, num_tiles * tile, planes * lane)
  long long rep_stride;
  long long row_stride;
  float* partial;   // (reps * num_tiles * parts)
  int num_tiles, tile, lane, parts;
  int iters, init_iters;
  float P, nv;
  uint32_t seed;
  long long start;
  float* scratch;  // the wide form past shared memory: its state slots
  int blocks;      // blocks of the whole launch (the wide form walks them)
};

// Calls sink(plane, value) for each of the NP channel planes of element e of
// tile tile_idx of repetition rep: read from the bit tensor or drawn from
// the element's Philox calls.
template <int NP, bool kInject, typename Sink>
__device__ __forceinline__ void draw_planes(const Params& p, int rep,
                                            int tile_idx, int e, Sink&& sink) {
  if (kInject) {
    const int r = e / p.lane;
    const int l = e - r * p.lane;
    const int* row = p.bits + rep * p.rep_stride +
                     (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      sink(pl, bits_half_normal((uint32_t)row[(long long)pl * p.lane]));
    }
  } else {
    constexpr int CALLS = (NP + 3) / 4;
    const unsigned long long attempt =
        (unsigned long long)(p.start + (long long)rep);
    const uint32_t att_lo = (uint32_t)attempt;
    const uint32_t att_hi = (uint32_t)(attempt >> 32);
#pragma unroll
    for (int j = 0; j < CALLS; ++j) {
      const uint4 x = philox4x32_10(
          make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j), att_lo,
                     att_hi),
          make_uint2(p.seed, kChannelKey));
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * j + k < NP) sink(4 * j + k, bits_half_normal(w[k]));
      }
    }
  }
}

// A thread's channels in a column (shared or device memory): plane pl at
// s[pl * T].
template <int K, int N, int T = kGeneralThreads>
struct SharedH {
  const float* s;
  __device__ __forceinline__ cf get(int k, int j, int r, int c) const {
    const int pl = 2 * (((k * K + j) * N + r) * N + c);
    return {s[pl * T], s[(pl + 1) * T]};
  }
};

// ---- the closed-form body, (N, Ns) = (2, 1) -----------------------------

// Entry (r, c) of link (k, j): H in registers, or in a column.
template <int K>
__device__ __forceinline__ cf h_at(const cf (&H)[K][K][2][2], int k, int j,
                                   int r, int c) {
  return H[k][j][r][c];
}

template <int K, int T>
__device__ __forceinline__ cf h_at(const SharedH<K, 2, T>& H, int k, int j,
                                   int r, int c) {
  return H.get(k, j, r, c);
}

// Link (k, j) of the forward network, or of the reverse one
// (H_rev[k][j] = H[j][k]^H), entry (r, c).
template <int K, bool REV, typename HT>
__device__ __forceinline__ cf link2(const HT& H, int k, int j, int r, int c) {
  return REV ? cconj(h_at<K>(H, j, k, c, r)) : h_at<K>(H, k, j, r, c);
}

// Bkl = (p, q, r) of user k over precoders F, and d = H_kk f_k
// (_solve_block's update, in its order).
template <int K, bool REV, typename HT>
__device__ __forceinline__ void closed_bkl(const HT& H,
                                           const cf (&F)[K][2], int k,
                                           float nv, float P, float& p, cf& q,
                                           float& r, cf (&d)[2]) {
  p = nv;
  q = {0.f, 0.f};
  r = nv;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cf t[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      t[i] = cadd(cmul(link2<K, REV, HT>(H, k, j, i, 0), F[j][0]),
                  cmul(link2<K, REV, HT>(H, k, j, i, 1), F[j][1]));
    }
    planes::herm2_add_outer(p, q, r, t[0], t[1], P);
    if (j == k) {
      d[0] = t[0];
      d[1] = t[1];
    }
  }
  p = p - P * cabs2(d[0]);
  q = csub(q, cscale(cmulc(d[0], d[1]), P));
  r = r - P * cabs2(d[1]);
}

// One direction of the Max-SINR update: out[k] = normalize(Bkl^-1 d).
template <int K, bool REV, typename HT>
__device__ __forceinline__ void closed_update(const HT& H,
                                              const cf (&F)[K][2],
                                              cf (&out)[K][2], float nv,
                                              float P) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float p, r;
    cf q, d[2];
    closed_bkl<K, REV, HT>(H, F, k, nv, P, p, q, r, d);
    planes::herm2_solve(p, q, r, d[0], d[1], out[k][0], out[k][1]);
    planes::vnormalize<2>(out[k]);
  }
}

template <int K, typename HT>
__device__ __forceinline__ float solve_closed(const HT& H, float nv, float P,
                                              int iters) {
  cf F[K][2], U[K][2];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    planes::dominant_right_singular(h_at<K>(H, k, k, 0, 0),
                                    h_at<K>(H, k, k, 0, 1),
                                    h_at<K>(H, k, k, 1, 0),
                                    h_at<K>(H, k, k, 1, 1), F[k]);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    closed_update<K, false, HT>(H, F, U, nv, P);
    closed_update<K, true, HT>(H, U, F, nv, P);
  }
  closed_update<K, false, HT>(H, F, U, nv, P);

  float cap = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float p, r;
    cf q, d[2];
    closed_bkl<K, false, HT>(H, F, k, nv, P, p, q, r, d);
    const float num =
        P * cabs2(cadd(cmulc(d[0], U[k][0]), cmulc(d[1], U[k][1])));
    const float den =
        fmaxf(fabsf(planes::herm2_quad(p, q, r, U[k][0], U[k][1])),
              planes::kEps);
    const float c = log2f(1.0f + num / den);
    cap = k == 0 ? c : cap + c;
  }
  return isfinite(cap) ? cap : 0.f;
}

// ---- the general body ---------------------------------------------------

template <int K, int N, bool REV>
__device__ __forceinline__ void link_matvec(const SharedH<K, N>& H, int k,
                                            int j, const cf (&v)[N],
                                            cf (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cf acc = cmul(REV ? cconj(H.get(j, k, 0, i)) : H.get(k, j, i, 0), v[0]);
#pragma unroll
    for (int c = 1; c < N; ++c) {
      acc = cadd(acc,
                 cmul(REV ? cconj(H.get(j, k, c, i)) : H.get(k, j, i, c), v[c]));
    }
    out[i] = acc;
  }
}

// first = nv I + sum_j sum_l p t t^H (t = H_kj f_jl) and D[l] = H_kk f_kl.
template <int K, int N, int NS, bool REV>
__device__ __forceinline__ void general_first(const SharedH<K, N>& H,
                                              const cf (&F)[K][NS][N], int k,
                                              float nv, float p,
                                              cf (&first)[N][N],
                                              cf (&D)[NS][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < N; ++c) first[i][c] = {i == c ? nv : 0.f, 0.f};
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      cf t[N];
      link_matvec<K, N, REV>(H, k, j, F[j][l], t);
      planes::herm_add_outer<N>(first, t, p);
      if (j == k) {
#pragma unroll
        for (int i = 0; i < N; ++i) D[l][i] = t[i];
      }
    }
  }
}

template <int K, int N, int NS, bool REV>
__device__ __forceinline__ void general_update(const SharedH<K, N>& H,
                                               const cf (&F)[K][NS][N],
                                               cf (&out)[K][NS][N], float nv,
                                               float p, float inv_sqrt_ns) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf first[N][N], D[NS][N];
    general_first<K, N, NS, REV>(H, F, k, nv, p, first, D);
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      cf B[N][N], rhs[N][1], x[N][1];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int c = 0; c < N; ++c) B[i][c] = first[i][c];
        rhs[i][0] = D[l][i];
      }
      planes::herm_add_outer<N>(B, D[l], -p);
      planes::herm_solve_cols_ldl<N, 1>(B, rhs, x);
      cf u[N];
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = x[i][0];
      planes::vnormalize<N>(u);
#pragma unroll
      for (int i = 0; i < N; ++i) out[k][l][i] = cscale(u[i], inv_sqrt_ns);
    }
  }
}

template <int K, int N, int NS>
__device__ __forceinline__ float solve_general(const SharedH<K, N>& H,
                                               float nv, float P, int iters,
                                               int init_iters) {
  const float inv_sqrt_ns = (float)(1.0 / sqrt((double)NS));
  const float p_rev = P / (float)NS;
  cf F[K][NS][N], U[K][NS][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf M[N][N], cols[NS][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int c = 0; c < N; ++c) M[i][c] = H.get(k, k, i, c);
    }
    planes::orth_iter_init<N, NS>(M, init_iters, cols);
#pragma unroll
    for (int l = 0; l < NS; ++l) {
#pragma unroll
      for (int i = 0; i < N; ++i) F[k][l][i] = cscale(cols[l][i], inv_sqrt_ns);
    }
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    general_update<K, N, NS, false>(H, F, U, nv, P, inv_sqrt_ns);
    general_update<K, N, NS, true>(H, U, F, nv, p_rev, inv_sqrt_ns);
  }
  general_update<K, N, NS, false>(H, F, U, nv, P, inv_sqrt_ns);

  float cap = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf first[N][N], D[NS][N];
    general_first<K, N, NS, false>(H, F, k, nv, P, first, D);
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      cf B[N][N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int c = 0; c < N; ++c) B[i][c] = first[i][c];
      }
      planes::herm_add_outer<N>(B, D[l], -P);
      const float num = P * cabs2(planes::gdotc<N>(U[k][l], D[l]));
      cf w[N];
      planes::matvec<N>(B, U[k][l], w);
      const float den =
          fmaxf(fabsf(planes::gdotc<N>(U[k][l], w).re), planes::kEps);
      const float c = log2f(1.0f + num / den);
      cap = (k == 0 && l == 0) ? c : cap + c;
    }
  }
  return isfinite(cap) ? cap : 0.f;
}

// ---- kernels --------------------------------------------------------------

// A block's elements summed in a fixed order into *out.
template <int T>
__device__ __forceinline__ void block_sum(float acc, float* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if constexpr (T == 32) {
    if (threadIdx.x == 0) *out = acc;
  } else {
    __shared__ float s_warp_sum[T / 32];
    if ((threadIdx.x & 31) == 0) s_warp_sum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = s_warp_sum[0];
#pragma unroll
      for (int w = 1; w < T / 32; ++w) v += s_warp_sum[w];
      *out = v;
    }
  }
}

template <int K, bool kInject>
__global__ void __launch_bounds__(kClosedThreads)
    mc_ia_closed_kernel(const Params p) {
  constexpr int NP = K * K * 8;
  const int cell = blockIdx.x / p.parts;   // rep * num_tiles + tile
  const int part = blockIdx.x % p.parts;
  const int rep = cell / p.num_tiles;
  const int tile_idx = cell % p.num_tiles;
  const int e = part * kClosedThreads + threadIdx.x;
  float acc = 0.f;
  if (e < p.tile * p.lane) {
    cf H[K][K][2][2];
    draw_planes<NP, kInject>(p, rep, tile_idx, e, [&](int pl, float v) {
      const int x = pl >> 1;  // (k K + j) 4 + r 2 + c
      cf& h = H[x / (4 * K)][(x / 4) % K][(x / 2) % 2][x % 2];
      if (pl & 1) {
        h.im = v;
      } else {
        h.re = v;
      }
    });
    acc = solve_closed<K>(H, p.nv, p.P, p.iters);
  }
  block_sum<kClosedThreads>(acc, p.partial + blockIdx.x);
}

template <int K, int N, int NS, bool kInject>
__global__ void __launch_bounds__(kGeneralThreads)
    mc_ia_general_kernel(const Params p) {
  constexpr int NP = K * K * N * N * 2;
  __shared__ float s_H[NP * kGeneralThreads];
  const int cell = blockIdx.x / p.parts;
  const int part = blockIdx.x % p.parts;
  const int rep = cell / p.num_tiles;
  const int tile_idx = cell % p.num_tiles;
  const int e = part * kGeneralThreads + threadIdx.x;
  float acc = 0.f;
  if (e < p.tile * p.lane) {
    float* mine = s_H + threadIdx.x;
    draw_planes<NP, kInject>(p, rep, tile_idx, e, [&](int pl, float v) {
      mine[pl * kGeneralThreads] = v;
    });
    const SharedH<K, N> H{mine};
    acc = solve_general<K, N, NS>(H, p.nv, p.P, p.iters, p.init_iters);
  }
  block_sum<kGeneralThreads>(acc, p.partial + blockIdx.x);
}

// The wide form's column: K^2 N^2 2 floats a thread, in shared memory
// while a warp's columns fit (wide.cuh), else in the scratch buffer.
template <int K, int N>
struct WideIA {
  static constexpr int NP = K * K * N * N * 2;
  static constexpr long long kBytes =
      (long long)NP * wide::kThreads * (long long)sizeof(float);
  static constexpr bool kGlobal = wide::in_scratch(kBytes);
};

// Either body on a column, one element a thread, one warp a block, the
// block walking blocks vb = blockIdx.x, + gridDim.x, ... of the launch (one
// trip unless the state is in the scratch buffer).
template <int K, int N, int NS, bool kInject>
__global__ void __launch_bounds__(wide::kThreads)
    mc_ia_wide_kernel(const Params p) {
  using G = WideIA<K, N>;
  constexpr int NP = G::NP;
  constexpr int CALLS = (NP + 3) / 4;
  extern __shared__ float s_col[];  // (NP, wide::kThreads)
  float* const slot =
      G::kGlobal ? p.scratch + (long long)blockIdx.x * NP * wide::kThreads
                 : s_col;
  float* const mine = slot + threadIdx.x;
#pragma unroll 1
  for (int vb = blockIdx.x; vb < p.blocks; vb += gridDim.x) {
    const int cell = vb / p.parts;
    const int part = vb % p.parts;
    const int rep = cell / p.num_tiles;
    const int tile_idx = cell % p.num_tiles;
    const int e = part * wide::kThreads + threadIdx.x;
    float acc = 0.f;
    if (e < p.tile * p.lane) {
      if (kInject) {
        const int r = e / p.lane;
        const int l = e - r * p.lane;
        const int* row = p.bits + rep * p.rep_stride +
                         (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll 1
        for (int pl = 0; pl < NP; ++pl) {
          mine[pl * wide::kThreads] =
              bits_half_normal((uint32_t)row[(long long)pl * p.lane]);
        }
      } else {
        const unsigned long long attempt =
            (unsigned long long)(p.start + (long long)rep);
#pragma unroll 1  // Philox calls; the last may be partly used
        for (int j = 0; j < CALLS; ++j) {
          const uint4 x = philox4x32_10(
              make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j),
                         (uint32_t)attempt, (uint32_t)(attempt >> 32)),
              make_uint2(p.seed, kChannelKey));
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (NP % 4 == 0 || 4 * j + k < NP) {
              mine[(4 * j + k) * wide::kThreads] = bits_half_normal(w[k]);
            }
          }
        }
      }
      const SharedH<K, N, wide::kThreads> H{mine};
      if constexpr (N == 2 && NS == 1) {
        acc = solve_closed<K>(H, p.nv, p.P, p.iters);
      } else {
        acc = solve_general<K, N, NS>(H, p.nv, p.P, p.iters, p.init_iters);
      }
    }
    block_sum<wide::kThreads>(acc, p.partial + vb);
  }
}

// out[cell] = the cell's partials added in order.
__global__ void ia_sum_parts_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int cells,
                                    int parts) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  float v = 0.f;
  for (int i = 0; i < parts; ++i) v += partial[(long long)cell * parts + i];
  out[cell] = v;
}

bool closed_form(int N, int NS) { return N == 2 && NS == 1; }

int threads_for(int N, int NS) {
#ifdef MC_IA_K
  (void)N, (void)NS;
  return wide::kThreads;
#else
  return closed_form(N, NS) ? kClosedThreads : kGeneralThreads;
#endif
}

#ifdef MC_IA_K
// A library built for one geometry (ops/_build.py): that one, wide form.
template <bool kInject>
int launch_geometry(const Params& p, int K, int N, int NS, int blocks,
                    cudaStream_t s) {
  constexpr int kK = MC_IA_K, kN = MC_IA_N, kNS = MC_IA_NS;
  (void)blocks;
  if (K != kK || N != kN || NS != kNS) return (int)cudaErrorInvalidValue;
  return wide::launch(mc_ia_wide_kernel<kK, kN, kNS, kInject>, p,
                      WideIA<kK, kN>::kBytes, s);
}
#else
// The prebuilt library's geometries (K, N, Ns): (2, 2, 1), (3, 2, 1),
// (4, 2, 1) closed form; (3, 4, 1), (2, 4, 2) general.
template <bool kInject>
int launch_geometry(const Params& p, int K, int N, int NS, int blocks,
                    cudaStream_t s) {
  if (closed_form(N, NS)) {
    switch (K) {
      case 2:
        mc_ia_closed_kernel<2, kInject><<<blocks, kClosedThreads, 0, s>>>(p);
        return 0;
      case 3:
        mc_ia_closed_kernel<3, kInject><<<blocks, kClosedThreads, 0, s>>>(p);
        return 0;
      case 4:
        mc_ia_closed_kernel<4, kInject><<<blocks, kClosedThreads, 0, s>>>(p);
        return 0;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (K == 3 && N == 4 && NS == 1) {
    mc_ia_general_kernel<3, 4, 1, kInject><<<blocks, kGeneralThreads, 0, s>>>(p);
    return 0;
  }
  if (K == 2 && N == 4 && NS == 2) {
    mc_ia_general_kernel<2, 4, 2, kInject><<<blocks, kGeneralThreads, 0, s>>>(p);
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}
#endif

int launch(Params& p, float* out, int reps, int K, int N, int NS, bool inject,
           void* stream) {
  if (reps < 1 || p.num_tiles < 1 || p.tile < 1 || p.lane < 1 ||
      p.iters < 0 || p.init_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = threads_for(N, NS);
  p.parts = (p.tile * p.lane + threads - 1) / threads;
  const long long cells = (long long)reps * p.num_tiles;
  const long long blocks = cells * p.parts;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  p.blocks = (int)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = inject
                     ? launch_geometry<true>(p, K, N, NS, (int)blocks, s)
                     : launch_geometry<false>(p, K, N, NS, (int)blocks, s);
  if (rc != 0) return rc;
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ia_sum_parts_kernel<<<(unsigned int)((cells + 255) / 256), 256, 0, s>>>(
      p.partial, out, (int)cells, p.parts);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials per (rep, tile) cell: the wrapper's scratch holds
// reps * num_tiles * mc_ia_num_parts(tile, lane, N, Ns) floats.
extern "C" int mc_ia_num_parts(int tile, int lane, int N, int NS) {
  const int threads = threads_for(N, NS);
  return (tile * lane + threads - 1) / threads;
}

// Bytes of the state buffer a launch of this library's geometry needs (the
// wide form past shared memory, on the current device), else 0; -1 if the
// device cannot be read.
extern "C" long long mc_ia_scratch_bytes(int reps, int num_tiles, int tile,
                                         int lane) {
#ifdef MC_IA_K
  return wide::scratch_bytes(
      (long long)reps * num_tiles *
          mc_ia_num_parts(tile, lane, MC_IA_N, MC_IA_NS),
      WideIA<MC_IA_K, MC_IA_N>::kBytes);
#else
  (void)reps, (void)num_tiles, (void)tile, (void)lane;
  return 0;
#endif
}

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the stream keyed by seed.
extern "C" int mc_ia_prng(void* out, void* partial, int reps, int num_tiles,
                          int tile, int lane, int K, int N, int NS, int iters,
                          int init_iters, float P, float nv, unsigned int seed,
                          long long start, void* scratch, void* stream) {
  Params p = {};
  p.partial = static_cast<float*>(partial);
  p.scratch = static_cast<float*>(scratch);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.iters = iters;
  p.init_iters = init_iters;
  p.P = P;
  p.nv = nv;
  p.seed = seed;
  p.start = start;
  return launch(p, static_cast<float*>(out), reps, K, N, NS, false, stream);
}

// Channel bits read from an int32 device tensor in the JAX layout (the
// counterpart of build_inject): (reps, num_tiles * tile, planes * lane) with
// strides (rep_stride, row_stride, 1), plane pl at lanes
// [pl * lane, (pl + 1) * lane). scratch: mc_ia_scratch_bytes of device
// memory, or null where that is 0 (both entry points).
extern "C" int mc_ia_inject(const void* bits, void* out, void* partial,
                            int reps, int num_tiles, int tile, int lane, int K,
                            int N, int NS, int iters, int init_iters, float P,
                            float nv, long long rep_stride,
                            long long row_stride, void* scratch,
                            void* stream) {
  Params p = {};
  p.bits = static_cast<const int*>(bits);
  p.scratch = static_cast<float*>(scratch);
  p.rep_stride = rep_stride;
  p.row_stride = row_stride;
  p.partial = static_cast<float*>(partial);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.iters = iters;
  p.init_iters = init_iters;
  p.P = P;
  p.nv = nv;
  return launch(p, static_cast<float*>(out), reps, K, N, NS, true, stream);
}
