// Block Diagonalization CoMP sum-capacity Monte Carlo, one capacity sum per
// (rep, tile), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/bd_pallas.py
// MonteCarloBD._solve_block + _guarded, launched by _make_prng_call
// (in-kernel random bits) and build_inject (bits read from a device
// tensor). For every element (one joint channel realization) it computes:
//   * H, an NT x NT complex Gaussian channel (NT = K * Nr_u), from erfinvf
//     of clamped uniforms (N(0, 1/2) per part);
//   * for each user k: B = tilde tilde^H of the other users' rows,
//     Y = Hk tilde^H, W = B^-1 Y^H by an unrolled LDL^H, T = Hk - W^H tilde
//     (the user's rows projected on the others' null space), and the
//     stream gains |T|^2 (Nr_u = 1) or the closed-form eigenvalues of
//     T T^H (Nr_u = 2);
//   * branch-free rank water-filling over the K * Nr_u gains, then per-BS
//     normalization (normalized), the water-filling powers as they are
//     (global) or equal power (none), log2 capacities, and the
//     scale-relative guard that zeroes a degenerate draw.
//
// What bounds it on the card: instruction issue. In PRNG mode nothing is
// read per element; at (K, Nr_u) = (3, 2) an element costs ~5,800 SASS
// instructions (72 erfinvf, three 4x4 LDL^H solves and their products, 18
// Philox calls), ~3,700 of them f32 and ~1,200 ALU (ops/sass.py counts
// them from the built library): the SM's four schedulers, one warp
// instruction per clock each, are the limit, ahead of the FMA pipe. The
// design:
//   * one element per thread, the whole solve in registers: every matrix is
//     a fixed-size array (ops/csrc/planes.cuh) and every loop is unrolled,
//     with (K, Nr_u) and the mode as template parameters (the menu below);
//   * each thread draws its element's channel words with Philox in
//     registers; inject-mode loads are coalesced along the lane;
//   * the TPU grid (rep, tile) ran in order and summed per step; here a
//     block sums a fixed slice of a (rep, tile) in a fixed order (per
//     thread, then a shuffle tree, then its warps), writes one partial, and
//     a second pass adds a (rep, tile)'s partials in order. No float
//     atomics: a rerun and another chunking give the same bits.
// Register pressure grows with NT^2: at (4, 2) H alone is 128 floats;
// chip_smoke.py prints ptxas's registers and spills for each instance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"

namespace {

using planes::cf;

constexpr int kThreads = 128;
constexpr int kElemsPerThread = 4;
constexpr int kElemsPerBlock = kThreads * kElemsPerThread;
constexpr uint32_t kChannelKey = 5u;  // ops/philox.py BD_CHANNEL_KEY
enum Mode { kNormalized = 0, kGlobal = 1, kNone = 2 };

struct Params {
  const int* bits;  // inject mode: (reps, num_tiles * tile, planes * lane)
  long long rep_stride;
  long long row_stride;
  float* partial;   // (reps * num_tiles * parts)
  int num_tiles, tile, lane, parts;
  float ipu, nv;
  uint32_t seed;
  long long start;
};

// Plane pl (re of H[i][c] at 2 (i NT + c), im next) of an element.
template <int NT>
__device__ __forceinline__ void set_plane(cf (&H)[NT][NT], int pl, float v) {
  const int e = pl >> 1;
  if (pl & 1) {
    H[e / NT][e % NT].im = v;
  } else {
    H[e / NT][e % NT].re = v;
  }
}

// Sum capacity of one element (0 for a degenerate draw): _solve_block +
// _guarded of bd_pallas.py, in the same order.
template <int K, int NR, int MODE>
__device__ __forceinline__ float solve_element(const cf (&H)[K * NR][K * NR],
                                               float nv, float ipu) {
  constexpr int NT = K * NR;
  constexpr int M = (K - 1) * NR;
  constexpr int NS = K * NR;  // streams
  float gains[NS];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cf tilde[M][NT];
    cf Hk[NR][NT];
#pragma unroll
    for (int t = 0; t < M; ++t) {
      const int src = t < k * NR ? t : t + NR;
#pragma unroll
      for (int j = 0; j < NT; ++j) tilde[t][j] = H[src][j];
    }
#pragma unroll
    for (int t = 0; t < NR; ++t) {
#pragma unroll
      for (int j = 0; j < NT; ++j) Hk[t][j] = H[NR * k + t][j];
    }
    // projector route: T = Hk - W^H tilde with W = B^-1 Y^H
    cf B[M][M];
    planes::gram_full<M, NT>(tilde, B);
    cf tilde_h[NT][M];
    planes::mat_H<M, NT>(tilde, tilde_h);
    cf Y[NR][M];
    planes::mat_mul<NR, NT, M>(Hk, tilde_h, Y);
    cf Y_h[M][NR];
    planes::mat_H<NR, M>(Y, Y_h);
    cf W[M][NR];
    planes::herm_solve_cols_ldl<M, NR>(B, Y_h, W);
    cf W_h[NR][M];
    planes::mat_H<M, NR>(W, W_h);
    cf proj[NR][NT];
    planes::mat_mul<NR, M, NT>(W_h, tilde, proj);
    cf T[NR][NT];
    planes::mat_sub<NR, NT>(Hk, proj, T);
    if constexpr (NR == 1) {
      float g = planes::cabs2(T[0][0]);
#pragma unroll
      for (int j = 1; j < NT; ++j) g = g + planes::cabs2(T[0][j]);
      gains[k] = fmaxf(g, 0.f);  // sigma^2
    } else {
      float p, r, l0, l1;
      cf q;
      planes::gram_rows<NT>(T, p, q, r);
      planes::herm2_eigvals(p, q, r, l0, l1);
      gains[NR * k] = fmaxf(l0, 0.f);  // sigma^2, descending
      gains[NR * k + 1] = fmaxf(l1, 0.f);
    }
  }

  float cap = 0.f;
  if constexpr (MODE == kNone) {
    // equal per-BS power: iPu / Nr_u on every stream
    const float p_eq = ipu / (float)NR;
    const float inv_nv = 1.0f / nv;
#pragma unroll
    for (int i = 0; i < NS; ++i) cap += log2f(1.0f + p_eq * gains[i] * inv_nv);
  } else {
    // branch-free water-filling over the stream gains (doWF_jit)
    const float total_power = (float)K * ipu;
    float inv[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) inv[i] = nv / fmaxf(gains[i], planes::kEps);
    int rank[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      int r_i = 0;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j != i) r_i += (inv[j] < inv[i]) + (inv[j] == inv[i] && j < i);
      }
      rank[i] = r_i;
    }
    float mu_k[NS];
    int kept = 0;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      float cum_inv = 0.f, worst = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        cum_inv += rank[i] <= kk ? inv[i] : 0.f;
        worst += rank[i] == kk ? inv[i] : 0.f;
      }
      mu_k[kk] = (total_power + cum_inv) / (float)(kk + 1);
      kept += mu_k[kk] >= worst;
    }
    float mu = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) mu += kept == kk + 1 ? mu_k[kk] : 0.f;
    float powers[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) powers[i] = fmaxf(mu - inv[i], 0.f);
    float scale2 = 1.0f;  // global: the water-filling powers as they are
    if constexpr (MODE == kNormalized) {
      // per-BS normalization: the stream basis is orthonormal, so a
      // user's block power is the sum of its stream powers
      float max_p = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float up = 0.f;
#pragma unroll
        for (int t = 0; t < NR; ++t) up += powers[NR * k + t];
        max_p = k == 0 ? up : fmaxf(max_p, up);
      }
      scale2 = ipu / fmaxf(max_p, planes::kEps);
    }
    const float inv_nv = 1.0f / nv;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      cap += log2f(1.0f + powers[i] * scale2 * gains[i] * inv_nv);
    }
  }

  // scale-relative guard
  float smax = gains[0], smin = gains[0];
#pragma unroll
  for (int i = 1; i < NS; ++i) {
    smax = fmaxf(smax, gains[i]);
    smin = fminf(smin, gains[i]);
  }
  const bool ok = sqrtf(smin) > 1e-6f * sqrtf(smax);
  return (isfinite(cap) && ok) ? cap : 0.f;
}

template <int K, int NR, int MODE, bool kInject>
__global__ void __launch_bounds__(kThreads) mc_bd_kernel(const Params p) {
  constexpr int NT = K * NR;
  constexpr int P = 2 * NT * NT;
  constexpr int CALLS = (P + 3) / 4;
  __shared__ float s_warp_sum[kThreads / 32];
  const int cell = blockIdx.x / p.parts;   // rep * num_tiles + tile
  const int part = blockIdx.x % p.parts;
  const int rep = cell / p.num_tiles;
  const int tile_idx = cell % p.num_tiles;
  const unsigned long long attempt =
      (unsigned long long)(p.start + (long long)rep);
  const uint32_t att_lo = (uint32_t)attempt;
  const uint32_t att_hi = (uint32_t)(attempt >> 32);
  const int elems = p.tile * p.lane;

  float acc = 0.f;
#pragma unroll 1
  for (int i = 0; i < kElemsPerThread; ++i) {
    const int e = part * kElemsPerBlock + i * kThreads + threadIdx.x;
    if (e >= elems) break;
    cf H[NT][NT];
    if (kInject) {
      const int r = e / p.lane;
      const int l = e - r * p.lane;
      const int* row = p.bits + rep * p.rep_stride +
                       (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll
      for (int pl = 0; pl < P; ++pl) {
        set_plane<NT>(H, pl, bits_half_normal((uint32_t)row[pl * p.lane]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < CALLS; ++j) {
        const uint4 x = philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j), att_lo,
                       att_hi),
            make_uint2(p.seed, kChannelKey));
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * j + k < P) set_plane<NT>(H, 4 * j + k, bits_half_normal(w[k]));
        }
      }
    }
    acc += solve_element<K, NR, MODE>(H, p.nv, p.ipu);
  }

  // fixed-order block reduction -> one partial per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane_in_warp = threadIdx.x & 31;
  if (lane_in_warp == 0) s_warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s_warp_sum[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) v += s_warp_sum[w];
    p.partial[blockIdx.x] = v;
  }
}

// out[cell] = the cell's partials added in order.
__global__ void bd_sum_parts_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int cells,
                                    int parts) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  float v = 0.f;
  for (int i = 0; i < parts; ++i) v += partial[(long long)cell * parts + i];
  out[cell] = v;
}

template <int K, int NR, int MODE, bool kInject>
void launch_one(const Params& p, int blocks, cudaStream_t s) {
  mc_bd_kernel<K, NR, MODE, kInject><<<blocks, kThreads, 0, s>>>(p);
}

template <int K, int NR, bool kInject>
int launch_mode(const Params& p, int mode, int blocks, cudaStream_t s) {
  switch (mode) {
    case kNormalized:
      launch_one<K, NR, kNormalized, kInject>(p, blocks, s);
      return 0;
    case kGlobal:
      launch_one<K, NR, kGlobal, kInject>(p, blocks, s);
      return 0;
    case kNone:
      launch_one<K, NR, kNone, kInject>(p, blocks, s);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The geometry menu (K, Nr_u): (2,1), (2,2), (3,2), (4,1), (4,2).
template <bool kInject>
int launch_geometry(const Params& p, int K, int NR, int mode, int blocks,
                    cudaStream_t s) {
  if (K == 2 && NR == 1) return launch_mode<2, 1, kInject>(p, mode, blocks, s);
  if (K == 2 && NR == 2) return launch_mode<2, 2, kInject>(p, mode, blocks, s);
  if (K == 3 && NR == 2) return launch_mode<3, 2, kInject>(p, mode, blocks, s);
  if (K == 4 && NR == 1) return launch_mode<4, 1, kInject>(p, mode, blocks, s);
  if (K == 4 && NR == 2) return launch_mode<4, 2, kInject>(p, mode, blocks, s);
  return (int)cudaErrorInvalidValue;
}

int launch(Params& p, float* out, int reps, int K, int NR, int mode,
           bool inject, void* stream) {
  if (reps < 1 || p.num_tiles < 1 || p.tile < 1 || p.lane < 1) {
    return (int)cudaErrorInvalidValue;
  }
  p.parts = (p.tile * p.lane + kElemsPerBlock - 1) / kElemsPerBlock;
  const long long cells = (long long)reps * p.num_tiles;
  const long long blocks = cells * p.parts;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = inject
                     ? launch_geometry<true>(p, K, NR, mode, (int)blocks, s)
                     : launch_geometry<false>(p, K, NR, mode, (int)blocks, s);
  if (rc != 0) return rc;
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  bd_sum_parts_kernel<<<(unsigned int)((cells + 255) / 256), 256, 0, s>>>(
      p.partial, out, (int)cells, p.parts);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials per (rep, tile) cell: the wrapper's scratch holds
// reps * num_tiles * mc_bd_num_parts(tile, lane) floats.
extern "C" int mc_bd_num_parts(int tile, int lane) {
  return (tile * lane + kElemsPerBlock - 1) / kElemsPerBlock;
}

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the stream keyed by seed.
// mode: 0 normalized, 1 global, 2 none.
extern "C" int mc_bd_prng(void* out, void* partial, int reps, int num_tiles,
                          int tile, int lane, int K, int NR, int mode,
                          float ipu, float nv, unsigned int seed,
                          long long start, void* stream) {
  Params p = {};
  p.partial = static_cast<float*>(partial);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.ipu = ipu;
  p.nv = nv;
  p.seed = seed;
  p.start = start;
  return launch(p, static_cast<float*>(out), reps, K, NR, mode, false,
                stream);
}

// Channel bits read from an int32 device tensor in the JAX layout (the
// counterpart of build_inject): (reps, num_tiles * tile, planes * lane)
// with strides (rep_stride, row_stride, 1), plane pl at lanes
// [pl * lane, (pl + 1) * lane).
extern "C" int mc_bd_inject(const void* bits, void* out, void* partial,
                            int reps, int num_tiles, int tile, int lane, int K,
                            int NR, int mode, float ipu, float nv,
                            long long rep_stride, long long row_stride,
                            void* stream) {
  Params p = {};
  p.bits = static_cast<const int*>(bits);
  p.rep_stride = rep_stride;
  p.row_stride = row_stride;
  p.partial = static_cast<float*>(partial);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.ipu = ipu;
  p.nv = nv;
  return launch(p, static_cast<float*>(out), reps, K, NR, mode, true, stream);
}
