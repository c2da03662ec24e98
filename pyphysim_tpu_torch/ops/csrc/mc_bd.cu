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
// read per element; at (K, Nr_u) = (3, 2) an element costs ~7,400 SASS
// instructions (72 erfinvf, three 4x4 LDL^H solves and their products, 18
// Philox calls, the shared-memory traffic and the column loops), most of
// them f32 (ops/sass.py counts them from the built library): the SM's four
// schedulers, one warp instruction per clock each, are the limit. The
// function needs fewer: the earlier form, H in registers, solved an element
// in ~5,800, so ~1,500 of these (the shared-memory traffic, loop counters,
// run-time addresses) are overhead of this design, and chip_smoke.py holds
// the kernel to the bound of the smaller count. To reach it the schedulers
// need enough warps to hide each solve's long dependent chain, and a loop
// body small enough to stay in the instruction cache. The design:
//   * one element per thread, its channel in shared memory: the thread
//     writes its element's NT x NT entries to a plane-major tile
//     s_H[entry][threadIdx.x] (one float2 per entry, so a warp's access is
//     256 consecutive bytes, free of bank conflicts), from Philox words in
//     registers (PRNG mode, the same words in the same order as the plain
//     version) or from loads coalesced along the lane (inject mode). Each
//     thread reads only its own column, so no barrier is needed;
//   * per user only the small working set lives in registers: B (M x M, M
//     = (K - 1) Nr_u), Y (Nr_u x M) and W (M x Nr_u). B and Y are summed
//     column by column of H; then T is streamed column by column straight
//     into its Gram (p, q, r) or |T|^2, so tilde, Hk, T and the projection
//     never exist whole. The sums run in the order of the plain version
//     (bd_pallas.py _solve_block), so the result stays within rounding of
//     it; T T^H is never rewritten as Hk Hk^H - Y W, which cancels;
//   * the loops: the Philox calls that fill a thread's column and the two
//     passes over the columns of H stay rolled (the column index is a
//     run-time shared-memory offset, so a rolled pass costs a counter and
//     keeps the code small); the user loop is unrolled, so each user's row
//     offsets are constants. Fully unrolled, the solve was ~130 KB of code
//     and slower than H held in registers; rolling the user loop as well,
//     or giving a thread 2 or 4 elements, was slower than this form
//     (bin/tune_bd_kernel.py times these variants; ops/bd_kernel.py's SASS
//     profile lists the loops);
//   * (K, Nr_u) and the mode are template parameters (the menu below).
// Shared memory per block of 128 threads: NT^2 x 1 KB (36 KB at (3, 2),
// 64 KB at (4, 2), above the 48 KB default, opted in per launch).
// __launch_bounds__ caps registers at 128 for NT <= 6 (four blocks a SM)
// and 168 at NT = 8 (three blocks, bound by shared memory); ptxas stays
// well below both without spilling (~60 at (3, 2), so shared memory, not
// registers, sets six blocks, 24 warps a SM, where H held in registers
// took 255 with spills and two blocks). chip_smoke.py prints each
// instance's registers and spills. The water-filling and the sums keep a
// fixed order: the TPU grid (rep, tile) ran in order and summed per step;
// here a block sums a fixed slice of a (rep, tile) in a fixed order (a
// shuffle tree, then its warps), writes one partial, and a second pass
// adds a (rep, tile)'s partials in order. No float atomics: a rerun and
// another chunking give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"

namespace {

using planes::cf;

constexpr int kThreads = 128;  // one element a thread
constexpr int kStaticSmemLimit = 48 * 1024;
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

// Bytes of s_H for an NT x NT channel per thread of a block.
template <int NT>
constexpr int smem_bytes() {
  return NT * NT * kThreads * (int)sizeof(float2);
}

// Blocks per SM that __launch_bounds__ asks registers for: four, unless
// shared memory admits fewer.
template <int NT>
constexpr int min_blocks() {
  return smem_bytes<NT>() > kStaticSmemLimit ? 3 : 4;
}

// Entry e = i NT + j of this thread's element: its column of s_H holds
// the entries kThreads float2 apart.
__device__ __forceinline__ cf load_h(const float2* col, int e) {
  const float2 v = col[e * kThreads];
  return {v.x, v.y};
}

// The stream gains of user k: sigma^2 of T = Hk - W^H tilde (Nr_u = 1:
// |T|^2; Nr_u = 2: the two eigenvalues of T T^H, descending), written to
// gains[NR k ...]. The user loop is unrolled, so k and the rows' offsets
// are constants; the two column loops stay rolled.
template <int K, int NR>
__device__ __forceinline__ void user_gains(const float2* col, int k,
                                           float (&gains)[K * NR]) {
  constexpr int NT = K * NR;
  constexpr int M = (K - 1) * NR;
  // the entry of column 0 of each row of tilde (the other users' rows, in
  // order) and of the user's own rows
  int trow[M], hrow[NR];
#pragma unroll
  for (int t = 0; t < M; ++t) trow[t] = (t < k * NR ? t : t + NR) * NT;
#pragma unroll
  for (int s = 0; s < NR; ++s) hrow[s] = (NR * k + s) * NT;

  // B = tilde tilde^H (gram_full) and Y = Hk tilde^H (mat_mul), each entry
  // summed over the columns in order (from 0, and 0 + x is x)
  cf B[M][M], Y[NR][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) B[i][j] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < NR; ++r) Y[r][i] = {0.f, 0.f};
  }
#pragma unroll 1  // columns
  for (int c = 0; c < NT; ++c) {
    cf tl[M], hk[NR];
#pragma unroll
    for (int t = 0; t < M; ++t) tl[t] = load_h(col, trow[t] + c);
#pragma unroll
    for (int s = 0; s < NR; ++s) hk[s] = load_h(col, hrow[s] + c);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i; j < M; ++j) {
        B[i][j] = planes::cadd(B[i][j], planes::cmulc(tl[i], tl[j]));
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        Y[r][i] = planes::cadd(Y[r][i],
                               planes::cmul(hk[r], planes::cconj(tl[i])));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i + 1; j < M; ++j) B[j][i] = planes::cconj(B[i][j]);
  }
  cf Y_h[M][NR];
  planes::mat_H<NR, M>(Y, Y_h);
  cf W[M][NR];
  planes::herm_solve_cols_ldl<M, NR>(B, Y_h, W);

  // T column by column, added at once into its Gram (gram_rows) or |T|^2
  float p = 0.f, r = 0.f;
  cf q = {0.f, 0.f};
#pragma unroll 1  // columns
  for (int c = 0; c < NT; ++c) {
    cf tl[M];
#pragma unroll
    for (int t = 0; t < M; ++t) tl[t] = load_h(col, trow[t] + c);
    cf T[NR];
#pragma unroll
    for (int s = 0; s < NR; ++s) {
      cf acc = planes::cmul(planes::cconj(W[0][s]), tl[0]);
#pragma unroll
      for (int t = 1; t < M; ++t) {
        acc = planes::cadd(acc, planes::cmul(planes::cconj(W[t][s]), tl[t]));
      }
      T[s] = planes::csub(load_h(col, hrow[s] + c), acc);
    }
    p = p + planes::cabs2(T[0]);
    if constexpr (NR == 2) {
      r = r + planes::cabs2(T[1]);
      q = planes::cadd(q, planes::cmulc(T[0], T[1]));
    }
  }
  float g0 = fmaxf(p, 0.f), g1 = 0.f;  // sigma^2
  if constexpr (NR == 2) {
    float l0, l1;
    planes::herm2_eigvals(p, q, r, l0, l1);
    g0 = fmaxf(l0, 0.f);  // descending
    g1 = fmaxf(l1, 0.f);
  }
#pragma unroll
  for (int i = 0; i < K * NR; ++i) {
    gains[i] = i == NR * k ? g0 : (NR == 2 && i == NR * k + 1 ? g1 : gains[i]);
  }
}

// Sum capacity of one element (0 for a degenerate draw): _solve_block +
// _guarded of bd_pallas.py, in the same order.
template <int K, int NR, int MODE>
__device__ __forceinline__ float solve_element(const float2* col, float nv,
                                               float ipu) {
  constexpr int NS = K * NR;  // streams
  float gains[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) gains[i] = 0.f;
#pragma unroll  // users
  for (int k = 0; k < K; ++k) user_gains<K, NR>(col, k, gains);

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
__global__ void __launch_bounds__(kThreads, min_blocks<K * NR>())
    mc_bd_kernel(const Params p) {
  constexpr int NT = K * NR;
  constexpr int P = 2 * NT * NT;
  constexpr int CALLS = P / 4;
  static_assert(P % 4 == 0, "a Philox call fills two whole entries");
  extern __shared__ float2 s_H[];  // (NT * NT, kThreads)
  __shared__ float s_warp_sum[kThreads / 32];
  float2* const col = s_H + threadIdx.x;  // this thread's element
  const int cell = blockIdx.x / p.parts;   // rep * num_tiles + tile
  const int part = blockIdx.x % p.parts;
  const int rep = cell / p.num_tiles;
  const int tile_idx = cell % p.num_tiles;
  const unsigned long long attempt =
      (unsigned long long)(p.start + (long long)rep);
  const uint32_t att_lo = (uint32_t)attempt;
  const uint32_t att_hi = (uint32_t)(attempt >> 32);
  const int elems = p.tile * p.lane;

  const int e = part * kThreads + threadIdx.x;
  float acc = 0.f;
  if (e < elems) {
    // entry en of the element: planes 2 en (re) and 2 en + 1 (im)
    if (kInject) {
      const int r = e / p.lane;
      const int l = e - r * p.lane;
      const int* row = p.bits + rep * p.rep_stride +
                       (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll 1
      for (int en = 0; en < NT * NT; ++en) {
        col[en * kThreads] =
            make_float2(bits_half_normal((uint32_t)row[(2 * en) * p.lane]),
                        bits_half_normal((uint32_t)row[(2 * en + 1) * p.lane]));
      }
    } else {
#pragma unroll 1  // Philox calls
      for (int j = 0; j < CALLS; ++j) {
        const uint4 x = philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j), att_lo,
                       att_hi),
            make_uint2(p.seed, kChannelKey));
        col[(2 * j) * kThreads] =
            make_float2(bits_half_normal(x.x), bits_half_normal(x.y));
        col[(2 * j + 1) * kThreads] =
            make_float2(bits_half_normal(x.z), bits_half_normal(x.w));
      }
    }
    acc = solve_element<K, NR, MODE>(col, p.nv, p.ipu);
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
int launch_one(const Params& p, int blocks, cudaStream_t s) {
  constexpr int bytes = smem_bytes<K * NR>();
  if (bytes > kStaticSmemLimit) {
    const cudaError_t rc = cudaFuncSetAttribute(
        mc_bd_kernel<K, NR, MODE, kInject>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  mc_bd_kernel<K, NR, MODE, kInject><<<blocks, kThreads, bytes, s>>>(p);
  return 0;
}

template <int K, int NR, bool kInject>
int launch_mode(const Params& p, int mode, int blocks, cudaStream_t s) {
  switch (mode) {
    case kNormalized:
      return launch_one<K, NR, kNormalized, kInject>(p, blocks, s);
    case kGlobal:
      return launch_one<K, NR, kGlobal, kInject>(p, blocks, s);
    case kNone:
      return launch_one<K, NR, kNone, kInject>(p, blocks, s);
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
  p.parts = (p.tile * p.lane + kThreads - 1) / kThreads;
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
  return (tile * lane + kThreads - 1) / kThreads;
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
