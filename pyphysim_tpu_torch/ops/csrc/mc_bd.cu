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
//   * (K, Nr_u) and the mode are template parameters: the prebuilt
//     library holds the five geometries below, and any other is built on
//     its first use with -DMC_BD_K=.. -DMC_BD_NR=.. (ops/_build.py): in
//     this form while NT <= kTileFormMaxNt (the prebuilt (4, 2)'s NT;
//     odd NT leaves the last Philox call of an element half used), else
//     in the wide form at the end of this note (-DMC_BD_WIDE=1 asks for
//     the wide form at any NT, so that the two can be compared).
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
//
// The wide form (mc_bd_wide_kernel, geometries built on first use above
// NT = kTileFormMaxNt). There the design above breaks: H alone takes NT^2
// KB a block of 128 threads (196 KB at (7, 2), 256 KB at (8, 2), past the
// 227 KB a block may opt in to), and B, M x M complex, no longer fits in
// 255 registers a thread (288 floats at (7, 2)). So the wide form
// (wide.cuh):
//   * runs one element a thread in blocks of ONE warp, and keeps the whole
//     state of an element in a per-thread column, entry n at col[n * 32]:
//     H (NT^2), B (M^2; L and (D, 1/D) overwrite it in place) and the
//     right-hand side X (M x Nr_u, W = B^-1 Y^H when solved). A warp's
//     access to an entry is 256 consecutive bytes, free of bank conflicts;
//   * the column lives in dynamic shared memory while a warp's columns fit
//     (kState x 256 B <= 227 KB: up to (10, 2) and (21, 1)); past that in
//     the scratch buffer of wide.cuh (mc_bd_scratch_bytes says how large);
//     loads stay coalesced, and L1 / L2 hold the hot rows;
//   * every loop over users, rows of B and the LDL^H steps is rolled
//     (run-time offsets), so the code stays small at any K; the loops over
//     the NT columns of a row are unrolled with the row in registers (the
//     sums of B and Y read one entry of shared memory per complex
//     multiply-add, the projection T keeps its Nr_u x NT sums in
//     registers). Sums run in the order of the plain version, as above;
//   * the water-filling and the guard are the menu form's.
// What bounds it: shared-memory traffic, one 8-byte load a complex
// multiply-add (a SM serves 16 of them a clock against 32 complex FMAs),
// then the solve's f32 operations. chip_smoke.py prints each instance's
// registers and spills and holds the kernel to its plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"
#include "wide.cuh"

namespace {

using planes::cf;

constexpr int kThreads = 128;  // one element a thread
constexpr int kTileFormMaxNt = 8;  // the largest NT of mc_bd_kernel
constexpr int kStaticSmemLimit = 48 * 1024;
#ifdef MC_BD_K
#ifndef MC_BD_WIDE
#define MC_BD_WIDE 0
#endif
// a library of one geometry: mc_bd_kernel, or the wide form above its NT
constexpr bool kWideForm = MC_BD_WIDE || MC_BD_K * MC_BD_NR > kTileFormMaxNt;
#else
constexpr bool kWideForm = false;
#endif
constexpr int kBlockThreads = kWideForm ? wide::kThreads : kThreads;
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
  float2* scratch;  // the wide form past shared memory: its state slots
  int blocks;       // blocks of the whole launch (the wide form walks them)
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

// The stream gains of user k from the Gram of its projection T (p, q, r;
// Nr_u = 1: p = |T|^2), written to gains[NR k ...] (k may be a run-time
// index: the gains stay in registers).
template <int K, int NR>
__device__ __forceinline__ void store_gains(float p, cf q, float r, int k,
                                            float (&gains)[K * NR]) {
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
  store_gains<K, NR>(p, q, r, k, gains);
}

// Sum capacity of one element from its stream gains (0 for a degenerate
// draw): the water-filling of _solve_block and _guarded of bd_pallas.py,
// in the same order.
template <int K, int NR, int MODE>
__device__ __forceinline__ float capacity_of_gains(
    const float (&gains)[K * NR], float nv, float ipu) {
  constexpr int NS = K * NR;  // streams
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

// Sum capacity of one element (0 for a degenerate draw): _solve_block +
// _guarded of bd_pallas.py, in the same order.
template <int K, int NR, int MODE>
__device__ __forceinline__ float solve_element(const float2* col, float nv,
                                               float ipu) {
  float gains[K * NR];
#pragma unroll
  for (int i = 0; i < K * NR; ++i) gains[i] = 0.f;
#pragma unroll  // users
  for (int k = 0; k < K; ++k) user_gains<K, NR>(col, k, gains);
  return capacity_of_gains<K, NR, MODE>(gains, nv, ipu);
}

template <int K, int NR, int MODE, bool kInject>
__global__ void __launch_bounds__(kThreads, min_blocks<K * NR>())
    mc_bd_kernel(const Params p) {
  constexpr int NT = K * NR;
  constexpr int P = 2 * NT * NT;
  constexpr int CALLS = (P + 3) / 4;  // odd NT: the last fills one entry
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
#pragma unroll 1  // Philox calls that fill two entries
      for (int j = 0; j < P / 4; ++j) {
        const uint4 x = philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j), att_lo,
                       att_hi),
            make_uint2(p.seed, kChannelKey));
        col[(2 * j) * kThreads] =
            make_float2(bits_half_normal(x.x), bits_half_normal(x.y));
        col[(2 * j + 1) * kThreads] =
            make_float2(bits_half_normal(x.z), bits_half_normal(x.w));
      }
      if constexpr (P % 4 != 0) {
        constexpr int j = P / 4;
        const uint4 x = philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j), att_lo,
                       att_hi),
            make_uint2(p.seed, kChannelKey));
        col[(2 * j) * kThreads] =
            make_float2(bits_half_normal(x.x), bits_half_normal(x.y));
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

// ---- the wide form ------------------------------------------------------

// The per-thread column of the wide form: H, then B, then X.
template <int K, int NR>
struct Wide {
  static constexpr int NT = K * NR;
  static constexpr int M = (K - 1) * NR;
  static constexpr int kB = NT * NT;     // B's first entry
  static constexpr int kX = kB + M * M;  // X's first entry
  static constexpr int kState = kX + M * NR;
  static constexpr long long kBytes =
      (long long)kState * wide::kThreads * (long long)sizeof(float2);
  static constexpr bool kGlobal = wide::in_scratch(kBytes);
};

__device__ __forceinline__ cf wload(const float2* col, int n) {
  const float2 v = col[n * wide::kThreads];
  return {v.x, v.y};
}

__device__ __forceinline__ void wstore(float2* col, int n, cf v) {
  col[n * wide::kThreads] = make_float2(v.re, v.im);
}

// user_gains for the wide form: the same sums in the same order, on the
// thread's column (H, B and X there); k is a run-time index.
template <int K, int NR>
__device__ __forceinline__ void user_gains_wide(float2* col, int k,
                                                float (&gains)[K * NR]) {
  using G = Wide<K, NR>;
  constexpr int NT = G::NT;
  constexpr int M = G::M;
  float2* const B = col + G::kB * wide::kThreads;
  float2* const X = col + G::kX * wide::kThreads;
  const int own = NR * k;  // the user's first row of H
  // B = tilde tilde^H (upper triangle) and X = Y^H with Y = Hk tilde^H,
  // row i of tilde (the other users' rows, in order) held in registers
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    const int hi = (i < own ? i : i + NR) * NT;
    cf ti[NT];
#pragma unroll
    for (int c = 0; c < NT; ++c) ti[c] = wload(col, hi + c);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int hr = (own + r) * NT;
      cf acc = planes::cmul(wload(col, hr), planes::cconj(ti[0]));
#pragma unroll
      for (int c = 1; c < NT; ++c) {
        acc = planes::cadd(
            acc, planes::cmul(wload(col, hr + c), planes::cconj(ti[c])));
      }
      wstore(X, i * NR + r, planes::cconj(acc));
    }
#pragma unroll 1
    for (int j = i; j < M; ++j) {
      const int hj = (j < own ? j : j + NR) * NT;
      cf acc = planes::cmulc(ti[0], wload(col, hj));
#pragma unroll
      for (int c = 1; c < NT; ++c) {
        acc = planes::cadd(acc, planes::cmulc(ti[c], wload(col, hj + c)));
      }
      wstore(B, i * M + j, acc);
    }
  }
  // LDL^H of B in place (planes::herm_solve_cols_ldl): L below the
  // diagonal, (D, 1/D) on it; B[i][j > i] above it, B[j][i] its conjugate
#pragma unroll 1
  for (int j = 0; j < M; ++j) {
    float d = wload(B, j * M + j).re;
#pragma unroll 1
    for (int q = 0; q < j; ++q) {
      d = d - planes::cabs2(wload(B, j * M + q)) * wload(B, q * M + q).re;
    }
    d = fmaxf(d, planes::kEps);
    const float dinv = 1.0f / d;
    wstore(B, j * M + j, {d, dinv});
#pragma unroll 1
    for (int i = j + 1; i < M; ++i) {
      cf acc = planes::cconj(wload(B, j * M + i));
#pragma unroll 1
      for (int q = 0; q < j; ++q) {
        acc = planes::csub(
            acc, planes::cscale(planes::cmulc(wload(B, i * M + q),
                                              wload(B, j * M + q)),
                                wload(B, q * M + q).re));
      }
      wstore(B, i * M + j, planes::cscale(acc, dinv));
    }
  }
  // forward substitution L z = X (unit diagonal)
#pragma unroll 1
  for (int i = 1; i < M; ++i) {
    cf x[NR];
#pragma unroll
    for (int t = 0; t < NR; ++t) x[t] = wload(X, i * NR + t);
#pragma unroll 1
    for (int j = 0; j < i; ++j) {
      const cf l = wload(B, i * M + j);
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        x[t] = planes::csub(x[t], planes::cmul(l, wload(X, j * NR + t)));
      }
    }
#pragma unroll
    for (int t = 0; t < NR; ++t) wstore(X, i * NR + t, x[t]);
  }
  // the diagonal scale, then back substitution L^H x = z
#pragma unroll 1
  for (int i = M - 1; i >= 0; --i) {
    const float dinv = wload(B, i * M + i).im;
    cf x[NR];
#pragma unroll
    for (int t = 0; t < NR; ++t) {
      x[t] = planes::cscale(wload(X, i * NR + t), dinv);
    }
#pragma unroll 1
    for (int j = i + 1; j < M; ++j) {
      const cf l = wload(B, j * M + i);
#pragma unroll
      for (int t = 0; t < NR; ++t) {
        x[t] = planes::csub(x[t], planes::cmulc(wload(X, j * NR + t), l));
      }
    }
#pragma unroll
    for (int t = 0; t < NR; ++t) wstore(X, i * NR + t, x[t]);
  }
  // T = Hk - W^H tilde: the sums over the rows of tilde for every column
  // at once in registers, then T column by column into its Gram
  cf acc[NR][NT];
  {
    const int h0 = (own > 0 ? 0 : NR) * NT;  // row 0 of tilde
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const cf h = wload(col, h0 + c);
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        acc[s][c] = planes::cmul(planes::cconj(wload(X, s)), h);
      }
    }
  }
#pragma unroll 1
  for (int t = 1; t < M; ++t) {
    const int ht = (t < own ? t : t + NR) * NT;
    cf w[NR];
#pragma unroll
    for (int s = 0; s < NR; ++s) w[s] = planes::cconj(wload(X, t * NR + s));
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const cf h = wload(col, ht + c);
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        acc[s][c] = planes::cadd(acc[s][c], planes::cmul(w[s], h));
      }
    }
  }
  float p = 0.f, r = 0.f;
  cf q = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const cf t0 = planes::csub(wload(col, own * NT + c), acc[0][c]);
    p = p + planes::cabs2(t0);
    if constexpr (NR == 2) {
      const cf t1 = planes::csub(wload(col, (own + 1) * NT + c), acc[1][c]);
      r = r + planes::cabs2(t1);
      q = planes::cadd(q, planes::cmulc(t0, t1));
    }
  }
  store_gains<K, NR>(p, q, r, k, gains);
}

template <int K, int NR, int MODE>
__device__ __forceinline__ float solve_element_wide(float2* col, float nv,
                                                    float ipu) {
  float gains[K * NR];
#pragma unroll
  for (int i = 0; i < K * NR; ++i) gains[i] = 0.f;
#pragma unroll 1  // users
  for (int k = 0; k < K; ++k) user_gains_wide<K, NR>(col, k, gains);
  return capacity_of_gains<K, NR, MODE>(gains, nv, ipu);
}

// The wide form: one element a thread, one warp a block, the block walking
// blocks vb = blockIdx.x, + gridDim.x, ... of the launch (one trip unless
// the state is in the scratch buffer), partial[vb] its elements' sum.
template <int K, int NR, int MODE, bool kInject>
__global__ void __launch_bounds__(wide::kThreads)
    mc_bd_wide_kernel(const Params p) {
  using G = Wide<K, NR>;
  constexpr int NT = G::NT;
  constexpr int CALLS = (2 * NT * NT + 3) / 4;  // two entries a call
  extern __shared__ float2 s_col[];  // (kState, wide::kThreads)
  float2* const slot =
      G::kGlobal
          ? p.scratch + (long long)blockIdx.x * G::kState * wide::kThreads
          : s_col;
  float2* const col = slot + threadIdx.x;  // this thread's element
  const int elems = p.tile * p.lane;
#pragma unroll 1
  for (int vb = blockIdx.x; vb < p.blocks; vb += gridDim.x) {
    const int cell = vb / p.parts;  // rep * num_tiles + tile
    const int part = vb % p.parts;
    const int rep = cell / p.num_tiles;
    const int tile_idx = cell % p.num_tiles;
    const int e = part * wide::kThreads + threadIdx.x;
    float acc = 0.f;
    if (e < elems) {
      if (kInject) {
        const int r = e / p.lane;
        const int l = e - r * p.lane;
        const int* row = p.bits + rep * p.rep_stride +
                         (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll 1
        for (int en = 0; en < NT * NT; ++en) {
          col[en * wide::kThreads] = make_float2(
              bits_half_normal((uint32_t)row[(long long)(2 * en) * p.lane]),
              bits_half_normal(
                  (uint32_t)row[(long long)(2 * en + 1) * p.lane]));
        }
      } else {
        const unsigned long long attempt =
            (unsigned long long)(p.start + (long long)rep);
#pragma unroll 1  // Philox calls; odd NT leaves the last one half used
        for (int j = 0; j < CALLS; ++j) {
          const uint4 x = philox4x32_10(
              make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j),
                         (uint32_t)attempt, (uint32_t)(attempt >> 32)),
              make_uint2(p.seed, kChannelKey));
          col[(2 * j) * wide::kThreads] =
              make_float2(bits_half_normal(x.x), bits_half_normal(x.y));
          if (2 * j + 1 < NT * NT) {
            col[(2 * j + 1) * wide::kThreads] =
                make_float2(bits_half_normal(x.z), bits_half_normal(x.w));
          }
        }
      }
      acc = solve_element_wide<K, NR, MODE>(col, p.nv, p.ipu);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (threadIdx.x == 0) p.partial[vb] = acc;
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
int launch_wide(const Params& p, cudaStream_t s) {
  return wide::launch(mc_bd_wide_kernel<K, NR, MODE, kInject>, p,
                      Wide<K, NR>::kBytes, s);
}

template <int K, int NR, int MODE, bool kInject>
int launch_one(const Params& p, int blocks, cudaStream_t s) {
  if constexpr (kWideForm) {
    return launch_wide<K, NR, MODE, kInject>(p, s);
  } else {
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

#ifdef MC_BD_K
// A library built for one geometry (ops/_build.py): that one.
template <bool kInject>
int launch_geometry(const Params& p, int K, int NR, int mode, int blocks,
                    cudaStream_t s) {
  if (K != MC_BD_K || NR != MC_BD_NR) return (int)cudaErrorInvalidValue;
  return launch_mode<MC_BD_K, MC_BD_NR, kInject>(p, mode, blocks, s);
}
#else
// The prebuilt library's geometries (K, Nr_u): (2,1), (2,2), (3,2), (4,1),
// (4,2).
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
#endif

int launch(Params& p, float* out, int reps, int K, int NR, int mode,
           bool inject, void* stream) {
  if (reps < 1 || p.num_tiles < 1 || p.tile < 1 || p.lane < 1) {
    return (int)cudaErrorInvalidValue;
  }
  p.parts = (p.tile * p.lane + kBlockThreads - 1) / kBlockThreads;
  const long long cells = (long long)reps * p.num_tiles;
  const long long blocks = cells * p.parts;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  p.blocks = (int)blocks;
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
  return (tile * lane + kBlockThreads - 1) / kBlockThreads;
}

// Bytes of the state buffer a launch of this library's geometry needs (the
// wide form past shared memory, on the current device), else 0; -1 if the
// device cannot be read.
extern "C" long long mc_bd_scratch_bytes(int reps, int num_tiles, int tile,
                                         int lane) {
#ifdef MC_BD_K
  if (!kWideForm) return 0;
  return wide::scratch_bytes(
      (long long)reps * num_tiles * mc_bd_num_parts(tile, lane),
      Wide<MC_BD_K, MC_BD_NR>::kBytes);
#else
  (void)reps, (void)num_tiles, (void)tile, (void)lane;
  return 0;
#endif
}

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the stream keyed by seed.
// mode: 0 normalized, 1 global, 2 none.
extern "C" int mc_bd_prng(void* out, void* partial, int reps, int num_tiles,
                          int tile, int lane, int K, int NR, int mode,
                          float ipu, float nv, unsigned int seed,
                          long long start, void* scratch, void* stream) {
  Params p = {};
  p.partial = static_cast<float*>(partial);
  p.scratch = static_cast<float2*>(scratch);
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
// [pl * lane, (pl + 1) * lane). scratch: mc_bd_scratch_bytes of device
// memory, or null where that is 0 (both entry points).
extern "C" int mc_bd_inject(const void* bits, void* out, void* partial,
                            int reps, int num_tiles, int tile, int lane, int K,
                            int NR, int mode, float ipu, float nv,
                            long long rep_stride, long long row_stride,
                            void* scratch, void* stream) {
  Params p = {};
  p.bits = static_cast<const int*>(bits);
  p.scratch = static_cast<float2*>(scratch);
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
