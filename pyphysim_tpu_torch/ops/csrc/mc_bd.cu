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
// 255 registers a thread (288 floats at (7, 2)). A one-thread form that
// kept the whole state in a per-thread column of shared memory fitted 2
// warps a SM at (7, 2) and summed every user's B and Y anew from H (134,302
// operations a solve against the function's 66,094). So the wide form
// splits an element over a group of lanes and sums its Gram once
// (wide.cuh holds the storage rule and the group's helpers):
//   * the Gram once: the group sums G = H H^H (its lower triangle; lane a
//     its rows a, each entry over the columns in order), and every user's B
//     (G over the other users' rows) and Y^H (G over those rows and the
//     user's own) are read from it: the 66,094 operations a solve at
//     (7, 2) that chip_smoke.py's bd_solve_flops counts. T = Hk - W^H tilde
//     stays explicit (H's columns read from the slot): T T^H as
//     Hk Hk^H - Y W would cancel in float32;
//   * a user's solve on Lu lanes (lane gu holding rows gu, gu + Lu, ... of
//     B, its factor and X, and those columns of T): the LDL^H and both
//     substitutions of wide::group_ldl_solve, column by column with a
//     __syncwarp a step, every sum over q in the plain version's order; the
//     back substitution sums from the last column down and T's Gram over
//     the columns as a butterfly (rounding only); complex multiply-adds are
//     fused chains (wide::cmac ...). U users at once on U sub-groups of the
//     element's group (the Lu and U rule is at struct Wide);
//   * the state (H, G's lower triangle, a factor and W a sub-group) in the
//     element's slot of the block's shared memory; past 227 KB a block, of
//     the scratch buffer (mc_bd_scratch_bytes says how large), first at
//     (61, 2). The solve is unrolled over M, so its code and build time
//     grow with M^2: bin/probe_wide_builds.py (NVIDIA H100 80GB HBM3, 700
//     W) built (16, 2) in 52 s at 255 registers and 4 bytes of spill,
//     (24, 2) in 89 s (444 B, 4 warps a SM), (32, 2) 111 s (~1 KB, 2),
//     (48, 2) 183 s (~2.5 KB, 1; 333 ms for 4,096 solves) and (61, 2), in
//     the scratch buffer, 274 s (9-12 KB; 952 ms for 4,096 solves), each
//     right; past (11, 2) a lane's rows want a loop, not an unrolled
//     slot list (ROADMAP.md);
//   * the water-filling and the guard are the menu form's, run alike on
//     every lane of the group.
// What bounds it (inferred from the timings below; the issue mix is not
// profiled): instruction issue, with lanes idle in the triangles of the
// factor and the substitutions. A step's broadcast load, pivot and
// shuffles cost every lane once whatever rows it holds, so more rows a lane
// pay less for them (a step skips, at compile time, a slot with no row in
// play); the work done once an element (the Philox draws, the Gram, the
// water-filling run on each lane) costs less with more elements a warp.
// bin/tune_wide_kernel.py measured it (NVIDIA H100 80GB HBM3, 700 W, 128
// reps x 4 tiles x 8 x 512 PRNG solves): at (7, 2), 4 lanes a user and one
// user at once (4 rows a lane, 8 elements a warp, shared memory for 8
// warps a SM) 12.46 ms; 8 lanes a user 16.29 ms and 4 users at once
// 16.90 ms, each at 16 warps a SM; the one-thread form 63.59 ms. So Lu is
// the power of two (at least 4) that leaves a lane at most 4 rows, and U
// the fewest users that leave shared memory for 8 warps a SM (2 at (8, 2)
// and (11, 2)). chip_smoke.py prints each instance's registers, spills,
// shared bytes and resident warps and holds the kernel to its plain
// version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The wide form's plan. A group of L = U Lu lanes an element: all L sum the
// element's Gram (lane g holding rows g, g + L, ...: RG of them), then the
// group's U sub-groups of Lu lanes solve U users at once (users u, u + U,
// ... on sub-group u), lane gu of a sub-group holding rows (and columns)
// gu, gu + Lu, ... (R of them) of its user's factor and T. Lu is
// the power of two (at least 4) that leaves each lane at most 4 rows, and U
// the fewest users (a power of two within a warp) whose warps' state leaves
// shared memory for wide::kRoomWarps warps a SM: a user more at once costs
// each element more of the work it does once (the draw, the Gram, the
// water-filling, run by a wider group), which bin/tune_wide_kernel.py
// measured to outweigh the warps it adds (the note at the head). The
// element's state is a slot of the block's memory, in float2 entries:
//   H  at kH: NT x NT, row-major (entry a NT + c);
//   G  at kG: the Gram H H^H, its lower triangle packed by columns (entry
//      G[a][b], a >= b, at kG + gl(a, b)): a column of G is contiguous, so
//      the rows of a group read it without conflicts;
//   then for each sub-group u, at kSub + u kSubEntries:
//   L  the LDL^H factor of its user's B, strictly lower, packed by rows
//      (wide::tri; wide::group_ldl_solve);
//   W  at kW (even, for 16-byte loads of a row): W = B^-1 Y^H spread over
//      the NT rows of H (NT x NR; 0 on the user's own rows), read by the
//      sub-group as T is formed.
template <int K, int NR>
struct Wide {
  static constexpr int NT = K * NR;
  static constexpr int M = (K - 1) * NR;
  static constexpr int Lu = wide::lanes_for((NT + 3) / 4, 4);
  static constexpr int R = (NT + Lu - 1) / Lu;
  static constexpr int kH = 0;
  static constexpr int kG = NT * NT;
  static constexpr int kSub = (kG + NT * (NT + 1) / 2 + 1) / 2 * 2;
  static constexpr int kW = (M * (M - 1) / 2 + 1) / 2 * 2;  // in a sub-slot
  static constexpr int kSubEntries = kW + NT * NR;
  // a warp's state bytes with u users at once
  static constexpr long long warp_bytes(int u) {
    return (long long)(32 / (u * Lu)) *
           wide::group_stride(kSub + u * kSubEntries, u * Lu) *
           (long long)sizeof(float2);
  }
  static constexpr int default_users() {
    int u = 1;
    while (!wide::leaves_room(warp_bytes(u)) && 2 * u * Lu <= 32 && u < K) {
      u *= 2;
    }
    return u;
  }
  static constexpr int U = default_users();
  static constexpr int L = U * Lu;  // lanes an element
  static constexpr int RG = (NT + L - 1) / L;
  static constexpr int kPerWarp = 32 / L;  // elements a warp
  static constexpr int kEntries = kSub + U * kSubEntries;
  static constexpr int kStride = wide::group_stride(kEntries, L);
  static constexpr int kWarps =
      wide::group_warps((long long)kPerWarp * kStride * sizeof(float2));
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kElems = kPerWarp * kWarps;  // elements a block
  static constexpr long long kBytes =
      (long long)kElems * kStride * (long long)sizeof(float2);
  static constexpr bool kGlobal = wide::in_scratch(kBytes);
  static_assert(Lu >= NR * NR && L <= 32 && (Lu & (Lu - 1)) == 0 &&
                    (U & (U - 1)) == 0,
                "lanes: powers of two, at most a warp");

  // G[a][b] (a >= b) in the packed lower triangle
  __device__ static constexpr int gl(int a, int b) {
    return b * NT - b * (b - 1) / 2 + (a - b);
  }
};

// Row t of tilde (the other users' rows of H, in order) for user rows from
// own on.
template <int NR>
__device__ __forceinline__ int other_row(int t, int own) {
  return t < own ? t : t + NR;
}

// The stream gains of user k into gains (k a run-time index) from the
// element's Gram, on the Lu lanes of a sub-group (lane gu; sub, its slot
// area): B = G over the other users' rows, X = Y^H = G over (other, own)
// rows, W = B^-1 X by the sub-group's LDL^H (X rows over the lanes), then T
// = Hk - W^H tilde on the lane's columns (the sum over the rows of tilde in
// order, H read from the slot; the user's own rows add W's zeros, exactly)
// and its Gram (p, q, r) or |T|^2: each lane's columns in order, then a
// butterfly over the sub-group (a fixed tree where the plain version sums
// the columns in order). `store` false: the sub-group has no user this
// round (it solves user k all the same and keeps nothing).
template <int K, int NR>
__device__ __forceinline__ void user_gains_group(float2* st, float2* sub,
                                                 int gu, int k, bool store,
                                                 float (&gains)[K * NR]) {
  using G = Wide<K, NR>;
  constexpr int NT = G::NT, M = G::M, Lu = G::Lu, R = G::R;
  using wide::ld;
  // G[a][b] for any a, b (the upper triangle as the lower's conjugate)
  auto gram = [&](int a, int b) {
    const cf v = ld(st, G::kG + G::gl(a > b ? a : b, a > b ? b : a));
    return a >= b ? v : planes::cconj(v);
  };
  const int own = NR * k;  // the user's first row of H
  cf x[R][NR];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = gu + r * Lu < M ? gu + r * Lu : M - 1;
    const int oi = other_row<NR>(i, own);
#pragma unroll
    for (int s = 0; s < NR; ++s) x[r][s] = gram(oi, own + s);
  }
  wide::group_ldl_solve<M, Lu, R, NR>(
      sub, gu,
      [&](int r, int j) {
        const int i = gu + r * Lu < M ? gu + r * Lu : M - 1;
        return gram(other_row<NR>(i, own), other_row<NR>(j, own));
      },
      [&](int j) {
        const int oj = other_row<NR>(j, own);
        return ld(st, G::kG + G::gl(oj, oj)).re;
      },
      x);
  // W over the rows of H: the solution on the other users' rows, 0 on the
  // user's own
  float2* const w_rows = sub + G::kW;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = gu + r * Lu;
    if (i < M) {
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        wide::st2(w_rows, other_row<NR>(i, own) * NR + s, x[r][s]);
      }
    }
  }
  if (gu < NR * NR) wide::st2(w_rows, own * NR + gu, {0.f, 0.f});
  __syncwarp();
  float pp = 0.f, rr = 0.f;
  cf qq = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = gu + r * Lu;
    const int cr = c < NT ? c : NT - 1;
    cf acc[NR];
#pragma unroll
    for (int a = 0; a < NT; ++a) {
      cf w[NR];
      if constexpr (NR == 2) {
        wide::ld_pair(w_rows, 2 * a, w[0], w[1]);
      } else {
        w[0] = ld(w_rows, a);
      }
      const cf h = ld(st, G::kH + a * NT + cr);
#pragma unroll
      for (int s = 0; s < NR; ++s) {
        acc[s] = a == 0 ? planes::cmulc(h, w[s]) : wide::cmacc(acc[s], h, w[s]);
      }
    }
    if (c < NT) {
      const cf t0 = planes::csub(ld(st, G::kH + own * NT + c), acc[0]);
      pp = pp + planes::cabs2(t0);
      if constexpr (NR == 2) {
        const cf t1 = planes::csub(ld(st, G::kH + (own + 1) * NT + c), acc[1]);
        rr = rr + planes::cabs2(t1);
        qq = planes::cadd(qq, planes::cmulc(t0, t1));
      }
    }
  }
  pp = wide::group_sum<Lu>(pp);
  if constexpr (NR == 2) {
    rr = wide::group_sum<Lu>(rr);
    qq = {wide::group_sum<Lu>(qq.re), wide::group_sum<Lu>(qq.im)};
  }
  if (store) store_gains<K, NR>(pp, qq, rr, k, gains);
  __syncwarp();
}

// One element's sum capacity on its group (the same value on every lane):
// _solve_block + _guarded of bd_pallas.py, with every user's B and Y read from
// the element's one Gram G = H H^H.
template <int K, int NR, int MODE>
__device__ __forceinline__ float solve_element_group(float2* st, int g,
                                                     float nv, float ipu) {
  using G = Wide<K, NR>;
  constexpr int NT = G::NT, L = G::L, Lu = G::Lu, U = G::U, RG = G::RG;
  using wide::ld;
  // G = H H^H, its lower triangle: the lane's rows a of H in registers, each
  // entry G[a][b] (b <= a) summed over the columns in order by fused
  // multiply-adds (row b read by the whole group at once); a slot's loop
  // ends at its last row
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const int a = g + r * L;
    const int ar = a < NT ? a : NT - 1;
    const int last = (r * L + L < NT ? r * L + L : NT) - 1;
    cf ha[NT];
#pragma unroll
    for (int c = 0; c < NT; ++c) ha[c] = ld(st, G::kH + ar * NT + c);
#pragma unroll 1
    for (int b = 0; b <= last; ++b) {
      cf hb[NT];
      if constexpr (NT % 2 == 0) {
#pragma unroll
        for (int c = 0; c < NT; c += 2) {
          wide::ld_pair(st, G::kH + b * NT + c, hb[c], hb[c + 1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < NT; ++c) hb[c] = ld(st, G::kH + b * NT + c);
      }
      cf acc = planes::cmulc(ha[0], hb[0]);
#pragma unroll
      for (int c = 1; c < NT; ++c) acc = wide::cmacc(acc, ha[c], hb[c]);
      if (b <= a && a < NT) wide::st2(st, G::kG + G::gl(a, b), acc);
    }
  }
  __syncwarp();
  // the users, U at once (a round's spare sub-groups solve the last user
  // again and keep nothing); each gain is then on one sub-group's lanes and
  // 0 on the others', so a butterfly across the sub-groups gathers it
  // exactly
  const int u = g / Lu, gu = g % Lu;
  float2* const sub = st + G::kSub + u * G::kSubEntries;
  float gains[K * NR];
#pragma unroll
  for (int i = 0; i < K * NR; ++i) gains[i] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += U) {
    const int k = k0 + u;
    user_gains_group<K, NR>(st, sub, gu, k < K ? k : K - 1, k < K, gains);
  }
  if constexpr (U > 1) {
#pragma unroll
    for (int i = 0; i < K * NR; ++i) {
#pragma unroll
      for (int off = L / 2; off >= Lu; off >>= 1) {
        gains[i] += __shfl_xor_sync(0xffffffffu, gains[i], off, L);
      }
    }
  }
  return capacity_of_gains<K, NR, MODE>(gains, nv, ipu);
}

// The wide form: a group of Wide::L lanes an element, Wide::kElems elements
// a block, the block walking blocks vb = blockIdx.x, + gridDim.x, ... of the
// launch (one trip unless the state is in the scratch buffer), partial[vb]
// its elements' sum: each warp's group leaders by a shuffle tree, then the
// warps in order.
template <int K, int NR, int MODE, bool kInject>
__global__ void __launch_bounds__(Wide<K, NR>::kThreads)
    mc_bd_wide_kernel(const Params p) {
  using G = Wide<K, NR>;
  constexpr int NT = G::NT, L = G::L;
  extern __shared__ float4 s_state[];
  __shared__ float s_warp_sum[G::kWarps];
  float2* const slot =
      G::kGlobal ? p.scratch + (long long)blockIdx.x * G::kElems * G::kStride
                 : reinterpret_cast<float2*>(s_state);
  const int g = threadIdx.x % L;       // the lane in its group
  const int grp = threadIdx.x / L;     // the element in the block
  float2* const st = slot + grp * G::kStride;
  const int elems = p.tile * p.lane;
#pragma unroll 1
  for (int vb = blockIdx.x; vb < p.blocks; vb += gridDim.x) {
    const int cell = vb / p.parts;  // rep * num_tiles + tile
    const int part = vb % p.parts;
    const int rep = cell / p.num_tiles;
    const int tile_idx = cell % p.num_tiles;
    const int e = part * G::kElems + grp;
    const bool valid = e < elems;
    __syncwarp();  // the previous trip's reads of the slot are done
    if (valid) {
      wide::draw_entries<L, kInject>(p, st + G::kH, g, e, rep, tile_idx,
                                     NT * NT, kChannelKey);
    }
    __syncwarp();
    // every group solves (an element past the end on whatever its slot
    // holds: the warp's lanes stay together) and only valid ones count
    const float cap = solve_element_group<K, NR, MODE>(st, g, p.nv, p.ipu);
    wide::block_partial<G::kWarps>((valid && g == 0) ? cap : 0.f, s_warp_sum,
                                   p.partial + vb);
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
                      Wide<K, NR>::kBytes, Wide<K, NR>::kThreads, s);
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

// Elements a block: kThreads, or the wide form's.
constexpr int block_elems() {
#ifdef MC_BD_K
  if constexpr (kWideForm) return Wide<MC_BD_K, MC_BD_NR>::kElems;
#endif
  return kThreads;
}

int num_parts(int tile, int lane) {
  return (tile * lane + block_elems() - 1) / block_elems();
}

int launch(Params& p, float* out, int reps, int K, int NR, int mode,
           bool inject, void* stream) {
  if (reps < 1 || p.num_tiles < 1 || p.tile < 1 || p.lane < 1) {
    return (int)cudaErrorInvalidValue;
  }
  p.parts = num_parts(p.tile, p.lane);
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

template <int kK, int kNR>
struct Geo {
  static constexpr int K = kK, NR = kNR;
};

}  // namespace

// Partials per (rep, tile) cell: the wrapper's scratch holds
// reps * num_tiles * mc_bd_num_parts(tile, lane) floats.
extern "C" int mc_bd_num_parts(int tile, int lane) {
  return num_parts(tile, lane);
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

// How geometry (K, NR) launches in mode `mode` (PRNG) on the current
// device: wide::launch_info's six ints in info (threads a block, dynamic
// shared bytes a block, elements a block, lanes an element, 1 if the state
// is in the scratch buffer, resident blocks a SM). Returns a CUDA error code
// (cudaErrorInvalidValue for a geometry this library does not hold).
extern "C" int mc_bd_launch_info(int K, int NR, int mode, int* info) {
  int rc = (int)cudaErrorInvalidValue;
  auto one = [&](auto kernel, int threads, long long bytes, int elems,
                 int lanes) {
    rc = wide::launch_info(kernel, threads, bytes, elems, lanes, info);
  };
  auto modes = [&](auto k_nr, auto tile_form) {
    constexpr int kK = decltype(k_nr)::K, kNR = decltype(k_nr)::NR;
    (void)tile_form;
    auto pick = [&](auto m) {
      constexpr int kM = decltype(m)::value;
      if constexpr (decltype(tile_form)::value) {
        one(mc_bd_kernel<kK, kNR, kM, false>, kThreads,
            smem_bytes<kK * kNR>(), kThreads, 1);
      } else {
        using G = Wide<kK, kNR>;
        one(mc_bd_wide_kernel<kK, kNR, kM, false>, G::kThreads, G::kBytes,
            G::kElems, G::L);
      }
    };
    if (mode == kNormalized) pick(std::integral_constant<int, kNormalized>{});
    if (mode == kGlobal) pick(std::integral_constant<int, kGlobal>{});
    if (mode == kNone) pick(std::integral_constant<int, kNone>{});
  };
#ifdef MC_BD_K
  if (K == MC_BD_K && NR == MC_BD_NR) {
    modes(Geo<MC_BD_K, MC_BD_NR>{},
          std::integral_constant<bool, !kWideForm>{});
  }
#else
  using T = std::true_type;
  if (K == 2 && NR == 1) modes(Geo<2, 1>{}, T{});
  if (K == 2 && NR == 2) modes(Geo<2, 2>{}, T{});
  if (K == 3 && NR == 2) modes(Geo<3, 2>{}, T{});
  if (K == 4 && NR == 1) modes(Geo<4, 1>{}, T{});
  if (K == 4 && NR == 2) modes(Geo<4, 2>{}, T{});
#endif
  return rc;
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
