// The wide forms of the Monte Carlo kernels built for one geometry (mc_bd.cu,
// mc_ia.cu): where an element's state no longer fits one thread, and the one
// place where the storage rule lives.
//
// Two layouts share it:
//   * one element a thread (the IA closed body past K = 4): a block of one
//     warp, each element's state in a per-thread column at stride kThreads;
//   * a group of lanes an element (the BD wide form, the IA general body):
//     `lanes` lanes (a power of two, at most a warp) hold one element, a warp
//     32 / lanes elements, each element's state in a slot of its own of the
//     block's memory (group_stride entries apart, so that the groups of a
//     warp start on different banks). A group may split into sub-groups
//     that each solve one of the element's users (wide::group_ldl_solve and
//     the shuffles below take the sub-group's width). BD sizes its groups by
//     leaves_room, IA by a fixed rule; bin/tune_wide_kernel.py measured
//     both against more warps a SM (the notes of mc_bd.cu and mc_ia.cu).
// A block's state (slot_bytes) lives in dynamic shared memory while it fits in
// kMaxSmem (opted in above the 48 KB default); past that in a device scratch
// buffer that the wrapper allocates, one slot of the same layout per block of
// a grid of at most kSlotsPerSm blocks a SM that walks all the blocks of the
// launch.
#pragma once

#include <cuda_runtime.h>

#include "philox.cuh"
#include "planes.cuh"

namespace wide {

constexpr int kThreads = 32;          // one element a thread: one warp a block
constexpr int kMaxSmem = 232448;      // a block's opt-in limit, 227 KB
constexpr int kSlotsPerSm = 16;       // scratch slots a SM
constexpr int kMaxWarps = 4;          // warps a block of the lane-group layout
constexpr int kMaxLanes = 32;         // lanes an element at most (a warp)
constexpr int kBankSkew = 8;          // 4-byte words between groups' banks
constexpr int kRoomWarps = 8;         // warps a SM the BD plan leaves
                                      // shared memory for

// True if a block's state (slot_bytes) goes to the scratch buffer.
constexpr bool in_scratch(long long slot_bytes) {
  return slot_bytes > kMaxSmem;
}

// The power of two >= n within [lo, kMaxLanes]: lanes for n rows, one a
// lane (past kMaxLanes rows a lane holds several).
constexpr int lanes_for(int n, int lo) {
  int l = lo;
  while (l < n && l < kMaxLanes) l *= 2;
  return l;
}

// float2 entries from one element's slot to the next, for `entries` entries
// of state and `lanes` lanes an element: even (float4 loads), and with more
// than one element a warp kBankSkew words past a multiple of 32 banks, so
// that the groups of a warp read a broadcast entry from different banks.
constexpr int group_stride(int entries, int lanes) {
  return lanes == 32 ? (entries + 1) / 2 * 2
                     : (entries + 15) / 16 * 16 + kBankSkew / 2;
}

// True if kRoomWarps warps of warp_bytes of state each fit a block's shared
// memory.
constexpr bool leaves_room(long long warp_bytes) {
  return warp_bytes * kRoomWarps <= kMaxSmem;
}

// Warps a block of the lane-group layout: kMaxWarps, or as many as shared
// memory holds (at least one: past it the state goes to scratch).
constexpr int group_warps(long long warp_bytes) {
  return warp_bytes * kMaxWarps <= kMaxSmem ? kMaxWarps
         : warp_bytes * 2 <= kMaxSmem      ? 2
                                           : 1;
}

// Blocks of the grid: all of them, or past shared memory at most
// kSlotsPerSm a SM of the current device (0 if it cannot be read).
inline long long grid(long long blocks, long long slot_bytes) {
  if (!in_scratch(slot_bytes)) return blocks;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const long long slots = (long long)kSlotsPerSm * sms;
  return blocks < slots ? blocks : slots;
}

// Bytes of the scratch buffer a launch of `blocks` blocks needs: 0 while
// the state fits in shared memory, -1 if the device cannot be read.
inline long long scratch_bytes(long long blocks, long long slot_bytes) {
  if (!in_scratch(slot_bytes)) return 0;
  const long long g = grid(blocks, slot_bytes);
  return g < 1 ? -1 : g * slot_bytes;
}

// Dynamic shared bytes a block asks for: the slot, or 0 past shared memory;
// opts the kernel in above the 48 KB default. -1 on an error.
template <typename Kernel>
int opt_in(Kernel kernel, long long slot_bytes) {
  const int bytes = in_scratch(slot_bytes) ? 0 : (int)slot_bytes;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Launches kernel<<<grid, threads, smem>>>(p) with the state in shared
// memory or, past it, in p.scratch.
template <typename Params>
int launch(void (*kernel)(Params), const Params& p, long long slot_bytes,
           int threads, cudaStream_t s) {
  const long long g = grid(p.blocks, slot_bytes);
  if (g < 1 || (in_scratch(slot_bytes) && p.scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = opt_in(kernel, slot_bytes);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)g, threads, bytes, s>>>(p);
  return 0;
}

// What a launch of `kernel` looks like on the current device, for the C
// functions mc_*_launch_info: info[0] threads a block, [1] dynamic shared
// bytes a block, [2] elements a block, [3] lanes an element, [4] 1 if the
// state is in the scratch buffer, [5] resident blocks a SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <typename Kernel>
int launch_info(Kernel kernel, int threads, long long slot_bytes, int elems,
                int lanes, int* info) {
  const int bytes = opt_in(kernel, slot_bytes);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, threads, (size_t)bytes);
  info[0] = threads;
  info[1] = bytes;
  info[2] = elems;
  info[3] = lanes;
  info[4] = in_scratch(slot_bytes) ? 1 : 0;
  info[5] = blocks;
  return (int)rc;
}

// ---- the lane group ------------------------------------------------------
// A group of L lanes (L a power of two, at most 32) of one warp; lane g of
// the group (g = lane % L) holds rows g, g + L, ... (R = ceil(rows / L) of
// them). Every helper is called by all 32 lanes of the warp together.

using planes::cf;

__device__ __forceinline__ cf ld(const float2* st, int n) {
  const float2 v = st[n];
  return {v.x, v.y};
}

__device__ __forceinline__ void st2(float2* st, int n, cf v) {
  st[n] = make_float2(v.re, v.im);
}

// Entries n and n + 1 (n even, the slot 16-byte aligned) in one load.
__device__ __forceinline__ void ld_pair(const float2* st, int n, cf& a,
                                        cf& b) {
  const float4 v = *reinterpret_cast<const float4*>(st + n);
  a = {v.x, v.y};
  b = {v.z, v.w};
}

// Complex multiply-adds as chains of fused multiply-adds (4 FFMA where
// cadd(acc, cmul(a, b)) compiles to 6 instructions): acc + a b, acc + a
// conj(b), acc - a b, acc - a conj(b). Each rounds once a product term, not
// as the plain version's separate product and sum (a difference of
// rounding).
__device__ __forceinline__ cf cmac(cf acc, cf a, cf b) {
  return {fmaf(a.re, b.re, fmaf(-a.im, b.im, acc.re)),
          fmaf(a.re, b.im, fmaf(a.im, b.re, acc.im))};
}

__device__ __forceinline__ cf cmacc(cf acc, cf a, cf b) {
  return {fmaf(a.re, b.re, fmaf(a.im, b.im, acc.re)),
          fmaf(a.im, b.re, fmaf(-a.re, b.im, acc.im))};
}

__device__ __forceinline__ cf cmsub(cf acc, cf a, cf b) {
  return {fmaf(-a.re, b.re, fmaf(a.im, b.im, acc.re)),
          fmaf(-a.re, b.im, fmaf(-a.im, b.re, acc.im))};
}

__device__ __forceinline__ cf cmsubc(cf acc, cf a, cf b) {
  return {fmaf(-a.re, b.re, fmaf(-a.im, b.im, acc.re)),
          fmaf(-a.im, b.re, fmaf(a.re, b.im, acc.im))};
}

// Lane src's v, within each group of L lanes.
template <int L>
__device__ __forceinline__ float bcast(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src, L);
}

template <int L>
__device__ __forceinline__ cf bcast(cf v, int src) {
  return {bcast<L>(v.re, src), bcast<L>(v.im, src)};
}

// The sum of v over the group, by a butterfly: every lane ends with the same
// bits (each step adds the same two values on both lanes, and float addition
// commutes). The order is a fixed tree, not the sequential one.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off, L);
  }
  return v;
}

// True if slot r (rows r L .. r L + L - 1) of an M-row group of L lanes
// holds a row below pivot j.
__host__ __device__ constexpr bool slot_below(int r, int j, int L, int M) {
  return r * L + L - 1 > j && r * L < M;
}

// Entry (i, j), i > j, of a strictly lower triangle packed by rows.
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i - 1) / 2 + j;
}

// X = B^-1 X for a Hermitian positive-definite M x M B and C right-hand
// columns by the LDL^H of planes::herm_solve_cols_ldl, over a group of L
// lanes: lane g holds rows i = g + r L (r < R) of X (x[r]) and of the factor
// (Lr[r], in registers), and writes each factor entry L[i][j] to
// lsh[tri(i, j)] (the slot's M (M - 1) / 2 area) once it is known.
//   * b(r, j): B[i][j] of the lane's row i = g + r L (j < i; any value
//     elsewhere); diag(j): B[j][j].re (the same on every lane);
//   * the factor runs column by column (M steps, a __syncwarp each): every
//     lane computes the pivot d_j from the row of L it reads from lsh, and
//     its own rows' L[i][j]; each sum over q < j runs in order, as there,
//     a term L[i][q] (conj(L[j][q]) D[q]) by cmsub (the plain version
//     rounds (L[i][q] conj(L[j][q])) D[q]);
//   * forward substitution, column by column: x_j broadcast from its lane,
//     then x_i -= L[i][j] x_j on the rows below, j in order, as there;
//   * back substitution, column by column from the last: x_j broadcast,
//     then x_i -= x_j conj(L[j][i]) (read from lsh) on the rows above. The
//     sum over j runs from M - 1 down, the reverse of the plain version's
//     order (a difference of rounding only).
// A step skips, at compile time, the rows r L .. r L + L - 1 of a slot r
// when none of them can take part (below the pivot in the factor and the
// forward substitution, above it in the back substitution), so that with
// two or more rows a lane the triangles cost what they hold.
template <int M, int L, int R, int C, typename BRow, typename Diag>
__device__ __forceinline__ void group_ldl_solve(float2* lsh, int g,
                                                BRow&& b, Diag&& diag,
                                                cf (&x)[R][C]) {
  cf Lr[R][M];
  float D[M], dinv_own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dinv_own[r] = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float d = diag(j);
    cf acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (slot_below(r, j, L, M)) acc[r] = b(r, j);
    }
#pragma unroll
    for (int q = 0; q < j; ++q) {
      const cf ljq = ld(lsh, tri(j, q));  // broadcast: row j of L
      d = d - planes::cabs2(ljq) * D[q];
      const cf ljd = planes::cscale(planes::cconj(ljq), D[q]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (slot_below(r, j, L, M)) acc[r] = cmsub(acc[r], Lr[r][q], ljd);
      }
    }
    d = fmaxf(d, planes::kEps);
    D[j] = d;
    const float dinv = 1.0f / d;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g + r * L;
      if (slot_below(r, j, L, M)) {
        Lr[r][j] = planes::cscale(acc[r], dinv);
        if (i > j && i < M) st2(lsh, tri(i, j), Lr[r][j]);
      }
      if (r == j / L && i == j) dinv_own[r] = dinv;
    }
    __syncwarp();
  }
  // forward substitution L z = x (unit diagonal)
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    cf xj[C];
#pragma unroll
    for (int t = 0; t < C; ++t) xj[t] = bcast<L>(x[j / L][t], j % L);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g + r * L;
      if (slot_below(r, j, L, M) && i > j && i < M) {
#pragma unroll
        for (int t = 0; t < C; ++t) x[r][t] = cmsub(x[r][t], Lr[r][j], xj[t]);
      }
    }
  }
  // the diagonal scale, then back substitution L^H x = z
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int t = 0; t < C; ++t) x[r][t] = planes::cscale(x[r][t], dinv_own[r]);
  }
#pragma unroll
  for (int j = M - 1; j > 0; --j) {
    cf xj[C];
#pragma unroll
    for (int t = 0; t < C; ++t) xj[t] = bcast<L>(x[j / L][t], j % L);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g + r * L;
      if (r * L < j && i < j) {
        const cf l = ld(lsh, tri(j, i));
#pragma unroll
        for (int t = 0; t < C; ++t) x[r][t] = cmsubc(x[r][t], xj[t], l);
      }
    }
  }
}

// The `entries` complex channel entries of element e (tile tile_idx of
// repetition rep) into st[0, entries), split over the group's lanes: read
// from the bit tensor (entry n from planes 2 n and 2 n + 1) or drawn from the
// element's Philox calls (call j fills entries 2 j and 2 j + 1 from its four
// words; odd `entries` leaves the last call half used), as the one-thread
// forms draw them.
template <int L, bool kInject, typename Params>
__device__ __forceinline__ void draw_entries(const Params& p, float2* st,
                                             int g, int e, int rep,
                                             int tile_idx, int entries,
                                             uint32_t key) {
  if (kInject) {
    const int r = e / p.lane;
    const int l = e - r * p.lane;
    const int* row = p.bits + rep * p.rep_stride +
                     (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll 1
    for (int n = g; n < entries; n += L) {
      st[n] = make_float2(
          bits_half_normal((uint32_t)row[(long long)(2 * n) * p.lane]),
          bits_half_normal((uint32_t)row[(long long)(2 * n + 1) * p.lane]));
    }
  } else {
    const int calls = (entries + 1) / 2;
    const unsigned long long attempt =
        (unsigned long long)(p.start + (long long)rep);
#pragma unroll 1
    for (int j = g; j < calls; j += L) {
      const uint4 x = philox4x32_10(
          make_uint4((uint32_t)e, (uint32_t)(tile_idx * calls + j),
                     (uint32_t)attempt, (uint32_t)(attempt >> 32)),
          make_uint2(p.seed, key));
      st[2 * j] = make_float2(bits_half_normal(x.x), bits_half_normal(x.y));
      if (2 * j + 1 < entries) {
        st[2 * j + 1] =
            make_float2(bits_half_normal(x.z), bits_half_normal(x.w));
      }
    }
  }
}

// The block's elements summed in a fixed order into *out: each warp's lanes
// by a shuffle tree (acc is 0 but on the groups' first lanes), then the warps
// in order. Every thread of the block calls it.
template <int kWarps>
__device__ __forceinline__ void block_partial(float acc, float* s_warp_sum,
                                              float* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if constexpr (kWarps == 1) {
    if (threadIdx.x == 0) *out = acc;
  } else {
    if ((threadIdx.x & 31) == 0) s_warp_sum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = s_warp_sum[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s_warp_sum[w];
      *out = v;
    }
    __syncthreads();
  }
}

}  // namespace wide
