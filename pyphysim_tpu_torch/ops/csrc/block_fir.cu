// Block-static sparse-tap FIR, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/fir_pallas.py:block_fir (body
// _kernel). Row r of x (R, block_size) is convolved with its own sparse
// complex kernel taps[r, :] (R, T) at the static offsets d_0 < ... < d_{T-1}:
//   y[r, m] = sum_i taps[r, i] * x[r, m - d_i]  over 0 <= m - d_i < block_size,
// for m in [0, block_size + D - 1), D = d_{T-1} + 1. Complex64 throughout
// (interleaved float2), where the TPU kernel worked on f32 real pairs.
//
// What bounds it on the card: memory bytes. At the flagship geometry
// (block_size 564, T = 16, D = 44, R = 8192 rows) the kernel must read x
// (37 MB) and the taps (1 MB) and write y (40 MB): ~23 us at 3.35 TB/s,
// against ~9 us for its 0.59 GFLOP at the 67 TFLOP/s f32 rate (past ~40
// taps the operations bound it instead: 81 taps over the same rows are
// 3.0 GFLOP, 44.7 us, against 25.2 us of bytes). The first
// form (one block of 128 threads a row, a run-time tap loop with two bounds
// tests a product) issued ~12 instructions per (output, tap) pair, more
// time than the bytes take. This form keeps the issue under the bytes:
//   * a warp owns kRowsPerWarp consecutive rows and walks them through a
//     ring of kStages row buffers in shared memory, filled by 16-byte
//     cp.async (8-byte where a row is not 16-byte aligned): the next rows'
//     loads are in flight while a row computes, and warps never wait on
//     each other (a TMA bulk copy a row into an mbarrier measured no
//     faster);
//   * each buffer holds the row between D - 1 zeros before it and zeros
//     after it up to the last output's 32-wide chunk, so no product needs
//     a bounds test (the zeros are written once, the rows land between);
//   * the tap loop is unrolled over a compile-time bound (16 / 32 / 64
//     instances, picked by T, a uniform test skips the unused taps) with
//     the offsets in the parameter bank; at most 16 taps are held in
//     registers for the whole row;
//   * a lane accumulates kChunks outputs 32 apart (a warp covers
//     32 * kChunks adjacent outputs a pass): for each tap one address and
//     kChunks conflict-free 8-byte shared loads feed 4 * kChunks FMAs,
//     ~5 instructions a pair. Adjacent outputs a lane would read shared
//     memory at a 32-byte stride (8-way bank conflicts) and store partial
//     sectors; 32 apart, a warp's loads and its float2 stores are
//     contiguous (an output row is 4,856 B, so 16-byte stores would be
//     misaligned on every odd row);
//   * the tail of a row (chunks short of a full pass) goes one chunk at a
//     time; a ragged row count needs no padding: each warp stops at the
//     last row.
// The offsets are a fixed-size struct passed by value (T <= 64), so a
// launch copies nothing from the host.
//
// That form holds a whole row (its taps, the D - 1 zeros before it and the
// padded tail) in each of a warp's buffers. Two more forms take every
// other shape the TPU kernel takes:
//   * segments (block_fir_seg_kernel): more than 64 taps, or a row whose
//     buffer does not fit kWarps warps of kStages buffers in 227 KB (long
//     blocks, long spans). What bounds it: bytes at sparse taps (COST259-HT:
//     17 taps over 361 samples, 41 us of bytes against 17 us of FMA at
//     1,024 rows of 8,192), operations at dense ones (81 taps at 0..80,
//     44.7 us against 25 us of bytes); at either, one 8-byte shared load a
//     complex MAC (2 clocks a warp at 128 B a clock a SM) would cap it at
//     half the FMA rate. The first form of it staged each warp's
//     own (row, segment) with its halo, so at 1,024 rows of 8,192 its 229
//     KB blocks ran 4 warps a SM in 96 blocks, and its tap loop waited on a
//     global load of each offset. This form:
//       - stages a block-wide item, the rows of a group (as many whole rows
//         as fit, or one row's segment and its D - 1 halo) with their taps,
//         in a ring of kSegStages stages by cp.async (16-byte pairs where
//         the block is even; zeros stored where the window leaves the
//         row), the next items' loads in flight while all kSegWarps warps
//         compute this one; items and stages are sized for
//         kSegBlocksPerSm blocks a SM (else one, else one stage), a row's
//         segments are cut so each item's units keep the warps busy, and
//         a grid of that many blocks a SM walks the items;
//       - reads the offsets into shared memory once a block;
//       - where the offsets are consecutive (d_i = d_0 + i: a dense
//         profile), gives a lane kDenseOut adjacent outputs and loads x into
//         a register window once for kDenseTaps taps: kDenseOut +
//         kDenseTaps - 1 loads feed kDenseOut * kDenseTaps MACs (kDenseOut
//         odd, so a warp's loads hit 32 distinct pairs of banks);
//       - else a lane sums kSegChunks outputs 32 apart, one shared load a
//         MAC;
//   * direct (block_fir_direct_kernel): where even one unit of outputs and
//     its halo do not fit 227 KB (a span past ~28,000 samples), a thread an
//     output reads x through L1 / L2 tap by tap.
// Every form sums each output's taps in the same order (i = 0..T-1), so
// they agree to the last bit where a shape fits two of them. make_plan is
// the one place that decides the form, the instance, the buffers, the warps
// and the grid; the host reads it through block_fir_plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "launch_info.cuh"

namespace {

constexpr int kMaxTaps = 64;       // the widest unrolled instance
constexpr int kWarps = 4;          // warps a block (each on its own rows)
constexpr int kRowsPerWarp = 8;    // consecutive rows a warp walks through
constexpr int kStages = 2;         // row buffers a warp: rows in flight
constexpr int kChunks = 4;         // outputs a lane per pass, 32 apart
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may opt in
constexpr int kSmemPerSm = 233472; // shared memory a SM, of which the card
constexpr int kSmemReserved = 1024; // keeps this much a resident block
constexpr int kDirectThreads = 256;  // threads a block of the direct form
constexpr long long kDirectGrid = 1 << 20;  // its blocks, each walking on
constexpr int kSegWarps = 8;       // warps a block of the segments form
constexpr int kSegStages = 2;      // its ring of staged items a block
constexpr int kSegBlocksPerSm = 2; // its blocks a SM the stages are sized for
constexpr int kSegMaxRows = 16;    // whole rows an item stages at most
constexpr int kSegChunks = 16;     // outputs a lane 32 apart, sparse taps
constexpr int kDenseOut = 7;       // adjacent outputs a lane, dense taps
constexpr int kDenseTaps = 16;     // taps a register window of x feeds
static_assert(kDenseOut % 2 == 1, "odd: a warp's window loads are "
              "conflict-free");

struct TapOffsets {
  int n;
  int d[kMaxTaps];
};

struct Geometry {
  int rows, block_size, out_len, num_taps;
  int row0;     // the row's first element in a stage (after taps and pad)
  int stage;    // elements of one stage buffer
  int chunks;   // 32-wide output chunks of a row
};

// The segments form's items: a group of `rows` rows, or one row's
// segment. A row of a stage is its taps (tap_slots), then its window: pad
// (0 or 1) and the samples from halo before the segment's first output on
// (zeros outside the row), row_stride elements in all. The pad makes the
// window's first sample even, so where the block is even every row's
// samples copy in 16-byte pairs (vec16).
struct Segments {
  int segment;      // outputs a segment, a multiple of unit
  int segments;     // segments a row
  int rows;         // rows an item stages
  int unit;         // outputs a warp takes at once (32 lanes)
  int tap_slots;    // taps rounded up to even
  int pad;          // halo & 1 where vec16, else 0
  int vec16;        // the block is even: 16-byte copies
  int halo;         // D - 1
  int row_stride;   // tap_slots + pad + halo + segment
  int first;        // d_0
  int offs_bytes;   // the offsets in shared memory (0 where dense)
  long long items;  // row groups * segments
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start loading row `row` (its taps and samples) into `stage`; every lane
// of the warp calls this, and commits one cp.async group either way.
__device__ __forceinline__ void load_row(float2* stage, const float2* x,
                                         const float2* taps,
                                         const Geometry& g, long long row,
                                         int lane) {
  const float2* xr = x + row * g.block_size;
  const float2* tr = taps + row * g.num_taps;
  float2* dst = stage + g.row0;
  for (int i = lane; i < g.num_taps; i += 32) cp_async8(stage + i, tr + i);
  if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const int pairs = g.block_size >> 1;
    for (int k = lane; k < pairs; k += 32) {
      cp_async16(dst + 2 * k, xr + 2 * k);
    }
    if ((g.block_size & 1) && lane == 0) {
      cp_async8(dst + g.block_size - 1, xr + g.block_size - 1);
    }
  } else {
    for (int k = lane; k < g.block_size; k += 32) {
      cp_async8(dst + k, xr + k);
    }
  }
  cp_async_commit();
}

// Taps a lane keeps in registers for a whole row (above 16 it reads each
// tap from shared memory once a pass).
template <int kMaxT>
constexpr int kRegTaps = kMaxT <= 16 ? kMaxT : 1;

// kC chunks of 32 outputs starting at chunk c of the row in `stage`:
// lane `lane` sums output (c + j) * 32 + lane for j < kC. kFull: the row
// has exactly kMaxT taps, so no tap is tested.
template <int kMaxT, bool kFull, int kC>
__device__ __forceinline__ void fir_chunks(const float2* stage,
                                           const float2 (&h)[kRegTaps<kMaxT>],
                                           const TapOffsets& offs,
                                           const Geometry& g, float2* yr,
                                           int c, int lane) {
  float2 acc[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) acc[j] = make_float2(0.f, 0.f);
  const float2* xs = stage + g.row0 + c * 32 + lane;
#pragma unroll
  for (int i = 0; i < kMaxT; ++i) {
    if (kFull || i < offs.n) {
      float2 t;
      if constexpr (kMaxT <= 16) {
        t = h[i];
      } else {
        t = stage[i];
      }
      const float2* p = xs - offs.d[i];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float2 v = p[32 * j];
        acc[j].x = fmaf(t.x, v.x, acc[j].x);
        acc[j].x = fmaf(-t.y, v.y, acc[j].x);
        acc[j].y = fmaf(t.x, v.y, acc[j].y);
        acc[j].y = fmaf(t.y, v.x, acc[j].y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int m = (c + j) * 32 + lane;
    if (m < g.out_len) yr[m] = acc[j];
  }
}

template <int kMaxT, bool kFull, int kS>
__global__ void __launch_bounds__(kWarps * 32)
    block_fir_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ taps, float2* __restrict__ y,
                     const __grid_constant__ Geometry g,
                     const __grid_constant__ TapOffsets offs) {
  extern __shared__ __align__(16) float2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float2* ring = smem + (long long)warp * kS * g.stage;
  const long long first =
      ((long long)blockIdx.x * warps + warp) * kRowsPerWarp;
  if (first >= g.rows) return;                  // the whole warp
  const int nrows = (int)min((long long)kRowsPerWarp, g.rows - first);

  // zeros around every stage's row, written once
  const int tap_slots = (g.num_taps + 1) & ~1;
  for (int s = 0; s < kS; ++s) {
    float2* st = ring + s * g.stage;
    for (int k = tap_slots + lane; k < g.row0; k += 32) {
      st[k] = make_float2(0.f, 0.f);
    }
    for (int k = g.row0 + g.block_size + lane; k < g.stage; k += 32) {
      st[k] = make_float2(0.f, 0.f);
    }
  }
  __syncwarp();

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < nrows) {
      load_row(ring + s * g.stage, x, taps, g, first + s, lane);
    } else {
      cp_async_commit();
    }
  }
  for (int k = 0; k < nrows; ++k) {
    const int next = k + kS - 1;
    if (next < nrows) {
      load_row(ring + (next % kS) * g.stage, x, taps, g, first + next, lane);
    } else {
      cp_async_commit();
    }
    const int s = k % kS;
    cp_async_wait<kS - 1>();
    __syncwarp();

    const float2* stage = ring + s * g.stage;
    float2 h[kRegTaps<kMaxT>];
#pragma unroll
    for (int i = 0; i < kRegTaps<kMaxT>; ++i) {
      h[i] = i < g.num_taps ? stage[i] : make_float2(0.f, 0.f);
    }
    float2* yr = y + (first + k) * g.out_len;
    int c = 0;
    for (; c + kChunks <= g.chunks; c += kChunks) {
      fir_chunks<kMaxT, kFull, kChunks>(stage, h, offs, g, yr, c, lane);
    }
    for (; c < g.chunks; ++c) {
      fir_chunks<kMaxT, kFull, 1>(stage, h, offs, g, yr, c, lane);
    }
    __syncwarp();        // every lane is done with the stage it refills next
  }
}

// Start loading `item` into `stage` (every thread of the block calls this
// and commits one group): each row of its group, its taps, then its
// window: zeros where the window leaves the row, the row's samples by
// cp.async (16-byte pairs where vec16).
__device__ __forceinline__ void load_item(float2* stage, const float2* x,
                                          const float2* taps,
                                          const Geometry& g,
                                          const Segments& sg,
                                          long long item) {
  const long long group = item / sg.segments;
  const int m0 = (int)(item - group * sg.segments) * sg.segment;
  const long long row0 = group * sg.rows;
  const int nrows = (int)min((long long)sg.rows, g.rows - row0);
  const int width = sg.row_stride - sg.tap_slots;  // the window
  const int lo = m0 - sg.halo - sg.pad;  // the sample of window slot 0
  const int a = min(max(-lo, 0), width);                 // [a, b): samples
  const int b = min(max(g.block_size - lo, a), width);
  const float2 zero = make_float2(0.f, 0.f);
  for (int r = 0; r < nrows; ++r) {
    float2* dst = stage + r * sg.row_stride;
    const float2* tr = taps + (row0 + r) * g.num_taps;
    for (int k = threadIdx.x; k < sg.tap_slots; k += blockDim.x) {
      if (k < g.num_taps) {
        cp_async8(dst + k, tr + k);
      } else {
        dst[k] = zero;
      }
    }
    float2* win = dst + sg.tap_slots;
    const float2* xr = x + (row0 + r) * g.block_size + lo;
    for (int k = threadIdx.x; k < a; k += blockDim.x) win[k] = zero;
    for (int k = b + threadIdx.x; k < width; k += blockDim.x) win[k] = zero;
    if (sg.vec16) {
      for (int k = a + 2 * threadIdx.x; k < b; k += 2 * blockDim.x) {
        cp_async16(win + k, xr + k);
      }
    } else {
      for (int k = a + threadIdx.x; k < b; k += blockDim.x) {
        cp_async8(win + k, xr + k);
      }
    }
  }
  cp_async_commit();
}

// A unit of sparse taps: kSegChunks chunks of 32 outputs from output `m`
// of the segment, a lane's outputs 32 apart; one shared load a MAC.
__device__ __forceinline__ void seg_sparse_unit(const float2* row_st,
                                                const int* s_offs,
                                                const Geometry& g,
                                                const Segments& sg,
                                                float2* yr, int m,
                                                int out_left, int lane) {
  float2 acc[kSegChunks];
#pragma unroll
  for (int j = 0; j < kSegChunks; ++j) acc[j] = make_float2(0.f, 0.f);
  const float2* xs = row_st + sg.tap_slots + sg.pad + sg.halo + m + lane;
#pragma unroll 4
  for (int i = 0; i < g.num_taps; ++i) {
    const float2 t = row_st[i];
    const float2* p = xs - s_offs[i];
#pragma unroll
    for (int j = 0; j < kSegChunks; ++j) {
      const float2 v = p[32 * j];
      acc[j].x = fmaf(t.x, v.x, acc[j].x);
      acc[j].x = fmaf(-t.y, v.y, acc[j].x);
      acc[j].y = fmaf(t.x, v.y, acc[j].y);
      acc[j].y = fmaf(t.y, v.x, acc[j].y);
    }
  }
#pragma unroll
  for (int j = 0; j < kSegChunks; ++j) {
    const int o = m + 32 * j + lane;
    if (o < out_left) yr[o] = acc[j];
  }
}

// A unit of dense taps (d_i = d_0 + i): kDenseOut adjacent outputs a
// lane from output `m` of the segment; x in a register window of
// kDenseOut + kDenseTaps - 1 samples a chunk of kDenseTaps taps, then the
// last taps one at a time.
__device__ __forceinline__ void seg_dense_unit(const float2* row_st,
                                               const Geometry& g,
                                               const Segments& sg,
                                               float2* yr, int m,
                                               int out_left, int lane) {
  constexpr int K = kDenseOut, U = kDenseTaps;
  float2 acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = make_float2(0.f, 0.f);
  // x[o - d_0] of output o = m + lane K, tap 0
  const float2* base =
      row_st + sg.tap_slots + sg.pad + sg.halo + m + lane * K - sg.first;
  int i = 0;
#pragma unroll 1
  for (; i + U <= g.num_taps; i += U) {
    float2 w[K + U - 1];     // w[e] = x[o - d_0 - i - (U - 1) + e]
#pragma unroll
    for (int e = 0; e < K + U - 1; ++e) w[e] = base[e - i - (U - 1)];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float2 t = row_st[i + u];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float2 v = w[j - u + U - 1];
        acc[j].x = fmaf(t.x, v.x, acc[j].x);
        acc[j].x = fmaf(-t.y, v.y, acc[j].x);
        acc[j].y = fmaf(t.x, v.y, acc[j].y);
        acc[j].y = fmaf(t.y, v.x, acc[j].y);
      }
    }
  }
#pragma unroll 1
  for (; i < g.num_taps; ++i) {
    const float2 t = row_st[i];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float2 v = base[j - i];
      acc[j].x = fmaf(t.x, v.x, acc[j].x);
      acc[j].x = fmaf(-t.y, v.y, acc[j].x);
      acc[j].y = fmaf(t.x, v.y, acc[j].y);
      acc[j].y = fmaf(t.y, v.x, acc[j].y);
    }
  }
  // a lane's stores are K apart: staging them through shared memory to
  // store 32 adjacent outputs an instruction measured slower
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int o = m + lane * K + j;
    if (o < out_left) yr[o] = acc[j];
  }
}

// kS stages a block (a ring: the item kS - 1 ahead loads while this one
// computes), kDense: the offsets are consecutive. The block walks items
// blockIdx.x, + gridDim.x, ...; its warps take the units (row of the
// group, unit of the segment) of the staged item.
template <int kS, bool kDense>
__global__ void __launch_bounds__(kSegWarps * 32, kSegBlocksPerSm)
    block_fir_seg_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ taps,
                         float2* __restrict__ y,
                         const __grid_constant__ Geometry g,
                         const __grid_constant__ Segments sg,
                         const int* __restrict__ offs) {
  extern __shared__ __align__(16) float2 smem[];
  int* s_offs = reinterpret_cast<int*>(smem);
  float2* stages = smem + sg.offs_bytes / 8;
  const long long stage_elems = (long long)sg.rows * sg.row_stride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (!kDense) {
    for (int i = threadIdx.x; i < g.num_taps; i += blockDim.x) {
      s_offs[i] = offs[i];
    }
  }
  const int units = sg.segment / sg.unit;     // a row's units in an item
  long long item = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    const long long ahead = item + (long long)s * gridDim.x;
    if (ahead < sg.items) {
      load_item(stages + s * stage_elems, x, taps, g, sg, ahead);
    } else {
      cp_async_commit();
    }
  }
  for (int k = 0; item < sg.items; ++k, item += gridDim.x) {
    const long long ahead = item + (long long)(kS - 1) * gridDim.x;
    if (ahead < sg.items) {
      load_item(stages + ((k + kS - 1) % kS) * stage_elems, x, taps, g, sg,
                ahead);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kS - 1>();
    __syncthreads();

    const float2* stage = stages + (k % kS) * stage_elems;
    const long long group = item / sg.segments;
    const int m0 = (int)(item - group * sg.segments) * sg.segment;
    const long long row0 = group * sg.rows;
    const int nrows = (int)min((long long)sg.rows, g.rows - row0);
    const int out_left = min(g.out_len - m0, sg.segment);
#pragma unroll 1
    for (int w = warp; w < nrows * units; w += kSegWarps) {
      const int r = w / units;
      const int m = (w - r * units) * sg.unit;
      const float2* row_st = stage + r * sg.row_stride;
      float2* yr = y + (row0 + r) * g.out_len + m0;
      if (kDense) {
        seg_dense_unit(row_st, g, sg, yr, m, out_left, lane);
      } else {
        seg_sparse_unit(row_st, s_offs, g, sg, yr, m, out_left, lane);
      }
    }
    __syncthreads();     // every warp is done with the stage refilled next
  }
}

// A thread an output, x read through the caches tap by tap: the shapes
// whose one segment does not fit a block's shared memory.
__global__ void __launch_bounds__(kDirectThreads)
    block_fir_direct_kernel(const float2* __restrict__ x,
                            const float2* __restrict__ taps,
                            float2* __restrict__ y,
                            const __grid_constant__ Geometry g,
                            const int* __restrict__ offs) {
  const long long total = (long long)g.rows * g.out_len;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    const long long row = o / g.out_len;
    const int m = (int)(o - row * g.out_len);
    const float2* xr = x + row * g.block_size;
    const float2* tr = taps + row * g.num_taps;
    float2 acc = make_float2(0.f, 0.f);
    for (int i = 0; i < g.num_taps; ++i) {
      const int k = m - __ldg(offs + i);
      if (k < 0) break;                 // the offsets increase
      if (k < g.block_size) {
        const float2 t = __ldg(tr + i);
        const float2 v = __ldg(xr + k);
        acc.x = fmaf(t.x, v.x, acc.x);
        acc.x = fmaf(-t.y, v.y, acc.x);
        acc.y = fmaf(t.x, v.y, acc.y);
        acc.y = fmaf(t.y, v.x, acc.y);
      }
    }
    y[o] = acc;
  }
}

// How one call runs. form 0, the row in a buffer: the instance (tap_bound,
// the least of 16 / 32 / 64 that holds T, and full, T equal to it) where
// T <= 64 and kWarps warps of kStages row buffers fit (fewer warps or
// buffers a row leave too few blocks: at 1,024 rows of 6,144 samples and
// a span of 361, two warps of two row buffers take 3.7x the segments
// form's time, PERF.md). form 1, segments: dense where the offsets are
// consecutive; for kSegStages stages in 1 / kSegBlocksPerSm of a SM's
// shared memory (less the 1 KB the card keeps a resident block), else in
// all of it, else one stage: as many whole rows an item as fit (at most
// kSegMaxRows), else a row's outputs cut into the fewest segments of
// whole units that fit. form 2, direct, where not one
// unit fits. Then the shared bytes and the grid.
struct Plan {
  int form, tap_bound, full, stages, warps;
  long long smem_bytes, blocks;
  Geometry g;
  Segments sg;
  int dense, blocks_per_sm;
};

// The segment (a multiple of unit, at most `most`) that cuts a row of
// out_len outputs so that its items' units keep kSegWarps warps busiest:
// of the fewest parts up to 3 more, each rounded up to a multiple of
// kSegWarps units where that fits, else of one unit, the one whose
// segments take the fewest rounds of the block's warps (then the fewest
// segments).
long long balanced_segment(long long out_len, long long unit,
                           long long most) {
  const long long fewest = (out_len + most - 1) / most;
  long long best = 0, best_rounds = 0, best_parts = 0;
  for (long long parts = fewest; parts < fewest + 4; ++parts) {
    for (const long long grain : {unit * kSegWarps, unit}) {
      const long long seg =
          ((out_len + parts - 1) / parts + grain - 1) / grain * grain;
      if (seg > most) continue;
      const long long n = (out_len + seg - 1) / seg;
      long long rounds = 0;
      for (long long i = 0; i < n; ++i) {
        const long long units =
            (std::min(seg, out_len - i * seg) + unit - 1) / unit;
        rounds += (units + kSegWarps - 1) / kSegWarps;
      }
      if (best == 0 || rounds < best_rounds ||
          (rounds == best_rounds && n < best_parts)) {
        best = seg;
        best_rounds = rounds;
        best_parts = n;
      }
    }
  }
  return best;
}

// 0, cudaErrorInvalidValue for arguments that are no FIR (no taps, an empty
// block, offsets whose span cannot hold T increasing ones), or the CUDA
// error of reading the device (the segments form's grid).
int make_plan(int rows, int block_size, int num_taps, int first_offset,
              int last_offset, Plan* p) {
  if (num_taps < 1 || block_size < 1 || rows < 0 || first_offset < 0 ||
      last_offset - first_offset < num_taps - 1) {
    return (int)cudaErrorInvalidValue;
  }
  *p = Plan{};
  Geometry& g = p->g;
  g.rows = rows;
  g.block_size = block_size;
  g.num_taps = num_taps;
  g.out_len = block_size + last_offset;
  g.chunks = (g.out_len + 31) / 32;
  const int tap_slots = (num_taps + 1) & ~1;
  // form 0: taps, D - 1 zeros rounded up to even, the row, zeros to the
  // last chunk
  g.row0 = tap_slots + ((last_offset + 1) & ~1);
  g.stage = g.row0 + 32 * g.chunks;
  if (num_taps <= kMaxTaps &&
      8LL * g.stage * kStages * kWarps <= kMaxSmem) {
    p->stages = kStages;
    p->warps = kWarps;
    p->tap_bound = num_taps <= 16 ? 16 : num_taps <= 32 ? 32 : 64;
    p->full = num_taps == p->tap_bound;
    p->smem_bytes = 8LL * p->warps * p->stages * g.stage;
    const long long per_block = (long long)p->warps * kRowsPerWarp;
    p->blocks = (rows + per_block - 1) / per_block;
    return 0;
  }
  // form 1: items of whole rows, else of one row's segment
  Segments& sg = p->sg;
  p->dense = last_offset - first_offset == num_taps - 1;
  sg.unit = 32 * (p->dense ? kDenseOut : kSegChunks);
  sg.tap_slots = tap_slots;
  sg.vec16 = block_size % 2 == 0;
  sg.pad = sg.vec16 ? last_offset & 1 : 0;
  sg.halo = last_offset;
  sg.first = first_offset;
  sg.offs_bytes = p->dense ? 0 : (4 * num_taps + 15) / 16 * 16;
  const long long whole = (long long)(g.out_len + sg.unit - 1) / sg.unit *
                          sg.unit;
  const int ladder[3][2] = {{kSegStages, kSegBlocksPerSm}, {kSegStages, 1},
                            {1, 1}};
  for (int i = 0; i < 3 && sg.segment == 0; ++i) {
    const int stages = ladder[i][0];
    const long long budget =   // dynamic bytes a block at ladder[i][1]
        std::min<long long>(kMaxSmem,
                            kSmemPerSm / ladder[i][1] - kSmemReserved);
    const long long room = (budget - sg.offs_bytes) / (8LL * stages);
    const long long fixed = tap_slots + sg.pad + last_offset;
    long long seg = 0, nrows = 1;
    if (fixed + whole <= room) {
      seg = whole;
      nrows = std::min<long long>({room / (fixed + whole), kSegMaxRows,
                                   std::max(rows, 1)});
    } else if (room - fixed >= sg.unit) {
      seg = balanced_segment(g.out_len, sg.unit,
                             (room - fixed) / sg.unit * sg.unit);
    }
    if (seg > 0) {
      sg.segment = (int)seg;
      sg.rows = (int)nrows;
      p->stages = stages;
      p->blocks_per_sm = ladder[i][1];
    }
  }
  if (sg.segment > 0) {
    p->form = 1;
    p->warps = kSegWarps;
    sg.segments = (g.out_len + sg.segment - 1) / sg.segment;
    sg.row_stride = tap_slots + sg.pad + last_offset + sg.segment;
    sg.items = ((long long)rows + sg.rows - 1) / sg.rows * sg.segments;
    g.row0 = tap_slots + sg.pad + last_offset;
    g.stage = sg.rows * sg.row_stride;
    p->smem_bytes = sg.offs_bytes + 8LL * p->stages * g.stage;
    int dev = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) {
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (rc != cudaSuccess) return (int)rc;
    p->blocks = std::min<long long>(sg.items,
                                    (long long)sms * p->blocks_per_sm);
    return 0;
  }
  // form 2: direct
  p->form = 2;
  p->dense = 0;
  sg = Segments{};
  p->warps = kDirectThreads / 32;
  const long long per_block = kDirectThreads;
  const long long blocks = ((long long)rows * g.out_len + per_block - 1) /
                           per_block;
  p->blocks = std::min(blocks, kDirectGrid);
  return 0;
}

// Opts `kernel` in to kMaxSmem of dynamic shared memory the first time a
// launch of it asks for more than the 48 KB default (`done`: the
// instance's own flag), so later launches, CUDA-graph captures among them,
// make no call.
template <typename Kernel>
int opt_in(Kernel kernel, long long smem_bytes, bool* done) {
  if (smem_bytes <= 48 * 1024 || *done) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  *done = rc == cudaSuccess;
  return (int)rc;
}

template <int kMaxT, bool kFull, int kS>
int launch(const float2* x, const float2* taps, float2* y, const Plan& p,
           const TapOffsets& offs, cudaStream_t stream) {
  static bool opted = false;
  const int rc = opt_in(block_fir_kernel<kMaxT, kFull, kS>, p.smem_bytes,
                        &opted);
  if (rc != 0) return rc;
  block_fir_kernel<kMaxT, kFull, kS>
      <<<(unsigned int)p.blocks, p.warps * 32, (size_t)p.smem_bytes,
         stream>>>(x, taps, y, p.g, offs);
  return 0;
}

template <int kMaxT, int kS>
int launch_full(const float2* x, const float2* taps, float2* y,
                const Plan& p, const TapOffsets& offs, cudaStream_t stream) {
  return p.full ? launch<kMaxT, true, kS>(x, taps, y, p, offs, stream)
                : launch<kMaxT, false, kS>(x, taps, y, p, offs, stream);
}

template <int kS>
int launch_taps(const float2* x, const float2* taps, float2* y,
                const Plan& p, const TapOffsets& offs, cudaStream_t stream) {
  if (p.tap_bound == 16) return launch_full<16, kS>(x, taps, y, p, offs,
                                                    stream);
  if (p.tap_bound == 32) return launch_full<32, kS>(x, taps, y, p, offs,
                                                    stream);
  return launch_full<64, kS>(x, taps, y, p, offs, stream);
}

template <int kS, bool kDense>
int launch_seg(const float2* x, const float2* taps, float2* y,
               const Plan& p, const int* offs, cudaStream_t stream) {
  static bool opted = false;
  const auto kernel = block_fir_seg_kernel<kS, kDense>;
  const int rc = opt_in(kernel, p.smem_bytes, &opted);
  if (rc != 0) return rc;
  kernel<<<(unsigned int)p.blocks, p.warps * 32, (size_t)p.smem_bytes,
           stream>>>(x, taps, y, p.g, p.sg, offs);
  return 0;
}

int launch_seg(const float2* x, const float2* taps, float2* y,
               const Plan& p, const int* offs, cudaStream_t stream) {
  if (p.stages == kSegStages) {
    return p.dense ? launch_seg<kSegStages, true>(x, taps, y, p, offs, stream)
                   : launch_seg<kSegStages, false>(x, taps, y, p, offs,
                                                   stream);
  }
  return p.dense ? launch_seg<1, true>(x, taps, y, p, offs, stream)
                 : launch_seg<1, false>(x, taps, y, p, offs, stream);
}

template <int kMaxT, bool kFull>
int rows_info(const Plan& p, int* out) {
  const int t = p.warps * 32;
  return p.stages == kStages
             ? instance_info(block_fir_kernel<kMaxT, kFull, kStages>, t,
                             p.smem_bytes, out)
             : instance_info(block_fir_kernel<kMaxT, kFull, 1>, t,
                             p.smem_bytes, out);
}

}  // namespace

// The plan of a call at these sizes (first_offset, last_offset: d_0,
// d_{T-1}) as 19 int64: tap_bound, full, stages, warps, the first
// output's sample in a buffer, the elements of a buffer (of a stage),
// 32-wide output chunks a row, outputs a row, shared bytes a block,
// blocks, the rows form's rows a warp and output chunks a lane (0 in
// the other forms), form (0 rows, 1 segments, 2 direct), outputs a
// segment, segments a row; the segments form's rows an item, outputs a
// unit, dense (0 / 1) and items.
extern "C" int block_fir_plan(int rows, int block_size, int num_taps,
                              int first_offset, int last_offset,
                              long long* out) {
  Plan p;
  const int rc =
      make_plan(rows, block_size, num_taps, first_offset, last_offset, &p);
  if (rc != 0) return rc;
  const long long v[19] = {p.tap_bound,  p.full,       p.stages,
                           p.warps,      p.g.row0,     p.g.stage,
                           p.g.chunks,   p.g.out_len,  p.smem_bytes,
                           p.blocks,     p.form == 0 ? kRowsPerWarp : 0,
                           p.form == 0 ? kChunks : 0,
                           p.form,       p.sg.segment, p.sg.segments,
                           p.sg.rows,    p.sg.unit,    p.dense,
                           p.sg.items};
  for (int i = 0; i < 19; ++i) out[i] = v[i];
  return 0;
}

// The instance a call at these sizes runs (block_fir_plan's), as 4 ints:
// registers and local (spill) bytes a thread, static shared bytes,
// resident blocks a SM at the plan's threads and shared bytes.
extern "C" int block_fir_launch_info(int rows, int block_size, int num_taps,
                                     int first_offset, int last_offset,
                                     int* out) {
  Plan p;
  const int rc =
      make_plan(rows, block_size, num_taps, first_offset, last_offset, &p);
  if (rc != 0) return rc;
  const int t = p.warps * 32;
  if (p.form == 0) {
    if (p.tap_bound == 16) {
      return p.full ? rows_info<16, true>(p, out)
                    : rows_info<16, false>(p, out);
    }
    if (p.tap_bound == 32) {
      return p.full ? rows_info<32, true>(p, out)
                    : rows_info<32, false>(p, out);
    }
    return p.full ? rows_info<64, true>(p, out) : rows_info<64, false>(p, out);
  }
  if (p.form == 2) {
    return instance_info(block_fir_direct_kernel, t, 0, out);
  }
  if (p.stages == kSegStages) {
    return p.dense ? instance_info(block_fir_seg_kernel<kSegStages, true>, t,
                                   p.smem_bytes, out)
                   : instance_info(block_fir_seg_kernel<kSegStages, false>,
                                   t, p.smem_bytes, out);
  }
  return p.dense ? instance_info(block_fir_seg_kernel<1, true>, t,
                                 p.smem_bytes, out)
                 : instance_info(block_fir_seg_kernel<1, false>, t,
                                 p.smem_bytes, out);
}

// x (rows, block_size), taps (rows, num_taps) and y (rows, block_size +
// offsets[num_taps - 1]) are contiguous complex64 on the device; offsets is
// a HOST array of num_taps increasing non-negative ints, copied into the
// launch's parameters before this returns (the rows form), and dev_offsets
// the same ints on the device (read by the segments and direct forms).
extern "C" int block_fir(const void* x, const void* taps, void* y, int rows,
                         int block_size, int num_taps, const void* offsets,
                         const void* dev_offsets, void* stream) {
  if (num_taps < 1) return (int)cudaErrorInvalidValue;
  const int* d = static_cast<const int*>(offsets);
  for (int i = 0; i < num_taps; ++i) {
    if (d[i] < 0 || (i > 0 && d[i] <= d[i - 1])) {
      return (int)cudaErrorInvalidValue;
    }
  }
  Plan p;
  int rc = make_plan(rows, block_size, num_taps, d[0], d[num_taps - 1], &p);
  if (rc != 0) return rc;
  if (rows == 0) return 0;
  const auto* xp = static_cast<const float2*>(x);
  const auto* tp = static_cast<const float2*>(taps);
  auto* yp = static_cast<float2*>(y);
  const auto* dp = static_cast<const int*>(dev_offsets);
  const auto s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(xp) & 15) p.sg.vec16 = 0;  // 8-byte copies
  if (p.form == 0) {
    TapOffsets offs = {};
    offs.n = num_taps;
    for (int i = 0; i < num_taps; ++i) offs.d[i] = d[i];
    rc = launch_taps<kStages>(xp, tp, yp, p, offs, s);
  } else if (dp == nullptr) {
    return (int)cudaErrorInvalidValue;   // the wrapper passes them
  } else if (p.form == 1) {
    rc = launch_seg(xp, tp, yp, p, dp, s);
  } else {
    block_fir_direct_kernel<<<(unsigned int)p.blocks, kDirectThreads, 0,
                              s>>>(xp, tp, yp, p.g, dp);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
