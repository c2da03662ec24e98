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
//     buffer does not fit kWarps warps of kStages buffers in 227 KB. A
//     row's outputs are cut into segments of whole 32-output chunks, each
//     staged with the D - 1 samples before it (zeros outside the row), as
//     large as kWarps x kStages buffers allow (fewer warps or buffers where
//     the halo leaves no pass of kChunks chunks); a warp walks kRowsPerWarp
//     (row, segment) items. The taps run in a loop over T with the offsets
//     read from a device array (a uniform load a tap). This form is right
//     first, not fast: its loads wait on each tap's offset (PERF.md);
//   * direct (block_fir_direct_kernel): where even one 32-output segment
//     and its halo do not fit 227 KB (a span past ~29,000 samples), a
//     thread an output reads x through L1 / L2 tap by tap.
// Every form sums each output's taps in the same order (i = 0..T-1), so
// they agree to the last bit where a shape fits two of them. make_plan is
// the one place that decides the form, the instance, the buffers, the warps
// and the grid; the host reads it through block_fir_plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxTaps = 64;       // the widest unrolled instance
constexpr int kWarps = 4;          // warps a block (each on its own rows)
constexpr int kRowsPerWarp = 8;    // consecutive rows a warp walks through
constexpr int kStages = 2;         // row buffers a warp: rows in flight
constexpr int kChunks = 4;         // outputs a lane per pass, 32 apart
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may opt in
constexpr int kDirectThreads = 256;  // threads a block of the direct form
constexpr long long kDirectGrid = 1 << 20;  // its blocks, each walking on

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

// The segments form's cut of a row (Geometry::row0 is then the first
// output's sample in a stage: the taps' slots and the D - 1 halo).
struct Segments {
  int segment;      // outputs a segment, a multiple of 32
  int segments;     // segments a row
  int tap_slots;    // taps rounded up to even
  int halo;         // D - 1
  long long items;  // rows * segments
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

// Start loading (row, segment) `item` into `stage`: the row's taps, then
// the segment's samples with its D - 1 halo before it, zeros where that
// window leaves the row. Every lane calls this and commits one group.
__device__ __forceinline__ void load_segment(float2* stage, const float2* x,
                                             const float2* taps,
                                             const Geometry& g,
                                             const Segments& sg,
                                             long long item, int lane) {
  const long long row = item / sg.segments;
  const int m0 = (int)(item - row * sg.segments) * sg.segment;
  const float2* tr = taps + row * g.num_taps;
  for (int i = lane; i < g.num_taps; i += 32) cp_async8(stage + i, tr + i);
  const float2* xr = x + row * g.block_size;
  float2* win = stage + sg.tap_slots;
  const int lo = m0 - sg.halo;        // the window's first sample
  const int n = sg.halo + sg.segment;
  for (int k = lane; k < n; k += 32) {
    const int src = lo + k;
    if (src >= 0 && src < g.block_size) {
      cp_async8(win + k, xr + src);
    } else {
      win[k] = make_float2(0.f, 0.f);
    }
  }
  cp_async_commit();
}

// kC chunks of 32 outputs starting at chunk c of the segment in `stage`,
// the taps in a loop; outputs at or past `out_left` are not stored.
template <int kC>
__device__ __forceinline__ void seg_chunks(const float2* stage,
                                           const int* __restrict__ offs,
                                           const Geometry& g, float2* yr,
                                           int c, int out_left, int lane) {
  float2 acc[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) acc[j] = make_float2(0.f, 0.f);
  const float2* xs = stage + g.row0 + c * 32 + lane;
#pragma unroll 4
  for (int i = 0; i < g.num_taps; ++i) {
    const float2 t = stage[i];
    const float2* p = xs - __ldg(offs + i);
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const float2 v = p[32 * j];
      acc[j].x = fmaf(t.x, v.x, acc[j].x);
      acc[j].x = fmaf(-t.y, v.y, acc[j].x);
      acc[j].y = fmaf(t.x, v.y, acc[j].y);
      acc[j].y = fmaf(t.y, v.x, acc[j].y);
    }
  }
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int m = (c + j) * 32 + lane;
    if (m < out_left) yr[m] = acc[j];
  }
}

template <int kS>
__global__ void __launch_bounds__(kWarps * 32)
    block_fir_seg_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ taps,
                         float2* __restrict__ y,
                         const __grid_constant__ Geometry g,
                         const __grid_constant__ Segments sg,
                         const int* __restrict__ offs) {
  extern __shared__ __align__(16) float2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float2* ring = smem + (long long)warp * kS * g.stage;
  const long long first =
      ((long long)blockIdx.x * warps + warp) * kRowsPerWarp;
  if (first >= sg.items) return;                // the whole warp
  const int n = (int)min((long long)kRowsPerWarp, sg.items - first);

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n) {
      load_segment(ring + s * g.stage, x, taps, g, sg, first + s, lane);
    } else {
      cp_async_commit();
    }
  }
  for (int k = 0; k < n; ++k) {
    const int next = k + kS - 1;
    if (next < n) {
      load_segment(ring + (next % kS) * g.stage, x, taps, g, sg,
                   first + next, lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kS - 1>();
    __syncwarp();

    const float2* stage = ring + (k % kS) * g.stage;
    const long long item = first + k;
    const long long row = item / sg.segments;
    const int m0 = (int)(item - row * sg.segments) * sg.segment;
    const int out_left = g.out_len - m0;
    const int chunks = (min(out_left, sg.segment) + 31) / 32;
    float2* yr = y + row * g.out_len + m0;
    int c = 0;
    for (; c + kChunks <= chunks; c += kChunks) {
      seg_chunks<kChunks>(stage, offs, g, yr, c, out_left, lane);
    }
    for (; c < chunks; ++c) {
      seg_chunks<1>(stage, offs, g, yr, c, out_left, lane);
    }
    __syncwarp();        // every lane is done with the stage it refills next
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
// form's time, PERF.md). form 1, segments:
// the largest segment (whole passes of kChunks chunks, or one chunk at one
// warp of one buffer) for kWarps x kStages buffers, else 2 x kStages, 1 x
// kStages, 1 x 1. form 2, direct, where none fits. Then the shared bytes
// and the grid.
struct Plan {
  int form, tap_bound, full, stages, warps;
  long long smem_bytes, blocks;
  Geometry g;
  Segments sg;
};

// 0, or cudaErrorInvalidValue for arguments that are no FIR (no taps, an
// empty block, a last offset below T - 1).
int make_plan(int rows, int block_size, int num_taps, int last_offset,
              Plan* p) {
  if (num_taps < 1 || block_size < 1 || rows < 0 ||
      last_offset < num_taps - 1) {
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
  // form 1: a buffer holds the taps, the halo and one segment
  Segments& sg = p->sg;
  sg.tap_slots = tap_slots;
  sg.halo = last_offset;
  const int shapes[4][2] = {{kWarps, kStages}, {2, kStages}, {1, kStages},
                            {1, 1}};
  for (int i = 0; i < 4 && sg.segment == 0; ++i) {
    const long long room = kMaxSmem / (8LL * shapes[i][0] * shapes[i][1]) -
                           tap_slots - ((last_offset + 1) & ~1);
    const int pass = i < 3 ? 32 * kChunks : 32;   // the least segment
    const long long seg = std::min<long long>(32LL * g.chunks,
                                              room / pass * pass);
    if (seg >= pass) {
      sg.segment = (int)seg;
      p->warps = shapes[i][0];
      p->stages = shapes[i][1];
    }
  }
  if (sg.segment > 0) {
    p->form = 1;
    sg.segments = (g.out_len + sg.segment - 1) / sg.segment;
    sg.items = (long long)rows * sg.segments;
    g.row0 = tap_slots + last_offset;
    g.stage = (tap_slots + last_offset + sg.segment + 1) & ~1;
    p->smem_bytes = 8LL * p->warps * p->stages * g.stage;
    const long long per_block = (long long)p->warps * kRowsPerWarp;
    p->blocks = (sg.items + per_block - 1) / per_block;
    return 0;
  }
  // form 2: direct
  p->form = 2;
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

template <int kS>
int launch_seg(const float2* x, const float2* taps, float2* y,
               const Plan& p, const int* offs, cudaStream_t stream) {
  static bool opted = false;
  const int rc = opt_in(block_fir_seg_kernel<kS>, p.smem_bytes, &opted);
  if (rc != 0) return rc;
  block_fir_seg_kernel<kS>
      <<<(unsigned int)p.blocks, p.warps * 32, (size_t)p.smem_bytes,
         stream>>>(x, taps, y, p.g, p.sg, offs);
  return 0;
}

}  // namespace

// The plan of a call at these sizes (last_offset: d_{T-1}) as 15 int64:
// tap_bound, full, stages, warps, the first output's sample in a buffer,
// the elements of a buffer, 32-wide output chunks a row, outputs a row,
// shared bytes a block, blocks, items (rows, or (row, segment) pairs) a
// warp, output chunks a lane, form (0 rows, 1 segments, 2 direct),
// outputs a segment, segments a row.
extern "C" int block_fir_plan(int rows, int block_size, int num_taps,
                              int last_offset, long long* out) {
  Plan p;
  const int rc = make_plan(rows, block_size, num_taps, last_offset, &p);
  if (rc != 0) return rc;
  const long long v[15] = {p.tap_bound,  p.full,       p.stages,
                           p.warps,      p.g.row0,     p.g.stage,
                           p.g.chunks,   p.g.out_len,  p.smem_bytes,
                           p.blocks,     kRowsPerWarp, kChunks,
                           p.form,       p.sg.segment, p.sg.segments};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
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
  int rc = make_plan(rows, block_size, num_taps, d[num_taps - 1], &p);
  if (rc != 0) return rc;
  if (rows == 0) return 0;
  const auto* xp = static_cast<const float2*>(x);
  const auto* tp = static_cast<const float2*>(taps);
  auto* yp = static_cast<float2*>(y);
  const auto* dp = static_cast<const int*>(dev_offsets);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.form == 0) {
    TapOffsets offs = {};
    offs.n = num_taps;
    for (int i = 0; i < num_taps; ++i) offs.d[i] = d[i];
    rc = launch_taps<kStages>(xp, tp, yp, p, offs, s);
  } else if (dp == nullptr) {
    return (int)cudaErrorInvalidValue;   // the wrapper passes them
  } else if (p.form == 1) {
    rc = p.stages == kStages ? launch_seg<kStages>(xp, tp, yp, p, dp, s)
                             : launch_seg<1>(xp, tp, yp, p, dp, s);
  } else {
    block_fir_direct_kernel<<<(unsigned int)p.blocks, kDirectThreads, 0,
                              s>>>(xp, tp, yp, p.g, dp);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
