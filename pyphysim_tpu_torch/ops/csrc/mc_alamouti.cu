// Alamouti 2x1 QPSK Monte Carlo over flat Rayleigh fading, one error count
// per (rep, tile), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/alamouti_pallas.py
// MonteCarloAlamouti._simulate_block, launched by _make_prng_call (in-kernel
// random bits) and build_inject (bits read from device tensors). For every
// codeword (row r of tile t, lane l of repetition rep) it computes:
//   * two QPSK symbols from a 4-bit index (sign map, 1/sqrt 2 scale);
//   * the power-split Alamouti encode and the two receive samples
//     r1 = (h1 s1 + h2 s2)/sqrt2 + n1, r2 = (-h1 s2* + h2 s1*)/sqrt2 + n2,
//     with h1, h2 ~ CN(0, 1) held per (rep, lane) across every tile;
//   * the matched combiner d1 = h1* r1 + h2 r2*, d2 = h2* r1 - h1 r2* (its
//     gain |h1|^2 + |h2|^2 is positive, so the decisions need no division);
//   * four sign decisions and the popcount of the 4-bit difference.
//
// What bounds it on the card: instruction issue. In PRNG mode nothing is
// read per codeword; each one costs a Philox4x32-10 call for its four noise
// words (per round two IMAD.WIDE on the FMA pipe and two LOP3 on the ALU;
// the key schedule runs in the uniform datapath), four erfinvf and the
// encode / combine arithmetic: ~226 SASS instructions, ~100 of them f32,
// ~70 ALU, ~25 IMAD (ops/sass.py counts them from the built library). No
// pipe is full at that mix; the SM's four schedulers, one warp instruction
// per clock each, are the limit. The design keeps everything in registers
// and spends the shared work once:
//   * a thread owns one lane and a group of 32 consecutive rows of one tile:
//     it draws its lane's channel once (one Philox call, four erfinvf) and
//     all 32 rows' data indices with one Philox call (4 words of 8 nibbles);
//   * neighbouring threads take neighbouring lanes, so inject-mode loads
//     are coalesced;
//   * the TPU grid (rep, tile) ran in order; here blocks run in any order,
//     so a block sums its counts with warp shuffles and issues one integer
//     atomicAdd into out[rep, tile] (the wrapper zeroes out): integer sums
//     are exact in any order, so results are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;      // lanes per block
constexpr int kGroupRows = 32;     // rows per thread: one data Philox call
constexpr float kC = 0.70710678118654752f;   // 1/sqrt(2)
constexpr float kSqrt2 = 1.4142135623730951f;
constexpr uint32_t kChannelKey = 2u;  // ops/philox.py ALAMOUTI_*_KEY
constexpr uint32_t kNoiseKey = 3u;
constexpr uint32_t kDataKey = 4u;

struct Params {
  // inject mode only: int32 bits in the JAX layout
  const int* ch;   // (reps, >= 4, lane): rows h1.re, h1.im, h2.re, h2.im
  const int* d;    // (reps, num_tiles * tile, lane), low 4 bits used
  const int* n1r;  // the same shape and strides as d
  const int* n1i;
  const int* n2r;
  const int* n2i;
  long long ch_rep_stride;
  long long ch_row_stride;
  long long d_rep_stride;
  long long d_row_stride;
  int* out;  // (reps, num_tiles), zeroed by the wrapper
  int num_tiles, tile, lane, row_groups, lane_chunks;
  float amp;  // per-component noise std sqrt(0.5 / snr)
  uint32_t seed;
  long long start;
};

// Bit errors of one codeword: data index idx (4 bits), noise words w[0..3].
__device__ __forceinline__ int codeword_errors(int idx, uint32_t w0,
                                               uint32_t w1, uint32_t w2,
                                               uint32_t w3, float h1r,
                                               float h1i, float h2r,
                                               float h2i, float amp) {
  const float s1r = (float)(1 - 2 * (idx & 1)) * kC;
  const float s1i = (float)(1 - 2 * ((idx >> 1) & 1)) * kC;
  const float s2r = (float)(1 - 2 * ((idx >> 2) & 1)) * kC;
  const float s2i = (float)(1 - 2 * ((idx >> 3) & 1)) * kC;
  const float n1r = bits_half_normal(w0) * kSqrt2;
  const float n1i = bits_half_normal(w1) * kSqrt2;
  const float n2r = bits_half_normal(w2) * kSqrt2;
  const float n2i = bits_half_normal(w3) * kSqrt2;
  const float r1r = (h1r * s1r - h1i * s1i + h2r * s2r - h2i * s2i) * kC +
                    amp * n1r;
  const float r1i = (h1r * s1i + h1i * s1r + h2r * s2i + h2i * s2r) * kC +
                    amp * n1i;
  const float r2r = (-(h1r * s2r + h1i * s2i) + h2r * s1r + h2i * s1i) * kC +
                    amp * n2r;
  const float r2i = (-(h1i * s2r - h1r * s2i) + (h2i * s1r - h2r * s1i)) *
                        kC +
                    amp * n2i;
  const float d1r = h1r * r1r + h1i * r1i + h2r * r2r + h2i * r2i;
  const float d1i = h1r * r1i - h1i * r1r - (h2r * r2i - h2i * r2r);
  const float d2r = h2r * r1r + h2i * r1i - (h1r * r2r + h1i * r2i);
  const float d2i = h2r * r1i - h2i * r1r + (h1r * r2i - h1i * r2r);
  const int decided = (int)(d1r < 0.f) | ((int)(d1i < 0.f) << 1) |
                      ((int)(d2r < 0.f) << 2) | ((int)(d2i < 0.f) << 3);
  return __popc(idx ^ decided);
}

template <bool kInject>
__global__ void __launch_bounds__(kThreads) mc_alamouti_kernel(const Params p) {
  __shared__ int s_warp_sum[kThreads / 32];
  // block -> (rep, tile, row group, lane chunk), lane chunk fastest
  long long b = blockIdx.x;
  const int lane_chunk = (int)(b % p.lane_chunks);
  b /= p.lane_chunks;
  const int group = (int)(b % p.row_groups);
  b /= p.row_groups;
  const int tile_idx = (int)(b % p.num_tiles);
  const int rep = (int)(b / p.num_tiles);
  const int l = lane_chunk * kThreads + threadIdx.x;
  const unsigned long long attempt =
      (unsigned long long)(p.start + (long long)rep);
  const uint32_t att_lo = (uint32_t)attempt;
  const uint32_t att_hi = (uint32_t)(attempt >> 32);

  int errors = 0;
  if (l < p.lane) {
    // the lane's channel: the same for every tile of the repetition
    uint32_t hb0, hb1, hb2, hb3;
    if (kInject) {
      const int* ch = p.ch + rep * p.ch_rep_stride + l;
      hb0 = (uint32_t)ch[0];
      hb1 = (uint32_t)ch[p.ch_row_stride];
      hb2 = (uint32_t)ch[2 * p.ch_row_stride];
      hb3 = (uint32_t)ch[3 * p.ch_row_stride];
    } else {
      const uint4 x = philox4x32_10(make_uint4((uint32_t)l, 0u, att_lo, att_hi),
                                    make_uint2(p.seed, kChannelKey));
      hb0 = x.x;
      hb1 = x.y;
      hb2 = x.z;
      hb3 = x.w;
    }
    const float h1r = bits_half_normal(hb0);
    const float h1i = bits_half_normal(hb1);
    const float h2r = bits_half_normal(hb2);
    const float h2i = bits_half_normal(hb3);

    uint32_t dw[4] = {0u, 0u, 0u, 0u};
    if (!kInject) {
      const uint4 x = philox4x32_10(
          make_uint4((uint32_t)(group * p.lane + l), (uint32_t)tile_idx,
                     att_lo, att_hi),
          make_uint2(p.seed, kDataKey));
      dw[0] = x.x;
      dw[1] = x.y;
      dw[2] = x.z;
      dw[3] = x.w;
    }
    const int r0 = group * kGroupRows;
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k) {
      const int r = r0 + k;
      if (r < p.tile) {
        int idx;
        uint32_t w0, w1, w2, w3;
        if (kInject) {
          const long long off = rep * p.d_rep_stride +
                                (long long)(tile_idx * p.tile + r) *
                                    p.d_row_stride +
                                l;
          idx = p.d[off] & 15;
          w0 = (uint32_t)p.n1r[off];
          w1 = (uint32_t)p.n1i[off];
          w2 = (uint32_t)p.n2r[off];
          w3 = (uint32_t)p.n2i[off];
        } else {
          idx = (int)((dw[k >> 3] >> (4 * (k & 7))) & 15u);
          const uint4 x = philox4x32_10(
              make_uint4((uint32_t)(r * p.lane + l), (uint32_t)tile_idx,
                         att_lo, att_hi),
              make_uint2(p.seed, kNoiseKey));
          w0 = x.x;
          w1 = x.y;
          w2 = x.z;
          w3 = x.w;
        }
        errors += codeword_errors(idx, w0, w1, w2, w3, h1r, h1i, h2r, h2i,
                                  p.amp);
      }
    }
  }

  // block reduction -> one integer atomic per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    errors += __shfl_down_sync(0xffffffffu, errors, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane_in_warp = threadIdx.x & 31;
  if (lane_in_warp == 0) s_warp_sum[warp] = errors;
  __syncthreads();
  if (warp == 0) {
    int v = lane_in_warp < (int)(blockDim.x >> 5) ? s_warp_sum[lane_in_warp]
                                                  : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane_in_warp == 0 && v != 0) {
      atomicAdd(p.out + rep * p.num_tiles + tile_idx, v);
    }
  }
}

int launch(Params& p, int reps, bool inject, void* stream) {
  if (reps < 1 || p.num_tiles < 1 || p.tile < 1 || p.lane < 1 ||
      (long long)p.tile * p.lane > 0xFFFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  p.row_groups = (p.tile + kGroupRows - 1) / kGroupRows;
  p.lane_chunks = (p.lane + kThreads - 1) / kThreads;
  const long long blocks =
      (long long)reps * p.num_tiles * p.row_groups * p.lane_chunks;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inject) {
    mc_alamouti_kernel<true><<<(unsigned int)blocks, kThreads, 0, s>>>(p);
  } else {
    mc_alamouti_kernel<false><<<(unsigned int)blocks, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the streams keyed by seed.
extern "C" int mc_alamouti_prng(void* out, int reps, int num_tiles, int tile,
                                int lane, float amp, unsigned int seed,
                                long long start, void* stream) {
  Params p = {};
  p.out = static_cast<int*>(out);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.amp = amp;
  p.seed = seed;
  p.start = start;
  return launch(p, reps, false, stream);
}

// Bits read from int32 device tensors in the JAX layout (the counterpart of
// build_inject): ch (reps, >= 4, lane) with strides (ch_rep_stride,
// ch_row_stride, 1); d and the four noise tensors (reps, num_tiles * tile,
// lane) with the strides (d_rep_stride, d_row_stride, 1).
extern "C" int mc_alamouti_inject(const void* ch, const void* d,
                                  const void* n1r, const void* n1i,
                                  const void* n2r, const void* n2i, void* out,
                                  int reps, int num_tiles, int tile, int lane,
                                  float amp, long long ch_rep_stride,
                                  long long ch_row_stride,
                                  long long d_rep_stride,
                                  long long d_row_stride, void* stream) {
  Params p = {};
  p.ch = static_cast<const int*>(ch);
  p.d = static_cast<const int*>(d);
  p.n1r = static_cast<const int*>(n1r);
  p.n1i = static_cast<const int*>(n1i);
  p.n2r = static_cast<const int*>(n2r);
  p.n2i = static_cast<const int*>(n2i);
  p.ch_rep_stride = ch_rep_stride;
  p.ch_row_stride = ch_row_stride;
  p.d_rep_stride = d_rep_stride;
  p.d_row_stride = d_row_stride;
  p.out = static_cast<int*>(out);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.amp = amp;
  return launch(p, reps, true, stream);
}
