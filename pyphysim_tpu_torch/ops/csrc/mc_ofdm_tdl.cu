// One Monte Carlo repetition of the flagship OFDM-over-TDL chain per
// (rep, symbol tile), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/mc_pallas.py
// MonteCarloOfdmTdl._simulate_block, launched by _make_prng_call (in-kernel
// random bits) and _make_inject_call (bits read from device tensors). For
// every (rep, tile, symbol s, used bin u) it computes:
//   * the per-bin channel H[s, u] = sum_il E[s, il] G[il, u], with the Jakes
//     phasor E[s, il] = exp(j (t_s C cos(phi_il) + psi_il)) and the constant
//     (tap, ray) -> bin matrix G built on the host (ops/mc_kernel.py);
//   * a Gray-mapped square-QAM symbol from the data bits;
//   * AWGN as erfinv of clamped uniforms, scaled by amp;
//   * the one-tap equalizer, a Gray slicer and the popcount of bit errors.
// The output is one int32 error count per (rep, tile), summed with integer
// atomics into a tensor the wrapper zeroes (deterministic in any block order).
//
// What bounds it on the card: f32 FMA on the channel product. At the
// flagship shape (TL = 16 taps x 16 rays = 256, 300 used bins) E @ G is
// 4 real products of 256-deep dot products per (s, u): ~2 kFLOP per
// simulated symbol, against 12 bytes of random bits that never leave the
// chip in PRNG mode. So the design keeps the arithmetic units fed:
//   * a block owns kRows = 32 consecutive symbols of one tile, and each
//     thread one used bin u: it accumulates 32 complex H values in
//     registers, so every G element it loads (coalesced along u, from L2)
//     feeds 128 FMAs;
//   * E is built in shared memory, kIlChunk (tap, ray) pairs at a time, laid
//     out [il][row] so a warp reads 4 rows with one broadcast float4 load;
//   * the Doppler rate C cos(phi) and phase psi of every (tap, ray) pair are
//     computed once per block into shared memory;
//   * mapping, noise, equalization, slicing and popcount stay in registers;
//     a warp-shuffle + shared-memory reduction issues one atomicAdd per block.
// E is evaluated with sincosf per element (accurate, not --use_fast_math:
// the phase reaches ~28 rad at t = 4096 symbols) instead of the TPU kernel's
// log-depth phasor doubling; the plain version in ops/mc_kernel.py keeps the
// doubling, and the two differ only in the last bits. Tensor cores (wgmma
// on bf16/TF32 operands) are a later step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kRows = 32;         // symbols per block (register tile)
constexpr int kIlChunk = 64;      // (tap, ray) pairs staged per pass
constexpr int kMaxTL = 1024;      // (tap, ray) pairs a block can hold
constexpr int kMaxThreads = 512;  // one thread per used bin, swept if more
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kSqrt2 = 1.4142135623730951f;

struct Params {
  const float* g_re;  // (TL, used), row-major
  const float* g_im;
  // inject mode only: bits in the JAX layout, as int32
  const int* pb;      // phase bits, rows 0 / 1 = phi / psi
  const int* db;      // data bits
  const int* n1;      // real-noise bits
  const int* n2;      // imaginary-noise bits
  long long pb_rep_stride;
  long long pb_row_stride;
  long long d_rep_stride;
  long long d_row_stride;
  int* out;  // (reps, num_tiles), zeroed by the wrapper
  int num_tiles, tile, used, TL;
  int M, Lq, half_bits;
  float C, amp, qam_scale, inv_scale;
  uint32_t seed;
  long long start;
};

// uint32 bits -> f32 uniform in [0, 1) / [-1, 1) from the signed int32 view,
// exactly as mc_pallas.py _u01 / _u11 (the scale is a power of two, so an
// FMA contraction rounds the same way as a multiply then an add).
__device__ __forceinline__ float u01(uint32_t bits) {
  return (float)(int)bits * 2.3283064365386963e-10f + 0.5f;
}

__device__ __forceinline__ float u11(uint32_t bits) {
  return (float)(int)bits * 4.656612873077393e-10f;
}

// inverse Gray code, exact below 8 bits
__device__ __forceinline__ int inv_gray(int p) {
  p ^= p >> 1;
  p ^= p >> 2;
  p ^= p >> 4;
  return p;
}

__device__ __forceinline__ void cmac(float& acc_re, float& acc_im, float er,
                                     float ei, float gr, float gi) {
  acc_re = fmaf(er, gr, acc_re);
  acc_re = fmaf(-ei, gi, acc_re);
  acc_im = fmaf(er, gi, acc_im);
  acc_im = fmaf(ei, gr, acc_im);
}

// Bit errors of symbol s of tile tile_idx on used bin u, given its channel.
template <bool kInject>
__device__ __forceinline__ int symbol_errors(const Params& p, float hr,
                                             float hi, int rep, int tile_idx,
                                             int s, int u, uint32_t att_lo,
                                             uint32_t att_hi) {
  uint32_t dbits, w1, w2;
  if (kInject) {
    const long long off = rep * p.d_rep_stride +
                          (long long)(tile_idx * p.tile + s) * p.d_row_stride +
                          u;
    dbits = (uint32_t)p.db[off];
    w1 = (uint32_t)p.n1[off];
    w2 = (uint32_t)p.n2[off];
  } else {
    const uint4 x = philox4x32_10(
        make_uint4((uint32_t)(s * p.used + u), (uint32_t)tile_idx, att_lo,
                   att_hi),
        make_uint2(p.seed, 1u));
    dbits = x.x;
    w1 = x.y;
    w2 = x.z;
  }
  // arithmetic Gray QAM map
  const int idx = (int)(dbits & (uint32_t)(p.M - 1));
  const int col = idx & (p.Lq - 1);
  const int row = idx >> p.half_bits;
  const int jj = col ^ (col >> 1);
  const int ii = row ^ (row >> 1);
  const float xr = (float)(2 * jj - (p.Lq - 1)) * p.inv_scale;
  const float xi = (float)((p.Lq - 1) - 2 * ii) * p.inv_scale;
  // AWGN by inverse CDF; both tails clamped so erfinv never sees +-1
  const float z1 = fminf(fmaxf(u11(w1), -0.99999994f), 0.99999994f);
  const float z2 = fminf(fmaxf(u11(w2), -0.99999994f), 0.99999994f);
  const float nr = erfinvf(z1) * kSqrt2;
  const float ni = erfinvf(z2) * kSqrt2;
  const float yr = xr * hr - xi * hi + p.amp * nr;
  const float yi = xr * hi + xi * hr + p.amp * ni;
  // one-tap equalizer (the 1e-30 floor stays in the normal f32 range)
  const float den = hr * hr + hi * hi + 1e-30f;
  const float eqr = (yr * hr + yi * hi) / den;
  const float eqi = (yi * hr - yr * hi) / den;
  // Gray slicer: floor(x + 0.5), clamped to the constellation
  const float lq1 = (float)(p.Lq - 1);
  const int colp = (int)fminf(
      fmaxf(floorf((eqr * p.qam_scale + lq1) * 0.5f + 0.5f), 0.f), lq1);
  const int rowp = (int)fminf(
      fmaxf(floorf((lq1 - eqi * p.qam_scale) * 0.5f + 0.5f), 0.f), lq1);
  const int decided = (inv_gray(rowp) << p.half_bits) | inv_gray(colp);
  return __popc(idx ^ decided);
}

template <bool kInject>
__global__ void __launch_bounds__(kMaxThreads)
    mc_ofdm_tdl_kernel(const Params p) {
  __shared__ float s_wl[kMaxTL];
  __shared__ float s_psi[kMaxTL];
  __shared__ __align__(16) float s_ere[kIlChunk][kRows];
  __shared__ __align__(16) float s_eim[kIlChunk][kRows];
  __shared__ int s_warp_sum[kMaxThreads / 32];

  const int row0 = blockIdx.x * kRows;
  const int tile_idx = blockIdx.y;
  const int rep = blockIdx.z;
  const unsigned long long attempt =
      (unsigned long long)(p.start + (long long)rep);
  const uint32_t att_lo = (uint32_t)attempt;
  const uint32_t att_hi = (uint32_t)(attempt >> 32);

  // Doppler rate and phase of every (tap, ray) pair; the same rays for
  // every tile of a repetition
  for (int il = threadIdx.x; il < p.TL; il += blockDim.x) {
    uint32_t phi_bits, psi_bits;
    if (kInject) {
      const int* pb = p.pb + rep * p.pb_rep_stride;
      phi_bits = (uint32_t)pb[il];
      psi_bits = (uint32_t)pb[p.pb_row_stride + il];
    } else {
      const uint4 x = philox4x32_10(
          make_uint4((uint32_t)il, 0u, att_lo, att_hi),
          make_uint2(p.seed, 0u));
      phi_bits = x.x;
      psi_bits = x.y;
    }
    s_wl[il] = p.C * cosf(u01(phi_bits) * kTwoPi);
    s_psi[il] = u01(psi_bits) * kTwoPi;
  }

  int errors = 0;
  for (int u0 = 0; u0 < p.used; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    const bool active = u < p.used;
    float acc_re[kRows], acc_im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc_re[r] = 0.f;
      acc_im[r] = 0.f;
    }

    for (int il0 = 0; il0 < p.TL; il0 += kIlChunk) {
      const int n_il = min(kIlChunk, p.TL - il0);
      __syncthreads();  // s_wl / s_psi written, previous chunk consumed
      for (int k = threadIdx.x; k < kIlChunk * kRows; k += blockDim.x) {
        const int c = k / kRows;
        const int r = k % kRows;
        float er = 0.f, ei = 0.f;
        if (c < n_il) {
          const float t = (float)(tile_idx * p.tile + row0 + r);
          sincosf(t * s_wl[il0 + c] + s_psi[il0 + c], &ei, &er);
        }
        s_ere[c][r] = er;
        s_eim[c][r] = ei;
      }
      __syncthreads();
      if (active) {
        const float* gr_p = p.g_re + (size_t)il0 * p.used + u;
        const float* gi_p = p.g_im + (size_t)il0 * p.used + u;
#pragma unroll 2
        for (int c = 0; c < n_il; ++c) {
          const float gr = __ldg(gr_p + (size_t)c * p.used);
          const float gi = __ldg(gi_p + (size_t)c * p.used);
          const float4* er4 = reinterpret_cast<const float4*>(s_ere[c]);
          const float4* ei4 = reinterpret_cast<const float4*>(s_eim[c]);
#pragma unroll
          for (int q = 0; q < kRows / 4; ++q) {
            const float4 a = er4[q];
            const float4 b = ei4[q];
            cmac(acc_re[4 * q + 0], acc_im[4 * q + 0], a.x, b.x, gr, gi);
            cmac(acc_re[4 * q + 1], acc_im[4 * q + 1], a.y, b.y, gr, gi);
            cmac(acc_re[4 * q + 2], acc_im[4 * q + 2], a.z, b.z, gr, gi);
            cmac(acc_re[4 * q + 3], acc_im[4 * q + 3], a.w, b.w, gr, gi);
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < p.tile) {
          errors += symbol_errors<kInject>(p, acc_re[r], acc_im[r], rep,
                                           tile_idx, row0 + r, u, att_lo,
                                           att_hi);
        }
      }
    }
  }

  // block reduction -> one integer atomic per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    errors += __shfl_down_sync(0xffffffffu, errors, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_warp_sum[warp] = errors;
  __syncthreads();
  if (warp == 0) {
    int v = lane < (int)(blockDim.x >> 5) ? s_warp_sum[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0 && v != 0) {
      atomicAdd(p.out + rep * p.num_tiles + tile_idx, v);
    }
  }
}

__global__ void philox_fill_kernel(const uint32_t* __restrict__ ctr,
                                   const uint32_t* __restrict__ key,
                                   uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 x = philox4x32_10(
      make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]),
      make_uint2(key[0], key[1]));
  out[4 * i] = x.x;
  out[4 * i + 1] = x.y;
  out[4 * i + 2] = x.z;
  out[4 * i + 3] = x.w;
}

Params make_params(const float* g_re, const float* g_im, int* out,
                   int num_tiles, int tile, int used, int TL, int M, float C,
                   float amp, float qam_scale, float inv_scale) {
  Params p = {};
  p.g_re = g_re;
  p.g_im = g_im;
  p.out = out;
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.used = used;
  p.TL = TL;
  p.M = M;
  int bits = 0;
  while ((1 << bits) < M) ++bits;
  p.half_bits = bits / 2;
  p.Lq = 1 << p.half_bits;
  p.C = C;
  p.amp = amp;
  p.qam_scale = qam_scale;
  p.inv_scale = inv_scale;
  return p;
}

int launch(const Params& p, int reps, bool inject, void* stream) {
  if (p.TL > kMaxTL || reps > 65535 || p.num_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = min(((p.used + 31) / 32) * 32, kMaxThreads);
  const dim3 grid((p.tile + kRows - 1) / kRows, p.num_tiles, reps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inject) {
    mc_ofdm_tdl_kernel<true><<<grid, threads, 0, s>>>(p);
  } else {
    mc_ofdm_tdl_kernel<false><<<grid, threads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the stream keyed by seed.
extern "C" int mc_ofdm_tdl_prng(const void* g_re, const void* g_im, void* out,
                                int reps, int num_tiles, int tile, int used,
                                int TL, int M, float C, float amp,
                                float qam_scale, float inv_scale,
                                unsigned int seed, long long start,
                                void* stream) {
  Params p = make_params(static_cast<const float*>(g_re),
                         static_cast<const float*>(g_im),
                         static_cast<int*>(out), num_tiles, tile, used,
                         TL, M, C, amp, qam_scale, inv_scale);
  p.seed = seed;
  p.start = start;
  return launch(p, reps, false, stream);
}

// Bits read from int32 device tensors in the JAX layout (the counterpart of
// _make_inject_call): phase bits (reps, >= 2, >= TL), data / noise bits
// (reps, num_tiles * tile, >= used); only bins u < used are counted.
extern "C" int mc_ofdm_tdl_inject(
    const void* g_re, const void* g_im, const void* pb, const void* db,
    const void* n1, const void* n2, void* out, int reps, int num_tiles,
    int tile, int used, int TL, int M, float C, float amp, float qam_scale,
    float inv_scale, long long pb_rep_stride, long long pb_row_stride,
    long long d_rep_stride, long long d_row_stride, void* stream) {
  Params p = make_params(static_cast<const float*>(g_re),
                         static_cast<const float*>(g_im),
                         static_cast<int*>(out), num_tiles, tile, used,
                         TL, M, C, amp, qam_scale, inv_scale);
  p.pb = static_cast<const int*>(pb);
  p.db = static_cast<const int*>(db);
  p.n1 = static_cast<const int*>(n1);
  p.n2 = static_cast<const int*>(n2);
  p.pb_rep_stride = pb_rep_stride;
  p.pb_row_stride = pb_row_stride;
  p.d_rep_stride = d_rep_stride;
  p.d_row_stride = d_row_stride;
  return launch(p, reps, true, stream);
}

// Philox4x32-10 of n counters (n x 4 words) under one key (2 words), all
// uint32 on the device: the bit-for-bit check of philox.cuh against
// ops/philox.py.
extern "C" int philox_fill(const void* counters, const void* key, void* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  philox_fill_kernel<<<(unsigned int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters),
      static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
