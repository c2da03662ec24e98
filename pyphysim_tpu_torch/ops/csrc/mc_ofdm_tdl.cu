// One Monte Carlo repetition of the flagship OFDM-over-TDL chain per
// (rep, symbol tile), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/mc_pallas.py
// MonteCarloOfdmTdl._simulate_block, launched by _make_prng_call (in-kernel
// random bits) and _make_inject_call (bits read from device tensors). For
// every (rep, tile, symbol s, used bin u) it computes:
//   * the per-bin channel H[s, u] = sum_l E[s, l] G[l, u] over the (tap,
//     ray) pairs l, with the Jakes phasor E[s, l] = exp(j (t_s C cos(phi_l)
//     + psi_l)) and the constant (tap, ray) -> bin matrix G of the host
//     (ops/mc_kernel.py);
//   * a Gray-mapped square-QAM symbol from the data bits;
//   * AWGN as erfinv of clamped uniforms, scaled by amp;
//   * the one-tap equalizer, a Gray slicer and the popcount of bit errors.
// The output is one int32 error count per (rep, tile), summed with integer
// atomics into a tensor the wrapper zeroes (deterministic in any block order).
//
// The rays are summed per tap. G's rows repeat within a tap (its rows are
// np.repeat over the rays of each tap), so
//   H[s, u] = sum_t (sum_r E[s, t, r]) G_tap[t, u],
// a product 16 deep at the flagship geometry (16 taps x 16 rays) instead of
// the TPU kernel's 256: the depth was free on its matrix unit and is not on
// this card. The host checks the repetition and hands G_tap (T, used).
//
// What bounds it on the card: instruction issue. In PRNG mode nothing is
// read per symbol. After the collapse the product is 64 FFMA per symbol;
// the rest is the per-symbol epilogue (one Philox4x32-10 call, two erfinvf,
// one division, the Gray map, the slicer and the popcount) and ~0.85
// phasors per symbol for the tap sums. No pipe is full at that mix, so the
// SM's four schedulers, one warp instruction per clock each, set the bound
// (ops/sass.py counts the instructions from the built library: ~268 a
// symbol). Tensor cores are not used: after the collapse the product is
// ~24 % of the issued instructions, and a wgmma tile would have to hand its
// results back in the epilogue's per-(row, bin) layout; at most it would
// remove that 24 %.
//
// The design:
//   * a block owns kRows consecutive symbols of one (rep, tile) and up to
//     kMaxThreads used bins (one thread per bin);
//   * prologue: the Doppler rate C cos(phi) and phase psi of every (tap, ray)
//     pair into shared memory; then each thread takes (row, tap) pairs and
//     sums the L phasors of that tap in registers (each rounded to bf16
//     first in the bf16 mode) into h[row, tap] in shared memory;
//   * body: a thread keeps G_tap[:, u] in registers and walks the block's
//     rows: kTaps complex MACs against the row of h (broadcast float4
//     loads), then the epilogue; one Philox call per symbol;
//   * a warp-shuffle + shared-memory reduction and one integer atomicAdd per
//     block.
// Phases: the argument t C cos(phi) + psi reaches ~28 rad at t = 4096, so it
// is reduced by hand (Cody-Waite, 2 pi in two parts) to [-pi, pi], where
// __sincosf is within 2^-21.4; the phase's own f32 rounding at t = 4096 is
// ~1e-6. cos(phi) takes a polynomial on a quadrant-reduced argument, so no
// libm slow path (and no loop) enters the listing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kRows = 64;         // symbols per block (ops/mc_kernel.py _ROWS)
constexpr int kMaxTL = 1024;      // (tap, ray) pairs a block holds
constexpr int kMaxThreads = 512;  // bins per block; more bins, more blocks
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kTwoPiHi = 6.28318548202514648f;     // f32(2 pi)
constexpr float kTwoPiLo = -1.7484555314695172e-7f;  // 2 pi - kTwoPiHi
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoOverPi = 0.63661977236758134f;
constexpr float kPiO2Hi = 1.5703125f;                // pi / 2 in three parts
constexpr float kPiO2Mid = 4.837512969970703125e-4f;
constexpr float kPiO2Lo = 7.54978995489188216e-8f;
constexpr float kSqrt2 = 1.4142135623730951f;

struct Params {
  const float* g_re;  // G_tap (T, used), row-major
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
  int num_tiles, tile, used, TL, T, L;
  int rows_log2;   // log2 of the rows of a block: min(kRows, tile)
  int bin_chunks;  // blocks across the used bins
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

// cos(x) for |x| < 2^16: x - j pi/2 in three exact parts, then the minimax
// polynomials of sin / cos on [-pi/4, pi/4] (within ~2 ulp), picked by the
// quadrant j without a branch.
__device__ __forceinline__ float cos_reduced(float x) {
  const float j = rintf(x * kTwoOverPi);
  float r = fmaf(j, -kPiO2Hi, x);
  r = fmaf(j, -kPiO2Mid, r);
  r = fmaf(j, -kPiO2Lo, r);
  const float z = r * r;
  const float c = fmaf(fmaf(fmaf(2.443315711809948e-5f, z,
                                 -1.388731625493765e-3f), z,
                            4.166664568298827e-2f), z * z,
                       fmaf(-0.5f, z, 1.0f));
  const float s = fmaf(fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                            -1.6666654611e-1f), z * r, r);
  const int q = (int)j & 3;
  const float v = (q & 1) ? s : c;
  return (q == 1 || q == 2) ? -v : v;
}

// e^{jx}, the argument reduced to [-pi, pi] first; rounded to bf16 (round
// to nearest even, as astype(bfloat16)) in the bf16 mode.
template <bool kBf16>
__device__ __forceinline__ void phasor(float x, float& c, float& s) {
  const float k = rintf(x * kInvTwoPi);
  float r = fmaf(k, -kTwoPiHi, x);
  r = fmaf(k, -kTwoPiLo, r);
  __sincosf(r, &s, &c);
  if (kBf16) {
    c = __bfloat162float(__float2bfloat16_rn(c));
    s = __bfloat162float(__float2bfloat16_rn(s));
  }
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
  // one-tap equalizer, one reciprocal for both parts (the 1e-30 floor stays
  // in the normal f32 range)
  const float inv = 1.0f / (hr * hr + hi * hi + 1e-30f);
  const float eqr = (yr * hr + yi * hi) * inv;
  const float eqi = (yi * hr - yr * hi) * inv;
  // Gray slicer: floor(x + 0.5), clamped to the constellation
  const float lq1 = (float)(p.Lq - 1);
  const int colp = (int)fminf(
      fmaxf(floorf((eqr * p.qam_scale + lq1) * 0.5f + 0.5f), 0.f), lq1);
  const int rowp = (int)fminf(
      fmaxf(floorf((lq1 - eqi * p.qam_scale) * 0.5f + 0.5f), 0.f), lq1);
  const int decided = (inv_gray(rowp) << p.half_bits) | inv_gray(colp);
  return __popc(idx ^ decided);
}

template <int kTaps, bool kInject, bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
    mc_ofdm_tdl_kernel(const Params p) {
  __shared__ float s_wl[kMaxTL];
  __shared__ float s_psi[kMaxTL];
  // h[row, tap] as (re, im); a row is kTaps / 2 float4 (stride padded)
  __shared__ __align__(16) float2 s_h[kRows][kTaps + 2];
  __shared__ int s_warp_sum[kMaxThreads / 32];

  const int row_block = blockIdx.x / p.bin_chunks;
  const int chunk = blockIdx.x - row_block * p.bin_chunks;
  const int nrows = 1 << p.rows_log2;
  const int row0 = row_block * nrows;
  const int tile_idx = blockIdx.y;
  const int rep = blockIdx.z;
  const unsigned long long attempt =
      (unsigned long long)(p.start + (long long)rep);
  const uint32_t att_lo = (uint32_t)attempt;
  const uint32_t att_hi = (uint32_t)(attempt >> 32);

  // Doppler rate and phase of every (tap, ray) pair; the same rays for
  // every tile of a repetition
#pragma unroll 1
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
    s_wl[il] = p.C * cos_reduced(u01(phi_bits) * kTwoPi);
    s_psi[il] = u01(psi_bits) * kTwoPi;
  }
  __syncthreads();

  // tap sums h[row, tap] = sum_r e^{j(t w + psi)} over the tap's rays; a
  // warp takes consecutive rows of one tap (broadcast reads of the rays)
  const int t_base = tile_idx * p.tile + row0;
#pragma unroll 1
  for (int k = threadIdx.x; k < (kTaps << p.rows_log2); k += blockDim.x) {
    const int r = k & (nrows - 1);
    const int tap = k >> p.rows_log2;
    float hr = 0.f, hi = 0.f;
    if (tap < p.T) {
      const float t = (float)(t_base + r);
      const float* wl = s_wl + tap * p.L;
      const float* ps = s_psi + tap * p.L;
#pragma unroll 1
      for (int l = 0; l < p.L; ++l) {
        float c, s;
        phasor<kBf16>(fmaf(t, wl[l], ps[l]), c, s);
        hr += c;
        hi += s;
      }
    }
    s_h[r][tap] = make_float2(hr, hi);
  }
  __syncthreads();

  int errors = 0;
  const int u = chunk * blockDim.x + threadIdx.x;
  if (u < p.used) {
    float gr[kTaps], gi[kTaps];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const bool on = t < p.T;
      gr[t] = on ? __ldg(p.g_re + (size_t)t * p.used + u) : 0.f;
      gi[t] = on ? __ldg(p.g_im + (size_t)t * p.used + u) : 0.f;
    }
#pragma unroll 1
    for (int r = 0; r < nrows; ++r) {
      const float4* h4 = reinterpret_cast<const float4*>(&s_h[r][0]);
      // four partial sums: two chains of kTaps FFMA each per part
      float ar = 0.f, br = 0.f, ai = 0.f, bi = 0.f;
#pragma unroll
      for (int q = 0; q < kTaps / 2; ++q) {
        const float4 v = h4[q];
        ar = fmaf(v.x, gr[2 * q], ar);
        br = fmaf(-v.y, gi[2 * q], br);
        ai = fmaf(v.x, gi[2 * q], ai);
        bi = fmaf(v.y, gr[2 * q], bi);
        ar = fmaf(v.z, gr[2 * q + 1], ar);
        br = fmaf(-v.w, gi[2 * q + 1], br);
        ai = fmaf(v.z, gi[2 * q + 1], ai);
        bi = fmaf(v.w, gr[2 * q + 1], bi);
      }
      errors += symbol_errors<kInject>(p, ar + br, ai + bi, rep, tile_idx,
                                       row0 + r, u, att_lo, att_hi);
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
                   int num_tiles, int tile, int used, int TL, int T, int M,
                   float C, float amp, float qam_scale, float inv_scale) {
  Params p = {};
  p.g_re = g_re;
  p.g_im = g_im;
  p.out = out;
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.used = used;
  p.TL = TL;
  p.T = T;
  p.L = T > 0 ? TL / T : 0;
  const int rows = tile < kRows ? tile : kRows;
  while ((1 << p.rows_log2) < rows) ++p.rows_log2;
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

template <int kTaps>
void launch_taps(const Params& p, dim3 grid, int threads, bool inject,
                 bool bf16, cudaStream_t s) {
  if (inject) {
    if (bf16) {
      mc_ofdm_tdl_kernel<kTaps, true, true><<<grid, threads, 0, s>>>(p);
    } else {
      mc_ofdm_tdl_kernel<kTaps, true, false><<<grid, threads, 0, s>>>(p);
    }
  } else if (bf16) {
    mc_ofdm_tdl_kernel<kTaps, false, true><<<grid, threads, 0, s>>>(p);
  } else {
    mc_ofdm_tdl_kernel<kTaps, false, false><<<grid, threads, 0, s>>>(p);
  }
}

int launch(Params& p, int reps, bool inject, bool bf16, void* stream) {
  // tile: a power of two >= 8 (the wrapper checks); T taps of L rays
  if (p.TL > kMaxTL || p.T < 1 || p.T > 32 || p.T * p.L != p.TL ||
      (1 << p.rows_log2) > p.tile || p.tile % (1 << p.rows_log2) != 0 ||
      reps > 65535 || p.num_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  p.bin_chunks = (p.used + kMaxThreads - 1) / kMaxThreads;
  const int per_chunk = (p.used + p.bin_chunks - 1) / p.bin_chunks;
  const int threads = ((per_chunk + 31) / 32) * 32;
  const dim3 grid((p.tile >> p.rows_log2) * p.bin_chunks, p.num_tiles, reps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.T <= 16) {
    launch_taps<16>(p, grid, threads, inject, bf16, s);
  } else {
    launch_taps<32>(p, grid, threads, inject, bf16, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the stream keyed by seed. G_tap
// is (T, used); the TL = T * L (tap, ray) pairs draw their rays.
extern "C" int mc_ofdm_tdl_prng(const void* g_re, const void* g_im, void* out,
                                int reps, int num_tiles, int tile, int used,
                                int TL, int T, int M, float C, float amp,
                                float qam_scale, float inv_scale, int bf16,
                                unsigned int seed, long long start,
                                void* stream) {
  Params p = make_params(static_cast<const float*>(g_re),
                         static_cast<const float*>(g_im),
                         static_cast<int*>(out), num_tiles, tile, used, TL,
                         T, M, C, amp, qam_scale, inv_scale);
  p.seed = seed;
  p.start = start;
  return launch(p, reps, false, bf16 != 0, stream);
}

// Bits read from int32 device tensors in the JAX layout (the counterpart of
// _make_inject_call): phase bits (reps, >= 2, >= TL), data / noise bits
// (reps, num_tiles * tile, >= used); only bins u < used are counted.
extern "C" int mc_ofdm_tdl_inject(
    const void* g_re, const void* g_im, const void* pb, const void* db,
    const void* n1, const void* n2, void* out, int reps, int num_tiles,
    int tile, int used, int TL, int T, int M, float C, float amp,
    float qam_scale, float inv_scale, int bf16, long long pb_rep_stride,
    long long pb_row_stride, long long d_rep_stride, long long d_row_stride,
    void* stream) {
  Params p = make_params(static_cast<const float*>(g_re),
                         static_cast<const float*>(g_im),
                         static_cast<int*>(out), num_tiles, tile, used, TL,
                         T, M, C, amp, qam_scale, inv_scale);
  p.pb = static_cast<const int*>(pb);
  p.db = static_cast<const int*>(db);
  p.n1 = static_cast<const int*>(n1);
  p.n2 = static_cast<const int*>(n2);
  p.pb_rep_stride = pb_rep_stride;
  p.pb_row_stride = pb_row_stride;
  p.d_rep_stride = d_rep_stride;
  p.d_row_stride = d_row_stride;
  return launch(p, reps, true, bf16 != 0, stream);
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
