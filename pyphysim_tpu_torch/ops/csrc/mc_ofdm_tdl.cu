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
// These instances take up to 32 taps and 1,024 (tap, ray) pairs; every
// other shape the TPU kernel takes runs in the general form below
// (mc_ofdm_tdl_general_kernel). The host cuts a call of more than 65,535
// reps or tiles into launches of at most that many of each
// (ops/mc_kernel.py launch_slices), each from its first tile (tile0).
// Phases: the argument t C cos(phi) + psi reaches ~28 rad at t = 4096, so it
// is reduced by hand (Cody-Waite, 2 pi in two parts) to [-pi, pi], where
// __sincosf is within 2^-21.4; the phase's own f32 rounding at t = 4096 is
// ~1e-6. cos(phi) takes a polynomial on a quadrant-reduced argument, so no
// libm slow path (and no loop) enters the listing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_info.cuh"
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
  int num_tiles;   // tiles of the call: a rep's row of out
  int tile, used, TL, T, L;
  int rows_log2;   // log2 of the rows of a block (make_plan's)
  int bin_chunks;  // blocks across the used bins
  // this launch's first tile. Where it sits moves both forms' code: after
  // num_tiles the fast instance issues more (17,598 SASS a thread at the
  // flagship against 17,144 at the end of the struct), at the end the
  // general form runs 2-5 % slower (bin/tune_mc_kernel.py
  // LAYOUT_VARIANTS on an H100); here the fast instance runs fastest of
  // the three places and the general form within 0.5 % of its fastest.
  int tile0;
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
                          ((long long)tile_idx * p.tile + s) * p.d_row_stride +
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
  const int tile_idx = p.tile0 + blockIdx.y;
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

// The general form: more than 32 taps or more than 1,024 (tap, ray) pairs.
// The fast instances above hold G_tap (at most 32 taps) in registers and
// the pairs in a static 8 KB; this form keeps their arithmetic in the same
// order (a tap's rays summed l = 0..L-1, the product's four partial sums
// over the taps in order, the same epilogue), so at 32 taps or fewer it
// gives their counts bit for bit. What bounds it on the card: instruction
// issue, as the fast form (at 51 taps of 32 rays ~2.2x the fast form's
// instructions a symbol: the product is 204 FFMA a symbol, not 64). The
// first general form reached 42 % of that bound: it padded the taps to 32
// (F1's 51 to 64: a fifth of its product on zeros), read h and the pairs
// through generic loads (its slot could be global), reloaded 32 taps of
// G_tap from L1 / L2 every 4 rows with the latency exposed, and ran one
// block of 10 warps a SM between barriers. This form:
//   * pads the taps to a multiple of kChunk (8), the taps of G_tap it
//     holds in registers at once (bin/tune_mc_kernel.py measured 8
//     fastest: 16 or 32 taps a chunk held more registers for no fewer
//     stalls);
//   * holds kGroup rows' partial sums a thread, so one G_tap chunk feeds
//     4 * kGroup * kChunk FFMA and its reload (from L1: G_tap's 134 KB at
//     51 taps sit beside two blocks' slots) waits behind other warps';
//   * has an instance for a slot in shared memory (kScratch false: every
//     read of h and of the pairs is an LDS) beside the scratch-buffer one
//     for slots past 227 KB (General::scratch);
//   * caps a block at kGenThreads bins and its registers by
//     __launch_bounds__ for kGenMinBlocks blocks a SM (94 registers, no
//     spill), and shrinks the rows a block until h takes a quarter of a
//     SM's shared memory, so one block's tap sums (the XU pipe: sincos,
//     rint) overlap another's product (the FMA pipe); one block a SM ran
//     34 % slower;
//   * folds (rep, tile, rows, bins) into a one-dimensional grid with
//     64-bit index math, each block walking blocks of that space.
// A call of more than 65,535 reps or tiles is cut into launches on the host
// (ops/mc_kernel.py launch_slices), each from its first tile (Params::
// tile0), so tiles past the fast instances' grid y run those instances.
constexpr int kChunk = 8;            // taps of G_tap in registers at once
constexpr int kGroup = 8;            // rows whose partial sums a thread holds
constexpr int kGenThreads = 320;     // bins a block of the general form
constexpr int kGenMinBlocks = 2;     // resident blocks a SM (registers)
constexpr long long kMaxSmem = 232448 - 1024;  // a block's dynamic bytes
                                     // (227 KB less the static reduction)
constexpr long long kMaxGrid = 1 << 24;       // blocks launched, shared memory
constexpr int kScratchBlocksPerSm = 4;        // slots a SM, past shared memory
static_assert(kGroup <= 8 && kChunk % 2 == 0,
              "a block holds at least 8 rows (a tile's least); a chunk is "
              "whole float4 pairs of taps");

struct General {
  const float2* g2;        // G_tap as (re, im) pairs, (Tp, used), zero past T
  float* scratch;          // slots of slot_floats each, or null
  long long slot_floats;   // a block's wl, psi (TLe each), then h
  long long blocks;        // reps * tiles * row_blocks * bin_chunks
  int tiles;               // tiles of this launch, from Params::tile0
  int TLe;                 // TL rounded up to even (h 16-byte aligned)
  int Tp;                  // taps rounded up to kChunk
  int h_stride;            // float2 a row of h: Tp + 2
  int row_blocks;          // tile >> rows_log2
};

// kC taps of G_tap (gp: tap 0 of the chunk at this thread's bin, taps
// `used` apart) against the rows of h from `h` on (h_stride float2 apart):
// kGroup rows' four partial sums, two taps a float4 of h, in tap order.
template <int kC>
__device__ __forceinline__ void product_chunk(
    const float2* __restrict__ gp, long long used, const float2* h,
    int h_stride, float (&ar)[kGroup], float (&br)[kGroup],
    float (&ai)[kGroup], float (&bi)[kGroup]) {
  float gr[kC], gi[kC];
#pragma unroll
  for (int t = 0; t < kC; ++t) {
    const float2 gt = __ldg(gp + t * used);
    gr[t] = gt.x;
    gi[t] = gt.y;
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float4* h4 = reinterpret_cast<const float4*>(h + j * h_stride);
#pragma unroll
    for (int q = 0; q < kC / 2; ++q) {
      const float4 v = h4[q];
      ar[j] = fmaf(v.x, gr[2 * q], ar[j]);
      br[j] = fmaf(-v.y, gi[2 * q], br[j]);
      ai[j] = fmaf(v.x, gi[2 * q], ai[j]);
      bi[j] = fmaf(v.y, gr[2 * q], bi[j]);
      ar[j] = fmaf(v.z, gr[2 * q + 1], ar[j]);
      br[j] = fmaf(-v.w, gi[2 * q + 1], br[j]);
      ai[j] = fmaf(v.z, gi[2 * q + 1], ai[j]);
      bi[j] = fmaf(v.w, gr[2 * q + 1], bi[j]);
    }
  }
}

template <bool kInject, bool kBf16, bool kScratch>
__global__ void __launch_bounds__(kGenThreads, kGenMinBlocks)
    mc_ofdm_tdl_general_kernel(const Params p, const General g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_warp_sum[kGenThreads / 32];
  float* slot =
      kScratch ? g.scratch + (long long)blockIdx.x * g.slot_floats : smem;
  float* s_wl = slot;
  float* s_psi = slot + g.TLe;
  float2* s_h = reinterpret_cast<float2*>(slot + 2 * g.TLe);
  const int nrows = 1 << p.rows_log2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

#pragma unroll 1
  for (long long b = blockIdx.x; b < g.blocks; b += gridDim.x) {
    // b = ((rep * tiles + tile) * row_blocks + row_block) * bin_chunks
    //     + chunk
    const int chunk = (int)(b % p.bin_chunks);
    long long q = b / p.bin_chunks;
    const int row_block = (int)(q % g.row_blocks);
    q /= g.row_blocks;
    const int tile_idx = p.tile0 + (int)(q % g.tiles);
    const int rep = (int)(q / g.tiles);
    const int row0 = row_block * nrows;
    const unsigned long long attempt =
        (unsigned long long)(p.start + (long long)rep);
    const uint32_t att_lo = (uint32_t)attempt;
    const uint32_t att_hi = (uint32_t)(attempt >> 32);

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

    // h[row, tap], taps T..Tp-1 zero
    const long long t_base = (long long)tile_idx * p.tile + row0;
#pragma unroll 1
    for (int k = threadIdx.x; k < (g.Tp << p.rows_log2); k += blockDim.x) {
      const int r = k & (nrows - 1);
      const int tap = k >> p.rows_log2;
      float hr = 0.f, hi = 0.f;
      if (tap < p.T) {
        const float t = (float)(t_base + r);
        const float* wl = s_wl + (long long)tap * p.L;
        const float* ps = s_psi + (long long)tap * p.L;
#pragma unroll 1
        for (int l = 0; l < p.L; ++l) {
          float c, s;
          phasor<kBf16>(fmaf(t, wl[l], ps[l]), c, s);
          hr += c;
          hi += s;
        }
      }
      s_h[r * g.h_stride + tap] = make_float2(hr, hi);
    }
    __syncthreads();

    int errors = 0;
    const int u = chunk * blockDim.x + threadIdx.x;
    if (u < p.used) {
      const float2* gu = g.g2 + u;
#pragma unroll 1
      for (int r0 = 0; r0 < nrows; r0 += kGroup) {
        float ar[kGroup], br[kGroup], ai[kGroup], bi[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) ar[j] = br[j] = ai[j] = bi[j] = 0.f;
        const float2* h = s_h + r0 * g.h_stride;
#pragma unroll 1
        for (int c = 0; c + kChunk <= g.Tp; c += kChunk) {
          product_chunk<kChunk>(gu + (long long)c * p.used, p.used, h + c,
                                g.h_stride, ar, br, ai, bi);
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          errors += symbol_errors<kInject>(p, ar[j] + br[j], ai[j] + bi[j],
                                           rep, tile_idx, row0 + r0 + j, u,
                                           att_lo, att_hi);
        }
      }
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      errors += __shfl_down_sync(0xffffffffu, errors, off);
    }
    if (lane == 0) s_warp_sum[warp] = errors;
    __syncthreads();
    if (warp == 0) {
      int v = lane < (int)(blockDim.x >> 5) ? s_warp_sum[lane] : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0 && v != 0) {
        atomicAdd(p.out + (long long)rep * p.num_tiles + tile_idx, v);
      }
    }
    __syncthreads();   // the slot and s_warp_sum serve the next block
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

// How a launch runs (ops/mc_kernel.py kernel_plan reads it): the fast
// instances (16 or 32 taps) while T <= 32 and TL <= kMaxTL (the launch's
// reps and tiles fit their grid's z / y dimensions and the call's 32-bit
// indices: the host cuts the call, launch_slices); else the general form,
// its rows a block shrunk (to kGroup) until h takes at most a quarter of
// kMaxSmem, its slot in shared memory or, past kMaxSmem, in scratch.
struct Plan {
  int general, rows_log2, bin_chunks, threads;
  long long smem_bytes, scratch_bytes, grid;
  General g;
};

int log2_of(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// reps and tiles: this launch's; num_tiles: the call's (a rep's row of out)
int make_plan(int reps, int tiles, int tile, int used, int TL, int T,
              int num_tiles, Plan* pl) {
  // a tile is a power of two >= 8 and T taps hold L rays each (the
  // wrapper checks); anything else is not a call of this kernel
  if (reps < 1 || tiles < 1 || num_tiles < tiles || tile < 8 ||
      (tile & (tile - 1)) || used < 1 || T < 1 || TL < T || TL % T ||
      reps > 65535 || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  *pl = Plan{};
  pl->general = !(T <= 32 && TL <= kMaxTL &&
                  (long long)reps * num_tiles <= 0x7fffffffLL &&
                  (long long)num_tiles * tile <= 0x7fffffffLL);
  const int max_threads = pl->general ? kGenThreads : kMaxThreads;
  pl->bin_chunks = (used + max_threads - 1) / max_threads;
  const int per_chunk = (used + pl->bin_chunks - 1) / pl->bin_chunks;
  pl->threads = ((per_chunk + 31) / 32) * 32;
  pl->rows_log2 = log2_of(tile < kRows ? tile : kRows);
  if (!pl->general) {
    pl->grid = (long long)(tile >> pl->rows_log2) * pl->bin_chunks;
    return 0;
  }
  General& g = pl->g;
  g.tiles = tiles;
  g.TLe = (TL + 1) & ~1;
  g.Tp = (T + kChunk - 1) / kChunk * kChunk;
  g.h_stride = g.Tp + 2;
  while (pl->rows_log2 > log2_of(kGroup) &&
         8LL * g.h_stride << pl->rows_log2 > kMaxSmem / 4) {
    --pl->rows_log2;
  }
  g.row_blocks = tile >> pl->rows_log2;
  g.slot_floats = 2LL * g.TLe + (2LL * g.h_stride << pl->rows_log2);
  g.blocks = (long long)reps * tiles * g.row_blocks * pl->bin_chunks;
  const long long slot_bytes = 4 * g.slot_floats;
  if (slot_bytes <= kMaxSmem) {
    pl->smem_bytes = slot_bytes;
    pl->grid = g.blocks < kMaxGrid ? g.blocks : kMaxGrid;
    return 0;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return (int)cudaErrorInvalidDevice;
  }
  const long long slots = (long long)sms * kScratchBlocksPerSm;
  pl->grid = g.blocks < slots ? g.blocks : slots;
  pl->scratch_bytes = pl->grid * slot_bytes;
  return 0;
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

// The general form's instance for a launch (the slot in shared memory or
// in scratch), opted in to kMaxSmem of dynamic shared memory once.
template <bool kInject, bool kBf16, bool kScratch>
auto general_instance(bool* opt_rc) {
  const auto kernel = mc_ofdm_tdl_general_kernel<kInject, kBf16, kScratch>;
  static cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  *opt_rc = opted == cudaSuccess;
  return kernel;
}

template <bool kInject, bool kBf16, bool kScratch>
int launch_general(const Params& p, const Plan& pl, cudaStream_t s) {
  bool ok = true;
  const auto kernel = general_instance<kInject, kBf16, kScratch>(&ok);
  if (!ok) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)pl.grid, pl.threads, (size_t)pl.smem_bytes, s>>>(
      p, pl.g);
  return 0;
}

template <bool kInject, bool kBf16>
int launch_general(const Params& p, const Plan& pl, cudaStream_t s) {
  return pl.scratch_bytes > 0 ? launch_general<kInject, kBf16, true>(p, pl, s)
                              : launch_general<kInject, kBf16, false>(p, pl,
                                                                      s);
}

int launch(Params& p, int reps, int tiles, bool inject, bool bf16,
           const void* g2, void* scratch, void* stream) {
  Plan pl;
  int rc = make_plan(reps, tiles, p.tile, p.used, p.TL, p.T, p.num_tiles,
                     &pl);
  if (rc != 0) return rc;
  if (p.tile0 < 0 || p.tile0 > p.num_tiles - tiles) {
    return (int)cudaErrorInvalidValue;
  }
  p.rows_log2 = pl.rows_log2;
  p.bin_chunks = pl.bin_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pl.general) {
    const dim3 grid((unsigned int)pl.grid, tiles, reps);
    if (p.T <= 16) {
      launch_taps<16>(p, grid, pl.threads, inject, bf16, s);
    } else {
      launch_taps<32>(p, grid, pl.threads, inject, bf16, s);
    }
    return (int)cudaGetLastError();
  }
  pl.g.g2 = static_cast<const float2*>(g2);
  pl.g.scratch = static_cast<float*>(scratch);
  if ((pl.scratch_bytes > 0 && scratch == nullptr) || g2 == nullptr) {
    return (int)cudaErrorInvalidValue;   // the wrapper passes both
  }
  rc = inject ? (bf16 ? launch_general<true, true>(p, pl, s)
                      : launch_general<true, false>(p, pl, s))
              : (bf16 ? launch_general<false, true>(p, pl, s)
                      : launch_general<false, false>(p, pl, s));
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of one launch (make_plan: reps and tiles of the launch, at
// most 65,535 each, num_tiles the call's) as 12 int64: general form (0 /
// 1), rows a block, blocks across the bins, threads a block, dynamic
// shared bytes, scratch bytes (0: the slot is in shared memory), blocks
// launched, blocks of the launch, taps rounded to kChunk, floats a slot,
// kChunk, kGroup.
extern "C" int mc_ofdm_tdl_plan(int reps, int tiles, int tile, int used,
                                int TL, int T, int num_tiles,
                                long long* out) {
  Plan pl;
  const int rc = make_plan(reps, tiles, tile, used, TL, T, num_tiles, &pl);
  if (rc != 0) return rc;
  const long long v[12] = {pl.general,       1LL << pl.rows_log2,
                           pl.bin_chunks,    pl.threads,
                           pl.smem_bytes,    pl.scratch_bytes,
                           pl.grid,          pl.general ? pl.g.blocks : 0,
                           pl.g.Tp,          pl.g.slot_floats,
                           kChunk,           kGroup};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// The PRNG-mode instance that launch runs (bf16: the product type) as 4
// ints: registers and local (spill) bytes a thread, static shared bytes,
// resident blocks a SM at the plan's threads and dynamic shared bytes.
extern "C" int mc_ofdm_tdl_launch_info(int reps, int tiles, int tile,
                                       int used, int TL, int T, int num_tiles,
                                       int bf16, int* out) {
  Plan pl;
  const int rc = make_plan(reps, tiles, tile, used, TL, T, num_tiles, &pl);
  if (rc != 0) return rc;
  bool ok = true;
  if (!pl.general) {
    if (T <= 16) {
      return bf16 ? instance_info(mc_ofdm_tdl_kernel<16, false, true>,
                                  pl.threads, 0, out)
                  : instance_info(mc_ofdm_tdl_kernel<16, false, false>,
                                  pl.threads, 0, out);
    }
    return bf16 ? instance_info(mc_ofdm_tdl_kernel<32, false, true>,
                                pl.threads, 0, out)
                : instance_info(mc_ofdm_tdl_kernel<32, false, false>,
                                pl.threads, 0, out);
  }
  const int threads = pl.threads;
  const long long smem = pl.smem_bytes;
  int r;
  if (pl.scratch_bytes > 0) {
    r = bf16 ? instance_info(general_instance<false, true, true>(&ok),
                             threads, smem, out)
             : instance_info(general_instance<false, false, true>(&ok),
                             threads, smem, out);
  } else {
    r = bf16 ? instance_info(general_instance<false, true, false>(&ok),
                             threads, smem, out)
             : instance_info(general_instance<false, false, false>(&ok),
                             threads, smem, out);
  }
  return ok ? r : (int)cudaErrorInvalidValue;
}

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// launch is the absolute attempt start + r of the stream keyed by seed, and
// its tiles [tile0, tile0 + tiles) of the call's num_tiles (out is (reps,
// num_tiles)). G_tap is (T, used); the TL = T * L (tap, ray) pairs draw
// their rays. g2: G_tap as (re, im) pairs, (T rounded up to kChunk, used)
// with zero rows past T, which the general form reads; scratch: a device
// buffer of mc_ofdm_tdl_plan's scratch bytes where that is not 0.
extern "C" int mc_ofdm_tdl_prng(const void* g_re, const void* g_im, void* out,
                                int reps, int num_tiles, int tile, int used,
                                int TL, int T, int M, float C, float amp,
                                float qam_scale, float inv_scale, int bf16,
                                const void* g2, unsigned int seed,
                                long long start, int tile0, int tiles,
                                void* scratch, void* stream) {
  Params p = make_params(static_cast<const float*>(g_re),
                         static_cast<const float*>(g_im),
                         static_cast<int*>(out), num_tiles, tile, used, TL,
                         T, M, C, amp, qam_scale, inv_scale);
  p.seed = seed;
  p.start = start;
  p.tile0 = tile0;
  return launch(p, reps, tiles, false, bf16 != 0, g2, scratch, stream);
}

// Bits read from int32 device tensors in the JAX layout (the counterpart of
// _make_inject_call): phase bits (reps, >= 2, >= TL), data / noise bits
// (reps, num_tiles * tile, >= used), of which this launch reads tiles
// [tile0, tile0 + tiles); only bins u < used are counted.
extern "C" int mc_ofdm_tdl_inject(
    const void* g_re, const void* g_im, const void* pb, const void* db,
    const void* n1, const void* n2, void* out, int reps, int num_tiles,
    int tile, int used, int TL, int T, int M, float C, float amp,
    float qam_scale, float inv_scale, int bf16, const void* g2,
    long long pb_rep_stride, long long pb_row_stride, long long d_rep_stride,
    long long d_row_stride, int tile0, int tiles, void* scratch,
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
  p.tile0 = tile0;
  return launch(p, reps, tiles, true, bf16 != 0, g2, scratch, stream);
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
