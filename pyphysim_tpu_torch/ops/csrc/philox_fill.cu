// The per-attempt random streams' draws (ops/streams.py) in one launch.
//
// No TPU kernel's counterpart: the JAX package draws its streams inside
// its jitted step. The port's plain version (ops/streams.py, Philox in
// torch int64 ops) issues ~300 small kernels a draw, so a chain step spent
// most of its time launching them. This kernel draws the same bits:
// row r is Philox4x32-10 (philox.cuh) under the key (k0[r], k1[r]) at the
// counters (j, 0, c2[r], c3[r]), j = 0 .. ceil(m_words / 4) - 1, four words
// a counter, and writes the (n, m) result directly:
//   kind 0: the words AND mask, as int64 in [0, 2^32);
//   kind 1: float32 uniforms (w >> 8) * 2^-24;
//   kind 2: float32 Box-Muller normals, two per pair of words along the row
//           (u1 = 1 - u of the first, u2 = u of the second; sqrt(-2 log
//           u1) times cos / sin of 2 pi u2), each step rounded as torch
//           rounds it (no fast math, no contraction), so they are the
//           plain version's bits.
// Each of k0, k1, c2, c3 is a scalar or an int64 column read with a stride
// and a right shift (its low 32 bits after the shift are the word): a chunk
// of attempts a gives c2 = a >> 0, c3 = a >> 32 with no packing on the host.
//
// What bounds it: the bytes it writes (8 a word, 4 a float), at best; a
// counter's ten Philox rounds and, for normals, two full-precision logf /
// sqrtf / cosf / sinf (as torch's, so that the bits agree) are a few
// hundred instructions for 16 or 32 bytes, so the issue is of the same
// order. One thread a counter, its four results in one 16-byte store where
// they land aligned (the rows are m words long, so not every counter's
// are), a grid-stride loop over 64-bit indices, so any n x m fits one
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 blocks a SM, then stride

struct Word {
  const long long* p;  // the column, or null for the scalar
  long long stride;    // elements between rows
  int shift;           // right shift before the low 32 bits are taken
  uint32_t value;      // the scalar
};

__device__ __forceinline__ uint32_t word_at(const Word& w, long long row) {
  if (w.p == nullptr) return w.value;
  return (uint32_t)((unsigned long long)__ldg(w.p + row * w.stride) >>
                    w.shift);
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return __fmul_rn((float)(w >> 8), 5.9604644775390625e-08f);  // 2^-24
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    philox_stream_fill_kernel(void* __restrict__ out, long long n,
                              long long m_out, long long ctrs, uint32_t mask,
                              Word k0, Word k1, Word c2, Word c3) {
  using T = typename std::conditional<kKind == 0, long long, float>::type;
  const long long total = n * ctrs;
  const bool small = total <= 0xFFFFFFFFLL;   // 32-bit division suffices
  const long long step = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < total; g += step) {
    const long long row =
        small ? (long long)((uint32_t)g / (uint32_t)ctrs) : g / ctrs;
    const long long j = g - row * ctrs;
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)j, 0u, word_at(c2, row), word_at(c3, row)),
        make_uint2(word_at(k0, row), word_at(k1, row)));
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
    const long long col = 4 * j;
    const int valid = (int)min(4LL, m_out - col);
    T r[4];
    if constexpr (kKind == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = (long long)(v[q] & mask);
    } else if constexpr (kKind == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = to_uniform(v[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const float u1 = 1.0f - to_uniform(v[q]);
        const float u2 = to_uniform(v[q + 1]);
        const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
        const float a = __fmul_rn(6.2831855f, u2);  // float32(2 pi) u2
        r[q] = __fmul_rn(rad, cosf(a));
        r[q + 1] = __fmul_rn(rad, sinf(a));
      }
    }
    // whole 16-byte stores where the four land aligned, else one by one
    T* o = static_cast<T*>(out) + row * m_out + col;
    if (valid == 4 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      if constexpr (kKind == 0) {
        reinterpret_cast<longlong2*>(o)[0] = make_longlong2(r[0], r[1]);
        reinterpret_cast<longlong2*>(o)[1] = make_longlong2(r[2], r[3]);
      } else {
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < valid) o[q] = r[q];
      }
    }
  }
}

}  // namespace

// out: (n, m_out) int64 (kind 0) or float32 (kinds 1, 2), contiguous on the
// device; m_words words are drawn a row (m_words >= m_out; even for kind
// 2). words is a HOST array of 16 int64, four for each of (k0, k1, c2,
// c3): a device address (0 for a scalar), a stride, a shift and the
// scalar; word i of row r is the scalar where the address is 0, else the
// low 32 bits of address[r * stride] >> shift (int64 on the device). It
// is read before this returns.
extern "C" int philox_stream_fill(void* out, long long n, long long m_out,
                                  long long m_words, int kind,
                                  unsigned int mask, const void* words,
                                  void* stream) {
  if (n < 0 || m_out < 0 || m_words < m_out || kind < 0 || kind > 2 ||
      (kind == 2 && (m_words & 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ctrs = (m_words + 3) / 4;
  if (ctrs > 0xFFFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (n == 0 || m_out == 0) return 0;
  const long long* spec = static_cast<const long long*>(words);
  Word w[4];
  for (int i = 0; i < 4; ++i) {
    w[i].p = reinterpret_cast<const long long*>(spec[4 * i]);
    w[i].stride = spec[4 * i + 1];
    w[i].shift = (int)spec[4 * i + 2];
    w[i].value = (uint32_t)spec[4 * i + 3];
    if (spec[4 * i + 2] < 0 || spec[4 * i + 2] > 63) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long long total = n * ctrs;
  const long long blocks =
      std::min((total + kThreads - 1) / kThreads, kMaxBlocks);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    philox_stream_fill_kernel<0><<<(unsigned int)blocks, kThreads, 0, s>>>(
        out, n, m_out, ctrs, mask, w[0], w[1], w[2], w[3]);
  } else if (kind == 1) {
    philox_stream_fill_kernel<1><<<(unsigned int)blocks, kThreads, 0, s>>>(
        out, n, m_out, ctrs, mask, w[0], w[1], w[2], w[3]);
  } else {
    philox_stream_fill_kernel<2><<<(unsigned int)blocks, kThreads, 0, s>>>(
        out, n, m_out, ctrs, mask, w[0], w[1], w[2], w[3]);
  }
  return (int)cudaGetLastError();
}
