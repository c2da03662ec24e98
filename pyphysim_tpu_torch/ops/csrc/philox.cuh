// Philox4x32-10 (Salmon et al., SC 2011), the counter-based generator of the
// port's Monte Carlo kernels. Bit-identical to ops/philox.py, which documents
// the stream layout; the tests check both against the Random123 known
// answers and chip_smoke.py checks this one against the torch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo0 = 0xD2511F53u * ctr.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// A 32-bit word as a uniform in [-1, 1): the signed view times 2^-31, as the
// JAX kernels' _u11 (mc_pallas.py).
__device__ __forceinline__ float bits_u11(uint32_t bits) {
  return (float)(int)bits * 4.656612873077393e-10f;
}

// erfinv of that uniform with both tails clamped (so it never sees +-1):
// N(0, 1/2); times sqrt(2) it is N(0, 1).
__device__ __forceinline__ float bits_half_normal(uint32_t bits) {
  return erfinvf(fminf(fmaxf(bits_u11(bits), -0.99999994f), 0.99999994f));
}
