// What one instance of a kernel runs on this card, for the launch-info
// exports of mc_ofdm_tdl.cu and block_fir.cu (chip_smoke.py prints them).
#pragma once

#include <cuda_runtime.h>

// Registers and local (spill) bytes a thread, static shared bytes and
// resident blocks a SM of `kernel` at `threads` and `smem` dynamic bytes,
// as out[0..3]; opted in to 227 KB of dynamic shared memory first where
// `smem` is past the 48 KB default. 0, or the CUDA error.
template <typename Kernel>
inline int instance_info(Kernel kernel, int threads, long long smem,
                         int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  int blocks = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                     (size_t)smem);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}
