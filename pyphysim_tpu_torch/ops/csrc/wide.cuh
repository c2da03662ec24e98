// The wide form of the Monte Carlo kernels built for one geometry
// (mc_bd.cu, mc_ia.cu): one element a thread, one warp a block, each
// element's state in a per-thread column at stride kThreads. The columns
// live in dynamic shared memory while a warp's fit in kMaxSmem; past that
// in a device scratch buffer that the wrapper allocates, one slot of the
// same layout per block of a grid of at most kSlotsPerSm blocks a SM that
// walks all the blocks of the launch.
#pragma once

#include <cuda_runtime.h>

namespace wide {

constexpr int kThreads = 32;          // one warp a block
constexpr int kMaxSmem = 227 * 1024;  // a block's opt-in limit
constexpr int kSlotsPerSm = 16;       // scratch slots a SM

// True if a block's columns (slot_bytes) go to the scratch buffer.
constexpr bool in_scratch(long long slot_bytes) {
  return slot_bytes > kMaxSmem;
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
// the columns fit in shared memory, -1 if the device cannot be read.
inline long long scratch_bytes(long long blocks, long long slot_bytes) {
  if (!in_scratch(slot_bytes)) return 0;
  const long long g = grid(blocks, slot_bytes);
  return g < 1 ? -1 : g * slot_bytes;
}

// Launches kernel<<<grid, kThreads, smem>>>(p) with the columns in shared
// memory (opted in above the 48 KB default) or, past it, in p.scratch.
template <typename Params>
int launch(void (*kernel)(Params), const Params& p, long long slot_bytes,
           cudaStream_t s) {
  const long long g = grid(p.blocks, slot_bytes);
  if (g < 1 || (in_scratch(slot_bytes) && p.scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = in_scratch(slot_bytes) ? 0 : (int)slot_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<(unsigned int)g, kThreads, bytes, s>>>(p);
  return 0;
}

}  // namespace wide
