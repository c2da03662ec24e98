// Per-subcarrier linear MMSE equalization of spatially multiplexed SC-FDMA
// on an estimated channel, and the unbiased hard decision with its bit
// count after the de-spreading IDFT, for Hopper (sm_90a).
//
// No TPU kernel has this counterpart: the JAX package has no SC-FDMA
// receiver. mimo_mmse.cu fuses the hard decision into the detector, which
// SC-FDMA cannot use: its decisions follow an IDFT over the whole
// allocation (ops/mimo_detect.py sc_mmse_eq). Per subcarrier k of attempt
// a, with the estimate H (Nr x Nt) held over the subframe:
//   A = H^H H + s2 I = L D L^H  (mmse.cuh),   W = A^-1 H^H  (Nr solves),
//   gain[t] = Re (W H)[t][t],  the MMSE gain that unbiases layer t,
// and for each data symbol l of the subframe, x[t][l] = W y[l]. The plain
// PyTorch version, ops/mimo_detect.py sc_mmse_eq_reference, runs the same
// float32 operations in the same order, each rounded on its own, so the
// two agree bit for bit.
//
// What bounds it on the card: bytes. At 4 x 4 and 12 data symbols one
// subcarrier reads H (128 B) and 12 y (384 B) and writes 12 x (384 B) and
// the gains, against ~830 float32 operations for its filter and 128 for
// each W y: ~2.7 operations a byte, under the card's 20. The layout is
// planar, the subcarrier innermost: H (n, Nr, Nt, K), y (n, Nr, NS, K)
// (all NS symbols of the subframe: the pilots are skipped, not copied
// out), x (n, Nt, ND, K), gain (n, Nt, K). A thread a subcarrier keeps W
// in registers and streams its symbols, loads of a warp contiguous. The
// gains are written a subcarrier (n * Nt * K floats): their sum over the
// subcarriers is one deterministic reduction outside, where atomics in a
// varying order would round differently from run to run. The noise
// variance s2 is read on the device, so a captured graph takes a new SNR by
// a write to that scalar.
//
// sc_decide_kernel follows the IDFT (torch.fft, outside): each de-spread
// symbol divided by its layer's mean gain mu, QAM.demodulate_hard's slicer
// and the bits that differ from the sent index (mmse.cuh, as mimo_mmse's
// tail), summed a block and added to the attempt's count. It replaces ~25
// element-wise torch launches (a division, the slicer's steps in int64,
// popcount, sums) by one that reads each symbol and index once.
#include <cuda_runtime.h>

#include "mmse.cuh"

namespace {

using namespace mmse;

constexpr int kThreads = 128;
constexpr int kDecideThreads = 256;
constexpr int kMaxSymbols = 32;

// the data symbols' indices among the subframe's NS, increasing
struct Symbols {
  int count;
  signed char index[kMaxSymbols];
};

template <int NR, int NT>
__global__ void __launch_bounds__(kThreads)
    sc_mmse_eq_kernel(const float2* __restrict__ h,
                      const float2* __restrict__ y,
                      const float* __restrict__ noise_var,
                      float2* __restrict__ x, float* __restrict__ gain,
                      long long K, int NS, Symbols data) {
  const long long a = blockIdx.y;
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  float2 H[NR][NT];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int t = 0; t < NT; ++t) H[r][t] = h[((a * NR + r) * NT + t) * K + k];
  }
  const float s2 = *noise_var;

  float Ad[NT], inv[NT];
  float2 Au[NT][NT], L[NT][NT];
  gram<NR, NT, false>(H, nullptr, s2, Ad, Au, nullptr);
  ldl<NT>(Ad, Au, inv, L);
  // W's column r solves A w = (row r of H)^H
  float2 W[NT][NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float2 b[NT], w[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) b[t] = make_float2(H[r][t].x, -H[r][t].y);
    solve<NT>(L, inv, b, w);
#pragma unroll
    for (int t = 0; t < NT; ++t) W[t][r] = w[t];
  }
  // Re (W H)[t][t], summed over r in order
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float g = sub(mul(W[t][0].x, H[0][t].x), mul(W[t][0].y, H[0][t].y));
#pragma unroll
    for (int r = 1; r < NR; ++r) {
      g = add(g, sub(mul(W[t][r].x, H[r][t].x), mul(W[t][r].y, H[r][t].y)));
    }
    gain[(a * NT + t) * K + k] = g;
  }
  const long long nd = data.count;
#pragma unroll 4
  for (int d = 0; d < data.count; ++d) {
    const int l = data.index[d];
    float2 Y[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) Y[r] = y[((a * NR + r) * NS + l) * K + k];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float2 v = cmul(W[t][0], Y[0]);
#pragma unroll
      for (int r = 1; r < NR; ++r) v = cadd(v, cmul(W[t][r], Y[r]));
      x[((a * NT + t) * nd + d) * K + k] = v;
    }
  }
}

// a block row is one (attempt, layer): symbols and sent (n * nt, S), mu
// (n * nt); counts (n,) gain the attempt's errors
__global__ void __launch_bounds__(kDecideThreads)
    sc_decide_kernel(const float2* __restrict__ symbols,
                     const float* __restrict__ mu,
                     const long long* __restrict__ sent,
                     unsigned long long* __restrict__ counts, long long S,
                     int nt, Slicer q) {
  const long long row = blockIdx.y;
  const long long s = (long long)blockIdx.x * kDecideThreads + threadIdx.x;
  unsigned int errors = 0;
  if (s < S) {
    const float2 v = symbols[row * S + s];
    const float m = mu[row];
    errors = bit_errors(__fdiv_rn(v.x, m), __fdiv_rn(v.y, m), sent[row * S + s],
                        q);
  }
  add_block_errors<kDecideThreads>(errors, counts + row / nt);
}

template <int NR, int NT>
int launch(const void* h, const void* y, const void* noise_var, void* x,
           void* gain, int n, long long K, int ns, const Symbols& data,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((K + kThreads - 1) / kThreads), (unsigned)n);
  sc_mmse_eq_kernel<NR, NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float2*>(h), static_cast<const float2*>(y),
      static_cast<const float*>(noise_var), static_cast<float2*>(x),
      static_cast<float*>(gain), K, ns, data);
  return (int)cudaGetLastError();
}

}  // namespace

// h (n, nr, nt, K) and y (n, nr, ns, K) complex64 in; x (n, nt, nd, K)
// complex64 and gain (n, nt, K) float32 out, nd the symbols set in
// data_mask (bit l: symbol l of the ns carries data; ns up to 32); (nr, nt)
// one of (4, 4) and (2, 2), the instances built; n up to 65,535 attempts.
// Returns cudaGetLastError() after the launch; synchronises and allocates
// nothing.
extern "C" int sc_mmse_eq(const void* h, const void* y, const void* noise_var,
                          void* x, void* gain, int n, long long K, int ns,
                          unsigned int data_mask, int nr, int nt,
                          void* stream) {
  if (n < 1 || n > 65535 || K < 1 || ns < 1 || ns > kMaxSymbols ||
      (K + kThreads - 1) / kThreads > 0x7FFFFFFFLL ||
      (ns < 32 && (data_mask >> ns) != 0u)) {
    return (int)cudaErrorInvalidValue;
  }
  Symbols data{0, {}};
  for (int l = 0; l < ns; ++l) {
    if ((data_mask >> l) & 1u) data.index[data.count++] = (signed char)l;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr * 8 + nt) {
    case 4 * 8 + 4:
      return launch<4, 4>(h, y, noise_var, x, gain, n, K, ns, data, st);
    case 2 * 8 + 2:
      return launch<2, 2>(h, y, noise_var, x, gain, n, K, ns, data, st);
  }
  return (int)cudaErrorInvalidValue;
}

// symbols (n, nt, S) complex64 and sent (n, nt, S) int64 in, mu (n, nt)
// float32; counts (n,) int64, zeroed by the caller, gain each attempt's bit
// errors; M a square QAM order up to 256, n * nt up to 65,535. Returns
// cudaGetLastError() after the launch; synchronises and allocates nothing.
extern "C" int sc_decide(const void* symbols, const void* mu, const void* sent,
                         void* counts, int n, int nt, long long S, int M,
                         void* stream) {
  const Slicer q = make_slicer(M);
  if (n < 1 || nt < 1 || (long long)n * nt > 65535 || S < 1 || q.lq == 0 ||
      (S + kDecideThreads - 1) / kDecideThreads > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((S + kDecideThreads - 1) / kDecideThreads),
                  (unsigned)(n * nt));
  sc_decide_kernel<<<grid, kDecideThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(symbols), static_cast<const float*>(mu),
      static_cast<const long long*>(sent),
      static_cast<unsigned long long*>(counts), S, nt, q);
  return (int)cudaGetLastError();
}
