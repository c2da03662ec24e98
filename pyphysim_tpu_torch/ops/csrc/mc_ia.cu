// Max-SINR interference-alignment Monte Carlo, one capacity sum per
// (rep, tile), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pyphysim_tpu/ops/ia_pallas.py
// MonteCarloMaxSinr._solve_block / _solve_block_general, launched by
// _make_prng_call (in-kernel random bits) and build_inject (bits read from
// a device tensor). For every element (one K-user interference channel of
// N x N links) it computes:
//   * H[k][j], complex Gaussian links from erfinvf of clamped uniforms
//     (N(0, 1/2) per part), the planes in the JAX order (k, j, entry,
//     re/im);
//   * the init: at (N, Ns) = (2, 1) the closed-form dominant right singular
//     vector of H[k][k]; elsewhere init_iters steps of orthogonal iteration
//     on H[k][k]^H H[k][k], columns scaled by 1/sqrt(Ns);
//   * `iterations` Max-SINR rounds: receive filters u = normalize(Bkl^-1 d)
//     with Bkl = nv I + sum_j P (H_kj f_j)(H_kj f_j)^H - P d d^H and
//     d = H_kk f_k (Cadambe eq. 28), then precoders from the same update on
//     the reverse network H_rev[k][j] = H[j][k]^H at power P / Ns; then the
//     last receive filters;
//   * SINR P |u^H d|^2 / |re(u^H Bkl u)| per stream, the sum over users and
//     streams of log2(1 + SINR), and 0 for a non-finite draw.
//
// What bounds it on the card: instruction issue. In PRNG mode nothing is
// read per element. At the bench point (K, N, Ns) = (3, 2, 1) with 10
// iterations a solve issues ~13,100 SASS instructions, ~9,900 of them f32
// (63 user updates of ~150 each, 72 erfinvf, 18 Philox calls; ops/sass.py
// counts them in the built library and chip_smoke.py prints the count): one
// warp instruction per scheduler per clock is the limit, ahead of the FMA
// pipe.
// The design:
//   * one solve per thread, the closed-form body wholly in registers: the
//     channels are a fixed-size register array (72 floats at K = 3), every
//     user and matrix loop unrolled with K a template parameter, and only
//     the Max-SINR iteration loop a run-time loop; the reverse network reads
//     the same registers conjugate-transposed, so H is held once;
//   * the general body (any other (N, Ns), mc_ia_general_kernel, in the
//     prebuilt library and in a geometry's own) splits an element over a
//     group of lanes (wide.cuh). One thread an element had kept H in shared
//     memory and F, U, Bkl and the factors in registers: 255 registers and
//     3,328 bytes of spill stores a thread at (3, 4, 2), 6 warps a SM. The
//     K user updates of a half-iteration are independent, so U of them run
//     at once on sub-groups of Lu lanes; lane gu holds rows gu, gu + Lu, ...
//     of its user's links (read from the element's slot), of first and Bkl
//     (registers) and of t = link f (the sub-group's T, in the slot, read
//     whole for the outer products); F and U live in the slot, whole for
//     every lane. A link product sums over the columns in order on one lane,
//     first += p t t^H takes the (j, l) terms in order, each stream's
//     Bkl^-1 d is wide::group_ldl_solve (its back substitution from the last
//     column down: rounding only), u = normalize(x) and the SINR's sums over
//     the rows run on every lane of the sub-group on vectors gathered whole
//     by shuffles (so in order), and the capacities are summed over users
//     and streams in order. Complex multiply-adds are fused chains. Its
//     loops over users and links stay rolled, so any K builds alike; past
//     227 KB a block (first at (15, 4, 2) for (N, Ns)
//     = (4, 2): one warp a block) its slots are in the scratch buffer,
//     read through L2 (chip_smoke.py holds that point to its plain
//     version: 2.18 s for 2,097,152 solves, 3.6 % of its operation bound);
//   * each thread draws its element's channel words with Philox in
//     registers; inject-mode loads are coalesced along the lane;
//   * a block sums its elements in a fixed order (a shuffle tree, then its
//     warps), writes one partial, and a second pass adds a (rep, tile)'s
//     partials in order. No float atomics: a rerun and another chunking give
//     the same bits.
// The prebuilt library holds the five geometries of with_geometry below; any
// other (K, N, Ns) is built on its first use with -DMC_IA_K=.. -DMC_IA_N=..
// -DMC_IA_NS=.. (ops/_build.py): the general body as above, or the closed
// body in mc_ia_wide_kernel, one element a thread in blocks of one warp
// with each thread's channels (K^2 N^2 2 floats) in a column at stride 32
// of shared memory (past K = 4 they no longer fit in registers: 200 floats
// at K = 5), past 227 KB a warp in the scratch buffer of wide.cuh
// (mc_ia_scratch_bytes says how large).
// What bounds the general body (inferred from the timings below; not
// profiled): instruction issue along chains of small steps (a user's Bkl is
// N x N: its factor, substitutions, gathers and normalization are a few
// operations between shuffles and __syncwarp).
// bin/tune_wide_kernel.py --grid timed every pair of lanes a user (2, 4, 8)
// and users at once (1, 2, 4) (NVIDIA H100 80GB HBM3, 700 W, 128 reps x 4
// tiles x 8 x 512 PRNG solves, 10 iterations): two rows a lane and 2 users
// at once was the best pair at (2, 3, 1) (2.85 ms), (3, 4, 1), (2, 4, 2)
// and (3, 4, 2) (23.87 ms, the parent's one-thread body 29.21) and 6 %
// behind the best at (4, 4, 2) (39.55 ms, a lane a row 37.53); a lane a
// row cost 1.6x at (2, 3, 1), more users at once up to 1.9x. Where the
// one-thread body fitted in registers it was faster: (2, 3, 1) 1.49 ms,
// (2, 4, 2) 6.93 ms against 9.86 (ROADMAP.md queues it). chip_smoke.py
// prints each instance's registers, spills, shared bytes and resident
// warps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "planes.cuh"
#include "wide.cuh"

namespace {

using planes::cabs2;
using planes::cadd;
using planes::cconj;
using planes::cf;
using planes::cmul;
using planes::cmulc;
using planes::cscale;
using planes::csub;

constexpr int kClosedThreads = 128;
constexpr uint32_t kChannelKey = 6u;  // ops/philox.py IA_CHANNEL_KEY

struct Params {
  const int* bits;  // inject mode: (reps, num_tiles * tile, planes * lane)
  long long rep_stride;
  long long row_stride;
  float* partial;   // (reps * num_tiles * parts)
  int num_tiles, tile, lane, parts;
  int iters, init_iters;
  float P, nv;
  uint32_t seed;
  long long start;
  float* scratch;  // the wide form past shared memory: its state slots
  int blocks;      // blocks of the whole launch (the wide form walks them)
};

// Calls sink(plane, value) for each of the NP channel planes of element e of
// tile tile_idx of repetition rep: read from the bit tensor or drawn from
// the element's Philox calls.
template <int NP, bool kInject, typename Sink>
__device__ __forceinline__ void draw_planes(const Params& p, int rep,
                                            int tile_idx, int e, Sink&& sink) {
  if (kInject) {
    const int r = e / p.lane;
    const int l = e - r * p.lane;
    const int* row = p.bits + rep * p.rep_stride +
                     (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll
    for (int pl = 0; pl < NP; ++pl) {
      sink(pl, bits_half_normal((uint32_t)row[(long long)pl * p.lane]));
    }
  } else {
    constexpr int CALLS = (NP + 3) / 4;
    const unsigned long long attempt =
        (unsigned long long)(p.start + (long long)rep);
    const uint32_t att_lo = (uint32_t)attempt;
    const uint32_t att_hi = (uint32_t)(attempt >> 32);
#pragma unroll
    for (int j = 0; j < CALLS; ++j) {
      const uint4 x = philox4x32_10(
          make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j), att_lo,
                     att_hi),
          make_uint2(p.seed, kChannelKey));
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * j + k < NP) sink(4 * j + k, bits_half_normal(w[k]));
      }
    }
  }
}

// A thread's channels in a column (shared or device memory): plane pl at
// s[pl * T].
template <int K, int N, int T>
struct SharedH {
  const float* s;
  __device__ __forceinline__ cf get(int k, int j, int r, int c) const {
    const int pl = 2 * (((k * K + j) * N + r) * N + c);
    return {s[pl * T], s[(pl + 1) * T]};
  }
};

// ---- the closed-form body, (N, Ns) = (2, 1) -----------------------------

// Entry (r, c) of link (k, j): H in registers, or in a column.
template <int K>
__device__ __forceinline__ cf h_at(const cf (&H)[K][K][2][2], int k, int j,
                                   int r, int c) {
  return H[k][j][r][c];
}

template <int K, int T>
__device__ __forceinline__ cf h_at(const SharedH<K, 2, T>& H, int k, int j,
                                   int r, int c) {
  return H.get(k, j, r, c);
}

// Link (k, j) of the forward network, or of the reverse one
// (H_rev[k][j] = H[j][k]^H), entry (r, c).
template <int K, bool REV, typename HT>
__device__ __forceinline__ cf link2(const HT& H, int k, int j, int r, int c) {
  return REV ? cconj(h_at<K>(H, j, k, c, r)) : h_at<K>(H, k, j, r, c);
}

// Bkl = (p, q, r) of user k over precoders F, and d = H_kk f_k
// (_solve_block's update, in its order).
template <int K, bool REV, typename HT>
__device__ __forceinline__ void closed_bkl(const HT& H,
                                           const cf (&F)[K][2], int k,
                                           float nv, float P, float& p, cf& q,
                                           float& r, cf (&d)[2]) {
  p = nv;
  q = {0.f, 0.f};
  r = nv;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cf t[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      t[i] = cadd(cmul(link2<K, REV, HT>(H, k, j, i, 0), F[j][0]),
                  cmul(link2<K, REV, HT>(H, k, j, i, 1), F[j][1]));
    }
    planes::herm2_add_outer(p, q, r, t[0], t[1], P);
    if (j == k) {
      d[0] = t[0];
      d[1] = t[1];
    }
  }
  p = p - P * cabs2(d[0]);
  q = csub(q, cscale(cmulc(d[0], d[1]), P));
  r = r - P * cabs2(d[1]);
}

// One direction of the Max-SINR update: out[k] = normalize(Bkl^-1 d).
template <int K, bool REV, typename HT>
__device__ __forceinline__ void closed_update(const HT& H,
                                              const cf (&F)[K][2],
                                              cf (&out)[K][2], float nv,
                                              float P) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float p, r;
    cf q, d[2];
    closed_bkl<K, REV, HT>(H, F, k, nv, P, p, q, r, d);
    planes::herm2_solve(p, q, r, d[0], d[1], out[k][0], out[k][1]);
    planes::vnormalize<2>(out[k]);
  }
}

template <int K, typename HT>
__device__ __forceinline__ float solve_closed(const HT& H, float nv, float P,
                                              int iters) {
  cf F[K][2], U[K][2];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    planes::dominant_right_singular(h_at<K>(H, k, k, 0, 0),
                                    h_at<K>(H, k, k, 0, 1),
                                    h_at<K>(H, k, k, 1, 0),
                                    h_at<K>(H, k, k, 1, 1), F[k]);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    closed_update<K, false, HT>(H, F, U, nv, P);
    closed_update<K, true, HT>(H, U, F, nv, P);
  }
  closed_update<K, false, HT>(H, F, U, nv, P);

  float cap = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float p, r;
    cf q, d[2];
    closed_bkl<K, false, HT>(H, F, k, nv, P, p, q, r, d);
    const float num =
        P * cabs2(cadd(cmulc(d[0], U[k][0]), cmulc(d[1], U[k][1])));
    const float den =
        fmaxf(fabsf(planes::herm2_quad(p, q, r, U[k][0], U[k][1])),
              planes::kEps);
    const float c = log2f(1.0f + num / den);
    cap = k == 0 ? c : cap + c;
  }
  return isfinite(cap) ? cap : 0.f;
}

// ---- the general body: a group of lanes an element -----------------------

// The general body's plan: a group of L = U Lu lanes an element, whose U
// sub-groups of Lu lanes update U users at once (users u, u + U, ... on
// sub-group u; the K users of a half-iteration are independent), lane gu of
// a sub-group holding rows gu, gu + Lu, ... (R of them) of its user's links,
// filters and Hermitian matrices. Lu is the power of two >= N / 2
// (two rows a lane) and U = 2, the plan bin/tune_wide_kernel.py --grid
// measured best or within 6 % of it at every geometry it times (see the
// note at the head). The element's state is a slot of the block's memory,
// in float2 entries:
//   H  at kH: the links, H[k][j][r][c] at ((k K + j) N + r) N + c (the JAX
//      plane order);
//   F  at kF, U at kU: the precoders and receive filters, vector (k, l)
//      at (k NS + l) N, each set whole for every lane to read;
//   then for each sub-group u, at kSub + u kSubEntries:
//   T  t = link(k, j) v_jl of its user, vector (j, l) at (j NS + l) N;
//   L  at kT + KS N: the LDL^H factor, strictly lower, packed by rows
//      (wide::tri; wide::group_ldl_solve).
template <int K, int N, int NS>
struct GroupIA {
  static constexpr int Lu = wide::lanes_for((N + 1) / 2, 1);
  static constexpr int R = (N + Lu - 1) / Lu;
  static constexpr int U = Lu < 32 ? 2 : 1;
  static constexpr int L = U * Lu;         // lanes an element
  static constexpr int kPerWarp = 32 / L;  // elements a warp
  static constexpr int KS = K * NS;        // vectors of a set
  static constexpr int kH = 0;
  static constexpr int kF = K * K * N * N;
  static constexpr int kU = kF + KS * N;
  static constexpr int kSub = (kU + KS * N + 1) / 2 * 2;
  static constexpr int kL = KS * N;        // in a sub-slot
  static constexpr int kSubEntries = (kL + N * (N - 1) / 2 + 1) / 2 * 2;
  static constexpr int kEntries = kSub + U * kSubEntries;
  static constexpr int kStride = wide::group_stride(kEntries, L);
  static constexpr int kWarps =
      wide::group_warps((long long)kPerWarp * kStride * sizeof(float2));
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kElems = kPerWarp * kWarps;  // elements a block
  static constexpr long long kBytes =
      (long long)kElems * kStride * (long long)sizeof(float2);
  static constexpr bool kGlobal = wide::in_scratch(kBytes);
  static_assert(L <= 32 && (Lu & (Lu - 1)) == 0 && (U & (U - 1)) == 0,
                "lanes: powers of two, at most a warp");
};

// Vector v (N entries at st[n]) whole on every lane of the group (a
// broadcast read).
template <int N>
__device__ __forceinline__ void ld_vec(const float2* st, int n, cf (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) wide::ld_pair(st, n + c, v[c], v[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = wide::ld(st, n + c);
  }
}

// The vector whose row a the sub-group's lane a % Lu holds in own[a / Lu],
// whole on every lane of the sub-group (a shuffle a row).
template <int N, int Lu, int R>
__device__ __forceinline__ void gather(const cf (&own)[R], cf (&v)[N]) {
#pragma unroll
  for (int a = 0; a < N; ++a) v[a] = wide::bcast<Lu>(own[a / Lu], a % Lu);
}

// Writes vector v (whole on every lane of a sub-group) times scale to
// st[n ...]: each lane its rows; none where `keep` is false.
template <int N, int Lu>
__device__ __forceinline__ void st_vec(float2* st, int n, int gu, bool keep,
                                       const cf (&v)[N], float scale) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    if (keep && a % Lu == gu) wide::st2(st, n + a, cscale(v[a], scale));
  }
}

// The lane's rows of first = nv I + sum_j sum_l p t t^H of user k, t =
// link(k, j) v_jl (link H[k][j], or REV H[j][k]^H) over the vectors v of the
// set at st[src], in _solve_block_general's order, by fused multiply-adds (a
// term (p t_i) conj(t_c), where the plain version rounds (t_i conj(t_c)) p);
// each t also goes to the sub-group's T (at sub).
template <int K, int N, int NS, bool REV>
__device__ __forceinline__ void group_first(
    const float2* st, float2* sub, int gu, int src, int k, float nv, float p,
    cf (&fr)[GroupIA<K, N, NS>::R][N]) {
  using G = GroupIA<K, N, NS>;
  constexpr int Lu = G::Lu, R = G::R;
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    // H[k][j] row i (forward) or column i of H[j][k] (reverse) starts here
    const int base = REV ? (j * K + k) * N * N : (k * K + j) * N * N;
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      cf v[N];
      ld_vec<N>(st, src + (j * NS + l) * N, v);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = gu + r * Lu < N ? gu + r * Lu : N - 1;
        cf acc;
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const cf h = REV ? cconj(wide::ld(st, base + c * N + i))
                           : wide::ld(st, base + i * N + c);
          acc = c == 0 ? cmul(h, v[0]) : wide::cmac(acc, h, v[c]);
        }
        if (gu + r * Lu < N) wide::st2(sub, (j * NS + l) * N + i, acc);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = gu + r * Lu;
#pragma unroll
    for (int c = 0; c < N; ++c) fr[r][c] = {i == c ? nv : 0.f, 0.f};
  }
#pragma unroll 1
  for (int jl = 0; jl < G::KS; ++jl) {
    cf t[N];
    ld_vec<N>(sub, jl * N, t);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = gu + r * Lu < N ? gu + r * Lu : N - 1;
      const cf pti = cscale(wide::ld(sub, jl * N + i), p);
#pragma unroll
      for (int c = 0; c < N; ++c) fr[r][c] = wide::cmacc(fr[r][c], pti, t[c]);
    }
  }
}

// The lane's rows of Bkl = first - p d d^H for d (whole on every lane; the
// lane's own rows of it in dr).
template <int N, int R>
__device__ __forceinline__ void group_bkl(const cf (&fr)[R][N],
                                          const cf (&dr)[R], const cf (&d)[N],
                                          float p, cf (&b)[R][N]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const cf pd = cscale(dr[r], p);
#pragma unroll
    for (int c = 0; c < N; ++c) b[r][c] = wide::cmsubc(fr[r][c], pd, d[c]);
  }
}

// d = t of user k's stream l (whole, and the lane's rows of it).
template <int N, int Lu, int R>
__device__ __forceinline__ void load_d(const float2* sub, int n, int gu,
                                       cf (&d)[N], cf (&dr)[R]) {
  ld_vec<N>(sub, n, d);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dr[r] = wide::ld(sub, n + (gu + r * Lu < N ? gu + r * Lu : N - 1));
  }
}

// One direction of the Max-SINR update: the set at st[dst] = for each user k
// and stream l, normalize(Bkl^-1 d) / sqrt(NS), over the set at st[src]; U
// users at once (a round's spare sub-groups update the last user again and
// keep nothing).
template <int K, int N, int NS, bool REV>
__device__ __forceinline__ void group_update(float2* st, float2* sub, int u,
                                             int gu, int src, int dst,
                                             float nv, float p,
                                             float inv_sqrt_ns) {
  using G = GroupIA<K, N, NS>;
  constexpr int Lu = G::Lu, R = G::R;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += G::U) {
    const bool keep = k0 + u < K;
    const int k = keep ? k0 + u : K - 1;
    cf fr[R][N];
    group_first<K, N, NS, REV>(st, sub, gu, src, k, nv, p, fr);
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      cf d[N], dr[R], b[R][N], x[R][1];
      load_d<N, Lu, R>(sub, (k * NS + l) * N, gu, d, dr);  // d = H_kk f_kl
#pragma unroll
      for (int r = 0; r < R; ++r) x[r][0] = dr[r];
      group_bkl<N, R>(fr, dr, d, p, b);
      wide::group_ldl_solve<N, Lu, R, 1>(
          sub + G::kL, gu, [&](int r, int j) { return b[r][j]; },
          [&](int j) { return wide::bcast<Lu>(b[j / Lu][j].re, j % Lu); }, x);
      cf xr[R], uv[N];
#pragma unroll
      for (int r = 0; r < R; ++r) xr[r] = x[r][0];
      gather<N, Lu, R>(xr, uv);
      planes::vnormalize<N>(uv);
      st_vec<N, Lu>(st, dst + (k * NS + l) * N, gu, keep, uv, inv_sqrt_ns);
    }
    __syncwarp();  // T is the next round's
  }
}

// Sum capacity of one element on its group (the same value on every lane):
// _solve_block_general of ia_pallas.py.
template <int K, int N, int NS>
__device__ __forceinline__ float solve_general_group(float2* st, int g,
                                                     float nv, float P,
                                                     int iters,
                                                     int init_iters) {
  using G = GroupIA<K, N, NS>;
  constexpr int L = G::L, Lu = G::Lu, R = G::R, U = G::U;
  const int u = g / Lu, gu = g % Lu;
  float2* const sub = st + G::kSub + u * G::kSubEntries;
  const float inv_sqrt_ns = (float)(1.0 / sqrt((double)NS));
  const float p_rev = P / (float)NS;
  // the init: init_iters steps of orthogonal iteration on H[k][k]^H H[k][k]
  // (planes::orth_iter_init), the lane's rows of the Gram in registers, the
  // iterate whole on every lane (its Gram-Schmidt run on every lane alike)
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += U) {
    const bool keep = k0 + u < K;
    const int k = keep ? k0 + u : K - 1;
    const int base = (k * K + k) * N * N;
    cf gk[R][N];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = gu + r * Lu < N ? gu + r * Lu : N - 1;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        cf acc;
#pragma unroll
        for (int t = 0; t < N; ++t) {
          const cf term = cmul(cconj(wide::ld(st, base + t * N + i)),
                               wide::ld(st, base + t * N + c));
          acc = t == 0 ? term : cadd(acc, term);
        }
        gk[r][c] = acc;
      }
    }
    cf cols[NS][N];
#pragma unroll
    for (int l = 0; l < NS; ++l) {
#pragma unroll
      for (int i = 0; i < N; ++i) cols[l][i] = {i == l ? 1.f : 0.f, 0.f};
    }
#pragma unroll 1
    for (int it = 0; it < init_iters; ++it) {
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        cf own[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cf acc = cmul(gk[r][0], cols[l][0]);
#pragma unroll
          for (int c = 1; c < N; ++c) acc = cadd(acc, cmul(gk[r][c], cols[l][c]));
          own[r] = acc;
        }
        gather<N, Lu, R>(own, cols[l]);
      }
      planes::mgs<NS, N>(cols);
    }
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      st_vec<N, Lu>(st, G::kF + (k * NS + l) * N, gu, keep, cols[l],
                    inv_sqrt_ns);
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    group_update<K, N, NS, false>(st, sub, u, gu, G::kF, G::kU, nv, P,
                                  inv_sqrt_ns);
    group_update<K, N, NS, true>(st, sub, u, gu, G::kU, G::kF, nv, p_rev,
                                 inv_sqrt_ns);
  }
  group_update<K, N, NS, false>(st, sub, u, gu, G::kF, G::kU, nv, P,
                                inv_sqrt_ns);

  // SINR P |u^H d|^2 / |re(u^H Bkl u)| a stream (each sum over rows whole on
  // every lane of the sub-group), U users at once; then the capacities,
  // gathered from the sub-groups by shuffles, summed over users and
  // streams in order
  float cap = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += U) {
    const int k = k0 + u < K ? k0 + u : K - 1;
    cf fr[R][N];
    group_first<K, N, NS, false>(st, sub, gu, G::kF, k, nv, P, fr);
    float cl[NS];
#pragma unroll
    for (int l = 0; l < NS; ++l) {
      cf d[N], dr[R], b[R][N], uv[N];
      load_d<N, Lu, R>(sub, (k * NS + l) * N, gu, d, dr);
      ld_vec<N>(st, G::kU + (k * NS + l) * N, uv);
      group_bkl<N, R>(fr, dr, d, P, b);
      const float num = P * cabs2(planes::gdotc<N>(uv, d));
      cf wr[R], w[N];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cf acc = cmul(b[r][0], uv[0]);
#pragma unroll
        for (int c = 1; c < N; ++c) acc = cadd(acc, cmul(b[r][c], uv[c]));
        wr[r] = acc;
      }
      gather<N, Lu, R>(wr, w);
      const float den =
          fmaxf(fabsf(planes::gdotc<N>(uv, w).re), planes::kEps);
      cl[l] = log2f(1.0f + num / den);
    }
#pragma unroll
    for (int v = 0; v < U; ++v) {
#pragma unroll
      for (int l = 0; l < NS; ++l) {
        const float c = __shfl_sync(0xffffffffu, cl[l], v * Lu, L);
        if (k0 + v < K) cap = (k0 + v == 0 && l == 0) ? c : cap + c;
      }
    }
    __syncwarp();
  }
  return isfinite(cap) ? cap : 0.f;
}

// ---- kernels --------------------------------------------------------------

// A block's elements summed in a fixed order into *out.
template <int T>
__device__ __forceinline__ void block_sum(float acc, float* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if constexpr (T == 32) {
    if (threadIdx.x == 0) *out = acc;
  } else {
    __shared__ float s_warp_sum[T / 32];
    if ((threadIdx.x & 31) == 0) s_warp_sum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = s_warp_sum[0];
#pragma unroll
      for (int w = 1; w < T / 32; ++w) v += s_warp_sum[w];
      *out = v;
    }
  }
}

template <int K, bool kInject>
__global__ void __launch_bounds__(kClosedThreads)
    mc_ia_closed_kernel(const Params p) {
  constexpr int NP = K * K * 8;
  const int cell = blockIdx.x / p.parts;   // rep * num_tiles + tile
  const int part = blockIdx.x % p.parts;
  const int rep = cell / p.num_tiles;
  const int tile_idx = cell % p.num_tiles;
  const int e = part * kClosedThreads + threadIdx.x;
  float acc = 0.f;
  if (e < p.tile * p.lane) {
    cf H[K][K][2][2];
    draw_planes<NP, kInject>(p, rep, tile_idx, e, [&](int pl, float v) {
      const int x = pl >> 1;  // (k K + j) 4 + r 2 + c
      cf& h = H[x / (4 * K)][(x / 4) % K][(x / 2) % 2][x % 2];
      if (pl & 1) {
        h.im = v;
      } else {
        h.re = v;
      }
    });
    acc = solve_closed<K>(H, p.nv, p.P, p.iters);
  }
  block_sum<kClosedThreads>(acc, p.partial + blockIdx.x);
}

// The general body: a group of GroupIA::L lanes an element,
// GroupIA::kElems elements a block, the block walking blocks vb = blockIdx.x,
// + gridDim.x, ... of the launch (one trip unless the state is in the
// scratch buffer); partial[vb] its elements' sum. The bound names one block
// a SM: with the threads alone ptxas held (3, 4, 2) and (4, 4, 2) to 72
// registers and spilled 4 bytes; with it, 79 and none.
template <int K, int N, int NS, bool kInject>
__global__ void __launch_bounds__(GroupIA<K, N, NS>::kThreads, 1)
    mc_ia_general_kernel(const Params p) {
  using G = GroupIA<K, N, NS>;
  constexpr int L = G::L;
  extern __shared__ float4 s_state[];
  __shared__ float s_warp_sum[G::kWarps];
  float2* const slot =
      G::kGlobal ? reinterpret_cast<float2*>(p.scratch) +
                       (long long)blockIdx.x * G::kElems * G::kStride
                 : reinterpret_cast<float2*>(s_state);
  const int g = threadIdx.x % L;    // the lane in its group
  const int grp = threadIdx.x / L;  // the element in the block
  float2* const st = slot + grp * G::kStride;
  const int elems = p.tile * p.lane;
#pragma unroll 1
  for (int vb = blockIdx.x; vb < p.blocks; vb += gridDim.x) {
    const int cell = vb / p.parts;
    const int part = vb % p.parts;
    const int rep = cell / p.num_tiles;
    const int tile_idx = cell % p.num_tiles;
    const int e = part * G::kElems + grp;
    const bool valid = e < elems;
    __syncwarp();  // the previous trip's reads of the slot are done
    if (valid) {
      wide::draw_entries<L, kInject>(p, st + G::kH, g, e, rep, tile_idx,
                                     K * K * N * N, kChannelKey);
    }
    __syncwarp();
    // every group solves (an element past the end on whatever its slot
    // holds: the warp's lanes stay together) and only valid ones count
    const float cap = solve_general_group<K, N, NS>(st, g, p.nv, p.P, p.iters,
                                                   p.init_iters);
    wide::block_partial<G::kWarps>((valid && g == 0) ? cap : 0.f, s_warp_sum,
                                   p.partial + vb);
  }
}

// The wide form's column: K^2 N^2 2 floats a thread, in shared memory
// while a warp's columns fit (wide.cuh), else in the scratch buffer.
template <int K, int N>
struct WideIA {
  static constexpr int NP = K * K * N * N * 2;
  static constexpr long long kBytes =
      (long long)NP * wide::kThreads * (long long)sizeof(float);
  static constexpr bool kGlobal = wide::in_scratch(kBytes);
};

// The closed body on a column, one element a thread, one warp a block, the
// block walking blocks vb = blockIdx.x, + gridDim.x, ... of the launch (one
// trip unless the state is in the scratch buffer).
template <int K, int N, int NS, bool kInject>
__global__ void __launch_bounds__(wide::kThreads)
    mc_ia_wide_kernel(const Params p) {
  static_assert(N == 2 && NS == 1, "the closed body");
  using G = WideIA<K, N>;
  constexpr int NP = G::NP;
  constexpr int CALLS = (NP + 3) / 4;
  extern __shared__ float s_col[];  // (NP, wide::kThreads)
  float* const slot =
      G::kGlobal ? p.scratch + (long long)blockIdx.x * NP * wide::kThreads
                 : s_col;
  float* const mine = slot + threadIdx.x;
#pragma unroll 1
  for (int vb = blockIdx.x; vb < p.blocks; vb += gridDim.x) {
    const int cell = vb / p.parts;
    const int part = vb % p.parts;
    const int rep = cell / p.num_tiles;
    const int tile_idx = cell % p.num_tiles;
    const int e = part * wide::kThreads + threadIdx.x;
    float acc = 0.f;
    if (e < p.tile * p.lane) {
      if (kInject) {
        const int r = e / p.lane;
        const int l = e - r * p.lane;
        const int* row = p.bits + rep * p.rep_stride +
                         (long long)(tile_idx * p.tile + r) * p.row_stride + l;
#pragma unroll 1
        for (int pl = 0; pl < NP; ++pl) {
          mine[pl * wide::kThreads] =
              bits_half_normal((uint32_t)row[(long long)pl * p.lane]);
        }
      } else {
        const unsigned long long attempt =
            (unsigned long long)(p.start + (long long)rep);
#pragma unroll 1  // Philox calls; the last may be partly used
        for (int j = 0; j < CALLS; ++j) {
          const uint4 x = philox4x32_10(
              make_uint4((uint32_t)e, (uint32_t)(tile_idx * CALLS + j),
                         (uint32_t)attempt, (uint32_t)(attempt >> 32)),
              make_uint2(p.seed, kChannelKey));
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (NP % 4 == 0 || 4 * j + k < NP) {
              mine[(4 * j + k) * wide::kThreads] = bits_half_normal(w[k]);
            }
          }
        }
      }
      const SharedH<K, N, wide::kThreads> H{mine};
      acc = solve_closed<K>(H, p.nv, p.P, p.iters);
    }
    block_sum<wide::kThreads>(acc, p.partial + vb);
  }
}

// out[cell] = the cell's partials added in order.
__global__ void ia_sum_parts_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int cells,
                                    int parts) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  float v = 0.f;
  for (int i = 0; i < parts; ++i) v += partial[(long long)cell * parts + i];
  out[cell] = v;
}

constexpr bool closed_form(int N, int NS) { return N == 2 && NS == 1; }

template <int kK, int kN, int kNS>
struct Geo {
  static constexpr int K = kK, N = kN, NS = kNS;
};

// Calls fn(Geo<K, N, NS>{}) for the library's geometry (K, N, NS); returns
// false if it holds none such. The prebuilt library's geometries: (2, 2, 1),
// (3, 2, 1), (4, 2, 1) closed form; (3, 4, 1), (2, 4, 2) general. A library
// built for one geometry (ops/_build.py) holds that one.
template <typename Fn>
bool with_geometry(int K, int N, int NS, Fn&& fn) {
#ifdef MC_IA_K
  if (K != MC_IA_K || N != MC_IA_N || NS != MC_IA_NS) return false;
  fn(Geo<MC_IA_K, MC_IA_N, MC_IA_NS>{});
#else
  if (K == 2 && N == 2 && NS == 1) {
    fn(Geo<2, 2, 1>{});
  } else if (K == 3 && N == 2 && NS == 1) {
    fn(Geo<3, 2, 1>{});
  } else if (K == 4 && N == 2 && NS == 1) {
    fn(Geo<4, 2, 1>{});
  } else if (K == 3 && N == 4 && NS == 1) {
    fn(Geo<3, 4, 1>{});
  } else if (K == 2 && N == 4 && NS == 2) {
    fn(Geo<2, 4, 2>{});
  } else {
    return false;
  }
#endif
  return true;
}

#ifdef MC_IA_K
constexpr bool kOneGeometry = true;
#else
constexpr bool kOneGeometry = false;
#endif

// Geometry Geo's kernel, threads and elements a block, state bytes a block
// (the closed body in the prebuilt kernel, one element a thread, or past
// K = 4 in the wide form; the general body in lane groups), passed to
// fn(kernel, threads, slot_bytes, elems, lanes).
template <typename Geom, bool kInject, typename Fn>
void with_kernel(Geom, Fn&& fn) {
  constexpr int K = Geom::K, N = Geom::N, NS = Geom::NS;
  if constexpr (!closed_form(N, NS)) {
    using G = GroupIA<K, N, NS>;
    fn(mc_ia_general_kernel<K, N, NS, kInject>, G::kThreads, G::kBytes,
       G::kElems, G::L);
  } else if constexpr (kOneGeometry) {
    fn(mc_ia_wide_kernel<K, N, NS, kInject>, wide::kThreads,
       WideIA<K, N>::kBytes, wide::kThreads, 1);
  } else {
    fn(mc_ia_closed_kernel<K, kInject>, kClosedThreads, 0LL, kClosedThreads,
       1);
  }
}

// Elements a block of geometry (K, N, NS); 0 if the library has none such.
int block_elems(int K, int N, int NS) {
  int elems = 0;
  with_geometry(K, N, NS, [&](auto geo) {
    with_kernel<decltype(geo), false>(
        geo, [&](auto, int, long long, int e, int) { elems = e; });
  });
  return elems;
}

int launch(Params& p, float* out, int reps, int K, int N, int NS, bool inject,
           void* stream) {
  if (reps < 1 || p.num_tiles < 1 || p.tile < 1 || p.lane < 1 ||
      p.iters < 0 || p.init_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int elems = block_elems(K, N, NS);
  if (elems < 1) return (int)cudaErrorInvalidValue;
  p.parts = (p.tile * p.lane + elems - 1) / elems;
  const long long cells = (long long)reps * p.num_tiles;
  const long long blocks = cells * p.parts;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  p.blocks = (int)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  auto go = [&](auto kernel, int threads, long long bytes, int, int) {
    if (bytes == 0) {
      kernel<<<(unsigned int)blocks, threads, 0, s>>>(p);
    } else {
      rc = wide::launch(kernel, p, bytes, threads, s);
    }
  };
  with_geometry(K, N, NS, [&](auto geo) {
    if (inject) {
      with_kernel<decltype(geo), true>(geo, go);
    } else {
      with_kernel<decltype(geo), false>(geo, go);
    }
  });
  if (rc != 0) return rc;
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ia_sum_parts_kernel<<<(unsigned int)((cells + 255) / 256), 256, 0, s>>>(
      p.partial, out, (int)cells, p.parts);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials per (rep, tile) cell: the wrapper's scratch holds
// reps * num_tiles * mc_ia_num_parts(tile, lane, K, N, Ns) floats (0 for a
// geometry this library does not hold).
extern "C" int mc_ia_num_parts(int tile, int lane, int K, int N, int NS) {
  const int elems = block_elems(K, N, NS);
  return elems < 1 ? 0 : (tile * lane + elems - 1) / elems;
}

// Bytes of the state buffer a launch of this library's geometry needs (its
// state past shared memory, on the current device), else 0; -1 if the
// device cannot be read.
extern "C" long long mc_ia_scratch_bytes(int reps, int num_tiles, int tile,
                                         int lane) {
#ifdef MC_IA_K
  long long bytes = 0;
  with_kernel<Geo<MC_IA_K, MC_IA_N, MC_IA_NS>, false>(
      Geo<MC_IA_K, MC_IA_N, MC_IA_NS>{},
      [&](auto, int, long long slot, int, int) {
        bytes = wide::scratch_bytes(
            (long long)reps * num_tiles *
                mc_ia_num_parts(tile, lane, MC_IA_K, MC_IA_N, MC_IA_NS),
            slot);
      });
  return bytes;
#else
  (void)reps, (void)num_tiles, (void)tile, (void)lane;
  return 0;
#endif
}

// How geometry (K, N, NS) launches (PRNG) on the current device:
// wide::launch_info's six ints in info (threads a block, dynamic shared bytes
// a block, elements a block, lanes an element, 1 if the state is in the
// scratch buffer, resident blocks a SM). Returns a CUDA error code
// (cudaErrorInvalidValue for a geometry this library does not hold).
extern "C" int mc_ia_launch_info(int K, int N, int NS, int* info) {
  int rc = (int)cudaErrorInvalidValue;
  with_geometry(K, N, NS, [&](auto geo) {
    with_kernel<decltype(geo), false>(
        geo, [&](auto kernel, int threads, long long bytes, int elems,
                 int lanes) {
          rc = wide::launch_info(kernel, threads, bytes, elems, lanes, info);
        });
  });
  return rc;
}

// In-kernel Philox bits (the counterpart of _make_prng_call): rep r of this
// call is the absolute attempt start + r of the stream keyed by seed.
extern "C" int mc_ia_prng(void* out, void* partial, int reps, int num_tiles,
                          int tile, int lane, int K, int N, int NS, int iters,
                          int init_iters, float P, float nv, unsigned int seed,
                          long long start, void* scratch, void* stream) {
  Params p = {};
  p.partial = static_cast<float*>(partial);
  p.scratch = static_cast<float*>(scratch);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.iters = iters;
  p.init_iters = init_iters;
  p.P = P;
  p.nv = nv;
  p.seed = seed;
  p.start = start;
  return launch(p, static_cast<float*>(out), reps, K, N, NS, false, stream);
}

// Channel bits read from an int32 device tensor in the JAX layout (the
// counterpart of build_inject): (reps, num_tiles * tile, planes * lane) with
// strides (rep_stride, row_stride, 1), plane pl at lanes
// [pl * lane, (pl + 1) * lane). scratch: mc_ia_scratch_bytes of device
// memory, or null where that is 0 (both entry points).
extern "C" int mc_ia_inject(const void* bits, void* out, void* partial,
                            int reps, int num_tiles, int tile, int lane, int K,
                            int N, int NS, int iters, int init_iters, float P,
                            float nv, long long rep_stride,
                            long long row_stride, void* scratch,
                            void* stream) {
  Params p = {};
  p.bits = static_cast<const int*>(bits);
  p.scratch = static_cast<float*>(scratch);
  p.rep_stride = rep_stride;
  p.row_stride = row_stride;
  p.partial = static_cast<float*>(partial);
  p.num_tiles = num_tiles;
  p.tile = tile;
  p.lane = lane;
  p.iters = iters;
  p.init_iters = init_iters;
  p.P = P;
  p.nv = nv;
  return launch(p, static_cast<float*>(out), reps, K, N, NS, true, stream);
}
