// Small-token attention, o = softmax(q k^T * scale) v, for S <= 64 tokens
// and head dim D <= 16 on (B, H, S, D) tensors, on the H100's tensor
// cores: the forward (kernel #2) and the backward (kernel #3).
//
// Replace the TPU kernels shifu_tpu/ops/pallas_small_attention.py:187
// _run_fwd (_fwd_kernel) and :209 _run_bwd (_bwd_kernel).  Same
// semantics: q, k, v (and g = dL/do) are read in their dtype; scores,
// softmax and every sum are f32; each output is rounded once to q's
// dtype; keys at or past S carry zero weight.  The backward recomputes the
// softmax w from q and k and writes dv = w^T g, dq = scale dS k and
// dk = scale dS^T q, where dP = g v^T, row = sum_k w dP (computed here, as
// _bwd_kernel does: o is not saved, and rowsum(g o) of a rounded o would be
// another number) and dS = w (dP - row).  Deterministic: no atomics,
// nothing carried between CTAs.
//
// Bound on the H100.  At the training path's shape (B=8192, H=8, S=31,
// D=8, bf16) the forward reads q, k, v and writes o, 130.0 MB (0.0388 ms
// at 3.35 TB/s); the backward reads q, k, v, g and writes dq, dk, dv,
// 227.5 MB (0.0679 ms).  Each takes B H S^2 = 6.30e7 exponentials (about
// 0.015 ms over the SFUs' 16 ex2 a clock an SM) and, with S padded to 32,
// 20 and 40 mma a group, 4.3 and 8.6 GFLOP (0.004 and 0.009 ms at 989
// TFLOP/s).  So bytes bound both: the design keeps enough bytes in flight
// an SM and little else in the way.
//
// Design.  One warp owns one (sample, head) group at a time; a CTA of
// kWarps warps walks over the groups with a stride, one wave of as many
// CTAs as the SMs hold.  A group's q, k, v (and g) are contiguous S x D
// rows: each warp stages its next group into shared memory with cp.async
// (16 bytes a copy, one a row at D = 8, two at D = 16) into a ring of two
// stages while it computes the current one.  Staged operands keep the
// 16-bit input dtype, zero past S and past D; a D other than 8 or 16
// takes element loads, and f32 inputs are split there, once, into bf16 hi
// + lo.  Shared memory is dynamic and sized by S and D padded (32 or 64
// rows, 8 or 16 columns; rows of 16 or 48 bytes, so ldmatrix's eight row
// addresses fall on distinct banks).
//
// Query rows go 16 at a time (an m-tile: 2 at S = 31).  Every key of a
// row sits in the warp's accumulators (16 f32 a lane at S <= 32, 32 at
// S <= 64), so the softmax takes one pass and each exponential once: keys
// >= S masked, the row max a tree over the thread's values and two quad
// shuffles, scale * log2(e) folded into one FFMA a score, ex2.approx.
// Products on the tensor cores (mma.sync, mma.cuh): Q K^T and dO V^T with
// m16n8k8 at D <= 8 and m16n8k16 above, K and V through ldmatrix; P V,
// dS K, dS^T Q and P^T dO with m16n8k16, P and dS taken from the
// accumulators, the transposed ones through movmatrix, the B operands
// through ldmatrix.trans.  The backward takes each m-tile once: scores, P,
// dP, row, dS, then dq for those 16 rows in full (stored at once), while
// dk and dv sum in registers over the m-tiles and are stored at the end.
//
// Accuracy, as in flash_common.cuh: 16-bit inputs enter the products as
// they are (exact products, f32 sums); P and dS enter as hi + lo 16-bit
// parts, two mma into one accumulator (in f16 dS's lo part is scaled by
// 2^11 into an accumulator of its own); f32 inputs enter as bf16 hi + lo,
// three mma a product.  One exception: for bf16 inputs the forward's P
// enters as three parts (hi, the rest rounded, the rest of that rounded),
// since with two a few outputs in a million, those that cancel towards 0,
// miss bf16's one-ulp tolerance, whose absolute floor is 1e-6.
// tests/test_torch_small_attention_numerics.py models these roundings
// against chip_smoke.py's tolerances and shows both misses.
//
// On the H100 (PERF.md) the forward runs at ~1.8x its byte bound and the
// backward at ~1.6x.  The third part of P costs the forward ~12%, so
// instruction issue, and not bytes alone, sets its pace.  Tried on the
// card with kernel_ab.py and slower: a ring of three stages (two groups in
// flight a warp); registers capped for more warps an SM (they spill);
// P^T and dS^T through a shared-memory bounce and ldmatrix.trans in place
// of movmatrix; 2 or 8 warps a CTA made no difference.  Masking only the
// key tiles that reach S was 2-3% faster and is kept.
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace shifu;

constexpr int kMaxS = 64;
constexpr int kMaxD = 16;
constexpr int kWarps = 4;   // a CTA's warps, each with groups of its own
// a warp's ring: the group computed and the next (three stages, the
// next two groups in flight, measured slower on the H100)
constexpr int kStages = 2;

// One warp's ring for NA operands of a group, S padded to SP and D to DP:
// kStages stages of NA operands, each of kParts parts (hi; lo for f32) of
// SP rows at a stride of kLd elements
template <typename T, int DP, int SP, int NA>
struct Ring {
  using E = typename Mma<T>::E;
  static constexpr int kParts = Mma<T>::kSplit ? 2 : 1;
  static constexpr int kLd = DP == 8 ? 8 : 24;
  static constexpr int kPanel = SP * kLd;
  static constexpr int kOp = kParts * kPanel;
  static constexpr int kStage = NA * kOp;
  static constexpr int kBytes =
      kWarps * kStages * kStage * static_cast<int>(sizeof(E));

  __device__ static Panel<E> panel(E* ring, int st, int op) {
    E* p = ring + st * kStage + op * kOp;
    return Panel<E>{p, p + (kParts - 1) * kPanel};
  }
};

// Stage group grp of the NA operands src (S x D rows each) into stage st of
// the warp's ring, zero past S and D.  vec (16-bit T, D == DP, 16-byte
// aligned): one cp.async a 16-byte chunk, each lane's chunks fixed at
// compile time; else element loads, f32 split into bf16 hi + lo.
template <typename T, int DP, int SP, int NA>
__device__ __forceinline__ void stage(typename Mma<T>::E* ring, int st,
                                      const T* const (&src)[NA],
                                      long long grp, int S, int D, bool vec) {
  using R = Ring<T, DP, SP, NA>;
  using E = typename R::E;
  const int lane = threadIdx.x % 32;
  const long long base = grp * S * D;
  if constexpr (!Mma<T>::kSplit) {
    if (vec) {
      constexpr int kC = DP / 8, kPerOp = SP * kC;  // 16-byte chunks
      static_assert(kPerOp % 32 == 0, "an operand is whole warps of chunks");
#pragma unroll
      for (int it = 0; it < NA * kPerOp / 32; ++it) {
        const int op = it * 32 / kPerOp, i = it * 32 % kPerOp + lane;
        const int r = i / kC, c = i % kC;
        cp16(R::panel(ring, st, op).hi + r * R::kLd + 8 * c,
             src[op] + base + (long long)(r < S ? r : 0) * D + 8 * c, r < S);
      }
      return;
    }
  }
#pragma unroll
  for (int op = 0; op < NA; ++op) {
    const Panel<E> p = R::panel(ring, st, op);
    const T* x = src[op] + base;
    for (int i = lane; i < SP * DP; i += 32) {
      const int r = i / DP, d = i % DP;
      const float v = (r < S && d < D) ? to_f32(x[(long long)r * D + d]) : 0.f;
      const E h = from_f32<E>(v);
      p.hi[r * R::kLd + d] = h;
      if constexpr (Mma<T>::kSplit) p.lo[r * R::kLd + d] = from_f32<E>(v - to_f32(h));
    }
  }
}

// The A fragments (16 x DP) of rows [r0, r0 + 16) of panel x, registers as
// score_mma takes them, every value's sign flipped by `sign` (exact)
template <int DP, int LD, bool kSplit, typename E>
__device__ __forceinline__ void frag_a(Panel<E> x, int r0, uint32_t sign,
                                       uint32_t (&hi)[DP / 4],
                                       uint32_t (&lo)[DP / 4]) {
  const int lane = threadIdx.x % 32;
  if constexpr (DP == 8) {
    const int off = (r0 + lane % 16) * LD;
    ldsm2(hi, x.hi + off);
    if constexpr (kSplit) ldsm2(lo, x.lo + off);
  } else {
    const int off = (r0 + lane % 8 + 8 * ((lane / 8) & 1)) * LD + 8 * (lane / 16);
    ldsm4(hi, x.hi + off);
    if constexpr (kSplit) ldsm4(lo, x.lo + off);
  }
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    hi[i] ^= sign;
    if constexpr (kSplit) lo[i] ^= sign;
  }
}

// keys >= S: -inf, so that they take no weight (only the key tiles that
// reach S are looked at)
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int S) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (8 * j + 8 > S)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= S) s[j][e] = -INFINITY;
}

// s = ex2(s c - max c) in place, each row's max from its live keys; returns
// this thread's part of the sums of the row halves (rows g, g + 8)
template <int NT>
__device__ __forceinline__ float2 softmax_exp(float (&s)[NT][4], float c) {
  const float mc[2] = {quad_max(tile_max<0>(s)) * c,
                       quad_max(tile_max<1>(s)) * c};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], c, -mc[e >> 1]));
      l[e >> 1] += s[j][e];
    }
  return make_float2(l[0], l[1]);
}

// The A fragment (16 x 16) of columns 16 kc .. 16 kc + 15 of the f32
// accumulator s as NP 16-bit parts: part 0 = x rounded, each next part the
// rest rounded (two parts: split's hi and lo)
template <typename E, int NT, int NP>
__device__ __forceinline__ void a_parts(const float (&s)[NT][4], int kc,
                                        uint32_t (&a)[NP][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* c = s[2 * kc + (i >> 1)] + 2 * (i & 1);
    float x0 = c[0], x1 = c[1];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      a[p][i] = pack<E>(x0, x1);
      if (p + 1 < NP) {
        const float2 h = unpack<E>(a[p][i]);
        x0 -= h.x;
        x1 -= h.y;
      }
    }
  }
}

// acc (16 x DP) += the sum of the NP parts of A (16 x 16 keys 16 kc ..)
// times those rows of panel x (transposed loads, once for all parts); f32
// inputs also A's first part times x's lo part
template <typename E, int DP, int LD, int NP, bool kSplit>
__device__ __forceinline__ void parts_mma(float (&acc)[DP / 8][4],
                                          const uint32_t (&a)[NP][4],
                                          Panel<E> x, int kc) {
  const int lane = threadIdx.x % 32;
  if constexpr (DP == 8) {
    const int off = (16 * kc + lane % 16) * LD;
    uint32_t b[2], bl[2];
    ldsm2t(b, x.hi + off);
    if constexpr (kSplit) ldsm2t(bl, x.lo + off);
#pragma unroll
    for (int p = 0; p < NP; ++p) mma16<E>(acc[0], a[p], b[0], b[1]);
    if constexpr (kSplit) mma16<E>(acc[0], a[0], bl[0], bl[1]);
  } else {
    const int mat = lane / 8, r = lane % 8;
    const int off = (16 * kc + 8 * (mat & 1) + r) * LD + 8 * (mat >> 1);
    uint32_t b[4], bl[4];
    ldsm4t(b, x.hi + off);
    if constexpr (kSplit) ldsm4t(bl, x.lo + off);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma16<E>(acc[u], a[p], b[2 * u], b[2 * u + 1]);
      if constexpr (kSplit) mma16<E>(acc[u], a[0], bl[2 * u], bl[2 * u + 1]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = pack<T>(a, b);
}

// Store rows [r0, r0 + 16) of a (16 x DP) accumulator times mul (rows g,
// and g + 8: mul1), rounded once to T; rows past S and columns past D are
// not written.  pairs (D even, y 16-byte aligned): two neighbouring columns
// a store.
template <typename T, int DP>
__device__ __forceinline__ void store_tile(T* __restrict__ y,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int S, int D, float mul0,
                                           float mul1, bool pairs) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, d = 8 * n + 2 * t;
      const float mul = h ? mul1 : mul0;
      const float a = acc[n][2 * h] * mul, b = acc[n][2 * h + 1] * mul;
      if (r >= S || d >= D) continue;
      T* p = y + (long long)r * D + d;
      if (pairs) {
        store2(p, a, b);
      } else {
        p[0] = from_f32<T>(a);
        if (d + 1 < D) p[1] = from_f32<T>(b);
      }
    }
}

// the scores' log2 scale, floored so that a masked -inf times it stays
// -inf; a negative scale flips q's sign instead (exact), so that the max of
// q.k is the max of the scaled scores
__device__ __forceinline__ float log2_scale(float scale) {
  return fmaxf(fabsf(scale) * kLog2e, 1e-30f);
}
__device__ __forceinline__ uint32_t sign_of(float scale) {
  return scale < 0.f ? 0x80008000u : 0u;
}

template <typename T, int DP, int SP>
__global__ void __launch_bounds__(kWarps * 32)
    sa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  long long groups, int S, int D, float scale, bool vec,
                  bool pairs) {
  using M = Mma<T>;
  using E = typename M::E;
  using R = Ring<T, DP, SP, 3>;
  constexpr int LD = R::kLd, NT = SP / 8;
  // P's 16-bit parts: three for bf16 inputs, whose one-ulp tolerance two
  // miss where an output cancels towards 0; two for f16 and f32
  constexpr int kPParts = std::is_same<T, __nv_bfloat16>::value ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem) + (threadIdx.x / 32) * kStages * R::kStage;
  const long long stride = (long long)gridDim.x * kWarps;
  long long grp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (grp >= groups) return;  // whole warps leave; no CTA-wide barrier
  const T* const src[3] = {q, k, v};
  const float c = log2_scale(scale);
  const uint32_t sign = sign_of(scale);
  const int mtiles = (S + 15) / 16;

  stage<T, DP, SP, 3>(ring, 0, src, grp, S, D, vec);
  cp_commit();
  for (int it = 0; grp < groups; grp += stride, ++it) {
    const int st = it & 1;
    if (grp + stride < groups)
      stage<T, DP, SP, 3>(ring, st ^ 1, src, grp + stride, S, D, vec);
    cp_commit();
    cp_wait_prev();
    __syncwarp();
    const Panel<E> qp = R::panel(ring, st, 0), kp = R::panel(ring, st, 1),
                   vp = R::panel(ring, st, 2);
    T* out = o + grp * S * D;
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      uint32_t qh[1][DP / 4], ql[1][DP / 4];
      frag_a<DP, LD, M::kSplit>(qp, 16 * mt, sign, qh[0], ql[0]);
      float s[1][NT][4];
      score_mma<E, DP, LD, NT, 1, M::kSplit>(s, qh, ql, kp);
      if (S < SP) mask_keys(s[0], S);
      const float2 l = softmax_exp(s[0], c);
      float acc[1][DP / 8][4];
      zero(acc);
#pragma unroll
      for (int kc = 0; kc < SP / 16; ++kc) {
        uint32_t pa[kPParts][4];
        a_parts<E, NT, kPParts>(s[0], kc, pa);
        parts_mma<E, DP, LD, kPParts, M::kSplit>(acc[0], pa, vp, kc);
      }
      store_tile<T, DP>(out, acc[0], 16 * mt, S, D, 1.f / quad_sum(l.x),
                        1.f / quad_sum(l.y), pairs);
    }
    __syncwarp();  // every lane is done with stage st before it is refilled
  }
}

// The A fragments of X^T (SP/16 tiles of 16 keys x the m-tile's 16 rows)
// from the f32 accumulator x (16 rows x SP keys): each 8 x 8 block split
// into hi + lo (lo times lo_scale) and transposed by movmatrix
template <typename E, int NT>
__device__ __forceinline__ void a_transposed(const float (&x)[NT][4],
                                             uint32_t (&hi)[NT / 2][4],
                                             uint32_t (&lo)[NT / 2][4],
                                             float lo_scale) {
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // keys 8 (i & 1) of the tile, rows 8 (i >> 1)
      const float* p = x[2 * kt + (i & 1)] + 2 * (i >> 1);
      uint32_t h, l;
      split<E>(p[0], p[1], h, l, lo_scale);
      hi[kt][i] = movt(h);
      lo[kt][i] = movt(l);
    }
}

template <typename T, int DP, int SP>
__global__ void __launch_bounds__(kWarps * 32)
    sa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ g,
                  T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                  long long groups, int S, int D, float scale, bool vec,
                  bool pairs) {
  using M = Mma<T>;
  using E = typename M::E;
  using R = Ring<T, DP, SP, 4>;
  constexpr int LD = R::kLd, NT = SP / 8, KT = SP / 16, DN = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem) + (threadIdx.x / 32) * kStages * R::kStage;
  const long long stride = (long long)gridDim.x * kWarps;
  long long grp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (grp >= groups) return;  // whole warps leave; no CTA-wide barrier
  const T* const src[4] = {q, k, v, g};
  const float c = log2_scale(scale);
  const uint32_t sign = sign_of(scale);
  const float lo_scale = M::kLoAcc ? kLoScale : 1.f;
  const int mtiles = (S + 15) / 16;

  stage<T, DP, SP, 4>(ring, 0, src, grp, S, D, vec);
  cp_commit();
  for (int it = 0; grp < groups; grp += stride, ++it) {
    const int st = it & 1;
    if (grp + stride < groups)
      stage<T, DP, SP, 4>(ring, st ^ 1, src, grp + stride, S, D, vec);
    cp_commit();
    cp_wait_prev();
    __syncwarp();
    const Panel<E> qp = R::panel(ring, st, 0), kp = R::panel(ring, st, 1),
                   vp = R::panel(ring, st, 2), gp = R::panel(ring, st, 3);
    const long long base = grp * S * D;
    // dk (and, in f16, dS lo's share of it) and dv over the keys, summed
    // over the m-tiles
    float dka[KT][DN][4], dkl[KT][DN][4], dva[KT][DN][4];
    zero(dka);
    zero(dva);
    if constexpr (M::kLoAcc) zero(dkl);
#pragma unroll 1
    for (int mt = 0; mt < mtiles; ++mt) {
      uint32_t qh[1][DP / 4], ql[1][DP / 4], gh[1][DP / 4], gl[1][DP / 4];
      frag_a<DP, LD, M::kSplit>(qp, 16 * mt, sign, qh[0], ql[0]);
      frag_a<DP, LD, M::kSplit>(gp, 16 * mt, 0u, gh[0], gl[0]);
      float s[1][NT][4], dp[1][NT][4];
      score_mma<E, DP, LD, NT, 1, M::kSplit>(s, qh, ql, kp);
      score_mma<E, DP, LD, NT, 1, M::kSplit>(dp, gh, gl, vp);
      if (S < SP) mask_keys(s[0], S);
      const float2 l = softmax_exp(s[0], c);
      const float il[2] = {1.f / quad_sum(l.x), 1.f / quad_sum(l.y)};
      // w = p / l (in s), row = sum_k w dP, then dS = w (dP - row) (in dp)
      float row[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[0][j][e] *= il[e >> 1];
          row[e >> 1] = fmaf(s[0][j][e], dp[0][j][e], row[e >> 1]);
        }
      row[0] = quad_sum(row[0]);
      row[1] = quad_sum(row[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[0][j][e] = s[0][j][e] * (dp[0][j][e] - row[e >> 1]);

      // dq = scale dS K for these 16 rows
      float dqa[1][DN][4], dql[1][DN][4];
      zero(dqa);
      if constexpr (M::kLoAcc) zero(dql);
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        uint32_t dh[1][4], dl[1][4];
        a_from_acc<E, NT>(dp[0], kc, dh[0], dl[0], lo_scale);
        out_mma<E, DP, LD, 1, M::kSplit>(dqa, M::kLoAcc ? dql : dqa, dh, dl,
                                         kp, kc);
      }
      if constexpr (M::kLoAcc) fold(dqa, dql);
      store_tile<T, DP>(dq + base, dqa[0], 16 * mt, S, D, scale, scale,
                        pairs);

      // dv += P^T dO and dk += dS^T Q over the m-tile's 16 rows
      const Panel<E> qm{qp.hi + 16 * mt * LD, qp.lo + 16 * mt * LD};
      const Panel<E> gm{gp.hi + 16 * mt * LD, gp.lo + 16 * mt * LD};
      uint32_t th[KT][4], tl[KT][4];
      a_transposed<E, NT>(s[0], th, tl, 1.f);
      out_mma<E, DP, LD, KT, M::kSplit>(dva, dva, th, tl, gm, 0);
      a_transposed<E, NT>(dp[0], th, tl, lo_scale);
      out_mma<E, DP, LD, KT, M::kSplit>(dka, M::kLoAcc ? dkl : dka, th, tl,
                                        qm, 0);
    }
    if constexpr (M::kLoAcc) fold(dka, dkl);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      store_tile<T, DP>(dk + base, dka[kt], 16 * kt, S, D, scale, scale, pairs);
      store_tile<T, DP>(dv + base, dva[kt], 16 * kt, S, D, 1.f, 1.f, pairs);
    }
    __syncwarp();  // every lane is done with stage st before it is refilled
  }
}

// The grid of a launch of `kernel` with `bytes` of shared memory: one wave
// of as many CTAs as the SMs hold, read once into `wave` (each
// instantiation's own), or fewer where the groups need fewer.  Returns the
// CUDA error code.
int grid_for(const void* kernel, int bytes, long long groups,
             std::atomic<int>& wave, unsigned& grid) {
  if (bytes > 48 * 1024) {  // above 48 KB only when asked for, per device
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  int n = wave.load(std::memory_order_relaxed);
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWarps * 32, bytes);
    if (e != cudaSuccess) return (int)e;
    n = sms * (per_sm > 0 ? per_sm : 1);
    wave.store(n, std::memory_order_relaxed);
  }
  const long long need = (groups + kWarps - 1) / kWarps;
  grid = (unsigned)(need < n ? need : n);
  return (int)cudaSuccess;
}

template <typename T, int DP, int SP>
int run_fwd(const void* q, const void* k, const void* v, void* o,
            long long groups, int S, int D, float scale, bool vec,
            bool pairs, cudaStream_t st) {
  constexpr int bytes = Ring<T, DP, SP, 3>::kBytes;
  static std::atomic<int> wave{0};
  unsigned grid;
  if (const int e = grid_for(reinterpret_cast<const void*>(
                                 sa_fwd_kernel<T, DP, SP>),
                             bytes, groups, wave, grid))
    return e;
  sa_fwd_kernel<T, DP, SP><<<grid, kWarps * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), groups, S, D, scale, vec,
      pairs);
  return (int)cudaSuccess;
}

template <typename T, int DP, int SP>
int run_bwd(const void* q, const void* k, const void* v, const void* g,
            void* dq, void* dk, void* dv, long long groups, int S, int D,
            float scale, bool vec, bool pairs, cudaStream_t st) {
  constexpr int bytes = Ring<T, DP, SP, 4>::kBytes;
  static std::atomic<int> wave{0};
  unsigned grid;
  if (const int e = grid_for(reinterpret_cast<const void*>(
                                 sa_bwd_kernel<T, DP, SP>),
                             bytes, groups, wave, grid))
    return e;
  sa_bwd_kernel<T, DP, SP><<<grid, kWarps * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), groups,
      S, D, scale, vec, pairs);
  return (int)cudaSuccess;
}

// The instantiation for (T, D padded to 8 or 16, S padded to 32 or 64)
template <typename T, typename... A>
int fwd_for(int S, int D, A... args) {
  if (D <= 8) return S <= 32 ? run_fwd<T, 8, 32>(args...) : run_fwd<T, 8, 64>(args...);
  return S <= 32 ? run_fwd<T, 16, 32>(args...) : run_fwd<T, 16, 64>(args...);
}

template <typename T, typename... A>
int bwd_for(int S, int D, A... args) {
  if (D <= 8) return S <= 32 ? run_bwd<T, 8, 32>(args...) : run_bwd<T, 8, 64>(args...);
  return S <= 32 ? run_bwd<T, 16, 32>(args...) : run_bwd<T, 16, 64>(args...);
}

// 16-byte copies: a 16-bit dtype, D of 8 or 16, inputs 16-byte aligned
bool vec_ok(int dtype, int D, const void* a, const void* b, const void* c,
            const void* d) {
  return dtype != kFloat32 && (D == 8 || D == 16) && aligned16(a) &&
         aligned16(b) && aligned16(c) && aligned16(d);
}

// stores of column pairs: D even, outputs 16-byte aligned
bool pairs_ok(int D, const void* a, const void* b, const void* c) {
  return D % 2 == 0 && aligned16(a) && aligned16(b) && aligned16(c);
}

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise.  Returns the CUDA error
// code of the launch (0 = cudaSuccess).
int small_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int S, int D, float scale, int dtype,
                        void* stream) {
  if (B < 0 || H < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const long long groups = (long long)B * H;
  if (groups == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(dtype, D, q, k, v, v);
  const bool pairs = pairs_ok(D, o, o, o);
  int rc;
  switch (dtype) {
    case shifu::kFloat32:
      rc = fwd_for<float>(S, D, q, k, v, o, groups, S, D, scale, vec, pairs, st);
      break;
    case shifu::kBFloat16:
      rc = fwd_for<__nv_bfloat16>(S, D, q, k, v, o, groups, S, D, scale, vec,
                                  pairs, st);
      break;
    case shifu::kFloat16:
      rc = fwd_for<__half>(S, D, q, k, v, o, groups, S, D, scale, vec, pairs,
                           st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}

// Backward (dq, dk, dv in q's dtype) on `stream`; does not synchronise.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
int small_attention_bwd(const void* q, const void* k, const void* v,
                        const void* g, void* dq, void* dk, void* dv, int B,
                        int H, int S, int D, float scale, int dtype,
                        void* stream) {
  if (B < 0 || H < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const long long groups = (long long)B * H;
  if (groups == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok(dtype, D, q, k, v, g);
  const bool pairs = pairs_ok(D, dq, dk, dv);
  int rc;
  switch (dtype) {
    case shifu::kFloat32:
      rc = bwd_for<float>(S, D, q, k, v, g, dq, dk, dv, groups, S, D, scale,
                          vec, pairs, st);
      break;
    case shifu::kBFloat16:
      rc = bwd_for<__nv_bfloat16>(S, D, q, k, v, g, dq, dk, dv, groups, S, D,
                                  scale, vec, pairs, st);
      break;
    case shifu::kFloat16:
      rc = bwd_for<__half>(S, D, q, k, v, g, dq, dk, dv, groups, S, D, scale,
                           vec, pairs, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}

const char* small_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
