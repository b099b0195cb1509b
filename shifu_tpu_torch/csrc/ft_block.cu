// Fused pre-LN FT-Transformer block, one pass over (B, S, D) f32 tokens:
//   y = LN(x); qkv = y Wqkv + b; per-head softmax(q k^T / sqrt(dh)) v;
//   x += attn Wp + b; y = LN(x); x += gelu_tanh(y Win + b) Wout + b.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_ft_block.py (_run_fwd over
// _block_math).  Same math, all in f32: LayerNorm with a two-pass variance
// and eps 1e-6, tanh-approximate gelu, softmax over the S real keys.
//
// Bound on the H100.  At the training path's shape (B=8192, S=31, D=64,
// H=8, R=4) a block is 28.2 GFLOP, 24.96 of them in the four products, over
// 130 MB of f32 activations in and out (0.039 ms at 3.35 TB/s).  The
// products run on the tensor cores with every f32 operand split into bf16
// hi + lo parts and three mma a product (hi hi, hi lo, lo hi): 3 x 24.96
// GFLOP at 989 TFLOP/s is 0.076 ms.  The rest (attention products,
// softmax, LayerNorm, gelu: 3.2 GFLOP) stays on the CUDA cores at 67
// TFLOP/s, 0.048 ms.  The bound is the largest, 0.076 ms (chip_smoke.py
// prints the three terms).
//
// Design.  A CTA owns NS whole samples, NS * S rows padded to a multiple
// of 16 (at most 128): 8 m-tiles of 16 rows, NH warps each (NH = 2 for D
// <= 64, each warp then taking half of a product's columns; 1 above,
// where the registers a warp needs do not fit 128).  NS is as many
// samples as 128 rows and shared memory hold, but no more than B spread
// over the SMs needs, so a small serving bucket still fills the card.  The
// activations never leave shared memory: X (rows x D, f32) is the residual
// stream; QKV (rows x 3D, f32) holds q|k|v, and the attention output
// overwrites q.  The weights stream through shared memory in tiles of 64
// k-rows x 64 columns, in one schedule over the four products: cp.async
// brings tile t + 1 (raw f32, a ring of two) while tile t is split into
// bf16 hi + lo (one pass between two barriers) and multiplied, so each
// weight fragment fetched from L2 feeds up to 128 rows (one CTA an SM:
// ~190 KB of shared memory at D = 64).  The A operand of every product
// lives in registers: the LayerNorm is computed straight into mma
// fragments (a row's values sit in one quad of lanes, reduced with two
// shuffles); the attention output is read back from shared memory into
// fragments; the FFN's hidden chunk goes from the mlp_in accumulator
// through bias, gelu and the hi/lo split into the A fragments of mlp_out
// without touching shared memory, and the FFN output accumulates in
// registers until the final store (with NH = 2 the two warps of an m-tile
// add their halves through shared memory there).  B fragments come
// through ldmatrix.trans from tiles of stride 72 (144 bytes: eight rows on
// distinct banks).  f32 row strides in shared memory are 8 or 24 mod 32
// words, so the fragments' float2 loads and stores are conflict-free.
//
// Attention runs on the CUDA cores, one thread per (row, head): at the
// path's head dim of 8 a score is 8 FMAs, and on the tensor cores it would
// pad to a k of 16 and need three mma for f32 accuracy; it is 2.0 of the
// 28.2 GFLOP.  Each score is computed once, p = exp2f(s * scale * log2(e)
// - max * scale * log2(e)) (one FFMA and one exp2f a score), and the
// output is divided exactly by the sum of p (see attention for the online
// softmax over chunks of keys at head dims 8 and 16).
//
// What the time goes to: at the path's shape the kernel runs at ~11x its
// bound (chip_smoke.py).  Taking one stage out at a time (kernel_ab.py,
// H100 SXM, PERF.md) saves: the products (mma.sync and their ldmatrix
// loads) 0.38 of 0.86 ms, the most; attention 0.14; gelu 0.11; the two
// LayerNorms 0.08; the split of the weight tiles 0.06.  So the products,
// at ~20% of the bf16 rate for their three passes, set the pace: wgmma,
// and more rows a CTA with fewer registers a row, are what is left.
//
// Ragged edges.  D is zero-padded to a multiple of 16 inside the kernel
// (the fragments mask columns past D; tiles zero-fill rows past K and
// columns past N); pad rows hold LayerNorm(0) = bias, stay finite, join no
// sample's attention and are not stored.  Nothing is padded in device
// memory.
//
// Registers and spills of the instantiations (nvcc -Xptxas -v, sm_90a, as
// chip_smoke.py's build line prints them; KS = D padded / 16, DH = the
// head-dim case): KS 1-4 (NH = 2, capped at 128 registers): DH 8 124-128
// registers, no spills but at KS 3 (8 B) and KS 4 (the path's: 72 B
// stored, 180 B loaded); DH 16 0-80 B stored; DH 0 80-312 B stored.  KS
// 5-8 (NH = 1): DH 8 and 16 195-244 registers, no spills; DH 0 255, 28-60
// B stored.  SASS: 48 x KS HMMA at NH = 2, 96 x KS at NH = 1; no
// MUFU.TANH.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// a CTA's 16-row m-tiles; NH warps each (1 or 2: each warp then takes
// 1 / NH of a product's columns)
constexpr int kMTiles = 8;
constexpr int kMaxRows = 16 * kMTiles;
constexpr int kMaxS = 64;
constexpr int kMaxD = 128;
constexpr int kMaxR = 8;
constexpr float kLnEps = 1e-6f;
constexpr float kLog2e = 1.4426950408889634f;
// shared memory a block may take on sm_90 (227 KB)
constexpr int kMaxSmem = 232448;
// a weight tile: kTk k-rows x kTn columns; the bf16 tiles' row stride
constexpr int kTk = 64;
constexpr int kTn = 64;
constexpr int kTld = kTn + 8;
constexpr int kRawBytes = 2 * kTk * kTn * 4;  // the f32 ring of two
constexpr int kTileBytes = 2 * kTk * kTld * 2;  // bf16 hi + lo

struct Params {
  const float* ln_attn_scale;
  const float* ln_attn_bias;
  const float* qkv_kernel;
  const float* qkv_bias;
  const float* proj_kernel;
  const float* proj_bias;
  const float* ln_mlp_scale;
  const float* ln_mlp_bias;
  const float* mlp_in_kernel;
  const float* mlp_in_bias;
  const float* mlp_out_kernel;
  const float* mlp_out_bias;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
// f32 row strides: 8 or 24 mod 32 words
__host__ __device__ inline int ld_x(int D) { return round16(D) + 8; }
__host__ __device__ inline int ld_q(int D) { return round16(3 * D) + 8; }

__host__ __device__ inline size_t smem_bytes(int rows, int D) {
  return (size_t)kRawBytes + kTileBytes +
         (size_t)rows * (ld_x(D) + ld_q(D)) * sizeof(float);
}

// tanh-approximate gelu, 0.5 x (1 + tanh(y)) with y = sqrt(2 / pi) (x +
// 0.044715 x^3), as x / (1 + exp(-2 y)): the same function (0.5 (1 +
// tanh(y)) is the logistic of 2 y), with an accurate expf (2 ulp, as
// tanhf) and __fdividef (2 ulp; 0 once 1 + exp(-2 y) passes 2^126, where
// the result is below 1e-36 in size), and no branch: tanhf and an IEEE
// division each have one, which keeps a thread's gelus from overlapping
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return __fdividef(x, 1.f + expf(-2.f * c * (x + 0.044715f * x * x * x)));
}

// -- the weight tiles ----------------------------------------------------------

// One tile of a weight matrix W (K x N, row-major): rows k0 .. k0 + kTk,
// columns n0 .. n0 + kTn
struct Tile {
  const float* w;
  int K, N, k0, n0;
};

// The schedule of tiles over the four products: QKV (n outer, k inner),
// proj, then per 64-column hidden chunk the mlp_in tiles and the mlp_out
// tiles of that chunk.
struct Schedule {
  int D, R;

  __device__ int kq() const { return (D + kTk - 1) / kTk; }
  __device__ int nq_qkv() const { return (3 * D + kTn - 1) / kTn; }
  __device__ int nq_d() const { return (D + kTn - 1) / kTn; }
  __device__ int n_total() const {
    return (nq_qkv() + nq_d()) * kq() +
           (R * D + kTn - 1) / kTn * (kq() + nq_d());
  }

  // the weights are read from the kernel's parameters, not held here
  __device__ Tile at(const Params& p, int t) const {
    const int k = kq(), nd = nq_d(), n_qkv = nq_qkv() * k;
    if (t < n_qkv)
      return {p.qkv_kernel, D, 3 * D, t % k * kTk, t / k * kTn};
    t -= n_qkv;
    if (t < nd * k) return {p.proj_kernel, D, D, t % k * kTk, t / k * kTn};
    t -= nd * k;
    const int hc = t / (k + nd), u = t % (k + nd);
    if (u < k) return {p.mlp_in_kernel, D, R * D, u * kTk, hc * kTn};
    return {p.mlp_out_kernel, R * D, D, hc * kTk, (u - k) * kTn};
  }
};

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   shifu::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// the rows a tile's products take: K - k0 rounded up to 16, at most kTk
__device__ __forceinline__ int tile_rows(const Tile& tl) {
  return min(kTk, round16(tl.K - tl.k0));
}

// Start the copy of tile `tl` into raw (kTk x kTn f32), zero past K and N.
// vec: D is a multiple of 4 (so is every N) and x and every W are 16-byte
// aligned.
__device__ __forceinline__ void fetch(const Tile& tl, float* raw, bool vec) {
  const int rows = tile_rows(tl);
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kTn / 4); i += blockDim.x) {
      const int r = i / (kTn / 4), c = i % (kTn / 4) * 4;
      const int k = tl.k0 + r, n = tl.n0 + c;
      const bool ok = k < tl.K && n < tl.N;
      shifu::cp16(raw + r * kTn + c,
                  ok ? tl.w + (size_t)k * tl.N + n : tl.w, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kTn; i += blockDim.x) {
      const int r = i / kTn, c = i % kTn;
      const int k = tl.k0 + r, n = tl.n0 + c;
      const bool ok = k < tl.K && n < tl.N;
      cp4(raw + r * kTn + c, ok ? tl.w + (size_t)k * tl.N + n : tl.w, ok);
    }
  }
}

// raw f32 tile -> bf16 hi and lo tiles (stride kTld)
__device__ __forceinline__ void split_tile(const float* raw, int rows,
                                           bf16* hi, bf16* lo) {
  for (int i = threadIdx.x; i < rows * (kTn / 2); i += blockDim.x) {
    const int r = i / (kTn / 2), c = i % (kTn / 2) * 2;
    const float2 v = *reinterpret_cast<const float2*>(raw + r * kTn + c);
    uint32_t h, l;
    shifu::split<bf16>(v.x, v.y, h, l);
    *reinterpret_cast<uint32_t*>(hi + r * kTld + c) = h;
    *reinterpret_cast<uint32_t*>(lo + r * kTld + c) = l;
  }
}

// The stream of weight tiles through shared memory: next() makes tile t
// ready in hi/lo for every warp and has tile t + 1 on its way.  All threads
// of the CTA call it the same number of times.
struct Stream {
  Schedule sched;
  float* raw;  // two kTk x kTn f32 tiles
  bf16* hi;
  bf16* lo;
  bool vec;
  int t;

  __device__ Stream(const Params& p, int D, int R, float* raw_, bf16* hi_,
                    bf16* lo_, bool vec_)
      : sched{D, R}, raw(raw_), hi(hi_), lo(lo_), vec(vec_), t(0) {
    fetch(sched.at(p, 0), raw, vec);
    shifu::cp_commit();
  }

  __device__ Tile next(const Params& p) {
    const Tile cur = sched.at(p, t);
    if (t + 1 < sched.n_total())
      fetch(sched.at(p, t + 1), raw + ((t + 1) & 1) * kTk * kTn, vec);
    shifu::cp_commit();  // an empty group past the last tile
    shifu::cp_wait_prev();
    __syncthreads();  // tile t has landed; every warp is done with t - 1
    split_tile(raw + (t & 1) * kTk * kTn, tile_rows(cur), hi, lo);
    __syncthreads();
    ++t;
    return cur;
  }
};

// acc[nt] for nt in [nb, nb + 2 np) += A . B, three mma a product (hi hi,
// hi lo, lo hi): A's k-steps ks in [ks0, ks0 + ksn) from registers (16 x
// 16 each, hi and lo) against the tile's rows krow + 16 (ks - ks0) ..;
// n-tile nt against the tile's columns ccol + 8 (nt - nb) ..
template <int KA, int NA>
__device__ __forceinline__ void tile_mma(float (&acc)[NA][4],
                                         const uint32_t (&ah)[KA][4],
                                         const uint32_t (&al)[KA][4],
                                         int ks0, int ksn, int krow, int nb,
                                         int np, int ccol, const bf16* hi,
                                         const bf16* lo) {
  const int lane = threadIdx.x & 31;
  const int lane_off = (krow + (lane & 15)) * kTld + ccol + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KA; ++ks) {
    if (ks < ks0 || ks >= ks0 + ksn) continue;
    const int k_off = (ks - ks0) * 16 * kTld + lane_off;
#pragma unroll
    for (int nt = 0; nt < NA; nt += 2) {
      if (nt < nb || nt >= nb + 2 * np) continue;
      const int off = k_off + (nt - nb) * 8;
      uint32_t bh[4], bl[4];
      shifu::ldsm4t(bh, hi + off);
      shifu::ldsm4t(bl, lo + off);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        shifu::mma16<bf16>(acc[nt + u], ah[ks], bh[2 * u], bh[2 * u + 1]);
        shifu::mma16<bf16>(acc[nt + u], ah[ks], bl[2 * u], bl[2 * u + 1]);
        shifu::mma16<bf16>(acc[nt + u], al[ks], bh[2 * u], bh[2 * u + 1]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// -- A fragments -----------------------------------------------------------------

// Element (h, ks, e) of a thread's 16-row slice: row g + 8 h, column
// 16 ks + 8 (e >> 1) + 2 t + (e & 1).  Fragment register i of k-step ks
// holds the pair (h, e) = (i & 1, 2 (i >> 1)) and its neighbour.
template <int KS>
__device__ __forceinline__ void load_rows(const float* Y, int ld, int r0,
                                          float (&v)[2][KS][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float2 x = *reinterpret_cast<const float2*>(
            Y + (r0 + g + 8 * h) * ld + 16 * ks + 8 * (e >> 1) + 2 * t);
        v[h][ks][e] = x.x;
        v[h][ks][e + 1] = x.y;
      }
}

template <int KS>
__device__ __forceinline__ void to_frags(const float (&v)[2][KS][4],
                                         uint32_t (&ah)[KS][4],
                                         uint32_t (&al)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, e = 2 * (i >> 1);
      shifu::split<bf16>(v[h][ks][e], v[h][ks][e + 1], ah[ks][i], al[ks][i]);
    }
}

__device__ __forceinline__ int frag_col(int ks, int e) {
  return 16 * ks + 8 * (e >> 1) + 2 * (threadIdx.x & 3) + (e & 1);
}

// A fragments of LayerNorm(X) over the warp's rows r0 .. r0 + 15; columns
// past D are 0.  A row's values lie in one quad of lanes.
template <int KS>
__device__ __forceinline__ void layernorm_frags(
    const float* X, int ldx, int r0, int D, const float* __restrict__ scale,
    const float* __restrict__ bias, uint32_t (&ah)[KS][4],
    uint32_t (&al)[KS][4]) {
  float v[2][KS][4], sc[KS][4], bi[KS][4];
  load_rows<KS>(X, ldx, r0, v);
  // the scale and bias of the thread's columns, loaded once for both of
  // its rows (columns past D read column 0: they are masked)
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = frag_col(ks, e) < D ? frag_col(ks, e) : 0;
      sc[ks][e] = __ldg(scale + c);
      bi[ks][e] = __ldg(bias + c);
    }
  const float inv_d = 1.f / (float)D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (frag_col(ks, e) < D) s += v[h][ks][e];
    const float mean = shifu::quad_sum(s) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (frag_col(ks, e) < D) {
          const float d = v[h][ks][e] - mean;
          sq = fmaf(d, d, sq);
        }
    const float rstd = rsqrtf(shifu::quad_sum(sq) * inv_d + kLnEps);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(ks, e);
        v[h][ks][e] =
            c < D ? (v[h][ks][e] - mean) * rstd * sc[ks][e] + bi[ks][e] : 0.f;
      }
  }
  to_frags<KS>(v, ah, al);
}

// A fragments of the attention output (the q columns of QKV), 0 past D
template <int KS>
__device__ __forceinline__ void attn_frags(const float* Q, int ldq, int r0,
                                           int D, uint32_t (&ah)[KS][4],
                                           uint32_t (&al)[KS][4]) {
  float v[2][KS][4];
  load_rows<KS>(Q, ldq, r0, v);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (frag_col(ks, e) >= D) v[h][ks][e] = 0.f;
  to_frags<KS>(v, ah, al);
}

// -- epilogues -------------------------------------------------------------------

// Y[r][n0 + c] (op)= acc + bias for the warp's rows and columns n < N;
// ADD: Y += (acc + bias), else Y = acc + bias.
template <bool ADD, int NA>
__device__ __forceinline__ void store_acc(float* Y, int ld, int r0,
                                          const float (&acc)[NA][4], int nb,
                                          int n0, int N,
                                          const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NA - nb; ++nt) {
    const int n = n0 + 8 * nt + 2 * t;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    const float b0 = __ldg(bias + n), b1 = two ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* y = Y + (r0 + g + 8 * h) * ld + n;
      const float v0 = acc[nb + nt][2 * h] + b0;
      const float v1 = acc[nb + nt][2 * h + 1] + b1;
      if (ADD) {
        y[0] += v0;
        if (two) y[1] += v1;
      } else if (two) {
        *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
      } else {
        y[0] = v0;
      }
    }
  }
}

// -- attention --------------------------------------------------------------------

// Per-head softmax attention of the block's ns samples: q|k|v in QKV
// (stride ldq); each (row, head)'s output overwrites its q.  One thread a
// (row, head); c = scale * log2(e); each score is computed once, and p =
// exp2f(s c - max c), one FFMA and one exp2f a score.  Keys go kJ at a
// time (keys past S read key S - 1 and are masked): kJ independent chains
// inside a chunk.  DH 8 or 16: q, the output and the chunk's scores in
// registers, 16-byte loads, and the softmax online over the chunks (the
// running max and sum, the output rescaled once a chunk), so a thread
// holds kJ scores, not S.  DH 0 (any other head dim): q from shared
// memory, the S scores in registers, the output in chunks of 16 dims.
constexpr int kJ = 8;

template <int DH>
__device__ __forceinline__ void attention_fixed(float* q, const float* k,
                                                const float* v, int ldq,
                                                int S, float c) {
  float qr[DH], o[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(q + d);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < S; j0 += kJ) {
    float s[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float* kj = k + min(j0 + jj, S - 1) * ldq;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(kj + d);
        a = fmaf(qr[d], x.x, a);
        a = fmaf(qr[d + 1], x.y, a);
        a = fmaf(qr[d + 2], x.z, a);
        a = fmaf(qr[d + 3], x.w, a);
      }
      s[jj] = j0 + jj < S ? a : -INFINITY;
    }
    float t[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) t[jj] = s[jj];
#pragma unroll
    for (int w = kJ / 2; w > 0; w /= 2)
#pragma unroll
      for (int jj = 0; jj < w; ++jj) t[jj] = fmaxf(t[jj], t[jj + w]);
    const float mn = fmaxf(m, t[0]), mc = mn * c;
    const float corr = exp2f(fmaf(m, c, -mc));  // 0 on the first chunk
    m = mn;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      s[jj] = exp2f(fmaf(s[jj], c, -mc));
      t[jj] = s[jj];
    }
#pragma unroll
    for (int w = kJ / 2; w > 0; w /= 2)
#pragma unroll
      for (int jj = 0; jj < w; ++jj) t[jj] += t[jj + w];
    l = fmaf(l, corr, t[0]);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float* vj = v + min(j0 + jj, S - 1) * ldq;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(vj + d);
        o[d] = fmaf(s[jj], x.x, o[d]);
        o[d + 1] = fmaf(s[jj], x.y, o[d + 1]);
        o[d + 2] = fmaf(s[jj], x.z, o[d + 2]);
        o[d + 3] = fmaf(s[jj], x.w, o[d + 3]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DH; d += 4)
    *reinterpret_cast<float4*>(q + d) =
        make_float4(o[d] / l, o[d + 1] / l, o[d + 2] / l, o[d + 3] / l);
}

__device__ __forceinline__ void attention_any(float* q, const float* k,
                                              const float* v, int ldq, int S,
                                              int dh, float c) {
  float s[kMaxS];
#pragma unroll
  for (int j = 0; j < kMaxS; ++j) s[j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    const float qd = q[d];
#pragma unroll
    for (int j0 = 0; j0 < kMaxS; j0 += kJ) {
      if (j0 >= S) break;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        s[j0 + jj] = fmaf(qd, k[min(j0 + jj, S - 1) * ldq + d], s[j0 + jj]);
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxS; ++j)
    if (j < S) m = fmaxf(m, s[j]);
  const float mc = m * c;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxS; ++j) {
    s[j] = j < S ? exp2f(fmaf(s[j], c, -mc)) : 0.f;
    l += s[j];
  }
  for (int d0 = 0; d0 < dh; d0 += 16) {
    float o[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) o[d] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < kMaxS; j0 += kJ) {
      if (j0 >= S) break;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float* vj = v + min(j0 + jj, S - 1) * ldq + d0;
#pragma unroll
        for (int d = 0; d < 16; ++d)
          if (d0 + d < dh) o[d] = fmaf(s[j0 + jj], vj[d], o[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < 16; ++d)
      if (d0 + d < dh) q[d0 + d] = o[d] / l;
  }
}

template <int DH>
__device__ void attention(float* QKV, int ldq, int ns, int S, int D, int H,
                          float c) {
  const int dh = DH ? DH : D / H;
  const int items = ns * H * S;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r = it % S, sh = it / S;
    const int h = sh % H, first = sh / H * S;
    float* q = QKV + (first + r) * ldq + h * dh;
    const float* k = QKV + first * ldq + D + h * dh;
    if (DH)
      attention_fixed<DH ? DH : 8>(q, k, k + D, ldq, S, c);
    else
      attention_any(q, k, k + D, ldq, S, dh, c);
  }
}

// -- the kernel ------------------------------------------------------------------

// KS: D rounded up to 16, over 16 (the k-steps of an A operand over D).
// DH: attention's head dim case (see attention).  NH: warps an m-tile.
template <int KS, int DH, int NH>
__global__ void __launch_bounds__(32 * kMTiles * NH, 1)
    ft_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                    Params p, int B, int S, int D, int H, int R, int NS,
                    float scale_log2e, bool vec) {
  constexpr int kNt = 8 / NH;  // n-tiles of a 64-column tile a warp takes
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  bf16* th = reinterpret_cast<bf16*>(smem + kRawBytes);
  bf16* tl = th + kTk * kTld;
  const int ldx = ld_x(D), ldq = ld_q(D);
  const int b0 = blockIdx.x * NS;
  const int ns = min(NS, B - b0);
  const int m = ns * S;          // real token rows of this block
  const int rows = round16(m);   // rows the products take
  float* X = reinterpret_cast<float*>(smem + kRawBytes + kTileBytes);
  float* QKV = X + rows * ldx;
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp % kMTiles);
  const int half = warp / kMTiles;  // which 1 / NH of the columns
  const int ccol = 8 * kNt * half;  // its first column in a tile
  const bool active = r0 < rows;

  // the block's rows into X (zero in pad rows and pad columns), then the
  // first weight tile, both in flight at once
  const float* xin = x + (size_t)b0 * S * D;
  constexpr int dp = 16 * KS;
  if (vec) {
    for (int i = threadIdx.x; i < rows * (dp / 4); i += blockDim.x) {
      const int r = i / (dp / 4), c = i % (dp / 4) * 4;
      const bool ok = r < m && c < D;
      shifu::cp16(X + r * ldx + c, ok ? xin + r * D + c : xin, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dp; i += blockDim.x) {
      const int r = i / dp, c = i % dp;
      const bool ok = r < m && c < D;
      cp4(X + r * ldx + c, ok ? xin + r * D + c : xin, ok);
    }
  }
  shifu::cp_commit();
  Stream ws(p, D, R, raw, th, tl, vec);
  shifu::cp_wait_prev();
  __syncthreads();

  // the warp's n-tile pairs of a tile whose columns end at N
  auto pairs = [&](const Tile& t) {
    return max(0, min(kNt / 2, (t.N - t.n0 - ccol + 15) / 16));
  };

  uint32_t ah[KS][4], al[KS][4];
  if (active)
    layernorm_frags<KS>(X, ldx, r0, D, p.ln_attn_scale, p.ln_attn_bias, ah,
                        al);

  // qkv = LN(x) Wqkv + b into QKV
  const Schedule sc = ws.sched;
  float acc[kNt][4];
  for (int nc = 0; nc < sc.nq_qkv(); ++nc) {
    zero(acc);
    for (int kc = 0; kc < sc.kq(); ++kc) {
      const Tile t = ws.next(p);
      if (active)
        tile_mma<KS, kNt>(acc, ah, al, t.k0 / 16, tile_rows(t) / 16, 0, 0,
                          pairs(t), ccol, th, tl);
    }
    if (active)
      store_acc<false, kNt>(QKV, ldq, r0, acc, 0, nc * kTn + ccol, 3 * D,
                            p.qkv_bias);
  }
  __syncthreads();
  attention<DH>(QKV, ldq, ns, S, D, H, scale_log2e);
  __syncthreads();

  // x += attn Wp + b
  if (active) attn_frags<KS>(QKV, ldq, r0, D, ah, al);
  for (int nc = 0; nc < sc.nq_d(); ++nc) {
    zero(acc);
    for (int kc = 0; kc < sc.kq(); ++kc) {
      const Tile t = ws.next(p);
      if (active)
        tile_mma<KS, kNt>(acc, ah, al, t.k0 / 16, tile_rows(t) / 16, 0, 0,
                          pairs(t), ccol, th, tl);
    }
    if (active)
      store_acc<true, kNt>(X, ldx, r0, acc, 0, nc * kTn + ccol, D,
                           p.proj_bias);
  }
  __syncthreads();  // every column of the warp's rows is in X

  // x += gelu(LN(x) Win + b) Wout + b, 64 hidden columns at a time; a
  // warp takes 64 / NH of them, and sums its part of the output in o
  if (active)
    layernorm_frags<KS>(X, ldx, r0, D, p.ln_mlp_scale, p.ln_mlp_bias, ah, al);
  float o[2 * KS][4];
  zero(o);
  const int hidden = R * D;
  for (int hc = 0; hc < hidden; hc += kTn) {
    zero(acc);
    for (int kc = 0; kc < sc.kq(); ++kc) {
      const Tile t = ws.next(p);
      if (active)
        tile_mma<KS, kNt>(acc, ah, al, t.k0 / 16, tile_rows(t) / 16, 0, 0,
                          pairs(t), ccol, th, tl);
    }
    uint32_t gh[kNt / 2][4], gl[kNt / 2][4];
    if (active) {
      const int t4 = threadIdx.x & 3;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = hc + ccol + 8 * nt + 2 * t4 + (e & 1);
          // columns past the hidden width: 0 (their weights are 0 too)
          acc[nt][e] = n < hidden
                           ? gelu_tanh(acc[nt][e] + __ldg(p.mlp_in_bias + n))
                           : 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < kNt / 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* c2 = acc[2 * ks + (i >> 1)] + 2 * (i & 1);
          shifu::split<bf16>(c2[0], c2[1], gh[ks][i], gl[ks][i]);
        }
    }
    for (int nc = 0; nc < sc.nq_d(); ++nc) {
      const Tile t = ws.next(p);
      if (active)
        tile_mma<kNt / 2, 2 * KS>(
            o, gh, gl, 0, min(kNt / 2, tile_rows(t) / 16 - kNt / 2 * half),
            ccol, 8 * nc, min(4, (t.N - t.n0 + 15) / 16), 0, th, tl);
    }
  }

  // out = x + (ffn + b), the block's real rows; with NH = 2 the second
  // warp of an m-tile hands its part of the sum over QKV (no longer read)
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  if (NH == 2) {
    if (active && half == 1) {
#pragma unroll
      for (int nt = 0; nt < 2 * KS; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(QKV + (r0 + g + 8 * h) * ldq + 8 * nt +
                                     2 * t4) =
              make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
    }
    __syncthreads();
  }
  if (active && half == 0) {
    float* dst = out + (size_t)b0 * S * D;
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
      const int n = 8 * nt + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= m) continue;
        float2 other = make_float2(0.f, 0.f);
        if (NH == 2)
          other = *reinterpret_cast<const float2*>(QKV + r * ldq + n);
        const float sum[2] = {o[nt][2 * h] + other.x,
                              o[nt][2 * h + 1] + other.y};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n + e < D)
            dst[(size_t)r * D + n + e] =
                X[r * ldx + n + e] +
                (sum[e] + __ldg(p.mlp_out_bias + n + e));
      }
    }
  }
}

using KernelFn = void (*)(const float*, float*, Params, int, int, int, int,
                          int, int, float, bool);

// two warps an m-tile where their registers fit (KS <= 4: 128 a thread)
template <int KS>
KernelFn pick_dh(int dh) {
  constexpr int NH = KS <= 4 ? 2 : 1;
  if (dh == 8) return ft_block_kernel<KS, 8, NH>;
  if (dh == 16) return ft_block_kernel<KS, 16, NH>;
  return ft_block_kernel<KS, 0, NH>;
}

int warps_an_mtile(int D) { return round16(D) / 16 <= 4 ? 2 : 1; }

KernelFn pick(int D, int dh) {
  switch (round16(D) / 16) {
    case 1: return pick_dh<1>(dh);
    case 2: return pick_dh<2>(dh);
    case 3: return pick_dh<3>(dh);
    case 4: return pick_dh<4>(dh);
    case 5: return pick_dh<5>(dh);
    case 6: return pick_dh<6>(dh);
    case 7: return pick_dh<7>(dh);
    default: return pick_dh<8>(dh);
  }
}

// the largest multiple of 16 rows, at most kMaxRows, whose plan fits
int rows_cap(int D) {
  int rows = kMaxRows;
  while (rows > 16 && smem_bytes(rows, D) > (size_t)kMaxSmem) rows -= 16;
  return rows;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace

extern "C" {

// x, out: (B, S, D) f32, contiguous, on the device.  params: the 12 f32
// tensors in shifu_tpu's _PARAM_ORDER.  Launches on `stream` and does not
// synchronise.  Returns the CUDA error code (0 = cudaSuccess).
int ft_block_fwd(const void* x, void* out, const void* const* params, int B,
                 int S, int D, int H, int R, float inv_sqrt_dh,
                 void* stream) {
  if (B < 0 || S < 1 || S > kMaxS || D < 1 || D > kMaxD || R < 1 ||
      R > kMaxR || H < 1 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // samples a block: as many as the rows and shared memory hold, but no
  // more than spreads B over the SMs
  const int cap = rows_cap(D) / S;
  const int spread = (B + sm_count() - 1) / sm_count();
  const int ns = max(1, min(cap, spread));
  const size_t smem = smem_bytes(round16(ns * S), D);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const float* const* f = reinterpret_cast<const float* const*>(params);
  Params p{f[0], f[1], f[2], f[3], f[4], f[5],
           f[6], f[7], f[8], f[9], f[10], f[11]};
  const bool vec = D % 4 == 0 && shifu::aligned16(x) &&
                   shifu::aligned16(p.qkv_kernel) &&
                   shifu::aligned16(p.proj_kernel) &&
                   shifu::aligned16(p.mlp_in_kernel) &&
                   shifu::aligned16(p.mlp_out_kernel);
  KernelFn kernel = pick(D, D / H);
  // the attribute is set once per instantiation, to the most a block takes
  static KernelFn allowed[64];
  static int n_allowed = 0;
  bool known = false;
  for (int i = 0; i < n_allowed; ++i) known = known || allowed[i] == kernel;
  if (!known) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (n_allowed < 64) allowed[n_allowed++] = kernel;
  }
  const unsigned blocks = (unsigned)((B + ns - 1) / ns);
  const int threads = 32 * kMTiles * warps_an_mtile(D);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p, B, S, D, H,
      R, ns, inv_sqrt_dh * kLog2e, vec);
  return (int)cudaGetLastError();
}

const char* ft_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
