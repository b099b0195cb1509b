// Shared pieces of the flash attention kernels, one source each
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Replace the TPU kernels shifu_tpu/ops/pallas_attention.py:198
// _flash_fwd_impl (_fwd_kernel) and :227 _flash_bwd_impl (_dq_kernel,
// _dkv_kernel).  Same function: scores s = (q . k) * scale; the forward
// keeps a running max m and normaliser l in f32 and writes o = (p v) / l,
// rounded once to q's dtype, and lse = m + log(l) (f32); the backward takes
// p = exp(s - lse) and dS = p (dP - Dres) with Dres = rowsum(dO * o),
// computed by the caller (a torch op, as it is an XLA op beside the TPU
// kernels); dq = scale * dS k, dk = scale * dS^T q, dv = p^T dO, each
// summed in f32 and rounded once.  Deterministic: no atomics.
//
// Bound on the H100.  At the flash path's shape (B=1024, H=8, S=1001, D=8,
// bf16) a forward is B H S^2 = 8.21e9 (query, key) pairs: 4 D = 32 matrix
// FLOP each (263 GFLOP, 0.27 ms at 989 TFLOP/s), one exponential each
// (8.21e9 over the SFU's 16 ex2 a clock per SM, 132 SMs: ~2.0 ms), over
// 4 x 65.6 M bf16 values = 525 MB (0.16 ms at 3.35 TB/s).  Each backward
// kernel recomputes p, so it too needs B H S^2 exponentials.  At D <= 16
// the exponentials bound these kernels; above, the products.
//
// Design.  A CTA of 4 warps owns one (sample, head) and kRows rows
// (queries for the forward and dq, keys for dk/dv): at D <= 16 two 16-row
// m-tiles a warp (128 rows a CTA), which share every B operand loaded from
// shared memory and give each warp two independent chains of work; above,
// one (64 rows).  A loop inside the CTA streams the other operand in tiles
// of kN rows through a ring of 3 shared buffers (one barrier a tile), kept
// in the 16-bit input dtype (cp.async, 16 bytes a copy, each thread's
// copies fixed by its index, when D is a multiple of 8) and zero past S and
// past D.  Every product runs on the tensor cores (mma.sync m16n8k8 for a
// contraction over D = 8, m16n8k16 otherwise, operands through ldmatrix):
// the scores Q K^T (and dO V^T), then P V, dS K, P^T dO and dS^T Q with P
// and dS taken from the f32 accumulators in registers.  The softmax keeps
// to the special-function unit: scale * log2(e) is folded into one FFMA a
// score, ex2.approx a score, the row max a tree over the thread's scores
// and two quad shuffles a tile, the row sum thread-local until the end.
// The ragged edge of S is masked in the last tile; nothing is padded in
// device memory.
//
// What limits them.  At D = 8 a pair costs one ex2 on the SFU (8 cycles a
// warp instruction per SM sub-partition) and about seven other
// instructions a lane: the FFMA, the max, the sum and the hi/lo split of P
// (three more for dS in the backward, six for P and dS in dk/dv), so issue
// and the SFU are nearly even, and on the H100 the kernels run at about
// twice the exponential bound, dk/dv above it (PERF.md).  Tried on the
// card and slower: more accumulators an output, tf32 products (fewer split
// instructions, twice the mma), the next tile's scores computed beside this
// tile's exponentials, more CTAs an SM by capping registers (but for dq).
//
// Accuracy.  Q K^T and dO V^T take the inputs as they are (exact products,
// f32 sums).  P and dS are f32 and go in as two 16-bit parts, hi = x
// rounded and lo = x - hi rounded, two mma into one f32 accumulator: one
// rounding of P or dS to bf16 would miss the tolerances where an output
// element cancels towards 0.  In f16, dS's lo part is scaled by 2^11 into
// an accumulator of its own (unscaled at the end), so that it cannot
// underflow.  f32 inputs are held as bf16 hi + lo parts and every product
// takes three mma (hi hi, lo hi, hi lo).
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace shifu {
namespace flash {

// the shared building blocks (common.cuh, mma.cuh), for the flash
// sources' `using namespace shifu::flash`
using shifu::Mma;
using shifu::Panel;
using shifu::a_from_acc;
using shifu::aligned16;
using shifu::cp16;
using shifu::cp_commit;
using shifu::cp_wait_prev;
using shifu::ex2;
using shifu::fold;
using shifu::kLoScale;
using shifu::kLoUnscale;
using shifu::kLog2e;
using shifu::ldsm2t;
using shifu::ldsm4;
using shifu::ldsm4t;
using shifu::mma16;
using shifu::mma8;
using shifu::out_mma;
using shifu::pack;
using shifu::quad_max;
using shifu::quad_sum;
using shifu::score_mma;
using shifu::smem_addr;
using shifu::split;
using shifu::tile_max;
using shifu::unpack;
using shifu::zero;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// The tiling of kernel kind K at the padded head dim DP: kMt 16-row
// m-tiles a warp (they share each B operand loaded from shared memory),
// so a CTA owns kRows rows; kN streamed rows a tile; the shared row stride
// kLd (elements; 16 bytes of padding above D = 8 keep ldmatrix's 8 row
// addresses on distinct banks); a ring of 3 buffers, so that one barrier a
// tile keeps a buffer from being refilled while it is read.
template <int DP, int K>
struct Tile {
  static constexpr int kMt = DP <= 16 ? 2 : 1;
  static constexpr int kRows = 16 * kWarps * kMt;
  static constexpr int kN =
      DP == 8 && K != kDq ? 64 : DP <= 16 ? 32 : DP <= 64 ? 64 : 32;
  static constexpr int kLd = DP == 8 ? 8 : DP + 8;
  static constexpr int kBufs = 3;
};

// -- operands ----------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float elem(const T* __restrict__ x, int r, int d,
                                      int S, int D) {
  return (r < S && d < D) ? to_f32(x[(long long)r * D + d]) : 0.f;
}

// Stage rows [r0, r0 + N) of two (S, D) matrices x0 and x1 into panels
// p0 and p1 of stride LD, zero past S and D.  vec: 16-bit T, D % 8 == 0 and
// 16-byte aligned rows: one cp.async a 16-byte chunk, each thread's chunks
// fixed by its index (no loop bounds or divisions at run time); else
// element loads (and, for f32, the hi/lo split).
template <typename T, int DP, int N, int LD>
__device__ __forceinline__ void stage2(Panel<typename Mma<T>::E> p0,
                                       Panel<typename Mma<T>::E> p1,
                                       const T* __restrict__ x0,
                                       const T* __restrict__ x1, int r0,
                                       int S, int D, bool vec) {
  using E = typename Mma<T>::E;
  if constexpr (!Mma<T>::kSplit) {
    if (vec) {
      constexpr int kC = DP / 8, kPer = N * kC;  // 16-byte chunks an operand
#pragma unroll
      for (int it = 0; it < (2 * kPer + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + threadIdx.x;
        if ((2 * kPer) % kThreads != 0 && i >= 2 * kPer) break;
        const int op = i / kPer, j = (i % kPer) / kC, c = i % kC;
        const int r = r0 + j;
        E* dst = (op ? p1.hi : p0.hi) + j * LD + c * 8;
        if (c * 8 < D)
          cp16(dst, (op ? x1 : x0) + (long long)(r < S ? r : 0) * D + c * 8,
               r < S);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      return;
    }
  }
#pragma unroll 1
  for (int op = 0; op < 2; ++op) {
    const Panel<E> p = op ? p1 : p0;
    const T* x = op ? x1 : x0;
    for (int i = threadIdx.x; i < N * DP; i += kThreads) {
      const int j = i / DP, d = i % DP;
      const float v = elem(x, r0 + j, d, S, D);
      const E h = from_f32<E>(v);
      p.hi[j * LD + d] = h;
      if constexpr (Mma<T>::kSplit)
        p.lo[j * LD + d] = from_f32<E>(v - to_f32(h));
    }
  }
}

// The A fragments (16 x DP) of rows [r0, r0 + 16) of a (S, D) matrix, times
// sgn (exact): register i holds the pair (row g + 8 (i & 1), column
// 16 (i / 4) + 8 ((i >> 1) & 1) + 2 t) and its neighbour, as mma's A
// operand wants; lo only for f32 inputs.
template <typename T, int DP>
__device__ __forceinline__ void load_a(const T* __restrict__ x, int r0, int S,
                                       int D, float sgn, uint32_t (&hi)[DP / 4],
                                       uint32_t (&lo)[DP / 4]) {
  using E = typename Mma<T>::E;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int r = r0 + g + 8 * (i & 1);
    const int d = 16 * (i / 4) + 8 * ((i >> 1) & 1) + 2 * t;
    const float a = sgn * elem(x, r, d, S, D), b = sgn * elem(x, r, d + 1, S, D);
    if constexpr (Mma<T>::kSplit)
      split<E>(a, b, hi[i], lo[i]);
    else
      hi[i] = pack<E>(a, b);
  }
}

// Store a (16 x DP) f32 accumulator's rows [r0, r0 + 16), times mul per row
// half (rows g and g + 8), rounded once to T; rows past S and columns past
// D are not written.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* __restrict__ y,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int S, int D, float mul0,
                                           float mul1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), d = 8 * n + 2 * t + (e & 1);
      if (r < S && d < D)
        y[(long long)r * D + d] = from_f32<T>(acc[n][e] * ((e >> 1) ? mul1 : mul0));
    }
}

// -- launch ------------------------------------------------------------------


// Launch K<T, DP>::run(blocks, stream, tiles, args...) for the head dim
// padded to DP = 8, 16, 32, 64 or 128; blocks = (B * H) * tiles, a tile
// being the K<T, DP>::kRows rows a CTA owns.  Returns the CUDA error code
// of the launch.
template <typename T, template <typename, int> class K, int DP, typename... A>
int launch_one(long long bh, int S, cudaStream_t st, A... args) {
  constexpr int kRows = K<T, DP>::kRows;
  const int tiles = (S + kRows - 1) / kRows;
  const int err = K<T, DP>::run((unsigned)(bh * tiles), st, tiles, args...);
  return err ? err : (int)cudaGetLastError();
}

template <typename T, template <typename, int> class K, typename... A>
int launch_d(int D, long long bh, int S, cudaStream_t st, A... args) {
  if (D <= 8) return launch_one<T, K, 8>(bh, S, st, args...);
  if (D <= 16) return launch_one<T, K, 16>(bh, S, st, args...);
  if (D <= 32) return launch_one<T, K, 32>(bh, S, st, args...);
  if (D <= 64) return launch_one<T, K, 64>(bh, S, st, args...);
  return launch_one<T, K, 128>(bh, S, st, args...);
}

// Allow `bytes` of dynamic shared memory for `kernel` (above the 48 KB a
// launch may take without asking); returns the CUDA error code
template <typename F>
int allow_smem(F* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The entry point of each source: checks the shape, then launches K for the
// dtype code; `args` go to K::run after (blocks, stream, row tiles).
template <template <typename, int> class K, typename... A>
int dispatch(int dtype, int B, int H, int S, int D, void* stream,
             A... args) {
  if (B < 0 || H < 1 || S < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const long long bh = (long long)B * H;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_d<float, K>(D, bh, S, st, args...);
    case kBFloat16:
      return launch_d<__nv_bfloat16, K>(D, bh, S, st, args...);
    case kFloat16:
      return launch_d<__half, K>(D, bh, S, st, args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace shifu
