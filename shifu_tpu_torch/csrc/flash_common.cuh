// Shared pieces of the flash attention kernels, one source each
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Replace the TPU kernels shifu_tpu/ops/pallas_attention.py
// _flash_fwd_impl (_fwd_kernel) and _flash_bwd_impl (_dq_kernel,
// _dkv_kernel).  Same math: q, k, v, dO widened to f32; scores
// s = (q . k) * scale; the forward keeps a running max m, normaliser l and
// unnormalised o in f32 and writes o / l (rounded once to q's dtype) and
// lse = m + log(l) (f32); the backward takes p = exp(s - lse) and
// dS = p (dP - Dres) with Dres = rowsum(dO * o), computed by the caller
// (a torch op, as it is an XLA op beside the TPU kernels); dq = scale *
// dS k, dk = scale * dS^T q, dv = p^T dO, each rounded once.
//
// Bound on the H100: operations.  At the flash path's shape (B=1024, H=8,
// S=1001, D=8, bf16) one forward does 4 S^2 D FLOP per (sample, head),
// 263 GFLOP in all, plus S^2 exponentials, over 33 MB of q, k, v and o.
// These first kernels run on the CUDA cores in f32 (67 TFLOP/s), not on
// the tensor cores: at D = 8 a tensor-core tile would be half padding, and
// a first kernel is right and simple first.
//
// Design.  The TPU grid walked its K/V blocks in order and carried
// (m, l, o) in VMEM scratch from one grid step to the next; its wrapper
// padded S to a common multiple of 512-row blocks.  Here a CTA of 128
// threads owns one (sample, head) and one tile of rows, and a loop inside
// the CTA streams the other operand through shared memory (f32, zero past
// S), so nothing is carried between CTAs, the ragged edge of S is masked in
// the kernel, and nothing is padded in device memory.  G = 1, 2, 4 or 8
// threads share a row, each holding DPT = 8 or 16 of its D dims in
// registers (dim d = i * G + t for thread t of the group), and a row's dot
// products are summed across the group by xor shuffles, which give every
// thread of the group the same sum.  Every kernel is deterministic: no
// atomics.
#pragma once

#include <math.h>

#include "common.cuh"

namespace shifu {
namespace flash {

constexpr int kThreads = 128;
// rows of the streamed operand per tile.  The forward keeps a tile's scores
// in registers and unrolls over them: at 32 rows nvcc took 25.6 s for its
// 15 instantiations, at 16 rows 12.3 s (CUDA 12.8, the H100 machine), for a
// rescale and two barriers every 16 keys instead of every 32
constexpr int kTile = 16;
constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// this thread's DPT dims of a row of D values in device memory (0 past D)
template <typename T, int G, int DPT>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int D,
                                         int t, bool live, float (&r)[DPT]) {
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * G + t;
    r[i] = (live && d < D) ? to_f32(row[d]) : 0.f;
  }
}

// this thread's DPT dims of a shared-memory row of G * DPT floats
template <int G, int DPT>
__device__ __forceinline__ void smem_row(const float* __restrict__ row, int t,
                                         float (&r)[DPT]) {
  if constexpr (G == 1) {
#pragma unroll
    for (int i = 0; i < DPT; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(row + i);
      r[i] = f.x;
      r[i + 1] = f.y;
      r[i + 2] = f.z;
      r[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) r[i] = row[i * G + t];
  }
}

template <int DPT>
__device__ __forceinline__ float dot(const float (&a)[DPT],
                                     const float (&b)[DPT]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// stage rows [r0, r0 + kTile) of a (S, D) matrix as f32, zero past S and D
template <typename T, int DP>
__device__ __forceinline__ void stage(float (*dst)[DP],
                                      const T* __restrict__ src, int r0,
                                      int S, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int j = idx / DP, d = idx % DP;
    const int r = r0 + j;
    dst[j][d] = (r < S && d < D) ? to_f32(src[(long long)r * D + d]) : 0.f;
  }
}

// Launch K<T, G, DPT>::run(blocks, stream, tiles, args...) for the head
// dim: D <= 8 and <= 16 one thread per row, then 2, 4 and 8 threads of 16
// dims each; blocks = (B * H) * tiles, a tile being 128 / G rows.  Returns
// the CUDA error code of the launch (0 = cudaSuccess).
template <typename T, template <typename, int, int> class K, int G, int DPT,
          typename... A>
int launch_one(long long bh, int S, cudaStream_t st, A... args) {
  constexpr int R = kThreads / G;
  const int tiles = (S + R - 1) / R;
  K<T, G, DPT>::run((unsigned)(bh * tiles), st, tiles, args...);
  return (int)cudaGetLastError();
}

template <typename T, template <typename, int, int> class K, typename... A>
int launch_d(int D, long long bh, int S, cudaStream_t st, A... args) {
  if (D <= 8) return launch_one<T, K, 1, 8>(bh, S, st, args...);
  if (D <= 16) return launch_one<T, K, 1, 16>(bh, S, st, args...);
  if (D <= 32) return launch_one<T, K, 2, 16>(bh, S, st, args...);
  if (D <= 64) return launch_one<T, K, 4, 16>(bh, S, st, args...);
  return launch_one<T, K, 8, 16>(bh, S, st, args...);
}

// The entry point of each source: checks the shape, then launches K for the
// dtype code; `args` go to K::run after (blocks, stream, row tiles).
template <template <typename, int, int> class K, typename... A>
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
