// Small-token attention, o = softmax(q k^T * scale) v, for S <= 64 tokens
// and head dim D <= 16, on (B, H, S, D) tensors.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_small_attention.py
// (_run_fwd / _fwd_kernel).  Same semantics: q, k, v are read in their
// dtype and widened to f32; scores, softmax and the weighted sum are f32;
// the output is rounded once to q's dtype.  No S x S tensor is written to
// device memory.
//
// Bound on the H100: bytes.  At the serving shape (B=4096, H=8, S=31, D=8,
// bf16) q, k, v in and o out are 65 MB, about 19 us at 3.35 TB/s, while the
// 1.0 GFLOP of products take about 15 us at the 67 TFLOP/s f32 rate of the
// CUDA cores.  The TPU kernel put the batch on the 128 lanes to dodge lane
// padding of the (S, S) scores; that is a TPU answer and is not copied.
// Here one warp owns one (sample, head) group: K and V (<= 64 x 16 f32, 4 KB
// each) are staged in shared memory, every lane owns one query row (two for
// S > 32) and keeps its q row and its output accumulator in registers.  Two
// passes over the keys (max, then exp-sum and weighted sum) keep the f32
// softmax exact without an S-long register array.  Reads of K and V are
// warp-wide broadcasts, so there are no bank conflicts.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxS = 64;
constexpr int kMaxD = 16;
constexpr int kWarps = 4;  // (sample, head) groups per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    small_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           long long groups, int S, int D, float scale) {
  __shared__ float ks[kWarps][kMaxS * kMaxD];
  __shared__ float vs[kWarps][kMaxS * kMaxD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  if (g >= groups) return;  // whole warp leaves; no block-wide barrier used
  const long long base = g * S * D;
  float* kw = ks[warp];
  float* vw = vs[warp];
  for (int i = lane; i < S * D; i += 32) {
    kw[i] = shifu::to_f32(k[base + i]);
    vw[i] = shifu::to_f32(v[base + i]);
  }
  __syncwarp();

  for (int qi = lane; qi < S; qi += 32) {
    const T* qrow = q + base + (long long)qi * D;
    float qr[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) qr[d] = d < D ? shifu::to_f32(qrow[d]) : 0.f;

    float m = -INFINITY;
    for (int j = 0; j < S; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) s = fmaf(qr[d], kw[j * D + d], s);
      m = fmaxf(m, s * scale);
    }
    float l = 0.f;
    float acc[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) acc[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) s = fmaf(qr[d], kw[j * D + d], s);
      const float p = expf(s * scale - m);
      l += p;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) acc[d] = fmaf(p, vw[j * D + d], acc[d]);
    }
    const float inv_l = 1.f / l;
    T* orow = o + base + (long long)qi * D;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) orow[d] = shifu::from_f32<T>(acc[d] * inv_l);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o,
            long long groups, int S, int D, float scale, cudaStream_t st) {
  const unsigned blocks = (unsigned)((groups + kWarps - 1) / kWarps);
  small_attention_kernel<T><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), groups, S, D, scale);
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
  switch (dtype) {
    case shifu::kFloat32:
      launch<float>(q, k, v, o, groups, S, D, scale, st);
      break;
    case shifu::kBFloat16:
      launch<__nv_bfloat16>(q, k, v, o, groups, S, D, scale, st);
      break;
    case shifu::kFloat16:
      launch<__half>(q, k, v, o, groups, S, D, scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* small_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
