// Small-token attention, o = softmax(q k^T * scale) v, for S <= 64 tokens
// and head dim D <= 16, on (B, H, S, D) tensors: the forward, and below it
// the backward (small_attention_bwd_kernel).
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

// Backward: dq, dk, dv of o = softmax(q k^T * scale) v, given g = dL/do.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_small_attention.py
// (_run_bwd / _bwd_kernel).  Same math: the softmax is recomputed per
// query in f32, then dv += w g, dP = g v^T, dS = w (dP - sum_k w dP),
// dq = scale * dS k, dk += scale * dS^T q; every sum in f32, each gradient
// rounded once to q's dtype.
//
// Bound on the H100: bytes and operations about equal.  At the training
// shape (B=8192, H=8, S=31, D=8, bf16) q, k, v, g in and dq, dk, dv out are
// about 228 MB (68 us at 3.35 TB/s); the ~10 S^2 D FLOP per group, 5.0 GFLOP
// in all, take about 75 us at the 67 TFLOP/s f32 rate of the CUDA cores.
// The TPU kernel put the batch on the 128 lanes and carried dk/dv across a
// fori_loop in VMEM.  Here one warp owns one (sample, head) group and nothing
// is carried between blocks, so the kernel is deterministic and needs no
// atomics: q, k, v and g are staged in shared memory as f32; a first pass
// with lane = query row computes dq and keeps each query's softmax max,
// 1/sum and sum_k w dP in shared memory; a second pass with lane = key row
// accumulates dk and dv in registers from those statistics.  In both passes
// the rows the lanes do not own are read as warp-wide broadcasts.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    small_attention_bwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ g, T* __restrict__ dq,
                               T* __restrict__ dk, T* __restrict__ dv,
                               long long groups, int S, int D, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long grp = (long long)blockIdx.x * kWarps + warp;
  if (grp >= groups) return;  // whole warp leaves; no block-wide barrier used
  const int sd = S * D;
  float* qs = smem + (size_t)warp * (4 * sd + 3 * S);
  float* ks = qs + sd;
  float* vs = ks + sd;
  float* gs = vs + sd;
  float* mrow = gs + sd;   // per query: softmax max
  float* ilrow = mrow + S; // per query: 1 / softmax sum
  float* dprow = ilrow + S; // per query: sum_k w dP
  const long long base = grp * sd;
  for (int i = lane; i < sd; i += 32) {
    qs[i] = shifu::to_f32(q[base + i]);
    ks[i] = shifu::to_f32(k[base + i]);
    vs[i] = shifu::to_f32(v[base + i]);
    gs[i] = shifu::to_f32(g[base + i]);
  }
  __syncwarp();

  // pass 1: lane = query row
  for (int qi = lane; qi < S; qi += 32) {
    float qr[kMaxD], gr[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      qr[d] = d < D ? qs[qi * D + d] : 0.f;
      gr[d] = d < D ? gs[qi * D + d] : 0.f;
    }
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) s = fmaf(qr[d], ks[j * D + d], s);
      m = fmaxf(m, s * scale);
    }
    float l = 0.f, pdp = 0.f;
    for (int j = 0; j < S; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) {
          s = fmaf(qr[d], ks[j * D + d], s);
          dp = fmaf(gr[d], vs[j * D + d], dp);
        }
      const float p = expf(s * scale - m);
      l += p;
      pdp = fmaf(p, dp, pdp);
    }
    const float il = 1.f / l;
    const float row = pdp * il;
    float acc[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) acc[d] = 0.f;
    for (int j = 0; j < S; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) {
          s = fmaf(qr[d], ks[j * D + d], s);
          dp = fmaf(gr[d], vs[j * D + d], dp);
        }
      const float w = expf(s * scale - m) * il;
      const float ds = w * (dp - row);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
    }
    T* out = dq + base + (long long)qi * D;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) out[d] = shifu::from_f32<T>(acc[d] * scale);
    mrow[qi] = m;
    ilrow[qi] = il;
    dprow[qi] = row;
  }
  __syncwarp();

  // pass 2: lane = key row
  for (int kj = lane; kj < S; kj += 32) {
    float kr[kMaxD], vr[kMaxD], dka[kMaxD], dva[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      kr[d] = d < D ? ks[kj * D + d] : 0.f;
      vr[d] = d < D ? vs[kj * D + d] : 0.f;
      dka[d] = 0.f;
      dva[d] = 0.f;
    }
    for (int i = 0; i < S; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) {
          s = fmaf(qs[i * D + d], kr[d], s);
          dp = fmaf(gs[i * D + d], vr[d], dp);
        }
      const float w = expf(s * scale - mrow[i]) * ilrow[i];
      const float ds = w * (dp - dprow[i]);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) {
          dva[d] = fmaf(w, gs[i * D + d], dva[d]);
          dka[d] = fmaf(ds, qs[i * D + d], dka[d]);
        }
    }
    T* dko = dk + base + (long long)kj * D;
    T* dvo = dv + base + (long long)kj * D;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) {
        dko[d] = shifu::from_f32<T>(dka[d] * scale);
        dvo[d] = shifu::from_f32<T>(dva[d]);
      }
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               void* dq, void* dk, void* dv, long long groups, int S, int D,
               float scale, cudaStream_t st) {
  const unsigned blocks = (unsigned)((groups + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * (4 * S * D + 3 * S) * sizeof(float);
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory (S*D > ~700)
    const cudaError_t e = cudaFuncSetAttribute(
        small_attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  small_attention_bwd_kernel<T><<<blocks, kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), groups,
      S, D, scale);
  return (int)cudaSuccess;
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
  int rc;
  switch (dtype) {
    case shifu::kFloat32:
      rc = launch_bwd<float>(q, k, v, g, dq, dk, dv, groups, S, D, scale, st);
      break;
    case shifu::kBFloat16:
      rc = launch_bwd<__nv_bfloat16>(q, k, v, g, dq, dk, dv, groups, S, D,
                                     scale, st);
      break;
    case shifu::kFloat16:
      rc = launch_bwd<__half>(q, k, v, g, dq, dk, dv, groups, S, D, scale,
                              st);
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
