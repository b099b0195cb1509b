// Flash attention backward, dk and dv (kernel #8, second of two): rows =
// keys, tiles of 16 queries streamed through shared memory with their dO,
// lse and Dres; p = exp(s - lse), dv = sum_q p dO, dS = p (dP - Dres),
// dk = scale * sum_q dS q.  Design and bound: flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace shifu::flash;

template <typename T, int G, int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dres, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int D, float scale,
                     int tiles) {
  constexpr int R = kThreads / G;
  constexpr int DP = G * DPT;
  __shared__ __align__(16) float qs[kTile][DP];
  __shared__ __align__(16) float gs[kTile][DP];
  __shared__ float ls[kTile];
  __shared__ float rs[kTile];
  const long long bh = blockIdx.x / tiles;
  const int t = threadIdx.x % G;
  const int row = (blockIdx.x % tiles) * R + threadIdx.x / G;
  const bool live = row < S;
  const long long base = bh * S * D;
  const T* qb = q + base;
  const T* gb = g + base;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  load_row<T, G, DPT>(k + base + (long long)row * D, D, t, live, kr);
  load_row<T, G, DPT>(v + base + (long long)row * D, D, t, live, vr);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    stage<T, DP>(qs, qb, q0, S, D);
    stage<T, DP>(gs, gb, q0, S, D);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < S ? lse[bh * S + r] : 0.f;
      rs[threadIdx.x] = r < S ? dres[bh * S + r] : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, S - q0);  // uniform across the CTA
    for (int i2 = 0; i2 < n; ++i2) {
      float qr[DPT], gr[DPT];
      smem_row<G, DPT>(qs[i2], t, qr);
      smem_row<G, DPT>(gs[i2], t, gr);
      const float sj = group_sum<G>(dot<DPT>(qr, kr)) * scale;
      const float p = expf(sj - ls[i2]);
      const float dp = group_sum<G>(dot<DPT>(gr, vr));
      const float ds = p * (dp - rs[i2]);
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dva[i] = fmaf(p, gr[i], dva[i]);
        dka[i] = fmaf(ds, qr[i], dka[i]);
      }
    }
  }
  if (!live) return;
  T* dko = dk + base + (long long)row * D;
  T* dvo = dv + base + (long long)row * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * G + t;
    if (d < D) {
      dko[d] = shifu::from_f32<T>(dka[i] * scale);
      dvo[d] = shifu::from_f32<T>(dva[i]);
    }
  }
}

template <typename T, int G, int DPT>
struct Dkv {
  static void run(unsigned blocks, cudaStream_t st, int tiles, const void* q,
                  const void* k, const void* v, const void* g,
                  const float* lse, const float* dres, void* dk, void* dv,
                  int S, int D, float scale) {
    flash_dkv_kernel<T, G, DPT><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, dres,
        static_cast<T*>(dk), static_cast<T*>(dv), S, D, scale, tiles);
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise; returns the CUDA error
// code of the launch (0 = cudaSuccess).  q, k, v, g (= dO), dk, dv
// contiguous (B, H, S, D) in one dtype; lse and dres contiguous (B, H, S)
// f32.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* dres, void* dk, void* dv,
                  int B, int H, int S, int D, float scale, int dtype,
                  void* stream) {
  return shifu::flash::dispatch<Dkv>(dtype, B, H, S, D, stream, q, k, v, g,
                                     lse, dres, dk, dv, S, D, scale);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
