// Flash attention backward, dq (kernel #8, first of two): rows = queries,
// K/V tiles of 16 keys streamed through shared memory; p = exp(s - lse),
// dS = p (dP - Dres), dq = scale * sum_k dS k.  Design and bound:
// flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace shifu::flash;

template <typename T, int G, int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dres, T* __restrict__ dq, int S,
                    int D, float scale, int tiles) {
  constexpr int R = kThreads / G;
  constexpr int DP = G * DPT;
  __shared__ __align__(16) float ks[kTile][DP];
  __shared__ __align__(16) float vs[kTile][DP];
  const long long bh = blockIdx.x / tiles;
  const int t = threadIdx.x % G;
  const int row = (blockIdx.x % tiles) * R + threadIdx.x / G;
  const bool live = row < S;
  const long long base = bh * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  float qr[DPT], gr[DPT], acc[DPT];
  load_row<T, G, DPT>(q + base + (long long)row * D, D, t, live, qr);
  load_row<T, G, DPT>(g + base + (long long)row * D, D, t, live, gr);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  const float lr = live ? lse[bh * S + row] : 0.f;
  const float dr = live ? dres[bh * S + row] : 0.f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    stage<T, DP>(ks, kb, k0, S, D);
    stage<T, DP>(vs, vb, k0, S, D);
    __syncthreads();
    const int jn = min(kTile, S - k0);  // uniform across the CTA
    for (int j = 0; j < jn; ++j) {
      float kr[DPT], vr[DPT];
      smem_row<G, DPT>(ks[j], t, kr);
      smem_row<G, DPT>(vs[j], t, vr);
      const float sj = group_sum<G>(dot<DPT>(qr, kr)) * scale;
      const float dp = group_sum<G>(dot<DPT>(gr, vr));
      const float ds = expf(sj - lr) * (dp - dr);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  if (!live) return;
  T* out = dq + base + (long long)row * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * G + t;
    if (d < D) out[d] = shifu::from_f32<T>(acc[i] * scale);
  }
}

template <typename T, int G, int DPT>
struct Dq {
  static void run(unsigned blocks, cudaStream_t st, int tiles, const void* q,
                  const void* k, const void* v, const void* g,
                  const float* lse, const float* dres, void* dq, int S, int D,
                  float scale) {
    flash_dq_kernel<T, G, DPT><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, dres,
        static_cast<T*>(dq), S, D, scale, tiles);
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise; returns the CUDA error
// code of the launch (0 = cudaSuccess).  q, k, v, g (= dO), dq contiguous
// (B, H, S, D) in one dtype; lse and dres contiguous (B, H, S) f32.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* dres, void* dq, int B, int H,
                 int S, int D, float scale, int dtype, void* stream) {
  return shifu::flash::dispatch<Dq>(dtype, B, H, S, D, stream, q, k, v, g,
                                    lse, dres, dq, S, D, scale);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
