// Flash attention forward (kernel #7): o and lse, rows = queries, K/V
// tiles of 16 keys streamed through shared memory; per tile the 16 scores
// stay in registers, then one rescale of the running (l, o).  Design and
// bound: flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace shifu::flash;

template <typename T, int G, int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale,
                     int tiles) {
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
  float qr[DPT], acc[DPT];
  load_row<T, G, DPT>(q + base + (long long)row * D, D, t, live, qr);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<T, DP>(ks, kb, k0, S, D);
    stage<T, DP>(vs, vb, k0, S, D);
    __syncthreads();
    float s[kTile];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float kr[DPT];
      smem_row<G, DPT>(ks[j], t, kr);
      const float sj = group_sum<G>(dot<DPT>(qr, kr)) * scale;
      s[j] = (k0 + j < S) ? sj : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float mnew = fmaxf(m, tmax);  // finite: a tile holds a live key
    const float corr = expf(m - mnew);  // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(s[j] - mnew);
      l += p;
      float vr[DPT];
      smem_row<G, DPT>(vs[j], t, vr);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
    m = mnew;
  }
  if (!live) return;
  const float il = 1.f / l;
  T* orow = o + base + (long long)row * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = i * G + t;
    if (d < D) orow[d] = shifu::from_f32<T>(acc[i] * il);
  }
  if (t == 0) lse[bh * S + row] = m + logf(l);
}

template <typename T, int G, int DPT>
struct Fwd {
  static void run(unsigned blocks, cudaStream_t st, int tiles, const void* q,
                  const void* k, const void* v, void* o, float* lse, int S,
                  int D, float scale) {
    flash_fwd_kernel<T, G, DPT><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, D, scale,
        tiles);
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise; returns the CUDA error
// code of the launch (0 = cudaSuccess).  q, k, v, o contiguous (B, H, S, D)
// in one dtype; lse contiguous (B, H, S) f32.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int S, int D, float scale, int dtype,
              void* stream) {
  return shifu::flash::dispatch<Fwd>(dtype, B, H, S, D, stream, q, k, v, o,
                                     lse, S, D, scale);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
