// Flash attention backward, dq (kernel #8, first of two): rows = queries,
// K/V tiles streamed through a shared ring; per tile
// S = Q K^T and dP = dO V^T on the tensor cores, p = ex2(s c - lse log2 e),
// dS = p (dP - Dres), dq += dS K with dS as hi + lo parts; dq = scale * dq.
// Design and bound: flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace shifu::flash;

// at D <= 16, 5 CTAs an SM (at most 102 registers a thread): faster on the
// H100 than the 4 that the 109 registers ptxas takes unbounded allow
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 16 ? 5 : 1)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dres, T* __restrict__ dq, int S,
                    int D, float scale, int tiles, bool vec) {
  using M = Mma<T>;
  using E = typename M::E;
  using Tl = Tile<DP, kDq>;
  constexpr int BN = Tl::kN, LD = Tl::kLd, NT = BN / 8, MT = Tl::kMt;
  constexpr int kPanel = BN * LD;
  constexpr int kParts = M::kSplit ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sm = reinterpret_cast<E*>(smem);
  auto panel = [&](int buf, int op) {  // [buffer][k, v][part]
    E* p = sm + (buf * 2 + op) * kParts * kPanel;
    return Panel<E>{p, p + (kParts - 1) * kPanel};
  };

  const long long bh = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * Tl::kRows + (threadIdx.x / 32) * 16 * MT;
  const long long base = bh * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const float c = fmaxf(fabsf(scale) * kLog2e, 1e-30f);  // as in the forward
  uint32_t qh[MT][DP / 4], ql[MT][DP / 4], gh[MT][DP / 4], gl[MT][DP / 4];
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  float lc[MT][2], dr[MT][2];  // per row: lse log2(e) and Dres
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a<T, DP>(q + base, r0 + 16 * mt, S, D, scale < 0.f ? -1.f : 1.f,
                  qh[mt], ql[mt]);
    load_a<T, DP>(g + base, r0 + 16 * mt, S, D, 1.f, gh[mt], gl[mt]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * mt + lane / 4 + 8 * h;
      lc[mt][h] = r < S ? lse[bh * S + r] * kLog2e : 0.f;
      dr[mt][h] = r < S ? dres[bh * S + r] : 0.f;
    }
  }

  float acc[MT][DP / 8][4], lacc[MT][DP / 8][4];
  zero(acc);
  zero(lacc);
  const int n_tiles = (S + BN - 1) / BN;

  stage2<T, DP, BN, LD>(panel(0, 0), panel(0, 1), kb, vb, 0, S, D, vec);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % Tl::kBufs, k0 = it * BN;
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) % Tl::kBufs;
      stage2<T, DP, BN, LD>(panel(nb, 0), panel(nb, 1), kb, vb, k0 + BN, S,
                            D, vec);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // also: every warp is done with the buffer refilled next

    float s[MT][NT][4], dp[MT][NT][4];
    score_mma<E, DP, LD, NT, MT, M::kSplit>(s, qh, ql, panel(buf, 0));
    score_mma<E, DP, LD, NT, MT, M::kSplit>(dp, gh, gl, panel(buf, 1));
    if (k0 + BN > S) {  // the last tile: keys past S
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t4 + (e & 1) >= S) s[mt][j][e] = -INFINITY;
    }
    // dS = p (dP - Dres), 16 keys at a time, block kc + 1 before the
    // products of block kc (the special-function unit and the other pipes
    // overlap)
    auto ds = [&](int kc) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 2 * kc; j < 2 * kc + 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][j][e], c, -lc[mt][e >> 1]));
            s[mt][j][e] = p * (dp[mt][j][e] - dr[mt][e >> 1]);
          }
    };
    ds(0);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      if (kc + 1 < BN / 16) ds(kc + 1);
      uint32_t dh[MT][4], dl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a_from_acc<E, NT>(s[mt], kc, dh[mt], dl[mt],
                          M::kLoAcc ? kLoScale : 1.f);
      out_mma<E, DP, LD, MT, M::kSplit>(acc, M::kLoAcc ? lacc : acc, dh, dl,
                                        panel(buf, 0), kc);
    }
  }

  if constexpr (M::kLoAcc) fold<MT, DP / 8>(acc, lacc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<T, DP>(dq + base, acc[mt], r0 + 16 * mt, S, D, scale, scale);
}

template <typename T, int DP>
struct Dq {
  static constexpr int kRows = Tile<DP, kDq>::kRows;
  static int run(unsigned blocks, cudaStream_t st, int tiles, const void* q,
                 const void* k, const void* v, const void* g, const float* lse,
                 const float* dres, void* dq, int S, int D, float scale,
                 bool vec) {
    using Tl = Tile<DP, kDq>;
    constexpr int kParts = Mma<T>::kSplit ? 2 : 1;
    const int bytes = Tl::kBufs * 2 * kParts * Tl::kN * Tl::kLd * 2;
    auto* kernel = flash_dq_kernel<T, DP>;
    if (const int err = allow_smem(kernel, bytes)) return err;
    kernel<<<blocks, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, dres,
        static_cast<T*>(dq), S, D, scale, tiles, vec);
    return 0;
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
  const bool vec = D % 8 == 0 && aligned16(k) && aligned16(v);
  return shifu::flash::dispatch<Dq>(dtype, B, H, S, D, stream, q, k, v, g,
                                    lse, dres, dq, S, D, scale, vec);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
