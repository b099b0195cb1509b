// Flash attention backward, dk and dv (kernel #8, second of two): rows =
// keys, tiles of queries streamed through a shared ring with their dO,
// lse and Dres; per tile the transposed scores S^T = K Q^T
// and dP^T = V dO^T on the tensor cores, so that p^T and dS^T come out in
// the accumulator layout that feeds dv += P^T dO and dk += dS^T Q as A
// operands (hi + lo parts); lse and Dres broadcast by column.
// dk = scale * dk.  Design and bound: flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace shifu::flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dres, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int D, float scale, int tiles,
                     bool vec) {
  using M = Mma<T>;
  using E = typename M::E;
  using Tl = Tile<DP, kDkv>;
  constexpr int BN = Tl::kN, LD = Tl::kLd, NT = BN / 8, MT = Tl::kMt;
  static_assert(BN <= kThreads, "one thread stages a query's lse and Dres");
  constexpr int kPanel = BN * LD;
  constexpr int kParts = M::kSplit ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sm = reinterpret_cast<E*>(smem);
  auto panel = [&](int buf, int op) {  // [buffer][q, dO][part]
    E* p = sm + (buf * 2 + op) * kParts * kPanel;
    return Panel<E>{p, p + (kParts - 1) * kPanel};
  };
  // [buffer][lse log2(e), Dres][BN] after the panels
  float* vecs = reinterpret_cast<float*>(sm + Tl::kBufs * 2 * kParts * kPanel);

  const long long bh = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * Tl::kRows + (threadIdx.x / 32) * 16 * MT;
  const long long base = bh * S * D;
  const T* qb = q + base;
  const T* gb = g + base;
  const float* lb = lse + bh * S;
  const float* db = dres + bh * S;
  const float c = fmaxf(fabsf(scale) * kLog2e, 1e-30f);  // as in the forward
  uint32_t kh[MT][DP / 4], kl[MT][DP / 4], vh[MT][DP / 4], vl[MT][DP / 4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a<T, DP>(k + base, r0 + 16 * mt, S, D, scale < 0.f ? -1.f : 1.f,
                  kh[mt], kl[mt]);
    load_a<T, DP>(v + base, r0 + 16 * mt, S, D, 1.f, vh[mt], vl[mt]);
  }
  const int t4 = threadIdx.x % 4;

  // queries past S read lse = +inf, so p = 0 there, and dO = 0
  auto stage_all = [&](int buf, int q0) {
    stage2<T, DP, BN, LD>(panel(buf, 0), panel(buf, 1), qb, gb, q0, S, D,
                          vec);
    if (threadIdx.x < BN) {
      const int i = threadIdx.x, r = q0 + i;
      vecs[buf * 2 * BN + i] = r < S ? lb[r] * kLog2e : INFINITY;
      vecs[buf * 2 * BN + BN + i] = r < S ? db[r] : 0.f;
    }
  };

  float dka[MT][DP / 8][4], dkl[MT][DP / 8][4], dva[MT][DP / 8][4];
  zero(dka);
  zero(dkl);
  zero(dva);
  const int n_tiles = (S + BN - 1) / BN;

  stage_all(0, 0);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % Tl::kBufs;
    if (it + 1 < n_tiles) stage_all((it + 1) % Tl::kBufs, (it + 1) * BN);
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // also: every warp is done with the buffer refilled next

    float s[MT][NT][4], dp[MT][NT][4];
    score_mma<E, DP, LD, NT, MT, M::kSplit>(s, kh, kl, panel(buf, 0));
    score_mma<E, DP, LD, NT, MT, M::kSplit>(dp, vh, vl, panel(buf, 1));
    const float* ls = vecs + buf * 2 * BN;
    // p^T and dS^T = p^T (dP^T - Dres), 16 queries at a time, block kc + 1
    // before the products of block kc (the special-function unit and the
    // other pipes overlap)
    auto pds = [&](int kc) {
#pragma unroll
      for (int j = 2 * kc; j < 2 * kc + 2; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
        const float2 dr =
            *reinterpret_cast<const float2*>(ls + BN + 8 * j + 2 * t4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                ex2(fmaf(s[mt][j][e], c, -((e & 1) ? lq.y : lq.x)));
            s[mt][j][e] = p;
            dp[mt][j][e] = p * (dp[mt][j][e] - ((e & 1) ? dr.y : dr.x));
          }
      }
    };
    pds(0);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      if (kc + 1 < BN / 16) pds(kc + 1);
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a_from_acc<E, NT>(s[mt], kc, ah[mt], al[mt]);
      out_mma<E, DP, LD, MT, M::kSplit>(dva, dva, ah, al, panel(buf, 1), kc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a_from_acc<E, NT>(dp[mt], kc, ah[mt], al[mt],
                          M::kLoAcc ? kLoScale : 1.f);
      out_mma<E, DP, LD, MT, M::kSplit>(dka, M::kLoAcc ? dkl : dka, ah, al,
                                        panel(buf, 0), kc);
    }
  }

  if constexpr (M::kLoAcc) fold<MT, DP / 8>(dka, dkl);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    store_rows<T, DP>(dk + base, dka[mt], r0 + 16 * mt, S, D, scale, scale);
    store_rows<T, DP>(dv + base, dva[mt], r0 + 16 * mt, S, D, 1.f, 1.f);
  }
}

template <typename T, int DP>
struct Dkv {
  static constexpr int kRows = Tile<DP, kDkv>::kRows;
  static int run(unsigned blocks, cudaStream_t st, int tiles, const void* q,
                 const void* k, const void* v, const void* g, const float* lse,
                 const float* dres, void* dk, void* dv, int S, int D,
                 float scale, bool vec) {
    using Tl = Tile<DP, kDkv>;
    constexpr int kParts = Mma<T>::kSplit ? 2 : 1;
    const int bytes = Tl::kBufs * (2 * kParts * Tl::kN * Tl::kLd * 2 +
                                   2 * Tl::kN * 4);
    auto* kernel = flash_dkv_kernel<T, DP>;
    if (const int err = allow_smem(kernel, bytes)) return err;
    kernel<<<blocks, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, dres,
        static_cast<T*>(dk), static_cast<T*>(dv), S, D, scale, tiles, vec);
    return 0;
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
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(g);
  return shifu::flash::dispatch<Dkv>(dtype, B, H, S, D, stream, q, k, v, g,
                                     lse, dres, dk, dv, S, D, scale, vec);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
