// Flash attention forward (kernel #7): o and lse, rows = queries, K/V tiles
// streamed through a shared ring; per tile S = Q K^T on the tensor cores,
// one rescale of the running (m, l, o), p = ex2(s c - m c) and o += P V
// with P as hi + lo parts.  Design and bound:
// flash_common.cuh.
#include "flash_common.cuh"

namespace {

using namespace shifu::flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int D, float scale,
                     int tiles, bool vec) {
  using M = Mma<T>;
  using E = typename M::E;
  using Tl = Tile<DP, kFwd>;
  constexpr int BN = Tl::kN, LD = Tl::kLd, NT = BN / 8, MT = Tl::kMt;
  constexpr int kPanel = BN * LD;  // elements of one part of one operand
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
  // a negative scale negates q (exact), so that the max of q.k is the max of
  // the scaled scores; c is floored so that a masked -inf times c stays -inf
  const float c = fmaxf(fabsf(scale) * kLog2e, 1e-30f);
  uint32_t qh[MT][DP / 4], ql[MT][DP / 4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_a<T, DP>(q + base, r0 + 16 * mt, S, D, scale < 0.f ? -1.f : 1.f,
                  qh[mt], ql[mt]);

  float acc[MT][DP / 8][4];
  zero(acc);
  // per m-tile and row half (rows g and g + 8): running max and this
  // thread's part of the row sum
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = -INFINITY;
      l[mt][h] = 0.f;
    }
  const int t4 = threadIdx.x % 4;
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

    float s[MT][NT][4];
    score_mma<E, DP, LD, NT, MT, M::kSplit>(s, qh, ql, panel(buf, 0));
    if (k0 + BN > S) {  // the last tile: keys past S
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t4 + (e & 1) >= S) s[mt][j][e] = -INFINITY;
    }
    float mcs[MT][2];  // the new max times c, per row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // finite: the tile holds a live key
      const float mx[2] = {quad_max(fmaxf(m[mt][0], tile_max<0>(s[mt]))),
                           quad_max(fmaxf(m[mt][1], tile_max<1>(s[mt])))};
      float mc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float corr = ex2((m[mt][h] - mx[h]) * c);  // 0 on the first tile
        l[mt][h] *= corr;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[mt][n][2 * h] *= corr;
          acc[mt][n][2 * h + 1] *= corr;
        }
        m[mt][h] = mx[h];
        mc[h] = mx[h] * c;
      }
      mcs[mt][0] = mc[0];
      mcs[mt][1] = mc[1];
    }
    // p = ex2(s c - m c), 16 keys (two 8-key column blocks) at a time: the
    // exponentials of block kc + 1 are issued before the products of block
    // kc, so that the special-function unit and the other pipes overlap
    auto exps = [&](int kc) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 2 * kc; j < 2 * kc + 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = ex2(fmaf(s[mt][j][2 * h], c, -mcs[mt][h]));
            const float p1 = ex2(fmaf(s[mt][j][2 * h + 1], c, -mcs[mt][h]));
            s[mt][j][2 * h] = p0;
            s[mt][j][2 * h + 1] = p1;
            l[mt][h] += p0 + p1;
          }
    };
    exps(0);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      if (kc + 1 < BN / 16) exps(kc + 1);
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a_from_acc<E, NT>(s[mt], kc, ph[mt], pl[mt]);
      out_mma<E, DP, LD, MT, M::kSplit>(acc, acc, ph, pl, panel(buf, 1), kc);
    }
  }

  const int g = (threadIdx.x % 32) / 4;
  const float sc = fabsf(scale);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = quad_sum(l[mt][0]), l1 = quad_sum(l[mt][1]);
    const int rm = r0 + 16 * mt;
    store_rows<T, DP>(o + base, acc[mt], rm, S, D, 1.f / l0, 1.f / l1);
    if (t4 == 0) {
      if (rm + g < S) lse[bh * S + rm + g] = m[mt][0] * sc + logf(l0);
      if (rm + g + 8 < S) lse[bh * S + rm + g + 8] = m[mt][1] * sc + logf(l1);
    }
  }
}

template <typename T, int DP>
struct Fwd {
  static constexpr int kRows = Tile<DP, kFwd>::kRows;
  static int run(unsigned blocks, cudaStream_t st, int tiles, const void* q,
                 const void* k, const void* v, void* o, float* lse, int S,
                 int D, float scale, bool vec) {
    using Tl = Tile<DP, kFwd>;
    constexpr int kParts = Mma<T>::kSplit ? 2 : 1;
    const int bytes = Tl::kBufs * 2 * kParts * Tl::kN * Tl::kLd * 2;
    auto* kernel = flash_fwd_kernel<T, DP>;
    if (const int err = allow_smem(kernel, bytes)) return err;
    kernel<<<blocks, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, D, scale, tiles,
        vec);
    return 0;
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
  const bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  return shifu::flash::dispatch<Fwd>(dtype, B, H, S, D, stream, q, k, v, o,
                                     lse, S, D, scale, vec);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
