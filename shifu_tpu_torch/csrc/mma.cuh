// Tensor-core building blocks shared by the kernels that run mma.sync
// (flash_*.cu, ft_block.cu, small_attention.cu): 16-bit pairs and the
// hi/lo split of an f32 pair, mma.sync m16n8k16 / m16n8k8 with f32
// accumulators, ldmatrix, movmatrix, and cp.async; then the fragment tiles
// of the attention kernels (scores, P and dS as A operands, products with
// a panel of rows in shared memory).  sm_90a; no state, every function
// inline.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace shifu {

// -- 16-bit pairs ------------------------------------------------------------

template <typename E>
__device__ __forceinline__ uint32_t pack(float a, float b) {  // a low
  uint32_t u;
  if constexpr (std::is_same<E, __half>::value) {
    __half2 h = __floats2half2_rn(a, b);
    u = *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    u = *reinterpret_cast<uint32_t*>(&h);
  }
  return u;
}

template <typename E>
__device__ __forceinline__ float2 unpack(uint32_t u) {
  if constexpr (std::is_same<E, __half>::value) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  } else {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
}

// (a, b) as hi = rounded and lo = (x - hi) * lo_scale rounded
template <typename E>
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo, float lo_scale = 1.f) {
  hi = pack<E>(a, b);
  const float2 h = unpack<E>(hi);
  lo = pack<E>((a - h.x) * lo_scale, (b - h.y) * lo_scale);
}

// the sum over the four lanes of a quad: one row of an mma fragment
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- tensor-core instructions ------------------------------------------------

// c += a (16 x 16) b (16 x 8), f32 accumulate
template <typename E>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t* a,
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// c += a (16 x 8) b (8 x 8), f32 accumulate
template <typename E>
__device__ __forceinline__ void mma8(float (&c)[4], const uint32_t* a,
                                     uint32_t b0) {
  if constexpr (std::is_same<E, __half>::value) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b0));
  } else {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b0));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// two 8 x 8 matrices; lanes 8i..8i+7 give the row addresses of matrix i
// (lanes 16..31 give addresses that are not read)
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// The transpose of an 8 x 8 matrix of 16-bit values held as mma holds a
// fragment (lane l: row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1), in
// the same layout
__device__ __forceinline__ uint32_t movt(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}


// -- tiles of mma fragments (flash_*.cu, small_attention.cu) ----------------

constexpr float kLog2e = 1.4426950408889634f;
// f16 dS: the lo part's scale (and 1 / it)
constexpr float kLoScale = 2048.f;
constexpr float kLoUnscale = 1.f / 2048.f;

// E: the 16-bit type the tensor cores take for T; kSplit: T is f32, held as
// bf16 hi + lo; kLoAcc: dS's lo part goes to an accumulator of its own
template <typename T>
struct Mma {
  using E = __nv_bfloat16;
  static constexpr bool kSplit = true;
  static constexpr bool kLoAcc = false;
};
template <>
struct Mma<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr bool kSplit = false;
  static constexpr bool kLoAcc = false;
};
template <>
struct Mma<__half> {
  using E = __half;
  static constexpr bool kSplit = false;
  static constexpr bool kLoAcc = true;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max of this thread's scores in row half H (row g, or g + 8) of a
// tile, as a tree: a chain of fmaxf would be 2 NT deep
template <int H, int NT>
__device__ __forceinline__ float tile_max(const float (&s)[NT][4]) {
  float t[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) t[j] = fmaxf(s[j][2 * H], s[j][2 * H + 1]);
#pragma unroll
  for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
  return t[0];
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// zero an accumulator array
template <int A, int N>
__device__ __forceinline__ void zero(float (&acc)[A][N][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
}

// acc += lacc / kLoScale: the lo parts' own accumulators folded back
template <int A, int N>
__device__ __forceinline__ void fold(float (&acc)[A][N][4],
                                     const float (&lacc)[A][N][4]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[a][n][e] = fmaf(lacc[a][n][e], kLoUnscale, acc[a][n][e]);
}

// A tile of streamed rows in shared memory: hi and, for f32 inputs, lo
template <typename E>
struct Panel {
  E* hi;
  E* lo;
};

// acc[m][j] (m-tile m, 16 x 8 streamed rows 8j..8j+7) = A[m] (16 x DP,
// registers) . X^T over the NT * 8 rows of panel x, each B fragment loaded
// once for the MT m-tiles.  f32 inputs: hi hi + hi lo + lo hi.
template <typename E, int DP, int LD, int NT, int MT, bool kSplit>
__device__ __forceinline__ void score_mma(float (&acc)[MT][NT][4],
                                          const uint32_t (&ah)[MT][DP / 4],
                                          const uint32_t (&al)[MT][DP / 4],
                                          Panel<E> x) {
  const int lane = threadIdx.x % 32;
  zero(acc);
  if constexpr (DP == 8) {
#pragma unroll
    for (int j = 0; j < NT; j += 4) {
      uint32_t b[4], bl[4];
      ldsm4(b, x.hi + (8 * j + lane) * LD);
      if constexpr (kSplit) ldsm4(bl, x.lo + (8 * j + lane) * LD);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma8<E>(acc[m][j + u], ah[m], b[u]);
          if constexpr (kSplit) {
            mma8<E>(acc[m][j + u], ah[m], bl[u]);
            mma8<E>(acc[m][j + u], al[m], b[u]);
          }
        }
    }
  } else {
    const int mat = lane / 8, r = lane % 8;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const int off = (8 * (j + (mat >> 1)) + r) * LD + 16 * kc + 8 * (mat & 1);
        uint32_t b[4], bl[4];
        ldsm4(b, x.hi + off);
        if constexpr (kSplit) ldsm4(bl, x.lo + off);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma16<E>(acc[m][j + u], ah[m] + 4 * kc, b[2 * u], b[2 * u + 1]);
            if constexpr (kSplit) {
              mma16<E>(acc[m][j + u], ah[m] + 4 * kc, bl[2 * u], bl[2 * u + 1]);
              mma16<E>(acc[m][j + u], al[m] + 4 * kc, b[2 * u], b[2 * u + 1]);
            }
          }
      }
    }
  }
}

// The A fragment (16 x 16) of columns 16 kc .. 16 kc + 15 of an f32
// accumulator, as hi and lo parts (lo times lo_scale)
template <typename E, int NT>
__device__ __forceinline__ void a_from_acc(const float (&s)[NT][4], int kc,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           float lo_scale = 1.f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* c = s[2 * kc + (i >> 1)] + 2 * (i & 1);
    split<E>(c[0], c[1], hi[i], lo[i], lo_scale);
  }
}

// acc[m] (16 x DP) += A[m] (16 x 16 streamed rows 16 kc..) . X over those
// rows of panel x (transposed loads, once for the MT m-tiles): hi hi and
// lo hi, plus hi lo for f32 inputs; the lo A part goes to lacc (acc
// itself, or an accumulator of its own)
template <typename E, int DP, int LD, int MT, bool kSplit>
__device__ __forceinline__ void out_mma(float (&acc)[MT][DP / 8][4],
                                        float (&lacc)[MT][DP / 8][4],
                                        const uint32_t (&ah)[MT][4],
                                        const uint32_t (&al)[MT][4],
                                        Panel<E> x, int kc) {
  const int lane = threadIdx.x % 32;
  if constexpr (DP == 8) {
    const int off = (16 * kc + lane % 16) * LD;
    uint32_t b[2], bl[2];
    ldsm2t(b, x.hi + off);
    if constexpr (kSplit) ldsm2t(bl, x.lo + off);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma16<E>(acc[m][0], ah[m], b[0], b[1]);
      mma16<E>(lacc[m][0], al[m], b[0], b[1]);
      if constexpr (kSplit) mma16<E>(acc[m][0], ah[m], bl[0], bl[1]);
    }
  } else {
    const int mat = lane / 8, r = lane % 8;
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      const int off = (16 * kc + 8 * (mat & 1) + r) * LD + 8 * (n + (mat >> 1));
      uint32_t b[4], bl[4];
      ldsm4t(b, x.hi + off);
      if constexpr (kSplit) ldsm4t(bl, x.lo + off);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma16<E>(acc[m][n + u], ah[m], b[2 * u], b[2 * u + 1]);
          mma16<E>(lacc[m][n + u], al[m], b[2 * u], b[2 * u + 1]);
          if constexpr (kSplit)
            mma16<E>(acc[m][n + u], ah[m], bl[2 * u], bl[2 * u + 1]);
        }
    }
  }
}

}  // namespace shifu
