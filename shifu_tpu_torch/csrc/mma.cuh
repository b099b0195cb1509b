// Tensor-core building blocks shared by the kernels that run mma.sync
// (flash_*.cu, ft_block.cu): 16-bit pairs and the hi/lo split of an f32
// pair, mma.sync m16n8k16 / m16n8k8 with f32 accumulators, ldmatrix, and
// cp.async.  sm_90a; no state, every function inline.
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

}  // namespace shifu
