// Stacked-table embedding lookup: out[b, f, :] = table[f, ids[b, f], :] for a
// (Nc, V, D) table of f32, bf16 or f16 and (B, Nc) int32 ids.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_embedding.py (_pallas_lookup /
// _make_lookup_kernel), with the semantics of its XLA reference _xla_lookup:
// an id in [-V, 0) wraps to id + V, and an id outside [-V, V) gives a row of
// NaN (the dedup sentinel V meets this case; split_features never makes one).
// A gather moves values unchanged, so the kernel copies bits: the result is
// bitwise equal to the plain version (ops/embedding.lookup_reference).
//
// Bound on the H100: bytes.  Each output element is one table element read
// and one written, plus the ids: at the DeepFM training shape (B = 32768,
// Nc = 6, D = 17 bf16) 14.2 MB, 4.2 us at 3.35 TB/s.  At that size a copy
// is set by latency, not bandwidth: each element is a chain of two
// dependent loads (the id, then the table) before its store, and the card
// must keep enough of those chains in flight in one short wave.
//
// Design.  The TPU kernel DMAs one (1, D) row per (b, f) into the output
// block, ids prefetched to SMEM; that does not carry over.  Here one thread
// owns one 16-byte run of the contiguous output (8 bf16/f16 elements or 4
// f32) and the grid is one thread per run, no grid-stride loop (418 K
// threads at the DeepFM shape, 1.5 waves of 2048 threads an SM; two or
// four runs a thread, in one wave, were slower on the card: PERF.md).  A
// thread divides once to find
// its first element's (row, column) and steps them along the run; it loads
// the ids of the rows the run touches, then issues every table load of the
// run before it stores anything, and writes the run with one 16-byte store.
// The last run, where B * Nc * D is not a multiple of the vector width, is
// masked and stored element by element; nothing is padded in device memory.
//   - D * element size a multiple of 16 (f32 D % 4 == 0, 16-bit D % 8 ==
//     0) and the table 16-byte aligned: a run lies in one table row, so
//     one id and one 16-byte table load;
//   - D at least the vector width (the DeepFM / Wide&Deep row of 17 bf16 =
//     34 bytes is not 16-byte aligned): a run spans at most two rows, so
//     two ids and element-wide table loads;
//   - narrower D (the wide part's D = 1): one id and one table load an
//     element.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// 16 bytes of Bits
template <typename Bits>
struct Vec {
  static constexpr int kN = 16 / sizeof(Bits);
  union {
    uint4 u;
    Bits e[kN];
  };
};

// The 16-byte run of output elements i0 .. i0 + kN into r; elements past
// n are NaN and not stored.  PATH: 0 rows 16-byte aligned, 1 a run spans
// at most two rows, 2 any D.
template <typename Bits, int PATH>
__device__ __forceinline__ void load_run(const Bits* __restrict__ table,
                                         const int* __restrict__ ids,
                                         unsigned i0, unsigned n, unsigned nc,
                                         long long v, unsigned d,
                                         Bits nan_bits, Vec<Bits>& r) {
  constexpr int kN = Vec<Bits>::kN;
  unsigned row = i0 / d;  // b * Nc + f
  unsigned c = i0 - row * d;
  unsigned f = row % nc;
  if (PATH == 0) {
    long long id = ids[row];
    if (id < 0) id += v;
    if (id >= 0 && id < v) {
      r.u = __ldg(reinterpret_cast<const uint4*>(
          table + ((long long)f * v + id) * d + c));
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) r.e[k] = nan_bits;
    }
  } else if (PATH == 1) {
    long long id0 = ids[row];
    long long id1 = row + 1 < n / d ? ids[row + 1] : 0;
    if (id0 < 0) id0 += v;
    if (id1 < 0) id1 += v;
    const unsigned f1 = f + 1 == nc ? 0 : f + 1;
    const bool ok0 = id0 >= 0 && id0 < v, ok1 = id1 >= 0 && id1 < v;
    const Bits* row0 = table + ((long long)f * v + (ok0 ? id0 : 0)) * d;
    const Bits* row1 = table + ((long long)f1 * v + (ok1 ? id1 : 0)) * d;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const unsigned cc = c + k;
      const bool second = cc >= d;
      r.e[k] = nan_bits;
      if ((second ? ok1 : ok0) && i0 + k < n)
        r.e[k] = __ldg(second ? row1 + (cc - d) : row0 + cc);
    }
  } else {
    long long at[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      long long id = i0 + k < n ? ids[row] : -1;
      if (id < 0 && i0 + k < n) id += v;
      at[k] = (id >= 0 && id < v) ? ((long long)f * v + id) * d + c : -1;
      if (++c == d) {
        c = 0;
        ++row;
        if (++f == nc) f = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k)
      r.e[k] = at[k] >= 0 ? __ldg(table + at[k]) : nan_bits;
  }
}

template <typename Bits, int PATH>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const Bits* __restrict__ table, const int* __restrict__ ids,
                  Bits* __restrict__ out, unsigned n, unsigned nc,
                  long long v, unsigned d, Bits nan_bits) {
  constexpr unsigned kN = Vec<Bits>::kN;
  const unsigned i0 = (blockIdx.x * kThreads + threadIdx.x) * kN;
  if (i0 >= n) return;
  Vec<Bits> r;
  load_run<Bits, PATH>(table, ids, i0, n, nc, v, d, nan_bits, r);
  if (i0 + kN <= n) {
    *reinterpret_cast<uint4*>(out + i0) = r.u;
  } else {
    for (unsigned k = 0; i0 + k < n; ++k) out[i0 + k] = r.e[k];
  }
}

template <typename Bits>
void launch(const void* table, const void* ids, void* out, unsigned n,
            unsigned nc, long long v, unsigned d, Bits nan_bits,
            cudaStream_t st) {
  constexpr unsigned kN = Vec<Bits>::kN;
  const unsigned blocks = ((n + kN - 1) / kN + kThreads - 1) / kThreads;
  const Bits* tb = static_cast<const Bits*>(table);
  const int* id = static_cast<const int*>(ids);
  Bits* o = static_cast<Bits*>(out);
  const bool aligned = (d * sizeof(Bits)) % 16 == 0 && shifu::aligned16(table);
  if (aligned)
    lookup_kernel<Bits, 0><<<blocks, kThreads, 0, st>>>(tb, id, o, n, nc, v,
                                                         d, nan_bits);
  else if (d >= kN)
    lookup_kernel<Bits, 1><<<blocks, kThreads, 0, st>>>(tb, id, o, n, nc, v,
                                                         d, nan_bits);
  else
    lookup_kernel<Bits, 2><<<blocks, kThreads, 0, st>>>(tb, id, o, n, nc, v,
                                                         d, nan_bits);
}

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise.  B * Nc * D must be below
// 2^31 (element indices are 32-bit) and `out` 16-byte aligned (a fresh
// allocation is).  Returns the CUDA error code of the launch (0 =
// cudaSuccess).
int embedding_lookup_fwd(const void* table, const void* ids, void* out,
                         long long B, int Nc, long long V, int D, int dtype,
                         void* stream) {
  if (B < 0 || Nc < 1 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const long long n = B * Nc * D;
  if (n >= (1LL << 31) - 16) return (int)cudaErrorInvalidValue;
  if (!shifu::aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case shifu::kFloat32:  // the NaN torch and numpy write: 0x7fc00000
      launch<uint32_t>(table, ids, out, (unsigned)n, Nc, V, D, 0x7fc00000u,
                       st);
      break;
    case shifu::kBFloat16:
      launch<uint16_t>(table, ids, out, (unsigned)n, Nc, V, D,
                       (uint16_t)0x7fc0u, st);
      break;
    case shifu::kFloat16:
      launch<uint16_t>(table, ids, out, (unsigned)n, Nc, V, D,
                       (uint16_t)0x7e00u, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* embedding_lookup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
