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
// Nc = 6, D = 17 bf16) about 14 MB, ~4 us at 3.35 TB/s; at that size the
// launch and the tail of the grid are as long as the copy, so the kernel is
// latency bound.  The TPU kernel DMAs one (1, D) row per (b, f) straight from
// HBM into the output block, ids prefetched to SMEM.  That does not carry
// over: rows of the concatenated DeepFM / Wide&Deep table are 17 bf16 = 34
// bytes, not 16-byte aligned, so no vector loads.  Here one thread copies one
// element: consecutive threads write consecutive output elements (coalesced)
// and read consecutive elements of one table row, and each thread reads its
// (b, f) id, which the threads of that row share through L1.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132u * 32u;  // grid-stride beyond 32 per SM

template <typename Bits>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const Bits* __restrict__ table, const int* __restrict__ ids,
                  Bits* __restrict__ out, unsigned n, unsigned nc,
                  long long v, unsigned d, Bits nan_bits) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const unsigned row = i / d;  // b * Nc + f
    const unsigned c = i - row * d;
    const unsigned f = row % nc;
    long long id = ids[row];
    if (id < 0) id += v;
    out[i] = (id >= 0 && id < v) ? table[((long long)f * v + id) * d + c]
                                 : nan_bits;
  }
}

template <typename Bits>
void launch(const void* table, const void* ids, void* out, unsigned n,
            unsigned nc, long long v, unsigned d, Bits nan_bits,
            cudaStream_t st) {
  unsigned blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lookup_kernel<Bits><<<blocks, kThreads, 0, st>>>(
      static_cast<const Bits*>(table), static_cast<const int*>(ids),
      static_cast<Bits*>(out), n, nc, v, d, nan_bits);
}

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise.  B * Nc * D must be below
// 2^31 (element indices are 32-bit).  Returns the CUDA error code of the
// launch (0 = cudaSuccess).
int embedding_lookup_fwd(const void* table, const void* ids, void* out,
                         long long B, int Nc, long long V, int D, int dtype,
                         void* stream) {
  if (B < 0 || Nc < 1 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const long long n = B * Nc * D;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
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
