// Rows-touched optimizer update of a stacked embedding table: for each
// (u, f) with ids[u, f] in [0, V), apply SGD or Adadelta to row ids[u, f] of
// field f of the table (Nc, V, D) and, for Adadelta, of its two f32 slots,
// with the gradient row g_rows[u, f] (f32), in place.  Ids outside [0, V) (the
// dedup sentinel V pads a unique-id batch to a fixed size) are skipped.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_embedding.py
// (_pallas_rows_update / _make_rows_update_kernel).  Same math in the same
// order as its reference rows_update_reference, in f32 (TF's rho 0.95 and eps
// 1e-8):
//   sgd:       t' = t - lr * g
//   adadelta:  a' = rho * a + ((1 - rho) * g) * g
//              u  = (g * sqrt(d + eps)) / sqrt(a' + eps)
//              d' = rho * d + ((1 - rho) * u) * u
//              t' = t - lr * u
// with each product, sum, square root and quotient rounded on its own
// (__fmul_rn and friends: nvcc would contract a*b+c into a fused multiply-add,
// the plain version does not), so the result is bitwise equal to the plain
// version; t' is stored in the table's dtype (f32, bf16 or f16), rounded to
// nearest even.
//
// Duplicates.  The TPU kernel needs the in-range ids of a field unique within
// a call: two copies of one row would race their write-back DMAs.  The port
// sends raw-id batches through this kernel as well, so it must hold with
// duplicates: every read of a row must come before any write to it.  Two
// launches on one stream do that: the first computes every touched row's new
// values into a (U, Nc, D) f32 scratch per buffer, the second writes them
// back.  Duplicates of one id carry the same gradient row (the summed dense
// gradient gathered at that id) and read the same old row, so they write the
// same bytes, whatever their order.
//
// Bound on the H100: bytes of the touched rows, g read and t, a, d read and
// written, 7 * D * 4 bytes a row for Adadelta (3 for SGD; a bf16 table moves
// fewer).  The scratch costs 6 * D * 4 more (written, then read back), and
// rows of 64 or 68 bytes (D = 16 f32; the first-order table has D = 1) are
// read element by element, one thread per element: a simple design that is
// right first.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132u * 32u;
// the constants as the plain version's Python floats reach f32
constexpr float kRho = (float)0.95;
constexpr float kOneMinusRho = (float)(1.0 - 0.95);
constexpr float kEps = (float)1e-8;

enum Rule : int { kSgd = 0, kAdadelta = 1 };

// the touched element i of the (U, Nc, D) rows: its offset in the table, or
// -1 when its id is outside [0, V)
__device__ __forceinline__ long long table_offset(const int* __restrict__ ids,
                                                  unsigned i, unsigned nc,
                                                  long long v, unsigned d) {
  const unsigned row = i / d;  // u * Nc + f
  const unsigned c = i - row * d;
  const long long id = ids[row];
  if (id < 0 || id >= v) return -1;
  return ((long long)(row % nc) * v + id) * d + c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    compute_kernel(const T* __restrict__ table,
                   const float* __restrict__ accu,
                   const float* __restrict__ delta,
                   const float* __restrict__ g_rows,
                   const int* __restrict__ ids, float* __restrict__ new_t,
                   float* __restrict__ new_a, float* __restrict__ new_d,
                   unsigned n, unsigned nc, long long v, unsigned d,
                   int rule, float lr) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const long long off = table_offset(ids, i, nc, v, d);
    if (off < 0) continue;
    const float g = g_rows[i];
    const float t = shifu::to_f32(table[off]);
    if (rule == kSgd) {
      new_t[i] = __fsub_rn(t, __fmul_rn(lr, g));
      continue;
    }
    const float a = accu[off];
    const float dd = delta[off];
    const float a2 =
        __fadd_rn(__fmul_rn(kRho, a), __fmul_rn(__fmul_rn(kOneMinusRho, g), g));
    const float u = __fdiv_rn(__fmul_rn(g, __fsqrt_rn(__fadd_rn(dd, kEps))),
                              __fsqrt_rn(__fadd_rn(a2, kEps)));
    new_a[i] = a2;
    new_d[i] = __fadd_rn(__fmul_rn(kRho, dd),
                         __fmul_rn(__fmul_rn(kOneMinusRho, u), u));
    new_t[i] = __fsub_rn(t, __fmul_rn(lr, u));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    write_kernel(T* __restrict__ table, float* __restrict__ accu,
                 float* __restrict__ delta, const int* __restrict__ ids,
                 const float* __restrict__ new_t,
                 const float* __restrict__ new_a,
                 const float* __restrict__ new_d, unsigned n, unsigned nc,
                 long long v, unsigned d, int rule) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const long long off = table_offset(ids, i, nc, v, d);
    if (off < 0) continue;
    table[off] = shifu::from_f32<T>(new_t[i]);
    if (rule == kAdadelta) {
      accu[off] = new_a[i];
      delta[off] = new_d[i];
    }
  }
}

template <typename T>
void launch(void* table, void* accu, void* delta, const void* g_rows,
            const void* ids, void* scratch, unsigned n, unsigned nc,
            long long v, unsigned d, int rule, float lr, cudaStream_t st) {
  unsigned blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  float* new_t = static_cast<float*>(scratch);
  float* new_a = rule == kAdadelta ? new_t + n : nullptr;
  float* new_d = rule == kAdadelta ? new_t + 2 * (size_t)n : nullptr;
  compute_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const float*>(accu),
      static_cast<const float*>(delta), static_cast<const float*>(g_rows),
      static_cast<const int*>(ids), new_t, new_a, new_d, n, nc, v, d, rule,
      lr);
  write_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(table), static_cast<float*>(accu),
      static_cast<float*>(delta), static_cast<const int*>(ids), new_t, new_a,
      new_d, n, nc, v, d, rule);
}

}  // namespace

extern "C" {

// Launches both passes on `stream` and does not synchronise.  `scratch`
// holds 1 (sgd) or 3 (adadelta) f32 buffers of U * Nc * D, which must be
// below 2^31; `accu` and `delta` may be null for sgd.  Returns the CUDA
// error code of the launches (0 = cudaSuccess).
int rows_update(void* table, void* accu, void* delta, const void* g_rows,
                const void* ids, void* scratch, long long U, int Nc,
                long long V, int D, int rule, int dtype, float lr,
                void* stream) {
  if (U < 0 || Nc < 1 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (rule != kSgd && rule != kAdadelta) return (int)cudaErrorInvalidValue;
  if (rule == kAdadelta && (accu == nullptr || delta == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n = U * Nc * D;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case shifu::kFloat32:
      launch<float>(table, accu, delta, g_rows, ids, scratch, (unsigned)n, Nc,
                    V, D, rule, lr, st);
      break;
    case shifu::kBFloat16:
      launch<__nv_bfloat16>(table, accu, delta, g_rows, ids, scratch,
                            (unsigned)n, Nc, V, D, rule, lr, st);
      break;
    case shifu::kFloat16:
      launch<__half>(table, accu, delta, g_rows, ids, scratch, (unsigned)n,
                     Nc, V, D, rule, lr, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* rows_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
