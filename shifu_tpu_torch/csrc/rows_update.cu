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
// Bound on the H100: bytes of the touched rows, g read and t, a, d read and
// written, 7 * D * 4 bytes a row for Adadelta (3 for SGD; a bf16 table moves
// fewer), plus the ids.  One pass moves just those: each row is read, updated
// in registers and written back by the threads that own it, and nothing else
// is written.  A row of D elements is cut into D / VEC chunks of VEC
// elements, VEC = 4 where D and the pointers allow it (16-byte loads and
// stores of g, the slots and an f32 table; 8 bytes of a bf16 or f16 table),
// else 2, else 1.  The chunks of one row go to a power-of-two group of lanes
// of one warp (4 lanes at D = 16 f32, a whole warp from D = 128), whose
// first lane reads the id and computes the row's offset once; the group's
// other lanes take it by a shuffle, so no thread divides per element.
//
// Duplicates.  The TPU kernel needs the in-range ids of a field unique
// within a call: two copies of one row would race their read-modify-write.
// The dedup path's ids are unique (`stamp` null: every in-range entry
// updates its row).  Raw-id batches (the resident tier, embed.dedup "off")
// carry duplicates, and duplicates of one id carry the same gradient row
// (the summed dense gradient gathered at that id), so one copy's update is
// the whole update.  `stamp` (Nc * V int32, kept by the wrapper between
// calls) elects that copy: the entry whose atomicMax(&stamp[f * V + id],
// call) returns less than `call` owns the row, and the others skip it.
// `call` grows strictly from launch to launch on the stamp's stream, so no
// stamp needs clearing between calls.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132u * 16u;
// the constants as the plain version's Python floats reach f32
constexpr float kRho = (float)0.95;
constexpr float kOneMinusRho = (float)(1.0 - 0.95);
constexpr float kEps = (float)1e-8;

enum Rule : int { kSgd = 0, kAdadelta = 1 };

// VEC elements of type E, loaded and stored as one access
template <typename E, int VEC>
struct alignas(sizeof(E) * VEC) Pack {
  E v[VEC];
};

template <typename T, int VEC, bool kAda>
__global__ void __launch_bounds__(kThreads)
    rows_update_kernel(T* __restrict__ table, float* __restrict__ accu,
                       float* __restrict__ delta,
                       const float* __restrict__ g_rows,
                       const int* __restrict__ ids, int* __restrict__ stamp,
                       int call, long long n_rows, int nc, long long v, int d,
                       int lanes_log2, float lr) {
  const int lanes = 1 << lanes_log2;  // a row's lanes, a power of two <= 32
  const int sub = threadIdx.x & (lanes - 1);
  const int chunks = d / VEC;
  const long long rows_per_block = kThreads >> lanes_log2;
  // the loop's trip count is the same for every thread of a block, so the
  // whole warp reaches each shuffle
  for (long long base = blockIdx.x * rows_per_block; base < n_rows;
       base += (long long)gridDim.x * rows_per_block) {
    const long long row = base + (threadIdx.x >> lanes_log2);  // u * Nc + f
    long long off = -1;
    if (sub == 0 && row < n_rows) {
      const int id = ids[row];
      if (id >= 0 && id < v) {
        const long long slot = (long long)(row % nc) * v + id;
        if (stamp == nullptr || atomicMax(stamp + slot, call) < call)
          off = slot * d;
      }
    }
    off = __shfl_sync(0xffffffffu, off, 0, lanes);
    if (off < 0) continue;
    const float* g_row = g_rows + row * d;
    for (int c = sub; c < chunks; c += lanes) {
      const long long e = off + (long long)c * VEC;
      const Pack<float, VEC> g =
          *reinterpret_cast<const Pack<float, VEC>*>(g_row + c * VEC);
      Pack<T, VEC> t = *reinterpret_cast<const Pack<T, VEC>*>(table + e);
      if constexpr (!kAda) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          t.v[i] = shifu::from_f32<T>(
              __fsub_rn(shifu::to_f32(t.v[i]), __fmul_rn(lr, g.v[i])));
      } else {
        Pack<float, VEC> a = *reinterpret_cast<const Pack<float, VEC>*>(
            accu + e);
        Pack<float, VEC> dd = *reinterpret_cast<const Pack<float, VEC>*>(
            delta + e);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gi = g.v[i];
          const float a2 =
              __fadd_rn(__fmul_rn(kRho, a.v[i]),
                        __fmul_rn(__fmul_rn(kOneMinusRho, gi), gi));
          const float u =
              __fdiv_rn(__fmul_rn(gi, __fsqrt_rn(__fadd_rn(dd.v[i], kEps))),
                        __fsqrt_rn(__fadd_rn(a2, kEps)));
          a.v[i] = a2;
          dd.v[i] = __fadd_rn(__fmul_rn(kRho, dd.v[i]),
                              __fmul_rn(__fmul_rn(kOneMinusRho, u), u));
          t.v[i] = shifu::from_f32<T>(
              __fsub_rn(shifu::to_f32(t.v[i]), __fmul_rn(lr, u)));
        }
        *reinterpret_cast<Pack<float, VEC>*>(accu + e) = a;
        *reinterpret_cast<Pack<float, VEC>*>(delta + e) = dd;
      }
      *reinterpret_cast<Pack<T, VEC>*>(table + e) = t;
    }
  }
}

// the widest VEC in {4, 2, 1} that divides D and to which every buffer is
// aligned
template <typename T>
int vec_width(const void* table, const void* accu, const void* delta,
              const void* g_rows, int d) {
  for (int vec = 4; vec > 1; vec /= 2) {
    if (d % vec) continue;
    const size_t t = vec * sizeof(T), f = vec * sizeof(float);
    const auto ok = [](const void* p, size_t b) {
      return p == nullptr || reinterpret_cast<uintptr_t>(p) % b == 0;
    };
    if (ok(table, t) && ok(accu, f) && ok(delta, f) && ok(g_rows, f))
      return vec;
  }
  return 1;
}

template <typename T, int VEC>
void launch_vec(void* table, void* accu, void* delta, const void* g_rows,
                const void* ids, void* stamp, int call, long long n_rows,
                int nc, long long v, int d, int rule, float lr,
                cudaStream_t st) {
  const int chunks = d / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  const long long rows_per_block = kThreads >> lanes_log2;
  long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto kernel = rule == kAdadelta ? rows_update_kernel<T, VEC, true>
                                        : rows_update_kernel<T, VEC, false>;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<T*>(table), static_cast<float*>(accu),
      static_cast<float*>(delta), static_cast<const float*>(g_rows),
      static_cast<const int*>(ids), static_cast<int*>(stamp), call, n_rows,
      nc, v, d, lanes_log2, lr);
}

template <typename T>
void launch(void* table, void* accu, void* delta, const void* g_rows,
            const void* ids, void* stamp, int call, long long n_rows, int nc,
            long long v, int d, int rule, float lr, cudaStream_t st) {
  switch (vec_width<T>(table, accu, delta, g_rows, d)) {
    case 4:
      launch_vec<T, 4>(table, accu, delta, g_rows, ids, stamp, call, n_rows,
                       nc, v, d, rule, lr, st);
      break;
    case 2:
      launch_vec<T, 2>(table, accu, delta, g_rows, ids, stamp, call, n_rows,
                       nc, v, d, rule, lr, st);
      break;
    default:
      launch_vec<T, 1>(table, accu, delta, g_rows, ids, stamp, call, n_rows,
                       nc, v, d, rule, lr, st);
  }
}

}  // namespace

extern "C" {

// Launches one pass on `stream` and does not synchronise.  `stamp` null:
// the in-range ids of each field are unique within the call.  Otherwise
// `stamp` holds Nc * V int32, each below `call` (> 0), and duplicates are
// allowed (module comment).  `accu` and `delta` may be null for sgd.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
int rows_update(void* table, void* accu, void* delta, const void* g_rows,
                const void* ids, void* stamp, int call, long long U, int Nc,
                long long V, int D, int rule, int dtype, float lr,
                void* stream) {
  if (U < 0 || Nc < 1 || V < 1 || V > INT32_MAX || D < 1)
    return (int)cudaErrorInvalidValue;
  if (rule != kSgd && rule != kAdadelta) return (int)cudaErrorInvalidValue;
  if (rule == kAdadelta && (accu == nullptr || delta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (stamp != nullptr && call < 1) return (int)cudaErrorInvalidValue;
  const long long n_rows = U * Nc;
  if (n_rows * D >= (1LL << 40)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case shifu::kFloat32:
      launch<float>(table, accu, delta, g_rows, ids, stamp, call, n_rows, Nc,
                    V, D, rule, lr, st);
      break;
    case shifu::kBFloat16:
      launch<__nv_bfloat16>(table, accu, delta, g_rows, ids, stamp, call,
                            n_rows, Nc, V, D, rule, lr, st);
      break;
    case shifu::kFloat16:
      launch<__half>(table, accu, delta, g_rows, ids, stamp, call, n_rows, Nc,
                     V, D, rule, lr, st);
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
