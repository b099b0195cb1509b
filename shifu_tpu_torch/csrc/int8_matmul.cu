// Fused int8-dequant first layer: out = cdt(cdt(dequant(q)) @ cdt(w)) + cdt(b)
// on q (M, F) int8, w (F, N) f32, b (N,) f32, per-column scale/offset (F,) f32.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_int8_matmul.py (_run_fwd /
// _fwd_kernel).  Same math, in the same order, so that training on the int8
// wire rounds where the JAX package rounds:
//   1. x = float(q) * scale[f] (+ offset[f]), f32 multiply then f32 add (no
//      fused multiply-add: __fmul_rn / __fadd_rn keep nvcc from contracting);
//   2. x and w rounded to the compute dtype (round to nearest even);
//   3. products accumulated in f32 (a product of two bf16 or f16 values is
//      exact in f32, so only the summation order differs from the reference);
//   4. the sum rounded to the compute dtype;
//   5. the bias rounded to the compute dtype and added as a compute-dtype add:
//      an f32 add of the two rounded values, rounded once more.
//
// Bound on the H100 at the training shape (M=65536, F=30, N=100, bf16): bytes,
// barely.  q in (2 MB), the bf16 output (13 MB) and the small w/b/scale make
// about 15 MB, 4.5 us at 3.35 TB/s; the 0.39 GFLOP of products take 5.9 us at
// the 67 TFLOP/s f32 rate of the CUDA cores, so the two bounds sit close.
// The TPU kernel tiles 256 batch rows and puts the whole (F, N) weight in VMEM
// for one MXU product; that is not carried over.  Here one CTA of 256 threads
// owns a 64-row x 64-column output tile and walks F in chunks of 32: each
// chunk of q is dequantized and rounded once while it is staged in shared
// memory, the matching chunk of w is rounded once while it is staged, and
// each thread keeps a 4 x 4 register tile of f32 accumulators.  N is tiled
// too (N reaches 4096).  A 64-row tile of q rows is one contiguous byte range
// when F fits one chunk (F=30: 1920 bytes), and neighbouring threads load
// neighbouring bytes, so the loads coalesce although 30-byte rows are not
// 4-byte aligned.  Tensor cores (wgmma) and TMA are left for a later version.
#include "common.cuh"

namespace {

constexpr int kBM = 64;       // rows of q per CTA
constexpr int kBN = 64;       // output columns per CTA
constexpr int kBK = 32;       // features per staged chunk
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 tile
constexpr int kTM = 4;
constexpr int kTN = 4;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return shifu::to_f32(shifu::from_f32<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const signed char* __restrict__ q,
                       const float* __restrict__ w,
                       const float* __restrict__ b,
                       const float* __restrict__ scale,
                       const float* __restrict__ offset,
                       T* __restrict__ out, long long M, int F, int N) {
  // odd row stride: the two rows a warp reads at once sit in other banks
  __shared__ float xs[kBM][kBK + 1];
  __shared__ float ws[kBK][kBN];
  __shared__ float ss[kBK];
  __shared__ float os[kBK];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int rows = (int)min((long long)kBM, M - row0);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += kBK) {
    const int kw = min(kBK, F - k0);
    __syncthreads();  // the previous chunk is consumed
    if (tid < kw) {
      ss[tid] = scale[k0 + tid];
      os[tid] = offset != nullptr ? offset[k0 + tid] : 0.f;
    }
    __syncthreads();
    // q chunk: rows x kw bytes; the linear index walks each row's kw bytes
    // in order, so neighbouring threads read neighbouring addresses
    for (int i = tid; i < rows * kw; i += kThreads) {
      const int r = i / kw;
      const int c = i - r * kw;
      float x = __fmul_rn((float)q[(row0 + r) * F + k0 + c], ss[c]);
      if (offset != nullptr) x = __fadd_rn(x, os[c]);
      xs[r][c] = round_to<T>(x);
    }
    // rows past M and features past kw read as 0
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i - r * kBK;
      if (r >= rows || c >= kw) xs[r][c] = 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN;
      const int n = i - k * kBN;
      ws[k][n] = (k < kw && col0 + n < N)
                     ? round_to<T>(w[(long long)(k0 + k) * N + col0 + n])
                     : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kw; ++k) {
      float xv[kTM], wv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) xv[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wv[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = col0 + tx + 16 * j;
    if (n >= N) continue;
    const float bias = round_to<T>(b[n]);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
      const float y = __fadd_rn(round_to<T>(acc[i][j]), bias);
      out[(row0 + r) * N + n] = shifu::from_f32<T>(y);
    }
  }
}

template <typename T>
void launch(const void* q, const void* w, const void* b, const void* scale,
            const void* offset, void* out, long long M, int F, int N,
            cudaStream_t st) {
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  int8_matmul_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const signed char*>(q), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(offset), static_cast<T*>(out), M, F, N);
}

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise.  `offset` may be null.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
int int8_matmul_fwd(const void* q, const void* w, const void* b,
                    const void* scale, const void* offset, void* out,
                    long long M, int F, int N, int dtype, void* stream) {
  if (M < 0 || F < 1 || F > 4096 || N < 1 || N > 4096)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case shifu::kFloat32:
      launch<float>(q, w, b, scale, offset, out, M, F, N, st);
      break;
    case shifu::kBFloat16:
      launch<__nv_bfloat16>(q, w, b, scale, offset, out, M, F, N, st);
      break;
    case shifu::kFloat16:
      launch<__half>(q, w, b, scale, offset, out, M, F, N, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
