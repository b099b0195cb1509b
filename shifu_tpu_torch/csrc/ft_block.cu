// Fused pre-LN FT-Transformer block, one pass over (B, S, D) f32 tokens:
//   y = LN(x); qkv = y Wqkv + b; per-head softmax(q k^T / sqrt(dh)) v;
//   x += attn Wp + b; y = LN(x); x += gelu_tanh(y Win + b) Wout + b.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_ft_block.py (_run_fwd over
// _block_math).  Same math, all in f32: LayerNorm with a two-pass variance
// and eps 1e-6, tanh-approximate gelu, softmax over the S real keys.
//
// Bound on the H100: operations.  At the serving shape (B=4096, S=31, D=64,
// H=8, R=4) a block is about 13.5 GFLOP (12.5 in the four products), about
// 0.2 ms at the 67 TFLOP/s f32 rate of the CUDA cores, against 65 MB of f32
// activations in and out (about 19 us at 3.35 TB/s).  Tensor cores (wgmma,
// bf16 or tf32 operands) would lift the operation bound; that is work for a
// later version.
//
// Design.  The TPU kernel's 8-sample batch tile and its padding of S to 8
// are TPU tiling choices and are not copied.  One block of 256 threads owns
// NS whole samples (NS*S token rows, padded to a multiple of 8 rows).  Their
// activations never leave dynamic shared memory:
//   X   [rows][D+1]   the residual stream
//   Y   [rows][D+1]   LN output, then the attention output
//   O   [rows][D+1]   the FFN output accumulator
//   Big [rows][3D+1]  q|k|v, then one chunk of the FFN hidden layer
// Row strides are odd so that threads reading different rows of one column
// hit different banks.  The FFN hidden dimension R*D is walked in chunks of
// at most 3D columns, so the whole envelope (S <= 64, D <= 128, R <= 8) fits
// in 227 KB and no shape the gate admits is refused.  Weights are read from
// device memory through the read-only cache; at D=64 a layer's are 192 KB
// and stay in L2 across blocks.  Products are f32 FMAs on the CUDA cores:
// each warp computes an 8-row x 64-column tile (two columns per lane, eight
// rows in registers), so one broadcast shared-memory load feeds two FMAs.
// Attention runs one thread per (row, head): a max pass over the keys, then
// exp-sum and the weighted sum of V, in chunks of 16 head dims.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;
constexpr int kMaxS = 64;
constexpr int kMaxD = 128;
constexpr int kMaxR = 8;
constexpr float kLnEps = 1e-6f;
// shared memory a block may take on sm_90 (227 KB)
constexpr int kMaxSmem = 232448;
// samples per block are added while a block stays under this, so that
// several blocks share an SM
constexpr int kTargetSmem = 56 * 1024;
constexpr int kMaxSamples = 16;

struct Params {
  const float* ln_attn_scale;
  const float* ln_attn_bias;
  const float* qkv_kernel;
  const float* qkv_bias;
  const float* proj_kernel;
  const float* proj_bias;
  const float* ln_mlp_scale;
  const float* ln_mlp_bias;
  const float* mlp_in_kernel;
  const float* mlp_in_bias;
  const float* mlp_out_kernel;
  const float* mlp_out_bias;
};

enum Epilogue { kBias, kGeluBias, kAddBias, kSet, kAdd };

__host__ __device__ inline int padded_rows(int ns, int S) {
  return (ns * S + kTileRows - 1) / kTileRows * kTileRows;
}

__host__ __device__ inline size_t smem_bytes(int ns, int S, int D) {
  return (size_t)padded_rows(ns, S) * (3 * (D + 1) + 3 * D + 1) *
         sizeof(float);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * x * x * x))));
}

// LayerNorm of `rows` rows of X into Y, one warp per row, two-pass variance.
__device__ void layernorm(const float* X, float* Y, int rows, int D, int ld,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_d = 1.f / (float)D;
  for (int r = warp; r < rows; r += kWarps) {
    const float* x = X + r * ld;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mean = shifu::warp_sum(s) * inv_d;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = x[c] - mean;
      sq = fmaf(t, t, sq);
    }
    const float rstd = rsqrtf(shifu::warp_sum(sq) * inv_d + kLnEps);
    for (int c = lane; c < D; c += 32)
      Y[r * ld + c] = (x[c] - mean) * rstd * scale[c] + bias[c];
  }
}

// Out[r][n] <- epilogue(sum_k A[r][k] * W[k][n]) for r < rows, n < N.
// A is in shared memory (stride lda); W is row-major in device memory
// (stride ldw).  A warp owns an 8-row x 64-column tile.
template <int EPI>
__device__ void matmul(const float* A, int lda, int rows, int K,
                       const float* __restrict__ W, int ldw, int N,
                       const float* __restrict__ bias, float* Out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_col_groups = (N + 63) / 64;
  const int items = rows / kTileRows * n_col_groups;
  for (int item = warp; item < items; item += kWarps) {
    const int r0 = item / n_col_groups * kTileRows;
    const int c0 = item % n_col_groups * 64 + lane;
    const int c1 = c0 + 32;
    const bool ok0 = c0 < N, ok1 = c1 < N;
    float acc0[kTileRows], acc1[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) acc0[i] = acc1[i] = 0.f;
    const float* a = A + r0 * lda;
    for (int k = 0; k < K; ++k) {
      const float w0 = ok0 ? __ldg(W + (size_t)k * ldw + c0) : 0.f;
      const float w1 = ok1 ? __ldg(W + (size_t)k * ldw + c1) : 0.f;
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const float av = a[i * lda + k];
        acc0[i] = fmaf(av, w0, acc0[i]);
        acc1[i] = fmaf(av, w1, acc1[i]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half ? c1 : c0;
      if (!(half ? ok1 : ok0)) continue;
      const float b = (EPI == kSet || EPI == kAdd) ? 0.f : bias[c];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const float v = half ? acc1[i] : acc0[i];
        float* out = Out + (r0 + i) * ldo + c;
        if (EPI == kBias) *out = v + b;
        if (EPI == kGeluBias) *out = gelu_tanh(v + b);
        if (EPI == kAddBias) *out = *out + (v + b);
        if (EPI == kSet) *out = v;
        if (EPI == kAdd) *out = *out + v;
      }
    }
  }
}

// Per-head softmax attention of the ns samples' rows: q|k|v in Big (stride
// ldb), output into Y (stride ldd).  One thread per (row, head).
__device__ void attention(const float* Big, int ldb, float* Y, int ldd,
                          int ns, int S, int D, int H, float inv_sqrt_dh) {
  const int dh = D / H;
  const int items = ns * S * H;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int h = it % H;
    const int row = it / H;
    const int first = row / S * S;  // the sample's first token row
    const float* qp = Big + row * ldb + h * dh;
    const float* kp = Big + first * ldb + D + h * dh;
    const float* vp = Big + first * ldb + 2 * D + h * dh;
    float m = -INFINITY;
    for (int j = 0; j < S; ++j) {
      float s = 0.f;
      for (int d = 0; d < dh; ++d)
        s = fmaf(qp[d] * inv_sqrt_dh, kp[j * ldb + d], s);
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int d0 = 0; d0 < dh; d0 += 16) {
      float acc[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = 0.f;
      for (int j = 0; j < S; ++j) {
        float s = 0.f;
        for (int d = 0; d < dh; ++d)
          s = fmaf(qp[d] * inv_sqrt_dh, kp[j * ldb + d], s);
        const float p = expf(s - m);
        if (d0 == 0) l += p;
#pragma unroll
        for (int c = 0; c < 16; ++c)
          if (d0 + c < dh) acc[c] = fmaf(p, vp[j * ldb + d0 + c], acc[c]);
      }
      const float inv_l = 1.f / l;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (d0 + c < dh) Y[row * ldd + h * dh + d0 + c] = acc[c] * inv_l;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ft_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                    Params p, int B, int S, int D, int H, int R, int NS,
                    float inv_sqrt_dh) {
  extern __shared__ float smem[];
  const int rows = padded_rows(NS, S);
  const int ldd = D + 1, ldb = 3 * D + 1;
  float* X = smem;
  float* Y = X + rows * ldd;
  float* O = Y + rows * ldd;
  float* Big = O + rows * ldd;

  const int b0 = blockIdx.x * NS;
  const int ns = min(NS, B - b0);
  const int m = ns * S;  // real token rows of this block
  const float* xin = x + (size_t)b0 * S * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    X[r * ldd + c] = r < m ? xin[i] : 0.f;  // pad rows stay finite
  }
  __syncthreads();

  // attention half
  layernorm(X, Y, rows, D, ldd, p.ln_attn_scale, p.ln_attn_bias);
  __syncthreads();
  matmul<kBias>(Y, ldd, rows, D, p.qkv_kernel, 3 * D, 3 * D, p.qkv_bias, Big,
                ldb);
  __syncthreads();
  attention(Big, ldb, Y, ldd, ns, S, D, H, inv_sqrt_dh);
  __syncthreads();
  matmul<kAddBias>(Y, ldd, rows, D, p.proj_kernel, D, D, p.proj_bias, X, ldd);
  __syncthreads();

  // FFN half, hidden layer in chunks of at most 3D columns
  layernorm(X, Y, rows, D, ldd, p.ln_mlp_scale, p.ln_mlp_bias);
  __syncthreads();
  const int hidden = R * D;
  const int chunk = min(hidden, 3 * D);
  for (int c = 0; c < hidden; c += chunk) {
    const int cw = min(chunk, hidden - c);
    matmul<kGeluBias>(Y, ldd, rows, D, p.mlp_in_kernel + c, hidden, cw,
                      p.mlp_in_bias + c, Big, ldb);
    __syncthreads();
    if (c == 0)
      matmul<kSet>(Big, ldb, rows, cw, p.mlp_out_kernel, D, D, nullptr, O,
                   ldd);
    else
      matmul<kAdd>(Big, ldb, rows, cw, p.mlp_out_kernel + (size_t)c * D, D, D,
                   nullptr, O, ldd);
    __syncthreads();
  }

  float* o = out + (size_t)b0 * S * D;
  for (int i = threadIdx.x; i < m * D; i += kThreads) {
    const int r = i / D, c = i % D;
    o[i] = X[r * ldd + c] + (O[r * ldd + c] + p.mlp_out_bias[c]);
  }
}

int samples_per_block(int B, int S, int D) {
  int ns = 1;
  while (ns < kMaxSamples && ns < B &&
         smem_bytes(ns + 1, S, D) <= (size_t)kTargetSmem)
    ++ns;
  return ns;
}

}  // namespace

extern "C" {

// x, out: (B, S, D) f32, contiguous, on the device.  params: the 12 f32
// tensors in shifu_tpu's _PARAM_ORDER.  Launches on `stream` and does not
// synchronise.  Returns the CUDA error code (0 = cudaSuccess).
int ft_block_fwd(const void* x, void* out, const void* const* params, int B,
                 int S, int D, int H, int R, float inv_sqrt_dh,
                 void* stream) {
  if (B < 0 || S < 1 || S > kMaxS || D < 1 || D > kMaxD || R < 1 ||
      R > kMaxR || H < 1 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int ns = samples_per_block(B, S, D);
  const size_t smem = smem_bytes(ns, S, D);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  static size_t smem_set = 0;  // the attribute only ever grows
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ft_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = kMaxSmem;
  }
  const float* const* f = reinterpret_cast<const float* const*>(params);
  Params p{f[0], f[1], f[2], f[3], f[4], f[5],
           f[6], f[7], f[8], f[9], f[10], f[11]};
  const unsigned blocks = (unsigned)((B + ns - 1) / ns);
  ft_block_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p, B, S, D, H,
      R, ns, inv_sqrt_dh);
  return (int)cudaGetLastError();
}

const char* ft_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
