// shifu_scorer — native CPU scoring engine for exported shifu_tpu artifacts.
//
// The port's own copy of the JAX package's scorer source, built by g++ at
// first use (shifu_tpu_torch/runtime/nativelib.py); host code, no CUDA.
// Both packages pack the same `model.bin` and score it alike.
//
// This is the framework's authored native-code component, replacing the
// reference's use of the TensorFlow 1.4 C++ runtime over JNI
// (reference: shifu-tensorflow-eval/pom.xml:59-73 libtensorflow_jni, loaded
// by TensorflowModel.java:169 SavedModelBundle.load).  Where the reference
// dragged in a full TF runtime, this is a dependency-free C ABI library
// (no runtime deps beyond libm) that executes the artifact's op-list program
// (export/program.py format v2) over named buffers, covering the full model
// ladder — MLP, Wide&Deep, DeepFM, multi-task, FT-Transformer — and matching
// the numpy interpreter (export/scorer.py run_program) to float32 roundoff.
//
// Model file format ("model.bin", little-endian, packed by
// shifu_tpu_torch/runtime/native_scorer.py:pack_native):
//   magic   u32 = 0x55464853 ("SHFU")
//   version u32 = 3
//   num_features u32, num_heads u32, num_buffers u32, num_ops u32
//   per op: opcode u32, dst u32, src u32 (0xFFFFFFFF if unused), then
//   op-specific fields/weights (see readers below).  Buffer 0 is the input.
//
// C ABI (bind from Java via JNA/JNI, from Python via ctypes):
//   shifu_scorer_load / _free / _num_features / _num_heads /
//   shifu_scorer_compute_batch (float rows) / shifu_scorer_compute (double row)

#include "shifu_scorer.h"  // public C ABI: mismatches fail at compile time

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t kMagic = 0x55464853u;  // "SHFU"
constexpr uint32_t kVersion = 3;  // v3: + kConstant extra-input ops
constexpr uint32_t kNoBuf = 0xFFFFFFFFu;
constexpr float kLeakyAlpha = 0.2f;  // TF 1.4 leaky_relu default (parity)
constexpr float kLnEps = 1e-6f;      // flax nn.LayerNorm default

enum Activation : uint32_t {
  kLinear = 0,
  kSigmoid = 1,
  kTanh = 2,
  kRelu = 3,
  kLeakyRelu = 4,
  kGelu = 5,     // tanh approximation (flax nn.gelu default)
  kSoftmax = 6,  // rowwise over the last axis; kActivation only (moe gate)
};

enum OpCode : uint32_t {
  kDense = 0,
  kGatherCols = 1,
  kEmbedLookup = 2,
  kNumericEmbed = 3,
  kConcat = 4,
  kFlatten = 5,
  kSumFields = 6,
  kAdd = 7,
  kFmPair = 8,
  kActivation = 9,
  kClsPrepend = 10,
  kLayerNorm = 11,
  kSelectToken = 12,
  kTransformerBlock = 13,
  kExpertDense = 14,   // per-expert dense over stacked (E, I, O) kernels
  kMoeCombine = 15,    // gate-weighted expert combination
  kConstant = 16,      // sidecar extra-input constant, broadcast per row
                       // (TensorflowModel.java:74-87 feeds inputNames[1:]
                       // from GenericModelConfig properties)
};

struct Op {
  uint32_t code = 0;
  uint32_t dst = 0;
  uint32_t src = kNoBuf;
  uint32_t act = 0;          // dense / activation
  uint32_t a = 0, b = 0, c = 0;  // op-specific dims (in/out, fields/dim, ...)
  std::vector<uint32_t> idx;     // positions / vocabs / src lists
  std::vector<float> w0, w1;     // kernel/bias, weight/bias, scale/bias, token
  std::vector<float> tw[12];     // transformer block weights (fixed order)
};

// Static per-buffer shape (batch dim implicit): rank 2 => (B, d1),
// rank 3 => (B, d1, d2).
struct Shape {
  uint32_t rank = 0;
  uint32_t d1 = 0;
  uint32_t d2 = 0;
  size_t per_row() const { return rank == 3 ? size_t(d1) * d2 : d1; }
};

struct Model {
  uint32_t num_features = 0;
  uint32_t num_heads = 0;
  std::vector<Op> ops;
  std::vector<Shape> shapes;  // per buffer, inferred at load
};

bool read_u32(FILE* f, uint32_t* out) {
  return std::fread(out, sizeof(uint32_t), 1, f) == 1;
}

// Hard cap on any single array read from an untrusted model.bin (256M
// elements = 1GB of floats) — rejects length fields that a corrupt or
// malicious file inflated, before any allocation happens.
constexpr uint64_t kMaxArrayElems = uint64_t(1) << 28;

bool read_f32s(FILE* f, std::vector<float>* out, uint64_t n) {
  if (n > kMaxArrayElems) return false;
  out->resize(n);
  return std::fread(out->data(), sizeof(float), n, f) == n;
}

bool read_u32s(FILE* f, std::vector<uint32_t>* out, uint64_t n) {
  if (n > kMaxArrayElems) return false;
  out->resize(n);
  return std::fread(out->data(), sizeof(uint32_t), n, f) == n;
}

float apply_act(uint32_t act, float x) {
  switch (act) {
    case kSigmoid:
      // stable piecewise sigmoid, same formulation as the python scorer
      if (x >= 0.0f) return 1.0f / (1.0f + std::exp(-x));
      { float e = std::exp(x); return e / (1.0f + e); }
    case kTanh: return std::tanh(x);
    case kRelu: return x > 0.0f ? x : 0.0f;
    case kLeakyRelu: return x >= 0.0f ? x : kLeakyAlpha * x;
    case kGelu: {
      const float kC = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.0f + std::tanh(kC * (x + 0.044715f * x * x * x)));
    }
    default: return x;
  }
}

// Elementwise activation over a buffer with the switch hoisted out of the
// loop: the common cases (relu / leaky_relu) become branch-free vector
// loops instead of a per-element switch dispatch.  Deliberately NOT
// restrict-qualified: the kDense path calls it in place (dst == src).
void apply_act_rows(uint32_t act, const float* src, float* dst, size_t n) {
  switch (act) {
    case kRelu:
      for (size_t i = 0; i < n; ++i) dst[i] = src[i] > 0.0f ? src[i] : 0.0f;
      break;
    case kLeakyRelu:
      for (size_t i = 0; i < n; ++i)
        dst[i] = src[i] >= 0.0f ? src[i] : kLeakyAlpha * src[i];
      break;
    case kLinear:
      if (dst != src) std::memcpy(dst, src, n * sizeof(float));
      break;
    default:
      for (size_t i = 0; i < n; ++i) dst[i] = apply_act(act, src[i]);
  }
}

// Scalar remainder path shared by every kernel below: one row at a time,
// sequential over k — the summation-order reference all tiles match.
void matmul_bias_rows(const float* __restrict x, const float* __restrict w,
                      const float* __restrict bias, float* __restrict y,
                      size_t m, size_t k, size_t n) {
  for (size_t i = 0; i < m; ++i) {
    const float* row = x + i * k;
    float* dst = y + i * n;
    if (bias) std::memcpy(dst, bias, n * sizeof(float));
    else std::memset(dst, 0, n * sizeof(float));
    for (size_t j = 0; j < k; ++j) {
      const float v = row[j];
      const float* wrow = w + j * n;
      for (size_t o = 0; o < n; ++o) dst[o] += v * wrow[o];
    }
  }
}

#if defined(__AVX512F__)
// y[m][n] = x[m][k] @ w[k][n] + bias[n] — explicit-intrinsics microkernel.
// A 6-row x 32-col accumulator tile lives in 12 zmm registers across the
// whole k-loop (6 broadcasts + 2 vector loads + 12 FMAs per k step); the
// autovectorized formulation of the same tile spills its accumulator arrays
// and measures 2.7x slower on the reference host (34 vs 92 GFLOP/s on the
// 3x100 MLP op-list).  Summation per output element stays sequential over
// k, matching matmul_bias_rows (FMA contraction aside, which the portable
// build also applies under -ffp-contract).
void matmul_bias(const float* __restrict x, const float* __restrict w,
                 const float* __restrict bias, float* __restrict y,
                 size_t m, size_t k, size_t n) {
  constexpr size_t MR = 6;
  size_t i = 0;
  for (; i + MR <= m; i += MR) {
    const float* r[MR];
    for (size_t q = 0; q < MR; ++q) r[q] = x + (i + q) * k;
    size_t o = 0;
    for (; o + 32 <= n; o += 32) {
      __m512 acc0[MR], acc1[MR];
      const __m512 b0 = bias ? _mm512_loadu_ps(bias + o) : _mm512_setzero_ps();
      const __m512 b1 = bias ? _mm512_loadu_ps(bias + o + 16)
                             : _mm512_setzero_ps();
      for (size_t q = 0; q < MR; ++q) { acc0[q] = b0; acc1[q] = b1; }
      for (size_t j = 0; j < k; ++j) {
        const float* wrow = w + j * n + o;
        const __m512 w0 = _mm512_loadu_ps(wrow);
        const __m512 w1 = _mm512_loadu_ps(wrow + 16);
        for (size_t q = 0; q < MR; ++q) {
          const __m512 v = _mm512_set1_ps(r[q][j]);
          acc0[q] = _mm512_fmadd_ps(v, w0, acc0[q]);
          acc1[q] = _mm512_fmadd_ps(v, w1, acc1[q]);
        }
      }
      for (size_t q = 0; q < MR; ++q) {
        _mm512_storeu_ps(y + (i + q) * n + o, acc0[q]);
        _mm512_storeu_ps(y + (i + q) * n + o + 16, acc1[q]);
      }
    }
    for (; o < n; o += 16) {  // n tail: masked 16-wide columns
      const size_t nb = n - o < 16 ? n - o : 16;
      const __mmask16 msk = (__mmask16)((1u << nb) - 1u);
      const __m512 bz = bias ? _mm512_maskz_loadu_ps(msk, bias + o)
                             : _mm512_setzero_ps();
      __m512 acc[MR];
      for (size_t q = 0; q < MR; ++q) acc[q] = bz;
      for (size_t j = 0; j < k; ++j) {
        const __m512 wv = _mm512_maskz_loadu_ps(msk, w + j * n + o);
        for (size_t q = 0; q < MR; ++q)
          acc[q] = _mm512_fmadd_ps(_mm512_set1_ps(r[q][j]), wv, acc[q]);
      }
      for (size_t q = 0; q < MR; ++q)
        _mm512_mask_storeu_ps(y + (i + q) * n + o, msk, acc[q]);
    }
  }
  if (i < m) matmul_bias_rows(x + i * k, w, bias, y + i * n, m - i, k, n);
}

#elif defined(__AVX2__) && defined(__FMA__)
// AVX2 spelling of the same 6x16 idea (12 ymm accumulators).
void matmul_bias(const float* __restrict x, const float* __restrict w,
                 const float* __restrict bias, float* __restrict y,
                 size_t m, size_t k, size_t n) {
  constexpr size_t MR = 6;
  size_t i = 0;
  for (; i + MR <= m; i += MR) {
    const float* r[MR];
    for (size_t q = 0; q < MR; ++q) r[q] = x + (i + q) * k;
    size_t o = 0;
    for (; o + 16 <= n; o += 16) {
      __m256 acc0[MR], acc1[MR];
      const __m256 b0 = bias ? _mm256_loadu_ps(bias + o) : _mm256_setzero_ps();
      const __m256 b1 = bias ? _mm256_loadu_ps(bias + o + 8)
                             : _mm256_setzero_ps();
      for (size_t q = 0; q < MR; ++q) { acc0[q] = b0; acc1[q] = b1; }
      for (size_t j = 0; j < k; ++j) {
        const float* wrow = w + j * n + o;
        const __m256 w0 = _mm256_loadu_ps(wrow);
        const __m256 w1 = _mm256_loadu_ps(wrow + 8);
        for (size_t q = 0; q < MR; ++q) {
          const __m256 v = _mm256_set1_ps(r[q][j]);
          acc0[q] = _mm256_fmadd_ps(v, w0, acc0[q]);
          acc1[q] = _mm256_fmadd_ps(v, w1, acc1[q]);
        }
      }
      for (size_t q = 0; q < MR; ++q) {
        _mm256_storeu_ps(y + (i + q) * n + o, acc0[q]);
        _mm256_storeu_ps(y + (i + q) * n + o + 8, acc1[q]);
      }
    }
    if (o < n) {  // n tail: scalar columns, same k order
      for (size_t q = 0; q < MR; ++q) {
        float* dst = y + (i + q) * n;
        for (size_t c = o; c < n; ++c) dst[c] = bias ? bias[c] : 0.0f;
        for (size_t j = 0; j < k; ++j) {
          const float v = r[q][j];
          const float* wrow = w + j * n;
          for (size_t c = o; c < n; ++c) dst[c] += v * wrow[c];
        }
      }
    }
  }
  if (i < m) matmul_bias_rows(x + i * k, w, bias, y + i * n, m - i, k, n);
}

#else
// Portable register-blocked kernel (no SIMD intrinsics available): a
// 6-row x 32-col accumulator tile the autovectorizer maps onto whatever
// vector unit exists.  Summation order per output element is sequential
// over k, matching matmul_bias_rows.
void matmul_bias(const float* __restrict x, const float* __restrict w,
                 const float* __restrict bias, float* __restrict y,
                 size_t m, size_t k, size_t n) {
  constexpr size_t MR = 6, NR = 32;
  size_t i = 0;
  for (; i + MR <= m; i += MR) {
    const float* r0 = x + (i + 0) * k;
    const float* r1 = x + (i + 1) * k;
    const float* r2 = x + (i + 2) * k;
    const float* r3 = x + (i + 3) * k;
    const float* r4 = x + (i + 4) * k;
    const float* r5 = x + (i + 5) * k;
    for (size_t o = 0; o < n; o += NR) {
      const size_t nb = n - o < NR ? n - o : NR;
      float a0[NR], a1[NR], a2[NR], a3[NR], a4[NR], a5[NR];
      for (size_t c = 0; c < NR; ++c) {
        const float bv = (bias && c < nb) ? bias[o + c] : 0.0f;
        a0[c] = bv; a1[c] = bv; a2[c] = bv;
        a3[c] = bv; a4[c] = bv; a5[c] = bv;
      }
      if (nb == NR) {  // full tile: constant trip counts vectorize cleanly
        for (size_t j = 0; j < k; ++j) {
          const float* wrow = w + j * n + o;
          const float v0 = r0[j], v1 = r1[j], v2 = r2[j];
          const float v3 = r3[j], v4 = r4[j], v5 = r5[j];
          for (size_t c = 0; c < NR; ++c) {
            const float wv = wrow[c];
            a0[c] += v0 * wv; a1[c] += v1 * wv; a2[c] += v2 * wv;
            a3[c] += v3 * wv; a4[c] += v4 * wv; a5[c] += v5 * wv;
          }
        }
      } else {
        for (size_t j = 0; j < k; ++j) {
          const float* wrow = w + j * n + o;
          const float v0 = r0[j], v1 = r1[j], v2 = r2[j];
          const float v3 = r3[j], v4 = r4[j], v5 = r5[j];
          for (size_t c = 0; c < nb; ++c) {
            const float wv = wrow[c];
            a0[c] += v0 * wv; a1[c] += v1 * wv; a2[c] += v2 * wv;
            a3[c] += v3 * wv; a4[c] += v4 * wv; a5[c] += v5 * wv;
          }
        }
      }
      const float* ab[MR] = {a0, a1, a2, a3, a4, a5};
      for (size_t r = 0; r < MR; ++r)
        std::memcpy(y + (i + r) * n + o, ab[r], nb * sizeof(float));
    }
  }
  if (i < m) matmul_bias_rows(x + i * k, w, bias, y + i * n, m - i, k, n);
}
#endif  // matmul_bias SIMD dispatch

void layernorm_rows(const float* x, const float* scale, const float* bias,
                    float* y, size_t rows, size_t d) {
  for (size_t r = 0; r < rows; ++r) {
    const float* src = x + r * d;
    float* dst = y + r * d;
    float mean = 0.0f;
    for (size_t i = 0; i < d; ++i) mean += src[i];
    mean /= d;
    float var = 0.0f;
    for (size_t i = 0; i < d; ++i) {
      const float c = src[i] - mean;
      var += c * c;
    }
    var /= d;
    const float inv = 1.0f / std::sqrt(var + kLnEps);
    for (size_t i = 0; i < d; ++i)
      dst[i] = (src[i] - mean) * inv * scale[i] + bias[i];
  }
}

void softmax_row(float* row, size_t n) {
  float m = row[0];
  for (size_t i = 1; i < n; ++i) m = row[i] > m ? row[i] : m;
  float sum = 0.0f;
  for (size_t i = 0; i < n; ++i) {
    row[i] = std::exp(row[i] - m);
    sum += row[i];
  }
  const float inv = 1.0f / sum;
  for (size_t i = 0; i < n; ++i) row[i] *= inv;
}

// ---------------------------------------------------------------------------
// load: parse ops and infer every buffer's static shape so compute is
// allocation-plan-free.

bool infer_shapes(Model* m) {
  auto& s = m->shapes;
  s[0] = {2, m->num_features, 0};
  // SSA discipline: every buffer is written exactly once and only read after
  // it is defined — exec_program sizes buffers from these final shapes, so
  // redefinition would let a crafted file write past an allocation.
  std::vector<bool> defined(s.size(), false);
  defined[0] = true;
  for (const Op& op : m->ops) {
    if (op.dst == 0 || defined[op.dst]) return false;
    if (op.src != kNoBuf && !defined[op.src]) return false;
    if (op.code == kConcat || op.code == kAdd || op.code == kMoeCombine)
      for (uint32_t sb : op.idx)
        if (sb >= s.size() || !defined[sb]) return false;
    defined[op.dst] = true;
    const Shape in = op.src != kNoBuf ? s[op.src] : Shape{};
    Shape out{};
    switch (op.code) {
      case kDense:
        if (in.rank != 2 || in.d1 != op.a) return false;
        out = {2, op.b, 0};
        break;
      case kGatherCols:
        if (in.rank != 2) return false;
        for (uint32_t p : op.idx)
          if (p >= in.d1) return false;  // column index out of range
        out = {2, static_cast<uint32_t>(op.idx.size()), 0};
        break;
      case kEmbedLookup:
        if (in.rank != 2 || op.idx.size() != size_t(op.a) * 2) return false;
        for (uint32_t fidx = 0; fidx < op.a; ++fidx) {
          if (op.idx[fidx] >= in.d1) return false;         // position range
          const uint32_t vocab = op.idx[op.a + fidx];
          if (vocab < 1 || vocab > op.b) return false;     // 1 <= vocab <= maxv
        }
        out = {3, op.a, op.c};  // (fields, dim)
        break;
      case kNumericEmbed:
        if (in.rank != 2 || in.d1 != op.a) return false;
        out = {3, op.a, op.b};
        break;
      case kConcat: {
        if (op.idx.empty()) return false;
        const Shape first = s[op.idx[0]];
        uint64_t total = 0;  // u64 + cap: u32 accumulation could wrap to a
        for (uint32_t b : op.idx) {  // tiny alloc that exec then overflows
          if (s[b].rank != first.rank || s[b].d2 != first.d2) return false;
          total += s[b].d1;
        }
        if (total > kMaxArrayElems) return false;
        out = {first.rank, static_cast<uint32_t>(total), first.d2};
        break;
      }
      case kFlatten: {
        if (in.rank != 3) return false;
        const uint64_t flat = uint64_t(in.d1) * in.d2;  // u32 mul could wrap
        if (flat > kMaxArrayElems) return false;
        out = {2, static_cast<uint32_t>(flat), 0};
        break;
      }
      case kSumFields:
        if (in.rank != 3) return false;
        out = {2, in.d2, 0};
        break;
      case kAdd: {
        if (op.idx.empty()) return false;
        uint32_t d1 = 0;
        for (uint32_t b : op.idx) {
          if (s[b].rank != 2) return false;
          d1 = s[b].d1 > d1 ? s[b].d1 : d1;
        }
        for (uint32_t b : op.idx)
          if (s[b].d1 != d1 && s[b].d1 != 1) return false;  // (B,1) broadcast
        out = {2, d1, 0};
        break;
      }
      case kFmPair:
        if (in.rank != 3) return false;
        out = {2, 1, 0};
        break;
      case kActivation:
        out = in;
        break;
      case kClsPrepend:
        if (in.rank != 3 || in.d2 != op.a) return false;
        out = {3, in.d1 + 1, in.d2};
        break;
      case kLayerNorm:
        if (in.per_row() == 0 ||
            (in.rank == 2 ? in.d1 : in.d2) != op.a) return false;
        out = in;
        break;
      case kSelectToken:
        if (in.rank != 3 || op.a >= in.d1) return false;
        out = {2, in.d2, 0};
        break;
      case kTransformerBlock:
        if (in.rank != 3 || in.d2 != op.a) return false;
        if (op.b < 1 || op.a % op.b != 0) return false;  // heads must divide d
        out = in;
        break;
      case kExpertDense:
        // a=experts, b=in, c=out; rank-2 input broadcasts to every expert
        if (in.rank == 2) {
          if (in.d1 != op.b) return false;
        } else if (in.rank == 3) {
          if (in.d1 != op.a || in.d2 != op.b) return false;
        } else {
          return false;
        }
        out = {3, op.a, op.c};
        break;
      case kMoeCombine: {
        if (op.idx.size() != 2) return false;
        const Shape h = s[op.idx[0]], g = s[op.idx[1]];
        if (h.rank != 3 || g.rank != 2 || g.d1 != h.d1) return false;
        out = {2, h.d2, 0};
        break;
      }
      case kConstant:
        if (op.src != kNoBuf || op.a == 0 ||
            op.w0.size() != op.a) return false;
        out = {2, op.a, 0};
        break;
      default:
        return false;
    }
    // universal allocation bound: no buffer's per-row element count may
    // exceed the cap, whatever op produced it (rank-3 concat could pass a
    // d1-only check while d1*d2 overflows downstream resizes)
    if (uint64_t(out.d1) * (out.rank == 3 ? out.d2 : 1) > kMaxArrayElems)
      return false;
    s[op.dst] = out;
  }
  return true;
}

bool read_op(FILE* f, Op* op) {
  if (!(read_u32(f, &op->code) && read_u32(f, &op->dst) &&
        read_u32(f, &op->src)))
    return false;
  switch (op->code) {
    case kDense:
      // act bounded to elementwise fns (softmax is kActivation-only)
      return read_u32(f, &op->act) && op->act <= kGelu &&
             read_u32(f, &op->a) && read_u32(f, &op->b) &&
             read_f32s(f, &op->w0, uint64_t(op->a) * op->b) &&
             read_f32s(f, &op->w1, op->b);
    case kGatherCols: {
      uint32_t n = 0;
      return read_u32(f, &n) && read_u32s(f, &op->idx, n);
    }
    case kEmbedLookup: {
      // a=fields, b=max_vocab, c=dim; idx = positions ++ vocabs
      if (!(read_u32(f, &op->a) && read_u32(f, &op->b) && read_u32(f, &op->c)))
        return false;
      // staged overflow-safe product check (u32 operands, untrusted)
      if (op->a > kMaxArrayElems || op->b > kMaxArrayElems ||
          op->c > kMaxArrayElems)
        return false;
      const uint64_t rows = uint64_t(op->a) * op->b;
      if (rows > kMaxArrayElems || rows * op->c > kMaxArrayElems) return false;
      return read_u32s(f, &op->idx, uint64_t(op->a) * 2) &&
             read_f32s(f, &op->w0, rows * op->c);
    }
    case kNumericEmbed:
      // a=fields, b=dim
      return read_u32(f, &op->a) && read_u32(f, &op->b) &&
             read_f32s(f, &op->w0, uint64_t(op->a) * op->b) &&
             read_f32s(f, &op->w1, uint64_t(op->a) * op->b);
    case kConcat:
    case kAdd: {
      uint32_t n = 0;
      return read_u32(f, &n) && read_u32s(f, &op->idx, n);
    }
    case kFlatten:
    case kSumFields:
    case kFmPair:
      return true;
    case kActivation:
      return read_u32(f, &op->act) && op->act <= kSoftmax;
    case kClsPrepend:
      // a=dim
      return read_u32(f, &op->a) && read_f32s(f, &op->w0, op->a);
    case kLayerNorm:
      // a=dim
      return read_u32(f, &op->a) && read_f32s(f, &op->w0, op->a) &&
             read_f32s(f, &op->w1, op->a);
    case kSelectToken:
      return read_u32(f, &op->a);
    case kTransformerBlock: {
      // a=d, b=heads, c=mlp_hidden; dims bounded so d*3*d etc. cannot wrap
      if (!(read_u32(f, &op->a) && read_u32(f, &op->b) && read_u32(f, &op->c)))
        return false;
      if (op->a == 0 || op->a > 65536 || op->c == 0 || op->c > 1 << 20)
        return false;
      const uint64_t d = op->a, mh = op->c;
      const uint64_t sizes[12] = {d,         d,      d * 3 * d, 3 * d,
                                  d * d,     d,      d,         d,
                                  d * mh,    mh,     mh * d,    d};
      for (int i = 0; i < 12; ++i)
        if (!read_f32s(f, &op->tw[i], sizes[i])) return false;
      return true;
    }
    case kExpertDense: {
      // act; a=experts, b=in, c=out — staged overflow-safe product checks
      if (!(read_u32(f, &op->act) && op->act <= kGelu &&
            read_u32(f, &op->a) && read_u32(f, &op->b) &&
            read_u32(f, &op->c)))
        return false;
      if (op->a == 0 || op->a > 65536 || op->b > kMaxArrayElems ||
          op->c > kMaxArrayElems)
        return false;
      const uint64_t ein = uint64_t(op->a) * op->b;
      if (ein > kMaxArrayElems || ein * op->c > kMaxArrayElems) return false;
      return read_f32s(f, &op->w0, ein * op->c) &&
             read_f32s(f, &op->w1, uint64_t(op->a) * op->c);
    }
    case kMoeCombine: {
      uint32_t n = 0;
      return read_u32(f, &n) && n == 2 && read_u32s(f, &op->idx, n);
    }
    case kConstant:
      // a=dim; w0 = the constant row
      return read_u32(f, &op->a) && op->a > 0 && op->a <= kMaxArrayElems &&
             read_f32s(f, &op->w0, op->a);
    default:
      return false;
  }
}

// ---------------------------------------------------------------------------
// execution

void exec_transformer_block(const Op& op, const float* x, float* out,
                            size_t batch, size_t s) {
  const size_t d = op.a, heads = op.b, mh = op.c, dh = d / heads;
  const float scale = 1.0f / std::sqrt(static_cast<float>(dh));
  const size_t rows = batch * s;
  std::vector<float> y(rows * d), qkv(rows * 3 * d), attn(rows * d);
  std::vector<float> scores(s * s), mlp(rows * mh);

  // pre-LN attention
  layernorm_rows(x, op.tw[0].data(), op.tw[1].data(), y.data(), rows, d);
  matmul_bias(y.data(), op.tw[2].data(), op.tw[3].data(), qkv.data(), rows, d,
              3 * d);
  // per (batch, head): scores = q k^T * scale; softmax; ctx = scores @ v
  for (size_t bi = 0; bi < batch; ++bi) {
    const float* q0 = qkv.data() + bi * s * 3 * d;
    for (size_t h = 0; h < heads; ++h) {
      const size_t qo = h * dh, ko = d + h * dh, vo = 2 * d + h * dh;
      for (size_t i = 0; i < s; ++i) {
        const float* qi = q0 + i * 3 * d + qo;
        float* srow = scores.data() + i * s;
        for (size_t j = 0; j < s; ++j) {
          const float* kj = q0 + j * 3 * d + ko;
          float acc = 0.0f;
          for (size_t t = 0; t < dh; ++t) acc += qi[t] * kj[t];
          srow[j] = acc * scale;
        }
        softmax_row(srow, s);
        float* ctx = attn.data() + (bi * s + i) * d + h * dh;
        std::memset(ctx, 0, dh * sizeof(float));
        for (size_t j = 0; j < s; ++j) {
          const float wij = srow[j];
          const float* vj = q0 + j * 3 * d + vo;
          for (size_t t = 0; t < dh; ++t) ctx[t] += wij * vj[t];
        }
      }
    }
  }
  // proj + residual
  matmul_bias(attn.data(), op.tw[4].data(), op.tw[5].data(), y.data(), rows, d,
              d);
  for (size_t i = 0; i < rows * d; ++i) out[i] = x[i] + y[i];

  // pre-LN MLP + residual
  layernorm_rows(out, op.tw[6].data(), op.tw[7].data(), y.data(), rows, d);
  matmul_bias(y.data(), op.tw[8].data(), op.tw[9].data(), mlp.data(), rows, d,
              mh);
  for (size_t i = 0; i < rows * mh; ++i) mlp[i] = apply_act(kGelu, mlp[i]);
  matmul_bias(mlp.data(), op.tw[10].data(), op.tw[11].data(), y.data(), rows,
              mh, d);
  for (size_t i = 0; i < rows * d; ++i) out[i] += y[i];
}

// Reusable intermediate-buffer arenas, shared across calls and across the
// short-lived worker threads of compute_batch (a thread_local would die
// with each worker and re-pay its page faults every call).  Retention is
// bounded: at most kMaxFree arenas are kept, and any arena past
// kMaxRetainFloats is dropped on release so one huge batch doesn't pin
// hundreds of MB for the process lifetime.
class ArenaPool {
 public:
  std::vector<float> acquire() {
    std::lock_guard<std::mutex> g(mu_);
    if (free_.empty()) return {};
    std::vector<float> a = std::move(free_.back());
    free_.pop_back();
    return a;
  }
  void release(std::vector<float>&& a) {
    std::lock_guard<std::mutex> g(mu_);
    if (free_.size() < kMaxFree && a.capacity() <= kMaxRetainFloats)
      free_.push_back(std::move(a));
  }

 private:
  static constexpr size_t kMaxFree = 16;
  static constexpr size_t kMaxRetainFloats = (size_t(64) << 20) / sizeof(float);
  std::mutex mu_;
  std::vector<std::vector<float>> free_;
};

ArenaPool& arena_pool() {
  static ArenaPool* pool = new ArenaPool();  // never destroyed: safe at exit
  return *pool;
}

int exec_program(const Model& m, const float* rows, size_t batch, float* out) {
  // One pooled arena holds every intermediate buffer (offsets from the SSA
  // shape plan).  Fresh per-call vectors would mmap tens of MB of new pages
  // each batch and pay their page faults back every call — measured ~2x the
  // whole MLP scoring cost at batch 8192.
  const size_t nbuf = m.shapes.size();
  std::vector<size_t> buf_off(nbuf);
  size_t total = 0;
  for (size_t i = 0; i < nbuf; ++i) {
    buf_off[i] = total;
    total += batch * m.shapes[i].per_row();
  }
  std::vector<float> arena = arena_pool().acquire();
  if (arena.capacity() < total) arena = std::vector<float>();  // grow without
  if (arena.size() < total) arena.resize(total);  // copying stale contents
  struct ArenaReturner {
    std::vector<float>* a;
    ~ArenaReturner() { arena_pool().release(std::move(*a)); }
  } returner{&arena};
  float* const base = arena.data();
  const auto buf = [&](uint32_t i) { return base + buf_off[i]; };
  std::memcpy(buf(0), rows, batch * m.num_features * sizeof(float));
  uint32_t last = 0;
  for (const Op& op : m.ops) {
    const Shape& os = m.shapes[op.dst];
    float* const dst = buf(op.dst);
    const size_t dst_n = batch * os.per_row();
    const float* src = op.src != kNoBuf ? buf(op.src) : nullptr;
    const Shape in = op.src != kNoBuf ? m.shapes[op.src] : Shape{};
    switch (op.code) {
      case kDense:
        matmul_bias(src, op.w0.data(), op.w1.data(), dst, batch, op.a,
                    op.b);
        if (op.act != kLinear) apply_act_rows(op.act, dst, dst, dst_n);
        break;
      case kGatherCols:
        for (size_t b = 0; b < batch; ++b)
          for (size_t i = 0; i < op.idx.size(); ++i)
            dst[b * os.d1 + i] = src[b * in.d1 + op.idx[i]];
        break;
      case kEmbedLookup: {
        const uint32_t nf = op.a, maxv = op.b, dim = op.c;
        const uint32_t* pos = op.idx.data();
        const uint32_t* vocab = op.idx.data() + nf;
        for (size_t b = 0; b < batch; ++b) {
          for (uint32_t fidx = 0; fidx < nf; ++fidx) {
            // clamp in float BEFORE the int cast: float->int of NaN or
            // out-of-range values is UB and architecture-dependent, and the
            // numpy interpreter's astype+clip must be matched exactly
            const float raw = src[b * in.d1 + pos[fidx]];
            const int32_t hi = static_cast<int32_t>(vocab[fidx]) - 1;
            int32_t id;
            if (!(raw > 0.0f)) {  // NaN and <=0 land in bucket 0
              id = 0;
            } else if (raw >= static_cast<float>(vocab[fidx])) {
              id = hi;
            } else {
              id = static_cast<int32_t>(raw);
              if (id > hi) id = hi;
            }
            const float* trow =
                op.w0.data() + (size_t(fidx) * maxv + id) * dim;
            std::memcpy(dst + (b * nf + fidx) * dim, trow,
                        dim * sizeof(float));
          }
        }
        break;
      }
      case kNumericEmbed: {
        const uint32_t nf = op.a, dim = op.b;
        for (size_t b = 0; b < batch; ++b)
          for (uint32_t fidx = 0; fidx < nf; ++fidx) {
            const float v = src[b * in.d1 + fidx];
            float* drow = dst + (b * nf + fidx) * dim;
            const float* wrow = op.w0.data() + size_t(fidx) * dim;
            const float* brow = op.w1.data() + size_t(fidx) * dim;
            for (uint32_t t = 0; t < dim; ++t)
              drow[t] = v * wrow[t] + brow[t];
          }
        break;
      }
      case kConcat: {
        const size_t stride = os.per_row();
        for (size_t b = 0; b < batch; ++b) {
          size_t off = 0;
          for (uint32_t sb : op.idx) {
            const size_t n = m.shapes[sb].per_row();
            std::memcpy(dst + b * stride + off,
                        buf(sb) + b * n, n * sizeof(float));
            off += n;
          }
        }
        break;
      }
      case kFlatten:
      case kActivation:
        if (op.code == kFlatten) {
          std::memcpy(dst, src, dst_n * sizeof(float));
        } else if (op.act == kSoftmax) {
          // rowwise stable softmax over the last axis (moe gate)
          const size_t width = os.rank == 3 ? os.d2 : os.d1;
          if (width == 0) return 2;  // crafted zero-width buffer: clean error
          for (size_t r = 0; r < dst_n / width; ++r) {
            const float* xr = src + r * width;
            float* dr = dst + r * width;
            float mx = xr[0];
            for (size_t k = 1; k < width; ++k) mx = std::max(mx, xr[k]);
            float sum = 0.0f;
            for (size_t k = 0; k < width; ++k) {
              dr[k] = std::exp(xr[k] - mx);
              sum += dr[k];
            }
            const float inv = 1.0f / sum;
            for (size_t k = 0; k < width; ++k) dr[k] *= inv;
          }
        } else {
          apply_act_rows(op.act, src, dst, dst_n);
        }
        break;
      case kSumFields:
        for (size_t b = 0; b < batch; ++b) {
          float* drow = dst + b * in.d2;
          std::memset(drow, 0, in.d2 * sizeof(float));
          for (uint32_t fidx = 0; fidx < in.d1; ++fidx) {
            const float* srow = src + (b * in.d1 + fidx) * in.d2;
            for (uint32_t t = 0; t < in.d2; ++t) drow[t] += srow[t];
          }
        }
        break;
      case kAdd: {
        const size_t d1 = os.d1;
        std::memset(dst, 0, dst_n * sizeof(float));
        for (uint32_t sb : op.idx) {
          const Shape& ss = m.shapes[sb];
          const float* p = buf(sb);
          for (size_t b = 0; b < batch; ++b)
            for (size_t i = 0; i < d1; ++i)
              dst[b * d1 + i] += p[b * ss.d1 + (ss.d1 == 1 ? 0 : i)];
        }
        break;
      }
      case kFmPair:
        for (size_t b = 0; b < batch; ++b) {
          float acc = 0.0f;
          for (uint32_t t = 0; t < in.d2; ++t) {
            float sum = 0.0f, sq = 0.0f;
            for (uint32_t fidx = 0; fidx < in.d1; ++fidx) {
              const float v = src[(b * in.d1 + fidx) * in.d2 + t];
              sum += v;
              sq += v * v;
            }
            acc += sum * sum - sq;
          }
          dst[b] = 0.5f * acc;
        }
        break;
      case kClsPrepend:
        for (size_t b = 0; b < batch; ++b) {
          float* drow = dst + b * os.d1 * os.d2;
          std::memcpy(drow, op.w0.data(), os.d2 * sizeof(float));
          std::memcpy(drow + os.d2, src + b * in.d1 * in.d2,
                      size_t(in.d1) * in.d2 * sizeof(float));
        }
        break;
      case kLayerNorm: {
        const size_t d = op.a;
        layernorm_rows(src, op.w0.data(), op.w1.data(), dst,
                       batch * in.per_row() / d, d);
        break;
      }
      case kSelectToken:
        for (size_t b = 0; b < batch; ++b)
          std::memcpy(dst + b * in.d2,
                      src + (b * in.d1 + op.a) * in.d2,
                      in.d2 * sizeof(float));
        break;
      case kTransformerBlock:
        exec_transformer_block(op, src, dst, batch, in.d1);
        break;
      case kExpertDense: {
        // per-expert matmul over stacked (E, I, O) kernels; output laid out
        // (B, E, O).  Rank-2 input feeds every expert the same rows; rank-3
        // gathers each expert's strided rows into a contiguous block so the
        // register-blocked matmul_bias serves both cases.
        const size_t e = op.a, din = op.b, dout = op.c;
        std::vector<float> xin(in.rank == 3 ? batch * din : 0);
        std::vector<float> tmp(batch * dout);
        for (size_t ex = 0; ex < e; ++ex) {
          const float* wk = op.w0.data() + ex * din * dout;
          const float* wb = op.w1.data() + ex * dout;
          const float* xsrc = src;
          if (in.rank == 3) {
            for (size_t b = 0; b < batch; ++b)
              std::memcpy(&xin[b * din], src + (b * e + ex) * din,
                          din * sizeof(float));
            xsrc = xin.data();
          }
          matmul_bias(xsrc, wk, wb, tmp.data(), batch, din, dout);
          if (op.act != kLinear)
            apply_act_rows(op.act, tmp.data(), tmp.data(), batch * dout);
          for (size_t b = 0; b < batch; ++b)
            std::memcpy(dst + (b * e + ex) * dout, &tmp[b * dout],
                        dout * sizeof(float));
        }
        break;
      }
      case kMoeCombine: {
        const float* h = buf(op.idx[0]);
        const float* g = buf(op.idx[1]);
        const Shape& hs = m.shapes[op.idx[0]];
        const size_t e = hs.d1, hd = hs.d2;
        for (size_t b = 0; b < batch; ++b) {
          float* o = dst + b * hd;
          std::fill(o, o + hd, 0.0f);
          for (size_t ex = 0; ex < e; ++ex) {
            const float gv = g[b * e + ex];
            const float* hrow = h + (b * e + ex) * hd;
            for (size_t k = 0; k < hd; ++k) o[k] += gv * hrow[k];
          }
        }
        break;
      }
      case kConstant:
        for (size_t b = 0; b < batch; ++b)
          std::memcpy(dst + b * op.a, op.w0.data(), op.a * sizeof(float));
        break;
      default:
        return 2;
    }
    last = op.dst;
  }
  const Shape& fs = m.shapes[last];
  if (fs.rank != 2 || fs.d1 != m.num_heads) return 3;
  std::memcpy(out, buf(last),
              batch * m.num_heads * sizeof(float));
  return 0;
}

}  // namespace

extern "C" {

void* shifu_scorer_load(const char* path) try {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto model = new Model();
  uint32_t magic = 0, version = 0, num_bufs = 0, num_ops = 0;
  // caps on header counts from the untrusted file: real programs have tens
  // of ops/buffers; a corrupt count must reject cleanly, not value-
  // initialize a multi-GB vector (sizeof(Op) is ~400 B)
  constexpr uint32_t kMaxOps = 1u << 16, kMaxBufs = 1u << 16;
  bool ok = read_u32(f, &magic) && magic == kMagic &&
            read_u32(f, &version) && version == kVersion &&
            read_u32(f, &model->num_features) &&
            read_u32(f, &model->num_heads) && read_u32(f, &num_bufs) &&
            read_u32(f, &num_ops) && num_bufs >= 1 &&
            num_bufs <= kMaxBufs && num_ops <= kMaxOps;
  if (ok) {
    model->ops.resize(num_ops);
    model->shapes.resize(num_bufs);
    for (uint32_t i = 0; ok && i < num_ops; ++i) {
      ok = read_op(f, &model->ops[i]) && model->ops[i].dst < num_bufs &&
           (model->ops[i].src == kNoBuf || model->ops[i].src < num_bufs);
      if (ok)
        for (uint32_t sb : model->ops[i].idx)
          if ((model->ops[i].code == kConcat || model->ops[i].code == kAdd) &&
              sb >= num_bufs)
            ok = false;
    }
  }
  std::fclose(f);
  if (ok) ok = infer_shapes(model);
  if (!ok) {
    delete model;
    return nullptr;
  }
  return model;
} catch (...) {
  // no exception may cross the C ABI (JVM/ctypes hosts): corrupt files that
  // provoke bad_alloc etc. report as load failure, not process death
  return nullptr;
}

void shifu_scorer_free(void* handle) { delete static_cast<Model*>(handle); }

int shifu_scorer_num_features(void* handle) {
  return handle ? static_cast<int>(static_cast<Model*>(handle)->num_features) : -1;
}

int shifu_scorer_num_heads(void* handle) {
  return handle ? static_cast<int>(static_cast<Model*>(handle)->num_heads) : -1;
}

// rows: [n][num_features] float32; out: [n][num_heads]. Returns 0 on success.
// Every op in the program is row-independent, so large batches are split
// across threads (each chunk is a standalone exec_program with its own
// buffers) — per-row results are identical to the single-threaded path.
// SHIFU_SCORER_THREADS caps/pins the pool; single-core hosts and small
// batches stay on the calling thread.
int shifu_scorer_compute_batch(void* handle, const float* rows, int n,
                               float* out) try {
  if (!handle || !rows || !out || n <= 0) return 1;
  const Model& m = *static_cast<Model*>(handle);
  const size_t batch = static_cast<size_t>(n);
  constexpr size_t kMinRowsPerThread = 512;
  // Cache-resident row blocks: running the WHOLE op-list over a bounded
  // slice of rows keeps each op's activations (e.g. 1024x100 floats =
  // 400 KB) L2-resident instead of streaming multi-MB intermediates
  // through L3 between ops — measured ~20% on the 3x100 MLP at batch 8k.
  size_t block = 1024;
  if (const char* env = std::getenv("SHIFU_SCORER_CHUNK_ROWS")) {
    const long v = std::strtol(env, nullptr, 10);
    if (v >= 64 && v <= (1l << 20)) block = static_cast<size_t>(v);
  }
  size_t t = 0;
  if (const char* env = std::getenv("SHIFU_SCORER_THREADS")) {
    const long v = std::strtol(env, nullptr, 10);
    if (v >= 1 && v <= 1024) t = static_cast<size_t>(v);
  }
  if (t == 0) {
    const unsigned hw = std::thread::hardware_concurrency();
    t = hw ? hw : 1;
  }
  t = std::min(t, batch / kMinRowsPerThread);
  const auto run_span = [&](size_t lo, size_t hi) -> int {
    for (size_t b = lo; b < hi; b += block) {
      const size_t be = b + block < hi ? b + block : hi;
      const int rc = exec_program(m, rows + b * m.num_features, be - b,
                                  out + b * m.num_heads);
      if (rc != 0) return rc;
    }
    return 0;
  };
  if (t <= 1) return run_span(0, batch);
  std::vector<int> rc(t, 0);
  const auto run_chunk = [&](size_t c) noexcept {
    const size_t lo = batch * c / t, hi = batch * (c + 1) / t;
    try {
      rc[c] = run_span(lo, hi);
    } catch (...) {
      rc[c] = 4;  // never unwind across a thread boundary either
    }
  };
  // Chunk 0 runs on the calling thread.  Spawn failures (cgroup pid limit,
  // RLIMIT_NPROC) must not unwind while earlier threads are joinable —
  // std::thread's destructor would std::terminate the host process — so
  // catch here and run every unspawned chunk inline instead.
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  size_t spawned = 0;
  try {
    for (size_t c = 1; c < t; ++c) {
      pool.emplace_back(run_chunk, c);
      ++spawned;
    }
  } catch (...) {
  }
  run_chunk(0);
  for (size_t c = spawned + 1; c < t; ++c) run_chunk(c);
  int status = 0;
  for (std::thread& th : pool) th.join();
  for (size_t c = 0; c < t; ++c)
    if (rc[c] != 0) status = rc[c];
  return status;
} catch (...) {
  return 4;  // allocation failure etc. — never unwind across the C ABI
}

// Single-row double API, mirroring TensorflowModel.compute's double[] in /
// double out contract (TensorflowModel.java:52-109).
double shifu_scorer_compute(void* handle, const double* row) {
  if (!handle || !row) return -1.0;
  const Model& m = *static_cast<Model*>(handle);
  std::vector<float> frow(m.num_features);
  for (uint32_t i = 0; i < m.num_features; ++i)
    frow[i] = static_cast<float>(row[i]);
  std::vector<float> out(m.num_heads);
  if (shifu_scorer_compute_batch(handle, frow.data(), 1, out.data()) != 0)
    return -1.0;
  return static_cast<double>(out[0]);
}

}  // extern "C"

#ifdef SHIFU_SELFTEST_MAIN
// Sanitizer self-test entry (see shifu_parser.cc counterpart): drives the
// compute kernels under ASan/UBSan/TSan with shapes that hit every branch
// of the register-blocked matmul (full 6x32 tiles, partial-width tile,
// remainder rows), the hoisted activation loops, and — via a synthetic
// in-TU model — the multithreaded compute_batch chunking.  Model-file
// loading is exercised separately through the Python tests.
#include <cstdio>
int main(int argc, char** argv) {
  // fuzz mode: with a model path on argv[1], only load/score it — the math
  // selftest below is covered by the dedicated sanitizer tests, and the
  // fuzz harness invokes this binary once per mutant
  if (argc > 1) {
    void* h = shifu_scorer_load(argv[1]);
    if (h) {
      const int nf = shifu_scorer_num_features(h);
      const int nh = shifu_scorer_num_heads(h);
      if (nf > 0 && nf < (1 << 20) && nh > 0 && nh < (1 << 10)) {
        std::vector<float> frow((size_t)nf, 0.0f), fout((size_t)nh);
        (void)shifu_scorer_compute_batch(h, frow.data(), 1, fout.data());
      }
      shifu_scorer_free(h);
      std::puts("model load ok");
    } else {
      std::puts("model load rejected");
    }
    std::puts("scorer selftest ok");
    return 0;
  }
  // matmul m=13, k=37, n=40: two full 6-row tiles + 1 remainder row; one
  // full 32-wide tile + one 8-wide partial tile; bias and no-bias
  const size_t M = 13, K = 37, N = 40;
  std::vector<float> x(M * K), w(K * N), b(N), y(M * N);
  for (size_t i = 0; i < x.size(); ++i) x[i] = 0.01f * (float)i - 0.2f;
  for (size_t i = 0; i < w.size(); ++i) w[i] = 0.002f * (float)i - 0.1f;
  for (size_t i = 0; i < b.size(); ++i) b[i] = 0.5f - 0.01f * (float)i;
  matmul_bias(x.data(), w.data(), b.data(), y.data(), M, K, N);
  // scalar recompute of elements in the full tile (r2,c17), the partial
  // tile (r2,c38), and the remainder row (r12,c5)
  const size_t probes[][2] = {{2, 17}, {2, 38}, {12, 5}, {11, 33}};
  for (auto& pr : probes) {
    float want = b[pr[1]];
    for (size_t j = 0; j < K; ++j) want += x[pr[0] * K + j] * w[j * N + pr[1]];
    if (std::fabs(y[pr[0] * N + pr[1]] - want) > 1e-4f) {
      std::fprintf(stderr, "selftest: matmul mismatch at %zu,%zu\n",
                   pr[0], pr[1]);
      return 1;
    }
  }
  matmul_bias(x.data(), w.data(), nullptr, y.data(), M, K, N);  // no-bias path

  for (uint32_t a = 0; a < 8; ++a) (void)apply_act(a, -0.3f);
  std::vector<float> av(33), av2(33);
  for (size_t i = 0; i < av.size(); ++i) av[i] = 0.1f * (float)i - 1.5f;
  for (uint32_t a = 0; a < 6; ++a) {
    apply_act_rows(a, av.data(), av2.data(), av.size());     // out-of-place
    apply_act_rows(a, av2.data(), av2.data(), av2.size());   // in-place
  }

  std::vector<float> ln_in(2 * 6), ln_s(6, 1.0f), ln_b(6, 0.0f), ln_out(2 * 6);
  for (size_t i = 0; i < ln_in.size(); ++i) ln_in[i] = (float)i * 0.1f;
  layernorm_rows(ln_in.data(), ln_s.data(), ln_b.data(), ln_out.data(), 2, 6);
  std::vector<float> sm{0.1f, 2.0f, -1.0f, 0.0f, 3.3f};
  softmax_row(sm.data(), sm.size());
  float s = 0.0f;
  for (float v : sm) s += v;
  if (std::fabs(s - 1.0f) > 1e-5f) {
    std::fprintf(stderr, "selftest: softmax not normalized\n");
    return 2;
  }

  // threaded compute_batch vs single-thread, on a synthetic 2-layer MLP
  // built directly (same TU, no file): covers the chunk split, the shared
  // arena pool, and rc aggregation under the sanitizers
  Model model;
  model.num_features = 35;
  model.num_heads = 1;
  Op d1;
  d1.code = kDense; d1.dst = 1; d1.src = 0; d1.act = kRelu;
  d1.a = 35; d1.b = 40;
  d1.w0.resize(35 * 40); d1.w1.resize(40);
  for (size_t i = 0; i < d1.w0.size(); ++i) d1.w0[i] = 0.01f * (float)(i % 71) - 0.3f;
  for (size_t i = 0; i < d1.w1.size(); ++i) d1.w1[i] = 0.05f;
  Op d2;
  d2.code = kDense; d2.dst = 2; d2.src = 1; d2.act = kSigmoid;
  d2.a = 40; d2.b = 1;
  d2.w0.resize(40); d2.w1.resize(1, 0.1f);
  for (size_t i = 0; i < d2.w0.size(); ++i) d2.w0[i] = 0.02f * (float)i - 0.35f;
  model.ops = {d1, d2};
  model.shapes.resize(3);
  if (!infer_shapes(&model)) {
    std::fprintf(stderr, "selftest: infer_shapes failed\n");
    return 3;
  }
  const size_t batch = 2048 + 5;  // ragged: chunk boundaries not row-aligned
  std::vector<float> rows(batch * 35), out1(batch), outN(batch);
  for (size_t i = 0; i < rows.size(); ++i) rows[i] = 0.001f * (float)(i % 977) - 0.4f;
  setenv("SHIFU_SCORER_THREADS", "1", 1);
  if (shifu_scorer_compute_batch(&model, rows.data(), (int)batch, out1.data()) != 0) {
    std::fprintf(stderr, "selftest: single-thread batch failed\n");
    return 4;
  }
  setenv("SHIFU_SCORER_THREADS", "3", 1);
  if (shifu_scorer_compute_batch(&model, rows.data(), (int)batch, outN.data()) != 0) {
    std::fprintf(stderr, "selftest: threaded batch failed\n");
    return 5;
  }
  for (size_t i = 0; i < batch; ++i) {
    if (out1[i] != outN[i]) {
      std::fprintf(stderr, "selftest: threaded result differs at %zu\n", i);
      return 6;
    }
    if (!(out1[i] >= 0.0f && out1[i] <= 1.0f)) {
      std::fprintf(stderr, "selftest: score out of [0,1] at %zu\n", i);
      return 7;
    }
  }
  std::puts("scorer selftest ok");
  return 0;
}
#endif  // SHIFU_SELFTEST_MAIN
