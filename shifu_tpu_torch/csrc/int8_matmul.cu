// Fused int8-dequant first layer: out = cdt(cdt(dequant(q)) @ cdt(w)) + cdt(b)
// on q (M, F) int8, w (F, N) f32, b (N,) f32, per-column scale/offset (F,) f32.
//
// Replaces the TPU kernel shifu_tpu/ops/pallas_int8_matmul.py (_run_fwd /
// _fwd_kernel).  Same math, with the same roundings, so that training on the
// int8 wire rounds where the JAX package rounds:
//   1. x = float(q) * scale[f] (+ offset[f]), f32 multiply then f32 add (no
//      fused multiply-add: __fmul_rn / __fadd_rn keep nvcc from contracting);
//   2. x and w rounded to the compute dtype (round to nearest even);
//   3. products accumulated in f32 on the tensor cores (mma.sync m16n8k16,
//      bf16 or f16 operands: a product of two such values is exact in f32,
//      so only the summation order differs from the reference).  For compute
//      dtype f32, x and w enter as bf16 hi = rounded and lo = the rest
//      rounded, in three products, hi hi + hi lo + lo hi (the lo lo term,
//      2^-16 of a product, is dropped).  The tensor cores add each k-step
//      into their f32 accumulator truncated toward zero, so over many
//      k-steps the error drifts one way: at F = 4096 in f32 (256 k-steps x
//      3 passes) it reached 2.4e-4 on the H100.  So each chunk of 64
//      features sums into an accumulator of its own, which is added to the
//      running sum with an f32 add rounded to nearest.  Within F32_ATOL /
//      F32_RTOL, as tests/test_torch_int8_matmul_numerics.py models;
//   4. the sum rounded to the compute dtype;
//   5. the bias rounded to the compute dtype and added as a compute-dtype add:
//      an f32 add of the two rounded values, rounded once more.
//
// Bound on the H100 at the training shape (M=65536, F=30, N=100, bf16):
// bytes.  q in (2 MB), the bf16 output (13 MB) and the small w/b/scale make
// about 15 MB, 4.5 us at 3.35 TB/s; the 0.39 GFLOP of products take 0.4 us
// on the tensor cores.  So the design reads each q byte once, writes the
// output with 16-byte stores, and keeps everything else off the memory
// path.  The TPU kernel tiles 256 batch rows and puts the whole (F, N)
// weight in VMEM for one MXU product; here:
//   - Panel kernel (F <= 64 and N <= 128, the path's shape): a persistent
//     grid of 256-thread CTAs, three an SM, each walking panels of 64 rows.
//     A CTA rounds w (F x N) into shared memory once, transposed and padded
//     to 16-multiples with zeros.  A panel of q is one contiguous, 16-byte
//     aligned run of 64 F bytes, copied with cp.async while the previous
//     panel computes (two buffers).  It is dequantized once in shared
//     memory, into rows padded by 16 bytes (ldmatrix reads them without
//     bank conflicts).  Each of the 8 warps takes 16 rows and half of the
//     columns (up to 8 mma n-tiles), so that its accumulators leave room
//     for three CTAs an SM: a panel is a chain of short dependent steps,
//     and the time is their latency unless other warps fill it (with all
//     N columns a warp, two CTAs an SM, the kernel took 0.0155 ms at the
//     path's shape, against 0.0116 with its products taken out).  The
//     epilogue rounds, adds the bias, and stages the (64, N) tile in shared
//     memory; being all of the panel's columns, it is one contiguous range
//     of the output, written with 16-byte stores.
//   - Tiled kernel (any other admitted shape, F and N up to 4096): 128 x 128
//     output tiles, F in chunks of 64 staged from global memory, each
//     chunk's sum folded into the running one (3.), the same mma, and the
//     epilogue written from the fragments, row by row.
#include "mma.cuh"

namespace {

using shifu::Mma;

constexpr int kThreads = 256;         // 8 warps
constexpr int kPanelM = 64;           // panel kernel: rows of a panel,
constexpr int kPanelK = 64;           //   F <= 64
constexpr int kPanelN = 128;          //   and N <= 128; a warp takes 16
constexpr int kHalfPairs = kPanelN / 32;  // rows and half the n-tile pairs
constexpr int kBM = 128;              // tiled kernel: rows of a tile, 16
constexpr int kBN = 128;              //   a warp; columns of a tile
constexpr int kBK = 64;               //   features of a chunk
constexpr int kPad = 8;               // 16-byte pad of a shared row

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return shifu::to_f32(shifu::from_f32<T>(x));
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// 16 bytes global -> shared, of which the first n are read and the rest
// zero-filled
__device__ __forceinline__ void cp16n(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   shifu::smem_addr(dst)),
               "l"(src), "r"(n));
}

// The operands as the tensor cores take them: x in a (rows, ld) array and
// w^T in an (n, ld) array of E, hi and, for an f32 compute dtype, lo
template <typename T>
struct Operands {
  using E = typename Mma<T>::E;
  E* x_hi;
  E* x_lo;
  E* w_hi;
  E* w_lo;
};

// two neighbouring values of a row, rounded (or split) and stored as a pair
template <typename T>
__device__ __forceinline__ void put_pair(typename Mma<T>::E* hi,
                                         typename Mma<T>::E* lo, int at,
                                         float a, float b) {
  using E = typename Mma<T>::E;
  if constexpr (Mma<T>::kSplit) {
    uint32_t h, l;
    shifu::split<E>(a, b, h, l);
    *reinterpret_cast<uint32_t*>(hi + at) = h;
    *reinterpret_cast<uint32_t*>(lo + at) = l;
  } else {
    *reinterpret_cast<uint32_t*>(hi + at) = shifu::pack<E>(a, b);
  }
}

// two neighbouring output values, stored as one access
template <typename T>
struct alignas(2 * sizeof(T)) Two {
  T a, b;
};

__device__ __forceinline__ float dequant(int q, float s, const float* offset,
                                         float o) {
  const float x = __fmul_rn((float)q, s);
  return offset != nullptr ? __fadd_rn(x, o) : x;
}

// acc[j] (16 rows x 8 columns of n-tile 2 p0 + j) += x rows m0.. . w over
// k-steps ksteps of 16 and the NP pairs of n-tiles from pair p0 that lie
// below n-tile nt (a multiple of 2)
template <typename T, int NP, int KS>
__device__ __forceinline__ void tile_mma(float (&acc)[2 * NP][4],
                                         const Operands<T>& op, int ld,
                                         int m0, int p0, int ksteps,
                                         int nt) {
  using E = typename Mma<T>::E;
  constexpr bool kSplit = Mma<T>::kSplit;
  const int lane = threadIdx.x % 32;
  const int mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) continue;  // (guards, not breaks: acc stays in
                                 // registers only while fully unrolled)
    uint32_t ah[4], al[4];
    const int a_off = (m0 + (lane & 15)) * ld + 16 * ks + 8 * (lane >> 4);
    shifu::ldsm4(ah, op.x_hi + a_off);
    if constexpr (kSplit) shifu::ldsm4(al, op.x_lo + a_off);
#pragma unroll
    for (int jp = 0; jp < NP; ++jp) {
      if (2 * (p0 + jp) >= nt) continue;
      const int b_off = (16 * (p0 + jp) + 8 * (mat >> 1) + r) * ld +
                        16 * ks + 8 * (mat & 1);
      uint32_t bh[4], bl[4];
      shifu::ldsm4(bh, op.w_hi + b_off);
      if constexpr (kSplit) shifu::ldsm4(bl, op.w_lo + b_off);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        shifu::mma16<E>(acc[2 * jp + u], ah, bh[2 * u], bh[2 * u + 1]);
        if constexpr (kSplit) {
          shifu::mma16<E>(acc[2 * jp + u], ah, bl[2 * u], bl[2 * u + 1]);
          shifu::mma16<E>(acc[2 * jp + u], al, bh[2 * u], bh[2 * u + 1]);
        }
      }
    }
  }
}

// -- the panel kernel ---------------------------------------------------------

// byte offsets of the panel kernel's shared arrays
struct PanelLayout {
  int kp, np, ld, qbuf, q, x, w, s, bias, tile, bytes;
  __host__ __device__ PanelLayout(int f, int n, bool split, int out_size) {
    kp = round_up(f, 16);
    np = round_up(n, 16);
    ld = kp + kPad;
    const int parts = split ? 2 : 1;
    qbuf = round_up(kPanelM * f, 16);
    q = 0;
    x = q + 2 * qbuf;
    w = x + parts * kPanelM * ld * 2;
    s = w + parts * np * ld * 2;            // scale then offset, kp each
    bias = s + 2 * kp * 4;
    tile = round_up(bias + np * 4, 16);
    bytes = tile + round_up(kPanelM * n * out_size, 16);
  }
};

// three CTAs an SM (85 registers) in bf16 and f16, two in f32 (three
// products): a panel is a chain of short steps, so the SM hides their
// latency with other CTAs' warps.  (Four, at 64 registers, took 0.0136 ms
// against 0.0139 at the path's shape but spilled 36 bytes.)
template <typename T>
__global__ void __launch_bounds__(kThreads, Mma<T>::kSplit ? 2 : 3)
    panel_kernel(const signed char* __restrict__ q,
                 const float* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ scale,
                 const float* __restrict__ offset, T* __restrict__ out,
                 long long M, int F, int N) {
  using E = typename Mma<T>::E;
  constexpr bool kSplit = Mma<T>::kSplit;
  extern __shared__ __align__(16) unsigned char smem[];
  const PanelLayout L(F, N, kSplit, sizeof(T));
  unsigned char* qs = smem + L.q;
  Operands<T> op;
  op.x_hi = reinterpret_cast<E*>(smem + L.x);
  op.x_lo = op.x_hi + kPanelM * L.ld;
  op.w_hi = reinterpret_cast<E*>(smem + L.w);
  op.w_lo = op.w_hi + L.np * L.ld;
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* os = ss + L.kp;
  float* bs = reinterpret_cast<float*>(smem + L.bias);
  T* tile = reinterpret_cast<T*>(smem + L.tile);

  const int tid = threadIdx.x;
  const long long panels = (M + kPanelM - 1) / kPanelM;
  const long long q_end = M * F;

  // panel p's bytes [p kPanelM F, min(M, (p + 1) kPanelM) F) -> buffer
  const auto copy_panel = [&](long long p, unsigned char* dst) {
    const long long start = p * kPanelM * F;
    const long long n = min((long long)kPanelM * F, q_end - start);
    for (int i = tid; 16 * i < n; i += kThreads)
      cp16n(dst + 16 * i, q + start + 16 * i,
            (int)min(16LL, n - 16LL * i));
  };

  long long p = blockIdx.x;
  if (p < panels) copy_panel(p, qs);
  shifu::cp_commit();

  // once a CTA: w^T rounded (zero past F and N), scale, offset, bias;
  // unrolled, so that a thread's loads of w are in flight together
#pragma unroll 8
  for (int i = tid; i < L.np * (L.kp / 2); i += kThreads) {
    const int n = i % L.np, k = 2 * (i / L.np);  // n fastest: w rows coalesce
    const float w0 = (n < N && k < F) ? w[(long long)k * N + n] : 0.f;
    const float w1 = (n < N && k + 1 < F) ? w[(long long)(k + 1) * N + n]
                                          : 0.f;
    put_pair<T>(op.w_hi, op.w_lo, n * L.ld + k, round_to<T>(w0),
                round_to<T>(w1));
  }
  for (int i = tid; i < L.kp; i += kThreads) {
    ss[i] = i < F ? scale[i] : 0.f;
    os[i] = (i < F && offset != nullptr) ? offset[i] : 0.f;
  }
  for (int i = tid; i < L.np; i += kThreads)
    bs[i] = i < N ? round_to<T>(b[i]) : 0.f;

  // dequant: thread tid takes rows tid / 8 + (kThreads / 8) i and k-pairs
  // tid % 8 + 8 j
  constexpr int kRowStep = kThreads / 8;
  const int dr = tid / 8, dc = tid % 8;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = 16 * (warp % (kPanelM / 16));
  const int p0 = kHalfPairs * (warp / (kPanelM / 16));  // first n-tile pair
  const int nt = L.np / 8;
  for (int buf = 0; p < panels; p += gridDim.x, buf ^= 1) {
    const long long next = p + gridDim.x;
    if (next < panels) copy_panel(next, qs + (buf ^ 1) * L.qbuf);
    shifu::cp_commit();
    shifu::cp_wait_prev();
    __syncthreads();  // panel p landed; the last panel's tile is written
    const unsigned char* qp = qs + buf * L.qbuf;
#pragma unroll
    for (int i = 0; i < kPanelM / kRowStep; ++i) {
      const int r = dr + kRowStep * i;
#pragma unroll
      for (int j = 0; j < kPanelK / 16; ++j) {
        const int k = 2 * (dc + 8 * j);
        if (k >= L.kp) continue;
        const float x0 =
            k < F ? dequant((signed char)qp[r * F + k], ss[k], offset, os[k])
                  : 0.f;
        const float x1 = k + 1 < F ? dequant((signed char)qp[r * F + k + 1],
                                             ss[k + 1], offset, os[k + 1])
                                   : 0.f;
        put_pair<T>(op.x_hi, op.x_lo, r * L.ld + k, round_to<T>(x0),
                    round_to<T>(x1));
      }
    }
    __syncthreads();  // x is staged

    float acc[2 * kHalfPairs][4];
#pragma unroll
    for (int j = 0; j < 2 * kHalfPairs; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    tile_mma<T, kHalfPairs, kPanelK / 16>(acc, op, L.ld, m0, p0, L.kp / 16,
                                          nt);

    // round, add the bias, stage the (rows, N) tile: a fragment's two
    // neighbouring columns as one store where N is even
    const int rows = (int)min((long long)kPanelM, M - p * kPanelM);
#pragma unroll
    for (int j = 0; j < 2 * kHalfPairs; ++j) {
      if (2 * p0 + j >= nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + lane / 4 + 8 * h;
        const int c = 8 * (2 * p0 + j) + 2 * (lane % 4);
        if (r >= rows || c >= N) continue;
        const T y0 = shifu::from_f32<T>(
            __fadd_rn(round_to<T>(acc[j][2 * h]), bs[c]));
        const T y1 = shifu::from_f32<T>(
            __fadd_rn(round_to<T>(acc[j][2 * h + 1]), bs[c + 1]));
        if (N % 2 == 0) {
          *reinterpret_cast<Two<T>*>(tile + r * N + c) = Two<T>{y0, y1};
        } else {
          tile[r * N + c] = y0;
          if (c + 1 < N) tile[r * N + c + 1] = y1;
        }
      }
    }
    __syncthreads();  // the tile is staged

    // the tile is all columns of rows p kPanelM.., one contiguous range
    const int n_bytes = rows * N * (int)sizeof(T);
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(out + p * kPanelM * (long long)N);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(tile);
    for (int i = tid; 16 * i + 16 <= n_bytes; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    for (int i = (n_bytes / 16) * 16 / (int)sizeof(T) + tid; i < rows * N;
         i += kThreads)
      reinterpret_cast<T*>(dst)[i] = tile[i];
  }
}

// -- the tiled kernel ---------------------------------------------------------

struct TiledLayout {
  int ld, x, w, bytes;
  __host__ __device__ explicit TiledLayout(bool split) {
    ld = kBK + kPad;
    const int parts = split ? 2 : 1;
    x = 0;
    w = x + parts * kBM * ld * 2;
    bytes = w + parts * kBN * ld * 2;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tiled_kernel(const signed char* __restrict__ q,
                 const float* __restrict__ w, const float* __restrict__ b,
                 const float* __restrict__ scale,
                 const float* __restrict__ offset, T* __restrict__ out,
                 long long M, int F, int N) {
  using E = typename Mma<T>::E;
  constexpr bool kSplit = Mma<T>::kSplit;
  extern __shared__ __align__(16) unsigned char smem[];
  const TiledLayout L(kSplit);
  Operands<T> op;
  op.x_hi = reinterpret_cast<E*>(smem + L.x);
  op.x_lo = op.x_hi + kBM * L.ld;
  op.w_hi = reinterpret_cast<E*>(smem + L.w);
  op.w_lo = op.w_hi + kBN * L.ld;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = 16 * warp;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  float acc[kBN / 8][4], part[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < F; k0 += kBK) {
    __syncthreads();  // the previous chunk is consumed
    // q rows row0.., features k0..k0 + 63: pair i & 31 of row i >> 5
    for (int i = tid; i < kBM * (kBK / 2); i += kThreads) {
      const int r = i / (kBK / 2), k = k0 + 2 * (i % (kBK / 2));
      const long long row = row0 + r;
      float x0 = 0.f, x1 = 0.f;
      if (row < M) {
        const signed char* qr = q + row * F;
        if (k < F)
          x0 = dequant(qr[k], scale[k], offset,
                       offset != nullptr ? offset[k] : 0.f);
        if (k + 1 < F)
          x1 = dequant(qr[k + 1], scale[k + 1], offset,
                       offset != nullptr ? offset[k + 1] : 0.f);
      }
      put_pair<T>(op.x_hi, op.x_lo, r * L.ld + (k - k0), round_to<T>(x0),
                  round_to<T>(x1));
    }
    // w^T chunk: column n of the tile fastest, so that w's rows coalesce
    for (int i = tid; i < kBN * (kBK / 2); i += kThreads) {
      const int n = i % kBN, k = k0 + 2 * (i / kBN);
      const int c = col0 + n;
      const float w0 = (c < N && k < F) ? w[(long long)k * N + c] : 0.f;
      const float w1 = (c < N && k + 1 < F) ? w[(long long)(k + 1) * N + c]
                                            : 0.f;
      put_pair<T>(op.w_hi, op.w_lo, n * L.ld + (k - k0), round_to<T>(w0),
                  round_to<T>(w1));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    tile_mma<T, kBN / 16, kBK / 16>(part, op, L.ld, m0, 0,
                                    (min(kBK, F - k0) + 15) / 16,
                                    round_up(min(kBN, N - col0), 16) / 8);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
  }

#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = row0 + m0 + lane / 4 + 8 * (e / 2);
      const int c = col0 + 8 * j + 2 * (lane % 4) + (e % 2);
      if (row < M && c < N)
        out[row * N + c] = shifu::from_f32<T>(
            __fadd_rn(round_to<T>(acc[j][e]), round_to<T>(b[c])));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* w, const void* b,
                   const void* scale, const void* offset, void* out,
                   long long M, int F, int N, cudaStream_t st) {
  const auto* qp = static_cast<const signed char*>(q);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  const auto* sp = static_cast<const float*>(scale);
  const auto* op = static_cast<const float*>(offset);
  T* yp = static_cast<T*>(out);
  cudaError_t err;
  if (F <= kPanelK && N <= kPanelN && shifu::aligned16(q) &&
      shifu::aligned16(out)) {
    const int smem = PanelLayout(F, N, Mma<T>::kSplit, sizeof(T)).bytes;
    err = cudaFuncSetAttribute(panel_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, panel_kernel<T>, kThreads, smem)) != cudaSuccess)
      return err;
    const long long panels = (M + kPanelM - 1) / kPanelM;
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > panels) grid = panels;
    panel_kernel<T><<<(unsigned)grid, kThreads, smem, st>>>(qp, wp, bp, sp,
                                                           op, yp, M, F, N);
  } else {
    const int smem = TiledLayout(Mma<T>::kSplit).bytes;
    err = cudaFuncSetAttribute(tiled_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                    (unsigned)((N + kBN - 1) / kBN));
    tiled_kernel<T><<<grid, kThreads, smem, st>>>(qp, wp, bp, sp, op, yp, M,
                                                  F, N);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and does not synchronise.  `offset` may be null.
// Takes the panel kernel where F <= 64, N <= 128 and q and out are 16-byte
// aligned, else the tiled kernel.  Returns the CUDA error code of the
// launch (0 = cudaSuccess).
int int8_matmul_fwd(const void* q, const void* w, const void* b,
                    const void* scale, const void* offset, void* out,
                    long long M, int F, int N, int dtype, void* stream) {
  if (M < 0 || F < 1 || F > 4096 || N < 1 || N > 4096)
    return (int)cudaErrorInvalidValue;
  if ((M + kPanelM - 1) / kPanelM >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case shifu::kFloat32:
      err = launch<float>(q, w, b, scale, offset, out, M, F, N, st);
      break;
    case shifu::kBFloat16:
      err = launch<__nv_bfloat16>(q, w, b, scale, offset, out, M, F, N, st);
      break;
    case shifu::kFloat16:
      err = launch<__half>(q, w, b, scale, offset, out, M, F, N, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
