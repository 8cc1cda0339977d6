// Fused dense layer forward for Hopper (sm_90a), on the tensor cores:
// out = act(x @ W + b).
//
// Replaces: the Pallas TPU kernel
//   deeplearning4j_tpu/ops/pallas_kernels.py::_dense_kernel, launched by
//   _dense_pallas (pallas_call) behind the public fused_dense.
// The JAX package runs it only for shapes that tile onto the TPU
// (m % 8, k % 128, n % 128, k <= 4096: sublanes, lanes and an untiled K
// strip in VMEM) and falls back to plain lax for every other shape, which
// includes both hidden layers of the MNIST MLP (784->500, 500->300). This
// kernel masks its edges and tiles K, so it takes every shape.
//
// Computes, for row-major x (M, K), W (K, N) (in, out) and b (N,), all f32
// or all bf16:
//   out = act(sum_k x[m,k] * W[k,n] + b[n])        (dtype of x)
// with the reference's numerics: products accumulated in f32, the bias
// added in f32, act in {linear, relu, tanh, sigmoid} applied in f32, and
// the result rounded once to x's dtype.
//
// Bounds on an H100 SXM at the MLP's shapes (batch 512; 989 TFLOP/s bf16,
// 495 TF32, 3.35 TB/s): layer 0 (512x784 @ 784x500) is 0.401 GFLOP.
// bf16: 0.41 us of operations under 0.63 us of its 2.1 MB, bound by
// bytes. f32: three TF32 products each, 2.43 us of operations against
// 1.25 us of its 4.2 MB, bound by operations (5.99 us on the CUDA cores'
// 67 TFLOP/s). Layer 1 (512x500 @ 500x300): 0.154 GFLOP; bf16 bound by
// its 1.1 MB (0.33 us), f32 by 0.93 us of operations.
//
// Design:
// - one block of 8 warps per 32x64 output tile, each warp computing 16x16
//   (two n8 blocks). The small tile is for the card's 132 SMs: 32x64
//   gives the MLP's layers 128 and 80 blocks, where 64x64 would give 64
//   and 40; with one block on most SMs, 8 warps (two a scheduler) hide
//   each other's latency, where 4 warps of 16x32 took 10-20% longer (H100
//   80GB HBM3, 700 W). K is not split;
// - K is stepped in chunks of 32, staged by cp.async into a ring (6 stages
//   at bf16, 4 at f32: the 48 KB of static shared memory), one barrier a
//   chunk. Shared tiles are XOR-swizzled (hopper_mma.cuh) so ldmatrix and
//   the f32 fragment loads are free of bank conflicts;
// - bf16: m16n8k16, x as the A operand through ldmatrix, W (K, N) as the
//   B operand through ldmatrix.trans;
// - f32: m16n8k8 TF32 with the 3xTF32 split (a*b ~ a_hi b_hi + a_hi b_lo
//   + a_lo b_hi), f32-accurate (a single TF32 pass keeps three decimal
//   digits and is not used), fragments from swizzled 4-byte shared loads;
//   each K chunk is summed in a fresh accumulator and added to the running
//   one on the CUDA cores (round to nearest);
// - the copy width of x and of W (16, 8 or 4 bytes by cp.async, 2 by plain
//   loads) is chosen at launch from the base pointer and the row pitch:
//   bf16 rows of 500 or 300 elements (1000, 600 bytes) are 8-byte aligned
//   only, odd bf16 widths 2-byte. The K tail and the M and N edges are
//   zero-filled by the copy (src-size), never read past the end;
// - bias and activation in the epilogue, in f32, one rounding to the
//   output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 32;      // rows of an output tile
constexpr int kBN = 64;      // columns of an output tile
constexpr int kBK = 32;      // depth of one stage
constexpr int kWarpsM = 2;   // warps along the tile's rows, 16 rows each
constexpr int kWarpsN = 4;   // warps along its columns
constexpr int kWarpN = kBN / kWarpsN;  // columns of a warp
constexpr int kNB = kWarpN / 8;        // n8 blocks of a warp
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
static_assert(kBM == 16 * kWarpsM && kNB % 2 == 0,
              "m16 rows a warp; bf16 B fragments come in n8 pairs");

// activation codes, as the wrapper passes them
constexpr int kLinear = 0;
constexpr int kRelu = 1;
constexpr int kTanh = 2;
constexpr int kSigmoid = 3;

// x tile: kBM rows of kBK elements; W tile: kBK rows of kBN elements.
// bf16 x rows are 4 chunks (ldmatrix: <1, 3, 0>); f32 x rows 8 chunks read
// as one element of 8 rows (<0, 7, 0>); bf16 W rows 8 chunks read by
// ldmatrix.trans (<0, 7, 0>); f32 W rows 16 chunks read as one element of
// 4 rows x 8 columns (<0, 3, 1>).
template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  using X = SwizzledTile<kBK * 2, 1, 3, 0>;
  using W = SwizzledTile<kBN * 2, 0, 7, 0>;
  static constexpr int kStages = 6;  // 6 KB a stage
};
template <>
struct Tiles<float> {
  using X = SwizzledTile<kBK * 4, 0, 7, 0>;
  using W = SwizzledTile<kBN * 4, 0, 3, 1>;
  static constexpr int kStages = 4;  // 12 KB a stage: the 48 KB of static
};                                   // shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return v < 0.f ? 0.f : v;  // NaN passes through, as torch.relu
    case kTanh:
      return tanhf(v);
    case kSigmoid:
      return 1.f / (1.f + expf(-v));
    default:
      return v;
  }
}

// Stage the tile of rows [r0, r0 + kRows) x columns [c0, c0 + kCols) of a
// row-major (n_rows, n_cols) array: chunks past either edge read zero.
template <typename T, typename Tile, int kRows, int kCols>
__device__ __forceinline__ void stage_tile(unsigned char* tile,
                                           const T* __restrict__ src,
                                           int r0, int c0, int n_rows,
                                           int n_cols, int width) {
  constexpr int kElts = 16 / sizeof(T);  // elements of a chunk
  constexpr int kChunks = kCols / kElts;
  constexpr int kPasses = (kRows * kChunks + kThreads - 1) / kThreads;
  const char* base = reinterpret_cast<const char*>(src);
#pragma unroll
  for (int n = 0; n < kPasses; ++n) {
    const int i = threadIdx.x + n * kThreads;
    if (kRows * kChunks % kThreads != 0 && i >= kRows * kChunks) break;
    const int r = i / kChunks, c = i % kChunks;
    const int gr = r0 + r, gc = c0 + c * kElts;
    const int left = gr < n_rows ? n_cols - gc : 0;
    const int valid =
        left <= 0 ? 0 : left >= kElts ? 16 : left * (int)sizeof(T);
    const char* from =
        valid ? base + ((size_t)gr * n_cols + gc) * sizeof(T) : base;
    copy_chunk(tile + Tile::offset(r, c), from, valid, width);
  }
}

// acc (this warp's 16 x kWarpN) += x_tile (16 rows) @ w_tile (kWarpN
// columns)
__device__ __forceinline__ void chunk_bf16(float (&acc)[kNB][4],
                                           const unsigned char* xs,
                                           const unsigned char* ws, int wm,
                                           int wn, int lane) {
  using X = Tiles<__nv_bfloat16>::X;
  using W = Tiles<__nv_bfloat16>::W;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, xs + X::offset(16 * wm + (lane & 15),
                                   2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < kNB / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, ws + W::offset(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                             kNB * wn + 2 * np + (lane >> 4)));
      mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ float lds_f32(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// the same through 3xTF32, summed in fresh accumulators (big and
// correction terms apart) added to acc
__device__ __forceinline__ void chunk_f32(float (&acc)[kNB][4],
                                          const unsigned char* xs,
                                          const unsigned char* ws, int wm,
                                          int wn, int lane) {
  using X = Tiles<float>::X;
  using W = Tiles<float>::W;
  const int g = lane >> 2, q = lane & 3;
  const int row = 16 * wm + g;
  float big[kNB][4] = {}, small[kNB][4] = {};
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(lds_f32(xs + X::element<4>(row, 8 * kk + q)), ah[0], al[0]);
    split_tf32(lds_f32(xs + X::element<4>(row + 8, 8 * kk + q)), ah[1],
               al[1]);
    split_tf32(lds_f32(xs + X::element<4>(row, 8 * kk + q + 4)), ah[2],
               al[2]);
    split_tf32(lds_f32(xs + X::element<4>(row + 8, 8 * kk + q + 4)), ah[3],
               al[3]);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int col = kWarpN * wn + 8 * nb + g;
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(lds_f32(ws + W::element<4>(8 * kk + q, col)), b0h, b0l);
      split_tf32(lds_f32(ws + W::element<4>(8 * kk + q + 4, col)), b1h, b1l);
      mma_3xtf32(big[nb], small[nb], ah, al, b0h, b1h, b0l, b1l);
    }
  }
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] += big[nb][e] + small[nb][e];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ out, int m,
                       int k, int n, int act, int x_width, int w_width) {
  using X = typename Tiles<T>::X;
  using W = typename Tiles<T>::W;
  constexpr int kStages = Tiles<T>::kStages;
  constexpr int kXBytes = kBM * kBK * sizeof(T);
  constexpr int kWBytes = kBK * kBN * sizeof(T);
  __shared__ __align__(128) unsigned char xs[kStages][kXBytes];
  __shared__ __align__(128) unsigned char ws[kStages][kWBytes];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int n_chunks = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) {
      stage_tile<T, X, kBM, kBK>(xs[s], x, row0, s * kBK, m, k, x_width);
      stage_tile<T, W, kBK, kBN>(ws[s], w, s * kBK, col0, k, n, w_width);
    }
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c-1
    const int next = c + kStages - 1;
    if (next < n_chunks) {
      const int s = next % kStages;
      stage_tile<T, X, kBM, kBK>(xs[s], x, row0, next * kBK, m, k, x_width);
      stage_tile<T, W, kBK, kBN>(ws[s], w, next * kBK, col0, k, n, w_width);
    }
    cp_async_commit();
    const int s = c % kStages;
    if constexpr (sizeof(T) == 4)
      chunk_f32(acc, xs[s], ws[s], wm, wn, lane);
    else
      chunk_bf16(acc, xs[s], ws[s], wm, wn, lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + kWarpN * wn + 8 * nb + 2 * q + e;
      if (col >= n) continue;
      const float bias = to_f32(b[col]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 16 * wm + g + 8 * h;
        if (row < m)
          out[(size_t)row * n + col] =
              from_f32<T>(activate(acc[nb][2 * h + e] + bias, act));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int m, int k, int n, int act, cudaStream_t stream) {
  const int x_width = copy_width(x, (long long)k * sizeof(T));
  const int w_width = copy_width(w, (long long)n * sizeof(T));
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  fused_dense_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), m, k, n, act, x_width,
      w_width);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous x (m, k), w (k, n), b (n,) and out (m, n), all of one element
// type: is_bf16 selects it (0: f32, 1: bf16). act: 0 linear, 1 relu,
// 2 tanh, 3 sigmoid. An empty output launches nothing. Returns
// cudaGetLastError() of the launch.
extern "C" int dl4j_fused_dense(const void* x, const void* w, const void* b,
                                void* out, int m, int k, int n, int act,
                                int is_bf16, void* stream) {
  if (m < 0 || k < 0 || n < 0 || act < kLinear || act > kSigmoid ||
      (n + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, b, out, m, k, n, act, s)
              : launch<float>(x, w, b, out, m, k, n, act, s);
  return (int)err;
}
