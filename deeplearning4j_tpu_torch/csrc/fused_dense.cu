// Fused dense layer forward for Hopper (sm_90a): out = act(x @ W + b).
//
// Replaces: the Pallas TPU kernel
//   deeplearning4j_tpu/ops/pallas_kernels.py::_dense_kernel, launched by
//   _dense_pallas (pallas_call) behind the public fused_dense.
// The JAX package runs it only for shapes that tile onto the TPU
// (m % 8, k % 128, n % 128, k <= 4096: sublanes, lanes and an untiled K
// strip in VMEM) and falls back to plain lax for every other shape, which
// includes both hidden layers of the MNIST MLP (784->500, 500->300). This
// kernel has masked edges and a tiled K, so it takes every shape.
//
// Computes, for row-major x (M, K), W (K, N) (in, out) and b (N,), all f32
// or all bf16:
//   out = act(sum_k x[m,k] * W[k,n] + b[n])        (dtype of x)
// with the reference's numerics: products accumulated in f32, the bias
// added in f32, act in {linear, relu, tanh, sigmoid} applied in f32, and
// the result rounded once to x's dtype.
//
// Bound on an H100 SXM at the MLP's shapes (batch 512): layer 0
// (512x784 @ 784x500) is 0.401 GFLOP, 5.99 us at the CUDA cores' 67
// TFLOP/s f32 rate against 4.2 MB of f32 operands (1.25 us at 3.35 TB/s):
// bound by operations at f32. In bf16 the tensor cores would do the same
// work in 0.41 us, under the 0.63 us of its 2.1 MB: bound by bytes there.
// This first version computes with f32 FMA on the CUDA cores whatever the
// input type (no mma/wgmma, no TMA, no split K): right and simple first.
//
// Design:
// - one block of 128 threads per 32x64 output tile; each thread owns a 4x4
//   micro-tile, rows ty + 8i and columns tx + 16j, so that neighbouring
//   threads write neighbouring columns. The small tile is for the card's
//   132 SMs: 32x64 gives the MLP's layers 128 and 80 blocks, where 64x64
//   would give 64 and 40;
// - K is stepped in chunks of 32, staged through shared memory as f32: the
//   x chunk transposed (padded to 33 rows so the transposing stores are
//   free of bank conflicts), the W chunk as it lies. Each thread loads its
//   24 elements of the next chunk into registers before the products of the
//   current one, so the loads' latency hides under the FMAs instead of
//   being paid once per element;
// - loads past M, K or N read zero, and stores past M or N are skipped, so
//   every shape works (1x1x1, 5x7x3, 512x784x500);
// - bias and activation in the epilogue, one rounding to the output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 32;               // rows of an output tile
constexpr int kBN = 64;               // columns of an output tile
constexpr int kBK = 32;               // depth of one shared-memory stage
constexpr int kTM = 4;                // rows a thread owns
constexpr int kTN = 4;                // columns a thread owns
constexpr int kThreadsM = kBM / kTM;  // 8
constexpr int kThreadsN = kBN / kTN;  // 16
constexpr int kThreads = kThreadsM * kThreadsN;
constexpr int kXLoads = kBM * kBK / kThreads;  // x elements a thread stages
constexpr int kWLoads = kBK * kBN / kThreads;  // W elements a thread stages
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN % kThreads == 0,
              "tiles must split evenly over the block");

// activation codes, as the wrapper passes them
constexpr int kLinear = 0;
constexpr int kRelu = 1;
constexpr int kTanh = 2;
constexpr int kSigmoid = 3;

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

// The chunk of x rows [row0, row0+kBM) x cols [k0, k0+kBK) and of W rows
// [k0, k0+kBK) x cols [col0, col0+kBN) that thread ``tid`` stages, as f32,
// zero past M, K or N. A warp reads 32 consecutive k of one x row and 32
// consecutive columns of one W row: both loads coalesce.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x,
                                           const T* __restrict__ w, int m,
                                           int k, int n, int row0, int col0,
                                           int k0, int tid, float (&xr)[kXLoads],
                                           float (&wr)[kWLoads]) {
#pragma unroll
  for (int l = 0; l < kXLoads; ++l) {
    const int e = tid + l * kThreads;
    const int gr = row0 + e / kBK, gc = k0 + e % kBK;
    xr[l] = (gr < m && gc < k) ? to_f32(x[(size_t)gr * k + gc]) : 0.f;
  }
#pragma unroll
  for (int l = 0; l < kWLoads; ++l) {
    const int e = tid + l * kThreads;
    const int gr = k0 + e / kBN, gc = col0 + e % kBN;
    wr[l] = (gr < k && gc < n) ? to_f32(w[(size_t)gr * n + gc]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ out, int m,
                       int k, int n, int act) {
  __shared__ float xs[kBK][kBM + 1];  // x chunk, transposed: xs[kk][row]
  __shared__ float ws[kBK][kBN];      // W chunk: ws[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;
  const int ty = tid / kThreadsN;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float xr[kXLoads], wr[kWLoads];
  if (k > 0) load_chunk(x, w, m, k, n, row0, col0, 0, tid, xr, wr);
  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kXLoads; ++l) {
      const int e = tid + l * kThreads;
      xs[e % kBK][e / kBK] = xr[l];
    }
#pragma unroll
    for (int l = 0; l < kWLoads; ++l) {
      const int e = tid + l * kThreads;
      ws[e / kBN][e % kBN] = wr[l];
    }
    __syncthreads();
    // the next chunk's loads are in flight while this chunk's products run
    if (k0 + kBK < k)
      load_chunk(x, w, m, k, n, row0, col0, k0 + kBK, tid, xr, wr);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], bw[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + kThreadsM * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bw[j] = ws[kk][tx + kThreadsN * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = col0 + tx + kThreadsN * j;
    if (col >= n) continue;
    const float bias = to_f32(b[col]);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = row0 + ty + kThreadsM * i;
      if (row < m)
        out[(size_t)row * n + col] = from_f32<T>(activate(acc[i][j] + bias, act));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int m, int k, int n, int act, cudaStream_t stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  fused_dense_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), m, k, n, act);
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
