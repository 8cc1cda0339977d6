// LSTM cell nonlinearity for Hopper (sm_90a), K2:
//   c_new = sigmoid(f) * c_prev + sigmoid(i) * tanh(g)
//   h_new = sigmoid(o) * tanh(c_new)
// Its backward is K2b (lstm_gates_bwd.cu).
//
// Replaces: the Pallas TPU kernel
//   deeplearning4j_tpu/ops/pallas_kernels.py::_lstm_gates_kernel, launched
//   by _lstm_gates_pallas (pallas_call) behind the public lstm_gates.
// The JAX package runs it only where the shape tiles onto the TPU
// (h % 128, B % 8, h <= 2048: lanes, sublanes and the (tile_b, 7h) VMEM
// working set); this kernel takes every shape.
//
// Inputs: ifog (B, 4H), the fused preactivations in gate order i, f, o, g,
// and c_prev (B, H), each row-major and contiguous, each f32 or bf16 on its
// own. Outputs c_new and h_new (B, H) in c_prev's type. The math is f32
// whatever the storage type, as in the TPU kernel: both outputs are
// rounded once. expf and tanhf (not the __expf intrinsics), and the two
// products and the sum rounded one by one (__fmul_rn, __fadd_rn: no fused
// multiply-add), so that at f32 the kernel computes what PyTorch's
// elementwise ops compute in the plain version.
//
// Bound on an H100 SXM: the kernel moves 7*B*H elements (4H + H read and
// 2H written per row) and does some 30 operations an element, so bytes
// bound it: at the bench's shapes (64x512 and 256x128, f32) 0.92 MB, 0.27
// us at 3.35 TB/s. Either is one wave of one launch, so the time on the
// card is launch latency. On an H100 80GB HBM3 at 700 W (chip_smoke.py's
// launch_floor): an empty kernel launched through dl4j_lstm_gates_empty
// takes 4.8 us between two CUDA events, K2 at 1x1 5.4 us (one thread's
// load, math and store) and at 64x512 6.1 us: 0.6 us for the volume,
// against the 0.27 us bound.
//
// Design: one thread per (b, j). It reads ifog[b, j], ifog[b, H+j],
// ifog[b, 2H+j], ifog[b, 3H+j] and c_prev[b, j], so a warp reads 32
// neighbouring addresses in each of the five streams and writes 32 in each
// of the two outputs. Indices are 64-bit, and a grid-stride loop covers any
// element count. No shared memory: nothing is read twice. 16-byte packs of
// 4 f32 or 8 bf16 elements a thread were slower on the card (6.7 us f32,
// 7.2 bf16 at 64x512 over a 4.9 us floor, against this layout's 6.1 over
// 4.8): a thread's dependent chain of transcendentals grows with its
// elements, and that chain, not the loads, sets the time of one wave.
// Fusing the cell into the recurrent product's epilogue is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 2147483647;  // gridDim.x limit

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

// PyTorch's CUDA sigmoid for float: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename TI, typename TC>
__global__ void __launch_bounds__(kThreads)
    lstm_gates_kernel(const TI* __restrict__ ifog,
                      const TC* __restrict__ c_prev, TC* __restrict__ c_out,
                      TC* __restrict__ h_out, int64_t b, int64_t h) {
  const int64_t n = b * h;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t row = e / h;
    const int64_t j = e - row * h;
    const TI* z = ifog + row * 4 * h + j;
    const float i = sigmoid(to_f32(z[0]));
    const float f = sigmoid(to_f32(z[h]));
    const float o = sigmoid(to_f32(z[2 * h]));
    const float g = tanhf(to_f32(z[3 * h]));
    const float c =
        __fadd_rn(__fmul_rn(f, to_f32(c_prev[e])), __fmul_rn(i, g));
    c_out[e] = from_f32<TC>(c);
    h_out[e] = from_f32<TC>(__fmul_rn(o, tanhf(c)));
  }
}

// Does nothing: launched by dl4j_lstm_gates_empty, it measures the floor
// that any launch costs on the card.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

int64_t grid_blocks(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

template <typename TI, typename TC>
cudaError_t launch(const void* ifog, const void* c_prev, void* c_out,
                   void* h_out, int64_t b, int64_t h, cudaStream_t stream) {
  lstm_gates_kernel<TI, TC><<<(unsigned)grid_blocks(b * h), kThreads, 0,
                               stream>>>(
      static_cast<const TI*>(ifog), static_cast<const TC*>(c_prev),
      static_cast<TC*>(c_out), static_cast<TC*>(h_out), b, h);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous ifog (b, 4h), c_prev (b, h), c_out (b, h) and h_out (b, h).
// ifog_bf16 and c_bf16 select the element types (0: f32, 1: bf16) of ifog
// and of c_prev and the outputs. An empty output launches nothing.
// Returns cudaGetLastError() of the launch.
extern "C" int dl4j_lstm_gates(const void* ifog, const void* c_prev,
                               void* c_out, void* h_out, long long b,
                               long long h, int ifog_bf16, int c_bf16,
                               void* stream) {
  if (b < 0 || h < 0 || (h > 0 && b > INT64_MAX / (4 * h)))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ifog_bf16) {
    err = c_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(ifog, c_prev, c_out,
                                                         h_out, b, h, s)
                 : launch<__nv_bfloat16, float>(ifog, c_prev, c_out, h_out,
                                                b, h, s);
  } else {
    err = c_bf16 ? launch<float, __nv_bfloat16>(ifog, c_prev, c_out, h_out,
                                                b, h, s)
                 : launch<float, float>(ifog, c_prev, c_out, h_out, b, h, s);
  }
  return (int)err;
}

// The launch floor: an empty kernel on the grid dl4j_lstm_gates launches
// for (b, h), through the same ctypes path. Returns cudaGetLastError().
extern "C" int dl4j_lstm_gates_empty(long long b, long long h, void* stream) {
  if (b <= 0 || h <= 0 || b > INT64_MAX / h)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<(unsigned)grid_blocks(b * h), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
