// LSTM cell backward for Hopper (sm_90a), K2b: from the forward's inputs
// and c_new, and the incoming grads dc_new and dh,
//   do      = dh * tanh(c_new)
//   dc      = dc_new + dh * o * (1 - tanh(c_new)^2)
//   d_ifog  = [dc*g * i*(1-i), dc*c_prev * f*(1-f), do * o*(1-o),
//              dc*i * (1-g^2)]                    (gate order i, f, o, g)
//   dc_prev = dc * f
// with i, f, o = sigmoid of their preactivations and g = tanh of its own.
//
// Replaces: no Pallas kernel. The JAX package's backward of lstm_gates is
// lax (deeplearning4j_tpu/ops/pallas_kernels.py::_lstm_gates_bwd, beside
// the Pallas forward _lstm_gates_pallas, K2), which XLA fuses into the
// scan's backward; eager PyTorch dispatches it as 28 device kernels a
// timestep. This kernel is that fusion, written by hand.
//
// Inputs: ifog (B, 4H), f32 or bf16, c_prev and c_new (B, H), f32 or bf16,
// all contiguous; dc_new and dh (B, H) in c's type, each with its own row
// stride (inner stride 1) so that a grad that arrives as a row view of a
// wider tensor (the (B, T, H) grad of torch.stack's output, or a slice of a
// concatenation's grad) is read in place, or null, read as zero (autograd
// leaves the last timestep's dc_new undefined). Outputs d_ifog (B, 4H) in
// ifog's type and dc_prev (B, H) in c's type, contiguous. The math is f32
// whatever the storage type, each output rounded once. The residuals
// sigmoid(i), sigmoid(f), sigmoid(o), tanh(g) and tanh(c_new) are
// recomputed in registers: saving them in the forward would cost five more
// (B, H) streams written and read, against some 20 operations an element
// here. expf and tanhf (not the __expf intrinsics), and every product, sum
// and difference rounded one by one (__fmul_rn, __fadd_rn, __fsub_rn: no
// fused multiply-add), in the plain version's order, so that at f32 the
// kernel computes what PyTorch's elementwise ops compute there.
//
// Bound on an H100 SXM: the kernel moves 13*B*H elements (4H + 4H of ifog
// and d_ifog, H each of c_prev, c_new, dc_new, dh and dc_prev a row; 12
// without dc_new) and does some 45 operations an element, so bytes bound
// it: at the bench's shapes (64x512 and 256x128, f32) 1.70 MB, 0.51 us at
// 3.35 TB/s. Both are one wave of blocks, so launch latency sets the time,
// as it does for K2; what the kernel buys is one launch where eager
// PyTorch made 28.
//
// Design: one thread per (b, j), as K2: a warp reads 32 neighbouring
// addresses in each of the eight input streams and writes 32 in each of
// the five output streams. Indices are 64-bit and a grid-stride loop
// covers any element count. No shared memory: nothing is read twice.

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

// (x * s) * (1 - s): a sigmoid gate's grad, in torch's left-to-right order
__device__ __forceinline__ float sigmoid_grad(float x, float s) {
  return __fmul_rn(__fmul_rn(x, s), __fsub_rn(1.f, s));
}

template <typename TI, typename TC>
__global__ void __launch_bounds__(kThreads) lstm_gates_bwd_kernel(
    const TI* __restrict__ ifog, const TC* __restrict__ c_prev,
    const TC* __restrict__ c_new, const TC* __restrict__ dc_new,
    int64_t dc_stride, const TC* __restrict__ dh, int64_t dh_stride,
    TI* __restrict__ d_ifog, TC* __restrict__ dc_prev, int64_t b,
    int64_t h) {
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
    const float tc = tanhf(to_f32(c_new[e]));
    const float gh = dh ? to_f32(dh[row * dh_stride + j]) : 0.f;
    const float gc = dc_new ? to_f32(dc_new[row * dc_stride + j]) : 0.f;
    const float d_o = __fmul_rn(gh, tc);
    const float dc = __fadd_rn(
        gc, __fmul_rn(__fmul_rn(gh, o), __fsub_rn(1.f, __fmul_rn(tc, tc))));
    TI* dz = d_ifog + row * 4 * h + j;
    dz[0] = from_f32<TI>(sigmoid_grad(__fmul_rn(dc, g), i));
    dz[h] = from_f32<TI>(sigmoid_grad(__fmul_rn(dc, to_f32(c_prev[e])), f));
    dz[2 * h] = from_f32<TI>(sigmoid_grad(d_o, o));
    dz[3 * h] = from_f32<TI>(
        __fmul_rn(__fmul_rn(dc, i), __fsub_rn(1.f, __fmul_rn(g, g))));
    dc_prev[e] = from_f32<TC>(__fmul_rn(dc, f));
  }
}

template <typename TI, typename TC>
cudaError_t launch(const void* ifog, const void* c_prev, const void* c_new,
                   const void* dc_new, int64_t dc_stride, const void* dh,
                   int64_t dh_stride, void* d_ifog, void* dc_prev, int64_t b,
                   int64_t h, cudaStream_t stream) {
  const int64_t n = b * h;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lstm_gates_bwd_kernel<TI, TC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TI*>(ifog), static_cast<const TC*>(c_prev),
      static_cast<const TC*>(c_new), static_cast<const TC*>(dc_new),
      dc_stride, static_cast<const TC*>(dh), dh_stride,
      static_cast<TI*>(d_ifog), static_cast<TC*>(dc_prev), b, h);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous ifog (b, 4h), c_prev (b, h), c_new (b, h), d_ifog (b, 4h) and
// dc_prev (b, h), and of dc_new and dh (b, h) with row strides dc_stride
// and dh_stride (in elements, inner stride 1); dc_new or dh may be null,
// read as zero. ifog_bf16 and c_bf16 select the element types (0: f32, 1:
// bf16) of ifog and d_ifog, and of the other five. An empty output
// launches nothing. Returns cudaGetLastError() of the launch.
extern "C" int dl4j_lstm_gates_bwd(const void* ifog, const void* c_prev,
                                   const void* c_new, const void* dc_new,
                                   long long dc_stride, const void* dh,
                                   long long dh_stride, void* d_ifog,
                                   void* dc_prev, long long b, long long h,
                                   int ifog_bf16, int c_bf16, void* stream) {
  if (b < 0 || h < 0 || dc_stride < 0 || dh_stride < 0 ||
      (h > 0 && b > INT64_MAX / (4 * h)))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ifog_bf16) {
    err = c_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                       ifog, c_prev, c_new, dc_new, dc_stride, dh, dh_stride,
                       d_ifog, dc_prev, b, h, s)
                 : launch<__nv_bfloat16, float>(ifog, c_prev, c_new, dc_new,
                                                dc_stride, dh, dh_stride,
                                                d_ifog, dc_prev, b, h, s);
  } else {
    err = c_bf16 ? launch<float, __nv_bfloat16>(ifog, c_prev, c_new, dc_new,
                                                dc_stride, dh, dh_stride,
                                                d_ifog, dc_prev, b, h, s)
                 : launch<float, float>(ifog, c_prev, c_new, dc_new,
                                        dc_stride, dh, dh_stride, d_ifog,
                                        dc_prev, b, h, s);
  }
  return (int)err;
}
