// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel _flash_attention_bwd_dq of
//   jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at :1456),
// reached from deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
// (:405); its lax twin is the dq pass of _blockwise_vjp_bwd (:237-260).
//
// Computes, over (B, H, T, Dh) row-major inputs, with lse and
// delta = rowsum(do * o) in f32 (B, H, T):
//   P  = exp(q k^T * scale [+ causal mask] - lse)            (f32)
//   dS = P * (do v^T - delta)                                 (f32)
//   dq = dS k * scale                                 (dtype of q)
// Every product accumulates in f32 on inputs upcast to f32, as the JAX VJP
// does. Masked scores contribute exactly zero (exp(-1e30 - lse) = 0).
//
// Bound on an H100 SXM: at the training shape (B=4, H=4, T=2048, Dh=128,
// causal, f32) the kernel does three products over the causal half
// (q k^T, do v^T, dS k): 3 * 2 * B*H*T^2/2 * Dh = 25.8 GFLOP, 0.385 ms at
// the 67 TFLOP/s f32 rate of the CUDA cores, against 84 MB of q, k, v, do,
// lse, delta and dq, 0.025 ms at 3.35 TB/s: bound by operations. This first
// version does f32 FMA on the CUDA cores; mma.sync/wgmma and TMA are the
// next step.
//
// Design (simple and right first; deterministic, no atomics):
// - one thread block of 256 threads per (b*h, 64-row q tile); the q, do
//   tiles are staged once in shared memory as f32, the k/v tiles of 64 rows
//   each in turn; rows past T are zero-filled and masked;
// - the k/v loop stops at the causal diagonal;
// - each thread owns 4 rows (ty + 16 i) x 4 key columns (tx + 16 j) of the
//   64x64 score and dP tiles, computed in one pass over Dh, and the same
//   4 rows x up to 8 head columns (tx + 16 j) of the dq accumulator, kept in
//   registers until the single write at the end;
// - the dS tile goes through shared memory for the dS k product;
// - q, do, k, v rows are padded to Dh+1 floats so the column reads of the
//   score products are free of bank conflicts.
// Shared memory is 148,736 bytes at Dh=128, above the 48 KB default, so the
// launch first raises the kernel's dynamic shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kColGroups = kMaxDh / 16;  // head columns per thread
static_assert(kBlockQ == kBlockK, "stage_rows stages tiles of one height");

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
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int dh) {
  const int ld = dh + 1;
  return sizeof(float) *
         (size_t)(2 * kBlockQ * ld + 2 * kBlockK * ld + kBlockQ * (kBlockK + 1));
}

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int t, int dh, int ld) {
  for (int i = threadIdx.x; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < t ? to_f32(src[(size_t)gr * dh + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const float* __restrict__ lse,
                                  const T* __restrict__ dout,
                                  const float* __restrict__ delta,
                                  T* __restrict__ dq, int t, int dh,
                                  int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  const int pld = kBlockK + 1;
  float* qs = smem;                  // kBlockQ x ld
  float* dos = qs + kBlockQ * ld;    // kBlockQ x ld
  float* ks = dos + kBlockQ * ld;    // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x ld
  float* dss = vs + kBlockK * ld;    // kBlockQ x pld

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const size_t base = (size_t)bh * t * dh;

  stage_rows(qs, q + base, q0, t, dh, ld);
  stage_rows(dos, dout + base, q0, t, dh, ld);

  float lse_r[4], delta_r[4], acc[4][kColGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    lse_r[i] = gr < t ? lse[(size_t)bh * t + gr] : 0.f;
    delta_r[i] = gr < t ? delta[(size_t)bh * t + gr] : 0.f;
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (t + kBlockK - 1) / kBlockK;
  const int last_q = min(q0 + kBlockQ, t) - 1;
  const int n_kt = causal ? min(n_tiles, last_q / kBlockK + 1) : n_tiles;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    stage_rows(ks, k + base, k0, t, dh, ld);
    stage_rows(vs, v + base, k0, t, dh, ld);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dh; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * ld + d];
        dov[i] = dos[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qr = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = qr < t && kc < t && (!causal || kc <= qr);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[r * pld + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    const int kn = min(kBlockK, t - k0);
    for (int c = 0; c < kn; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * pld + c];
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) {
        const int dc = tx + 16 * j;
        if (dc < dh) {
          const float kk = ks[c * ld + dc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
        }
      }
    }
  }

  T* dqb = dq + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= t) continue;
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) {
      const int dc = tx + 16 * j;
      if (dc < dh) dqb[(size_t)gr * dh + dc] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lse, const void* dout, const void* delta,
                   void* dq, int bh, int t, int dh, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockQ - 1) / kBlockQ);
  flash_attention_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous (B*H, T, Dh) tensors (lse, delta: (B*H, T) f32); is_bf16
// selects the element type (0: f32, 1: bf16). Returns cudaGetLastError() of
// the launch.
extern "C" int dl4j_flash_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* lse,
                                           const void* dout,
                                           const void* delta, void* dq,
                                           int bh, int t, int dh, int causal,
                                           float scale, int is_bf16,
                                           void* stream) {
  if (bh < 1 || t < 1 || dh < 8 || dh > kMaxDh || dh % 8 != 0 ||
      (t + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, lse, dout, delta, dq, bh, t,
                                      dh, causal, scale, s)
              : launch<float>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                              causal, scale, s);
  return (int)err;
}
