// Causal / non-causal flash-attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas TPU flash kernel behind
//   deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
//   (jax.experimental.pallas.ops.tpu.flash_attention, forward pallas_call),
// whose lax twin is blockwise_attention's forward (_fwd_q_block). Both of
// the JAX package's "flash" and "blockwise" cores land here on a CUDA
// tensor; the split between them was a TPU scheduling matter.
//
// Computes, over (B, H, T, Dh) row-major inputs:
//   o   = softmax(q k^T / sqrt(Dh) [+ causal mask]) v      (dtype of q)
//   lse = logsumexp of the scaled, masked scores           (f32, (B, H, T))
// with the reference's numerics: scores, running max, running sum and the
// output accumulator are f32; P is rounded to V's dtype before the PV
// product (the einsum on p.astype(v.dtype)); masked scores are -1e30 and the
// row sum is guarded by max(l, 1e-30).
//
// Bound on an H100 SXM: for the serving shape (B=1, H=4, T=2048, Dh=128,
// causal, bf16) the work is 4*B*H*T^2*Dh/2 = 4.29 GFLOP, 4.34 us at the
// 989 TFLOP/s bf16 dense tensor-core rate, against 8.4 MB of q/k/v/o, 2.5 us
// at 3.35 TB/s: the kernel is bound by operations. This first version does
// its arithmetic with f32 FMA on the CUDA cores (67 TFLOP/s peak), not on
// the tensor cores, so it cannot come near that bound; wgmma and TMA are
// the next step.
//
// Design (simple and right first):
// - one thread block of 256 threads per (b*h, 64-row q tile);
// - the q tile is staged once in shared memory as f32, the k/v tiles of 64
//   rows each in turn; rows past T are zero-filled (ragged edges masked);
// - the k/v loop stops at the causal diagonal, so masked tiles cost nothing;
// - each thread owns 4 rows (ty + 16 i) x 4 score columns (tx + 16 j) of the
//   64x64 score tile and the same 4 rows x up to 8 columns (tx + 16 j) of
//   the output accumulator; the online-softmax state of a row lives in the
//   registers of the 16 threads that share it, reduced with xor shuffles;
// - q and k rows are padded to Dh+1 floats so the column reads of the score
//   product are free of bank conflicts.
// Shared memory is 115,456 bytes at Dh=128, above the 48 KB default, so the
// launch first raises the kernel's dynamic shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kColGroups = kMaxDh / 16;  // output columns per thread
constexpr float kNegInf = -1e30f;

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
  return sizeof(float) * (size_t)(kBlockQ * ld + kBlockK * ld + kBlockK * dh +
                                  kBlockQ * (kBlockK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int t, int dh,
                               int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;                  // kBlockQ x ld
  float* ks = qs + kBlockQ * ld;     // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x dh
  float* ps = vs + kBlockK * dh;     // kBlockQ x (kBlockK + 1)
  const int pld = kBlockK + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const size_t base = (size_t)bh * t * dh;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBlockQ * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    const int gr = q0 + r;
    qs[r * ld + c] = gr < t ? to_f32(qb[(size_t)gr * dh + c]) : 0.f;
  }

  float m[4], l[4], acc[4][kColGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (t + kBlockK - 1) / kBlockK;
  const int last_q = min(q0 + kBlockQ, t) - 1;
  const int n_kt = causal ? min(n_tiles, last_q / kBlockK + 1) : n_tiles;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int i = tid; i < kBlockK * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const int gr = k0 + r;
      const bool ok = gr < t;
      ks[r * ld + c] = ok ? to_f32(kb[(size_t)gr * dh + c]) : 0.f;
      vs[r * dh + c] = ok ? to_f32(vb[(size_t)gr * dh + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qr = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < t && (!causal || kc <= qr);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        // P in V's dtype for the PV product; the row sum keeps f32 p
        ps[r * pld + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBlockK, t - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * pld + c];
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) {
        const int dc = tx + 16 * j;
        if (dc < dh) {
          const float vv = vs[c * dh + dc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* ob = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= t) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) {
      const int dc = tx + 16 * j;
      if (dc < dh) ob[(size_t)gr * dh + dc] = from_f32<T>(acc[i][j] / li);
    }
    if (tx == 0) lse[(size_t)bh * t + gr] = m[i] + logf(li);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, int dh, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockQ - 1) / kBlockQ);
  flash_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous (B*H, T, Dh) tensors (lse: (B*H, T) f32); is_bf16 selects the
// element type (0: f32, 1: bf16). Returns cudaGetLastError() of the launch.
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int t, int dh, int causal,
                                        float scale, int is_bf16,
                                        void* stream) {
  if (bh < 1 || t < 1 || dh < 8 || dh > kMaxDh || dh % 8 != 0 ||
      (t + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, lse, bh, t, dh, causal,
                                      scale, s)
              : launch<float>(q, k, v, o, lse, bh, t, dh, causal, scale, s);
  return (int)err;
}
