// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel _flash_attention_bwd_dkv of
//   jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at :1121),
// reached from deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
// (:405); its lax twin is the dk/dv pass of _blockwise_vjp_bwd (:262-311).
//
// Computes, over (B, H, T, Dh) row-major inputs, with lse and
// delta = rowsum(do * o) in f32 (B, H, T):
//   P  = exp(q k^T * scale [+ causal mask] - lse)            (f32)
//   dv = P^T do                                        (dtype of v)
//   dk = (P * (do v^T - delta))^T q * scale            (dtype of k)
// Every product accumulates in f32 on inputs upcast to f32, as the JAX VJP
// does. Masked scores contribute exactly zero (exp(-1e30 - lse) = 0).
//
// Bound on an H100 SXM: at the training shape (B=4, H=4, T=2048, Dh=128,
// causal, f32) the kernel does four products over the causal half
// (q k^T, do v^T, P^T do, dS^T q): 4 * 2 * B*H*T^2/2 * Dh = 34.4 GFLOP,
// 0.513 ms at the 67 TFLOP/s f32 rate of the CUDA cores, against 101 MB of
// q, k, v, do, lse, delta, dk and dv, 0.030 ms at 3.35 TB/s: bound by
// operations. This first version does f32 FMA on the CUDA cores;
// mma.sync/wgmma and TMA are the next step.
//
// Design (simple and right first; deterministic, no atomics):
// - one thread block of 256 threads per (b*h, 64-row k/v tile); the k and v
//   tiles are staged once in shared memory as f32, then the block loops over
//   the 64-row q/do tiles that see its keys: under causal it starts at the
//   diagonal tile (the JAX VJP's start = (j*bk)//bq);
// - each thread owns 4 key rows (ty + 16 i) x 4 query columns (tx + 16 j)
//   of the transposed 64x64 score and dP tiles, computed in one pass over
//   Dh; P and dS go through shared memory for the two products over q rows;
// - the dk and dv accumulators (4 key rows x up to 8 head columns each, 64
//   floats a thread) stay in registers for the whole loop and are written
//   once: a 64x128 f32 pair would not fit in shared memory beside the tiles;
// - q, do, k, v rows are padded to Dh+1 floats so the column reads of the
//   score products are free of bank conflicts; rows past T are zero-filled
//   and masked.
// Shared memory is 165,888 bytes at Dh=128, above the 48 KB default, so the
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
  return sizeof(float) * (size_t)(2 * kBlockK * ld + 2 * kBlockQ * ld +
                                  2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
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
    flash_attention_bwd_dkv_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const float* __restrict__ lse,
                                   const T* __restrict__ dout,
                                   const float* __restrict__ delta,
                                   T* __restrict__ dk, T* __restrict__ dv,
                                   int t, int dh, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  const int pld = kBlockQ + 1;
  float* ks = smem;                  // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x ld
  float* qs = vs + kBlockK * ld;     // kBlockQ x ld
  float* dos = qs + kBlockQ * ld;    // kBlockQ x ld
  float* ps = dos + kBlockQ * ld;    // kBlockK x pld: P^T
  float* dss = ps + kBlockK * pld;   // kBlockK x pld: dS^T
  float* lses = dss + kBlockK * pld;  // kBlockQ
  float* deltas = lses + kBlockQ;     // kBlockQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kBlockK;
  const size_t base = (size_t)bh * t * dh;

  stage_rows(ks, k + base, k0, t, dh, ld);
  stage_rows(vs, v + base, k0, t, dh, ld);

  float acc_k[4][kColGroups], acc_v[4][kColGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_tiles = (t + kBlockQ - 1) / kBlockQ;
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // the previous tile's readers are done with q/do/P/dS
    stage_rows(qs, q + base, q0, t, dh, ld);
    stage_rows(dos, dout + base, q0, t, dh, ld);
    if (tid < kBlockQ) {
      const int gr = q0 + tid;
      lses[tid] = gr < t ? lse[(size_t)bh * t + gr] : 0.f;
      deltas[tid] = gr < t ? delta[(size_t)bh * t + gr] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dh; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * ld + d];
        vv[i] = vs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * ld + d];
        dov[j] = dos[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int kr = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qc = q0 + c;
        const bool ok = kr < t && qc < t && (!causal || kr <= qc);
        const float p = ok ? expf(s[i][j] * scale - lses[c]) : 0.f;
        ps[r * pld + c] = p;
        dss[r * pld + c] = p * (dp[i][j] - deltas[c]);
      }
    }
    __syncthreads();

    const int qn = min(kBlockQ, t - q0);
    for (int c = 0; c < qn; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty + 16 * i) * pld + c];
        dsv[i] = dss[(ty + 16 * i) * pld + c];
      }
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) {
        const int dc = tx + 16 * j;
        if (dc < dh) {
          const float qq = qs[c * ld + dc];
          const float dd = dos[c * ld + dc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(pv[i], dd, acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qq, acc_k[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + base;
  T* dvb = dv + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = k0 + ty + 16 * i;
    if (gr >= t) continue;
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) {
      const int dc = tx + 16 * j;
      if (dc < dh) {
        dkb[(size_t)gr * dh + dc] = from_f32<T>(acc_k[i][j] * scale);
        dvb[(size_t)gr * dh + dc] = from_f32<T>(acc_v[i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lse, const void* dout, const void* delta,
                   void* dk, void* dv, int bh, int t, int dh, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockK - 1) / kBlockK);
  flash_attention_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, dh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous (B*H, T, Dh) tensors (lse, delta: (B*H, T) f32); is_bf16
// selects the element type (0: f32, 1: bf16). Returns cudaGetLastError() of
// the launch.
extern "C" int dl4j_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* lse,
                                            const void* dout,
                                            const void* delta, void* dk,
                                            void* dv, int bh, int t, int dh,
                                            int causal, float scale,
                                            int is_bf16, void* stream) {
  if (bh < 1 || t < 1 || dh < 8 || dh > kMaxDh || dh % 8 != 0 ||
      (t + kBlockK - 1) / kBlockK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, lse, dout, delta, dk, dv, bh,
                                      t, dh, causal, scale, s)
              : launch<float>(q, k, v, lse, dout, delta, dk, dv, bh, t, dh,
                              causal, scale, s);
  return (int)err;
}
