// Flash-attention backward, dQ, for Hopper (sm_90a), on the tensor
// cores, at head dims above 128 up to 256 (flash_attention_bwd_dq.cu
// takes those up to 128): flash_bwd_split.cuh's column-split kernel at
// its Dh-256 bucket, in every mode, in a library of its own.
//
// Replaces: the Pallas TPU kernel _flash_attention_bwd_dq of
//   jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at :1456),
// reached from deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
// (:405), at the head dims whose JAX path is the lax blockwise_attention
// (its dq pass, _blockwise_vjp_bwd) and blockwise_block_partials.
//
// Computes what flash_attention_bwd_dq.cu computes, over q, do (B, H, Tq,
// Dh) and k, v (B, H, Tk, Dh), at any Tq, Tk and causal shift, from lse
// and delta (f32 (B, H, Tq); delta less the lse's cotangent where the
// caller has one). bf16 dS rounds to bf16 for its product; f32 runs the
// 3xTF32 split. A masked element of P is selected to 0.
//
// Bound on an H100 SXM at the Dh-256 flagship's training shape (B=4, H=2,
// T=2048, causal): 25.8 GFLOP, f32 0.156 ms (3xTF32), bf16 0.026 ms;
// bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_split.cuh"
#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

using flash::BwdArgs;

// The entry point of flash_attention_bwd_dq.cu, for 128 < dh <= 256
// (cudaErrorInvalidValue otherwise).
extern "C" int dl4j_flash_attention_bwd_dq_wide(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, const void* delta, void* dq, int bh, int tq,
    int tk, int dh, int causal, int shift, float scale, int is_bf16,
    void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || dh <= 128 || dh > 256 || dh % 8 != 0 ||
      (tq + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, lse, dout, delta, dq, nullptr, bh, tq, tk, dh,
                  causal, causal ? shift : 0, scale,
                  static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 ? flash_split::launch_dq<__nv_bfloat16, 256>(a)
                       : flash_split::launch_dq<float, 256>(a));
}
