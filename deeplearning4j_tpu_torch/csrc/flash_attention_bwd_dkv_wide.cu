// Flash-attention backward, dK and dV, for Hopper (sm_90a), on the tensor
// cores, at head dims above 128 up to 256 (flash_attention_bwd_dkv.cu
// takes those up to 128): flash_bwd_split.cuh's column-split kernel at
// its Dh-256 bucket, in every mode, in a library of its own.
//
// Replaces: the Pallas TPU kernel _flash_attention_bwd_dkv of
//   jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at :1121),
// reached from deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
// (:405), at the head dims whose JAX path is the lax blockwise_attention
// (its dk/dv pass, _blockwise_vjp_bwd) and blockwise_block_partials.
//
// Computes what flash_attention_bwd_dkv.cu computes, over q, do (B, H, Tq,
// Dh) and k, v (B, H, Tk, Dh), at any Tq, Tk and causal shift (key j seen
// by row i iff j <= i + shift), from lse and delta (f32 (B, H, Tq); delta
// less the lse's cotangent where the caller has one). bf16 P and dS round
// to bf16 for their products; f32 runs the 3xTF32 split. A masked element
// of P is selected to 0, so a row that sees no key adds nothing.
//
// Bound on an H100 SXM at the Dh-256 flagship's training shape (B=4, H=2,
// T=2048, causal; B*H*T^2*Dh as at 4 heads of 128): 34.4 GFLOP, f32
// 0.208 ms (3xTF32), bf16 0.035 ms; bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_split.cuh"
#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

using flash::BwdArgs;

// The entry point of flash_attention_bwd_dkv.cu, for 128 < dh <= 256
// (cudaErrorInvalidValue otherwise).
extern "C" int dl4j_flash_attention_bwd_dkv_wide(
    const void* q, const void* k, const void* v, const void* lse,
    const void* dout, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int dh, int causal, int shift, float scale, int is_bf16,
    void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || dh <= 128 || dh > 256 || dh % 8 != 0 ||
      (tk + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, lse, dout, delta, dk, dv, bh, tq, tk, dh,
                  causal, causal ? shift : 0, scale,
                  static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 ? flash_split::launch_dkv<__nv_bfloat16, 256>(a)
                       : flash_split::launch_dkv<float, 256>(a));
}
