// Causal / non-causal flash-attention forward for Hopper (sm_90a), on the
// tensor cores, at head dims above 128 up to 256: flash_fwd.cuh's kernel
// at its Dh-256 bucket, in a library of its own, so that its nvcc runs
// beside the narrow source's and leaves the narrow kernels as they are.
//
// Replaces: the same Pallas TPU forward as flash_attention_fwd.cu
//   (deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu),
// at the head dims whose JAX path is the lax blockwise_attention.
//
// Bounds on an H100 SXM at the Dh-256 flagship's shapes (2 heads of 256:
// B*H*T^2*Dh as at 4 heads of 128, so the same work), causal: serving
// B=1 H=2 T=2048 bf16 4.29 GFLOP in 4.34 us; training B=4 H=2 T=2048
// 17.2 GFLOP, bf16 17.4 us, f32 104 us (3xTF32). Bound by operations.

#include "flash_fwd.cuh"

// The entry point of flash_attention_fwd.cu, for 128 < dh <= 256
// (cudaErrorInvalidValue otherwise).
extern "C" int dl4j_flash_attention_fwd_wide(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int bh, int tq,
                                             int tk, int dh, int causal,
                                             int shift, float scale,
                                             int is_bf16, int key_split,
                                             void* stream) {
  return entry<128, 256>(q, k, v, o, lse, bh, tq, tk, dh, causal,
                                    shift, scale, is_bf16, key_split, stream);
}
