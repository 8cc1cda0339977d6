// Causal / non-causal flash-attention forward for Hopper (sm_90a), on the
// tensor cores, at head dims up to 128 (flash_attention_fwd_wide.cu takes
// those above, up to 256). The kernel, its bounds and its design are
// flash_fwd.cuh's.
//
// Replaces: the Pallas TPU flash kernel behind
//   deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
//   (jax.experimental.pallas.ops.tpu.flash_attention, forward pallas_call),
// whose lax twin is blockwise_attention's forward (_fwd_q_block). Both of
// the JAX package's "flash" and "blockwise" cores land here on a CUDA
// tensor; the split between them was a TPU scheduling matter.

#include "flash_fwd.cuh"

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous q and o (B*H, Tq, Dh) and k, v (B*H, Tk, Dh) tensors (lse:
// (B*H, Tq) f32); shift is the causal diagonal's (key j seen by row i iff
// j <= i + shift; ignored without causal); is_bf16 selects the element
// type (0: f32, 1: bf16); key_split the launch (0: the rule of
// launch_width, 1: 4 warps a block, 2: 8 warps splitting each K/V tile's
// keys). Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a head dim above 128.
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int tq, int tk, int dh,
                                        int causal, int shift, float scale,
                                        int is_bf16, int key_split,
                                        void* stream) {
  return entry<0, 32, 64, 128>(q, k, v, o, lse, bh, tq, tk, dh,
                                          causal, shift, scale, is_bf16,
                                          key_split, stream);
}
