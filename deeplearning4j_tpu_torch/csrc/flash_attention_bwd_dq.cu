// Flash-attention backward, dQ, for Hopper (sm_90a), on the tensor cores.
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
// Every sum is f32. bf16 inputs multiply as bf16 on the tensor cores, with
// dS rounded to bf16 for the dS k product (as FlashAttention-2's backward
// does); f32 inputs go through the 3xTF32 split and keep f32's accuracy. A
// masked element of P is selected to 0.
//
// Bound on an H100 SXM at the training shape (B=4, H=4, T=2048, Dh=128,
// causal): three products over the causal half (q k^T, do v^T, dS k),
// 3 * 2 * B*H*T^2/2 * Dh = 25.8 GFLOP, against 84 MB (f32) of q, k, v, do,
// lse, delta and dq (0.025 ms at 3.35 TB/s). f32: three TF32 products
// each, 0.156 ms at 495 TFLOP/s; bf16: 0.026 ms at 989. Bound by
// operations at both types.
//
// Design (flash_tiles.cuh has the block shape and the products):
// - one block per (b*h, 64-row q tile) owns q and do in shared memory and
//   walks the 64-key K/V tiles up to the causal diagonal; under causal the
//   late q tiles, which walk the most K/V tiles, launch first (the block
//   index is reversed), so the short ones fill the tail;
// - K and V tiles are double-buffered by cp.async, tile j+1 in flight
//   during the products of tile j, one barrier a tile;
// - each warp computes S = q K^T and dP = do V^T for its 16 queries and 32
//   of the tile's keys: at bf16 q and do are held as A fragments in
//   registers across the walk (as K3f holds Q), at f32 they are read and
//   split from shared memory. lse and delta are indexed by the
//   accumulator's rows and kept in registers. dS stays in registers as the
//   A operand of dQ += dS K, with K as the B operand through
//   ldmatrix.trans (bf16);
// - exp(scale s - lse) is 2^(c s - log2(e) lse) with c = scale log2(e); the
//   causal / T mask is one compare and select an element on the tiles that
//   cross the diagonal or T only, and a warp whose queries all lie before
//   its keys skips the tile;
// - the two warps of each 16 queries take the two 32-key halves of every
//   K/V tile and add their dQ once at the end through shared memory;
// - templated on a head-dim bucket (32, 64, 128): every dh % 8 == 0 up to
//   128 runs, the columns past dh zero;
// - shared memory at Dh=128: q, do and two stages of K and V, 64 rows
//   each, bf16 96 KB, f32 192 KB; one block an SM;
// - the copy width (16, 8, 4 or 2 bytes) follows the inputs' alignment.
// Deterministic: no atomics, one writer for each output element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

template <typename T, int DH>
constexpr int smem_bytes() {
  return 6 * tile_bytes<T, DH>();
}

template <typename T, int DH, bool kVec16>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const float* __restrict__ lse,
                                  const T* __restrict__ dout,
                                  const float* __restrict__ delta,
                                  T* __restrict__ dq, int t, int dh,
                                  int causal, float scale, int width) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kRowBytes = DH * sizeof(T);
  constexpr int kTile = tile_bytes<T, DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;             // the block's 64 queries
  unsigned char* dos = qs + kTile;      // and their do
  unsigned char* ks = dos + kTile;      // two stages of a K tile
  unsigned char* vs = ks + 2 * kTile;   // and of V

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % kRowWarps;  // which 16 queries
  const int kw = warp / kRowWarps;  // which 32 keys of each K/V tile
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x;
  const int n_tiles = (t + kBlock - 1) / kBlock;
  const int q0 =
      (causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y) * kBlock;
  const size_t base = (size_t)bh * t * dh;
  const T* kb = k + base;
  const T* vb = v + base;
  const int last_q = min(q0 + kBlock, t) - 1;
  const int n_kt = causal ? min(n_tiles, last_q / kBlock + 1) : n_tiles;

  // q and do, then the first K/V tile, one commit group each
  stage_rows<T, DH, kBlock, kVec16, kThreads>(qs, q + base, q0, t, dh, width);
  stage_rows<T, DH, kBlock, kVec16, kThreads>(
      dos, dout + base, q0, t, dh, width);
  cp_async_commit();
  stage_rows<T, DH, kBlock, kVec16, kThreads>(ks, kb, 0, t, dh, width);
  stage_rows<T, DH, kBlock, kVec16, kThreads>(vs, vb, 0, t, dh, width);
  cp_async_commit();

  const float c2 = scale * kLog2e;
  const int qr0 = q0 + rw * 16;  // the warp's first query
  const int row = qr0 + g;       // this thread's queries: row, row + 8
  float lc[2], dl[2];            // log2(e) lse and delta of those rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < t;
    lc[h] = ok ? lse[(size_t)bh * t + row + 8 * h] * kLog2e : 0.f;
    dl[h] = ok ? delta[(size_t)bh * t + row + 8 * h] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  uint32_t qf[kF32 ? 1 : DH / 16][4], dof[kF32 ? 1 : DH / 16][4];
  if constexpr (!kF32) {
    cp_async_wait<1>();  // q and do are in the older group
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      lda_bf16<DH>(qf[kk], qs, rw * 16, kk, lane);
      lda_bf16<DH>(dof[kk], dos, rw * 16, kk, lane);
    }
  }
  const F32Lanes<DH> ln(g, qd);  // f32 fragment addressing
  const auto q_frag = [&](int kk, uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = qf[kF32 ? 0 : kk][i];
  };
  const auto do_frag = [&](int kk, uint32_t (&r)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = dof[kF32 ? 0 : kk][i];
  };

  for (int j = 0; j < n_kt; ++j) {
    const int slot = j & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is done with tile j-1
    if (j + 1 < n_kt) {
      const int nx = slot ^ 1, r0 = (j + 1) * kBlock;
      stage_rows<T, DH, kBlock, kVec16, kThreads>(
          ks + nx * kTile, kb, r0, t, dh, width);
      stage_rows<T, DH, kBlock, kVec16, kThreads>(
          vs + nx * kTile, vb, r0, t, dh, width);
    }
    cp_async_commit();

    const int kw0 = j * kBlock + kw * kHalf;  // the warp's first key
    if (kw0 >= t || (causal && kw0 > qr0 + 15)) continue;
    const int off = slot * kTile + kw * kHalf * kRowBytes;
    const unsigned char* kt = ks + off;
    const unsigned char* vt = vs + off;
    const bool edge = (causal && kw0 + kHalf - 1 > qr0) || kw0 + kHalf > t;

    float s[kHalf / 8][4] = {};
    if constexpr (kF32)
      scores_f32<DH, kHalf>(s, qs, rw * 16, kt, ln);
    else
      scores_bf16<DH, kHalf>(s, q_frag, kt, lane);
#pragma unroll
    for (int nb = 0; nb < kHalf / 8; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = fast_exp2(fmaf(s[nb][2 * h + e], c2, -lc[h]));
          if (edge) {
            const int col = kw0 + 8 * nb + 2 * qd + e;
            if (col >= t || (causal && col > row + 8 * h)) p = 0.f;
          }
          s[nb][2 * h + e] = p;
        }

    // dS = P * (dP - delta), delta by row
    float dp[kHalf / 8][4] = {};
    if constexpr (kF32)
      scores_f32<DH, kHalf>(dp, dos, rw * 16, vt, ln);
    else
      scores_bf16<DH, kHalf>(dp, do_frag, vt, lane);
#pragma unroll
    for (int nb = 0; nb < kHalf / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= dp[nb][e] - dl[e >> 1];

    if constexpr (kF32)
      pv_f32<DH, kHalf>(acc, s, kt, ln);
    else
      pv_bf16<DH, kHalf>(acc, s, kt, lane);
  }
  cp_async_wait<0>();

  // the two halves of each 16 queries: kw = 1 hands over its dQ
  static_assert(DH / 2 * kSlots * 4 <= 6 * kTile, "the exchange fits");
  __syncthreads();  // every warp is done with the tiles
  float* x = reinterpret_cast<float*>(smem);
  const int xslot = rw * 32 + lane;
  if (kw == 1) put_acc<DH>(x, xslot, acc);
  __syncthreads();
  if (kw == 0) {
    add_acc<DH>(x, xslot, acc);
    store_rows<T, DH>(dq + base, acc, row, t, dh, scale, qd);
  }
}

template <typename T, int DH, bool kVec16>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lse, const void* dout, const void* delta,
                   void* dq, int bh, int t, int dh, int causal, float scale,
                   int width, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  constexpr int smem = smem_bytes<T, DH>();
  const auto kernel = flash_attention_bwd_dq_kernel<T, DH, kVec16>;
  cudaError_t err = set_smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, dh, causal, scale, width);
  return cudaGetLastError();
}

template <typename T, bool kVec16>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* lse, const void* dout, const void* delta,
                      void* dq, int bh, int t, int dh, int causal,
                      float scale, int width, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32, kVec16>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                                 causal, scale, width, stream);
  if (dh <= 64)
    return launch<T, 64, kVec16>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                                 causal, scale, width, stream);
  return launch<T, 128, kVec16>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                                causal, scale, width, stream);
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         const void* lse, const void* dout, const void* delta,
                         void* dq, int bh, int t, int dh, int causal,
                         float scale, cudaStream_t stream) {
  const int width = bwd_copy_width(q, k, v, dout);
  return width == 16
             ? launch_dh<T, true>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                                  causal, scale, width, stream)
             : launch_dh<T, false>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                                   causal, scale, width, stream);
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
      (t + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_width<__nv_bfloat16>(q, k, v, lse, dout, delta, dq, bh,
                                            t, dh, causal, scale, s)
              : launch_width<float>(q, k, v, lse, dout, delta, dq, bh, t, dh,
                                    causal, scale, s);
  return (int)err;
}
