// Flash-attention backward, dK and dV, for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces: the Pallas TPU kernel _flash_attention_bwd_dkv of
//   jax.experimental.pallas.ops.tpu.flash_attention (pallas_call at :1121),
// reached from deeplearning4j_tpu/ops/flash_attention.py::_flash_attention_tpu
// (:405); its lax twin is the dk/dv pass of _blockwise_vjp_bwd (:262-311).
//
// Computes, over row-major q, do (B, H, Tq, Dh) and k, v (B, H, Tk, Dh),
// with lse and delta = rowsum(do * o) in f32 (B, H, Tq):
//   P  = exp(q k^T * scale [+ causal mask] - lse)            (f32)
//   dv = P^T do                                        (dtype of v)
//   dk = (P * (do v^T - delta))^T q * scale            (dtype of k)
// Under causal, key j is seen by row i iff j <= i + shift (K3f's shifted
// diagonal: a pair of blockwise_block_partials at its global offsets;
// attention over one sequence is Tq == Tk, shift 0). A caller with an lse
// cotangent passes delta - dlse: dS = P * (dP - delta + dlse). The kernel
// below takes attention over one sequence; Tq != Tk or a shift runs
// flash_bwd_split.cuh's column-split kernel at the same head-dim buckets.
// Every sum is f32. bf16 inputs multiply as bf16 on the tensor cores, with
// P and dS rounded to bf16 for the two products that take them (as
// FlashAttention-2's backward does); f32 inputs go through the 3xTF32
// split and keep f32's accuracy. A masked element of P is selected to 0.
//
// Bound on an H100 SXM at the training shape (B=4, H=4, T=2048, Dh=128,
// causal): four products over the causal half (k q^T, v do^T, P^T do,
// dS^T q), 4 * 2 * B*H*T^2/2 * Dh = 34.4 GFLOP, against 101 MB (f32) of
// q, k, v, do, lse, delta, dk and dv (0.030 ms at 3.35 TB/s). f32: three
// TF32 products each, 0.208 ms at 495 TFLOP/s; bf16: 0.035 ms at 989.
// Bound by operations at both types.
//
// Design (flash_tiles.cuh has the block shape and the products):
// - one block per (b*h, 64-key tile) owns K and V in shared memory and
//   walks the 64-row q tiles that see its keys, from the causal diagonal
//   (the JAX VJP's start = (j*bk)//bq); the early key tiles, which walk
//   the most q tiles, have the lowest block index and launch first;
// - q, do and their lse, delta rows are double-buffered by cp.async, tile
//   i+1 in flight during the products of tile i, one barrier a tile;
// - each warp computes the transposed tiles S^T = K q^T and dP^T = V do^T
//   for its 16 keys and 32 of the tile's queries, keys as rows: K and V are
//   the A operand, q and do rows the B operand (ldmatrix at bf16). lse and
//   delta are indexed by the accumulator's columns. P^T and dS^T then stay
//   in registers as the A operand of dV += P^T do and dK += dS^T q, with do
//   and q as the B operand through ldmatrix.trans (bf16);
// - exp(scale s - lse) is 2^(c s - log2(e) lse) with c = scale log2(e):
//   one multiply-add and one ex2 an element; the causal / T mask is one
//   compare and select an element, on the tiles that cross the diagonal or
//   T only, and a warp whose keys all lie past its queries skips the tile;
// - the two warps of each 16 keys take the two 32-query halves of every q
//   tile and add their dK, dV once at the end through shared memory (one
//   writes dK, the other dV), so a warp holds 2 x 16 x Dh f32 accumulators
//   (128 registers a thread at Dh=128) and the block 8 warps. At f32 and
//   Dh=128 ptxas still spills a little (chip_smoke.py phase 1 prints it).
//   Two layouts tried on the card were slower and spilled as much or more:
//   dK and dV split by head-dim columns across the pair (P and dS through
//   shared memory, FlashAttention-2's layout), and the 32 queries taken in
//   two passes of 16;
// - templated on a head-dim bucket (32, 64, 128): every dh % 8 == 0 up to
//   128 runs, the columns past dh zero (flash_attention_bwd_dkv_wide.cu
//   takes the head dims above);
// - shared memory at Dh=128: K, V and two stages of q and do, 64 rows each,
//   bf16 96 KB, f32 192 KB, plus 1 KB of lse and delta; one block an SM;
// - the copy width (16, 8, 4 or 2 bytes) follows the inputs' alignment.
// Deterministic: no atomics, one writer for each output element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_bwd_split.cuh"
#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

template <typename T, int DH>
constexpr int smem_bytes() {
  return 6 * tile_bytes<T, DH>() + 4 * kBlock * (int)sizeof(float);
}

template <typename T, int DH, bool kVec16>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkv_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const float* __restrict__ lse,
                                   const T* __restrict__ dout,
                                   const float* __restrict__ delta,
                                   T* __restrict__ dk, T* __restrict__ dv,
                                   int t, int dh, int causal, float scale,
                                   int width) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kRowBytes = DH * sizeof(T);
  constexpr int kTile = tile_bytes<T, DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;              // the block's 64 keys
  unsigned char* vs = ks + kTile;        // and values
  unsigned char* qs = vs + kTile;        // two stages of a q tile
  unsigned char* dos = qs + 2 * kTile;   // and of do
  float* ls = reinterpret_cast<float*>(dos + 2 * kTile);  // 2 x lse rows
  float* ds = ls + 2 * kBlock;                             // 2 x delta rows

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % kRowWarps;  // which 16 keys
  const int kw = warp / kRowWarps;  // which 32 queries of each q tile
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * t * dh;
  const T* qb = q + base;
  const T* dob = dout + base;
  const float* lb = lse + (size_t)bh * t;
  const float* db = delta + (size_t)bh * t;

  const int n_tiles = (t + kBlock - 1) / kBlock;
  const int first = causal ? (int)blockIdx.y : 0;

  stage_rows<T, DH, kBlock, kVec16, kThreads>(ks, k + base, k0, t, dh, width);
  stage_rows<T, DH, kBlock, kVec16, kThreads>(vs, v + base, k0, t, dh, width);
  stage_rows<T, DH, kBlock, kVec16, kThreads>(
      qs, qb, first * kBlock, t, dh, width);
  stage_rows<T, DH, kBlock, kVec16, kThreads>(
      dos, dob, first * kBlock, t, dh, width);
  stage_vec(ls, lb, first * kBlock, t, 0);
  stage_vec(ds, db, first * kBlock, t, kBlock);
  cp_async_commit();

  float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const float c2 = scale * kLog2e;
  const int key0 = k0 + rw * 16;  // the warp's first key
  const int key = key0 + g;       // this thread's keys: key, key + 8
  const F32Lanes<DH> ln(g, qd);  // f32 fragment addressing
  const auto k_frag = [&](int kk, uint32_t (&r)[4]) {
    lda_bf16<DH>(r, ks, rw * 16, kk, lane);
  };
  const auto v_frag = [&](int kk, uint32_t (&r)[4]) {
    lda_bf16<DH>(r, vs, rw * 16, kk, lane);
  };

  for (int i = first; i < n_tiles; ++i) {
    const int slot = (i - first) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile i landed; every warp is done with tile i-1
    if (i + 1 < n_tiles) {
      const int nx = slot ^ 1, r0 = (i + 1) * kBlock;
      stage_rows<T, DH, kBlock, kVec16, kThreads>(
          qs + nx * kTile, qb, r0, t, dh, width);
      stage_rows<T, DH, kBlock, kVec16, kThreads>(
          dos + nx * kTile, dob, r0, t, dh, width);
      stage_vec(ls + nx * kBlock, lb, r0, t, 0);
      stage_vec(ds + nx * kBlock, db, r0, t, kBlock);
    }
    cp_async_commit();

    const int qw0 = i * kBlock + kw * kHalf;  // the warp's first query
    if (qw0 >= t || (causal && key0 > qw0 + kHalf - 1)) continue;
    const int off = slot * kTile + kw * kHalf * kRowBytes;
    const unsigned char* qt = qs + off;
    const unsigned char* dot = dos + off;
    const float* lt = ls + slot * kBlock + kw * kHalf;
    const float* dt = ds + slot * kBlock + kw * kHalf;
    const bool edge = (causal && key0 + 15 > qw0) || qw0 + kHalf > t;

    // P^T: rows are keys, columns queries
    float s[kHalf / 8][4] = {};
    if constexpr (kF32)
      scores_f32<DH, kHalf>(s, ks, rw * 16, qt, ln);
    else
      scores_bf16<DH, kHalf>(s, k_frag, qt, lane);
#pragma unroll
    for (int nb = 0; nb < kHalf / 8; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * nb + 2 * qd);
      const float lc[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = fast_exp2(fmaf(s[nb][2 * h + e], c2, -lc[e]));
          if (edge) {
            const int col = qw0 + 8 * nb + 2 * qd + e;
            if (col >= t || (causal && key + 8 * h > col)) p = 0.f;
          }
          s[nb][2 * h + e] = p;
        }
    }
    if constexpr (kF32)
      pv_f32<DH, kHalf>(acc_v, s, dot, ln);
    else
      pv_bf16<DH, kHalf>(acc_v, s, dot, lane);

    // dS^T = P^T * (dP^T - delta), delta by column
    float dp[kHalf / 8][4] = {};
    if constexpr (kF32)
      scores_f32<DH, kHalf>(dp, vs, rw * 16, dot, ln);
    else
      scores_bf16<DH, kHalf>(dp, v_frag, dot, lane);
#pragma unroll
    for (int nb = 0; nb < kHalf / 8; ++nb) {
      const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * nb + 2 * qd);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[nb][2 * h] *= dp[nb][2 * h] - d2.x;
        s[nb][2 * h + 1] *= dp[nb][2 * h + 1] - d2.y;
      }
    }
    if constexpr (kF32)
      pv_f32<DH, kHalf>(acc_k, s, qt, ln);
    else
      pv_bf16<DH, kHalf>(acc_k, s, qt, lane);
  }
  cp_async_wait<0>();

  // the two halves of each 16 keys: kw = 1 hands over its dK and writes
  // dV, kw = 0 hands over its dV and writes dK
  static_assert(DH * kSlots * 4 <= 6 * kTile, "the exchange fits");
  __syncthreads();  // every warp is done with the tiles
  float* x = reinterpret_cast<float*>(smem);
  const int xslot = rw * 32 + lane;
  if (kw == 0)
    put_acc<DH>(x, xslot, acc_v);
  else
    put_acc<DH>(x + (DH / 2) * kSlots, xslot, acc_k);
  __syncthreads();
  if (kw == 0) {
    add_acc<DH>(x + (DH / 2) * kSlots, xslot, acc_k);
    store_rows<T, DH>(dk + base, acc_k, key, t, dh, scale, qd);
  } else {
    add_acc<DH>(x, xslot, acc_v);
    store_rows<T, DH>(dv + base, acc_v, key, t, dh, 1.f, qd);
  }
}

template <typename T, int DH, bool kVec16>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lse, const void* dout, const void* delta,
                   void* dk, void* dv, int bh, int t, int dh, int causal,
                   float scale, int width, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  constexpr int smem = smem_bytes<T, DH>();
  const auto kernel = flash_attention_bwd_dkv_kernel<T, DH, kVec16>;
  cudaError_t err = set_smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, dh, causal, scale, width);
  return cudaGetLastError();
}

template <typename T, bool kVec16>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* lse, const void* dout, const void* delta,
                      void* dk, void* dv, int bh, int t, int dh, int causal,
                      float scale, int width, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32, kVec16>(q, k, v, lse, dout, delta, dk, dv, bh, t,
                                 dh, causal, scale, width, stream);
  if (dh <= 64)
    return launch<T, 64, kVec16>(q, k, v, lse, dout, delta, dk, dv, bh, t,
                                 dh, causal, scale, width, stream);
  return launch<T, 128, kVec16>(q, k, v, lse, dout, delta, dk, dv, bh, t, dh,
                                causal, scale, width, stream);
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         const void* lse, const void* dout, const void* delta,
                         void* dk, void* dv, int bh, int t, int dh,
                         int causal, float scale, cudaStream_t stream) {
  const int width = bwd_copy_width(q, k, v, dout);
  return width == 16
             ? launch_dh<T, true>(q, k, v, lse, dout, delta, dk, dv, bh, t,
                                  dh, causal, scale, width, stream)
             : launch_dh<T, false>(q, k, v, lse, dout, delta, dk, dv, bh, t,
                                   dh, causal, scale, width, stream);
}

}  // namespace

// Plain C entry point bound with ctypes. Pointers are device pointers of
// contiguous q, do (B*H, Tq, Dh) and k, v, dk, dv (B*H, Tk, Dh) tensors
// (lse, delta: (B*H, Tq) f32); shift is the causal diagonal's (key j seen
// by row i iff j <= i + shift; ignored without causal); is_bf16 selects
// the element type (0: f32, 1: bf16). Returns cudaGetLastError() of the
// launch.
extern "C" int dl4j_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* lse,
                                            const void* dout,
                                            const void* delta, void* dk,
                                            void* dv, int bh, int tq, int tk,
                                            int dh, int causal, int shift,
                                            float scale, int is_bf16,
                                            void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || dh < 8 || dh > kMaxDh || dh % 8 != 0 ||
      (tk + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tq == tk && !(causal && shift != 0))
    return (int)(is_bf16
                     ? launch_width<__nv_bfloat16>(q, k, v, lse, dout, delta,
                                                   dk, dv, bh, tq, dh, causal,
                                                   scale, s)
                     : launch_width<float>(q, k, v, lse, dout, delta, dk, dv,
                                           bh, tq, dh, causal, scale, s));
  const BwdArgs a{q, k, v, lse, dout, delta, dk, dv, bh, tq, tk, dh,
                  causal, causal ? shift : 0, scale, s};
  return (int)(is_bf16 ? flash_split::launch_dkv<__nv_bfloat16, 32, 64, 128>(a)
                       : flash_split::launch_dkv<float, 32, 64, 128>(a));
}
