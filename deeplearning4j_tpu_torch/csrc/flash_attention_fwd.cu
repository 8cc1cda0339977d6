// Causal / non-causal flash-attention forward for Hopper (sm_90a), on the
// tensor cores.
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
// product, as the reference's p.astype(v.dtype) does (the row sum keeps
// the f32 p); masked scores are -1e30 and the row sum is guarded by
// max(l, 1e-30). lse = m + log(max(l, 1e-30)) is what the backward
// kernels read.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 dense tensor-core
// rates, 3.35 TB/s), causal, Dh=128:
// - serving, B=1 H=4 T=2048 bf16: 4.29 GFLOP in 4.34 us against 8.4 MB in
//   2.5 us: bound by operations;
// - training, B=4 H=4 T=2048: 17.2 GFLOP. bf16: 17.4 us of operations
//   against 33.7 MB, 10.0 us. f32 (three TF32 products each): 104 us of
//   operations against 67.2 MB, 20.1 us; on the CUDA cores' 67 TFLOP/s it
//   would be 256 us. Bound by operations at both types.
//
// Design (FlashAttention-2's online softmax on mma.sync; wgmma and TMA are
// a later step; the staging and the tile products are flash_tiles.cuh's,
// shared with the backward pair):
// - one block per (b*h, 64-row q tile), 4 warps along the tile, 16 rows
//   each; under causal the q tiles launch heaviest first (the block index
//   is reversed), so the short tiles near the start fill the tail;
// - key split: at f32, and at bf16 when the grid cannot give every SM two
//   blocks (serving's B*H = 4: 128 blocks), the block has 8 warps, and the
//   two warps of each 16 rows take the two halves of every K/V tile, each
//   with its own online softmax; they merge (m, l, acc) once at the end
//   through shared memory. That halves the sequential walk over the keys,
//   which is what bounds the serving shape (its time is flat in H and in
//   causal). Else two 4-warp blocks share an SM;
// - Q is staged once; K and V tiles are double-buffered by cp.async, tile
//   j+1 in flight during the products of tile j, one barrier a tile.
//   Shared tiles are XOR-swizzled (hopper_mma.cuh) instead of padded, so
//   ldmatrix and the f32 fragment loads are free of bank conflicts. Rows
//   past T and columns past dh are zero-filled by the copy (src-size 0);
// - bf16: Q is held as m16n8k16 A fragments in registers, S = Q K^T comes
//   from ldmatrix'ed K fragments (those of step kk+1 loaded before the
//   products of step kk), P is packed to bf16 in registers (the
//   accumulator pairs are the next product's A fragment) and multiplied by
//   V through ldmatrix.trans, with no trip through shared memory;
// - the online softmax runs on the f32 accumulator layout: each thread
//   holds 2 rows, the row max is reduced over the quad with shuffles, and
//   exp(scale s - m) is 2^(c s - c m) with c = scale log2(e): one
//   multiply-add and one ex2 an element. The causal/T mask is one compare
//   and select an element, on the tiles that need it only;
// - f32: the same tiles on m16n8k8 TF32 with the 3xTF32 split (a*b ~
//   a_hi b_hi + a_hi b_lo + a_lo b_hi), f32-accurate; a single TF32 pass
//   would keep three decimal digits and is not used. The fragments come
//   from swizzled 4-byte shared loads (ldmatrix is 16-bit). Each 32-wide
//   slice of Dh and each tile's PV is summed in fresh accumulators (the
//   correction terms apart) and added to the running sum on the CUDA cores
//   (round to nearest), so no long sum stays in the tensor core's adder.
//   P's columns are taken in the order 2q, 2q+1 (the accumulator's) for
//   the A fragment's q, q+4, and V's rows in the same order;
// - templated on a head-dim bucket (32, 64, 128): every dh % 8 == 0 up to
//   128 runs, the columns past dh zero;
// - shared memory at Dh=128: 16 KB of bf16 Q and two stages of K and V,
//   64 rows each (80 KB; 144 KB with the key split), or 32 KB of f32 Q
//   and two stages of 64-row f32 K and V (160 KB). The limit is raised
//   once per kernel and device;
// - the copy width (16, 8, 4 or 2 bytes) follows the inputs' alignment,
//   so a view at any element offset runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace hopper;
using flash::F32Lanes;
using flash::pv_bf16;
using flash::pv_f32;
using flash::scores_bf16;
using flash::scores_f32;
using flash::stage_rows;

constexpr int kRowWarps = 4;  // warps along the q tile, 16 rows each
constexpr int kMaxDh = 128;
constexpr float kNegInf = -1e30f;

constexpr int kBlockQ = kRowWarps * 16;
constexpr int kKVStages = 2;  // the cp.async ring of K/V tiles

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBlockK = 64;  // keys of a tile a warp takes
};
template <>
struct Cfg<float> {
  static constexpr int kBlockK = 32;
};

template <typename T, int DH, int kSplit>
constexpr int smem_bytes() {
  return (kBlockQ + 2 * kKVStages * kSplit * Cfg<T>::kBlockK) * DH *
         (int)sizeof(T);
}

// ---------------------------------------------------------------- kernel --

// Scores of keys past ``lim`` (the row's last visible key) set to -1e30:
// one compare and one select an element, on edge tiles only.
template <int BK>
__device__ __forceinline__ void mask_scores(float (&s)[BK / 8][4], int k0,
                                            const int (&lim)[2], int qd) {
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * nb + 2 * qd + e > lim[h]) s[nb][2 * h + e] = kNegInf;
}

// Merge the key halves of a 16-row group: the warp of kw = 1 hands its
// (m, l, acc) to the warp of kw = 0 through shared memory ``xchg`` (the
// K/V tiles, free by now), laid out value-major so that a warp's stores
// and loads are free of bank conflicts. A half that saw no visible key
// has m = -1e30 and weight 0. Every thread of the block calls it; it
// returns true for the threads that hold the merged result.
template <int DH>
__device__ __forceinline__ bool merge_key_halves(float* xchg, int slot,
                                                 int kw, float c2,
                                                 float (&m)[2], float (&l)[2],
                                                 float (&acc)[DH / 8][4]) {
  constexpr int kSlots = kRowWarps * 32;
  float* x_m = xchg + (DH / 2) * kSlots;
  float* x_l = x_m + 2 * kSlots;
  if (kw == 1) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xchg[(4 * n + e) * kSlots + slot] = acc[n][e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x_m[h * kSlots + slot] = m[h];
      x_l[h * kSlots + slot] = l[h];
    }
  }
  __syncthreads();
  if (kw == 1) return false;
  float a1[2], a2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m2 = x_m[h * kSlots + slot];
    const float m_new = fmaxf(m[h], m2);
    a1[h] = fast_exp2((m[h] - m_new) * c2);
    a2[h] = fast_exp2((m2 - m_new) * c2);
    m[h] = m_new;
    l[h] = l[h] * a1[h] + x_l[h * kSlots + slot] * a2[h];
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = acc[n][e] * a1[e >> 1] +
                  xchg[(4 * n + e) * kSlots + slot] * a2[e >> 1];
  return true;
}

template <typename T, int DH, bool kVec16, int kSplit>
__global__ void __launch_bounds__(kRowWarps * kSplit * 32)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int t, int dh,
                               int causal, float scale, int width) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kThreads = kRowWarps * kSplit * 32;
  constexpr int BK = Cfg<T>::kBlockK;  // keys a warp takes of a tile
  constexpr int kTileK = kSplit * BK;
  constexpr int kRowBytes = DH * sizeof(T);
  constexpr int kStageBytes = kTileK * kRowBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                      // kBlockQ rows
  unsigned char* ks = qs + kBlockQ * kRowBytes;  // kKVStages K tiles
  unsigned char* vs = ks + kKVStages * kStageBytes;  // the same for V

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % kRowWarps;  // which 16 q rows
  const int kw = warp / kRowWarps;  // which BK keys of each tile
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) *
                 kBlockQ;
  const size_t base = (size_t)bh * t * dh;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  const int n_tiles = (t + kTileK - 1) / kTileK;
  const int last_q = min(q0 + kBlockQ, t) - 1;
  const int n_kt = causal ? min(n_tiles, last_q / kTileK + 1) : n_tiles;

  // Q and the first kKVStages - 1 K/V tiles, one commit group each
  stage_rows<T, DH, kBlockQ, kVec16, kThreads>(qs, qb, q0, t, dh, width);
#pragma unroll
  for (int st = 0; st < kKVStages - 1; ++st) {
    if (st < n_kt) {
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          ks + st * kStageBytes, kb, st * kTileK, t, dh, width);
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          vs + st * kStageBytes, vb, st * kTileK, t, dh, width);
    }
    cp_async_commit();
  }

  // The softmax runs on raw scores s = q.k: with c = scale * log2(e),
  // exp(scale s - max(scale s)) = 2^(c s - c max(s)), one multiply-add and
  // one ex2 an element; max(scale s) = scale max(s) (scale > 0).
  const float c2 = scale * 1.4426950408889634f;
  const int row = rw * 16 + g;  // this thread's rows: row, row + 8
  int lim[2];                   // the last key each row sees
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = causal ? min(q0 + row + 8 * h, t - 1) : t - 1;
  // a warp's keys need the mask if they reach past T or, under causal,
  // past the warp's first row
  const int warp_lim = causal ? min(q0 + rw * 16, t - 1) : t - 1;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const F32Lanes<DH> ln(g, qd);  // f32 fragment addressing
  uint32_t qf[kF32 ? 1 : DH / 16][4];
  if constexpr (!kF32) {
    cp_async_wait<kKVStages - 2>();  // Q is in the oldest group
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      flash::lda_bf16<DH>(qf[kk], qs, rw * 16, kk, lane);
  }

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait<kKVStages - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j-1
    const int next = j + kKVStages - 1;
    if (next < n_kt) {
      const int slot = next % kKVStages;
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          ks + slot * kStageBytes, kb, next * kTileK, t, dh, width);
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          vs + slot * kStageBytes, vb, next * kTileK, t, dh, width);
    }
    cp_async_commit();
    const int cur = (j % kKVStages) * kStageBytes + kw * BK * kRowBytes;
    const unsigned char* kt = ks + cur;
    const unsigned char* vt = vs + cur;

    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    if constexpr (kF32)
      scores_f32<DH, BK>(s, qs, rw * 16, kt, ln);
    else
      scores_bf16<DH, BK>(
          s, [&](int kk, uint32_t (&r)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = qf[kk][e];
          },
          kt, lane);

    const int k0 = j * kTileK + kw * BK;
    if (k0 + BK - 1 > warp_lim) mask_scores<BK>(s, k0, lim, qd);

    // online softmax on the accumulator layout
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * h], s[nb][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = fast_exp2((m[h] - m_new) * c2);
      // a row with no visible key yet keeps m = -1e30 and p = 0 (2^(c s)
      // with s = -1e30), never the rounding error of m * c
      const float mc = m_new == kNegInf ? 0.f : m_new * c2;
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[nb][2 * h + e], c2, -mc));
          s[nb][2 * h + e] = p;
          rs += p;
        }
      l[h] = l[h] * alpha + rs;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    if constexpr (kF32)
      pv_f32<DH, BK>(acc, s, vt, ln);
    else
      pv_bf16<DH, BK>(acc, s, vt, lane);
  }
  cp_async_wait<0>();

  if constexpr (kSplit == 2) {
    static_assert(
        (DH / 2 + 4) * kRowWarps * 32 * 4 <= 2 * kKVStages * kStageBytes,
        "the merge fits in the K/V tiles");
    __syncthreads();  // every warp is done with the last K/V tile
    if (!merge_key_halves<DH>(reinterpret_cast<float*>(ks), rw * 32 + lane,
                              kw, c2, m, l, acc))
      return;
  }

  T* ob = o + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int gr = q0 + row + 8 * h;
    if (gr >= t) continue;
    const float li = fmaxf(lh, 1e-30f);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int dc = 8 * n + 2 * qd;
      if (dc >= dh) break;
      const float o0 = acc[n][2 * h] / li, o1 = acc[n][2 * h + 1] / li;
      T* dst = ob + (size_t)gr * dh + dc;
      if constexpr (kF32)
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o0, o1);
    }
    if (qd == 0) lse[(size_t)bh * t + gr] = m[h] * scale + logf(li);
  }
}

template <typename T, int DH, bool kVec16, int kSplit>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, int dh, int causal, float scale,
                   int width, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  constexpr int smem = smem_bytes<T, DH, kSplit>();
  const auto kernel = flash_attention_fwd_kernel<T, DH, kVec16, kSplit>;
  cudaError_t err = set_smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kRowWarps * kSplit * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, dh, causal, scale, width);
  return cudaGetLastError();
}

template <typename T, bool kVec16, int kSplit>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int t, int dh, int causal,
                      float scale, int width, cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32, kVec16, kSplit>(q, k, v, o, lse, bh, t, dh, causal,
                                         scale, width, stream);
  if (dh <= 64)
    return launch<T, 64, kVec16, kSplit>(q, k, v, o, lse, bh, t, dh, causal,
                                         scale, width, stream);
  return launch<T, 128, kVec16, kSplit>(q, k, v, o, lse, bh, t, dh, causal,
                                        scale, width, stream);
}

// The SMs of the current device, read once per device.
int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int t, int dh,
                         int causal, float scale, int width,
                         cudaStream_t stream) {
  // Split each K/V tile's keys over two warp groups at f32, whose products
  // keep more warps busy, and at bf16 when the grid cannot give every SM
  // two blocks (serving's B*H = 4); else two 4-warp blocks share an SM.
  if constexpr (sizeof(T) == 4) {
    return width == 16 ? launch_dh<T, true, 2>(q, k, v, o, lse, bh, t, dh,
                                               causal, scale, width, stream)
                       : launch_dh<T, false, 2>(q, k, v, o, lse, bh, t, dh,
                                                causal, scale, width, stream);
  } else {
    const long long blocks = (long long)bh * ((t + kBlockQ - 1) / kBlockQ);
    if (blocks < 2LL * sm_count())
      return width == 16
                 ? launch_dh<T, true, 2>(q, k, v, o, lse, bh, t, dh, causal,
                                         scale, width, stream)
                 : launch_dh<T, false, 2>(q, k, v, o, lse, bh, t, dh, causal,
                                          scale, width, stream);
    return width == 16 ? launch_dh<T, true, 1>(q, k, v, o, lse, bh, t, dh,
                                               causal, scale, width, stream)
                       : launch_dh<T, false, 1>(q, k, v, o, lse, bh, t, dh,
                                                causal, scale, width, stream);
  }
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
  // rows are dh * elt bytes, a multiple of 16: the bases set the width
  const long long align = reinterpret_cast<long long>(q) |
                          reinterpret_cast<long long>(k) |
                          reinterpret_cast<long long>(v);
  const int width = copy_width(reinterpret_cast<const void*>(align), 16);
  const cudaError_t err =
      is_bf16 ? launch_width<__nv_bfloat16>(q, k, v, o, lse, bh, t, dh,
                                            causal, scale, width, s)
              : launch_width<float>(q, k, v, o, lse, bh, t, dh, causal,
                                    scale, width, s);
  return (int)err;
}
