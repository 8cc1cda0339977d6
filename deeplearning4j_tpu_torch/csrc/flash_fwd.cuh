// The flash-attention forward kernel K3f for Hopper (sm_90a), on the
// tensor cores, and its launch: the narrow source flash_attention_fwd.cu
// instantiates it at the head-dim buckets 32, 64 and 128, the wide one
// flash_attention_fwd_wide.cu at 256, each in a library of its own.
//
// Computes, over row-major q (B, H, Tq, Dh) and k, v (B, H, Tk, Dh):
//   o   = softmax(q k^T / sqrt(Dh) [+ causal mask]) v      (dtype of q)
//   lse = logsumexp of the scaled, masked scores          (f32, (B, H, Tq))
// Under causal, key j is seen by row i iff j <= i + shift, where shift =
// q_offset - k_offset is the diagonal shift of a (Q shard, K/V shard) pair
// at global sequence offsets (blockwise_block_partials; ring attention's
// pairs). Attention over one sequence is Tq == Tk, shift 0. A row that
// sees no key (shift < 0 leaves the first -shift rows so) comes out as
// o = 0, lse = -1e30: zero weight in a logsumexp merge.
// The reference's numerics: scores, running max, running sum and the
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
// A pair at a shift scores the pairs on or below its shifted diagonal, and
// the tile walk skips the tiles above it: its bound is ops/_kernels.py's
// flash_attention_fwd_cost at (tq, tk, shift).
//
// Design (FlashAttention-2's online softmax on mma.sync; wgmma and TMA are
// a later step; the staging and the tile products are flash_tiles.cuh's,
// shared with the backward pair):
// - one block per (b*h, 64-row q tile), 4 warps along the tile, 16 rows
//   each; under causal the q tiles launch heaviest first (the block index
//   is reversed), so the short tiles near the start fill the tail (at a
//   shift too: row i sees i + shift + 1 keys). A tile whose rows see no
//   key walks no K/V tile;
// - key split: at f32, and at bf16 when the grid cannot give every SM two
//   blocks (serving's B*H = 4: 128 blocks), the block has 8 warps, and the
//   two warps of each 16 rows take the two halves of every K/V tile, each
//   with its own online softmax; they merge (m, l, acc) once at the end
//   through shared memory. That halves the sequential walk over the keys,
//   which is what bounds the serving shape (its time is flat in H and in
//   causal). Else two 4-warp blocks share an SM. The caller may force the
//   split (key_split 1: 4 warps, 2: 8 warps; 0 keeps this rule): it is the
//   one tile size of the kernel chosen at run time, and the autotuner's
//   flash_attention knob (ops/flash_attention.py's key_split_for);
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
// - templated on a head-dim bucket (32, 64, 128, 256): every dh % 8 == 0
//   up to 256 runs, the columns past dh zero;
// - shared memory at Dh=128: 16 KB of bf16 Q and two stages of K and V,
//   64 rows each (80 KB; 144 KB with the key split), or 32 KB of f32 Q
//   and two stages of 64-row f32 K and V (160 KB; 96 KB at key split 1,
//   32-row tiles). The limit is raised once per kernel and device;
// - at Dh=256 the rows are twice as long: a warp takes 32 keys of a tile
//   at bf16 and 16 at f32 (block_k), so both key splits fit (bf16 96 KB at
//   split 1, 160 KB at split 2; f32 128 KB, 192 KB; the card allows 227
//   KB); bf16 Q is read from its staged tile at each k step instead of
//   being held in registers (kQRegs), which leaves the 16 x 256 f32 O its
//   128 registers a thread. Rows of 512 and 1024 bytes keep the swizzle
//   <0, 7, 0> conflict-free: the XOR moves a chunk within its 128 bytes;
// - the copy width (16, 8, 4 or 2 bytes) follows the inputs' alignment,
//   so a view at any element offset runs.

#pragma once

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
constexpr float kNegInf = -1e30f;

constexpr int kBlockQ = kRowWarps * 16;
constexpr int kKVStages = 2;  // the cp.async ring of K/V tiles

// keys of a K/V tile a warp takes: 64 bf16 and 32 f32 up to Dh 128; half
// that at Dh 256, where the rows are twice as long
template <typename T, int DH>
__host__ __device__ constexpr int block_k() {
  return (sizeof(T) == 2 ? 64 : 32) / (DH > 128 ? 2 : 1);
}

template <typename T, int DH, int kSplit>
constexpr int smem_bytes() {
  return (kBlockQ + 2 * kKVStages * kSplit * block_k<T, DH>()) * DH *
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

// kShifted: Tq != Tk or a causal shift. Without it tk and shift fold to
// tq and 0, so the old modes (attention over one sequence) compile to the
// loop they had before the shift existed; tk and shift come last, after
// the parameters the old modes read.
template <typename T, int DH, bool kVec16, int kSplit, bool kShifted>
__global__ void __launch_bounds__(kRowWarps * kSplit * 32)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int tq, int dh,
                               int causal, float scale, int width,
                               int tk_arg, int shift_arg) {
  constexpr bool kF32 = sizeof(T) == 4;
  // bf16 Q as A fragments in registers up to Dh 128; at Dh 256 they would
  // take 64 registers a thread beside a 128-register O, so they are read
  // from the staged Q tile at each step
  constexpr bool kQRegs = !kF32 && DH <= 128;
  const int tk = kShifted ? tk_arg : tq;
  const int shift = kShifted ? shift_arg : 0;
  constexpr int kThreads = kRowWarps * kSplit * 32;
  constexpr int BK = block_k<T, DH>();  // keys a warp takes of a tile
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
  const size_t q_base = (size_t)bh * tq * dh;
  const size_t k_base = (size_t)bh * tk * dh;
  const T* qb = q + q_base;
  const T* kb = k + k_base;
  const T* vb = v + k_base;

  const int n_tiles = (tk + kTileK - 1) / kTileK;
  // under causal the tile's last row sees keys up to last_k: the walk
  // stops at its tile, and a tile that sees none walks no tile
  const int last_k = min(q0 + kBlockQ, tq) - 1 + shift;
  const int n_kt = !causal                 ? n_tiles
                   : kShifted && last_k < 0 ? 0
                                            : min(n_tiles, last_k / kTileK + 1);

  // Q and the first kKVStages - 1 K/V tiles, one commit group each
  stage_rows<T, DH, kBlockQ, kVec16, kThreads>(qs, qb, q0, tq, dh, width);
#pragma unroll
  for (int st = 0; st < kKVStages - 1; ++st) {
    if (st < n_kt) {
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          ks + st * kStageBytes, kb, st * kTileK, tk, dh, width);
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          vs + st * kStageBytes, vb, st * kTileK, tk, dh, width);
    }
    cp_async_commit();
  }

  // The softmax runs on raw scores s = q.k: with c = scale * log2(e),
  // exp(scale s - max(scale s)) = 2^(c s - c max(s)), one multiply-add and
  // one ex2 an element; max(scale s) = scale max(s) (scale > 0).
  const float c2 = scale * 1.4426950408889634f;
  const int row = rw * 16 + g;  // this thread's rows: row, row + 8
  int lim[2];  // the last key each row sees (< 0: none)
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = causal ? min(q0 + row + 8 * h + shift, tk - 1) : tk - 1;
  // a warp's keys need the mask if they reach past Tk or, under causal,
  // past the warp's first row's last key
  const int warp_lim = causal ? min(q0 + rw * 16 + shift, tk - 1) : tk - 1;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const F32Lanes<DH> ln(g, qd);  // f32 fragment addressing
  uint32_t qf[kQRegs ? DH / 16 : 1][4];
  if constexpr (kQRegs) {
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
          ks + slot * kStageBytes, kb, next * kTileK, tk, dh, width);
      stage_rows<T, DH, kTileK, kVec16, kThreads>(
          vs + slot * kStageBytes, vb, next * kTileK, tk, dh, width);
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
    else if constexpr (kQRegs)
      scores_bf16<DH, BK>(
          s, [&](int kk, uint32_t (&r)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = qf[kk][e];
          },
          kt, lane);
    else
      scores_bf16<DH, BK>(
          s, [&](int kk, uint32_t (&r)[4]) {
            flash::lda_bf16<DH>(r, qs, rw * 16, kk, lane);
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

  T* ob = o + q_base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int gr = q0 + row + 8 * h;
    if (gr >= tq) continue;
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
    // a row that saw no key keeps m = -1e30: o = 0 above, lse = -1e30
    if (qd == 0)
      lse[(size_t)bh * tq + gr] = kShifted && m[h] == kNegInf
                                      ? kNegInf
                                      : m[h] * scale + logf(li);
  }
}

// One launch's arguments, passed down the dispatch on the templates.
struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, tq, tk, dh, causal, shift;
  float scale;
  int width;
  cudaStream_t stream;
};

template <typename T, int DH, bool kVec16, int kSplit, bool kShifted>
cudaError_t launch(const Args& a) {
  static bool smem_set[kMaxDevices] = {};
  constexpr int smem = smem_bytes<T, DH, kSplit>();
  const auto kernel = flash_attention_fwd_kernel<T, DH, kVec16, kSplit,
                                                 kShifted>;
  cudaError_t err = set_smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kRowWarps * kSplit * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.tq, a.dh, a.causal, a.scale, a.width,
      a.tk, a.shift);
  return cudaGetLastError();
}

// the first of the head-dim buckets DH, More... that holds a.dh
template <typename T, bool kVec16, int kSplit, bool kShifted, int DH,
          int... More>
cudaError_t launch_dh(const Args& a) {
  if constexpr (sizeof...(More) == 0)
    return launch<T, DH, kVec16, kSplit, kShifted>(a);
  else
    return a.dh <= DH ? launch<T, DH, kVec16, kSplit, kShifted>(a)
                      : launch_dh<T, kVec16, kSplit, kShifted, More...>(a);
}

template <typename T, int kSplit, bool kShifted, int... DHs>
cudaError_t launch_copy(const Args& a) {
  return a.width == 16 ? launch_dh<T, true, kSplit, kShifted, DHs...>(a)
                       : launch_dh<T, false, kSplit, kShifted, DHs...>(a);
}

template <typename T, int kSplit, int... DHs>
cudaError_t launch_split(const Args& a) {
  return a.tq != a.tk || (a.causal && a.shift != 0)
             ? launch_copy<T, kSplit, true, DHs...>(a)
             : launch_copy<T, kSplit, false, DHs...>(a);
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

template <typename T, int... DHs>
cudaError_t launch_width(const Args& a, int key_split) {
  if (key_split == 0) {
    // Split each K/V tile's keys over two warp groups at f32, whose
    // products keep more warps busy, and at bf16 when the grid cannot give
    // every SM two blocks (serving's B*H = 4); else two 4-warp blocks
    // share an SM.
    const long long blocks =
        (long long)a.bh * ((a.tq + kBlockQ - 1) / kBlockQ);
    key_split = (sizeof(T) == 4 || blocks < 2LL * sm_count()) ? 2 : 1;
  }
  return key_split == 2 ? launch_split<T, 2, DHs...>(a)
                        : launch_split<T, 1, DHs...>(a);
}

// One launch: the checks every entry shares, then the dispatch over the
// element type onto the head-dim buckets DHs (dh in (kMinDh, DHs's last])
template <int kMinDh, int... DHs>
int entry(const void* q, const void* k, const void* v, void* o, void* lse,
          int bh, int tq, int tk, int dh, int causal, int shift, float scale,
          int is_bf16, int key_split, void* stream) {
  constexpr int kBuckets[] = {DHs...};
  constexpr int kMaxDh = kBuckets[sizeof...(DHs) - 1];
  if (bh < 1 || tq < 1 || tk < 1 || dh <= kMinDh || dh > kMaxDh ||
      dh % 8 != 0 || (tq + kBlockQ - 1) / kBlockQ > 65535 || key_split < 0 ||
      key_split > 2)
    return (int)cudaErrorInvalidValue;
  // rows are dh * elt bytes, a multiple of 16: the bases set the width
  const long long align = reinterpret_cast<long long>(q) |
                          reinterpret_cast<long long>(k) |
                          reinterpret_cast<long long>(v);
  const Args a{q, k, v, o, lse, bh, tq, tk, dh, causal, shift, scale,
               copy_width(reinterpret_cast<const void*>(align), 16),
               static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 ? launch_width<__nv_bfloat16, DHs...>(a, key_split)
                       : launch_width<float, DHs...>(a, key_split));
}

}  // namespace
