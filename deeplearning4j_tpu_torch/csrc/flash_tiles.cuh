// Tiles and tile products of the flash-attention kernels on the tensor
// cores: the forward K3f (flash_attention_fwd.cu) and the backward pair K3k
// (flash_attention_bwd_dkv.cu, dK and dV) and K3q (flash_attention_bwd_dq.cu,
// dQ). Built on hopper_mma.cuh.
//
// The backward pair shares one block shape (the constants below): a block
// owns kBlock = 64 rows (keys in K3k, queries in K3q) held in shared
// memory, and walks tiles of 64 rows of the other side, double-buffered by
// cp.async. Its 8 warps form 4 row groups of 16 owned rows; the two warps
// of a group take the two 32-row halves of every walked tile, each with
// accumulators of its own, and add them once at the end through shared
// memory (FlashAttention-2's key split, as K3f's), so each warp holds one
// 16 x Dh f32 accumulator per output.
//
// The products, for a warp's 16 rows (A) against BN rows of a tile (B):
// - scores: s (16 x BN) = A B^T over Dh. bf16: m16n8k16 with A fragments
//   from ldmatrix (or from registers: K3f's Q, K3q's q and do), B's from
//   ldmatrix of B's rows; f32: m16n8k8 through the 3xTF32 split, each
//   32-wide slice of Dh summed in fresh accumulators (big and correction
//   terms apart) and added on the CUDA cores;
// - pv: acc (16 x Dh) += p (16 x BK) B, with B's rows the k dimension. The
//   score accumulators are the A operand as they lie: bf16 packs each
//   accumulator pair into the A fragment and takes B through
//   ldmatrix.trans; f32 takes the accumulator's columns 2q, 2q+1 for the
//   TF32 A fragment's q, q+4 and B's rows in that order, and sums each
//   group of 32 output columns over the BK rows in fresh accumulators
//   before adding it to acc on the CUDA cores.
// Shared tiles are XOR-swizzled (hopper_mma.cuh's SwizzledTile) instead of
// padded; rows past T and columns past dh are zero-filled by the copy. The
// f32 loads address the swizzle through sixteen lane offsets computed once
// (F32Lanes): with one XOR a load, K3k at f32 spilled 856 bytes a thread
// and took 1.12 ms at the training shape on an H100 (chip_smoke.py);
// PERF.md has the times with the offsets.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper_mma.cuh"

namespace flash {

using namespace hopper;

constexpr int kRowWarps = 4;                 // row groups of 16 owned rows
constexpr int kSplit = 2;                    // warps a row group
constexpr int kThreads = kRowWarps * kSplit * 32;
constexpr int kBlock = kRowWarps * 16;       // owned rows = walked tile rows
constexpr int kHalf = kBlock / kSplit;       // walked rows a warp takes
constexpr int kSlots = kRowWarps * 32;       // threads of one split half
constexpr int kMaxDh = 128;
constexpr float kLog2e = 1.4426950408889634f;

// rows of DH elements of T; <1, 3, 0> for the 4-chunk rows of bf16 Dh 32
template <typename T, int DH>
using RowTile =
    typename std::conditional<DH * sizeof(T) / 16 >= 8,
                              SwizzledTile<DH * sizeof(T), 0, 7, 0>,
                              SwizzledTile<DH * sizeof(T), 1, 3, 0>>::type;

template <typename T, int DH>
__host__ __device__ constexpr int tile_bytes() {
  return kBlock * DH * (int)sizeof(T);
}

// Stage rows [row0, row0 + ROWS) of a (t, dh) array into a shared tile of
// DH-wide rows: rows past t and columns past dh read zero. Each of the
// block's kThreads threads copies one chunk column of every
// kThreads / kChunks-th row, so its shared offsets and source step are
// fixed; kVec16 (every source 16-byte aligned) takes cp.async.cg directly.
template <typename T, int DH, int ROWS, bool kVec16, int kThreads>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const T* __restrict__ src,
                                           int row0, int t, int dh,
                                           int width) {
  using Tile = RowTile<T, DH>;
  constexpr int kChunks = DH * sizeof(T) / 16;
  constexpr int kRowsPerPass = kThreads / kChunks;
  static_assert(ROWS % kRowsPerPass == 0, "whole passes");
  const int c = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const size_t pitch = (size_t)dh * sizeof(T);
  const bool col_ok = c < dh * (int)sizeof(T) / 16;
  const char* base = reinterpret_cast<const char*>(src);
  const char* from = base + (size_t)(row0 + r0) * pitch + c * 16;
#pragma unroll
  for (int n = 0; n < ROWS / kRowsPerPass; ++n) {
    const int r = r0 + n * kRowsPerPass;
    const bool ok = col_ok && row0 + r < t;
    const char* at = ok ? from + n * kRowsPerPass * pitch : base;
    if constexpr (kVec16)
      cp_async_cg16(tile + Tile::offset(r, c), at, ok ? 16 : 0);
    else
      copy_chunk(tile + Tile::offset(r, c), at, ok ? 16 : 0, width);
  }
}

// Stage kBlock f32 values [row0, row0 + kBlock) of a length-t vector
// (lse or delta) into shared ``dst``; past t zero. Threads [first, first +
// kBlock) copy one value each.
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int t, int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < kBlock) {
    const bool ok = row0 + i < t;
    cp_async_ca4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

// ----------------------------------------------------------- bf16 path ----

// The m16n8k16 A fragment of 16 rows from ``row0`` of a tile, k step kk.
template <int DH>
__device__ __forceinline__ void lda_bf16(uint32_t (&r)[4],
                                         const unsigned char* tile, int row0,
                                         int kk, int lane) {
  using Tile = RowTile<__nv_bfloat16, DH>;
  ldmatrix_x4(r, tile + Tile::offset(row0 + (lane & 15),
                                     2 * kk + (lane >> 4)));
}

// s (16 x BN) += A B^T over DH. ``a_frag(kk, r)`` gives A's fragment of k
// step kk; B's BN rows start at ``bt``. The fragments of step kk+1 are
// loaded before the products of step kk, so ldmatrix's latency hides under
// them.
template <int DH, int BN, typename AFrag>
__device__ __forceinline__ void scores_bf16(float (&s)[BN / 8][4],
                                            AFrag a_frag,
                                            const unsigned char* bt,
                                            int lane) {
  using Tile = RowTile<__nv_bfloat16, DH>;
  const int row = (lane & 7) + ((lane >> 4) << 3);
  const int half = (lane >> 3) & 1;
  uint32_t af[2][4], bf[2][BN / 16][4];
  a_frag(0, af[0]);
#pragma unroll
  for (int np = 0; np < BN / 16; ++np)
    ldmatrix_x4(bf[0][np], bt + Tile::offset(16 * np + row, half));
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    if (kk + 1 < DH / 16) {
      a_frag(kk + 1, af[(kk + 1) & 1]);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np)
        ldmatrix_x4(bf[(kk + 1) & 1][np],
                    bt + Tile::offset(16 * np + row, 2 * (kk + 1) + half));
    }
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      mma_bf16_16816(s[2 * np], af[kk & 1], bf[kk & 1][np][0],
                     bf[kk & 1][np][1]);
      mma_bf16_16816(s[2 * np + 1], af[kk & 1], bf[kk & 1][np][2],
                     bf[kk & 1][np][3]);
    }
  }
}

// acc (16 x DH) += p (16 x BK) B, p from the score accumulators packed to
// bf16, B's BK rows (the k dimension) from ``bt`` through ldmatrix.trans,
// each fragment loaded one product pair ahead
template <int DH, int BK>
__device__ __forceinline__ void pv_bf16(float (&acc)[DH / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const unsigned char* bt, int lane) {
  using Tile = RowTile<__nv_bfloat16, DH>;
  constexpr int kSteps = BK / 16 * (DH / 16);
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int half = lane >> 4;
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pf[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pf[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
  uint32_t bf[2][4];
  ldmatrix_x4_trans(bf[0], bt + Tile::offset(row, half));
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int kk = i / (DH / 16), dp = i % (DH / 16);
    if (i + 1 < kSteps) {
      const int kn = (i + 1) / (DH / 16), dn = (i + 1) % (DH / 16);
      ldmatrix_x4_trans(bf[(i + 1) & 1],
                        bt + Tile::offset(16 * kn + row, 2 * dn + half));
    }
    mma_bf16_16816(acc[2 * dp], pf[kk], bf[i & 1][0], bf[i & 1][1]);
    mma_bf16_16816(acc[2 * dp + 1], pf[kk], bf[i & 1][2], bf[i & 1][3]);
  }
}

// ------------------------------------------------------------ f32 path ----

// Lane byte offsets of the f32 fragment loads from a RowTile<float, DH>
// (swizzle <0, 7, 0>). The swizzle's XOR touches the low three chunk bits
// only, so every load is a tile base, a constant and one of sixteen lane
// offsets computed once; written as one XOR a load, each load's address is
// its own loop-invariant value, and the compiler keeps dozens of them in
// registers across the tile loop.
template <int DH>
struct F32Lanes {
  static constexpr int kRow = DH * 4;  // bytes of a row
  // rows 8i + g, chunk c: + ((c & ~7) << 4) + rows[c & 7]; the column
  // 4c + q (in floats), the fragment's q or q+4 with c = 2k or 2k+1
  int rows[8];
  // rows 8i + 2q + e, column 8n + g: + ((2n & ~7) << 4) + pairs[2(n & 3) + e]
  int pairs[8];
  __device__ __forceinline__ F32Lanes(int g, int q) {
#pragma unroll
    for (int m = 0; m < 8; ++m) rows[m] = g * kRow + ((m ^ g) << 4) + 4 * q;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        pairs[2 * m + e] = (2 * q + e) * kRow +
                           ((((2 * m) | (g >> 2)) ^ (2 * q + e)) << 4) +
                           4 * (g & 3);
  }
  // the f32 at row 8i + g (i = row8 / 8) and chunk c of a tile
  __device__ __forceinline__ float row(const unsigned char* tile, int row8,
                                       int c) const {
    return *reinterpret_cast<const float*>(tile + row8 * kRow +
                                           ((c & ~7) << 4) + rows[c & 7]);
  }
  // the f32 at row 8j + 2q + e and column 8n + g of a tile
  __device__ __forceinline__ float pair(const unsigned char* tile, int j,
                                        int e, int n) const {
    return *reinterpret_cast<const float*>(
        tile + 8 * j * kRow + ((2 * n & ~7) << 4) + pairs[2 * (n & 3) + e]);
  }
};

// s (16 x BN) += A B^T over DH through 3xTF32: A's rows a_row0 + g and
// +8 of tile ``at`` (a_row0 a multiple of 8), B's BN rows from ``bt``.
// Each 32-wide slice of DH is summed in fresh accumulators (big and
// correction terms apart) and added to s on the CUDA cores.
template <int DH, int BN>
__device__ __forceinline__ void scores_f32(float (&s)[BN / 8][4],
                                           const unsigned char* at,
                                           int a_row0,
                                           const unsigned char* bt,
                                           const F32Lanes<DH>& ln) {
  constexpr int kSlice = DH < 32 ? DH : 32;
#pragma unroll
  for (int d0 = 0; d0 < DH; d0 += kSlice) {
    float big[BN / 8][4] = {}, small[BN / 8][4] = {};
#pragma unroll
    for (int kk = d0 / 8; kk < (d0 + kSlice) / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(ln.row(at, a_row0, 2 * kk), ah[0], al[0]);
      split_tf32(ln.row(at, a_row0 + 8, 2 * kk), ah[1], al[1]);
      split_tf32(ln.row(at, a_row0, 2 * kk + 1), ah[2], al[2]);
      split_tf32(ln.row(at, a_row0 + 8, 2 * kk + 1), ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(ln.row(bt, 8 * nb, 2 * kk), b0h, b0l);
        split_tf32(ln.row(bt, 8 * nb, 2 * kk + 1), b1h, b1l);
        mma_3xtf32(big[nb], small[nb], ah, al, b0h, b1h, b0l, b1l);
      }
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] += big[nb][e] + small[nb][e];
  }
}

// acc (16 x DH) += p (16 x BK) B through 3xTF32, B's BK rows from ``bt``.
// The TF32 A fragment's column q is the row 2q of an 8-row block of B and
// column q+4 the row 2q+1, so the score accumulators are the fragment as
// they lie (split once, held across the column groups). Each group of 32
// output columns is summed over the BK rows in fresh accumulators and
// added to acc on the CUDA cores, so acc never grows by a 16 x DH copy.
template <int DH, int BK>
__device__ __forceinline__ void pv_f32(float (&acc)[DH / 8][4],
                                       const float (&p)[BK / 8][4],
                                       const unsigned char* bt,
                                       const F32Lanes<DH>& ln) {
  constexpr int kGroup = DH / 8 < 4 ? DH / 8 : 4;
  uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    split_tf32(p[j][0], ah[j][0], al[j][0]);
    split_tf32(p[j][2], ah[j][1], al[j][1]);
    split_tf32(p[j][1], ah[j][2], al[j][2]);
    split_tf32(p[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < DH / 8; n0 += kGroup) {
    float part[kGroup][4] = {};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(ln.pair(bt, j, 0, n0 + n), b0h, b0l);
        split_tf32(ln.pair(bt, j, 1, n0 + n), b1h, b1l);
        mma_3xtf32(part[n], part[n], ah[j], al[j], b0h, b1h, b0l, b1l);
      }
#pragma unroll
    for (int n = 0; n < kGroup; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// ------------------------------------------------------------- epilogue ---

// One warp's 16 x DH accumulator through shared ``x``, value-major so that
// a warp's stores and loads are free of bank conflicts: ``put`` by the
// warp of one split half, ``add`` by the other's at the same slot.
template <int DH>
__device__ __forceinline__ void put_acc(float* x, int slot,
                                        const float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * n + e) * kSlots + slot] = acc[n][e];
}

template <int DH>
__device__ __forceinline__ void add_acc(const float* x, int slot,
                                        float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += x[(4 * n + e) * kSlots + slot];
}

// acc * scale into rows ``row`` and row+8 of a (t, dh) array of T, the
// rows past t and the columns past dh left out
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&acc)[DH / 8][4],
                                           int row, int t, int dh,
                                           float scale, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row + 8 * h;
    if (gr >= t) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int dc = 8 * n + 2 * q;
      if (dc >= dh) break;
      const float a = acc[n][2 * h] * scale, b = acc[n][2 * h + 1] * scale;
      T* at = dst + (size_t)gr * dh + dc;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(at) = make_float2(a, b);
      else
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
    }
  }
}

// ------------------------------------------- the column-split kernels ---
//
// The column-split backward pair (flash_bwd_split.cuh: every mode at Dh
// 256, and Tq != Tk or a shift below) splits its accumulators' head-dim
// columns over the warps of a row group: each warp multiplies the whole
// walked tile into NC output columns from column c0. The variants below
// take that column window; the functions above are the narrow kernels'
// and stay as they are.

// acc (16 x NC) += p (16 x BK) B[:, c0 : c0 + NC], bf16; B's rows (the k
// dimension) DH wide from ``bt``. c0 is a multiple of 16.
template <int DH, int NC, int BK>
__device__ __forceinline__ void pv_bf16_cols(float (&acc)[NC / 8][4],
                                             const float (&p)[BK / 8][4],
                                             const unsigned char* bt,
                                             int lane, int c0) {
  using Tile = RowTile<__nv_bfloat16, DH>;
  constexpr int kSteps = BK / 16 * (NC / 16);
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int half = lane >> 4;
  const int c16 = c0 / 16;
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pf[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pf[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
  uint32_t bf[2][4];
  ldmatrix_x4_trans(bf[0], bt + Tile::offset(row, 2 * c16 + half));
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int kk = i / (NC / 16), dp = i % (NC / 16);
    if (i + 1 < kSteps) {
      const int kn = (i + 1) / (NC / 16), dn = (i + 1) % (NC / 16);
      ldmatrix_x4_trans(bf[(i + 1) & 1],
                        bt + Tile::offset(16 * kn + row,
                                          2 * (c16 + dn) + half));
    }
    mma_bf16_16816(acc[2 * dp], pf[kk], bf[i & 1][0], bf[i & 1][1]);
    mma_bf16_16816(acc[2 * dp + 1], pf[kk], bf[i & 1][2], bf[i & 1][3]);
  }
}

// The same through 3xTF32: acc (16 x NC) += p (16 x BK) B[:, c0 : c0 +
// NC], B's rows DH floats wide; c0 a multiple of 8.
template <int DH, int NC, int BK>
__device__ __forceinline__ void pv_f32_cols(float (&acc)[NC / 8][4],
                                            const float (&p)[BK / 8][4],
                                            const unsigned char* bt,
                                            const F32Lanes<DH>& ln, int c0) {
  constexpr int kGroup = NC / 8 < 4 ? NC / 8 : 4;
  const int n8 = c0 / 8;
  uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    split_tf32(p[j][0], ah[j][0], al[j][0]);
    split_tf32(p[j][2], ah[j][1], al[j][1]);
    split_tf32(p[j][1], ah[j][2], al[j][2]);
    split_tf32(p[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < NC / 8; n0 += kGroup) {
    float part[kGroup][4] = {};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(ln.pair(bt, j, 0, n8 + n0 + n), b0h, b0l);
        split_tf32(ln.pair(bt, j, 1, n8 + n0 + n), b1h, b1l);
        mma_3xtf32(part[n], part[n], ah[j], al[j], b0h, b1h, b0l, b1l);
      }
#pragma unroll
    for (int n = 0; n < kGroup; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// acc * scale into rows ``row`` and row+8, columns [c0, c0 + NC), of a
// (t, dh) array of T; the rows past t and the columns past dh left out
template <typename T, int NC>
__device__ __forceinline__ void store_cols(T* __restrict__ dst,
                                           const float (&acc)[NC / 8][4],
                                           int row, int t, int dh, int c0,
                                           float scale, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row + 8 * h;
    if (gr >= t) continue;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const int dc = c0 + 8 * n + 2 * q;
      if (dc >= dh) break;
      const float a = acc[n][2 * h] * scale, b = acc[n][2 * h + 1] * scale;
      T* at = dst + (size_t)gr * dh + dc;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(at) = make_float2(a, b);
      else
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
    }
  }
}

// Stage N f32 values [row0, row0 + N) of a length-t vector into shared
// ``dst``; past t zero. Threads [first, first + N) copy one value each.
template <int N>
__device__ __forceinline__ void stage_vec_n(float* dst,
                                            const float* __restrict__ src,
                                            int row0, int t, int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < N) {
    const bool ok = row0 + i < t;
    cp_async_ca4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

// A warp's 16 x BN score tile through shared ``x`` to the other warps of
// its row group, value-major (lane-minor), so that the stores and loads
// are free of bank conflicts
template <int BN>
__device__ __forceinline__ void put_tile(float* x, int lane,
                                         const float (&s)[BN / 8][4]) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * n + e) * 32 + lane] = s[n][e];
}

template <int BN>
__device__ __forceinline__ void get_tile(const float* x, int lane,
                                         float (&s)[BN / 8][4]) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = x[(4 * n + e) * 32 + lane];
}

// The warps of row group ``group`` meet: a named barrier (1 + group; 0 is
// __syncthreads') over their kThreads threads
template <int kThreads>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kThreads)
               : "memory");
}

// One launch of a column-split backward kernel's arguments, passed down
// the dispatch on the templates: out0, out1 are dk, dv (K3k) or dq (K3q)
struct BwdArgs {
  const void *q, *k, *v, *lse, *dout, *delta;
  void *out0, *out1;
  int bh, tq, tk, dh, causal, shift;
  float scale;
  cudaStream_t stream;
};

// The widest copy every row of q, k, v and do allows (rows are dh * elt
// bytes, a multiple of 16: the bases set it).
inline int bwd_copy_width(const void* q, const void* k, const void* v,
                          const void* dout) {
  const long long align =
      reinterpret_cast<long long>(q) | reinterpret_cast<long long>(k) |
      reinterpret_cast<long long>(v) | reinterpret_cast<long long>(dout);
  return copy_width(reinterpret_cast<const void*>(align), 16);
}

}  // namespace flash
