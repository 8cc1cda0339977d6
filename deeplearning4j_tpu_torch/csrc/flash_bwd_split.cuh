// The column-split backward pair: K3k (dkv_kernel: dK, dV) and K3q
// (dq_kernel: dQ) at any Tq, Tk and causal shift (key j seen by row i iff
// j <= i + shift), templated on a head-dim bucket. The wide sources
// (flash_attention_bwd_*_wide.cu) run it at Dh 256 in every mode; the
// narrow ones (flash_attention_bwd_*.cu) at their buckets 32, 64 and 128
// for Tq != Tk or a shift (blockwise_block_partials' pairs), and their own
// kernels, as they were, for attention over one sequence. Built on
// flash_tiles.cuh's tiles.
//
// At Dh 256 the narrow pair's layout cannot hold: a warp of K3k keeps
// 2 x 16 x Dh f32 accumulators (256 registers a thread), and six staged
// 64-row tiles take 384 KB at f32. So:
// - the kSplitW warps of each 16-row group split the accumulators'
//   head-dim columns (Dh / kSplitW each, from c0 = kw * Dh / kSplitW):
//   each scores its slice of every walked tile (16 x kRows / kSplitW),
//   hands it to the group's other warps through shared memory (put_tile /
//   get_tile after a named barrier over the group), and multiplies every
//   slice into its columns. No exchange is left for the epilogue;
// - a block owns RG row groups of kSplitW warps: at bf16 4 groups of 2
//   (64 rows, 64-row walked tiles, 8 warps; a warp holds 16 x 128 f32 per
//   output, as the narrow K3k does at Dh 128), at f32 2 groups (32 and
//   32 rows) of 4 warps in K3k (16 x 64 per output) and of 2 in K3q, so
//   the six staged tiles take 192 KB at either type; one block an SM;
// - the swizzle and the f32 lane offsets are the narrow kernels': rows of
//   512 and 1024 bytes keep every ldmatrix and 4-byte fragment load
//   conflict-free (the XOR moves a chunk within its 128 bytes).
// The column split was slower at Dh 128 (flash_attention_bwd_dkv.cu);
// at 256 it is what fits. Below 256 the same blocks hold fewer columns a
// warp.
//
// K3k: one block per (b*h, kRows-key tile) owns K and V in shared memory
// and walks the kRows-row q tiles that see its keys, from the first row
// that sees key k0 (k0 - shift); q, do and their lse, delta rows are
// double-buffered by cp.async, one barrier a tile. Warp (rw, kw) scores
// S^T = K q^T and dP^T = V do^T for its 16 keys and the kw-th slice of the
// tile's queries and adds every slice's P^T do and dS^T q into its
// columns of dV and dK. A key tile that no row sees writes zeros.
// K3q: one block per (b*h, kRows-row q tile) owns q and do and walks the
// kRows-key K/V tiles up to its last row's last visible key (q0 + kRows -
// 1 + shift); under causal the late q tiles, which walk the most, launch
// first. Warp (rw, kw) scores S = q K^T and dP = do V^T for its 16
// queries and the kw-th slice of the tile's keys (q and do as A
// fragments read from the staged tiles), lse and delta by row in
// registers, and adds every slice's dS K into its columns of dQ.
// Both: exp(scale s - lse) is 2^(c s - log2(e) lse); the causal / T mask
// selects P to 0 on the tiles that cross the diagonal or T only, so a row
// that sees no key (lse = -1e30) adds nothing; a group whose rows see
// nothing of a tile skips it; the blocks write the outputs straight from
// the accumulators (rows past T and columns past dh left out).
// Deterministic: no atomics, one writer for each output element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_tiles.cuh"
#include "hopper_mma.cuh"

namespace flash_split {

using namespace flash;


// row groups of 16 a block, and warps a row group
template <typename T>
__host__ __device__ constexpr int row_groups() {
  return sizeof(T) == 2 ? 4 : 2;
}

// K3k (kDkv) at f32 splits its groups 4 ways: 8 warps an SM, and two
// 16 x Dh/4 accumulators a warp; K3q, whose one accumulator fits at 2,
// ran faster at 2 than at 4 on the card (PERF.md, section 6)
template <typename T, bool kDkv>
__host__ __device__ constexpr int splits() {
  return kDkv && sizeof(T) == 4 ? 4 : 2;
}

template <typename T, bool kDkv>
__host__ __device__ constexpr int threads() {
  return row_groups<T>() * splits<T, kDkv>() * 32;
}


// floats of one warp's exchanged 16 x BN tile
template <int BN>
__host__ __device__ constexpr int tile_floats() {
  return 32 * BN / 2;
}

// s (16 x BN) += A B^T over DH: A the warp's 16 rows from ``at``, B's BN
// rows from ``bt`` (bf16 through ldmatrix, f32 through 3xTF32)
template <typename T, int DH, int BN>
__device__ __forceinline__ void scores(float (&s)[BN / 8][4],
                                       const unsigned char* at, int a_row0,
                                       const unsigned char* bt, int lane,
                                       const F32Lanes<DH>& ln) {
  if constexpr (sizeof(T) == 4)
    scores_f32<DH, BN>(s, at, a_row0, bt, ln);
  else
    scores_bf16<DH, BN>(
        s, [&](int kk, uint32_t (&r)[4]) {
          lda_bf16<DH>(r, at, a_row0, kk, lane);
        },
        bt, lane);
}

// acc (16 x NC) += p (16 x BK) B[:, c0 : c0 + NC], B's BK rows from
// ``bt``
template <typename T, int DH, int NC, int BK>
__device__ __forceinline__ void product(float (&acc)[NC / 8][4],
                                        const float (&p)[BK / 8][4],
                                        const unsigned char* bt, int lane,
                                        const F32Lanes<DH>& ln, int c0) {
  if constexpr (sizeof(T) == 4)
    pv_f32_cols<DH, NC, BK>(acc, p, bt, ln, c0);
  else
    pv_bf16_cols<DH, NC, BK>(acc, p, bt, lane, c0);
}

// acc += every slice of a walked tile (row group ``rw``'s warps' score
// tiles, 16 x BK each) times B's matching BK rows: the warp's own slice
// ``own`` from its registers, the others' from shared ``x`` (one tile of
// tile_floats<BK>() a warp, warp w * RG + rw), a slice whose ``live`` is
// false skipped. The others are own ^ 1, ..., own ^ (W - 1), so the code
// holds one product for each slice (W a power of two)
template <typename T, int DH, int RG, int NC, int BK, int W>
__device__ __forceinline__ void product_slices(
    float (&acc)[NC / 8][4], const float (&own_p)[BK / 8][4], int own,
    const bool (&live)[W], const float* x, int rw,
    const unsigned char* bt, int row_bytes, int lane,
    const F32Lanes<DH>& ln, int c0) {
  static_assert((W & (W - 1)) == 0, "the slices pair by XOR");
  if (live[own])
    product<T, DH, NC, BK>(acc, own_p, bt + own * BK * row_bytes, lane, ln,
                           c0);
#pragma unroll
  for (int d = 1; d < W; ++d) {
    const int w = own ^ d;
    if (!live[w]) continue;
    float p[BK / 8][4];
    get_tile<BK>(x + (w * RG + rw) * tile_floats<BK>(), lane, p);
    product<T, DH, NC, BK>(acc, p, bt + w * BK * row_bytes, lane, ln, c0);
  }
}

template <typename T, int DH>
constexpr int dkv_smem_bytes() {
  constexpr int kRows = row_groups<T>() * 16;
  return 6 * kRows * DH * (int)sizeof(T) + 4 * kRows * 4 +
         2 * threads<T, true>() / 32 *
             tile_floats<kRows / splits<T, true>()>() * 4;
}

template <typename T, int DH, bool kVec16>
__global__ void __launch_bounds__(threads<T, true>(), 1)
    dkv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ lse,
        const T* __restrict__ dout, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int dh,
        int causal, int shift, float scale, int width) {
  constexpr int RG = row_groups<T>();
  constexpr int W = splits<T, true>();  // warps a row group
  constexpr int kRows = RG * 16;      // owned keys = walked q rows
  constexpr int kSlice = kRows / W;   // queries a warp scores of a tile
  constexpr int kCols = DH / W;    // dK, dV columns a warp holds
  constexpr int kThreads = threads<T, true>();
  constexpr int kRowBytes = DH * sizeof(T);
  constexpr int kTile = kRows * kRowBytes;
  constexpr int kX = tile_floats<kSlice>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;              // the block's keys
  unsigned char* vs = ks + kTile;        // and values
  unsigned char* qs = vs + kTile;        // two stages of a q tile
  unsigned char* dos = qs + 2 * kTile;   // and of do
  float* ls = reinterpret_cast<float*>(dos + 2 * kTile);  // 2 x lse rows
  float* ds = ls + 2 * kRows;                              // 2 x delta rows
  float* xp = ds + 2 * kRows;         // each warp's P^T for its group
  float* xs = xp + kThreads / 32 * kX;  // and its dS^T

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % RG;  // which 16 keys
  const int kw = warp / RG;  // which slice of the queries and of the columns
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const size_t q_base = (size_t)bh * tq * dh;
  const size_t k_base = (size_t)bh * tk * dh;
  const T* qb = q + q_base;
  const T* dob = dout + q_base;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;

  const int n_tiles = (tq + kRows - 1) / kRows;
  const int first = causal ? min(max(k0 - shift, 0) / kRows, n_tiles) : 0;

  stage_rows<T, DH, kRows, kVec16, kThreads>(ks, k + k_base, k0, tk, dh,
                                              width);
  stage_rows<T, DH, kRows, kVec16, kThreads>(vs, v + k_base, k0, tk, dh,
                                              width);
  stage_rows<T, DH, kRows, kVec16, kThreads>(qs, qb, first * kRows, tq, dh,
                                              width);
  stage_rows<T, DH, kRows, kVec16, kThreads>(dos, dob, first * kRows, tq,
                                              dh, width);
  stage_vec_n<kRows>(ls, lb, first * kRows, tq, 0);
  stage_vec_n<kRows>(ds, db, first * kRows, tq, kRows);
  cp_async_commit();

  float acc_k[kCols / 8][4], acc_v[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const float c2 = scale * kLog2e;
  const int key0 = k0 + rw * 16;  // the warp's first key
  const int key = key0 + g;       // this thread's keys: key, key + 8
  const int c0 = kw * kCols;      // the warp's output columns
  const F32Lanes<DH> ln(g, qd);  // f32 fragment addressing
  const int own = kw * kSlice * kRowBytes;

  for (int i = first; i < n_tiles; ++i) {
    const int slot = (i - first) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile i landed; every warp is done with tile i-1
    if (i + 1 < n_tiles) {
      const int nx = slot ^ 1, r0 = (i + 1) * kRows;
      stage_rows<T, DH, kRows, kVec16, kThreads>(qs + nx * kTile, qb, r0,
                                                  tq, dh, width);
      stage_rows<T, DH, kRows, kVec16, kThreads>(dos + nx * kTile, dob, r0,
                                                  tq, dh, width);
      stage_vec_n<kRows>(ls + nx * kRows, lb, r0, tq, 0);
      stage_vec_n<kRows>(ds + nx * kRows, db, r0, tq, kRows);
    }
    cp_async_commit();

    // the slices of the tile with a query that sees one of the group's keys
    bool live[W];
    bool any = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int qs0 = i * kRows + w * kSlice;
      live[w] = qs0 < tq && !(causal && key0 > qs0 + kSlice - 1 + shift);
      any |= live[w];
    }
    if (!any) continue;  // every warp of the group skips
    const bool mine = live[kw];
    const unsigned char* qt = qs + slot * kTile;
    const unsigned char* dot = dos + slot * kTile;
    const int qw0 = i * kRows + kw * kSlice;  // the warp's first query
    const float* lt = ls + slot * kRows + kw * kSlice;
    const float* dt = ds + slot * kRows + kw * kSlice;

    // P^T: rows are keys, columns the warp's queries
    float s[kSlice / 8][4] = {};
    if (mine) {
      const bool edge =
          (causal && key0 + 15 > qw0 + shift) || qw0 + kSlice > tq;
      scores<T, DH, kSlice>(s, ks, rw * 16, qt + own, lane, ln);
#pragma unroll
      for (int nb = 0; nb < kSlice / 8; ++nb) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lt + 8 * nb + 2 * qd);
        const float lc[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = fast_exp2(fmaf(s[nb][2 * h + e], c2, -lc[e]));
            if (edge) {
              const int col = qw0 + 8 * nb + 2 * qd + e;
              if (col >= tq || (causal && key + 8 * h > col + shift))
                p = 0.f;
            }
            s[nb][2 * h + e] = p;
          }
      }
      put_tile<kSlice>(xp + warp * kX, lane, s);
    }
    group_sync<W * 32>(rw);
    product_slices<T, DH, RG, kCols, kSlice, W>(acc_v, s, kw, live, xp, rw, dot,
                                            kRowBytes, lane, ln, c0);

    // dS^T = P^T * (dP^T - delta), delta by column
    if (mine) {
      float dp[kSlice / 8][4] = {};
      scores<T, DH, kSlice>(dp, vs, rw * 16, dot + own, lane, ln);
#pragma unroll
      for (int nb = 0; nb < kSlice / 8; ++nb) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dt + 8 * nb + 2 * qd);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[nb][2 * h] *= dp[nb][2 * h] - d2.x;
          s[nb][2 * h + 1] *= dp[nb][2 * h + 1] - d2.y;
        }
      }
      put_tile<kSlice>(xs + warp * kX, lane, s);
    }
    group_sync<W * 32>(rw);
    product_slices<T, DH, RG, kCols, kSlice, W>(acc_k, s, kw, live, xs, rw, qt,
                                            kRowBytes, lane, ln, c0);
  }
  cp_async_wait<0>();
  store_cols<T, kCols>(dk + k_base, acc_k, key, tk, dh, c0, scale, qd);
  store_cols<T, kCols>(dv + k_base, acc_v, key, tk, dh, c0, 1.f, qd);
}

template <typename T, int DH, bool kVec16>
cudaError_t launch_dkv_at(const BwdArgs& a, int width) {
  static bool smem_set[kMaxDevices] = {};
  constexpr int smem = dkv_smem_bytes<T, DH>();
  constexpr int kRows = row_groups<T>() * 16;
  const auto kernel = dkv_kernel<T, DH, kVec16>;
  cudaError_t err = set_smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tk + kRows - 1) / kRows);
  kernel<<<grid, threads<T, true>(), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.tq, a.tk, a.dh,
      a.causal, a.shift, a.scale, width);
  return cudaGetLastError();
}

// the first of the head-dim buckets DH, More... that holds a.dh
template <typename T, bool kVec16, int DH, int... More>
cudaError_t launch_dkv_dh(const BwdArgs& a, int width) {
  if constexpr (sizeof...(More) == 0)
    return launch_dkv_at<T, DH, kVec16>(a, width);
  else
    return a.dh <= DH ? launch_dkv_at<T, DH, kVec16>(a, width)
                      : launch_dkv_dh<T, kVec16, More...>(a, width);
}

// One launch at head-dim buckets DHs, the copy width from the inputs
template <typename T, int... DHs>
cudaError_t launch_dkv(const BwdArgs& a) {
  const int width = bwd_copy_width(a.q, a.k, a.v, a.dout);
  return width == 16 ? launch_dkv_dh<T, true, DHs...>(a, width)
                     : launch_dkv_dh<T, false, DHs...>(a, width);
}

template <typename T, int DH>
constexpr int dq_smem_bytes() {
  constexpr int kRows = row_groups<T>() * 16;
  return 6 * kRows * DH * (int)sizeof(T) +
         threads<T, false>() / 32 *
             tile_floats<kRows / splits<T, false>()>() * 4;
}

template <typename T, int DH, bool kVec16>
__global__ void __launch_bounds__(threads<T, false>(), 1)
    dq_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ lse,
        const T* __restrict__ dout, const float* __restrict__ delta,
        T* __restrict__ dq, int tq, int tk, int dh, int causal, int shift,
        float scale, int width) {
  constexpr int RG = row_groups<T>();
  constexpr int W = splits<T, false>();  // warps a row group
  constexpr int kRows = RG * 16;      // owned queries = walked keys
  constexpr int kSlice = kRows / W;   // keys a warp scores of a tile
  constexpr int kCols = DH / W;    // dQ columns a warp holds
  constexpr int kThreads = threads<T, false>();
  constexpr int kRowBytes = DH * sizeof(T);
  constexpr int kTile = kRows * kRowBytes;
  constexpr int kX = tile_floats<kSlice>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;            // the block's queries
  unsigned char* dos = qs + kTile;     // and their do
  unsigned char* ks = dos + kTile;     // two stages of a K tile
  unsigned char* vs = ks + 2 * kTile;  // and of V
  float* xs = reinterpret_cast<float*>(vs + 2 * kTile);  // each warp's dS

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % RG;  // which 16 queries
  const int kw = warp / RG;  // which slice of the keys and of the columns
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x;
  const int n_qt = (tq + kRows - 1) / kRows;
  const int n_ktiles = (tk + kRows - 1) / kRows;
  const int q0 =
      (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * kRows;
  const size_t q_base = (size_t)bh * tq * dh;
  const size_t k_base = (size_t)bh * tk * dh;
  const T* kb = k + k_base;
  const T* vb = v + k_base;
  const int last_k = min(q0 + kRows, tq) - 1 + shift;
  const int n_kt = !causal       ? n_ktiles
                   : last_k < 0  ? 0
                                 : min(n_ktiles, last_k / kRows + 1);

  stage_rows<T, DH, kRows, kVec16, kThreads>(qs, q + q_base, q0, tq, dh,
                                              width);
  stage_rows<T, DH, kRows, kVec16, kThreads>(dos, dout + q_base, q0, tq, dh,
                                              width);
  stage_rows<T, DH, kRows, kVec16, kThreads>(ks, kb, 0, tk, dh, width);
  stage_rows<T, DH, kRows, kVec16, kThreads>(vs, vb, 0, tk, dh, width);
  cp_async_commit();

  const float c2 = scale * kLog2e;
  const int qr0 = q0 + rw * 16;  // the warp's first query
  const int row = qr0 + g;       // this thread's queries: row, row + 8
  float lc[2], dl[2];            // log2(e) lse and delta of those rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < tq;
    lc[h] = ok ? lse[(size_t)bh * tq + row + 8 * h] * kLog2e : 0.f;
    dl[h] = ok ? delta[(size_t)bh * tq + row + 8 * h] : 0.f;
  }
  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int c0 = kw * kCols;      // the warp's output columns
  const F32Lanes<DH> ln(g, qd);  // f32 fragment addressing
  const int own = kw * kSlice * kRowBytes;

  for (int j = 0; j < n_kt; ++j) {
    const int slot = j & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is done with tile j-1
    if (j + 1 < n_kt) {
      const int nx = slot ^ 1, r0 = (j + 1) * kRows;
      stage_rows<T, DH, kRows, kVec16, kThreads>(ks + nx * kTile, kb, r0,
                                                  tk, dh, width);
      stage_rows<T, DH, kRows, kVec16, kThreads>(vs + nx * kTile, vb, r0,
                                                  tk, dh, width);
    }
    cp_async_commit();

    // the slices of the tile with a key that one of the group's queries
    // sees
    bool live[W];
    bool any = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int ks0 = j * kRows + w * kSlice;
      live[w] = ks0 < tk && !(causal && ks0 > qr0 + 15 + shift);
      any |= live[w];
    }
    if (!any) continue;  // every warp of the group skips
    const bool mine = live[kw];
    const unsigned char* kt = ks + slot * kTile;
    const unsigned char* vt = vs + slot * kTile;

    float s[kSlice / 8][4] = {};
    if (mine) {
      const int kw0 = j * kRows + kw * kSlice;  // the warp's first key
      const bool edge =
          (causal && kw0 + kSlice - 1 > qr0 + shift) || kw0 + kSlice > tk;
      scores<T, DH, kSlice>(s, qs, rw * 16, kt + own, lane, ln);
#pragma unroll
      for (int nb = 0; nb < kSlice / 8; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p = fast_exp2(fmaf(s[nb][2 * h + e], c2, -lc[h]));
            if (edge) {
              const int col = kw0 + 8 * nb + 2 * qd + e;
              if (col >= tk || (causal && col > row + 8 * h + shift))
                p = 0.f;
            }
            s[nb][2 * h + e] = p;
          }
      // dS = P * (dP - delta), delta by row
      float dp[kSlice / 8][4] = {};
      scores<T, DH, kSlice>(dp, dos, rw * 16, vt + own, lane, ln);
#pragma unroll
      for (int nb = 0; nb < kSlice / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= dp[nb][e] - dl[e >> 1];
      put_tile<kSlice>(xs + warp * kX, lane, s);
    }
    group_sync<W * 32>(rw);
    product_slices<T, DH, RG, kCols, kSlice, W>(acc, s, kw, live, xs, rw, kt,
                                            kRowBytes, lane, ln, c0);
  }
  cp_async_wait<0>();
  store_cols<T, kCols>(dq + q_base, acc, row, tq, dh, c0, scale, qd);
}

template <typename T, int DH, bool kVec16>
cudaError_t launch_dq_at(const BwdArgs& a, int width) {
  static bool smem_set[kMaxDevices] = {};
  constexpr int smem = dq_smem_bytes<T, DH>();
  constexpr int kRows = row_groups<T>() * 16;
  const auto kernel = dq_kernel<T, DH, kVec16>;
  cudaError_t err = set_smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.tq + kRows - 1) / kRows);
  kernel<<<grid, threads<T, false>(), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.lse),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.tq, a.tk, a.dh, a.causal, a.shift, a.scale,
      width);
  return cudaGetLastError();
}

// the first of the head-dim buckets DH, More... that holds a.dh
template <typename T, bool kVec16, int DH, int... More>
cudaError_t launch_dq_dh(const BwdArgs& a, int width) {
  if constexpr (sizeof...(More) == 0)
    return launch_dq_at<T, DH, kVec16>(a, width);
  else
    return a.dh <= DH ? launch_dq_at<T, DH, kVec16>(a, width)
                      : launch_dq_dh<T, kVec16, More...>(a, width);
}

// One launch at head-dim buckets DHs, the copy width from the inputs
template <typename T, int... DHs>
cudaError_t launch_dq(const BwdArgs& a) {
  const int width = bwd_copy_width(a.q, a.k, a.v, a.dout);
  return width == 16 ? launch_dq_dh<T, true, DHs...>(a, width)
                     : launch_dq_dh<T, false, DHs...>(a, width);
}

}  // namespace flash_split
