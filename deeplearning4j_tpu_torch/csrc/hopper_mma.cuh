// Building blocks of the port's tensor-core kernels for Hopper (sm_90a):
// inline-PTX wrappers for warp-level mma.sync, ldmatrix, cp.async and the
// TF32 rounding, the 3xTF32 split, XOR-swizzled shared-memory tiles and a
// staging copy whose width follows the source's alignment. Plain CUDA, no
// CUTLASS or CuTe: each kernel still builds with one nvcc call and no
// include path (the quoted include resolves beside the source).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"), with
// g = lane / 4 and q = lane % 4:
// - m16n8k16 bf16: A (16x16, row) a[0] = (g, 2q..2q+1), a[1] = (g+8, 2q..),
//   a[2] = (g, 2q+8..), a[3] = (g+8, 2q+8..), two bf16 in a register, the
//   lower column in the low half; B (16x8, col) b[0] = rows 2q..2q+1 of
//   column g, b[1] = rows 2q+8..2q+9.
// - m16n8k8 tf32: A a[0] = (g, q), a[1] = (g+8, q), a[2] = (g, q+4),
//   a[3] = (g+8, q+4); B b[0] = (q, g), b[1] = (q+4, g).
// - the f32 accumulator of both: c[0..1] = (g, 2q..2q+1), c[2..3] =
//   (g+8, 2q..2q+1).
// A row of a 16x8 accumulator pair (two n8 blocks) is therefore the A
// fragment of the next m16n8k16 product once it is packed to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ------------------------------------------------------------ products ----

// d += a(16x16 bf16) * b(16x8 bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a(16x8 tf32) * b(8x8 tf32), f32 accumulate
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits): to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split x = hi + lo, hi = tf32(x), lo = tf32(x - hi): the
// product a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi keeps f32's accuracy
// (the dropped a_lo*b_lo is ~2^-22 of it). x - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// a*b to f32 accuracy from three TF32 products: big += a_hi*b_hi and
// small += a_hi*b_lo + a_lo*b_hi, the correction terms (~2^-11 of the big
// one) in an accumulator of their own, so they keep their low bits and the
// chains of dependent products are shorter; the caller adds small to big.
// big and small may be the same accumulator.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b0_hi, uint32_t b1_hi,
                                           uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32_1688(small, a_lo, b0_hi, b1_hi);
  mma_tf32_1688(small, a_hi, b0_lo, b1_lo);
  mma_tf32_1688(big, a_hi, b0_hi, b1_hi);
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// two f32 packed as bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------ shared memory ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i receives matrix i's fragment (row lane/4, columns
// 2(lane%4)..+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// the same, each matrix transposed: register i receives (rows
// 2(lane%4)..+1, column lane/4) of matrix i, the B fragment of a
// row-major (k, n) tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// A tile in shared memory as rows of kRowBytes (a multiple of 16), each
// row cut into 16-byte chunks; chunk c of row r is stored at chunk
// c ^ (((r >> kRowShift) & kRowMask) << kChunkShift) of the row. The
// XOR replaces padding: the rows a warp reads together land on distinct
// banks. Parameters per access pattern:
// - ldmatrix over rows of >= 8 chunks, or one 4-byte element per lane
//   with 8 rows of one chunk column: <0, 7, 0>;
// - ldmatrix over rows of 4 chunks (two rows per 128 bytes): <1, 3, 0>;
// - 4-byte elements of 4 rows (q) x 8 columns (g) of a wide row: <0, 3, 1>.
template <int kRowBytes, int kRowShift, int kRowMask, int kChunkShift>
struct SwizzledTile {
  static_assert(kRowBytes % 16 == 0, "rows are whole 16-byte chunks");
  static_assert((kRowBytes / 16 & (kRowBytes / 16 - 1)) == 0 &&
                    (kRowMask << kChunkShift) < kRowBytes / 16,
                "the swizzle stays inside a row of 2^n chunks");
  __device__ __forceinline__ static int chunk(int r, int c) {
    return c ^ (((r >> kRowShift) & kRowMask) << kChunkShift);
  }
  // byte offset of chunk c of row r
  __device__ __forceinline__ static int offset(int r, int c) {
    return r * kRowBytes + (chunk(r, c) << 4);
  }
  // byte offset of element e (of elt_bytes) of row r
  template <int kEltBytes>
  __device__ __forceinline__ static int element(int r, int e) {
    const int byte = e * kEltBytes;
    return r * kRowBytes + (chunk(r, byte >> 4) << 4) + (byte & 15);
  }
};

// ------------------------------------------------------------ staging ----

__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_ca8(void* dst, const void* src,
                                             int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_ca4(void* dst, const void* src,
                                             int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The widest copy (16, 8, 4 or 2 bytes) that every row of a row-major
// array at ``base`` with rows of ``pitch_bytes`` allows: each copy's source
// must be aligned to its size.
inline int copy_width(const void* base, long long pitch_bytes) {
  const unsigned long long a =
      reinterpret_cast<unsigned long long>(base) |
      static_cast<unsigned long long>(pitch_bytes);
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 2;
}

// Copy the first ``valid`` bytes of the 16-byte chunk at ``src`` into the
// 16-byte chunk at ``dst`` (shared) and zero the rest, in pieces of
// ``width`` bytes (from copy_width; ``valid`` is a multiple of it). Widths
// 16, 8 and 4 go by cp.async (the src-size form zero-fills; a piece with
// nothing to read is given ``src`` itself, never an address past the
// data), width 2 by plain loads. ``src`` must be a readable address when
// ``valid`` is 0 too.
__device__ __forceinline__ void copy_chunk(void* dst, const char* src,
                                           int valid, int width) {
  char* d = static_cast<char*>(dst);
  if (width == 16) {
    cp_async_cg16(d, src, valid);
  } else if (width == 8) {
#pragma unroll
    for (int p = 0; p < 16; p += 8) {
      const bool ok = p < valid;
      cp_async_ca8(d + p, ok ? src + p : src, ok ? 8 : 0);
    }
  } else if (width == 4) {
#pragma unroll
    for (int p = 0; p < 16; p += 4) {
      const bool ok = p < valid;
      cp_async_ca4(d + p, ok ? src + p : src, ok ? 4 : 0);
    }
  } else {
    uint16_t h[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      h[p] = 2 * p < valid ? *reinterpret_cast<const uint16_t*>(src + 2 * p)
                           : uint16_t(0);
    uint4 v;
    v.x = h[0] | (uint32_t(h[1]) << 16);
    v.y = h[2] | (uint32_t(h[3]) << 16);
    v.z = h[4] | (uint32_t(h[5]) << 16);
    v.w = h[6] | (uint32_t(h[7]) << 16);
    *reinterpret_cast<uint4*>(d) = v;
  }
}

// Set a kernel's dynamic shared-memory limit once per device and process
// (the call costs host time on every launch otherwise). ``done`` is the
// caller's own flags, one per device, so that kernels of one signature
// keep separate flags.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t set_smem_limit_once(Kernel kernel, int bytes,
                                bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace hopper
