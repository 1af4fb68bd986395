// Device helpers shared by the flash-attention kernels (forward K1,
// backward K2 and K3): cp.async copies into padded shared-memory tiles,
// ldmatrix fragment loads and the m16n8k16 bf16 tensor-core product.
//
// Fragment conventions (PTX ISA, mma.m16n8k16 with .bf16): lane l holds
// g = l / 4 and t = l % 4. A C fragment c[0..3] covers rows g and g + 8,
// columns 2t and 2t + 1 of a 16 x 8 tile; an A fragment a[0..3] covers rows
// g, g + 8 and k columns 2t.., 8 + 2t.. of a 16 x 16 tile. Two C fragments
// of neighbouring 8-column tiles, rounded to bf16 and packed in pairs, are
// therefore exactly the A fragment of that 16 x 16 tile, which is how the
// kernels feed P and dS from registers into the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kPad = 8;  // bf16 elements of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a tile of kRows rows of D bf16 (row stride `ld` elements in global
// memory) into shared memory rows of D + kPad elements, 16 bytes a thread,
// spread over kThreads threads.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* gmem,
                                          int64_t ld) {
  constexpr int kChunksPerRow = D / 8;
  constexpr int kChunks = kRows * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    cp_async16(smem_u32(smem + row * (D + kPad) + col),
               gmem + static_cast<int64_t>(row) * ld + col);
  }
}

// ldmatrix row addresses for a lane (lrow = lane & 7, lmat = lane >> 3),
// in elements from the tile origin, for a tile with row stride ld:
// - A operand (rows = M, cols = K, row-major in smem): matrices
//   (rows 0-7 | 8-15) x (cols 0-7 | 8-15).
__device__ __forceinline__ int a_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
// - B operand stored with N as the row (like K in Q K^T): b0, b1 of the
//   8-wide n tile and b0, b1 of the next one.
__device__ __forceinline__ int b_offset(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}
// - B operand stored with K as the row (like V in P V), loaded with .trans:
//   b0, b1 of the 8-wide n tile and b0, b1 of the next one.
__device__ __forceinline__ int bt_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

}  // namespace flash
