// Device helpers shared by the flash-attention kernels: the constants and
// bf16 packing (all three kernels); cp.async tile loads, bf16
// mma.sync.m16n8k16 with f32 accumulation and ldmatrix fragment loads (the
// two backward kernels). The forward's bf16 kernel is built on hopper.cuh.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 col-major:  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8:            c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// So a C tile re-packed to bf16 pairs is an A fragment of the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE
constexpr int kD = 128;          // head_dim
constexpr int kTile = 64;        // rows of every smem tile
constexpr int kLds = kD + 8;     // padded smem row (bf16): conflict-free reads

typedef __nv_bfloat16 bf16;
typedef bf16 (*Tile)[kLds];

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The 16x16 block of `t` at (r0, c0) as an A fragment (ldmatrix_x4), or,
// through ldmatrix_x4_trans, as the B fragments of two 8-wide n tiles:
// r[0], r[1] for columns c0..c0+7 and r[2], r[3] for c0+8..c0+15, with the
// rows of `t` as the k dimension.
__device__ __forceinline__ const bf16* frag_addr(Tile t, int r0, int c0,
                                                 int lane) {
  return &t[r0 + (lane % 8) + ((lane / 8) % 2) * 8][c0 + (lane / 16) * 8];
}

// B fragment of an n tile whose rows of `t` are the n dimension and whose
// columns are k (t = K for S = Q K^T): b0, b1 of rows n0 + g.
__device__ __forceinline__ void b_frag(uint32_t& b0, uint32_t& b1, Tile t,
                                       int n0, int k0, int lane) {
  const bf16* r = &t[n0 + lane / 4][k0 + (lane % 4) * 2];
  b0 = *reinterpret_cast<const uint32_t*>(r);
  b1 = *reinterpret_cast<const uint32_t*>(r + 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Copy rows [r0, r0 + kTile) of an [S, kD] bf16 matrix (row stride `ss`
// elements) into a padded smem tile with 128 threads; rows past `S` are
// zero-filled.
__device__ __forceinline__ void load_tile(Tile dst, const bf16* src,
                                          long long ss, int r0, int S,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < (kTile * kD / 8) / 128; ++i) {
    int c = tid + i * 128;
    int row = c / (kD / 8);
    int col = (c % (kD / 8)) * 8;
    bool ok = r0 + row < S;
    const bf16* g = ok ? src + (r0 + row) * ss + col : src;
    cp_async16(&dst[row][col], g, ok);
  }
}

}  // namespace flash
