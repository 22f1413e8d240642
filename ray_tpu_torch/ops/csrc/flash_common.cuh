// What the three flash-attention kernels share besides hopper.cuh: the
// mask value and head width of the TPU kernels, the constants of their
// common layout (a producer warpgroup and two consumer warpgroups, tiles
// stored as two 128B-swizzled 64-column halves), exp2 on the MUFU, bf16
// packing of accumulators (for stores, or as a wgmma register A operand),
// the release of a ring stage, and the two wgmma products they are built
// from: A B^T with both operands K-major in shared memory, and A B with A
// from registers and B MN-major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr float kMaskValue = -0.7f * 3.402823466e38f;  // DEFAULT_MASK_VALUE
constexpr int kD = 128;             // head_dim
constexpr int kHalf = 64;           // columns per 128B-swizzled TMA box
constexpr int kProducerRegs = 24;   // setmaxnreg of the producer warpgroup
constexpr int kConsumerRegs = 240;  // and of each consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// An m64nN accumulator (N / 2 values a thread) as the register A operand of
// N / 16 k-steps: k-step kk covers the columns of accumulator blocks j = 2kk
// and 2kk + 1.
template <int kSteps>
__device__ __forceinline__ void pack_a(uint32_t (&a)[kSteps][4],
                                       const float (&x)[8 * kSteps]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// One arrival per consumer warp on an `empty` barrier.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// Issue acc = A B^T as one wgmma group; the caller waits for it. A is 64
// rows and B is N rows (64 or 128) of [row][d] tiles with d contiguous
// (K-major), each stored as two 64-column halves a_half / b_half bytes
// apart; D = 128 in 8 k-steps.
template <int N>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2],
                                          uint32_t a_base, uint32_t a_half,
                                          uint32_t b_base, uint32_t b_half) {
  static_assert(N == 64 || N == 128, "wgmma shapes in hopper.cuh");
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
    const uint64_t da =
        hopper::desc_sw128(a_base + (kk / 4) * a_half + col, 16, 1024);
    const uint64_t db =
        hopper::desc_sw128(b_base + (kk / 4) * b_half + col, 16, 1024);
    if constexpr (N == 128)
      hopper::wgmma_m64n128k16_ss<0>(acc, da, db, kk > 0 ? 1 : 0);
    else
      hopper::wgmma_m64n64k16_ss(acc, da, db, kk > 0 ? 1 : 0);
  }
  hopper::wgmma_commit();
}

// acc (64 x 128) += A B, inside a wgmma group the caller fences and
// commits: A from registers (kSteps k-steps), B [k][n] in shared memory
// with n contiguous, an MN-major operand (transpose bit 1) whose two
// 64-wide n halves are b_half bytes apart; a k-step of 16 rows is 2048
// bytes.
template <int kSteps>
__device__ __forceinline__ void mma_rs(float (&acc)[64],
                                       const uint32_t (&a)[kSteps][4],
                                       uint32_t b_base, uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    hopper::wgmma_m64n128k16_rs<1>(
        acc, a[kk], hopper::desc_sw128(b_base + kk * 16 * 128, b_half, 1024),
        1);
}

// Host: the 4-D tensor map {D, S, heads, batch} over a [B, heads, S, D]
// bf16 tensor given by element strides (batch, head, seq; the last dim
// dense), boxes of 64 columns x `rows` rows, 128B-swizzled. False when the
// driver refuses it (a stride or base address not a multiple of 16 bytes).
inline bool make_bhsd_map(CUtensorMap* map, const void* base, int B,
                          int heads, int S, long long sb, long long sh,
                          long long ss, uint32_t rows) {
  const uint64_t dims[4] = {kD, static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {ss * 2ull, sh * 2ull, sb * 2ull};  // bytes
  const uint32_t box[4] = {kHalf, rows, 1, 1};
  return hopper::make_map_bf16_sw128(map, base, 4, dims, strides, box);
}

}  // namespace flash
