// What the three flash-attention kernels share besides hopper.cuh: the
// mask value and head width of the TPU kernels, the constants of their
// common layout (a producer warpgroup and two consumer warpgroups, tiles
// stored as 128B-swizzled 64-column boxes: two at head_dim 128, four at
// 256), exp2 on the MUFU, bf16 packing of accumulators (for stores, or as
// a wgmma register A operand), the release of a ring stage, and the two
// wgmma products they are built from: A B^T with both operands K-major in
// shared memory (over D / 16 k-steps), and A B with A from registers and B
// MN-major. Then what the two D = 256 backward kernels share (a score
// slice stored to a swizzled box, and A B with both operands in shared
// memory), and what the generic variants (f32, and bf16 from head_dim 768
// up) share: loads and stores by element type, rounding to it, f32 tiles
// in shared memory, the chunk of D they tile by, the backward's
// parameters; the cluster kernels' swizzled f32 score partials (32 columns
// a row in f32, 64 in bf16) and the bf16 ones' offsets into their P, P^T,
// dS and dS^T boxes. Last, on the host: the shared-memory opt-in, the
// tensor maps (bf16, and f32 for the 5-CTA cluster kernels at D = 640) and
// how many clusters of a kernel fit.

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
// rows and B is N rows (32, 64 or 128) of [row][d] tiles with d contiguous
// (K-major), each stored as D / 64 column boxes a_half / b_half bytes
// apart; D / 16 k-steps (8 at the default D = 128, 16 at 256).
template <int N, int D = kD>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2],
                                          uint32_t a_base, uint32_t a_half,
                                          uint32_t b_base, uint32_t b_half) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma shapes in hopper.cuh");
  static_assert(D % kHalf == 0, "D is a whole number of 64-column boxes");
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
    const uint64_t da =
        hopper::desc_sw128(a_base + (kk / 4) * a_half + col, 16, 1024);
    const uint64_t db =
        hopper::desc_sw128(b_base + (kk / 4) * b_half + col, 16, 1024);
    if constexpr (N == 128)
      hopper::wgmma_m64n128k16_ss<0>(acc, da, db, kk > 0 ? 1 : 0);
    else if constexpr (N == 64)
      hopper::wgmma_m64n64k16_ss(acc, da, db, kk > 0 ? 1 : 0);
    else
      hopper::wgmma_m64n32k16_ss(acc, da, db, kk > 0 ? 1 : 0);
  }
  hopper::wgmma_commit();
}

// acc (64 x 128) += A B, inside a wgmma group the caller fences and
// commits: A from registers (kSteps k-steps), B [k][n] in shared memory
// with n contiguous, an MN-major operand (transpose bit 1) whose two
// 64-wide n halves are b_half bytes apart; a k-step of 16 rows is 2048
// bytes. A wider B (D = 256) takes one call per 128-column half, each with
// its own accumulator and b_base.
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

// What the two D = 256 backward kernels share: a 64-row [row][64 col] bf16
// box (8 KB, 128B-swizzled as TMA writes it and as wgmma reads a K-major
// operand), and the two steps that pass an m64n32 slice of scores from one
// consumer to both through such a box.
constexpr uint32_t kBoxBytes = 64 * kHalf * 2;

// This consumer's 64 x 32 slice (columns 32 cw..) of an m64n32 accumulator
// as bf16 into a [64][64] box, 128B-swizzled as wgmma reads a K-major A
// operand: the 16-byte chunk c of row r sits at chunk c ^ (r % 8). A warp's
// 32 stores fall in 32 banks.
__device__ __forceinline__ void store_t(__nv_bfloat16* box,
                                        const float (&x)[16], int cw,
                                        int warp, int lane) {
  unsigned char* base = reinterpret_cast<unsigned char*>(box);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = 16 * warp + lane / 4 + 8 * a;
      const int chunk = (cw * 4 + j) ^ (r % 8);
      *reinterpret_cast<uint32_t*>(base + r * 128 + chunk * 16 +
                                   4 * (lane % 4)) =
          pack_bf16(x[4 * j + 2 * a], x[4 * j + 2 * a + 1]);
    }
}

// acc (64 rows x 128 d) += A B inside a wgmma group: A one [64][64] box
// (K-major in shared memory, as store_t writes it), B [k][d] MN-major, two
// 64-column boxes of a 64-row tile one box apart (LBO); 4 k-steps of 16
// rows.
__device__ __forceinline__ void mma_t(float (&acc)[64], uint32_t a_base,
                                      uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_m64n128k16_ss<1>(
        acc, hopper::desc_sw128(a_base + kk * 32, 16, 1024),
        hopper::desc_sw128(b_base + kk * 16 * 128, kBoxBytes, 1024), 1);
}

// ---------------------------------------------------------------------------
// The generic variants (the f32 forward at 128, f32 and bf16 from 768 up):
// scalar FMAs on the CUDA cores over f32 tiles in dynamic shared memory.
// Inputs are read 4 elements at a time (16 bytes of f32, 8 of
// bf16: the wrappers' layout check keeps rows 16-byte aligned) and widened
// to f32; P and dS are rounded to the input dtype where the Pallas kernels
// round them.
// ---------------------------------------------------------------------------

// The chunk of D a generic variant tiles by above 4 kD (the f32 forward at kD
// runs in one chunk): 2 kD where it divides D, else kD. Chunks stay narrow
// enough that the chunked instances, which hold the chunk's accumulators
// and the chunk loop's state, fit in registers with no spill.
inline int gen_chunk(int D) { return D % (2 * kD) == 0 ? 2 * kD : kD; }

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a += b * c, elementwise
__device__ __forceinline__ void fma4(float4& a, float4 b, float4 c) {
  a.x = fmaf(b.x, c.x, a.x);
  a.y = fmaf(b.y, c.y, a.y);
  a.z = fmaf(b.z, c.z, a.z);
  a.w = fmaf(b.w, c.w, a.w);
}

// acc += w * b, elementwise: a row of the f32 cluster kernels' register
// tiles
__device__ __forceinline__ void fma4(float (&acc)[4], float w, float4 b) {
  acc[0] = fmaf(w, b.x, acc[0]);
  acc[1] = fmaf(w, b.y, acc[1]);
  acc[2] = fmaf(w, b.z, acc[2]);
  acc[3] = fmaf(w, b.w, acc[3]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float hsum(float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

__device__ __forceinline__ float4 f4(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

// The f32 cluster backward kernels' [64][32] f32 score tiles (dK/dV at D =
// 640 and 1024, dQ at 1024) in shared memory: 8 16-byte columns a row,
// column c of row r at c ^ (r % 8), so 8 consecutive rows' stores of one
// column fall in 8 banks.
__device__ __forceinline__ int swz32(int row, int col4) {
  return row * 32 + ((col4 ^ (row & 7)) << 2);
}

// The bf16 cluster kernels' (D = 640) [row][64] f32 score partials: 16
// 16-byte columns a row, column c of row r at c ^ (r % 8), so the 8 rows a
// warp's accumulator store covers fall in distinct banks.
__device__ __forceinline__ int swz64(int row, int col4) {
  return row * 64 + ((col4 ^ (row & 7)) << 2);
}

// Byte offset of columns 4 col4.. of row `row` in their bf16 [row][64]
// boxes of P, P^T or dS^T, whose 16-byte chunk c of a row sits at c ^ (row %
// 8) (store_t's layout, as wgmma reads a K-major operand).
__device__ __forceinline__ uint32_t box_at(int row, int col4) {
  return row * 128 + ((((col4 >> 1) ^ (row & 7))) << 4) + (col4 & 1) * 8;
}

// Rows [r0, r0 + rows) of an [S, D] matrix (row stride `ss` elements, the
// last dim dense) into f32 shared memory with a row pitch of D + 4 floats
// (16-byte aligned rows whose float4s fall in distinct banks from one row to
// the next); rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int rows,
                                          int S, int tid, int nthreads) {
  for (int i = tid; i < rows * (D / 4); i += nthreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      v = Elem<T>::load4(src + static_cast<long long>(r0 + r) * ss + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = v;
  }
}

// What the two backward entry points hand their generic variants: inputs
// by element strides (batch, head, seq), lse and delta [B, H, Sq] f32, the
// outputs dense (out0 = dK and out1 = dV, or out0 = dQ).
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;
  void* out1;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, KVH, Sq, Skv;
  float scale;
  int causal;
};

// Host: dynamic shared memory above 48 KB for one kernel. Set at every
// launch of a generic variant (a host call of about a microsecond), since
// their instances share one function type.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Host: the 4-D tensor map {D, S, heads, batch} over a [B, heads, S, D]
// bf16 tensor given by element strides (batch, head, seq; the last dim
// dense), boxes of 64 columns x `rows` rows, 128B-swizzled. False when the
// driver refuses it (a stride or base address not a multiple of 16 bytes).
inline bool make_bhsd_map(CUtensorMap* map, const void* base, int B,
                          int heads, int S, long long sb, long long sh,
                          long long ss, uint32_t rows, int D = kD) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {ss * 2ull, sh * 2ull, sb * 2ull};  // bytes
  const uint32_t box[4] = {kHalf, rows, 1, 1};
  return hopper::make_map_bf16_sw128(map, base, 4, dims, strides, box);
}

// Host: make_bhsd_map over an f32 tensor, boxes of 32 columns (128 bytes) x
// `rows` rows, with `swizzle` (128B for a tile read down 8 rows of one
// 16-byte column at once, none for one read along its rows). Used by the
// 5-CTA cluster kernels (f32 at D = 640).
inline bool make_f32_map(CUtensorMap* map, const void* base, int B,
                         int heads, int S, long long sb, long long sh,
                         long long ss, uint32_t rows, int D,
                         CUtensorMapSwizzle swizzle) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {ss * 4ull, sh * 4ull, sb * 4ull};  // bytes
  const uint32_t box[4] = {32, rows, 1, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, swizzle,
                          base, 4, dims, strides, box);
}

// Host: how many clusters of `kernel` (one cluster of `ctas` CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory each) the
// current device holds at once, into *clusters; the CUDA error.
template <typename Kernel>
inline int max_clusters(Kernel kernel, int ctas, int threads, int smem,
                        int* clusters) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  err = cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg);
  return static_cast<int>(err);
}

}  // namespace flash
