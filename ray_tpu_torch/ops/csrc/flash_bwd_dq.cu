// Flash-attention backward, dQ, for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dq_kernel`, launched by
// `_flash_bwd_pallas` (ray_tpu/ops/attention.py:262-309, call :356). Same
// function: per q tile, for every visible KV tile, recompute
//   S = Q K^T * scale (masked to -0.7 * FLT_MAX), P = exp(S - LSE),
//   dP = dO V^T, dS = P * (dP - delta) * scale rounded to bf16,
// and accumulate dQ += dS K in f32; dQ is stored in bf16. LSE comes from
// the forward and delta = rowsum(dO * O) from the caller, both f32.
//
// What bounds it on the H100, and what the design does about it:
//   * At training lengths it is bound by the tensor cores: 3 products of
//     2 * 64 * 128 * 128 per (64 q rows, 128 KV rows) pair, 6 * B * H * D *
//     pairs FLOP in all. It has the forward's skeleton: each block owns 128
//     q rows of one (b, h) and has three warpgroups, a producer
//     (setmaxnreg.dec to 24) in which one thread issues every TMA load, and
//     two consumers of 64 q rows each (setmaxnreg.inc to 240). Q and dO
//     (128 x 128 bf16 each) are loaded once and stay in shared memory; K
//     and V tiles of 128 rows go through a ring of 2 stages, each with
//     `full` mbarriers (TMA bytes) for K and for V and `empty` ones that
//     the consumer warps arrive at, V's once dP is done, K's once dQ +=
//     dS K is. A short sequence (Sq <= 64) leaves the second consumer no
//     rows: it exits at once and the `empty` barriers count only the first
//     one's warps.
//   * S = Q K^T and dP = dO V^T are wgmma.m64n128k16 with both operands
//     K-major in shared memory; dP is issued right behind S, and P (one
//     FFMA and one MUFU.EX2 per score, raw scores in log2 units against
//     LSE * log2 e) is computed while the tensor cores work on dP, its
//     results tied before the wait so the compiler cannot sink them below
//     it. dS re-packs from the accumulators into the register A operand
//     of dQ += dS K, which reads K [kv][d] MN-major through the transpose
//     bit, as the forward reads V. dQ (64 registers) stays in f32
//     registers for the whole KV loop.
//   * The TPU kernel's sequential KV grid axis and its VMEM dQ scratch
//     become the loop inside one block. KV tiles wholly above the diagonal
//     are never loaded; only the diagonal tile and a ragged KV edge carry
//     mask code (a template, not a branch per score). Blocks start with
//     the heaviest causal q tiles, and the H / KVH q heads that share one
//     KV head run next to each other, so they read its K and V from L2.
//   * Grouped-query attention reads KV head h / (H / KVH) in place.
//   * The tensor maps are 4-D {D, S, heads, batch} built from the element
//     strides the caller passes, so strided q, k, v and dO load without a
//     copy; TMA zero-fills rows past Sq and Skv, rows past Sq get LSE =
//     +inf (P = 0), and the stores are guarded by row < Sq.
// That kernel serves bf16 at head_dim 128. At 256 (llama3_8b(n_heads=16)) its
// arrangement does not fit: Q and dO for 128 rows take 128 KB of shared
// memory and a 2-stage ring of 64-row K and V tiles another 128 KB, and
// 32-row KV tiles would leave N = 32 products with both operands in shared
// memory for the whole tile. flash_bwd_dq_d256_kernel (after it) serves bf16
// at 256, bound by the tensor cores (3 products of 2 * 64 * 64 * 256 per
// (64 q rows, 64 KV rows) pair) and by shared memory:
//   * A block owns 64 q rows of one (b, h). Q and dO (64 x 256 each, four
//     64-column boxes, 32 KB) are loaded once; K and V tiles of 64 rows go
//     through a 2-stage ring with `full`/`empty` mbarriers as above.
//   * The products over D, S = Q K^T and dP = dO V^T, are split by KV
//     columns, so none is done twice: each consumer takes 32 of the tile's
//     64 (wgmma.m64n32k16, 16 k-steps, both operands K-major; 16 registers
//     each), computes its half of P and of dS = P (dP - delta) * scale and
//     stores dS in bf16 (rounded as the Pallas kernel rounds it) into a
//     128B-swizzled [q][kv] box; a proxy fence and a named barrier over
//     both consumers publish the two halves.
//   * dQ is split by columns: each consumer holds a 128-column half (64 f32
//     registers) for the whole loop and computes dQ[:, half] += dS K[:,
//     half] as wgmma.m64n128k16 with both operands in shared memory (dS
//     K-major as A, K's two boxes of that half MN-major through the
//     transpose bit as B).
//   * dS has two buffers, so one barrier an iteration also keeps a
//     consumer from overwriting what the other still reads: 64 (Q, dO) +
//     128 (ring) + 16 KB of shared memory, 210 KB with the alignment.
//   * As in the D = 256 dK/dV kernel, each iteration waits for its own
//     products: the N = 32 score products read more shared memory than it
//     gives the tensor cores, and the consumers meet at the barrier with
//     the tensor cores idle while both compute P and dS.
// A generic variant (at the end of this file) serves f32 at any head_dim
// that is a multiple of 128 and bf16 at those from 384 up (tiled over D
// from 640 up), with P and dS rounded to the input dtype as the Pallas
// kernel rounds them.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::fast_exp2;
using flash::kConsumerRegs;
using flash::kD;
using flash::kHalf;
using flash::kLog2e;
using flash::kProducerRegs;
using flash::pack_bf16;
using flash::release;
typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;         // consumer warpgroups, 64 q rows each
constexpr int kBM = 64 * kConsumers;  // q rows per block
constexpr int kBN = 128;              // KV rows per tile
constexpr int kStages = 2;            // K/V ring depth
constexpr uint32_t kQHalfBytes = kBM * kHalf * 2;   // 16 KB
constexpr uint32_t kKvHalfBytes = kBN * kHalf * 2;  // 16 KB
constexpr uint32_t kTileBytes = kBN * kD * 2;       // one K or V tile

struct __align__(1024) DqSmem {
  bf16 q[2][kBM * kHalf];  // two 64-column halves
  bf16 dout[2][kBM * kHalf];
  bf16 k[kStages][2][kBN * kHalf];
  bf16 v[kStages][2][kBN * kHalf];
  uint64_t q_full;            // Q and dO
  uint64_t k_full[kStages];   // TMA bytes of K have landed
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];  // every consumer warp is done with K
  uint64_t v_empty[kStages];
};

// + slack to align the base to 1024 bytes.
constexpr int kSmemBytes = static_cast<int>(sizeof(DqSmem)) + 1024;

struct DqArgs {
  const float* lse;    // [B, H, Sq] dense
  const float* delta;  // [B, H, Sq] dense
  bf16* dq;            // [B, H, Sq, D] dense
  int H, KVH, Sq, Skv, n_qt;
  float scale_log2;  // scale * log2(e)
  float scale;
  int causal;
};

// Issue acc = A B^T as one wgmma group: A is this warpgroup's 64 rows of Q
// or dO, B the KV tile's K or V (128 rows), both K-major. The caller waits.
__device__ __forceinline__ void issue_s(float (&acc)[64], uint32_t a_base,
                                        uint32_t b_base) {
  flash::issue_abt<kBN>(acc, a_base, kQHalfBytes, b_base, kKvHalfBytes);
}

// Issue dQ += dS K as one wgmma group: dS (bf16) is the register A operand,
// K [kv][d] with d contiguous is read MN-major, as the forward reads V.
__device__ __forceinline__ void issue_dq(float (&dq)[64],
                                         const uint32_t (&a)[kBN / 16][4],
                                         uint32_t k_base) {
  hopper::wgmma_fence();
  flash::mma_rs(dq, a, k_base, kKvHalfBytes);
  hopper::wgmma_commit();
}

// P in place, for an accumulator of N / 2 KV columns: s[4j + 2a + b] holds
// q row r_lo + 8a, KV column k0 + 8j + 2(lane % 4) + b; lse_* are LSE *
// log2(e) of the two rows. Masked (the diagonal tile or a ragged KV edge):
// columns past Skv, or after the row (causal). The unmasked instance carries
// no mask code.
template <bool kMasked, int N>
__device__ __forceinline__ void probs(float (&s)[N], const DqArgs& p,
                                      float lse_lo, float lse_hi, int k0,
                                      int r_lo, int lane) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fast_exp2(
          fmaf(s[4 * j + e], p.scale_log2, e < 2 ? -lse_lo : -lse_hi));
      if (kMasked) {
        const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const int row = r_lo + (e < 2 ? 0 : 8);
        if (col >= p.Skv || (p.causal && col > row)) x = 0.f;
      }
      s[4 * j + e] = x;
    }
  }
}

template <int N>
__device__ __forceinline__ void probs(float (&s)[N], const DqArgs& p,
                                      bool masked, float lse_lo,
                                      float lse_hi, int k0, int r_lo,
                                      int lane) {
  if (masked)
    probs<true, N>(s, p, lse_lo, lse_hi, k0, r_lo, lane);
  else
    probs<false, N>(s, p, lse_lo, lse_hi, k0, r_lo, lane);
  // Keep P ahead of the wait for dP: without these ties the compiler may
  // sink the exponentials below it, and nothing would overlap.
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_reg(s[i]);
}

// dS = P (dP - delta) * scale, packed to bf16 as the register A operand of
// dQ += dS K: k-step kk covers the KV columns of accumulator blocks j = 2kk
// and 2kk + 1 (elements 8kk..8kk+7; 0-1 and 4-5 on the row r_lo, 2-3 and
// 6-7 on r_lo + 8).
__device__ __forceinline__ void pack_ds(uint32_t (&a)[kBN / 16][4],
                                        const float (&s)[64],
                                        const float (&dp)[64], float dl_lo,
                                        float dl_hi, float scale) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r;
      const float dl = (r % 2 == 0) ? dl_lo : dl_hi;
      a[kk][r] = pack_bf16(s[i] * (dp[i] - dl) * scale,
                           s[i + 1] * (dp[i + 1] - dl) * scale);
    }
  }
}

__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const DqArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  DqSmem& sm = *reinterpret_cast<DqSmem*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));

  // Block -> (q tile, b, KV head, head in the group), the group fastest,
  // the q tile slowest: causal, the heaviest (last) q tiles start first.
  const int G = p.H / p.KVH;
  const int n_bk = gridDim.x / (G * p.n_qt);  // B * KVH
  int id = blockIdx.x;
  const int g = id % G;
  id /= G;
  const int bk = id % n_bk;
  const int rank = id / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int h = kvh * G + g;
  const int qt = p.causal ? p.n_qt - 1 - rank : rank;
  const int q0 = qt * kBM;
  const int kv_end = p.causal ? min(p.Skv, q0 + kBM) : p.Skv;
  const int n_kt = (kv_end + kBN - 1) / kBN;

  // A short sequence (Sq <= 64) leaves the second consumer no rows: it
  // exits at once, and the `empty` barriers count the first one's warps.
  const int consumers = q0 + 64 < p.Sq ? kConsumers : 1;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.k_empty[s], 4 * consumers);  // consumer warps
      hopper::mbar_init(&sm.v_empty[s], 4 * consumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load --------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.q_full, 2 * kBM * kD * 2);
      hopper::tma_load_4d(sm.q[0], &tq, &sm.q_full, 0, q0, h, b);
      hopper::tma_load_4d(sm.q[1], &tq, &sm.q_full, kHalf, q0, h, b);
      hopper::tma_load_4d(sm.dout[0], &tdo, &sm.q_full, 0, q0, h, b);
      hopper::tma_load_4d(sm.dout[1], &tdo, &sm.q_full, kHalf, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t freed = ((kt / kStages) - 1) & 1;
        const int k0 = kt * kBN;
        if (kt >= kStages) hopper::mbar_wait(&sm.k_empty[s], freed);
        hopper::mbar_expect_tx(&sm.k_full[s], kTileBytes);
        hopper::tma_load_4d(sm.k[s][0], &tk, &sm.k_full[s], 0, k0, kvh, b);
        hopper::tma_load_4d(sm.k[s][1], &tk, &sm.k_full[s], kHalf, k0, kvh,
                            b);
        if (kt >= kStages) hopper::mbar_wait(&sm.v_empty[s], freed);
        hopper::mbar_expect_tx(&sm.v_full[s], kTileBytes);
        hopper::tma_load_4d(sm.v[s][0], &tv, &sm.v_full[s], 0, k0, kvh, b);
        hopper::tma_load_4d(sm.v[s][1], &tv, &sm.v_full[s], kHalf, k0, kvh,
                            b);
      }
    }
  } else {
    // ---------------- consumers: 64 q rows each -------------------------
    const int cw = wg - 1;
    if (cw >= consumers) return;
    hopper::reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int row_c = q0 + cw * 64;  // this warpgroup's first q row
    const int r_lo = row_c + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;
    // Rows past Sq get LSE = +inf, so P = 0 there and they add nothing.
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    const float lse_lo = r_lo < p.Sq ? p.lse[row0 + r_lo] * kLog2e : INFINITY;
    const float lse_hi = r_hi < p.Sq ? p.lse[row0 + r_hi] * kLog2e : INFINITY;
    const float dl_lo = r_lo < p.Sq ? p.delta[row0 + r_lo] : 0.f;
    const float dl_hi = r_hi < p.Sq ? p.delta[row0 + r_hi] : 0.f;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    float sc[64], dp[64];
    uint32_t ds[kBN / 16][4];
    const uint32_t q_base = hopper::smem_u32(sm.q[0]) + cw * 64 * 128;
    const uint32_t do_base = hopper::smem_u32(sm.dout[0]) + cw * 64 * 128;

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const int k0 = kt * kBN;
      const bool masked =
          (k0 + kBN > p.Skv) || (p.causal && k0 + kBN - 1 > row_c);
      const uint32_t k_base = hopper::smem_u32(sm.k[s][0]);
      hopper::mbar_wait(&sm.k_full[s], parity);
      issue_s(sc, q_base, k_base);  // S = Q K^T
      hopper::mbar_wait(&sm.v_full[s], parity);
      issue_s(dp, do_base, hopper::smem_u32(sm.v[s][0]));  // dP = dO V^T
      hopper::wgmma_wait<1>();  // S is done, dP may still run
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_reg(sc[i]);
      probs(sc, p, masked, lse_lo, lse_hi, k0, r_lo, lane);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_reg(dp[i]);
      release(&sm.v_empty[s], lane);
      pack_ds(ds, sc, dp, dl_lo, dl_hi, p.scale);
      issue_dq(dq, ds, k_base);  // dQ += dS K
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_reg(dq[i]);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) hopper::fence_reg(ds[kk][i]);
      release(&sm.k_empty[s], lane);
    }

    bf16* dQ = p.dq + row0 * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      if (r_lo < p.Sq)
        *reinterpret_cast<uint32_t*>(dQ + static_cast<long long>(r_lo) * kD +
                                     c) = pack_bf16(dq[4 * j], dq[4 * j + 1]);
      if (r_hi < p.Sq)
        *reinterpret_cast<uint32_t*>(dQ + static_cast<long long>(r_hi) * kD +
                                     c) =
            pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 256: 64 q rows per block, the two consumers split dQ by
// columns and the scores by KV columns (see the top of this file), the
// arrangement of the D = 256 dK/dV kernel with q and KV in each other's
// places. Its block walk follows the D = 128 kernel's.
// ---------------------------------------------------------------------------

namespace d256 {

using flash::kBoxBytes;  // 8 KB: 64 rows x 128 B
using flash::mma_t;
using flash::store_t;

constexpr int kDW = 2 * kD;              // head_dim
constexpr int kBoxes = kDW / kHalf;      // 64-column boxes of a row
constexpr int kBM = 64;                  // q rows per block
constexpr int kBN = 64;                  // KV rows per tile
constexpr int kKvCols = kBN / kConsumers;  // S, dP columns per consumer
constexpr uint32_t kTileBytes = 64 * kDW * 2;  // one Q, dO, K or V tile

struct __align__(1024) Smem {
  bf16 q[kBoxes][kBM * kHalf];
  bf16 dout[kBoxes][kBM * kHalf];
  bf16 k[kStages][kBoxes][kBN * kHalf];
  bf16 v[kStages][kBoxes][kBN * kHalf];
  bf16 ds[2][kBM * kBN];  // dS [q][kv], one 128B-swizzled box; 2 buffers
  uint64_t q_full;            // Q and dO
  uint64_t k_full[kStages];   // TMA bytes of K have landed
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];  // every consumer warp is done with K
  uint64_t v_empty[kStages];
};

// + slack to align the base to 1024 bytes.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const DqArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Smem& sm =
      *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));

  // Block -> (q tile, b, KV head, head in the group), as at D = 128.
  const int G = p.H / p.KVH;
  const int n_bk = gridDim.x / (G * p.n_qt);  // B * KVH
  int id = blockIdx.x;
  const int g = id % G;
  id /= G;
  const int bk = id % n_bk;
  const int rank = id / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int h = kvh * G + g;
  const int qt = p.causal ? p.n_qt - 1 - rank : rank;
  const int q0 = qt * kBM;
  const int kv_end = p.causal ? min(p.Skv, q0 + kBM) : p.Skv;
  const int n_kt = (kv_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.k_full[s], 1);
      hopper::mbar_init(&sm.v_full[s], 1);
      hopper::mbar_init(&sm.k_empty[s], 4 * kConsumers);  // consumer warps
      hopper::mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: as at D = 128, four boxes a tile --------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.q_full, 2 * kTileBytes);
#pragma unroll
      for (int i = 0; i < kBoxes; ++i) {
        hopper::tma_load_4d(sm.q[i], &tq, &sm.q_full, i * kHalf, q0, h, b);
        hopper::tma_load_4d(sm.dout[i], &tdo, &sm.q_full, i * kHalf, q0, h,
                            b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t freed = ((kt / kStages) - 1) & 1;
        const int k0 = kt * kBN;
        if (kt >= kStages) hopper::mbar_wait(&sm.k_empty[s], freed);
        hopper::mbar_expect_tx(&sm.k_full[s], kTileBytes);
#pragma unroll
        for (int i = 0; i < kBoxes; ++i)
          hopper::tma_load_4d(sm.k[s][i], &tk, &sm.k_full[s], i * kHalf, k0,
                              kvh, b);
        if (kt >= kStages) hopper::mbar_wait(&sm.v_empty[s], freed);
        hopper::mbar_expect_tx(&sm.v_full[s], kTileBytes);
#pragma unroll
        for (int i = 0; i < kBoxes; ++i)
          hopper::tma_load_4d(sm.v[s][i], &tv, &sm.v_full[s], i * kHalf, k0,
                              kvh, b);
      }
    }
  } else {
    // ---------------- consumers: all 64 q rows, half the columns --------
    // Consumer cw computes S and dP for KV columns 32 cw.. of the tile and
    // owns columns 128 cw.. of dQ.
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r_lo = q0 + warp * 16 + lane / 4;  // this thread's q rows
    const int r_hi = r_lo + 8;
    // Rows past Sq get LSE = +inf, so P = 0 there and they add nothing.
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    const float lse_lo = r_lo < p.Sq ? p.lse[row0 + r_lo] * kLog2e : INFINITY;
    const float lse_hi = r_hi < p.Sq ? p.lse[row0 + r_hi] * kLog2e : INFINITY;
    const float dl_lo = r_lo < p.Sq ? p.delta[row0 + r_lo] : 0.f;
    const float dl_hi = r_hi < p.Sq ? p.delta[row0 + r_hi] : 0.f;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    float sc[kKvCols / 2], dp[kKvCols / 2];
    const uint32_t q_base = hopper::smem_u32(sm.q[0]);
    const uint32_t do_base = hopper::smem_u32(sm.dout[0]);
    const uint32_t rows = cw * kKvCols * 128;  // this consumer's KV rows
    const uint32_t half = 2 * cw * kBoxBytes;  // its dQ columns' K boxes

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const int buf = kt & 1;
      const uint32_t parity = (kt / kStages) & 1;
      const int k0 = kt * kBN;
      const bool masked =
          (k0 + kBN > p.Skv) || (p.causal && k0 + kBN - 1 > q0);
      const uint32_t k_base = hopper::smem_u32(sm.k[s][0]);
      // S = Q K^T, dP = dO V^T: 16 k-steps of m64n32k16 each.
      hopper::mbar_wait(&sm.k_full[s], parity);
      flash::issue_abt<kKvCols, kDW>(sc, q_base, kBoxBytes, k_base + rows,
                                     kBoxBytes);
      hopper::mbar_wait(&sm.v_full[s], parity);
      flash::issue_abt<kKvCols, kDW>(dp, do_base, kBoxBytes,
                                     hopper::smem_u32(sm.v[s][0]) + rows,
                                     kBoxBytes);
      hopper::wgmma_wait<1>();  // S is done, dP may still run
#pragma unroll
      for (int i = 0; i < kKvCols / 2; ++i) hopper::fence_reg(sc[i]);
      // P for this consumer's KV columns, from k0 + 32 cw.
      probs(sc, p, masked, lse_lo, lse_hi, k0 + cw * kKvCols, r_lo, lane);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kKvCols / 2; ++i) hopper::fence_reg(dp[i]);
      release(&sm.v_empty[s], lane);
      // dS = P (dP - delta) * scale in place of dP, rounded to bf16 by
      // store_t as the Pallas kernel rounds it.
#pragma unroll
      for (int i = 0; i < kKvCols / 2; ++i)
        dp[i] = sc[i] * (dp[i] - ((i % 4) < 2 ? dl_lo : dl_hi)) * p.scale;
      // Both halves of dS for both consumers' products; two buffers, as
      // in the D = 256 dK/dV kernel.
      store_t(sm.ds[buf], dp, cw, warp, lane);
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1, 256);
      hopper::wgmma_fence();
      mma_t(dq, hopper::smem_u32(sm.ds[buf]), k_base + half);  // dQ += dS K
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_reg(dq[i]);
      release(&sm.k_empty[s], lane);
    }

    bf16* dQ = p.dq + row0 * kDW;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = cw * kD + j * 8 + (lane % 4) * 2;
      if (r_lo < p.Sq)
        *reinterpret_cast<uint32_t*>(dQ + static_cast<long long>(r_lo) * kDW +
                                     c) = pack_bf16(dq[4 * j], dq[4 * j + 1]);
      if (r_hi < p.Sq)
        *reinterpret_cast<uint32_t*>(dQ + static_cast<long long>(r_hi) * kDW +
                                     c) =
            pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
    }
  }
}

}  // namespace d256

// ---------------------------------------------------------------------------
// Generic variant: every dtype and head_dim (a multiple of 128) but bf16
// D = 128 and 256, which the wgmma kernels above serve. The same function on the CUDA
// cores: one block of 128 threads per (b, h, 16 q rows, chunk of D), walking
// the visible 32-row KV tiles, with Q, dO, K, V as f32 tiles in dynamic
// shared memory (102 KB at DC = 256, 196 KB at 512). D up to 512 runs in one
// chunk (DC = D); above, D is cut into chunks of DC = 256 or 128 columns
// (flash::gen_chunk; the chunked instances): each block writes one chunk of
// dQ, and the contractions over D (S = Q K^T and dP = dO V^T) are
// summed over the chunks staged one at a time, in the order that ends with
// the block's own chunk, so K's columns for dQ are the ones left in shared
// memory. With more than one chunk Q and dO are reloaded per chunk and every
// block recomputes the scores (D / DC times their work; right and slow
// first). Each thread computes 4 entries of dS (q row tid / 8, KV columns
// tid % 8 + 8i; rounded to q's dtype) and holds an eighth of its row's dQ
// chunk as interleaved float4s in f32 registers for the whole KV loop. Bound
// by shared-memory reads, not by the FMA rate; simple first.
// ---------------------------------------------------------------------------

constexpr int kGBQ = 16;  // q rows per block, 8 threads per row
constexpr int kGBN = 32;  // KV rows per tile

template <int DC>
constexpr int gen_smem_bytes() {
  return ((2 * kGBQ + 2 * kGBN) * (DC + 4) + kGBQ * (kGBN + 1)) * 4;
}

template <typename T, int DC, bool kChunked>
__device__ __forceinline__ void flash_bwd_dq_generic_body(
    const flash::BwdParams& p) {
  extern __shared__ float4 gen_smem[];
  constexpr int kP = DC + 4;      // row pitch of the f32 tiles
  constexpr int kPS = kGBN + 1;   // row pitch of dS
  float* Qs = reinterpret_cast<float*>(gen_smem);
  float* Os = Qs + kGBQ * kP;  // dO
  float* Ks = Os + kGBQ * kP;
  float* Vs = Ks + kGBN * kP;
  float* Ss = Vs + kGBN * kP;

  const int tid = threadIdx.x;
  const int r = tid / 8;  // q row of the tile
  const int cc = tid % 8;
  const int n_qt = gridDim.x;
  const int qt = p.causal ? (n_qt - 1 - blockIdx.x) : blockIdx.x;
  const int bh = blockIdx.y;
  const int n_dc = kChunked ? gridDim.z : 1;
  const int oc = kChunked ? blockIdx.z : 0;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kGBQ;
  const int row = q0 + r;
  const long long rowg = static_cast<long long>(bh) * p.Sq + row;
  const float lse = row < p.Sq ? p.lse[rowg] : INFINITY;  // P = 0 past Sq
  const float delta = row < p.Sq ? p.delta[rowg] : 0.f;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dO = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  if (n_dc == 1) {
    flash::load_tile<T, DC>(Qs, Q, p.q_ss, q0, kGBQ, p.Sq, tid, 128);
    flash::load_tile<T, DC>(Os, dO, p.o_ss, q0, kGBQ, p.Sq, tid, 128);
  }

  float dq[DC / 8];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) dq[i] = 0.f;

  const int kv_end = p.causal ? min(p.Skv, q0 + kGBQ) : p.Skv;
  const int n_kt = (kv_end + kGBN - 1) / kGBN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kGBN;
    // S and dP entries (row, k0 + cc + 8i)
    float4 s4[kGBN / 8], p4[kGBN / 8];
#pragma unroll
    for (int i = 0; i < kGBN / 8; ++i)
      s4[i] = p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int ci = 0; ci < n_dc; ++ci) {
      const int dc = (oc + 1 + ci) % n_dc;  // ends with the block's chunk
      __syncthreads();  // Q, dO stored / the last chunk's readers are done
      if (n_dc > 1) {
        flash::load_tile<T, DC>(Qs, Q + dc * DC, p.q_ss, q0, kGBQ, p.Sq, tid,
                                128);
        flash::load_tile<T, DC>(Os, dO + dc * DC, p.o_ss, q0, kGBQ, p.Sq,
                                tid, 128);
      }
      flash::load_tile<T, DC>(Ks, K + dc * DC, p.k_ss, k0, kGBN, p.Skv, tid,
                              128);
      flash::load_tile<T, DC>(Vs, V + dc * DC, p.v_ss, k0, kGBN, p.Skv, tid,
                              128);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < DC; d += 4) {
        const float4 q4 = flash::ld4(Qs + r * kP + d);
        const float4 o4 = flash::ld4(Os + r * kP + d);
#pragma unroll
        for (int i = 0; i < kGBN / 8; ++i) {
          const int j = cc + 8 * i;
          flash::fma4(s4[i], q4, flash::ld4(Ks + j * kP + d));
          flash::fma4(p4[i], o4, flash::ld4(Vs + j * kP + d));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGBN / 8; ++i) {
      const int j = cc + 8 * i;
      const int col = k0 + j;
      float x = flash::hsum(s4[i]) * p.scale;
      if (col >= p.Skv || (p.causal && col > row)) x = flash::kMaskValue;
      const float pr = expf(x - lse);
      Ss[r * kPS + j] =
          flash::Elem<T>::round((flash::hsum(p4[i]) - delta) * pr * p.scale);
    }
    __syncthreads();

    // dQ += dS K over the tile's KV rows (the chunk's columns)
#pragma unroll 4
    for (int j = 0; j < kGBN; ++j) {
      const float sj = Ss[r * kPS + j];
#pragma unroll
      for (int q = 0; q < DC / 32; ++q) {
        const float4 k4 = flash::ld4(Ks + j * kP + 4 * (cc + 8 * q));
        dq[4 * q] = fmaf(sj, k4.x, dq[4 * q]);
        dq[4 * q + 1] = fmaf(sj, k4.y, dq[4 * q + 1]);
        dq[4 * q + 2] = fmaf(sj, k4.z, dq[4 * q + 2]);
        dq[4 * q + 3] = fmaf(sj, k4.w, dq[4 * q + 3]);
      }
    }
  }

  if (row < p.Sq) {
    T* dQ = static_cast<T*>(p.out0) + rowg * (DC * n_dc) + oc * DC;
#pragma unroll
    for (int q = 0; q < DC / 32; ++q)
      flash::Elem<T>::store4(dQ + 4 * (cc + 8 * q),
                             make_float4(dq[4 * q], dq[4 * q + 1],
                                         dq[4 * q + 2], dq[4 * q + 3]));
  }
}

// One block per (q tile, b * h): D up to 4 kD, in one chunk.
template <typename T, int DC>
__global__ void __launch_bounds__(128)
flash_bwd_dq_generic_kernel(const flash::BwdParams p) {
  flash_bwd_dq_generic_body<T, DC, false>(p);
}

// One block per (q tile, b * h, chunk of D): D above 4 kD.
template <typename T, int DC>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_generic_chunked_kernel(const flash::BwdParams p) {
  flash_bwd_dq_generic_body<T, DC, true>(p);
}

template <typename T, int DC, bool kChunked>
int launch_generic(const flash::BwdParams& p, int D, int B, cudaStream_t st) {
  constexpr int smem = gen_smem_bytes<DC>();
  void (*kernel)(const flash::BwdParams);
  if constexpr (kChunked)
    kernel = flash_bwd_dq_generic_chunked_kernel<T, DC>;
  else
    kernel = flash_bwd_dq_generic_kernel<T, DC>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + kGBQ - 1) / kGBQ, B * p.H, D / DC);
  kernel<<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Picks the generic instance by D (a multiple of kD, checked by the caller)
// and dtype: D itself up to 4 kD (bf16 at D = kD and 2 kD is the wgmma
// kernels'), above that a chunk of flash::gen_chunk(D) columns.
int launch_generic_d(const flash::BwdParams& p, int D, int dtype, int B,
                     cudaStream_t st) {
  if (D > 4 * kD) {
    const bool wide = flash::gen_chunk(D) == 2 * kD;
    if (dtype == 1)
      return wide ? launch_generic<bf16, 2 * kD, true>(p, D, B, st)
                  : launch_generic<bf16, kD, true>(p, D, B, st);
    return wide ? launch_generic<float, 2 * kD, true>(p, D, B, st)
                : launch_generic<float, kD, true>(p, D, B, st);
  }
  if (dtype == 1) {
    if (D == 3 * kD) return launch_generic<bf16, 3 * kD, false>(p, D, B, st);
    return launch_generic<bf16, 4 * kD, false>(p, D, B, st);
  }
  if (D == kD) return launch_generic<float, kD, false>(p, D, B, st);
  if (D == 2 * kD) return launch_generic<float, 2 * kD, false>(p, D, B, st);
  if (D == 3 * kD) return launch_generic<float, 3 * kD, false>(p, D, B, st);
  return launch_generic<float, 4 * kD, false>(p, D, B, st);
}

}  // namespace

// q/dO [B, H, Sq, D] and k/v [B, KVH, Skv, D] given by element strides (batch,
// head, seq; the last dim dense, every stride and base address a multiple of 16
// bytes, as TMA and the 16-byte loads require); lse and delta [B, H, Sq] f32
// and dq [B, H, Sq, D] dense, in the inputs' dtype. D is a multiple of 128;
// dtype: 0 = float32, 1 = bfloat16. bf16 at D = 128 and 256 runs a wgmma
// kernel, every other case the generic variant. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape or layout the kernels do
// not take).
extern "C" int ray_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int KVH,
    int Sq, int Skv, int D, float scale, int causal, int dtype,
    void* stream) {
  if (D % kD != 0 || D < kD || B < 1 || H < 1 || KVH < 1 ||
      H % KVH != 0 || Sq < 1 || Skv < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || D > 2 * kD) {
    const flash::BwdParams p{
        q,    k,    v,    dout, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dq, nullptr,
        q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        o_sb, o_sh, o_ss, H,    KVH,  Sq,   Skv,  scale, causal};
    return launch_generic_d(p, D, dtype, B, st);
  }
  // bf16 at D = 128 (128 q rows a block, 128-row KV tiles) or 256 (64, 64)
  const bool wide = D == 2 * kD;
  const uint32_t bm = wide ? d256::kBM : kBM;
  const uint32_t bn = wide ? d256::kBN : kBN;
  CUtensorMap tq, tk, tv, tdo;
  if (!flash::make_bhsd_map(&tq, q, B, H, Sq, q_sb, q_sh, q_ss, bm, D) ||
      !flash::make_bhsd_map(&tk, k, B, KVH, Skv, k_sb, k_sh, k_ss, bn, D) ||
      !flash::make_bhsd_map(&tv, v, B, KVH, Skv, v_sb, v_sh, v_ss, bn, D) ||
      !flash::make_bhsd_map(&tdo, dout, B, H, Sq, o_sb, o_sh, o_ss, bm, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + bm - 1) / bm;
  const DqArgs a{static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 static_cast<bf16*>(dq),
                 H, KVH, Sq, Skv, n_qt,
                 scale * kLog2e, scale, causal};
  const dim3 grid(B * H * n_qt), block(128 * (1 + kConsumers));
  if (wide) {
    const cudaError_t err = hopper::opt_in_smem<2 * kD>(
        d256::flash_bwd_dq_d256_kernel, d256::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    d256::flash_bwd_dq_d256_kernel<<<grid, block, d256::kSmemBytes, st>>>(
        tq, tk, tv, tdo, a);
  } else {
    const cudaError_t err =
        hopper::opt_in_smem<kD>(flash_bwd_dq_kernel, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_kernel<<<grid, block, kSmemBytes, st>>>(tq, tk, tv, tdo, a);
  }
  return static_cast<int>(cudaGetLastError());
}
