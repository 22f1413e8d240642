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
// f32 at 128, 256, 384, 512, 640 and 1024 runs
// flash_bwd_dq_f32_d128_cluster_kernel, flash_bwd_dq_f32_d256_cluster_kernel,
// flash_bwd_dq_f32_d384_cluster_kernel, flash_bwd_dq_f32_d512_cluster_kernel,
// flash_bwd_dq_f32_d640_cluster_kernel and flash_bwd_dq_f32_cluster_kernel
// (after those), one body, dq_cluster<kChunks>, at 1, 2, 3, 4, 5 and 8 CTAs.
// The generic variant's chunked instances computed S and dP over all of D in
// each of their 5 or 4 chunk blocks, and its instances (the one-chunk ones
// at 128, 256, 384 and 512 too) read one shared-memory word per FMA or two
// in their inner loops
// (32 words a clock against the FMA units' 128). These kernels are bound by
// the FMA units: f32 has no exact tensor-core input (TF32 rounds, and the f32
// variants are held to 1e-4), 3 products of 64 * 32 * D FMAs per (64 q rows,
// 32 KV rows) pair. They are the f32 dK/dV cluster (flash_bwd_dkv.cu) with
// (Q, dO) and (K, V) in each other's places and one product fewer:
//   * One cluster of D / 128 CTAs (1, 2, 3, 4, 5 or 8; 8 is the largest
//     portable cluster) per (b, head, 64 q rows), one CTA per 128-column
//     chunk of D. A CTA loads its chunk of Q and dO once (128B-swizzled f32
//     boxes of 32 columns, since they are read down 8 rows of one column at
//     once) and streams its chunk of K and V per 32-row KV tile through a
//     3-stage ring (not swizzled: read along rows). The group's query heads
//     run next to each other and the heaviest causal q tiles first, as
//     above.
//   * Warpgroup 0 computes S = Q K^T, warpgroup 1 dP = dO V^T (64 x 32)
//     over the CTA's 128 columns into its shared memory. Then each CTA sums
//     its share of the 64 q rows (8 at D1024; 12 or 13 at D640, which
//     splits them unevenly; 16 at D512, 8 threads a row, so every thread
//     of the exchange sums 4 partials of S and of dP where at D1024 half
//     the threads sum 8; 21 or 22 at D384 and 32 at D256, more than the 16
//     rows its 128 threads cover at once, so a thread takes a row in each of
//     two row slots, 16 rows apart; all 64 at D128, in four row slots, with
//     no peer's partial to add) over the chunks through distributed
//     shared memory (ld.shared::cluster), in chunk order from 0, masks KV
//     columns past Skv (TMA zero-filled their K rows, so S is 0 there and
//     exp(0 - LSE) is not) and after the row (causal), forms P and dS = P
//     (dP - delta) scale in f32 (rounding nothing, as the Pallas kernel's
//     cast does not in f32) and stores dS into every CTA
//     (st.shared::cluster).
//     Only dS crosses back: one 64 x 32 buffer a tile.
//   * dQ[:, chunk] += dS K_chunk, split over both math warpgroups by q
//     rows: 32 f32 registers a thread for the whole loop. A ring stage is
//     released after it, since it reads K.
//   * Roles and hand-overs as in the dK/dV cluster: two math warpgroups
//     (setmaxnreg 224) run phase A of tile t, then phase B of tile t - 1,
//     beside the exchange of tile t in the third (56 registers), through
//     mbarriers the peers arrive at (parts_ready, parts_free, ds_ready,
//     ds_free), with double buffers; 8 x 8 register tiles in phase A. At
//     D128 (one CTA, four row slots) the split is 208 / 88 and the
//     hand-overs are CTA-scope arrivals, as in the dK/dV cluster (7.8%
//     faster on the H100 than the cluster-scope ones at one CTA).
//   * About 209 KB of shared memory: one CTA an SM.
// bf16 at 640 runs flash_bwd_dq_bf16_cluster_kernel (after those): the f32
// dQ's dataflow with each CTA's three products on the tensor cores. The
// generic chunked instance it replaces did scalar FMAs and computed S and dP
// over all of D in each of its 5 chunk blocks. On wgmma the products are a
// small share of the work; what the design has to hide is the exchange (two
// f32 partials of 64 x 64 a tile pair, summed over the 5 CTAs) and the
// hand-overs between the roles.
//   * One cluster of 5 CTAs per (b, head, 64 q rows), one CTA per 128
//     columns of D, ordered as the f32 one. A CTA loads its chunk of Q and
//     dO once and streams its chunk of K and V per 64-row tile through a
//     3-stage ring, all as 128B-swizzled 64-column TMA boxes.
//   * Phase A: warpgroup 0 computes S = Q_c K_c^T, warpgroup 1 dP = dO_c
//     V_c^T (wgmma.m64n64k16, both operands K-major, 32 f32 registers).
//     Phase B: warpgroup h computes dQ[:, 64 h..] += dS K_c[:, 64 h..]
//     (wgmma.m64n64k16 with A = the dS box and B = K's box h read MN-major
//     through the transpose bit), 32 f32 registers for the whole loop.
//   * The exchange warpgroup owns 12 or 13 of the 64 q rows (16 lanes a
//     row), as the f32 D640 dQ does: it sums S and dP over the 5 CTAs in
//     chunk order from 0, forms P = 2^(S scale log2 e - LSE log2 e), zero on
//     KV columns past Skv and after the row, and dS = P (dP - delta) scale
//     rounded to bf16, and stores dS into every CTA as a swizzled [q][kv]
//     box (K-major for phase B); the reader fences the async proxy after
//     its acquire of the peers' stores.
//   * Shared memory: Q and dO 32 KB, the ring 96 KB, dS 2 x 8 KB, the
//     partials 2 x 2 x 16 KB: 215,040 bytes with the alignment slack, one
//     CTA an SM.
// bf16 at 1024, 512 and 384 runs the same kernel at 8, 4 and 3 CTAs a
// cluster (flash_bwd_dq_bf16_d1024_cluster_kernel,
// flash_bwd_dq_bf16_d512_cluster_kernel,
// flash_bwd_dq_bf16_d384_cluster_kernel), as f32 does: the body is a
// template over the chunk count, each instance gives its cluster's size as a
// literal, and the shared memory is the 5-CTA one's. At 8 CTAs each CTA's
// exchange owns 8 of the 64 q rows (one row a 16-lane group, one row slot)
// and sums 8 partials a row in place of 5; at 4 it owns 16 rows in two
// slots and sums 4 partials a row; at 3 it owns 21 or 22 rows (0-20, 21-41,
// 42-63) in three slots (the third 5 or 6 rows full) and sums 3 partials a
// row. The body has no setmaxnreg split, so the third slot's sums come out
// of the 168 registers every thread of the launch has.
// A generic variant (at the end of this file) serves f32 and bf16 at any
// other head_dim that is a multiple of 128 (from 768 up but 1024), tiled over
// D: chunks of 256 columns for D768, 1280, ..., of 128 for D896, 1152, ...,
// with P and dS rounded to the input dtype as the Pallas kernel rounds them.

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
// f32 at D = 128, 256, 384, 512, 640 and 1024: one cluster of 1, 2, 3, 4, 5
// or 8 CTAs per (b, head, 64 q rows), one CTA per 128-column chunk of D, the
// scores summed over the cluster; the f32 dK/dV cluster (flash_bwd_dkv.cu)
// with Q, dO and K, V in each other's places (see the top of this file).
// ---------------------------------------------------------------------------

namespace f32c {

constexpr int kBQ = 64;                 // q rows per cluster
constexpr int kBN = 32;                 // KV rows per tile
constexpr int kStages = 3;              // K/V ring depth
constexpr int kBox = 32;                // f32 columns of a 128-byte box
constexpr int kBoxes = kD / kBox;       // boxes of a chunk's row
constexpr int kMathWarps = 8;           // two warpgroups: the products
constexpr int kXWarps = 4;              // one warpgroup: the exchange, loads
constexpr int kThreads = 32 * (kMathWarps + kXWarps);
constexpr int kMathRegs = 224;          // setmaxnreg of the math warpgroups
constexpr int kXRegs = 56;              // and of the exchange warpgroup
constexpr uint32_t kRowBytes = kD * 4;  // one row of a chunk

// Q, dO, K and V chunks as TMA writes them: 4 boxes of 32 columns, each
// `rows` x 128 bytes. Q and dO are read down 8 rows of one 16-byte column at
// once, so their 16-byte column c of row r sits at c ^ (r % 8) within its
// box (CU_TENSOR_MAP_SWIZZLE_128B) and those 8 words fall in 8 distinct
// banks; K and V are read along a row, in place.
struct __align__(1024) Smem {
  float q[kBoxes][kBQ * kBox];
  float dout[kBoxes][kBQ * kBox];
  float k[kStages][kBoxes][kBN * kBox];
  float v[kStages][kBoxes][kBN * kBox];
  float part[2][2][kBQ * kBN];  // [buffer][S, dP] over this chunk, [q][kv]
  float ds[2][kBQ * kBN];       // [buffer] dS over all of D, [q][kv]
  uint64_t q_full;
  uint64_t full[kStages];     // K, V landed (TMA bytes)
  uint64_t empty[kStages];    // this CTA's math warps are done with a stage
  uint64_t parts_ready[2];    // every CTA's math warps wrote part[buffer]
  uint64_t parts_free[2];     // every CTA's exchange warps read their slice
  uint64_t ds_ready[2];       // every CTA stored its rows of ds[buffer]
  uint64_t ds_free[2];        // every CTA's math warps are done with it
};

// + slack to align the base to 1024 bytes.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

using flash::f4;
using flash::swz32;  // the [q][kv] partials
static_assert(kBN == 32, "swz32's rows are 32 floats");

// dS's 16-byte column c of row r sits at c ^ (r % 2): the two rows a warp
// reads at once in phase B fall in other banks.
__device__ __forceinline__ int ds_at(int row, int col4) {
  return row * kBN + ((col4 ^ (row & 1)) << 2);
}

// The kernel over kChunks CTAs a cluster (D = kChunks kD); the kernels
// after it give the cluster's size as a literal.
template <int kChunks>
__device__ __forceinline__ void dq_cluster(const CUtensorMap& tq,
                                           const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           const CUtensorMap& tdo,
                                           const flash::BwdParams& p) {
  constexpr int kDW = kChunks * kD;  // head_dim
  // q rows a CTA's exchange owns at most (64 of 1 CTA, 32 of 2, 22 of 3, 16
  // of 4, 13 of 5, 8 of 8), 16 a slot
  constexpr int kSlots = ((kBQ + kChunks - 1) / kChunks + 15) / 16;
  // setmaxnreg of the math and exchange warpgroups: 224 and 56 at up to two
  // row slots, 208 and 88 at four (D = kD: 216 / 72 ran as fast and 200 /
  // 104 3% slower on the H100, none spilled); each split is the 168 x 384
  // registers the launch gives a CTA.
  constexpr int kMathR = kSlots == 4 ? 208 : kMathRegs;
  constexpr int kXR = kSlots == 4 ? 88 : kXRegs;
  // One CTA a cluster (D = kD): no peer reads or arrives, so the hand-overs
  // are CTA-scope arrivals and waits (no MEMBAR.ALL.GPU), the exchange
  // reads and writes its own shared memory with plain loads and stores, and
  // every math warp arrives at parts_ready itself, with no named barrier.
  constexpr bool kOne = kChunks == 1;
  extern __shared__ unsigned char cluster_smem[];
  const uint32_t raw = hopper::smem_u32(cluster_smem);
  Smem& sm = *reinterpret_cast<Smem*>(cluster_smem +
                                      (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = static_cast<int>(hopper::cluster_ctarank());  // D chunk

  // Cluster -> (q tile, b, KV head, head in the group), the group fastest,
  // the q tile slowest: causal, the heaviest (last) q tiles start first, and
  // the query heads of one KV head run next to each other, so they read its
  // K and V from L2.
  const int G = p.H / p.KVH;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int n_bk = gridDim.x / kChunks / (G * n_qt);  // B * KVH
  int id = blockIdx.x / kChunks;
  const int g = id % G;
  id /= G;
  const int bk = id % n_bk;
  const int rank = id / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int h = kvh * G + g;
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  const int q0 = qt * kBQ;
  // Causal: KV tiles wholly after the q tile are never loaded.
  const int kv_end = p.causal ? min(p.Skv, q0 + kBQ) : p.Skv;
  const int n_kt = (kv_end + kBN - 1) / kBN;

  if (tid == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kMathWarps);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&sm.parts_ready[i], kOne ? kMathWarps : kChunks);
      hopper::mbar_init(&sm.parts_free[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.ds_ready[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.ds_free[i], kChunks * kMathWarps);
    }
    hopper::fence_barrier_init();
  }
  // The barriers are set up, and every CTA of the cluster runs, before a
  // copy lands or a peer touches this CTA's shared memory.
  if constexpr (kOne)
    __syncthreads();
  else
    hopper::cluster_sync();

  if (warp >= kMathWarps) {
    // ---------------- exchange warpgroup --------------------------------
    // Its first warp's lane 0 loads (TMA, 4 boxes each; rows past Sq and
    // Skv are zero-filled): Q and dO once, K and V per tile of KV head kvh.
    hopper::reg_dealloc<kXR>();
    const bool loader = warp == kMathWarps && lane == 0;
    auto load_tile = [&](int kt) {
      const int s = kt % kStages;
      hopper::mbar_expect_tx(&sm.full[s], 2 * kBN * kRowBytes);
      for (int x = 0; x < kBoxes; ++x) {
        hopper::tma_load_4d(sm.k[s][x], &tk, &sm.full[s], c * kD + x * kBox,
                            kt * kBN, kvh, b);
        hopper::tma_load_4d(sm.v[s][x], &tv, &sm.full[s], c * kD + x * kBox,
                            kt * kBN, kvh, b);
      }
    };
    if (loader) {
      hopper::mbar_expect_tx(&sm.q_full, 2 * kBQ * kRowBytes);
      for (int x = 0; x < kBoxes; ++x) {
        hopper::tma_load_4d(sm.q[x], &tq, &sm.q_full, c * kD + x * kBox, q0,
                            h, b);
        hopper::tma_load_4d(sm.dout[x], &tdo, &sm.q_full, c * kD + x * kBox,
                            q0, h, b);
      }
      for (int kt = 0; kt < min(n_kt, kStages - 1); ++kt) load_tile(kt);
    }

    // This CTA's q rows, [c 64 / kChunks, (c + 1) 64 / kChunks) (8 of 64 at 8
    // chunks, 12 or 13 at 5, 16 at 4: every thread; 21 or 22 at 3; 32 at 2:
    // every thread in both slots; all 64 at 1, in four full slots), for the
    // whole loop: thread xt takes row
    // c 64 / kChunks + xt / 8 + 16 i of each row slot i < kSlots and sums
    // one 16-byte column (4 KV columns) of it over the chunks, in chunk
    // order 0 to kChunks - 1 in every CTA, so that all hold the same dS
    // bits; applies scale and the mask (KV columns past Skv, whose K rows
    // TMA zero-filled, and after the row, causal), forms P = exp(S scale -
    // LSE) and dS = P (dP - delta) scale in f32 (the Pallas kernel's cast
    // rounds nothing in f32) and stores dS into every CTA's ds. The rows'
    // LSE and delta are read once (+inf and 0 past Sq: P and dS are 0 on
    // such a row).
    const int xt = tid - 32 * kMathWarps;
    const int col4 = xt % 8;
    int row[kSlots];
    bool mine[kSlots];
    float lse[kSlots], delta[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      row[i] = c * kBQ / kChunks + xt / 8 + 16 * i;
      mine[i] = row[i] < (c + 1) * kBQ / kChunks;
      const int qrow = q0 + row[i];
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq + qrow;
      lse[i] = mine[i] && qrow < p.Sq ? p.lse[at] : INFINITY;
      delta[i] = mine[i] && qrow < p.Sq ? p.delta[at] : 0.f;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int buf = kt & 1;
      const int k0 = kt * kBN;
      const int nx = kt + kStages - 1;  // the tile the loader loads next
      if constexpr (kOne)
        hopper::mbar_wait(&sm.parts_ready[buf], (kt >> 1) & 1);
      else
        hopper::mbar_wait_cluster(&sm.parts_ready[buf], (kt >> 1) & 1);
      float4 sv[kSlots], dpv[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        sv[i] = dpv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!mine[i]) continue;
        if constexpr (kOne) {
          sv[i] = flash::ld4(sm.part[buf][0] + swz32(row[i], col4));
          dpv[i] = flash::ld4(sm.part[buf][1] + swz32(row[i], col4));
          continue;
        }
        const uint32_t s_at =
            hopper::smem_u32(sm.part[buf][0] + swz32(row[i], col4));
        const uint32_t p_at =
            hopper::smem_u32(sm.part[buf][1] + swz32(row[i], col4));
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          const float4 x = hopper::ld_cluster_f4(hopper::map_rank(s_at, r));
          const float4 y = hopper::ld_cluster_f4(hopper::map_rank(p_at, r));
          sv[i] = r == 0 ? x : flash::add4(sv[i], x);
          dpv[i] = r == 0 ? y : flash::add4(dpv[i], y);
        }
      }
      __syncwarp();
      if constexpr (kOne) {
        if (lane == 0) hopper::mbar_arrive(&sm.parts_free[buf]);
      } else {
        if (lane < kChunks)
          hopper::mbar_signal_rank(&sm.parts_free[buf], lane);
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        const float sx[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
        float dx[4] = {dpv[i].x, dpv[i].y, dpv[i].z, dpv[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 4 * col4 + e;
          float x = sx[e] * p.scale;
          if (col >= p.Skv || (p.causal && col > q0 + row[i]))
            x = flash::kMaskValue;
          const float pr = expf(x - lse[i]);
          dx[e] = (dx[e] - delta[i]) * pr * p.scale;
        }
        dpv[i] = f4(dx);
      }
      // Every CTA's math warps are done with this buffer's tile before.
      if (kt >= 2) hopper::mbar_wait(&sm.ds_free[buf], ((kt - 2) >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        if constexpr (kOne) {
          *reinterpret_cast<float4*>(sm.ds[buf] + ds_at(row[i], col4)) =
              dpv[i];
          continue;
        }
        const uint32_t d_at =
            hopper::smem_u32(sm.ds[buf] + ds_at(row[i], col4));
#pragma unroll
        for (int r = 0; r < kChunks; ++r)
          hopper::st_cluster_f4(hopper::map_rank(d_at, r), dpv[i]);
      }
      __syncwarp();
      if constexpr (kOne) {
        if (lane == 0) hopper::mbar_arrive(&sm.ds_ready[buf]);
      } else {
        if (lane < kChunks)
          hopper::mbar_arrive_rank(&sm.ds_ready[buf], lane);
      }
      // The tile two ahead goes into the stage of the one before this, once
      // this CTA's math warps are done with it. The loader is xt == 0,
      // tested afresh: at 5 chunks ptxas spilled the flag (8 bytes).
      if (xt == 0 && nx < n_kt) {
        if (nx >= kStages)
          hopper::mbar_wait(&sm.empty[nx % kStages], (nx / kStages - 1) & 1);
        load_tile(nx);
      }
    }
  } else {
    // ---------------- math warpgroups -----------------------------------
    // Phase A of tile kt (S or dP over this chunk), then phase B of tile kt
    // - 1 (dQ += dS K), so the exchange of tile kt runs beside phase B.
    // Warps 0-3 compute S = Q K^T, warps 4-7 dP = dO V^T; all eight share
    // phase B by q rows. Every inner loop runs on register tiles in which
    // each word read from shared memory feeds 8 FMAs (shared memory gives
    // 32 words a clock, the FMA units take 128).
    hopper::reg_alloc<kMathR>();
    const int half = warp / 4;
    const int w4 = warp % 4;
    // Phase A, the dK/dV cluster's with Q and dO as the stationary tiles (a
    // copy: one helper shared by the two changed the D640 dK/dV's register
    // allocation): q rows l8 + 8i by KV rows 8 w4 + i' (i, i' < 8) over the
    // 16-byte columns cq + 4j (j < 8) of the chunk, cq = lane / 8: the four
    // lanes of a tile take a quarter of the columns each and are summed by
    // shuffles. A quarter warp reads 8 q rows of one column and one K word.
    const int l8 = lane % 8;
    const int cq = lane / 8;
    // Phase B: q rows qg + 16i (i < 4) by columns 4 dg + 64m + e (m < 2, e
    // < 4): a half warp reads one dS word and 16 consecutive 16-byte columns
    // of K, and each K word feeds the 4 rows, each dS word 8 columns.
    const int dg = lane % 16;
    const int qg = 2 * warp + lane / 16;
    float acc[4][2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.f;

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt <= n_kt; ++kt) {
      if (kt < n_kt) {
        const int s = kt % kStages;
        const int buf = kt & 1;
        hopper::mbar_wait(&sm.full[s], (kt / kStages) & 1);
        // Every CTA's exchange warps are done with this buffer's tile.
        if (kt >= 2)
          hopper::mbar_wait(&sm.parts_free[buf], ((kt - 2) >> 1) & 1);
        // Step j reads 16-byte column g = cq + 4j: box j / 2, column cq +
        // 4 (j % 2) in it, at (cq + 4 (j % 2)) ^ l8 in Q's and dO's rows.
        const float* a0 = (half ? sm.dout[0] : sm.q[0]) + l8 * kBox +
                          ((cq ^ l8) << 2);
        const float* a1 = (half ? sm.dout[0] : sm.q[0]) + l8 * kBox +
                          ((cq ^ l8 ^ 4) << 2);
        const float* b0 =
            (half ? sm.v[s][0] : sm.k[s][0]) + 8 * w4 * kBox + 4 * cq;
        float x[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) x[i][i2] = 0.f;
#pragma unroll 1
        for (int j = 0; j < kD / 16; ++j) {
          const float* ak = ((j & 1) ? a1 : a0) + (j >> 1) * kBQ * kBox;
          const float* bk = b0 + (j >> 1) * kBN * kBox + (j & 1) * 16;
          float4 bq[8];
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) bq[i2] = flash::ld4(bk + i2 * kBox);
          // Consecutive FMAs go to 8 different accumulators.
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a = flash::ld4(ak + 8 * i * kBox);
#pragma unroll
            for (int i2 = 0; i2 < 8; ++i2)
              x[i][i2] = fmaf(a.x, bq[i2].x, x[i][i2]);
#pragma unroll
            for (int i2 = 0; i2 < 8; ++i2)
              x[i][i2] = fmaf(a.y, bq[i2].y, x[i][i2]);
#pragma unroll
            for (int i2 = 0; i2 < 8; ++i2)
              x[i][i2] = fmaf(a.z, bq[i2].z, x[i][i2]);
#pragma unroll
            for (int i2 = 0; i2 < 8; ++i2)
              x[i][i2] = fmaf(a.w, bq[i2].w, x[i][i2]);
          }
        }
        // The four column quarters' sums: lanes 8 apart trade q rows (each
        // keeps 4 of its 8), then lanes 16 apart trade KV rows (each keeps
        // 4).
        const bool hi_q = cq & 1, hi_kv = cq & 2;
        float y[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) {
            const float keep = hi_q ? x[i + 4][i2] : x[i][i2];
            const float give = hi_q ? x[i][i2] : x[i + 4][i2];
            y[i][i2] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
          }
        float* out = sm.part[buf][half];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float z[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float keep = hi_kv ? y[i][e + 4] : y[i][e];
            const float give = hi_kv ? y[i][e] : y[i][e + 4];
            z[e] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
          }
          *reinterpret_cast<float4*>(
              out + swz32(l8 + 8 * (i + 4 * hi_q), 2 * w4 + hi_kv)) = f4(z);
        }
        // One warp, another each tile, waits at a named barrier for all
        // eight warps' partials and arrives at each CTA's parts_ready
        // (lanes 0 to kChunks - 1 in one instruction): the release at
        // cluster scope is a GPU-wide memory barrier that stalls the warp,
        // so the other warps only arrive at the named barrier and go on. Its
        // id alternates by tile, and no warp runs two tiles ahead of the
        // signalling one (its phase B waits for the next tile's exchange).
        // At one CTA each warp arrives (CTA scope) for its own partials.
        if constexpr (kOne) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&sm.parts_ready[buf]);
        } else if (warp == kt % kMathWarps) {
          hopper::named_bar_sync(1 + buf, 32 * kMathWarps);
          if (lane < kChunks)
            hopper::mbar_arrive_rank(&sm.parts_ready[buf], lane);
        } else {
          hopper::named_bar_arrive(1 + buf, 32 * kMathWarps);
        }
      }
      if (kt >= 1) {
        // dQ += dS K over tile kt - 1's KV rows, this chunk's columns; the
        // stage is released after it, since K is read here.
        const int t = kt - 1;
        const int s = t % kStages;
        const int buf = t & 1;
        if constexpr (kOne)
          hopper::mbar_wait(&sm.ds_ready[buf], (t >> 1) & 1);
        else
          hopper::mbar_wait_cluster(&sm.ds_ready[buf], (t >> 1) & 1);
        const float* Dm = sm.ds[buf] + qg * kBN;
        // 16-byte column dg + 16m of a row: box dg / 8 + 2m, column dg % 8.
        const float* Kt = sm.k[s][0] + (dg >> 3) * kBN * kBox + 4 * (dg & 7);
#pragma unroll 2
        for (int jj = 0; jj < kBN; jj += 4) {
          // dS's 16-byte column jj / 4 of rows qg + 16i, at (jj / 4) ^ (qg %
          // 2) (ds_at).
          const int pc = ((jj >> 2) ^ (qg & 1)) << 2;
          float4 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = flash::ld4(Dm + 16 * i * kBN + pc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float4 o =
                  flash::ld4(Kt + 2 * m * kBN * kBox + (jj + e) * kBox);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float wi = e == 0   ? w[i].x
                                 : e == 1 ? w[i].y
                                 : e == 2 ? w[i].z
                                          : w[i].w;
                flash::fma4(acc[i][m], wi, o);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
        if constexpr (kOne) {
          if (lane == 0) hopper::mbar_arrive(&sm.ds_free[buf]);
        } else {
          if (lane < kChunks)
            hopper::mbar_signal_rank(&sm.ds_free[buf], lane);
        }
      }
    }

    float* dQ = static_cast<float*>(p.out0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + qg + 16 * i;
      if (r >= p.Sq) continue;
      float* o = dQ + ((static_cast<long long>(b) * p.H + h) * p.Sq + r) * kDW +
                 c * kD + 4 * dg;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        *reinterpret_cast<float4*>(o + 64 * m) = f4(acc[i][m]);
    }
  }
  // No CTA leaves while a peer may still touch its shared memory.
  if constexpr (!kOne) hopper::cluster_sync();
}

// f32 at D = 1024: clusters of 8 CTAs, the largest portable cluster.
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const flash::BwdParams p) {
  dq_cluster<8>(tq, tk, tv, tdo, p);
}

// f32 at D = 640: clusters of 5 CTAs. Each CTA's exchange owns 12 or 13 of
// the 64 q rows (c * 64 / 5 to (c + 1) * 64 / 5).
__global__ void __cluster_dims__(5, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_d640_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const flash::BwdParams p) {
  dq_cluster<5>(tq, tk, tv, tdo, p);
}

// f32 at D = 512: clusters of 4 CTAs. Each CTA's exchange owns 16 of the 64
// q rows, 8 threads a row.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_d512_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const flash::BwdParams p) {
  dq_cluster<4>(tq, tk, tv, tdo, p);
}

// f32 at D = 384: clusters of 3 CTAs. Each CTA's exchange owns 21 or 22 of
// the 64 q rows (c * 64 / 3 to (c + 1) * 64 / 3), 8 threads a row, in two
// row slots.
__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_d384_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const flash::BwdParams p) {
  dq_cluster<3>(tq, tk, tv, tdo, p);
}

// f32 at D = 256: clusters of 2 CTAs. Each CTA's exchange owns 32 of the 64
// q rows (0-31, 32-63), 8 threads a row, in two full row slots of 16.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_d256_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const flash::BwdParams p) {
  dq_cluster<2>(tq, tk, tv, tdo, p);
}

// f32 at D = 128: clusters of 1 CTA, which holds all of D. Its exchange owns
// all 64 q rows in four full row slots of 16 and sums no peer's partials.
__global__ void __cluster_dims__(1, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_d128_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const flash::BwdParams p) {
  dq_cluster<1>(tq, tk, tv, tdo, p);
}

}  // namespace f32c

// ---------------------------------------------------------------------------
// bf16 at D = 512, 640 and 1024: f32c's dataflow (a cluster of 4, 5 or 8
// CTAs per (b, head, 64 q rows), the scores summed through distributed shared
// memory) with each CTA's three products on the tensor cores (see the top of
// this file).
// ---------------------------------------------------------------------------

namespace bf16c {

using flash::kBoxBytes;  // 8 KB: a 64-row [row][64 col] bf16 box

constexpr int kBQ = 64;                 // q rows per cluster
constexpr int kBN = 64;                 // KV rows per tile
constexpr int kStages = 3;              // K/V ring depth
constexpr int kMathWarps = 8;           // two warpgroups: the products
constexpr int kXWarps = 4;              // one warpgroup: the exchange, loads
constexpr int kThreads = 32 * (kMathWarps + kXWarps);
constexpr uint32_t kTileBytes = 64 * kD * 2;  // a chunk of Q, dO, K or V

// Q, dO, K and V chunks as TMA writes them (two 128B-swizzled 64-column
// boxes each), dS as one such box ([q][kv], K-major for the wgmma that
// reads it), the score partials in f32: 32 + 96 (the ring) + 16 + 64 KB.
struct __align__(1024) Smem {
  bf16 q[2][kBQ * kHalf];
  bf16 dout[2][kBQ * kHalf];
  bf16 k[kStages][2][kBN * kHalf];
  bf16 v[kStages][2][kBN * kHalf];
  bf16 ds[2][kBQ * kBN];          // [buffer] dS over all of D
  float part[2][2][kBQ * kBN];    // [buffer][S, dP] over this chunk
  uint64_t q_full;            // Q and dO
  uint64_t full[kStages];     // K, V landed (TMA bytes)
  uint64_t empty[kStages];    // this CTA's math warps are done with a stage
  uint64_t parts_ready[2];    // every CTA's math warps wrote part[buffer]
  uint64_t parts_free[2];     // every CTA's exchange warps read their slice
  uint64_t ds_ready[2];       // every CTA stored its rows of ds[buffer]
  uint64_t ds_free[2];        // every CTA's math warps are done with it
};

// + slack to align the base to 1024 bytes: 215,040 bytes, one CTA an SM.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

// The [q][kv] f32 partials and the bf16 boxes.
using flash::box_at;
using flash::swz64;
static_assert(kBN == 64, "swz64's rows are 64 floats");

// The kernel over kChunks CTAs a cluster (D = kChunks kD), as f32c's; the
// kernels after it give the cluster's size as a literal.
template <int kChunks>
__device__ __forceinline__ void dq_cluster(const CUtensorMap& tq,
                                           const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           const CUtensorMap& tdo,
                                           const DqArgs& p) {
  constexpr int kDW = kChunks * kD;  // head_dim
  // q rows a CTA's exchange owns at most (22 of 3 CTAs, 16 of 4, 13 of 5, 8
  // of 8), 8 a slot
  constexpr int kSlots = ((kBQ + kChunks - 1) / kChunks + 7) / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Smem& sm =
      *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = static_cast<int>(hopper::cluster_ctarank());  // D chunk

  // Cluster -> (q tile, b, KV head, head in the group), the group fastest,
  // the q tile slowest: causal, the heaviest (last) q tiles start first, and
  // the query heads of one KV head run next to each other, so they read its
  // K and V from L2.
  const int G = p.H / p.KVH;
  const int n_bk = gridDim.x / kChunks / (G * p.n_qt);  // B * KVH
  int id = blockIdx.x / kChunks;
  const int g = id % G;
  id /= G;
  const int bk = id % n_bk;
  const int rank = id / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int h = kvh * G + g;
  const int qt = p.causal ? p.n_qt - 1 - rank : rank;
  const int q0 = qt * kBQ;
  const long long bh = static_cast<long long>(b) * p.H + h;
  // Causal: KV tiles wholly after the q tile are never loaded.
  const int kv_end = p.causal ? min(p.Skv, q0 + kBQ) : p.Skv;
  const int n_kt = (kv_end + kBN - 1) / kBN;

  if (tid == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], kMathWarps);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&sm.parts_ready[i], kChunks);
      hopper::mbar_init(&sm.parts_free[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.ds_ready[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.ds_free[i], kChunks * kMathWarps);
    }
    hopper::fence_barrier_init();
  }
  // The barriers are set up, and every CTA of the cluster runs, before a
  // copy lands or a peer touches this CTA's shared memory.
  hopper::cluster_sync();

  if (warp >= kMathWarps) {
    // ---------------- exchange warpgroup --------------------------------
    // Its first warp's lane 0 loads (TMA, two boxes each; rows past Sq and
    // Skv are zero-filled): Q and dO once, K and V per tile of KV head kvh.
    const bool loader = warp == kMathWarps && lane == 0;
    auto load_tile = [&](int kt) {
      const int s = kt % kStages;
      hopper::mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
      for (int x = 0; x < 2; ++x) {
        hopper::tma_load_4d(sm.k[s][x], &tk, &sm.full[s], c * kD + x * kHalf,
                            kt * kBN, kvh, b);
        hopper::tma_load_4d(sm.v[s][x], &tv, &sm.full[s], c * kD + x * kHalf,
                            kt * kBN, kvh, b);
      }
    };
    if (loader) {
      hopper::mbar_expect_tx(&sm.q_full, 2 * kTileBytes);
      for (int x = 0; x < 2; ++x) {
        hopper::tma_load_4d(sm.q[x], &tq, &sm.q_full, c * kD + x * kHalf, q0,
                            h, b);
        hopper::tma_load_4d(sm.dout[x], &tdo, &sm.q_full, c * kD + x * kHalf,
                            q0, h, b);
      }
      for (int kt = 0; kt < min(n_kt, kStages - 1); ++kt) load_tile(kt);
    }

    // This CTA's q rows, [c 64 / kChunks, (c + 1) 64 / kChunks) (21 or 22
    // of 3 CTAs, 16 of 4, 12 or 13 of 5, 8 of 8), for the whole loop: 16 lanes a row, lane
    // col4 of row r0 + xt / 16 + 8 i (i < kSlots) sums 16-byte column col4
    // (4 KV columns) of S and dP over the kChunks chunks, in chunk order
    // from 0 in every CTA, forms P = 2^(S scale log2 e - LSE log2
    // e), zero on KV columns past Skv (TMA zero-filled their K rows, so S
    // is 0 there and P would not be) and after the row (causal), and dS = P
    // (dP - delta) scale rounded to bf16 (where the Pallas kernel rounds
    // it), and stores dS into every CTA's box. The rows' LSE and delta are
    // read once (+inf and 0 past Sq: P and dS are 0 on such a row).
    const int xt = tid - 32 * kMathWarps;
    const int r0 = c * kBQ / kChunks;
    const int r1 = (c + 1) * kBQ / kChunks;
    const int col4 = xt % 16;
    int row[kSlots];
    bool mine[kSlots];
    float lse[kSlots], delta[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      row[i] = r0 + xt / 16 + 8 * i;
      mine[i] = row[i] < r1;
      const bool live = mine[i] && q0 + row[i] < p.Sq;
      lse[i] = live ? p.lse[bh * p.Sq + q0 + row[i]] * kLog2e : INFINITY;
      delta[i] = live ? p.delta[bh * p.Sq + q0 + row[i]] : 0.f;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int buf = kt & 1;
      const int k0 = kt * kBN;
      const int nx = kt + kStages - 1;  // the tile the loader loads next
      hopper::mbar_wait_cluster(&sm.parts_ready[buf], (kt >> 1) & 1);
      float4 sv[kSlots], dpv[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        sv[i] = dpv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!mine[i]) continue;
        const uint32_t s_at =
            hopper::smem_u32(sm.part[buf][0] + swz64(row[i], col4));
        const uint32_t p_at =
            hopper::smem_u32(sm.part[buf][1] + swz64(row[i], col4));
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          const float4 x = hopper::ld_cluster_f4(hopper::map_rank(s_at, r));
          const float4 y = hopper::ld_cluster_f4(hopper::map_rank(p_at, r));
          sv[i] = r == 0 ? x : flash::add4(sv[i], x);
          dpv[i] = r == 0 ? y : flash::add4(dpv[i], y);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_signal_rank(&sm.parts_free[buf], lane);
      uint2 dw[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const float sx[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
        const float dx[4] = {dpv[i].x, dpv[i].y, dpv[i].z, dpv[i].w};
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 4 * col4 + e;
          float pr = fast_exp2(fmaf(sx[e], p.scale_log2, -lse[i]));
          if (col >= p.Skv || (p.causal && col > q0 + row[i])) pr = 0.f;
          ds[e] = pr * (dx[e] - delta[i]) * p.scale;
        }
        dw[i] = make_uint2(pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]));
      }
      // Every CTA's math warps are done with this buffer's tile before.
      if (kt >= 2)
        hopper::mbar_wait(&sm.ds_free[buf], ((kt - 2) >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        const uint32_t at =
            hopper::smem_u32(sm.ds[buf]) + box_at(row[i], col4);
#pragma unroll
        for (int r = 0; r < kChunks; ++r)
          hopper::st_cluster_u2(hopper::map_rank(at, r), dw[i]);
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_arrive_rank(&sm.ds_ready[buf], lane);
      // The tile two ahead goes into the stage of the one before this,
      // once this CTA's math warps are done with it.
      if (loader && nx < n_kt) {
        if (nx >= kStages)
          hopper::mbar_wait(&sm.empty[nx % kStages], (nx / kStages - 1) & 1);
        load_tile(nx);
      }
    }
  } else {
    // ---------------- math warpgroups -----------------------------------
    // Phase A of tile kt, then phase B of tile kt - 1, so the exchange of
    // tile kt runs beside phase B. Phase A: warpgroup 0 computes S = Q K^T,
    // warpgroup 1 dP = dO V^T over this chunk (wgmma.m64n64k16, both
    // operands K-major, 8 k-steps, 32 f32 registers). Phase B: warpgroup
    // `half` computes dQ[:, 64 half..] += dS K[:, 64 half..]
    // (wgmma.m64n64k16 with A = the dS box and B = K's box `half` read
    // MN-major through the transpose bit, 4 k-steps), 32 f32 registers for
    // the whole loop. A ring stage is released after phase B, since it
    // reads K.
    const int half = warp / 4;
    const int w4 = warp % 4;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float sc[32];
    // acc[4j + 2a + e] and sc[4j + 2a + e]: q row r_lo + 8a of the tile.
    const int r_lo = 16 * w4 + lane / 4;

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt <= n_kt; ++kt) {
      if (kt < n_kt) {
        const int s = kt % kStages;
        const int buf = kt & 1;
        hopper::mbar_wait(&sm.full[s], (kt / kStages) & 1);
        // Every CTA's exchange warps are done with this buffer's tile.
        if (kt >= 2)
          hopper::mbar_wait(&sm.parts_free[buf], ((kt - 2) >> 1) & 1);
        flash::issue_abt<kBN>(
            sc, hopper::smem_u32(half ? sm.dout[0] : sm.q[0]), kBoxBytes,
            hopper::smem_u32(half ? sm.v[s][0] : sm.k[s][0]), kBoxBytes);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(sc[i]);
        // sc[4j + 2a + e]: KV column 8j + 2 (lane % 4) + e, in 16-byte
        // column 2j + (lane % 4) / 2.
        float* out = sm.part[buf][half];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            *reinterpret_cast<float2*>(
                out + swz64(r_lo + 8 * a, 2 * j + (lane % 4) / 2) +
                2 * (lane & 1)) =
                make_float2(sc[4 * j + 2 * a], sc[4 * j + 2 * a + 1]);
        // One warp, another each tile, releases the partials to every CTA
        // once all eight warps have stored theirs, as in f32c.
        if (warp == kt % kMathWarps) {
          hopper::named_bar_sync(1 + buf, 32 * kMathWarps);
          if (lane < kChunks)
            hopper::mbar_arrive_rank(&sm.parts_ready[buf], lane);
        } else {
          hopper::named_bar_arrive(1 + buf, 32 * kMathWarps);
        }
      }
      if (kt >= 1) {
        // dQ += dS K over tile kt - 1's KV rows, this warpgroup's 64 of
        // the chunk's columns.
        const int t = kt - 1;
        const int s = t % kStages;
        const int buf = t & 1;
        hopper::mbar_wait_cluster(&sm.ds_ready[buf], (t >> 1) & 1);
        hopper::fence_proxy_async_cluster();  // peers' stores, then wgmma
        const uint32_t a_base = hopper::smem_u32(sm.ds[buf]);
        const uint32_t b_base = hopper::smem_u32(sm.k[s][half]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          hopper::wgmma_m64n64k16_ss_mn(
              acc, hopper::desc_sw128(a_base + kk * 32, 16, 1024),
              hopper::desc_sw128(b_base + kk * 16 * 128, kBoxBytes, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(acc[i]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
        if (lane < kChunks) hopper::mbar_signal_rank(&sm.ds_free[buf], lane);
      }
    }

    // acc[4j + 2a + e]: q row q0 + r_lo + 8a, column c kD + 64 half + 8j +
    // 2 (lane % 4) + e.
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = r_lo + 8 * a;
      if (q0 + r >= p.Sq) continue;
      bf16* o = p.dq + (bh * p.Sq + q0 + r) * kDW + c * kD + 64 * half +
                2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) =
            pack_bf16(acc[4 * j + 2 * a], acc[4 * j + 2 * a + 1]);
    }
  }
  // No CTA leaves while a peer may still touch its shared memory.
  hopper::cluster_sync();
}

// bf16 at D = 640: clusters of 5 CTAs.
__global__ void __cluster_dims__(5, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const DqArgs p) {
  dq_cluster<5>(tq, tk, tv, tdo, p);
}

// bf16 at D = 1024: clusters of 8 CTAs, the largest portable cluster.
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_d1024_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                       const __grid_constant__ CUtensorMap tk,
                                       const __grid_constant__ CUtensorMap tv,
                                       const __grid_constant__ CUtensorMap tdo,
                                       const DqArgs p) {
  dq_cluster<8>(tq, tk, tv, tdo, p);
}

// bf16 at D = 512: clusters of 4 CTAs. Each CTA's exchange owns 16 of the 64
// q rows, 16 lanes a row, in two row slots.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_d512_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const DqArgs p) {
  dq_cluster<4>(tq, tk, tv, tdo, p);
}

// bf16 at D = 384: clusters of 3 CTAs. Each CTA's exchange owns 21 or 22 of
// the 64 q rows, 16 lanes a row, in three row slots.
__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_d384_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const DqArgs p) {
  dq_cluster<3>(tq, tk, tv, tdo, p);
}

}  // namespace bf16c

// ---------------------------------------------------------------------------
// Generic variant: every dtype and head_dim (a multiple of 128) above 512
// but 640 and 1024; the kernels above serve those.
// The same function on the CUDA cores: one block of 128 threads per (b, h, 16
// q rows, chunk of D), walking the visible 32-row KV tiles, with Q, dO, K, V
// as f32 tiles in dynamic shared memory (102 KB at DC = 256).
// D is cut into chunks of DC = 256 or 128 columns (flash::gen_chunk; the
// chunked instances): each block writes one chunk of dQ, and the
// contractions over D (S = Q K^T and dP = dO V^T) are summed over the chunks
// staged one at a time, in the order that ends with the block's own chunk, so
// K's columns for dQ are the ones left in shared memory. The f32 instances
// of 256- and 128-column chunks serve only D768, 1280, ... and D896, 1152,
// ... (f32 D640 and 1024 are the cluster kernels'), and so do the bf16 ones
// (bf16 D640 and 1024 are the cluster kernels'). With more than one chunk Q
// and dO are reloaded per chunk and every block recomputes the scores (D /
// DC times their work; right and slow first). Each thread computes 4
// entries of dS (q row tid / 8, KV columns tid % 8 + 8i; rounded to q's
// dtype) and holds an eighth of its row's dQ chunk as interleaved float4s in
// f32 registers for the whole KV loop. Bound by shared-memory reads, not by
// the FMA rate; simple first.
// ---------------------------------------------------------------------------

constexpr int kGBQ = 16;  // q rows per block, 8 threads per row
constexpr int kGBN = 32;  // KV rows per tile

template <int DC>
constexpr int gen_smem_bytes() {
  return ((2 * kGBQ + 2 * kGBN) * (DC + 4) + kGBQ * (kGBN + 1)) * 4;
}

// p by value: the body taking the kernel's parameters by reference compiled
// the one-chunk instance at bf16 D384 (a cluster kernel's now) to code 1.45x
// slower on the H100.
template <typename T, int DC, bool kChunked>
__device__ __forceinline__ void flash_bwd_dq_generic_body(
    const flash::BwdParams p) {
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

// One block per (q tile, b * h, chunk of D): D above 4 kD.
template <typename T, int DC>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_generic_chunked_kernel(const flash::BwdParams p) {
  flash_bwd_dq_generic_body<T, DC, true>(p);
}

template <typename T, int DC>
int launch_generic(const flash::BwdParams& p, int D, int B, cudaStream_t st) {
  constexpr int smem = gen_smem_bytes<DC>();
  void (*kernel)(const flash::BwdParams) =
      flash_bwd_dq_generic_chunked_kernel<T, DC>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + kGBQ - 1) / kGBQ, B * p.H, D / DC);
  kernel<<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Picks the generic instance by D (a multiple of kD, checked by the caller)
// and dtype: above 4 kD a chunk of flash::gen_chunk(D) columns (D = 5 kD and
// 8 kD are the cluster kernels'). No generic instance takes D up to 4 kD (the
// wgmma and cluster kernels'): cudaErrorInvalidValue.
int launch_generic_d(const flash::BwdParams& p, int D, int dtype, int B,
                     cudaStream_t st) {
  if (D > 4 * kD) {
    const bool wide = flash::gen_chunk(D) == 2 * kD;
    if (dtype == 1)
      return wide ? launch_generic<bf16, 2 * kD>(p, D, B, st)
                  : launch_generic<bf16, kD>(p, D, B, st);
    return wide ? launch_generic<float, 2 * kD>(p, D, B, st)
                : launch_generic<float, kD>(p, D, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 at D = kChunks kD (1, 2, 3, 4, 5 or 8): one cluster of kChunks CTAs
// per 64 q rows, on `kernel`, the instance of that size. A launch the card
// refuses (no room for a cluster) returns its error. The shared-memory opt-in
// is set at every launch, as for the generic variants.
template <int kChunks, typename Kernel>
int launch_cluster(Kernel kernel, const flash::BwdParams& p, int B,
                   cudaStream_t st) {
  constexpr int D = kChunks * kD;
  CUtensorMap tq, tk, tv, tdo;
  if (!flash::make_f32_map(&tq, p.q, B, p.H, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                           f32c::kBQ, D, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !flash::make_f32_map(&tk, p.k, B, p.KVH, p.Skv, p.k_sb, p.k_sh,
                           p.k_ss, f32c::kBN, D, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !flash::make_f32_map(&tv, p.v, B, p.KVH, p.Skv, p.v_sb, p.v_sh,
                           p.v_ss, f32c::kBN, D, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !flash::make_f32_map(&tdo, p.dout, B, p.H, p.Sq, p.o_sb, p.o_sh,
                           p.o_ss, f32c::kBQ, D, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = flash::allow_smem(kernel, f32c::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.Sq + f32c::kBQ - 1) / f32c::kBQ;
  kernel<<<B * p.H * n_qt * kChunks, f32c::kThreads, f32c::kSmemBytes, st>>>(
      tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D = kChunks kD (3, 4, 5 or 8): one cluster of kChunks CTAs per 64 q
// rows, on `kernel`, the instance of that size, with 128B-swizzled
// 64-column boxes of every input. A launch the card refuses returns its
// error. The shared-memory opt-in is set at every launch.
template <int kChunks, typename Kernel>
int launch_bf16_cluster(Kernel kernel, const flash::BwdParams& p, int B,
                        cudaStream_t st) {
  constexpr int D = kChunks * kD;
  CUtensorMap tq, tk, tv, tdo;
  if (!flash::make_bhsd_map(&tq, p.q, B, p.H, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                            bf16c::kBQ, D) ||
      !flash::make_bhsd_map(&tk, p.k, B, p.KVH, p.Skv, p.k_sb, p.k_sh,
                            p.k_ss, bf16c::kBN, D) ||
      !flash::make_bhsd_map(&tv, p.v, B, p.KVH, p.Skv, p.v_sb, p.v_sh,
                            p.v_ss, bf16c::kBN, D) ||
      !flash::make_bhsd_map(&tdo, p.dout, B, p.H, p.Sq, p.o_sb, p.o_sh,
                            p.o_ss, bf16c::kBQ, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = flash::allow_smem(kernel, bf16c::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.Sq + bf16c::kBQ - 1) / bf16c::kBQ;
  const DqArgs a{p.lse, p.delta, static_cast<bf16*>(p.out0), p.H, p.KVH,
                 p.Sq, p.Skv, n_qt, p.scale * kLog2e, p.scale, p.causal};
  kernel<<<B * p.H * n_qt * kChunks, bf16c::kThreads, bf16c::kSmemBytes,
           st>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of the f32 D = 1024 kernel (8 CTAs each) the current
// device holds at once (cudaOccupancyMaxActiveClusters at its shared
// memory), into *clusters. Returns the CUDA error.
extern "C" int ray_flash_bwd_dq_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dq_f32_cluster_kernel, 8,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 640 kernel (clusters of 5).
extern "C" int ray_flash_bwd_dq_f32_d640_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dq_f32_d640_cluster_kernel, 5,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 512 kernel (clusters of 4).
extern "C" int ray_flash_bwd_dq_f32_d512_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dq_f32_d512_cluster_kernel, 4,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 384 kernel (clusters of 3).
extern "C" int ray_flash_bwd_dq_f32_d384_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dq_f32_d384_cluster_kernel, 3,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 256 kernel (clusters of 2).
extern "C" int ray_flash_bwd_dq_f32_d256_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dq_f32_d256_cluster_kernel, 2,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 128 kernel (clusters of 1).
extern "C" int ray_flash_bwd_dq_f32_d128_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dq_f32_d128_cluster_kernel, 1,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the bf16 D = 640 kernel (clusters of 5).
extern "C" int ray_flash_bwd_dq_bf16_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dq_bf16_cluster_kernel, 5,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 1024 kernel (clusters of 8).
extern "C" int ray_flash_bwd_dq_bf16_d1024_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dq_bf16_d1024_cluster_kernel,
                             8, bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 512 kernel (clusters of 4).
extern "C" int ray_flash_bwd_dq_bf16_d512_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dq_bf16_d512_cluster_kernel, 4,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 384 kernel (clusters of 3).
extern "C" int ray_flash_bwd_dq_bf16_d384_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dq_bf16_d384_cluster_kernel, 3,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// q/dO [B, H, Sq, D] and k/v [B, KVH, Skv, D] given by element strides (batch,
// head, seq; the last dim dense, every stride and base address a multiple of 16
// bytes, as TMA and the 16-byte loads require); lse and delta [B, H, Sq] f32
// and dq [B, H, Sq, D] dense, in the inputs' dtype. D is a multiple of 128;
// dtype: 0 = float32, 1 = bfloat16. bf16 at D = 128 and 256 runs a wgmma
// kernel, f32 at D = 128 a cluster kernel of 1 CTA, at D = 256 one of 2 CTAs,
// D = 384 one of 3, D = 512 one of 4, D = 640 one of 5 and D = 1024 one of 8
// (f32 or bf16), every other case (from D = 768 up) the generic variant.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape or layout the kernels do not take).
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
    if (dtype == 0 && D == kD)
      return launch_cluster<1>(f32c::flash_bwd_dq_f32_d128_cluster_kernel, p,
                               B, st);
    if (dtype == 0 && D == 2 * kD)
      return launch_cluster<2>(f32c::flash_bwd_dq_f32_d256_cluster_kernel, p,
                               B, st);
    if (dtype == 0 && D == 3 * kD)
      return launch_cluster<3>(f32c::flash_bwd_dq_f32_d384_cluster_kernel, p,
                               B, st);
    if (dtype == 0 && D == 4 * kD)
      return launch_cluster<4>(f32c::flash_bwd_dq_f32_d512_cluster_kernel, p,
                               B, st);
    if (dtype == 0 && D == 5 * kD)
      return launch_cluster<5>(f32c::flash_bwd_dq_f32_d640_cluster_kernel, p,
                               B, st);
    if (dtype == 0 && D == 8 * kD)
      return launch_cluster<8>(f32c::flash_bwd_dq_f32_cluster_kernel, p, B,
                               st);
    if (D == 3 * kD)
      return launch_bf16_cluster<3>(
          bf16c::flash_bwd_dq_bf16_d384_cluster_kernel, p, B, st);
    if (D == 4 * kD)
      return launch_bf16_cluster<4>(
          bf16c::flash_bwd_dq_bf16_d512_cluster_kernel, p, B, st);
    if (D == 5 * kD)
      return launch_bf16_cluster<5>(bf16c::flash_bwd_dq_bf16_cluster_kernel, p,
                                    B, st);
    if (D == 8 * kD)
      return launch_bf16_cluster<8>(
          bf16c::flash_bwd_dq_bf16_d1024_cluster_kernel, p, B, st);
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
