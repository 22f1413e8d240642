// Flash-attention backward, dK and dV, for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `_flash_bwd_dkv_kernel`, launched by
// `_flash_bwd_pallas` (ray_tpu/ops/attention.py:203-259, call :326). Same
// function: per KV tile, for every q tile that sees it, recompute
//   S = Q K^T * scale (masked to -0.7 * FLT_MAX), P = exp(S - LSE),
//   dV += P^T dO with P rounded to bf16,
//   dP = dO V^T, dS = P * (dP - delta) * scale rounded to bf16,
//   dK += dS^T Q,
// accumulating in f32 and storing dK, dV in bf16. LSE comes from the
// forward and delta = rowsum(dO * O) from the caller, both f32.
//
// What bounds it on the H100, and what the design does about it:
//   * At training lengths it is bound by the tensor cores: 4 products of
//     2 * 64 * 64 * 128 per (64 KV rows, 64 q rows) pair, 8 * B * H * D *
//     pairs FLOP in all. Each block owns 128 KV rows of one (b, KV head)
//     and has three warpgroups: a producer, which gives its registers away
//     (setmaxnreg.dec to 24), and two consumers of 64 KV rows each
//     (setmaxnreg.inc to 240). K and V (128 x 128 bf16 each) are loaded
//     once by TMA and stay in shared memory. The producer walks the H / KVH
//     query heads of the group and their 64-row q tiles: one thread issues
//     the TMA loads of Q and dO into a ring of 3 stages, and one warp
//     writes the tile's LSE (times log2 e) and delta rows beside them with
//     plain loads (+inf and 0 past Sq, so those q rows add nothing). Each
//     stage has a `full` mbarrier (TMA bytes plus the warp's 32 arrivals)
//     and an `empty` one that the 8 consumer warps arrive at.
//   * The products run transposed, so every intermediate stays in
//     registers: S^T = K Q^T and dP^T = V dO^T are wgmma.m64n64k16 with
//     both operands K-major in shared memory (64 KV rows x 64 q columns,
//     32 f32 registers each); P^T and dS^T re-pack from those accumulators
//     into the register A operand of dV += P^T dO and dK += dS^T Q
//     (wgmma.m64n128k16, 4 k-steps each), which read the same swizzled dO
//     and Q tiles MN-major through the transpose bit. dK and dV (64 + 64
//     registers) stay in f32 registers for the whole loop: 192 f32 values
//     per thread at the peak, under the 240 of setmaxnreg.
//   * dP^T is issued right behind S^T, and P is computed (one FFMA and one
//     MUFU.EX2 per score, raw scores in log2 units) while the tensor cores
//     work on dP^T; P's results are tied before the wait so the compiler
//     cannot sink them below it. The two consumers interleave on the
//     tensor cores by themselves.
//   * The TPU kernel's sequential q grid axis and its VMEM dK/dV scratch
//     become the loop inside one block, so dK and dV come out with KVH
//     heads, summed over the group's query heads in f32, with no atomics
//     and no repeat_kv copy.
//   * Causal work is uneven: the first KV tiles see every later q tile.
//     The grid's slow axis is the KV tile, so the heaviest tiles start
//     first. q tiles wholly before a KV tile are never loaded; a consumer
//     whose 64 rows see nothing of a tile only releases it; only the
//     diagonal tiles carry mask code (a template, not a branch per score).
//     Every block walks its q tiles from the last one down, so the blocks
//     of one KV head read the same Q and dO tiles at the same time, from
//     L2.
//   * The tensor maps are 4-D {D, S, heads, batch} built from the element
//     strides the caller passes, so q, k, v and dO as transposes of
//     [B, S, heads, D] views load without a copy; TMA zero-fills rows past
//     Sq and Skv, and the stores are guarded by row < Skv.
// That kernel serves bf16 at head_dim 128. At 256 (llama3_8b(n_heads=16))
// it cannot: dK and dV of 64 KV rows x 256 columns are 256 f32 registers a
// thread in one warpgroup. flash_bwd_dkv_d256_kernel (after it) serves bf16
// at 256, still bound by the tensor cores (the same FLOP as H32 D128 at equal
// d_model), and by registers and shared memory:
//   * A block owns 64 KV rows of one (b, KV head). K and V (64 x 256 each,
//     four 64-column boxes) stay in shared memory; Q and dO tiles of 64 q
//     rows (32 KB each) go through a 2-stage ring with LSE and delta as
//     above. The two consumer warpgroups split dK and dV by columns: each
//     holds a 128-column half of both, 64 + 64 f32 registers, for the whole
//     loop, so the group's query heads are still summed in f32 with no
//     atomics.
//   * The products over D, S^T = K Q^T and dP^T = V dO^T, are split by q
//     columns instead, so none is done twice: each consumer takes 32 of the
//     tile's 64 q columns (wgmma.m64n32k16, 16 k-steps, both operands
//     K-major in shared memory; 16 registers each). It computes its half of
//     P^T and dS^T and stores it in bf16 (rounded where the Pallas kernel
//     rounds) into a 128B-swizzled [kv][q] box in shared memory; a proxy
//     fence and a named barrier over both consumers publish the two halves.
//     Then dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half]
//     are wgmma.m64n128k16 with both operands in shared memory (P^T or dS^T
//     K-major as A, dO or Q MN-major through the transpose bit as B).
//   * P^T and dS^T have two buffers each, so the one barrier an iteration
//     also keeps a consumer from overwriting what the other still reads:
//     shared memory is then 64 (K, V) + 128 (ring) + 32 KB, all 227 KB with
//     the alignment slack.
//   * The N = 32 score products read 3 KB of shared memory per 16
//     tensor-core cycles, above the 128 B a cycle it gives, and the
//     consumers meet at the barrier each iteration with the tensor cores
//     idle while both compute P and dS: those two bound its rate. Issuing
//     the next tile's S^T and dP^T before waiting for dV and dK would fill
//     that gap, but ptxas then serializes every wgmma of the kernel
//     (C7514/C7515, in three arrangements tried), which made it a quarter
//     slower; so each iteration waits for its own products.
// f32 at 640 runs flash_bwd_dkv_f32_cluster_kernel (after that). The generic
// variant's chunked instance computed S^T and dP^T over all of D in each of
// its 5 chunk blocks, and its inner loops read one shared-memory word per
// FMA (32 words a clock against the FMA units' 128). This kernel is bound by
// the FMA units: f32 has no exact tensor-core input (TF32 rounds, and the
// f32 variants are held to 1e-4), 4 products of 64 * 32 * 640 FMAs per (64 KV
// rows, 32 q rows) pair.
//   * One cluster of 5 CTAs per (b, KV head, 64 KV rows), one CTA per
//     128-column chunk of D. A CTA loads its chunk of K and V once and
//     streams its chunk of Q and dO per 32-row q tile, walking the group's
//     query heads as above, through a 3-stage ring (f32 TMA boxes of 32
//     columns; K and V 128B-swizzled, since they are read down 8 rows of
//     one column at once).
//   * The products over D are split across the cluster, not repeated: each
//     CTA computes S^T and dP^T (64 x 32) over its own 128 columns into its
//     shared memory. Then each CTA sums a fifth of the KV rows over the 5
//     chunks through distributed shared memory (ld.shared::cluster), in
//     chunk order 0 to 4, forms P^T and dS^T of those rows in f32 (rounding
//     nothing, as the Pallas kernel's casts do not in f32) and stores them
//     into every CTA (st.shared::cluster): all five hold the same bits, and
//     a CTA moves 26 KB through the cluster a tile, not the 64 KB of every
//     CTA reading every partial.
//   * dV[:, chunk] += P^T dO and dK[:, chunk] += dS^T Q: 64 f32 registers a
//     thread for the whole loop, so the group's query heads are summed with
//     no atomics.
//   * Roles: two math warpgroups (setmaxnreg 224) run phase A (S^T or dP^T)
//     of tile t, then phase B (dV or dK) of tile t - 1, so the exchange of
//     tile t runs beside phase B; one warpgroup (56 registers) sums,
//     exchanges and loads. They hand over through mbarriers that the peers
//     arrive at (parts_ready, parts_free, pd_ready, pd_free), with double
//     buffers, instead of a cluster barrier a tile.
//   * Shared memory gives 32 words a clock and the FMA units take 128, so
//     every inner loop runs on an 8 x 8 register tile (each word read feeds
//     8 FMAs); phase A splits a tile's 128 columns over 4 lanes and sums them
//     by shuffles.
//   * An arrival released at cluster scope compiles to a GPU-wide memory
//     barrier (MEMBAR.ALL.GPU) that stalls the warp: lanes 0-4 arrive at the
//     5 CTAs in one instruction, only one math warp (another each tile)
//     releases the partials, and the "done reading" signals arrive with CTA
//     scope.
//   * 226 KB of shared memory: one CTA an SM, and a cluster takes 5 SMs of
//     one GPC (22 clusters fit on the H100).
// f32 at 128, 256, 384, 512 and 1024 runs the same kernel at 1, 2, 3, 4 and
// 8 CTAs a cluster (flash_bwd_dkv_f32_d128_cluster_kernel,
// flash_bwd_dkv_f32_d256_cluster_kernel,
// flash_bwd_dkv_f32_d384_cluster_kernel,
// flash_bwd_dkv_f32_d512_cluster_kernel,
// flash_bwd_dkv_f32_d1024_cluster_kernel): the body is a template over the
// number of 128-column chunks, and each instance gives its cluster's size
// as a literal. At 8 chunks each CTA owns 8 of the 64 KV rows in the
// exchange and moves about 28 KB a tile through the cluster; 8 is the
// largest portable cluster. At 4 chunks each CTA owns 16 rows, 8 threads a
// row: every thread of the exchange. At 3 it owns 21 or 22, more than the
// exchange's 16 rows of 8 threads, so the exchange walks its rows in slots
// of 16 (kSlots: 2 at 2 and 3 chunks, 1 at 4, 5 and 8), one loop for every
// cluster size; the second slot keeps 5 or 6 rows, 40 or 48 of the 128
// threads. At 2 chunks it owns 32 rows: both slots full, every thread in
// each. The two slots' sums do not fit the exchange's 56 registers
// (ptxas spilled 64 bytes), so at two slots the exchange takes 72 and the
// math warpgroups 216 in place of 224, which they take without a spill. At
// 1 chunk (D128) the one CTA owns all 64 rows, four full slots, at 88 and
// 208, and sums no peer's partials: with no peer its hand-overs are
// CTA-scope arrivals and plain shared-memory loads and stores (4.3% faster
// on the H100 than the cluster-scope ones at one CTA).
// Chunks of 256 columns would not fit: K, V and the Q/dO ring alone would
// take 320 KB a CTA; so at D256 one CTA cannot hold a 64-row KV block (its
// dK and dV alone are 128 registers a math thread), and two share it.
// bf16 at 640 runs flash_bwd_dkv_bf16_cluster_kernel (after that): the same
// cluster with each CTA's products on the tensor cores. The generic chunked
// instance ran all four products as scalar FMAs, and its 5 chunk blocks each
// recomputed S^T and dP^T over all of D. Here the four products of a (64 KV
// rows, 64 q rows) tile pair are 4.2 MFLOP a CTA, about 0.56 us at one SM's
// share of the tensor cores; the exchange of the f32 score partials (about
// 49 KB a CTA a tile through distributed shared memory, 39 KB of it remote)
// bounds it, not the tensor cores.
//   * One cluster of 5 CTAs per (b, KV head, 64 KV rows). A CTA loads its
//     chunk of K and V once (two 128B-swizzled 64-column boxes each) and
//     streams its chunk of Q and dO per 64-row q tile through a 3-stage ring
//     with LSE and delta (with 2 stages a tile's loads wait for the phase B
//     of the tile before, which was slower on the card).
//   * Warpgroup 0 computes S^T = K Q^T, warpgroup 1 dP^T = V dO^T, over the
//     CTA's 128 columns (wgmma.m64n64k16, both operands K-major) into f32
//     partials. The exchange warpgroup sums a fifth of the KV rows over the
//     5 chunks in chunk order 0 to 4, forms P^T and, from that f32 P^T,
//     dS^T, rounds both to bf16 (where the Pallas kernel rounds them) and
//     stores them into every CTA as 128B-swizzled [kv][q] boxes. Then dV +=
//     P^T dO and dK += dS^T Q are wgmma.m64n128k16 with both operands in
//     shared memory (flash::mma_t), 64 f32 registers for the whole loop.
//   * Phase B of tile t - 1 runs beside the exchange of tile t, with the
//     f32 kernel's hand-overs. wgmma reads through the async proxy what
//     other CTAs stored: the reader fences after its acquire, which was
//     faster on the card than each writer fencing before its release.
//   * 232,448 bytes of shared memory (3 ring stages, two buffers of the
//     partials and of P^T and dS^T): one CTA an SM, 22 clusters at once.
// bf16 at 384, 512 and 1024 runs the same kernel at 3, 4 and 8 CTAs a
// cluster (flash_bwd_dkv_bf16_d384_cluster_kernel,
// flash_bwd_dkv_bf16_d512_cluster_kernel,
// flash_bwd_dkv_bf16_d1024_cluster_kernel), as f32 does: the body is a
// template over the chunk count, each instance gives its cluster's size as a
// literal, and the shared memory is the 5-CTA one's. At 8 CTAs each CTA's
// exchange owns 8 of the 64 KV rows (one row a 16-lane group, one row slot)
// and sums 8 partials a row in place of 5; at 4 it owns 16 rows in two
// slots and sums 4 partials a row; at 3 it owns 21 or 22 rows in three
// slots (the third 5 or 6 rows full) and sums 3 partials a row. The body
// has no setmaxnreg split, so the third slot's sums come out of the 168
// registers every thread of the launch has.
// A generic variant (at the end of this file) serves f32 and bf16 at any
// other head_dim that is a multiple of 128 (from 768 up but 1024, tiled over
// D), with P and dS rounded to the input dtype as the Pallas kernel rounds
// them.

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
using flash::pack_a;
using flash::pack_bf16;
using flash::release;
typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;          // consumer warpgroups, 64 KV rows each
constexpr int kBKV = 64 * kConsumers;  // KV rows per block
constexpr int kBQ = 64;                // q rows per tile
constexpr int kStages = 3;             // Q/dO ring depth
constexpr uint32_t kKvHalfBytes = kBKV * kHalf * 2;  // 16 KB
constexpr uint32_t kQHalfBytes = kBQ * kHalf * 2;    // 8 KB
constexpr uint32_t kQTileBytes = kBQ * kD * 2;       // one Q or dO tile

struct __align__(1024) DkvSmem {
  bf16 k[2][kBKV * kHalf];  // two 64-column halves
  bf16 v[2][kBKV * kHalf];
  bf16 q[kStages][2][kBQ * kHalf];
  bf16 dout[kStages][2][kBQ * kHalf];
  float lse[kStages][kBQ];    // LSE * log2(e) of the tile's q rows
  float delta[kStages][kBQ];
  uint64_t kv_full;
  uint64_t full[kStages];   // Q, dO landed; LSE, delta written
  uint64_t empty[kStages];  // every consumer warp is done with the stage
};

// + slack to align the base to 1024 bytes.
constexpr int kSmemBytes = static_cast<int>(sizeof(DkvSmem)) + 1024;

struct DkvArgs {
  const float* lse;    // [B, H, Sq] dense
  const float* delta;  // [B, H, Sq] dense
  bf16* dk;            // [B, KVH, Skv, D] dense
  bf16* dv;
  int H, KVH, Sq, Skv, n_kvt;
  float scale_log2;  // scale * log2(e)
  float scale;
  int causal;
};

// Issue acc = A B^T as one wgmma group: A is this warpgroup's 64 rows of K
// or V, B the q tile's Q or dO (64 rows), both K-major. The caller waits.
__device__ __forceinline__ void issue_t(float (&acc)[32], uint32_t a_base,
                                        uint32_t b_base) {
  flash::issue_abt<kBQ>(acc, a_base, kKvHalfBytes, b_base, kQHalfBytes);
}

// P^T in place, for an accumulator of N q columns: st[4j + 2a + b] holds KV
// row r_lo + 8a (r_lo = this thread's first row), q column 8j + 2(lane % 4)
// + b of those the accumulator covers (lse points at the first one's). diag
// = r_lo - that first q column: a score is masked (causal) where its q
// column is below its KV row. The unmasked instance carries no mask code.
template <bool kMasked, int N>
__device__ __forceinline__ void probs_impl(float (&st)[N / 2],
                                           const float* lse, float c,
                                           int diag, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int qc = 8 * j + 2 * (lane % 4);
    const float2 l = *reinterpret_cast<const float2*>(lse + qc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fast_exp2(fmaf(st[4 * j + e], c, (e & 1) ? -l.y : -l.x));
      if (kMasked && qc + (e & 1) < diag + (e < 2 ? 0 : 8)) x = 0.f;
      st[4 * j + e] = x;
    }
  }
}

template <int N>
__device__ __forceinline__ void probs(float (&st)[N / 2], bool masked,
                                      const float* lse, float c, int diag,
                                      int lane) {
  if (masked)
    probs_impl<true, N>(st, lse, c, diag, lane);
  else
    probs_impl<false, N>(st, lse, c, diag, lane);
  // Keep P ahead of the wait for dP^T: without these ties the compiler may
  // sink the exponentials below it, and nothing would overlap.
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hopper::fence_reg(st[i]);
}

// dS^T = P^T (dP^T - delta) * scale in place of dP^T (delta by q column,
// pointing at the accumulator's first one).
template <int N>
__device__ __forceinline__ void dscores(float (&dpt)[N / 2],
                                        const float (&st)[N / 2],
                                        const float* delta, float scale,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 d =
        *reinterpret_cast<const float2*>(delta + 8 * j + 2 * (lane % 4));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * j + e] =
          st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x)) * scale;
  }
}

__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const DkvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));

  // Block -> (KV tile, b, KV head), the KV tile slowest: causal, the first
  // KV tiles see the most q tiles, so they start first.
  const int G = p.H / p.KVH;
  const int n_bk = gridDim.x / p.n_kvt;  // B * KVH
  const int bk = blockIdx.x % n_bk;
  const int kvt = blockIdx.x / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int k0 = kvt * kBKV;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  // Causal: q tiles before this KV tile see none of it (kBKV % kBQ == 0).
  const int qt_first = p.causal ? min(k0 / kBQ, n_qt) : 0;
  const int n_per = n_qt - qt_first;  // q tiles per query head
  const int n_it = G * n_per;
  // Iteration it: query head kvh * G + it / n_per, q tile q_start(it).
  auto q_start = [&](int it) { return (n_qt - 1 - it % n_per) * kBQ; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1 + 32);  // TMA thread + LSE warp
      hopper::mbar_init(&sm.empty[s], 4 * kConsumers);  // consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ------------------------------------------
    // Thread 0 issues every TMA load; warp 1 writes LSE and delta. A stage
    // is refilled once both consumers are done with it.
    hopper::reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.kv_full, 2 * kBKV * kD * 2);
      hopper::tma_load_4d(sm.k[0], &tk, &sm.kv_full, 0, k0, kvh, b);
      hopper::tma_load_4d(sm.k[1], &tk, &sm.kv_full, kHalf, k0, kvh, b);
      hopper::tma_load_4d(sm.v[0], &tv, &sm.kv_full, 0, k0, kvh, b);
      hopper::tma_load_4d(sm.v[1], &tv, &sm.kv_full, kHalf, k0, kvh, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          hopper::mbar_wait(&sm.empty[s], ((it / kStages) - 1) & 1);
        const int h = kvh * G + it / n_per;
        const int q0 = q_start(it);
        hopper::mbar_expect_tx(&sm.full[s], 2 * kQTileBytes);
        hopper::tma_load_4d(sm.q[s][0], &tq, &sm.full[s], 0, q0, h, b);
        hopper::tma_load_4d(sm.q[s][1], &tq, &sm.full[s], kHalf, q0, h, b);
        hopper::tma_load_4d(sm.dout[s][0], &tdo, &sm.full[s], 0, q0, h, b);
        hopper::tma_load_4d(sm.dout[s][1], &tdo, &sm.full[s], kHalf, q0, h,
                            b);
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          hopper::mbar_wait(&sm.empty[s], ((it / kStages) - 1) & 1);
        const int h = kvh * G + it / n_per;
        const int q0 = q_start(it);
        const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
        for (int i = lane; i < kBQ; i += 32) {
          const int r = q0 + i;
          sm.lse[s][i] = r < p.Sq ? p.lse[row0 + r] * kLog2e : INFINITY;
          sm.delta[s][i] = r < p.Sq ? p.delta[row0 + r] : 0.f;
        }
        hopper::mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    // ---------------- consumers: 64 KV rows each ------------------------
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int kr0 = k0 + cw * 64;  // this warpgroup's first KV row
    const int r_lo = kr0 + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
    const uint32_t k_base = hopper::smem_u32(sm.k[0]) + cw * 64 * 128;
    const uint32_t v_base = hopper::smem_u32(sm.v[0]) + cw * 64 * 128;

    hopper::mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = q_start(it);
      hopper::mbar_wait(&sm.full[s], (it / kStages) & 1);
      // Causal: every q row of the tile is before every KV row of this
      // warpgroup; or the warpgroup has no rows (Skv <= 64).
      if (kr0 >= p.Skv || (p.causal && q0 + kBQ - 1 < kr0)) {
        release(&sm.empty[s], lane);
        continue;
      }
      const bool masked = p.causal && q0 < kr0 + 63;  // the diagonal
      const uint32_t q_base = hopper::smem_u32(sm.q[s][0]);
      const uint32_t do_base = hopper::smem_u32(sm.dout[s][0]);
      issue_t(st, k_base, q_base);    // S^T = K Q^T
      issue_t(dpt, v_base, do_base);  // dP^T = V dO^T
      hopper::wgmma_wait<1>();        // S^T is done, dP^T may still run
#pragma unroll
      for (int i = 0; i < 32; ++i) hopper::fence_reg(st[i]);
      probs<kBQ>(st, masked, sm.lse[s], p.scale_log2, r_lo - q0, lane);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) hopper::fence_reg(dpt[i]);
      dscores<kBQ>(dpt, st, sm.delta[s], p.scale, lane);
      pack_a(pa, st);
      pack_a(sa, dpt);
      hopper::wgmma_fence();
      // dV += P^T dO and dK += dS^T Q read the same swizzled dO and Q
      // tiles MN-major: their two 64-wide d halves are one 8 KB LBO apart.
      flash::mma_rs(dv, pa, do_base, kQHalfBytes);
      flash::mma_rs(dk, sa, q_base, kQHalfBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        hopper::fence_reg(dv[i]);
        hopper::fence_reg(dk[i]);
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hopper::fence_reg(pa[kk][i]);
          hopper::fence_reg(sa[kk][i]);
        }
      release(&sm.empty[s], lane);
    }

    const long long out0 = (static_cast<long long>(b) * p.KVH + kvh) * p.Skv;
    bf16* dK = p.dk + out0 * kD;
    bf16* dV = p.dv + out0 * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      if (r_lo < p.Skv) {
        const long long o = static_cast<long long>(r_lo) * kD + c;
        *reinterpret_cast<uint32_t*>(dK + o) =
            pack_bf16(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dV + o) =
            pack_bf16(dv[4 * j], dv[4 * j + 1]);
      }
      if (r_hi < p.Skv) {
        const long long o = static_cast<long long>(r_hi) * kD + c;
        *reinterpret_cast<uint32_t*>(dK + o) =
            pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dV + o) =
            pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 256: 64 KV rows per block, the two consumers split dK and dV
// by columns and the scores by q columns (see the top of this file). Its
// block walk, producer and stores follow the D = 128 kernel's with four
// boxes a tile; they are not shared with it because moving that kernel's
// code into shared helpers changed its machine code (the same time, other
// registers and order), and the D = 128 path is kept as it compiled.
// ---------------------------------------------------------------------------

namespace d256 {

using flash::kBoxBytes;  // 8 KB: 64 rows x 128 B
using flash::mma_t;
using flash::store_t;

constexpr int kDW = 2 * kD;            // head_dim
constexpr int kBoxes = kDW / kHalf;    // 64-column boxes of a row
constexpr int kBKV = 64;               // KV rows per block
constexpr int kBQ = 64;                // q rows per tile
constexpr int kQCols = kBQ / kConsumers;  // S^T columns per consumer
constexpr int kStages = 2;             // Q/dO ring depth
constexpr uint32_t kTileBytes = 64 * kDW * 2;   // one K, V, Q or dO tile

struct __align__(1024) Smem {
  bf16 k[kBoxes][kBKV * kHalf];
  bf16 v[kBoxes][kBKV * kHalf];
  bf16 q[kStages][kBoxes][kBQ * kHalf];
  bf16 dout[kStages][kBoxes][kBQ * kHalf];
  bf16 pt[2][kBKV * kBQ];   // P^T [kv][q], one 128B-swizzled box; 2 buffers
  bf16 dst[2][kBKV * kBQ];  // dS^T, the same
  float lse[kStages][kBQ];  // LSE * log2(e) of the tile's q rows
  float delta[kStages][kBQ];
  uint64_t kv_full;
  uint64_t full[kStages];   // Q, dO landed; LSE, delta written
  uint64_t empty[kStages];  // every consumer warp is done with the stage
};

// + slack to align the base to 1024 bytes: 232,448 bytes, the whole 227 KB
// a block may opt in to.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const DkvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Smem& sm =
      *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));

  // Block -> (KV tile, b, KV head), the KV tile slowest, as at D = 128.
  const int G = p.H / p.KVH;
  const int n_bk = gridDim.x / p.n_kvt;  // B * KVH
  const int bk = blockIdx.x % n_bk;
  const int kvt = blockIdx.x / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int k0 = kvt * kBKV;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int qt_first = p.causal ? min(kvt, n_qt) : 0;  // kBKV == kBQ
  const int n_per = n_qt - qt_first;  // q tiles per query head
  const int n_it = G * n_per;
  auto q_start = [&](int it) { return (n_qt - 1 - it % n_per) * kBQ; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1 + 32);  // TMA thread + LSE warp
      hopper::mbar_init(&sm.empty[s], 4 * kConsumers);  // consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: as at D = 128, four boxes a tile --------
    hopper::reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
#pragma unroll
      for (int i = 0; i < kBoxes; ++i) {
        hopper::tma_load_4d(sm.k[i], &tk, &sm.kv_full, i * kHalf, k0, kvh, b);
        hopper::tma_load_4d(sm.v[i], &tv, &sm.kv_full, i * kHalf, k0, kvh, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          hopper::mbar_wait(&sm.empty[s], ((it / kStages) - 1) & 1);
        const int h = kvh * G + it / n_per;
        const int q0 = q_start(it);
        hopper::mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
#pragma unroll
        for (int i = 0; i < kBoxes; ++i) {
          hopper::tma_load_4d(sm.q[s][i], &tq, &sm.full[s], i * kHalf, q0, h,
                              b);
          hopper::tma_load_4d(sm.dout[s][i], &tdo, &sm.full[s], i * kHalf, q0,
                              h, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          hopper::mbar_wait(&sm.empty[s], ((it / kStages) - 1) & 1);
        const int h = kvh * G + it / n_per;
        const int q0 = q_start(it);
        const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
        for (int i = lane; i < kBQ; i += 32) {
          const int r = q0 + i;
          sm.lse[s][i] = r < p.Sq ? p.lse[row0 + r] * kLog2e : INFINITY;
          sm.delta[s][i] = r < p.Sq ? p.delta[row0 + r] : 0.f;
        }
        hopper::mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    // ---------------- consumers: all 64 KV rows, half the columns -------
    // Consumer cw computes S^T and dP^T for q columns 32 cw.. of the tile
    // and owns columns 128 cw.. of dK and dV.
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r_lo = k0 + warp * 16 + lane / 4;  // this thread's KV rows
    const int r_hi = r_lo + 8;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    float st[kQCols / 2], dpt[kQCols / 2];
    const uint32_t k_base = hopper::smem_u32(sm.k[0]);
    const uint32_t v_base = hopper::smem_u32(sm.v[0]);
    const uint32_t cols = cw * kQCols * 128;   // this consumer's q rows
    const uint32_t half = 2 * cw * kBoxBytes;  // its dK/dV boxes

    hopper::mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int buf = it & 1;
      const int q0 = q_start(it);
      hopper::mbar_wait(&sm.full[s], (it / kStages) & 1);
      const bool masked = p.causal && q0 < k0 + kBKV - 1;  // the diagonal
      const uint32_t q_base = hopper::smem_u32(sm.q[s][0]);
      const uint32_t do_base = hopper::smem_u32(sm.dout[s][0]);
      // S^T = K Q^T, dP^T = V dO^T: 16 k-steps of m64n32k16 each.
      flash::issue_abt<kQCols, kDW>(st, k_base, kBoxBytes, q_base + cols,
                                    kBoxBytes);
      flash::issue_abt<kQCols, kDW>(dpt, v_base, kBoxBytes, do_base + cols,
                                    kBoxBytes);
      hopper::wgmma_wait<1>();  // S^T is done, dP^T may still run
#pragma unroll
      for (int i = 0; i < kQCols / 2; ++i) hopper::fence_reg(st[i]);
      probs<kQCols>(st, masked, sm.lse[s] + cw * kQCols, p.scale_log2,
                    r_lo - (q0 + cw * kQCols), lane);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kQCols / 2; ++i) hopper::fence_reg(dpt[i]);
      dscores<kQCols>(dpt, st, sm.delta[s] + cw * kQCols, p.scale, lane);
      // Both halves of P^T and dS^T, in bf16, for both consumers' products.
      // Two buffers: the other consumer may still read this iteration's
      // buffer of two iterations back until it has passed the barrier of
      // the last one.
      store_t(sm.pt[buf], st, cw, warp, lane);
      store_t(sm.dst[buf], dpt, cw, warp, lane);
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1, 256);
      hopper::wgmma_fence();
      mma_t(dv, hopper::smem_u32(sm.pt[buf]), do_base + half);  // P^T dO
      mma_t(dk, hopper::smem_u32(sm.dst[buf]), q_base + half);  // dS^T Q
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        hopper::fence_reg(dv[i]);
        hopper::fence_reg(dk[i]);
      }
      release(&sm.empty[s], lane);
    }

    const long long out0 = (static_cast<long long>(b) * p.KVH + kvh) * p.Skv;
    bf16* dK = p.dk + out0 * kDW;
    bf16* dV = p.dv + out0 * kDW;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = cw * kD + j * 8 + (lane % 4) * 2;
      if (r_lo < p.Skv) {
        const long long o = static_cast<long long>(r_lo) * kDW + c;
        *reinterpret_cast<uint32_t*>(dK + o) =
            pack_bf16(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dV + o) =
            pack_bf16(dv[4 * j], dv[4 * j + 1]);
      }
      if (r_hi < p.Skv) {
        const long long o = static_cast<long long>(r_hi) * kDW + c;
        *reinterpret_cast<uint32_t*>(dK + o) =
            pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dV + o) =
            pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

}  // namespace d256

// ---------------------------------------------------------------------------
// f32 at D = 128, 256, 384, 512, 640 and 1024: one cluster of 1, 2, 3, 4, 5
// or 8 CTAs per (b, KV head, 64 KV rows), one CTA per 128-column chunk of D;
// the scores summed over the cluster (see the top of this file).
// ---------------------------------------------------------------------------

namespace f32c {

constexpr int kBKV = 64;                // KV rows per cluster
constexpr int kBQ = 32;                 // q rows per tile
constexpr int kStages = 3;              // Q/dO ring depth
constexpr int kBox = 32;                // f32 columns of a 128-byte box
constexpr int kBoxes = kD / kBox;       // boxes of a chunk's row
constexpr int kMathWarps = 8;           // two warpgroups: the products
constexpr int kXWarps = 4;              // one warpgroup: the exchange, loads
constexpr int kThreads = 32 * (kMathWarps + kXWarps);
constexpr int kMathRegs = 224;          // setmaxnreg of the math warpgroups
constexpr int kXRegs = 56;              // and of the exchange (one row slot)
constexpr uint32_t kRowBytes = kD * 4;  // one row of a chunk

// K, V, Q and dO chunks as TMA writes them: 4 boxes of 32 columns, each
// `rows` x 128 bytes. K and V are read down 8 rows of one 16-byte column at
// once, so their 16-byte column c of row r sits at c ^ (r % 8) within its
// box (CU_TENSOR_MAP_SWIZZLE_128B) and those 8 words fall in 8 distinct
// banks; Q and dO are read along a row, in place.
struct __align__(1024) Smem {
  float k[kBoxes][kBKV * kBox];
  float v[kBoxes][kBKV * kBox];
  float q[kStages][kBoxes][kBQ * kBox];
  float dout[kStages][kBoxes][kBQ * kBox];
  float part[2][2][kBKV * kBQ];  // [buffer][S^T, dP^T] over this chunk
  float pd[2][2][kBKV * kBQ];    // [buffer][P^T, dS^T] over all of D
  float lse[kStages][kBQ];
  float delta[kStages][kBQ];
  uint64_t kv_full;
  uint64_t full[kStages];     // Q, dO landed (TMA bytes); LSE, delta written
  uint64_t empty[kStages];    // this CTA's math warps are done with a stage
  uint64_t parts_ready[2];    // every CTA's math warps wrote part[buffer]
  uint64_t parts_free[2];     // every CTA's exchange warps read their slice
  uint64_t pd_ready[2];       // every CTA stored its slice of pd[buffer]
  uint64_t pd_free[2];        // every CTA's math warps are done with it
};

// + slack to align the base to 1024 bytes.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

using flash::f4;
using flash::swz32;  // the [kv][q] partials
static_assert(kBQ == 32, "swz32's rows are 32 floats");

// The kernel over kChunks CTAs a cluster (D = kChunks kD); the kernels
// after it give the cluster's size as a literal.
template <int kChunks>
__device__ __forceinline__ void dkv_cluster(const CUtensorMap& tq,
                                            const CUtensorMap& tk,
                                            const CUtensorMap& tv,
                                            const CUtensorMap& tdo,
                                            const flash::BwdParams& p) {
  constexpr int kDW = kChunks * kD;  // head_dim
  // KV rows a CTA's exchange owns at most (64 of 1 CTA, 32 of 2, 22 of 3, 16
  // of 4, 13 of 5, 8 of 8), 16 a slot
  constexpr int kSlots = ((kBKV + kChunks - 1) / kChunks + 15) / 16;
  // setmaxnreg of the math and exchange warpgroups: 224 and 56 at one row
  // slot, 216 and 72 at two (at 56 the exchange spilled 64 bytes), 208 and
  // 88 at four (D = kD: 216 / 72 spilled 44 bytes, and 208 / 88 ran 0.7%
  // faster than 200 / 104 on the H100); each split is the 168 x 384
  // registers the launch gives a CTA.
  constexpr int kMathR = kSlots == 1 ? kMathRegs : kSlots == 2 ? 216 : 208;
  constexpr int kXR = kSlots == 1 ? kXRegs : kSlots == 2 ? 72 : 88;
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

  // Cluster -> (KV tile, b, KV head), the KV tile slowest: causal, the
  // first KV tiles see the most q tiles, so they start first.
  const int G = p.H / p.KVH;
  const int n_kvt = (p.Skv + kBKV - 1) / kBKV;
  const int n_bk = gridDim.x / kChunks / n_kvt;  // B * KVH
  const int cl = blockIdx.x / kChunks;
  const int bk = cl % n_bk;
  const int kvt = cl / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int k0 = kvt * kBKV;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  // Causal: q tiles wholly before this KV tile see none of it.
  const int qt_first = p.causal ? min(k0 / kBQ, n_qt) : 0;
  const int n_per = n_qt - qt_first;  // q tiles per query head
  const int n_it = G * n_per;
  // Tile it: query head head(it), q rows from q_start(it), the last first.
  auto head = [&](int it) { return kvh * G + it / n_per; };
  auto q_start = [&](int it) { return (n_qt - 1 - it % n_per) * kBQ; };

  if (tid == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1 + 32);  // TMA bytes + the loader
      hopper::mbar_init(&sm.empty[s], kMathWarps);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&sm.parts_ready[i], kOne ? kMathWarps : kChunks);
      hopper::mbar_init(&sm.parts_free[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.pd_ready[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.pd_free[i], kChunks * kMathWarps);
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
    hopper::reg_dealloc<kXR>();
    // Its first warp loads: K and V once, then per tile Q and dO (TMA, 4
    // boxes each; rows past Sq and Skv are zero-filled) and LSE and delta
    // (+inf and 0 past Sq: P and dS are 0 on such a q row), the loads read
    // an iteration ahead into registers.
    const bool loader = warp == kMathWarps;
    float lse_next = 0.f, delta_next = 0.f;
    auto fetch_rows = [&](int it) {
      const int r = q_start(it) + lane;
      const long long at =
          (static_cast<long long>(b) * p.H + head(it)) * p.Sq + r;
      lse_next = r < p.Sq ? p.lse[at] : INFINITY;
      delta_next = r < p.Sq ? p.delta[at] : 0.f;
    };
    auto load_tile = [&](int it) {
      const int s = it % kStages;
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.full[s], 2 * kBQ * kRowBytes);
        for (int x = 0; x < kBoxes; ++x) {
          hopper::tma_load_4d(sm.q[s][x], &tq, &sm.full[s],
                              c * kD + x * kBox, q_start(it), head(it), b);
          hopper::tma_load_4d(sm.dout[s][x], &tdo, &sm.full[s],
                              c * kD + x * kBox, q_start(it), head(it), b);
        }
      }
      sm.lse[s][lane] = lse_next;
      sm.delta[s][lane] = delta_next;
      hopper::mbar_arrive(&sm.full[s]);
    };
    if (loader) {
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.kv_full, 2 * kBKV * kRowBytes);
        for (int x = 0; x < kBoxes; ++x) {
          hopper::tma_load_4d(sm.k[x], &tk, &sm.kv_full, c * kD + x * kBox,
                              k0, kvh, b);
          hopper::tma_load_4d(sm.v[x], &tv, &sm.kv_full, c * kD + x * kBox,
                              k0, kvh, b);
        }
      }
      for (int it = 0; it < min(n_it, kStages - 1); ++it) {
        fetch_rows(it);
        load_tile(it);
      }
    }

    // This CTA's KV rows, [c 64 / kChunks, (c + 1) 64 / kChunks) (8 of 64
    // at 8 chunks, 12 or 13 at 5, 16 at 4: every thread; 21 or 22 at 3; 32
    // at 2: every thread in both slots; all 64 at 1, in four full slots):
    // thread xt takes row c 64 / kChunks + xt / 8 + 16 i of each row slot i
    // < kSlots and sums one 16-byte column (4 q columns) of it over the
    // chunks, in chunk order 0 to kChunks - 1 in every CTA, so that all hold
    // the same P^T and dS^T bits, forms P^T = exp(S^T scale - LSE) and dS^T
    // = P^T (dP^T - delta) scale in f32 (the Pallas kernel's casts round
    // nothing in f32), and stores them into every CTA's pd.
    const int xt = tid - 32 * kMathWarps;
    const int col4 = xt % 8;
    int row[kSlots], krow[kSlots];
    bool mine[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      row[i] = c * kBKV / kChunks + xt / 8 + 16 * i;
      mine[i] = row[i] < (c + 1) * kBKV / kChunks;
      krow[i] = k0 + row[i];
    }
    for (int it = 0; it < n_it; ++it) {
      const int buf = it & 1;
      const int s = it % kStages;
      const int q0 = q_start(it);
      const int nx = it + kStages - 1;  // the tile the loader loads next
      if (loader && nx < n_it) fetch_rows(nx);
      if constexpr (kOne)
        hopper::mbar_wait(&sm.parts_ready[buf], (it >> 1) & 1);
      else
        hopper::mbar_wait_cluster(&sm.parts_ready[buf], (it >> 1) & 1);
      float4 st[kSlots], dpt[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        st[i] = dpt[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!mine[i]) continue;
        if constexpr (kOne) {
          st[i] = flash::ld4(sm.part[buf][0] + swz32(row[i], col4));
          dpt[i] = flash::ld4(sm.part[buf][1] + swz32(row[i], col4));
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
          st[i] = r == 0 ? x : flash::add4(st[i], x);
          dpt[i] = r == 0 ? y : flash::add4(dpt[i], y);
        }
      }
      __syncwarp();
      if constexpr (kOne) {
        if (lane == 0) hopper::mbar_arrive(&sm.parts_free[buf]);
      } else {
        if (lane < kChunks)
          hopper::mbar_signal_rank(&sm.parts_free[buf], lane);
      }
      hopper::mbar_wait(&sm.full[s], (it / kStages) & 1);  // LSE, delta
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        float pv[4] = {st[i].x, st[i].y, st[i].z, st[i].w};
        float dv[4] = {dpt[i].x, dpt[i].y, dpt[i].z, dpt[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 4 * col4 + e;
          float x = pv[e] * p.scale;
          if (p.causal && q0 + qi < krow[i]) x = flash::kMaskValue;
          const float pr = expf(x - sm.lse[s][qi]);
          pv[e] = pr;
          dv[e] = (dv[e] - sm.delta[s][qi]) * pr * p.scale;
        }
        st[i] = f4(pv);
        dpt[i] = f4(dv);
      }
      // Every CTA's math warps are done with this buffer's tile before.
      if (it >= 2)
        hopper::mbar_wait(&sm.pd_free[buf], ((it - 2) >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        if constexpr (kOne) {
          *reinterpret_cast<float4*>(sm.pd[buf][0] + row[i] * kBQ +
                                     4 * col4) = st[i];
          *reinterpret_cast<float4*>(sm.pd[buf][1] + row[i] * kBQ +
                                     4 * col4) = dpt[i];
          continue;
        }
        const uint32_t p_at =
            hopper::smem_u32(sm.pd[buf][0] + row[i] * kBQ + 4 * col4);
        const uint32_t d_at =
            hopper::smem_u32(sm.pd[buf][1] + row[i] * kBQ + 4 * col4);
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          hopper::st_cluster_f4(hopper::map_rank(p_at, r), st[i]);
          hopper::st_cluster_f4(hopper::map_rank(d_at, r), dpt[i]);
        }
      }
      __syncwarp();
      if constexpr (kOne) {
        if (lane == 0) hopper::mbar_arrive(&sm.pd_ready[buf]);
      } else {
        if (lane < kChunks)
          hopper::mbar_arrive_rank(&sm.pd_ready[buf], lane);
      }
      // The tile two ahead goes into the stage of the one before this,
      // once this CTA's math warps are done with it.
      if (loader && nx < n_it) {
        if (nx >= kStages)
          hopper::mbar_wait(&sm.empty[nx % kStages], (nx / kStages - 1) & 1);
        load_tile(nx);
      }
    }
  } else {
    // ---------------- math warpgroups -----------------------------------
    // Phase A of tile it (S^T or dP^T over this chunk), then phase B of
    // tile it - 1 (dV or dK), so the exchange of tile it runs beside phase
    // B. Warps 0-3 compute S^T and dV, warps 4-7 dP^T and dK. Every inner
    // loop runs on an 8 x 8 register tile, so each word read from shared
    // memory feeds 8 FMAs (shared memory gives 32 words a clock, the FMA
    // units take 128).
    hopper::reg_alloc<kMathR>();
    const int half = warp / 4;
    const int w4 = warp % 4;
    // Phase A: KV rows l8 + 8i by q rows 8 w4 + i' (i, i' < 8) over the
    // 16-byte columns dq + 4j (j < 8) of the chunk, dq = lane / 8: the four
    // lanes of a tile take a quarter of the columns each and are summed by
    // shuffles. A quarter warp reads 8 KV rows of one column and one q
    // word.
    const int l8 = lane % 8;
    const int dq = lane / 8;
    // Phase B: KV rows kg + 8i (i < 8) by columns 4 dg + 64m + e (m < 2, e
    // < 4): a quarter warp reads one P^T word and 8 consecutive 16-byte
    // columns.
    const int dg = lane % 16;
    const int kg = 2 * w4 + lane / 16;
    float acc[8][2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.f;

    hopper::mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it <= n_it; ++it) {
      if (it < n_it) {
        const int s = it % kStages;
        const int buf = it & 1;
        hopper::mbar_wait(&sm.full[s], (it / kStages) & 1);
        // Every CTA's exchange warps are done with this buffer's tile.
        if (it >= 2)
          hopper::mbar_wait(&sm.parts_free[buf], ((it - 2) >> 1) & 1);
        // Step j reads 16-byte column g = dq + 4j: box j / 2, column dq +
        // 4 (j % 2) in it, at (dq + 4 (j % 2)) ^ l8 in K's and V's rows.
        const float* a0 = (half ? sm.v[0] : sm.k[0]) + l8 * kBox +
                          ((dq ^ l8) << 2);
        const float* a1 = (half ? sm.v[0] : sm.k[0]) + l8 * kBox +
                          ((dq ^ l8 ^ 4) << 2);
        const float* b0 =
            (half ? sm.dout[s][0] : sm.q[s][0]) + 8 * w4 * kBox + 4 * dq;
        float x[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) x[i][i2] = 0.f;
#pragma unroll 1
        for (int j = 0; j < kD / 16; ++j) {
          const float* ak = ((j & 1) ? a1 : a0) + (j >> 1) * kBKV * kBox;
          const float* bk = b0 + (j >> 1) * kBQ * kBox + (j & 1) * 16;
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
        // The four column quarters' sums: lanes 8 apart trade KV rows (each
        // keeps 4 of its 8), then lanes 16 apart trade q rows (each keeps
        // 4).
        const bool hi_kv = dq & 1, hi_q = dq & 2;
        float y[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) {
            const float keep = hi_kv ? x[i + 4][i2] : x[i][i2];
            const float give = hi_kv ? x[i][i2] : x[i + 4][i2];
            y[i][i2] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
          }
        float* out = sm.part[buf][half];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float z[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float keep = hi_q ? y[i][e + 4] : y[i][e];
            const float give = hi_q ? y[i][e] : y[i][e + 4];
            z[e] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
          }
          *reinterpret_cast<float4*>(
              out + swz32(l8 + 8 * (i + 4 * hi_kv), 2 * w4 + hi_q)) = f4(z);
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
        } else if (warp == it % kMathWarps) {
          hopper::named_bar_sync(1 + buf, 32 * kMathWarps);
          if (lane < kChunks)
            hopper::mbar_arrive_rank(&sm.parts_ready[buf], lane);
        } else {
          hopper::named_bar_arrive(1 + buf, 32 * kMathWarps);
        }
      }
      if (it >= 1) {
        // dV += P^T dO (warps 0-3) or dK += dS^T Q (4-7) over tile it - 1's
        // q rows, this chunk's columns.
        const int t = it - 1;
        const int s = t % kStages;
        const int buf = t & 1;
        if constexpr (kOne)
          hopper::mbar_wait(&sm.pd_ready[buf], (t >> 1) & 1);
        else
          hopper::mbar_wait_cluster(&sm.pd_ready[buf], (t >> 1) & 1);
        const float* Pm = sm.pd[buf][half] + kg * kBQ;
        // 16-byte column dg + 16m of a row: box dg / 8 + 2m, column dg % 8.
        const float* Bt = (half ? sm.q[s][0] : sm.dout[s][0]) +
                          (dg >> 3) * kBQ * kBox + 4 * (dg & 7);
#pragma unroll 2
        for (int qq = 0; qq < kBQ; qq += 4) {
          float4 w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = flash::ld4(Pm + 8 * i * kBQ + qq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float4 o =
                  flash::ld4(Bt + 2 * m * kBQ * kBox + (qq + e) * kBox);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
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
          if (lane == 0) hopper::mbar_arrive(&sm.pd_free[buf]);
        } else {
          if (lane < kChunks)
            hopper::mbar_signal_rank(&sm.pd_free[buf], lane);
        }
      }
    }

    float* out = static_cast<float*>(half ? p.out0 : p.out1);  // dK : dV
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = k0 + kg + 8 * i;
      if (row >= p.Skv) continue;
      float* o = out +
                 ((static_cast<long long>(b) * p.KVH + kvh) * p.Skv + row) *
                     kDW +
                 c * kD + 4 * dg;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        *reinterpret_cast<float4*>(o + 64 * m) = f4(acc[i][m]);
    }
  }
  // No CTA leaves while a peer may still touch its shared memory.
  if constexpr (!kOne) hopper::cluster_sync();
}

// f32 at D = 640: clusters of 5 CTAs.
__global__ void __cluster_dims__(5, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const flash::BwdParams p) {
  dkv_cluster<5>(tq, tk, tv, tdo, p);
}

// f32 at D = 1024: clusters of 8 CTAs, the largest portable cluster.
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_d1024_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                       const __grid_constant__ CUtensorMap tk,
                                       const __grid_constant__ CUtensorMap tv,
                                       const __grid_constant__ CUtensorMap tdo,
                                       const flash::BwdParams p) {
  dkv_cluster<8>(tq, tk, tv, tdo, p);
}

// f32 at D = 512: clusters of 4 CTAs. Each CTA's exchange owns 16 of the 64
// KV rows, 8 threads a row: every thread of it.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_d512_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const flash::BwdParams p) {
  dkv_cluster<4>(tq, tk, tv, tdo, p);
}

// f32 at D = 384: clusters of 3 CTAs. Each CTA's exchange owns 21 or 22 of
// the 64 KV rows in two row slots of 16.
__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_d384_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const flash::BwdParams p) {
  dkv_cluster<3>(tq, tk, tv, tdo, p);
}

// f32 at D = 256: clusters of 2 CTAs. Each CTA's exchange owns 32 of the 64
// KV rows in two full row slots of 16.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_d256_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const flash::BwdParams p) {
  dkv_cluster<2>(tq, tk, tv, tdo, p);
}

// f32 at D = 128: clusters of 1 CTA, which holds all of D. Its exchange owns
// all 64 KV rows in four full row slots of 16 and sums no peer's partials.
__global__ void __cluster_dims__(1, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_d128_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const flash::BwdParams p) {
  dkv_cluster<1>(tq, tk, tv, tdo, p);
}

}  // namespace f32c

// ---------------------------------------------------------------------------
// bf16 at D = 512, 640 and 1024: f32c's cluster (4, 5 or 8 CTAs per 64 KV
// rows, one per 128 columns of D, the scores summed through distributed
// shared memory) with each CTA's four products on the tensor cores (see the
// top of this file).
// ---------------------------------------------------------------------------

namespace bf16c {

using flash::kBoxBytes;  // 8 KB: a 64-row [row][64 col] bf16 box

constexpr int kBKV = 64;                // KV rows per cluster
constexpr int kBQ = 64;                 // q rows per tile
constexpr int kStages = 3;              // Q/dO ring depth
constexpr int kMathWarps = 8;           // two warpgroups: the products
constexpr int kXWarps = 4;              // one warpgroup: the exchange, loads
constexpr int kThreads = 32 * (kMathWarps + kXWarps);
constexpr uint32_t kTileBytes = 64 * kD * 2;  // a chunk of K, V, Q or dO

// K, V, Q and dO chunks as TMA writes them (two 128B-swizzled 64-column
// boxes each), P^T and dS^T as one such box each ([kv][q], K-major for
// the wgmma that reads them), the score partials in f32.
struct __align__(1024) Smem {
  bf16 k[2][kBKV * kHalf];
  bf16 v[2][kBKV * kHalf];
  bf16 q[kStages][2][kBQ * kHalf];
  bf16 dout[kStages][2][kBQ * kHalf];
  bf16 pd[2][2][kBKV * kBQ];      // [buffer][P^T, dS^T] over all of D
  float part[2][2][kBKV * kBQ];   // [buffer][S^T, dP^T] over this chunk
  float lse[kStages][kBQ];        // LSE * log2(e) of the tile's q rows
  float delta[kStages][kBQ];
  uint64_t kv_full;
  uint64_t full[kStages];     // Q, dO landed (TMA bytes); LSE, delta written
  uint64_t empty[kStages];    // this CTA's math warps are done with a stage
  uint64_t parts_ready[2];    // every CTA's math warps wrote part[buffer]
  uint64_t parts_free[2];     // every CTA's exchange warps read their slice
  uint64_t pd_ready[2];       // every CTA stored its slice of pd[buffer]
  uint64_t pd_free[2];        // every CTA's math warps are done with it
};

// + slack to align the base to 1024 bytes: 232,448 bytes, the whole 227 KB
// a block may opt in to.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

// The [kv][q] f32 partials and the bf16 boxes.
using flash::box_at;
using flash::swz64;
static_assert(kBQ == 64, "swz64's rows are 64 floats");

// The kernel over kChunks CTAs a cluster (D = kChunks kD), as f32c's; the
// kernels after it give the cluster's size as a literal.
template <int kChunks>
__device__ __forceinline__ void dkv_cluster(const CUtensorMap& tq,
                                            const CUtensorMap& tk,
                                            const CUtensorMap& tv,
                                            const CUtensorMap& tdo,
                                            const DkvArgs& p) {
  constexpr int kDW = kChunks * kD;  // head_dim
  // KV rows a CTA's exchange owns at most (22 of 3 CTAs, 16 of 4, 13 of 5, 8
  // of 8), 8 a slot
  constexpr int kSlots = ((kBKV + kChunks - 1) / kChunks + 7) / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Smem& sm =
      *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = static_cast<int>(hopper::cluster_ctarank());  // D chunk

  // Cluster -> (KV tile, b, KV head), the KV tile slowest, as in f32c.
  const int G = p.H / p.KVH;
  const int n_bk = gridDim.x / kChunks / p.n_kvt;  // B * KVH
  const int cl = blockIdx.x / kChunks;
  const int bk = cl % n_bk;
  const int kvt = cl / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int k0 = kvt * kBKV;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int qt_first = p.causal ? min(kvt, n_qt) : 0;  // kBKV == kBQ
  const int n_per = n_qt - qt_first;  // q tiles per query head
  const int n_it = G * n_per;
  auto head = [&](int it) { return kvh * G + it / n_per; };
  auto q_start = [&](int it) { return (n_qt - 1 - it % n_per) * kBQ; };

  if (tid == 0) {
    hopper::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1 + 32);  // TMA bytes + the loader
      hopper::mbar_init(&sm.empty[s], kMathWarps);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&sm.parts_ready[i], kChunks);
      hopper::mbar_init(&sm.parts_free[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.pd_ready[i], kChunks * kXWarps);
      hopper::mbar_init(&sm.pd_free[i], kChunks * kMathWarps);
    }
    hopper::fence_barrier_init();
  }
  // The barriers are set up, and every CTA of the cluster runs, before a
  // copy lands or a peer touches this CTA's shared memory.
  hopper::cluster_sync();

  if (warp >= kMathWarps) {
    // ---------------- exchange warpgroup --------------------------------
    // Its first warp loads: K and V once, then per tile Q and dO (TMA, two
    // boxes each; rows past Sq and Skv are zero-filled) and LSE * log2(e)
    // and delta (+inf and 0 past Sq: P and dS are 0 on such a q row), read
    // an iteration ahead into registers.
    const bool loader = warp == kMathWarps;
    float lse_next[2] = {0.f, 0.f}, delta_next[2] = {0.f, 0.f};
    auto fetch_rows = [&](int it) {
      const long long at =
          (static_cast<long long>(b) * p.H + head(it)) * p.Sq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q_start(it) + lane + 32 * i;
        lse_next[i] = r < p.Sq ? p.lse[at + r] * kLog2e : INFINITY;
        delta_next[i] = r < p.Sq ? p.delta[at + r] : 0.f;
      }
    };
    auto load_tile = [&](int it) {
      const int s = it % kStages;
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        for (int x = 0; x < 2; ++x) {
          hopper::tma_load_4d(sm.q[s][x], &tq, &sm.full[s],
                              c * kD + x * kHalf, q_start(it), head(it), b);
          hopper::tma_load_4d(sm.dout[s][x], &tdo, &sm.full[s],
                              c * kD + x * kHalf, q_start(it), head(it), b);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sm.lse[s][lane + 32 * i] = lse_next[i];
        sm.delta[s][lane + 32 * i] = delta_next[i];
      }
      hopper::mbar_arrive(&sm.full[s]);
    };
    if (loader) {
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.kv_full, 2 * kTileBytes);
        for (int x = 0; x < 2; ++x) {
          hopper::tma_load_4d(sm.k[x], &tk, &sm.kv_full, c * kD + x * kHalf,
                              k0, kvh, b);
          hopper::tma_load_4d(sm.v[x], &tv, &sm.kv_full, c * kD + x * kHalf,
                              k0, kvh, b);
        }
      }
      for (int it = 0; it < min(n_it, kStages - 1); ++it) {
        fetch_rows(it);
        load_tile(it);
      }
    }

    // This CTA's slice of the KV rows, [r0, r1) (21 or 22 of 3 CTAs, 16 of
    // 4, 12 or 13 of 5, 8 of 8): thread xt sums 16-byte column col4 (4 q
    // columns) of rows r0 + xt / 16 + 8 i (i < kSlots) over the kChunks
    // chunks, in chunk order from 0 in every CTA, forms P^T = exp(S^T scale
    // - LSE) and from that f32 P^T dS^T = P^T (dP^T - delta) scale, rounds
    // both to bf16 (where the Pallas kernel rounds them) and stores them
    // into every CTA's pd.
    const int xt = tid - 32 * kMathWarps;
    const int r0 = c * kBKV / kChunks;
    const int r1 = (c + 1) * kBKV / kChunks;
    const int col4 = xt % 16;
    int row[kSlots];
    bool mine[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      row[i] = r0 + xt / 16 + 8 * i;
      mine[i] = row[i] < r1;
    }
    for (int it = 0; it < n_it; ++it) {
      const int buf = it & 1;
      const int s = it % kStages;
      const int q0 = q_start(it);
      const int nx = it + kStages - 1;  // the tile the loader loads next
      if (loader && nx < n_it) fetch_rows(nx);
      hopper::mbar_wait_cluster(&sm.parts_ready[buf], (it >> 1) & 1);
      float4 st[kSlots], dpt[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        st[i] = dpt[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!mine[i]) continue;
        const uint32_t s_at =
            hopper::smem_u32(sm.part[buf][0] + swz64(row[i], col4));
        const uint32_t p_at =
            hopper::smem_u32(sm.part[buf][1] + swz64(row[i], col4));
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          const float4 x = hopper::ld_cluster_f4(hopper::map_rank(s_at, r));
          const float4 y = hopper::ld_cluster_f4(hopper::map_rank(p_at, r));
          st[i] = r == 0 ? x : flash::add4(st[i], x);
          dpt[i] = r == 0 ? y : flash::add4(dpt[i], y);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_signal_rank(&sm.parts_free[buf], lane);
      hopper::mbar_wait(&sm.full[s], (it / kStages) & 1);  // LSE, delta
      uint2 pw[kSlots], dw[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const float sv[4] = {st[i].x, st[i].y, st[i].z, st[i].w};
        const float dv[4] = {dpt[i].x, dpt[i].y, dpt[i].z, dpt[i].w};
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 4 * col4 + e;
          pr[e] = fast_exp2(fmaf(sv[e], p.scale_log2, -sm.lse[s][qi]));
          if (p.causal && q0 + qi < k0 + row[i]) pr[e] = 0.f;
          ds[e] = pr[e] * (dv[e] - sm.delta[s][qi]) * p.scale;
        }
        pw[i] = make_uint2(pack_bf16(pr[0], pr[1]), pack_bf16(pr[2], pr[3]));
        dw[i] = make_uint2(pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]));
      }
      // Every CTA's math warps are done with this buffer's tile before.
      if (it >= 2)
        hopper::mbar_wait(&sm.pd_free[buf], ((it - 2) >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        const uint32_t at = box_at(row[i], col4);
        const uint32_t p_at = hopper::smem_u32(sm.pd[buf][0]) + at;
        const uint32_t d_at = hopper::smem_u32(sm.pd[buf][1]) + at;
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          hopper::st_cluster_u2(hopper::map_rank(p_at, r), pw[i]);
          hopper::st_cluster_u2(hopper::map_rank(d_at, r), dw[i]);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_arrive_rank(&sm.pd_ready[buf], lane);
      // The tile two ahead goes into the stage of the one before this,
      // once this CTA's math warps are done with it.
      if (loader && nx < n_it) {
        if (nx >= kStages)
          hopper::mbar_wait(&sm.empty[nx % kStages], (nx / kStages - 1) & 1);
        load_tile(nx);
      }
    }
  } else {
    // ---------------- math warpgroups -----------------------------------
    // Warpgroup 0 computes S^T = K Q^T and dV += P^T dO, warpgroup 1 dP^T =
    // V dO^T and dK += dS^T Q, over this chunk: phase A of tile it, then
    // phase B of tile it - 1, so the exchange of tile it runs beside phase
    // B. S^T and dP^T are wgmma.m64n64k16 with both operands K-major (8
    // k-steps, 32 f32 registers); dV and dK are wgmma.m64n128k16 with A =
    // P^T or dS^T from pd and B = dO or Q MN-major through the transpose bit
    // (flash::mma_t, 4 k-steps), 64 f32 registers for the whole loop.
    const int half = warp / 4;
    const int w4 = warp % 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float sc[32];
    const uint32_t a_base = hopper::smem_u32(half ? sm.v[0] : sm.k[0]);

    hopper::mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it <= n_it; ++it) {
      if (it < n_it) {
        const int s = it % kStages;
        const int buf = it & 1;
        hopper::mbar_wait(&sm.full[s], (it / kStages) & 1);
        // Every CTA's exchange warps are done with this buffer's tile.
        if (it >= 2)
          hopper::mbar_wait(&sm.parts_free[buf], ((it - 2) >> 1) & 1);
        flash::issue_abt<kBQ>(
            sc, a_base, kBoxBytes,
            hopper::smem_u32(half ? sm.dout[s][0] : sm.q[s][0]), kBoxBytes);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(sc[i]);
        // sc[4j + 2a + e]: KV row 16 w4 + lane / 4 + 8a, q column 8j +
        // 2 (lane % 4) + e, into 16-byte column 2j + (lane % 4) / 2.
        float* out = sm.part[buf][half];
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int r = 16 * w4 + lane / 4 + 8 * a;
            *reinterpret_cast<float2*>(out + swz64(r, 2 * j + (lane % 4) / 2) +
                                       2 * (lane & 1)) =
                make_float2(sc[4 * j + 2 * a], sc[4 * j + 2 * a + 1]);
          }
        // One warp, another each tile, releases the partials to every CTA
        // once all eight warps have stored theirs, as in f32c.
        if (warp == it % kMathWarps) {
          hopper::named_bar_sync(1 + buf, 32 * kMathWarps);
          if (lane < kChunks)
            hopper::mbar_arrive_rank(&sm.parts_ready[buf], lane);
        } else {
          hopper::named_bar_arrive(1 + buf, 32 * kMathWarps);
        }
      }
      if (it >= 1) {
        // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1) over tile it -
        // 1's q rows, this chunk's columns.
        const int t = it - 1;
        const int s = t % kStages;
        const int buf = t & 1;
        hopper::mbar_wait_cluster(&sm.pd_ready[buf], (t >> 1) & 1);
        hopper::fence_proxy_async_cluster();  // peers' stores, then wgmma
        hopper::wgmma_fence();
        flash::mma_t(acc, hopper::smem_u32(sm.pd[buf][half]),
                     hopper::smem_u32(half ? sm.q[s][0] : sm.dout[s][0]));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) hopper::fence_reg(acc[i]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
        if (lane < kChunks) hopper::mbar_signal_rank(&sm.pd_free[buf], lane);
      }
    }

    // acc[4j + 2a + e]: KV row k0 + 16 w4 + lane / 4 + 8a, column c kD +
    // 8j + 2 (lane % 4) + e.
    bf16* out = half ? p.dk : p.dv;
    const long long row0 =
        (static_cast<long long>(b) * p.KVH + kvh) * p.Skv + k0;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = 16 * w4 + lane / 4 + 8 * a;
      if (k0 + r >= p.Skv) continue;
      bf16* o = out + (row0 + r) * kDW + c * kD + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) =
            pack_bf16(acc[4 * j + 2 * a], acc[4 * j + 2 * a + 1]);
    }
  }
  // No CTA leaves while a peer may still touch its shared memory.
  hopper::cluster_sync();
}

// bf16 at D = 640: clusters of 5 CTAs.
__global__ void __cluster_dims__(5, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const DkvArgs p) {
  dkv_cluster<5>(tq, tk, tv, tdo, p);
}

// bf16 at D = 1024: clusters of 8 CTAs, the largest portable cluster.
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_d1024_cluster_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const DkvArgs p) {
  dkv_cluster<8>(tq, tk, tv, tdo, p);
}

// bf16 at D = 512: clusters of 4 CTAs. Each CTA's exchange owns 16 of the 64
// KV rows, 16 lanes a row, in two row slots.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_d512_cluster_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const DkvArgs p) {
  dkv_cluster<4>(tq, tk, tv, tdo, p);
}

// bf16 at D = 384: clusters of 3 CTAs. Each CTA's exchange owns 21 or 22 of
// the 64 KV rows, 16 lanes a row, in three row slots.
__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_d384_cluster_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const DkvArgs p) {
  dkv_cluster<3>(tq, tk, tv, tdo, p);
}

}  // namespace bf16c

// ---------------------------------------------------------------------------
// Generic variant: every dtype and head_dim (a multiple of 128) above 512
// but 640 and 1024; the kernels above serve those.
// The same function on the CUDA cores: one block of 128 threads per (b, KV
// head, 16 KV rows, chunk of D), walking the group's query heads and their
// 32-row q tiles as the wgmma kernels do, with K, V, Q, dO as f32 tiles in
// dynamic shared memory (104 KB at DC = 256). D is cut into chunks of DC =
// 256 or 128 columns (flash::gen_chunk; the chunked instances): each block
// writes one
// chunk of dK and dV, and the contractions over D (S^T = K Q^T and dP^T = V
// dO^T) are summed over the chunks staged one at a time, in the order that ends
// with the block's own chunk, so Q's and dO's columns for dK and dV are the
// ones left in shared memory. With more than one chunk K and V are reloaded per
// chunk and every block recomputes the scores (D / DC times their work; right
// and slow first). Each thread holds 4 entries of P^T and dS^T (KV row tid / 8,
// q columns tid % 8 + 8i; P rounded to v's dtype, dS to q's) and an eighth of
// its KV row's dK and dV chunk as interleaved float4s, in f32 registers for the
// whole loop, so the group's query heads are summed in f32 with no atomics.
// Bound by shared-memory reads, not by the FMA rate; simple first.
// ---------------------------------------------------------------------------

constexpr int kGBKV = 16;  // KV rows per block, 8 threads per row
constexpr int kGBQ = 32;   // q rows per tile

template <int DC>
constexpr int gen_smem_bytes() {
  return ((2 * kGBKV + 2 * kGBQ) * (DC + 4) + 2 * kGBKV * (kGBQ + 1) +
          2 * kGBQ) * 4;
}

// p by value: the body taking the kernel's parameters by reference compiled
// the one-chunk instance at f32 D128 (a cluster kernel's now) to code 1.10x
// slower on the H100.
template <typename T, int DC, bool kChunked>
__device__ __forceinline__ void flash_bwd_dkv_generic_body(
    const flash::BwdParams p) {
  extern __shared__ float4 gen_smem[];
  constexpr int kP = DC + 4;      // row pitch of the f32 tiles
  constexpr int kPT = kGBQ + 1;   // row pitch of P^T and dS^T
  float* Ks = reinterpret_cast<float*>(gen_smem);
  float* Vs = Ks + kGBKV * kP;
  float* Qs = Vs + kGBKV * kP;
  float* Os = Qs + kGBQ * kP;  // dO
  float* Pt = Os + kGBQ * kP;
  float* St = Pt + kGBKV * kPT;
  float* Ls = St + kGBKV * kPT;
  float* Ds = Ls + kGBQ;

  const int tid = threadIdx.x;
  const int kr = tid / 8;  // KV row of the tile
  const int cc = tid % 8;
  // Block -> (KV tile, b, KV head), the KV tile slowest: causal, the first
  // KV tiles see the most q tiles, so they start first. blockIdx.y is the
  // chunk of D.
  const int n_kvt = (p.Skv + kGBKV - 1) / kGBKV;
  const int n_bk = gridDim.x / n_kvt;  // B * KVH
  const int bk = blockIdx.x % n_bk;
  const int kvt = blockIdx.x / n_bk;
  const int n_dc = kChunked ? gridDim.y : 1;
  const int oc = kChunked ? blockIdx.y : 0;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int G = p.H / p.KVH;
  const int k0 = kvt * kGBKV;
  const int krow = k0 + kr;
  const int n_qt = (p.Sq + kGBQ - 1) / kGBQ;
  // Causal: q tiles wholly before this KV tile see none of it.
  const int qt_first = p.causal ? min(k0 / kGBQ, n_qt) : 0;

  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  if (n_dc == 1) {
    flash::load_tile<T, DC>(Ks, K, p.k_ss, k0, kGBKV, p.Skv, tid, 128);
    flash::load_tile<T, DC>(Vs, V, p.v_ss, k0, kGBKV, p.Skv, tid, 128);
  }

  float dk[DC / 8], dv[DC / 8];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) dk[i] = dv[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kGBQ;
      // S^T and dP^T entries (krow, q0 + cc + 8i)
      float4 s4[kGBQ / 8], p4[kGBQ / 8];
#pragma unroll
      for (int i = 0; i < kGBQ / 8; ++i)
        s4[i] = p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int ci = 0; ci < n_dc; ++ci) {
        const int dc = (oc + 1 + ci) % n_dc;  // ends with the block's chunk
        __syncthreads();  // K, V stored / the last chunk's readers are done
        if (n_dc > 1) {
          flash::load_tile<T, DC>(Ks, K + dc * DC, p.k_ss, k0, kGBKV, p.Skv,
                                  tid, 128);
          flash::load_tile<T, DC>(Vs, V + dc * DC, p.v_ss, k0, kGBKV, p.Skv,
                                  tid, 128);
        }
        flash::load_tile<T, DC>(Qs, Q + dc * DC, p.q_ss, q0, kGBQ, p.Sq, tid,
                                128);
        flash::load_tile<T, DC>(Os, dO + dc * DC, p.o_ss, q0, kGBQ, p.Sq, tid,
                                128);
        if (ci == 0) {
          for (int j = tid; j < kGBQ; j += 128) {  // +inf / 0 past Sq: P = 0
            const int r = q0 + j;
            Ls[j] = r < p.Sq ? p.lse[row0 + r] : INFINITY;
            Ds[j] = r < p.Sq ? p.delta[row0 + r] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int d = 0; d < DC; d += 4) {
          const float4 k4 = flash::ld4(Ks + kr * kP + d);
          const float4 v4 = flash::ld4(Vs + kr * kP + d);
#pragma unroll
          for (int i = 0; i < kGBQ / 8; ++i) {
            const int j = cc + 8 * i;
            flash::fma4(s4[i], k4, flash::ld4(Qs + j * kP + d));
            flash::fma4(p4[i], v4, flash::ld4(Os + j * kP + d));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGBQ / 8; ++i) {
        const int j = cc + 8 * i;
        float x = flash::hsum(s4[i]) * p.scale;
        if (krow >= p.Skv || (p.causal && q0 + j < krow))
          x = flash::kMaskValue;
        const float pr = expf(x - Ls[j]);
        const float ds = (flash::hsum(p4[i]) - Ds[j]) * pr * p.scale;
        Pt[kr * kPT + j] = flash::Elem<T>::round(pr);
        St[kr * kPT + j] = flash::Elem<T>::round(ds);
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's q rows (the chunk's
      // columns)
#pragma unroll 4
      for (int j = 0; j < kGBQ; ++j) {
        const float pj = Pt[kr * kPT + j];
        const float sj = St[kr * kPT + j];
#pragma unroll
        for (int q = 0; q < DC / 32; ++q) {
          const int col = 4 * (cc + 8 * q);
          const float4 o4 = flash::ld4(Os + j * kP + col);
          const float4 q4 = flash::ld4(Qs + j * kP + col);
          dv[4 * q] = fmaf(pj, o4.x, dv[4 * q]);
          dv[4 * q + 1] = fmaf(pj, o4.y, dv[4 * q + 1]);
          dv[4 * q + 2] = fmaf(pj, o4.z, dv[4 * q + 2]);
          dv[4 * q + 3] = fmaf(pj, o4.w, dv[4 * q + 3]);
          dk[4 * q] = fmaf(sj, q4.x, dk[4 * q]);
          dk[4 * q + 1] = fmaf(sj, q4.y, dk[4 * q + 1]);
          dk[4 * q + 2] = fmaf(sj, q4.z, dk[4 * q + 2]);
          dk[4 * q + 3] = fmaf(sj, q4.w, dk[4 * q + 3]);
        }
      }
    }
  }

  if (krow < p.Skv) {
    const long long o =
        ((static_cast<long long>(b) * p.KVH + kvh) * p.Skv + krow) *
            (DC * n_dc) + oc * DC;
    T* dK = static_cast<T*>(p.out0) + o;
    T* dV = static_cast<T*>(p.out1) + o;
#pragma unroll
    for (int q = 0; q < DC / 32; ++q) {
      const int col = 4 * (cc + 8 * q);
      flash::Elem<T>::store4(dK + col, make_float4(dk[4 * q], dk[4 * q + 1],
                                                   dk[4 * q + 2],
                                                   dk[4 * q + 3]));
      flash::Elem<T>::store4(dV + col, make_float4(dv[4 * q], dv[4 * q + 1],
                                                   dv[4 * q + 2],
                                                   dv[4 * q + 3]));
    }
  }
}

// One block per (KV tile, b, KV head, chunk of D): D above 4 kD.
template <typename T, int DC>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dkv_generic_chunked_kernel(const flash::BwdParams p) {
  flash_bwd_dkv_generic_body<T, DC, true>(p);
}

template <typename T, int DC>
int launch_generic(const flash::BwdParams& p, int D, int B, cudaStream_t st) {
  constexpr int smem = gen_smem_bytes<DC>();
  void (*kernel)(const flash::BwdParams) =
      flash_bwd_dkv_generic_chunked_kernel<T, DC>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kvt = (p.Skv + kGBKV - 1) / kGBKV;
  dim3 grid(B * p.KVH * n_kvt, D / DC);
  kernel<<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Picks the generic instance by D (a multiple of kD, checked by the caller)
// and dtype: above 4 kD a chunk of flash::gen_chunk(D) columns (D = 5 kD and
// 8 kD are the cluster kernels'). No generic instance takes D up to 4 kD
// (bf16 at kD and 2 kD is the wgmma kernels', f32 at kD and 2 kD and both at
// 3 kD and 4 kD the cluster kernels'): cudaErrorInvalidValue.
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

// f32 at D = kChunks kD (1, 2, 3, 4, 5 or 8): one cluster of kChunks CTAs per
// 64 KV rows, on `kernel`, the instance of that size. A launch the card refuses
// (no room for a cluster) returns its error. The shared-memory opt-in is set
// at every launch, as for the generic variants.
template <int kChunks, typename Kernel>
int launch_cluster(Kernel kernel, const flash::BwdParams& p, int B,
                   cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  constexpr int D = kChunks * kD;
  if (!flash::make_f32_map(&tq, p.q, B, p.H, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                           f32c::kBQ, D, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !flash::make_f32_map(&tk, p.k, B, p.KVH, p.Skv, p.k_sb, p.k_sh,
                           p.k_ss, f32c::kBKV, D,
                           CU_TENSOR_MAP_SWIZZLE_128B) ||
      !flash::make_f32_map(&tv, p.v, B, p.KVH, p.Skv, p.v_sb, p.v_sh,
                           p.v_ss, f32c::kBKV, D,
                           CU_TENSOR_MAP_SWIZZLE_128B) ||
      !flash::make_f32_map(&tdo, p.dout, B, p.H, p.Sq, p.o_sb, p.o_sh,
                           p.o_ss, f32c::kBQ, D, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = flash::allow_smem(kernel, f32c::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kvt = (p.Skv + f32c::kBKV - 1) / f32c::kBKV;
  kernel<<<B * p.KVH * n_kvt * kChunks, f32c::kThreads, f32c::kSmemBytes,
           st>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D = kChunks kD (3, 4, 5 or 8): one cluster of kChunks CTAs per 64 KV
// rows, on `kernel`, the instance of that size, with 128B-swizzled
// 64-column boxes of every input. A launch the card refuses returns its
// error.
template <int kChunks, typename Kernel>
int launch_bf16_cluster(Kernel kernel, const flash::BwdParams& p, int B,
                        cudaStream_t st) {
  constexpr int D = kChunks * kD;
  CUtensorMap tq, tk, tv, tdo;
  if (!flash::make_bhsd_map(&tq, p.q, B, p.H, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                            bf16c::kBQ, D) ||
      !flash::make_bhsd_map(&tk, p.k, B, p.KVH, p.Skv, p.k_sb, p.k_sh,
                            p.k_ss, bf16c::kBKV, D) ||
      !flash::make_bhsd_map(&tv, p.v, B, p.KVH, p.Skv, p.v_sb, p.v_sh,
                            p.v_ss, bf16c::kBKV, D) ||
      !flash::make_bhsd_map(&tdo, p.dout, B, p.H, p.Sq, p.o_sb, p.o_sh,
                            p.o_ss, bf16c::kBQ, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = flash::allow_smem(kernel, bf16c::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kvt = (p.Skv + bf16c::kBKV - 1) / bf16c::kBKV;
  const DkvArgs a{p.lse, p.delta, static_cast<bf16*>(p.out0),
                  static_cast<bf16*>(p.out1), p.H, p.KVH, p.Sq, p.Skv, n_kvt,
                  p.scale * kLog2e, p.scale, p.causal};
  kernel<<<B * p.KVH * n_kvt * kChunks, bf16c::kThreads, bf16c::kSmemBytes,
           st>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of the f32 D = 640 kernel the current device holds at
// once (cudaOccupancyMaxActiveClusters at its shared memory), into
// *clusters. Returns the CUDA error.
extern "C" int ray_flash_bwd_dkv_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dkv_f32_cluster_kernel, 5,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 1024 kernel (clusters of 8).
extern "C" int ray_flash_bwd_dkv_f32_d1024_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dkv_f32_d1024_cluster_kernel, 8,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 512 kernel (clusters of 4).
extern "C" int ray_flash_bwd_dkv_f32_d512_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dkv_f32_d512_cluster_kernel, 4,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 384 kernel (clusters of 3).
extern "C" int ray_flash_bwd_dkv_f32_d384_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dkv_f32_d384_cluster_kernel, 3,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 256 kernel (clusters of 2).
extern "C" int ray_flash_bwd_dkv_f32_d256_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dkv_f32_d256_cluster_kernel, 2,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 128 kernel (clusters of 1).
extern "C" int ray_flash_bwd_dkv_f32_d128_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_bwd_dkv_f32_d128_cluster_kernel, 1,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the bf16 D = 640 kernel (clusters of 5).
extern "C" int ray_flash_bwd_dkv_bf16_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dkv_bf16_cluster_kernel, 5,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 1024 kernel (clusters of 8).
extern "C" int ray_flash_bwd_dkv_bf16_d1024_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dkv_bf16_d1024_cluster_kernel,
                             8, bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 512 kernel (clusters of 4).
extern "C" int ray_flash_bwd_dkv_bf16_d512_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dkv_bf16_d512_cluster_kernel,
                             4, bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 384 kernel (clusters of 3).
extern "C" int ray_flash_bwd_dkv_bf16_d384_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_bwd_dkv_bf16_d384_cluster_kernel,
                             3, bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// q/dO [B, H, Sq, D] and k/v [B, KVH, Skv, D] given by element strides (batch,
// head, seq; the last dim dense, every stride and base address a multiple of 16
// bytes, as TMA and the 16-byte loads require); lse and delta [B, H, Sq] f32
// and dk/dv [B, KVH, Skv, D] dense, in the inputs' dtype. D is a multiple of
// 128; dtype: 0 = float32, 1 = bfloat16. bf16 at D = 128 and 256 runs a wgmma
// kernel, f32 at D = 128 a cluster kernel of 1 CTA, at D = 256 one of 2 CTAs,
// D = 384 one of 3, D = 512 one of 4, D = 640 one of 5 and D = 1024 one of 8
// (f32 or bf16), every other case (from D = 768 up) the generic variant.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape or layout the kernels do not take).
extern "C" int ray_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long q_sb,
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
        static_cast<const float*>(delta), dk, dv,
        q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        o_sb, o_sh, o_ss, H,    KVH,  Sq,   Skv,  scale, causal};
    if (dtype == 0 && D == kD)
      return launch_cluster<1>(f32c::flash_bwd_dkv_f32_d128_cluster_kernel,
                               p, B, st);
    if (dtype == 0 && D == 2 * kD)
      return launch_cluster<2>(f32c::flash_bwd_dkv_f32_d256_cluster_kernel,
                               p, B, st);
    if (dtype == 0 && D == 3 * kD)
      return launch_cluster<3>(f32c::flash_bwd_dkv_f32_d384_cluster_kernel,
                               p, B, st);
    if (dtype == 0 && D == 4 * kD)
      return launch_cluster<4>(f32c::flash_bwd_dkv_f32_d512_cluster_kernel,
                               p, B, st);
    if (dtype == 0 && D == 5 * kD)
      return launch_cluster<5>(f32c::flash_bwd_dkv_f32_cluster_kernel, p, B,
                               st);
    if (dtype == 0 && D == 8 * kD)
      return launch_cluster<8>(f32c::flash_bwd_dkv_f32_d1024_cluster_kernel,
                               p, B, st);
    if (D == 3 * kD)
      return launch_bf16_cluster<3>(
          bf16c::flash_bwd_dkv_bf16_d384_cluster_kernel, p, B, st);
    if (D == 4 * kD)
      return launch_bf16_cluster<4>(
          bf16c::flash_bwd_dkv_bf16_d512_cluster_kernel, p, B, st);
    if (D == 5 * kD)
      return launch_bf16_cluster<5>(bf16c::flash_bwd_dkv_bf16_cluster_kernel,
                                    p, B, st);
    if (D == 8 * kD)
      return launch_bf16_cluster<8>(
          bf16c::flash_bwd_dkv_bf16_d1024_cluster_kernel, p, B, st);
    return launch_generic_d(p, D, dtype, B, st);
  }
  // bf16 at D = 128 (128 KV rows a block) or 256 (64)
  const bool wide = D == 2 * kD;
  const int bkv = wide ? d256::kBKV : kBKV;
  const uint32_t bq = wide ? d256::kBQ : kBQ;
  CUtensorMap tq, tk, tv, tdo;
  if (!flash::make_bhsd_map(&tq, q, B, H, Sq, q_sb, q_sh, q_ss, bq, D) ||
      !flash::make_bhsd_map(&tk, k, B, KVH, Skv, k_sb, k_sh, k_ss, bkv, D) ||
      !flash::make_bhsd_map(&tv, v, B, KVH, Skv, v_sb, v_sh, v_ss, bkv, D) ||
      !flash::make_bhsd_map(&tdo, dout, B, H, Sq, o_sb, o_sh, o_ss, bq, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_kvt = (Skv + bkv - 1) / bkv;
  const DkvArgs a{static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv),
                  H, KVH, Sq, Skv, n_kvt,
                  scale * kLog2e, scale, causal};
  const dim3 grid(B * KVH * n_kvt), block(128 * (1 + kConsumers));
  if (wide) {
    const cudaError_t err = hopper::opt_in_smem<2 * kD>(
        d256::flash_bwd_dkv_d256_kernel, d256::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    d256::flash_bwd_dkv_d256_kernel<<<grid, block, d256::kSmemBytes, st>>>(
        tq, tk, tv, tdo, a);
  } else {
    const cudaError_t err =
        hopper::opt_in_smem<kD>(flash_bwd_dkv_kernel, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_kernel<<<grid, block, kSmemBytes, st>>>(tq, tk, tv, tdo,
                                                          a);
  }
  return static_cast<int>(cudaGetLastError());
}
