// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`, launched by
// `_flash_fwd_pallas` (ray_tpu/ops/attention.py:84-179). It computes the
// same function: O = softmax(q k^T * scale [causal mask]) v with an online
// softmax, O = acc / max(l, 1e-30) in the input dtype and LSE = m +
// log(max(l, 1e-30)) in f32, masked scores set to -0.7 * FLT_MAX as the TPU
// kernel does.
//
// What bounds it on the H100, and what the design does about it:
//   * Long prompts (causal FLOPs 2*S^2*D*H grow as S^2) are bound by the
//     tensor cores, which reach their full rate only through wgmma fed
//     without stalls. Each block owns 128 q rows of one (b, h) and has
//     three warpgroups: a producer, which gives its registers away
//     (setmaxnreg.dec to 24) and in which one thread issues TMA loads, and
//     two consumers of 64 q rows each (setmaxnreg.inc to 240). Q (128 x 128
//     bf16) is loaded once; K and V tiles of 128 rows go through a ring of
//     2 stages in shared memory. Each stage has `full` mbarriers (TMA
//     transaction bytes) for K and for V and `empty` mbarriers that the 8
//     consumer warps arrive at, K's as soon as S = Q K^T is done, V's after
//     O += P V, so the next tiles are in flight while the current ones are
//     used. S = Q K^T is 8 wgmma.m64n128k16 with both operands in shared
//     memory (K-major); O += P V takes P from registers (the S accumulator
//     re-packed to bf16) and V from shared memory through the transpose bit
//     (MN-major).
//   * The softmax (exp2 on the SFU, row max and sum) would leave the tensor
//     cores idle. Inside each consumer, S of tile kt is issued before
//     O += P V of tile kt - 1, so that product runs under the softmax of
//     tile kt; between the consumers, named barriers make them take turns
//     issuing (ping-pong), so one's softmax runs under the other's wgmmas.
//     Scores stay raw in the unmasked tiles: P = 2^(s * scale * log2 e - m)
//     is one FFMA and one MUFU.EX2 per score.
//   * Causal KV tiles wholly above the diagonal are never loaded, so causal
//     work is half of the square; only the diagonal tile and a ragged last
//     tile are masked (the TPU kernel's visible/full classes).
//   * Short prompts (the 32..512 token buckets) are bound by bytes and by
//     launch latency: q, k, v and o cross device memory once; m, l and O
//     stay in registers for the whole KV loop.
//   * The TPU kernel's sequential "arbitrary" grid axis and its VMEM
//     scratch become the KV loop inside one block: blocks run in parallel
//     and in no order on 132 SMs, so nothing may carry over between them.
//     Blocks are ordered by KV head, then heaviest causal q tile first,
//     and the H / KVH q heads that share one KV head run next to each
//     other, so they read its K and V from L2.
//   * Grouped-query attention reads KV head h / (H / KVH) in place; the
//     caller never materializes repeat_kv copies.
//   * No 128-multiple gate: TMA zero-fills rows past Sq / Skv, the column
//     mask covers the ragged KV edge and the stores are guarded by row <
//     Sq, so every prefill bucket (32, 64, ...) runs through the kernel.
//   * The tensor maps are 4-D {D, S, heads, batch} built from the element
//     strides the caller passes, so q/k from apply_rope (dense BHSD) and v
//     as the transpose of a [B, S, KVH, D] view load without a copy.
// bf16 at head_dim 256 (llama3_8b(n_heads=16): d_model / n_heads) runs the
// same kernel as flash_fwd_bf16_kernel<256, 64>:
//   * It is bound by the tensor cores as at 128 (4 * B * H * D * pairs FLOP,
//     the same as H32 D128 at equal d_model), and now by registers too: O
//     of 64 q rows x 256 columns is 128 f32 registers per consumer thread
//     (two m64n128 accumulators). So KV tiles are 64 rows: S (32 registers)
//     and P packed (16) fit beside O under setmaxnreg 240 with no spill,
//     where a 128-row tile would add 64 + 32.
//   * Shared memory: Q (128 x 256, four 64-column boxes, 64 KB) and a
//     2-stage ring of 64-row K and V tiles (32 KB each): 194 KB of the 227.
//   * S = Q K^T is 16 wgmma.m64n64k16 with both operands in shared memory;
//     at N = 64 they read 4 KB per 32 tensor-core cycles, shared memory's
//     whole 128 B a cycle (N = 128 at D = 128 reads 96), so S is where this
//     instance loses rate. O += P V is two wgmma.m64n128k16 per k-step, P
//     from registers, V read MN-major by 128-column halves (LBO one box).
//   * The rest is the D = 128 design: ping-pong, S of tile kt before P V of
//     tile kt - 1, causal tiles above the diagonal never loaded, GQA in
//     place, any S. With 64-row tiles the block's last causal tile lies
//     wholly above consumer 0's rows: it runs that tile masked to zeros
//     (turns stay balanced), 1 / (2 (qt + 1)) of its work.
// f32 at head_dim 256, 384, 512, 640 and 1024 runs
// flash_fwd_f32_d256_cluster_kernel, flash_fwd_f32_d384_cluster_kernel,
// flash_fwd_f32_d512_cluster_kernel, flash_fwd_f32_cluster_kernel and
// flash_fwd_f32_d1024_cluster_kernel (after it), one body at 2, 3, 4, 5 and 8
// CTAs (fwd_cluster<kChunks>): the f32 dK/dV's cluster (flash_bwd_dkv.cu)
// carried over to the forward, which has no dP. The generic instances they
// replace computed S over all of D in each block (in each of their 5 or 4
// chunk blocks above 512) and read one shared-memory word per 1 to 4 FMAs.
// These kernels are bound by the FMA units: f32 has no exact tensor-core
// input (TF32 rounds, and the f32 forward is held to 1e-5), 2 products of
// 128 x 32 x D FMAs per (q, KV) tile pair.
//   * One cluster of D / 128 CTAs (2, 3, 4, 5 or 8; 8 is the largest
//     portable cluster) per (b, head, 128 q rows), one CTA per 128-column
//     chunk of D, the heaviest causal q tiles first. A CTA loads its chunk
//     of Q once (f32 TMA boxes of 32 columns, 128B-swizzled since it is read
//     down 8 rows of one column at once) and streams its chunk of K and V of
//     the KV head per 32-row tile through a 3-stage ring.
//   * The product over D is split across the cluster, not repeated: each CTA
//     computes S (128 x 32) over its own 128 columns into its shared memory.
//     The exchange warpgroup owns 128 / (D / 128) of the q rows (64 at
//     D256, 42 or 43 at D384, 32 at D512, 25 or 26 at D640, 16 at D1024) for
//     the whole loop, in row slots of 16 rows (four at D256, three at D384,
//     two otherwise): it sums their partials over the chunks through
//     distributed shared memory in chunk order from 0, scales and masks
//     them, keeps each row's running max m and sum l, and stores P = exp(S -
//     m) (f32: nothing rounds) and the row's correction exp(m_old - m_new)
//     into every CTA. O = O corr + P V follows, O (64 f32 a thread) in
//     registers for the whole loop; at the end the owners store l into every
//     CTA and write LSE = m + log(l).
//   * Roles, hand-overs and 8 x 8 register tiles as in that dK/dV: two math
//     warpgroups (S of tile t, then O of tile t - 1) and one exchange and
//     load warpgroup. The exchange does not bound it at D640: on the card,
//     keeping its loads or its stores within the CTA left its time as it was.
//   * 232,448 bytes of shared memory: one CTA an SM, 66 clusters of 2, 39 of
//     3, 30 of 4, 22 of 5 or 15 of 8 at once.
// bf16 at head_dim 640 runs flash_fwd_bf16_cluster_kernel (after those):
// the f32 forward's cluster with each CTA's two products on the tensor
// cores, as the bf16 dK/dV's cluster (flash_bwd_dkv.cu bf16c) runs its four.
// The generic chunked instance it replaces did scalar FMAs and computed S
// over all of D in each of its 5 chunk blocks. On wgmma the products are a
// small share of the work; what the design has to hide is the exchange (one
// f32 partial of 128 x 64 a tile pair, summed over the 5 CTAs through
// distributed shared memory) and the hand-overs between the roles.
//   * One cluster of 5 CTAs per (b, head, 128 q rows), one CTA per 128
//     columns of D, the heaviest causal q tiles first, KV tiles above the
//     diagonal never loaded, GQA in place. A CTA loads its chunk of Q once
//     and streams its chunk of K and V per 64-row tile through a 3-stage
//     ring, all as 128B-swizzled 64-column TMA boxes.
//   * Each math warpgroup owns 64 q rows: S = Q_c K_c^T is
//     wgmma.m64n64k16 with both operands K-major (32 f32 registers), and O_c
//     = O_c corr + P V_c is wgmma.m64n128k16 with A = its 64 rows of the P
//     box and B = V read MN-major (flash::mma_t), O_c in 64 f32 registers
//     for the whole loop.
//   * The exchange warpgroup owns 25 or 26 of the 128 q rows for the whole
//     loop (16 lanes a row): it sums their S partials over the 5 CTAs in
//     chunk order from 0, scales them to log2 units, masks KV columns past
//     Skv by hand (TMA zero-fills K, so S = 0 there and 2^(0 - m) would
//     not be 0) and after the row, keeps m and l per row and stores P =
//     2^(S - m_new) rounded to bf16 (the Pallas kernel's cast to V's dtype;
//     l sums it unrounded) as a swizzled [q][kv] box, and the row's
//     correction, into every CTA. At the end the owners store l into every
//     CTA and write LSE = m ln 2 + log(l).
//   * Roles and hand-overs as in the f32 forward: phase A of tile t, then
//     phase B of tile t - 1, through mbarriers the peers arrive at, with
//     double buffers; the reader of P fences the async proxy after its
//     acquire of the peers' stores.
//   * Shared memory: Q 32 KB, the ring 96 KB, P 2 x 16 KB, the partials 2
//     x 32 KB, the rows' corrections and sums: 232,448 bytes with the
//     alignment slack, the whole opt-in (a 2-stage ring would free 32 KB).
// bf16 at 1024, 512 and 384 runs the same kernel at 8, 4 and 3 CTAs a
// cluster (flash_fwd_bf16_d1024_cluster_kernel,
// flash_fwd_bf16_d512_cluster_kernel, flash_fwd_bf16_d384_cluster_kernel),
// as f32 does: the body is a template over the chunk count
// (fwd_cluster<kChunks>), each instance gives its cluster's size as a
// literal, and each CTA keeps its 128 columns, so the shared memory is the
// 5-CTA one's. At 8 CTAs each CTA's exchange owns 16 of the 128 q rows (one
// row a 16-lane group, every lane used) and sums 8 partials a row in place
// of 5; at 4 it owns 32 rows in four full row slots and sums 4 partials a
// row; at 3 it owns 42 or 43 rows in six row slots of 8 (the sixth 2 or 3
// rows full) and sums 3 partials a row. They replace the generic instance of
// 256-column chunks, which computed S over all of D in each of its 4 chunk
// blocks, and the one-chunk generic instances at 384 and 512, which ran both
// products as scalar FMAs.
// A generic scalar-FMA variant serves f32 at 128 and from 768 up but 1024
// and bf16 from 768 up but 1024, tiled over
// D from 768 up: its instance of 256-column chunks serves D768, 1280, ...,
// that of 128-column chunks D896, 1152, ...

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::fast_exp2;
using flash::kConsumerRegs;
using flash::kD;
using flash::kHalf;
using flash::kLog2e;
using flash::kMaskValue;
using flash::kProducerRegs;
using flash::pack_bf16;
using flash::release;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim is dense
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int H, KVH, Sq, Skv;
  float scale;
  int causal;
};

// Number of KV tiles a q tile starting at q0 must visit (causal skipping:
// tiles wholly above the diagonal are never loaded).
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int bm,
                                        int bn) {
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(p.Skv, q0 + bm);
  return (kv_end + bn - 1) / bn;
}

// ---------------------------------------------------------------------------
// bf16: a producer warpgroup and two consumer warpgroups of 64 q rows each,
// KV tiles in a 2-stage ring (TMA + mbarriers), wgmma. One template, two
// instances: D = 128 with 128-row KV tiles, D = 256 with 64-row ones.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;  // consumer warpgroups, 64 q rows each
constexpr int kBM = 64 * kConsumers;  // q rows per block
constexpr int kStages = 2;     // K/V ring depth
constexpr float kLn2 = 0.6931471805599453f;

// KV rows per tile by head_dim. At D = 256 a consumer thread holds O in
// 128 f32 registers (two 64 x 128 accumulators); S of a 64-row tile (32)
// and P packed (16) fit beside it under setmaxnreg 240, those of a
// 128-row tile (64 + 32) would not.
template <int D>
constexpr int fwd_bn() {
  return D == kD ? 128 : 64;
}

template <int D, int BN>
struct __align__(1024) FwdSmem {
  bf16 q[D / kHalf][kBM * kHalf];  // 64-column boxes
  bf16 k[kStages][D / kHalf][BN * kHalf];
  bf16 v[kStages][D / kHalf][BN * kHalf];
  uint64_t q_full;
  uint64_t k_full[kStages];   // TMA bytes of K have landed
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];  // every consumer warp is done with K
  uint64_t v_empty[kStages];
};

// + slack to align the base to 1024 bytes: 165,888 bytes in all at D = 128,
// 198,656 at D = 256.
template <int D>
constexpr int fwd_smem_bytes() {
  return static_cast<int>(sizeof(FwdSmem<D, fwd_bn<D>()>)) + 1024;
}

struct FwdArgs {
  void* o;
  float* lse;
  int H, KVH, Sq, Skv, n_qt;
  float scale_log2;  // scale * log2(e): scores are kept in log2 units
  int causal;
};

// Issue O += P V as one wgmma group: P (bf16) is the register A operand, V
// is [kv][d] in shared memory with d contiguous (MN-major), D / 64 boxes of
// box_bytes each; O is one 64 x 128 accumulator per 128 columns.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / kD][64],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_base,
                                         uint32_t box_bytes) {
  hopper::wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < D / kD; ++hh)
    flash::mma_rs(o[hh], pa, v_base + 2 * hh * box_bytes, box_bytes);
  hopper::wgmma_commit();
}

// Online softmax of one S tile of N columns in place (scores in log2
// units): scale, mask (kMasked: the diagonal tile or a ragged KV edge), new
// row max, P = 2^(x - m); updates m and this thread's partial row sums l,
// returns the factors that rescale O. The unmasked instance carries no mask
// code.
template <bool kMasked, int N>
__device__ __forceinline__ void softmax_impl(float (&sc)[N / 2],
                                             const FwdArgs& p, int k0,
                                             int r_lo, int lane, float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& corr_lo,
                                             float& corr_hi) {
  const float c = p.scale_log2;
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
  if (kMasked) {  // scale, then mask: sc holds log2-unit scores
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
        const int row = r_lo + (e < 2 ? 0 : 8);
        float x = sc[4 * j + e] * c;
        if (col >= p.Skv || (p.causal && col > row)) x = kMaskValue;
        sc[4 * j + e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
  } else {  // sc stays raw; c > 0, so max(s) * c = max(s * c)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_lo *= c;
    mx_hi *= c;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo);
  const float mn_hi = fmaxf(m_hi, mx_hi);
  corr_lo = fast_exp2(m_lo - mn_lo);
  corr_hi = fast_exp2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  // P = 2^(x - m): one FFMA (or FADD) and one MUFU.EX2 per score.
  const float cs = kMasked ? 1.f : c;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], cs, -mn_lo));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], cs, -mn_lo));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], cs, -mn_hi));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], cs, -mn_hi));
    sum_lo += sc[4 * j] + sc[4 * j + 1];
    sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
}

template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N / 2],
                                             const FwdArgs& p, bool masked,
                                             int k0, int r_lo, int lane,
                                             float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi,
                                             float& corr_lo, float& corr_hi) {
  if (masked)
    softmax_impl<true, N>(sc, p, k0, r_lo, lane, m_lo, m_hi, l_lo, l_hi,
                          corr_lo, corr_hi);
  else
    softmax_impl<false, N>(sc, p, k0, r_lo, lane, m_lo, m_hi, l_lo, l_hi,
                           corr_lo, corr_hi);
  // Keep the softmax ahead of the next wgmma wait: without these ties the
  // compiler may sink the exponentials below it, and the softmax would no
  // longer run under the other product.
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hopper::fence_reg(sc[i]);
  hopper::fence_reg(l_lo);
  hopper::fence_reg(l_hi);
  hopper::fence_reg(corr_lo);
  hopper::fence_reg(corr_hi);
}

template <int D, int BN>
__device__ __forceinline__ void fence_o_pa(float (&o)[D / kD][64],
                                           uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int hh = 0; hh < D / kD; ++hh)
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_reg(o[hh][i]);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) hopper::fence_reg(pa[kk][i]);
}

template <int D, int BN>
__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const FwdArgs p) {
  constexpr int kBoxes = D / kHalf;  // 64-column boxes of a row
  constexpr uint32_t kQBoxBytes = kBM * kHalf * 2;
  constexpr uint32_t kKvBoxBytes = BN * kHalf * 2;
  constexpr uint32_t kTileBytes = BN * D * 2;  // one K or V tile, 32 KB
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  FwdSmem<D, BN>& sm = *reinterpret_cast<FwdSmem<D, BN>*>(
      smem_raw + (((raw + 1023) & ~1023u) - raw));

  // Block -> (b, kv head, q tile, head in the group), the group fastest,
  // then the q tiles of one KV head, heaviest causal tile first.
  const int G = p.H / p.KVH;
  int id = blockIdx.x;
  const int g = id % G;
  id /= G;
  const int rank = id % p.n_qt;
  id /= p.n_qt;
  const int kvh = id % p.KVH;
  const int b = id / p.KVH;
  const int h = kvh * G + g;
  const int qt = p.causal ? p.n_qt - 1 - rank : rank;
  const int q0 = qt * kBM;
  const int kv_end = p.causal ? min(p.Skv, q0 + kBM) : p.Skv;
  const int n_kt = (kv_end + BN - 1) / BN;

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
    // ---------------- producer: one thread issues every TMA load --------
    // K of a stage is refilled once both consumers have S = Q K^T of it,
    // V once they have O += P V of it.
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.q_full, kBM * D * 2);
#pragma unroll
      for (int i = 0; i < kBoxes; ++i)
        hopper::tma_load_4d(sm.q[i], &tq, &sm.q_full, i * kHalf, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t freed = ((kt / kStages) - 1) & 1;
        const int k0 = kt * BN;
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
    // ---------------- consumers: 64 q rows each -------------------------
    // Software pipeline inside the warpgroup: S of tile kt is issued before
    // O += P V of tile kt - 1, so the softmax of one tile runs while the
    // tensor cores work on the other product.
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int row_c = q0 + cw * 64;  // this warpgroup's first q row
    const int r_lo = row_c + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;

    if (row_c >= p.Sq) {  // a short bucket leaves this warpgroup no rows
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t parity = (kt / kStages) & 1;
        hopper::mbar_wait(&sm.k_full[s], parity);
        release(&sm.k_empty[s], lane);
        hopper::mbar_wait(&sm.v_full[s], parity);
        release(&sm.v_empty[s], lane);
      }
      return;
    }

    float o[D / kD][64];  // one 64 x 128 accumulator per 128 columns
#pragma unroll
    for (int hh = 0; hh < D / kD; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[hh][i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
    float l_lo = 0.f, l_hi = 0.f;  // this thread's partial row sums
    float corr_lo, corr_hi;
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];

    const uint32_t q_base = hopper::smem_u32(sm.q[0]) + cw * 64 * 128;
    auto masked = [&](int k0) {
      return (k0 + BN > p.Skv) || (p.causal && k0 + BN - 1 > row_c);
    };
    // Ping-pong between the two consumers (named barriers 1 and 2): each
    // issues its products only after the other has issued its own, so one
    // warpgroup's softmax runs under the other's wgmmas. Each consumer
    // issues n_kt + 1 times; consumer 1 lets consumer 0 go first and skips
    // its last hand-over, so every barrier is balanced at exit.
    const bool pingpong = q0 + 64 < p.Sq;  // both consumers have rows
    int turns = n_kt + 1;
    auto my_turn = [&]() {
      if (pingpong) hopper::named_bar_sync(1 + cw, 256);
    };
    auto pass_turn = [&]() {
      --turns;
      if (pingpong && !(cw == 1 && turns == 0))
        hopper::named_bar_arrive(2 - cw, 256);
    };
    if (pingpong && cw == 1) hopper::named_bar_arrive(1, 256);

    hopper::mbar_wait(&sm.q_full, 0);
    hopper::mbar_wait(&sm.k_full[0], 0);
    my_turn();
    flash::issue_abt<BN, D>(sc, q_base, kQBoxBytes,  // S = Q K^T
                            hopper::smem_u32(sm.k[0][0]), kKvBoxBytes);
    pass_turn();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hopper::fence_reg(sc[i]);
    release(&sm.k_empty[0], lane);
    softmax_tile<BN>(sc, p, masked(0), 0, r_lo, lane, m_lo, m_hi, l_lo, l_hi,
                     corr_lo, corr_hi);
    flash::pack_a(pa, sc);  // P as the next A operand

    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      const int k0 = kt * BN;
      hopper::mbar_wait(&sm.k_full[s], (kt / kStages) & 1);
      hopper::mbar_wait(&sm.v_full[sp], ((kt - 1) / kStages) & 1);
      my_turn();
      flash::issue_abt<BN, D>(sc, q_base, kQBoxBytes,
                              hopper::smem_u32(sm.k[s][0]), kKvBoxBytes);
      issue_pv<D, BN>(o, pa, hopper::smem_u32(sm.v[sp][0]), kKvBoxBytes);
      pass_turn();
      hopper::wgmma_wait<1>();  // S of tile kt is done, P V may still run
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_reg(sc[i]);
      release(&sm.k_empty[s], lane);
      softmax_tile<BN>(sc, p, masked(k0), k0, r_lo, lane, m_lo, m_hi, l_lo,
                       l_hi, corr_lo, corr_hi);
      hopper::wgmma_wait<0>();  // P V of tile kt - 1 is done
      fence_o_pa<D, BN>(o, pa);
      release(&sm.v_empty[sp], lane);
#pragma unroll
      for (int hh = 0; hh < D / kD; ++hh)
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[hh][4 * j] *= corr_lo;
          o[hh][4 * j + 1] *= corr_lo;
          o[hh][4 * j + 2] *= corr_hi;
          o[hh][4 * j + 3] *= corr_hi;
        }
      flash::pack_a(pa, sc);
    }
    const int sl = (n_kt - 1) % kStages;
    hopper::mbar_wait(&sm.v_full[sl], ((n_kt - 1) / kStages) & 1);
    my_turn();
    issue_pv<D, BN>(o, pa, hopper::smem_u32(sm.v[sl][0]), kKvBoxBytes);
    pass_turn();
    hopper::wgmma_wait<0>();
    fence_o_pa<D, BN>(o, pa);
    release(&sm.v_empty[sl], lane);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    l_lo = fmaxf(l_lo, 1e-30f);
    l_hi = fmaxf(l_hi, 1e-30f);
    const long long bh = static_cast<long long>(b) * p.H + h;
    bf16* O = static_cast<bf16*>(p.o) + bh * p.Sq * D;
    float* LSE = p.lse + bh * p.Sq;
#pragma unroll
    for (int hh = 0; hh < D / kD; ++hh)
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int c = hh * kD + j * 8 + (lane % 4) * 2;
        if (r_lo < p.Sq)
          *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r_lo) * D +
                                       c) =
              pack_bf16(o[hh][4 * j] / l_lo, o[hh][4 * j + 1] / l_lo);
        if (r_hi < p.Sq)
          *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r_hi) * D +
                                       c) =
              pack_bf16(o[hh][4 * j + 2] / l_hi, o[hh][4 * j + 3] / l_hi);
      }
    if (lane % 4 == 0) {
      if (r_lo < p.Sq) LSE[r_lo] = m_lo * kLn2 + logf(l_lo);
      if (r_hi < p.Sq) LSE[r_hi] = m_hi * kLn2 + logf(l_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 at D = 256, 384, 512, 640 and 1024: one cluster of 2, 3, 4, 5 or 8
// CTAs per (b, head, 128 q rows), one CTA per 128-column chunk of D, the
// scores summed over the cluster (see the top of this file).
// ---------------------------------------------------------------------------

namespace f32c {

constexpr int kBM = 128;                // q rows per cluster
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

// Q, K and V chunks as TMA writes them: 4 boxes of 32 columns, each `rows`
// x 128 bytes. Q is read down 8 rows of one 16-byte column at once, so its
// 16-byte column c of row r sits at c ^ (r % 8) within its box
// (CU_TENSOR_MAP_SWIZZLE_128B) and those 8 words fall in 8 distinct banks;
// K and V are read along a row, in place.
struct __align__(1024) Smem {
  float q[kBoxes][kBM * kBox];
  float k[kStages][kBoxes][kBN * kBox];
  float v[kStages][kBoxes][kBN * kBox];
  float part[2][kBM * kBN];  // [buffer] S over this chunk, [q][kv]
  float pm[2][kBM * kBN];    // [buffer] P over all of D, [q][kv]
  float corr[2][kBM];        // [buffer] exp(m_old - m_new) of each q row
  float lsum[kBM];           // the row sums l after the last tile
  uint64_t q_full;
  uint64_t full[kStages];     // K, V landed (TMA bytes)
  uint64_t empty[kStages];    // this CTA's math warps are done with a stage
  uint64_t parts_ready[2];    // every CTA's math warps wrote part[buffer]
  uint64_t parts_free[2];     // every CTA's exchange warps read their slice
  uint64_t pd_ready[2];       // every CTA stored its rows of pm, corr
  uint64_t pd_free[2];        // every CTA's math warps are done with them
};

// + slack to align the base to 1024 bytes: 232,448 bytes, the whole 227 KB
// a block may opt in to.
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

// A [q][kv] partials tile: 8 16-byte columns a row, column c of row r at c
// ^ (r % 8), so 8 consecutive rows' stores of one column fall in 8 banks.
__device__ __forceinline__ int swz(int row, int col4) {
  return row * kBN + ((col4 ^ (row & 7)) << 2);
}

// P's 16-byte column c of row r sits at c ^ (r % 2): the two rows a warp
// reads at once in phase B fall in other banks.
__device__ __forceinline__ int pm_at(int row, int col4) {
  return row * kBN + ((col4 ^ (row & 1)) << 2);
}

// The kernel over kChunks CTAs a cluster (D = kChunks kD); the three kernels
// after it give the cluster's size as a literal.
template <int kChunks>
__device__ __forceinline__ void fwd_cluster(const CUtensorMap& tq,
                                            const CUtensorMap& tk,
                                            const CUtensorMap& tv,
                                            const Params& p) {
  constexpr int kDW = kChunks * kD;  // head_dim
  // q rows a CTA's exchange owns at most (64 of 2 CTAs, 43 of 3, 32 of 4, 26
  // of 5, 16 of 8), 16 a slot: 4 slots at 2 CTAs, 3 at 3, 2 at 4 and 5. At 8
  // the second slot stays, never this CTA's, as that instance has always had
  // it.
  constexpr int kOwned = ((kBM + kChunks - 1) / kChunks + 15) / 16;
  constexpr int kSlots = kOwned < 2 ? 2 : kOwned;
  // setmaxnreg of the math and exchange warpgroups: 224 and 56 at two row
  // slots, 216 and 72 at three (at 56 three slots spilled 28 bytes; 208 and
  // 88 ran no faster), 200 and 104 at four (none of 216 / 72, 208 / 88 and
  // 200 / 104 spilled there; 200 / 104 ran 3% faster than 216 / 72 on the
  // H100); each split is the 168 x 384 registers the launch gives a CTA.
  constexpr int kMathR = kSlots == 2 ? kMathRegs : kSlots == 3 ? 216 : 200;
  constexpr int kXR = kSlots == 2 ? kXRegs : kSlots == 3 ? 72 : 104;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Smem& sm =
      *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = static_cast<int>(hopper::cluster_ctarank());  // D chunk

  // Cluster -> (q tile, b, head), the q tile slowest, heaviest causal tile
  // first; the query heads of one KV head run next to each other, so they
  // read its K and V from L2.
  const int n_qt = (p.Sq + kBM - 1) / kBM;
  const int n_bh = gridDim.x / kChunks / n_qt;  // B * H
  const int cl = blockIdx.x / kChunks;
  const int bh = cl % n_bh;
  const int rank = cl / n_bh;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  const int q0 = qt * kBM;
  const int n_kt = kv_tiles(p, q0, kBM, kBN);

  if (tid == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
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
    // Its first warp's lane 0 loads (TMA, 4 boxes each; rows past Sq and
    // Skv are zero-filled): Q once, K and V per tile of KV head kvh.
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
      hopper::mbar_expect_tx(&sm.q_full, kBM * kRowBytes);
      for (int x = 0; x < kBoxes; ++x)
        hopper::tma_load_4d(sm.q[x], &tq, &sm.q_full, c * kD + x * kBox, q0,
                            h, b);
      for (int kt = 0; kt < min(n_kt, kStages - 1); ++kt) load_tile(kt);
    }

    // This CTA's q rows, [r0, r1) (64 of 128 at 2 chunks, all four slots
    // full; 42 or 43 at 3, the third slot 10 or 11 rows full; 32 at 4, both
    // slots full; 25 or 26 at 5, 16 at 8), for the whole loop: 8 lanes a
    // row, lane col4 of row r0 + xt / 8 + 16 i (i < kSlots; at 8 chunks i = 1
    // is never this CTA's) sums 16-byte column col4 (4 KV columns) over the
    // chunks, in chunk order from 0 in every CTA, applies scale and the
    // mask, keeps the row's running max m and sum l (the same in its 8
    // lanes), and stores P = exp(S - m_new) in f32 (the Pallas kernel's cast
    // to V's dtype rounds nothing in f32) and the row's correction exp(m_old
    // - m_new) into every CTA.
    const int xt = tid - 32 * kMathWarps;
    const int r0 = c * kBM / kChunks;
    const int r1 = (c + 1) * kBM / kChunks;
    const int col4 = xt % 8;
    int row[kSlots];
    bool mine[kSlots];
    float m[kSlots], l[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      row[i] = r0 + xt / 8 + 16 * i;
      mine[i] = row[i] < r1;  // the same in a row's 8 lanes
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int buf = kt & 1;
      const int k0 = kt * kBN;
      const int nx = kt + kStages - 1;  // the tile the loader loads next
      hopper::mbar_wait_cluster(&sm.parts_ready[buf], (kt >> 1) & 1);
      float4 sv[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        sv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!mine[i]) continue;
        const uint32_t at = hopper::smem_u32(sm.part[buf] + swz(row[i], col4));
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          const float4 x = hopper::ld_cluster_f4(hopper::map_rank(at, r));
          sv[i] = r == 0 ? x : flash::add4(sv[i], x);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_signal_rank(&sm.parts_free[buf], lane);
      float4 pv[kSlots];
      float corr[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        float x[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 4 * col4 + e;
          x[e] *= p.scale;
          if (col >= p.Skv || (p.causal && col > q0 + row[i]))
            x[e] = kMaskValue;
          mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[i], mx);
        corr[i] = expf(m[i] - mn);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = expf(x[e] - mn);
          sum += x[e];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * corr[i] + sum;
        pv[i] = make_float4(x[0], x[1], x[2], x[3]);
      }
      // Every CTA's math warps are done with this buffer's tile before.
      if (kt >= 2)
        hopper::mbar_wait(&sm.pd_free[buf], ((kt - 2) >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        const uint32_t p_at =
            hopper::smem_u32(sm.pm[buf] + pm_at(row[i], col4));
        const uint32_t c_at = hopper::smem_u32(sm.corr[buf] + row[i]);
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          hopper::st_cluster_f4(hopper::map_rank(p_at, r), pv[i]);
          if (col4 == 0)
            hopper::st_cluster_f32(hopper::map_rank(c_at, r), corr[i]);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_arrive_rank(&sm.pd_ready[buf], lane);
      // The tile two ahead goes into the stage of the one before this,
      // once this CTA's math warps are done with it.
      if (loader && nx < n_kt) {
        if (nx >= kStages)
          hopper::mbar_wait(&sm.empty[nx % kStages], (nx / kStages - 1) & 1);
        load_tile(nx);
      }
    }
    // The row sums into every CTA (published by the cluster barrier
    // below), and LSE = m + log(l) in natural-log units, which the
    // backward reads.
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (!mine[i] || col4 != 0) continue;
      const float lf = fmaxf(l[i], 1e-30f);
      const uint32_t at = hopper::smem_u32(sm.lsum + row[i]);
      for (int r = 0; r < kChunks; ++r)
        hopper::st_cluster_f32(hopper::map_rank(at, r), lf);
      if (q0 + row[i] < p.Sq)
        p.lse[static_cast<long long>(bh) * p.Sq + q0 + row[i]] =
            m[i] + logf(lf);
    }
    // Publishes lsum to the math warps; no CTA leaves while a peer may
    // still touch its shared memory.
    hopper::cluster_sync();
  } else {
    // ---------------- math warpgroups -----------------------------------
    // Phase A of tile kt (S = Q K^T over this chunk), then phase B of tile
    // kt - 1 (O = O corr + P V), so the exchange of tile kt runs beside
    // phase B. Every inner loop runs on an 8 x 8 register tile, so each
    // word read from shared memory feeds 8 FMAs (shared memory gives 32
    // words a clock, the FMA units take 128).
    hopper::reg_alloc<kMathR>();
    const int half = warp / 4;
    const int w4 = warp % 4;
    // Phase A: q rows 64 half + l8 + 8i by KV rows 8 w4 + i' (i, i' < 8)
    // over the 16-byte columns dq + 4j (j < 8) of the chunk, dq = lane / 8:
    // the four lanes of a tile take a quarter of the columns each and are
    // summed by shuffles. A quarter warp reads 8 q rows of one column and
    // one K word.
    const int l8 = lane % 8;
    const int dq = lane / 8;
    // Phase B: q rows kg + 16i (i < 8) by columns 4 dg + 64m + e (m < 2, e
    // < 4): a half warp reads one P word and 16 consecutive 16-byte
    // columns of V.
    const int dg = lane % 16;
    const int kg = 2 * warp + lane / 16;
    float acc[8][2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][mm][e] = 0.f;

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt <= n_kt; ++kt) {
      if (kt < n_kt) {
        const int s = kt % kStages;
        const int buf = kt & 1;
        hopper::mbar_wait(&sm.full[s], (kt / kStages) & 1);
        // Every CTA's exchange warps are done with this buffer's tile.
        if (kt >= 2)
          hopper::mbar_wait(&sm.parts_free[buf], ((kt - 2) >> 1) & 1);
        // Step j reads 16-byte column g = dq + 4j: box j / 2, column dq +
        // 4 (j % 2) in it, at (dq + 4 (j % 2)) ^ l8 in Q's rows.
        const float* a0 =
            sm.q[0] + (64 * half + l8) * kBox + ((dq ^ l8) << 2);
        const float* a1 =
            sm.q[0] + (64 * half + l8) * kBox + ((dq ^ l8 ^ 4) << 2);
        const float* b0 = sm.k[s][0] + 8 * w4 * kBox + 4 * dq;
        float x[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) x[i][i2] = 0.f;
#pragma unroll 1
        for (int j = 0; j < kD / 16; ++j) {
          const float* ak = ((j & 1) ? a1 : a0) + (j >> 1) * kBM * kBox;
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
        const bool hi_q = dq & 1, hi_kv = dq & 2;
        float y[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) {
            const float keep = hi_q ? x[i + 4][i2] : x[i][i2];
            const float give = hi_q ? x[i][i2] : x[i + 4][i2];
            y[i][i2] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
          }
        float* out = sm.part[buf];
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
              out + swz(64 * half + l8 + 8 * (i + 4 * hi_q), 2 * w4 + hi_kv)) =
              make_float4(z[0], z[1], z[2], z[3]);
        }
        // One warp, another each tile, waits at a named barrier for all
        // eight warps' partials and arrives at each CTA's parts_ready
        // (lanes 0 to kChunks - 1 in one instruction): the release at
        // cluster scope is a GPU-wide memory barrier that stalls the warp, so
        // the other warps only arrive at the named barrier and go on.
        if (warp == kt % kMathWarps) {
          hopper::named_bar_sync(1 + buf, 32 * kMathWarps);
          if (lane < kChunks)
            hopper::mbar_arrive_rank(&sm.parts_ready[buf], lane);
        } else {
          hopper::named_bar_arrive(1 + buf, 32 * kMathWarps);
        }
      }
      if (kt >= 1) {
        // O = O corr + P V over tile kt - 1's KV rows, this chunk's
        // columns.
        const int t = kt - 1;
        const int s = t % kStages;
        const int buf = t & 1;
        hopper::mbar_wait_cluster(&sm.pd_ready[buf], (t >> 1) & 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float cr = sm.corr[buf][kg + 16 * i];
#pragma unroll
          for (int mm = 0; mm < 2; ++mm)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][mm][e] *= cr;
        }
        const float* Pm = sm.pm[buf] + kg * kBN;
        // 16-byte column dg + 16m of a row: box dg / 8 + 2m, column dg % 8.
        const float* Vt =
            sm.v[s][0] + (dg >> 3) * kBN * kBox + 4 * (dg & 7);
#pragma unroll 2
        for (int jj = 0; jj < kBN; jj += 4) {
          // P's 16-byte column jj / 4 of rows kg + 16i, at (jj / 4) ^ (kg %
          // 2) (pm_at).
          const int pc = ((jj >> 2) ^ (kg & 1)) << 2;
          float4 w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = flash::ld4(Pm + 16 * i * kBN + pc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int mm = 0; mm < 2; ++mm) {
              const float4 o =
                  flash::ld4(Vt + 2 * mm * kBN * kBox + (jj + e) * kBox);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float wi = e == 0   ? w[i].x
                                 : e == 1 ? w[i].y
                                 : e == 2 ? w[i].z
                                          : w[i].w;
                flash::fma4(acc[i][mm], wi, o);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
        if (lane < kChunks) hopper::mbar_signal_rank(&sm.pd_free[buf], lane);
      }
    }
    // Every CTA's row sums have arrived (the exchange warps' stores before
    // the cluster barrier); after it no peer touches this CTA's memory.
    hopper::cluster_sync();
    float* O = static_cast<float*>(p.o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = kg + 16 * i;
      if (q0 + row >= p.Sq) continue;
      const float lf = sm.lsum[row];
      float* o = O + (static_cast<long long>(bh) * p.Sq + q0 + row) * kDW +
                 c * kD + 4 * dg;
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
        *reinterpret_cast<float4*>(o + 64 * mm) =
            make_float4(acc[i][mm][0] / lf, acc[i][mm][1] / lf,
                        acc[i][mm][2] / lf, acc[i][mm][3] / lf);
    }
  }
}

// f32 at D = 640: clusters of 5 CTAs.
__global__ void __cluster_dims__(5, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_f32_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const Params p) {
  fwd_cluster<5>(tq, tk, tv, p);
}

// f32 at D = 1024: clusters of 8 CTAs, the largest portable cluster.
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_f32_d1024_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const Params p) {
  fwd_cluster<8>(tq, tk, tv, p);
}

// f32 at D = 512: clusters of 4 CTAs. Each CTA's exchange owns 32 of the 128
// q rows, 8 threads a row in both row slots: every thread of it, twice.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_f32_d512_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const Params p) {
  fwd_cluster<4>(tq, tk, tv, p);
}

// f32 at D = 384: clusters of 3 CTAs. Each CTA's exchange owns 42 or 43 of
// the 128 q rows, 8 threads a row in three row slots of 16, the third 10 or
// 11 rows full, at setmaxnreg 72 beside math warpgroups at 216.
__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_f32_d384_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const Params p) {
  fwd_cluster<3>(tq, tk, tv, p);
}

// f32 at D = 256: clusters of 2 CTAs. Each CTA's exchange owns 64 of the 128
// q rows, 8 threads a row in four full row slots of 16, at setmaxnreg 104
// beside math warpgroups at 200.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_f32_d256_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const Params p) {
  fwd_cluster<2>(tq, tk, tv, p);
}

}  // namespace f32c

// ---------------------------------------------------------------------------
// bf16 at D = 512, 640 and 1024: one cluster of 4, 5 or 8 CTAs per (b,
// head, 128 q rows), one CTA per 128 columns of D, the scores summed over
// the cluster and each CTA's two products on the tensor cores (see the top
// of this file).
// ---------------------------------------------------------------------------

namespace bf16c {

constexpr int kBM = 128;                 // q rows per cluster
constexpr int kBN = 64;                  // KV rows per tile
constexpr int kStages = 3;               // K/V ring depth
constexpr int kMathWarps = 8;            // two warpgroups, 64 q rows each
constexpr int kXWarps = 4;               // one warpgroup: the exchange, loads
constexpr int kThreads = 32 * (kMathWarps + kXWarps);
constexpr uint32_t kQBoxBytes = kBM * kHalf * 2;   // a 64-column box of Q
constexpr uint32_t kKvBoxBytes = kBN * kHalf * 2;  // and of a K or V tile
constexpr uint32_t kTileBytes = kBN * kD * 2;      // a chunk of a K or V tile

// Q, K and V chunks as TMA writes them (two 128B-swizzled 64-column boxes
// each), P as one such box of 128 q rows by the tile's 64 KV columns
// ([q][kv], K-major for the wgmma that reads it), the score partials in
// f32. 32 + 96 (the ring) + 32 + 64 KB and the rows' corrections and sums:
// with the alignment slack, the whole 227 KB a block may opt in to.
struct __align__(1024) Smem {
  bf16 q[2][kBM * kHalf];
  bf16 k[kStages][2][kBN * kHalf];
  bf16 v[kStages][2][kBN * kHalf];
  bf16 p[2][kBM * kBN];          // [buffer] P over all of D
  float part[2][kBM * kBN];      // [buffer] S over this chunk, [q][kv]
  float corr[2][kBM];            // [buffer] 2^(m_old - m_new) of each q row
  float lsum[kBM];               // the row sums l after the last tile
  uint64_t q_full;
  uint64_t full[kStages];     // K, V landed (TMA bytes)
  uint64_t empty[kStages];    // this CTA's math warps are done with a stage
  uint64_t parts_ready[2];    // every CTA's math warps wrote part[buffer]
  uint64_t parts_free[2];     // every CTA's exchange warps read their slice
  uint64_t pd_ready[2];       // every CTA stored its rows of p, corr
  uint64_t pd_free[2];        // every CTA's math warps are done with them
};

constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's 227 KB per block");

// The [q][kv] f32 partials and the bf16 boxes.
using flash::box_at;
using flash::swz64;
static_assert(kBN == 64, "swz64's rows are 64 floats");

// The kernel over kChunks CTAs a cluster (D = kChunks kD), as f32c's; the
// two kernels after it give the cluster's size as a literal.
template <int kChunks>
__device__ __forceinline__ void fwd_cluster(const CUtensorMap& tq,
                                            const CUtensorMap& tk,
                                            const CUtensorMap& tv,
                                            const FwdArgs& p) {
  constexpr int kDW = kChunks * kD;  // head_dim
  // q rows a CTA's exchange owns at most (43 of 3 CTAs, 32 of 4, 26 of 5, 16
  // of 8), 8 a slot
  constexpr int kSlots = ((kBM + kChunks - 1) / kChunks + 7) / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  Smem& sm =
      *reinterpret_cast<Smem*>(smem_raw + (((raw + 1023) & ~1023u) - raw));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = static_cast<int>(hopper::cluster_ctarank());  // D chunk

  // Cluster -> (q tile, b, head), the q tile slowest, heaviest causal tile
  // first; the query heads of one KV head run next to each other, so they
  // read its K and V from L2.
  const int n_bh = gridDim.x / kChunks / p.n_qt;  // B * H
  const int cl = blockIdx.x / kChunks;
  const int bh = cl % n_bh;
  const int rank = cl / n_bh;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int qt = p.causal ? p.n_qt - 1 - rank : rank;
  const int q0 = qt * kBM;
  // Causal: KV tiles wholly after the q tile are never loaded.
  const int kv_end = p.causal ? min(p.Skv, q0 + kBM) : p.Skv;
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
    // Its first warp's lane 0 loads (TMA, two boxes each; rows past Sq and
    // Skv are zero-filled): Q once, K and V per tile of KV head kvh.
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
      hopper::mbar_expect_tx(&sm.q_full, kBM * kD * 2);
      for (int x = 0; x < 2; ++x)
        hopper::tma_load_4d(sm.q[x], &tq, &sm.q_full, c * kD + x * kHalf, q0,
                            h, b);
      for (int kt = 0; kt < min(n_kt, kStages - 1); ++kt) load_tile(kt);
    }

    // This CTA's q rows, [r0, r1) (25 or 26 of the 128 at 5 CTAs, 16 at
    // 8, 32 at 4, 42 or 43 at 3), for the whole loop: 16 lanes a row, lane
    // col4 of row r0 + xt / 16 + 8 i (i < kSlots) sums 16-byte column col4
    // (4 KV columns) over the kChunks chunks, in chunk order from 0 in
    // every CTA, scales it to log2 units, masks KV columns past Skv (TMA
    // zero-filled their K rows, so S is 0 there and 2^(0 - m) is not) and
    // after the row
    // (causal), keeps the row's running max m and sum l (the same in its 16
    // lanes), and stores P = 2^(S - m_new) rounded to bf16 (where the
    // Pallas kernel casts P to V's dtype; l sums it unrounded, as there) and
    // the row's correction 2^(m_old - m_new) into every CTA.
    const int xt = tid - 32 * kMathWarps;
    const int r0 = c * kBM / kChunks;
    const int r1 = (c + 1) * kBM / kChunks;
    const int col4 = xt % 16;
    int row[kSlots];
    bool mine[kSlots];
    float m[kSlots], l[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      row[i] = r0 + xt / 16 + 8 * i;
      mine[i] = row[i] < r1;  // the same in a row's 16 lanes
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int buf = kt & 1;
      const int k0 = kt * kBN;
      const int nx = kt + kStages - 1;  // the tile the loader loads next
      hopper::mbar_wait_cluster(&sm.parts_ready[buf], (kt >> 1) & 1);
      float4 sv[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        sv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!mine[i]) continue;
        const uint32_t at =
            hopper::smem_u32(sm.part[buf] + swz64(row[i], col4));
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          const float4 x = hopper::ld_cluster_f4(hopper::map_rank(at, r));
          sv[i] = r == 0 ? x : flash::add4(sv[i], x);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_signal_rank(&sm.parts_free[buf], lane);
      uint2 pw[kSlots];
      float corr[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        float x[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 4 * col4 + e;
          x[e] *= p.scale_log2;
          if (col >= p.Skv || (p.causal && col > q0 + row[i]))
            x[e] = kMaskValue;
          mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[i], mx);
        corr[i] = fast_exp2(m[i] - mn);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = fast_exp2(x[e] - mn);
          sum += x[e];
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * corr[i] + sum;
        pw[i] = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
      }
      // Every CTA's math warps are done with this buffer's tile before.
      if (kt >= 2)
        hopper::mbar_wait(&sm.pd_free[buf], ((kt - 2) >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!mine[i]) continue;
        const uint32_t p_at =
            hopper::smem_u32(sm.p[buf]) + box_at(row[i], col4);
        const uint32_t c_at = hopper::smem_u32(sm.corr[buf] + row[i]);
#pragma unroll
        for (int r = 0; r < kChunks; ++r) {
          hopper::st_cluster_u2(hopper::map_rank(p_at, r), pw[i]);
          if (col4 == 0)
            hopper::st_cluster_f32(hopper::map_rank(c_at, r), corr[i]);
        }
      }
      __syncwarp();
      if (lane < kChunks) hopper::mbar_arrive_rank(&sm.pd_ready[buf], lane);
      // The tile two ahead goes into the stage of the one before this,
      // once this CTA's math warps are done with it.
      if (loader && nx < n_kt) {
        if (nx >= kStages)
          hopper::mbar_wait(&sm.empty[nx % kStages], (nx / kStages - 1) & 1);
        load_tile(nx);
      }
    }
    // The row sums into every CTA (published by the cluster barrier
    // below), and LSE = m ln 2 + log(l) in natural-log units, which the
    // backward reads.
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (!mine[i] || col4 != 0) continue;
      const float lf = fmaxf(l[i], 1e-30f);
      const uint32_t at = hopper::smem_u32(sm.lsum + row[i]);
      for (int r = 0; r < kChunks; ++r)
        hopper::st_cluster_f32(hopper::map_rank(at, r), lf);
      if (q0 + row[i] < p.Sq)
        p.lse[static_cast<long long>(bh) * p.Sq + q0 + row[i]] =
            m[i] * kLn2 + logf(lf);
    }
    // Publishes lsum to the math warps; no CTA leaves while a peer may
    // still touch its shared memory.
    hopper::cluster_sync();
  } else {
    // ---------------- math warpgroups -----------------------------------
    // Warpgroup `half` owns q rows 64 half.. of the tile: phase A of tile
    // kt (S = Q K^T over this chunk, wgmma.m64n64k16 with both operands
    // K-major, 8 k-steps, 32 f32 registers), then phase B of tile kt - 1
    // (O = O corr + P V: wgmma.m64n128k16 with A = its 64 rows of the P
    // box and B = V MN-major through the transpose bit, flash::mma_t, 4
    // k-steps; O is 64 f32 registers for the whole loop), so the exchange
    // of tile kt runs beside phase B.
    const int half = warp / 4;
    const int w4 = warp % 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float sc[32];
    const uint32_t q_base = hopper::smem_u32(sm.q[0]) + half * 64 * 128;
    // acc[4j + 2a + e] and sc[4j + 2a + e]: q row r_lo + 8a of the tile.
    const int r_lo = 64 * half + 16 * w4 + lane / 4;

    hopper::mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt <= n_kt; ++kt) {
      if (kt < n_kt) {
        const int s = kt % kStages;
        const int buf = kt & 1;
        hopper::mbar_wait(&sm.full[s], (kt / kStages) & 1);
        // Every CTA's exchange warps are done with this buffer's tile.
        if (kt >= 2)
          hopper::mbar_wait(&sm.parts_free[buf], ((kt - 2) >> 1) & 1);
        flash::issue_abt<kBN>(sc, q_base, kQBoxBytes,
                              hopper::smem_u32(sm.k[s][0]), kKvBoxBytes);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_reg(sc[i]);
        // sc[4j + 2a + e]: KV column 8j + 2 (lane % 4) + e, in 16-byte
        // column 2j + (lane % 4) / 2.
        float* out = sm.part[buf];
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
        // O = O corr + P V over tile kt - 1's KV rows, this chunk's
        // columns.
        const int t = kt - 1;
        const int s = t % kStages;
        const int buf = t & 1;
        hopper::mbar_wait_cluster(&sm.pd_ready[buf], (t >> 1) & 1);
        hopper::fence_proxy_async_cluster();  // peers' stores, then wgmma
        const float c_lo = sm.corr[buf][r_lo];
        const float c_hi = sm.corr[buf][r_lo + 8];
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          acc[4 * j] *= c_lo;
          acc[4 * j + 1] *= c_lo;
          acc[4 * j + 2] *= c_hi;
          acc[4 * j + 3] *= c_hi;
        }
        hopper::wgmma_fence();
        flash::mma_t(acc, hopper::smem_u32(sm.p[buf]) + half * 64 * 128,
                     hopper::smem_u32(sm.v[s][0]));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) hopper::fence_reg(acc[i]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
        if (lane < kChunks) hopper::mbar_signal_rank(&sm.pd_free[buf], lane);
      }
    }
    // Every CTA's row sums have arrived (the exchange warps' stores before
    // the cluster barrier); after it no peer touches this CTA's memory.
    hopper::cluster_sync();
    // acc[4j + 2a + e]: q row q0 + r_lo + 8a, column c kD + 8j + 2 (lane
    // % 4) + e.
    bf16* O = static_cast<bf16*>(p.o);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = r_lo + 8 * a;
      if (q0 + r >= p.Sq) continue;
      const float lf = sm.lsum[r];
      bf16* o = O + (static_cast<long long>(bh) * p.Sq + q0 + r) * kDW +
                c * kD + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) =
            pack_bf16(acc[4 * j + 2 * a] / lf, acc[4 * j + 2 * a + 1] / lf);
    }
  }
}

// bf16 at D = 640: clusters of 5 CTAs.
__global__ void __cluster_dims__(5, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_bf16_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const FwdArgs p) {
  fwd_cluster<5>(tq, tk, tv, p);
}

// bf16 at D = 1024: clusters of 8 CTAs, the largest portable cluster. Each
// CTA's exchange owns 16 of the 128 q rows.
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_bf16_d1024_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const FwdArgs p) {
  fwd_cluster<8>(tq, tk, tv, p);
}

// bf16 at D = 512: clusters of 4 CTAs. Each CTA's exchange owns 32 of the 128
// q rows, 16 lanes a row in four row slots: every lane of it, four times.
__global__ void __cluster_dims__(4, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_bf16_d512_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const FwdArgs p) {
  fwd_cluster<4>(tq, tk, tv, p);
}

// bf16 at D = 384: clusters of 3 CTAs. Each CTA's exchange owns 42 or 43 of
// the 128 q rows, 16 lanes a row in six row slots of 8, the sixth 2 or 3
// rows full.
__global__ void __cluster_dims__(3, 1, 1) __launch_bounds__(kThreads, 1)
flash_fwd_bf16_d384_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const FwdArgs p) {
  fwd_cluster<3>(tq, tk, tv, p);
}

}  // namespace bf16c

// ---------------------------------------------------------------------------
// Generic variant: every dtype and head_dim (a multiple of 128) but bf16 D =
// 128, D = 256, D = 384, D = 512, D = 640 and D = 1024, which the kernels
// above serve. Scalar FMAs on the CUDA cores over f32 tiles in dynamic shared
// memory: 32 q rows per block, 4 threads per row, 16-row KV tiles, the same
// online softmax with P rounded to the input dtype before P V. f32 D128 runs
// in one chunk (DC = D). Above 512, D is cut into chunks of DC = 256
// or 128 columns (flash::gen_chunk; the chunked instances): the grid's z axis
// gives each block one chunk of O's columns, held in registers (acc[DC /
// 4]), and the scores S = Q K^T are summed over the chunks staged one at a
// time through shared memory. So shared memory (67 KB
// at most, DC = 256) and registers stay bounded at any D. The f32 instances of
// 256- and 128-column chunks serve only D768, 1280, ... and D896, 1152, ...
// (f32 D640 and 1024 are the cluster kernels'), and so do the bf16 ones (bf16
// D640 and 1024 are the cluster kernels'). With more than one
// chunk a block reloads Q's chunks for every KV tile, and every block
// recomputes the scores: D / DC times the score work of one chunk, right and
// slow first. Each thread takes 4 scores of its row (columns c, c + 4, ...) and
// a quarter of its chunk's columns as interleaved float4s, so a warp's shared
// loads fall in distinct banks. It is bound by shared-memory reads (5 float4
// loads per 16 FMAs of the scores, 1 per 4 of P V), well below the 67 TFLOP/s
// of the f32 FMA units; simple first, as the serving and training paths run
// bf16 D = 128.
// ---------------------------------------------------------------------------

constexpr int kGBM = 32;  // q rows per block, 4 threads per row
constexpr int kGBN = 16;  // KV rows per tile

template <int DC>
constexpr int gen_smem_bytes() {
  return ((kGBM + 2 * kGBN) * (DC + 4) + kGBM * (kGBN + 1)) * 4;
}

template <typename T, int DC, bool kChunked>
__device__ __forceinline__ void flash_fwd_generic_body(const Params& p) {
  extern __shared__ float4 gen_smem[];
  constexpr int kP = DC + 4;        // row pitch of the f32 tiles
  constexpr int kPP = kGBN + 1;     // row pitch of P
  float* Qs = reinterpret_cast<float*>(gen_smem);
  float* Ks = Qs + kGBM * kP;
  float* Vs = Ks + kGBN * kP;
  float* Ps = Vs + kGBN * kP;

  const int tid = threadIdx.x;
  const int r = tid / 4;  // row of the q tile
  const int c = tid % 4;  // this thread's share of the columns
  const int n_qt = gridDim.x;
  const int qt = p.causal ? (n_qt - 1 - blockIdx.x) : blockIdx.x;
  const int bh = blockIdx.y;
  const int n_dc = kChunked ? gridDim.z : 1;  // chunks of D
  const int oc = kChunked ? blockIdx.z : 0;   // the chunk of O this writes
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kGBM;
  const int row = q0 + r;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V =
      static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + oc * DC;
  if (n_dc == 1)
    flash::load_tile<T, DC>(Qs, Q, p.q_ss, q0, kGBM, p.Sq, tid, 128);

  float acc[DC / 4];
#pragma unroll
  for (int i = 0; i < DC / 4; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = kv_tiles(p, q0, kGBM, kGBN);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kGBN;
    float4 dot[kGBN / 4];
#pragma unroll
    for (int i = 0; i < kGBN / 4; ++i) dot[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // Q is stored / the last chunk's readers are done
      if (n_dc > 1)
        flash::load_tile<T, DC>(Qs, Q + dc * DC, p.q_ss, q0, kGBM, p.Sq, tid,
                                128);
      flash::load_tile<T, DC>(Ks, K + dc * DC, p.k_ss, k0, kGBN, p.Skv, tid,
                              128);
      if (dc == n_dc - 1)
        flash::load_tile<T, DC>(Vs, V, p.v_ss, k0, kGBN, p.Skv, tid, 128);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {
        const float4 q4 = flash::ld4(Qs + r * kP + d);
#pragma unroll
        for (int i = 0; i < kGBN / 4; ++i)
          flash::fma4(dot[i], q4, flash::ld4(Ks + (c + 4 * i) * kP + d));
      }
    }
    float sv[kGBN / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kGBN / 4; ++i) {
      const int col = k0 + c + 4 * i;
      float x = flash::hsum(dot[i]) * p.scale;
      if (col >= p.Skv || (p.causal && col > row)) x = kMaskValue;
      sv[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kGBN / 4; ++i) {
      const float e = expf(sv[i] - mn);
      Ps[r * kPP + c + 4 * i] = flash::Elem<T>::round(e);  // P as V's dtype
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    __syncwarp();  // the 4 threads of row r share Ps[r]
#pragma unroll
    for (int i = 0; i < DC / 4; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int j = 0; j < kGBN; ++j) {
      const float pj = Ps[r * kPP + j];
#pragma unroll
      for (int q = 0; q < DC / 16; ++q) {
        const float4 v4 = flash::ld4(Vs + j * kP + 4 * (c + 4 * q));
        acc[4 * q] = fmaf(pj, v4.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(pj, v4.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(pj, v4.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(pj, v4.w, acc[4 * q + 3]);
      }
    }
  }

  if (row < p.Sq) {
    l = fmaxf(l, 1e-30f);
    T* O = static_cast<T*>(p.o) +
           (static_cast<long long>(bh) * p.Sq + row) * (DC * n_dc) + oc * DC;
#pragma unroll
    for (int q = 0; q < DC / 16; ++q)
      flash::Elem<T>::store4(
          O + 4 * (c + 4 * q),
          make_float4(acc[4 * q] / l, acc[4 * q + 1] / l, acc[4 * q + 2] / l,
                      acc[4 * q + 3] / l));
    if (c == 0 && oc == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] = m + logf(l);
  }
}

// One block per (q tile, b * h): f32 D = kD, in one chunk.
template <typename T, int DC>
__global__ void __launch_bounds__(128)
flash_fwd_generic_kernel(const Params p) {
  flash_fwd_generic_body<T, DC, false>(p);
}

// One block per (q tile, b * h, chunk of D): D above 4 kD.
template <typename T, int DC>
__global__ void __launch_bounds__(128, 1)
flash_fwd_generic_chunked_kernel(const Params p) {
  flash_fwd_generic_body<T, DC, true>(p);
}

template <typename T, int DC, bool kChunked>
int launch_generic(const Params& p, int D, int B, cudaStream_t st) {
  constexpr int smem = gen_smem_bytes<DC>();
  void (*kernel)(const Params);
  if constexpr (kChunked)
    kernel = flash_fwd_generic_chunked_kernel<T, DC>;
  else
    kernel = flash_fwd_generic_kernel<T, DC>;
  const cudaError_t err = flash::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + kGBM - 1) / kGBM, B * p.H, D / DC);
  kernel<<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Picks the generic instance by D (a multiple of kD, checked by the caller)
// and dtype: D itself for f32 at kD, above 4 kD a chunk of
// flash::gen_chunk(D) columns (D = 5 kD and 8 kD are the cluster kernels').
// No bf16 forward runs a one-chunk instance: bf16 at kD and 2 kD is the
// wgmma kernel's, at 3 kD and 4 kD the cluster kernels', as is f32 at 2 kD,
// 3 kD and 4 kD, so the caller sends only f32 at kD here below 5 kD.
int launch_generic_d(const Params& p, int D, int dtype, int B,
                     cudaStream_t st) {
  if (D > 4 * kD) {
    const bool wide = flash::gen_chunk(D) == 2 * kD;
    if (dtype == 1)
      return wide ? launch_generic<bf16, 2 * kD, true>(p, D, B, st)
                  : launch_generic<bf16, kD, true>(p, D, B, st);
    return wide ? launch_generic<float, 2 * kD, true>(p, D, B, st)
                : launch_generic<float, kD, true>(p, D, B, st);
  }
  return launch_generic<float, kD, false>(p, D, B, st);
}

// f32 at D = kChunks kD (2, 3, 4, 5 or 8): one cluster of kChunks CTAs per 128
// q rows, on `kernel`, the instance of that size. A launch the card refuses
// (no room for a cluster) returns its error. The shared-memory opt-in is set
// at every launch, as for the generic variants.
template <int kChunks, typename Kernel>
int launch_cluster(Kernel kernel, const Params& p, int B, cudaStream_t st) {
  constexpr int D = kChunks * kD;
  CUtensorMap tq, tk, tv;
  if (!flash::make_f32_map(&tq, p.q, B, p.H, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                           f32c::kBM, D, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !flash::make_f32_map(&tk, p.k, B, p.KVH, p.Skv, p.k_sb, p.k_sh,
                           p.k_ss, f32c::kBN, D, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !flash::make_f32_map(&tv, p.v, B, p.KVH, p.Skv, p.v_sb, p.v_sh,
                           p.v_ss, f32c::kBN, D, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = flash::allow_smem(kernel, f32c::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.Sq + f32c::kBM - 1) / f32c::kBM;
  kernel<<<B * p.H * n_qt * kChunks, f32c::kThreads, f32c::kSmemBytes, st>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D = kChunks kD (3, 4, 5 or 8): one cluster of kChunks CTAs per
// 128 q rows, on `kernel`, the instance of that size, with 128B-swizzled
// 64-column boxes of q, k and v. A launch the card refuses returns its
// error. The shared-memory opt-in is set at every launch.
template <int kChunks, typename Kernel>
int launch_bf16_cluster(Kernel kernel, const Params& p, int B,
                        cudaStream_t st) {
  constexpr int D = kChunks * kD;
  CUtensorMap tq, tk, tv;
  if (!flash::make_bhsd_map(&tq, p.q, B, p.H, p.Sq, p.q_sb, p.q_sh, p.q_ss,
                            bf16c::kBM, D) ||
      !flash::make_bhsd_map(&tk, p.k, B, p.KVH, p.Skv, p.k_sb, p.k_sh,
                            p.k_ss, bf16c::kBN, D) ||
      !flash::make_bhsd_map(&tv, p.v, B, p.KVH, p.Skv, p.v_sb, p.v_sh,
                            p.v_ss, bf16c::kBN, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = flash::allow_smem(kernel, bf16c::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.Sq + bf16c::kBM - 1) / bf16c::kBM;
  const FwdArgs a{p.o, p.lse, p.H, p.KVH, p.Sq, p.Skv, n_qt,
                  p.scale * kLog2e, p.causal};
  kernel<<<B * p.H * n_qt * kChunks, bf16c::kThreads, bf16c::kSmemBytes,
           st>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of the f32 D = 640 kernel the current device holds at
// once (cudaOccupancyMaxActiveClusters at its shared memory), into
// *clusters. Returns the CUDA error.
extern "C" int ray_flash_fwd_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_fwd_f32_cluster_kernel, 5,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 1024 kernel (clusters of 8).
extern "C" int ray_flash_fwd_f32_d1024_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_fwd_f32_d1024_cluster_kernel, 8,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 512 kernel (clusters of 4).
extern "C" int ray_flash_fwd_f32_d512_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_fwd_f32_d512_cluster_kernel, 4,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 384 kernel (clusters of 3).
extern "C" int ray_flash_fwd_f32_d384_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_fwd_f32_d384_cluster_kernel, 3,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the f32 D = 256 kernel (clusters of 2).
extern "C" int ray_flash_fwd_f32_d256_max_clusters(int* clusters) {
  return flash::max_clusters(f32c::flash_fwd_f32_d256_cluster_kernel, 2,
                             f32c::kThreads, f32c::kSmemBytes, clusters);
}

// The same for the bf16 D = 640 kernel (clusters of 5).
extern "C" int ray_flash_fwd_bf16_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_fwd_bf16_cluster_kernel, 5,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 1024 kernel (clusters of 8).
extern "C" int ray_flash_fwd_bf16_d1024_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_fwd_bf16_d1024_cluster_kernel, 8,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 512 kernel (clusters of 4).
extern "C" int ray_flash_fwd_bf16_d512_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_fwd_bf16_d512_cluster_kernel, 4,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The same for the bf16 D = 384 kernel (clusters of 3).
extern "C" int ray_flash_fwd_bf16_d384_max_clusters(int* clusters) {
  return flash::max_clusters(bf16c::flash_fwd_bf16_d384_cluster_kernel, 3,
                             bf16c::kThreads, bf16c::kSmemBytes, clusters);
}

// The bf16 launch at D = 128 or 256: tensor maps over q, k, v (4-D {D, S,
// heads, batch}, 128B swizzle, boxes of 64 columns x kBM or BN rows), then
// the kernel.
template <int D>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* qs, const long long* ks,
                       const long long* vs, int B, int H, int KVH, int Sq,
                       int Skv, float scale, int causal, cudaStream_t st) {
  constexpr int BN = fwd_bn<D>();
  constexpr int smem = fwd_smem_bytes<D>();
  CUtensorMap tq, tk, tv;
  if (!flash::make_bhsd_map(&tq, q, B, H, Sq, qs[0], qs[1], qs[2], kBM, D) ||
      !flash::make_bhsd_map(&tk, k, B, KVH, Skv, ks[0], ks[1], ks[2], BN,
                            D) ||
      !flash::make_bhsd_map(&tv, v, B, KVH, Skv, vs[0], vs[1], vs[2], BN, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + kBM - 1) / kBM;
  const FwdArgs a{o,   static_cast<float*>(lse), H, KVH, Sq, Skv, n_qt,
                  scale * kLog2e, causal};
  const cudaError_t err =
      hopper::opt_in_smem<D>(flash_fwd_bf16_kernel<D, BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<D, BN>
      <<<B * H * n_qt, 128 * (1 + kConsumers), smem, st>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// q [B, H, Sq, D], k/v [B, KVH, Skv, D] given by element strides (batch,
// head, seq; the last dim dense); o [B, H, Sq, D] and lse [B, H, Sq] dense.
// D is a multiple of 128; dtype: 0 = float32, 1 = bfloat16. bf16 at
// D = 128 and 256 runs the wgmma kernel, f32 at D = 256 a cluster kernel of
// 2 CTAs, D = 384 one of 3, 512 one of 4, 640 one of 5 and 1024 one of 8
// (f32 or bf16), every other case the generic variant. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape or
// layout the kernels do not take: every stride and the base addresses must
// be multiples of 16 bytes, as TMA and the 16-byte loads require).
extern "C" int ray_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, int B, int H,
                             int KVH, int Sq, int Skv, int D, float scale,
                             int causal, int dtype, void* stream) {
  if (D % kD != 0 || D < kD || B < 1 || H < 1 || KVH < 1 ||
      H % KVH != 0 || Sq < 1 || Skv < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == kD || D == 2 * kD)) {
    const long long qs[3] = {q_sb, q_sh, q_ss};
    const long long ks[3] = {k_sb, k_sh, k_ss};
    const long long vs[3] = {v_sb, v_sh, v_ss};
    return D == kD ? launch_bf16<kD>(q, k, v, o, lse, qs, ks, vs, B, H, KVH,
                                     Sq, Skv, scale, causal, st)
                   : launch_bf16<2 * kD>(q, k, v, o, lse, qs, ks, vs, B, H,
                                         KVH, Sq, Skv, scale, causal, st);
  }
  const Params p{q,    k,    v,    o,    static_cast<float*>(lse),
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 H,    KVH,  Sq,   Skv,  scale, causal};
  if (dtype == 0 && D == 2 * kD)
    return launch_cluster<2>(f32c::flash_fwd_f32_d256_cluster_kernel, p, B,
                             st);
  if (dtype == 0 && D == 3 * kD)
    return launch_cluster<3>(f32c::flash_fwd_f32_d384_cluster_kernel, p, B,
                             st);
  if (dtype == 0 && D == 4 * kD)
    return launch_cluster<4>(f32c::flash_fwd_f32_d512_cluster_kernel, p, B,
                             st);
  if (dtype == 0 && D == 5 * kD)
    return launch_cluster<5>(f32c::flash_fwd_f32_cluster_kernel, p, B, st);
  if (dtype == 0 && D == 8 * kD)
    return launch_cluster<8>(f32c::flash_fwd_f32_d1024_cluster_kernel, p, B,
                             st);
  if (dtype == 1 && D == 3 * kD)
    return launch_bf16_cluster<3>(bf16c::flash_fwd_bf16_d384_cluster_kernel,
                                  p, B, st);
  if (dtype == 1 && D == 4 * kD)
    return launch_bf16_cluster<4>(bf16c::flash_fwd_bf16_d512_cluster_kernel,
                                  p, B, st);
  if (dtype == 1 && D == 5 * kD)
    return launch_bf16_cluster<5>(bf16c::flash_fwd_bf16_cluster_kernel, p, B,
                                  st);
  if (dtype == 1 && D == 8 * kD)
    return launch_bf16_cluster<8>(bf16c::flash_fwd_bf16_d1024_cluster_kernel,
                                  p, B, st);
  return launch_generic_d(p, D, dtype, B, st);
}
