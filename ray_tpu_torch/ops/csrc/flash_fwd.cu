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
// A generic scalar-FMA variant serves f32 (D = 128 and 256) and bf16 at
// D = 256.

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
// 128-row KV tiles in a 2-stage ring (TMA + mbarriers), wgmma.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;  // consumer warpgroups, 64 q rows each
constexpr int kBM = 64 * kConsumers;  // q rows per block
constexpr int kBN = 128;       // KV rows per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kTileBytes = kBN * kD * 2;  // one K or V tile, 32 KB

struct __align__(1024) FwdSmem {
  bf16 q[2][kBM * kHalf];             // two 64-column halves
  bf16 k[kStages][2][kBN * kHalf];
  bf16 v[kStages][2][kBN * kHalf];
  uint64_t q_full;
  uint64_t k_full[kStages];   // TMA bytes of K have landed
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];  // every consumer warp is done with K
  uint64_t v_empty[kStages];
};

// + slack to align the base to 1024 bytes: 165,888 bytes in all.
constexpr int kSmemBytes = static_cast<int>(sizeof(FwdSmem)) + 1024;

struct FwdArgs {
  void* o;
  float* lse;
  int H, KVH, Sq, Skv, n_qt;
  float scale_log2;  // scale * log2(e): scores are kept in log2 units
  int causal;
};

constexpr uint32_t kKvHalfBytes = kBN * kHalf * 2;

// Issue O += P V as one wgmma group: P (bf16) is the register A operand, V
// is [kv][d] in shared memory with d contiguous (MN-major).
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v_base) {
  hopper::wgmma_fence();
  flash::mma_rs(o, pa, v_base, kKvHalfBytes);
  hopper::wgmma_commit();
}

// Online softmax of one S tile in place (scores in log2 units): scale,
// mask (kMasked: the diagonal tile or a ragged KV edge), new row max, P =
// 2^(x - m); updates m and this thread's partial row sums l, returns the
// factors that rescale O. The unmasked instance carries no mask code.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], const FwdArgs& p,
                                             int k0, int r_lo,
                                             int lane, float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& corr_lo,
                                             float& corr_hi) {
  const float c = p.scale_log2;
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
  if (kMasked) {  // scale, then mask: sc holds log2-unit scores
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
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
    for (int j = 0; j < kBN / 8; ++j) {
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
  for (int j = 0; j < kBN / 8; ++j) {
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

__device__ __forceinline__ void softmax_tile(float (&sc)[64], const FwdArgs& p,
                                             bool masked, int k0, int r_lo,
                                             int lane, float& m_lo,
                                             float& m_hi, float& l_lo,
                                             float& l_hi, float& corr_lo,
                                             float& corr_hi) {
  if (masked)
    softmax_tile<true>(sc, p, k0, r_lo, lane, m_lo, m_hi, l_lo, l_hi,
                       corr_lo, corr_hi);
  else
    softmax_tile<false>(sc, p, k0, r_lo, lane, m_lo, m_hi, l_lo, l_hi,
                        corr_lo, corr_hi);
  // Keep the softmax ahead of the next wgmma wait: without these ties the
  // compiler may sink the exponentials below it, and the softmax would no
  // longer run under the other product.
#pragma unroll
  for (int i = 0; i < 64; ++i) hopper::fence_reg(sc[i]);
  hopper::fence_reg(l_lo);
  hopper::fence_reg(l_hi);
  hopper::fence_reg(corr_lo);
  hopper::fence_reg(corr_hi);
}

__global__ void __launch_bounds__(128 * (1 + kConsumers), 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const FwdArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
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
    // ---------------- producer: one thread issues every TMA load --------
    // K of a stage is refilled once both consumers have S = Q K^T of it,
    // V once they have O += P V of it.
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&sm.q_full, kBM * kD * 2);
      hopper::tma_load_4d(sm.q[0], &tq, &sm.q_full, 0, q0, h, b);
      hopper::tma_load_4d(sm.q[1], &tq, &sm.q_full, kHalf, q0, h, b);
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

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 units
    float l_lo = 0.f, l_hi = 0.f;  // this thread's partial row sums
    float corr_lo, corr_hi;
    float sc[64];
    uint32_t pa[kBN / 16][4];

    constexpr uint32_t q_half_bytes = kBM * kHalf * 2;
    const uint32_t q_base = hopper::smem_u32(sm.q[0]) + cw * 64 * 128;
    auto masked = [&](int k0) {
      return (k0 + kBN > p.Skv) || (p.causal && k0 + kBN - 1 > row_c);
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
    flash::issue_abt<kBN>(sc, q_base, q_half_bytes,  // S = Q K^T
                          hopper::smem_u32(sm.k[0][0]), kKvHalfBytes);
    pass_turn();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_reg(sc[i]);
    release(&sm.k_empty[0], lane);
    softmax_tile(sc, p, masked(0), 0, r_lo, lane, m_lo, m_hi, l_lo, l_hi,
                 corr_lo, corr_hi);
    flash::pack_a(pa, sc);  // P as the next A operand

    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      const int k0 = kt * kBN;
      hopper::mbar_wait(&sm.k_full[s], (kt / kStages) & 1);
      hopper::mbar_wait(&sm.v_full[sp], ((kt - 1) / kStages) & 1);
      my_turn();
      flash::issue_abt<kBN>(sc, q_base, q_half_bytes,
                            hopper::smem_u32(sm.k[s][0]), kKvHalfBytes);
      issue_pv(o, pa, hopper::smem_u32(sm.v[sp][0]));
      pass_turn();
      hopper::wgmma_wait<1>();  // S of tile kt is done, P V may still run
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_reg(sc[i]);
      release(&sm.k_empty[s], lane);
      softmax_tile(sc, p, masked(k0), k0, r_lo, lane, m_lo, m_hi, l_lo,
                   l_hi, corr_lo, corr_hi);
      hopper::wgmma_wait<0>();  // P V of tile kt - 1 is done
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_reg(o[i]);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) hopper::fence_reg(pa[kk][i]);
      release(&sm.v_empty[sp], lane);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[4 * j] *= corr_lo;
        o[4 * j + 1] *= corr_lo;
        o[4 * j + 2] *= corr_hi;
        o[4 * j + 3] *= corr_hi;
      }
      flash::pack_a(pa, sc);
    }
    const int sl = (n_kt - 1) % kStages;
    hopper::mbar_wait(&sm.v_full[sl], ((n_kt - 1) / kStages) & 1);
    my_turn();
    issue_pv(o, pa, hopper::smem_u32(sm.v[sl][0]));
    pass_turn();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_reg(o[i]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::fence_reg(pa[kk][i]);
    release(&sm.v_empty[sl], lane);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    l_lo = fmaxf(l_lo, 1e-30f);
    l_hi = fmaxf(l_hi, 1e-30f);
    const long long bh = static_cast<long long>(b) * p.H + h;
    bf16* O = static_cast<bf16*>(p.o) + bh * p.Sq * kD;
    float* LSE = p.lse + bh * p.Sq;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = j * 8 + (lane % 4) * 2;
      if (r_lo < p.Sq)
        *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r_lo) * kD +
                                     c) =
            pack_bf16(o[4 * j] / l_lo, o[4 * j + 1] / l_lo);
      if (r_hi < p.Sq)
        *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r_hi) * kD +
                                     c) =
            pack_bf16(o[4 * j + 2] / l_hi, o[4 * j + 3] / l_hi);
    }
    if (lane % 4 == 0) {
      if (r_lo < p.Sq) LSE[r_lo] = m_lo * kLn2 + logf(l_lo);
      if (r_hi < p.Sq) LSE[r_hi] = m_hi * kLn2 + logf(l_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// Generic variant: f32 at D = 128 and 256, bf16 at D = 256 (everything but
// bf16 D = 128, which the wgmma kernel above serves). Scalar FMAs on the
// CUDA cores over f32 tiles in dynamic shared memory (D = 256 needs 69 KB,
// above the 48 KB of static memory): 32 q rows per block, 4 threads per row,
// 16-row KV tiles, the same online softmax with P rounded to the input dtype
// before P V. Each thread takes 4 scores of its row (columns c, c + 4, ...)
// and a quarter of O's columns as interleaved float4s, so a warp's shared
// loads fall in distinct banks. It is bound by shared-memory reads (5 float4
// loads per 16 FMAs of the scores, 1 per 4 of P V), well below the 67
// TFLOP/s of the f32 FMA units; simple first, as the serving and training
// paths run bf16 D = 128.
// ---------------------------------------------------------------------------

constexpr int kGBM = 32;  // q rows per block, 4 threads per row
constexpr int kGBN = 16;  // KV rows per tile

template <int D>
constexpr int gen_smem_bytes() {
  return ((kGBM + 2 * kGBN) * (D + 4) + kGBM * (kGBN + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_fwd_generic_kernel(const Params p) {
  extern __shared__ float4 gen_smem[];
  constexpr int kP = D + 4;         // row pitch of the f32 tiles
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
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kGBM;
  const int row = q0 + r;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  flash::load_tile<T, D>(Qs, Q, p.q_ss, q0, kGBM, p.Sq, tid, 128);

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = kv_tiles(p, q0, kGBM, kGBN);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kGBN;
    __syncthreads();  // Q is stored / the last tile's readers are done
    flash::load_tile<T, D>(Ks, K, p.k_ss, k0, kGBN, p.Skv, tid, 128);
    flash::load_tile<T, D>(Vs, V, p.v_ss, k0, kGBN, p.Skv, tid, 128);
    __syncthreads();

    float4 dot[kGBN / 4];
#pragma unroll
    for (int i = 0; i < kGBN / 4; ++i) dot[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 q4 = flash::ld4(Qs + r * kP + d);
#pragma unroll
      for (int i = 0; i < kGBN / 4; ++i)
        flash::fma4(dot[i], q4, flash::ld4(Ks + (c + 4 * i) * kP + d));
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
    for (int i = 0; i < D / 4; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int j = 0; j < kGBN; ++j) {
      const float pj = Ps[r * kPP + j];
#pragma unroll
      for (int q = 0; q < D / 16; ++q) {
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
           (static_cast<long long>(bh) * p.Sq + row) * D;
#pragma unroll
    for (int q = 0; q < D / 16; ++q)
      flash::Elem<T>::store4(
          O + 4 * (c + 4 * q),
          make_float4(acc[4 * q] / l, acc[4 * q + 1] / l, acc[4 * q + 2] / l,
                      acc[4 * q + 3] / l));
    if (c == 0) p.lse[static_cast<long long>(bh) * p.Sq + row] = m + logf(l);
  }
}

template <typename T, int D>
int launch_generic(const Params& p, int B, cudaStream_t st) {
  constexpr int smem = gen_smem_bytes<D>();
  const cudaError_t err =
      flash::allow_smem(flash_fwd_generic_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Sq + kGBM - 1) / kGBM, B * p.H);
  flash_fwd_generic_kernel<T, D><<<grid, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 launch: tensor maps over q, k, v (4-D {D, S, heads, batch},
// 128B swizzle, boxes of 64 columns x kBM or kBN rows), then the kernel.
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* qs, const long long* ks,
                       const long long* vs, int B, int H, int KVH, int Sq,
                       int Skv, float scale, int causal, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!flash::make_bhsd_map(&tq, q, B, H, Sq, qs[0], qs[1], qs[2], kBM) ||
      !flash::make_bhsd_map(&tk, k, B, KVH, Skv, ks[0], ks[1], ks[2], kBN) ||
      !flash::make_bhsd_map(&tv, v, B, KVH, Skv, vs[0], vs[1], vs[2], kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + kBM - 1) / kBM;
  const FwdArgs a{o,   static_cast<float*>(lse), H, KVH, Sq, Skv, n_qt,
                  scale * kLog2e, causal};
  const cudaError_t err =
      hopper::opt_in_smem(flash_fwd_bf16_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<<<B * H * n_qt, 128 * (1 + kConsumers), kSmemBytes,
                          st>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// q [B, H, Sq, D], k/v [B, KVH, Skv, D] given by element strides (batch,
// head, seq; the last dim dense); o [B, H, Sq, D] and lse [B, H, Sq] dense.
// D is 128 or 256; dtype: 0 = float32, 1 = bfloat16. bf16 at D = 128 runs
// the wgmma kernel, every other case the generic variant. Returns
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
  if ((D != kD && D != 2 * kD) || B < 1 || H < 1 || KVH < 1 ||
      H % KVH != 0 || Sq < 1 || Skv < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == kD) {
    const long long qs[3] = {q_sb, q_sh, q_ss};
    const long long ks[3] = {k_sb, k_sh, k_ss};
    const long long vs[3] = {v_sb, v_sh, v_ss};
    return launch_bf16(q, k, v, o, lse, qs, ks, vs, B, H, KVH, Sq, Skv,
                       scale, causal, st);
  }
  const Params p{q,    k,    v,    o,    static_cast<float*>(lse),
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 H,    KVH,  Sq,   Skv,  scale, causal};
  if (dtype == 1) return launch_generic<bf16, 2 * kD>(p, B, st);
  if (D == kD) return launch_generic<float, kD>(p, B, st);
  return launch_generic<float, 2 * kD>(p, B, st);
}
