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
// That kernel serves bf16 at head_dim 128. A generic variant (at the end of
// this file) serves f32 at head_dim 128 and 256 and bf16 at 256, with P
// and dS rounded to the input dtype as the Pallas kernel rounds them.

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

// P^T in place: st[4j + 2a + b] holds KV row r_lo + 8a (r_lo = this
// thread's first row), q column q0 + 8j + 2(lane % 4) + b. diag = r_lo -
// q0: a score is masked (causal) where its q column is below its KV row.
// The unmasked instance carries no mask code.
template <bool kMasked>
__device__ __forceinline__ void probs(float (&st)[32], const float* lse,
                                      float c, int diag, int lane) {
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j) {
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

__device__ __forceinline__ void probs(float (&st)[32], bool masked,
                                      const float* lse, float c, int diag,
                                      int lane) {
  if (masked)
    probs<true>(st, lse, c, diag, lane);
  else
    probs<false>(st, lse, c, diag, lane);
  // Keep P ahead of the wait for dP^T: without these ties the compiler may
  // sink the exponentials below it, and nothing would overlap.
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::fence_reg(st[i]);
}

// dS^T = P^T (dP^T - delta) * scale in place of dP^T (delta by q column).
__device__ __forceinline__ void dscores(float (&dpt)[32],
                                        const float (&st)[32],
                                        const float* delta, float scale,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < kBQ / 8; ++j) {
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
      probs(st, masked, sm.lse[s], p.scale_log2, r_lo - q0, lane);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) hopper::fence_reg(dpt[i]);
      dscores(dpt, st, sm.delta[s], p.scale, lane);
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
// Generic variant: f32 at D = 128 and 256, bf16 at D = 256 (everything but
// bf16 D = 128, which the wgmma kernel above serves). The same function on
// the CUDA cores: one block of 128 threads per (b, KV head, 16 KV rows),
// walking the group's query heads and their 32-row q tiles as the kernel
// above does, with K, V, Q, dO as f32 tiles in dynamic shared memory (104 KB
// at D = 256). Each thread holds 4 entries of P^T and dS^T (KV row tid / 8,
// q columns tid % 8 + 8i; P rounded to v's dtype, dS to q's) and an eighth
// of its KV row's dK and dV columns as interleaved float4s, in f32 registers
// for the whole loop, so the group's query heads are summed in f32 with no
// atomics. Bound by shared-memory reads, not by the FMA rate; simple first.
// ---------------------------------------------------------------------------

constexpr int kGBKV = 16;  // KV rows per block, 8 threads per row
constexpr int kGBQ = 32;   // q rows per tile

template <int D>
constexpr int gen_smem_bytes() {
  return ((2 * kGBKV + 2 * kGBQ) * (D + 4) + 2 * kGBKV * (kGBQ + 1) +
          2 * kGBQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_generic_kernel(const flash::BwdParams p) {
  extern __shared__ float4 gen_smem[];
  constexpr int kP = D + 4;       // row pitch of the f32 tiles
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
  // KV tiles see the most q tiles, so they start first.
  const int n_kvt = (p.Skv + kGBKV - 1) / kGBKV;
  const int n_bk = gridDim.x / n_kvt;  // B * KVH
  const int bk = blockIdx.x % n_bk;
  const int kvt = blockIdx.x / n_bk;
  const int kvh = bk % p.KVH;
  const int b = bk / p.KVH;
  const int G = p.H / p.KVH;
  const int k0 = kvt * kGBKV;
  const int krow = k0 + kr;
  const int n_qt = (p.Sq + kGBQ - 1) / kGBQ;
  // Causal: q tiles wholly before this KV tile see none of it.
  const int qt_first = p.causal ? min(k0 / kGBQ, n_qt) : 0;

  flash::load_tile<T, D>(
      Ks, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
      kGBKV, p.Skv, tid, 128);
  flash::load_tile<T, D>(
      Vs, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
      kGBKV, p.Skv, tid, 128);

  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dk[i] = dv[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dO = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kGBQ;
      __syncthreads();  // K, V stored / the last tile's readers are done
      flash::load_tile<T, D>(Qs, Q, p.q_ss, q0, kGBQ, p.Sq, tid, 128);
      flash::load_tile<T, D>(Os, dO, p.o_ss, q0, kGBQ, p.Sq, tid, 128);
      for (int i = tid; i < kGBQ; i += 128) {  // +inf / 0 past Sq: P = 0
        const int r = q0 + i;
        Ls[i] = r < p.Sq ? p.lse[row0 + r] : INFINITY;
        Ds[i] = r < p.Sq ? p.delta[row0 + r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T entries (krow, q0 + cc + 8i)
      float4 s4[kGBQ / 8], p4[kGBQ / 8];
#pragma unroll
      for (int i = 0; i < kGBQ / 8; ++i)
        s4[i] = p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = flash::ld4(Ks + kr * kP + d);
        const float4 v4 = flash::ld4(Vs + kr * kP + d);
#pragma unroll
        for (int i = 0; i < kGBQ / 8; ++i) {
          const int j = cc + 8 * i;
          flash::fma4(s4[i], k4, flash::ld4(Qs + j * kP + d));
          flash::fma4(p4[i], v4, flash::ld4(Os + j * kP + d));
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

      // dV += P^T dO, dK += dS^T Q over the tile's q rows
#pragma unroll 4
      for (int j = 0; j < kGBQ; ++j) {
        const float pj = Pt[kr * kPT + j];
        const float sj = St[kr * kPT + j];
#pragma unroll
        for (int q = 0; q < D / 32; ++q) {
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
        ((static_cast<long long>(b) * p.KVH + kvh) * p.Skv + krow) * D;
    T* dK = static_cast<T*>(p.out0) + o;
    T* dV = static_cast<T*>(p.out1) + o;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
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

template <typename T, int D>
int launch_generic(const flash::BwdParams& p, int B, cudaStream_t st) {
  constexpr int smem = gen_smem_bytes<D>();
  const cudaError_t err =
      flash::allow_smem(flash_bwd_dkv_generic_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kvt = (p.Skv + kGBKV - 1) / kGBKV;
  flash_bwd_dkv_generic_kernel<T, D><<<B * p.KVH * n_kvt, 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/dO [B, H, Sq, D] and k/v [B, KVH, Skv, D] given by element strides
// (batch, head, seq; the last dim dense, every stride and base address a
// multiple of 16 bytes, as TMA and the 16-byte loads require); lse and delta
// [B, H, Sq] f32 and dk/dv [B, KVH, Skv, D] dense, in the inputs' dtype. D
// is 128 or 256; dtype: 0 = float32, 1 = bfloat16. bf16 at D = 128 runs the
// wgmma kernel, every other case the generic variant. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape or
// layout the kernels do not take).
extern "C" int ray_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int KVH,
    int Sq, int Skv, int D, float scale, int causal, int dtype,
    void* stream) {
  if ((D != kD && D != 2 * kD) || B < 1 || H < 1 || KVH < 1 ||
      H % KVH != 0 || Sq < 1 || Skv < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || D != kD) {
    const flash::BwdParams p{
        q,    k,    v,    dout, static_cast<const float*>(lse),
        static_cast<const float*>(delta), dk, dv,
        q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
        o_sb, o_sh, o_ss, H,    KVH,  Sq,   Skv,  scale, causal};
    if (dtype == 1) return launch_generic<bf16, 2 * kD>(p, B, st);
    if (D == kD) return launch_generic<float, kD>(p, B, st);
    return launch_generic<float, 2 * kD>(p, B, st);
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!flash::make_bhsd_map(&tq, q, B, H, Sq, q_sb, q_sh, q_ss, kBQ) ||
      !flash::make_bhsd_map(&tk, k, B, KVH, Skv, k_sb, k_sh, k_ss, kBKV) ||
      !flash::make_bhsd_map(&tv, v, B, KVH, Skv, v_sb, v_sh, v_ss, kBKV) ||
      !flash::make_bhsd_map(&tdo, dout, B, H, Sq, o_sb, o_sh, o_ss, kBQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_kvt = (Skv + kBKV - 1) / kBKV;
  const DkvArgs a{static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv),
                  H, KVH, Sq, Skv, n_kvt,
                  scale * kLog2e, scale, causal};
  const cudaError_t err =
      hopper::opt_in_smem(flash_bwd_dkv_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<B * KVH * n_kvt, 128 * (1 + kConsumers), kSmemBytes,
                         st>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}
