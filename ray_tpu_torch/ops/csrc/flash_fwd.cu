// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`, launched by
// `_flash_fwd_pallas` (ray_tpu/ops/attention.py:84-179). It computes the
// same function: O = softmax(q k^T * scale [causal mask]) v with an online
// softmax, O = acc / max(l, 1e-30) in the input dtype and LSE = m + log(l)
// in f32, masked scores set to -0.7 * FLT_MAX as the TPU kernel does.
//
// What bounds it on the H100, and what the design does about it:
//   * Long prompts (causal FLOPs 2*S^2*D*H grow as S^2) are bound by the
//     tensor cores. The bf16 path runs every product on them with
//     mma.sync.m16n8k16 (f32 accumulation) and skips the KV tiles wholly
//     above the diagonal, as the TPU kernel does, so causal work is half of
//     the full square.
//   * Short prompts (the 32..512 token buckets) are bound by bytes: q, k, v
//     and o are read and written once. Each block keeps its running max,
//     sum and output accumulator in registers for the whole KV loop, so
//     nothing but q, k, v, o and the LSE crosses device memory; K and V
//     tiles are read once per q tile through shared memory with cp.async.
//   * The TPU kernel's sequential "arbitrary" grid axis and its VMEM
//     scratch become a loop over KV tiles inside one block per (b*h, q
//     tile): blocks run in parallel and in no order on 132 SMs, so nothing
//     may carry over between them. Tiles are 64 x 64 x 128 (bf16) instead
//     of 1024 x 1024: a block has 227 KB of shared memory, not VMEM.
//   * Grouped-query attention reads KV head h / (H / KVH) directly, so the
//     caller never materializes repeat_kv copies.
//   * No 128-multiple gate: the kernel masks a ragged edge itself, so every
//     prefill bucket (32, 64, ...) runs through it.
// A plain scalar-FMA f32 variant serves f32 inputs (D = 128 as well).
// Later work: TMA + wgmma + a producer warp, double-buffered KV tiles.

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::kD;
using flash::kLds;
using flash::kMaskValue;
using flash::ldmatrix_x4_trans;
using flash::load_tile;
using flash::mma_bf16;
using flash::pack_bf16;

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
// bf16: 4 warps, 64 q rows per block (16 per warp), 64-row KV tiles.
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = flash::kTile;

__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBN][kLds];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBN][kLds];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;    // row group inside an mma fragment
  const int tig = lane % 4;  // thread in group
  const int n_qt = gridDim.x;
  // Causal: the heaviest q tiles (most KV tiles) are launched first.
  const int qt = p.causal ? (n_qt - 1 - blockIdx.x) : blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kBM;

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.v_sb + kvh * p.v_sh;

  // This warp's two fragment rows (global q positions).
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;

  // Q A-fragments for the 8 k-steps of D = 128, held for the whole loop.
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    int c = kk * 16 + tig * 2;
    const uint32_t zero = 0u;
    qa[kk][0] = r_lo < p.Sq
        ? *reinterpret_cast<const uint32_t*>(Q + r_lo * p.q_ss + c) : zero;
    qa[kk][1] = r_hi < p.Sq
        ? *reinterpret_cast<const uint32_t*>(Q + r_hi * p.q_ss + c) : zero;
    qa[kk][2] = r_lo < p.Sq
        ? *reinterpret_cast<const uint32_t*>(Q + r_lo * p.q_ss + c + 8) : zero;
    qa[kk][3] = r_hi < p.Sq
        ? *reinterpret_cast<const uint32_t*>(Q + r_hi * p.q_ss + c + 8) : zero;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;  // this thread's partial row sums

  const int n_kt = kv_tiles(p, q0, kBM, kBN);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    load_tile(Ks, K, p.k_ss, k0, p.Skv, tid);
    cp_async_commit();
    load_tile(Vs, V, p.v_ss, k0, p.Skv, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 KV columns.
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + tig * 2];
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    // Scale, mask (diagonal tile or ragged KV edge), online softmax.
    const bool masked = (k0 + kBN > p.Skv) ||
                        (p.causal && k0 + kBN - 1 > q0);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked) {
          int col = k0 + nt * 8 + tig * 2 + (e & 1);
          int row = e < 2 ? r_lo : r_hi;
          if (col >= p.Skv || (p.causal && col > row)) x = kMaskValue;
        }
        s[nt][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = __expf(m_lo - mn_lo);
    const float corr_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn_lo);
      s[nt][1] = __expf(s[nt][1] - mn_lo);
      s[nt][2] = __expf(s[nt][2] - mn_hi);
      s[nt][3] = __expf(s[nt][3] - mn_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= corr_lo;
      acc[dt][1] *= corr_lo;
      acc[dt][2] *= corr_hi;
      acc[dt][3] *= corr_hi;
    }

    cp_async_wait<0>();
    __syncthreads();

    // acc += P V: P (bf16) is re-packed from the S accumulators as the A
    // operand; V's B fragments come transposed out of smem by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        const int vrow = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int vcol = dp * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(vb, &Vs[vrow][vcol]);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with Ks/Vs before the next load
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  l_lo = fmaxf(l_lo, 1e-30f);
  l_hi = fmaxf(l_hi, 1e-30f);

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) +
                     (static_cast<long long>(bh) * p.Sq) * kD;
  float* LSE = p.lse + static_cast<long long>(bh) * p.Sq;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    int c = dt * 8 + tig * 2;
    if (r_lo < p.Sq)
      *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r_lo) * kD + c) =
          pack_bf16(acc[dt][0] / l_lo, acc[dt][1] / l_lo);
    if (r_hi < p.Sq)
      *reinterpret_cast<uint32_t*>(O + static_cast<long long>(r_hi) * kD + c) =
          pack_bf16(acc[dt][2] / l_hi, acc[dt][3] / l_hi);
  }
  if (tig == 0) {
    if (r_lo < p.Sq) LSE[r_lo] = m_lo + logf(l_lo);
    if (r_hi < p.Sq) LSE[r_hi] = m_hi + logf(l_hi);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs, 32 q rows per block (4 threads per row), 16-row KV
// tiles. Off the serving path (the engine runs bf16); kept so f32 callers
// never fall back to the plain version on the card.
// ---------------------------------------------------------------------------

constexpr int kBM32 = 32;
constexpr int kBN32 = 16;

__global__ void __launch_bounds__(128)
flash_fwd_f32_kernel(Params p) {
  __shared__ float Qs[kBM32][kD + 1];
  __shared__ float Ks[kBN32][kD + 1];
  __shared__ float Vs[kBN32][kD];
  __shared__ float Ps[kBM32][kBN32 + 1];

  const int tid = threadIdx.x;
  const int r = tid / 4;  // row of the q tile
  const int c = tid % 4;  // this thread's share of columns
  const int n_qt = gridDim.x;
  const int qt = p.causal ? (n_qt - 1 - blockIdx.x) : blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kBM32;
  const int row = q0 + r;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < kBM32 * kD; i += 128) {
    int rr = i / kD, cc = i % kD;
    Qs[rr][cc] = q0 + rr < p.Sq ? Q[(q0 + rr) * p.q_ss + cc] : 0.f;
  }

  float acc[kD / 4];
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = kv_tiles(p, q0, kBM32, kBN32);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN32;
    __syncthreads();  // Q is stored / the last tile's readers are done
    for (int i = tid; i < kBN32 * kD; i += 128) {
      int rr = i / kD, cc = i % kD;
      bool ok = k0 + rr < p.Skv;
      Ks[rr][cc] = ok ? K[(k0 + rr) * p.k_ss + cc] : 0.f;
      Vs[rr][cc] = ok ? V[(k0 + rr) * p.v_ss + cc] : 0.f;
    }
    __syncthreads();

    float sv[kBN32 / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBN32 / 4; ++i) {
      int j = c + 4 * i;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) dot = fmaf(Qs[r][d], Ks[j][d], dot);
      float x = dot * p.scale;
      int col = k0 + j;
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
    for (int i = 0; i < kBN32 / 4; ++i) {
      float e = expf(sv[i] - mn);
      Ps[r][c + 4 * i] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    __syncwarp();  // the 4 threads of row r share Ps[r]
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBN32; ++j) a = fmaf(Ps[r][j], Vs[j][c + 4 * i], a);
      acc[i] = a;
    }
  }

  if (row < p.Sq) {
    l = fmaxf(l, 1e-30f);
    float* O = static_cast<float*>(p.o) +
               (static_cast<long long>(bh) * p.Sq + row) * kD;
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) O[c + 4 * i] = acc[i] / l;
    if (c == 0) p.lse[static_cast<long long>(bh) * p.Sq + row] = m + logf(l);
  }
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KVH, Skv, D] given by element strides (batch,
// head, seq; the last dim dense); o [B, H, Sq, D] and lse [B, H, Sq] dense.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ray_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, long long q_sb,
                             long long q_sh, long long q_ss, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, int B, int H,
                             int KVH, int Sq, int Skv, int D, float scale,
                             int causal, int dtype, void* stream) {
  if (D != kD || B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 ||
      Skv < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    static_cast<float*>(lse),
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           H,    KVH,  Sq,   Skv,  scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((Sq + kBM - 1) / kBM, B * H);
    flash_fwd_bf16_kernel<<<grid, 128, 0, st>>>(p);
  } else {
    dim3 grid((Sq + kBM32 - 1) / kBM32, B * H);
    flash_fwd_f32_kernel<<<grid, 128, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
