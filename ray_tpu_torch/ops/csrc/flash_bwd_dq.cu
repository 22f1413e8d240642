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
//     2 * 64 * 64 * 128 per tile pair (6 * B * H * D * pairs FLOP; causal
//     pairs are half the square). Every product runs on mma.sync.m16n8k16
//     bf16 with f32 accumulation, and KV tiles wholly above the diagonal
//     are never loaded; only the diagonal tile (and a ragged KV edge) is
//     masked.
//   * The TPU kernel's sequential KV grid axis and its VMEM dQ scratch
//     become a loop inside one block per (b * h, 64-row q tile). dQ (16 x
//     128 per warp) stays in f32 registers for the whole loop; Q, dO, K and
//     V tiles sit in shared memory (68 KB, dynamic), and the A fragments of
//     Q and dO come from there through ldmatrix to save registers.
//   * dS is re-packed from the accumulators into A fragments; K is the
//     non-transposed B operand of dS K, read with ldmatrix.trans.
//   * Grouped-query attention reads KV head h / (H / KVH) in place.
//   * Causal work is uneven: the last q tiles see the most KV tiles, so the
//     grid's slow axis walks q tiles from the last, heaviest, one down.
// Later work: TMA + wgmma, double-buffered K/V tiles, fusing with dK/dV.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBM = kTile;  // q rows per block, 16 per warp
constexpr int kBN = kTile;  // KV rows per tile
constexpr int kSmem = 4 * kTile * kLds * sizeof(bf16);

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, H, Sq] dense
  const float* delta;  // [B, H, Sq] dense
  bf16* dq;            // [B, H, Sq, D] dense
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim is dense
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // dO
  int H, KVH, Sq, Skv;
  float scale;
  int causal;
};

__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile Qs = reinterpret_cast<Tile>(smem);
  Tile Ds = Qs + kBM;  // dO
  Tile Ks = Ds + kBM;
  Tile Vs = Ks + kBN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int n_qt = gridDim.y;
  const int qt = p.causal ? (n_qt - 1 - blockIdx.y) : blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kBM;

  const bf16* Q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dO = p.dout + b * p.o_sb + h * p.o_sh;
  const bf16* K = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* V = p.v + b * p.v_sb + kvh * p.v_sh;
  load_tile(Qs, Q, p.q_ss, q0, p.Sq, tid);
  load_tile(Ds, dO, p.o_ss, q0, p.Sq, tid);
  cp_async_commit();

  // This warp's two fragment rows (global q positions). Rows past Sq get
  // LSE = +inf, so P = 0 there and they add nothing.
  const int r_lo = q0 + warp * 16 + g;
  const int r_hi = r_lo + 8;
  const long long row0 = static_cast<long long>(bh) * p.Sq;
  const float lse_lo = r_lo < p.Sq ? p.lse[row0 + r_lo] : INFINITY;
  const float lse_hi = r_hi < p.Sq ? p.lse[row0 + r_hi] : INFINITY;
  const float dl_lo = r_lo < p.Sq ? p.delta[row0 + r_lo] : 0.f;
  const float dl_hi = r_hi < p.Sq ? p.delta[row0 + r_hi] : 0.f;

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int kv_end = p.causal ? min(p.Skv, q0 + kBM) : p.Skv;
  const int n_kt = (kv_end + kBN - 1) / kBN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    load_tile(Ks, K, p.k_ss, k0, p.Skv, tid);
    load_tile(Vs, V, p.v_ss, k0, p.Skv, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 KV columns.
    float s[kBN / 8][4], dp[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, frag_addr(Qs, warp * 16, kk * 16, lane));
      ldmatrix_x4(da, frag_addr(Ds, warp * 16, kk * 16, lane));
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        uint32_t b0, b1;
        b_frag(b0, b1, Ks, nt * 8, kk * 16, lane);
        mma_bf16(s[nt], qa, b0, b1);
        b_frag(b0, b1, Vs, nt * 8, kk * 16, lane);
        mma_bf16(dp[nt], da, b0, b1);
      }
    }

    // P and dS (into s). Masked: the diagonal tile and a ragged KV edge.
    const bool masked = (k0 + kBN > p.Skv) ||
                        (p.causal && k0 + kBN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r_lo : r_hi;
        float x = s[nt][e] * p.scale;
        if (masked) {
          int col = k0 + nt * 8 + tig * 2 + (e & 1);
          if (col >= p.Skv || (p.causal && col > row)) x = kMaskValue;
        }
        const float pv = __expf(x - (e < 2 ? lse_lo : lse_hi));
        s[nt][e] = pv * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi)) * p.scale;
      }
    }

    // dQ += dS K: dS (bf16) as the A operand, K's B fragments transposed
    // out of smem by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kD / 16; ++dn) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, frag_addr(Ks, kk * 16, dn * 16, lane));
        mma_bf16(acc[2 * dn], a, kb[0], kb[1]);
        mma_bf16(acc[2 * dn + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with Ks/Vs before the next load
  }

  bf16* dQ = p.dq + row0 * kD;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    int c = dt * 8 + tig * 2;
    if (r_lo < p.Sq)
      *reinterpret_cast<uint32_t*>(dQ + static_cast<long long>(r_lo) * kD +
                                   c) = pack_bf16(acc[dt][0], acc[dt][1]);
    if (r_hi < p.Sq)
      *reinterpret_cast<uint32_t*>(dQ + static_cast<long long>(r_hi) * kD +
                                   c) = pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

}  // namespace

// q/dO [B, H, Sq, D] and k/v [B, KVH, Skv, D] bf16 given by element strides
// (batch, head, seq; the last dim dense); lse and delta [B, H, Sq] f32 and
// dq [B, H, Sq, D] bf16 dense. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ray_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int KVH,
    int Sq, int Skv, int D, float scale, int causal, void* stream) {
  if (D != kD || B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 ||
      Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of shared memory only as dynamic memory, once allowed.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<bf16*>(dq),
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, H, KVH, Sq, Skv, scale, causal};
  dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_bwd_dq_kernel<<<grid, 128, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
