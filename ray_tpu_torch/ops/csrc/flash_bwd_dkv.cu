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
//     2 * 64 * 64 * 128 per tile pair (8 * B * H * D * pairs FLOP). Every
//     product runs on mma.sync.m16n8k16 bf16 with f32 accumulation; q tiles
//     wholly before the KV tile (causal) are never visited, and only the
//     diagonal tile is masked.
//   * The TPU kernel's sequential q grid axis and its VMEM dK/dV scratch
//     become a loop inside one block per (b, KV head, 64-row KV tile). The
//     block walks the H / KVH query heads of its group and their q tiles,
//     so dK and dV come out with KVH heads, summed once in f32, with no
//     atomics and no repeat_kv copy.
//   * Registers: dK and dV (16 x 128 f32 each per warp) stay in registers
//     for the whole loop, 128 of them. To leave room, K and V A fragments
//     are read from shared memory with ldmatrix at each use, and each
//     64-row q tile is taken in two 32-column halves, so S^T and dP^T hold
//     16 registers each.
//   * The products run transposed: S^T = K Q^T puts KV rows on the mma rows,
//     so P^T and dS^T re-pack from the accumulators straight into the A
//     operands of P^T dO and dS^T Q, whose B operands (dO, Q, row-major in
//     smem) come through ldmatrix.trans.
//   * Causal work is uneven: early KV tiles see every later q tile. The
//     grid's slow axis is the KV tile, so the heaviest tiles of every head
//     start first.
// Later work: TMA + wgmma, double-buffered Q/dO tiles, fusing with dQ.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBKV = kTile;  // KV rows per block, 16 per warp
constexpr int kBQ = kTile;   // q rows per tile
constexpr int kHalf = 32;    // q columns of S^T / dP^T in registers at once
constexpr int kSmem = 4 * kTile * kLds * sizeof(bf16) + 2 * kBQ * sizeof(float);

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, H, Sq] dense
  const float* delta;  // [B, H, Sq] dense
  bf16* dk;            // [B, KVH, Skv, D] dense
  bf16* dv;            // [B, KVH, Skv, D] dense
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim is dense
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // dO
  int H, KVH, Sq, Skv;
  float scale;
  int causal;
};

__global__ void __launch_bounds__(128)
flash_bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile Ks = reinterpret_cast<Tile>(smem);
  Tile Vs = Ks + kBKV;
  Tile Qs = Vs + kBKV;
  Tile Ds = Qs + kBQ;  // dO
  float* Ls = reinterpret_cast<float*>(Ds + kBQ);  // LSE of the q tile
  float* Dl = Ls + kBQ;                            // delta of the q tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int kt = blockIdx.y;
  const int b = blockIdx.x / p.KVH;
  const int kvh = blockIdx.x % p.KVH;
  const int n_rep = p.H / p.KVH;
  const int k0 = kt * kBKV;

  load_tile(Ks, p.k + b * p.k_sb + kvh * p.k_sh, p.k_ss, k0, p.Skv, tid);
  load_tile(Vs, p.v + b * p.v_sb + kvh * p.v_sh, p.v_ss, k0, p.Skv, tid);
  cp_async_commit();

  // This warp's two fragment rows (global KV positions).
  const int r_lo = k0 + warp * 16 + g;
  const int r_hi = r_lo + 8;

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  // Causal: q tiles before this KV tile see none of it (kBQ == kBKV).
  const int qt_begin = p.causal ? kt : 0;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = kvh * n_rep + rep;
    const bf16* Q = p.q + b * p.q_sb + h * p.q_sh;
    const bf16* dO = p.dout + b * p.o_sb + h * p.o_sh;
    const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      load_tile(Qs, Q, p.q_ss, q0, p.Sq, tid);
      load_tile(Ds, dO, p.o_ss, q0, p.Sq, tid);
      cp_async_commit();
      // q rows past Sq get LSE = +inf, so P = 0 there and they add nothing.
      if (tid < kBQ) {
        Ls[tid] = q0 + tid < p.Sq ? p.lse[row0 + q0 + tid] : INFINITY;
      } else {
        const int i = tid - kBQ;
        Dl[i] = q0 + i < p.Sq ? p.delta[row0 + q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      const bool masked = p.causal && q0 < k0 + kBKV - 1;  // diagonal tile
#pragma unroll
      for (int half = 0; half < kBQ / kHalf; ++half) {
        const int c0 = half * kHalf;
        // S^T = K Q^T and dP^T = V dO^T: 16 KV rows x 32 q columns a warp.
        float st[kHalf / 8][4], dpt[kHalf / 8][4];
#pragma unroll
        for (int nt = 0; nt < kHalf / 8; ++nt) {
          st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
          dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, frag_addr(Ks, warp * 16, kk * 16, lane));
          ldmatrix_x4(va, frag_addr(Vs, warp * 16, kk * 16, lane));
#pragma unroll
          for (int nt = 0; nt < kHalf / 8; ++nt) {
            uint32_t b0, b1;
            b_frag(b0, b1, Qs, c0 + nt * 8, kk * 16, lane);
            mma_bf16(st[nt], ka, b0, b1);
            b_frag(b0, b1, Ds, c0 + nt * 8, kk * 16, lane);
            mma_bf16(dpt[nt], va, b0, b1);
          }
        }

        // P^T into st, dS^T into dpt.
#pragma unroll
        for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + nt * 8 + tig * 2 + (e & 1);  // in the tile
            float x = st[nt][e] * p.scale;
            if (masked && q0 + qc < (e < 2 ? r_lo : r_hi)) x = kMaskValue;
            const float pv = __expf(x - Ls[qc]);
            st[nt][e] = pv;
            dpt[nt][e] = pv * (dpt[nt][e] - Dl[qc]) * p.scale;
          }
        }

        // dV += P^T dO and dK += dS^T Q over these 32 q rows: P^T and dS^T
        // (bf16) as A operands, dO's and Q's B fragments transposed out of
        // smem by ldmatrix.
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
          uint32_t pa[4], sa[4];
          pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
          pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
          pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
          pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
          sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
          sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
          sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
          sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
          for (int dn = 0; dn < kD / 16; ++dn) {
            uint32_t fb[4];
            ldmatrix_x4_trans(fb, frag_addr(Ds, c0 + kk * 16, dn * 16, lane));
            mma_bf16(dv[2 * dn], pa, fb[0], fb[1]);
            mma_bf16(dv[2 * dn + 1], pa, fb[2], fb[3]);
            ldmatrix_x4_trans(fb, frag_addr(Qs, c0 + kk * 16, dn * 16, lane));
            mma_bf16(dk[2 * dn], sa, fb[0], fb[1]);
            mma_bf16(dk[2 * dn + 1], sa, fb[2], fb[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with Qs/Ds/Ls/Dl before reload
    }
  }

  const long long out0 = (static_cast<long long>(b) * p.KVH + kvh) * p.Skv;
  bf16* dK = p.dk + out0 * kD;
  bf16* dV = p.dv + out0 * kD;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (r_lo < p.Skv) {
      const long long o = static_cast<long long>(r_lo) * kD + c;
      *reinterpret_cast<uint32_t*>(dK + o) = pack_bf16(dk[dt][0], dk[dt][1]);
      *reinterpret_cast<uint32_t*>(dV + o) = pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (r_hi < p.Skv) {
      const long long o = static_cast<long long>(r_hi) * kD + c;
      *reinterpret_cast<uint32_t*>(dK + o) = pack_bf16(dk[dt][2], dk[dt][3]);
      *reinterpret_cast<uint32_t*>(dV + o) = pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

}  // namespace

// q/dO [B, H, Sq, D] and k/v [B, KVH, Skv, D] bf16 given by element strides
// (batch, head, seq; the last dim dense); lse and delta [B, H, Sq] f32 and
// dk/dv [B, KVH, Skv, D] bf16 dense. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ray_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int KVH,
    int Sq, int Skv, int D, float scale, int causal, void* stream) {
  if (D != kD || B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 ||
      Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of shared memory only as dynamic memory, once allowed.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           static_cast<bf16*>(dk), static_cast<bf16*>(dv),
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, H, KVH, Sq, Skv, scale, causal};
  dim3 grid(B * KVH, (Skv + kBKV - 1) / kBKV);
  flash_bwd_dkv_kernel<<<grid, 128, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
