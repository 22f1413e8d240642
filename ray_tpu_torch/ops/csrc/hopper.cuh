// Hopper (sm_90a) building blocks for the port's kernels: mbarriers with
// phase parity, TMA tile loads and the host-side tensor maps they read (bf16
// or f32), the cluster barrier, loads, stores and mbarrier arrivals in a
// cluster peer's shared memory, wgmma descriptors for 128-byte-swizzled
// tiles, wgmma.m64n128k16 (bf16 in, f32 accumulate) with A from shared
// memory or from registers,
// wgmma.m64n64k16 and wgmma.m64n32k16 with both operands in shared memory
// (m64n64k16 also with B MN-major), the fences around them (and the proxy
// fence that makes shared-memory stores visible to wgmma), named barriers,
// setmaxnreg and the once-per-device shared-memory opt-in.
//
// Shared-memory tiles are written by TMA with CU_TENSOR_MAP_SWIZZLE_128B: a
// box is at most 64 bf16 (128 bytes) wide, so a 128-column tile is stored as
// two 64-column halves, each `rows` x 128 B, 8-row groups 1024 B apart, and
// each half must start on a 1024-byte boundary.
//
// Operand layouts (wgmma "canonical" layouts for the 128B swizzle):
//   K-major (the reduction dim contiguous, e.g. Q and K of S = Q K^T):
//     desc_sw128(half + k_elem * 2, 16, 1024): a k-step of 16 elements
//     moves the start address by 32 bytes inside the 128-byte row; LBO is
//     unused, SBO is the 1024-byte stride of 8-row groups. The same
//     descriptor serves an M of 64 rows (A) and an N of 32, 64 or 128 rows
//     (B): the unit reads N / 8 groups at SBO strides, so rows r0.. of a
//     taller tile start at half + r0 * 128 (r0 a multiple of 8).
//   MN-major (the output dim contiguous, e.g. V of O += P V, trans-b = 1):
//     desc_sw128(half0 + k_row * 128, half_bytes, 1024): LBO is the stride
//     from one 64-wide MN block to the next (the other half), SBO the
//     stride of 8-row k groups; a k-step of 16 rows moves 2048 bytes.
//     half_bytes is rows * 128 of the tile the box wrote (8 KB for a
//     64-row tile, 16 KB for 128 rows).
//
// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4j + 2a + b] holds row 16w + l/4 + 8a, column
// 8j + 2(l%4) + b (j < N / 8). The register A operand of one k-step has the
// layout of mma.m16n8k16's A fragment per warp (rows 16w..16w+15), so a pair
// of 8-col accumulator blocks j = 2kk, 2kk+1 packed to bf16 is the A operand
// of k-step kk of the next product: an m64n64 accumulator gives 4 k-steps,
// an m64n128 one 8.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After every mbar_init and before any other thread touches the barriers
// (followed by __syncthreads()).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// True once the phase with this parity has completed. A fresh barrier is in
// phase 0; its k-th completion (k = 0, 1, ...) is waited for with k & 1.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---------------------------------------------------------------------------
// TMA tile loads (global -> shared), completion counted on an mbarrier.
// Coordinates are in elements, innermost dimension first; rows outside the
// tensor are zero-filled and still count toward the transaction bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters: the barrier over every thread of the cluster
// (release on arrival, acquire on the wait, so shared-memory stores before
// it are visible to every CTA's loads after it), this CTA's rank, loads and
// stores in another CTA's shared memory (distributed shared memory), and
// mbarriers that other CTAs arrive at.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address in CTA `rank`'s shared memory of what `addr` (a shared::cta
// address) is in this CTA's.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster_u2(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y)
               : "memory");
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// One arrival on the mbarrier `bar` (this CTA's address of it) in CTA
// `rank`, releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar,
                                                 uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          map_rank(smem_u32(bar), rank))
      : "memory");
}

// An arrival at CTA `rank`'s barrier with the default (CTA-scope)
// semantics, which need no fence: for "done reading" signals, whose reads
// have delivered their values before the arrival issues. (The release at
// cluster scope of mbar_arrive_rank compiles to a GPU-wide memory barrier,
// MEMBAR.ALL.GPU, that stalls the warp.)
__device__ __forceinline__ void mbar_signal_rank(uint64_t* bar,
                                                 uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   map_rank(smem_u32(bar), rank))
               : "memory");
}

// mbar_wait for a barrier that other CTAs of the cluster arrive at: the
// acquire is at cluster scope, so their released writes are visible.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128B-swizzled operand tile at shared address `addr`
// (offsets in bytes; see the layouts at the top of this file).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // layout type 1: 128-byte swizzle
}

// Before the first wgmma that reads registers written by other instructions
// or shared memory written since the last fence.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties a register to this point of the program: after wgmma_wait, every
// accumulator and register A operand of the waited wgmmas goes through it,
// so the compiler neither reads an accumulator before the wait nor reuses an
// A register while the tensor cores may still read it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define HOPPER_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define HOPPER_D64_OPERANDS(d)                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64] (+)= A (64 x 16, shared memory) * B (16 x 128, shared memory).
// scale_d = 0 overwrites d. TransB = 1 reads B as MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : HOPPER_D64_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// d[64] (+)= A (64 x 16, four bf16x2 registers per thread) * B (16 x 128,
// shared memory). TransB = 1 reads B as MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : HOPPER_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(TransB));
}

#define HOPPER_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define HOPPER_D32_OPERANDS(d)                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d[32] (+)= A (64 x 16, shared memory) * B (16 x 64, shared memory), both
// K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[32] (+)= A (64 x 16, shared memory, K-major) * B (16 x 64, shared
// memory) read MN-major through the transpose bit: one 64-wide MN block,
// so the descriptor's LBO is unused.
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : HOPPER_D32_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#define HOPPER_D16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define HOPPER_D16_OPERANDS(d)                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d[16] (+)= A (64 x 16, shared memory) * B (16 x 32, shared memory), both
// K-major.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_D16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D16_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef HOPPER_D64
#undef HOPPER_D64_OPERANDS
#undef HOPPER_D32
#undef HOPPER_D32_OPERANDS
#undef HOPPER_D16
#undef HOPPER_D16_OPERANDS

// After shared-memory stores by ordinary instructions (the generic proxy)
// and before a wgmma (the async proxy) reads them; each storing thread
// fences, then a barrier orders the readers behind every store.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same for stores that other CTAs made into this CTA's shared memory
// (st.shared::cluster) before a wgmma here reads them: a proxy fence
// anywhere on the causality path from the stores to the wgmma orders them,
// so the reader fences after its acquire (cheaper than each writer's fence
// before its release).
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Named barriers (ids 1..15; __syncthreads() owns 0) over `n` threads, a
// multiple of 32: sync waits until n threads have arrived or synced,
// arrive counts this thread in and goes on.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups (only in a kernel whose roles
// split once, by warpgroup, and never reconverge).
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// Host: above 48 KB a block gets shared memory only as dynamic memory, after
// an opt-in that is per kernel and per device. Made once per device (one
// bit each), so a launch pays no attribute call. The bits are kept per
// instantiation of this template, so two kernels of one function type take
// two Tags.
// ---------------------------------------------------------------------------

template <int Tag = 0, typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int bytes) {
  static std::atomic<uint64_t> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (opted_in.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) opted_in.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is a driver function; it is
// looked up through the runtime (cudaGetDriverEntryPoint), so a library
// built from these sources needs no -lcuda.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A tensor map of `rank` dims (innermost first, dims[0] dense) of elements
// of `elem_bytes` bytes with byte strides for dims 1..rank-1, box `box`,
// swizzle `swizzle` and zero-filled out-of-range elements. A dim of extent 1
// may carry any stride, so its stride is replaced by a valid one. Returns
// false when the driver refuses the map (a stride that is not a multiple of
// 16 bytes, an address that is not 16-byte aligned). A map depends only on
// these arguments, so the last 16 built on each host thread are kept: a
// model's layers hand the kernel the same recycled buffers again and again.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dtype,
                     uint32_t elem_bytes, CUtensorMapSwizzle swizzle,
                     const void* base, int rank, const uint64_t* dims,
                     const uint64_t* strides_bytes, const uint32_t* box) {
  struct Key {
    const void* base;
    uint64_t rank, dtype, swizzle;
    cuuint64_t dim[5], stride[4];
    cuuint32_t box[5], pad;
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  constexpr int kCached = 16;
  thread_local Entry cache[kCached];
  thread_local int n_cached = 0, next = 0;

  if (rank < 2 || rank > 5) return false;
  Key key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.rank = static_cast<uint64_t>(rank);
  key.dtype = static_cast<uint64_t>(dtype);
  key.swizzle = static_cast<uint64_t>(swizzle);
  cuuint32_t estride[5];
  uint64_t extent = dims[0] * elem_bytes;  // bytes spanned by the dims below
  for (int i = 0; i < rank; ++i) {
    key.dim[i] = dims[i];
    key.box[i] = box[i];
    estride[i] = 1;
    if (i > 0) {
      uint64_t s = dims[i] == 1 ? ((extent + 15) / 16) * 16
                                : strides_bytes[i - 1];
      key.stride[i - 1] = s;
      extent = s * dims[i];
    }
  }
  for (int i = 0; i < n_cached; ++i) {
    if (memcmp(&cache[i].key, &key, sizeof(key)) == 0) {
      *map = cache[i].map;
      return true;
    }
  }
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  CUresult r = encode(map, dtype, static_cast<cuuint32_t>(rank),
                      const_cast<void*>(base), key.dim, key.stride, key.box,
                      estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  cache[next].key = key;
  cache[next].map = *map;
  next = (next + 1) % kCached;
  if (n_cached < kCached) ++n_cached;
  return true;
}

// make_map of bf16 elements, 128-byte swizzle.
inline bool make_map_bf16_sw128(CUtensorMap* map, const void* base, int rank,
                                const uint64_t* dims,
                                const uint64_t* strides_bytes,
                                const uint32_t* box) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides_bytes,
                  box);
}

}  // namespace hopper
