// Hopper (sm_90a) building blocks for warp-specialised kernels: TMA tile
// loads into 128-byte-swizzled shared memory, mbarrier rings between a
// producer thread and consumer warpgroups, setmaxnreg, wgmma.mma_async on
// bf16 operands with fp32 accumulators (m64nNk16 at N = 32, 64, 128 and 256),
// and thread block clusters: TMA loads multicast to several blocks, arrivals
// on another block's mbarrier, the cluster barrier and cluster launches.
// Used by K2's bf16 kernels, forward (flash_attn_fwd.cu) and backward
// (flash_attn_bwd.cu); the clusters by the d = 512 forward and P/dS kernels.
//
// Shared-memory tiles.  A TMA box of 64 bf16 columns (128 bytes) x R rows
// lands as R rows of 128 bytes under CU_TENSOR_MAP_SWIZZLE_128B: in each
// 1024-byte atom of 8 rows, 16-byte chunk c of row r sits at chunk c ^ (r % 8).
// A tile of W columns is W / 64 such column blocks one after another.  Every
// block starts on a 1024-byte boundary, so the hardware's swizzle (a function
// of the address bits) is the one the wgmma descriptors below describe.
//
// wgmma descriptors (``desc_sw128``): start address >> 4 in bits 0-13, the
// leading byte offset >> 4 in bits 16-29, the stride byte offset >> 4 in bits
// 32-45, base offset 0, swizzle mode 1 (128 bytes) in bits 62-63.
//   * K-major operand (the contraction index along the 128-byte row: Q, K, V
//     and dO contracted over d): 8-row groups 1024 bytes apart (SBO); the
//     leading offset is unused; k-step kk of 16 starts 32·kk bytes into the
//     row (the swizzle is applied by the hardware to the summed address).
//   * MN-major operand (the contraction index across rows: dO and Q in dV,
//     dK, K in dQ, read with imm-trans-b = 1; Pᵀ and dSᵀ as stored in dV and
//     dK at d = 512, read with imm-trans-a = 1): 8 contraction rows per
//     1024-byte group (SBO = 1024), 64-column blocks LBO apart; k-step kk of
//     16 starts 16 rows = 2048 bytes further.
//
// wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16: 64 x 64 += 64 x 16 ·
// 16 x 64, issued by a warpgroup (4 warps, 128 threads).  Warp w of the group
// owns rows 16w .. 16w + 15; accumulator d[4j + r] of a thread (g = lane / 4,
// t = lane % 4) is row 16w + g + 8·(r / 2), column 8j + 2t + (r % 2), j < 8.
// So entries 16h .. 16h + 15 hold columns 32h .. 32h + 31.
// An A operand from registers has mma.sync m16n8k16's A layout per warp:
// a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..),
// two bf16 a register, the lower column in the low half.  So accumulator
// columns 16kk .. 16kk+15, d[8kk .. 8kk+7] packed in pairs, are the A operand
// of k-step kk of the next product (``pack_a_wg``): P and dS go from the
// softmax into dV, dK and dQ without touching shared memory.
//
// The host side encodes the tensor maps (``bf16_tile_map``) with the
// driver's cuTensorMapEncodeTiled, found through the runtime, and launches
// clustered grids through cudaLaunchKernelExC (``launch_cluster``).
//
// Everything here lives in an anonymous namespace: each source that includes
// it is built into its own library.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA) and the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects ``bytes`` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity ``parity`` has completed.  A wait that
// outlasts 2^26 polls (well over a second; no wait of a correct kernel comes
// near) traps, so that a fault in a ring's bookkeeping ends the launch with
// an error instead of hanging the card.  The loop is one asm statement: as a
// C++ loop around try_wait it made ptxas hold the consumers to the launch's
// 168 registers, spill, and serialise their wgmma (C7512).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 polls;\n"
      "mov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.eq.u32 p, polls, 67108864;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A 4-d box of ``map`` at coordinates (c0 innermost .. c3) into shared memory,
// completing on ``bar``'s transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// global memory into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma's registers (its
// accumulators, or its A operand) across the asynchronous product: called
// on them before wgmma_fence and after wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WGMMA_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_D32_OUT(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64) = A (64 x 16) · B (16 x 64) + (accumulate ? d : 0), A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) = A (64 x 16, registers) · B (16 x 64) + (accumulate ? d : 0),
// B in shared memory K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

// d (64 x N) = A (64 x 16) · B (16 x N) + (accumulate ? d : 0) at N = 32, 128
// and 256 (N / 2 accumulators a thread, d[4j + r] at row 16w + g + 8·(r / 2),
// column 8j + 2t + r % 2), B K-major (TRANS_B = 0) or MN-major (TRANS_B = 1),
// A K-major or, at N = 256, MN-major (TRANS_A = 1), both in shared memory.
#define WGMMA_OUT8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : WGMMA_OUT8(d, 0), WGMMA_OUT8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : WGMMA_OUT8(d, 0), WGMMA_OUT8(d, 8), WGMMA_OUT8(d, 16), WGMMA_OUT8(d, 24),
        WGMMA_OUT8(d, 32), WGMMA_OUT8(d, 40), WGMMA_OUT8(d, 48), WGMMA_OUT8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %132, %131;\n"
      "}\n"
      : WGMMA_OUT8(d, 0), WGMMA_OUT8(d, 8), WGMMA_OUT8(d, 16), WGMMA_OUT8(d, 24),
        WGMMA_OUT8(d, 32), WGMMA_OUT8(d, 40), WGMMA_OUT8(d, 48), WGMMA_OUT8(d, 56),
        WGMMA_OUT8(d, 64), WGMMA_OUT8(d, 72), WGMMA_OUT8(d, 80), WGMMA_OUT8(d, 88),
        WGMMA_OUT8(d, 96), WGMMA_OUT8(d, 104), WGMMA_OUT8(d, 112), WGMMA_OUT8(d, 120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

#undef WGMMA_OUT8

// ---- clusters: multicast loads, remote arrivals, the cluster barrier ----
//
// A cluster of blocks on neighbouring SMs (launched with
// cudaLaunchAttributeClusterDimension) shares its tiles: one block's TMA
// load lands at the same shared-memory offset in every block of ``mask``
// (bit r: the block of %cluster_ctarank r) and completes on the mbarrier at
// the same offset in each, so a tile that several blocks read crosses L2
// once.  A ring slot that such loads refill is free only once every block
// of the cluster has read it: each consumer warp arrives on the slot's
// "empty" barrier in every block, lane r on block r's
// (``mbar_arrive_cluster``), and each block's producer waits on its own.  A block's "full" barrier counts its
// own producer's arrival and the bytes of the whole tile, whoever loads
// them (a remote load may complete bytes before the local expect_tx; the
// pending arrival keeps the phase open).

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: arrive, then wait for all the others
// (release / acquire: shared-memory writes before it are seen after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One arrival on the mbarrier at ``bar``'s offset in the block of rank
// ``cta``.  Release at the block's scope, as CUTLASS's cluster barriers
// arrive: what it orders is this thread's reads of a slot, which wgmma has
// finished.  With a release at the cluster's scope, four arrivals in a row
// stretched the forward's softmax and P·V phase from ~830 cycles a key tile
// to ~9,000 (H100).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// tma_load_4d into every block of ``mask``: the box lands at ``dst``'s offset
// and completes on the barrier at ``bar``'s offset in each.
__device__ __forceinline__ void tma_load_4d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1, int c2,
                                                      int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "h"(mask)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory stores (an operand written
// by threads) before later async-proxy reads of them (wgmma, TMA stores);
// then a barrier hands the operand to the warpgroups that read it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier ``id`` (0 is __syncthreads) over ``count`` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}


// Four 8 x 8 bf16 matrices: lanes 8i .. 8i+7 give the addresses of matrix i's
// rows (16 bytes each); r[i] receives matrix i's elements (g, 2t), (g, 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// Hides a value from the optimiser: what is derived from it is recomputed
// where it is used, instead of being hoisted and held in registers.
__device__ __forceinline__ void opaque(uint64_t& x) { asm volatile("" : "+l"(x)); }

#undef WGMMA_D32
#undef WGMMA_D32_OUT

// 2^x on the SFU (ex2.approx.ftz: about 2 ulp; results below 2^-126 flush
// to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- end of PTX helpers --------------------------------------------------

// The wgmma descriptor of a 128-byte-swizzled operand starting at ``p``
// (``lbo`` and ``sbo`` in bytes).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// (lo, hi) rounded to nearest even as one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operands of a warpgroup's 64 rows (row0 .. row0 + 63) of a
// 128-byte-swizzled [rows][W] tile (W / 64 column blocks of ``rows`` rows)
// for its W / 16 k-steps, by ldmatrix: warp wq takes rows row0 + 16wq ..
// row0 + 16wq + 15; lane l gives the address of row (l % 8) + 8·((l / 8) % 2),
// 16-byte chunk 2·(kk % 4) + l / 16 of column block kk / 4, stored at chunk
// position chunk ^ (row % 8).
template <int W>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[W / 16][4], const void* tile, int rows,
                                            int row0, int wq, int lane) {
  const int r = row0 + 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int chunk = 2 * (kk % 4) + (lane >> 4);
    ldmatrix_x4(a[kk], static_cast<const unsigned char*>(tile) + (kk / 4) * rows * 128 +
                           r * 128 + ((chunk ^ (r & 7)) << 4));
  }
}

// The A operands of the N / 8 k-steps over a 64 x (N / 2) accumulator's
// columns (N = 32: four k-steps; 16: two), rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a_wg(uint32_t (&a)[N / 8][4], const float (&x)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16x2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so that nothing
// links against libcuda; null if the driver has none.
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (b, seq, heads, d) tensor with element strides (sb, sn, sh) and unit
// stride along d, as a 4-d map over (d, heads, seq, b) with boxes of 64
// columns x 1 head x ``rows`` rows x 1 batch, 128-byte swizzled.
inline cudaError_t bf16_tile_map(CUtensorMap* map, const void* base, int b, int seq, int heads,
                                 int d, long long sb, long long sn, long long sh, int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sn * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches a kernel on ``grid`` in clusters of ``cluster`` blocks along x, of
// ``threads`` with ``smem`` bytes of dynamic shared memory; ``args`` point at
// its arguments; a cluster of 1 is a plain launch.  A cluster the card cannot
// place is refused here.
inline cudaError_t launch_cluster(const void* kernel, dim3 grid, int threads, int smem,
                                  int cluster, void** args, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of ``cluster`` blocks of ``threads`` with ``smem`` bytes
// of dynamic shared memory the card runs at once, into ``*clusters`` (the
// kernel's shared-memory attribute must be set already).
inline cudaError_t max_clusters(const void* kernel, int threads, int smem, int cluster,
                                int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace
