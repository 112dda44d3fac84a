// bf16 products on mma.sync, ldmatrix fragment loads and cp.async tile copies
// for Hopper (sm_90a): the d = 512 bf16 backward's two products from P and dS
// (flash_attn_bwd.cu, mm_tile_bf16); and the bf16 type, which K2's bf16
// forward (flash_attn_fwd.cu) takes from here too.
//
// A product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16
// operands, fp32 accumulators (what upstream's Pallas kernel does with bf16
// q, k and v: jax.lax.dot(..., preferred_element_type=float32)), one
// instruction per 16 x 8 x 16 tile at up to 989 TFLOP/s.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4), each register two
// bf16 with the lower column (or row) in its low half: A (16 x 16,
// row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..); B (16 x 8, column-major) b0 = (2t..2t+1, g),
// b1 = (2t+8.., g); the accumulator C (16 x 8) c0, c1 = (g, 2t..2t+1),
// c2, c3 = (g+8, 2t..).
//
// An A operand whose contraction index runs along a shared-memory row (dS in
// dQ = dS k) is read as 32-bit pairs (``frag_a_rows``).  Operands contracted
// along the sequence, stored with the sequence across rows (P and dS in dV and
// dK; dO, q and k), are read transposed by
// ldmatrix.sync.aligned.m8n8.x4.trans (``frag_b_trans`` / ``frag_a_trans``).
// Rows are padded to a pitch of W + 8 bf16 (W a multiple of 16): the
// 32-bit reads hit 32 banks (pitch ≡ 4 words mod 32) and the eight 16-byte
// rows of an ldmatrix phase hit eight distinct 16-byte bank groups (pitch ≡
// 16 bytes mod 128).
//
// Everything here lives in an anonymous namespace: each source that includes
// it is built into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"   // cp_async16, cp_async_commit, cp_async_wait

namespace {

typedef __nv_bfloat16 bf16;

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lanes 8i .. 8i+7 give the addresses
// of matrix i's rows (16 bytes each); r[i] receives matrix i's elements
// (2t, g) and (2t+1, g) of this lane.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// ---- end of PTX helpers --------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows 0..15 and columns kk..kk+15 of a row-major tile of
// pitch P (the contraction index along the row).
template <int P>
__device__ __forceinline__ void frag_a_rows(uint32_t (&a)[4], const bf16* s, int kk, int g,
                                            int t) {
  const bf16* r = s + g * P + kk + 2 * t;
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * P);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * P + 8);
}

// The A fragment of rows i0..i0+15 and contraction kk..kk+15 of A(i, kk) =
// s[kk·P + i] (the contraction index across rows), by ldmatrix.trans.
template <int P>
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4], const bf16* s, int i0, int kk,
                                             int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a, s + (kk + (mi >> 1) * 8 + r) * P + i0 + (mi & 1) * 8);
}

// The B fragments of output columns c0..c0+7 (b[0], b[1]) and c0+8..c0+15
// (b[2], b[3]) over contraction rows k0..k0+15 of B(k, c) = s[k·P + c] (the
// contraction index across rows), by ldmatrix.trans.
template <int P>
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[4], const bf16* s, int k0, int c0,
                                             int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, s + (k0 + (mi & 1) * 8 + r) * P + c0 + (mi >> 1) * 8);
}

// ROWS x COLS bf16 of a row-major global slice (row stride rs elements,
// 16-byte aligned) into shared rows of pitch PITCH, in 16-byte copies.
template <int ROWS, int COLS, int PITCH, int NTHREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long long rs, int tid) {
  constexpr int CHUNKS = COLS / 8;
  for (int e = tid; e < ROWS * CHUNKS; e += NTHREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    cp_async16(dst + r * PITCH + c, src + (long long)r * rs + c);
  }
}

}  // namespace
