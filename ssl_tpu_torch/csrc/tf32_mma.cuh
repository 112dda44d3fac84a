// 3xTF32 products on mma.sync and cp.async tile copies for Hopper (sm_90a),
// shared by K2's forward (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu).
//
// A float32 operand x is taken as x = big + small with big = cvt.rna.tf32(x)
// and small = cvt.rna.tf32(x - big); a product is small·big + big·small +
// big·big on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 into fp32
// accumulators (what PyTorch's fp32 memory-efficient attention does through
// CUTLASS's OpMultiplyAddFastF32): fp32-class accuracy at up to 495/3 TFLOP/s.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8,
// row-major) holds (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (8 x 8,
// column-major) holds (t, g), (t+4, g); the accumulator C (16 x 8) holds
// (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  With the contraction index of
// a k-step permuted as (t, t+4) -> (2t, 2t+1), a logit tile's accumulator
// fragment is the A fragment of the next product (``accumulate``), so P or
// dS go from the softmax into that product without touching shared memory;
// rows padded to D + 4 floats (≡ 4 mod 8) keep both g·(D+4) + t (contracting
// over d) and 2t·(D+4) + g (contracting over the sequence) on 32 banks.
//
// Everything here lives in an anonymous namespace: each source that includes
// it is built into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- end of PTX helpers --------------------------------------------------

// x = big + small, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// An A fragment (16 x 8, row-major) as big and small tf32 halves.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// A B fragment (8 x 8, column-major) as big and small tf32 halves.
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// c[j][i] += a[i] b[j] for NJ column tiles and NI row tiles in 3xTF32
// (small·big + big·small + big·big), one pass over all tiles at a time so
// that no product waits on the one before it.
template <int NJ, int NI>
__device__ __forceinline__ void mma3_grid(float (*c)[NI][4], const FragA (&a)[NI],
                                          const FragB (&b)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) mma_tf32(c[j][i], a[i].small, b[j].big);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) mma_tf32(c[j][i], a[i].big, b[j].small);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < NI; ++i) mma_tf32(c[j][i], a[i].big, b[j].big);
}

// acc (16·RW x D) += x (16·RW x NT·8, accumulator fragments) · y (NT·8 rows
// of pitch D + 4): the contraction index of k-step j is permuted so that x's
// accumulator fragment is the A fragment as it stands.
template <int D, int NT, int RW>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][RW][4],
                                           const float (&x)[NT][RW][4], const float* y, int g,
                                           int t) {
  constexpr int P = D + 4, CHUNK = 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    FragA fa[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) fa[i].set(x[j][i][0], x[j][i][2], x[j][i][1], x[j][i][3]);
    const float* y0 = y + (8 * j + 2 * t) * P + g;
#pragma unroll
    for (int c0 = 0; c0 < D / 8; c0 += CHUNK) {
      FragB fb[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) fb[c].set(y0[8 * (c0 + c)], y0[P + 8 * (c0 + c)]);
      mma3_grid<CHUNK, RW>(acc + c0, fa, fb);
    }
  }
}

// ROWS x COLS floats of a row-major global slice (row stride rs, 16-byte
// aligned) into shared rows of pitch PITCH, in 16-byte copies.
template <int ROWS, int COLS, int PITCH, int NTHREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, long long rs,
                                                int tid) {
  constexpr int CHUNKS = COLS / 4;
  for (int e = tid; e < ROWS * CHUNKS; e += NTHREADS) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * 4;
    cp_async16(dst + r * PITCH + c, src + (long long)r * rs + c);
  }
}

// COUNT floats (a multiple of 4) of a contiguous slice.
template <int COUNT, int NTHREADS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int tid) {
  for (int e = tid; e < COUNT / 4; e += NTHREADS) cp_async16(dst + 4 * e, src + 4 * e);
}

}  // namespace
