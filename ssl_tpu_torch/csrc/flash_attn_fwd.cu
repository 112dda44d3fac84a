// K2: flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash attention that ssl_tpu/ops/attention.py
// (sdp_attention, flash branch :32-39) calls through
// jax.experimental.pallas.ops.tpu.flash_attention (upstream
// _flash_attention_impl :589, pallas_call :758).  Same contract as its plain
// PyTorch version, ssl_tpu_torch/ops/attention.py::sdp_attention_reference:
//     o[b, i, h, :] = sum_j softmax_j(sm_scale * q[b, i, h, :] . k[b, j, h, :]) v[b, j, h, :]
// over float32 (b, seq, heads, d) inputs read through their strides (unit
// stride along d, every stride and base 16-byte aligned), n and m multiples
// of 128; o is written contiguous (b, n, heads, d).  For training it also
// writes each row's log-sum-exp of the scaled logits, lse = m + log(l), from
// which the backward (flash_attn_bwd.cu) recomputes the probabilities.
//
// What bounds it on this card: tensor-core operations.  The two products are
// 4·b·h·n·m·d operations against 4·b·h·(2nd + 2md) bytes, hundreds of
// operations per byte.  Both run as 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh):
// the arithmetic of the backward's recompute, so the forward's lse and the
// backward's P come from the same logits (the same splits, the same order of
// products).  The online softmax (scale, max, exp, sum, rescale: ~5·bhnm)
// runs on the CUDA cores in fp32 with expf.
//
// d = 64 and 128 (flash_attn_fwd_kernel):
//   * one block per (query tile of BQ = 128, b·head[, key split]); warp w
//     owns rows 16·RW·w .. 16·RW·(w+1)-1 (RW = 2 at d = 64: 4 warps, two
//     blocks per SM in ~102 KB; RW = 1 at d = 128: 8 warps, one block in
//     ~198 KB).  Q is split into its tf32 halves once, into shared memory;
//     K and V tiles of BK = 32 keys stream through a two-stage cp.async ring;
//   * per key tile the warp's logits (16·RW x 32) stay in accumulator
//     registers: row max and row sum by quad shuffles, P in place, and P's
//     accumulator fragments are the A fragments of P·V (``accumulate``), so P
//     never touches shared memory;
//   * each key tile's P·V goes into a fresh fragment and is folded into the
//     output with fp32 FFMA, o = alpha·o + tile: the tensor cores sum at most
//     32 keys, and the sums over the sequence are taken on the CUDA cores
//     (the backward's longer tensor-core sums cost it ~3e-5 relative L2 at
//     4096 keys, PERF.md; the forward's hold is elementwise).
// d = 512 (the VAE's single head, flash_attn_fwd_d512_kernel): a warp's
// 16 x 512 output does not fit its registers beside the logits, so the
// output columns are cut across the warps instead of the rows.  One block of
// 8 warps per (32 queries, b·head[, split]) holds Q (32 x 512) in shared
// memory; the K and V tiles of 32 keys arrive in turn through a two-stage
// ring (K of the next tile lands while P·V of this one runs).  Logits: warp
// w contracts a quarter of d for 32 queries x 16 keys (more products per
// fragment split than one warp contracting all of d for a thinner slice);
// the four partial sums are added in order in shared memory, where all 256
// threads take the softmax, 8 per row, and leave P and each row's rescale
// there.  P·V: warp w owns output columns 64w .. 64w+63 of all 32 rows, its
// accumulator and fresh tile 2 x 64 registers a thread; ~219 KB of shared
// memory, one block per SM.  Two variants timed against it on an H100 were
// slower (PERF.md): 64 queries a tile shared by two blocks that each take
// half of the output columns (1.5x the products for ~2.7x less K and V
// traffic), and each block starting its key loop at another tile.
// Small grids: where the blocks would fill under 90% of the SMs' slots
// (ops/attention_cuda.py::fwd_plan), the key loop is cut into 2-8 parts;
// each writes its unnormalised output and row max and sum to scratch, and
// flash_attn_fwd_combine_kernel merges the parts in order into o and lse.
// Determinism: no atomics, every sum in a fixed order: two launches on the
// same inputs give bit-identical outputs.  expf/logf, no fast-math.
//
// bf16 (compute_dtype bfloat16; flash_attn_fwd_bf16_kernel,
// flash_attn_fwd_d512_bf16_kernel, flash_attn_fwd_combine_bf16_kernel,
// entry flash_attn_fwd_bf16): upstream's Pallas kernel with bf16 q, k and v,
// whose roundings it keeps: S = q kᵀ on bf16 operands into fp32
// accumulators, the online softmax and the row sum in fp32, P rounded to
// bf16 for P·V (fp32 accumulators), o rounded to bf16 once at the end; lse
// and split parts stay fp32.  At d = 64 and 128 the kernel is built for
// Hopper (hopper_wgmma.cuh; below): wgmma on TMA-loaded, 128-byte-swizzled
// tiles, a producer thread, two consumer warpgroups of 64 query rows and one
// block an SM (up to 171 registers a consumer thread at d = 64, 219 at
// d = 128, no spills).  What bounds it: the products at the bf16 rate (989
// TFLOP/s) and, as long at d = 64, the softmax's exponentials (b·h·n·m of
// them at 16 a clock per SM), which the two warpgroups take in turns beside
// the other's products.  At 4096 tokens it reaches ~57% of that bound; what
// holds it there is each warpgroup's chain (the issue of its 16 register-A
// wgmma, which stalls while the products run, the softmax, the packing of P)
// more than any unit's rate.  The d = 512 kernel is built for Hopper too
// (below): what bounds it is the products, but the float32 plan it replaced
// (32-query blocks on mma.sync) streamed all of K and V through each block
// and sat at the L2's rate; 64-query blocks whose two warpgroups split the
// output columns, wgmma, and K and V tiles multicast to clusters of 2 such
// blocks move 4x fewer bytes through L2.  The bf16 combine is bound by
// bytes (each part read once, o and lse written once): it takes a row's
// split weights once and shares them by shuffle, and moves 16 bytes a load
// and a store (flash_attn_fwd_combine_bf16_kernel, below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"   // the bf16 type, TMA, mbarrier rings, setmaxnreg, bf16 wgmma
#include "tf32_mma.cuh"      // 3xTF32 mma.sync products, cp.async tile copies

namespace {

// element strides per (batch, seq, head) of q, k and v
struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh;
};

// A split key loop's partial results in scratch, null without a split: part
// s's unnormalised output rows o[s] (b, n, heads, D), its row max m[s] and
// row sum l[s] (b·heads, n).
struct Parts {
  float *o, *m, *l;
};

// Two adjacent output values, as float32 or rounded to bf16.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows row0 + 16i + g (+ 8) of the (b, n, heads, D) output, columns col0 +
// 8c + 2t (+ 1), from unnormalised accumulators with each row's max and sum:
// as o (divided by the sum, in o's type) and lse, or, with a split, as
// float32 part ``split``.  ``stats``: this thread's warp writes the row
// statistics.
template <int D, int NC, int RW, typename OutT>
__device__ __forceinline__ void write_rows(const float (&acc)[NC][RW][4],
                                           const float (&row_m)[RW][2],
                                           const float (&row_l)[RW][2], OutT* o, float* lse,
                                           const Parts& parts, int split, int b, int heads,
                                           int n, int bi, int hi, int row0, int col0, bool stats,
                                           int g, int t) {
  const long long bh_row = ((long long)bi * heads + hi) * n;
  const long long stats_part = (long long)split * b * heads * n;
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int row = row0 + 16 * i + g + 8 * h8;
      const long long at = (((long long)bi * n + row) * heads + hi) * D + col0 + 2 * t;
      if (parts.o) {
        float* dst = parts.o + (long long)split * b * n * heads * D + at;
#pragma unroll
        for (int c = 0; c < NC; ++c) store2(dst + 8 * c, acc[c][i][2 * h8], acc[c][i][2 * h8 + 1]);
      } else {
        const float l = row_l[i][h8];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          store2(o + at + 8 * c, acc[c][i][2 * h8] / l, acc[c][i][2 * h8 + 1] / l);
      }
      if (stats && t == 0) {
        if (parts.o) {
          parts.m[stats_part + bh_row + row] = row_m[i][h8];
          parts.l[stats_part + bh_row + row] = row_l[i][h8];
        } else if (lse != nullptr) {
          lse[bh_row + row] = row_m[i][h8] + logf(row_l[i][h8]);
        }
      }
    }
}

// ---- d = 64 and 128 -----------------------------------------------------

template <int D, int BQ, int BK>
constexpr size_t fwd_smem_floats() {
  return (size_t)2 * BQ * (D + 4) + (size_t)2 * 2 * BK * (D + 4);
}

// s (16·RW rows x NT·8 keys) = the warp's rows of Q (pre-split halves qb and
// qs, pitch D + 4) times the key tile kt (rows of pitch D + 4) over d.
template <int D, int NT, int RW>
__device__ __forceinline__ void logits(const uint32_t* qb, const uint32_t* qs, const float* kt,
                                       int g, int t, float (&s)[NT][RW][4]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][i][r] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    FragA fa[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int a = (16 * i + g) * P + kk + t;
      const int idx[4] = {a, a + 8 * P, a + 4, a + 8 * P + 4};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fa[i].big[r] = qb[idx[r]];
        fa[i].small[r] = qs[idx[r]];
      }
    }
    FragB fb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      fb[j].set(kt[(8 * j + g) * P + kk + t], kt[(8 * j + g) * P + kk + t + 4]);
    mma3_grid<NT, RW>(s, fa, fb);
  }
}

// The online softmax over one key tile: s becomes P = exp(sm_scale·s - m)
// with m each row's running max, alpha the rescale of what came before, and
// row_l this thread's share of the running row sum (the quad's four shares
// are added at the end).  Rows g and g + 8 of each row tile are spread over
// the four threads of a quad.
template <int NT, int RW>
__device__ __forceinline__ void online_softmax(float (&s)[NT][RW][4], float (&row_m)[RW][2],
                                               float (&row_l)[RW][2], float (&alpha)[RW][2],
                                               float sm_scale) {
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][i][2 * h8 + e] *= sm_scale;
          mx = fmaxf(mx, s[j][i][2 * h8 + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_m[i][h8], mx);
      alpha[i][h8] = expf(row_m[i][h8] - m_new);
      row_m[i][h8] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][i][2 * h8 + e] = expf(s[j][i][2 * h8 + e] - m_new);
          sum += s[j][i][2 * h8 + e];
        }
      row_l[i][h8] = row_l[i][h8] * alpha[i][h8] + sum;
    }
}

// acc = alpha·acc + tile, alpha per row (rows g and g + 8 of each row tile).
template <int NC, int RW>
__device__ __forceinline__ void fold(float (&acc)[NC][RW][4], const float (&tile)[NC][RW][4],
                                     const float (&alpha)[RW][2]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][i][r] = fmaf(alpha[i][r / 2], acc[c][i][r], tile[c][i][r]);
}

template <int D, int BQ, int BK, int RW>
__global__ void __launch_bounds__(BQ / RW * 2)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Parts parts, Strides st, int b, int heads, int n,
                      int tiles_per_split, float sm_scale) {
  constexpr int NTHREADS = BQ / RW * 2, P = D + 4, NT = BK / 8, NC = D / 8;
  constexpr int STAGE = 2 * BK * P;
  extern __shared__ __align__(16) float smem[];
  uint32_t* s_qb = reinterpret_cast<uint32_t*>(smem);   // [BQ][D + 4] big halves of Q
  uint32_t* s_qs = s_qb + BQ * P;                        // [BQ][D + 4] small halves
  float* ring = smem + 2 * BQ * P;                       // 2 x {k [BK][D + 4], v [BK][D + 4]}

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * BQ, split = blockIdx.z;
  const int tile0 = split * tiles_per_split;
  const float* kp = k + bi * st.kb + hi * st.kh;
  const float* vp = v + bi * st.vb + hi * st.vh;

  auto load_stage = [&](int stage, int tile) {
    float* s = ring + stage * STAGE;
    const long long k0 = (long long)tile * BK;
    load_tile_async<BK, D, P, NTHREADS>(s, kp + k0 * st.kn, st.kn, tid);
    load_tile_async<BK, D, P, NTHREADS>(s + BK * P, vp + k0 * st.vn, st.vn, tid);
  };

  // Q lands as floats where its big halves go; each thread splits the
  // 16-byte pieces it copied itself, so no barrier is needed before that
  float* q_raw = smem;
  load_tile_async<BQ, D, P, NTHREADS>(q_raw, q + bi * st.qb + hi * st.qh + (long long)q0 * st.qn,
                                      st.qn, tid);
  cp_async_commit();
  load_stage(0, tile0);
  cp_async_commit();
  cp_async_wait<1>();
  for (int e = tid; e < BQ * (D / 4); e += NTHREADS) {
    const int at = (e / (D / 4)) * P + (e % (D / 4)) * 4;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float val = q_raw[at + x];
      split_tf32(val, s_qb[at + x], s_qs[at + x]);
    }
  }

  float acc[NC][RW][4], row_m[RW][2], row_l[RW][2];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      row_m[i][h8] = -INFINITY;
      row_l[i][h8] = 0.f;
    }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][i][r] = 0.f;

  const int r0 = 16 * RW * warp;   // the warp's first row in the tile
  for (int it = 0; it < tiles_per_split; ++it) {
    if (it + 1 < tiles_per_split) load_stage((it + 1) & 1, tile0 + it + 1);
    cp_async_commit();
    cp_async_wait<1>();       // this tile (and Q) have landed
    __syncthreads();
    const float* s_k = ring + (it & 1) * STAGE;
    const float* s_v = s_k + BK * P;

    float s[NT][RW][4], alpha[RW][2];
    logits<D, NT, RW>(s_qb + r0 * P, s_qs + r0 * P, s_k, g, t, s);
    online_softmax<NT, RW>(s, row_m, row_l, alpha, sm_scale);
    float tile[NC][RW][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) tile[c][i][r] = 0.f;
    accumulate<D, NT, RW>(tile, s, s_v, g, t);    // this tile's P·V
    fold<NC, RW>(acc, tile, alpha);
    __syncthreads();          // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {        // the quad's shares of the row sum
      row_l[i][h8] += __shfl_xor_sync(0xffffffffu, row_l[i][h8], 1);
      row_l[i][h8] += __shfl_xor_sync(0xffffffffu, row_l[i][h8], 2);
    }
  write_rows<D, NC, RW, float>(acc, row_m, row_l, o, lse, parts, split, b, heads, n, bi, hi,
                               q0 + r0, 0, true, g, t);
}

// ---- d = 512 -------------------------------------------------------------

constexpr int W_BQ = 32, W_BK = 32, W_THREADS = 256;
constexpr int W_PS = W_BK + 8;   // pitch of the logit parts and P: float2 rows on 32 banks

template <int D>
constexpr size_t d512_smem_floats() {
  return (size_t)W_BQ * (D + 4) + (size_t)2 * W_BK * (D + 4) + (size_t)5 * W_BQ * W_PS +
         (size_t)3 * W_BQ;
}

template <int D>
__global__ void __launch_bounds__(W_THREADS)
flash_attn_fwd_d512_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, Parts parts, Strides st, int b, int heads,
                           int n, int tiles_per_split, float sm_scale) {
  constexpr int P = D + 4, DQ = D / 4, NC = D / 64;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                      // [32][D + 4]
  float* s_k = s_q + W_BQ * P;            // [32][D + 4] the key tile
  float* s_v = s_k + W_BK * P;            // [32][D + 4] the value tile
  float* s_part = s_v + W_BK * P;        // [4][32][W_PS] logits by quarter of d
  float* s_p = s_part + 4 * W_BQ * W_PS;  // [32][W_PS] P
  float* s_alpha = s_p + W_BQ * W_PS;     // [32] each row's rescale
  float* s_m = s_alpha + W_BQ;            // [32] row max, at the end
  float* s_l = s_m + W_BQ;                // [32] row sum, at the end

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * W_BQ, split = blockIdx.z;
  const int tile0 = split * tiles_per_split;
  const float* kp = k + bi * st.kb + hi * st.kh;
  const float* vp = v + bi * st.vb + hi * st.vh;
  const int dq = warp & 3, kh = warp >> 2;           // logits: quarter of d, half of the keys
  const int sr = tid >> 3, sc = (tid & 7) * 4;       // softmax: row and 4 columns

  load_tile_async<W_BQ, D, P, W_THREADS>(
      s_q, q + bi * st.qb + hi * st.qh + (long long)q0 * st.qn, st.qn, tid);
  load_tile_async<W_BK, D, P, W_THREADS>(s_k, kp + (long long)tile0 * W_BK * st.kn, st.kn, tid);
  cp_async_commit();

  float acc[NC][2][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][i][r] = 0.f;
  float row_m = -INFINITY, row_l = 0.f;   // of softmax row sr, the same in its 8 threads

  for (int it = 0; it < tiles_per_split; ++it) {
    const long long k0 = (long long)(tile0 + it) * W_BK;
    load_tile_async<W_BK, D, P, W_THREADS>(s_v, vp + k0 * st.vn, st.vn, tid);
    cp_async_commit();
    cp_async_wait<1>();       // the key tile (and Q) have landed
    __syncthreads();

    // this warp's quarter of d for 32 queries x 16 keys
    float s[2][2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][i][r] = 0.f;
    const float* qw = s_q + dq * DQ;
    const float* kw = s_k + 16 * kh * P + dq * DQ;
#pragma unroll 2
    for (int kk = 0; kk < DQ; kk += 8) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = qw + (16 * i + g) * P + kk + t;
        fa[i].set(a[0], a[8 * P], a[4], a[8 * P + 4]);
      }
      FragB fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        fb[j].set(kw[(8 * j + g) * P + kk + t], kw[(8 * j + g) * P + kk + t + 4]);
      mma3_grid<2, 2>(s, fa, fb);
    }
    float* part = s_part + dq * W_BQ * W_PS;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * kh + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(part + (16 * i + g) * W_PS + col) =
            make_float2(s[j][i][0], s[j][i][1]);
        *reinterpret_cast<float2*>(part + (16 * i + g + 8) * W_PS + col) =
            make_float2(s[j][i][2], s[j][i][3]);
      }
    __syncthreads();          // the parts are complete and the key tile is free
    if (it + 1 < tiles_per_split)
      load_tile_async<W_BK, D, P, W_THREADS>(s_k, kp + (k0 + W_BK) * st.kn, st.kn, tid);
    cp_async_commit();

    // softmax: the four parts in order, 8 threads per row
    float x[4];
    {
      const int at = sr * W_PS + sc;
      const float4 p0 = *reinterpret_cast<const float4*>(s_part + at);
      const float4 p1 = *reinterpret_cast<const float4*>(s_part + W_BQ * W_PS + at);
      const float4 p2 = *reinterpret_cast<const float4*>(s_part + 2 * W_BQ * W_PS + at);
      const float4 p3 = *reinterpret_cast<const float4*>(s_part + 3 * W_BQ * W_PS + at);
      x[0] = (((p0.x + p1.x) + p2.x) + p3.x) * sm_scale;
      x[1] = (((p0.y + p1.y) + p2.y) + p3.y) * sm_scale;
      x[2] = (((p0.z + p1.z) + p2.z) + p3.z) * sm_scale;
      x[3] = (((p0.w + p1.w) + p2.w) + p3.w) * sm_scale;
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(row_m, mx);
    const float alpha = expf(row_m - m_new);
    row_m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = expf(x[e] - m_new);
      sum += x[e];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    row_l = row_l * alpha + sum;
    *reinterpret_cast<float4*>(s_p + sr * W_PS + sc) = make_float4(x[0], x[1], x[2], x[3]);
    if ((tid & 7) == 0) s_alpha[sr] = alpha;
    cp_async_wait<1>();       // the value tile has landed (the next key tile may not have)
    __syncthreads();

    // P·V into a fresh tile for columns 64·warp .. 64·warp + 63 of all 32
    // rows, then the fold
    float tile[NC][2][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) tile[c][i][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W_BK; kk += 8) {
      FragA fa[2];   // contraction index permuted: slot t is key kk + 2t, slot t + 4 key kk + 2t + 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 lo = *reinterpret_cast<const float2*>(s_p + (16 * i + g) * W_PS + kk + 2 * t);
        const float2 hi8 =
            *reinterpret_cast<const float2*>(s_p + (16 * i + g + 8) * W_PS + kk + 2 * t);
        fa[i].set(lo.x, hi8.x, lo.y, hi8.y);
      }
      const float* y0 = s_v + (kk + 2 * t) * P + 64 * warp + g;
      FragB fb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) fb[c].set(y0[8 * c], y0[P + 8 * c]);
      mma3_grid<NC, 2>(tile, fa, fb);
    }
    float al[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      al[i][0] = s_alpha[16 * i + g];
      al[i][1] = s_alpha[16 * i + g + 8];
    }
    fold<NC, 2>(acc, tile, al);
    __syncthreads();          // the value tile, P and the rescales are free
  }

  if ((tid & 7) == 0) {
    s_m[sr] = row_m;
    s_l[sr] = row_l;
  }
  __syncthreads();
  float ms[2][2], ls[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      ms[i][h8] = s_m[16 * i + g + 8 * h8];
      ls[i][h8] = s_l[16 * i + g + 8 * h8];
    }
  write_rows<D, NC, 2, float>(acc, ms, ls, o, lse, parts, split, b, heads, n, bi, hi, q0,
                              64 * warp, warp == 0, g, t);
}

// ---- bf16, d = 64 and 128: wgmma on TMA-loaded tiles --------------------
//
// Warp-specialised for Hopper (hopper_wgmma.cuh), as the bf16 backward: one
// block of 384 threads per (128 queries, b·head[, split]), one block an SM.
// The producer warpgroup (threads 256-383) gives its registers to the
// consumers (setmaxnreg 24 / 240), and one of its threads issues every copy:
// Q once, then the key loop's K and V tiles of 128 keys through a ring of 4
// stages at d = 64, 2 at d = 128, each with a "full" mbarrier (the
// producer's arrival and the copies' bytes) and an "empty" one (every
// consumer thread's arrival once its products have read the stage).  Two
// consumer warpgroups own 64 query rows each, their Q rows held as wgmma A
// operands in registers.
// Per key tile j a warpgroup issues S_j = Q K_jᵀ (m64n64k16, the key tile
// K-major along d as stored) and, in the same batch, O += P_{j-1} V_{j-1}
// (P rounded to bf16 as the A operand from registers, the value tile read
// MN-major: no transposed copy, no P in shared memory); S_j's softmax runs
// in fp32 while that product does, in units of log2 (P = ex2(s·c - m) with
// c = sm_scale·log2 e, the row sum over the unrounded P); then O is rescaled
// in registers and P_j packed.  The exponentials (16 a clock per SM) take as
// long as the products at d = 64, so the two warpgroups take turns at them
// (named barriers 1 and 2): one's exponentials run while the other's
// products, row max and packing do.  ptxas moves register arithmetic across
// a barrier freely, so the turn is pinned at both ends: the exponentials
// read a shared word loaded after the bar.sync, and a shared store of the
// row sum, which needs every exponential, precedes the bar.arrive.

constexpr int FB_BQ = 128, FB_BK = 128, FB_THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D>
constexpr int FB_STAGES = D == 64 ? 4 : 2;

// Shared memory (bytes) at head width D: 1024 of alignment slack, Q
// ([128][D]), the ring stages' K and V ([128][D] each), the barriers (full
// and empty a stage, one for Q), and the turns' words: the 1.0 read after
// each bar.sync and one row-sum slot a consumer thread.
template <int D>
constexpr int fwd_bf16_smem_bytes() {
  return 1024 + FB_BQ * D * 2 + FB_STAGES<D> * 2 * FB_BK * D * 2 +
         (2 * FB_STAGES<D> + 1) * 8 + 4 * (1 + 256);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Arrive at named barrier ``id`` (1 or 2; 0 is __syncthreads) over ``count``
// threads without waiting (``bar_sync``, hopper_wgmma.cuh, waits).
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float ld_shared(const float* p) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(smem_u32(p)) : "memory");
  return x;
}
__device__ __forceinline__ void st_shared(float* p, float x) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(smem_u32(p)), "f"(x) : "memory");
}

// s (64 x 128) = the warpgroup's Q rows (the A operands of D / 16 k-steps in
// registers, ``load_a_rows``) · the key tile's rowsᵀ over D, as two
// accumulators of 64 keys: the tile ``kt`` ([128][D] as D / 64 column blocks
// of 128 rows) K-major along d.
template <int D>
__device__ __forceinline__ void logits_fwd(float (&s)[2][32], const uint32_t (&q)[D / 16][4],
                                           const bf16* kt) {
  uint64_t dk = desc_sw128(kt, 16, 1024);
  opaque(dk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
      wgmma_rs<0>(s[nb], q[kk],
                  dk + (((kk / 4) * FB_BK * 128 + nb * 64 * 128 + (kk % 4) * 32) >> 4), kk > 0);
}

// o (64 x D) += p (64 x 128: the A operands of 8 k-steps) · the value tile
// ``vt`` ([128][D] as D / 64 column blocks of 128 rows) read MN-major.
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 64][32], const uint32_t (&p)[8][4],
                                              const bf16* vt) {
  uint64_t dv = desc_sw128(vt, FB_BK * 128, 1024);
  opaque(dv);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wgmma_rs<1>(o[c], p[kk], dv + ((c * FB_BK * 128 + kk * 16 * 128) >> 4), 1);
}

// The online softmax's first half over one key tile of S (entry i of a
// 64-key accumulator is row g + 8·((i % 4) / 2) of the warp's 16): each
// row's running max m of s·c (in four independent parts a row, for short
// chains), and alpha = 2^(m_old - m), the rescale of what came before.  NEG:
// c < 0, where the max of s·c is c times the min of s.
template <bool NEG>
__device__ __forceinline__ void row_max_fwd(const float (&s)[2][32], float (&row_m)[2],
                                            float (&alpha)[2], float c) {
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[h][q] = NEG ? INFINITY : -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float& m = mx[(i % 4) / 2][(i / 4) % 4];
      m = NEG ? fminf(m, s[nb][i]) : fmaxf(m, s[nb][i]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = NEG ? fminf(fminf(mx[h][0], mx[h][1]), fminf(mx[h][2], mx[h][3]))
                  : fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
#pragma unroll
    for (int lane_mask = 1; lane_mask < 4; lane_mask <<= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, m, lane_mask);
      m = NEG ? fminf(m, o) : fmaxf(m, o);
    }
    const float m_new = fmaxf(row_m[h], m * c);
    alpha[h] = ex2(row_m[h] - m_new);
    row_m[h] = m_new;
  }
}

// Its second half: s becomes P = 2^(s·c - m), and row_l, this thread's share
// of the running row sum (the quad's four shares are added at the end),
// becomes alpha·row_l plus the tile's P (in four parts a row).
__device__ __forceinline__ void exp_sum_fwd(float (&s)[2][32], const float (&row_m)[2],
                                            float (&row_l)[2], const float (&alpha)[2], float c) {
  float sum[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[h][q] = 0.f;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[nb][i] = ex2(fmaf(s[nb][i], c, -row_m[(i % 4) / 2]));
      sum[(i % 4) / 2][(i / 4) % 4] += s[nb][i];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row_l[h] = row_l[h] * alpha[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
}

// acc *= alpha by row, skipped where every row of the warp keeps its max
// (alpha = 1: the product would change nothing).
template <int CB>
__device__ __forceinline__ void rescale(float (&acc)[CB][32], const float (&alpha)[2]) {
  if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i % 4) / 2];
}

// P (the softmax's s, rounded to bf16) as the A operands of P·V's k-steps:
// k-step 4·nb + kk is key block nb's columns 16kk .. 16kk + 15.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[2][32]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[4 * nb + kk][i] = pack_bf16x2(s[nb][8 * kk + 2 * i], s[nb][8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(x[i]);
}

template <int D, bool NEG>
__global__ void __launch_bounds__(FB_THREADS, 1)
flash_attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                           float* __restrict__ lse, Parts parts, int b, int heads, int n,
                           int tiles_per_split, float sm_scale) {
  constexpr int CB = D / 64, STAGES = FB_STAGES<D>;
  constexpr int Q_BYTES = FB_BQ * D * 2, TILE_BYTES = FB_BK * D * 2;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* base = align1024(smem_tma);
  bf16* s_q = reinterpret_cast<bf16*>(base);                  // CB blocks of [128][64]
  unsigned char* ring = base + Q_BYTES;                        // STAGES x {k, v}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  float* s_turn = reinterpret_cast<float*>(q_bar + 1);          // [1 + 256]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * FB_BQ, split = blockIdx.z, tile0 = split * tiles_per_split;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(q_bar, 1);
    s_turn[0] = 1.f;
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {   // the producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_arrive_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tma_load_4d(s_q + c * FB_BQ * 64, &tm_q, q_bar, 64 * c, hi, q0, bi);
      for (int it = 0; it < tiles_per_split; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        bf16* sk = reinterpret_cast<bf16*>(ring + s * 2 * TILE_BYTES);
        bf16* sv = sk + FB_BK * D;
        const int k0 = (tile0 + it) * FB_BK;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(sk + c * FB_BK * 64, &tm_k, &full[s], 64 * c, hi, k0, bi);
          tma_load_4d(sv + c * FB_BK * 64, &tm_v, &full[s], 64 * c, hi, k0, bi);
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  setmaxnreg_inc<240>();
  const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int last = tiles_per_split - 1;
  const float scale_log2 = sm_scale * LOG2E;
  float acc[CB][32], row_m[2] = {-INFINITY, -INFINITY}, row_l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  auto key_tile = [&](int it) {
    return reinterpret_cast<const bf16*>(ring + (it % STAGES) * 2 * TILE_BYTES);
  };
  mbar_wait(q_bar, 0);
  __syncwarp();
  uint32_t q_frag[D / 16][4];
  load_a_rows<D>(q_frag, s_q, FB_BQ, 64 * wg, wq, lane);
  float s[2][32];
  uint32_t p[8][4];

  // Tile it's softmax, the exponentials in this warpgroup's turn.  Turns
  // alternate from warpgroup 0, which warpgroup 1's first arrival lets
  // start; warpgroup 1 does not arrive after its last (so that every
  // arrival meets a wait).
  auto softmax = [&](int it) {
    row_max_fwd<NEG>(s, row_m, alpha, scale_log2);
    bar_sync(1 + wg, 256);
    const float one = ld_shared(s_turn);
    exp_sum_fwd(s, {row_m[0] * one, row_m[1] * one}, row_l, alpha, scale_log2);
    st_shared(s_turn + 1 + tid, row_l[0] + row_l[1]);
    if (wg == 0 || it < last) bar_arrive(2 - wg, 256);
  };
  auto issue_logits = [&](int it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    __syncwarp();
    fence_all(s);
    fence_regs(q_frag);
    wgmma_fence();
    logits_fwd<D>(s, q_frag, key_tile(it));
    wgmma_commit();
  };
  auto after_logits = [&] {
    fence_all(s);
    fence_regs(q_frag);
  };

  if (wg == 1) bar_arrive(1, 256);
  issue_logits(0);
  wgmma_wait<0>();
  after_logits();
  softmax(0);
  pack_p(p, s);
  for (int it = 1; it <= last; ++it) {
    fence_regs(p);
    fence_all(acc);
    issue_logits(it);                                          // S_it, then
    accumulate_pv<D>(acc, p, key_tile(it - 1) + FB_BK * D);   // O += P_{it-1} V_{it-1}
    wgmma_commit();
    wgmma_wait<1>();
    after_logits();
    softmax(it);
    wgmma_wait<0>();
    fence_regs(p);
    fence_all(acc);
    mbar_arrive(&empty[(it - 1) % STAGES]);
    rescale<CB>(acc, alpha);
    pack_p(p, s);
  }
  fence_regs(p);
  fence_all(acc);
  wgmma_fence();
  accumulate_pv<D>(acc, p, key_tile(last) + FB_BK * D);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(p);
  fence_all(acc);
  mbar_arrive(&empty[last % STAGES]);

#pragma unroll
  for (int h = 0; h < 2; ++h) {        // the quad's shares of the row sum
    row_l[h] += __shfl_xor_sync(0xffffffffu, row_l[h], 1);
    row_l[h] += __shfl_xor_sync(0xffffffffu, row_l[h], 2);
  }
  // the accumulators in write_rows' layout (entry 32c + 4j + r of acc is
  // column 8·(8c + j) + 2t + r % 2), the row max in natural-log units
  const float m_nat[1][2] = {{row_m[0] * LN2, row_m[1] * LN2}};
  const float l_rows[1][2] = {{row_l[0], row_l[1]}};
  write_rows<D, D / 8, 1, bf16>(reinterpret_cast<const float(&)[D / 8][1][4]>(acc), m_nat,
                                l_rows, o, lse, parts, split, b, heads, n, bi, hi,
                                q0 + 64 * wg + 16 * wq, 0, true, g, t);
}

// ---- bf16, d = 512: wgmma over K and V tiles multicast across a cluster --
//
// The VAE's single head.  One block of 384 threads per (64 queries, b·head[,
// split]): a producer warpgroup (threads 256-383; setmaxnreg 40 / 232) and two
// consumer warpgroups that own the same 64 query rows.  A 64 x 512 fp32 output
// does not fit one warpgroup's registers, so the consumers split the output
// columns: warpgroup w keeps columns 256w .. 256w + 255 (128 accumulators a
// thread).  Q (64 x 512) lands once by TMA and stays in shared memory as the
// logits' K-major A operand.  Per key tile of 64:
//   * warpgroup w computes S for keys 32w .. 32w + 31 over all of d
//     (m64n32k16, the key tile K-major as stored), so no partial logits are
//     added; each row's max over the warpgroup's keys goes to shared memory,
//     one named barrier, and both take the max of the two;
//   * each forms its half of P = 2^(s·c - m) (c = sm_scale·log2 e, the row sum
//     over the unrounded fp32 P, its own share until the end) and writes it,
//     rounded to bf16, into a shared [64][64] tile (two, alternating), then
//     fence.proxy.async and a second named barrier hand it to both;
//   * O += P V as m64n256k16 with P the shared A operand and the warpgroup's
//     256 columns of the value tile read MN-major (imm-trans-b), issued beside
//     the next tile's S.
// At the end the two warpgroups' row sums are added in order, o is rounded to
// bf16 once and lse = m + log l in fp32 (a split writes fp32 parts).  No
// atomics: two launches repeat bit for bit.
//
// What bounds it: the products, 4·b·h·n·m·d operations, ~35 µs at b·h = 1 and
// 4096 tokens at the bf16 rate.  The float32 plan it replaced (32 queries a
// block, mma.sync) streamed all of K and V through every block, 4·b·h·n·m·d /
// 32 bytes through L2 (1.07 GB at b·h = 1), and sat at the L2's rate.  Here
// a block takes 64 queries, and blocks go in clusters of 2 along the
// queries: each block's producer loads half of the column blocks of each K
// and V tile and multicasts them to the pair, so a tile crosses L2 once for
// 128 queries, 4·b·h·n·m·d / 128 bytes.  (Clusters of 4 move half that, but
// the card holds 30 of them at once, not the 32 that 128 blocks make: two
// waves.)  K and V have one slot each (Q 64 KB, K 64 KB, V 64 KB and P 16
// KB fill ~210 KB), filled by two producer threads.  The K slot is two halves
// along d (column blocks 0-3 and 4-7), each with its own barriers and its
// own commit group of S's k-steps, so that K_{j+1}'s first half loads while
// S_j's second half runs; the rest of K_{j+1} while P_{j-1} V_{j-1} and tile
// j's softmax run; V_j while the next logits do.  A slot is free once both
// blocks' consumer warps have arrived on its empty barrier.  The exponentials (b·h·n·m at 16 a clock per SM) are ~1/8 of the
// products' time at d = 512, so the warpgroups take them together (no
// turns).

constexpr int FD_D = 512, FD_BQ = 64, FD_BK = 64, FD_THREADS = 384;
constexpr int FD_CLUSTER = 2;      // blocks a cluster (n is a multiple of 128: tiles in pairs)
constexpr int FD_CB = FD_D / 64;   // 64-column blocks of a row

// Shared memory (bytes): 1024 of alignment slack, Q ([64][512]), one K and
// one V tile ([64][512] each), P twice ([64][64]), each row's max and sum by
// warpgroup ([2][64] floats each), and seven barriers (full and empty for
// each half of K and for V, and Q's).
constexpr int fwd_d512_bf16_smem_bytes() {
  return 1024 + FD_BQ * FD_D * 2 + 2 * FD_BK * FD_D * 2 + 2 * FD_BQ * FD_BK * 2 +
         2 * 2 * FD_BQ * 4 + 7 * 8;
}

template <bool NEG>
__global__ void __launch_bounds__(FD_THREADS, 1)
flash_attn_fwd_d512_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                                float* __restrict__ lse, Parts parts, int b, int heads, int n,
                                int tiles_per_split, float sm_scale) {
  constexpr int BLOCK = FD_BK * 64;   // elements of a [64][64] column block
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* base = align1024(smem_tma);
  bf16* s_q = reinterpret_cast<bf16*>(base);      // FD_CB blocks of [64][64]
  bf16* s_k = s_q + FD_BQ * FD_D;
  bf16* s_v = s_k + FD_BK * FD_D;
  bf16* s_p = s_v + FD_BK * FD_D;                 // 2 x [64][64]
  float* s_max = reinterpret_cast<float*>(s_p + 2 * FD_BQ * FD_BK);   // [2][64]
  float* s_sum = s_max + 2 * FD_BQ;                                   // [2][64]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(s_sum + 2 * FD_BQ);   // [2]: by half of d
  uint64_t *empty_k = full_k + 2, *full_v = full_k + 4, *empty_v = full_k + 5, *q_bar = full_k + 6;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * FD_BQ, split = blockIdx.z, tile0 = split * tiles_per_split;
  if (tid == 0) {
    for (int h = 0; h < 2; ++h) {
      mbar_init(&full_k[h], 1);
      mbar_init(&empty_k[h], 8 * FD_CLUSTER);   // every consumer warp of the cluster
    }
    mbar_init(full_v, 1);
    mbar_init(empty_v, 8 * FD_CLUSTER);
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  cluster_sync();   // every block's barriers exist before a load or arrival reaches them

  if (tid >= 256) {   // the producer warpgroup: K (and Q) from thread 256, V from 288
    setmaxnreg_dec<40>();
    if (tid == 256 || tid == 288) {
      const bool is_k = tid == 256;
      const int pieces = is_k ? 2 : 1, blocks = FD_CB / pieces;   // K by half of d
      const uint32_t rank = cluster_ctarank();
      const uint16_t mask = (1u << FD_CLUSTER) - 1;
      uint64_t* full = is_k ? full_k : full_v;
      uint64_t* empty = is_k ? empty_k : empty_v;
      bf16* dst = is_k ? s_k : s_v;
      if (is_k) {
        mbar_arrive_expect_tx(q_bar, FD_BQ * FD_D * 2);
        for (int c = 0; c < FD_CB; ++c)
          tma_load_4d(s_q + c * FD_BQ * 64, &tm_q, q_bar, 64 * c, hi, q0, bi);
      }
      for (int it = 0; it < tiles_per_split; ++it) {
        const int k0 = (tile0 + it) * FD_BK;
        for (int h = 0; h < pieces; ++h) {
          if (it > 0) mbar_wait(&empty[h], (it - 1) & 1);
          mbar_arrive_expect_tx(&full[h], blocks * BLOCK * 2);
          for (int c = h * blocks + rank; c < (h + 1) * blocks; c += FD_CLUSTER)
            tma_load_4d_multicast(dst + c * BLOCK, is_k ? &tm_k : &tm_v, &full[h], 64 * c, hi, k0,
                                  bi, mask);
        }
      }
    }
  } else {   // the consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = 16 * wq + g;   // this thread's rows: r0 and r0 + 8
    const int last = tiles_per_split - 1;
    const float c = sm_scale * LOG2E;
    float acc[128], s[16], row_m[2] = {-INFINITY, -INFINITY}, row_l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // a consumer warp's arrival on a slot's empty barrier in every block
    // (lane r on block r's)
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane < FD_CLUSTER) mbar_arrive_cluster(bar, lane);
    };
    // S = Q · (this warpgroup's 32 keys of K tile it)ᵀ over d, each half of d
    // its own commit group
    auto issue_s = [&](int it) {
      uint64_t dq = desc_sw128(s_q, 16, 1024), dk = desc_sw128(s_k + 32 * wg * 64, 16, 1024);
      opaque(dq);
      opaque(dk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mbar_wait(&full_k[h], it & 1);
        __syncwarp();
#pragma unroll
        for (int kk = 16 * h; kk < 16 * h + 16; ++kk) {
          const int off = ((kk / 4) * BLOCK * 2 + (kk % 4) * 32) >> 4;   // Q, K: 64-row blocks
          wgmma_ss_n32<0>(s, dq + off, dk + off, kk > 0);
        }
        wgmma_commit();
      }
    };
    // O += P_it · (this warpgroup's 256 columns of V tile it)
    auto issue_pv = [&](int it) {
      mbar_wait(full_v, it & 1);
      __syncwarp();
      uint64_t dp = desc_sw128(s_p + (it & 1) * FD_BQ * FD_BK, 16, 1024);
      uint64_t dv = desc_sw128(s_v + 4 * wg * BLOCK, BLOCK * 2, 1024);
      opaque(dp);
      opaque(dv);
#pragma unroll
      for (int kk = 0; kk < FD_BK / 16; ++kk)
        wgmma_ss_n256<1>(acc, dp + ((kk * 32) >> 4), dv + ((kk * 16 * 128) >> 4), 1);
    };
    // tile it's softmax over this warpgroup's keys (entry i of s is row r0 +
    // 8·((i % 4) / 2), key 32wg + 8·(i / 4) + 2t + i % 2), P into buffer it % 2
    auto softmax = [&](int it) {
      float pm[2] = {NEG ? INFINITY : -INFINITY, NEG ? INFINITY : -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        pm[(i % 4) / 2] = NEG ? fminf(pm[(i % 4) / 2], s[i]) : fmaxf(pm[(i % 4) / 2], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int lane_mask = 1; lane_mask < 4; lane_mask <<= 1) {
          const float x = __shfl_xor_sync(0xffffffffu, pm[h], lane_mask);
          pm[h] = NEG ? fminf(pm[h], x) : fmaxf(pm[h], x);
        }
      if (t == 0) {
        s_max[64 * wg + r0] = pm[0] * c;
        s_max[64 * wg + r0 + 8] = pm[1] * c;
      }
      bar_sync(1, 256);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(row_m[h], fmaxf(pm[h] * c, s_max[64 * (1 - wg) + r0 + 8 * h]));
        alpha[h] = ex2(row_m[h] - m_new);
        row_m[h] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[i] = ex2(fmaf(s[i], c, -row_m[(i % 4) / 2]));
        sum[(i % 4) / 2] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) row_l[h] = row_l[h] * alpha[h] + sum[h];
      // [64 rows][64 keys] under the 128-byte swizzle: key chunk 4wg + j of row r at chunk
      // (4wg + j) ^ (r % 8)
      unsigned char* pb = reinterpret_cast<unsigned char*>(s_p + (it & 1) * FD_BQ * FD_BK);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          *reinterpret_cast<uint32_t*>(pb + row * 128 + (((4 * wg + j) ^ (row & 7)) << 4) +
                                       4 * t) = pack_bf16x2(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
        }
      fence_proxy_async();
    };

    mbar_wait(q_bar, 0);
    __syncwarp();
    fence_regs(s);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<1>();
    if (last > 0) release(&empty_k[0]);
    wgmma_wait<0>();
    fence_regs(s);
    if (last > 0) release(&empty_k[1]);
    softmax(0);
    bar_sync(2, 256);   // both halves of P_0 are in place
    for (int it = 1; it <= last; ++it) {
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_s(it);          // S_it (two groups), then
      issue_pv(it - 1);     // O += P_{it-1} V_{it-1}
      wgmma_commit();
      wgmma_wait<2>();
      if (it < last) release(&empty_k[0]);
      wgmma_wait<1>();
      fence_regs(s);
      if (it < last) release(&empty_k[1]);
      softmax(it);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v);
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i % 4) / 2];
      }
      bar_sync(2, 256);     // both halves of P_it are in place, P_{it-1} is free
    }
    fence_regs(acc);
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // the row sums: the quad's shares, then the two warpgroups' in order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_l[h] += __shfl_xor_sync(0xffffffffu, row_l[h], 1);
      row_l[h] += __shfl_xor_sync(0xffffffffu, row_l[h], 2);
    }
    if (t == 0) {
      s_sum[64 * wg + r0] = row_l[0];
      s_sum[64 * wg + r0 + 8] = row_l[1];
    }
    bar_sync(1, 256);
    const float l_rows[1][2] = {{s_sum[r0] + s_sum[64 + r0], s_sum[r0 + 8] + s_sum[64 + r0 + 8]}};
    const float m_nat[1][2] = {{row_m[0] * LN2, row_m[1] * LN2}};
    // the accumulators in write_rows' layout (entry 4j + r: column 8j + 2t + r % 2)
    write_rows<FD_D, 32, 1, bf16>(reinterpret_cast<const float(&)[32][1][4]>(acc), m_nat, l_rows,
                                  o, lse, parts, split, b, heads, n, bi, hi, q0 + 16 * wq,
                                  256 * wg, wg == 0, g, t);
  }
  cluster_sync();   // no block leaves while another may still arrive on its barriers
}

// ---- the parts of a split key loop ---------------------------------------

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  store2(p, x.x, x.y);
  store2(p + 2, x.z, x.w);
}

// o row r (of b·n·heads), columns c .. c + 3, and lse: the parts merged in
// order, o = sum_s e^(m_s - M) o_s / L with M = max_s m_s and L = sum_s
// e^(m_s - M) l_s; lse = M + log L; o in its own type.
template <typename OutT>
__device__ __forceinline__ void combine_rows(const Parts& parts, OutT* __restrict__ o,
                                             float* __restrict__ lse, int b, int heads, int n,
                                             int d, int nsplit) {
  const long long rows = (long long)b * n * heads, chunks = d / 4;
  const long long part = rows * d, stats = (long long)b * heads * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < rows * chunks;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / chunks;
    const int c = (int)(e % chunks) * 4;
    const int hi = (int)(r % heads), i = (int)((r / heads) % n), bi = (int)(r / heads / n);
    const long long srow = ((long long)bi * heads + hi) * n + i;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, parts.m[s * stats + srow]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(parts.m[s * stats + srow] - mx);
      l += w * parts.l[s * stats + srow];
      const float4 x = *reinterpret_cast<const float4*>(parts.o + s * part + r * d + c);
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
    store4(o + r * d + c, make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l));
    if (lse != nullptr && c == 0) lse[srow] = mx + logf(l);
  }
}

__global__ void flash_attn_fwd_combine_kernel(Parts parts, float* __restrict__ o,
                                              float* __restrict__ lse, int b, int heads, int n,
                                              int d, int nsplit) {
  combine_rows<float>(parts, o, lse, b, heads, n, d, nsplit);
}

// The same function writing a bf16 o, redesigned for the bf16 forward's
// parts (at most CB_MAX_SPLIT): a row is CB_LANES(D) neighbouring lanes of a
// warp, 8 columns a lane per chunk (CB_CHUNKS(D) chunks: 1 at d = 64 and
// 128, 2 at d = 512, where a row takes a whole warp), one row a lane group,
// blocks of CB_THREADS sized to the rows (no grid-stride loop).  Lane s of
// a row loads split s's row max and sum and takes its weight e^(m_s - M)
// once; M comes from a butterfly max over the row's lanes (max is exact in
// any order), and every lane reads the weights by shuffle, in split order.
// Each lane reads its columns of each part as two 16-byte loads a chunk and
// writes them as one 16-byte bf16 store.  The arithmetic of each element
// and its order over the splits are those of combine_rows, so o and lse are
// bit for bit the same as its.
constexpr int CB_THREADS = 256, CB_MAX_SPLIT = 8;
template <int D>
constexpr int CB_LANES = D / 8 < 32 ? D / 8 : 32;
template <int D>
constexpr int CB_CHUNKS = D / (8 * CB_LANES<D>);

template <int D>
__global__ void __launch_bounds__(CB_THREADS)
flash_attn_fwd_combine_bf16_kernel(Parts parts, bf16* __restrict__ o, float* __restrict__ lse,
                                   int b, int heads, int n, int nsplit) {
  constexpr int G = CB_LANES<D>, CH = CB_CHUNKS<D>;
  const int lane = threadIdx.x & 31, g = lane % G, base = lane - g;
  const long long rows = (long long)b * n * heads;
  const long long r = (long long)blockIdx.x * (CB_THREADS / G) + threadIdx.x / G;
  const bool live = r < rows;     // rows % (CB_THREADS / G) == 0 (n % 128 == 0): all live
  const int hi = (int)(r % heads), i = (int)((r / heads) % n), bi = (int)(r / heads / n);
  const long long stats = (long long)b * heads * n, srow = ((long long)bi * heads + hi) * n + i;
  float m_g = -INFINITY, l_g = 0.f;
  if (live && g < nsplit) {
    m_g = parts.m[g * stats + srow];
    l_g = parts.l[g * stats + srow];
  }
  float mx = m_g;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float w_g = g < nsplit ? expf(m_g - mx) : 0.f;
  float l = 0.f;
  float acc[CH][8] = {};
  const long long part = rows * D;
  const float* src = parts.o + r * D + 8 * g;
  for (int s = 0; s < nsplit; ++s) {
    const float w = __shfl_sync(0xffffffffu, w_g, base + s);
    l += w * __shfl_sync(0xffffffffu, l_g, base + s);
    if (!live) continue;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(src + s * part + 8 * G * c);
      const float4 x1 = *reinterpret_cast<const float4*>(src + s * part + 8 * G * c + 4);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c][j] = fmaf(w, x[j], acc[c][j]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    uint4 packed;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h2[j] = __floats2bfloat162_rn(acc[c][2 * j] / l, acc[c][2 * j + 1] / l);
    *reinterpret_cast<uint4*>(o + r * D + 8 * g + 8 * G * c) = packed;
  }
  if (lse != nullptr && g == 0) lse[srow] = mx + logf(l);
}

// ---- launches ------------------------------------------------------------

// q, k, v and o in T (float or bf16); lse and the scratch of a split in float
template <typename T>
struct Args {
  const T *q, *k, *v;
  T* o;
  float *lse, *scratch;
  Strides st;
  int b, heads, n, m, split;
  float sm_scale;
};

// scratch as [o parts | row max parts | row sum parts], or no parts
template <typename T>
Parts parts_of(const Args<T>& a, int d) {
  if (a.split == 1) return Parts{nullptr, nullptr, nullptr};
  const long long po = (long long)a.split * a.b * a.n * a.heads * d;
  const long long ps = (long long)a.split * a.b * a.heads * a.n;
  return Parts{a.scratch, a.scratch + po, a.scratch + po + ps};
}

template <int D>
cudaError_t launch_combine_bf16(const Parts& parts, bf16* o, float* lse, int b, int heads,
                                int n, int nsplit, cudaStream_t stream) {
  const long long rows = (long long)b * n * heads, per_block = CB_THREADS / CB_LANES<D>;
  flash_attn_fwd_combine_bf16_kernel<D>
      <<<(unsigned)((rows + per_block - 1) / per_block), CB_THREADS, 0, stream>>>(
          parts, o, lse, b, heads, n, nsplit);
  return cudaGetLastError();
}

// the bf16 combine at head width d (64, 128 or 512), 1 < nsplit <= CB_MAX_SPLIT
cudaError_t combine_bf16(const Parts& parts, bf16* o, float* lse, int b, int heads, int n, int d,
                         int nsplit, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > CB_MAX_SPLIT) return cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch_combine_bf16<64>(parts, o, lse, b, heads, n, nsplit, stream);
    case 128: return launch_combine_bf16<128>(parts, o, lse, b, heads, n, nsplit, stream);
    case 512: return launch_combine_bf16<512>(parts, o, lse, b, heads, n, nsplit, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_combine(const Args<T>& a, const Parts& parts, int d, cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(float)) {
    const long long work = (long long)a.b * a.n * a.heads * (d / 4);
    const int blocks = (int)(work / 256 < 1056 ? (work + 255) / 256 : 1056);
    flash_attn_fwd_combine_kernel<<<blocks, 256, 0, stream>>>(parts, a.o, a.lse, a.b, a.heads,
                                                              a.n, d, a.split);
    return cudaGetLastError();
  } else {
    return combine_bf16(parts, a.o, a.lse, a.b, a.heads, a.n, d, a.split, stream);
  }
}

// the main kernel on its grid, then, with a split, the combine
template <typename T, typename K>
cudaError_t launch_split(K kernel, int bq, int bk, int threads, size_t smem, int d,
                         const Args<T>& a, cudaStream_t stream) {
  const int tiles = a.m / bk;
  if (a.n % bq || a.m % bk || tiles % a.split) return cudaErrorInvalidValue;
  if (a.split > 1 && a.scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Parts parts = parts_of(a, d);
  kernel<<<dim3(a.n / bq, a.b * a.heads, a.split), threads, smem, stream>>>(
      a.q, a.k, a.v, a.o, a.lse, parts, a.st, a.b, a.heads, a.n, tiles / a.split, a.sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return a.split > 1 ? launch_combine(a, parts, d, stream) : cudaSuccess;
}

template <int D, int BQ, int BK, int RW>
cudaError_t launch_fused(const Args<float>& a, cudaStream_t stream) {
  return launch_split(flash_attn_fwd_kernel<D, BQ, BK, RW>, BQ, BK, BQ / RW * 2,
                      sizeof(float) * fwd_smem_floats<D, BQ, BK>(), D, a, stream);
}

template <int D>
cudaError_t launch_d512(const Args<float>& a, cudaStream_t stream) {
  return launch_split(flash_attn_fwd_d512_kernel<D>, W_BQ, W_BK, W_THREADS,
                      sizeof(float) * d512_smem_floats<D>(), D, a, stream);
}

// The bf16 kernels (``pos``, and ``neg`` for a negative scale) over tensor
// maps of q, k and v's strided views (boxes of 64 columns x bq query or bk
// key rows), blocks of bq queries in clusters of ``cluster`` along the
// queries (1: a plain grid); a split writes float parts, which the combine
// merges.
template <typename K>
cudaError_t launch_bf16(K pos, K neg, int d, int bq, int bk, int threads, int smem, int cluster,
                        const Args<bf16>& a, cudaStream_t stream) {
  const int tiles = a.m / bk;
  if (a.n % (bq * cluster) || a.m % bk || tiles % a.split) return cudaErrorInvalidValue;
  if (a.split > 1 && a.scratch == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const Strides& st = a.st;
  cudaError_t err = bf16_tile_map(&tq, a.q, a.b, a.n, a.heads, d, st.qb, st.qn, st.qh, bq);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tk, a.k, a.b, a.m, a.heads, d, st.kb, st.kn, st.kh, bk);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tv, a.v, a.b, a.m, a.heads, d, st.vb, st.vn, st.vh, bk);
  if (err != cudaSuccess) return err;
  const K kernel = a.sm_scale < 0 ? neg : pos;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Parts parts = parts_of(a, d);
  bf16* o = a.o;
  float* lse = a.lse;
  int b = a.b, heads = a.heads, n = a.n, per_split = tiles / a.split;
  float sm_scale = a.sm_scale;
  void* args[] = {&tq, &tk, &tv, &o, &lse, &parts, &b, &heads, &n, &per_split, &sm_scale};
  err = launch_cluster(reinterpret_cast<const void*>(kernel),
                       dim3(a.n / bq, a.b * a.heads, a.split), threads, smem, cluster, args,
                       stream);
  if (err != cudaSuccess) return err;
  return a.split > 1 ? launch_combine(a, parts, d, stream) : cudaSuccess;
}

}  // namespace

extern "C" {

const char* flash_attn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q: (b, n, heads, d), k and v: (b, m, heads, d); float32 on the current
// device, element strides per (batch, seq, head), unit stride along d, every
// stride a multiple of 4 and every base 16-byte aligned; n and m multiples
// of 128.  o: contiguous (b, n, heads, d).  lse: null, or a contiguous (b,
// heads, n) output for each row's log-sum-exp of the scaled logits.  split:
// the number of parts the key loop is cut into (a power of 2 dividing m/32);
// with split > 1, scratch holds split·b·heads·n·(d + 2) floats, else may be
// null.  Launches the kernels on the stream and returns the first launch
// error (cudaSuccess = 0).
int flash_attn_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                   float* scratch, long long qb, long long qn, long long qh, long long kb,
                   long long kn, long long kh, long long vb, long long vn, long long vh, int b,
                   int heads, int n, int m, int d, int split, float sm_scale, void* stream) {
  const Args<float> a{q, k, v, o, lse, scratch, Strides{qb, qn, qh, kb, kn, kh, vb, vn, vh},
                      b, heads, n, m, split, sm_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 128 != 0 || m % 128 != 0 || split < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return (int)launch_fused<64, 128, 32, 2>(a, s);
    case 128: return (int)launch_fused<128, 128, 32, 1>(a, s);
    case 512: return (int)launch_d512<512>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// flash_attn_fwd with bf16 q, k, v and o (lse and scratch float32): every
// stride a multiple of 8 and every base 16-byte aligned, below 2^39 elements
// (the tensor maps); split divides m/128 at d = 64 and 128, m/64 at d = 512.
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        float* scratch, long long qb, long long qn, long long qh, long long kb,
                        long long kn, long long kh, long long vb, long long vn, long long vh,
                        int b, int heads, int n, int m, int d, int split, float sm_scale,
                        void* stream) {
  const Args<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, scratch,
                     Strides{qb, qn, qh, kb, kn, kh, vb, vn, vh}, b, heads, n, m, split,
                     sm_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 128 != 0 || m % 128 != 0 || split < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return (int)launch_bf16(flash_attn_fwd_bf16_kernel<64, false>,
                              flash_attn_fwd_bf16_kernel<64, true>, 64, FB_BQ, FB_BK, FB_THREADS,
                              fwd_bf16_smem_bytes<64>(), 1, a, s);
    case 128:
      return (int)launch_bf16(flash_attn_fwd_bf16_kernel<128, false>,
                              flash_attn_fwd_bf16_kernel<128, true>, 128, FB_BQ, FB_BK,
                              FB_THREADS, fwd_bf16_smem_bytes<128>(), 1, a, s);
    case 512:
      return (int)launch_bf16(flash_attn_fwd_d512_bf16_kernel<false>,
                              flash_attn_fwd_d512_bf16_kernel<true>, FD_D, FD_BQ, FD_BK,
                              FD_THREADS, fwd_d512_bf16_smem_bytes(), FD_CLUSTER, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 kernel's dynamic shared memory a block at head width d (64, 128
// or 512), or -1; the wrapper checks its own plan against it.
int flash_attn_fwd_bf16_smem_bytes(int d) {
  switch (d) {
    case 64: return fwd_bf16_smem_bytes<64>();
    case 128: return fwd_bf16_smem_bytes<128>();
    case 512: return fwd_d512_bf16_smem_bytes();
    default: return -1;
  }
}

// Blocks a cluster of the bf16 kernel at head width d (1: no cluster); the
// wrapper checks its own plan against it.
int flash_attn_fwd_bf16_cluster(int d) { return d == 512 ? FD_CLUSTER : 1; }

// flash_attn_fwd_combine_bf16 alone: the split parts of a bf16 forward,
// o_parts (split, b, n, heads, d) and its row maxima m and sums l (split, b,
// heads, n), all float32, merged in order into the bf16 o (b, n, heads, d)
// and, unless null, the float32 lse (b, heads, n); all contiguous on the
// current device, 16-byte aligned, n a multiple of 128, d 64, 128 or 512,
// 1 <= split <= 8.  Returns cudaGetLastError() after the launch.
int flash_attn_fwd_combine_bf16(const float* o_parts, const float* m, const float* l, void* o,
                                float* lse, int b, int heads, int n, int d, int split,
                                void* stream) {
  if (n % 128 != 0) return (int)cudaErrorInvalidValue;
  const Parts parts{const_cast<float*>(o_parts), const_cast<float*>(m), const_cast<float*>(l)};
  return (int)combine_bf16(parts, static_cast<bf16*>(o), lse, b, heads, n, d, split,
                           (cudaStream_t)stream);
}

}  // extern "C"
