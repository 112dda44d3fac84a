// K2 backward: flash attention's dK, dV and dQ, hand-written for Hopper (sm_90a).
//
// Replaces the backward of the Pallas TPU flash attention that
// ssl_tpu/ops/attention.py (sdp_attention, flash branch :32-39) differentiates
// through: upstream jax/experimental/pallas/ops/tpu/flash_attention.py (jax
// 0.9.0) _flash_attention_bwd_dkv :941 (kernel _flash_attention_dkv_kernel
// :796) and _flash_attention_bwd_dq :1287 (kernel _flash_attention_dq_kernel
// :1146).  Same contract as the plain PyTorch version,
// ssl_tpu_torch/ops/attention.py::flash_attn_bwd_reference: with the
// forward's per-row log-sum-exp lse and di = rowsum(o * dO), both (b, heads, n),
//     P  = exp(sm_scale q kᵀ - lse)      dP = dO vᵀ      dS = P * (dP - di)
//     dV = Pᵀ dO      dK = sm_scale dSᵀ q      dQ = sm_scale dS k
// over float32 (b, seq, heads, d) inputs read through their strides (unit
// stride along d, every stride and base 16-byte aligned), n and m multiples
// of 128; dq, dk and dv are written contiguous (b, seq, heads, d).
//
// What bounds it on this card: tensor-core operations.  The five products are
// 10·b·h·n·m·d operations against 4·b·h·(3nd + 3md + 2n) bytes, hundreds of
// operations per byte.  They run as 3xTF32 on the tensor cores: x = big +
// small with big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and
// each product is small·big + big·small + big·big into fp32 accumulators
// (what PyTorch's fp32 memory-efficient attention does through CUTLASS's
// OpMultiplyAddFastF32), fp32-class accuracy at up to 495/3 TFLOP/s.  The
// softmax recompute (exp, scale, subtract, multiply: ~8·bhnm) runs on the
// CUDA cores in fp32.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, not wgmma.
// wgmma takes tf32 operands only K-major from shared memory, but dV = Pᵀ dO,
// dK = dSᵀ q and dQ = dS k contract over the sequence, along which dO, q and
// k are not contiguous: they would need transposed staging copies.  mma.sync
// loads each thread's fragment itself, so one padded row-major tile serves
// both the logit products (contracting over d) and the accumulations
// (contracting over the sequence).  And the accumulator fragment of a 16x8
// logit tile is, with the contraction index permuted as (t, t+4) -> (2t,
// 2t+1), the A fragment of the next product: Pᵀ and dSᵀ (dS in dq) go from
// the softmax straight into the accumulation without touching shared memory.
// The permutation also makes the B fragments of the accumulations
// conflict-free: rows are padded to D + 4 floats (≡ 4 mod 8), so both
// g·(D+4) + t (contracting over d) and 2t·(D+4) + g (over the sequence) hit 32
// banks.
//
// Kernels (d = 64 and 128):
//   * flash_attn_bwd_dkv_kernel: one block per (b·head, tile of BN keys[,
//     split]); warp w owns keys 16·RW·w .. 16·RW·(w+1)-1 (RW row tiles of 16):
//     its K and V rows stay in shared memory, the Q, dO, lse and di tiles of
//     BM queries stream through a two-stage cp.async ring (16-byte
//     cp.async.cg copies, the next tile in flight while the current one is
//     computed).  Per tile the warp computes Sᵀ and dPᵀ (16·RW x BM), Pᵀ and
//     dSᵀ in registers, then dV += Pᵀ dO and dK += dSᵀ Q into 2·16·RW·D
//     accumulators;
//   * flash_attn_bwd_dq_kernel: one block per (b·head, tile of BQ queries[,
//     split]), warp w owning 16·RW queries; Q, dO, lse, di stay, K and V
//     tiles of BK keys stream; S, dP, dS in registers, dQ += dS K;
//   * what limits them is issue, not the tensor pipe: each 3xTF32 product
//     costs three mma.sync and, per operand element, two cvt.rna and a
//     subtraction.  So every B fragment is split once and used by all RW row
//     tiles of the warp, and the three passes of a product run over all of
//     the warp's tiles before the next pass (mma3_grid), so that no mma waits
//     on the one before it;
//   * tiles (BN, BM, RW of dkv; BQ, BK, RW of dq): d = 64: (128, 32, 2) and
//     (128, 32, 2), 4 warps and ~105 KB of shared memory each, two blocks per
//     SM; d = 128: (128, 32, 1) and (128, 32, 1), 8 warps and ~203 KB, one
//     block per SM.  227-255 registers a thread (ptxas);
//   * where a grid would fill under 90% of the SMs' block slots (unet_ds2,
//     struct_ds2: 1024 tokens), the wrapper splits the streamed loop into 2
//     or 4 parts: each part writes its partial dK/dV (or dQ) to scratch and
//     flash_attn_bwd_sum_kernel adds the parts in a fixed order.
// d = 512 (the VAE's single head) takes its own path: 2·16·512 accumulators
// do not fit a warp's registers beside the logits.  flash_attn_bwd_p_ds_kernel
// writes P and dS once to scratch (b·h·n·m floats each, 268 MB together at
// n = m = 4096, b = 2), tiles of 128 queries x 64 keys contracting d through a cp.async
// ring; then flash_attn_bwd_dkv_mm_kernel (dV = Pᵀ dO and dK = sm_scale dSᵀ q,
// one launch) and flash_attn_bwd_dq_mm_kernel (dQ = sm_scale dS k) are 128 x
// 128 tensor-core tiles over a three-stage ring.  That is 10·bhnmd of work,
// where recomputing the logits in both halves is 14, for ~0.8 GB of extra
// traffic (~0.25 ms at 3.35 TB/s).
// Accuracy: the gradients land ~3e-5 relative L2 from the plain fp32
// backward at 4096 keys and ~1e-5 at 1024 (PERF.md), growing with the length
// of the sums, inside the 1e-4 hold.
// Determinism: no atomics; every element of dQ, dK and dV (and of each split
// part) is summed by one thread in a fixed order, and the parts are added in
// order, so two launches on the same inputs give bit-identical outputs.
//
// bf16 (compute_dtype bfloat16; the *_bf16_kernel kernels, entry
// flash_attn_bwd_bf16): upstream's two Pallas backward kernels with bf16
// operands: P recomputed in fp32 from lse, dV = Pᵀ dO and dP = dO vᵀ on bf16
// operands, dS = P (dP - di) formed in fp32 and rounded to bf16 for
// dK = sm_scale dSᵀ q and dQ = sm_scale dS k, all sums in fp32 accumulators;
// dq, dk and dv written in bf16 (split parts in fp32, rounded by
// flash_attn_bwd_sum_bf16_kernel).
// At d = 64 and 128 the two kernels are built for Hopper (hopper_wgmma.cuh):
// wgmma.mma_async on the bf16 tiles as TMA lands them in 128-byte-swizzled
// shared memory, the logit products with both operands K-major along d, the
// accumulations with P or dS as the A operand from registers and the
// streamed or resident tile as an MN-major B (imm-trans-b, which 16-bit
// types allow and tf32 does not): no transposed copy.  One thread of a
// producer warpgroup keeps a ring of 3-4 stages full through mbarriers; two
// consumer warpgroups own 64 rows each.  What bounds them: the seven
// products at the bf16 rate (8bhnmd in dkv, 6bhnmd in dq) and, close behind,
// the softmax's exponentials: each kernel forms P once, bhnm exponentials at
// 16 a clock per SM, about half the products' time.  So at d = 64 the
// warpgroup's own K and V (dkv) or Q and dO (dq) stay in registers as the
// logit products' A operands (the products then read only the streamed tile
// from shared memory), and each tile's softmax goes in two halves of 32
// columns: the second half's P and dS are formed while the first half's
// accumulations run.  At d = 512 P and dS go to scratch in bf16 (half the
// float32 scratch), where the products that read them round them anyway.
// flash_attn_bwd_p_ds_bf16_kernel, which forms them, is built for Hopper as
// well (below): it is bound by its two logit products, but the plan it
// replaced (128 x 64 tiles on mma.sync, a cp.async ring) read q, dO, k and v
// 4·b·h·n·m·d·(1/128 + 1/64) bytes through L2 and sat near the L2's rate;
// 128 x 128 tiles on wgmma, in pairs of blocks that share q and dO by TMA
// multicast, read half of that.  dkv_mm and dq_mm, the plain products over
// the scratch, run wgmma too (below): 128 x 256 output tiles on a
// persistent grid, Pᵀ and dSᵀ read as stored through the A operand's
// transpose bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"   // the bf16 type, TMA, mbarrier rings, setmaxnreg, bf16 wgmma
#include "tf32_mma.cuh"      // 3xTF32 mma.sync products, cp.async tile copies

namespace {

// element strides per (batch, seq, head) of q, k, v and dO
struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh;
};

// ---- d = 64 and 128: the fused kernels ----------------------------------

template <int D, int BN, int BM>
constexpr size_t dkv_smem_floats() {
  return (size_t)2 * BN * (D + 4) + (size_t)2 * (2 * BM * (D + 4) + 2 * BM);
}

template <int D, int BQ, int BK>
constexpr size_t dq_smem_floats() {
  return (size_t)2 * BQ * (D + 4) + (size_t)2 * (2 * BK * (D + 4));
}

// Sᵀ or S (16·RW rows of the warp x NT·8 columns) and dPᵀ or dP over d:
// s += a_rows · b_colsᵀ and dp += c_rows · e_colsᵀ, where the warp's rows are
// rows 0 .. 16·RW-1 of a and c and the columns are rows of b and e (pitch
// D + 4); s[j][i] is column tile j of row tile i.
template <int D, int NT, int RW>
__device__ __forceinline__ void logits_and_dp(const float* a, const float* b, const float* c,
                                              const float* e, int g, int t,
                                              float (&s)[NT][RW][4], float (&dp)[NT][RW][4]) {
  constexpr int P = D + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][i][r] = dp[j][i][r] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    FragA fa[RW], fc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float* ar = a + (16 * i + g) * P + kk + t;
      const float* cr = c + (16 * i + g) * P + kk + t;
      fa[i].set(ar[0], ar[8 * P], ar[4], ar[8 * P + 4]);
      fc[i].set(cr[0], cr[8 * P], cr[4], cr[8 * P + 4]);
    }
    FragB fb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      fb[j].set(b[(8 * j + g) * P + kk + t], b[(8 * j + g) * P + kk + t + 4]);
    mma3_grid<NT, RW>(s, fa, fb);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      fb[j].set(e[(8 * j + g) * P + kk + t], e[(8 * j + g) * P + kk + t + 4]);
    mma3_grid<NT, RW>(dp, fc, fb);
  }
}

// Two adjacent output values, as float32 or rounded to bf16.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Store a 16·RW x D accumulator times scale into contiguous (b, seq, heads,
// D) rows: row tile i's rows are row0 + 16i + g and + 8 of the sequence, and
// element (r, col) of the (b·seq·heads, D) output is at out + (r·heads + hi)·D.
template <int D, int RW, typename OutT>
__device__ __forceinline__ void store_rows(OutT* out, const float (&acc)[D / 8][RW][4],
                                           long long row0, int heads, int hi, float scale,
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const long long r = row0 + 16 * i + g;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t;
      store2(out + (r * heads + hi) * D + col, acc[c][i][0] * scale, acc[c][i][1] * scale);
      store2(out + ((r + 8) * heads + hi) * D + col, acc[c][i][2] * scale, acc[c][i][3] * scale);
    }
  }
}

template <int D, int BN, int BM, int RW>
__global__ void __launch_bounds__(BN / RW * 2)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, Strides st, int b,
                          int heads, int n, int m, int tiles_per_split, float sm_scale) {
  constexpr int NTHREADS = BN / RW * 2, P = D + 4, NT = BM / 8;
  constexpr int STAGE = 2 * BM * P + 2 * BM;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;               // [BN][D + 4]
  float* s_v = s_k + BN * P;       // [BN][D + 4]
  float* ring = s_v + BN * P;      // 2 x {q [BM][D + 4], dO [BM][D + 4], lse [BM], di [BM]}

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int k0 = blockIdx.x * BN, split = blockIdx.z;
  const int tile0 = split * tiles_per_split;
  const float* qp = q + bi * st.qb + hi * st.qh;
  const float* gp = dout + bi * st.gb + hi * st.gh;
  const float* lp = lse + (long long)bh * n;
  const float* dip = di + (long long)bh * n;

  auto load_stage = [&](int stage, int tile) {
    float* s = ring + stage * STAGE;
    const long long q0 = (long long)tile * BM;
    load_tile_async<BM, D, P, NTHREADS>(s, qp + q0 * st.qn, st.qn, tid);
    load_tile_async<BM, D, P, NTHREADS>(s + BM * P, gp + q0 * st.gn, st.gn, tid);
    load_vec_async<BM, NTHREADS>(s + 2 * BM * P, lp + q0, tid);
    load_vec_async<BM, NTHREADS>(s + 2 * BM * P + BM, dip + q0, tid);
  };

  load_tile_async<BN, D, P, NTHREADS>(s_k, k + bi * st.kb + hi * st.kh + (long long)k0 * st.kn,
                                      st.kn, tid);
  load_tile_async<BN, D, P, NTHREADS>(s_v, v + bi * st.vb + hi * st.vh + (long long)k0 * st.vn,
                                      st.vn, tid);
  load_stage(0, tile0);
  cp_async_commit();

  float acc_k[D / 8][RW][4], acc_v[D / 8][RW][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_k[c][i][r] = acc_v[c][i][r] = 0.f;

  const float* my_k = s_k + 16 * RW * warp * P;     // the warp's keys: 16·RW rows
  const float* my_v = s_v + 16 * RW * warp * P;
  for (int it = 0; it < tiles_per_split; ++it) {
    if (it + 1 < tiles_per_split) load_stage((it + 1) & 1, tile0 + it + 1);
    cp_async_commit();
    cp_async_wait<1>();       // this tile (and K, V) have landed
    __syncthreads();
    const float* s_q = ring + (it & 1) * STAGE;
    const float* s_do = s_q + BM * P;
    const float* s_lse = s_do + BM * P;
    const float* s_di = s_lse + BM;

    float s[NT][RW][4], dp[NT][RW][4];   // Sᵀ, dPᵀ: rows = the warp's keys, columns = queries
    logits_and_dp<D, NT, RW>(my_k, s_q, my_v, s_do, g, t, s, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;     // this thread's query columns c and c + 1
      const float lse2[2] = {s_lse[c], s_lse[c + 1]}, di2[2] = {s_di[c], s_di[c + 1]};
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[j][i][r] = expf(s[j][i][r] * sm_scale - lse2[r % 2]);
          dp[j][i][r] = s[j][i][r] * (dp[j][i][r] - di2[r % 2]);
        }
    }
    accumulate<D, NT, RW>(acc_v, s, s_do, g, t);    // dV += Pᵀ dO
    accumulate<D, NT, RW>(acc_k, dp, s_q, g, t);    // dK += dSᵀ Q
    __syncthreads();          // every warp is done with this stage before it is refilled
  }

  const long long part = (long long)split * b * m * heads * D;
  const long long row0 = (long long)bi * m + k0 + 16 * RW * warp;
  store_rows<D, RW, float>(dk + part, acc_k, row0, heads, hi, sm_scale, g, t);
  store_rows<D, RW, float>(dv + part, acc_v, row0, heads, hi, 1.f, g, t);
}

template <int D, int BQ, int BK, int RW>
__global__ void __launch_bounds__(BQ / RW * 2)
flash_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, Strides st, int b, int heads, int n, int m,
                         int tiles_per_split, float sm_scale) {
  constexpr int NTHREADS = BQ / RW * 2, P = D + 4, NT = BK / 8;
  constexpr int STAGE = 2 * BK * P;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;               // [BQ][D + 4]
  float* s_do = s_q + BQ * P;      // [BQ][D + 4]
  float* ring = s_do + BQ * P;     // 2 x {k [BK][D + 4], v [BK][D + 4]}

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

  load_tile_async<BQ, D, P, NTHREADS>(s_q, q + bi * st.qb + hi * st.qh + (long long)q0 * st.qn,
                                      st.qn, tid);
  load_tile_async<BQ, D, P, NTHREADS>(
      s_do, dout + bi * st.gb + hi * st.gh + (long long)q0 * st.gn, st.gn, tid);
  load_stage(0, tile0);
  cp_async_commit();

  // the warp's rows: q0 + 16·RW·warp + 16i + g and + 8, row tile i < RW
  const int r0 = q0 + 16 * RW * warp;
  float row_lse[RW][2], row_di[RW][2], acc[D / 8][RW][4];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      row_lse[i][h8] = lse[(long long)bh * n + r0 + 16 * i + g + 8 * h8];
      row_di[i][h8] = di[(long long)bh * n + r0 + 16 * i + g + 8 * h8];
    }
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][i][r] = 0.f;

  const float* my_q = s_q + 16 * RW * warp * P;
  const float* my_do = s_do + 16 * RW * warp * P;
  for (int it = 0; it < tiles_per_split; ++it) {
    if (it + 1 < tiles_per_split) load_stage((it + 1) & 1, tile0 + it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* s_k = ring + (it & 1) * STAGE;
    const float* s_v = s_k + BK * P;

    float s[NT][RW][4], dp[NT][RW][4];   // S and dP: rows = the warp's queries, columns = keys
    logits_and_dp<D, NT, RW>(my_q, s_k, my_do, s_v, g, t, s, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dp[j][i][r] = expf(s[j][i][r] * sm_scale - row_lse[i][r / 2]) *
                        (dp[j][i][r] - row_di[i][r / 2]);
    accumulate<D, NT, RW>(acc, dp, s_k, g, t);      // dQ += dS K
    __syncthreads();
  }

  const long long part = (long long)split * b * n * heads * D;
  store_rows<D, RW, float>(dq + part, acc, (long long)bi * n + r0, heads, hi, sm_scale, g, t);
}

// out[i] = sum over s of parts[s·count + i], s = 0, 1, ... in order.
__global__ void flash_attn_bwd_sum_kernel(const float4* __restrict__ parts,
                                          float4* __restrict__ out, long long count4,
                                          int nparts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 a = parts[i];
    for (int s = 1; s < nparts; ++s) {
      const float4 x = parts[s * count4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    out[i] = a;
  }
}

// ---- d = 512: P and dS through scratch ----------------------------------

constexpr int PDS_BM = 128, PDS_BN = 64, PDS_KC = 32, PDS_P = PDS_KC + 4;
constexpr int PDS_STAGE = 2 * (PDS_BM + PDS_BN) * PDS_P;
constexpr int MM_BM = 128, MM_BN = 128, MM_KC = 32, MM_STAGES = 3;
constexpr int MM_PA = MM_KC + 4, MM_PT = MM_BM + 8;   // pitches: [i][k] and [k][i or j]
constexpr int MM_STAGE = MM_BM * MM_PA + MM_KC * MM_PT;

// P and dS of 128 queries x 64 keys: 8 warps, each 32 x 32 of S and dP,
// contracting d in chunks of 32 through a two-stage ring; written to
// p_out, ds_out as (b·heads, n, m).
template <int D>
__global__ void __launch_bounds__(256)
flash_attn_bwd_p_ds_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ di,
                           float* __restrict__ p_out, float* __restrict__ ds_out, Strides st,
                           int heads, int n, int m, float sm_scale) {
  constexpr int P = PDS_P, NCHUNK = D / PDS_KC;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = warp / 2, wc = warp % 2;
  const int bh = blockIdx.z, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.y * PDS_BM, k0 = blockIdx.x * PDS_BN;
  const float* qp = q + bi * st.qb + hi * st.qh + (long long)q0 * st.qn;
  const float* gp = dout + bi * st.gb + hi * st.gh + (long long)q0 * st.gn;
  const float* kp = k + bi * st.kb + hi * st.kh + (long long)k0 * st.kn;
  const float* vp = v + bi * st.vb + hi * st.vh + (long long)k0 * st.vn;

  auto load_stage = [&](int stage, int chunk) {
    float* s = smem + stage * PDS_STAGE;
    const int c0 = chunk * PDS_KC;
    load_tile_async<PDS_BM, PDS_KC, P, 256>(s, qp + c0, st.qn, tid);
    load_tile_async<PDS_BM, PDS_KC, P, 256>(s + PDS_BM * P, gp + c0, st.gn, tid);
    load_tile_async<PDS_BN, PDS_KC, P, 256>(s + 2 * PDS_BM * P, kp + c0, st.kn, tid);
    load_tile_async<PDS_BN, PDS_KC, P, 256>(s + (2 * PDS_BM + PDS_BN) * P, vp + c0, st.vn, tid);
  };

  float s[4][2][4], dp[4][2][4];   // [column tile j][row tile i]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][i][r] = dp[j][i][r] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < NCHUNK; ++it) {
    if (it + 1 < NCHUNK) load_stage((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* s_q = smem + (it & 1) * PDS_STAGE + wr * 32 * P;
    const float* s_do = s_q + PDS_BM * P;
    const float* s_k = smem + (it & 1) * PDS_STAGE + 2 * PDS_BM * P + wc * 32 * P;
    const float* s_v = s_k + PDS_BN * P;
#pragma unroll
    for (int kk = 0; kk < PDS_KC; kk += 8) {
      FragA fq[2], fg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = s_q + (16 * i + g) * P + kk + t;
        const float* c = s_do + (16 * i + g) * P + kk + t;
        fq[i].set(a[0], a[8 * P], a[4], a[8 * P + 4]);
        fg[i].set(c[0], c[8 * P], c[4], c[8 * P + 4]);
      }
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fb[j].set(s_k[(8 * j + g) * P + kk + t], s_k[(8 * j + g) * P + kk + t + 4]);
      mma3_grid<4, 2>(s, fq, fb);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fb[j].set(s_v[(8 * j + g) * P + kk + t], s_v[(8 * j + g) * P + kk + t + 4]);
      mma3_grid<4, 2>(dp, fg, fb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int row = q0 + wr * 32 + 16 * i + g + 8 * h8;
      const float l = lse[(long long)bh * n + row], d = di[(long long)bh * n + row];
      const long long base = ((long long)bh * n + row) * m + k0 + wc * 32 + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = expf(s[j][i][2 * h8] * sm_scale - l);
        const float p1 = expf(s[j][i][2 * h8 + 1] * sm_scale - l);
        *reinterpret_cast<float2*>(p_out + base + 8 * j) = make_float2(p0, p1);
        *reinterpret_cast<float2*>(ds_out + base + 8 * j) =
            make_float2(p0 * (dp[j][i][2 * h8] - d), p1 * (dp[j][i][2 * h8 + 1] - d));
      }
    }
  }
}

// out (rows, D) = alpha A B over k < kdim, one 128 x 128 tile per block: 8
// warps of 64 x 32, a three-stage ring of 32-deep chunks.  A(i, kk) is
// a[i·lda + kk] when A_KCONTIG, else a[kk·lda + i]; B(kk, j) is b[kk·ldb + j];
// out(i, j) is out[i·ostride + j].
template <bool A_KCONTIG>
__device__ __forceinline__ void mm_tile(const float* __restrict__ a, long long lda,
                                        const float* __restrict__ b, long long ldb,
                                        float* __restrict__ out, long long ostride, int kdim,
                                        float alpha) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = warp / 4, wc = warp % 4;
  const int i0 = blockIdx.y * MM_BM, j0 = blockIdx.x * MM_BN;
  const int nchunk = kdim / MM_KC;

  auto load_stage = [&](int stage, int chunk) {
    float* s = smem + stage * MM_STAGE;
    const long long c0 = (long long)chunk * MM_KC;
    if (A_KCONTIG)
      load_tile_async<MM_BM, MM_KC, MM_PA, 256>(s, a + i0 * lda + c0, lda, tid);
    else
      load_tile_async<MM_KC, MM_BM, MM_PT, 256>(s, a + c0 * lda + i0, lda, tid);
    load_tile_async<MM_KC, MM_BN, MM_PT, 256>(s + MM_BM * MM_PA, b + c0 * ldb + j0, ldb, tid);
  };

  float acc[4][4][4];   // [column tile j][row tile i]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][i][r] = 0.f;

#pragma unroll
  for (int c = 0; c < MM_STAGES - 1; ++c) {
    if (c < nchunk) load_stage(c, c);
    cp_async_commit();
  }
  for (int it = 0; it < nchunk; ++it) {
    if (it + MM_STAGES - 1 < nchunk) load_stage((it + MM_STAGES - 1) % MM_STAGES,
                                                it + MM_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MM_STAGES - 1>();
    __syncthreads();
    const float* s_a = smem + (it % MM_STAGES) * MM_STAGE;
    const float* s_b = s_a + MM_BM * MM_PA + wc * 32;
#pragma unroll
    for (int kk = 0; kk < MM_KC; kk += 8) {
      FragA fa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr * 64 + 16 * i + g;
        if (A_KCONTIG) {
          const float* x = s_a + r * MM_PA + kk + t;
          fa[i].set(x[0], x[8 * MM_PA], x[4], x[8 * MM_PA + 4]);
        } else {
          const float* x = s_a + (kk + t) * MM_PT + r;
          fa[i].set(x[0], x[8], x[4 * MM_PT], x[4 * MM_PT + 8]);
        }
      }
      FragB fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fb[j].set(s_b[(kk + t) * MM_PT + 8 * j + g], s_b[(kk + t + 4) * MM_PT + 8 * j + g]);
      mma3_grid<4, 4>(acc, fa, fb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = i0 + wr * 64 + 16 * i + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + wc * 32 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(out + r * ostride + col) =
          make_float2(acc[j][i][0] * alpha, acc[j][i][1] * alpha);
      *reinterpret_cast<float2*>(out + (r + 8) * ostride + col) =
          make_float2(acc[j][i][2] * alpha, acc[j][i][3] * alpha);
    }
  }
}

// dV = Pᵀ dO (blockIdx.z even) and dK = sm_scale dSᵀ q (odd) for b·head z / 2.
template <int D>
__global__ void __launch_bounds__(256)
flash_attn_bwd_dkv_mm_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                             const float* __restrict__ p, const float* __restrict__ ds,
                             float* __restrict__ dk, float* __restrict__ dv, Strides st,
                             int heads, int n, int m, float sm_scale) {
  const int bh = blockIdx.z / 2, bi = bh / heads, hi = bh % heads;
  const long long out = ((long long)bi * m * heads + hi) * D;
  if (blockIdx.z % 2 == 0)
    mm_tile<false>(p + (long long)bh * n * m, m, dout + bi * st.gb + hi * st.gh, st.gn,
                   dv + out, (long long)heads * D, n, 1.f);
  else
    mm_tile<false>(ds + (long long)bh * n * m, m, q + bi * st.qb + hi * st.qh, st.qn,
                   dk + out, (long long)heads * D, n, sm_scale);
}

// dQ = sm_scale dS k for b·head blockIdx.z.
template <int D>
__global__ void __launch_bounds__(256)
flash_attn_bwd_dq_mm_kernel(const float* __restrict__ k, const float* __restrict__ ds,
                            float* __restrict__ dq, Strides st, int heads, int n, int m,
                            float sm_scale) {
  const int bh = blockIdx.z, bi = bh / heads, hi = bh % heads;
  mm_tile<true>(ds + (long long)bh * n * m, m, k + bi * st.kb + hi * st.kh, st.kn,
                dq + ((long long)bi * n * heads + hi) * D, (long long)heads * D, m, sm_scale);
}

// ---- bf16, d = 64 and 128: the fused kernels ----------------------------
//
// Warp-specialised for Hopper (hopper_wgmma.cuh): 384 threads, two consumer
// warpgroups (threads 0-255) and a producer warpgroup (256-383) of which one
// thread issues every copy.  The producer gives its registers to the
// consumers (setmaxnreg 24 / 240).  The block's resident rows come in once
// by TMA; the streamed tiles of BF16_TILE rows (and, in dkv, their lse and di)
// run through a ring of STAGES buffers: a "full" mbarrier a stage (the
// producer's arrival and the copies' bytes) and an "empty" one (every
// consumer thread's arrival once its products have read the stage).  Each
// consumer warpgroup owns 64 of the block's 128 rows.  Per tile it computes
// the two logit products (m64n64k16, K-major along d as stored; at d = 64
// with the warpgroup's resident rows as A operands from registers), forms P
// and dS in fp32 registers, and accumulates with the rounded P or dS as
// wgmma's A operand from registers and the streamed or resident tile as an
// MN-major B (imm-trans-b = 1): no transposed copy.  The softmax goes in two
// halves of 32 columns, so that the second half's exponentials run beside
// the first half's accumulations.  Outputs are bf16, or the fp32 parts of a
// split.

constexpr int BF16_BLOCK = 128, BF16_TILE = 64, BF16_THREADS = 384;
constexpr int BF16_STAGES_D64 = 4, BF16_STAGES_D128 = 3;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory (bytes) of the two kernels at head width D with STAGES ring
// stages: 1024 of alignment slack, the resident [128][D] operands (K and V,
// or Q and dO), the stages' [64][D] operands, dkv's lse and di a stage, and
// the barriers (full and empty a stage, one for the resident rows).
template <int D, int STAGES>
constexpr int dkv_bf16_smem_bytes() {
  return 1024 + 2 * BF16_BLOCK * D * 2 + STAGES * 2 * BF16_TILE * D * 2 +
         STAGES * 2 * BF16_TILE * 4 + (2 * STAGES + 1) * 8;
}

template <int D, int STAGES>
constexpr int dq_bf16_smem_bytes() {
  return 1024 + 2 * BF16_BLOCK * D * 2 + STAGES * 2 * BF16_TILE * D * 2 + (2 * STAGES + 1) * 8;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// s (64 x 64) = rows 0..63 of a · rows 0..63 of bᵀ over D: a and b are
// [rows][D] tiles as D / 64 column blocks of a_rows (b_rows) rows.  The descriptors are rebuilt from one
// opaque base each per call, so that the compiler holds two registers for
// them, not two a k-step.
template <int D>
__device__ __forceinline__ void logits_wg(float (&s)[32], const bf16* a, int a_rows,
                                          const bf16* b, int b_rows) {
  uint64_t da = desc_sw128(a, 16, 1024), db = desc_sw128(b, 16, 1024);
  opaque(da);
  opaque(db);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;     // column block, bytes into the row
    wgmma_ss(s, da + ((c * a_rows * 128 + off) >> 4), db + ((c * b_rows * 128 + off) >> 4),
             kk > 0);
  }
}

// The same with a's rows as the A operands of D / 16 k-steps in registers
// (``load_a_rows``).
template <int D>
__device__ __forceinline__ void logits_wg(float (&s)[32], const uint32_t (&a)[D / 16][4],
                                          const bf16* b, int b_rows) {
  uint64_t db = desc_sw128(b, 16, 1024);
  opaque(db);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs<0>(s, a[kk], db + (((kk / 4) * b_rows * 128 + (kk % 4) * 32) >> 4), kk > 0);
}

// acc (64 x D) += x · y over the 32 contraction rows of half h: x holds the
// A operands of its two k-steps, y's rows 32h .. 32h + 31 of a [64][D] tile
// (D / 64 column blocks of 64 rows) are read MN-major.
template <int D>
__device__ __forceinline__ void accumulate_half(float (&acc)[D / 64][32], uint32_t (&x)[2][4],
                                                const bf16* y, int h) {
  uint64_t dy = desc_sw128(y + 32 * h * 64, BF16_TILE * 128, 1024);
  opaque(dy);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wgmma_rs<1>(acc[c], x[kk], dy + ((c * BF16_TILE * 128 + kk * 16 * 128) >> 4), 1);
}

// Columns 32h .. 32h + 31 of a 64 x 64 accumulator (d[4j + r], column 8j +
// 2t + r % 2): its entries 16h .. 16h + 15.
__device__ __forceinline__ float (&half_cols(float (&d)[32], int h))[16] {
  return *reinterpret_cast<float(*)[16]>(d + 16 * h);
}

// Pᵀ = exp(sm_scale·Sᵀ - lse) and dSᵀ = Pᵀ (dPᵀ - di) in place over 32 query
// columns of the dkv kernel's accumulators (this thread's columns 8j + 2t
// and + 1, j < 4, of the given lse and di).
__device__ __forceinline__ void p_and_ds_cols(float (&st)[16], float (&dpt)[16],
                                              const float* s_lse, const float* s_di,
                                              float scale_log2, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * t);
    const float2 dd = *reinterpret_cast<const float2*>(s_di + 8 * j + 2 * t);
    const float l2[2] = {l.x * LOG2E, l.y * LOG2E}, d2[2] = {dd.x, dd.y};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p = ex2(fmaf(st[4 * j + r], scale_log2, -l2[r % 2]));
      st[4 * j + r] = p;
      dpt[4 * j + r] = p * (dpt[4 * j + r] - d2[r % 2]);
    }
  }
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) fence_regs(acc[c]);
}

// Store a warpgroup's 64 x D accumulator times scale into contiguous (b, seq,
// heads, D) rows: this thread's rows are row and row + 8 of the flattened
// (b·seq) index, its columns 64c + 8j + 2t and + 1.
template <int D, typename OutT>
__device__ __forceinline__ void store_wg(OutT* out, const float (&acc)[D / 64][32],
                                         long long row, int heads, int hi, float scale, int t) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t;
      store2(out + (row * heads + hi) * D + col, acc[c][4 * j] * scale,
             acc[c][4 * j + 1] * scale);
      store2(out + ((row + 8) * heads + hi) * D + col, acc[c][4 * j + 2] * scale,
             acc[c][4 * j + 3] * scale);
    }
}

// One block per (b·head, 128 keys[, split]): K and V resident, Q, dO, lse and
// di tiles of 64 queries streamed.  Consumer warpgroup w owns keys 64w..64w+63:
// Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, Pᵀ and dSᵀ in registers, dV += Pᵀ dO, dK += dSᵀ Q.
template <int D, int STAGES, typename OutT>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_attn_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ di,
                               OutT* __restrict__ dk, OutT* __restrict__ dv, int b, int heads,
                               int n, int m, int tiles_per_split, float sm_scale) {
  constexpr int BN = BF16_BLOCK, BM = BF16_TILE, CB = D / 64;
  constexpr int KV_BYTES = BN * D * 2, TILE_BYTES = BM * D * 2;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* base = align1024(smem_tma);
  bf16* s_k = reinterpret_cast<bf16*>(base);                  // CB blocks of [BN][64]
  bf16* s_v = reinterpret_cast<bf16*>(base + KV_BYTES);
  unsigned char* ring = base + 2 * KV_BYTES;                   // STAGES x {q, dO}
  float* s_vec = reinterpret_cast<float*>(ring + STAGES * 2 * TILE_BYTES);  // STAGES x {lse, di}
  uint64_t* full = reinterpret_cast<uint64_t*>(s_vec + STAGES * 2 * BM);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int k0 = blockIdx.x * BN, split = blockIdx.z, tile0 = split * tiles_per_split;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {   // the producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_arrive_expect_tx(kv_bar, 2 * KV_BYTES);
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int r = 0; r < BN / 64; ++r) {
          tma_load_4d(s_k + (c * BN + 64 * r) * 64, &tm_k, kv_bar, 64 * c, hi, k0 + 64 * r, bi);
          tma_load_4d(s_v + (c * BN + 64 * r) * 64, &tm_v, kv_bar, 64 * c, hi, k0 + 64 * r, bi);
        }
      const float* lp = lse + (long long)bh * n;
      const float* dp = di + (long long)bh * n;
      for (int it = 0; it < tiles_per_split; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES + 2 * BM * 4);
        bf16* sq = reinterpret_cast<bf16*>(ring + s * 2 * TILE_BYTES);
        bf16* sdo = sq + BM * D;
        const int q0 = (tile0 + it) * BM;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(sq + c * BM * 64, &tm_q, &full[s], 64 * c, hi, q0, bi);
          tma_load_4d(sdo + c * BM * 64, &tm_do, &full[s], 64 * c, hi, q0, bi);
        }
        bulk_load(s_vec + s * 2 * BM, lp + q0, BM * 4, &full[s]);
        bulk_load(s_vec + s * 2 * BM + BM, dp + q0, BM * 4, &full[s]);
      }
    }
  } else {   // the consumer warpgroups
    setmaxnreg_inc<240>();
    const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float scale_log2 = sm_scale * LOG2E;
    float acc_k[CB][32], acc_v[CB][32];
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;
    const bf16* my_k = s_k + 64 * wg * 64;     // this warpgroup's keys in column block 0
    const bf16* my_v = s_v + 64 * wg * 64;
    mbar_wait(kv_bar, 0);
    __syncwarp();
    // At d = 64 the warpgroup's K and V rows stay in registers as the logit
    // products' A operands (32 registers), so that those products read only
    // Q and dO from shared memory; at d = 128 they are read from there.
    constexpr bool A_REGS = D == 64;
    uint32_t k_frag[A_REGS ? D / 16 : 1][4], v_frag[A_REGS ? D / 16 : 1][4];
    if constexpr (A_REGS) {
      load_a_rows<D>(k_frag, s_k, BN, 64 * wg, wq, lane);
      load_a_rows<D>(v_frag, s_v, BN, 64 * wg, wq, lane);
    }
    for (int it = 0; it < tiles_per_split; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      __syncwarp();
      const bf16* sq = reinterpret_cast<const bf16*>(ring + s * 2 * TILE_BYTES);
      const bf16* sdo = sq + BM * D;
      const float* s_lse = s_vec + s * 2 * BM;
      const float* s_di = s_lse + BM;

      // Sᵀ and dPᵀ (rows = the warpgroup's keys, columns = queries) as
      // m64n64k16 products in one group; then per half of 32 queries: form Pᵀ
      // and dSᵀ and issue its share of dV and dK, so that half 1's softmax
      // runs beside half 0's products.
      float st[32], dpt[32];
      uint32_t ap[2][2][4], as[2][2][4];   // per half, its two k-steps
      fence_regs(st);
      fence_regs(dpt);
      if constexpr (A_REGS) {
        fence_regs(k_frag);
        fence_regs(v_frag);
      }
      wgmma_fence();
      if constexpr (A_REGS) {
        logits_wg<D>(st, k_frag, sq, BM);
        logits_wg<D>(dpt, v_frag, sdo, BM);
      } else {
        logits_wg<D>(st, my_k, BN, sq, BM);
        logits_wg<D>(dpt, my_v, BN, sdo, BM);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (A_REGS) {
        fence_regs(k_frag);
        fence_regs(v_frag);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&sh)[16] = half_cols(st, h), (&dh)[16] = half_cols(dpt, h);
        fence_regs(sh);
        fence_regs(dh);
        p_and_ds_cols(sh, dh, s_lse + 32 * h, s_di + 32 * h, scale_log2, t);
        pack_a_wg(ap[h], sh);
        pack_a_wg(as[h], dh);
        fence_regs(ap[h]);
        fence_regs(as[h]);
        if (h == 0) {       // (half 1 accumulates into them while half 0's products run)
          fence_acc<D>(acc_v);
          fence_acc<D>(acc_k);
        }
        wgmma_fence();
        accumulate_half<D>(acc_v, ap[h], sdo, h);    // dV += Pᵀ dO
        accumulate_half<D>(acc_k, as[h], sq, h);     // dK += dSᵀ Q
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fence_regs(ap[h]);
        fence_regs(as[h]);
      }
      fence_acc<D>(acc_v);
      fence_acc<D>(acc_k);
      mbar_arrive(&empty[s]);
    }

    const long long part = (long long)split * b * m * heads * D;
    const long long row = (long long)bi * m + k0 + 64 * wg + 16 * wq + g;
    store_wg<D, OutT>(dk + part, acc_k, row, heads, hi, sm_scale, t);
    store_wg<D, OutT>(dv + part, acc_v, row, heads, hi, 1.f, t);
  }
}

// One block per (b·head, 128 queries[, split]): Q and dO resident, K and V
// tiles of 64 keys streamed.  Consumer warpgroup w owns queries 64w..64w+63:
// S = Q Kᵀ and dP = dO Vᵀ, dS in registers, dQ += dS K.
template <int D, int STAGES, typename OutT>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_attn_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ di,
                              OutT* __restrict__ dq, int b, int heads, int n, int m,
                              int tiles_per_split, float sm_scale) {
  constexpr int BQ = BF16_BLOCK, BK = BF16_TILE, CB = D / 64;
  constexpr int QD_BYTES = BQ * D * 2, TILE_BYTES = BK * D * 2;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* base = align1024(smem_tma);
  bf16* s_q = reinterpret_cast<bf16*>(base);                  // CB blocks of [BQ][64]
  bf16* s_do = reinterpret_cast<bf16*>(base + QD_BYTES);
  unsigned char* ring = base + 2 * QD_BYTES;                   // STAGES x {k, v}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qd_bar = empty + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * BQ, split = blockIdx.z, tile0 = split * tiles_per_split;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(qd_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {   // the producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_arrive_expect_tx(qd_bar, 2 * QD_BYTES);
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int r = 0; r < BQ / 64; ++r) {
          tma_load_4d(s_q + (c * BQ + 64 * r) * 64, &tm_q, qd_bar, 64 * c, hi, q0 + 64 * r, bi);
          tma_load_4d(s_do + (c * BQ + 64 * r) * 64, &tm_do, qd_bar, 64 * c, hi, q0 + 64 * r,
                      bi);
        }
      for (int it = 0; it < tiles_per_split; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        bf16* sk = reinterpret_cast<bf16*>(ring + s * 2 * TILE_BYTES);
        bf16* sv = sk + BK * D;
        const int k0 = (tile0 + it) * BK;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(sk + c * BK * 64, &tm_k, &full[s], 64 * c, hi, k0, bi);
          tma_load_4d(sv + c * BK * 64, &tm_v, &full[s], 64 * c, hi, k0, bi);
        }
      }
    }
  } else {   // the consumer warpgroups
    setmaxnreg_inc<240>();
    const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float scale_log2 = sm_scale * LOG2E;
    // this thread's rows: r0 and r0 + 8
    const int r0 = q0 + 64 * wg + 16 * wq + g;
    const float l2[2] = {lse[(long long)bh * n + r0] * LOG2E,
                         lse[(long long)bh * n + r0 + 8] * LOG2E};
    const float d2[2] = {di[(long long)bh * n + r0], di[(long long)bh * n + r0 + 8]};
    float acc[CB][32];
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    const bf16* my_q = s_q + 64 * wg * 64;     // this warpgroup's queries in column block 0
    const bf16* my_do = s_do + 64 * wg * 64;
    mbar_wait(qd_bar, 0);
    __syncwarp();
    // At d = 64 the warpgroup's Q and dO rows stay in registers as the logit
    // products' A operands (32 registers), so that those products read only
    // K and V from shared memory.
    constexpr bool A_REGS = D == 64;
    uint32_t q_frag[A_REGS ? D / 16 : 1][4], do_frag[A_REGS ? D / 16 : 1][4];
    if constexpr (A_REGS) {
      load_a_rows<D>(q_frag, s_q, BQ, 64 * wg, wq, lane);
      load_a_rows<D>(do_frag, s_do, BQ, 64 * wg, wq, lane);
    }
    for (int it = 0; it < tiles_per_split; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      __syncwarp();
      const bf16* sk = reinterpret_cast<const bf16*>(ring + s * 2 * TILE_BYTES);
      const bf16* sv = sk + BK * D;
      // S and dP (rows = the warpgroup's queries, columns = keys) as
      // m64n64k16 products in one group; then per half of 32 keys: form dS
      // and issue its share of dQ, as in the dkv kernel.
      float st[32], dpt[32];
      uint32_t as[2][2][4];   // per half, its two k-steps
      fence_regs(st);
      fence_regs(dpt);
      if constexpr (A_REGS) {
        fence_regs(q_frag);
        fence_regs(do_frag);
      }
      wgmma_fence();
      if constexpr (A_REGS) {
        logits_wg<D>(st, q_frag, sk, BK);
        logits_wg<D>(dpt, do_frag, sv, BK);
      } else {
        logits_wg<D>(st, my_q, BQ, sk, BK);
        logits_wg<D>(dpt, my_do, BQ, sv, BK);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&sh)[16] = half_cols(st, h), (&dh)[16] = half_cols(dpt, h);
        fence_regs(sh);
        fence_regs(dh);
#pragma unroll
        for (int i = 0; i < 16; ++i)     // dS; rows r0 (i % 4 < 2) and r0 + 8
          dh[i] = ex2(fmaf(sh[i], scale_log2, -l2[(i % 4) / 2])) * (dh[i] - d2[(i % 4) / 2]);
        pack_a_wg(as[h], dh);
        fence_regs(as[h]);
        if (h == 0) fence_acc<D>(acc);
        wgmma_fence();
        accumulate_half<D>(acc, as[h], sk, h);     // dQ += dS K
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) fence_regs(as[h]);
      fence_acc<D>(acc);
      if constexpr (A_REGS) {
        fence_regs(q_frag);
        fence_regs(do_frag);
      }
      mbar_arrive(&empty[s]);
    }

    const long long part = (long long)split * b * n * heads * D;
    store_wg<D, OutT>(dq + part, acc, (long long)bi * n + r0, heads, hi, sm_scale, t);
  }
}

// out[i] = sum over s of parts[s·count + i], s = 0, 1, ... in order, rounded to bf16.
__global__ void flash_attn_bwd_sum_bf16_kernel(const float4* __restrict__ parts,
                                               bf16* __restrict__ out, long long count4,
                                               int nparts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 a = parts[i];
    for (int s = 1; s < nparts; ++s) {
      const float4 x = parts[s * count4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    store2(out + 4 * i, a.x, a.y);
    store2(out + 4 * i + 2, a.z, a.w);
  }
}

// ---- bf16, d = 512: P and dS on wgmma, tiles multicast across a cluster --
//
// flash_attn_bwd_p_ds_bf16_kernel: tiles of 128 queries x 128 keys of one
// b·head, in blocks of 384 threads: a producer warpgroup (threads 256-383;
// setmaxnreg 40 / 232) and two consumer warpgroups of 64 query rows.  Each
// consumer runs S = q kᵀ and dP = dO vᵀ as m64n128k16 products, both operands
// K-major along d as stored (64 + 64 accumulators a thread), over a ring of
// PD_STAGES stages of 64-column chunks of d: a stage holds the chunk of the
// tile's 128 rows of q, dO, k and v (four TMA boxes of 128 x 64, 64 KB).
// Then P = exp(sm_scale·S - lse) and dS = P (dP - di) in fp32, rounded to
// bf16, each staged through shared memory and written as 16-byte pieces
// along the rows of the (b·h, n, m) scratch, which dkv_mm and dq_mm read.
// What bounds it: the two products, 4·b·h·n·m·d operations (~70 µs at b = 2
// and 4096 tokens at the bf16 rate), and the bytes of q, dO, k and v that
// each tile reads, 4·b·h·n·m·d·(1/BQ + 1/BK) through L2 (1.07 GB at b = 2;
// the plan it replaced, 128 x 64 tiles on mma.sync, read 1.61 GB and sat near
// the L2's rate).  Blocks go in pairs along the keys (where the key tiles come
// in pairs) that take tiles together: the two blocks of a query tile share
// its q and dO chunks, one loading q and the other dO, each with multicast
// to both, which cuts the L2 traffic by a quarter; a stage is refilled once
// both blocks have read it.  (Clusters of 2 x 2, sharing k and v across
// query tiles too, halve it, but the card holds 30 such clusters at once,
// 120 of its 132 SMs: no faster, PERF.md.)  The grid is persistent (as many
// pairs as the card holds at once, each walking the pairs of tiles in turn),
// so that the next tile's chunks load while this tile's P and dS are formed
// and stored.

constexpr int PD_BQ = 128, PD_BK = 128, PD_THREADS = 384, PD_STAGES = 3;
constexpr int PD_BOX = 128 * 64 * 2;           // bytes of one 128-row, 64-column box
constexpr int PD_OUT = PD_BQ * PD_BK * 2;      // bytes of a staged P or dS tile

// Shared memory (bytes): 1024 of alignment slack, the ring (q, dO, k and v
// boxes a stage), the staged output tile and the ring's barriers (full and
// empty a stage).
constexpr int p_ds_bf16_smem_bytes() {
  return 1024 + PD_STAGES * 4 * PD_BOX + PD_OUT + 2 * PD_STAGES * 8;
}

// Blocks a cluster at m keys (a multiple of 128): 2 where the 128-key tiles
// come in pairs, else 1.
inline int p_ds_cluster(int m) { return (m / PD_BK) % 2 == 0 ? 2 : 1; }

// Stores the 128 x 128 tile ``x`` (a consumer thread's 64 accumulators of
// its warpgroup's rows, rounded to bf16) to rows q0 .. of ``out`` (an n x m
// matrix), keys k0 ..: through ``stage`` ([128][128] bf16, 16-byte chunk c
// of row r at chunk c ^ (r % 8)), then 16-byte pieces along the rows.
__device__ __forceinline__ void store_tile(const float (&x)[64], unsigned char* stage,
                                           bf16* __restrict__ out, long long m, int q0, int k0,
                                           int wg, int wq, int g, int t, int tid) {
  bar_sync(1, 256);   // the stage's last reader is done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + 16 * wq + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(stage + row * 256 + ((j ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16x2(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
  }
  bar_sync(1, 256);
  for (int e = tid; e < PD_BQ * PD_BK / 8; e += 256) {
    const int r = e / (PD_BK / 8), c = e % (PD_BK / 8);
    *reinterpret_cast<uint4*>(out + (q0 + r) * m + k0 + 8 * c) =
        *reinterpret_cast<const uint4*>(stage + r * 256 + ((c ^ (r & 7)) << 4));
  }
}

template <int D>
__global__ void __launch_bounds__(PD_THREADS, 1)
flash_attn_bwd_p_ds_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse, const float* __restrict__ di,
                                bf16* __restrict__ p_out, bf16* __restrict__ ds_out, int heads,
                                int n, int m, float sm_scale, int cluster, int tiles) {
  constexpr int NCHUNK = D / 64, STAGE = 4 * PD_BOX;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* ring = align1024(smem_tma);   // PD_STAGES x {q, dO, k, v}
  unsigned char* stage_out = ring + PD_STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + PD_OUT);
  uint64_t* empty = full + PD_STAGES;

  // The cluster tiles (``cluster`` key tiles of one query tile and b·head)
  // in turn: this block's cluster takes cluster tiles cl, cl + clusters, ...;
  // in each, this block (rank x) takes key tile kt·cluster + x.
  const int tid = threadIdx.x, x = blockIdx.x % cluster;
  const int cl = blockIdx.x / cluster, clusters = gridDim.x / cluster;
  const int kts = m / (PD_BK * cluster), qts = n / PD_BQ;
  auto tile_of = [&](int w, int& bh, int& q0, int& k0) {
    k0 = ((w % kts) * cluster + x) * PD_BK;
    q0 = (w / kts % qts) * PD_BQ;
    bh = w / (kts * qts);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < PD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * cluster);   // every consumer warp of the cluster
    }
    mbar_init_fence();
  }
  cluster_sync();   // every block's barriers exist before a load or arrival reaches them

  if (tid >= 256) {   // the producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 256) {
      // q and dO are shared by the cluster: block 0 loads q, the last dO
      const uint16_t all = (uint16_t)((1u << cluster) - 1);
      int u = 0;   // chunks loaded so far
      for (int w = cl; w < tiles; w += clusters) {
        int bh, q0, k0;
        tile_of(w, bh, q0, k0);
        const int bi = bh / heads, hi = bh % heads;
        for (int c = 0; c < NCHUNK; ++c, ++u) {
          const int s = u % PD_STAGES;
          if (u >= PD_STAGES) mbar_wait(&empty[s], (u / PD_STAGES - 1) & 1);
          mbar_arrive_expect_tx(&full[s], STAGE);
          unsigned char* st = ring + s * STAGE;
          if (x == 0) tma_load_4d_multicast(st, &tm_q, &full[s], 64 * c, hi, q0, bi, all);
          if (x == cluster - 1)
            tma_load_4d_multicast(st + PD_BOX, &tm_do, &full[s], 64 * c, hi, q0, bi, all);
          tma_load_4d(st + 2 * PD_BOX, &tm_k, &full[s], 64 * c, hi, k0, bi);
          tma_load_4d(st + 3 * PD_BOX, &tm_v, &full[s], 64 * c, hi, k0, bi);
        }
      }
    }
  } else {   // the consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float scale_log2 = sm_scale * LOG2E;
    // a consumer warp's arrival on a stage's empty barrier in every block (lane r on block r's)
    auto release = [&](int s) {
      __syncwarp();
      if (lane < cluster) mbar_arrive_cluster(&empty[s], lane);
    };
    int u = 0;   // chunks consumed so far
    for (int w = cl; w < tiles; w += clusters) {
      int bh, q0, k0;
      tile_of(w, bh, q0, k0);
      float s[64], dp[64];
      for (int c = 0; c < NCHUNK; ++c, ++u) {
        mbar_wait(&full[u % PD_STAGES], (u / PD_STAGES) & 1);
        __syncwarp();
        const unsigned char* st = ring + (u % PD_STAGES) * STAGE;
        // q and dO: this warpgroup's 64 rows (1024-byte aligned); k and v: all 128
        uint64_t dq = desc_sw128(st + 64 * wg * 128, 16, 1024);
        uint64_t dg = desc_sw128(st + PD_BOX + 64 * wg * 128, 16, 1024);
        uint64_t dk = desc_sw128(st + 2 * PD_BOX, 16, 1024);
        uint64_t dv = desc_sw128(st + 3 * PD_BOX, 16, 1024);
        opaque(dq);
        opaque(dg);
        opaque(dk);
        opaque(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // k-step kk starts 32 bytes into the rows
          wgmma_ss_n128<0>(s, dq + 2 * kk, dk + 2 * kk, c > 0 || kk > 0);
          wgmma_ss_n128<0>(dp, dg + 2 * kk, dv + 2 * kk, c > 0 || kk > 0);
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release((u - 1) % PD_STAGES);   // chunk c - 1 is read
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release((u - 1) % PD_STAGES);

      // P and dS in place (entry 4j + r of an accumulator: row 16wq + g +
      // 8·(r / 2) of the warpgroup's, key 8j + 2t + r % 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long at = (long long)bh * n + q0 + 64 * wg + 16 * wq + g + 8 * h;
        const float l2 = lse[at] * LOG2E, dd = di[at];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            s[i] = ex2(fmaf(s[i], scale_log2, -l2));
            dp[i] = s[i] * (dp[i] - dd);
          }
      }
      const long long mat = (long long)bh * n * m;
      store_tile(s, stage_out, p_out + mat, m, q0, k0, wg, wq, g, t, tid);
      store_tile(dp, stage_out, ds_out + mat, m, q0, k0, wg, wq, g, t, tid);
    }
  }
  cluster_sync();   // no block leaves while another may still arrive on its barriers
}

// ---- bf16, d = 512: dK, dV and dQ from P and dS on wgmma -----------------
//
// flash_attn_bwd_dkv_mm_bf16_kernel (dV = Pᵀ dO and dK = sm_scale dSᵀ q, one
// launch) and flash_attn_bwd_dq_mm_bf16_kernel (dQ = sm_scale dS k): plain
// batched products over the bf16 [P | dS] scratch that p_ds writes, in
// output tiles of 128 rows (keys, or queries in dq) x 256 columns of d, in
// blocks of 384 threads: a producer warpgroup (threads 256-383; setmaxnreg
// 40 / 232) and two consumer warpgroups of 64 output rows, each running
// m64n256k16 (128 fp32 accumulators a thread) over a ring of MMW_STAGES
// stages of 64-deep chunks of the contraction (queries in dkv, keys in dq).
// A stage holds the tile's A chunk (two 64 x 64 boxes of the scratch, 16 KB)
// and B chunk (four 64 x 64 boxes of dO, q or k, 32 KB), all as TMA lands
// them under the 128-byte swizzle.  The operands are read as stored: Pᵀ and
// dSᵀ are the scratch's rows read MN-major (imm-trans-a = 1, which 16-bit
// types allow), dS in dq K-major, and dO, q and k MN-major (imm-trans-b = 1):
// no transposed copy.  The epilogue scales, rounds to bf16 once and stages
// the tile a 64-column block at a time through shared memory, then writes
// 16-byte pieces along the rows of the (b, seq, heads, d) output.
// What bounds them: the products, 4·b·h·n·m·d (dkv) and 2·b·h·n·m·d (dq)
// operations at the bf16 rate, ~70 and ~35 µs at b = 2 and 4096 tokens.
// Four stages keep two to three chunks in flight while one is multiplied;
// three were 10% slower.  The grid is persistent (one block an SM, each
// walking the tiles in turn), so that one tile's epilogue runs beside the
// next tile's loads; the two column blocks of a row tile come next to each
// other in the walk, so they read the same scratch strip at about the same
// time (P and dS, 128 MB at b = 2, do not fit the 50 MB L2).  (Pairs of
// blocks sharing the B chunk by TMA multicast were 2-4% slower: the pair
// waits for its slower block.  The plan this replaced: 128 x 128 tiles of
// mma.sync with ldmatrix fragment loads and a cp.async ring filled by the
// computing warps, at 24-28% of the bound.)

constexpr int MMW_BM = 128, MMW_BN = 256, MMW_KC = 64, MMW_STAGES = 4, MMW_THREADS = 384;
constexpr int MMW_BOX = 64 * 64 * 2;                  // bytes of one 64-row, 64-column box
constexpr int MMW_A = 2 * MMW_BOX, MMW_STAGE = MMW_A + 4 * MMW_BOX;   // A, then B, a stage
constexpr int MMW_OUT = MMW_BM * 64 * 2;              // a staged 128 x 64 bf16 output block

// Shared memory (bytes): 1024 of alignment slack, the ring, the staged
// output block and the ring's barriers (full and empty a stage).
constexpr int mm_bf16_smem_bytes() {
  return 1024 + MMW_STAGES * MMW_STAGE + MMW_OUT + 2 * MMW_STAGES * 8;
}

// How dkv_mm (dq = false) or dq_mm runs at b·heads bh, n queries and m keys
// on a card of ``sms`` SMs: its tile, ring stages, shared memory, tiles and
// grid (one block an SM, at most one a tile).  The wrapper checks its own
// plan against it (flash_attn_bwd_bf16_mm_geometry).
struct MmPlan {
  int rows, cols, stages, smem, tiles, grid;
};

inline MmPlan mm_plan(bool dq, int bh, int n, int m, int sms) {
  const int tiles = (dq ? 1 : 2) * bh * ((dq ? n : m) / MMW_BM) * (512 / MMW_BN);
  return {MMW_BM, MMW_BN, MMW_STAGES, mm_bf16_smem_bytes(), tiles, tiles < sms ? tiles : sms};
}

// out (rows x 512 per matrix) = scale · A B over the contraction, for one of
// the matrices: dkv (TRANS_A) has 2·bh of them, dV = Pᵀ dO for mat < bh and
// dK = sm_scale dSᵀ q after; dq has bh, dQ = sm_scale dS k.  The scratch
// map tm_s views [P | dS] as (2·bh, n, 1, m) (boxes of 64 columns x 64
// rows): A of matrix mat is scratch matrix mat (dkv) or bh + mat (dq).
// tm_b0 / tm_b1 (dO / q, or k twice) are (b, seq, heads, 512) maps with boxes
// of 64 columns x 64 rows; out0 / out1 (dv / dk, or dq twice) contiguous (b,
// rows, heads, 512).
template <bool TRANS_A>
__device__ __forceinline__ void mm_bf16(const CUtensorMap* tm_s, const CUtensorMap* tm_b0,
                                        const CUtensorMap* tm_b1, bf16* __restrict__ out0,
                                        bf16* __restrict__ out1, float scale0, float scale1,
                                        int bh, int heads, int n, int m, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* ring = align1024(smem_tma);    // MMW_STAGES x {A, B}
  unsigned char* stage_out = ring + MMW_STAGES * MMW_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + MMW_OUT);
  uint64_t* empty = full + MMW_STAGES;

  // Tile w: column block w % 2 of row tile (w / 2) % rts of matrix w / (2·rts);
  // this block takes tiles blockIdx.x, blockIdx.x + gridDim.x, ...
  const int tid = threadIdx.x;
  const int rows = TRANS_A ? m : n, nchunk = (TRANS_A ? n : m) / MMW_KC;
  const int rts = rows / MMW_BM, cbs = 512 / MMW_BN;
  auto tile_of = [&](int w, int& mat, int& r0, int& c0) {
    c0 = (w % cbs) * MMW_BN;
    r0 = (w / cbs % rts) * MMW_BM;
    mat = w / (cbs * rts);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < MMW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {   // the producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int u = 0;   // chunks loaded so far
      for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
        int mat, r0, c0;
        tile_of(w, mat, r0, c0);
        const int b_bh = mat % bh, bi = b_bh / heads, hi = b_bh % heads;
        const int smat = TRANS_A ? mat : bh + mat;
        const CUtensorMap* tm_b = mat >= bh ? tm_b1 : tm_b0;
        for (int c = 0; c < nchunk; ++c, ++u) {
          const int s = u % MMW_STAGES;
          if (u >= MMW_STAGES) mbar_wait(&empty[s], (u / MMW_STAGES - 1) & 1);
          mbar_arrive_expect_tx(&full[s], MMW_STAGE);
          unsigned char* st = ring + s * MMW_STAGE;
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // the A boxes of the two warpgroups' 64 rows
            if (TRANS_A)   // 64 keys (columns of P or dS) x 64 queries (rows): Pᵀ MN-major
              tma_load_4d(st + h * MMW_BOX, tm_s, &full[s], r0 + 64 * h, 0, MMW_KC * c, smat);
            else           // 64 keys x 64 queries of dS: K-major
              tma_load_4d(st + h * MMW_BOX, tm_s, &full[s], MMW_KC * c, 0, r0 + 64 * h, smat);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)   // B's four 64-column boxes
            tma_load_4d(st + MMW_A + i * MMW_BOX, tm_b, &full[s], c0 + 64 * i, hi, MMW_KC * c,
                        bi);
        }
      }
    }
  } else {   // the consumer warpgroups
    setmaxnreg_inc<232>();
    const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    // a consumer warp's arrival on a stage's empty barrier
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    int u = 0;   // chunks consumed so far
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      int mat, r0, c0;
      tile_of(w, mat, r0, c0);
      float acc[128];
      for (int c = 0; c < nchunk; ++c, ++u) {
        mbar_wait(&full[u % MMW_STAGES], (u / MMW_STAGES) & 1);
        __syncwarp();
        const unsigned char* st = ring + (u % MMW_STAGES) * MMW_STAGE;
        // A: this warpgroup's box (64 rows MN-major, or 64 rows K-major); B: all four
        uint64_t da = desc_sw128(st + wg * MMW_BOX, TRANS_A ? MMW_BOX : 16, 1024);
        uint64_t db = desc_sw128(st + MMW_A, MMW_BOX, 1024);
        opaque(da);
        opaque(db);
        wgmma_fence();
        // k-step kk: 16 rows further (MN-major A, and B), 32 bytes into the rows (K-major A)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n256<1, TRANS_A ? 1 : 0>(acc, da + ((TRANS_A ? kk * 2048 : kk * 32) >> 4),
                                            db + ((kk * 2048) >> 4), c > 0 || kk > 0);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release((u - 1) % MMW_STAGES);   // chunk c - 1 is read
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((u - 1) % MMW_STAGES);

      // the epilogue: scale, round to bf16, and through stage_out ([128][64]
      // bf16, 16-byte chunk ch of row r at chunk ch ^ (r % 8)) a 64-column
      // block at a time; entry 4j + r of acc is row 16wq + g + 8·(r / 2) of
      // the warpgroup's, column 8j + 2t + r % 2
      const int b_bh = mat % bh, bi = b_bh / heads, hi = b_bh % heads;
      const float scale = mat >= bh ? scale1 : scale0;
      const long long pitch = (long long)heads * 512;
      bf16* out = (mat >= bh ? out1 : out0) + ((long long)bi * rows * heads + hi) * 512 + c0;
#pragma unroll
      for (int cb = 0; cb < MMW_BN / 64; ++cb) {
        bar_sync(1, 256);   // the staged block's last reader is done
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * wg + 16 * wq + g + 8 * h;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = 32 * cb + 4 * j + 2 * h;
            *reinterpret_cast<uint32_t*>(stage_out + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t) =
                pack_bf16x2(acc[i] * scale, acc[i + 1] * scale);
          }
        }
        bar_sync(1, 256);
        for (int e = tid; e < MMW_BM * 8; e += 256) {
          const int r = e / 8, ch = e % 8;
          *reinterpret_cast<uint4*>(out + (r0 + r) * pitch + 64 * cb + 8 * ch) =
              *reinterpret_cast<const uint4*>(stage_out + r * 128 + ((ch ^ (r & 7)) << 4));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(MMW_THREADS, 1)
flash_attn_bwd_dkv_mm_bf16_kernel(const __grid_constant__ CUtensorMap tm_s,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const __grid_constant__ CUtensorMap tm_q, bf16* __restrict__ dv,
                                  bf16* __restrict__ dk, float sm_scale, int bh, int heads, int n,
                                  int m, int tiles) {
  mm_bf16<true>(&tm_s, &tm_do, &tm_q, dv, dk, 1.f, sm_scale, bh, heads, n, m, tiles);
}

__global__ void __launch_bounds__(MMW_THREADS, 1)
flash_attn_bwd_dq_mm_bf16_kernel(const __grid_constant__ CUtensorMap tm_s,
                                 const __grid_constant__ CUtensorMap tm_k, bf16* __restrict__ dq,
                                 float sm_scale, int bh, int heads, int n, int m, int tiles) {
  mm_bf16<false>(&tm_s, &tm_k, &tm_k, dq, dq, sm_scale, sm_scale, bh, heads, n, m, tiles);
}

// ---- launches ------------------------------------------------------------

// q, k, v, dO, dq, dk and dv in T (float or bf16); lse, di and the split
// parts in float; the d = 512 scratch (P and dS) in T
template <typename T>
struct Args {
  const T *q, *k, *v, *dout;
  const float *lse, *di;
  T *dq, *dk, *dv;
  void* scratch;
  Strides st;
  int b, heads, n, m, dkv_split, dq_split;
  float sm_scale;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_sum(const float* parts, T* out, long long count, int nparts,
                       cudaStream_t stream) {
  const long long count4 = count / 4;
  const int blocks = (int)(count4 / 256 < 1056 ? (count4 + 255) / 256 : 1056);
  if constexpr (sizeof(T) == sizeof(float))
    flash_attn_bwd_sum_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(parts), reinterpret_cast<float4*>(out), count4, nparts);
  else
    flash_attn_bwd_sum_bf16_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(parts), out, count4, nparts);
  return cudaGetLastError();
}

// the dkv kernel, then the dq kernel, then the sums of split parts, on one
// stream; returns the first error.  Split parts go to scratch (float) as
// [dk parts | dv parts | dq parts].  ``Dkv``/``Dq`` launch the two kernels on
// (grid, output pointers).
template <typename T, typename LaunchDkv, typename LaunchDq>
cudaError_t launch_split_parts(const Args<T>& a, int d, int bm, int bk, int bn, int bq,
                               LaunchDkv dkv_kernel, LaunchDq dq_kernel, cudaStream_t stream) {
  const long long kv_size = (long long)a.b * a.m * a.heads * d;
  const long long q_size = (long long)a.b * a.n * a.heads * d;
  if ((a.n / bm) % a.dkv_split || (a.m / bk) % a.dq_split || a.m % bn || a.n % bq)
    return cudaErrorInvalidValue;
  if ((a.dkv_split > 1 || a.dq_split > 1) && a.scratch == nullptr) return cudaErrorInvalidValue;
  float* scratch = static_cast<float*>(a.scratch);
  float* dk = scratch;
  float* dv = scratch + (a.dkv_split > 1 ? a.dkv_split * kv_size : 0);
  float* dq = scratch + (a.dkv_split > 1 ? 2 * a.dkv_split * kv_size : 0);
  cudaError_t err = dkv_kernel(dk, dv);
  if (err != cudaSuccess) return err;
  if ((err = dq_kernel(dq)) != cudaSuccess) return err;
  if (a.dkv_split > 1) {
    if ((err = launch_sum(dk, a.dk, kv_size, a.dkv_split, stream)) != cudaSuccess) return err;
    if ((err = launch_sum(dv, a.dv, kv_size, a.dkv_split, stream)) != cudaSuccess) return err;
  }
  if (a.dq_split > 1) return launch_sum(dq, a.dq, q_size, a.dq_split, stream);
  return cudaSuccess;
}

template <int D, int BN, int BM, int KRW, int BQ, int BK, int QRW>
cudaError_t launch_fused(const Args<float>& a, cudaStream_t stream) {
  const size_t smem_dkv = sizeof(float) * dkv_smem_floats<D, BN, BM>();
  const size_t smem_dq = sizeof(float) * dq_smem_floats<D, BQ, BK>();
  cudaError_t err = set_smem(flash_attn_bwd_dkv_kernel<D, BN, BM, KRW>, smem_dkv);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dq_kernel<D, BQ, BK, QRW>, smem_dq);
  if (err != cudaSuccess) return err;
  auto dkv = [&](float* dk_parts, float* dv_parts) {
    flash_attn_bwd_dkv_kernel<D, BN, BM, KRW>
        <<<dim3(a.m / BN, a.b * a.heads, a.dkv_split), BN / KRW * 2, smem_dkv, stream>>>(
            a.q, a.k, a.v, a.dout, a.lse, a.di, a.dkv_split > 1 ? dk_parts : a.dk,
            a.dkv_split > 1 ? dv_parts : a.dv, a.st, a.b, a.heads, a.n, a.m,
            a.n / BM / a.dkv_split, a.sm_scale);
    return cudaGetLastError();
  };
  auto dq = [&](float* dq_parts) {
    flash_attn_bwd_dq_kernel<D, BQ, BK, QRW>
        <<<dim3(a.n / BQ, a.b * a.heads, a.dq_split), BQ / QRW * 2, smem_dq, stream>>>(
            a.q, a.k, a.v, a.dout, a.lse, a.di, a.dq_split > 1 ? dq_parts : a.dq, a.st, a.b,
            a.heads, a.n, a.m, a.m / BK / a.dq_split, a.sm_scale);
    return cudaGetLastError();
  };
  return launch_split_parts(a, D, BM, BK, BN, BQ, dkv, dq, stream);
}

// bf16: a split writes float parts (the OutT = float instantiation), an
// unsplit loop bf16 outputs directly.  q, k, v and dO go in as tensor maps
// (boxes of 64 columns x 64 rows) over their strided views.
template <int D, int STAGES>
cudaError_t launch_fused_bf16(const Args<bf16>& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const Strides& st = a.st;
  cudaError_t err = bf16_tile_map(&tq, a.q, a.b, a.n, a.heads, D, st.qb, st.qn, st.qh, 64);
  if (err == cudaSuccess) err = bf16_tile_map(&tk, a.k, a.b, a.m, a.heads, D, st.kb, st.kn, st.kh, 64);
  if (err == cudaSuccess) err = bf16_tile_map(&tv, a.v, a.b, a.m, a.heads, D, st.vb, st.vn, st.vh, 64);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tdo, a.dout, a.b, a.n, a.heads, D, st.gb, st.gn, st.gh, 64);
  if (err != cudaSuccess) return err;
  constexpr int smem_dkv = dkv_bf16_smem_bytes<D, STAGES>();
  constexpr int smem_dq = dq_bf16_smem_bytes<D, STAGES>();
  err = set_smem(flash_attn_bwd_dkv_bf16_kernel<D, STAGES, float>, smem_dkv);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dkv_bf16_kernel<D, STAGES, bf16>, smem_dkv);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dq_bf16_kernel<D, STAGES, float>, smem_dq);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dq_bf16_kernel<D, STAGES, bf16>, smem_dq);
  if (err != cudaSuccess) return err;
  auto dkv = [&](float* dk_parts, float* dv_parts) {
    const dim3 grid(a.m / BF16_BLOCK, a.b * a.heads, a.dkv_split);
    const int tiles = a.n / BF16_TILE / a.dkv_split;
    if (a.dkv_split > 1)
      flash_attn_bwd_dkv_bf16_kernel<D, STAGES, float><<<grid, BF16_THREADS, smem_dkv, stream>>>(
          tq, tk, tv, tdo, a.lse, a.di, dk_parts, dv_parts, a.b, a.heads, a.n, a.m, tiles,
          a.sm_scale);
    else
      flash_attn_bwd_dkv_bf16_kernel<D, STAGES, bf16><<<grid, BF16_THREADS, smem_dkv, stream>>>(
          tq, tk, tv, tdo, a.lse, a.di, a.dk, a.dv, a.b, a.heads, a.n, a.m, tiles, a.sm_scale);
    return cudaGetLastError();
  };
  auto dq = [&](float* dq_parts) {
    const dim3 grid(a.n / BF16_BLOCK, a.b * a.heads, a.dq_split);
    const int tiles = a.m / BF16_TILE / a.dq_split;
    if (a.dq_split > 1)
      flash_attn_bwd_dq_bf16_kernel<D, STAGES, float><<<grid, BF16_THREADS, smem_dq, stream>>>(
          tq, tk, tv, tdo, a.lse, a.di, dq_parts, a.b, a.heads, a.n, a.m, tiles, a.sm_scale);
    else
      flash_attn_bwd_dq_bf16_kernel<D, STAGES, bf16><<<grid, BF16_THREADS, smem_dq, stream>>>(
          tq, tk, tv, tdo, a.lse, a.di, a.dq, a.b, a.heads, a.n, a.m, tiles, a.sm_scale);
    return cudaGetLastError();
  };
  return launch_split_parts(a, D, BF16_TILE, BF16_TILE, BF16_BLOCK, BF16_BLOCK, dkv, dq, stream);
}

// d = 512: flash_attn_bwd_p_ds_kernel into scratch as [P | dS], then
// flash_attn_bwd_dkv_mm_kernel and flash_attn_bwd_dq_mm_kernel.
template <int D>
cudaError_t launch_d512(const Args<float>& a, cudaStream_t stream) {
  if (a.scratch == nullptr || a.dkv_split != 1 || a.dq_split != 1) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(a.scratch);
  float* ds = p + (long long)a.b * a.heads * a.n * a.m;
  const size_t smem_pds = sizeof(float) * 2 * PDS_STAGE;
  const size_t smem_mm = sizeof(float) * MM_STAGES * MM_STAGE;
  cudaError_t err = set_smem(flash_attn_bwd_p_ds_kernel<D>, smem_pds);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dkv_mm_kernel<D>, smem_mm);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dq_mm_kernel<D>, smem_mm);
  if (err != cudaSuccess) return err;
  flash_attn_bwd_p_ds_kernel<D>
      <<<dim3(a.m / PDS_BN, a.n / PDS_BM, a.b * a.heads), 256, smem_pds, stream>>>(
          a.q, a.k, a.v, a.dout, a.lse, a.di, p, ds, a.st, a.heads, a.n, a.m, a.sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attn_bwd_dkv_mm_kernel<D>
      <<<dim3(D / MM_BN, a.m / MM_BM, 2 * a.b * a.heads), 256, smem_mm, stream>>>(
          a.q, a.dout, p, ds, a.dk, a.dv, a.st, a.heads, a.n, a.m, a.sm_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attn_bwd_dq_mm_kernel<D>
      <<<dim3(D / MM_BN, a.n / MM_BM, a.b * a.heads), 256, smem_mm, stream>>>(
          a.k, ds, a.dq, a.st, a.heads, a.n, a.m, a.sm_scale);
  return cudaGetLastError();
}

// The card's SM count (current device).
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// bf16, d = 512: dkv_mm, then dq_mm, on the [P | dS] scratch (2·b·heads·n·m
// bf16) as mm_plan says, on TMA tensor maps of the scratch and of dO, q and k
// (boxes of 64 columns x 64 rows).
cudaError_t launch_mm_bf16(const Args<bf16>& a, cudaStream_t stream) {
  constexpr int D = 512;
  if (a.scratch == nullptr || a.n % MMW_BM || a.m % MMW_BM) return cudaErrorInvalidValue;
  const int bh = a.b * a.heads, heads = a.heads, n = a.n, m = a.m;
  int sms = 0;
  CUtensorMap ts, tdo, tq, tk;
  const Strides& st = a.st;
  cudaError_t err = bf16_tile_map(&ts, a.scratch, 2 * bh, n, 1, m, (long long)n * m, m, m, 64);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tdo, a.dout, a.b, n, heads, D, st.gb, st.gn, st.gh, 64);
  if (err == cudaSuccess) err = bf16_tile_map(&tq, a.q, a.b, n, heads, D, st.qb, st.qn, st.qh, 64);
  if (err == cudaSuccess) err = bf16_tile_map(&tk, a.k, a.b, m, heads, D, st.kb, st.kn, st.kh, 64);
  if (err == cudaSuccess) err = device_sms(&sms);
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dkv_mm_bf16_kernel, mm_bf16_smem_bytes());
  if (err == cudaSuccess) err = set_smem(flash_attn_bwd_dq_mm_bf16_kernel, mm_bf16_smem_bytes());
  if (err != cudaSuccess) return err;
  const MmPlan kv = mm_plan(false, bh, n, m, sms), qp = mm_plan(true, bh, n, m, sms);
  flash_attn_bwd_dkv_mm_bf16_kernel<<<kv.grid, MMW_THREADS, kv.smem, stream>>>(
      ts, tdo, tq, a.dv, a.dk, a.sm_scale, bh, heads, n, m, kv.tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_attn_bwd_dq_mm_bf16_kernel<<<qp.grid, MMW_THREADS, qp.smem, stream>>>(
      ts, tk, a.dq, a.sm_scale, bh, heads, n, m, qp.tiles);
  return cudaGetLastError();
}

// the same in bf16: P and dS in bf16 scratch, the p_ds kernel on TMA tensor
// maps of q, k, v and dO (boxes of 64 columns x 128 rows) in clusters of
// p_ds_cluster(m) blocks, as many as fit the card at once; then dkv_mm and
// dq_mm (launch_mm_bf16)
cudaError_t launch_d512_bf16(const Args<bf16>& a, cudaStream_t stream) {
  constexpr int D = 512;
  if (a.scratch == nullptr || a.dkv_split != 1 || a.dq_split != 1) return cudaErrorInvalidValue;
  if (a.n % PD_BQ || a.m % PD_BK) return cudaErrorInvalidValue;
  bf16* p = static_cast<bf16*>(a.scratch);
  bf16* ds = p + (long long)a.b * a.heads * a.n * a.m;
  CUtensorMap tq, tk, tv, tdo;
  const Strides& st = a.st;
  cudaError_t err = bf16_tile_map(&tq, a.q, a.b, a.n, a.heads, D, st.qb, st.qn, st.qh, PD_BQ);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tk, a.k, a.b, a.m, a.heads, D, st.kb, st.kn, st.kh, PD_BK);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tv, a.v, a.b, a.m, a.heads, D, st.vb, st.vn, st.vh, PD_BK);
  if (err == cudaSuccess)
    err = bf16_tile_map(&tdo, a.dout, a.b, a.n, a.heads, D, st.gb, st.gn, st.gh, PD_BQ);
  if (err != cudaSuccess) return err;
  constexpr int smem_pds = p_ds_bf16_smem_bytes();
  if ((err = set_smem(flash_attn_bwd_p_ds_bf16_kernel<D>, smem_pds)) != cudaSuccess) return err;
  const float* lse = a.lse;
  const float* di = a.di;
  int heads = a.heads, n = a.n, m = a.m, cluster = p_ds_cluster(a.m);
  int tiles = (m / (PD_BK * cluster)) * (n / PD_BQ) * a.b * a.heads;
  float sm_scale = a.sm_scale;
  // as many clusters as the card holds at once, at most one a cluster tile
  const void* kernel = reinterpret_cast<const void*>(flash_attn_bwd_p_ds_bf16_kernel<D>);
  int clusters = 0;
  if ((err = max_clusters(kernel, PD_THREADS, smem_pds, cluster, &clusters)) != cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  clusters = clusters < tiles ? clusters : tiles;
  void* args[] = {&tq, &tk, &tv, &tdo, &lse, &di, &p, &ds, &heads, &n, &m, &sm_scale, &cluster,
                  &tiles};
  err = launch_cluster(kernel, dim3(cluster * clusters), PD_THREADS, smem_pds, cluster, args,
                       stream);
  return err != cudaSuccess ? err : launch_mm_bf16(a, stream);
}

}  // namespace

extern "C" {

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, dout: (b, n, heads, d); k, v: (b, m, heads, d); float32 on the current
// device, element strides per (batch, seq, head), unit stride along d, every
// stride a multiple of 4 and every base 16-byte aligned.  lse and di:
// contiguous (b, heads, n).  dq: contiguous (b, n, heads, d); dk and dv:
// contiguous (b, m, heads, d).  n and m multiples of 128.  scratch: float32,
// d = 512: 2·b·heads·n·m (P and dS); d = 64 or 128: 2·dkv_split·b·m·heads·d
// if dkv_split > 1 plus dq_split·b·n·heads·d if dq_split > 1, else may be
// null.  dkv_split (dq_split) cuts the loop over query (key) tiles into that
// many parts, each a divisor of the tile count (64-row tiles at d = 64,
// 32-row at d = 128); 1 at d = 512.  Launches the kernels on the stream and
// returns the first launch error (cudaSuccess = 0).
int flash_attn_bwd(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* di, float* dq, float* dk, float* dv,
                   float* scratch, long long qb, long long qn, long long qh, long long kb,
                   long long kn, long long kh, long long vb, long long vn, long long vh,
                   long long gb, long long gn, long long gh, int b, int heads, int n, int m,
                   int d, int dkv_split, int dq_split, float sm_scale, void* stream) {
  const Args<float> a{q, k, v, dout, lse, di, dq, dk, dv, scratch,
                      Strides{qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh},
                      b, heads, n, m, dkv_split, dq_split, sm_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 128 != 0 || m % 128 != 0 || dkv_split < 1 || dq_split < 1)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return (int)launch_fused<64, 128, 32, 2, 128, 32, 2>(a, s);
    case 128: return (int)launch_fused<128, 128, 32, 1, 128, 32, 1>(a, s);
    case 512: return (int)launch_d512<512>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// flash_attn_bwd with bf16 q, k, v, dout, dq, dk and dv (lse and di
// float32): every stride a multiple of 8 and every base 16-byte aligned (the
// tensor maps also need strides below 2^39 elements).
// scratch: d = 512: 2·b·heads·n·m bf16 (P and dS); d = 64 or 128 the float32
// split parts as flash_attn_bwd's (64-row query and key tiles).
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* di, void* dq, void* dk, void* dv,
                        void* scratch, long long qb, long long qn, long long qh, long long kb,
                        long long kn, long long kh, long long vb, long long vn, long long vh,
                        long long gb, long long gn, long long gh, int b, int heads, int n, int m,
                        int d, int dkv_split, int dq_split, float sm_scale, void* stream) {
  const Args<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, di,
                     static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                     scratch, Strides{qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh},
                     b, heads, n, m, dkv_split, dq_split, sm_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 128 != 0 || m % 128 != 0 || dkv_split < 1 || dq_split < 1)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return (int)launch_fused_bf16<64, BF16_STAGES_D64>(a, s);
    case 128: return (int)launch_fused_bf16<128, BF16_STAGES_D128>(a, s);
    case 512: return (int)launch_d512_bf16(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// flash_attn_bwd_bf16's last two kernels alone at d = 512, dkv_mm and
// dq_mm, on a given scratch [P | dS] (2·b·heads·n·m bf16, P and dS each
// contiguous (b, heads, n, m)): dq, dk and dv from q, k and dout as
// flash_attn_bwd_bf16 takes them.  Returns the first launch error.
int flash_attn_bwd_mm_bf16(const void* q, const void* k, const void* dout, const void* scratch,
                           void* dq, void* dk, void* dv, long long qb, long long qn, long long qh,
                           long long kb, long long kn, long long kh, long long gb, long long gn,
                           long long gh, int b, int heads, int n, int m, int d, float sm_scale,
                           void* stream) {
  if (d != 512 || n % 128 != 0 || m % 128 != 0) return (int)cudaErrorInvalidValue;
  const Args<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), nullptr,
                     static_cast<const bf16*>(dout), nullptr, nullptr, static_cast<bf16*>(dq),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), const_cast<void*>(scratch),
                     Strides{qb, qn, qh, kb, kn, kh, 0, 0, 0, gb, gn, gh},
                     b, heads, n, m, 1, 1, sm_scale};
  return (int)launch_mm_bf16(a, (cudaStream_t)stream);
}

// How the bf16 dkv_mm (kernel 0) or dq_mm (1) runs at d = 512 on the current
// device: tile rows and columns, ring stages, shared memory and grid into
// out[0..4] (mm_plan); returns an error code.  The wrapper checks its own
// plan against it.
int flash_attn_bwd_bf16_mm_geometry(int kernel, int b, int heads, int n, int m, int* out) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const MmPlan p = mm_plan(kernel == 1, b * heads, n, m, sms);
  const int v[5] = {p.rows, p.cols, p.stages, p.smem, p.grid};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// The bf16 wgmma kernels' dynamic shared memory a block at head width d
// (kernel 0: dkv, or p_ds at d = 512; 1: dq), or -1; the wrapper checks its
// own plan against it.
int flash_attn_bwd_bf16_smem_bytes(int d, int kernel) {
  switch (d) {
    case 64: return kernel ? dq_bf16_smem_bytes<64, BF16_STAGES_D64>()
                           : dkv_bf16_smem_bytes<64, BF16_STAGES_D64>();
    case 128: return kernel ? dq_bf16_smem_bytes<128, BF16_STAGES_D128>()
                            : dkv_bf16_smem_bytes<128, BF16_STAGES_D128>();
    case 512: return kernel ? -1 : p_ds_bf16_smem_bytes();
    default: return -1;
  }
}

// Blocks a cluster of the bf16 backward's kernels at head width d and m keys
// (1: no cluster); the wrapper checks its own plan against it.
int flash_attn_bwd_bf16_cluster(int d, int m) { return d == 512 ? p_ds_cluster(m) : 1; }

}  // extern "C"
