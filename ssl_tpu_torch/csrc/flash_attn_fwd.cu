// K2: flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash attention that ssl_tpu/ops/attention.py
// (sdp_attention, flash branch :32-39) calls through
// jax.experimental.pallas.ops.tpu.flash_attention.  Same contract as its
// plain PyTorch version, ssl_tpu_torch/ops/attention.py::sdp_attention_reference:
//     o[b, i, h, :] = sum_j softmax_j(sm_scale * q[b, i, h, :] . k[b, j, h, :]) v[b, j, h, :]
// over float32 (b, seq, heads, d) tensors read through their strides (unit
// stride along d), with n and m multiples of 128 (the wrapper checks both).
// For training it also writes each row's log-sum-exp of the scaled logits,
// lse = m + log(l) from the running max and sum it holds anyway; the backward
// (csrc/flash_attn_bwd.cu) recomputes the probabilities from it.  Upstream
// saves m and l apart (save_residuals), which carry the same information.
//
// What bounds it on this card: operations.  At the diffusion tree's shapes
// (n = m = 4096 with d = 64 for the UNet's 4 heads, d = 512 for the VAE's one
// head) the logits alone are n·m per head, 4·n·m·d fp32 operations for the
// two products against 16·n·d bytes of input and output: ~100 to ~1000
// operations per byte, far above the card's ~20 fp32 operations per byte.
// So the design keeps the n x m logits out of device memory altogether and
// reads each input once per query tile:
//   * one block of 256 threads per (b·head, tile of BM queries); the Q tile
//     stays in shared memory, K and V tiles of BN keys stream through it;
//   * thread (ty, tx) of a 16 x 16 grid owns query rows ty·TM .. ty·TM+TM-1
//     and the output columns tx + 16c and logit columns tx + 16j, so the
//     16 threads of a half-warp hold a whole row: the online softmax's row
//     max and row sum are taken with shuffles inside the half-warp, and the
//     running max and sum stay in registers;
//   * the tile's probabilities go through shared memory once for the P·V
//     product; the output accumulator (TM x d/16 per thread) is in registers;
//   * the tile shape is a template on d (64, 128 and 512, the widths of the
//     serving path): BM = BN = 64 for d <= 128, and 32 for d = 512, whose
//     32 x 512 Q, K and V tiles take ~200 KB of dynamic shared memory
//     (above 48 KB it needs cudaFuncSetAttribute);
//   * fp32 FMA and expf, no fast-math, no atomics: deterministic, and each
//     row's sums run in a fixed order.
// Rows of Q and K in shared memory are padded by one float so that the reads
// of a warp fall in distinct banks.  Tensor cores (wgmma), TMA and a
// pipelined ring of K/V tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;

struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh;
};

template <int D, int BM, int BN>
constexpr size_t smem_floats() {
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D + (size_t)BM * (BN + 1);
}

// Reduce over the 16 lanes of a half-warp (xor offsets below 16 stay inside it).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides st, int heads, int n, int m,
                      float sm_scale) {
  constexpr int TM = BM / 16;   // query rows per thread
  constexpr int TN = D / 16;    // output columns per thread
  constexpr int SJ = BN / 16;   // logit columns per thread and tile
  constexpr int QS = D + 1, KS = D + 1, PS = BN + 1;
  extern __shared__ float smem[];
  float* s_q = smem;              // [BM][D + 1]
  float* s_k = s_q + BM * QS;     // [BN][D + 1]
  float* s_v = s_k + BN * KS;     // [BN][D]
  float* s_p = s_v + BN * D;      // [BM][BN + 1]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bi = blockIdx.y / heads, hi = blockIdx.y % heads;
  const int q0 = blockIdx.x * BM;
  const float* qp = q + bi * st.qb + hi * st.qh;
  const float* kp = k + bi * st.kb + hi * st.kh;
  const float* vp = v + bi * st.vb + hi * st.vh;
  float* op = o + bi * st.ob + hi * st.oh;

  for (int e = tid; e < BM * D; e += NTHREADS) {
    const int r = e / D, c = e % D;
    s_q[r * QS + c] = qp[(long long)(q0 + r) * st.qn + c];
  }

  float acc[TM][TN];
  float row_m[TM], row_l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < m; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done (and Q is staged)
    for (int e = tid; e < BN * D; e += NTHREADS) {
      const int r = e / D, c = e % D;
      s_k[r * KS + c] = kp[(long long)(k0 + r) * st.kn + c];
      s_v[e] = vp[(long long)(k0 + r) * st.vn + c];
    }
    __syncthreads();

    // logits of this thread's rows against keys tx + 16j of the tile
    float s[TM][SJ];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[TM], kv[SJ];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = s_q[(ty * TM + i) * QS + c];
#pragma unroll
      for (int j = 0; j < SJ; ++j) kv[j] = s_k[(tx + 16 * j) * KS + c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax: running max and sum per row, rescale the accumulator
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[i][j] *= sm_scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(row_m[i], half_warp_max(mx));
      const float alpha = expf(row_m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(ty * TM + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      row_l[i] = row_l[i] * alpha + half_warp_sum(sum);
      row_m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P · V over the tile's keys
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float vv[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) vv[c] = s_v[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = s_p[(ty * TM + i) * PS + j];
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* orow = op + (long long)(q0 + ty * TM + i) * st.on;
#pragma unroll
    for (int c = 0; c < TN; ++c) orow[tx + 16 * c] = acc[i][c] / row_l[i];
    // the row's log-sum-exp of the scaled logits, for the backward's recompute
    if (lse != nullptr && tx == 0)
      lse[(long long)blockIdx.y * n + q0 + ty * TM + i] = row_m[i] + logf(row_l[i]);
  }
}

template <int D, int BM, int BN>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   const Strides& st, int b, int heads, int n, int m, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D, BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_fwd_kernel<D, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BM, b * heads);
  flash_attn_fwd_kernel<D, BM, BN><<<grid, NTHREADS, smem, stream>>>(q, k, v, o, lse, st, heads,
                                                                      n, m, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q: (b, n, heads, d), k and v: (b, m, heads, d), o: (b, n, heads, d); float32
// on the current device, element strides per (batch, seq, head), unit stride
// along d; n and m multiples of 128.  lse: null, or a contiguous (b, heads, n)
// output for each row's log-sum-exp of the scaled logits (what the backward
// recomputes the probabilities from).  Returns cudaGetLastError() after the launch.
int flash_attn_fwd(const float* q, const float* k, const float* v, float* o, float* lse,
                   long long qb, long long qn, long long qh, long long kb, long long kn, long long kh,
                   long long vb, long long vn, long long vh, long long ob, long long on,
                   long long oh, int b, int heads, int n, int m, int d, float sm_scale,
                   void* stream) {
  const Strides st{qb, qn, qh, kb, kn, kh, vb, vn, vh, ob, on, oh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 128 != 0 || m % 128 != 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return (int)launch<64, 64, 64>(q, k, v, o, lse, st, b, heads, n, m, sm_scale, s);
    case 128: return (int)launch<128, 64, 64>(q, k, v, o, lse, st, b, heads, n, m, sm_scale, s);
    case 512: return (int)launch<512, 32, 32>(q, k, v, o, lse, st, b, heads, n, m, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
