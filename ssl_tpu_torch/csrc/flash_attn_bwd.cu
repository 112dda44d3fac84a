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
// stride along d), n and m multiples of 128; dq, dk and dv are written
// contiguous (b, seq, heads, d).
//
// What bounds it on this card: operations.  The five products (q kᵀ, dO vᵀ,
// Pᵀ dO, dSᵀ q, dS k) are 10·b·h·n·m·d fp32 operations against
// 4·b·h·(3nd + 3md + 2n) bytes of input and output: at the training shapes
// (n = m = 1024 or 4096, d = 64 to 512) hundreds of operations per byte, far
// above the card's ~20 fp32 operations per byte.  So no n x m matrix goes to
// device memory; each kernel recomputes P and dS for its own tiles, which
// costs the two logit products twice over the pair (14 instead of 10 bhnmd):
//   * flash_attn_bwd_dkv: one block of 256 threads per (b·head, tile of BN
//     keys).  The K and V tiles stay in shared memory; the Q and dO tiles of
//     every query tile, with their lse and di, stream through it.  Thread
//     (ty, tx) of a 16 x 16 grid recomputes logits and dP for query rows
//     ty·TM .. ty·TM+TM-1 and keys tx + 16j, writes P and dS to shared memory,
//     then accumulates dV and dK for keys ty·TK .. and columns tx + 16c in
//     registers;
//   * flash_attn_bwd_dq: one block per (b·head, tile of BM queries).  The Q
//     and dO tiles stay, K and V tiles stream; dS goes through shared memory
//     once for dQ += dS k, and the dQ accumulator is in registers;
//   * the tile shape is a template on d (64, 128 and 512, the widths of the
//     training path): BM = BN = 64 for d <= 128; at d = 512 (the VAE's single
//     head) BM = 32 and BN = 16, so that the four 512-wide tiles take ~200 KB
//     of dynamic shared memory and a thread holds 32 or 64 accumulators;
//   * fp32 FMA and expf, no fast-math, no atomics: each element of dQ, dK and
//     dV is summed by one thread in a fixed order, so the result repeats bit
//     for bit.
// Rows in shared memory are padded by one float so that a half-warp reading
// 16 rows at one column hits 16 banks.  Tensor cores (wgmma), TMA and a
// pipelined ring of tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;

// element strides per (batch, seq, head) of q, k, v and dO
struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh;
};

// ROWS x D floats of a (seq, d) slice with row stride rs into shared memory
// rows of pitch D + 1; consecutive threads read consecutive columns.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long rs, int tid) {
  for (int e = tid; e < ROWS * D; e += NTHREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = src[(long long)r * rs + c];
  }
}

// s[i][j] = q_r · k_j and dp[i][j] = dO_r · v_j for the query rows
// r = ty·TM + i and the keys j = tx + 16·jj of the two tiles in shared memory.
template <int D, int TM, int SJ>
__device__ __forceinline__ void logits_and_dp(const float* s_q, const float* s_do,
                                              const float* s_k, const float* s_v, int ty,
                                              int tx, float (&s)[TM][SJ],
                                              float (&dp)[TM][SJ]) {
  constexpr int P = D + 1;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[TM], gv[TM], kv[SJ], vv[SJ];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      qv[i] = s_q[(ty * TM + i) * P + c];
      gv[i] = s_do[(ty * TM + i) * P + c];
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      kv[j] = s_k[(tx + 16 * j) * P + c];
      vv[j] = s_v[(tx + 16 * j) * P + c];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

template <int D, int BM, int BN>
constexpr size_t dkv_smem_floats() {
  return (size_t)(2 * BN + 2 * BM) * (D + 1) + (size_t)2 * BM * (BN + 1) + 2 * BM;
}

template <int D, int BM, int BN>
constexpr size_t dq_smem_floats() {
  return (size_t)(2 * BN + 2 * BM) * (D + 1) + (size_t)BM * (BN + 1);
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          float* __restrict__ dk, float* __restrict__ dv, Strides st, int heads,
                          int n, int m, float sm_scale) {
  constexpr int TM = BM / 16;   // query rows per thread in the recompute
  constexpr int SJ = BN / 16;   // keys per thread in the recompute
  constexpr int TK = BN / 16;   // key rows per thread in the accumulators
  constexpr int TN = D / 16;    // columns per thread in the accumulators
  constexpr int P = D + 1, PS = BN + 1;
  extern __shared__ float smem[];
  float* s_k = smem;               // [BN][D + 1]
  float* s_v = s_k + BN * P;       // [BN][D + 1]
  float* s_q = s_v + BN * P;       // [BM][D + 1]
  float* s_do = s_q + BM * P;      // [BM][D + 1]
  float* s_p = s_do + BM * P;      // [BM][BN + 1]
  float* s_ds = s_p + BM * PS;     // [BM][BN + 1]
  float* s_lse = s_ds + BM * PS;   // [BM]
  float* s_di = s_lse + BM;        // [BM]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int k0 = blockIdx.x * BN;
  const float* qp = q + bi * st.qb + hi * st.qh;
  const float* gp = dout + bi * st.gb + hi * st.gh;
  const float* lp = lse + (long long)bh * n;
  const float* dip = di + (long long)bh * n;

  load_tile<D, BN>(s_k, k + bi * st.kb + hi * st.kh + (long long)k0 * st.kn, st.kn, tid);
  load_tile<D, BN>(s_v, v + bi * st.vb + hi * st.vh + (long long)k0 * st.vn, st.vn, tid);

  float acc_k[TK][TN], acc_v[TK][TN];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BM) {
    __syncthreads();  // the previous tile's readers are done (and K, V are staged)
    load_tile<D, BM>(s_q, qp + (long long)q0 * st.qn, st.qn, tid);
    load_tile<D, BM>(s_do, gp + (long long)q0 * st.gn, st.gn, tid);
    for (int e = tid; e < BM; e += NTHREADS) {
      s_lse[e] = lp[q0 + e];
      s_di[e] = dip[q0 + e];
    }
    __syncthreads();

    float s[TM][SJ], dp[TM][SJ];
    logits_and_dp<D, TM, SJ>(s_q, s_do, s_k, s_v, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      const float row_lse = s_lse[r], row_di = s_di[r];
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float p = expf(s[i][j] * sm_scale - row_lse);
        s_p[r * PS + tx + 16 * j] = p;
        s_ds[r * PS + tx + 16 * j] = p * (dp[i][j] - row_di);
      }
    }
    __syncthreads();

    // dV += Pᵀ dO, then dK += dSᵀ Q, over the tile's queries
#pragma unroll 2
    for (int i = 0; i < BM; ++i) {
      float gv[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) gv[c] = s_do[i * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TK; ++a) {
        const float p = s_p[i * PS + ty * TK + a];
#pragma unroll
        for (int c = 0; c < TN; ++c) acc_v[a][c] = fmaf(p, gv[c], acc_v[a][c]);
      }
    }
#pragma unroll 2
    for (int i = 0; i < BM; ++i) {
      float qv[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) qv[c] = s_q[i * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TK; ++a) {
        const float ds = s_ds[i * PS + ty * TK + a];
#pragma unroll
        for (int c = 0; c < TN; ++c) acc_k[a][c] = fmaf(ds, qv[c], acc_k[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < TK; ++a) {
    const long long row = ((long long)bi * m + k0 + ty * TK + a) * heads + hi;
    float* dkrow = dk + row * D;
    float* dvrow = dv + row * D;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      dkrow[tx + 16 * c] = acc_k[a][c] * sm_scale;
      dvrow[tx + 16 * c] = acc_v[a][c];
    }
  }
}

template <int D, int BM, int BN>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, Strides st, int heads, int n, int m,
                         float sm_scale) {
  constexpr int TM = BM / 16;   // query rows per thread
  constexpr int SJ = BN / 16;   // keys per thread in the recompute
  constexpr int TN = D / 16;    // columns per thread in the accumulator
  constexpr int P = D + 1, PS = BN + 1;
  extern __shared__ float smem[];
  float* s_q = smem;               // [BM][D + 1]
  float* s_do = s_q + BM * P;      // [BM][D + 1]
  float* s_k = s_do + BM * P;      // [BN][D + 1]
  float* s_v = s_k + BN * P;       // [BN][D + 1]
  float* s_ds = s_v + BN * P;      // [BM][BN + 1]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * BM;
  const float* kp = k + bi * st.kb + hi * st.kh;
  const float* vp = v + bi * st.vb + hi * st.vh;

  load_tile<D, BM>(s_q, q + bi * st.qb + hi * st.qh + (long long)q0 * st.qn, st.qn, tid);
  load_tile<D, BM>(s_do, dout + bi * st.gb + hi * st.gh + (long long)q0 * st.gn, st.gn, tid);
  float row_lse[TM], row_di[TM], acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    row_lse[i] = lse[(long long)bh * n + q0 + ty * TM + i];
    row_di[i] = di[(long long)bh * n + q0 + ty * TM + i];
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < m; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO are staged)
    load_tile<D, BN>(s_k, kp + (long long)k0 * st.kn, st.kn, tid);
    load_tile<D, BN>(s_v, vp + (long long)k0 * st.vn, st.vn, tid);
    __syncthreads();

    float s[TM][SJ], dp[TM][SJ];
    logits_and_dp<D, TM, SJ>(s_q, s_do, s_k, s_v, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float p = expf(s[i][j] * sm_scale - row_lse[i]);
        s_ds[(ty * TM + i) * PS + tx + 16 * j] = p * (dp[i][j] - row_di[i]);
      }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float kv[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) kv[c] = s_k[j * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ds = s_ds[(ty * TM + i) * PS + j];
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* dqrow = dq + (((long long)bi * n + q0 + ty * TM + i) * heads + hi) * D;
#pragma unroll
    for (int c = 0; c < TN; ++c) dqrow[tx + 16 * c] = acc[i][c] * sm_scale;
  }
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *di;
  float *dq, *dk, *dv;
  Strides st;
  int b, heads, n, m;
  float sm_scale;
};

// flash_attn_bwd_dkv_kernel, then flash_attn_bwd_dq_kernel, on one stream;
// returns the first error.
template <int D, int BM, int BN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem_dkv = sizeof(float) * dkv_smem_floats<D, BM, BN>();
  const size_t smem_dq = sizeof(float) * dq_smem_floats<D, BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel<D, BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dkv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel<D, BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dkv_kernel<D, BM, BN><<<dim3(a.m / BN, a.b * a.heads), NTHREADS, smem_dkv,
                                         stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.di, a.dk,
                                                   a.dv, a.st, a.heads, a.n, a.m, a.sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dq_kernel<D, BM, BN><<<dim3(a.n / BM, a.b * a.heads), NTHREADS, smem_dq,
                                        stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.di, a.dq,
                                                  a.st, a.heads, a.n, a.m, a.sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, dout: (b, n, heads, d); k, v: (b, m, heads, d); float32 on the current
// device, element strides per (batch, seq, head), unit stride along d.  lse
// and di: contiguous (b, heads, n).  dq: contiguous (b, n, heads, d); dk and
// dv: contiguous (b, m, heads, d).  n and m multiples of 128.  Launches
// flash_attn_bwd_dkv_kernel, then flash_attn_bwd_dq_kernel, on the stream and
// returns the first launch error (cudaSuccess = 0).
int flash_attn_bwd(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* di, float* dq, float* dk, float* dv,
                   long long qb, long long qn, long long qh, long long kb, long long kn,
                   long long kh, long long vb, long long vn, long long vh, long long gb,
                   long long gn, long long gh, int b, int heads, int n, int m, int d,
                   float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, di, dq, dk, dv,
               Strides{qb, qn, qh, kb, kn, kh, vb, vn, vh, gb, gn, gh}, b, heads, n, m, sm_scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 128 != 0 || m % 128 != 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return (int)launch<64, 64, 64>(a, s);
    case 128: return (int)launch<128, 64, 64>(a, s);
    case 512: return (int)launch<512, 32, 16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
