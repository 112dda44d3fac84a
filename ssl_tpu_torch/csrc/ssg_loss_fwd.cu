// K1: fused masked-dense SSL-loss forward, hand-written for Hopper (sm_90a).
//
// Replaces ssl_tpu/ops/ssg_pallas.py::_make_kernel (the Pallas kernel that
// _pallas_forward launches through pl.pallas_call).  Same contract as its
// plain PyTorch version, ssl_tpu_torch/ops/ssg.py::ssl_loss_sums_reference:
// for every image pair (sr, gt), reflect-padded by p = search/2 outside this
// kernel, and every search offset d in [-p, p]^2, the windowed SSD with the
// out-of-patch rule
//     S_d = box9(C2) + rect_d(D_d - C2),  D_d = sum_c (P - P_d)^2,  C2 = sum_c P^2,
// where rect_d sums over the clipped window rectangle [a_y, b_y] x [a_x, b_x];
// q_d = exp(-(S_d / (c window^2)) / sigma).  Sweep 1 sums q_d per pixel into
// inv = 1 / (sum_d q_d + 1e-10); sweep 2 accumulates the masked sums
// |x - y| and y (log y - log x) (clamp 1e-10) with x = q_sr inv_sr,
// y = q_gt inv_gt, the mask count, and the backward helpers
// a_map = sum_d sign(x - y) x and b_map = sum_d y [x > 1e-10].
//
// What bounds it on this card: operations.  At the main path's shapes
// (b16, 3x128^2, search 25, window 9) it reads and writes ~14 MB but does
// ~1e10 fp32 operations and ~1e9 exp/log over 2 images x 2 sweeps x
// b h w x 625 pixel-offsets.  Nothing it computes per offset needs to leave
// the SM, so the design keeps every intermediate in shared memory and
// registers and spends device memory traffic only on the inputs and outputs:
//   * one block per (image, 16x16 output tile), 256 threads, one per pixel;
//   * the tile plus a halo of p of both padded images is staged once in
//     shared memory (the out-of-patch rule keeps every shifted read inside
//     tile +- p), with C2 over tile +- k and each pixel's box9(C2) computed
//     once;
//   * per offset: E = D_d - C2 over the rectangle's rows and columns of
//     tile +- k, a vertical then a horizontal box-sum in shared memory (the
//     order of the banded products By E Bx^T of the plain version), then exp;
//   * a pixel's inverse depends only on its own search^2 values of q, so both
//     sweeps stay inside one block and the per-pixel sums live in registers;
//   * per-block partial sums of l1, kl and count go to a buffer in a fixed
//     reduction order and are summed afterwards: no float atomics, so the
//     result is deterministic.
// expf/logf (not the __expf intrinsics) and no fast-math keep it near the
// CPU reference.  Making it fast (fewer shared-memory passes per offset,
// running box-sums across offsets) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int NTHREADS = TILE * TILE;

struct Geom {
  int c, search, p, k;
  int T;   // staged tile edge: TILE + 2p
  int R;   // D / C2 region edge: TILE + 2k
  float norm, sigma;
};

// q of sr and gt at this thread's pixel for offset index s.  Every thread of
// the block must call it (it synchronises).
__device__ __forceinline__ void offset_q(int s, const Geom& g, const float* s_img,
                                         const float* s_c2, float* s_e, float* s_v,
                                         int tid, int ty, int tx, float box_sr,
                                         float box_gt, float& q_sr, float& q_gt) {
  const int p = g.p, k = g.k, T = g.T, R = g.R, c = g.c;
  const int TT = T * T, RR = R * R;
  const int dy = s / g.search - p, dx = s % g.search - p;
  const int a_y = max(-k, -p - dy), b_y = min(k, p - dy);
  const int a_x = max(-k, -p - dx), b_x = min(k, p - dx);
  const int r_lo = k + a_y, r_hi = TILE - 1 + k + b_y;
  const int c_lo = k + a_x, c_hi = TILE - 1 + k + b_x;

  // E = D_d - C2 on the rows and columns the clipped rectangles touch
  for (int e = tid; e < RR; e += NTHREADS) {
    const int r = e / R, col = e % R;
    if (r < r_lo || r > r_hi || col < c_lo || col > c_hi) continue;
    const int ic = (r + p - k) * T + (col + p - k);
    const int is = ic + dy * T + dx;
    float ds = 0.f, dg = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float u = s_img[ch * TT + ic] - s_img[ch * TT + is];
      ds += u * u;
      const float v = s_img[(c + ch) * TT + ic] - s_img[(c + ch) * TT + is];
      dg += v * v;
    }
    s_e[e] = ds - s_c2[e];
    s_e[RR + e] = dg - s_c2[RR + e];
  }
  __syncthreads();

  // vertical box-sum over [a_y, b_y] for each output row
  for (int e = tid; e < TILE * R; e += NTHREADS) {
    const int t = e / R, col = e % R;
    if (col < c_lo || col > c_hi) continue;
    float vs = 0.f, vg = 0.f;
    for (int r = t + k + a_y; r <= t + k + b_y; ++r) {
      vs += s_e[r * R + col];
      vg += s_e[RR + r * R + col];
    }
    s_v[e] = vs;
    s_v[TILE * R + e] = vg;
  }
  __syncthreads();

  // horizontal box-sum over [a_x, b_x] at this thread's pixel
  float rs = 0.f, rg = 0.f;
  for (int col = tx + k + a_x; col <= tx + k + b_x; ++col) {
    rs += s_v[ty * R + col];
    rg += s_v[TILE * R + ty * R + col];
  }
  q_sr = expf(-((rs + box_sr) / g.norm) / g.sigma);
  q_gt = expf(-((rg + box_gt) / g.norm) / g.sigma);
}

// Deterministic block sum: warp shuffles, then warp 0 over the warp sums.
__device__ __forceinline__ float block_sum(float v, float* s_red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < NTHREADS / 32; ++i) total += s_red[i];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(NTHREADS)
ssg_loss_fwd_kernel(const float* __restrict__ psr, const float* __restrict__ pgt,
                    const float* __restrict__ mask, float* __restrict__ partial,
                    float* __restrict__ inv_sr_out, float* __restrict__ inv_gt_out,
                    float* __restrict__ a_out, float* __restrict__ b_out,
                    int c, int h, int w, int search, int window, float sigma,
                    int generalization) {
  extern __shared__ float smem[];
  __shared__ float s_red[NTHREADS / 32];

  Geom g;
  g.c = c;
  g.search = search;
  g.p = search / 2;
  g.k = window / 2;
  g.T = TILE + 2 * g.p;
  g.R = TILE + 2 * g.k;
  g.norm = (float)c * (float)window * (float)window;
  g.sigma = sigma;
  const int p = g.p, k = g.k, T = g.T, R = g.R;
  const int TT = T * T, RR = R * R;
  const int hp = h + 2 * p, wp = w + 2 * p;

  float* s_img = smem;               // [2][c][T][T]: sr then gt
  float* s_c2 = s_img + 2 * c * TT;  // [2][R][R]
  float* s_e = s_c2 + 2 * RR;        // [2][R][R]
  float* s_v = s_e + 2 * RR;         // [2][TILE][R]

  const int img = blockIdx.z;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, ty = tid / TILE, tx = tid % TILE;
  const int y = y0 + ty, x = x0 + tx;
  const bool valid = y < h && x < w;

  // stage s_img[.][ch][i][j] = P[img][ch][y0 + i][x0 + j], zero past the edge
  const size_t img_off = (size_t)img * c * hp * wp;
  for (int e = tid; e < c * TT; e += NTHREADS) {
    const int ch = e / TT, rem = e % TT, i = rem / T, j = rem % T;
    const int u = y0 + i, v = x0 + j;
    const bool in = u < hp && v < wp;
    const size_t off = img_off + ((size_t)ch * hp + u) * wp + v;
    s_img[e] = in ? psr[off] : 0.f;
    s_img[c * TT + e] = in ? pgt[off] : 0.f;
  }
  __syncthreads();

  // C2 = sum_c P^2 over tile +- k (region row r is padded row y0 + r + p - k)
  for (int e = tid; e < RR; e += NTHREADS) {
    const int r = e / R, col = e % R;
    const int idx = (r + p - k) * T + (col + p - k);
    float a = 0.f, b = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float u = s_img[ch * TT + idx];
      a += u * u;
      const float v = s_img[(c + ch) * TT + idx];
      b += v * v;
    }
    s_c2[e] = a;
    s_c2[RR + e] = b;
  }
  __syncthreads();

  // full window x window box of C2 at this pixel: columns of row sums
  float box_sr = 0.f, box_gt = 0.f;
  for (int col = tx; col <= tx + 2 * k; ++col) {
    float vs = 0.f, vg = 0.f;
    for (int r = ty; r <= ty + 2 * k; ++r) {
      vs += s_c2[r * R + col];
      vg += s_c2[RR + r * R + col];
    }
    box_sr += vs;
    box_gt += vg;
  }

  const int n2 = search * search;
  float inv_sr = 1.f, inv_gt = 1.f;
  if (generalization) {
    float r_sr = 0.f, r_gt = 0.f;
    for (int s = 0; s < n2; ++s) {
      float q_sr, q_gt;
      offset_q(s, g, s_img, s_c2, s_e, s_v, tid, ty, tx, box_sr, box_gt, q_sr, q_gt);
      r_sr += q_sr;
      r_gt += q_gt;
    }
    inv_sr = 1.f / (r_sr + 1e-10f);
    inv_gt = 1.f / (r_gt + 1e-10f);
  }

  const size_t pix = ((size_t)img * h + y) * w + x;
  const float m = valid ? mask[pix] : 0.f;
  float l1 = 0.f, kl = 0.f, a_acc = 0.f, b_acc = 0.f;
  for (int s = 0; s < n2; ++s) {
    float q_sr, q_gt;
    offset_q(s, g, s_img, s_c2, s_e, s_v, tid, ty, tx, box_sr, box_gt, q_sr, q_gt);
    if (!valid) continue;
    const float xv = q_sr * inv_sr, yv = q_gt * inv_gt;
    const float d = xv - yv;
    l1 += m * fabsf(d);
    const float xs = fmaxf(xv, 1e-10f), ys = fmaxf(yv, 1e-10f);
    kl += m * (ys * (logf(ys) - logf(xs)));
    a_acc += d > 0.f ? xv : (d < 0.f ? -xv : 0.f);
    b_acc += xv > 1e-10f ? yv : 0.f;
  }

  if (valid) {
    inv_sr_out[pix] = inv_sr;
    inv_gt_out[pix] = inv_gt;
    a_out[pix] = a_acc;
    b_out[pix] = b_acc;
  }
  const float l1_blk = block_sum(l1, s_red);
  const float kl_blk = block_sum(kl, s_red);
  const float cnt_blk = block_sum(m, s_red);
  if (tid == 0) {
    const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[3 * blk + 0] = l1_blk;
    partial[3 * blk + 1] = kl_blk;
    partial[3 * blk + 2] = cnt_blk;
  }
}

size_t smem_bytes(int c, int search, int window) {
  const int T = TILE + 2 * (search / 2), R = TILE + 2 * (window / 2);
  return sizeof(float) * ((size_t)2 * c * T * T + 4 * R * R + 2 * TILE * R);
}

}  // namespace

extern "C" {

// Number of blocks the launch uses, i.e. rows of `partial` (each holds l1, kl, count).
int ssg_loss_fwd_blocks(int b, int h, int w) {
  return b * ((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE);
}

const char* ssg_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// psr, pgt: (b, c, h + 2p, w + 2p) reflect-padded; mask: (b, h, w);
// partial: (blocks, 3); inv_sr, inv_gt, a_map, b_map: (b, h, w).  All float32,
// contiguous, on the current device.  Returns cudaGetLastError() after the launch.
int ssg_loss_fwd(const float* psr, const float* pgt, const float* mask, float* partial,
                 float* inv_sr, float* inv_gt, float* a_map, float* b_map, int b, int c,
                 int h, int w, int search, int window, float sigma, int generalization,
                 void* stream) {
  const size_t smem = smem_bytes(c, search, window);
  cudaError_t err = cudaFuncSetAttribute(
      ssg_loss_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, b);
  ssg_loss_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      psr, pgt, mask, partial, inv_sr, inv_gt, a_map, b_map, c, h, w, search, window,
      sigma, generalization);
  return (int)cudaGetLastError();
}

}  // extern "C"
