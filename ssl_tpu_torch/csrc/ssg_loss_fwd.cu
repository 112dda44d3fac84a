// K1: fused masked-dense SSL-loss forward, hand-written for Hopper (sm_90a).
//
// Replaces ssl_tpu/ops/ssg_pallas.py::_make_kernel (the Pallas kernel that
// _pallas_forward launches through pl.pallas_call).  Same contract as its
// plain PyTorch version, ssl_tpu_torch/ops/ssg.py::ssl_loss_sums_reference:
// for every image pair (sr, gt), reflect-padded by p = search/2 outside this
// kernel, and every search offset d in [-p, p]^2, the windowed SSD with the
// out-of-patch rule
//     S_d = box(C2) + rect_d(D_d - C2),  D_d = sum_c (P - P_d)^2,  C2 = sum_c P^2,
// where box sums the window x window cells around a pixel and rect_d the
// clipped rectangle [a_y, b_y] x [a_x, b_x] of them; q_d = exp(-(S_d /
// (c window^2)) / sigma).  Sweep 1 sums q_d per pixel into inv = 1 / (sum_d
// q_d + 1e-10); sweep 2 accumulates the masked sums |x - y| and y (log y -
// log x) (clamp 1e-10) with x = q_sr inv_sr, y = q_gt inv_gt, the mask count,
// and the backward helpers a_map = sum_d sign(x - y) x and b_map = sum_d y
// [x > 1e-10].
//
// What bounds it on this card: operations.  At the main path's shapes
// (b16, 3x128^2 and b2, 3x512^2; search 25, window 9) it reads and writes a
// few MB but does ~1e10 fp32 operations and ~1e9 exp/log over 2 images x 2
// sweeps x b h w x 625 pixel-offsets.  Nothing it computes per offset needs
// to leave the SM: every intermediate stays in shared memory and registers.
// The design brings the work per pixel-offset down to a constant number of
// shared-memory passes:
//   * one block of NWARPS warps per (image, tile of TH x 32 pixels), TH = 32
//     - 2k (k = window/2), so that the tile's rows with their k-row halo are
//     32 region rows, one per lane.  The tile plus a halo of p of both padded
//     images is staged once; C2 over the region and its full-width window
//     row sums H9 are computed once;
//   * the offsets are owned by warps (warp w takes d = w, w + NWARPS, ...),
//     each with private scratch: no block-wide barrier per offset, only
//     __syncwarp between its two passes;
//   * pass 1, lane = region row: D along the row, and a running window sum
//     over the rect's columns (one add and one subtract per column, the
//     leaving value read back from the lane's own row of scratch);
//   * pass 2, lane = tile column: a running sum down the column over the
//     rect's rows (one add and one subtract per row), then exp.  Both running
//     sums restart at every tile and offset;
//   * S_d is taken as rect_d(D_d) + (the window's cells outside the rect)(C2),
//     the same sum of cells as the plain version's box(C2) + rect_d(D_d -
//     C2) without its cancellation of two boxes of C2 (~70 at the test
//     images): the window sums carry D's own magnitude.  The cells outside
//     the rect (offsets with |d| > p - k along an axis) are added directly,
//     at most k row sums H9 and k cells of C2 a row;
//   * each warp sums q (sweep 1) or the a and b maps (sweep 2) per pixel in
//     registers over its offsets; the warps' partial maps are added in warp
//     order once per sweep, and l1, kl and the count go to per-block
//     partials in a fixed order: no float atomics, so the result is
//     deterministic.
//   * q = expf(e) with e = -S / (c window^2 sigma) (one multiply by the
//     rounded constant); sweep 2 takes log x as e + log inv_sr (log inv once
//     per pixel) where x > 1e-10, else the clamp's log, instead of two logf
//     per pixel-offset: the same value up to float rounding.
//   * the running sums of both passes are kept in double and rounded once
//     per output: a float running sum carries the rounding of the largest
//     sums that passed through it (on an SR of std ~9 those reach 1e5 and
//     more) into a small window sum, where q = exp(-S / 0.972) turns an
//     absolute error of S into a relative one of q.  In double that error is
//     below 1e-10 whatever passed, and S carries only its own float rounding.
// expf/logf (not the __expf intrinsics) and no fast-math keep it near the
// CPU reference.
//
// Two modes mirror ssl_tpu/ops/ssg.py's bf16 knobs (template parameters, one
// kernel each):
//   * STREAM16 (SSGConfig.stream_dtype = bfloat16): the staged images are
//     rounded to bf16 after C2 and H9 are taken from the float32 values, and
//     each channel difference of D is rounded to bf16 before it is squared
//     in float32 (exactly: a bf16 value squares exactly in float32), which is
//     what XLA compiles jnp.sum((P - P_d) ** 2, dtype=float32) on bf16 P to;
//   * STORE16 (SSGConfig.q_store_dtype = bfloat16, the JAX stored route):
//     two kernels, the walk and the stream.  The walk is sweep 1 alone: it
//     sums the float32 q into inv_sr and inv_gt and writes, for every
//     pixel-offset, the stored route's encoding to a stack in device memory
//     (ssl_tpu/ops/ssg.py::_q_stack): bf16(q_sr) and bf16(q_sr - q_gt), the
//     difference taken in float32, as one bf16 pair a pixel, offset-major,
//     [n2][b][h][w][2].  A warp's store of one tile row is 32 consecutive
//     4-byte pairs, and the stream's load of 32 neighbouring pixels at one
//     offset the same 128 bytes: both coalesced.  The stack is the search^2 x
//     2b x h x w bf16 values that losses/ssl_loss.py::dense_route budgets for
//     the stored route (0.98 GB at b24, 3x128^2); the wrapper allocates it
//     and frees it when the call returns.  The stream
//     (ssg_loss_fwd_stream_kernel) replaces sweep 2 by one pass over the
//     stack, one thread a pixel, the offsets in order: it decodes q_gt =
//     max(q_sr' - diff', 0) (_q_decode), takes x, y, the masked sums and the
//     maps from the decoded values, with log x and log y from logf of them,
//     and writes per-block partials of l1, kl and the count, summed in a
//     fixed order.  It moves ~2 bytes a value twice (written by the walk,
//     read by the stream) instead of a second walk over the offsets.
//   * with both (bench.py's defaults) the walk stages SR and GT as bf16x2
//     pairs (one 4-byte cell a position holds both images' rounded value; C2
//     and H9 come from the float32 images in device memory): pass 1 reads a
//     cell and its shifted cell and takes both images' channel difference
//     with one __hsub2, which rounds each exact difference once, the value
//     of round_bf16 of the float32 difference (the 8-warp float-staged walk
//     writes the same stack, bit for bit, on an H100).  That halves pass 1's
//     shared loads and the staged images, and with sweep 2's per-row maps
//     gone the walk runs 16 warps a block: 128 registers a thread (ptxas, no
//     spills) and 226 KB of shared memory, one block and 16 warps an SM
//     where the other instantiations run 8.  The store mode alone (float32
//     stream) stages float32 planes, which leave no room for 16 warps' rows.
// The walk's launch geometry (tile, grid, shared memory) is mirrored by
// ssl_tpu_torch/ops/ssg_cuda.py::k1_launch, which the wrapper checks against
// ssg_loss_fwd_blocks and ssg_loss_fwd_smem_bytes; the stream's by
// k1_stream_launch, checked against ssg_loss_fwd_stream_blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;                  // tile columns: one per lane
constexpr int REGION_ROWS = 32;             // tile rows + 2k: one per lane
constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
const float kLogClamp = -23.02585093f;   // logf(1e-10f)

// The bf16 stream + store mode's walk stages SR and GT as bf16x2 pairs (one
// 4-byte cell holds both images' value, so one load and one __hsub2 give
// both images' channel difference) and runs WALK16_WARPS warps; every other
// instantiation stages float32 planes and runs NWARPS.
constexpr int WALK16_WARPS = 16;
template <bool STREAM16, bool STORE16>
constexpr bool kPairs = STREAM16 && STORE16;
template <bool STREAM16, bool STORE16>
constexpr int kWarps = kPairs<STREAM16, STORE16> ? WALK16_WARPS : NWARPS;

// Shared-memory layout, in floats, of a block (every pitch odd, so that a
// warp whose lanes walk 32 rows in step hits 32 banks).  ``pairs``: the
// images as bf16x2 cells and only the inverse maps (the walk of the bf16
// stream + store mode).
struct Layout {
  int c, p, k, th, warps;   // channels, search and window halves, tile rows, warps
  int ip, irows;            // staged images: pitch and rows
  int cp, hp, dp;           // pitches of C2, of H9, of the rows of D and H1
  int img, c2, h9, maps, red, scratch, warp, total;   // offsets and sizes
  __host__ __device__ Layout(int c_, int search, int window, bool pairs = false) {
    c = c_;
    p = search / 2;
    k = window / 2;
    th = REGION_ROWS - 2 * k;
    warps = pairs ? WALK16_WARPS : NWARPS;
    ip = TILE_W + 2 * p + 1;
    irows = th + 2 * p;
    cp = TILE_W + 2 * k + 1;
    hp = TILE_W + 1;
    dp = cp;
    img = 0;                                        // [2][c][irows][ip]: sr then gt, or
                                                    // [c][irows][ip] (sr, gt) pairs
    c2 = img + (pairs ? 1 : 2) * c * irows * ip;    // [2][32][cp] C2 over the region
    h9 = c2 + 2 * REGION_ROWS * cp;                 // [2][32][hp] full-window row sums of C2
    maps = h9 + 2 * REGION_ROWS * hp;               // [5][th][32] inv_sr, inv_gt, mask, log
                                                    // invs (the pairs' walk: the first two)
    red = maps + (pairs ? 2 : 5) * th * TILE_W;     // [3][warps] block sums
    scratch = red + 3 * warps;                      // [warps][warp]
    warp = 2 * REGION_ROWS * dp;                    // a row of D, then H1, per image and lane
    total = scratch + warps * warp;
  }
};

struct Offset {
  int dy, dx, ay, by, ax, bx;   // shift and clipped rectangle
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ Offset offset_of(int s, int search, int p, int k) {
  Offset o;
  o.dy = s / search - p;
  o.dx = s % search - p;
  o.ay = max(-k, -p - o.dy);
  o.by = min(k, p - o.dy);
  o.ax = max(-k, -p - o.dx);
  o.bx = min(k, p - o.dx);
  return o;
}

// Pass 1 for one offset, lane = region row rho, both images at once: D
// along the row into the lane's row buffer, and its running sum over the
// rect's wx columns; output x (plus C2 at the window's columns outside the
// rect) goes to position x of the same buffer, whose D there has been read
// for the last time (x <= x + k + ax, the column leaving the window, and
// every later output lies left of every later leaving column).  Rows
// outside the rect's reach are skipped.  C: channels (0: L.c at run time); STREAM16:
// D's channel differences rounded to bf16.
template <int C, bool STREAM16, bool PAIRS = false>
__device__ __forceinline__ void pass_rows(const Layout& L, const float* smem, float* rows,
                                          const Offset& o, int lane) {
  const int rho = lane, k = L.k, nch = C ? C : L.c;
  if (rho < k + o.ay || rho > L.th - 1 + k + o.by) return;
  const int c_lo = k + o.ax, c_hi = TILE_W - 1 + k + o.bx, wx = o.bx - o.ax + 1;
  const bool clipped = o.ax > -k || o.bx < k;
  const int plane = L.irows * L.ip;
  const float* p0 = smem + L.img + (rho + L.p - k) * L.ip + (L.p - k);   // sr at region (rho, 0)
  const float* p1 = p0 + L.c * plane;                                    // gt
  const __nv_bfloat162* q01 = reinterpret_cast<const __nv_bfloat162*>(p0);  // (sr, gt) cells
  const int shift = o.dy * L.ip + o.dx;
  float* r0 = rows + rho * L.dp;
  float* r1 = r0 + REGION_ROWS * L.dp;
  const float* c2r0 = smem + L.c2 + rho * L.cp;
  const float* c2r1 = c2r0 + REGION_ROWS * L.cp;
  double run0 = 0.0, run1 = 0.0;
#pragma unroll 2
  for (int col = c_lo; col <= c_hi; ++col) {
    // the values that leave the window at this column, read before anything
    // is stored here so that the loads overlap the D below (wx = 1: D itself)
    const bool full = col >= c_lo + wx - 1;
    const int leave = col - wx + 1;
    const float l0 = full && wx > 1 ? r0[leave] : 0.f;
    const float l1 = full && wx > 1 ? r1[leave] : 0.f;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int ch = 0; ch < nch; ++ch) {
      float u0, u1;
      if (PAIRS) {   // both images' bf16 difference, each rounded once: round_bf16's value
        const __nv_bfloat162 u = __hsub2(q01[ch * plane + col], q01[ch * plane + col + shift]);
        u0 = __low2float(u);
        u1 = __high2float(u);
      } else {
        u0 = p0[ch * plane + col] - p0[ch * plane + col + shift];
        u1 = p1[ch * plane + col] - p1[ch * plane + col + shift];
        if (STREAM16) {
          u0 = round_bf16(u0);
          u1 = round_bf16(u1);
        }
      }
      d0 += u0 * u0;
      d1 += u1 * u1;
    }
    r0[col] = d0;
    r1[col] = d1;
    run0 += d0;
    run1 += d1;
    if (full) {
      const int x = col - k - o.bx;
      float h0 = (float)run0, h1v = (float)run1;
      run0 -= wx > 1 ? l0 : d0;
      run1 -= wx > 1 ? l1 : d1;
      if (clipped) {
        for (int v = -k; v < o.ax; ++v) {
          h0 += c2r0[x + k + v];
          h1v += c2r1[x + k + v];
        }
        for (int v = o.bx + 1; v <= k; ++v) {
          h0 += c2r0[x + k + v];
          h1v += c2r1[x + k + v];
        }
      }
      r0[x] = h0;
      r1[x] = h1v;
    }
  }
}

// Pass 2 for one offset, lane = tile column x: the running sum over the
// rect's rows of H1 (plus the window's rows outside the rect from H9) gives
// S at each tile row y; visit(y, e_sr, e_gt) takes the exponents e = -S /
// (c window^2 sigma) of q = exp(e) there.  The loop runs
// over all 32 rows with the rows past the tile skipped, so that y is known
// at compile time and the callers' per-row sums stay in registers.
template <typename Visit>
__device__ __forceinline__ void pass_columns(const Layout& L, const float* smem, const float* rows,
                                             const Offset& o, int x, float neg_inv, Visit visit) {
  const int k = L.k;
  const bool clipped = o.ay > -k || o.by < k;
  const float* col0 = rows + x;
  const float* col1 = col0 + REGION_ROWS * L.dp;
  const float* h90 = smem + L.h9 + x;
  const float* h91 = h90 + REGION_ROWS * L.hp;
  double run0 = 0.0, run1 = 0.0;
  for (int r = k + o.ay; r < k + o.by; ++r) {
    run0 += col0[r * L.dp];
    run1 += col1[r * L.dp];
  }
#pragma unroll
  for (int y = 0; y < REGION_ROWS; ++y) {
    if (y < L.th) {
      run0 += col0[(y + k + o.by) * L.dp];
      run1 += col1[(y + k + o.by) * L.dp];
      float s0 = (float)run0, s1 = (float)run1;
      if (clipped) {
        for (int u = -k; u < o.ay; ++u) {
          s0 += h90[(y + k + u) * L.hp];
          s1 += h91[(y + k + u) * L.hp];
        }
        for (int u = o.by + 1; u <= k; ++u) {
          s0 += h90[(y + k + u) * L.hp];
          s1 += h91[(y + k + u) * L.hp];
        }
      }
      run0 -= col0[(y + k + o.ay) * L.dp];
      run1 -= col1[(y + k + o.ay) * L.dp];
      visit(y, s0 * neg_inv, s1 * neg_inv);
    }
  }
}

// Deterministic block sum of one value per thread: warp shuffles, then
// thread 0 over the warp sums in order.  Every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* s_red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < NWARPS; ++i) total += s_red[i];
  __syncthreads();
  return total;
}

template <int C, bool STREAM16, bool STORE16>
__global__ void __launch_bounds__(32 * kWarps<STREAM16, STORE16>)
ssg_loss_fwd_kernel(const float* __restrict__ psr, const float* __restrict__ pgt,
                    const float* __restrict__ mask, float* __restrict__ partial,
                    float* __restrict__ inv_sr_out, float* __restrict__ inv_gt_out,
                    float* __restrict__ a_out, float* __restrict__ b_out,
                    __nv_bfloat162* __restrict__ stack, int c, int h, int w, int search,
                    int window, float sigma, int generalization) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool PAIRS = kPairs<STREAM16, STORE16>;
  constexpr int WARPS = kWarps<STREAM16, STORE16>, THREADS = 32 * WARPS;
  const Layout L(c, search, window, PAIRS);
  const int p = L.p, k = L.k, th = L.th;
  const int hp = h + 2 * p, wp = w + 2 * p;
  // q = exp(-S / (c window^2 sigma)), one multiply by the rounded constant
  const float neg_inv = -1.f / ((float)c * (float)window * (float)window * sigma);
  const int n2 = search * search;

  const int img = blockIdx.z;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* s_inv_sr = smem + L.maps;
  float* s_inv_gt = s_inv_sr + th * TILE_W;
  float* s_mask = s_inv_gt + th * TILE_W;      // (the walk of STORE16 reads no mask)
  float* s_log_inv_sr = s_mask + th * TILE_W;
  float* s_log_inv_gt = s_log_inv_sr + th * TILE_W;
  float* rows = smem + L.scratch + warp * L.warp;

  // stage both padded images over tile +- p (zero past the edge) and the mask
  const size_t img_off = (size_t)img * c * hp * wp;
  const int plane = L.irows * L.ip;
  for (int e = tid; e < c * L.irows * (TILE_W + 2 * p); e += THREADS) {
    const int cols = TILE_W + 2 * p;
    const int ch = e / (L.irows * cols), rem = e % (L.irows * cols);
    const int i = rem / cols, j = rem % cols;
    const int u = y0 + i, v = x0 + j;
    const bool in = u < hp && v < wp;
    const size_t off = img_off + ((size_t)ch * hp + u) * wp + v;
    if (PAIRS) {
      reinterpret_cast<__nv_bfloat162*>(smem + L.img)[ch * plane + i * L.ip + j] =
          __floats2bfloat162_rn(in ? psr[off] : 0.f, in ? pgt[off] : 0.f);
    } else {
      smem[L.img + ch * plane + i * L.ip + j] = in ? psr[off] : 0.f;
      smem[L.img + (c + ch) * plane + i * L.ip + j] = in ? pgt[off] : 0.f;
    }
  }
  if (!STORE16) {   // the walk leaves the mask to the stream
    for (int e = tid; e < th * TILE_W; e += THREADS) {
      const int y = y0 + e / TILE_W, x = x0 + e % TILE_W;
      s_mask[e] = (y < h && x < w) ? mask[((size_t)img * h + y) * w + x] : 0.f;
    }
  }
  __syncthreads();

  // C2 over the region (rows tile +- k, columns tile +- k), then H9; the
  // pairs' walk takes C2 from the float32 images in device memory
  const int rcols = TILE_W + 2 * k;
  for (int e = tid; e < 2 * REGION_ROWS * rcols; e += THREADS) {
    const int im = e / (REGION_ROWS * rcols), rem = e % (REGION_ROWS * rcols);
    const int r = rem / rcols, col = rem % rcols;
    float a = 0.f;
    if (PAIRS) {
      const int u = y0 + r + p - k, v = x0 + col + p - k;
      if (u < hp && v < wp) {
        const float* P = (im ? pgt : psr) + img_off + (size_t)u * wp + v;
        for (int ch = 0; ch < c; ++ch) a += P[(size_t)ch * hp * wp] * P[(size_t)ch * hp * wp];
      }
    } else {
      const float* P = smem + L.img + im * c * plane + (r + p - k) * L.ip + (col + p - k);
      for (int ch = 0; ch < c; ++ch) a += P[ch * plane] * P[ch * plane];
    }
    smem[L.c2 + (im * REGION_ROWS + r) * L.cp + col] = a;
  }
  __syncthreads();
  for (int e = tid; e < 2 * REGION_ROWS * TILE_W; e += THREADS) {
    const int im = e / (REGION_ROWS * TILE_W), rem = e % (REGION_ROWS * TILE_W);
    const int r = rem / TILE_W, x = rem % TILE_W;
    const float* row = smem + L.c2 + (im * REGION_ROWS + r) * L.cp + x;
    float a = 0.f;
    for (int v = 0; v <= 2 * k; ++v) a += row[v];
    smem[L.h9 + (im * REGION_ROWS + r) * L.hp + x] = a;
  }
  __syncthreads();
  if (STREAM16 && !PAIRS) {   // C2 and H9 keep the float32 values; D streams bf16 ones
    for (int e = tid; e < 2 * c * plane; e += THREADS) smem[L.img + e] = round_bf16(smem[L.img + e]);
    __syncthreads();
  }

  // sweep 1: per-pixel sums of q over this warp's offsets, then over warps;
  // with STORE16 (the walk) also the stack, also without generalization
  float* red = smem + L.scratch;   // [WARPS][2][th][32], over the warps' scratch
  if (generalization || STORE16) {
    float rs[REGION_ROWS], rg[REGION_ROWS];
#pragma unroll
    for (int y = 0; y < REGION_ROWS; ++y) rs[y] = rg[y] = 0.f;
    const bool in_x = x0 + lane < w;
    const size_t plane_px = (size_t)gridDim.z * h * w;   // pixels of one offset's stack plane
    for (int s = warp; s < n2; s += WARPS) {
      const Offset o = offset_of(s, search, p, k);
      pass_rows<C, STREAM16, PAIRS>(L, smem, rows, o, lane);
      __syncwarp();
      // this lane's pixel of tile row 0 in offset s's plane
      __nv_bfloat162* out = STORE16 ? stack + s * plane_px + ((size_t)img * h + y0) * w + x0 + lane
                                    : nullptr;
      pass_columns(L, smem, rows, o, lane, neg_inv, [&](int y, float e_sr, float e_gt) {
        const float q_sr = expf(e_sr), q_gt = expf(e_gt);
        rs[y] += q_sr;
        rg[y] += q_gt;
        if (STORE16 && in_x && y0 + y < h)
          out[(size_t)y * w] = __floats2bfloat162_rn(q_sr, q_sr - q_gt);
      });
      __syncwarp();
    }
    __syncthreads();   // every warp is done with its scratch
#pragma unroll
    for (int y = 0; y < REGION_ROWS; ++y)
      if (y < th) {
        red[((warp * 2 + 0) * th + y) * TILE_W + lane] = rs[y];
        red[((warp * 2 + 1) * th + y) * TILE_W + lane] = rg[y];
      }
    __syncthreads();
    for (int e = tid; e < th * TILE_W; e += THREADS) {
      float a = 0.f, b = 0.f;
      for (int v = 0; v < WARPS; ++v) {
        a += red[(v * 2 + 0) * th * TILE_W + e];
        b += red[(v * 2 + 1) * th * TILE_W + e];
      }
      s_inv_sr[e] = generalization ? 1.f / (a + 1e-10f) : 1.f;
      s_inv_gt[e] = generalization ? 1.f / (b + 1e-10f) : 1.f;
      if (STORE16) {   // the walk's outputs: the inverse maps (and the stack)
        const int y = y0 + e / TILE_W, x = x0 + e % TILE_W;
        if (y < h && x < w) {
          const size_t pix = ((size_t)img * h + y) * w + x;
          inv_sr_out[pix] = s_inv_sr[e];
          inv_gt_out[pix] = s_inv_gt[e];
        }
      }
    }
    if (STORE16) return;   // sweep 2 is the stream kernel's
  } else {
    for (int e = tid; e < th * TILE_W; e += THREADS) s_inv_sr[e] = s_inv_gt[e] = 1.f;
  }
  __syncthreads();
  for (int e = tid; e < th * TILE_W; e += THREADS) {
    s_log_inv_sr[e] = logf(s_inv_sr[e]);
    s_log_inv_gt[e] = logf(s_inv_gt[e]);
  }
  __syncthreads();

  // sweep 2: the masked loss sums per lane, the a and b maps per pixel
  float l1 = 0.f, kl = 0.f;
  {
    float am[REGION_ROWS], bm[REGION_ROWS];
#pragma unroll
    for (int y = 0; y < REGION_ROWS; ++y) am[y] = bm[y] = 0.f;
    for (int s = warp; s < n2; s += NWARPS) {
      const Offset o = offset_of(s, search, p, k);
      pass_rows<C, STREAM16>(L, smem, rows, o, lane);
      __syncwarp();
      pass_columns(L, smem, rows, o, lane, neg_inv, [&](int y, float e_sr, float e_gt) {
        const int e = y * TILE_W + lane;
        const float m = s_mask[e];
        const float q_sr = expf(e_sr), q_gt = expf(e_gt);
        const float xv = q_sr * s_inv_sr[e], yv = q_gt * s_inv_gt[e];
        const float d = xv - yv;
        l1 += m * fabsf(d);
        // log x = e_sr + log inv_sr where x > 1e-10, else the clamp's log
        const float lx = xv > 1e-10f ? e_sr + s_log_inv_sr[e] : kLogClamp;
        const float ly = yv > 1e-10f ? e_gt + s_log_inv_gt[e] : kLogClamp;
        kl += m * (fmaxf(yv, 1e-10f) * (ly - lx));
        am[y] += d > 0.f ? xv : (d < 0.f ? -xv : 0.f);
        bm[y] += xv > 1e-10f ? yv : 0.f;
      });
      __syncwarp();
    }
    __syncthreads();
#pragma unroll
    for (int y = 0; y < REGION_ROWS; ++y)
      if (y < th) {
        red[((warp * 2 + 0) * th + y) * TILE_W + lane] = am[y];
        red[((warp * 2 + 1) * th + y) * TILE_W + lane] = bm[y];
      }
    __syncthreads();
  }

  float cnt = 0.f;
  for (int e = tid; e < th * TILE_W; e += THREADS) {
    const int y = y0 + e / TILE_W, x = x0 + e % TILE_W;
    cnt += s_mask[e];
    if (y >= h || x >= w) continue;
    float a = 0.f, b = 0.f;
    for (int v = 0; v < NWARPS; ++v) {
      a += red[(v * 2 + 0) * th * TILE_W + e];
      b += red[(v * 2 + 1) * th * TILE_W + e];
    }
    const size_t pix = ((size_t)img * h + y) * w + x;
    inv_sr_out[pix] = s_inv_sr[e];
    inv_gt_out[pix] = s_inv_gt[e];
    a_out[pix] = a;
    b_out[pix] = b;
  }
  float* s_red = smem + L.red;
  const float l1_blk = block_sum(l1, s_red);
  const float kl_blk = block_sum(kl, s_red + NWARPS);
  const float cnt_blk = block_sum(cnt, s_red + 2 * NWARPS);
  if (tid == 0) {
    const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[3 * blk + 0] = l1_blk;
    partial[3 * blk + 1] = kl_blk;
    partial[3 * blk + 2] = cnt_blk;
  }
}

// STORE16's sweep 2: one pass over the walk's stack, one thread a pixel (e
// over b h w), the offsets in order (see the header).  Every sum is taken in
// a fixed order (a thread's over the offsets, block_sum's over the threads),
// so a second launch repeats the first bit for bit.  What bounds it: bytes,
// the 4-byte pair a pixel-offset (~2 logf and ~25 other operations against
// it); the loads go unrolled, so that each thread keeps several in flight.
__global__ void __launch_bounds__(NTHREADS)
ssg_loss_fwd_stream_kernel(const __nv_bfloat162* __restrict__ stack,
                           const float* __restrict__ inv_sr, const float* __restrict__ inv_gt,
                           const float* __restrict__ mask, float* __restrict__ partial,
                           float* __restrict__ a_out, float* __restrict__ b_out, int n2,
                           long long pixels) {
  __shared__ float s_red[3 * NWARPS];
  const long long e = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  float l1 = 0.f, kl = 0.f, cnt = 0.f;
  if (e < pixels) {
    const float isr = inv_sr[e], igt = inv_gt[e], m = mask[e];
    cnt = m;
    float am = 0.f, bm = 0.f;
    const __nv_bfloat162* q = stack + e;
#pragma unroll 8
    for (int s = 0; s < n2; ++s) {
      const __nv_bfloat162 v = __ldcs(q + s * pixels);   // read once: stream past the caches
      const float q_sr = __low2float(v);
      const float q_gt = fmaxf(q_sr - __high2float(v), 0.f);
      const float xv = q_sr * isr, yv = q_gt * igt;
      const float d = xv - yv;
      l1 += m * fabsf(d);
      const float lx = xv > 1e-10f ? logf(xv) : kLogClamp;
      const float ly = yv > 1e-10f ? logf(yv) : kLogClamp;
      kl += m * (fmaxf(yv, 1e-10f) * (ly - lx));
      am += d > 0.f ? xv : (d < 0.f ? -xv : 0.f);
      bm += xv > 1e-10f ? yv : 0.f;
    }
    a_out[e] = am;
    b_out[e] = bm;
  }
  const float l1_blk = block_sum(l1, s_red);
  const float kl_blk = block_sum(kl, s_red + NWARPS);
  const float cnt_blk = block_sum(cnt, s_red + 2 * NWARPS);
  if (threadIdx.x == 0) {
    partial[3 * blockIdx.x + 0] = l1_blk;
    partial[3 * blockIdx.x + 1] = kl_blk;
    partial[3 * blockIdx.x + 2] = cnt_blk;
  }
}

}  // namespace

extern "C" {

// Blocks of a launch, i.e. rows of `partial` (each holds l1, kl, count).
int ssg_loss_fwd_blocks(int b, int h, int w, int window) {
  const int th = REGION_ROWS - 2 * (window / 2);
  return b * ((h + th - 1) / th) * ((w + TILE_W - 1) / TILE_W);
}

// Dynamic shared memory of a launch, in bytes, and its threads a block: the
// walk of the bf16 stream + store mode stages bf16x2 pairs and runs
// WALK16_WARPS warps.
int ssg_loss_fwd_smem_bytes(int c, int search, int window, int stream_bf16, int store_bf16) {
  return (int)sizeof(float) * Layout(c, search, window, stream_bf16 && store_bf16).total;
}
int ssg_loss_fwd_threads(int stream_bf16, int store_bf16) {
  return 32 * (stream_bf16 && store_bf16 ? WALK16_WARPS : NWARPS);
}

const char* ssg_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// psr, pgt: (b, c, h + 2p, w + 2p) reflect-padded; mask: (b, h, w);
// partial: (blocks, 3); inv_sr, inv_gt, a_map, b_map: (b, h, w).  All float32,
// contiguous, on the current device.  window <= 31.  stream_bf16 and
// store_bf16 (0 or 1) pick the mode; the bf16 modes take 3 channels.  With
// store_bf16 this launches the walk alone: it writes inv_sr, inv_gt and
// ``stack`` (search^2 b h w bf16 pairs, ssg_loss_fwd_stream's input) and
// leaves mask, partial, a_map and b_map to ssg_loss_fwd_stream; else stack
// may be null.  Returns cudaGetLastError() after the launch.
int ssg_loss_fwd(const float* psr, const float* pgt, const float* mask, float* partial,
                 float* inv_sr, float* inv_gt, float* a_map, float* b_map, void* stack, int b,
                 int c, int h, int w, int search, int window, float sigma, int generalization,
                 int stream_bf16, int store_bf16, void* stream) {
  if (REGION_ROWS - 2 * (window / 2) < 1) return (int)cudaErrorInvalidValue;
  if (store_bf16 && stack == nullptr) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                          float*, float*, __nv_bfloat162*, int, int, int, int, int, float, int);
  // [stream_bf16][store_bf16] for 3 channels (unrolled); float32 alone for others
  static const Kernel kernels[2][2] = {
      {ssg_loss_fwd_kernel<3, false, false>, ssg_loss_fwd_kernel<3, false, true>},
      {ssg_loss_fwd_kernel<3, true, false>, ssg_loss_fwd_kernel<3, true, true>}};
  if (c != 3 && (stream_bf16 || store_bf16)) return (int)cudaErrorInvalidValue;
  const Kernel kernel =
      c == 3 ? kernels[stream_bf16 != 0][store_bf16 != 0] : ssg_loss_fwd_kernel<0, false, false>;
  const int smem = ssg_loss_fwd_smem_bytes(c, search, window, stream_bf16, store_bf16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int th = REGION_ROWS - 2 * (window / 2);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + th - 1) / th, b);
  kernel<<<grid, ssg_loss_fwd_threads(stream_bf16, store_bf16), smem, (cudaStream_t)stream>>>(
      psr, pgt, mask, partial, inv_sr, inv_gt, a_map, b_map,
      static_cast<__nv_bfloat162*>(stack), c, h, w, search, window, sigma, generalization);
  return (int)cudaGetLastError();
}

// Blocks of a stream launch over ``pixels`` = b h w pixels, i.e. rows of its
// `partial` (each holds l1, kl, count).
int ssg_loss_fwd_stream_blocks(long long pixels) {
  return (int)((pixels + NTHREADS - 1) / NTHREADS);
}

// The bf16 store's sweep 2 over the walk's ``stack`` (n2 = search^2 planes
// of ``pixels`` bf16 pairs): inv_sr, inv_gt (the walk's) and mask in,
// partial (ssg_loss_fwd_stream_blocks(pixels), 3), a_map and b_map out; all
// float32 (b, h, w), contiguous, on the current device.  Returns
// cudaGetLastError() after the launch.
int ssg_loss_fwd_stream(const void* stack, const float* inv_sr, const float* inv_gt,
                        const float* mask, float* partial, float* a_map, float* b_map, int n2,
                        long long pixels, void* stream) {
  if (n2 < 1 || pixels < 1) return (int)cudaErrorInvalidValue;
  ssg_loss_fwd_stream_kernel<<<ssg_loss_fwd_stream_blocks(pixels), NTHREADS, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat162*>(stack), inv_sr, inv_gt, mask, partial, a_map, b_map, n2,
      pixels);
  return (int)cudaGetLastError();
}

}  // extern "C"
