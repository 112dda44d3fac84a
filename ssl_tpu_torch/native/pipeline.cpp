// Host C++ of the port's two-stage degrader (C++17, no dependencies beyond
// the standard library), bound with ctypes by ssl_tpu_torch/native/__init__.py.
//
//   jpeg_roundtrip(_batch): the 8x8 DCT quantisation round trip of the
//     reference's DiffJPEG (ITU-T T.81 Annex K tables, raw table * factor,
//     4:2:0 chroma), one image per thread in the batched form
//   filter2d_reflect_batch: 2-D filtering of HWC float32 images with a
//     k x k kernel each and a reflect-101 border (OpenCV's filter2D with
//     BORDER_REFLECT_101), rows spread over threads
//   jpeg_libjpeg_roundtrip: the baseline JPEG encode and decode that
//     cv2.imencode(".jpg", quality) and cv2.imdecode compute through
//     libjpeg(-turbo) at its defaults (4:2:0, integer "islow" DCTs,
//     fancy upsampling), in libjpeg's integer arithmetic: the BSRGAN
//     degradation's JPEG where cv2 does not import
//
// A copy of the JAX package's host library (ssl_tpu/native/pipeline.cpp),
// which the port does not import; its SSG oracle stays there.  The filter
// makes one reflect-padded copy of each image and skips the kernel's zero
// taps (the per-item kernels are zero-padded to 21 x 21); every output still
// sums its taps in the same order, row by row, so the result is the
// original loop's.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// transposed against Annex K, as the reference DiffJPEG keeps y_table.T
const float kYTable[64] = {
    16, 12, 14, 14, 18, 24, 49, 72, 11, 12, 13, 17, 22, 35, 64, 92,
    10, 14, 16, 22, 37, 55, 78, 95, 16, 19, 24, 29, 56, 64, 87, 98,
    24, 26, 40, 51, 68, 81, 103, 112, 40, 58, 57, 87, 109, 104, 121, 100,
    51, 60, 69, 80, 103, 113, 120, 103, 61, 55, 56, 62, 77, 92, 101, 99};
const float kCTable[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// The 8-point orthonormal DCT-II basis, made once (thread-safe static init).
struct Dct {
  float m[64];
  Dct() {
    for (int k = 0; k < 8; ++k) {
      double s = (k == 0) ? std::sqrt(1.0 / 8.0) : std::sqrt(2.0 / 8.0);
      for (int n = 0; n < 8; ++n)
        m[k * 8 + n] = (float)(s * std::cos((2 * n + 1) * k * M_PI / 16.0));
    }
  }
};

const float* dct() {
  static const Dct table;
  return table.m;
}

// 8x8 block: out = D * in * D^T (forward) or D^T * in * D (inverse)
void dct8x8(const float* in, float* out, bool inverse) {
  const float* d = dct();
  float tmp[64];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = 0;
      for (int k = 0; k < 8; ++k) acc += (inverse ? d[k * 8 + i] : d[i * 8 + k]) * in[k * 8 + j];
      tmp[i * 8 + j] = acc;
    }
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = 0;
      for (int k = 0; k < 8; ++k) acc += tmp[i * 8 + k] * (inverse ? d[k * 8 + j] : d[j * 8 + k]);
      out[i * 8 + j] = acc;
    }
}

void jpeg_channel(float* chan, int h, int w, const float* table, float factor) {
  float q[64];
  // raw table * factor, as the reference DiffJPEG quantises (no libjpeg
  // floor and clip of the table)
  for (int i = 0; i < 64; ++i) q[i] = table[i] * factor;
  float block[64], coef[64];
  for (int by = 0; by < h / 8; ++by)
    for (int bx = 0; bx < w / 8; ++bx) {
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) block[i * 8 + j] = chan[(by * 8 + i) * w + bx * 8 + j] - 128.0f;
      dct8x8(block, coef, false);
      for (int i = 0; i < 64; ++i) coef[i] = std::round(coef[i] / q[i]) * q[i];
      dct8x8(coef, block, true);
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) chan[(by * 8 + i) * w + bx * 8 + j] = block[i * 8 + j] + 128.0f;
    }
}

inline int reflect101(int x, int n) {
  if (n == 1) return 0;
  while (x < 0 || x >= n) {
    if (x < 0) x = -x;
    if (x >= n) x = 2 * n - 2 - x;
  }
  return x;
}

// Runs fn(i) for i in [0, n) on up to n_threads threads, in contiguous chunks.
template <class Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  int nt = std::max(1, std::min(n_threads, n));
  if (nt == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t)
    pool.emplace_back([=]() {
      for (int i = t * per; i < std::min(n, (t + 1) * per); ++i) fn(i);
    });
  for (auto& th : pool) th.join();
}

// ---- libjpeg's baseline codec (jfdctint.c, jidctint.c, jcdctmgr.c,
// jccolor.c, jdcolor.c, jcsample.c, jdsample.c, jcparam.c), integer for
// integer.  Only the parts a round trip at cv2's defaults reaches: 8-bit
// RGB, 2x2 chroma subsampling, the "islow" DCTs, standard tables scaled by
// jpeg_quality_scaling with force_baseline.  Entropy coding is lossless and
// left out: the quantised coefficients go straight to the decoder.

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t kF0298 = 2446, kF0390 = 3196, kF0541 = 4433, kF0765 = 6270, kF0899 = 7373,
                  kF1175 = 9633, kF1501 = 12299, kF1847 = 15137, kF1961 = 16069,
                  kF2053 = 16819, kF2562 = 20995, kF3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// Annex K tables in natural (row-major) order, as jcparam.c holds them
const int kStdLuma[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jpeg_quality_scaling + jpeg_add_quant_table(force_baseline = TRUE)
void quant_table(const int* basic, int quality, int* out) {
  quality = std::min(100, std::max(1, quality));
  const int64_t scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i)
    out[i] = (int)std::min<int64_t>(255, std::max<int64_t>(1, (basic[i] * scale + 50) / 100));
}

// jcdctmgr.c compute_reciprocal with 16-bit DCTELEMs (the SIMD build's):
// round(|x| / divisor) becomes ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // floor(log2(divisor))
  int r = 16 + b;
  uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
  uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jfdctint.c jpeg_fdct_islow: rows, then columns; the output is 8x the DCT
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int k = 0; k < 8; ++k) {
      int32_t* p = d + k * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {  // rows: scaled up by 2^PASS1_BITS; columns: that scale removed
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = (int32_t)((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = (int32_t)descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = (int32_t)descale(tmp10 - tmp11, kPass1Bits);
      }
      int64_t z1 = (tmp12 + tmp13) * kF0541;
      p[2 * step] = (int32_t)descale(z1 + tmp13 * kF0765, odd_shift);
      p[6 * step] = (int32_t)descale(z1 - tmp12 * kF1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * kF1175;
      tmp4 *= kF0298;
      tmp5 *= kF2053;
      tmp6 *= kF3072;
      tmp7 *= kF1501;
      z1 *= -kF0899;
      z2 *= -kF2562;
      z3 = z3 * -kF1961 + z5;
      z4 = z4 * -kF0390 + z5;
      p[7 * step] = (int32_t)descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = (int32_t)descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = (int32_t)descale(tmp6 + z2 + z3, odd_shift);
      p[step] = (int32_t)descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// jdmaster.c's post-IDCT range limit: sample = clamp(x + 128) for the
// masked index x & 1023 (out-of-range values wrap as libjpeg's table does)
inline uint8_t idct_limit(int64_t x) {
  const int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

// jidctint.c jpeg_idct_islow on dequantised coefficients: columns, then rows
void idct_islow(const int32_t* coef, uint8_t* out, int out_stride) {
  int64_t ws[64];
  for (int pass = 0; pass < 2; ++pass) {
    for (int k = 0; k < 8; ++k) {
      int64_t in[8];
      for (int j = 0; j < 8; ++j) in[j] = pass == 0 ? coef[j * 8 + k] : ws[k * 8 + j];
      int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
      int64_t z2 = in[2], z3 = in[6];
      int64_t z1 = (z2 + z3) * kF0541;
      tmp2 = z1 - z3 * kF1847;
      tmp3 = z1 + z2 * kF0765;
      tmp0 = (in[0] + in[4]) * (1 << kConstBits);
      tmp1 = (in[0] - in[4]) * (1 << kConstBits);
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      tmp0 = in[7];
      tmp1 = in[5];
      tmp2 = in[3];
      tmp3 = in[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * kF1175;
      tmp0 *= kF0298;
      tmp1 *= kF2053;
      tmp2 *= kF3072;
      tmp3 *= kF1501;
      z1 *= -kF0899;
      z2 *= -kF2562;
      z3 = z3 * -kF1961 + z5;
      z4 = z4 * -kF0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int64_t o[8] = {tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3};
      for (int j = 0; j < 8; ++j) {
        if (pass == 0)
          ws[j * 8 + k] = descale(o[j], kConstBits - kPass1Bits);  // the zero-AC shortcut agrees
        else
          out[k * out_stride + j] = idct_limit(descale(o[j], kConstBits + kPass1Bits + 3));
      }
    }
  }
}

// One component plane (rows x cols, multiples of 8) through the forward
// DCT, quantisation, dequantisation and inverse DCT, in place.
void code_plane(uint8_t* plane, int rows, int cols, const int* qtable) {
  Divisor div[64];
  for (int i = 0; i < 64; ++i) div[i] = reciprocal((uint32_t)qtable[i] * 8);
  int32_t block[64];
  for (int by = 0; by < rows; by += 8)
    for (int bx = 0; bx < cols; bx += 8) {
      uint8_t* origin = plane + (size_t)by * cols + bx;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) block[i * 8 + j] = (int32_t)origin[i * cols + j] - 128;
      fdct_islow(block);
      for (int i = 0; i < 64; ++i) {
        const uint32_t mag = (uint32_t)std::abs(block[i]);
        const int32_t q = (int32_t)(((uint64_t)(mag + div[i].corr) * div[i].recip) >> div[i].shift);
        block[i] = (block[i] < 0 ? -q : q) * qtable[i];
      }
      idct_islow(block, origin, cols);
    }
}

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t fix16(double x) { return (int32_t)(x * (1 << kScaleBits) + 0.5); }

inline uint8_t clamp255(int v) { return (uint8_t)std::min(255, std::max(0, v)); }

}  // namespace

extern "C" {

// img: (h, w, 3) RGB uint8, in place: what cv2.imdecode(cv2.imencode(
// ".jpg", img, [IMWRITE_JPEG_QUALITY, quality])) gives (channel order aside).
void jpeg_libjpeg_roundtrip(uint8_t* img, int h, int w, int quality) {
  const int lw = (w + 7) / 8 * 8, lh = (h + 7) / 8 * 8;     // luma blocks
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;             // chroma samples
  const int cbw = (cw + 7) / 8 * 8, cbh = (ch + 7) / 8 * 8;   // chroma blocks
  const int pw = 2 * cbw;                                   // full-res chroma row width
  // jccolor.c rgb_ycc_convert; the right edge replicated (jcsample.c)
  std::vector<uint8_t> y((size_t)lh * lw), cb_full((size_t)2 * ch * pw), cr_full((size_t)2 * ch * pw);
  for (int i = 0; i < 2 * ch; ++i) {
    const int si = std::min(i, h - 1);  // the bottom row doubled when h is odd
    for (int j = 0; j < pw; ++j) {
      const uint8_t* px = img + ((size_t)si * w + std::min(j, w - 1)) * 3;
      const int32_t r = px[0], g = px[1], b = px[2];
      const int32_t yy = (fix16(0.29900) * r + fix16(0.58700) * g + fix16(0.11400) * b +
                          kOneHalf) >> kScaleBits;
      const int32_t off = (128 << kScaleBits) + kOneHalf - 1;
      cb_full[(size_t)i * pw + j] = (uint8_t)((-fix16(0.16874) * r - fix16(0.33126) * g +
                                               fix16(0.50000) * b + off) >> kScaleBits);
      cr_full[(size_t)i * pw + j] = (uint8_t)((fix16(0.50000) * r - fix16(0.41869) * g -
                                               fix16(0.08131) * b + off) >> kScaleBits);
      if (i < h && j < lw) y[(size_t)i * lw + j] = (uint8_t)yy;
    }
  }
  for (int i = h; i < lh; ++i)  // luma rows replicated to whole blocks
    std::copy(y.begin() + (size_t)(h - 1) * lw, y.begin() + (size_t)h * lw, y.begin() + (size_t)i * lw);
  // jcsample.c h2v2_downsample (bias 1, 2, 1, 2, ... along the row), then
  // the last chroma row replicated to whole blocks (jcprepct.c)
  std::vector<uint8_t> cb((size_t)cbh * cbw), cr((size_t)cbh * cbw);
  for (int i = 0; i < cbh; ++i) {
    const int si = std::min(i, ch - 1);
    for (int j = 0; j < cbw; ++j) {
      const int bias = (j & 1) ? 2 : 1;
      const size_t a = (size_t)(2 * si) * pw + 2 * j, b = a + pw;
      cb[(size_t)i * cbw + j] = (uint8_t)((cb_full[a] + cb_full[a + 1] + cb_full[b] + cb_full[b + 1] + bias) >> 2);
      cr[(size_t)i * cbw + j] = (uint8_t)((cr_full[a] + cr_full[a + 1] + cr_full[b] + cr_full[b + 1] + bias) >> 2);
    }
  }
  int qluma[64], qchroma[64];
  quant_table(kStdLuma, quality, qluma);
  quant_table(kStdChroma, quality, qchroma);
  code_plane(y.data(), lh, lw, qluma);
  code_plane(cb.data(), cbh, cbw, qchroma);
  code_plane(cr.data(), cbh, cbw, qchroma);
  // jdcolor.c's tables
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int32_t x = i - 128;
    cr_r[i] = (fix16(1.40200) * x + kOneHalf) >> kScaleBits;
    cb_b[i] = (fix16(1.77200) * x + kOneHalf) >> kScaleBits;
    cr_g[i] = -fix16(0.71414) * x;
    cb_g[i] = -fix16(0.34414) * x + kOneHalf;
  }
  // jdsample.c h2v2_fancy_upsample: 9/16, 3/16, 3/16, 1/16 of the nearest
  // chroma samples, the edges replicated (h2v2_upsample, each sample
  // doubled both ways, where a chroma row holds 2 samples or fewer); then
  // ycc_rgb_convert
  std::vector<int> up_cb(2 * (size_t)cw), up_cr(2 * (size_t)cw);
  auto upsample_row = [&](const std::vector<uint8_t>& plane, int near, int far, int* out) {
    const uint8_t* p0 = plane.data() + (size_t)near * cbw;
    const uint8_t* p1 = plane.data() + (size_t)far * cbw;
    if (cw <= 2) {
      for (int c = 0; c < cw; ++c) out[2 * c] = out[2 * c + 1] = p0[c];
      return;
    }
    auto colsum = [&](int c) { return p0[c] * 3 + p1[c]; };
    for (int c = 0; c < cw; ++c) {
      const int t = colsum(c);
      const int last = c == 0 ? t : colsum(c - 1), next = c == cw - 1 ? t : colsum(c + 1);
      out[2 * c] = (c == 0 ? t * 4 + 8 : t * 3 + last + 8) >> 4;
      out[2 * c + 1] = (c == cw - 1 ? t * 4 + 7 : t * 3 + next + 7) >> 4;
    }
  };
  for (int i = 0; i < h; ++i) {
    const int r = i / 2;
    const int far = (i & 1) ? std::min(r + 1, ch - 1) : std::max(r - 1, 0);
    upsample_row(cb, r, far, up_cb.data());
    upsample_row(cr, r, far, up_cr.data());
    for (int j = 0; j < w; ++j) {
      const int yy = y[(size_t)i * lw + j], cbv = up_cb[j], crv = up_cr[j];
      uint8_t* px = img + ((size_t)i * w + j) * 3;
      px[0] = clamp255(yy + cr_r[crv]);
      px[1] = clamp255(yy + ((cb_g[cbv] + cr_g[crv]) >> kScaleBits));
      px[2] = clamp255(yy + cb_b[cbv]);
    }
  }
}

// img: HWC RGB float32 in [0, 1], h and w multiples of 16; in place.
void jpeg_roundtrip(float* img, int h, int w, float quality) {
  float factor = ((quality < 50.0f) ? 5000.0f / quality : 200.0f - quality * 2.0f) / 100.0f;
  std::vector<float> y(h * w), cb(h * w / 4), cr(h * w / 4);
  std::vector<float> cbf(h * w), crf(h * w);
  for (int i = 0; i < h * w; ++i) {
    float r = img[i * 3] * 255.f, g = img[i * 3 + 1] * 255.f, b = img[i * 3 + 2] * 255.f;
    y[i] = 0.299f * r + 0.587f * g + 0.114f * b;
    cbf[i] = -0.168736f * r - 0.331264f * g + 0.5f * b + 128.f;
    crf[i] = 0.5f * r - 0.418688f * g - 0.081312f * b + 128.f;
  }
  int h2 = h / 2, w2 = w / 2;
  for (int i = 0; i < h2; ++i)
    for (int j = 0; j < w2; ++j) {
      cb[i * w2 + j] = 0.25f * (cbf[(2 * i) * w + 2 * j] + cbf[(2 * i) * w + 2 * j + 1] +
                                cbf[(2 * i + 1) * w + 2 * j] + cbf[(2 * i + 1) * w + 2 * j + 1]);
      cr[i * w2 + j] = 0.25f * (crf[(2 * i) * w + 2 * j] + crf[(2 * i) * w + 2 * j + 1] +
                                crf[(2 * i + 1) * w + 2 * j] + crf[(2 * i + 1) * w + 2 * j + 1]);
    }
  jpeg_channel(y.data(), h, w, kYTable, factor);
  jpeg_channel(cb.data(), h2, w2, kCTable, factor);
  jpeg_channel(cr.data(), h2, w2, kCTable, factor);
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j) {
      float yy = y[i * w + j];
      float cbv = cb[(i / 2) * w2 + j / 2] - 128.f;
      float crv = cr[(i / 2) * w2 + j / 2] - 128.f;
      float r = yy + 1.402f * crv;
      float g = yy - 0.344136f * cbv - 0.714136f * crv;
      float b = yy + 1.772f * cbv;
      float* px = img + ((size_t)i * w + j) * 3;
      px[0] = std::min(1.f, std::max(0.f, r / 255.f));
      px[1] = std::min(1.f, std::max(0.f, g / 255.f));
      px[2] = std::min(1.f, std::max(0.f, b / 255.f));
    }
}

// b images of (h, w, 3), each with its own quality; one image per thread.
void jpeg_roundtrip_batch(float* imgs, int b, int h, int w, const float* qualities,
                          int n_threads) {
  parallel_for(b, n_threads, [=](int i) {
    jpeg_roundtrip(imgs + (size_t)i * h * w * 3, h, w, qualities[i]);
  });
}

// b images of (h, w, c) float32, each filtered with its own k x k kernel
// (kernels: b x k x k), reflect-101 border; out must not alias imgs.
void filter2d_reflect_batch(const float* imgs, float* outs, int b, int h, int w, int c,
                            const float* kernels, int k, int n_threads) {
  const int half = k / 2, pw = w + 2 * half, ph = h + 2 * half;
  const size_t plane = (size_t)ph * pw * c;
  std::vector<float> padded((size_t)b * plane);
  parallel_for(b * ph, n_threads, [&](int r) {      // reflect-padded copies
    int i = r / ph, py = r % ph, sy = reflect101(py - half, h);
    const float* src = imgs + ((size_t)i * h + sy) * w * c;
    float* dst = padded.data() + i * plane + (size_t)py * pw * c;
    for (int px = 0; px < pw; ++px) {
      int sx = reflect101(px - half, w);
      for (int ch = 0; ch < c; ++ch) dst[(size_t)px * c + ch] = src[(size_t)sx * c + ch];
    }
  });
  parallel_for(b * h, n_threads, [&](int r) {       // one output row each
    int i = r / h, y = r % h;
    const float* kern = kernels + (size_t)i * k * k;
    const float* pad = padded.data() + i * plane;
    float* acc = outs + ((size_t)i * h + y) * w * c;
    const int n = w * c;
    for (int j = 0; j < n; ++j) acc[j] = 0.f;
    for (int ky = 0; ky < k; ++ky) {
      const float* row = pad + (size_t)(y + ky) * pw * c;
      for (int kx = 0; kx < k; ++kx) {
        const float wgt = kern[ky * k + kx];
        if (wgt == 0.f) continue;        // adds 0 to every (finite) output
        const float* src = row + (size_t)kx * c;
        for (int j = 0; j < n; ++j) acc[j] += wgt * src[j];
      }
    }
  });
}

}  // extern "C"
