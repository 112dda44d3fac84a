// Host C++ of the port's two-stage degrader (C++17, no dependencies beyond
// the standard library), bound with ctypes by ssl_tpu_torch/native/__init__.py.
//
//   jpeg_roundtrip(_batch): the 8x8 DCT quantisation round trip of the
//     reference's DiffJPEG (ITU-T T.81 Annex K tables, raw table * factor,
//     4:2:0 chroma), one image per thread in the batched form
//   filter2d_reflect_batch: 2-D filtering of HWC float32 images with a
//     k x k kernel each and a reflect-101 border (OpenCV's filter2D with
//     BORDER_REFLECT_101), rows spread over threads
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

}  // namespace

extern "C" {

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
