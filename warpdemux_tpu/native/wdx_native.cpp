// Native host-side kernels for warpdemux_tpu.
//
// The reference's host hot paths are native too: pod5's C++/Arrow reader
// decodes VBZ-compressed signal, and a Cython kernel computes the windowed
// t-test (reference warpdemux/segmentation/_c_segmentation.pyx; pod5 signal
// codec = zstd over streamvbyte-16 with zig-zag delta coding). This
// framework keeps the *batch* compute on device, but the ingest decode and
// the live lane's single-read operations run on host — these are their
// C++ implementations, exposed through a minimal C ABI consumed via ctypes
// (warpdemux_tpu/native/__init__.py). Build: `make` in this directory
// (g++ -O3 -shared, links the zstd runtime libzstd.so.1; no headers needed).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// The four libzstd entry points used here (stable ABI since zstd 1.0).
size_t ZSTD_compress(void* dst, size_t dst_capacity, const void* src,
                     size_t src_size, int level);
size_t ZSTD_decompress(void* dst, size_t dst_capacity, const void* src,
                       size_t compressed_size);
size_t ZSTD_compressBound(size_t src_size);
unsigned ZSTD_isError(size_t code);

// Plain zstd frame decompression; returns the decompressed size, or -1.
int64_t zstd_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                        int64_t dst_cap) {
  size_t n = ZSTD_decompress(dst, (size_t)dst_cap, src, (size_t)src_len);
  return ZSTD_isError(n) ? -1 : (int64_t)n;
}

// ---------------------------------------------------------------------------
// VBZ signal codec (pod5 signal compression): zstd( keys || data ) where
// keys hold 1 bit per value (LSB-first; 0 -> 1 byte, 1 -> 2 bytes LE) and
// values are zig-zag-coded deltas of the int16 ADC stream.
// ---------------------------------------------------------------------------

// Returns 0 on success, negative on error. `out` must hold n int16.
int vbz_decode(const uint8_t* payload, int64_t payload_len, int64_t n,
               int16_t* out, uint8_t* scratch, int64_t scratch_len) {
  if (n == 0) return 0;
  size_t raw_len =
      ZSTD_decompress(scratch, (size_t)scratch_len, payload, (size_t)payload_len);
  if (ZSTD_isError(raw_len)) return -1;
  const int64_t keylen = (n + 7) / 8;
  if ((int64_t)raw_len < keylen) return -2;
  const uint8_t* keys = scratch;
  const uint8_t* data = scratch + keylen;
  const uint8_t* data_end = scratch + raw_len;

  int32_t acc = 0;
  int64_t di = 0;
  const int64_t dlen = data_end - data;
  for (int64_t i = 0; i < n; ++i) {
    const int wide = (keys[i >> 3] >> (i & 7)) & 1;
    uint32_t v;
    if (wide) {
      if (di + 2 > dlen) return -3;
      v = (uint32_t)data[di] | ((uint32_t)data[di + 1] << 8);
      di += 2;
    } else {
      if (di + 1 > dlen) return -3;
      v = data[di];
      di += 1;
    }
    const int32_t delta = (int32_t)(v >> 1) ^ -(int32_t)(v & 1);
    acc += delta;
    out[i] = (int16_t)acc;
  }
  return 0;
}

// Encode n int16 samples; returns compressed size, or negative on error.
// `out` must hold at least vbz_encode_bound(n) bytes; `scratch` likewise.
int64_t vbz_encode_bound(int64_t n) {
  return (int64_t)ZSTD_compressBound((size_t)((n + 7) / 8 + 2 * n)) + 16;
}

int64_t vbz_encode(const int16_t* sig, int64_t n, uint8_t* out,
                   int64_t out_len, uint8_t* scratch, int64_t scratch_len) {
  const int64_t keylen = (n + 7) / 8;
  if (scratch_len < keylen + 2 * n) return -1;
  uint8_t* keys = scratch;
  uint8_t* data = scratch + keylen;
  memset(keys, 0, (size_t)keylen);
  int64_t di = 0;
  int32_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t delta = (int32_t)sig[i] - prev;
    prev = sig[i];
    const uint32_t zz = ((uint32_t)(delta << 1)) ^ (uint32_t)(delta >> 31);
    if (zz > 0xFFFFu) return -2;
    if (zz > 0xFFu) {
      keys[i >> 3] |= (uint8_t)(1u << (i & 7));
      data[di++] = (uint8_t)(zz & 0xFF);
      data[di++] = (uint8_t)(zz >> 8);
    } else {
      data[di++] = (uint8_t)zz;
    }
  }
  const size_t csize = ZSTD_compress(out, (size_t)out_len, scratch,
                                     (size_t)(keylen + di), 1);
  if (ZSTD_isError(csize)) return -3;
  return (int64_t)csize;
}

// ---------------------------------------------------------------------------
// Windowed t-test (live-lane single-read path). Exact parity with the
// reference Cython kernel (_c_segmentation.pyx:124-161): for each position
// p in [0, n - 2w), score = |m1 - m2| / sqrt(ssd1 + ssd2) where ssd are
// *sums* of squared deviations. O(n) sliding update in f64.
// ---------------------------------------------------------------------------

void windowed_t_test(const double* x, int64_t n, int64_t w, double* out) {
  const int64_t m = n - 2 * w;
  if (m <= 0) return;
  // running sums for the two adjacent windows
  double s1 = 0, q1 = 0, s2 = 0, q2 = 0;
  for (int64_t i = 0; i < w; ++i) {
    s1 += x[i];
    q1 += x[i] * x[i];
    s2 += x[i + w];
    q2 += x[i + w] * x[i + w];
  }
  const double wf = (double)w;
  for (int64_t p = 0;; ++p) {
    const double m1 = s1 / wf, m2 = s2 / wf;
    const double v1 = q1 - s1 * m1;  // = sum((xi - m1)^2)
    const double v2 = q2 - s2 * m2;
    const double vs = v1 + v2;
    out[p] = vs > 0 ? fabs(m1 - m2) / sqrt(vs) : 0.0;
    if (p + 1 >= m) break;
    const double out1 = x[p], in1 = x[p + w];
    s1 += in1 - out1;
    q1 += in1 * in1 - out1 * out1;
    const double out2 = x[p + w], in2 = x[p + 2 * w];
    s2 += in2 - out2;
    q2 += in2 * in2 - out2 * out2;
  }
}

// Segment means between consecutive changepoints (the reference's
// c_new_means, _c_segmentation.pyx:41-53).
void segment_means(const double* x, int64_t n, const int64_t* cpts,
                   int64_t n_cpts, double* out) {
  for (int64_t i = 0; i + 1 < n_cpts; ++i) {
    int64_t a = cpts[i], b = cpts[i + 1];
    if (a < 0) a = 0;
    if (b > n) b = n;
    double s = 0;
    for (int64_t j = a; j < b; ++j) s += x[j];
    out[i] = b > a ? s / (double)(b - a) : 0.0;
  }
}

// Streaming mean-variance-shift polyA scan (live lane): returns the first
// index t in [w, n) where the trailing window [t-w, t) is elevated
// (mean >= thr_mean) and flat (variance <= thr_var), else -1. O(n).
int64_t mvs_scan(const float* x, int64_t n, int64_t w, double thr_mean,
                 double thr_var) {
  if (n < w || w <= 0) return -1;
  double s = 0, q = 0;
  for (int64_t i = 0; i < w; ++i) {
    s += x[i];
    q += (double)x[i] * x[i];
  }
  const double wf = (double)w;
  for (int64_t t = w;; ++t) {
    const double mean = s / wf;
    const double var = q / wf - mean * mean;
    if (mean >= thr_mean && var <= thr_var) return t;
    if (t >= n) break;
    const double xin = x[t], xout = x[t - w];
    s += xin - xout;
    q += xin * xin - xout * xout;
  }
  return -1;
}

}  // extern "C"
