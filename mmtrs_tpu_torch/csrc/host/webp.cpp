// WebP decoding for the port's image codec: VP8 (lossy, RFC 6386) and VP8L
// (lossless, RFC 9649) bitstreams to RGB, as libwebp 1.6 decodes them for
// Pillow (WebPAnimDecoder, MODE_RGBA, fancy upsampling, no dithering).
//
// Up to its YUV planes a VP8 decode is fixed bit for bit by RFC 6386; the
// rest follows libwebp's own integer arithmetic: the "fancy" chroma
// upsampler (9-3-3-1 weights, computed as libwebp computes them) and the
// 14-bit fixed-point YUV -> RGB with its clipping. Intra prediction reads
// unfiltered neighbours; the loop filter runs in raster order over each
// macroblock row once the row is reconstructed. VP8L is exact by
// construction (integer transforms on ARGB words). One image, one thread,
// no CPU feature flags: the output is the same on any host.
//
// The RIFF container is parsed in Python (utils/codec.py), which hands each
// entry point one chunk's payload. Each returns 0, or 1 (the data ends
// early), 2 (a corrupt bitstream), 3 (an inter frame) or 4 (out of memory).
// The constant tables are in webp_tables.h (scripts/make_webp_tables.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

#include "webp_tables.h"

namespace {

enum Status { kOk = 0, kTruncated = 1, kCorrupt = 2, kInterFrame = 3, kNoMemory = 4 };

// ---------------------------------------------------------------------------
// VP8: the boolean decoder (RFC 6386 section 7), one byte at a time. As in
// libwebp, ``range`` holds the range minus one, ``value`` the bits loaded
// (the top 8 above ``bits`` are the window), and reading past the data
// feeds one zero byte and sets ``eof``, which the decoder reports as
// a premature end.
// ---------------------------------------------------------------------------

struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = static_cast<uint64_t>(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;  // 7 ^ floor(log2(r))
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= static_cast<uint32_t>(get_bit(0x80)) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = static_cast<int>(get_value(n));
    return get_value(1) ? -v : v;
  }
};

// ---------------------------------------------------------------------------
// VP8: constants of the specification and libwebp's mode numbering
// ---------------------------------------------------------------------------

constexpr int BPS = 32;  // libwebp's work-buffer stride
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
  B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  // DC prediction where the top or left samples (or both) lie outside the frame
  DC_PRED_NOTOP = 4, DC_PRED_NOLEFT = 5, DC_PRED_NOTOPLEFT = 6,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const int kScan[16] = {
    0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
    0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS, 0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }
inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // libwebp's VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2
inline int abs0(int v) { return v < 0 ? -v : v; }

// ---------------------------------------------------------------------------
// VP8: inverse transforms (libwebp's dsp/dec.c)
// ---------------------------------------------------------------------------

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline void store(uint8_t* dst, int x, int y, int v) { dst[x + y * BPS] = clip8(dst[x + y * BPS] + (v >> 3)); }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[4 * 4], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    store(dst, 0, 0, a + d);
    store(dst, 1, 0, b + c);
    store(dst, 2, 0, b - c);
    store(dst, 3, 0, a - d);
    tmp++;
    dst += BPS;
  }
}

// libwebp picks a DC-only or three-coefficient variant by the block's
// non-zero coefficients; each is the full transform on such a block, and a
// block of zeros adds 0, so the full transform serves them all
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits >> 30) transform_one(src, dst);
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    transform_one(src, dst);
    transform_one(src + 16, dst + 4);
    transform_one(src + 32, dst + 4 * BPS);
    transform_one(src + 48, dst + 4 * BPS + 4);
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---------------------------------------------------------------------------
// VP8: intra prediction on the work buffer (libwebp's dsp/dec.c)
// ---------------------------------------------------------------------------

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y) {
    const int base = dst[-1] - top[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + base);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred_luma16(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, 16, dc >> 5);
      break;
    }
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_PRED_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, 16, dc >> 4);
      break;
    }
    case DC_PRED_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill(dst, 16, dc >> 4);
      break;
    }
    default: fill(dst, 16, 0x80); break;
  }
}

void pred_chroma8(int mode, uint8_t* dst) {
  switch (mode) {
    case DC_PRED: {
      int dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 8, dc >> 4);
      break;
    }
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_PRED_NOTOP: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill(dst, 8, dc >> 3);
      break;
    }
    case DC_PRED_NOLEFT: {
      int dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill(dst, 8, dc >> 3);
      break;
    }
    default: fill(dst, 8, 0x80); break;
  }
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, static_cast<int>(dc >> 3));
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, avg3(A, B, C), 4);
      memset(dst + 1 * BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    }
  }
}
#undef DST

// ---------------------------------------------------------------------------
// VP8: the loop filters (libwebp's dsp/dec.c), on the frame with its stride
// ---------------------------------------------------------------------------

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it && abs0(q3 - q2) <= it &&
         abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {  // 16 pixels across one edge
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh,
                 bool macroblock_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (macroblock_edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// ---------------------------------------------------------------------------
// VP8: the frame decoder
// ---------------------------------------------------------------------------

struct FInfo {
  int limit = 0;  // 0: no filtering
  int ilevel = 0;
  int inner = 0;
  int hev_thresh = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct MBData {  // one macroblock's modes and residuals
  int16_t coeffs[384];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint8_t imodes[16];
  uint32_t non_zero_y, non_zero_uv;
};

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  // segment header (ResetSegmentHeader's defaults)
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;  // 0 off, 1 simple, 2 complex
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  int parse_headers(const uint8_t* data, size_t size);
  int decode(uint8_t* rgb);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_mode(MBData& b, uint8_t* top, uint8_t* left);
  int get_coeffs(BoolReader& r, int type, int ctx, const int* dq, int n, int16_t* out);
  int parse_residuals(BoolReader& r, MBData& b, uint8_t& top_nz, uint8_t& top_nz_dc, uint8_t& left_nz,
                      uint8_t& left_nz_dc);
};

int VP8Decoder::parse_headers(const uint8_t* data, size_t size) {
  if (size < 10) return kTruncated;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame) return kInterFrame;
  if (profile > 3 || !show) return kCorrupt;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kCorrupt;
  width = ((data[7] << 8) | data[6]) & 0x3fff;  // the 2 scale bits are ignored, as libwebp ignores them
  height = ((data[9] << 8) | data[8]) & 0x3fff;
  if (width == 0 || height == 0) return kCorrupt;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (partition_length > buf_size) return kTruncated;
  br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;

  br.get_value(1);  // colour space
  br.get_value(1);  // clamping type (libwebp always clamps)
  // segment header
  use_segment = br.get_value(1);
  if (use_segment) {
    update_map = br.get_value(1);
    if (br.get_value(1)) {  // update the segments' data
      absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.get_value(1) ? br.get_value(8) : 255;
  } else {
    update_map = 0;
  }
  if (br.eof) return kCorrupt;
  // filter header
  simple = br.get_value(1);
  level = br.get_value(6);
  sharpness = br.get_value(3);
  use_lf_delta = br.get_value(1);
  if (use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
  }
  filter_type = (level == 0) ? 0 : simple ? 1 : 2;
  if (br.eof) return kCorrupt;
  // token partitions: the sizes of all but the last, 3 bytes each, then the data
  num_parts_minus_one = (1 << br.get_value(2)) - 1;
  const size_t last_part = num_parts_minus_one;
  if (buf_size < 3 * last_part) return kTruncated;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  const uint8_t* buf_end = buf + buf_size;
  size_t size_left = buf_size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last_part].init(part_start, size_left);
  if (part_start >= buf_end) return kTruncated;
  parse_quant();
  br.get_value(1);  // update_proba, ignored
  parse_proba();
  return kOk;
}

void VP8Decoder::parse_quant() {
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else if (i > 0) {
      dqm[i] = dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    QuantMatrix& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 as libwebp computes it: (x * 101581) >> 16
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void VP8Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = br.get_bit(CoeffsUpdateProba[t][b][c][p]) ? br.get_value(8) : CoeffsProba0[t][b][c][p];
  use_skip_proba = br.get_value(1);
  if (use_skip_proba) skip_p = br.get_value(8);
}

void VP8Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    } else {
      base_level = level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths[s][i4x4];
      int lvl = base_level;
      if (use_lf_delta) {
        lvl += ref_lf_delta[0];
        if (i4x4) lvl += mode_lf_delta[0];
      }
      lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
      if (lvl > 0) {
        int ilevel = lvl;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lvl + ilevel;
        info.hev_thresh = (lvl >= 40) ? 2 : (lvl >= 15) ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void VP8Decoder::parse_intra_mode(MBData& b, uint8_t* top, uint8_t* left) {
  if (update_map) {
    b.segment = !br.get_bit(seg_proba[0]) ? br.get_bit(seg_proba[1]) : br.get_bit(seg_proba[2]) + 2;
  } else {
    b.segment = 0;
  }
  b.skip = use_skip_proba ? br.get_bit(skip_p) : 0;
  b.is_i4x4 = !br.get_bit(145);
  if (!b.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED) : (br.get_bit(163) ? V_PRED : DC_PRED);
    b.imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        ymode = !br.get_bit(prob[0])   ? B_DC_PRED
                : !br.get_bit(prob[1]) ? B_TM_PRED
                : !br.get_bit(prob[2]) ? B_VE_PRED
                : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE_PRED : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br.get_bit(prob[6]) ? B_LD_PRED
                       : (!br.get_bit(prob[7]) ? B_VL_PRED : (!br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = static_cast<uint8_t>(ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = static_cast<uint8_t>(ymode);
    }
  }
  b.uvmode = !br.get_bit(142) ? DC_PRED : !br.get_bit(114) ? V_PRED : br.get_bit(183) ? TM_PRED : H_PRED;
}

// the coefficients of one 4x4 block from position n, dequantised at their
// zig-zag places; returns the position after the last non-zero one
int VP8Decoder::get_coeffs(BoolReader& r, int type, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!r.get_bit(p[0])) return n;  // end of block
    while (!r.get_bit(p[1])) {       // a zero coefficient
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const int band_next = kBands[n + 1];
    if (!r.get_bit(p[2])) {
      v = 1;
      p = proba[type][band_next][1];
    } else {
      if (!r.get_bit(p[3])) {
        if (!r.get_bit(p[4])) {
          v = 2;
        } else {
          v = 3 + r.get_bit(p[5]);
        }
      } else if (!r.get_bit(p[6])) {
        if (!r.get_bit(p[7])) {
          v = 5 + r.get_bit(159);
        } else {
          v = 7 + 2 * r.get_bit(165);
          v += r.get_bit(145);
        }
      } else {
        const int bit1 = r.get_bit(p[8]);
        const int bit0 = r.get_bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + r.get_bit(*tab);
        v += 3 + (8 << cat);
      }
      p = proba[type][band_next][2];
    }
    const int sign = r.get_bit(0x80);
    out[kZigzag[n]] = static_cast<int16_t>((sign ? -v : v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// libwebp's ParseResiduals: returns 1 when every coefficient is zero
int VP8Decoder::parse_residuals(BoolReader& r, MBData& b, uint8_t& top_nz, uint8_t& top_nz_dc, uint8_t& left_nz,
                                uint8_t& left_nz_dc) {
  const QuantMatrix& q = dqm[b.segment];
  int16_t* dst = b.coeffs;
  memset(dst, 0, sizeof(b.coeffs));
  int first, ac_type;
  if (!b.is_i4x4) {  // the Y2 block of DC coefficients
    int16_t dc[16] = {0};
    const int ctx = top_nz_dc + left_nz_dc;
    const int nz = get_coeffs(r, 1, ctx, q.y2, 0, dc);
    top_nz_dc = left_nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(r, ac_type, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = top_nz >> (4 + ch);
    lnz = left_nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(r, 2, ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  top_nz = static_cast<uint8_t>(out_t_nz);
  left_nz = static_cast<uint8_t>(out_l_nz);
  b.non_zero_y = non_zero_y;
  b.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return (mb_y == 0) ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
    return (mb_y == 0) ? DC_PRED_NOTOP : DC_PRED;
  }
  return mode;
}

// libwebp's YUV -> RGB: 14-bit fixed point, clipped (dsp/yuv.h)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return ((v & ~16383) == 0) ? static_cast<uint8_t>(v >> 6) : (v < 0) ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's fancy upsampler for one pair of output rows (dsp/upsampling.c):
// each chroma sample of the pair (u in the low half, v in the high half of
// a word) weighted 9-3-3-1 from its four nearest, as libwebp rounds it
void upsample_line_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                        const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load_uv = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x - 0], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x - 0) * 3);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x + 0], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x + 0) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
    }
  }
}

int VP8Decoder::decode(uint8_t* rgb) {
  precompute_filter_strengths();
  const int y_stride = mb_w * 16, uv_stride = mb_w * 8;
  std::vector<uint8_t> Y(static_cast<size_t>(y_stride) * mb_h * 16);
  std::vector<uint8_t> U(static_cast<size_t>(uv_stride) * mb_h * 8), V(U.size());
  std::vector<TopSamples> top_yuv(mb_w);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<uint8_t> top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
  std::vector<MBData> row(mb_w);
  std::vector<FInfo> finfo(mb_w);
  uint8_t yuv_b[YUV_SIZE];
  memset(yuv_b, 0, sizeof(yuv_b));
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& token_br = parts[mb_y & num_parts_minus_one];
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (br.eof) return kTruncated;
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& block = row[mb_x];
      int skip = use_skip_proba ? block.skip : 0;
      if (!skip) {
        skip = parse_residuals(token_br, block, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!block.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        finfo[mb_x] = fstrengths[block.segment][block.is_i4x4];
        finfo[mb_x].inner |= !skip;
      }
      if (token_br.eof) return kTruncated;
    }

    // reconstruct the row (libwebp's ReconstructRow), unfiltered neighbours
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = row[mb_x];
      if (mb_x > 0) {  // the previous block's right columns become the left samples
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      TopSamples* const top = &top_yuv[mb_x];
      const int16_t* const coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top[0].y, 16);
        memcpy(u_dst - BPS, top[0].u, 8);
        memcpy(v_dst - BPS, top[0].v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top[0].y[15], 4);
          } else {
            memcpy(top_right, top[1].y, 4);
          }
        }
        // the top-right samples repeated beside rows 3, 7 and 11
        for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          pred_luma4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        if (bits != 0)
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
      }
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      pred_chroma8(uv_mode, u_dst);
      pred_chroma8(uv_mode, v_dst);
      do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h - 1) {
        memcpy(top[0].y, y_dst + 15 * BPS, 16);
        memcpy(top[0].u, u_dst + 7 * BPS, 8);
        memcpy(top[0].v, v_dst + 7 * BPS, 8);
      }
      uint8_t* const y_out = &Y[static_cast<size_t>(mb_y) * 16 * y_stride + mb_x * 16];
      uint8_t* const u_out = &U[static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8];
      uint8_t* const v_out = &V[static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8];
      for (int j = 0; j < 16; ++j) memcpy(y_out + j * y_stride, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(u_out + j * uv_stride, u_dst + j * BPS, 8);
        memcpy(v_out + j * uv_stride, v_dst + j * BPS, 8);
      }
    }

    // loop-filter the row, macroblock by macroblock (libwebp's DoFilter)
    if (filter_type > 0) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* const yp = &Y[static_cast<size_t>(mb_y) * 16 * y_stride + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(yp, 1, y_stride, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k, 1, y_stride, limit);
          if (mb_y > 0) simple_filter(yp, y_stride, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k * y_stride, y_stride, 1, limit);
        } else {
          uint8_t* const up = &U[static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8];
          uint8_t* const vp = &V[static_cast<size_t>(mb_y) * 8 * uv_stride + mb_x * 8];
          const int il = f.ilevel, hv = f.hev_thresh;
          if (mb_x > 0) {
            filter_loop(yp, 1, y_stride, 16, limit + 4, il, hv, true);
            filter_loop(up, 1, uv_stride, 8, limit + 4, il, hv, true);
            filter_loop(vp, 1, uv_stride, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k, 1, y_stride, 16, limit, il, hv, false);
            filter_loop(up + 4, 1, uv_stride, 8, limit, il, hv, false);
            filter_loop(vp + 4, 1, uv_stride, 8, limit, il, hv, false);
          }
          if (mb_y > 0) {
            filter_loop(yp, y_stride, 1, 16, limit + 4, il, hv, true);
            filter_loop(up, uv_stride, 1, 8, limit + 4, il, hv, true);
            filter_loop(vp, uv_stride, 1, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k * y_stride, y_stride, 1, 16, limit, il, hv, false);
            filter_loop(up + 4 * uv_stride, uv_stride, 1, 8, limit, il, hv, false);
            filter_loop(vp + 4 * uv_stride, uv_stride, 1, 8, limit, il, hv, false);
          }
        }
      }
    }
  }

  // YUV 4:2:0 -> RGB over the visible width x height (libwebp's EmitFancyRGB)
  const int w = width, h = height;
  const size_t out_stride = static_cast<size_t>(w) * 3;
  auto yrow = [&](int r) { return &Y[static_cast<size_t>(r) * y_stride]; };
  auto urow = [&](int r) { return &U[static_cast<size_t>(r) * uv_stride]; };
  auto vrow = [&](int r) { return &V[static_cast<size_t>(r) * uv_stride]; };
  upsample_line_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgb, nullptr, w);
  int k = 1;
  for (; 2 * k < h; ++k)
    upsample_line_pair(yrow(2 * k - 1), yrow(2 * k), urow(k - 1), vrow(k - 1), urow(k), vrow(k),
                       rgb + (2 * k - 1) * out_stride, rgb + 2 * k * out_stride, w);
  if (!(h & 1))
    upsample_line_pair(yrow(h - 1), nullptr, urow(k - 1), vrow(k - 1), urow(k - 1), vrow(k - 1),
                       rgb + (h - 1) * out_stride, nullptr, w);
  return kOk;
}

// ---------------------------------------------------------------------------
// VP8L: the bit reader, least significant bit first. Bits past the data read
// as zeros; a stream is at its end once more bits were consumed than it
// holds (libwebp counts at least 64, even in a shorter stream).
// ---------------------------------------------------------------------------

struct LBitReader {
  const uint8_t* data = nullptr;
  size_t len = 0;
  uint64_t pos = 0;    // bits consumed
  uint64_t limit = 0;  // bits that may be consumed

  void init(const uint8_t* d, size_t n) {
    data = d;
    len = n;
    pos = 0;
    limit = n >= 8 ? static_cast<uint64_t>(n) * 8 : 64;
  }
  uint32_t peek(int n) const {  // n <= 32
    const size_t byte = static_cast<size_t>(pos >> 3);
    uint64_t v = 0;
    for (int i = 0; i < 8 && byte + i < len; ++i) v |= static_cast<uint64_t>(data[byte + i]) << (8 * i);
    v >>= (pos & 7);
    return static_cast<uint32_t>(v & ((n == 32) ? 0xffffffffull : ((1ull << n) - 1)));
  }
  uint32_t read(int n) {
    if (eos()) return 0;
    const uint32_t v = peek(n);
    pos += n;
    return v;
  }
  bool eos() const { return pos > limit; }
};

// a canonical prefix code: a table of the codes up to ROOT_BITS long,
// the longer ones decoded bit by bit over the counts per length
constexpr int MAX_CODE_LENGTH = 15;
constexpr int ROOT_BITS = 8;

struct HuffmanCode {
  std::vector<uint32_t> table;  // (length << 16) | symbol; length 0xff: a longer code
  int root_bits = 0;
  int count[MAX_CODE_LENGTH + 1] = {0};
  std::vector<uint16_t> sorted;

  // libwebp's BuildHuffmanTable rules: a lone symbol takes no bits, any other
  // set of lengths must make a complete code
  bool build(const int* lengths, int n) {
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > MAX_CODE_LENGTH) return false;
      ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    int offset[MAX_CODE_LENGTH + 2] = {0};
    for (int len = 1; len < MAX_CODE_LENGTH; ++len) {
      if (count[len] > (1 << len)) return false;
      offset[len + 1] = offset[len] + count[len];
    }
    const int used = n - count[0];
    sorted.assign(used, 0);
    {
      int off[MAX_CODE_LENGTH + 2];
      memcpy(off, offset, sizeof(off));
      for (int s = 0; s < n; ++s)
        if (lengths[s] > 0) sorted[off[lengths[s]]++] = static_cast<uint16_t>(s);
    }
    if (used == 1) {
      root_bits = 0;
      table.assign(1, static_cast<uint32_t>(sorted[0]));
      return true;
    }
    int open = 1;
    for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
      open <<= 1;
      open -= count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;  // not complete
    int max_len = MAX_CODE_LENGTH;
    while (count[max_len] == 0) --max_len;
    root_bits = max_len < ROOT_BITS ? max_len : ROOT_BITS;
    table.assign(1u << root_bits, 0xff0000u);
    int code = 0, k = 0;
    for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        if (len > root_bits) continue;
        int rev = 0;  // the code's bits in reading order
        for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int idx = rev; idx < (1 << root_bits); idx += 1 << len)
          table[idx] = (static_cast<uint32_t>(len) << 16) | sorted[k];
      }
      code <<= 1;
    }
    return true;
  }
  int read_symbol(LBitReader& br) const {
    if (root_bits == 0) return static_cast<int>(table[0]);
    const uint32_t bits = br.peek(MAX_CODE_LENGTH);
    const uint32_t e = table[bits & ((1u << root_bits) - 1)];
    const uint32_t len = e >> 16;
    if (len != 0xff) {
      br.pos += len;
      return static_cast<int>(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len2 = 1; len2 <= MAX_CODE_LENGTH; ++len2) {
      code |= (bits >> (len2 - 1)) & 1;
      const int c = count[len2];
      if (code - c < first) {
        br.pos += len2;
        return sorted[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // not reached for a complete code
  }
};

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int NUM_LITERAL_CODES = 256;
constexpr int NUM_LENGTH_CODES = 24;
constexpr int NUM_DISTANCE_CODES = 40;
constexpr int MAX_CACHE_BITS = 11;
const int kAlphabetSize[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES, NUM_LITERAL_CODES, NUM_LITERAL_CODES,
                              NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HTreeGroup {
  HuffmanCode htrees[5];
};

enum { PREDICTOR_TRANSFORM = 0, CROSS_COLOR_TRANSFORM = 1, SUBTRACT_GREEN_TRANSFORM = 2, COLOR_INDEXING_TRANSFORM = 3 };

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_and_green = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t red_and_blue = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (alpha_and_green & 0xff00ff00u) | (red_and_blue & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a0, uint32_t a1) { return (((a0 ^ a1) & 0xfefefefeu) >> 1) + (a0 & a1); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff, c = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + b - c)) << s;
  }
  return out;
}
inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}
inline int sub3(int a, int b, int c) { return abs0(b - c) - abs0(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) pa_minus_pb += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}

// libwebp's predictors 0-13 (14 and 15 act as 0); ``top`` is the row above
// at this pixel, so top[1] of a row's last pixel is the row's first pixel
inline uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
  switch (mode) {
    case 1: return *left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(*left, top[1]), top[0]);
    case 6: return average2(*left, top[-1]);
    case 7: return average2(*left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(*left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], *left, top[-1]);
    case 12: return add_sub_full(*left, top[0], top[-1]);
    case 13: return add_sub_half(*left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

struct VP8LDecoder {
  LBitReader br;
  Transform transforms[4];
  int num_transforms = 0;
  unsigned transforms_seen = 0;

  bool read_code_lengths(const int* code_length_code_lengths, int num_symbols, int* code_lengths);
  bool read_huffman_code(int alphabet_size, HuffmanCode* code);
  bool read_transform(int* xsize, int ysize);
  int decode_image_stream(int xsize, int ysize, bool is_level0, std::vector<uint32_t>* out, int* out_xsize);
  void inverse_transforms(std::vector<uint32_t>& pixels, int height);
};

bool VP8LDecoder::read_code_lengths(const int* code_length_code_lengths, int num_symbols, int* code_lengths) {
  HuffmanCode lengths_code;
  if (!lengths_code.build(code_length_code_lengths, 19)) return false;
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * br.read(3);
    max_symbol = 2 + br.read(length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int prev_code_len = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    if (br.eos()) return false;
    const int code_len = lengths_code.read_symbol(br);
    if (code_len < 16) {
      code_lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      const int slot = code_len - 16;
      const int extra_bits[3] = {2, 3, 7}, offsets[3] = {3, 3, 11};
      const int repeat = br.read(extra_bits[slot]) + offsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = (code_len == 16) ? prev_code_len : 0;
      for (int i = 0; i < repeat; ++i) code_lengths[symbol++] = length;
    }
  }
  return true;
}

// one prefix code; ``code`` null: read and check it, keep nothing
bool VP8LDecoder::read_huffman_code(int alphabet_size, HuffmanCode* code) {
  std::vector<int> code_lengths(alphabet_size > 256 ? alphabet_size : 256, 0);
  bool ok;
  if (br.read(1)) {  // simple code: one or two symbols given directly
    const int num_symbols = br.read(1) + 1;
    const int first_symbol_len_code = br.read(1);
    int symbol = br.read(first_symbol_len_code == 0 ? 1 : 8);
    code_lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br.read(8);
      code_lengths[symbol] = 1;
    }
    ok = true;
  } else {
    int code_length_code_lengths[19] = {0};
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) code_length_code_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
    ok = read_code_lengths(code_length_code_lengths, alphabet_size, code_lengths.data());
  }
  if (!ok || br.eos()) return false;
  HuffmanCode scratch;
  return (code ? code : &scratch)->build(code_lengths.data(), alphabet_size);
}

bool VP8LDecoder::read_transform(int* xsize, int ysize) {
  const int type = br.read(2);
  if (transforms_seen & (1u << type)) return false;  // each transform at most once
  transforms_seen |= 1u << type;
  Transform& t = transforms[num_transforms++];
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  switch (type) {
    case PREDICTOR_TRANSFORM:
    case CROSS_COLOR_TRANSFORM:
      t.bits = br.read(3) + 2;
      return decode_image_stream(subsample_size(t.xsize, t.bits), subsample_size(t.ysize, t.bits), false, &t.data,
                                 nullptr) == kOk;
    case COLOR_INDEXING_TRANSFORM: {
      const int num_colors = br.read(8) + 1;
      const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
      *xsize = subsample_size(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> palette;
      if (decode_image_stream(num_colors, 1, false, &palette, nullptr) != kOk) return false;
      // the palette is stored as deltas; entries past it are transparent black
      const int final_num_colors = 1 << (8 >> bits);
      t.data.assign(final_num_colors, 0);
      t.data[0] = palette[0];
      for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(palette[i], t.data[i - 1]);
      return true;
    }
    default:  // SUBTRACT_GREEN_TRANSFORM
      return true;
  }
}

// an image stream (RFC 9649 section 5): its transforms (level 0 only), colour
// cache, prefix codes (meta codes at level 0 only) and entropy-coded
// pixels, ``xsize`` x ``ysize`` ARGB words before any inverse transform
int VP8LDecoder::decode_image_stream(int xsize, int ysize, bool is_level0, std::vector<uint32_t>* out,
                                     int* out_xsize) {
  int transform_xsize = xsize;
  if (is_level0) {
    while (br.read(1)) {
      if (num_transforms == 4 || !read_transform(&transform_xsize, ysize)) return kCorrupt;
    }
  }
  int color_cache_bits = 0;
  if (br.read(1)) {
    color_cache_bits = br.read(4);
    if (color_cache_bits < 1 || color_cache_bits > MAX_CACHE_BITS) return kCorrupt;
  }
  // meta prefix codes: one group of five codes for each tile of the entropy image
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  int num_groups = 1;
  if (is_level0 && br.read(1)) {
    huffman_bits = br.read(3) + 2;
    huffman_xsize = subsample_size(transform_xsize, huffman_bits);
    const int huffman_ysize = subsample_size(ysize, huffman_bits);
    const int status = decode_image_stream(huffman_xsize, huffman_ysize, false, &huffman_image, nullptr);
    if (status != kOk) return status;
    for (uint32_t& g : huffman_image) {
      g = (g >> 8) & 0xffff;
      if (static_cast<int>(g) >= num_groups) num_groups = static_cast<int>(g) + 1;
    }
  }
  if (br.eos()) return kTruncated;
  // only the groups the entropy image names are kept; the others are read and checked
  std::vector<int> mapping(num_groups, huffman_image.empty() ? 0 : -1);
  int num_used = huffman_image.empty() ? 1 : 0;
  for (uint32_t g : huffman_image)
    if (mapping[g] < 0) mapping[g] = num_used++;
  std::vector<HTreeGroup> groups(num_used);
  const int cache_size = color_cache_bits > 0 ? 1 << color_cache_bits : 0;
  for (int i = 0; i < num_groups; ++i) {
    for (int j = 0; j < 5; ++j) {
      const int alphabet = kAlphabetSize[j] + (j == 0 ? cache_size : 0);
      HuffmanCode* code = mapping[i] < 0 ? nullptr : &groups[mapping[i]].htrees[j];
      if (!read_huffman_code(alphabet, code)) return br.eos() ? kTruncated : kCorrupt;
    }
  }
  for (uint32_t& g : huffman_image) g = static_cast<uint32_t>(mapping[g]);

  // the entropy-coded pixels: literals, backward references, colour cache hits
  const int width = transform_xsize, height = ysize;
  const size_t total = static_cast<size_t>(width) * height;
  out->assign(total, 0);
  uint32_t* const data = out->data();
  std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
  const int cache_shift = 32 - color_cache_bits;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  const int mask = huffman_bits ? (1 << huffman_bits) - 1 : 0;
  auto group_at = [&](int x, int y) -> const HTreeGroup& {
    if (huffman_image.empty()) return groups[0];
    return groups[huffman_image[static_cast<size_t>(y >> huffman_bits) * huffman_xsize + (x >> huffman_bits)]];
  };
  const HTreeGroup* group = total ? &group_at(0, 0) : nullptr;
  while (pos < total) {
    if ((col & mask) == 0) group = &group_at(col, row);
    const int code = group->htrees[GREEN].read_symbol(br);
    if (br.eos()) return kTruncated;
    if (code < NUM_LITERAL_CODES) {
      const int red = group->htrees[RED].read_symbol(br);
      const int blue = group->htrees[BLUE].read_symbol(br);
      const int alpha = group->htrees[ALPHA].read_symbol(br);
      if (br.eos()) return kTruncated;
      data[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES) {
      auto copy_value = [&](int symbol) {
        if (symbol < 4) return symbol + 1;
        const int extra_bits = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra_bits;
        return offset + static_cast<int>(br.read(extra_bits)) + 1;
      };
      const int length = copy_value(code - NUM_LITERAL_CODES);
      const int dist_symbol = group->htrees[DIST].read_symbol(br);
      const int dist_code = copy_value(dist_symbol);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {  // the 120 short codes name nearby pixels in two dimensions
        const int plane = kCodeToPlane[dist_code - 1];
        const int yoffset = plane >> 4, xoffset = 8 - (plane & 0xf);
        dist = yoffset * width + xoffset;
        if (dist < 1) dist = 1;
      }
      if (br.eos()) return kTruncated;
      if (pos < static_cast<size_t>(dist) || total - pos < static_cast<size_t>(length)) return kCorrupt;
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (col & mask) group = &group_at(col, row);
    } else if (code < NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size) {
      while (cached < pos) cache[(data[cached] * 0x1e35a7bdu) >> cache_shift] = data[cached], ++cached;
      data[pos++] = cache[code - (NUM_LITERAL_CODES + NUM_LENGTH_CODES)];
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else {
      return kCorrupt;
    }
    if (cache_size)
      while (cached < pos) cache[(data[cached] * 0x1e35a7bdu) >> cache_shift] = data[cached], ++cached;
  }
  if (br.eos()) return kTruncated;
  if (out_xsize) *out_xsize = transform_xsize;
  return kOk;
}

// the inverse transforms, last read first, over the whole image in place
void VP8LDecoder::inverse_transforms(std::vector<uint32_t>& pixels, int height) {
  for (int n = num_transforms - 1; n >= 0; --n) {
    const Transform& t = transforms[n];
    const int width = t.xsize;
    switch (t.type) {
      case SUBTRACT_GREEN_TRANSFORM:
        for (uint32_t& argb : pixels) {
          const uint32_t green = (argb >> 8) & 0xff;
          uint32_t red_blue = argb & 0x00ff00ffu;
          red_blue += (green << 16) | green;
          argb = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
        }
        break;
      case PREDICTOR_TRANSFORM: {
        uint32_t* out = pixels.data();
        out[0] = add_pixels(out[0], 0xff000000u);  // the first pixel predicts black
        for (int x = 1; x < width; ++x) out[x] = add_pixels(out[x], out[x - 1]);  // the first row: left
        const int tiles_per_row = subsample_size(width, t.bits);
        for (int y = 1; y < height; ++y) {
          uint32_t* cur = out + static_cast<size_t>(y) * width;
          const uint32_t* up = cur - width;
          const uint32_t* modes = &t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row];
          cur[0] = add_pixels(cur[0], up[0]);  // the first column: top
          for (int x = 1; x < width; ++x) {
            const int mode = (modes[x >> t.bits] >> 8) & 0xf;
            cur[x] = add_pixels(cur[x], predict(mode, &cur[x - 1], &up[x]));
          }
        }
        break;
      }
      case CROSS_COLOR_TRANSFORM: {
        const int tiles_per_row = subsample_size(width, t.bits);
        for (int y = 0; y < height; ++y) {
          uint32_t* cur = pixels.data() + static_cast<size_t>(y) * width;
          const uint32_t* codes = &t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row];
          for (int x = 0; x < width; ++x) {
            const uint32_t c = codes[x >> t.bits];
            const int8_t green_to_red = static_cast<int8_t>(c & 0xff);
            const int8_t green_to_blue = static_cast<int8_t>((c >> 8) & 0xff);
            const int8_t red_to_blue = static_cast<int8_t>((c >> 16) & 0xff);
            const uint32_t argb = cur[x];
            const int8_t green = static_cast<int8_t>(argb >> 8);
            int new_red = (argb >> 16) & 0xff;
            int new_blue = argb & 0xff;
            new_red += (static_cast<int>(green_to_red) * green) >> 5;
            new_red &= 0xff;
            new_blue += (static_cast<int>(green_to_blue) * green) >> 5;
            new_blue += (static_cast<int>(red_to_blue) * static_cast<int8_t>(new_red)) >> 5;
            new_blue &= 0xff;
            cur[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) | static_cast<uint32_t>(new_blue);
          }
        }
        break;
      }
      default: {  // COLOR_INDEXING_TRANSFORM: indices, bundled 2, 4 or 8 to a pixel, to colours
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int packed_width = subsample_size(width, t.bits);
        std::vector<uint32_t> unpacked(static_cast<size_t>(width) * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = pixels.data() + static_cast<size_t>(y) * packed_width;
          uint32_t* dst = unpacked.data() + static_cast<size_t>(y) * width;
          uint32_t packed = 0;
          for (int x = 0; x < width; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        pixels.swap(unpacked);
        break;
      }
    }
  }
}

int vp8l_decode(const uint8_t* data, size_t size, int width, int height, bool headerless, uint8_t* rgb) {
  VP8LDecoder dec;
  dec.br.init(data, size);
  if (!headerless) {
    if (dec.br.read(8) != 0x2f) return kCorrupt;
    const int w = dec.br.read(14) + 1, h = dec.br.read(14) + 1;
    dec.br.read(1);  // alpha is used: only a hint
    if (dec.br.read(3) != 0) return kCorrupt;  // version
    if (w != width || h != height) return kCorrupt;
  }
  std::vector<uint32_t> pixels;
  const int status = dec.decode_image_stream(width, height, true, &pixels, nullptr);
  if (status != kOk) return status;
  if (rgb == nullptr) return kOk;
  dec.inverse_transforms(pixels, height);
  const size_t n = static_cast<size_t>(width) * height;
  for (size_t i = 0; i < n; ++i) {
    const uint32_t argb = pixels[i];
    rgb[3 * i + 0] = static_cast<uint8_t>(argb >> 16);
    rgb[3 * i + 1] = static_cast<uint8_t>(argb >> 8);
    rgb[3 * i + 2] = static_cast<uint8_t>(argb);
  }
  return kOk;
}

}  // namespace

// a VP8 chunk's payload (with its padding byte, if any) -> RGB u8 [height, width, 3]
extern "C" int mmtrs_webp_vp8_decode(const void* src, long long n, int width, int height, void* rgb) {
  try {
    std::unique_ptr<VP8Decoder> dec(new VP8Decoder());
    int status = dec->parse_headers(static_cast<const uint8_t*>(src), static_cast<size_t>(n));
    if (status == kOk && (dec->width != width || dec->height != height)) status = kCorrupt;
    if (status == kOk) status = dec->decode(static_cast<uint8_t*>(rgb));
    return status;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}

// a VP8L chunk's payload (its 5-byte header first) -> RGB u8 [height, width, 3]
extern "C" int mmtrs_webp_vp8l_decode(const void* src, long long n, int width, int height, void* rgb) {
  try {
    return vp8l_decode(static_cast<const uint8_t*>(src), static_cast<size_t>(n), width, height, false,
                       static_cast<uint8_t*>(rgb));
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}

// an ALPH chunk's losslessly compressed plane (a VP8L image stream without
// the header, width x height): decoded and checked, nothing kept
extern "C" int mmtrs_webp_alpha_check(const void* src, long long n, int width, int height) {
  try {
    return vp8l_decode(static_cast<const uint8_t*>(src), static_cast<size_t>(n), width, height, true, nullptr);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (...) {
    return kCorrupt;
  }
}
