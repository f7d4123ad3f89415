// K3 mmtrs_shift_rows: per-line fractional shift of an NHWC batch.
//
// Replaces mmtrs_tpu/ops/pallas/shift_kernel.py:_shift_rows_kernel, which
// deskew's three shears run (ops/warp.py rotate_shear3). For axis 2 each
// image row (b, y) moves along W by off[b, y]; for axis 1 each column
// (b, x) moves along H by off[b, x], which replaces the swapaxes pair
// around the TPU's y-shear with the same result:
//   out[.., p, ..] = (1 - f) in[(p + k) mod n] + f in[(p + k + 1) mod n],
//   k = floor(off), f = off - k, replicate border where p + off leaves
//   [0, n - 1] — the wrapped indices of the TPU's log-roll cascade, read
//   directly. u8 in, u8 out (the chain's round-half-up store), or f32.
// Bound on the card: bytes, the batch read once and written once.
//
// The work is mapped onto the card so that no element pays for its own
// indexing (64-bit divisions per element leave such a kernel bound by
// integer issue, far from its byte bound):
// - the grid carries the row (axis 2) or a tile of columns x rows (axis 1),
//   so the only 64-bit product is a line's base; the offset, k, f, k mod n
//   and the border thresholds are taken once per line, inside a line
//   everything is 32-bit, and the channel is a counter that runs with the
//   element;
// - the source lines are staged in shared memory with 16-byte loads (the
//   partial chunks at a misaligned start or end byte by byte); consecutive
//   threads compute consecutive values into a shared output line, so a
//   warp's shared reads fall on consecutive bytes (free of bank conflicts),
//   and the line goes out in 16-byte stores;
// - axis 2: one block per row; the row's W*C values are one line shifted
//   by k*C elements with wrap, so the taps are (e + s*C) mod (W*C) and
//   that plus C;
// - axis 1: a block takes TX columns x TY output rows. A column's taps come
//   from source rows y + k_x and y + k_x + 1 (mod H), so the block stages
//   rows y0 + min k .. y0 + TY + max k of its TX*C-value column strip, and
//   rows 0 and H - 1 for the border. Deskew's y-shear has |slope| <= 1, so
//   that is at most TY + TX + 4 rows; a tile whose offsets spread further
//   reads global memory directly instead (the same arithmetic).
//
// K6 mmtrs_shift_rows_windowed: per-pixel windowed shift of an NHWC batch.
//
// Replaces mmtrs_tpu/ops/pallas/shift_kernel.py:_shift_rows_pp_kernel, the
// elastic transform's two passes (ops/augment.py elastic →
// ops/warp.py shift_axis_windowed). off [B, H, W] is shared by the
// channels. The TPU sums the 2m + 2 hat taps k = -m..m + 1 around
// rel = clip(p + off, 0, n - 1) - p with lane rolls, because it has no
// gather, then takes the first (last) sample where the clipped source sits
// at 0 (n - 1). Here the two non-zero taps are read directly:
//   src = clip(p + off, 0, n - 1), i0 = floor(src), w = src - i0,
//   out = (1 - w) in[i0] + w in[min(i0 + 1, n - 1)],
// a tap whose index relative to p falls outside [-m, m + 1] weighs 0, and
// src <= 0 (>= n - 1) takes in[0] (in[n - 1]). Within the window that is the
// bilinear shift with a replicate border; beyond it, the TPU kernel's sum.
// Bound: bytes (4 B of offset per pixel besides the image read and written).
// The design is K3's: the grid carries rows (axis 2) or tiles (axis 1), the
// lines are staged in shared memory with 16-byte loads and go out in
// 16-byte stores, an offset is read once per pixel (four at a time) for all
// its channels, and nothing is divided per element. On axis 1 the window
// bounds the source rows a tile reads, so it stages exactly those.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "line_stage.cuh"

namespace {

using mmtrs::Border;
using mmtrs::border_of;
using mmtrs::byte_f;
using mmtrs::chunks_of;
using mmtrs::flush_chunk;
using mmtrs::kChunk;
using mmtrs::line_pitch;
using mmtrs::put;
using mmtrs::round16;
using mmtrs::smem_fits;
using mmtrs::stage_chunk;
using mmtrs::tap_of;
using mmtrs::word_at;

// Axis 2: one block per image row (b, y) of W*C values. The row is copied
// to shared memory first (with its first C + 8 bytes again after its end,
// so that a u8 window never wraps), its values are computed into a shared
// output row, which goes out in 16-byte stores. Consecutive threads take
// consecutive values (f32) or 4-byte words (u8), so a warp's shared reads
// are consecutive (no bank conflicts). A u8 word's two taps are two
// unaligned 4-byte windows of the row, (e + s*C) and that plus C; a word
// wholly before (after) the blend range copies the first (last) pixel's
// bytes, which is what the u8 store of an integer value gives.
template <typename T>
__global__ void shift_w_kernel(const T* __restrict__ in, T* __restrict__ out,
                               const float* __restrict__ off, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nE = W * C, nbytes = nE * (int)sizeof(T);
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * nE;
  T* dst = out + base;
  unsigned char* s_out = smem + round16(nbytes + kChunk - 1 + C + 8);
  const int oshift = (int)((uintptr_t)dst & (kChunk - 1));
  const bool words = sizeof(T) == 1 && nE >= C + 8;
  // the loads go out before the offset is read
  const unsigned char* g = reinterpret_cast<const unsigned char*>(in + base);
  const int ishift = (int)((uintptr_t)g & (kChunk - 1));
  const int nq_in = (ishift + nbytes + kChunk - 1) / kChunk;
  for (int q = t; q < nq_in; q += nt) stage_chunk(smem, g, nbytes, q);
  if (words)
    for (int j = t; j < C + 8; j += nt) smem[ishift + nbytes + j] = g[j];
  const T* row = reinterpret_cast<const T*>(smem + ishift);
  T* res = reinterpret_cast<T*>(s_out + oshift);
  const float o = off[blockIdx.x];
  const float k = floorf(o);
  const float f = o - k, g0 = 1.0f - f;
  int s = (int)k % W;
  if (s < 0) s += W;
  const int sC = s * C;
  const Border bd = border_of(o, W);
  __syncthreads();

  // value e = p * C + c on its own, the plain version's formula
  const auto value = [&](int e, int p, int c) {
    if (p < bd.lo) return tap_of(row + c);
    if (p >= bd.hi) return tap_of(row + (nE - C) + c);
    int i0 = e + sC;
    if (i0 >= nE) i0 -= nE;
    int i1 = i0 + C;
    if (i1 >= nE) i1 -= nE;
    return g0 * tap_of(row + i0) + f * tap_of(row + i1);
  };
  if constexpr (sizeof(T) == 1) {
    if (words) {
      // word w of the output row holds values e = 4w - oshift .. + 3; the
      // (p, c) of its first value advance with it (floor division)
      const unsigned char* rb = reinterpret_cast<const unsigned char*>(row);
      int e = 4 * t - oshift;
      int p = e >= 0 ? e / C : -((C - 1 - e) / C);
      int c = e - p * C;
      const int dp = 4 * nt / C, dc = 4 * nt - dp * C;
      for (int w = t; 4 * w < oshift + nE; w += nt, e += 4 * nt) {
        if (e >= 0 && e + 3 < nE && p >= bd.lo && p + 3 < bd.hi) {
          int i0 = e + sC;
          if (i0 >= nE) i0 -= nE;
          const uint32_t a = word_at(rb + i0), b = word_at(rb + i0 + C);
          uint32_t packed = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = g0 * byte_f(a, j) + f * byte_f(b, j);
            const float y = fminf(fmaxf(v, 0.0f), 255.0f) + 0.5f;
            packed |= (__float_as_uint(__fadd_rd(y, 8388608.0f)) & 0xFFu) << (8 * j);
          }
          *reinterpret_cast<uint32_t*>(s_out + 4 * w) = packed;
        } else if (e >= 0 && e + 3 < nE && (p + 3 < bd.lo || p >= bd.hi)) {
          const unsigned char* px = rb + (p < bd.lo ? 0 : nE - C);
          uint32_t packed = 0u;
          for (int j = 0, cj = c; j < 4; ++j) {
            packed |= (uint32_t)px[cj] << (8 * j);
            if (++cj == C) cj = 0;
          }
          *reinterpret_cast<uint32_t*>(s_out + 4 * w) = packed;
        } else {  // the row's ends and a word across a border
          for (int j = max(0, -e); j < 4 && e + j < nE; ++j) {
            const int ej = e + j, pj = ej / C;
            put(res + ej, value(ej, pj, ej - pj * C));
          }
        }
        c += dc, p += dp;
        if (c >= C) c -= C, ++p;
      }
    }
  }
  if (!words) {
    // element e = p * C + c; (p, c) advance with e, no division per element
    int p = t / C, c = t - p * C;
    const int dp = nt / C, dc = nt - dp * C;
    for (int e = t; e < nE; e += nt) {
      put(res + e, value(e, p, c));
      c += dc, p += dp;
      if (c >= C) c -= C, ++p;
    }
  }
  __syncthreads();
  const int nq_out = (oshift + nbytes + kChunk - 1) / kChunk;
  for (int q = t; q < nq_out; q += nt) flush_chunk(s_out, reinterpret_cast<unsigned char*>(dst), nbytes, q);
}

// Axis 1: a block takes TX columns x TY output rows of image blockIdx.z;
// the segment of a row is those TX columns' TX*C values. Shared memory
// holds rows_cap input segments and TY output segments of `pitch` bytes,
// then rows_cap ints (the input segments' alignment shifts, all 0 when
// `aligned`). A tile whose offsets need more than rows_cap input rows reads
// global memory for its taps; its output still goes out in 16-byte stores.
// Thread t takes value t mod ew of the segment (and every ew-th after it)
// on the rows t / ew, t / ew + blockDim.x / ew, ...: its column's offset,
// taps and border stay in registers down the rows, and a warp's values are
// consecutive (shared reads free of bank conflicts).
template <typename T, int TX, int TY>
__global__ void shift_h_kernel(const T* __restrict__ in, T* __restrict__ out,
                               const float* __restrict__ off, int H, int W, int C, int rows_cap,
                               int pitch, int ew, int aligned) {
  static_assert(TX == 32, "one warp reads a tile's offsets");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_kmin, s_kmax;
  __shared__ int s_oshift[TY];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, t = threadIdx.x, nt = blockDim.x;
  const int nx = min(TX, W - x0), ny = min(TY, H - y0);
  const size_t img = (size_t)blockIdx.z * H;
  const float* offs = off + (size_t)blockIdx.z * W + x0;
  const int nvals = nx * C;
  const int seg = nvals * (int)sizeof(T);

  if (t < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    if (t < nx) lo = hi = (int)floorf(offs[t]);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, m));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
    }
    if (t == 0) s_kmin = lo, s_kmax = hi;
  }
  if (t < ny)
    s_oshift[t] = aligned ? 0 : (int)((uintptr_t)(out + ((img + y0 + t) * W + x0) * C) & (kChunk - 1));
  __syncthreads();
  const int kmin = s_kmin;
  const long long span_ll = (long long)ny + ((long long)s_kmax - kmin) + 1;
  const bool staged_in = span_ll + 2 <= rows_cap;
  const int span = staged_in ? (int)span_ll : 0;
  const int nq_max = (seg + 2 * kChunk - 2) / kChunk;  // chunks of a segment at any alignment
  unsigned char* s_out = smem + (size_t)rows_cap * pitch;
  int* s_shift = reinterpret_cast<int*>(s_out + (size_t)TY * pitch);

  // staged input row i holds source row y0 + kmin + i (mod H); rows span
  // and span + 1 hold rows 0 and H - 1, the border
  if (staged_in) {
    for (int j = t; j < (span + 2) * nq_max; j += nt) {
      const int i = j / nq_max, q = j - i * nq_max;
      int r;
      if (i < span) {
        r = (y0 + kmin + i) % H;
        if (r < 0) r += H;
      } else {
        r = i == span ? 0 : H - 1;
      }
      const unsigned char* g = reinterpret_cast<const unsigned char*>(in + ((img + r) * W + x0) * C);
      const int shift = (int)((uintptr_t)g & (kChunk - 1));
      if (q == 0) s_shift[i] = shift;
      if (q * kChunk < shift + seg) stage_chunk(smem + (size_t)i * pitch, g, seg, q);
    }
  }
  __syncthreads();
  const auto tap = [&](int i, int e) {
    const int sh = aligned ? 0 : s_shift[i];
    return tap_of(reinterpret_cast<const T*>(smem + (size_t)i * pitch + sh) + e);
  };
  const auto tap_global = [&](int r, int e) { return tap_of(in + ((img + r) * W + x0) * C + e); };

  const int dy = nt / ew;
  for (int e = t % ew; e < nvals; e += ew) {
    const int col = e / C;
    const float o = offs[col];
    const float kf = floorf(o);
    const float f = o - kf, g0 = 1.0f - f;
    const int k = (int)kf;
    const Border bd = border_of(o, H);
    for (int yy = t / ew; yy < ny; yy += dy) {
      const int y = y0 + yy;
      float v;
      if (y < bd.lo) {
        v = staged_in ? tap(span, e) : tap_global(0, e);
      } else if (y >= bd.hi) {
        v = staged_in ? tap(span + 1, e) : tap_global(H - 1, e);
      } else if (staged_in) {
        const int i = yy + k - kmin;
        v = g0 * tap(i, e) + f * tap(i + 1, e);
      } else {
        int r0 = (y + k) % H;
        if (r0 < 0) r0 += H;
        const int r1 = r0 + 1 == H ? 0 : r0 + 1;
        v = g0 * tap_global(r0, e) + f * tap_global(r1, e);
      }
      put(reinterpret_cast<T*>(s_out + (size_t)yy * pitch + s_oshift[yy]) + e, v);
    }
  }
  __syncthreads();
  for (int j = t; j < ny * nq_max; j += nt) {
    const int r = j / nq_max, q = j - r * nq_max;
    unsigned char* g = reinterpret_cast<unsigned char*>(out + ((img + y0 + r) * W + x0) * C);
    if (q * kChunk < s_oshift[r] + seg) flush_chunk(s_out + (size_t)r * pitch, g, seg, q);
  }
}

template <typename T, int TX, int TY>
int launch_h(const void* in, void* out, const float* off, int B, int H, int W, int C,
             cudaStream_t stream) {
  const int pitch = round16(TX * C * (int)sizeof(T) + kChunk - 1);
  const int rows_cap = TY + TX + 4;
  const size_t smem = (size_t)(rows_cap + TY) * pitch + (size_t)rows_cap * sizeof(int);
  // ew threads across a segment's values, as many row groups as fit 256
  const int ew = std::min(TX * C, 256);
  const int threads = ew * std::max(1, 256 / ew);
  const int aligned = (uintptr_t)in % kChunk == 0 && (uintptr_t)out % kChunk == 0 &&
                      (size_t)W * C * sizeof(T) % kChunk == 0;
  const dim3 grid((unsigned)((W + TX - 1) / TX), (unsigned)((H + TY - 1) / TY), (unsigned)B);
  if (!smem_fits(shift_h_kernel<T, TX, TY>, smem)) return (int)cudaErrorInvalidValue;  // C too large
  shift_h_kernel<T, TX, TY><<<grid, threads, smem, stream>>>((const T*)in, (T*)out, off, H, W, C,
                                                             rows_cap, pitch, ew, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const void* in, void* out, const float* off, int B, int H, int W, int C,
             cudaStream_t stream) {
  const int nbytes = W * C * (int)sizeof(T);
  const size_t smem = (size_t)round16(nbytes + kChunk - 1 + C + 8) + (size_t)round16(nbytes + kChunk - 1);
  const int threads = std::min(128, (W * C + 31) / 32 * 32);
  const unsigned rows = (unsigned)((size_t)B * H);
  if (!smem_fits(shift_w_kernel<T>, smem)) return (int)cudaErrorInvalidValue;  // a row too long
  shift_w_kernel<T><<<rows, threads, smem, stream>>>((const T*)in, (T*)out, off, W, C);
  return (int)cudaGetLastError();
}

// K6's window rule at sample p of a line of n samples with offset o: the
// taps i0, i1 and their weights (0 for a tap outside the window), and
// whether the first (edge < 0) or last (edge > 0) sample is taken instead.
// The plain version's own float steps, in its order.
struct Window {
  int i0, i1;
  bool in0, in1;
  float w0, w1;
  int edge;
};

__device__ __forceinline__ Window window_of(int p, float o, int n, int m) {
  const float last = (float)(n - 1);
  const float src = fminf(fmaxf((float)p + o, 0.0f), last);
  const float f0 = floorf(src);
  const float w = src - f0;
  Window t;
  t.i0 = (int)f0;
  t.i1 = min(t.i0 + 1, n - 1);
  const int k = t.i0 - p;
  t.in0 = k >= -m && k <= m + 1;
  t.in1 = k >= -m - 1 && k <= m;
  t.w0 = t.in0 ? 1.0f - w : 0.0f;
  t.w1 = t.in1 ? w : 0.0f;
  t.edge = src >= last ? 1 : (src <= 0.0f ? -1 : 0);
  return t;
}

// The offsets of up to four neighbouring pixels from p (n of them valid):
// one 16-byte load where the offset rows are 16-byte aligned.
__device__ __forceinline__ void offsets4(const float* __restrict__ p, int n, int vec, float o[4]) {
  if (vec && n >= 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = j < n ? p[j] : 0.0f;
  }
}

// Axis 2: one block per image row (b, y) of W pixels. The row's W*C values
// are staged with 16-byte loads; thread t takes pixels 4t..4t+3 (and the
// groups 4*blockDim.x further on), reads their four offsets at once and
// blends each channel's two taps from the staged row into a shared output
// row, which goes out in 16-byte stores. Every tap index lies in the row,
// so the window only sets weights on this axis; the taps are read as the
// plain version reads them (a zero weight times the sample).
template <typename T>
__global__ void window_w_kernel(const T* __restrict__ in, T* __restrict__ out,
                                const float* __restrict__ off, int W, int C, int m, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nE = W * C, nbytes = nE * (int)sizeof(T);
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * nE;
  const unsigned char* g = reinterpret_cast<const unsigned char*>(in + base);
  T* dst = out + base;
  const int ishift = (int)((uintptr_t)g & (kChunk - 1));
  const int oshift = (int)((uintptr_t)dst & (kChunk - 1));
  unsigned char* s_out = smem + line_pitch(nbytes);
  for (int q = t; q < chunks_of(ishift, nbytes); q += nt) stage_chunk(smem, g, nbytes, q);
  __syncthreads();
  const T* row = reinterpret_cast<const T*>(smem + ishift);
  T* res = reinterpret_cast<T*>(s_out + oshift);
  const float* offs = off + (size_t)blockIdx.x * W;
  for (int p0 = 4 * t; p0 < W; p0 += 4 * nt) {
    float o[4];
    offsets4(offs + p0, W - p0, vec, o);
    for (int j = 0; j < 4 && p0 + j < W; ++j) {
      const int p = p0 + j;
      const Window tw = window_of(p, o[j], W, m);
      const T* a = row + tw.i0 * C;
      const T* b = row + tw.i1 * C;
      for (int c = 0; c < C; ++c) {
        float v;
        if (tw.edge > 0) {
          v = tap_of(row + (nE - C) + c);
        } else if (tw.edge < 0) {
          v = tap_of(row + c);
        } else {
          v = tw.w0 * tap_of(a + c) + tw.w1 * tap_of(b + c);
        }
        put(res + p * C + c, v);
      }
    }
  }
  __syncthreads();
  for (int q = t; q < chunks_of(oshift, nbytes); q += nt)
    flush_chunk(s_out, reinterpret_cast<unsigned char*>(dst), nbytes, q);
}

// Axis 1: a block takes TX columns x TY output rows of image blockIdx.z.
// Output row y reads source rows y - m .. y + m + 1 of its column (a tap
// beyond them weighs 0) and rows 0 and H - 1 (the edges), so the block
// stages rows y0 - m .. y0 + TY + m, clamped to the image, of its TX*C-value
// column strip, then rows 0 and H - 1: every sample it reads is staged, and
// the launcher refuses an m whose strip does not fit (`rows` slots of
// `pitch` bytes). After them come TY output segments and the `rows` slots'
// alignment shifts (all 0 when `aligned`). Thread t takes four neighbouring
// pixels of one row (one 16-byte offset load) and all their channels.
template <typename T, int TX, int TY>
__global__ void window_h_kernel(const T* __restrict__ in, T* __restrict__ out,
                                const float* __restrict__ off, int H, int W, int C, int m,
                                int rows, int pitch, int aligned, int vec) {
  static_assert(TX % 4 == 0, "four pixels per thread");
  constexpr int G = TX / 4;  // pixel groups of a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_oshift[TY];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, t = threadIdx.x, nt = blockDim.x;
  const int nx = min(TX, W - x0), ny = min(TY, H - y0);
  const size_t img = (size_t)blockIdx.z * H;
  const int seg = nx * C * (int)sizeof(T);
  const int lo = max(0, y0 - m), hi = min(H - 1, y0 + ny + m);
  const int span = hi - lo + 1;  // + 2 <= rows (the launcher's bound)
  const int nq = (seg + 2 * kChunk - 2) / kChunk;  // chunks of a segment at any alignment
  unsigned char* s_out = smem + (size_t)rows * pitch;
  int* s_shift = reinterpret_cast<int*>(s_out + (size_t)TY * pitch);

  if (t < ny)
    s_oshift[t] = aligned ? 0 : (int)((uintptr_t)(out + ((img + y0 + t) * W + x0) * C) & (kChunk - 1));
  // slot i < span holds source row lo + i; slots span and span + 1 rows 0 and H - 1
  for (int j = t; j < (span + 2) * nq; j += nt) {
    const int i = j / nq, q = j - i * nq;
    const int r = i < span ? lo + i : (i == span ? 0 : H - 1);
    const unsigned char* g = reinterpret_cast<const unsigned char*>(in + ((img + r) * W + x0) * C);
    const int shift = (int)((uintptr_t)g & (kChunk - 1));
    if (q == 0) s_shift[i] = shift;
    if (q * kChunk < shift + seg) stage_chunk(smem + (size_t)i * pitch, g, seg, q);
  }
  __syncthreads();
  const auto tap = [&](int i, int e) {
    const int sh = aligned ? 0 : s_shift[i];
    return tap_of(reinterpret_cast<const T*>(smem + (size_t)i * pitch + sh) + e);
  };

  const float* offs = off + (img + y0) * W + x0;
  for (int j = t; j < ny * G; j += nt) {
    const int yy = j / G, px = (j - yy * G) * 4;
    if (px >= nx) continue;
    const int y = y0 + yy;
    float o[4];
    offsets4(offs + (size_t)yy * W + px, nx - px, vec, o);
    T* res = reinterpret_cast<T*>(s_out + (size_t)yy * pitch + s_oshift[yy]);
    for (int jj = 0; jj < 4 && px + jj < nx; ++jj) {
      const Window tw = window_of(y, o[jj], H, m);
      const int e = (px + jj) * C;
      const int i0 = tw.i0 - lo, i1 = tw.i1 - lo;
      for (int c = 0; c < C; ++c) {
        float v;
        if (tw.edge > 0) {
          v = tap(span + 1, e + c);
        } else if (tw.edge < 0) {
          v = tap(span, e + c);
        } else {
          // a tap outside the window weighs 0 and is not staged
          const float a = tw.in0 ? tap(i0, e + c) : 0.0f;
          const float b = tw.in1 ? tap(i1, e + c) : 0.0f;
          v = tw.w0 * a + tw.w1 * b;
        }
        put(res + e + c, v);
      }
    }
  }
  __syncthreads();
  for (int j = t; j < ny * nq; j += nt) {
    const int r = j / nq, q = j - r * nq;
    unsigned char* g = reinterpret_cast<unsigned char*>(out + ((img + y0 + r) * W + x0) * C);
    if (q * kChunk < s_oshift[r] + seg) flush_chunk(s_out + (size_t)r * pitch, g, seg, q);
  }
}

template <typename T>
int launch_window_w(const void* in, void* out, const float* off, int B, int H, int W, int C, int m,
                    cudaStream_t stream) {
  const int nbytes = W * C * (int)sizeof(T);
  const size_t smem = 2 * (size_t)line_pitch(nbytes);
  const int threads = std::min(256, ((W + 3) / 4 + 31) / 32 * 32);
  const int vec = (uintptr_t)off % kChunk == 0 && W % 4 == 0;
  const unsigned rows = (unsigned)((size_t)B * H);
  if (!smem_fits(window_w_kernel<T>, smem)) return (int)cudaErrorInvalidValue;  // a row too long
  window_w_kernel<T><<<rows, threads, smem, stream>>>((const T*)in, (T*)out, off, W, C, m, vec);
  return (int)cudaGetLastError();
}

template <typename T, int TX, int TY>
int launch_window_h(const void* in, void* out, const float* off, int B, int H, int W, int C, int m,
                    cudaStream_t stream) {
  const int pitch = line_pitch(TX * C * (int)sizeof(T));
  const int rows = (int)std::min<long long>(TY + 2LL * m + 1, H) + 2;  // the strip and the edges
  const size_t smem = (size_t)(rows + TY) * pitch + (size_t)rows * sizeof(int);
  const int aligned = (uintptr_t)in % kChunk == 0 && (uintptr_t)out % kChunk == 0 &&
                      (size_t)W * C * sizeof(T) % kChunk == 0;
  const int vec = (uintptr_t)off % kChunk == 0 && W % 4 == 0;
  const dim3 grid((unsigned)((W + TX - 1) / TX), (unsigned)((H + TY - 1) / TY), (unsigned)B);
  // an m (or C) whose strip does not fit
  if (!smem_fits(window_h_kernel<T, TX, TY>, smem)) return (int)cudaErrorInvalidValue;
  window_h_kernel<T, TX, TY><<<grid, 256, smem, stream>>>((const T*)in, (T*)out, off, H, W, C, m,
                                                          rows, pitch, aligned, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out [B, H, W, C] u8 (is_u8) or f32, off f32 [B, H] (axis 2) or
// [B, W] (axis 1), on the device; B*H rows at most 2^31 - 1 (axis 2), B at
// most 65535 (axis 1), W*C at most 2^31 / 4. Shared memory must hold the
// staged lines (200 KB at most): axis 2 a row in and out, W*C*sizeof(T)
// up to ~100 KB (W up to ~8.5K px at f32, C = 3); axis 1 164 u8 or 100 f32
// segments of 32 pixels (C <= 38 at u8, 15 at f32). A shape past these
// returns cudaErrorInvalidValue.
extern "C" int mmtrs_shift_rows(const void* in, void* out, const void* off, int B,
                                int H, int W, int C, int axis, int is_u8,
                                void* stream) {
  const float* o = (const float*)off;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if ((size_t)B * H * W * C == 0) return (int)cudaSuccess;
  if (axis == 2) {
    if (is_u8) return launch_w<uint8_t>(in, out, o, B, H, W, C, s);
    return launch_w<float>(in, out, o, B, H, W, C, s);
  }
  if (is_u8) return launch_h<uint8_t, 32, 64>(in, out, o, B, H, W, C, s);
  return launch_h<float, 32, 32>(in, out, o, B, H, W, C, s);
}

// in, out [B, H, W, C] u8 (is_u8) or f32, off f32 [B, H, W], on the device;
// max_shift >= 0 (the window's m; a larger one than the line is the line).
// B*H rows at most 2^31 - 1 (axis 2), B at most 65535 (axis 1). Shared
// memory must hold the staged lines (200 KB at most): axis 2 a row in and
// out, W*C*sizeof(T) up to ~100 KB; axis 1 a strip of min(TY + 2m + 1, H)
// + 2 rows of 32 pixels and TY output rows (TY 64 at u8, 32 at f32): at
// C = 3, m up to ~800 at u8 and ~220 at f32. A shape past these returns
// cudaErrorInvalidValue.
extern "C" int mmtrs_shift_rows_windowed(const void* in, void* out, const void* off,
                                         int B, int H, int W, int C, int axis,
                                         int max_shift, int is_u8, void* stream) {
  const float* o = (const float*)off;
  cudaStream_t s = (cudaStream_t)stream;
  if ((axis != 1 && axis != 2) || max_shift < 0) return (int)cudaErrorInvalidValue;
  if ((size_t)B * H * W * C == 0) return (int)cudaSuccess;
  const int m = std::min(max_shift, axis == 2 ? W : H);
  if (axis == 2) {
    if (is_u8) return launch_window_w<uint8_t>(in, out, o, B, H, W, C, m, s);
    return launch_window_w<float>(in, out, o, B, H, W, C, m, s);
  }
  if (is_u8) return launch_window_h<uint8_t, 32, 64>(in, out, o, B, H, W, C, m, s);
  return launch_window_h<float, 32, 32>(in, out, o, B, H, W, C, m, s);
}
