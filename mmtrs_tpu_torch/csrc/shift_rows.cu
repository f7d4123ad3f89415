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
// K6 mmtrs_shift_rows_windowed: per-pixel bounded shift of an NHWC batch.
//
// Replaces mmtrs_tpu/ops/pallas/shift_kernel.py:_shift_rows_pp_kernel, the
// elastic transform's two passes (ops/augment.py elastic →
// ops/warp.py shift_axis_windowed). off [B, H, W] is shared by the
// channels; along the line:
//   src = clip(p + off, 0, n - 1), out = (1 - w) in[floor(src)] + w in[floor(src) + 1]
// The TPU sums 2m + 2 hat taps of a static window with lane rolls because it
// has no gather; the two non-zero taps are read directly here, and the
// clipped source already gives the replicate border. |off| <= max_shift is
// checked by the wrapper. Bound: bytes (4 B of offset per pixel besides the
// image); one thread per element.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "pixel_io.cuh"

namespace {

using mmtrs::Line;
using mmtrs::line_of;
using mmtrs::load;
using mmtrs::store;

constexpr int kChunk = 16;             // bytes of one vector load or store
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr int kMaxSmem = 200 * 1024;    // the most a launch opts in to

__host__ __device__ __forceinline__ int round16(int v) { return (v + kChunk - 1) / kChunk * kChunk; }

// Chunk q of the 16-byte chunks that cover [g, g + nbytes) on g's aligned
// grid, copied from global g to shared s (stage) or back (flush): a whole
// chunk as one uint4, a partial one (a misaligned start or end) byte by
// byte. s[shift + i] pairs with g[i], shift = g mod 16; s is 16-aligned.
__device__ __forceinline__ void stage_chunk(unsigned char* __restrict__ s,
                                            const unsigned char* __restrict__ g, int nbytes,
                                            int q) {
  const int shift = (int)((uintptr_t)g & (kChunk - 1));
  const int lo = q * kChunk - shift;  // the chunk's first byte, from g
  if (lo >= 0 && lo + kChunk <= nbytes) {
    *reinterpret_cast<uint4*>(s + q * kChunk) = *reinterpret_cast<const uint4*>(g + lo);
  } else {
    const int hi = min(lo + kChunk, nbytes);
    for (int i = max(lo, 0); i < hi; ++i) s[shift + i] = g[i];
  }
}

__device__ __forceinline__ void flush_chunk(const unsigned char* __restrict__ s,
                                            unsigned char* __restrict__ g, int nbytes, int q) {
  const int shift = (int)((uintptr_t)g & (kChunk - 1));
  const int lo = q * kChunk - shift;
  if (lo >= 0 && lo + kChunk <= nbytes) {
    *reinterpret_cast<uint4*>(g + lo) = *reinterpret_cast<const uint4*>(s + q * kChunk);
  } else {
    const int hi = min(lo + kChunk, nbytes);
    for (int i = max(lo, 0); i < hi; ++i) g[i] = s[shift + i];
  }
}

// u8 <-> f32 without the conversion unit (a quarter-rate pipe on the card):
// b | 0x4B000000 is the float 2^23 + b, so subtracting 2^23 gives b
// exactly; and the u8 store floor(clip(v, 0, 255) + 0.5) (mmtrs::q8) is
// the low byte of (clip(v, 0, 255) + 0.5) + 2^23 added rounding down, which
// is 2^23 + that floor. Bit for bit what pixel_io.cuh's load and store do.
__device__ __forceinline__ float tap_of(const uint8_t* p) {
  return __uint_as_float(0x4B000000u | (uint32_t)*p) - 8388608.0f;
}
__device__ __forceinline__ float tap_of(const float* p) { return *p; }
__device__ __forceinline__ void put(uint8_t* p, float v) {
  const float y = fminf(fmaxf(v, 0.0f), 255.0f) + 0.5f;
  *p = (uint8_t)__float_as_uint(__fadd_rd(y, 8388608.0f));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// The samples p = 0..n-1 of a line with offset o that take the blend are
// [lo, hi): below lo the source p + o lies before 0 (the first sample is
// taken), from hi on after n - 1 (the last). These are the plain version's
// own float tests, (float)p + o < 0 and (float)p + o > n - 1, which are
// monotone in p, so each threshold is an estimate moved until the test
// flips.
struct Border {
  int lo, hi;
};

__device__ __forceinline__ Border border_of(float o, int n) {
  const float last = (float)(n - 1);
  int lo = min(max((int)ceilf(fminf(fmaxf(-o, -1.0f), (float)n + 1.0f)), 0), n);
  while (lo < n && (float)lo + o < 0.0f) ++lo;
  while (lo > 0 && !((float)(lo - 1) + o < 0.0f)) --lo;
  int hi = min(max((int)floorf(fminf(fmaxf(last - o, -2.0f), (float)n)) + 1, 0), n);
  while (hi < n && !((float)hi + o > last)) ++hi;
  while (hi > 0 && (float)(hi - 1) + o > last) --hi;
  return {lo, hi};
}

// The 4 bytes at p (any alignment) of shared memory, from its two words.
__device__ __forceinline__ uint32_t word_at(const unsigned char* p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>((uintptr_t)p & ~(uintptr_t)3);
  return __funnelshift_r(w[0], w[1], ((uint32_t)(uintptr_t)p & 3u) * 8u);
}

// Byte j of x as a float: 0x4B0000xx is 2^23 + x_j (see tap_of).
__device__ __forceinline__ float byte_f(uint32_t x, int j) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)) - 8388608.0f;
}

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

// Whether `kernel` may take `bytes` of dynamic shared memory, opting in
// above the 48 KB default.
template <typename K>
bool smem_fits(K* kernel, size_t bytes) {
  if (bytes <= (size_t)kStaticSmem) return true;
  if (bytes > (size_t)kMaxSmem) return false;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) == cudaSuccess)
    return true;
  cudaGetLastError();  // the refusal is not the launch's error
  return false;
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

template <typename T>
__global__ void shift_pp_kernel(const T* __restrict__ in, T* __restrict__ out,
                                const float* __restrict__ off, int B, int H, int W,
                                int C, int axis) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * W * C) return;
  const int c = (int)(i % C);
  const int x = (int)((i / C) % W);
  const int y = (int)((i / ((size_t)C * W)) % H);
  const int b = (int)(i / ((size_t)C * W * H));

  const Line l = line_of(b, y, x, c, H, W, C, axis);
  const float o = off[((size_t)b * H + y) * W + x];
  const float src = fminf(fmaxf((float)l.pos + o, 0.0f), (float)(l.n - 1));
  const float f0 = floorf(src);
  const float w = src - f0;
  const int i0 = (int)f0;
  const int i1 = min(i0 + 1, l.n - 1);
  const float v = (1.0f - w) * load(in + l.base + i0 * l.stride) + w * load(in + l.base + i1 * l.stride);
  store(out + l.base + l.pos * l.stride, v);
}

template <typename T>
int launch_pp(const void* in, void* out, const float* off, int B, int H, int W, int C, int axis,
              cudaStream_t stream) {
  const size_t n = (size_t)B * H * W * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  shift_pp_kernel<T><<<blocks, threads, 0, stream>>>((const T*)in, (T*)out, off, B, H, W, C, axis);
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

extern "C" int mmtrs_shift_rows_windowed(const void* in, void* out, const void* off,
                                         int B, int H, int W, int C, int axis,
                                         int is_u8, void* stream) {
  const float* o = (const float*)off;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if (is_u8) return launch_pp<uint8_t>(in, out, o, B, H, W, C, axis, s);
  return launch_pp<float>(in, out, o, B, H, W, C, axis, s);
}
