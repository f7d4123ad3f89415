// K4 mmtrs_resample_rows: one pass of the two-pass affine warp on an NHWC
// batch — a per-line fractional shift, then an affine resample of the
// shifted line.
//
// Replaces mmtrs_tpu/ops/pallas/shift_kernel.py:_resample_rows_kernel, which
// ops/warp.py _warp_shear_fused runs twice per warp (the crop∘augment warp of
// preprocess_augment_batch and every preset's warp). Along a line of n
// samples (axis 2: row (b, y), off = off_h[b, y]; axis 1: column (b, x),
// off = off_v[b, x]; alpha and r per image):
//   tmp[x]  = (1 - f) in[(x + s) mod n] + f in[(x + s + 1) mod n],
//             k = floor(off), f = off - k, s = k mod n, replicate border
//             where x + off leaves [0, n - 1]   (K3's shift)
//   out[xo] = sum_x tmp[x] max(0, 1 - |clip(alpha xo + r, 0, n - 1) - x|)
// The hat weight has two non-zero taps, at floor(c) and floor(c) + 1 with
// weights 1 - w and w, whatever the scale, so each output reads them
// directly: three input samples, no [n, n] matrix (the TPU builds one and
// multiplies because it has no gather). u8 stores u8 (round-half-up), f32
// stores f32.
// Bound on the card: bytes, the batch read once and written once.
//
// The design is K3's (shift_rows.cu): nothing is divided per element. A
// line's shift constants (k, f, s and the border thresholds, K3's own float
// tests) are taken once per line, the affine source c once per output
// position, and the lines are staged in shared memory with 16-byte loads
// and go out in 16-byte stores (partial chunks at a misaligned start or end
// byte by byte).
// - axis 2 (the horizontal pass): one block per row; each output value
//   reads its three samples (floor(c) + s, + 1, + 2 mod n) from the staged
//   row, or the border's where a hat tap's shift leaves the line.
// - axis 1 (the vertical pass): a block takes TX columns x TY output rows.
//   Output row y reads shifted rows floor(c(y)) and + 1, c monotone in y
//   (reversed for alpha < 0), and column x's shift reads source rows
//   + k_x and + k_x + 1, so the tile stages the union: rows
//   min floor(c) + min k .. max floor(c) + 1 + max k + 1 (mod n) of its
//   TX*C-value column strip, about |alpha| TY + (max k - min k) + 4 rows,
//   and rows 0 and n - 1 for the border. The cap fits the warps the chains
//   draw: |alpha| up to 1.3 (a scale of 1/0.9 and the crop's margin) with
//   offsets whose floor spreads by 14 across 32 columns (a slope of
//   sin 25°); a tile past it reads global memory with the same arithmetic.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "line_stage.cuh"

namespace {

using mmtrs::Border;
using mmtrs::border_of;
using mmtrs::chunks_of;
using mmtrs::flush_chunk;
using mmtrs::kChunk;
using mmtrs::line_pitch;
using mmtrs::put;
using mmtrs::smem_fits;
using mmtrs::stage_chunk;
using mmtrs::tap_of;

// A line's shift by o: tmp[x] = g0 in[(x + s) mod n] + f in[(x + s + 1) mod n]
// for x in [bd.lo, bd.hi), in[0] below, in[n - 1] from bd.hi on.
struct Shift {
  float f, g0;
  int k, s;
  Border bd;
};

__device__ __forceinline__ Shift shift_of(float o, int n) {
  Shift sh;
  const float k = floorf(o);
  sh.f = o - k;
  sh.g0 = 1.0f - sh.f;
  sh.k = (int)k;
  sh.s = sh.k % n;
  if (sh.s < 0) sh.s += n;
  sh.bd = border_of(o, n);
  return sh;
}

// The hat resample's taps x0, x1 at output position xo and their weights
// g = 1 - w and w: c = clip(alpha xo + r, 0, n - 1), x0 = floor(c).
struct Hat {
  int x0, x1;
  float g, w;
};

__device__ __forceinline__ Hat hat_of(float alpha, float r, int xo, int n) {
  const float c = fminf(fmaxf(alpha * (float)xo + r, 0.0f), (float)(n - 1));
  const float c0 = floorf(c);
  Hat h;
  h.w = c - c0;
  h.g = 1.0f - h.w;
  h.x0 = (int)c0;
  h.x1 = min(h.x0 + 1, n - 1);
  return h;
}

// Axis 2: one block per image row (blockIdx.x, image blockIdx.y). The row's
// W*C values are staged; thread t takes output pixels t, t + blockDim.x, ...
// (its hat once, for all channels) into a shared output row, which goes out
// in 16-byte stores.
template <typename T>
__global__ void resample_w_kernel(const T* __restrict__ in, T* __restrict__ out,
                                  const float* __restrict__ off, const float* __restrict__ alpha,
                                  const float* __restrict__ r, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y, t = threadIdx.x, nt = blockDim.x;
  const int nE = W * C, nb = nE * (int)sizeof(T);
  const size_t line = (size_t)b * H + blockIdx.x;
  const unsigned char* g = reinterpret_cast<const unsigned char*>(in + line * nE);
  T* dst = out + line * nE;
  const int ishift = (int)((uintptr_t)g & (kChunk - 1));
  const int oshift = (int)((uintptr_t)dst & (kChunk - 1));
  unsigned char* s_out = smem + line_pitch(nb);
  for (int q = t; q < chunks_of(ishift, nb); q += nt) stage_chunk(smem, g, nb, q);
  // the loads go out before the line's constants are read
  const Shift sh = shift_of(off[line], W);
  const float al = alpha[b], rb = r[b];
  __syncthreads();
  const T* row = reinterpret_cast<const T*>(smem + ishift);
  T* res = reinterpret_cast<T*>(s_out + oshift);
  const auto tmp = [&](int x, int c) {
    if (x < sh.bd.lo) return tap_of(row + c);
    if (x >= sh.bd.hi) return tap_of(row + (nE - C) + c);
    int i0 = x + sh.s;
    if (i0 >= W) i0 -= W;
    const int i1 = i0 + 1 == W ? 0 : i0 + 1;
    return sh.g0 * tap_of(row + i0 * C + c) + sh.f * tap_of(row + i1 * C + c);
  };
  for (int xo = t; xo < W; xo += nt) {
    const Hat h = hat_of(al, rb, xo, W);
    T* o = res + xo * C;
    if (h.x0 >= sh.bd.lo && h.x1 < sh.bd.hi && h.x1 == h.x0 + 1) {
      // both hat taps blend: three neighbouring samples of the row (mod W)
      int p0 = h.x0 + sh.s;
      if (p0 >= W) p0 -= W;
      const int p1 = p0 + 1 == W ? 0 : p0 + 1;
      const int p2 = p1 + 1 == W ? 0 : p1 + 1;
      const T *a = row + p0 * C, *b = row + p1 * C, *d = row + p2 * C;
      for (int c = 0; c < C; ++c) {
        const float sb = tap_of(b + c);
        put(o + c, h.g * (sh.g0 * tap_of(a + c) + sh.f * sb) + h.w * (sh.g0 * sb + sh.f * tap_of(d + c)));
      }
    } else {
      for (int c = 0; c < C; ++c) put(o + c, h.g * tmp(h.x0, c) + h.w * tmp(h.x1, c));
    }
  }
  __syncthreads();
  for (int q = t; q < chunks_of(oshift, nb); q += nt)
    flush_chunk(s_out, reinterpret_cast<unsigned char*>(dst), nb, q);
}

// Axis 1: a block takes TX columns x TY output rows of image blockIdx.z.
// Shared memory holds rows_cap input segments of `pitch` bytes, TY output
// segments of the same pitch, then rows_cap ints (the input segments' alignment
// shifts, all 0 when `aligned`). Thread t takes value t mod ew of the
// segment (and every ew-th after it) on the rows t / ew,
// t / ew + blockDim.x / ew, ...: its column's shift stays in registers down
// the rows, and the rows' hats are taken once per tile into shared memory.
// Where both of a row's hat taps blend (the interior), its value reads three
// neighbouring staged rows; near the border it takes the general path.
template <typename T, int TX, int TY>
__global__ void resample_h_kernel(const T* __restrict__ in, T* __restrict__ out,
                                  const float* __restrict__ off, const float* __restrict__ alpha,
                                  const float* __restrict__ r, int H, int W, int C, int rows_cap,
                                  int pitch, int ew, int aligned) {
  static_assert(TX == 32, "one warp reads a tile's offsets");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_kmin, s_kmax;
  __shared__ int s_oshift[TY];
  __shared__ Hat s_hat[TY];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, b = blockIdx.z;
  const int t = threadIdx.x, nt = blockDim.x;
  const int nx = min(TX, W - x0), ny = min(TY, H - y0);
  const size_t img = (size_t)b * H;
  const float* offs = off + (size_t)b * W + x0;
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
  if (t < ny) {
    s_hat[t] = hat_of(alpha[b], r[b], y0 + t, H);
    s_oshift[t] = aligned ? 0 : (int)((uintptr_t)(out + ((img + y0 + t) * W + x0) * C) & (kChunk - 1));
  }
  __syncthreads();
  const int kmin = s_kmin;
  // c is monotone in y, so the tile's hat taps span the first and last rows'
  const int jmin = min(s_hat[0].x0, s_hat[ny - 1].x0), jmax = max(s_hat[0].x1, s_hat[ny - 1].x1);
  const long long span_ll = (long long)(jmax - jmin) + ((long long)s_kmax - kmin) + 2;
  const bool staged_in = span_ll + 2 <= rows_cap;
  const int span = staged_in ? (int)span_ll : 0;
  const int nq = (seg + 2 * kChunk - 2) / kChunk;  // chunks of a segment at any alignment
  unsigned char* s_out = smem + (size_t)rows_cap * pitch;
  int* s_shift = reinterpret_cast<int*>(s_out + (size_t)TY * pitch);

  // staged input row i holds source row jmin + kmin + i (mod H); rows span
  // and span + 1 hold rows 0 and H - 1, the border
  if (staged_in) {
    for (int j = t; j < (span + 2) * nq; j += nt) {
      const int i = j / nq, q = j - i * nq;
      int row;
      if (i < span) {
        row = (int)(((long long)jmin + kmin + i) % H);
        if (row < 0) row += H;
      } else {
        row = i == span ? 0 : H - 1;
      }
      const unsigned char* g = reinterpret_cast<const unsigned char*>(in + ((img + row) * W + x0) * C);
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
  const auto tap_global = [&](int row, int e) { return tap_of(in + ((img + row) * W + x0) * C + e); };

  const int dy = nt / ew;
  for (int e = t % ew; e < nvals; e += ew) {
    const Shift sh = shift_of(offs[e / C], H);
    const int di = sh.k - kmin - jmin;  // staged row of shifted row j's first tap: j + di
    // the shifted column at row j
    const auto tmp = [&](int j) {
      if (j < sh.bd.lo) return staged_in ? tap(span, e) : tap_global(0, e);
      if (j >= sh.bd.hi) return staged_in ? tap(span + 1, e) : tap_global(H - 1, e);
      if (staged_in) return sh.g0 * tap(j + di, e) + sh.f * tap(j + di + 1, e);
      int r0 = j + sh.s;
      if (r0 >= H) r0 -= H;
      const int r1 = r0 + 1 == H ? 0 : r0 + 1;
      return sh.g0 * tap_global(r0, e) + sh.f * tap_global(r1, e);
    };
    for (int yy = t / ew; yy < ny; yy += dy) {
      const Hat h = s_hat[yy];
      float v;
      if (staged_in && h.x0 >= sh.bd.lo && h.x1 < sh.bd.hi && h.x1 == h.x0 + 1) {
        // both hat taps blend: three neighbouring staged rows
        const int i = h.x0 + di;
        const float b = tap(i + 1, e);
        v = h.g * (sh.g0 * tap(i, e) + sh.f * b) + h.w * (sh.g0 * b + sh.f * tap(i + 2, e));
      } else {
        v = h.g * tmp(h.x0) + h.w * tmp(h.x1);
      }
      put(reinterpret_cast<T*>(s_out + (size_t)yy * pitch + s_oshift[yy]) + e, v);
    }
  }
  __syncthreads();
  for (int j = t; j < ny * nq; j += nt) {
    const int row = j / nq, q = j - row * nq;
    unsigned char* g = reinterpret_cast<unsigned char*>(out + ((img + y0 + row) * W + x0) * C);
    if (q * kChunk < s_oshift[row] + seg) flush_chunk(s_out + (size_t)row * pitch, g, seg, q);
  }
}

template <typename T>
int launch_w(const void* in, void* out, const float* off, const float* alpha, const float* r, int B,
             int H, int W, int C, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)line_pitch(W * C * (int)sizeof(T));
  const int threads = std::min(64, (W + 31) / 32 * 32);  // more rows in flight per SM (64 beat 128 and 256)
  if (!smem_fits(resample_w_kernel<T>, smem)) return (int)cudaErrorInvalidValue;  // a row too long
  resample_w_kernel<T><<<dim3((unsigned)H, (unsigned)B), threads, smem, stream>>>(
      (const T*)in, (T*)out, off, alpha, r, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T, int TX, int TY>
int launch_h(const void* in, void* out, const float* off, const float* alpha, const float* r, int B,
             int H, int W, int C, cudaStream_t stream) {
  const int pitch = line_pitch(TX * C * (int)sizeof(T));
  const int rows_cap = TY + TY / 4 + TX / 2 + 8;  // |alpha| <= 1.3 and a floor spread of 14 at TY = 64
  const size_t smem = (size_t)(rows_cap + TY) * pitch + (size_t)rows_cap * sizeof(int);
  // ew threads across a segment's values, as many row groups as fit 256
  const int ew = std::min(TX * C, 256);
  const int threads = ew * std::max(1, 256 / ew);
  const int aligned = (uintptr_t)in % kChunk == 0 && (uintptr_t)out % kChunk == 0 &&
                      (size_t)W * C * sizeof(T) % kChunk == 0;
  const dim3 grid((unsigned)((W + TX - 1) / TX), (unsigned)((H + TY - 1) / TY), (unsigned)B);
  if (!smem_fits(resample_h_kernel<T, TX, TY>, smem)) return (int)cudaErrorInvalidValue;  // C too large
  resample_h_kernel<T, TX, TY><<<grid, threads, smem, stream>>>(
      (const T*)in, (T*)out, off, alpha, r, H, W, C, rows_cap, pitch, ew, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, const float* off, const float* alpha, const float* r, int B,
           int H, int W, int C, int axis, cudaStream_t stream) {
  if (axis == 2) return launch_w<T>(in, out, off, alpha, r, B, H, W, C, stream);
  if (sizeof(T) == 1) return launch_h<T, 32, 64>(in, out, off, alpha, r, B, H, W, C, stream);
  return launch_h<T, 32, 32>(in, out, off, alpha, r, B, H, W, C, stream);
}

}  // namespace

// in, out [B, H, W, C] u8 (is_u8) or f32, off f32 [B, H] (axis 2) or
// [B, W] (axis 1), alpha and r f32 [B], on the device. B at most 65535, H
// at most 2^31 - 1 (axis 2). Shared memory must hold the staged lines
// (200 KB at most): axis 2 a row in and out, 2*W*C*sizeof(T) up to ~200 KB;
// axis 1 the tile's segments of 32 pixels (C up to ~35 at u8, ~15 at f32).
// A shape past these returns cudaErrorInvalidValue.
extern "C" int mmtrs_resample_rows(const void* in, void* out, const void* off,
                                   const void* alpha, const void* r, int B, int H,
                                   int W, int C, int axis, int is_u8, void* stream) {
  const float *o = (const float*)off, *a = (const float*)alpha, *rr = (const float*)r;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if ((size_t)B * H * W * C == 0) return (int)cudaSuccess;
  if (is_u8) return launch<uint8_t>(in, out, o, a, rr, B, H, W, C, axis, s);
  return launch<float>(in, out, o, a, rr, B, H, W, C, axis, s);
}
