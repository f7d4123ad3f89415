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
// Bound on the card: bytes, one read of two neighbouring taps (mostly the
// same cache lines) and one write per element; one thread per element.
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

#include <cstdint>

#include "pixel_io.cuh"

namespace {

using mmtrs::Line;
using mmtrs::line_of;
using mmtrs::load;
using mmtrs::store;

template <typename T>
__global__ void shift_kernel(const T* __restrict__ in, T* __restrict__ out,
                             const float* __restrict__ off, int B, int H, int W,
                             int C, int axis) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * W * C) return;
  const int c = (int)(i % C);
  const int x = (int)((i / C) % W);
  const int y = (int)((i / ((size_t)C * W)) % H);
  const int b = (int)(i / ((size_t)C * W * H));

  const Line l = line_of(b, y, x, c, H, W, C, axis);
  const float o = axis == 2 ? off[(size_t)b * H + y] : off[(size_t)b * W + x];
  const int n = l.n;
  const float k = floorf(o);
  const float f = o - k;
  int s = (int)k % n;
  if (s < 0) s += n;
  int i0 = l.pos + s;
  if (i0 >= n) i0 -= n;
  const int i1 = i0 + 1 == n ? 0 : i0 + 1;
  float v = (1.0f - f) * load(in + l.base + i0 * l.stride) + f * load(in + l.base + i1 * l.stride);
  const float src = (float)l.pos + o;
  if (src < 0.0f) v = load(in + l.base);
  if (src > (float)(n - 1)) v = load(in + l.base + (size_t)(n - 1) * l.stride);
  store(out + l.base + l.pos * l.stride, v);
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
int launch(bool per_pixel, const void* in, void* out, const float* off, int B,
           int H, int W, int C, int axis, cudaStream_t stream) {
  const size_t n = (size_t)B * H * W * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (per_pixel)
    shift_pp_kernel<T><<<blocks, threads, 0, stream>>>((const T*)in, (T*)out, off, B, H, W, C, axis);
  else
    shift_kernel<T><<<blocks, threads, 0, stream>>>((const T*)in, (T*)out, off, B, H, W, C, axis);
  return (int)cudaGetLastError();
}

int dispatch(bool per_pixel, const void* in, void* out, const void* off, int B,
             int H, int W, int C, int axis, int is_u8, void* stream) {
  const float* o = (const float*)off;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if (is_u8) return launch<uint8_t>(per_pixel, in, out, o, B, H, W, C, axis, s);
  return launch<float>(per_pixel, in, out, o, B, H, W, C, axis, s);
}

}  // namespace

extern "C" int mmtrs_shift_rows(const void* in, void* out, const void* off, int B,
                                int H, int W, int C, int axis, int is_u8,
                                void* stream) {
  return dispatch(false, in, out, off, B, H, W, C, axis, is_u8, stream);
}

extern "C" int mmtrs_shift_rows_windowed(const void* in, void* out, const void* off,
                                         int B, int H, int W, int C, int axis,
                                         int is_u8, void* stream) {
  return dispatch(true, in, out, off, B, H, W, C, axis, is_u8, stream);
}
