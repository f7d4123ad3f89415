// K4 mmtrs_resample_rows: one pass of the two-pass affine warp on an NHWC
// batch — a per-line fractional shift, then an affine resample of the
// shifted line.
//
// Replaces mmtrs_tpu/ops/pallas/shift_kernel.py:_resample_rows_kernel, which
// ops/warp.py _warp_shear_fused runs twice per warp (the crop∘augment warp of
// preprocess_augment_batch and augment_legacy's warp). Along a line of n
// samples (axis 2: row (b, y), off = off_h[b, y]; axis 1: column (b, x),
// off = off_v[b, x]; alpha and r per image):
//   tmp[x]  = (1 - f) in[(x + s) mod n] + f in[(x + s + 1) mod n],
//             k = floor(off), f = off - k, s = k mod n, replicate border
//             where x + off leaves [0, n - 1]   (K3's shift)
//   out[xo] = sum_x tmp[x] max(0, 1 - |clip(alpha xo + r, 0, n - 1) - x|)
// The hat weight has at most two non-zero taps, at floor(c) and floor(c)+1
// with weights 1 - w and w, so each output reads them directly: four input
// samples, no [n, n] matrix (the TPU builds one and multiplies because it
// has no gather). Axis 1 reads columns in place instead of the transposes
// around the TPU's vertical pass. u8 input may store u8 (round-half-up) or
// f32; f32 input stores f32.
// Bound on the card: bytes (one write per element; the four reads mostly
// hit the same or neighbouring cache lines); one thread per element.
#include <cuda_runtime.h>

#include <cstdint>

#include "pixel_io.cuh"

namespace {

using mmtrs::Line;
using mmtrs::line_of;
using mmtrs::load;
using mmtrs::store;

// K3's shifted sample at position x of the line.
template <typename Tin>
__device__ __forceinline__ float shifted(const Tin* __restrict__ in, const Line& l,
                                         int x, int s, float f, float o) {
  const int n = l.n;
  int i0 = x + s;
  if (i0 >= n) i0 -= n;
  const int i1 = i0 + 1 == n ? 0 : i0 + 1;
  float v = (1.0f - f) * load(in + l.base + i0 * l.stride) + f * load(in + l.base + i1 * l.stride);
  const float src = (float)x + o;
  if (src < 0.0f) v = load(in + l.base);
  if (src > (float)(n - 1)) v = load(in + l.base + (size_t)(n - 1) * l.stride);
  return v;
}

template <typename Tin, typename Tout>
__global__ void resample_kernel(const Tin* __restrict__ in, Tout* __restrict__ out,
                                const float* __restrict__ off,
                                const float* __restrict__ alpha,
                                const float* __restrict__ r, int B, int H, int W,
                                int C, int axis) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * W * C) return;
  const int c = (int)(i % C);
  const int x = (int)((i / C) % W);
  const int y = (int)((i / ((size_t)C * W)) % H);
  const int b = (int)(i / ((size_t)C * W * H));

  // l.base starts the line at pos 0 for either axis (it holds no pos term)
  const Line l = line_of(b, y, x, c, H, W, C, axis);
  const int n = l.n;
  const float o = axis == 2 ? off[(size_t)b * H + y] : off[(size_t)b * W + x];
  const float k = floorf(o);
  const float f = o - k;
  int s = (int)k % n;
  if (s < 0) s += n;

  const float cc = fminf(fmaxf(alpha[b] * (float)l.pos + r[b], 0.0f), (float)(n - 1));
  const float c0 = floorf(cc);
  const float w = cc - c0;
  const int x0 = (int)c0;
  const int x1 = min(x0 + 1, n - 1);
  const float v = (1.0f - w) * shifted(in, l, x0, s, f, o) + w * shifted(in, l, x1, s, f, o);
  store(out + l.base + l.pos * l.stride, v);
}

template <typename Tin, typename Tout>
int launch(const void* in, void* out, const float* off, const float* alpha,
           const float* r, int B, int H, int W, int C, int axis, cudaStream_t stream) {
  const size_t n = (size_t)B * H * W * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  resample_kernel<Tin, Tout><<<blocks, threads, 0, stream>>>(
      (const Tin*)in, (Tout*)out, off, alpha, r, B, H, W, C, axis);
  return (int)cudaGetLastError();
}

}  // namespace

// in_u8 / out_u8 pick u8 or f32 for each side; f32 in with u8 out is refused.
extern "C" int mmtrs_resample_rows(const void* in, void* out, const void* off,
                                   const void* alpha, const void* r, int B, int H,
                                   int W, int C, int axis, int in_u8, int out_u8,
                                   void* stream) {
  const float *o = (const float*)off, *a = (const float*)alpha, *rr = (const float*)r;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if (in_u8 && out_u8) return launch<uint8_t, uint8_t>(in, out, o, a, rr, B, H, W, C, axis, s);
  if (in_u8) return launch<uint8_t, float>(in, out, o, a, rr, B, H, W, C, axis, s);
  if (!out_u8) return launch<float, float>(in, out, o, a, rr, B, H, W, C, axis, s);
  return (int)cudaErrorInvalidValue;
}
