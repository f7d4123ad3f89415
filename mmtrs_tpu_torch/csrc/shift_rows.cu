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
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float load(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = (uint8_t)(int)(fminf(fmaxf(v, 0.0f), 255.0f) + 0.5f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

  int n, pos;
  size_t base, stride;
  float o;
  if (axis == 2) {
    n = W, pos = x, o = off[(size_t)b * H + y];
    base = ((size_t)b * H + y) * W * C + c, stride = C;
  } else {
    n = H, pos = y, o = off[(size_t)b * W + x];
    base = (size_t)b * H * W * C + (size_t)x * C + c, stride = (size_t)W * C;
  }
  const float k = floorf(o);
  const float f = o - k;
  int s = (int)k % n;
  if (s < 0) s += n;
  int i0 = pos + s;
  if (i0 >= n) i0 -= n;
  const int i1 = i0 + 1 == n ? 0 : i0 + 1;
  float v = (1.0f - f) * load(in + base + i0 * stride) + f * load(in + base + i1 * stride);
  const float src = (float)pos + o;
  if (src < 0.0f) v = load(in + base);
  if (src > (float)(n - 1)) v = load(in + base + (size_t)(n - 1) * stride);
  store(out + base + pos * stride, v);
}

template <typename T>
int launch(const void* in, void* out, const float* off, int B, int H, int W,
           int C, int axis, cudaStream_t stream) {
  const size_t n = (size_t)B * H * W * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  shift_kernel<T><<<blocks, threads, 0, stream>>>(
      (const T*)in, (T*)out, off, B, H, W, C, axis);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mmtrs_shift_rows(const void* in, void* out, const void* off, int B,
                                int H, int W, int C, int axis, int is_u8,
                                void* stream) {
  const float* o = (const float*)off;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  if (is_u8) return launch<uint8_t>(in, out, o, B, H, W, C, axis, s);
  return launch<float>(in, out, o, B, H, W, C, axis, s);
}
