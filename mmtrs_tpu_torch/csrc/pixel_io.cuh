// Loads and stores shared by the resampling kernels (K3, K4, K6) and the
// photometric pass (K5): u8 or f32 in, the chain's u8 store out.
//
// The u8 store is the round-half-up quantiser of the JAX package
// (floor(clip(v, 0, 255) + 0.5), the Pallas kernels' _quant_u8), which the
// plain versions compute as (clamp(v, 0, 255) + 0.5).to(uint8).
#pragma once

#include <cstdint>

namespace mmtrs {

__device__ __forceinline__ float load(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load(const float* p) { return *p; }

__device__ __forceinline__ float q8(float v) {
  return (float)(int)(fminf(fmaxf(v, 0.0f), 255.0f) + 0.5f);
}

__device__ __forceinline__ void store(uint8_t* p, float v) { *p = (uint8_t)(int)q8(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// One line of an NHWC batch: axis 2 walks row (b, y) along W, axis 1 walks
// column (b, x) along H. `pos` is the element's index along the line.
struct Line {
  int n, pos;
  size_t base, stride;
};

__device__ __forceinline__ Line line_of(int b, int y, int x, int c, int H, int W,
                                        int C, int axis) {
  Line l;
  if (axis == 2) {
    l.n = W, l.pos = x;
    l.base = ((size_t)b * H + y) * W * C + c, l.stride = C;
  } else {
    l.n = H, l.pos = y;
    l.base = (size_t)b * H * W * C + (size_t)x * C + c, l.stride = (size_t)W * C;
  }
  return l;
}

}  // namespace mmtrs
