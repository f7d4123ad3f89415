// The chain's u8 quantiser for the photometric pass (K5): the round-half-up
// store of the JAX package (floor(clip(v, 0, 255) + 0.5), the Pallas
// kernels' _quant_u8), which the plain versions compute as
// (clamp(v, 0, 255) + 0.5).to(uint8). The line kernels (K3, K4, K6) store
// the same value with line_stage.cuh's exact magic-number conversion.
#pragma once

namespace mmtrs {

__device__ __forceinline__ float q8(float v) {
  return (float)(int)(fminf(fmaxf(v, 0.0f), 255.0f) + 0.5f);
}

}  // namespace mmtrs
