// K5 mmtrs_photometric: the `legacy` preset's pointwise photometric pass on
// a u8 NHWC RGB batch, with a u8 store after every stage.
//
// Replaces mmtrs_tpu/ops/pallas/photometric_kernel.py:_photometric_kernel
// (ops/augment.py legacy_photometrics). Per image b, params[b] holds
// (brightness, contrast, dh, ds, dv, use_hsv, sigma, dropout, y0, x0):
//   1. q8(x (1 + contrast) + brightness 255)
//   2. if use_hsv > 0: q8(hsv_shift(x, dh, ds, dv))   (ops/augment.py hsv_shift)
//   3. if sigma > 0:   q8(x + sigma n), n a standard normal per element
//   4. if dropout > 0: zero the hole x hole square at (y0, x0)
// One thread owns one pixel and its three channels, so the HSV round trip
// needs none of the TPU's lane rolls; a block never spans two images
// (blockIdx.y is the image), so the per-image branches do not diverge.
// Every step mirrors the plain version (ops/kernels/photometric.py) op for
// op: true divisions, floor-mod as fmodf plus a sign fix (torch.remainder),
// and the library is built with -fmad=false.
//
// Noise: the TPU seeds its hardware PRNG per (image, row block), which a
// GPU cannot reproduce. Here the bits are a counter-based hash of the
// image's seed and the element's index e = (y W + x) 3 + c within the image:
//   bits = fmix32(e * 0x9E3779B1 + fmix32(seed))   (murmur3's finaliser)
// then the TPU's own Box-Muller on the two 16-bit halves (_normal_bits).
// The plain version computes the same bits exactly in int64.
// Bound on the card: bytes (3 B read and written per pixel); the HSV and
// noise rows add some 60 flops and two transcendentals per element.
#include <cuda_runtime.h>

#include <cstdint>

#include "pixel_io.cuh"

#define F32(x) ((float)(x))

namespace {

using mmtrs::q8;

enum { P_BRIGHT, P_CONTRAST, P_DH, P_DS, P_DV, P_USE_HSV, P_SIGMA, P_DROP, P_Y0, P_X0, N_PARAMS };

__device__ __forceinline__ float fmod_floor(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float normal_of(uint32_t key, uint32_t e) {
  const uint32_t bits = fmix32(e * 0x9E3779B1u + key);
  const float u1 = (float)(bits & 0xFFFFu) * F32(1.0 / 65536.0);
  const float u2 = (float)((bits >> 16) & 0xFFFFu) * F32(1.0 / 65536.0);
  const float rad = sqrtf(-2.0f * logf(1.0f - u1));
  return rad * cosf(F32(2.0 * 3.141592653589793) * u2);
}

// rgb_to_hsv → shift → hsv_to_rgb (ops/color.py), on 0..255 values in place
__device__ void hsv_shift(float* px, float dh, float ds, float dv) {
  const float r = px[0] / 255.0f, g = px[1] / 255.0f, b = px[2] / 255.0f;
  const float v = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float c = v - mn;
  const float safe_c = c > 0.0f ? c : 1.0f;
  float h;
  if (v == r)
    h = (g - b) / safe_c;
  else if (v == g)
    h = 2.0f + (b - r) / safe_c;
  else
    h = 4.0f + (r - g) / safe_c;
  h = c > 0.0f ? fmod_floor(h * 60.0f, 360.0f) : 0.0f;
  const float s = v > 0.0f ? c / v : 0.0f;

  const float H = fmod_floor(h / 2.0f + dh, 180.0f);
  const float S = fminf(fmaxf(s * 255.0f + ds, 0.0f), 255.0f);
  const float V = fminf(fmaxf(v * 255.0f + dv, 0.0f), 255.0f);

  const float hh = fmod_floor(H * 2.0f, 360.0f);
  const float ss = S / 255.0f, vv = V / 255.0f;
  const float cc = vv * ss;
  const float hp = hh / 60.0f;
  const float xc = cc * (1.0f - fabsf(fmod_floor(hp, 2.0f) - 1.0f));
  int idx = (int)floorf(hp) % 6;
  if (idx < 0) idx += 6;
  float rp, gp, bp;
  switch (idx) {
    case 0: rp = cc, gp = xc, bp = 0.0f; break;
    case 1: rp = xc, gp = cc, bp = 0.0f; break;
    case 2: rp = 0.0f, gp = cc, bp = xc; break;
    case 3: rp = 0.0f, gp = xc, bp = cc; break;
    case 4: rp = xc, gp = 0.0f, bp = cc; break;
    default: rp = cc, gp = 0.0f, bp = xc; break;
  }
  const float m = vv - cc;
  px[0] = fminf(fmaxf((rp + m) * 255.0f, 0.0f), 255.0f);
  px[1] = fminf(fmaxf((gp + m) * 255.0f, 0.0f), 255.0f);
  px[2] = fminf(fmaxf((bp + m) * 255.0f, 0.0f), 255.0f);
}

__global__ void photometric_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                   const float* __restrict__ params,
                                   const int32_t* __restrict__ seeds, int H, int W,
                                   float hole) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const float* P = params + (size_t)b * N_PARAMS;
  const size_t base = ((size_t)b * H * W + p) * 3;

  float px[3];
  const float scale = 1.0f + P[P_CONTRAST];
  const float shift = P[P_BRIGHT] * 255.0f;
  for (int ch = 0; ch < 3; ++ch) px[ch] = q8((float)in[base + ch] * scale + shift);

  if (P[P_USE_HSV] > 0.0f) {
    hsv_shift(px, P[P_DH], P[P_DS], P[P_DV]);
    for (int ch = 0; ch < 3; ++ch) px[ch] = q8(px[ch]);
  }
  const float sigma = P[P_SIGMA];
  if (sigma > 0.0f) {
    const uint32_t key = fmix32((uint32_t)seeds[b]);
    for (int ch = 0; ch < 3; ++ch)
      px[ch] = q8(px[ch] + normal_of(key, (uint32_t)(p * 3 + ch)) * sigma);
  }
  if (P[P_DROP] > 0.0f) {
    const float yf = (float)(p / W), xf = (float)(p % W);
    const float y0 = P[P_Y0], x0 = P[P_X0];
    if (yf >= y0 && yf < y0 + hole && xf >= x0 && xf < x0 + hole) px[0] = px[1] = px[2] = 0.0f;
  }
  for (int ch = 0; ch < 3; ++ch) out[base + ch] = (uint8_t)(int)px[ch];
}

}  // namespace

extern "C" int mmtrs_photometric(const void* in, void* out, const void* params,
                                 const void* seeds, int B, int H, int W, float hole,
                                 void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((H * W + threads - 1) / threads), (unsigned)B);
  photometric_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const float*)params, (const int32_t*)seeds, H, W,
      hole);
  return (int)cudaGetLastError();
}
