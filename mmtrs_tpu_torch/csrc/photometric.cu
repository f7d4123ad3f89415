// K5 mmtrs_photometric: the `legacy` preset's pointwise photometric pass on
// a u8 NHWC RGB batch, with a u8 store after every stage.
//
// Replaces mmtrs_tpu/ops/pallas/photometric_kernel.py:_photometric_kernel
// (ops/augment.py legacy_photometrics). Per image b, params[b] holds
// (brightness, contrast, dh, ds, dv, use_hsv, sigma, dropout, y0, x0):
//   1. q8(x (1 + contrast) + brightness 255)
//   2. if use_hsv > 0: q8(hsv_shift(x, dh, ds, dv))   (ops/color.py hsv_shift)
//   3. if sigma > 0:   q8(x + sigma n), n a standard normal per element
//   4. if dropout > 0: zero the hole x hole square at (y0, x0)
// q8(v) = floor(clip(v, 0, 255) + 0.5) is the chain's round-half-up store.
// Every value is bit for bit the plain version's (ops/kernels/photometric.py):
// each f32 step is the same IEEE operation, the library is built with
// -fmad=false, and whatever replaces a step below gives the same bits.
//
// Noise: the TPU seeds its hardware PRNG per (image, row block), which a
// GPU cannot reproduce. Here the bits are a counter-based hash of the
// image's seed and the element's index e = (y W + x) 3 + c within the image:
//   bits = fmix32(e * 0x9E3779B1 + fmix32(seed))   (murmur3's finaliser)
// then the TPU's own Box-Muller on the two 16-bit halves (_normal_bits).
// The plain version computes the same bits exactly in int64.
//
// Bound on the card: bytes (3 B read and 3 written per pixel) for the
// images that run stage 1 alone, most of the chain's, often as the
// identity; the HSV and noise stages are bound by their f32 instructions
// (logf, sqrtf and cosf per noise element dominate). So:
// - an image is one contiguous run of H W 3 bytes. A thread owns 8 pixels
//   (24 bytes, three 8-byte words) that it loads and stores as whole words
//   on the output's 8-byte grid; the pixels of an image before that grid
//   (head) and after its last whole 8 (tail) go byte by byte in one thread,
//   and an input on another grid than its output (a view that starts at
//   another byte) is read byte by byte. A block never spans two images, so
//   every per-image branch is uniform over a block.
// - the heaviest images go first: the blocks of grid row y take the y-th
//   image in order of noise, then HSV (each warp ranks the images with
//   ballots), so the long blocks start first and the short ones fill in
//   behind them instead of a few long ones running last on an idle card.
//   Eight pixels a thread keep enough threads on the heavy images to hide
//   the transcendentals' latency (16 left phase 2's mix slower than one
//   thread a pixel).
// - stage 1 is a function of one byte per image: a 256-entry u8 table in
//   shared memory that each block builds with the same f32 expression; the
//   identity (contrast and brightness 0) skips it.
// - an image with HSV, noise or a hole stages each chunk in shared memory
//   (a row of 7 words a thread, so a warp's byte reads fall on 32 banks)
//   and walks its pixels in a loop compiled for the stages it runs; the
//   others keep their chunk in registers.
// - HSV: k / 255 of the three input bytes from a 256-entry table built with
//   the same division; each floor-mod is a select of a, a - b or a + b on
//   the range (-b, 2b) the stage meets (fmod(a, b) of a in [b, 2b) is a - b
//   exactly, Sterbenz; of a in (-b, 0) it is a, which the sign fix moves by
//   b), with fmodf kept for anything outside; hp's mod 2 is hp - 2, hp - 4
//   (exact on [2, 6)) and its sector a truncation; the six-way pick is
//   selects. The true divisions by safe_c, v, 255 (of S and V) and 60 stay.
// - noise: the hash, then logf, sqrtf and cosf as the plain version (tables
//   of them in the L2 measured slower: a warp's 32 scattered reads cost more
//   than the arithmetic), logf as K1's log_normal (lab_math.cuh), the
//   toolkit's own instructions less its branches for zero, subnormal and
//   infinite x, which 1 - u1 in [2^-16, 1] never is; the halves become
//   floats by exact magic numbers, not the conversion unit.
// - the hole: a chunk's row and column once, then stepped per pixel.
#include <cuda_runtime.h>

#include <cstdint>

#include "lab_math.cuh"
#include "line_stage.cuh"

namespace {

using mmtrs::byte_f;
using mmtrs::log_normal;
using mmtrs::q8_bits;

enum { P_BRIGHT, P_CONTRAST, P_DH, P_DS, P_DV, P_USE_HSV, P_SIGMA, P_DROP, P_Y0, P_X0, N_PARAMS };

constexpr int kThreads = 256;  // a block's threads, one entry each of its byte tables
constexpr int kPx = 8;         // pixels a thread owns: 24 bytes, three 8-byte words
constexpr int kWords = 6;      // those bytes as 4-byte words
constexpr int kPitch = 7;      // words of a thread's row in the stage: odd, so a warp's rows start on 32 banks

__shared__ uint8_t s_lut[kThreads];   // stage 1: q8(k (1 + contrast) + brightness 255)
__shared__ float s_inv255[kThreads];  // k / 255

// floor-mod as torch.remainder computes it: fmod plus a sign fix
__device__ __forceinline__ float fmod_floor(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// fmod_floor(a, b) for b > 0 without the remainder loop on (-b, 2b)
__device__ __forceinline__ float mod_near(float a, float b) {
  if (!(a > -b && a < 2.0f * b)) return fmod_floor(a, b);
  return a < 0.0f ? a + b : (a >= b ? a - b : a);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// a 16-bit integer as a float, exactly (see line_stage.cuh's tap_of)
__device__ __forceinline__ float f16bits(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ float normal_of(uint32_t key, uint32_t e) {
  const uint32_t bits = fmix32(e * 0x9E3779B1u + key);
  const float u1 = f16bits(bits & 0xFFFFu) * F32(1.0 / 65536.0);
  const float u2 = f16bits(bits >> 16) * F32(1.0 / 65536.0);
  const float rad = sqrtf(-2.0f * log_normal(1.0f - u1));  // 1 - u1 in [2^-16, 1]
  return rad * cosf(F32(2.0 * 3.141592653589793) * u2);
}

// What one image asks of its pixels.
struct Image {
  float dh, ds, dv, sigma, y0, y1, x0, x1;
  uint32_t key;  // fmix32(seed)
  bool bc;       // stage 1 is not the identity: s_lut holds it
  bool hsv, noise, drop;
};

// rgb_to_hsv → shift → hsv_to_rgb (ops/color.py) on one pixel's bytes,
// stored u8 in place
__device__ __forceinline__ void hsv_shift(uint32_t q[3], const Image& I) {
  const float r = s_inv255[q[0]], g = s_inv255[q[1]], b = s_inv255[q[2]];
  const float v = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float c = v - mn;
  const float safe_c = c > 0.0f ? c : 1.0f;
  const bool is_r = v == r, is_g = !is_r && v == g;
  const float t = (is_r ? g - b : (is_g ? b - r : r - g)) / safe_c;
  float h = is_r ? t : (is_g ? 2.0f + t : 4.0f + t);
  h = c > 0.0f ? mod_near(h * 60.0f, 360.0f) : 0.0f;
  const float s = v > 0.0f ? c / (v > 0.0f ? v : 1.0f) : 0.0f;  // no 0 / 0 even if selected

  const float H = mod_near(h * 0.5f + I.dh, 180.0f);
  const float S = fminf(fmaxf(s * 255.0f + I.ds, 0.0f), 255.0f);
  const float V = fminf(fmaxf(v * 255.0f + I.dv, 0.0f), 255.0f);

  const float hh = mod_near(H * 2.0f, 360.0f);
  const float ss = S / 255.0f, vv = V / 255.0f;
  const float cc = vv * ss;
  const float hp = hh / 60.0f;
  float f;  // fmod_floor(hp, 2)
  int k;    // floor(hp) mod 6
  if (hp >= 0.0f && hp < 6.0f) {
    f = hp - (hp >= 4.0f ? 4.0f : (hp >= 2.0f ? 2.0f : 0.0f));
    k = (int)hp;
  } else {
    f = fmod_floor(hp, 2.0f);
    k = (int)floorf(hp) % 6;
    if (k < 0) k += 6;
  }
  const float xc = cc * (1.0f - fabsf(f - 1.0f));
  const float rp = (k == 0 || k == 5) ? cc : ((k == 1 || k == 4) ? xc : 0.0f);
  const float gp = (k == 1 || k == 2) ? cc : ((k == 0 || k == 3) ? xc : 0.0f);
  const float bp = (k == 3 || k == 4) ? cc : ((k == 2 || k == 5) ? xc : 0.0f);
  const float m = vv - cc;
  q[0] = q8_bits(fminf(fmaxf((rp + m) * 255.0f, 0.0f), 255.0f));
  q[1] = q8_bits(fminf(fmaxf((gp + m) * 255.0f, 0.0f), 255.0f));
  q[2] = q8_bits(fminf(fmaxf((bp + m) * 255.0f, 0.0f), 255.0f));
}

// Every stage on pixel p of an image, at row yf and column xf, its bytes in
// q; kHsv and kNoise false leave out a stage the image does not run.
template <bool kHsv, bool kNoise>
__device__ __forceinline__ void run_pixel(uint32_t q[3], uint32_t p, float yf, float xf,
                                          const Image& I) {
  if (I.bc)
    for (int c = 0; c < 3; ++c) q[c] = s_lut[q[c]];
  if (kHsv && I.hsv) hsv_shift(q, I);
  if (kNoise && I.noise)
    for (int c = 0; c < 3; ++c)
      q[c] = q8_bits(byte_f(q[c], 0) + normal_of(I.key, p * 3u + (uint32_t)c) * I.sigma);
  if (I.drop && yf >= I.y0 && yf < I.y1 && xf >= I.x0 && xf < I.x1) q[0] = q[1] = q[2] = 0;
}

// Stage 1 on the four bytes of a word.
__device__ __forceinline__ uint32_t map_word(uint32_t w) {
  return (uint32_t)s_lut[w & 0xFFu] | (uint32_t)s_lut[(w >> 8) & 0xFFu] << 8 |
         (uint32_t)s_lut[(w >> 16) & 0xFFu] << 16 | (uint32_t)s_lut[w >> 24] << 24;
}

// A chunk of kPx pixels from p0 on an image with HSV, noise or a hole: staged
// in the thread's row of shared memory, walked pixel by pixel.
template <bool kHsv, bool kNoise>
__device__ __forceinline__ void heavy_chunk(uint32_t w[kWords], uint32_t* row, int p0, int W,
                                            const Image& I) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) row[i] = w[i];
  uint8_t* px = reinterpret_cast<uint8_t*>(row);
  int y = p0 / W, x = p0 - y * W;
  float yf = (float)y, xf = (float)x;
#pragma unroll 1
  for (int k = 0; k < kPx; ++k) {
    uint32_t q[3] = {px[3 * k], px[3 * k + 1], px[3 * k + 2]};
    run_pixel<kHsv, kNoise>(q, (uint32_t)(p0 + k), yf, xf, I);
    px[3 * k] = (uint8_t)q[0], px[3 * k + 1] = (uint8_t)q[1], px[3 * k + 2] = (uint8_t)q[2];
    xf += 1.0f;
    if (++x == W) x = 0, xf = 0.0f, yf += 1.0f;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = row[i];
}

__device__ __forceinline__ void edge_pixel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                           int p, int W, const Image& I) {
  uint32_t q[3] = {src[3 * p], src[3 * p + 1], src[3 * p + 2]};
  const int y = p / W;
  run_pixel<true, true>(q, (uint32_t)p, (float)y, (float)(p - y * W), I);
  dst[3 * p] = (uint8_t)q[0], dst[3 * p + 1] = (uint8_t)q[1], dst[3 * p + 2] = (uint8_t)q[2];
}

// The image of the blocks with blockIdx.y == y: the y-th heaviest of the B
// images (noise before HSV before the rest, in batch order within each), so
// that the blocks the card dispatches first are the long ones and the short
// ones fill in behind them. Each warp ranks the images itself with ballots
// (no block barrier); batch order above kMaxRanked images.
constexpr int kMaxRanked = 1024;

__device__ __forceinline__ int weight_of(const float* __restrict__ params, int B, int i) {
  if (i >= B) return -1;
  const float* P = params + (size_t)i * N_PARAMS;
  return 2 * (P[P_SIGMA] > 0.0f) + (P[P_USE_HSV] > 0.0f);
}

__device__ __forceinline__ int image_of(const float* __restrict__ params, int B, int y) {
  if (B > kMaxRanked) return y;
  const int lane = threadIdx.x & 31;
  int n3 = 0, n2 = 0, n1 = 0;  // images of weight 3, 2 and 1
  for (int i0 = 0; i0 < B; i0 += 32) {
    const int w = weight_of(params, B, i0 + lane);
    n3 += __popc(__ballot_sync(0xFFFFFFFFu, w == 3));
    n2 += __popc(__ballot_sync(0xFFFFFFFFu, w == 2));
    n1 += __popc(__ballot_sync(0xFFFFFFFFu, w == 1));
  }
  // rank y is the k-th image of weight c
  const int c = y < n3 ? 3 : y < n3 + n2 ? 2 : y < n3 + n2 + n1 ? 1 : 0;
  int k = y - (c < 3 ? n3 : 0) - (c < 2 ? n2 : 0) - (c < 1 ? n1 : 0);
  for (int i0 = 0;; i0 += 32) {
    uint32_t m = __ballot_sync(0xFFFFFFFFu, weight_of(params, B, i0 + lane) == c);
    if (k < __popc(m)) {
      for (; k > 0; --k) m &= m - 1;
      return i0 + __ffs(m) - 1;
    }
    k -= __popc(m);
  }
}

// grid (ceil(n / (kPx kThreads)), B); n = H W pixels an image, 3 n < 2^31.
// Job j of an image is its chunk of pixels head + kPx j .. + kPx for
// j < body, and its head and tail for j == body (that job exists whenever
// they hold a pixel: then kPx body < n).
__global__ void __launch_bounds__(kThreads)
    photometric_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       const float* __restrict__ params, const int32_t* __restrict__ seeds,
                       int n, int W, float hole) {
  __shared__ uint32_t stage[kThreads * kPitch];
  const int t = threadIdx.x;
  const int b = image_of(params, gridDim.y, blockIdx.y);
  const float* P = params + (size_t)b * N_PARAMS;
  const float scale = 1.0f + P[P_CONTRAST], shift = P[P_BRIGHT] * 255.0f;
  Image I;
  I.bc = !(scale == 1.0f && shift == 0.0f);
  I.hsv = P[P_USE_HSV] > 0.0f;
  I.noise = P[P_SIGMA] > 0.0f;
  I.drop = P[P_DROP] > 0.0f;
  I.dh = P[P_DH], I.ds = P[P_DS], I.dv = P[P_DV], I.sigma = P[P_SIGMA];
  I.y0 = P[P_Y0], I.x0 = P[P_X0];
  I.y1 = I.y0 + hole, I.x1 = I.x0 + hole;
  I.key = fmix32((uint32_t)seeds[b]);
  if (I.bc) s_lut[t] = (uint8_t)q8_bits(byte_f((uint32_t)t, 0) * scale + shift);
  if (I.hsv) s_inv255[t] = byte_f((uint32_t)t, 0) / 255.0f;
  if (I.bc || I.hsv) __syncthreads();

  const size_t img = (size_t)b * (size_t)n * 3;
  const uint8_t* src = in + img;
  uint8_t* dst = out + img;
  // 3 head = -dst (mod 8), and 3 * 3 = 1 (mod 8)
  const int head = min((int)(((8u - ((uint32_t)(uintptr_t)dst & 7u)) * 3u) & 7u), n);
  const int body = (n - head) / kPx;
  const int j = blockIdx.x * kThreads + t;
  if (j < body) {
    const int p0 = head + j * kPx;
    const uint8_t* s = src + 3 * p0;
    uint32_t w[kWords];
    if (((uintptr_t)s & 7u) == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(s) + i);
        w[2 * i] = v.x, w[2 * i + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[i] = (uint32_t)s[4 * i] | (uint32_t)s[4 * i + 1] << 8 | (uint32_t)s[4 * i + 2] << 16 |
               (uint32_t)s[4 * i + 3] << 24;
    }
    uint32_t* row = stage + t * kPitch;
    if (I.hsv && I.noise) {
      heavy_chunk<true, true>(w, row, p0, W, I);
    } else if (I.hsv) {
      heavy_chunk<true, false>(w, row, p0, W, I);
    } else if (I.noise) {
      heavy_chunk<false, true>(w, row, p0, W, I);
    } else if (I.drop) {
      heavy_chunk<false, false>(w, row, p0, W, I);
    } else if (I.bc) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = map_word(w[i]);
    }
    uint2* d = reinterpret_cast<uint2*>(dst + 3 * p0);
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else if (j == body) {
    const int tail0 = head + body * kPx, edges = head + n - tail0;
    for (int i = 0; i < edges; ++i) edge_pixel(src, dst, i < head ? i : tail0 + i - head, W, I);
  }
}

}  // namespace

extern "C" int mmtrs_photometric(const void* in, void* out, const void* params,
                                 const void* seeds, int B, int H, int W, int blocks, float hole,
                                 void* stream) {
  photometric_kernel<<<dim3((unsigned)blocks, (unsigned)B), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const float*)params, (const int32_t*)seeds, H * W, W,
      hole);
  return (int)cudaGetLastError();
}
