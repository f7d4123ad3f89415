// Shared-memory staging of image lines for the line kernels: K3 and K6
// (shift_rows.cu) and K4 (resample_rows.cu).
//
// Each of them copies the lines it reads into shared memory with 16-byte
// loads, computes its values there, and writes the result lines back with
// 16-byte stores. Lines start at any byte (an NHWC row of W*C bytes need not
// be a multiple of 16), so a copy runs on the pointer's aligned 16-byte grid
// and moves the partial chunks at either end byte by byte. Values go between
// u8 and f32 by exact magic numbers, not the conversion unit (a quarter-rate
// pipe on the card), bit for bit what a conversion gives; K5
// (photometric.cu) takes those conversions too.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mmtrs {

constexpr int kChunk = 16;              // bytes of one vector load or store
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr int kMaxSmem = 200 * 1024;    // the most a launch opts in to

__host__ __device__ __forceinline__ int round16(int v) { return (v + kChunk - 1) / kChunk * kChunk; }

// Bytes of shared memory that hold `nbytes` of a line at any alignment.
__host__ __device__ __forceinline__ int line_pitch(int nbytes) { return round16(nbytes + kChunk - 1); }

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

// The chunks of a line of `nbytes` that starts at byte `shift` of the grid.
__device__ __forceinline__ int chunks_of(int shift, int nbytes) {
  return (shift + nbytes + kChunk - 1) / kChunk;
}

// u8 <-> f32 without the conversion unit: b | 0x4B000000 is the float
// 2^23 + b, so subtracting 2^23 gives b exactly; and the chain's u8 store
// floor(clip(v, 0, 255) + 0.5) (round-half-up, the Pallas kernels'
// _quant_u8) is the low byte of (clip(v, 0, 255) + 0.5) + 2^23 added
// rounding down, which is 2^23 + that floor.
__device__ __forceinline__ float tap_of(const uint8_t* p) {
  return __uint_as_float(0x4B000000u | (uint32_t)*p) - 8388608.0f;
}
__device__ __forceinline__ float tap_of(const float* p) { return *p; }
__device__ __forceinline__ uint32_t q8_bits(float v) {
  const float y = fminf(fmaxf(v, 0.0f), 255.0f) + 0.5f;
  return __float_as_uint(__fadd_rd(y, 8388608.0f)) & 0xFFu;
}
__device__ __forceinline__ void put(uint8_t* p, float v) { *p = (uint8_t)q8_bits(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// The 4 bytes at p (any alignment) of shared memory, from its two words.
__device__ __forceinline__ uint32_t word_at(const unsigned char* p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>((uintptr_t)p & ~(uintptr_t)3);
  return __funnelshift_r(w[0], w[1], ((uint32_t)(uintptr_t)p & 3u) * 8u);
}

// Byte j of x as a float: 0x4B0000xx is 2^23 + x_j (see tap_of).
__device__ __forceinline__ float byte_f(uint32_t x, int j) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + j)) - 8388608.0f;
}

// The samples p = 0..n-1 of a line shifted by o that take the blend are
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

}  // namespace mmtrs
