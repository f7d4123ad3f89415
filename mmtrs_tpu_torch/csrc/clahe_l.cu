// CLAHE on a u8 L plane, as two kernels.
//
// K8 mmtrs_clahe_hist_lut replaces
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_hist_lut_kernel (per tile row)
// and takes the L-plane role of
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_hist_lut_kernel_img (per image),
// both reached through clahe_pallas on the L-plane route. It computes what
// K1's histogram half does (csrc/clahe_lab.cu), without the LAB conversion:
// one 256-thread block per (image, tile) counts the tile's u8 L values in a
// 256-bin shared histogram with integer atomics, clips at OpenCV's integer
// limit, redistributes the excess (OpenCV's integer rule), block-scans the
// bins and stores rint(cdf * f32(255/area)) clipped to 0..255 as the tile's
// u8 LUT row. The TPU's one-tile-row-per-grid-step granularity is a TPU
// scheduling choice and is not carried over. Each thread issues 4 loads
// before its 4 atomics, so an archive tile (378 x 504 px at 3024 x 4032,
// ~744 px a thread) keeps several loads in flight.
// Bound on the card: bytes, 1 B/px read once; the LUT rows are 256 B a tile.
//
// K9 mmtrs_clahe_apply replaces
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_apply_kernel_img
// on the L plane: one thread per pixel gathers its 4 neighbouring tile LUT
// entries and blends them as K2 does (true divisions y/th, the oracle's
// formula and order, mmtrs_tpu/ops/clahe.py:84-109), storing f32 (the
// interpolated value) or u8 round-half-up (cv2's saturate_cast<uchar>).
// The grid is (column blocks, H, B), so a block's row values are uniform and
// no 64-bit index division is needed. The TPU's W @ onehot matmul and host
// quadrant weights are not needed: the card gathers.
// Bound on the card: bytes, 1 B/px read + 1 or 4 B/px written; the LUTs
// (ty*tx*256 B an image) stay in L1/L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "lab_math.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kLoads = 4;

__global__ void __launch_bounds__(kBins)
hist_lut_kernel(const uint8_t* __restrict__ l, uint8_t* __restrict__ lut,
                int H, int W, int ty, int tx, int limit, float lut_scale) {
  __shared__ int hist[kBins];
  __shared__ int scan[kBins];
  __shared__ int excess;
  const int tile = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const int th = H / ty, tw = W / tx, area = th * tw;
  const size_t base = ((size_t)b * H + (size_t)(tile / tx) * th) * W +
                      (size_t)(tile % tx) * tw;

  hist[i] = 0;
  if (i == 0) excess = 0;
  __syncthreads();

  for (int p0 = i; p0 < area; p0 += kLoads * kBins) {
    int v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = p0 + u * kBins;
      v[u] = p < area ? (int)l[base + (size_t)(p / tw) * W + p % tw] : -1;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (v[u] >= 0) atomicAdd(&hist[v[u]], 1);
    }
  }
  __syncthreads();

  // clip at the integer limit; OpenCV redistribution (clahe.cpp calcLut):
  // excess // 256 to every bin, +1 to the first `resid` bins at step
  // max(256 // resid, 1)
  const int h = hist[i];
  if (h > limit) atomicAdd(&excess, h - limit);
  __syncthreads();
  const int batch_add = excess / kBins;
  const int resid = excess - batch_add * kBins;
  const int step = max(kBins / max(resid, 1), 1);
  const int bonus = (i % step == 0) && (i / step < resid);
  scan[i] = min(h, limit) + batch_add + bonus;
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {  // inclusive Hillis-Steele scan
    const int add = i >= off ? scan[i - off] : 0;
    __syncthreads();
    scan[i] += add;
    __syncthreads();
  }
  // round-half-even of cdf * f32((256-1)/area), clipped: exact in u8
  const float v = fminf(fmaxf(rintf((float)scan[i] * lut_scale), 0.0f), 255.0f);
  lut[((size_t)b * ty * tx + tile) * kBins + i] = (uint8_t)(int)v;
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(uint8_t* o, float v) { *o = mmtrs::q_u8(v); }

template <typename Out>
__global__ void apply_kernel(const uint8_t* __restrict__ l,
                             const uint8_t* __restrict__ lut,
                             Out* __restrict__ out, int H, int W, int ty, int tx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y, b = blockIdx.z;
  const int th = H / ty, tw = W / tx;

  // OpenCV tile coordinate arange/t - 0.5, edge-clamped (clahe.py:84-91)
  const float fy = (float)y / (float)th - 0.5f;
  const float fx = (float)x / (float)tw - 0.5f;
  const int y0 = (int)fminf(fmaxf(floorf(fy), 0.0f), (float)(ty - 1));
  const int x0 = (int)fminf(fmaxf(floorf(fx), 0.0f), (float)(tx - 1));
  const int y1 = min(y0 + 1, ty - 1), x1 = min(x0 + 1, tx - 1);
  const float wy = fminf(fmaxf(fy - (float)y0, 0.0f), 1.0f);
  const float wx = fminf(fmaxf(fx - (float)x0, 0.0f), 1.0f);

  const size_t pix = ((size_t)b * H + y) * W + x;
  const uint8_t* lb = lut + (size_t)b * ty * tx * kBins + l[pix];
  const float v00 = lb[(y0 * tx + x0) * kBins], v01 = lb[(y0 * tx + x1) * kBins];
  const float v10 = lb[(y1 * tx + x0) * kBins], v11 = lb[(y1 * tx + x1) * kBins];
  store(out + pix, v00 * (1.0f - wy) * (1.0f - wx) + v01 * (1.0f - wy) * wx +
                       v10 * wy * (1.0f - wx) + v11 * wy * wx);
}

}  // namespace

extern "C" int mmtrs_clahe_hist_lut(const void* l, void* lut, int B, int H, int W,
                                    int ty, int tx, int limit, float lut_scale,
                                    void* stream) {
  const dim3 grid(ty * tx, B);
  hist_lut_kernel<<<grid, kBins, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)l, (uint8_t*)lut, H, W, ty, tx, limit, lut_scale);
  return (int)cudaGetLastError();
}

extern "C" int mmtrs_clahe_apply(const void* l, const void* lut, void* out, int B,
                                 int H, int W, int ty, int tx, int out_u8,
                                 void* stream) {
  const int threads = 256;
  const dim3 grid((W + threads - 1) / threads, H, B);
  if (out_u8) {
    apply_kernel<uint8_t><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)l, (const uint8_t*)lut, (uint8_t*)out, H, W, ty, tx);
  } else {
    apply_kernel<float><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)l, (const uint8_t*)lut, (float*)out, H, W, ty, tx);
  }
  return (int)cudaGetLastError();
}
