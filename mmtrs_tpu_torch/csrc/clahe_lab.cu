// CLAHE on the LAB L channel of a u8 RGB batch, as two kernels.
//
// K1 mmtrs_clahe_lab_fwd_lut replaces the Pallas kernels
//   mmtrs_tpu/ops/pallas/lab_kernels.py:_fwd_kernel (u8 RGB -> u8 L, i8 a, i8 b)
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_hist_lut_kernel_img (tile hist + LUT).
// One block per (image, tile): it reads the tile's interleaved RGB once,
// writes the quantised L and chroma planes, counts L in a 256-bin shared
// histogram with integer atomics, then clips, redistributes (OpenCV's
// integer rule) and block-scans it into the tile's u8 LUT row.
// Bound on the card: bytes, 3 B/px read + 3 B/px written; the LUT rows are
// 256 B per tile. The TPU kernel's nibble one-hot matmul and log-roll scan
// are gone: the H100 has shared-memory atomics and a cheap in-block scan.
//
// K2 mmtrs_clahe_apply_lab_bwd replaces
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_apply_kernel_img (4-LUT blend)
//   mmtrs_tpu/ops/pallas/lab_kernels.py:_bwd_kernel (LAB -> u8 RGB).
// One thread per pixel gathers its 4 neighbouring tile LUT entries directly
// (the TPU's W @ onehot gather substitute and host quadrant weights are not
// needed), blends them with the oracle's formula and order
// (mmtrs_tpu/ops/clahe.py:84-109), stores L' as u8 round-half-up in a
// register and runs the backward LAB conversion; L' never reaches device
// memory. Bound on the card: bytes, 3 B/px read + 3 B/px written, plus LUT
// reads that stay in L1/L2 (64 tiles x 256 B per image).
#include <cuda_runtime.h>

#include <cstdint>

#include "lab_math.cuh"

namespace {

constexpr int kBins = 256;

__global__ void __launch_bounds__(kBins)
fwd_lut_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ lq,
               int8_t* __restrict__ da, int8_t* __restrict__ db,
               uint8_t* __restrict__ lut, int H, int W, int ty, int tx,
               int limit, float lut_scale) {
  __shared__ int hist[kBins];
  __shared__ int scan[kBins];
  __shared__ int excess;
  const int tile = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const int th = H / ty, tw = W / tx;
  const int y0 = (tile / tx) * th, x0 = (tile % tx) * tw;

  hist[i] = 0;
  if (i == 0) excess = 0;
  __syncthreads();

  for (int p = i; p < th * tw; p += kBins) {
    const size_t pix = ((size_t)b * H + y0 + p / tw) * W + x0 + p % tw;
    const uint8_t* px = rgb + pix * 3;
    uint8_t l;
    int8_t a, c;
    mmtrs::rgb_to_lab_q(px[0], px[1], px[2], &l, &a, &c);
    lq[pix] = l;
    da[pix] = a;
    db[pix] = c;
    atomicAdd(&hist[l], 1);
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

__global__ void apply_bwd_kernel(const uint8_t* __restrict__ lq,
                                 const int8_t* __restrict__ da,
                                 const int8_t* __restrict__ db,
                                 const uint8_t* __restrict__ lut,
                                 uint8_t* __restrict__ out, int B, int H, int W,
                                 int ty, int tx) {
  const size_t pix = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (size_t)B * H * W) return;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const int b = (int)(pix / ((size_t)W * H));
  const int th = H / ty, tw = W / tx;

  // OpenCV tile coordinate arange/t - 0.5, edge-clamped (clahe.py:84-91)
  const float fy = (float)y / (float)th - 0.5f;
  const float fx = (float)x / (float)tw - 0.5f;
  const int y0 = (int)fminf(fmaxf(floorf(fy), 0.0f), (float)(ty - 1));
  const int x0 = (int)fminf(fmaxf(floorf(fx), 0.0f), (float)(tx - 1));
  const int y1 = min(y0 + 1, ty - 1), x1 = min(x0 + 1, tx - 1);
  const float wy = fminf(fmaxf(fy - (float)y0, 0.0f), 1.0f);
  const float wx = fminf(fmaxf(fx - (float)x0, 0.0f), 1.0f);

  const int l = lq[pix];
  const uint8_t* lb = lut + (size_t)b * ty * tx * kBins + l;
  const float v00 = lb[(y0 * tx + x0) * kBins], v01 = lb[(y0 * tx + x1) * kBins];
  const float v10 = lb[(y1 * tx + x0) * kBins], v11 = lb[(y1 * tx + x1) * kBins];
  const float blend = v00 * (1.0f - wy) * (1.0f - wx) + v01 * (1.0f - wy) * wx +
                      v10 * wy * (1.0f - wx) + v11 * wy * wx;
  const float l2 = (float)mmtrs::q_u8(blend);
  mmtrs::lab_q_to_rgb(l2, da[pix], db[pix], out + pix * 3);
}

}  // namespace

extern "C" int mmtrs_clahe_lab_fwd_lut(const void* rgb, void* lq, void* da,
                                       void* db, void* lut, int B, int H, int W,
                                       int ty, int tx, int limit, float lut_scale,
                                       void* stream) {
  const dim3 grid(ty * tx, B);
  fwd_lut_kernel<<<grid, kBins, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (uint8_t*)lq, (int8_t*)da, (int8_t*)db,
      (uint8_t*)lut, H, W, ty, tx, limit, lut_scale);
  return (int)cudaGetLastError();
}

extern "C" int mmtrs_clahe_apply_lab_bwd(const void* lq, const void* da,
                                         const void* db, const void* lut,
                                         void* out, int B, int H, int W, int ty,
                                         int tx, void* stream) {
  const size_t n = (size_t)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  apply_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)lq, (const int8_t*)da, (const int8_t*)db,
      (const uint8_t*)lut, (uint8_t*)out, B, H, W, ty, tx);
  return (int)cudaGetLastError();
}
