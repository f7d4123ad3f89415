// CLAHE on the LAB L channel of a u8 RGB batch, as two kernels.
//
// K1 mmtrs_clahe_lab_fwd_lut replaces the Pallas kernels
//   mmtrs_tpu/ops/pallas/lab_kernels.py:_fwd_kernel (u8 RGB -> u8 L, i8 a, i8 b)
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_hist_lut_kernel_img (tile hist + LUT).
// A tile is one block, or a cluster of 2 or 4 blocks (Hopper thread-block
// clusters) when the batch has too few tiles to give every SM two blocks.
// Each block walks its rows of the tile four pixels a thread: 12 bytes of
// RGB in three 32-bit loads, each plane out four pixels to a 32-bit store,
// row and column advanced without a division. The gamma decode takes 256
// values, so a block fills a table of it in shared memory with the same
// device function and the per-pixel code reads it; the XYZ sums, the
// white-point divisions, f_lab and the quantisers run per pixel as before.
// L is counted in per-warp sub-histograms: a warp whose 128 pixels share one
// L adds once, a thread whose 4 pixels do adds once, other pixels add one
// each, so neither a flat tile nor a mixed one serialises 32 lanes on one
// bin (a __match_any_sync per pixel measured slower on teeth and random
// pixels). A cluster's blocks merge their counts into the leader's through
// distributed shared memory; the leader clips, redistributes (OpenCV's
// integer rule) and scans (warp shuffles) into the tile's u8 LUT row.
// Bound on the card: bytes, 3 B/px read + 3 B/px written; the LUT rows are
// 256 B per tile. What holds it back is the instructions a pixel issues
// (three cube roots, two IEEE divisions) and the tile-shaped reads. The TPU
// kernel's nibble one-hot matmul and log-roll scan are gone: the card has
// shared-memory atomics and warp shuffles.
//
// K2 mmtrs_clahe_apply_lab_bwd replaces
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_apply_kernel_img (4-LUT blend)
//   mmtrs_tpu/ops/pallas/lab_kernels.py:_bwd_kernel (LAB -> u8 RGB).
// A block covers (image, band of rows, 4 x blockDim columns); a thread takes
// 4 consecutive pixels of a row and walks the band's rows. Its column terms
// (x0, x1, wx) are computed once, the row terms (y0, y1, wy) once a row,
// with the expressions and order of the oracle (mmtrs_tpu/ops/clahe.py:84-109),
// so they are bit for bit the per-pixel ones. A band lies between two
// changes of its rows' lower tile row, so it reads two tile rows of LUTs,
// staged in shared memory as f32, where the four gathers read without a
// conversion. L' is stored as u8 round-half-up in a register; fy'(L'), Y(L'),
// a/500 and b/200 come from 256-entry tables filled by the same device
// functions; fx, fz, the RGB sums and the gamma encode run per pixel.
// Bound on the card: bytes, 3 B/px read + 3 B/px written; the LUTs stay in
// L2. Held back, as K1, by the instructions a pixel issues (three pows).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

#include "lab_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;  // K1: one thread per bin
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kApplyThreads = 128;  // K2's widest block
constexpr int kStageRows = 2;       // K2 stages two tile rows of up to 8 tiles
constexpr int kStageTiles = 8;

__device__ __forceinline__ uint32_t pack4(const uint8_t* v) {
  return (uint32_t)v[0] | (uint32_t)v[1] << 8 | (uint32_t)v[2] << 16 | (uint32_t)v[3] << 24;
}

__device__ __forceinline__ void unpack4(uint32_t w, uint8_t* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (uint8_t)(w >> (8 * k));
}

// `n` (0..4) consecutive bytes from p: one 32-bit load when kVec (then n is
// 0 or 4 and p is 4-aligned), else byte by byte
template <bool kVec, int kWords>
__device__ __forceinline__ void load_px(const uint8_t* p, int n, uint8_t* v) {
  if (kVec) {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      unpack4(n > 0 ? reinterpret_cast<const uint32_t*>(p)[w] : 0u, v + 4 * w);
  } else {
#pragma unroll
    for (int k = 0; k < 4 * kWords; ++k) v[k] = k < n * kWords ? p[k] : 0;
  }
}

template <bool kVec, int kWords>
__device__ __forceinline__ void store_px(uint8_t* p, int n, const uint8_t* v) {
  if (kVec) {
    if (n > 0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) reinterpret_cast<uint32_t*>(p)[w] = pack4(v + 4 * w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4 * kWords; ++k)
      if (k < n * kWords) p[k] = v[k];
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// K1. Grid (ty * tx * kSplit, B); block kSplit-th parts of a tile's rows.
template <int kSplit, bool kVec>
__global__ void __launch_bounds__(kThreads)
lab_fwd_hist_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ lq,
                    int8_t* __restrict__ da, int8_t* __restrict__ db,
                    uint8_t* __restrict__ lut, int H, int W, int ty, int tx,
                    int limit, float lut_scale) {
  __shared__ float lin[kBins];
  __shared__ int hist[kWarps][kBins];
  __shared__ int part[kWarps];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int tile = blockIdx.x / kSplit, rank = blockIdx.x % kSplit, b = blockIdx.y;
  const int th = H / ty, tw = W / tx;
  const int row0 = (tile / tx) * th + rank * th / kSplit;
  const int rows = (rank + 1) * th / kSplit - rank * th / kSplit;
  const size_t col0 = (size_t)(tile % tx) * tw;

  lin[i] = mmtrs::srgb_u8_to_linear(i);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hist[w][i] = 0;
  __syncthreads();

  // groups of 4 pixels of a tile row, row-major; the trip count is the
  // block's, so every lane of a warp reaches the warp shuffle and vote
  const int gpr = (tw + 3) / 4;
  const int groups = rows * gpr;
  const int dr = kThreads / gpr, dc = kThreads - dr * gpr;
  int r = i / gpr, c = i - r * gpr;
  int* h = hist[warp];
  for (int g = i; g - i < groups; g += kThreads) {
    const int n = g < groups ? min(4, tw - 4 * c) : 0;
    const size_t pix = ((size_t)b * H + row0 + r) * W + col0 + 4 * c;
    uint8_t px[12], l[4], a[4], d[4];
    load_px<kVec, 3>(rgb + pix * 3, n, px);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int8_t ak, dk;
      mmtrs::linear_to_lab_q(lin[px[3 * k]], lin[px[3 * k + 1]], lin[px[3 * k + 2]], &l[k], &ak, &dk);
      a[k] = (uint8_t)ak;
      d[k] = (uint8_t)dk;
    }
    store_px<kVec, 1>(lq + pix, n, l);
    store_px<kVec, 1>(reinterpret_cast<uint8_t*>(da) + pix, n, a);
    store_px<kVec, 1>(reinterpret_cast<uint8_t*>(db) + pix, n, d);
    // a warp whose 128 pixels share one L adds once; a thread whose 4 do,
    // once; the rest pixel by pixel
    const bool same4 = n == 4 && l[0] == l[1] && l[1] == l[2] && l[2] == l[3];
    const int lead = __shfl_sync(kFull, l[0], 0);  // every lane, before any branch
    if (__all_sync(kFull, same4 && l[0] == lead)) {
      if (lane == 0) atomicAdd(&h[l[0]], 4 * 32);
    } else if (same4) {
      atomicAdd(&h[l[0]], 4);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) atomicAdd(&h[l[k]], 1);
    }
    c += dc;
    r += dr;
    if (c >= gpr) {
      c -= gpr;
      ++r;
    }
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) count += hist[w][i];

  if (kSplit > 1) {  // the leader sums the cluster's counts bin by bin
    hist[0][i] = count;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
#pragma unroll
      for (int q = 1; q < kSplit; ++q) count += cluster.map_shared_rank(&hist[0][0], q)[i];
    }
    cluster.sync();  // the others' shared memory lives until the leader has read it
    if (rank != 0) return;
  }

  // clip at the integer limit; OpenCV redistribution (clahe.cpp calcLut):
  // excess // 256 to every bin, +1 to the first `resid` bins at step
  // max(256 // resid, 1)
  int excess = warp_sum(max(count - limit, 0));
  if (lane == 0) part[warp] = excess;
  __syncthreads();
  excess = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) excess += part[w];
  const int batch_add = excess / kBins;
  const int resid = excess - batch_add * kBins;
  const int step = max(kBins / max(resid, 1), 1);
  const int bonus = (i % step == 0) && (i / step < resid);
  int cdf = min(count, limit) + batch_add + bonus;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {  // inclusive scan: warps, then the block
    const int t = __shfl_up_sync(kFull, cdf, off);
    if (lane >= off) cdf += t;
  }
  __syncthreads();
  if (lane == 31) part[warp] = cdf;
  __syncthreads();
  for (int w = 0; w < warp; ++w) cdf += part[w];
  // round-half-even of cdf * f32((256-1)/area), clipped: exact in u8
  const float v = fminf(fmaxf(rintf((float)cdf * lut_scale), 0.0f), 255.0f);
  lut[((size_t)b * ty * tx + tile) * kBins + i] = (uint8_t)(int)v;
}

// OpenCV's tile coordinate of row or column p, p / t - 0.5, its lower tile
// clamped to [0, n - 1] and the weight of the upper one (clahe.py:84-91)
struct TileCoord {
  int lo, hi;
  float w;
};

__device__ __forceinline__ TileCoord tile_coord(int p, int t, int n) {
  const float f = (float)p / (float)t - 0.5f;
  const int lo = (int)fminf(fmaxf(floorf(f), 0.0f), (float)(n - 1));
  return {lo, min(lo + 1, n - 1), fminf(fmaxf(f - (float)lo, 0.0f), 1.0f)};
}

// K2's byte tables: fy'(L'), Y(L'), a/500 and b/200 of the chroma bytes
struct BwdTables {
  float fyp[kBins], y[kBins], a[kBins], b[kBins];
};

// The u8 sRGB encode above the knee, q_u8(srgb_gamma(y) * 255) for y in
// (kSrgbKnee, 1] (it is 255 from 1 up), tabulated by the float's top 16
// bits: bin j holds the floats whose bits >> 16 are kKneeBin + j. Across a
// bin the encode rises by less than one level (its slope, 112 y^-0.58 levels
// a unit, times the bin's width, 2^-7 y), so entry j is its value at the
// bin's first float above the knee (bits 17 and up) and the low 16 bits of
// the first float that takes the next value (bits 0-16; 0x10000 where none
// does). The table is filled once per card by srgb_encode_table_kernel with
// the device function itself; a bin that breaks the one-step rule is
// reported, and the launch fails.
constexpr int kKneeBin = 0x3b4d;  // bits of f32(0.0031308) >> 16
constexpr int kEncodeBins = 0x3f80 - kKneeBin + 1;  // up to the bin of 1.0f
constexpr int kEncodeFault = 1000;  // returned when the table breaks its rule
__device__ __align__(16) uint32_t g_encode[kEncodeBins];
__device__ int g_encode_bad;

__global__ void srgb_encode_table_kernel() {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kEncodeBins) return;
  const int knee = __float_as_int(F32(mmtrs::kSrgbKnee));
  const int lo = max((kKneeBin + j) << 16, knee + 1), hi = ((kKneeBin + j + 1) << 16) - 1;
  const int k0 = mmtrs::srgb_gamma_u8(__int_as_float(lo));
  const int k1 = mmtrs::srgb_gamma_u8(__int_as_float(hi));
  int step = 0x10000;
  if (k1 > k0) {  // bisect on the bits: encode(a) = k0 < encode(b)
    int a = lo, b = hi;
    while (b - a > 1) {
      const int m = a + (b - a) / 2;
      if (mmtrs::srgb_gamma_u8(__int_as_float(m)) > k0) b = m; else a = m;
    }
    step = b & 0xffff;
  }
  const bool bad = (knee >> 16) != kKneeBin || k1 < k0 || k1 > k0 + 1 ||
                   (j == kEncodeBins - 1 && (lo != 0x3f800000 || k0 != 255));
  if (bad) atomicExch(&g_encode_bad, 1);
  g_encode[j] = (uint32_t)k0 << 17 | (uint32_t)step;
}

// q_u8(linear_to_srgb(v) * 255): the linear branch as linear_to_srgb
// computes it, the gamma branch from the table
__device__ __forceinline__ uint8_t encode_u8(float v, const uint32_t* enc) {
  const float y = fmaxf(v, 0.0f);
  if (y <= F32(mmtrs::kSrgbKnee)) return mmtrs::q_u8(F32(12.92) * y * 255.0f);
  const int bits = __float_as_int(y);
  const uint32_t w = enc[min((bits >> 16) - kKneeBin, kEncodeBins - 1)];
  return (uint8_t)((w >> 17) + ((uint32_t)(bits & 0xffff) >= (w & 0x1ffff)));
}

// Rows [ya, yb) of a band, 4 pixels from column x (n of them inside the
// row). LUT value (tile row t, tile column c, bin l) is luts[(t - ta) * tx *
// 256 + c * 256 + l], in shared memory when the band's rows are staged.
template <bool kVec>
__device__ __forceinline__ void blend_rows(const uint8_t* __restrict__ lq,
                                           const int8_t* __restrict__ da,
                                           const int8_t* __restrict__ db, const uint8_t* luts,
                                           const BwdTables& t, const uint32_t* enc,
                                           uint8_t* __restrict__ out, size_t img, int W, int ya,
                                           int yb, int th, int tw, int ty, int tx, int ta, int x,
                                           int n) {
  int cx0[4], cx1[4];
  float cwx[4], cwx1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const TileCoord cx = tile_coord(min(x + k, W - 1), tw, tx);
    cx0[k] = cx.lo * kBins;
    cx1[k] = cx.hi * kBins;
    cwx[k] = cx.w;
    cwx1[k] = 1.0f - cx.w;
  }
  for (int y = ya; y < yb; ++y) {
    const TileCoord cy = tile_coord(y, th, ty);
    const float wy = cy.w, wy1 = 1.0f - cy.w;
    const uint8_t* r0 = luts + (cy.lo - ta) * tx * kBins;
    const uint8_t* r1 = luts + (cy.hi - ta) * tx * kBins;
    const size_t pix = img + (size_t)y * W + x;
    uint8_t l[4], a[4], d[4], o[12];
    load_px<kVec, 1>(lq + pix, n, l);
    load_px<kVec, 1>(reinterpret_cast<const uint8_t*>(da) + pix, n, a);
    load_px<kVec, 1>(reinterpret_cast<const uint8_t*>(db) + pix, n, d);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v00 = r0[cx0[k] + l[k]], v01 = r0[cx1[k] + l[k]];
      const float v10 = r1[cx0[k] + l[k]], v11 = r1[cx1[k] + l[k]];
      const float blend = v00 * wy1 * cwx1[k] + v01 * wy1 * cwx[k] +
                          v10 * wy * cwx1[k] + v11 * wy * cwx[k];
      const int l2 = mmtrs::q_u8(blend);
      float r, g, bl;
      mmtrs::lab_terms_to_linear(t.fyp[l2], t.y[l2], t.a[a[k]], t.b[d[k]], &r, &g, &bl);
      o[3 * k] = encode_u8(r, enc);
      o[3 * k + 1] = encode_u8(g, enc);
      o[3 * k + 2] = encode_u8(bl, enc);
    }
    store_px<kVec, 3>(out + pix * 3, n, o);
  }
}

// `nbytes` (a multiple of 16) from global to shared memory, 16 bytes a
// thread at a time where `src` is 16-aligned, else byte by byte
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int nbytes) {
  if (((uintptr_t)src & 15) == 0) {
    for (int o = 16 * threadIdx.x; o < nbytes; o += 16 * blockDim.x)
      *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(src + o);
  } else {
    for (int o = threadIdx.x; o < nbytes; o += blockDim.x) dst[o] = src[o];
  }
}

// K2. Grid (column blocks, bands of `band` rows, B).
template <bool kVec>
__global__ void __launch_bounds__(kApplyThreads)
lab_bwd_blend_kernel(const uint8_t* __restrict__ lq, const int8_t* __restrict__ da,
                     const int8_t* __restrict__ db, const uint8_t* __restrict__ lut,
                     uint8_t* __restrict__ out, int H, int W, int ty, int tx, int band) {
  __shared__ BwdTables t;
  __shared__ __align__(16) uint32_t enc[kEncodeBins];
  __shared__ __align__(16) uint8_t stage[kStageRows * kStageTiles * kBins];
  const int i = threadIdx.x, b = blockIdx.z;
  const int th = H / ty, tw = W / tx;
  const int ya = blockIdx.y * band, yb = min(ya + band, H);
  const int x = 4 * (blockIdx.x * blockDim.x + i);

  // the band's tile rows: the first row's lower one to the last row's
  // upper one; two at most when the band lies between two changes of the
  // lower one (the host picks such bands), and then staged
  const int ta = tile_coord(ya, th, ty).lo, tb = tile_coord(yb - 1, th, ty).hi;
  const uint8_t* src = lut + ((size_t)b * ty + ta) * tx * kBins;
  const bool staged = tb - ta < kStageRows && tx <= kStageTiles;
  if (staged) stage_bytes(stage, src, (tb - ta + 1) * tx * kBins);
  stage_bytes(reinterpret_cast<uint8_t*>(enc), reinterpret_cast<const uint8_t*>(g_encode),
              (int)sizeof(g_encode));
  for (int v = i; v < kBins; v += blockDim.x) {
    const float f = mmtrs::lab_fyp((float)v);
    t.fyp[v] = f;
    t.y[v] = mmtrs::lab_y(f);
    t.a[v] = mmtrs::lab_a_term((int8_t)v);
    t.b[v] = mmtrs::lab_b_term((int8_t)v);
  }
  __syncthreads();

  const int n = max(min(4, W - x), 0);
  if (n == 0) return;
  const size_t img = (size_t)b * H * W;
  blend_rows<kVec>(lq, da, db, staged ? stage : src, t, enc, out, img, W, ya, yb, th, tw, ty,
                   tx, ta, x, n);
}

bool aligned4(const void* p) { return ((uintptr_t)p & 3) == 0; }

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, dim3 block, int cluster, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int kSplit>
int launch_fwd(bool vec, int B, int ty, int tx, cudaStream_t s, const uint8_t* rgb,
               uint8_t* lq, int8_t* da, int8_t* db, uint8_t* lut, int H, int W,
               int limit, float lut_scale) {
  const dim3 grid(ty * tx * kSplit, B);
  return vec ? launch(lab_fwd_hist_kernel<kSplit, true>, grid, dim3(kThreads), kSplit, s, rgb,
                      lq, da, db, lut, H, W, ty, tx, limit, lut_scale)
             : launch(lab_fwd_hist_kernel<kSplit, false>, grid, dim3(kThreads), kSplit, s, rgb,
                      lq, da, db, lut, H, W, ty, tx, limit, lut_scale);
}

// Fills g_encode on the current card at the first call, on `stream`, and
// waits for it (once per process and card): K2's launches read it.
int ensure_encode_table(cudaStream_t stream) {
  constexpr int kMaxCards = 64;
  static std::atomic<bool> ready[kMaxCards];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxCards) return (int)cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev].load(std::memory_order_relaxed)) return 0;
  const int zero = 0;
  int bad = 0;
  err = cudaMemcpyToSymbolAsync(g_encode_bad, &zero, sizeof(int), 0, cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const int launched = launch(srgb_encode_table_kernel, dim3((kEncodeBins + 255) / 256),
                              dim3(256), 1, stream);
  if (launched != 0) return launched;
  err = cudaMemcpyFromSymbolAsync(&bad, g_encode_bad, sizeof(int), 0, cudaMemcpyDeviceToHost, stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return (int)err;
  if (bad) return kEncodeFault;
  ready[dev].store(true, std::memory_order_release);
  return 0;
}

}  // namespace

// K1's launch constants past the pointers, one struct so that a call
// passes few arguments (ops/kernels/clahe_lab.py:FwdLaunch mirrors it);
// split: blocks (a cluster) per tile, 1, 2 or 4
struct FwdLaunch {
  int B, H, W, ty, tx, limit;
  float lut_scale;
  int split;
};

extern "C" int mmtrs_clahe_lab_fwd_lut(const void* rgb, void* planes, void* lut,
                                       const void* launch, void* stream) {
  const FwdLaunch& a = *static_cast<const FwdLaunch*>(launch);
  const size_t n = (size_t)a.B * a.H * a.W;  // lq, da, db: planes, n bytes apart
  uint8_t* lq = (uint8_t*)planes;
  const bool vec = (a.W / a.tx) % 4 == 0 && aligned4(rgb) && aligned4(lq) && n % 4 == 0;
  const auto s = (cudaStream_t)stream;
  const auto run = [&](auto launcher) {
    return launcher(vec, a.B, a.ty, a.tx, s, (const uint8_t*)rgb, lq, (int8_t*)(lq + n),
                    (int8_t*)(lq + 2 * n), (uint8_t*)lut, a.H, a.W, a.limit, a.lut_scale);
  };
  switch (a.split) {
    case 1: return run(launch_fwd<1>);
    case 2: return run(launch_fwd<2>);
    case 4: return run(launch_fwd<4>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// band: rows a block walks; a band that lies between two changes of its
// rows' lower tile row (band divides H / ty / 2) reads its LUTs staged
extern "C" int mmtrs_clahe_apply_lab_bwd(const void* lq, const void* da,
                                         const void* db, const void* lut,
                                         void* out, int B, int H, int W, int ty,
                                         int tx, int band, void* stream) {
  const bool vec = W % 4 == 0 && aligned4(lq) && aligned4(da) && aligned4(db) && aligned4(out);
  const int groups = (W + 3) / 4;
  const int threads = min(kApplyThreads, (groups + 31) / 32 * 32);
  const dim3 grid((groups + threads - 1) / threads, (H + band - 1) / band, B);
  const auto s = (cudaStream_t)stream;
  const int ready = ensure_encode_table(s);
  if (ready != 0) return ready;
  return vec ? launch(lab_bwd_blend_kernel<true>, grid, dim3(threads), 1, s, (const uint8_t*)lq,
                      (const int8_t*)da, (const int8_t*)db, (const uint8_t*)lut, (uint8_t*)out,
                      H, W, ty, tx, band)
             : launch(lab_bwd_blend_kernel<false>, grid, dim3(threads), 1, s, (const uint8_t*)lq,
                      (const int8_t*)da, (const int8_t*)db, (const uint8_t*)lut, (uint8_t*)out,
                      H, W, ty, tx, band);
}
