// CLAHE on a u8 L plane, as two kernels. On the main path they run from
// preprocess.py:_clahe_lab_stage (the L-plane route, K9 storing u8) for every
// phone-shaped upload (buckets 512x688, 688x512, 512x912, one image a
// request) and every archive batch of preprocess_stream ([4, 3024, 4032];
// [2, 752, 1000] for a padded 750x1000), and from ops/clahe.py:clahe_dispatch
// (K9 storing f32) for clahe_rgb, which ops/augment.py:legacy_clahe_member
// takes wherever the fused route refuses the shape.
//
// K8 mmtrs_clahe_hist_lut replaces
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_hist_lut_kernel (per tile row)
// and takes the L-plane role of
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_hist_lut_kernel_img (per image),
// both reached through clahe_pallas on the L-plane route. It computes what
// K1's histogram half does (csrc/clahe_lab.cu), without the LAB conversion.
// Bound on the card: bytes, 1 B/px read once; the LUT rows are 256 B a tile.
// What held the first design back: one 256-thread block per (image, tile)
// (128 blocks on 132 SMs at two 12 MP images, ~744 px a thread, four 1-byte
// loads in flight), each load at an address built with a division and a
// modulo. Now a block walks its rows of the tile as 8-byte words on the
// row's aligned grid (W % 8 == 0; else byte loads of the same words), four
// words a thread in flight, the bytes outside [x0, x0 + tw) masked, rows
// and words advanced by addition; and a tile of more than 2^17 pixels
// (12 MP photographs: 190,512) is split over a thread-block cluster of 2,
// 4 or 8 blocks (the host's hist_split), which merge their counts into the
// leader's through distributed shared memory. What holds it back now is the
// shared atomic a pixel: counts go to per-warp histograms, one add a byte.
// K1's warp-uniform and per-thread fast paths, a histogram a lane, run
// merging in a thread, deeper or shallower loads, and splitting a served
// request's 64 tiles to fill the SMs all measured slower on teeth (PERF.md
// §6, PR 9). Integer counts are exact in any order, so the clip at
// OpenCV's integer limit, its redistribution, the warp-shuffle scan and
// rint(cdf * f32(255/area)) clipped to 0..255 give the LUT bit for bit.
//
// K9 mmtrs_clahe_apply replaces
//   mmtrs_tpu/ops/pallas/clahe_kernel.py:_apply_kernel_img
// on the L plane: the 4-LUT bilinear blend, stored f32 (the blend) or u8
// round-half-up (cv2's saturate_cast<uchar>). Bound on the card: bytes,
// 1 B/px read + 1 or 4 B/px written; the LUTs (ty*tx*256 B an image) stay
// in L2. What held the first design back: one thread a pixel, each
// recomputing its tile terms with two IEEE divisions and gathering four
// bytes through L1. Now a block covers (image, band of rows, 8 x blockDim
// columns) and a thread takes 8 consecutive pixels of a row, one 8-byte
// load and an 8-byte (u8) or two 16-byte (f32) stores a row, with the next
// rows' loads issued before the current rows are blended. Its column terms
// (x0, x1, wx) are computed once, the row terms once a row, with the
// oracle's expressions and order (mmtrs_tpu/ops/clahe.py:84-109), so they
// are bit for bit the per-pixel ones. Bands are cut at the changes of their
// rows' lower tile row (rows th/2 + k*th), not at powers of two, so a
// band's rows share their two tile rows of LUTs, which the block stages in
// shared memory as f32 at fixed strides (StagedLuts): a pixel's four values
// are then one address and three immediate offsets, with no conversion. A
// band the kernel finds otherwise (another plan, or more than 8 tiles
// across) reads the u8 LUTs from global memory. The byte <-> f32 steps that
// remain take exact magic-number forms (line_stage.cuh), not the
// conversion unit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "line_stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;  // K8: one thread per bin
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFlight = 4;  // K8's 8-byte loads a thread keeps in flight
constexpr int kWord = 8;            // bytes of a K8 word and of a K9 thread's pixels
constexpr int kApplyThreads = 128;  // K9's widest block
constexpr int kAhead = 4;           // K9 rows loaded ahead of the blend
constexpr int kStageTiles = 8;      // K9 stages the LUTs of up to 8 tiles across

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int byte_of(uint2 w, int k) {
  return (int)(((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xffu);
}

// The 8-byte word at p: one load when kVec (p is 8-aligned), else the bytes
// [lo, hi) one by one (the others 0)
template <bool kVec>
__device__ __forceinline__ uint2 load_word(const uint8_t* p, int lo, int hi) {
  if (kVec) return *reinterpret_cast<const uint2*>(p);
  uint2 w = make_uint2(0u, 0u);
#pragma unroll
  for (int k = 0; k < kWord; ++k) {
    if (k >= lo && k < hi) {
      const uint32_t v = (uint32_t)p[k] << (8 * (k & 3));
      if (k < 4) w.x |= v; else w.y |= v;
    }
  }
  return w;
}

// Counts the bytes of w that `mask` marks into the histogram h.
__device__ __forceinline__ void count_word(int* h, uint2 w, uint32_t mask) {
#pragma unroll
  for (int k = 0; k < kWord; ++k)
    if (mask >> k & 1u) atomicAdd(&h[byte_of(w, k)], 1);
}

// K8. Grid (ty * tx * kSplit, B); block `rank` of a tile's cluster counts
// its kSplit-th part of the tile's rows.
template <int kSplit, bool kVec>
__global__ void __launch_bounds__(kThreads)
plane_hist_lut_kernel(const uint8_t* __restrict__ l, uint8_t* __restrict__ lut, int H, int W,
                      int ty, int tx, int limit, float lut_scale) {
  __shared__ __align__(16) int hist[kWarps][kBins];
  __shared__ int part[kWarps];
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int tile = blockIdx.x / kSplit, rank = blockIdx.x % kSplit, b = blockIdx.y;
  const int th = H / ty, tw = W / tx;
  const int row0 = (tile / tx) * th + rank * th / kSplit;
  const int rows = (rank + 1) * th / kSplit - rank * th / kSplit;
  const int x0 = (tile % tx) * tw;

#pragma unroll
  for (int o = i; o < kWarps * kBins / 4; o += kThreads) reinterpret_cast<int4*>(&hist[0][0])[o] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // the words of the row's 8-byte grid that cover [x0, x0 + tw), row-major
  // over the block's rows; item g is (row r, word w0 + c). A trip takes
  // kFlight items a thread, kThreads apart, all loaded before any is counted
  // (issuing the next trip's loads first measured slower at serving's shape)
  const int w0 = x0 / kWord, wpr = (x0 + tw - 1) / kWord - w0 + 1;
  const int items = rows * wpr;
  const int dr = kThreads / wpr, dc = kThreads - dr * wpr;
  const uint8_t* img = l + ((size_t)b * H + row0) * W + (size_t)w0 * kWord;
  const int first = x0 - w0 * kWord, last = first + tw;  // the tile's bytes, from word w0
  int r = i / wpr, c = i - r * wpr;
  int* h = hist[warp];
  for (int g = i; g - i < items; g += kFlight * kThreads) {
    uint2 w[kFlight];
    uint32_t mask[kFlight];
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      const bool in = g + u * kThreads < items;
      const int lo = max(first - kWord * c, 0), hi = min(last - kWord * c, kWord);
      mask[u] = in ? (0xffu << lo) & (0xffu >> (kWord - hi)) : 0u;  // bytes [lo, hi)
      w[u] = in ? load_word<kVec>(img + (size_t)r * W + kWord * c, lo, hi) : make_uint2(0u, 0u);
      c += dc;
      r += dr;
      if (c >= wpr) {
        c -= wpr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kFlight; ++u) count_word(h, w[u], mask[u]);
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) count += hist[w][i];

  if (kSplit > 1) {  // the leader sums the cluster's counts bin by bin
    hist[0][i] = count;  // each thread reads and writes its own bin only
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

// The band's LUTs staged in shared memory as f32: slot 0 holds the band's
// lower tile row, slot 1 its upper one, each as tiles 0..tx-1 and a copy of
// tile tx-1, so that a column's upper tile is always its lower one + 1 and
// the four values lie at fixed offsets from the first (LDS immediates).
constexpr int kSlot = (kStageTiles + 1) * kBins;

struct StagedLuts {
  const float* s;
  __device__ __forceinline__ void row(const TileCoord&) {}
  __device__ __forceinline__ void get(int c0, int, int p, float& v00, float& v01, float& v10,
                                      float& v11) const {
    const float* q = s + c0 + p;
    v00 = q[0];
    v01 = q[kBins];
    v10 = q[kSlot];
    v11 = q[kSlot + kBins];
  }
};

// The u8 LUTs in global memory from tile row ta, rows of `len` bytes
struct GlobalLuts {
  const uint8_t* base;
  int ta, len;
  const uint8_t *r0, *r1;
  __device__ __forceinline__ void row(const TileCoord& cy) {
    r0 = base + (cy.lo - ta) * len;
    r1 = base + (cy.hi - ta) * len;
  }
  __device__ __forceinline__ void get(int c0, int c1, int p, float& v00, float& v01, float& v10,
                                      float& v11) const {
    v00 = mmtrs::tap_of(r0 + c0 + p);
    v01 = mmtrs::tap_of(r0 + c1 + p);
    v10 = mmtrs::tap_of(r1 + c0 + p);
    v11 = mmtrs::tap_of(r1 + c1 + p);
  }
};

// The u8 store floor(clip(v, 0, 255) + 0.5) of a blend v of LUT values in
// 0..255 with weights in [0, 1] that sum to 1 within a few ulps: v lies in
// [0, 255.5), where the clip changes no result, so it is left out; the
// floor is the low byte of (v + 0.5) + 2^23 added rounding down (as
// line_stage.cuh's put).
__device__ __forceinline__ uint32_t q_blend(float v) {
  return __float_as_uint(__fadd_rd(v + 0.5f, 8388608.0f)) & 0xffu;
}

// The 8 results of a thread's row from column x: n of them inside the row
template <bool kVec>
__device__ __forceinline__ void store8(uint8_t* o, const float* v, int n) {
  if (kVec) {
    uint2 w;
    w.x = q_blend(v[0]) | q_blend(v[1]) << 8 | q_blend(v[2]) << 16 | q_blend(v[3]) << 24;
    w.y = q_blend(v[4]) | q_blend(v[5]) << 8 | q_blend(v[6]) << 16 | q_blend(v[7]) << 24;
    *reinterpret_cast<uint2*>(o) = w;
  } else {
#pragma unroll
    for (int k = 0; k < kWord; ++k)
      if (k < n) o[k] = (uint8_t)q_blend(v[k]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store8(float* o, const float* v, int n) {
  if (kVec) {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kWord; ++k)
      if (k < n) o[k] = v[k];
  }
}

// Rows [ya, yb) of a band, 8 pixels from column x (n of them inside the
// row), their LUT values from `luts`. The rows' pixels are loaded kAhead
// rows ahead of the blend.
template <bool kVec, typename Luts, typename Out>
__device__ __forceinline__ void blend_rows(const uint8_t* __restrict__ l, Luts luts,
                                           Out* __restrict__ out, size_t img, int W, int ya,
                                           int yb, int th, int tw, int ty, int tx, int x, int n,
                                           uint2 (&cur)[kAhead]) {
  int cx0[kWord], cx1[kWord];
  float cwx[kWord], cwx1[kWord];
#pragma unroll
  for (int k = 0; k < kWord; ++k) {
    const TileCoord cx = tile_coord(min(x + k, W - 1), tw, tx);
    cx0[k] = cx.lo * kBins;
    cx1[k] = cx.hi * kBins;
    cwx[k] = cx.w;
    cwx1[k] = 1.0f - cx.w;
  }
  for (int y = ya; y < yb; y += kAhead) {
    uint2 next[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int yn = y + kAhead + a;
      next[a] = yn < yb ? load_word<kVec>(l + img + (size_t)yn * W + x, 0, n) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (y + a >= yb) break;
      const TileCoord cy = tile_coord(y + a, th, ty);
      const float wy = cy.w, wy1 = 1.0f - cy.w;
      luts.row(cy);
      float v[kWord];
#pragma unroll
      for (int k = 0; k < kWord; ++k) {
        float v00, v01, v10, v11;
        luts.get(cx0[k], cx1[k], byte_of(cur[a], k), v00, v01, v10, v11);
        v[k] = v00 * wy1 * cwx1[k] + v01 * wy1 * cwx[k] + v10 * wy * cwx1[k] + v11 * wy * cwx[k];
      }
      store8<kVec>(out + img + (size_t)(y + a) * W + x, v, n);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) cur[a] = next[a];
  }
}

constexpr int kTileWords = kBins / kWord;  // 8-byte words of a tile's LUT
constexpr int kStageLoads = 6;             // staging loads a thread keeps in flight

// Word o of the stage, slot by slot (tiles 0..tx of a slot, the last a copy
// of tile tx - 1): its source in the u8 LUTs of image b
__device__ __forceinline__ const uint8_t* stage_src(const uint8_t* lut, int o, int b, int ty,
                                                    int tx, const TileCoord& rows) {
  const int per_slot = (tx + 1) * kTileWords;
  const int s = o >= per_slot, r = o - s * per_slot;
  const int c = r / kTileWords, wd = r - c * kTileWords;
  return lut + (((size_t)b * ty + (s ? rows.hi : rows.lo)) * tx + min(c, tx - 1)) * kBins + wd * kWord;
}

// K9. Grid (column blocks, bands, B). Band j (from blockIdx.y plus the
// empty bands skipped) is cut from the rows shifted by th / 2, where the
// lower tile row changes at multiples of th: each run of th shifted rows
// in ceil(th / band) bands of up to `band` rows.
template <bool kVec, typename Out>
__global__ void __launch_bounds__(kApplyThreads)
plane_blend_kernel(const uint8_t* __restrict__ l, const uint8_t* __restrict__ lut,
                   Out* __restrict__ out, int H, int W, int ty, int tx, int band) {
  __shared__ __align__(16) float stage[2 * kSlot];
  const int b = blockIdx.z;
  const int th = H / ty, tw = W / tx, shift = th / 2;
  const int per = (th + band - 1) / band, j = blockIdx.y + shift / band;
  const int m = j / per, q = j - m * per;
  const int va = m * th + q * band, vb = min(va + band, (m + 1) * th);
  const int ya = max(va - shift, 0), yb = min(vb - shift, H);
  if (ya >= yb) return;  // the whole block
  const int x = kWord * (blockIdx.x * blockDim.x + threadIdx.x);
  const int n = max(min(kWord, W - x), 0);
  const size_t img = (size_t)b * H * W;

  uint2 cur[kAhead];  // the first rows' pixels, in flight while the LUTs are staged
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    cur[a] = n > 0 && ya + a < yb ? load_word<kVec>(l + img + (size_t)(ya + a) * W + x, 0, n)
                                  : make_uint2(0u, 0u);

  // a band whose rows share their lower tile row (every band the host
  // plans) reads two tile rows of LUTs, staged as f32; any other band
  // reads its first row's lower tile row to its last row's upper one from
  // global memory
  const TileCoord first = tile_coord(ya, th, ty), last = tile_coord(yb - 1, th, ty);
  const bool staged = first.lo == last.lo && tx <= kStageTiles;
  if (staged) {  // kStageLoads 8-byte loads a thread in flight, then their conversions
    const int words = 2 * (tx + 1) * kTileWords;
    for (int o0 = threadIdx.x; o0 < words; o0 += kStageLoads * blockDim.x) {
      uint2 w[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int o = o0 + u * blockDim.x;
        if (o < words) w[u] = load_word<kVec>(stage_src(lut, o, b, ty, tx, first), 0, kWord);
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int o = o0 + u * blockDim.x;
        if (o >= words) break;
        const int s = o >= words / 2, r = o - s * (words / 2);
        float4* d = reinterpret_cast<float4*>(stage + s * kSlot + r * kWord);
        d[0] = make_float4(mmtrs::byte_f(w[u].x, 0), mmtrs::byte_f(w[u].x, 1), mmtrs::byte_f(w[u].x, 2),
                           mmtrs::byte_f(w[u].x, 3));
        d[1] = make_float4(mmtrs::byte_f(w[u].y, 0), mmtrs::byte_f(w[u].y, 1), mmtrs::byte_f(w[u].y, 2),
                           mmtrs::byte_f(w[u].y, 3));
      }
    }
  }
  __syncthreads();
  if (n == 0) return;
  if (staged) {
    blend_rows<kVec>(l, StagedLuts{stage}, out, img, W, ya, yb, th, tw, ty, tx, x, n, cur);
  } else {
    const uint8_t* base = lut + ((size_t)b * ty + first.lo) * tx * kBins;
    blend_rows<kVec>(l, GlobalLuts{base, first.lo, tx * kBins, base, base}, out, img, W, ya, yb,
                     th, tw, ty, tx, x, n, cur);
  }
}

bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

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
int launch_hist(bool vec, int B, int ty, int tx, cudaStream_t s, const uint8_t* l, uint8_t* lut,
                int H, int W, int limit, float lut_scale) {
  const dim3 grid(ty * tx * kSplit, B);
  return vec ? launch(plane_hist_lut_kernel<kSplit, true>, grid, dim3(kThreads), kSplit, s, l, lut,
                      H, W, ty, tx, limit, lut_scale)
             : launch(plane_hist_lut_kernel<kSplit, false>, grid, dim3(kThreads), kSplit, s, l, lut,
                      H, W, ty, tx, limit, lut_scale);
}

template <typename Out>
int launch_blend(bool vec, dim3 grid, dim3 block, cudaStream_t s, const uint8_t* l,
                 const uint8_t* lut, Out* out, int H, int W, int ty, int tx, int band) {
  return vec ? launch(plane_blend_kernel<true, Out>, grid, block, 1, s, l, lut, out, H, W, ty, tx, band)
             : launch(plane_blend_kernel<false, Out>, grid, block, 1, s, l, lut, out, H, W, ty, tx, band);
}

}  // namespace

// split: blocks (a cluster) per tile, 1, 2, 4 or 8 (ops/kernels/clahe.py:hist_split)
extern "C" int mmtrs_clahe_hist_lut(const void* l, void* lut, int B, int H, int W, int ty, int tx,
                                    int limit, float lut_scale, int split, void* stream) {
  const bool vec = W % kWord == 0 && aligned(l, kWord);
  const auto s = (cudaStream_t)stream;
  const auto run = [&](auto launcher) {
    return launcher(vec, B, ty, tx, s, (const uint8_t*)l, (uint8_t*)lut, H, W, limit, lut_scale);
  };
  switch (split) {
    case 1: return run(launch_hist<1>);
    case 2: return run(launch_hist<2>);
    case 4: return run(launch_hist<4>);
    case 8: return run(launch_hist<8>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// band: the most rows a K9 block walks; bands: the grid's bands, those
// that hold rows (ops/kernels/clahe.py:apply_band, apply_bands)
extern "C" int mmtrs_clahe_apply(const void* l, const void* lut, void* out, int B, int H, int W,
                                 int ty, int tx, int band, int bands, int out_u8, void* stream) {
  const bool vec = W % kWord == 0 && aligned(l, kWord) && aligned(lut, kWord) &&
                   aligned(out, out_u8 ? kWord : 16);
  const int groups = (W + kWord - 1) / kWord;
  const int threads = min(kApplyThreads, (groups + 31) / 32 * 32);
  const dim3 grid((groups + threads - 1) / threads, bands, B);
  const auto s = (cudaStream_t)stream;
  return out_u8 ? launch_blend(vec, grid, dim3(threads), s, (const uint8_t*)l, (const uint8_t*)lut,
                               (uint8_t*)out, H, W, ty, tx, band)
                : launch_blend(vec, grid, dim3(threads), s, (const uint8_t*)l, (const uint8_t*)lut,
                               (float*)out, H, W, ty, tx, band);
}
