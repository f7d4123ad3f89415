// K7 mmtrs_scatter_rows: in-place row scatter dst[idx[k]] = sub[k] of a
// batch-major tensor, the write-back half of subset_apply.
//
// Replaces mmtrs_tpu/ops/pallas/scatter_kernel.py:_scatter_kernel
// (scatter_rows_pallas), which DMAs one [1, H, L] row block of the sub-batch
// to row idx[k] of the aliased destination. Here a row is row_bytes of
// contiguous memory whatever the dtype, so one byte-copy kernel serves u8
// and f32. grid.y = k (the sub-batch row), grid.x = a chunk of the row; the
// block reads idx[k] itself on the device, so the launch needs no host
// sync. Rows outside idx are never read or written; an idx entry outside
// [0, B) is skipped (the wrapper's contract is unique, in-range ids).
// Bound on the card: bytes, 2·n·row_bytes moved. Copies are 16 bytes a
// thread where row_bytes and both pointers allow it (the host picks the
// width), else 4 bytes, else single bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // vectors copied by each thread of a block

template <typename V>
__global__ void scatter_kernel(char* __restrict__ dst, const char* __restrict__ sub,
                               const int64_t* __restrict__ idx, int64_t B,
                               int64_t row_bytes) {
  const int64_t k = blockIdx.y;
  const int64_t r = idx[k];
  if (r < 0 || r >= B) return;
  const int64_t n_vec = row_bytes / (int64_t)sizeof(V);
  V* __restrict__ out = reinterpret_cast<V*>(dst + r * row_bytes);
  const V* __restrict__ in = reinterpret_cast<const V*>(sub + k * row_bytes);
  const int64_t start = (int64_t)blockIdx.x * kThreads * kPerThread + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t v = start + (int64_t)j * kThreads;
    if (v < n_vec) out[v] = in[v];
  }
}

template <typename V>
int launch(void* dst, const void* sub, const int64_t* idx, int64_t n, int64_t B,
           int64_t row_bytes, cudaStream_t stream) {
  const int64_t n_vec = row_bytes / (int64_t)sizeof(V);
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  const dim3 grid((unsigned)((n_vec + per_block - 1) / per_block), (unsigned)n);
  scatter_kernel<V><<<grid, kThreads, 0, stream>>>((char*)dst, (const char*)sub, idx, B,
                                                   row_bytes);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t row_bytes, int64_t width) {
  return row_bytes % width == 0 && reinterpret_cast<uintptr_t>(p) % width == 0;
}

}  // namespace

// dst [B, row_bytes] and sub [n, row_bytes] as bytes, idx int64 [n] on the
// device. n must be at most 65535 (grid.y) and each row at most
// 2^31 · 1024 bytes (grid.x).
extern "C" int mmtrs_scatter_rows(void* dst, const void* sub, const void* idx, long long n,
                                  long long B, long long row_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* ix = (const int64_t*)idx;
  if (n <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  if (aligned(dst, row_bytes, 16) && aligned(sub, row_bytes, 16))
    return launch<uint4>(dst, sub, ix, n, B, row_bytes, s);
  if (aligned(dst, row_bytes, 4) && aligned(sub, row_bytes, 4))
    return launch<uint32_t>(dst, sub, ix, n, B, row_bytes, s);
  return launch<uint8_t>(dst, sub, ix, n, B, row_bytes, s);
}
