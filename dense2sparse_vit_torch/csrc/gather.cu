// Token gather for sm_90a: out[b, k, :] = x[b, idx[b, k], :], and a zero row
// where idx[b, k] < 0 or >= N.
//
// Replaces dense2sparse_vit_tpu/ops/pallas/gather.py::fused_gather_tokens
// (kernel body `_gather_kernel`). The TPU kernel selects rows with a one-hot
// (K, N) @ (N, D) product on the matrix unit; on the H100 the same result is
// a direct indexed copy, and moving the rows is all there is to do.
//
// What bounds it: device-memory bandwidth. It reads and writes B*K rows of D
// elements, 2*B*K*D*2 bytes in bf16 (about 54 MB at B=256, K=138, D=384),
// about 16 us at the card's 3.35 TB/s. One warp copies one output row with
// 16-byte vector loads and stores, so a 768-byte bf16 row is two fully
// coalesced passes of the warp. The kernel copies bytes and does not read
// the element type. A faster design would fold the gather into the
// LayerNorm prologue of the next block's qkv GEMM (read x[b, idx] directly),
// so that the gathered copy never goes to device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ROWS_PER_CTA = GATHER_THREADS / 32;

__global__ void __launch_bounds__(GATHER_THREADS)
    gather_rows_kernel(const uint4* __restrict__ x, const long long* __restrict__ idx,
                       uint4* __restrict__ out, int N, int K, int vecs_per_row,
                       long long rows) {
  const long long row = (long long)blockIdx.x * GATHER_ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long b = row / K;
  const long long src = idx[row];
  uint4* dst = out + row * vecs_per_row;
  if (src < 0 || src >= N) {
    for (int v = lane; v < vecs_per_row; v += 32) dst[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* s = x + (b * N + src) * vecs_per_row;
  for (int v = lane; v < vecs_per_row; v += 32) dst[v] = s[v];
}

}  // namespace

// x: (B, N, row_bytes) bytes, idx: (B, K) int64, out: (B, K, row_bytes).
// row_bytes must be a multiple of 16 and the pointers 16-byte aligned.
extern "C" int d2s_gather_rows(const void* x, const void* idx, void* out, int B, int N, int K,
                               int row_bytes, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * K;
  const long long ctas = (rows + GATHER_ROWS_PER_CTA - 1) / GATHER_ROWS_PER_CTA;
  gather_rows_kernel<<<(unsigned)ctas, GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const long long*>(idx),
      static_cast<uint4*>(out), N, K, row_bytes / 16, rows);
  return (int)cudaGetLastError();
}
