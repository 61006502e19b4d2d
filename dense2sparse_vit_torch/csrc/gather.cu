// Token gather for sm_90a: out[b, k, :] = x[b, idx[b, k], :], and a zero row
// where idx[b, k] < 0 or >= N; and its transpose, the scatter-add
// dx[b, n, :] = sum_k [idx[b, k] == n] * g[b, k, :].
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
// the element type. A row that is no 16-byte multiple (a token width that
// is no multiple of 8 in bf16, the Pallas kernel's any D) takes the same
// kernel instantiated for the widest of 8, 4 or 2-byte units that divides
// it; the 16-byte instantiation is unchanged. A faster design would fold the gather into the
// LayerNorm prologue of the next block's qkv GEMM (read x[b, idx] directly),
// so that the gathered copy never goes to device memory.
//
// The scatter replaces the backward of the same file, `_fgt_bwd` with its
// kernel body `_scatter_kernel`, which on the TPU is the transposed one-hot
// product: repeated indices sum, and an index < 0 or >= N contributes
// nothing. What bounds it: device memory, one read of the (B, K, D)
// cotangent and one write of the (B, N, D) result (about 33 MB at B=128,
// N=197, K=138, D=384 in bf16, ~10 us at 3.35 TB/s). Here one CTA takes one
// sample and 32 output rows. It reads the sample's K indices once into
// shared memory and builds from them a small inverse table, each of its
// rows' first and last source k (shared-memory atomicMin / atomicMax, whose
// result does not depend on their order). Then its threads walk the CTA's
// (row, 8-element vector) pairs, neighbouring threads on neighbouring
// vectors of a row: each adds, in fp32 and in ascending k, the cotangent
// rows from the row's first source to its last whose index is the row (one
// row in the common case of distinct indices, none where the table is
// empty), and writes its vector once (zeros where no index points at the
// row; a D that is no multiple of 8 element by element, in the same
// order). Ascending k is the order a sequential index_add_ sums repeated
// indices in, so the result is bit for bit that of the plain version on
// the CPU; no atomics touch the sums, so it does not depend on the order
// blocks run in.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ROWS_PER_CTA = GATHER_THREADS / 32;

// V: the unit a lane copies, 16 bytes (uint4) for rows of 16-byte
// multiples, else the widest of 8, 4 or 2 bytes that divides the row
template <typename V>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_rows_kernel(const V* __restrict__ x, const long long* __restrict__ idx,
                       V* __restrict__ out, int N, int K, int vecs_per_row,
                       long long rows) {
  const long long row = (long long)blockIdx.x * GATHER_ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long b = row / K;
  const long long src = idx[row];
  V* dst = out + row * vecs_per_row;
  if (src < 0 || src >= N) {
    for (int v = lane; v < vecs_per_row; v += 32) dst[v] = V{};
    return;
  }
  const V* s = x + (b * N + src) * vecs_per_row;
  for (int v = lane; v < vecs_per_row; v += 32) dst[v] = s[v];
}

constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_ROWS = 32;  // output rows per CTA
constexpr int SCATTER_MAX_K = 8192;

// 8 consecutive elements of a row as floats: bf16 from one 16-byte vector,
// fp32 from two; and one element (a row that is no multiple of 8 elements)
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]);

__device__ __forceinline__ void load1(const __nv_bfloat16* p, float (&f)[1]) {
  f[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load1(const float* p, float (&f)[1]) { f[0] = *p; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, const float (&f)[1]) {
  *p = __float2bfloat16(f[0]);
}
__device__ __forceinline__ void store1(float* p, const float (&f)[1]) { *p = f[0]; }

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// VEC: the elements a thread sums and stores at once, 8 (a 16-byte vector
// of bf16, two of fp32) where D is a multiple of 8, else 1
template <typename T, int VEC>
__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_rows_kernel(const T* __restrict__ g, const long long* __restrict__ idx,
                        T* __restrict__ out, int N, int K, int D) {
  extern __shared__ int s_idx[];  // the sample's indices, -1 where out of range
  __shared__ int s_first[SCATTER_ROWS], s_last[SCATTER_ROWS];  // each row's first, last k
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * SCATTER_ROWS;
  if (threadIdx.x < SCATTER_ROWS) {
    s_first[threadIdx.x] = K;
    s_last[threadIdx.x] = -1;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const long long v = idx[(long long)b * K + k];
    const int n = (v >= 0 && v < N) ? (int)v : -1;
    s_idx[k] = n;
    if (n >= n0 && n < n0 + SCATTER_ROWS) {
      atomicMin(&s_first[n - n0], k);
      atomicMax(&s_last[n - n0], k);
    }
  }
  __syncthreads();
  const int vecs = D / VEC;
  const T* gb = g + (long long)b * K * D;
  for (int i = threadIdx.x; i < SCATTER_ROWS * vecs; i += blockDim.x) {
    const int r = i / vecs, c = (i % vecs) * VEC;
    const int n = n0 + r;
    if (n >= N) break;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    const int last = s_last[r];
    for (int k = s_first[r]; k <= last; ++k) {
      if (s_idx[k] != n) continue;
      float f[VEC];
      if constexpr (VEC == 8)
        load8(gb + (long long)k * D + c, f);
      else
        load1(gb + (long long)k * D + c, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += f[j];
    }
    if constexpr (VEC == 8)
      store8(out + ((long long)b * N + n) * D + c, acc);
    else
      store1(out + ((long long)b * N + n) * D + c, acc);
  }
}

}  // namespace

namespace {

template <typename V>
cudaError_t launch_gather(const void* x, const void* idx, void* out, int N, int K,
                          int row_bytes, long long rows, cudaStream_t stream) {
  const long long ctas = (rows + GATHER_ROWS_PER_CTA - 1) / GATHER_ROWS_PER_CTA;
  gather_rows_kernel<V><<<(unsigned)ctas, GATHER_THREADS, 0, stream>>>(
      static_cast<const V*>(x), static_cast<const long long*>(idx), static_cast<V*>(out), N, K,
      row_bytes / (int)sizeof(V), rows);
  return cudaGetLastError();
}

template <typename T>
void launch_scatter(const void* g, const void* idx, void* out, int N, int K, int D, dim3 grid,
                    size_t smem, cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  const long long* it = static_cast<const long long*>(idx);
  T* ot = static_cast<T*>(out);
  if (D % 8 == 0)
    scatter_rows_kernel<T, 8><<<grid, SCATTER_THREADS, smem, s>>>(gt, it, ot, N, K, D);
  else
    scatter_rows_kernel<T, 1><<<grid, SCATTER_THREADS, smem, s>>>(gt, it, ot, N, K, D);
}

}  // namespace

// x: (B, N, row_bytes) bytes, idx: (B, K) int64, out: (B, K, row_bytes).
// Rows of 16-byte multiples take 16-byte copies (x and out 16-byte
// aligned); any other even row the widest of 8, 4 and 2 bytes that divides
// it and both pointers' alignment.
extern "C" int d2s_gather_rows(const void* x, const void* idx, void* out, int B, int N, int K,
                               int row_bytes, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || row_bytes <= 0 || row_bytes % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long align = (unsigned long long)row_bytes |
                                   reinterpret_cast<unsigned long long>(x) |
                                   reinterpret_cast<unsigned long long>(out);
  if (align % 16 == 0) return (int)launch_gather<uint4>(x, idx, out, N, K, row_bytes, rows, s);
  if (align % 8 == 0) return (int)launch_gather<uint2>(x, idx, out, N, K, row_bytes, rows, s);
  if (align % 4 == 0) return (int)launch_gather<uint32_t>(x, idx, out, N, K, row_bytes, rows, s);
  return (int)launch_gather<uint16_t>(x, idx, out, N, K, row_bytes, rows, s);
}

// g: (B, K, D), idx: (B, K) int64, out: (B, N, D); dtype 0 = bf16, 1 = fp32.
// D a multiple of 8 takes 16-byte vectors (the pointers 16-byte aligned),
// any other D element by element; K <= 8192.
extern "C" int d2s_scatter_rows(const void* g, const void* idx, void* out, int B, int N, int K,
                                int D, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K > SCATTER_MAX_K || D <= 0 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + SCATTER_ROWS - 1) / SCATTER_ROWS, B);
  const size_t smem = (size_t)K * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_scatter<__nv_bfloat16>(g, idx, out, N, K, D, grid, smem, s);
  else
    launch_scatter<float>(g, idx, out, N, K, D, grid, smem, s);
  return (int)cudaGetLastError();
}
