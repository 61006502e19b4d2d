// LayerNorm-prologue GEMM with a bias / activation / residual epilogue, for
// sm_90a, shared by block.cu and predictor.cu, and the tensor-core helpers
// both use.
//
//   out[m, n] = epi( sum_k LN(a)[m, k] * w[n, k] )
//   LN(a)[m, k] = bf16((a[m, k] - mu_m) * rstd_m * ln_w[k] + ln_b[k])   (optional)
//   epi(v)      = bf16(act(v + bias[n]) + residual[m, n])             (each optional)
//
// `a` is bf16 (M, K) with rows grouped per sample, so a strided view such as
// the spatial tokens x[:, 1:] of a (B, N+1, C) stream is read in place; `w` is
// the torch Linear layout (N, K), row-major, which is the column-major B
// operand of the tensor-core product. With a LayerNorm, ln_stats_kernel
// first writes each row's fp32 mean and 1/std (two-pass, the row held in
// registers) to a scratch buffer, and the GEMM normalises each A slice in
// shared memory once it has arrived.
//
// Design: CTA tile 128 x 128 x 64, 8 warps each owning a 64 x 32 sub-tile of
// mma.sync m16n8k16 products (bf16 in, fp32 accumulate, the PTX ISA's
// fragment layouts, fragments loaded with ldmatrix), fed by a 3-stage
// cp.async ring; the accumulators are staged through shared memory so that
// the epilogue reads and writes 16-byte vectors. What bounds it: the legacy
// mma.sync path reaches only part of Hopper's bf16 rate, which needs wgmma;
// a faster version would load with TMA into the ring and multiply with
// wgmma on 64-row warpgroup tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace d2s {

using bf16 = __nv_bfloat16;

enum Act : int { ACT_NONE = 0, ACT_GELU = 1, ACT_RELU = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); fragment layouts of the PTX ISA,
// g = lane / 4, t = lane % 4:
//   a: {(g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)}
//   b: {(2t..2t+1, g), (2t+8..2t+9, g)}
//   c: {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four 8x8 b16 matrices whose rows lanes 0-7, 8-15, 16-23, 24-31 point
// at; r[i] gets the pair (row lane / 4, cols 2 (lane % 4) + {0, 1}) of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 64;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_STAGES = 3;
constexpr int GEMM_LDS = GEMM_BK + 8;  // bf16 pitch: conflict-free ldmatrix rows
constexpr int GEMM_LDC = GEMM_BN + 4;  // fp32 pitch of the epilogue tile
constexpr int GEMM_STAGE = (GEMM_BM + GEMM_BN) * GEMM_LDS;  // bf16 per stage
constexpr int GEMM_SMEM_BYTES = GEMM_STAGES * GEMM_STAGE * 2;
constexpr int GEMM_WM = 64;  // warp tile: 2 warps down, 4 across
constexpr int GEMM_WN = 32;
constexpr int GEMM_MT = GEMM_WM / 16;
constexpr int GEMM_NT = GEMM_WN / 8;
// 16-byte vectors of the A and B tiles each thread moves per K slice
constexpr int GEMM_VECS = GEMM_BM * GEMM_BK / 8 / GEMM_THREADS;
static_assert(GEMM_BM == GEMM_BN, "A and B slices share the copy mapping");
static_assert(GEMM_VECS * GEMM_THREADS * 8 == GEMM_BM * GEMM_BK, "slice copy");
static_assert(GEMM_BM * GEMM_LDC * 4 <= GEMM_SMEM_BYTES, "epilogue tile fits the ring");

struct GemmArgs {
  const bf16* a;         // rows of K values; see a_rows / a_bstride
  int a_rows;            // rows per sample in `a` (M for a packed matrix)
  long long a_bstride;   // elements from one sample's first row to the next
  const bf16* w;         // (N, K)
  const float* bias;     // (N) or null
  const float* ln_w;     // (K) or null: no LayerNorm prologue
  const float* ln_b;     // (K)
  float ln_eps;
  float2* ln_stats;      // (M) scratch for the rows' (mean, 1/std)
  const bf16* residual;  // (M, N) or null
  bf16* out;             // (M, N)
  int M, N, K;
  int act;
};

__device__ __forceinline__ const bf16* gemm_a_row(const GemmArgs& p, int m) {
  return p.a + (long long)(m / p.a_rows) * p.a_bstride + (long long)(m % p.a_rows) * p.K;
}

// One warp per row: fp32 mean, then 1/std from the squared deviations (two
// passes over the row; the second reads it from L1).
static __global__ void ln_stats_kernel(const GemmArgs p) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= p.M) return;
  const int lane = threadIdx.x & 31;
  const uint4* row = reinterpret_cast<const uint4*>(gemm_a_row(p, m));
  const int nv = p.K / 8;
  float s = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const uint4 v = row[j];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
  }
  const float mu = warp_sum(s) / p.K;
  float q = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const uint4 v = row[j];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = __bfloat162float(e[t]) - mu;
      q += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(q) / p.K + p.ln_eps);
  if (lane == 0) p.ln_stats[m] = make_float2(mu, rs);
}

static __global__ void __launch_bounds__(GEMM_THREADS, 2) ln_gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 s_stats[GEMM_BM];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [STAGES][A (BM x LDS) | B (BN x LDS)]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int wm = (warp & 1) * GEMM_WM;
  const int wn = (warp >> 1) * GEMM_WN;
  const bool ln = p.ln_w != nullptr;

  if (ln) {
    for (int r = tid; r < GEMM_BM; r += GEMM_THREADS)
      s_stats[r] = m0 + r < p.M ? p.ln_stats[m0 + r] : make_float2(0.f, 0.f);
  }

  auto issue = [&](int slice) {
    const int k0 = slice * GEMM_BK;
    bf16* As = stages + (slice % GEMM_STAGES) * GEMM_STAGE;
    bf16* Bs = As + GEMM_BM * GEMM_LDS;
#pragma unroll
    for (int i = 0; i < GEMM_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS;
      const int r = v / (GEMM_BK / 8);
      const int c = (v % (GEMM_BK / 8)) * 8;
      const bool ka = k0 + c < p.K;
      const bool va = ka && m0 + r < p.M;
      cp_async16(As + r * GEMM_LDS + c, va ? gemm_a_row(p, m0 + r) + k0 + c : p.a, va);
      const bool vb = ka && n0 + r < p.N;
      cp_async16(Bs + r * GEMM_LDS + c, vb ? p.w + (long long)(n0 + r) * p.K + k0 + c : p.w,
                 vb);
    }
  };

  float acc[GEMM_MT][GEMM_NT][4];
#pragma unroll
  for (int i = 0; i < GEMM_MT; ++i)
#pragma unroll
    for (int j = 0; j < GEMM_NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int slices = (p.K + GEMM_BK - 1) / GEMM_BK;
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < slices) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();  // slice s has landed; slice s-1's stage is free
    bf16* As = stages + (s % GEMM_STAGES) * GEMM_STAGE;
    const bf16* Bs = As + GEMM_BM * GEMM_LDS;
    if (ln) {
      const int k0 = s * GEMM_BK;
#pragma unroll
      for (int i = 0; i < GEMM_VECS; ++i) {
        const int v = tid + i * GEMM_THREADS;
        const int r = v / (GEMM_BK / 8);
        const int c = (v % (GEMM_BK / 8)) * 8;
        if (m0 + r >= p.M || k0 + c >= p.K) continue;
        uint4* slot = reinterpret_cast<uint4*>(As + r * GEMM_LDS + c);
        uint4 val = *slot;
        bf16* e = reinterpret_cast<bf16*>(&val);
        const float2 st = s_stats[r];
        const float4 g0 = __ldg(reinterpret_cast<const float4*>(p.ln_w + k0 + c));
        const float4 g1 = __ldg(reinterpret_cast<const float4*>(p.ln_w + k0 + c + 4));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.ln_b + k0 + c));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.ln_b + k0 + c + 4));
        const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16((__bfloat162float(e[j]) - st.x) * st.y * gm[j] + bt[j]);
        *slot = val;
      }
      __syncthreads();
    }
    if (s + GEMM_STAGES - 1 < slices) issue(s + GEMM_STAGES - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t af[GEMM_MT][4];
      uint32_t bfr[GEMM_NT][2];
#pragma unroll
      for (int i = 0; i < GEMM_MT; ++i)
        ldmatrix_x4(af[i], As + (wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * GEMM_LDS +
                               kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < GEMM_NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (wn + j * 8 + (lane & 7) + (lane >> 4) * 8) * GEMM_LDS + kk +
                           ((lane >> 3) & 1) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < GEMM_MT; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_NT; ++j) mma_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it for the tile

  // accumulators -> fp32 tile; a thread holds column pairs (2t, 2t+1) of
  // rows g and g + 8 of every 16 x 8 product
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < GEMM_MT; ++i)
#pragma unroll
    for (int j = 0; j < GEMM_NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(Cs + (wm + i * 16 + g + half * 8) * GEMM_LDC + wn + j * 8 +
                                   2 * t) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
  __syncthreads();

  // 8 consecutive columns a thread: N % 8 == 0, so a chunk is all in or out
  for (int e = tid; e < GEMM_BM * GEMM_BN / 8; e += GEMM_THREADS) {
    const int r = e / (GEMM_BN / 8);
    const int c = (e % (GEMM_BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    const float4 c0 = *reinterpret_cast<const float4*>(Cs + r * GEMM_LDC + c);
    const float4 c1 = *reinterpret_cast<const float4*>(Cs + r * GEMM_LDC + c + 4);
    float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    if (p.bias) {
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.bias + n));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.bias + n + 4));
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += bb[j];
    }
    if (p.act == ACT_GELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = gelu_exact(v[j]);
    } else if (p.act == ACT_RELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
    }
    const long long o = (long long)m * p.N + n;
    if (p.residual) {
      const uint4 rv = *reinterpret_cast<const uint4*>(p.residual + o);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(re[j]);
    }
    const uint4 ov = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    *reinterpret_cast<uint4*>(p.out + o) = ov;
  }
}

// Launches on `stream` (the row statistics first, when there is a
// LayerNorm); returns the launch error (cudaSuccess = 0). Requires K and N
// multiples of 8 and 16-byte aligned pointers.
static cudaError_t launch_ln_gemm(const GemmArgs& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 8 != 0 || p.N % 8 != 0 || p.a_rows <= 0 ||
      (p.ln_w && !p.ln_stats))
    return cudaErrorInvalidValue;
  if (p.ln_w) {
    constexpr int rows_per_cta = 8;
    ln_stats_kernel<<<(p.M + rows_per_cta - 1) / rows_per_cta, 32 * rows_per_cta, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         GEMM_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + GEMM_BN - 1) / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM);
  ln_gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace d2s
