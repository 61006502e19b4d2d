// LayerNorm-prologue GEMM with a bias / activation / residual epilogue, for
// sm_90a, shared by block.cu, block_bwd.cu and predictor.cu; the
// weight-gradient GEMM of block_bwd.cu; and the tensor-core helpers all use.
//
//   out[m, n] = epi( sum_k LN(a)[m, k] * W[k, n] )
//   LN(a)[m, k] = bf16((a[m, k] - mu_m) * rstd_m * ln_w[k] + ln_b[k])   (optional)
//   epi(v)      = act(v + bias[n]) * gelu'(gelu_in[m, n]) * s[m / rows]
//                 + residual[m, n]
//                 (each term optional), stored as bf16 or fp32; `preact`
//                 optionally keeps v + bias, the activation's input, in bf16;
//                 s is a per-sample scale of the branch (DropPath's
//                 Bernoulli(keep)/keep draw), `rows` the tokens per sample
//
// `a` is bf16 (M, K) with rows grouped per sample, so a strided view such as
// the spatial tokens x[:, 1:] of a (B, N+1, C) stream is read in place. The
// weight comes in one of two layouts: the torch Linear layout (N, K)
// row-major, W[k, n] = w[n, k], which is the forward's x @ w^T and the
// column-major B operand of the tensor-core product; or (K, N) row-major,
// W[k, n] = w[k, n], which is the backward's g @ w for a Linear weight w of
// shape (out, in) = (K, N), loaded into shared memory as it lies and read
// with transposing ldmatrix. With a LayerNorm, ln_stats_kernel first writes
// each row's fp32 mean and 1/std (two-pass, the row held in registers) to a
// scratch buffer, and the GEMM normalises each A slice in shared memory once
// it has arrived.
//
// Design: CTA tile 128 x 128 x 64, 8 warps each owning a 64 x 32 sub-tile of
// mma.sync m16n8k16 products (bf16 in, fp32 accumulate, the PTX ISA's
// fragment layouts, fragments loaded with ldmatrix), fed by a 3-stage
// cp.async ring; the accumulators are staged through shared memory so that
// the epilogue reads and writes 16-byte vectors. What bounds it: the legacy
// mma.sync path reaches only part of Hopper's bf16 rate, which needs wgmma;
// a faster version would load with TMA into the ring and multiply with
// wgmma on 64-row warpgroup tiles.
//
// The weight gradient dW[i, j] = sum_m P[m, i] * Q[m, j] (wgrad_kernel)
// reduces over the B*N token rows, 25,216 at B=128, N=197, while its output
// is a small weight matrix: a 128 x 128 tiling of a 384 x 384 dW has only 9
// tiles for 132 SMs. So the row range is split across CTAs (split-K), each
// CTA writes its fp32 partial product to a workspace, and reduce_partials
// sums the partials in a fixed order: deterministic, no atomics. Both
// operands lie row-major with the reduction along their rows and are read
// with transposing ldmatrix. column_sums (bias gradients) splits rows the
// same way.
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

// the same, transposed: r[i] gets the pair (rows 2 (lane % 4) + {0, 1},
// col lane / 4) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// B fragments of two neighbouring 8-column tiles of a 16 x 16 slice of a
// (K, N) row-major matrix in shared memory (pitch `ld`), from the slice's
// corner: r[0], r[1] for columns n0..n0+7, r[2], r[3] for n0+8..n0+15
__device__ __forceinline__ void ld_b_kn(uint32_t (&r)[4], const bf16* corner, int ld, int lane) {
  ldmatrix_x4_trans(r, corner + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

// the A fragment of a 16 x 16 slice of A^T, where A is (K, M) row-major in
// shared memory (pitch `ld`): the slice's rows are A's columns m0..m0+15
__device__ __forceinline__ void ld_a_trans(uint32_t (&r)[4], const bf16* corner, int ld, int lane) {
  ldmatrix_x4_trans(r, corner + ((lane & 7) + ((lane >> 4) & 1) * 8) * ld + ((lane >> 3) & 1) * 8);
}

// d/dv of the exact GELU
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * __expf(-0.5f * v * v);
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
constexpr int GEMM_LDB_KN = GEMM_BN + 8;  // bf16 pitch of a (K, N) weight slice
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
static_assert(GEMM_BK * GEMM_LDB_KN <= GEMM_BN * GEMM_LDS, "a (K, N) slice fits the B stage");

struct GemmArgs {
  const bf16* a;         // rows of K values; see a_rows / a_bstride
  int a_rows;            // rows per sample in `a` (M for a packed matrix)
  long long a_bstride;   // elements from one sample's first row to the next
  const bf16* w;         // (N, K), or (K, N) with w_kn
  int w_kn;              // 0: w is (N, K); 1: w is (K, N)
  const float* bias;     // (N) or null
  const float* ln_w;     // (K) or null: no LayerNorm prologue
  const float* ln_b;     // (K)
  float ln_eps;
  float2* ln_stats;      // (M) scratch for the rows' (mean, 1/std)
  const bf16* residual;  // (M, N) or null
  const float* row_scale;  // (M / scale_rows) or null: scales the branch per sample
  int scale_rows;
  const bf16* gelu_in;   // (M, N) or null: multiply by gelu'(gelu_in)
  bf16* preact;          // (M, N) or null: store act's input
  bf16* out;             // (M, N) bf16, or null with out_f32
  float* out_f32;        // (M, N) fp32 instead of `out`, or null
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

template <bool W_KN>
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
      if (W_KN) {
        const int rb = v / (GEMM_BN / 8);
        const int cb = (v % (GEMM_BN / 8)) * 8;
        const bool vb = k0 + rb < p.K && n0 + cb < p.N;
        cp_async16(Bs + rb * GEMM_LDB_KN + cb,
                   vb ? p.w + (long long)(k0 + rb) * p.N + n0 + cb : p.w, vb);
      } else {
        const bool vb = ka && n0 + r < p.N;
        cp_async16(Bs + r * GEMM_LDS + c, vb ? p.w + (long long)(n0 + r) * p.K + k0 + c : p.w,
                   vb);
      }
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
        if (W_KN)
          ld_b_kn(r, Bs + kk * GEMM_LDB_KN + wn + j * 8, GEMM_LDB_KN, lane);
        else
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
    const long long o = (long long)m * p.N + n;
    if (p.preact)
      *reinterpret_cast<uint4*>(p.preact + o) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    if (p.act == ACT_GELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = gelu_exact(v[j]);
    } else if (p.act == ACT_RELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
    }
    if (p.gelu_in) {
      const uint4 gv = *reinterpret_cast<const uint4*>(p.gelu_in + o);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= gelu_grad(__bfloat162float(ge[j]));
    }
    if (p.row_scale) {
      const float sc = p.row_scale[m / p.scale_rows];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= sc;
    }
    if (p.residual) {
      const uint4 rv = *reinterpret_cast<const uint4*>(p.residual + o);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(re[j]);
    }
    if (p.out_f32) {
      *reinterpret_cast<float4*>(p.out_f32 + o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p.out_f32 + o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(p.out + o) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
}

// Launches on `stream` (the row statistics first, when there is a
// LayerNorm); returns the launch error (cudaSuccess = 0). Requires K and N
// multiples of 8 and 16-byte aligned pointers.
static cudaError_t launch_ln_gemm(const GemmArgs& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 8 != 0 || p.N % 8 != 0 || p.a_rows <= 0 ||
      (p.ln_w && !p.ln_stats) || (!p.out) == (!p.out_f32) ||
      (p.row_scale && (p.scale_rows <= 0 || p.M % p.scale_rows != 0)))
    return cudaErrorInvalidValue;
  if (p.ln_w) {
    constexpr int rows_per_cta = 8;
    ln_stats_kernel<<<(p.M + rows_per_cta - 1) / rows_per_cta, 32 * rows_per_cta, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const auto kernel = p.w_kn ? ln_gemm_kernel<true> : ln_gemm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         GEMM_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + GEMM_BN - 1) / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM);
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// ---- weight gradient: dW (I, J) = P^T Q, P (M, I), Q (M, J), fp32 out -----

constexpr int WG_BI = 128;
constexpr int WG_BJ = 128;
constexpr int WG_BK = 32;  // token rows per slice
constexpr int WG_THREADS = 256;
constexpr int WG_STAGES = 3;
constexpr int WG_LD = WG_BI + 8;  // bf16 pitch: conflict-free transposing ldmatrix
constexpr int WG_STAGE = 2 * WG_BK * WG_LD;  // bf16 per stage: the P slice, then Q's
constexpr int WG_SMEM_BYTES = WG_STAGES * WG_STAGE * 2;
constexpr int WG_VECS = WG_BK * WG_BI / 8 / WG_THREADS;  // 16-byte vectors per operand
static_assert(WG_BI == WG_BJ, "P and Q slices share the copy mapping");
static_assert(WG_VECS * WG_THREADS * 8 == WG_BK * WG_BI, "slice copy");

struct WgradArgs {
  const bf16* p;     // (M, I)
  const bf16* q;     // (M, J)
  float* partial;    // (splits, I, J)
  int M, I, J;
  int rows_per_split;  // a multiple of WG_BK
};

// CTA (j tile, i tile, split s): partial[s] tile = sum over the split's rows
static __global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(const WgradArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int j0 = blockIdx.x * WG_BJ;
  const int i0 = blockIdx.y * WG_BI;
  const int m_begin = blockIdx.z * a.rows_per_split;
  const int m_end = min(a.M, m_begin + a.rows_per_split);
  const int wi = (warp & 1) * 64;
  const int wj = (warp >> 1) * 32;

  auto issue = [&](int slice) {
    const int m0 = m_begin + slice * WG_BK;
    bf16* Ps = stages + (slice % WG_STAGES) * WG_STAGE;
    bf16* Qs = Ps + WG_BK * WG_LD;
#pragma unroll
    for (int i = 0; i < WG_VECS; ++i) {
      const int v = tid + i * WG_THREADS;
      const int r = v / (WG_BI / 8);
      const int c = (v % (WG_BI / 8)) * 8;
      const bool vm = m0 + r < m_end;
      const bool vp = vm && i0 + c < a.I;
      cp_async16(Ps + r * WG_LD + c, vp ? a.p + (long long)(m0 + r) * a.I + i0 + c : a.p, vp);
      const bool vq = vm && j0 + c < a.J;
      cp_async16(Qs + r * WG_LD + c, vq ? a.q + (long long)(m0 + r) * a.J + j0 + c : a.q, vq);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int slices = m_end > m_begin ? (m_end - m_begin + WG_BK - 1) / WG_BK : 0;
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < slices) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    if (s + WG_STAGES - 1 < slices) issue(s + WG_STAGES - 1);
    cp_async_commit();
    const bf16* Ps = stages + (s % WG_STAGES) * WG_STAGE;
    const bf16* Qs = Ps + WG_BK * WG_LD;
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld_a_trans(af[i], Ps + kk * WG_LD + wi + i * 16, WG_LD, lane);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ld_b_kn(r, Qs + kk * WG_LD + wj + j * 8, WG_LD, lane);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  float* out = a.partial + (long long)blockIdx.z * a.I * a.J;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i0 + wi + i * 16 + g + half * 8;
        const int col = j0 + wj + j * 8 + 2 * t;
        if (row < a.I && col < a.J)
          *reinterpret_cast<float2*>(out + (long long)row * a.J + col) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
}

// How many row splits wgrad uses for an (I, J) gradient over M rows: enough
// CTAs for two per SM of the H100's 132, each split at least 128 rows.
static inline void wgrad_plan(int M, int I, int J, int* splits, int* rows_per_split) {
  const int tiles = ((I + WG_BI - 1) / WG_BI) * ((J + WG_BJ - 1) / WG_BJ);
  int s = (2 * 132 + tiles - 1) / tiles;
  const int most = (M + 127) / 128;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int rows = (M + s - 1) / s;
  rows = (rows + WG_BK - 1) / WG_BK * WG_BK;
  *rows_per_split = rows;
  *splits = (M + rows - 1) / rows;
}

static inline long long wgrad_workspace_floats(int M, int I, int J) {
  int s, rows;
  wgrad_plan(M, I, J, &s, &rows);
  return (long long)s * I * J;
}

// out[e] = sum_s partial[s * len + e], in s order
static __global__ void reduce_partials_kernel(const float* __restrict__ partial, int splits,
                                              long long len, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(long long)s * len + e];
  out[e] = acc;
}

static cudaError_t launch_reduce(const float* partial, int splits, long long len, float* out,
                                 cudaStream_t stream) {
  const long long blocks = (len + 255) / 256;
  reduce_partials_kernel<<<(unsigned)blocks, 256, 0, stream>>>(partial, splits, len, out);
  return cudaGetLastError();
}

// dW (I, J) fp32 = P^T Q over M rows; `workspace` holds
// wgrad_workspace_floats(M, I, J) floats. I, J multiples of 8.
static cudaError_t launch_wgrad(const bf16* p, const bf16* q, float* dw, float* workspace, int M,
                                int I, int J, cudaStream_t stream) {
  if (M <= 0 || I <= 0 || J <= 0 || I % 8 != 0 || J % 8 != 0) return cudaErrorInvalidValue;
  WgradArgs a{p, q, workspace, M, I, J, 0};
  int splits;
  wgrad_plan(M, I, J, &splits, &a.rows_per_split);
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WG_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((J + WG_BJ - 1) / WG_BJ, (I + WG_BI - 1) / WG_BI, splits);
  wgrad_kernel<<<grid, WG_THREADS, WG_SMEM_BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(workspace, splits, (long long)I * J, dw, stream);
}

// ---- column sums (bias gradients): out[n] = sum_m a[m, n], fp32 ---------

constexpr int COLSUM_ROWS = 256;  // rows per split

template <typename T>
static __global__ void column_sums_kernel(const T* __restrict__ a, int M, int N,
                                          float* __restrict__ partial) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * COLSUM_ROWS;
  const int m1 = min(M, m0 + COLSUM_ROWS);
  float acc = 0.f;
  for (int m = m0; m < m1; ++m) {
    if constexpr (sizeof(T) == 2)
      acc += __bfloat162float(a[(long long)m * N + n]);
    else
      acc += a[(long long)m * N + n];
  }
  partial[(long long)blockIdx.y * N + n] = acc;
}

static inline long long column_sums_workspace_floats(int M, int N) {
  return (long long)((M + COLSUM_ROWS - 1) / COLSUM_ROWS) * N;
}

template <typename T>
static cudaError_t launch_column_sums(const T* a, float* out, float* workspace, int M, int N,
                                      cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaErrorInvalidValue;
  const int splits = (M + COLSUM_ROWS - 1) / COLSUM_ROWS;
  column_sums_kernel<T><<<dim3((N + 255) / 256, splits), 256, 0, stream>>>(a, M, N, workspace);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(workspace, splits, N, out, stream);
}

}  // namespace d2s
