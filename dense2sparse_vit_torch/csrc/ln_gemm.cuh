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
// the spatial tokens x[:, 1:] of a (B, N+1, C) stream is read in place: its
// TMA tensor map is 3-D, (K, rows per sample, samples), and a tile never
// spans two samples. The weight comes in one of two layouts: the torch
// Linear layout (N, K) row-major, W[k, n] = w[n, k], the forward's x @ w^T,
// a K-major B operand; or (K, N) row-major, W[k, n] = w[k, n], the
// backward's g @ w for a Linear weight w of shape (out, in) = (K, N), an
// MN-major B that wgmma reads transposed. With a LayerNorm, ln_stats_kernel
// first writes each row's fp32 mean and 1/std (two-pass, the row held in
// registers) to a scratch buffer. The weight gradient dW = P^T Q runs on
// the same kernel with both operands MN-major.
//
// These are the projections that the TPU kernels (dense2sparse_vit_tpu/ops/
// pallas/block.py, mlp.py, predictor.py, attention.py) compute with
// jnp.dot on the MXU. What bounds them on the H100: operations. At B=256,
// N=197 the block forward's four products are 178.5 GFLOP, ~0.18 ms at the
// 989 TFLOP/s bf16 peak, against ~0.21 ms for the larger of bytes and
// operations product by product; only wgmma reaches that rate (mma.sync,
// which an earlier version of this engine ran, stays near 14% of it).
//
// Design: gemm_kernel, one persistent CTA per SM, five warpgroups. A
// producer warpgroup has one thread issue TMA loads of 128 x 64 A and
// 128 x 64 B slices, in the 128-byte swizzle, into a 4-stage ring, each
// stage with a full and an empty mbarrier; out-of-bounds rows and columns
// (M not a multiple of the tile, K = 96) arrive as zeros. Two MMA
// warpgroups each own 64 rows of the 128 x 128 output tile and issue
// wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate) from shared
// memory, keeping one slice's products in flight while they wait for the
// next. The LayerNorm prologue normalises the warpgroup's rows of A in
// place in shared memory, with the expression above (which block_bwd.cu's
// ln_apply repeats), then fences the writes to the async proxy before the
// products read them (the SS form rather than A from registers: one
// product form and one operand layout for every caller, and the pass over
// A runs while the previous slice's products do). Each MMA warpgroup
// stages its accumulators in an fp32 tile of its own and goes on to the
// next tile; an epilogue warpgroup beside it applies the epilogue in the
// order above and stores 16-byte vectors, so a tile's epilogue (GELU's
// erf, the residual's reads) runs beside the next tile's products, and
// the producer fills the ring across tiles. Registers move from the
// producer to the MMA warpgroups by setmaxnreg. What bounds it now, on
// the H100: at K = 384 the tile's six slices leave the LayerNorm pass and
// the ring's refill in the way (~200 TFLOP/s for qkv and fc1 at B=256),
// at K >= 1152 the L2's bandwidth for a 128 x 128 tile (~550 TFLOP/s for
// fc2); wider tiles (or TMA multicast across a cluster) are the next step.
// Tiles are a pure function of the shapes and each output tile's sum runs
// in one CTA in K order, so a product gives the same bits on every run and
// in the backward's recompute; the weight gradient, whose output is small
// (a 384 x 384 dW is nine tiles), splits its rows across CTAs into fp32
// partials that reduce_partials adds in a fixed order. No atomics. The
// bias gradient of a bf16 cotangent, the column sums of P, rides on the
// weight gradient dW = P^T Q (wgrad's `db`): the epilogue warpgroups,
// idle while a tile's products run, add up the P slices in the ring as the
// MMA warps multiply them, each column tile of a split every n_tiles-th
// slice (so that the extra shared-memory reads spread evenly over the
// CTAs), into one fp32 partial row per split and column tile, which the
// same reduce adds; the products, and so dW's bits, are untouched.
//
// The int8 products of quant_block.cu (W8A8) run on the same kernel,
// instantiated for int8 operands in the GEMM_NK layout (s8 wgmma takes
// K-major operands only: the codes (M, K) and the weight's codes (N, K)
// both lie that way): a slice is 128 int8 values of K, the same 128 bytes
// a row of the swizzle holds, so the TMA boxes, the ring, the descriptors
// and their 32-byte steps are the bf16 ones byte for byte, each step a
// wgmma.mma_async m64n128k32 .s32.s8.s8 with exact int32 sums. The MMA
// warpgroups stage the sums converted to fp32 (round to nearest), and the
// epilogue warpgroups dequantize, as quant_block.cu's notes define:
//   out[m, n] = res[m, n] + act(acc * (row_s[m] * col_s[n]) + bias[n])
// each operation rounded on its own (__fmul_rn, __fadd_rn: no fma), act
// the exact GELU of the bf16-rounded value, res bf16 or fp32. The int8
// epilogue (qgemm_epilogue) loads what does not depend on the sums (the
// scales, the bias, the first rows' residual) before they are staged, and
// takes GELU as a template argument: behind a runtime branch in its element
// loop, erf's arithmetic stayed in every product's epilogue and cost about
// what running it does. What bounds the int8 products at the block's
// shapes: at K = 384 the epilogue (GELU's erf for fc1; the fp32 tile's
// staging and reading for all), which the short K loop cannot cover; at
// K = 1536 (fc2) the ring's refill, as for the bf16 products.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

namespace d2s {

using bf16 = __nv_bfloat16;

// Rows padded with zero columns. An entry that takes token rows of any
// width C gets them from its caller padded to an aligned width (16-byte
// rows: the TMA maps and the vector copies), with zero LayerNorm
// parameters, weights and biases in the padding; only the LayerNorm
// statistics then need the true width. The entry opens an LnWidth scope
// with C for the launches it makes, and each launch of a LayerNorm
// (ln_stats_kernel, block_bwd.cu's ln_apply_kernel, norm.cu's backward,
// quant_block.cu's row quantization) takes ln_width(K) of its K columns:
// C where the scope narrows the rows, else K. Host code only.
inline thread_local int ln_width_scope = 0;
struct LnWidth {
  int prev;
  explicit LnWidth(int width) : prev(ln_width_scope) { ln_width_scope = width; }
  ~LnWidth() { ln_width_scope = prev; }
};
inline int ln_width(int K) {
  return ln_width_scope > 0 && ln_width_scope < K ? ln_width_scope : K;
}

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

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t packed) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
}

// (lo, hi) less the bf16 pair `packed`, itself in bf16: where `packed` is
// (lo, hi) rounded, the pair plus it is (lo, hi) to ~2^-17 of their size
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi, uint32_t packed) {
  const float2 r = bf16x2_to_float2(packed);
  return pack_bf16(lo - r.x, hi - r.y);
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

// ---- the Hopper GEMM engine: TMA loads, wgmma products, an mbarrier ring ----

constexpr int GEMM_BM = 128;  // two MMA warpgroups of 64 rows each
constexpr int GEMM_BN = 128;  // one m64n128k16 product per warpgroup and 16-deep step
constexpr int GEMM_BK = 64;   // 128 bytes of bf16: one row of the 128-byte swizzle
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 640;  // producer, two MMA warpgroups, two epilogue warpgroups
constexpr int GEMM_A_BYTES = GEMM_BM * GEMM_BK * 2;
constexpr int GEMM_B_BYTES = GEMM_BN * GEMM_BK * 2;
constexpr int GEMM_STAGE_BYTES = GEMM_A_BYTES + GEMM_B_BYTES;
constexpr int GEMM_BOX_BYTES = 64 * GEMM_BK * 2;  // one 64 x 64 TMA box: 8 rows of 1024-byte atoms
constexpr int GEMM_LDC = GEMM_BN + 8;  // fp32 pitch of the epilogue tile: conflict-free float2 stores
constexpr int GEMM_C_BYTES = GEMM_BM * GEMM_LDC * 4;
constexpr int GEMM_SUM_GROUPS = 8;  // the row groups of an epilogue warpgroup's column sums
constexpr int GEMM_SUM_BYTES = GEMM_SUM_GROUPS * GEMM_BM * 4;
constexpr int GEMM_SMEM_BYTES = 1024 + GEMM_STAGES * GEMM_STAGE_BYTES + GEMM_C_BYTES +
                                GEMM_SUM_BYTES + (2 * GEMM_STAGES + 4) * 8;
// The weight gradient's split plan assumes the H100 SXM's 132 SMs, fixed so
// that the plan, and with it the bits, depend on the shapes alone.
constexpr int GEMM_PLAN_SMS = 132;
static_assert(GEMM_SMEM_BYTES <= 232448, "one CTA per SM");
static_assert(GEMM_A_BYTES == 2 * GEMM_BOX_BYTES && GEMM_B_BYTES == 2 * GEMM_BOX_BYTES,
              "a tile is two 64-wide boxes");

// GEMM_NK: A (rows, K) and the weight in the torch Linear layout (N, K),
// both K-major; GEMM_KN: the weight (K, N), an MN-major B; GEMM_WGRAD: dW =
// P^T Q, A = P^T and B = Q^T, both MN-major (P and Q lie with the reduction
// along their rows).
enum GemmMode : int { GEMM_NK = 0, GEMM_KN = 1, GEMM_WGRAD = 2 };

// T: the operands' type, bf16 or int8_t (the int8 codes: GEMM_NK only,
// no LayerNorm, preact, gelu_in, row_scale or colsum)
template <typename T>
struct GemmArgsT {
  const T* a;            // rows of K values; see a_rows / a_bstride
  int a_rows;            // rows per sample in `a` (M for a packed matrix)
  long long a_bstride;   // elements from one sample's first row to the next
  const T* w;            // (N, K), or (K, N) with w_kn
  int w_kn;              // 0: w is (N, K); 1: w is (K, N)
  const float* bias;     // (N) or null
  const float* ln_w;     // (K) or null: no LayerNorm prologue
  const float* ln_b;     // (K)
  float ln_eps;
  float2* ln_stats;      // (M) scratch for the rows' (mean, 1/std)
  int ln_k;              // the LayerNorm's width: columns past it are zeros (0: K)
  const bf16* residual;  // (M, N) or null
  const float* row_scale;  // (M / scale_rows) or null: scales the branch per sample
  int scale_rows;
  const bf16* gelu_in;   // (M, N) or null: multiply by gelu'(gelu_in)
  bf16* preact;          // (M, N) or null: store act's input
  bf16* out;             // (M, N) bf16, or null with out_f32
  float* out_f32;        // (M, N) fp32 instead of `out`, or null
  float* colsum;         // weight gradient: (splits, n_tiles, M) partial column sums of P, or null
  const float* row_s;    // int8: (M) the codes' row scales
  const float* col_s;    // int8: (N) the weight's column scales
  const float* residual_f32;  // int8: (M, N) fp32 residual instead of `residual`, or null
  int M, N, K;
  int act;
};
using GemmArgs = GemmArgsT<bf16>;
using QGemmArgs = GemmArgsT<int8_t>;

// The work tiles of one launch: `outer` x row_tiles x n_tiles, where outer
// is the sample (A's rows come per sample) or, for the weight gradient, the
// split of the reduction; each split reduces k_split elements.
struct GemmTiles {
  int row_tiles;
  int n_tiles;
  int tiles;
  int k_split;
};

template <typename T>
__device__ __forceinline__ const T* gemm_a_row(const GemmArgsT<T>& p, int m) {
  return p.a + (long long)(m / p.a_rows) * p.a_bstride + (long long)(m % p.a_rows) * p.K;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: a box of the tensor `map` at the given coordinates (innermost
// first) into shared memory, completing `bytes` on the barrier; the parts
// of the box outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory operand in the 128-byte swizzle: `lead` bytes
// between 64-element column blocks of an MN-major operand (unused K-major),
// `stride` bytes between groups of 8 rows (K-major) or 8 K-rows (MN-major)
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lead, uint32_t stride) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving register traffic across the asynchronous
// products that own the accumulators (or read the A fragments)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// an accumulator as the fp32 the epilogue takes: int32 rounded to nearest
__device__ __forceinline__ float acc_float(float v) { return v; }
__device__ __forceinline__ float acc_float(int v) { return __int2float_rn(v); }

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), both bf16 from shared
// memory; TA / TB: the operand is MN-major (transposed). d's layout: warp w
// of the warpgroup holds rows 16w..16w+15, and d[4j..4j+3] are the mma.sync
// c fragment of columns 8j..8j+7, (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 32, fp32) = (acc ? d : 0) + A (64 x 16) B (16 x 32), both bf16 from
// shared memory; TA / TB: the operand is MN-major. d's layout as
// wgmma_m64n128k16's: warp w holds rows 16w..16w+15, d[4j..4j+3]
// the mma.sync c fragment of columns 8j..8j+7
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (64 x 64, fp32) = (acc ? d : 0) + A (64 x 16) B (16 x 64), both from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d (64 x 128, int32) += A (64 x 32) B (32 x 128), both int8 and K-major
// from shared memory (s8 wgmma has no transposed form); d's layout as
// wgmma_m64n128k16's
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The squared deviations about mu of a lane's 8-column vectors of a bf16
// row of nv vectors; with NARROW, of its first k columns alone (the zeros
// past a row's true width left out)
template <bool NARROW>
__device__ __forceinline__ float row_sq_dev(const uint4* row, int nv, int lane, float mu, int k) {
  float q = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const uint4 v = row[j];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = __bfloat162float(e[t]) - mu;
      if (!NARROW || j * 8 + t < k) q += d * d;
    }
  }
  return q;
}

// One warp per row: fp32 mean, then 1/std from the squared deviations (two
// passes over the row; the second reads it from L1), over the LayerNorm's
// p.ln_k columns (NARROW: fewer than K, the rest zeros).
template <bool NARROW>
static __global__ void ln_stats_kernel(const GemmArgs p) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= p.M) return;
  const int lane = threadIdx.x & 31;
  const uint4* row = reinterpret_cast<const uint4*>(gemm_a_row(p, m));
  const int nv = p.K / 8, k = NARROW ? p.ln_k : p.K;
  float s = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const uint4 v = row[j];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
  }
  const float mu = warp_sum(s) / k;
  const float q = row_sq_dev<NARROW>(row, nv, lane, mu, k);
  const float rs = rsqrtf(warp_sum(q) / k + p.ln_eps);
  if (lane == 0) p.ln_stats[m] = make_float2(mu, rs);
}

// The int8 epilogue of one tile (gemm_kernel's notes): the thread's 8
// consecutive columns n .. n + 7 (column c of the tile) of the half's rows
// ct / 16 + 8 i, from the fp32 tile once `staged` completes its phase.
// GELU is a template argument, so that the products without it carry none
// of its arithmetic.
template <bool GELU>
__device__ __forceinline__ void qgemm_epilogue(const GemmArgsT<int8_t>& p, const float* c_tile,
                                               uint64_t* staged, uint32_t parity, int r0,
                                               int n0, int h, int ct) {
  const int c = (ct & 15) * 8;
  const int n = n0 + c;
  // What does not depend on the sums is loaded before they are staged:
  // the column scales, the bias, the scales of the thread's 8 rows
  // (row0 + 8 i) and the residual of its first 4; the residual then
  // streams 4 rows ahead of the arithmetic.
  const bool live = n < p.N;
  const int row0 = r0 + 64 * h + (ct >> 4);
  float cs[8], bb[8], rs[8];
  uint4 res[4][2];  // row i in slot i % 4: 8 bf16 in [0], or 8 fp32 in [0] and [1]
  auto load_res = [&](int i) {
    const int m = row0 + 8 * i;
    if (m >= p.a_rows) return;
    const long long o = (long long)m * p.N + n;
    if (p.residual) {
      res[i & 3][0] = *reinterpret_cast<const uint4*>(p.residual + o);
    } else if (p.residual_f32) {
      res[i & 3][0] = *reinterpret_cast<const uint4*>(p.residual_f32 + o);
      res[i & 3][1] = *reinterpret_cast<const uint4*>(p.residual_f32 + o + 4);
    }
  };
  if (live) {
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(p.col_s + n));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(p.col_s + n + 4));
    cs[0] = s0.x, cs[1] = s0.y, cs[2] = s0.z, cs[3] = s0.w;
    cs[4] = s1.x, cs[5] = s1.y, cs[6] = s1.z, cs[7] = s1.w;
    if (p.bias) {
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.bias + n));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.bias + n + 4));
      bb[0] = b0.x, bb[1] = b0.y, bb[2] = b0.z, bb[3] = b0.w;
      bb[4] = b1.x, bb[5] = b1.y, bb[6] = b1.z, bb[7] = b1.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      rs[i] = row0 + 8 * i < p.a_rows ? __ldg(p.row_s + row0 + 8 * i) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) load_res(i);
  }
  mbar_wait(staged, parity);
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 - r0 + 8 * i;  // the row in the tile
      if (r0 + r < p.a_rows) {
        const long long o = (long long)(r0 + r) * p.N + n;
        const float4 c0 = *reinterpret_cast<const float4*>(c_tile + r * GEMM_LDC + c);
        const float4 c1 = *reinterpret_cast<const float4*>(c_tile + r * GEMM_LDC + c + 4);
        float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // acc * (s_row * s_col) + bias, each operation rounded on its own
          v[j] = __fmul_rn(v[j], __fmul_rn(rs[i], cs[j]));
          if (p.bias) v[j] = __fadd_rn(v[j], bb[j]);
          if (GELU) v[j] = gelu_exact(__bfloat162float(__float2bfloat16(v[j])));
        }
        const uint4* rr = res[i & 3];
        if (p.residual) {
          const bf16* re = reinterpret_cast<const bf16*>(&rr[0]);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__bfloat162float(re[j]), v[j]);
        } else if (p.residual_f32) {
          const float re[8] = {__uint_as_float(rr[0].x), __uint_as_float(rr[0].y),
                               __uint_as_float(rr[0].z), __uint_as_float(rr[0].w),
                               __uint_as_float(rr[1].x), __uint_as_float(rr[1].y),
                               __uint_as_float(rr[1].z), __uint_as_float(rr[1].w)};
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(re[j], v[j]);
        }
        if (p.out_f32) {
          *reinterpret_cast<float4*>(p.out_f32 + o) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(p.out_f32 + o + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(p.out + o) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        }
      }
      if (i + 4 < 8) load_res(i + 4);  // into the slot row i has freed
    }
  }
}

// Persistent: each CTA walks the work tiles blockIdx.x, + gridDim.x, ...
// with five warpgroups. The producer's one thread keeps the ring of
// GEMM_STAGES (A, B) slices full by TMA; a slice's full barrier completes
// when its bytes have landed, its empty barrier when the eight MMA warps
// are done with it. Each of the two MMA warpgroups owns 64 rows of the
// 128-row tile: it normalises its rows of A in place (LayerNorm prologue),
// issues four m64n128k16 products per slice and keeps one slice's products
// in flight while it waits for the next; at the tile's end it stages its
// accumulators in its half of the fp32 tile (`staged`) and goes on to the
// next tile's slices, which the producer has loaded meanwhile. Its
// epilogue warpgroup applies the epilogue to those 64 rows, stores them
// and frees the half (`drained`): one tile's epilogue runs beside the next
// tile's products. Registers (setmaxnreg; 640 threads enter with 96 each):
// the producer gives up 64 a thread, which the MMA warpgroups take (128
// each, 64 of them accumulators); the epilogue warpgroups keep 96. With
// int8 operands (T = int8_t, GEMM_NK) a slice holds 2 * GEMM_BK values of
// K and the epilogue dequantizes (the notes at the top).
template <int MODE, typename T = bf16>
static __global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const GemmArgsT<T> p,
                const GemmTiles t) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  static_assert(INT8 || std::is_same<T, bf16>::value, "bf16 or int8 operands");
  static_assert(!INT8 || MODE == GEMM_NK, "s8 wgmma reads K-major operands only");
  constexpr int BK = GEMM_BK * 2 / (int)sizeof(T);  // K values of a 128-byte slice
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ unsigned char gemm_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~uintptr_t(1023));
  float* c_tile = reinterpret_cast<float*>(ring + GEMM_STAGES * GEMM_STAGE_BYTES);
  float* sum_tile = c_tile + GEMM_BM * GEMM_LDC;  // [2][GEMM_SUM_GROUPS][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sum_tile + GEMM_SUM_GROUPS * GEMM_BM);
  uint64_t* empty = full + GEMM_STAGES;
  uint64_t* staged = empty + GEMM_STAGES;  // per MMA warpgroup: its 64 rows staged
  uint64_t* drained = staged + 2;         // and read by its epilogue warpgroup
  constexpr bool WGRAD = MODE == GEMM_WGRAD;
  const bool colsum = WGRAD && p.colsum != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], colsum ? 16 : 8);  // the MMA warps (and the epilogue warps)
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(&staged[h], 4);
      mbar_init(&drained[h], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // work tile -> (outer, first row, first column, reduction range)
  auto decode = [&](int tile, int& outer, int& r0, int& n0, int& k_begin, int& slices) {
    n0 = (tile % t.n_tiles) * GEMM_BN;
    const int rest = tile / t.n_tiles;
    r0 = (rest % t.row_tiles) * GEMM_BM;
    outer = rest / t.row_tiles;
    k_begin = WGRAD ? outer * t.k_split : 0;
    const int k_end = WGRAD ? min(p.K, k_begin + t.k_split) : p.K;
    slices = (k_end - k_begin + BK - 1) / BK;
  };
  const int role = threadIdx.x >> 7;  // 0 producer, 1 and 2 MMA, 3 and 4 their epilogues
  const int ct = threadIdx.x & 127;
  const int lane = ct & 31;

  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    if (ct == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
        int outer, r0, n0, k_begin, slices;
        decode(tile, outer, r0, n0, k_begin, slices);
        for (int kb = 0; kb < slices; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, GEMM_STAGE_BYTES);
          unsigned char* a_s = ring + stage * GEMM_STAGE_BYTES;
          unsigned char* b_s = a_s + GEMM_A_BYTES;
          const int k0 = k_begin + kb * BK;
          if (WGRAD) {  // P (tokens, I): boxes of 64 columns x 64 token rows
            tma_load_2d(a_s, &tma_a, bar, r0, k0);
            tma_load_2d(a_s + GEMM_BOX_BYTES, &tma_a, bar, r0 + 64, k0);
          } else {  // A (K, rows per sample, samples)
            tma_load_3d(a_s, &tma_a, bar, k0, r0, outer);
          }
          if (MODE == GEMM_NK) {  // W (N, K): 128 rows of 128 bytes
            tma_load_2d(b_s, &tma_b, bar, k0, n0);
          } else {  // W (K, N) or Q (tokens, J): boxes of 64 columns x 64 rows
            tma_load_2d(b_s, &tma_b, bar, n0, k0);
            tma_load_2d(b_s + GEMM_BOX_BYTES, &tma_b, bar, n0 + 64, k0);
          }
          if (++stage == GEMM_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if (role >= 3) {  // the epilogue of MMA warpgroup role - 3's 64 rows
    const int h = role - 3;
    // 8 consecutive columns a thread, the same in each of its 8 rows (N % 8
    // == 0, so a chunk is all in or out); the global loads of 4 rows are
    // issued before their arithmetic, so their latencies overlap
    const int c = (ct & 15) * 8;
    uint32_t parity = 0;
    // the weight gradient's column sums of P (colsum), from the ring's A
    // slices while the MMA warps multiply them: the 64 columns of box h,
    // column tile nt taking the slices kb with kb % n_tiles == nt, a thread
    // 4 columns (8 bytes of a swizzled 16-byte chunk) of the rows
    // sum_rg + 8 i, which share sum_rg's swizzle
    const int sum_cg = ct & 15, sum_rg = ct >> 4;
    const int sum_byte = h * GEMM_BOX_BYTES + sum_rg * 128 +
                         ((((sum_cg >> 1) ^ sum_rg) << 4) | ((sum_cg & 1) << 3));
    float* sums = sum_tile + h * GEMM_SUM_GROUPS * 64;  // [GEMM_SUM_GROUPS][64]
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
      int outer, r0, n0, k_begin, slices;
      decode(tile, outer, r0, n0, k_begin, slices);
      if (colsum) {
        const int nt = n0 / GEMM_BN;
        float cs[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kb = 0; kb < slices; ++kb) {
          mbar_wait(&full[stage], phase);
          if (kb % t.n_tiles == nt) {
            const unsigned char* rows = ring + stage * GEMM_STAGE_BYTES + sum_byte;
#pragma unroll
            for (int i = 0; i < GEMM_BK / GEMM_SUM_GROUPS; ++i) {
              const uint2 v = *reinterpret_cast<const uint2*>(rows + i * GEMM_SUM_GROUPS * 128);
              const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
              const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
              cs[0] += lo.x;
              cs[1] += lo.y;
              cs[2] += hi.x;
              cs[3] += hi.y;
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == GEMM_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        // the row groups' sums, added in order
#pragma unroll
        for (int j = 0; j < 4; ++j) sums[sum_rg * 64 + sum_cg * 4 + j] = cs[j];
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + h) : "memory");
        const int i = r0 + h * 64 + ct;
        if (ct < 64 && i < p.M) {
          float v = 0.f;
#pragma unroll
          for (int g8 = 0; g8 < GEMM_SUM_GROUPS; ++g8) v += sums[g8 * 64 + ct];
          p.colsum[((long long)outer * t.n_tiles + nt) * p.M + i] = v;
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + h) : "memory");
      }
      const int row_base = WGRAD ? 0 : outer * p.a_rows;  // the sample's first packed row
      float* out_f32 =
          p.out_f32 ? p.out_f32 + (WGRAD ? (long long)outer * p.M * p.N : 0) : nullptr;
      const int n = n0 + c;
      if constexpr (INT8) {
        if (p.act == ACT_GELU)
          qgemm_epilogue<true>(p, c_tile, &staged[h], parity, r0, n0, h, ct);
        else
          qgemm_epilogue<false>(p, c_tile, &staged[h], parity, r0, n0, h, ct);
      } else {
        mbar_wait(&staged[h], parity);
      }
      if (!INT8 && n < p.N) {
        float bb[8];
        if (p.bias) {
          const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.bias + n));
          const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.bias + n + 4));
          bb[0] = b0.x, bb[1] = b0.y, bb[2] = b0.z, bb[3] = b0.w;
          bb[4] = b1.x, bb[5] = b1.y, bb[6] = b1.z, bb[7] = b1.w;
        }
#pragma unroll 1
        for (int batch = 0; batch < 2; ++batch) {
          uint4 gin[4], res[4];
          float scl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 64 * h + (ct >> 4) + 8 * (i + 4 * batch);
            if (r0 + r >= p.a_rows) continue;
            const int m = row_base + r0 + r;
            const long long o = (long long)m * p.N + n;
            if (p.gelu_in) gin[i] = *reinterpret_cast<const uint4*>(p.gelu_in + o);
            if (p.row_scale) scl[i] = __ldg(p.row_scale + m / p.scale_rows);
            if (p.residual) res[i] = *reinterpret_cast<const uint4*>(p.residual + o);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 64 * h + (ct >> 4) + 8 * (i + 4 * batch);
            if (r0 + r >= p.a_rows) continue;
            const long long o = (long long)(row_base + r0 + r) * p.N + n;
            const float4 c0 = *reinterpret_cast<const float4*>(c_tile + r * GEMM_LDC + c);
            const float4 c1 = *reinterpret_cast<const float4*>(c_tile + r * GEMM_LDC + c + 4);
            float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
            if (p.bias) {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] += bb[j];
            }
            if (p.preact)
              *reinterpret_cast<uint4*>(p.preact + o) =
                  make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                             pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
            if (p.act == ACT_GELU) {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] = gelu_exact(v[j]);
            } else if (p.act == ACT_RELU) {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
            }
            if (p.gelu_in) {
              const bf16* ge = reinterpret_cast<const bf16*>(&gin[i]);
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= gelu_grad(__bfloat162float(ge[j]));
            }
            if (p.row_scale) {
              const float sc = scl[i];
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= sc;
            }
            if (p.residual) {
              const bf16* re = reinterpret_cast<const bf16*>(&res[i]);
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(re[j]);
            }
            if (out_f32) {
              *reinterpret_cast<float4*>(out_f32 + o) = make_float4(v[0], v[1], v[2], v[3]);
              *reinterpret_cast<float4*>(out_f32 + o + 4) = make_float4(v[4], v[5], v[6], v[7]);
            } else {
              *reinterpret_cast<uint4*>(p.out + o) =
                  make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                             pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&drained[h]);  // read: the MMA warps may stage the next
      parity ^= 1;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 128;\n");
  const int wg = role - 1;  // MMA warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool ln = !INT8 && p.ln_w != nullptr;
  float* cs = c_tile + wg * 64 * GEMM_LDC;
  // the LayerNorm prologue's share of a slice: 16-byte chunk `pc` of rows
  // ct / 8 + 16 i (i < 4), which holds columns 8 (pc ^ row % 8) .. + 7
  const int ln_row = ct >> 3;
  const int pc = ct & 7;
  const int lc = pc ^ (ln_row & 7);
  float4 lnp[4];  // ln_w, ln_b at the slice's columns 8 lc .. 8 lc + 7
  auto load_ln = [&](int kb) {
    const int k = kb * GEMM_BK + lc * 8;
    if (k >= p.K) return;
    lnp[0] = __ldg(reinterpret_cast<const float4*>(p.ln_w + k));
    lnp[1] = __ldg(reinterpret_cast<const float4*>(p.ln_w + k + 4));
    lnp[2] = __ldg(reinterpret_cast<const float4*>(p.ln_b + k));
    lnp[3] = __ldg(reinterpret_cast<const float4*>(p.ln_b + k + 4));
  };
  int stage = 0;
  uint32_t phase = 0;
  uint32_t drain_parity = 1;  // the first tile finds the staging tile free

  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    int outer, r0, n0, k_begin, slices;
    decode(tile, outer, r0, n0, k_begin, slices);
    const int row_base = WGRAD ? 0 : outer * p.a_rows;  // the sample's first packed row
    const int wr0 = r0 + wg * 64;                       // this warpgroup's first row
    float2 st[4];
    if (ln) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr0 + ln_row + 16 * i;
        st[i] = r < p.a_rows ? p.ln_stats[row_base + r] : make_float2(0.f, 0.f);
      }
      load_ln(0);
    }
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const int mma_slices = slices;  // the K slices whose products enter the sum
    int prev = 0;
    for (int kb = 0; kb < slices; ++kb) {
      mbar_wait(&full[stage], phase);
      unsigned char* a_s = ring + stage * GEMM_STAGE_BYTES;
      const unsigned char* b_s = a_s + GEMM_A_BYTES;
      if (ln) {
        const float4 g0 = lnp[0], g1 = lnp[1], b0 = lnp[2], b1 = lnp[3];
        const bool live = kb * GEMM_BK + lc * 8 < p.K;
        if (kb + 1 < slices) load_ln(kb + 1);  // the next slice's, in flight meanwhile
        if (live) {
          const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ln_row + 16 * i;
            if (wr0 + r >= p.a_rows) continue;
            uint4* slot = reinterpret_cast<uint4*>(a_s + (wg * 64 + r) * 128 + pc * 16);
            uint4 val = *slot;
            bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              e[j] = __float2bfloat16((__bfloat162float(e[j]) - st[i].x) * st[i].y * gm[j] + bt[j]);
            *slot = val;
          }
        }
        // the generic-proxy writes before the products' async-proxy reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      fence_acc(acc);
      wgmma_fence();
      if (kb < mma_slices) {
#pragma unroll
        for (int kk = 0; kk < GEMM_BK / 16; ++kk) {  // 32 bytes of K a step
          if constexpr (INT8) {
            wgmma_m64n128k32_s8(acc, wgmma_desc(a_s + wg * GEMM_BOX_BYTES + kk * 32, 16, 1024),
                                wgmma_desc(b_s + kk * 32, 16, 1024));
          } else if (WGRAD) {  // P^T: this warpgroup's box, 16 token rows of 128 bytes a step
            wgmma_m64n128k16<1, 1>(acc,
                                   wgmma_desc(a_s + wg * GEMM_BOX_BYTES + kk * 2048, 0, 1024),
                                   wgmma_desc(b_s + kk * 2048, GEMM_BOX_BYTES, 1024));
          } else if (MODE == GEMM_KN) {
            wgmma_m64n128k16<0, 1>(acc, wgmma_desc(a_s + wg * GEMM_BOX_BYTES + kk * 32, 16, 1024),
                                   wgmma_desc(b_s + kk * 2048, GEMM_BOX_BYTES, 1024));
          } else {
            wgmma_m64n128k16<0, 0>(acc, wgmma_desc(a_s + wg * GEMM_BOX_BYTES + kk * 32, 16, 1024),
                                   wgmma_desc(b_s + kk * 32, 16, 1024));
          }
        }
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous slice's products are done: release its stage
      if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == GEMM_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // accumulators (int32 rounded to fp32) -> this warpgroup's 64 rows of
    // the fp32 tile, once the epilogue warpgroup has read the previous tile's
    mbar_wait(&drained[wg], drain_parity);
    drain_parity ^= 1;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(cs + (warp * 16 + g + half * 8) * GEMM_LDC + j * 8 + 2 * tq) =
            make_float2(acc_float(acc[4 * j + 2 * half]), acc_float(acc[4 * j + 2 * half + 1]));
    __syncwarp();
    if (lane == 0) mbar_arrive(&staged[wg]);
  }
}

// ---- host: tensor maps and launches ---------------------------------------

using TensorMapEncoder = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                      const cuuint32_t*, CUtensorMapInterleave,
                                      CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point table (the library links no libcuda)
static TensorMapEncoder tensor_map_encoder() {
  static const TensorMapEncoder fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncoder>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 (or `type`) tensor of `rank` dims (innermost first; strides in
// bytes, from the second dim on) read in boxes of `box`, in the 128-byte
// swizzle that the products' descriptors name, out-of-bounds elements zero
static bool encode_map(CUtensorMap* map, const void* base, cuuint32_t rank,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const TensorMapEncoder encode = tensor_map_encoder();
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode &&
         encode(map, type, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, typename T = bf16>
static cudaError_t launch_gemm_tiles(const CUtensorMap& ma, const CUtensorMap& mb,
                                     const GemmArgsT<T>& p, const GemmTiles& t,
                                     cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<MODE, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GEMM_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  gemm_kernel<MODE, T><<<std::min(t.tiles, sms), GEMM_THREADS, GEMM_SMEM_BYTES, stream>>>(
      ma, mb, p, t);
  return cudaGetLastError();
}

// Launches on `stream` (the row statistics first, when there is a
// LayerNorm); returns the launch error (cudaSuccess = 0), and
// cudaErrorInvalidValue for arguments the engine does not take. Requires K
// and N multiples of 8, M a multiple of a_rows, a_bstride a multiple of 8
// where there is more than one sample, and 16-byte aligned pointers.
static cudaError_t launch_ln_gemm(const GemmArgs& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 8 != 0 || p.N % 8 != 0 || p.a_rows <= 0 ||
      p.M % p.a_rows != 0 || (p.ln_w && !p.ln_stats) || (!p.out) == (!p.out_f32) ||
      (p.row_scale && (p.scale_rows <= 0 || p.M % p.scale_rows != 0)))
    return cudaErrorInvalidValue;
  const int samples = p.M / p.a_rows;
  const long long bstride = samples > 1 ? p.a_bstride : (long long)p.a_rows * p.K;
  if (samples > 1 && (bstride <= 0 || bstride % 8 != 0)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const cuuint64_t a_dims[3] = {(cuuint64_t)p.K, (cuuint64_t)p.a_rows, (cuuint64_t)samples};
  const cuuint64_t a_strides[2] = {(cuuint64_t)p.K * 2, (cuuint64_t)bstride * 2};
  const cuuint32_t a_box[3] = {GEMM_BK, GEMM_BM, 1};
  if (!encode_map(&ma, p.a, 3, a_dims, a_strides, a_box)) return cudaErrorInvalidValue;
  bool ok;
  if (p.w_kn) {
    const cuuint64_t dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K};
    const cuuint64_t strides[1] = {(cuuint64_t)p.N * 2};
    const cuuint32_t box[2] = {64, GEMM_BK};
    ok = encode_map(&mb, p.w, 2, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.N};
    const cuuint64_t strides[1] = {(cuuint64_t)p.K * 2};
    const cuuint32_t box[2] = {GEMM_BK, GEMM_BN};
    ok = encode_map(&mb, p.w, 2, dims, strides, box);
  }
  if (!ok) return cudaErrorInvalidValue;
  if (p.ln_w) {
    constexpr int rows_per_cta = 8;
    GemmArgs q = p;
    q.ln_k = p.ln_k > 0 ? p.ln_k : ln_width(p.K);
    if (q.ln_k > p.K) return cudaErrorInvalidValue;
    const int ctas = (p.M + rows_per_cta - 1) / rows_per_cta;
    if (q.ln_k == p.K)
      ln_stats_kernel<false><<<ctas, 32 * rows_per_cta, 0, stream>>>(q);
    else
      ln_stats_kernel<true><<<ctas, 32 * rows_per_cta, 0, stream>>>(q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  GemmTiles t;
  t.row_tiles = (p.a_rows + GEMM_BM - 1) / GEMM_BM;
  t.n_tiles = (p.N + GEMM_BN - 1) / GEMM_BN;
  t.tiles = samples * t.row_tiles * t.n_tiles;
  t.k_split = p.K;
  return p.w_kn ? launch_gemm_tiles<GEMM_KN>(ma, mb, p, t, stream)
                : launch_gemm_tiles<GEMM_NK>(ma, mb, p, t, stream);
}

// The int8 product (the notes at the top): a (M, K) codes with row_s (M),
// w (N, K) codes with col_s (N), bias (N) or null, at most one of residual
// (bf16) and residual_f32, act ACT_NONE or ACT_GELU, exactly one of out and
// out_f32; a_rows, a_bstride, w_kn and the bf16-only options are ignored.
// Returns the launch error, and cudaErrorInvalidValue for arguments the
// engine does not take. Requires K a multiple of 16 (TMA's 16-byte
// strides; K past a slice's end arrives as zeros), N a multiple of 8 and
// 16-byte aligned pointers. A template, so that only the files that call
// it build the int8 kernel.
template <typename T>
static cudaError_t launch_qgemm(const GemmArgsT<T>& q, cudaStream_t stream) {
  static_assert(std::is_same<T, int8_t>::value, "int8 codes");
  if (q.M <= 0 || q.N <= 0 || q.K <= 0 || q.K % 16 != 0 || q.N % 8 != 0 || !q.row_s ||
      !q.col_s || (!q.out) == (!q.out_f32) || (q.residual && q.residual_f32) ||
      (q.act != ACT_NONE && q.act != ACT_GELU))
    return cudaErrorInvalidValue;
  GemmArgsT<T> p = q;
  p.a_rows = q.M;  // one sample: rows past M arrive as zeros and are not stored
  CUtensorMap ma, mb;
  const cuuint32_t box[3] = {2 * GEMM_BK, GEMM_BM, 1};  // 128 bytes of K by 128 rows
  const cuuint64_t a_dims[3] = {(cuuint64_t)p.K, (cuuint64_t)p.M, 1};
  const cuuint64_t a_strides[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M * p.K};
  const cuuint64_t w_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.N};
  const cuuint64_t w_strides[1] = {(cuuint64_t)p.K};
  if (!encode_map(&ma, p.a, 3, a_dims, a_strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !encode_map(&mb, p.w, 2, w_dims, w_strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return cudaErrorInvalidValue;
  GemmTiles t;
  t.row_tiles = (p.M + GEMM_BM - 1) / GEMM_BM;
  t.n_tiles = (p.N + GEMM_BN - 1) / GEMM_BN;
  t.tiles = t.row_tiles * t.n_tiles;
  t.k_split = p.K;
  return launch_gemm_tiles<GEMM_NK, T>(ma, mb, p, t, stream);
}

// ---- weight gradient: dW (I, J) = P^T Q, P (M, I), Q (M, J), fp32 out -----
//
// gemm_kernel<GEMM_WGRAD> with the (I, J) tiles as its rows and columns and
// the M token rows split across CTAs: each split writes its fp32 partial
// product to a workspace, and reduce_partials adds the partials in a fixed
// order, so the sum takes no atomics and gives the same bits on every run.

// How many row splits wgrad uses for an (I, J) gradient over M rows: at most
// one work tile per SM of the H100's 132 (the kernel keeps one CTA on an
// SM), each split a multiple of GEMM_BK rows and at least 128.
static inline void wgrad_plan(int M, int I, int J, int* splits, int* rows_per_split) {
  const int tiles = ((I + GEMM_BM - 1) / GEMM_BM) * ((J + GEMM_BN - 1) / GEMM_BN);
  int s = GEMM_PLAN_SMS / tiles;
  const int most = (M + 127) / 128;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int rows = (M + s - 1) / s;
  rows = (rows + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
  *rows_per_split = rows;
  *splits = (M + rows - 1) / rows;
}

// the splits' dW partials, then their column tiles' column sums of P
static inline long long wgrad_workspace_floats(int M, int I, int J) {
  int s, rows;
  wgrad_plan(M, I, J, &s, &rows);
  return (long long)s * I * J + (long long)s * ((J + GEMM_BN - 1) / GEMM_BN) * I;
}

// The one reducer of fp32 partial rows, the weight gradient's and norm.cu's:
// out[e] = sum_s partial[s * len + e] for e < len and, in the CTAs past
// len's, out2[e] likewise over partial2's splits2 rows of len2 (a bias's
// column sums, dbeta). A CTA's warps form groups of reduce_ways(rows)
// warps, each group 32 columns: warp k of a group adds the rows k, k +
// ways, ... in order, then the group's first warp adds their sums in
// order. Few rows (a weight gradient's 3-14 splits) take one warp a column
// group, a CTA 256 columns; many (the LayerNorm backward's 264 CTAs) spread
// over 8 warps so that their loads overlap. The order depends on the
// shapes alone: the same bits on every run.
constexpr int RED_WARPS = 8;

__host__ __device__ inline int reduce_ways(int rows) {
  return rows >= 32 ? 8 : rows >= 16 ? 4 : rows >= 8 ? 2 : 1;
}

// the CTAs that reduce `rows` partial rows of len
__host__ __device__ inline long long reduce_ctas(int rows, long long len) {
  const int cols = 32 * RED_WARPS / reduce_ways(rows);
  return (len + cols - 1) / cols;
}

static __global__ void __launch_bounds__(32 * RED_WARPS)
    reduce_partials_kernel(const float* __restrict__ partial, int splits, long long len,
                           float* __restrict__ out, const float* __restrict__ partial2,
                           int splits2, long long len2, float* __restrict__ out2) {
  __shared__ float sh[RED_WARPS][32];
  const long long first = reduce_ctas(splits, len);
  const bool second = blockIdx.x >= first;
  const float* src = second ? partial2 : partial;
  const long long n = second ? len2 : len;
  float* dst = second ? out2 : out;
  const int rows = second ? splits2 : splits;
  const int ways = reduce_ways(rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / ways, k = warp % ways;
  const long long cta = second ? blockIdx.x - first : blockIdx.x;
  const long long e = (cta * (RED_WARPS / ways) + group) * 32 + lane;
  float acc = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int s = k; s < rows; s += ways) acc += src[(long long)s * n + e];
  }
  sh[warp][lane] = acc;
  __syncthreads();
  if (k == 0 && e < n) {
    float t = 0.f;
    for (int i = 0; i < ways; ++i) t += sh[warp + i][lane];
    dst[e] = t;
  }
}

static cudaError_t launch_reduce(const float* partial, int splits, long long len, float* out,
                                 cudaStream_t stream, const float* partial2 = nullptr,
                                 int splits2 = 0, long long len2 = 0, float* out2 = nullptr) {
  const long long ctas = reduce_ctas(splits, len) + (len2 > 0 ? reduce_ctas(splits2, len2) : 0);
  reduce_partials_kernel<<<(unsigned)ctas, 32 * RED_WARPS, 0, stream>>>(
      partial, splits, len, out, partial2, splits2, len2, out2);
  return cudaGetLastError();
}

// dW (I, J) fp32 = P^T Q over M rows and, where db is not null, db (I) fp32
// = the column sums of P (its bias gradient), added in the same fixed
// order; `workspace` holds wgrad_workspace_floats(M, I, J) floats. I, J
// multiples of 8.
static cudaError_t launch_wgrad(const bf16* p, const bf16* q, float* dw, float* workspace, int M,
                                int I, int J, cudaStream_t stream, float* db = nullptr) {
  if (M <= 0 || I <= 0 || J <= 0 || I % 8 != 0 || J % 8 != 0) return cudaErrorInvalidValue;
  int splits, rows;
  wgrad_plan(M, I, J, &splits, &rows);
  GemmArgs g{};
  g.a = p;
  g.a_rows = I;
  g.w = q;
  g.out_f32 = workspace;
  g.colsum = db ? workspace + (long long)splits * I * J : nullptr;
  g.M = I;
  g.N = J;
  g.K = M;
  g.act = ACT_NONE;
  CUtensorMap ma, mb;
  const cuuint32_t box[2] = {64, GEMM_BK};
  const cuuint64_t p_dims[2] = {(cuuint64_t)I, (cuuint64_t)M};
  const cuuint64_t p_strides[1] = {(cuuint64_t)I * 2};
  const cuuint64_t q_dims[2] = {(cuuint64_t)J, (cuuint64_t)M};
  const cuuint64_t q_strides[1] = {(cuuint64_t)J * 2};
  if (!encode_map(&ma, p, 2, p_dims, p_strides, box) ||
      !encode_map(&mb, q, 2, q_dims, q_strides, box))
    return cudaErrorInvalidValue;
  GemmTiles t;
  t.row_tiles = (I + GEMM_BM - 1) / GEMM_BM;
  t.n_tiles = (J + GEMM_BN - 1) / GEMM_BN;
  t.tiles = splits * t.row_tiles * t.n_tiles;
  t.k_split = rows;
  const cudaError_t err = launch_gemm_tiles<GEMM_WGRAD>(ma, mb, g, t, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(workspace, splits, (long long)I * J, dw, stream, g.colsum,
                       splits * t.n_tiles, db ? I : 0, db);
}

}  // namespace d2s
