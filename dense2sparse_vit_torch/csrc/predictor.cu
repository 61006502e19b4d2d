// PredictorLG (LayerNorm variants) forward for sm_90a: (B, N, D) spatial
// tokens -> (B, N) raw keep scores.
//
// Replaces dense2sparse_vit_tpu/ops/pallas/predictor.py::fused_predictor_lg
// (kernel body `_predictor_kernel`). Per sample:
//   h = units_in(x)                        LN -> Linear -> act, each
//   g = bf16(mean over tokens of h[:, c2:])   the pooled global half, c2 = c / 2
//   h = units_out([h[:, :c2], g])          LN -> Linear -> act, each
//   s = LN(h) . w + b                      final unit, width -> 1
// LayerNorm eps is the predictor's 1e-5, act GELU (small predictor) or ReLU
// (large), applied to the Linear's fp32 sum and bias and then rounded to
// bf16 (the plain version rounds the Linear's output first: within the
// tolerance its checks hold the kernel to).
//
// What bounds it on the H100. At the headline shapes (small predictor,
// D = 384, B = 256, N = 196 / 137 / 96) the products are ~20 GFLOP at
// N=196 (out_0 split, below): ~0.02 ms at 989 TFLOP/s. The bytes are the
// input read once (38.5 MB at N=196) and the head's local half written and
// read back (19 MB each way): ~0.023 ms at 3.35 TB/s. Neither dominates,
// so the design keeps everything else on chip and overlaps the weight
// stream with the products. As built, neither bound is what limits it: one
// CTA fills an SM, and its MMA warpgroups also load the rows, run the
// LayerNorm passes, the epilogues (bias, GELU, bf16 rounding, stores) and
// the pooled sums, in turn; clock64() readings put the products at about a
// fifth of a CTA's time, which the tensor cores spend idle otherwise, and a
// wave of 132 CTAs quantizes the run (the head at N=137: 274 tiles, three
// waves; the small predictor's tail therefore takes three warpgroups, 192
// rows, where they fit: 183 tiles, two waves). Every parameter a launch reads many
// times (the LayerNorms', the biases, zero-padded) is copied to shared
// memory first: read from global memory, the first CTA-wide touch of each
// cost an L2 round trip inside the LayerNorm and epilogue loops. Tried and
// not kept: a helper warpgroup per MMA warpgroup taking the epilogue from
// an fp32 tile (slower: register cap at 544 threads, two-byte stores), two
// 64-row CTAs an SM with a 2-stage ring (slower), the tail launched while
// the terms run (programmatic dependent launch: slower).
//
// Design: one kernel body, pred_body, run as a few launches that the host
// plans from the shapes alone (pred_plan), by two kernels that differ only
// in their register budget (predictor_kernel, up to two warpgroups;
// predictor_kernel_wide, three). A launch takes a tile of 64 rows per MMA
// warpgroup (three, two or one warpgroups, the most that fit in shared
// memory) and runs a chain of consecutive units on it:
//   - its input rows come in by cp.async at their row addresses (a row tile
//     may span samples; the first launch reads the strided spatial view
//     x[:, 1:] in place). Each warpgroup computes its rows' LayerNorm
//     statistics from shared memory (two threads a row, two passes: the
//     variance about the row's own mean), normalises each row once in place
//     in the 128-byte swizzle, and keeps it for every column tile of the
//     unit;
//   - one producer warp streams the unit's weight (N, K) through a 4-stage
//     TMA ring of 128-row x 64-column slices; each MMA warpgroup issues
//     wgmma m64nNTk16 from shared memory (NT = 128, 64 or 32 columns: a
//     width's tiles are 128s, then a 64 and a 32, so 192 and 96 fill theirs;
//     the split unit's are 64s), bias and activation in the epilogue, which
//     has no branch on the column (the biases and the split terms are
//     zero-padded), so that its column pairs' arithmetic interleaves;
//   - a unit whose output is the next unit's input writes it, bf16, into the
//     other of two shared-memory buffers, where its LayerNorm runs in place:
//     the rows stay on chip between units. The last unit of the model ends
//     in the final LayerNorm and the dot product with the 1-unit head, from
//     shared memory, and writes the scores.
// The plan for the units, given widths (w_0, ..., w_{n-1}) and the split
// after unit n_in - 1 (c = w_{n_in - 1}):
//   - the head: the input units, from x. Its last unit writes only its local
//     half h[:, :c2] to device memory, through a staging tile (16-byte
//     stores), and instead of its global half the fixed-order fp32 column
//     sums of each warpgroup's 64 rows, one row of sums per sample those
//     rows touch (no atomics): `pool`, (groups of 64 rows, segments, c - c2);
//   - the terms, two launches between the two, since they need every head
//     tile's sums and are the same for every tile of a sample: the pooled
//     mean of sample s, its groups' sums added in group order, divided by N
//     and rounded to bf16 (as the plain version's concat does), and its
//     statistics (pred_means, a CTA a sample); then the per-sample vectors
//     below (pred_terms), once, into the scratch;
//   - the tail: out_0 first, in split form, then the other units and the
//     score, each tile copying its samples' terms to shared memory. The
//     concat row's LayerNorm statistics combine the local
//     half's (mean and squared deviations from shared memory) with the
//     sample's (the pooled vector's mean m_s and squared deviations about
//     it), so the variance stays about the row's own mean. out_0's local
//     half goes through wgmma with K = c2, its input normalised exactly in
//     shared memory; the global half is a per-sample vector times per-row
//     scalars,
//       sum_k>=c2 LN(row)_k W[n, k] = r (t_s[n] + (m_s - mu) u[n]) + v[n] - b[n]
//       t_s = ((g_s - m_s) * ln_w_bot) @ W_bot^T,  u = ln_w_bot @ W_bot^T,
//       v = ln_b_bot @ W_bot^T + b
//     (r = 1/std and mu of the row: r t - r mu u + v with t = (g_s * ln_w_bot)
//     @ W_bot^T, written with g_s about its own mean, which keeps the rank-1
//     term free of cancellation when |mu| >> std), so out_0's products
//     halve. pred_terms computes t_s, u and v in fp32 on the CUDA cores. A
//     split after the last unit (no out_0) ends in a launch of the
//     final unit alone on the concat row: its statistics combined as above,
//     both halves normalised exactly, the pooled half from g_s.
// Shapes whose rows do not fit on chip within 227 KB write a unit's output
// to device memory and go on in a further launch of the same kernel: the
// small predictor runs in 4 launches (head; means; terms; split out_0,
// out_1, score); the large at D=384 in 6 (head; means; terms; out_0, 768
// wide; out_1; out_2, out_3 and the score). A unit
// whose input is wider than one warpgroup's 64 rows can hold (the large
// predictor's 1536-wide inputs at D=768) keeps its input in column chunks:
// the statistics first, chunk by chunk (combined like the halves above),
// then each column tile reloads and normalises each chunk.
//
// Every tile, partial and order is a function of the shapes alone, and each
// output's sum runs in one warpgroup (or thread) in K order: the same bits
// on every launch. It takes widths of any size: a row whose width is no
// multiple of 8 ends inside an 8-column vector, whose loads, statistics and
// sums mask the rest, and lies in device memory at a pitch rounded up to 8
// (pred_pitch: the input x, each unit's weight rows, what a launch writes),
// so that every row starts 16-byte aligned; c / 2 may end inside a vector
// too.
#include <vector>

#include "ln_gemm.cuh"

namespace d2s {

constexpr int PRED_MAX_UNITS = 8;                      // units one launch runs
constexpr int PRED_BN = 128;                           // weight rows a ring stage holds
constexpr int PRED_BK = 64;                            // 128 bytes of bf16: a swizzle row
constexpr int PRED_STAGES = 4;
constexpr int PRED_STAGE_BYTES = PRED_BN * PRED_BK * 2;
constexpr int PRED_BLOCK_BYTES = 64 * PRED_BK * 2;     // 64 rows x 64 columns, swizzled
constexpr int PRED_SPITCH = PRED_BN + 8;               // bf16 pitch of the staging tile
constexpr int PRED_SMEM_MAX = 232448;
constexpr int PRED_MAX_WGS = 3;                        // MMA warpgroups a CTA, at most

// How a launch ends: its last unit's output to device memory (OUT), the
// head's local half and pooled sums (POOL), or the scores (SCORE). MEANS and
// TERMS are the launches between the head and the tail, which run no unit:
// they write the split's per-sample terms (pred_means, pred_terms).
enum PredEnd : int {
  PRED_END_OUT = 0, PRED_END_POOL = 1, PRED_END_SCORE = 2, PRED_END_MEANS = 3, PRED_END_TERMS = 4
};

// the terms launch: samples a CTA takes (with ln_w_bot and ln_b_bot, 16 rows
// of the product), outputs, and W_bot's columns a chunk; its and the means
// launch's threads
constexpr int PRED_TS = 14;
constexpr int PRED_TROWS = 16;
constexpr int PRED_TN = 128;
constexpr int PRED_TKC = 128;
constexpr int PRED_TERMS_THREADS = 256;

struct PredUnit {
  const float* ln_w;  // (K); the split unit's: the concat row's (c)
  const float* ln_b;
  const float* bias;  // (N)
  int K, N;           // columns multiplied (the split unit: c2) and outputs
  int s_ln, s_bias;   // shared-memory copies: ln_w then ln_b; the bias, zeros to a multiple of 128
};

struct PredArgs {
  CUtensorMap wmap[PRED_MAX_UNITS];  // each unit's weight (N, K): boxes of PRED_BK x PRED_BN
  PredUnit u[PRED_MAX_UNITS];
  int n_units;  // 0: the tail of a split after the last unit (the final unit on the concat row)
  // the first unit's input: row m at in + (m / in_rows) * in_bstride + (m % in_rows) * in_pitch
  const bf16* in;
  long long in_bstride;
  int in_rows, in_pitch;
  int M, ntok, samples;  // rows (B * N), tokens a sample, B
  int wgs;               // MMA warpgroups, 64 rows each
  int kc, chunks;        // the first input's resident columns, and its column chunks
  int act;
  float eps;
  // split: the first unit is out_0 (or none: n_units = 0)
  int split, c2, cg;     // local and global widths of its input
  const float* pool;     // the head's sums (groups, pool_segs, cg)
  int pool_segs;
  const bf16* w_full;    // TERMS: out_0's weight (N, c2 + cg)
  // the terms, written by the TERMS launch and read by the tail: per sample
  // (m_s, squared deviations), g (samples, cg) and t (samples, N of out_0);
  // u and v (2, N of out_0)
  float2* gstat;
  float* terms_g;
  float* terms_t;
  float* terms_uv;
  // the end
  int end;
  bf16* out;             // OUT: (M, N); POOL: (M, out_c2), the local half
  int out_pitch, out_c2;
  float* pool_out;       // POOL: (groups, pool_segs_out, N - out_c2)
  int pool_segs_out;
  bf16* scores;          // SCORE: (M)
  const float* fln_w;
  const float* fln_b;
  const bf16* fw;
  const float* fb;
  int s_fln;             // shared-memory copy of fln_w then fln_b
  // shared memory: byte offsets from the 1024-aligned base
  int off_ring, off_buf[2], buf_blocks[2], off_stage, off_rows, off_glob, off_t, off_uv, off_gstat,
      off_bar;
};

template <int NT>
__device__ __forceinline__ void pred_mma(float (&d)[NT / 2], uint64_t da, uint64_t db) {
  if constexpr (NT == 128)
    wgmma_m64n128k16<0, 0>(d, da, db);
  else if constexpr (NT == 64)
    wgmma_m64n64k16_ss<0, 0>(d, da, db, 1);
  else
    wgmma_m64n32k16_ss<0, 0>(d, da, db, 1);
}

// the column tiles of a width: 128s (at most `most`), then a 64 and a 32
// (the last one partly past the width when it is no multiple of 32). The
// split unit takes 64s: its epilogue's per-row terms beside 128 columns'
// sums exceed the registers.
__host__ __device__ __forceinline__ int pred_tile_n(int rest, int most) {
  return rest >= 128 && most >= 128 ? 128 : rest >= 64 ? 64 : 32;
}

__host__ __device__ __forceinline__ int pred_round(int v, int m) { return (v + m - 1) / m * m; }

// byte offset of (row, col) in a warpgroup's rows: 64-column blocks of 64
// rows of 128 bytes, 16-byte chunks swizzled by row % 8 (the layout of the
// TMA's 128-byte swizzle, which wgmma's descriptors name)
__device__ __forceinline__ int pred_swz(int row, int col) {
  return (col >> 6) * PRED_BLOCK_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

__device__ __forceinline__ void pred_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the generic-proxy writes to shared memory before wgmma's async-proxy reads
__device__ __forceinline__ void pred_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bf16 rounding (to nearest, ties to even) of a finite float by integer
// operations, which issue at a higher rate than the conversion
// instructions (F2F, F2FP): the same bits as __float2bfloat16
__device__ __forceinline__ uint32_t pred_bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
__device__ __forceinline__ float pred_bf16_round(float v) {
  return __uint_as_float(pred_bf16_bits(v) << 16);
}
__device__ __forceinline__ uint32_t pred_pack(float lo, float hi) {
  return pred_bf16_bits(lo) | (pred_bf16_bits(hi) << 16);
}

// a Linear's output (fp32 sum + bias) through the activation (a template
// argument: behind a run-time branch, erf's arithmetic stays in every
// element's path)
template <int ACT>
__device__ __forceinline__ float pred_act(float v) {
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  // 0.5 v (1 + erf(v / sqrt 2)), erf by Abramowitz & Stegun 7.1.26 (absolute
  // error under 1.5e-7, far below bf16's rounding), as the TPU kernel's
  // `_erf`: a reciprocal, five FMAs and one exponential, each a single
  // approximate instruction (its argument 1 + p z >= 1 needs no range
  // handling; 2^(-z^2 log2 e) <= 1 flushes to 0 where it underflows)
  const float z = fabsf(v) * 0.70710678118654752f;
  float t, e;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, z, 1.f)));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(z * z * -1.4426950408889634f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f), 0.254829592f);
  const float erf_abs = fmaf(-poly, e, 1.f);
  return 0.5f * v * (1.f + copysignf(erf_abs, v));
}

__device__ __forceinline__ void pred_load8(const unsigned char* reg, int row, int col,
                                           float (&f)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(reg + pred_swz(row, col));
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(e[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 floats of the parameters' shared-memory copies
__device__ __forceinline__ void pred_ld8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// a unit's LayerNorm width (the split unit's: the concat row's) and the
// shared-memory copy of its parameters, ln_w then ln_b
__device__ __forceinline__ int pred_ln_width(const PredArgs& p, int u) {
  return p.split && u == 0 ? p.c2 + p.cg : p.u[u].K;
}
// ln_b's offset in a copy of k values' parameters (ln_w zero-filled up to
// it, so that the 16-byte loads of a partial last vector stay aligned and
// read zeros) and the weights' row pitch in device memory: rows of k values
// lie 16-byte multiples apart
__host__ __device__ __forceinline__ int pred_pitch(int k) { return (k + 7) / 8 * 8; }
__device__ __forceinline__ const float* pred_ln(const PredArgs& p, const unsigned char* sm, int u) {
  return reinterpret_cast<const float*>(sm + p.u[u].s_ln);
}

// A row is two threads', ct and ct ^ 1 (the same warp): each takes half of
// its 8-column vectors (the last one partial where k is no multiple of 8:
// only the split's local half, c / 2, can be).
__device__ __forceinline__ void pred_half(int k, int half, int& v0, int& v1) {
  const int nv = (k + 7) >> 3, h = (nv + 1) >> 1;
  v0 = half ? h : 0;
  v1 = half ? nv : h;
}

// the sum over a thread's vectors [v0, v1) of a row of f(8 values): four
// vectors at a time into four sums (loads in flight together), added in a
// fixed order
template <typename F>
__device__ __forceinline__ float pred_row_sum(const unsigned char* reg, int row, int v0, int v1,
                                              F f) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int v = v0;
  for (; v + 4 <= v1; v += 4) {
    float x[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) pred_load8(reg, row, (v + i) * 8, x[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += f(x[i]);
  }
  for (; v < v1; ++v) {
    float x[8];
    pred_load8(reg, row, v * 8, x);
    s[0] += f(x);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// (mean, sum of squared deviations about it) of columns [0, k) of a row,
// zeros from k to the next multiple of 8: two passes, the pair's halves
// added (the same bits in both threads); the zeros' squared deviations taken
// off
__device__ __forceinline__ float2 pred_row_stats(const unsigned char* reg, int row, int k,
                                                  int half) {
  int v0, v1;
  pred_half(k, half, v0, v1);
  float s = pred_row_sum(reg, row, v0, v1, [](const float (&x)[8]) {
    return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
  });
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  const float mean = __fdividef(s, (float)k);
  float q = pred_row_sum(reg, row, v0, v1, [mean](const float (&x)[8]) {
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = (x[i] - mean) * (x[i] - mean);
    return ((d[0] + d[1]) + (d[2] + d[3])) + ((d[4] + d[5]) + (d[6] + d[7]));
  });
  q += __shfl_xor_sync(0xffffffffu, q, 1);
  if (k & 7) q -= (float)(8 - (k & 7)) * mean * mean;
  return make_float2(mean, q);
}

// the (mean, squared deviations) of two sets of na and nb values together
__device__ __forceinline__ float2 pred_combine(float na, float2 a, float nb, float2 b) {
  const float n = na + nb;
  const float mu = __fdividef(na * a.x + nb * b.x, n);
  const float da = a.x - mu, db = b.x - mu;
  return make_float2(mu, a.y + b.y + na * da * da + nb * db * db);
}

// LayerNorm in place: columns [0, k) of a row, bf16((v - mu) r w + b)
__device__ __forceinline__ void pred_row_normalize(unsigned char* reg, int row, int k, int half,
                                                   float mu, float r, const float* ln_w,
                                                   const float* ln_b) {
  int v0, v1;
  pred_half(k, half, v0, v1);
#pragma unroll 4
  for (int v = v0; v < v1; ++v) {
    uint4* slot = reinterpret_cast<uint4*>(reg + pred_swz(row, v * 8));
    float x[8], w[8], b[8];
    pred_load8(reg, row, v * 8, x);
    pred_ld8(ln_w + v * 8, w);
    pred_ld8(ln_b + v * 8, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = (x[i] - mu) * r * w[i] + b[i];
    *slot = make_uint4(pred_pack(x[0], x[1]), pred_pack(x[2], x[3]), pred_pack(x[4], x[5]),
                       pred_pack(x[6], x[7]));
  }
}

// Chunk c of the first unit's input (columns [c kc, c kc + kc), zeros past
// K up to the next multiple of 16) for a warpgroup's 64 rows from row0, by
// cp.async at each row's address (16 bytes, fewer for a vector across K,
// the rest zero-filled); rows past M arrive as zeros. Issued and committed:
// the caller waits.
__device__ __forceinline__ void pred_issue_chunk(const PredArgs& p, unsigned char* reg, int row0,
                                                 int c, int ct) {
  const int K = p.u[0].K;
  const int col0 = c * p.kc;
  const int nv = (min(pred_round(K, 16), col0 + p.kc) - col0) >> 3;
  const int warp = ct >> 5, lane = ct & 31;
  for (int row = warp; row < 64; row += 4) {  // a warp a row, its lanes along it
    const int m = row0 + row;
    const bf16* src = m < p.M ? p.in + (m / p.in_rows) * p.in_bstride +
                                    (long long)(m % p.in_rows) * p.in_pitch
                              : p.in;
    for (int v = lane; v < nv; v += 32) {
      const int col = col0 + v * 8;
      const int bytes = m < p.M ? 2 * max(0, min(8, K - col)) : 0;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(reg + pred_swz(row, v * 8)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                   "l"(bytes ? src + col : p.in), "r"(bytes));
    }
  }
  cp_async_commit();
}

// The MEANS launch, after the head: two samples a CTA, 128 threads each.
// The pooled mean g_s: the head's sums of the sample's groups added in
// group order, divided by N, rounded to bf16 (the plain version's concat);
// m_s and the squared deviations of g_s about it, each thread's columns in
// order, then its four warps' sums in order.
__device__ __forceinline__ void pred_means(const PredArgs& p, unsigned char* sm) {
  constexpr int T = PRED_TERMS_THREADS / 2;
  const int half = threadIdx.x / T, tid = threadIdx.x % T, warp = tid >> 5, lane = tid & 31;
  const int cg = p.cg, N = p.ntok, smp = 2 * blockIdx.x + half;
  float* red = reinterpret_cast<float*>(sm) + half * (T / 32);            // its warps' sums
  float* gl = reinterpret_cast<float*>(sm) + 2 * (T / 32) + half * cg;    // its means
  if (smp < p.samples) {
    float* out = p.terms_g + (long long)smp * cg;
    const int src = smp;  // the sample whose partial sums are added
    const int g0 = (src * N) >> 6, g1 = ((src + 1) * N - 1) >> 6;
    // four columns a thread at a time, so that their loads are in flight together
    float a = 0.f;
    for (int j0 = tid; j0 < cg; j0 += 4 * T) {
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int g = g0; g <= g1; ++g) {
        const float* part = p.pool + ((long long)g * p.pool_segs + src - (g << 6) / N) * cg;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = j0 + e * T < cg ? part[j0 + e * T] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e] += v[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e * T < cg) {
          const float m = pred_bf16_round(__fdividef(sum[e], (float)N));
          gl[j0 + e * T] = m;
          out[j0 + e * T] = m;
          a += m;
        }
    }
    a = warp_sum(a);
    if (lane == 0) red[warp] = a;
  }
  __syncthreads();
  if (smp >= p.samples) return;
  float tot = 0.f;
  for (int w = 0; w < T / 32; ++w) tot += red[w];
  const float m = __fdividef(tot, (float)cg);
  float q = 0.f;
  for (int j = tid; j < cg; j += T) {
    const float d = gl[j] - m;
    q += d * d;
  }
  q = warp_sum(q);
  pred_bar(1 + half, T);  // its warps have read the sums
  if (lane == 0) red[warp] = q;
  pred_bar(1 + half, T);
  if (tid == 0) {
    float qt = 0.f;
    for (int w = 0; w < T / 32; ++w) qt += red[w];
    p.gstat[smp] = make_float2(m, qt);
  }
}

// The TERMS launch, after the means, where out_0 follows the split: CTA
// (x, y) takes samples s0 = 14 y .. s0 + 13 and outputs 128 x .. 128 x +
// 127 of out_0: t_s = ((g_s - m_s) ln_w_bot) W_bot^T, and u = ln_w_bot
// W_bot^T and v = ln_b_bot W_bot^T + b as two more rows of the same product
// (written by CTAs y = 0). The 16 rows go to shared memory once, k-major (a
// thread's eight rows at one k are two 16-byte loads, the same for the
// whole warp); W_bot's 128 outputs come in 128-column chunks, coalesced,
// the next chunk in registers while this one's products run, into rows
// padded to 65 words (a warp's 32 outputs at one k in 32 banks); a thread
// takes one output and eight rows, each sum in K order, fp32 on the CUDA
// cores.
__device__ __forceinline__ void pred_terms(const PredArgs& p, unsigned char* sm) {
  constexpr int T = PRED_TERMS_THREADS, RP = PRED_TROWS + 4;  // RP: the rows' pitch
  constexpr int WP = PRED_TKC / 2 + 1;                          // W_bot's row pitch, words
  constexpr int PER = PRED_TN * PRED_TKC / 4 / T;               // 4-column loads a thread
  const int tid = threadIdx.x;
  const int cg = p.cg, c2 = p.c2, n0 = p.u[0].N, nb = blockIdx.x * PRED_TN;
  const int s0 = blockIdx.y * PRED_TS, S = min(PRED_TS, p.samples - s0);
  float* gk = reinterpret_cast<float*>(sm + p.off_glob);        // [cg][RP]
  uint32_t* ws = reinterpret_cast<uint32_t*>(sm + p.off_t);     // [PRED_TN][WP]
  float2* gs = reinterpret_cast<float2*>(sm + p.off_gstat);     // [PRED_TS]
  const float* lw = p.u[0].ln_w + c2;  // the global half's LayerNorm
  const float* lb = p.u[0].ln_b + c2;
  // W_bot's chunk at column k0: load e of a thread is output row (tid + e T)
  // / 32, columns 4 ((tid + e T) % 32) .. + 3 (8-byte aligned where c2 is a
  // multiple of 4, the rows pred_pitch(c) apart; else column by column,
  // zeros past cg)
  const int wp = pred_pitch(c2 + cg);
  uint2 wn[PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * T, r = i >> 5, k = k0 + 4 * (i & 31);
      const bf16* src = p.w_full + (long long)(nb + r) * wp + c2 + k;
      if (nb + r >= n0 || k >= cg) {
        wn[e] = make_uint2(0u, 0u);
      } else if ((c2 & 3) == 0) {
        wn[e] = __ldg(reinterpret_cast<const uint2*>(src));
      } else {
        uint16_t h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = k + j < cg ? __ldg(reinterpret_cast<const unsigned short*>(src) + j) : 0;
        wn[e] = make_uint2(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16);
      }
    }
  };
  fetch(0);
  for (int s = tid; s < S; s += T) gs[s] = p.gstat[s0 + s];
  __syncthreads();
  // the rows: eight entries a thread at a time, their loads in flight together
  for (int i0 = tid; i0 < PRED_TROWS * cg; i0 += 8 * T) {
    float g[8], w[8];
    int r[8], k[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = min(i0 + e * T, PRED_TROWS * cg - 1);
      r[e] = i / cg;
      k[e] = i - r[e] * cg;
      g[e] = r[e] < S ? p.terms_g[(long long)(s0 + r[e]) * cg + k[e]] : 0.f;
      w[e] = __ldg((r[e] == PRED_TS + 1 ? lb : lw) + k[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = r[e] < S ? (g[e] - gs[r[e]].x) * w[e] : r[e] >= PRED_TS ? w[e] : 0.f;
      if (i0 + e * T < PRED_TROWS * cg) gk[k[e] * RP + r[e]] = v;
    }
  }
  const int n = tid % PRED_TN, r0 = (tid / PRED_TN) * 8;  // a warp's rows are the same
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < cg; k0 += PRED_TKC) {
    __syncthreads();  // the last chunk's products are done
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * T, r = i >> 5, j = i & 31;
      ws[r * WP + 2 * j] = wn[e].x;
      ws[r * WP + 2 * j + 1] = wn[e].y;
    }
    __syncthreads();
    if (k0 + PRED_TKC < cg) fetch(k0 + PRED_TKC);
    const int kn = min(PRED_TKC, cg - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; kk += 2) {
      const uint32_t w2 = ws[n * WP + (kk >> 1)];
      const float wv[2] = {__uint_as_float(w2 << 16), __uint_as_float(w2 & 0xffff0000u)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* gp = gk + (k0 + kk + h) * RP + r0;
        const float4 ga = *reinterpret_cast<const float4*>(gp);
        const float4 gb = *reinterpret_cast<const float4*>(gp + 4);
        acc[0] = fmaf(ga.x, wv[h], acc[0]);
        acc[1] = fmaf(ga.y, wv[h], acc[1]);
        acc[2] = fmaf(ga.z, wv[h], acc[2]);
        acc[3] = fmaf(ga.w, wv[h], acc[3]);
        acc[4] = fmaf(gb.x, wv[h], acc[4]);
        acc[5] = fmaf(gb.y, wv[h], acc[5]);
        acc[6] = fmaf(gb.z, wv[h], acc[6]);
        acc[7] = fmaf(gb.w, wv[h], acc[7]);
      }
    }
  }
  if (nb + n >= n0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    if (r < S)
      p.terms_t[(long long)(s0 + r) * n0 + nb + n] = acc[i];
    else if (r == PRED_TS && blockIdx.y == 0)
      p.terms_uv[nb + n] = acc[i];
    else if (r == PRED_TS + 1 && blockIdx.y == 0)
      p.terms_uv[n0 + nb + n] = acc[i] + __ldg(p.u[0].bias + nb + n);
  }
}

// The tail's copy of the terms for its samples s_lo .. s_lo + S - 1: (m_s,
// squared deviations); t_s, u and v in rows of pred_round(N, 128), zeros
// past N (the epilogue reads them there), or, with no unit after the split,
// g_s.
__device__ __forceinline__ void pred_load_terms(const PredArgs& p, unsigned char* sm, int s_lo,
                                                int S, int tid, int threads) {
  float2* gs = reinterpret_cast<float2*>(sm + p.off_gstat);
  for (int s = tid; s < S; s += threads) gs[s] = p.gstat[s_lo + s];
  if (p.n_units == 0) {
    float* gl = reinterpret_cast<float*>(sm + p.off_glob);
    for (int i = tid; i < S * p.cg; i += threads) gl[i] = p.terms_g[(long long)s_lo * p.cg + i];
    return;
  }
  const int n0 = p.u[0].N, np = pred_round(n0, PRED_BN);
  float* tt = reinterpret_cast<float*>(sm + p.off_t);
  float* uu = reinterpret_cast<float*>(sm + p.off_uv);
  for (int i = tid; i < S * np; i += threads) {
    const int s = i / np, n = i - s * np;
    tt[i] = n < n0 ? p.terms_t[(long long)(s_lo + s) * n0 + n] : 0.f;
  }
  for (int i = tid; i < 2 * np; i += threads) {
    const int h = i / np, n = i - h * np;
    uu[i] = n < n0 ? p.terms_uv[h * n0 + n] : 0.f;
  }
}

// One column tile's epilogue for a warpgroup's 64 rows: bias (the split
// unit: its rank-1 global term and v) and activation, bf16, into the staging
// tile (row-major) or the next unit's buffer (swizzled; zeros from N to the
// next multiple of 16, which its products read). The bias is loaded before
// the arithmetic, so that its loads are in flight together.
template <int NT, int ACT>
__device__ __forceinline__ void pred_epilogue(const PredArgs& p, const unsigned char* sm, int u,
                                              const float (&acc)[NT / 2], int n0,
                                              unsigned char* dst, bool to_stage, int row0,
                                              int s_lo, int wg, int warp, int lane) {
  const PredUnit& U = p.u[u];
  const int N = U.N, N16 = pred_round(N, 16);
  const int g = lane >> 2, t = lane & 3;
  const bool split = p.split && u == 0;
  // What each column pair adds: the bias, or the split unit's terms. No
  // branch may depend on the column (ptxas would wrap each pair's
  // activation in one, and the pairs would run one at a time): both copies
  // are zero past N, where the sums are 0 too (the weight's rows there
  // arrive as zeros), so that act(0) = 0 goes into the zeros the next
  // unit's products read.
  float2 add[NT / 8];
  if (!split) {  // the copy's zeros past N
    const float* bias = reinterpret_cast<const float*>(sm + U.s_bias);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      add[j] = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t);
  }
  // the split unit's t, u, v: rows of pred_round(N, 128), zeros past N
  const int np = pred_round(N, 128);
  const float2* rows = reinterpret_cast<const float2*>(sm + p.off_rows) + wg * 64;
  const float* uu = reinterpret_cast<const float*>(sm + p.off_uv);
  const float* vv = uu + np;
  const float2* gs = reinterpret_cast<const float2*>(sm + p.off_gstat);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
    if (split) {  // r t + (r (m_s - mu)) u + v
      const int s = min(row0 + row, p.M - 1) / p.ntok - s_lo;
      const float2 st = rows[row];  // (mu, 1/std)
      const float r = st.y, rd = st.y * (gs[s].x - st.x);
      const float* ts = reinterpret_cast<const float*>(sm + p.off_t) + s * np;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 tv = *reinterpret_cast<const float2*>(ts + col);
        const float2 uv = *reinterpret_cast<const float2*>(uu + col);
        const float2 vb = *reinterpret_cast<const float2*>(vv + col);
        add[j] = make_float2(fmaf(r, tv.x, fmaf(rd, uv.x, vb.x)),
                             fmaf(r, tv.y, fmaf(rd, uv.y, vb.y)));
      }
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const uint32_t pk = pred_pack(pred_act<ACT>(acc[4 * j + 2 * h] + add[j].x),
                                    pred_act<ACT>(acc[4 * j + 2 * h + 1] + add[j].y));
      if (to_stage)
        *reinterpret_cast<uint32_t*>(dst + (row * PRED_SPITCH + 8 * j + 2 * t) * 2) = pk;
      else if (col < N16)
        *reinterpret_cast<uint32_t*>(dst + pred_swz(row, col)) = pk;
    }
  }
}

// A staged column tile to device memory (16-byte stores; POOL: only the
// local half's columns) and, for POOL, the global half's column sums: thread
// ct takes column n0 + ct down the warpgroup's 64 rows in order, one sum a
// sample segment.
__device__ __forceinline__ void pred_store_tile(const PredArgs& p, const unsigned char* stage,
                                                int n, int n0, int nt, int grp, int ct) {
  const int row0 = grp * 64;
  const bool pool = p.end == PRED_END_POOL;
  const int cols = pool ? p.out_c2 : n;
  const int nv = nt >> 3;
  for (int i = ct; i < 64 * nv; i += 128) {
    const int row = i / nv, v = i - row * nv;
    const int m = row0 + row, col = n0 + v * 8;
    if (m < p.M && col < cols)
      *reinterpret_cast<uint4*>(p.out + (long long)m * p.out_pitch + col) =
          *reinterpret_cast<const uint4*>(stage + (row * PRED_SPITCH + v * 8) * 2);
  }
  const int col = n0 + ct;
  if (!pool || ct >= nt || col < p.out_c2 || col >= n || row0 >= p.M) return;
  const int cg = n - p.out_c2;
  const int rows = min(64, p.M - row0);
  float* dst = p.pool_out + (long long)grp * p.pool_segs_out * cg + (col - p.out_c2);
  auto at = [&](int row) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(stage + (row * PRED_SPITCH + ct) * 2));
  };
  // the rows of each sample in turn, four sums a segment added in a fixed order
  int next = (row0 / p.ntok + 1) * p.ntok - row0;  // where the next sample starts
  for (int seg = 0, ra = 0; ra < rows; ++seg, ra = next, next += p.ntok) {
    const int rb = min(rows, next);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int row = ra;
    for (; row + 4 <= rb; row += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] += at(row + i);
    }
    for (; row < rb; ++row) a[0] += at(row);
    dst[(long long)seg * cg] = (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// A thread's share of the final unit's dot product over columns [0, k) of
// a row in shared memory: bf16((x - mu) r w + b) times the head's weight
// (a partial last vector masked)
__device__ __forceinline__ float pred_score_dot(const unsigned char* reg, int row, int k, int half,
                                                float mu, float r, const float* w, const float* b,
                                                const bf16* fw) {
  int v0, v1;
  pred_half(k, half, v0, v1);
  float dot = 0.f;
  for (int v = v0; v < v1; ++v) {
    float f[8], lw[8], lb[8];
    pred_load8(reg, row, v * 8, f);
    pred_ld8(w + v * 8, lw);
    pred_ld8(b + v * 8, lb);
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(fw + v * 8));
    const bf16* e = reinterpret_cast<const bf16*>(&q);
    const int lim = k - v * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = pred_bf16_round((f[i] - mu) * r * lw[i] + lb[i]);
      dot += i < lim ? y * __bfloat162float(e[i]) : 0.f;
    }
  }
  return dot;
}

// The final unit from the last unit's output (k columns, bf16) in shared
// memory: LayerNorm, the dot product with the 1-unit head, the bias.
__device__ __forceinline__ void pred_scores(const PredArgs& p, const unsigned char* reg,
                                            const unsigned char* sm_fln, int k, int row0,
                                            int ct) {
  const int row = ct >> 1, half = ct & 1;
  const float2 st = pred_row_stats(reg, row, k, half);
  const float mu = st.x, r = rsqrtf(__fdividef(st.y, (float)k) + p.eps);
  const float* fln = reinterpret_cast<const float*>(sm_fln);
  float dot = pred_score_dot(reg, row, k, half, mu, r, fln, fln + pred_pitch(k), p.fw);
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  const int m = row0 + row;
  if (half == 0 && m < p.M) p.scores[m] = __float2bfloat16(dot + __ldg(p.fb));
}

// The final unit on the concat row, for a split after the last unit: the
// local half (c2 columns) in shared memory, the pooled half g_s of the
// row's sample in the terms' copy, the row's statistics (mu, r) combined
// from both
__device__ __forceinline__ void pred_scores_concat(const PredArgs& p, const unsigned char* reg,
                                                   const unsigned char* sm, float mu, float r,
                                                   int row0, int s_lo, int ct) {
  const int row = ct >> 1, half = ct & 1;
  const int c2 = p.c2, c = c2 + p.cg;
  const float* fln = reinterpret_cast<const float*>(sm + p.s_fln);
  const int cp = pred_pitch(c);
  float dot = pred_score_dot(reg, row, c2, half, mu, r, fln, fln + cp, p.fw);
  const int s = min(row0 + row, p.M - 1) / p.ntok - s_lo;
  const float* g = reinterpret_cast<const float*>(sm + p.off_glob) + s * p.cg;
  for (int j = half; j < p.cg; j += 2) {
    const float y = pred_bf16_round((g[j] - mu) * r * fln[c2 + j] + fln[cp + c2 + j]);
    dot += y * __bfloat162float(p.fw[c2 + j]);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  const int m = row0 + row;
  if (half == 0 && m < p.M) p.scores[m] = __float2bfloat16(dot + __ldg(p.fb));
}

// One column tile of unit u for a warpgroup: the products over the unit's K
// slices from the ring (chunk by chunk for a chunked first input, each
// chunk reloaded and normalised first), then the epilogue.
template <int NT>
__device__ __forceinline__ void pred_tile(const PredArgs& p, unsigned char* sm, int u, int n0,
                                          unsigned char* src, unsigned char* dst, bool to_stage,
                                          int& stage, uint32_t& phase, int row0, int grp, int s_lo,
                                          int wg, int ct) {
  const PredUnit& U = p.u[u];
  const int warp = ct >> 5, lane = ct & 31;
  unsigned char* ring = sm + p.off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.off_bar);
  uint64_t* empty = full + PRED_STAGES;
  const int k16 = pred_round(U.K, 16);
  const int chunks = u ? 1 : p.chunks;
  const int kc = u ? pred_round(k16, 64) : p.kc;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if (chunks > 1) {
      pred_bar(1 + wg, 128);  // the last chunk's products are done
      pred_issue_chunk(p, src, row0, c, ct);
      cp_async_wait<0>();
      pred_bar(1 + wg, 128);
      const float2 st = reinterpret_cast<const float2*>(sm + p.off_rows)[wg * 64 + (ct >> 1)];
      const float* ln = pred_ln(p, sm, u);
      pred_row_normalize(src, ct >> 1, min(U.K - c * kc, kc), ct & 1, st.x, st.y, ln + c * kc,
                         ln + pred_pitch(pred_ln_width(p, u)) + c * kc);
      pred_fence_async();
      pred_bar(1 + wg, 128);
    }
    const int k_end = min(k16, (c + 1) * kc);
    int prev = -1;
    for (int k0 = c * kc; k0 < k_end; k0 += PRED_BK) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a_s = src + ((k0 - c * kc) >> 6) * PRED_BLOCK_BYTES;
      const unsigned char* b_s = ring + stage * PRED_STAGE_BYTES;
      const int steps = min(4, (k_end - k0) >> 4);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < steps)
          pred_mma<NT>(acc, wgmma_desc(a_s + kk * 32, 16, 1024),
                       wgmma_desc(b_s + kk * 32, 16, 1024));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous slice's products are done: release its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == PRED_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  if (to_stage) pred_bar(1 + wg, 128);  // the previous tile's staged rows are stored
  if (p.act == ACT_GELU)
    pred_epilogue<NT, ACT_GELU>(p, sm, u, acc, n0, dst, to_stage, row0, s_lo, wg, warp, lane);
  else
    pred_epilogue<NT, ACT_RELU>(p, sm, u, acc, n0, dst, to_stage, row0, s_lo, wg, warp, lane);
  if (to_stage) {
    pred_bar(1 + wg, 128);
    pred_store_tile(p, dst, U.N, n0, NT, grp, ct);
  }
}

// Threads: 128 per MMA warpgroup (warpgroup wg takes rows 64 wg .. 64 wg +
// 63 of the tile), then one producer warp.
__device__ __forceinline__ void pred_body(const PredArgs& p) {
  extern __shared__ unsigned char pred_smem[];
  // the 1024-aligned base, as an offset into the array so that the
  // compiler keeps its accesses in the shared space (LDS / STS)
  unsigned char* sm = pred_smem + ((1024 - (smem_u32(pred_smem) & 1023)) & 1023);
  if (p.end == PRED_END_MEANS) {
    pred_means(p, sm);
    return;
  }
  if (p.end == PRED_END_TERMS) {
    pred_terms(p, sm);
    return;
  }
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + p.off_bar);
  uint64_t* empty = full + PRED_STAGES;
  const int tid = threadIdx.x;
  const int mma_threads = 128 * p.wgs;
  if (tid == 0) {
    for (int s = 0; s < PRED_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * p.wgs);  // every MMA warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= mma_threads) {  // the producer: every unit's weight slices, in the consumers' order
    if (tid == mma_threads) {
      unsigned char* ring = sm + p.off_ring;
      int stage = 0;
      uint32_t phase = 0;
      auto load = [&](const CUtensorMap* map, int k0, int n0) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], PRED_STAGE_BYTES);
        tma_load_2d(ring + stage * PRED_STAGE_BYTES, map, &full[stage], k0, n0);
        if (++stage == PRED_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int u = 0; u < p.n_units; ++u) {
        const int k16 = pred_round(p.u[u].K, 16);
        const int chunks = u ? 1 : p.chunks;
        const int kc = u ? pred_round(k16, 64) : p.kc;
        const int most = p.split && u == 0 ? 64 : 128;
        for (int n0 = 0; n0 < p.u[u].N; n0 += pred_tile_n(p.u[u].N - n0, most))
          for (int c = 0; c < chunks; ++c)
            for (int k0 = c * kc; k0 < min(k16, (c + 1) * kc); k0 += PRED_BK)
              load(&p.wmap[u], k0, n0);
      }
    }
    return;
  }

  const int wg = tid >> 7, ct = tid & 127;
  const int grp = blockIdx.x * p.wgs + wg;  // the warpgroup's group of 64 rows
  const int row0 = grp * 64;
  const int tile0 = blockIdx.x * 64 * p.wgs;  // the tile's first row
  const int s_lo = tile0 / p.ntok;
  const int S = (min(tile0 + 64 * p.wgs, p.M) - 1) / p.ntok - s_lo + 1;  // samples of the tile
  unsigned char* const buf0 = sm + p.off_buf[0] + wg * p.buf_blocks[0] * PRED_BLOCK_BYTES;
  unsigned char* const buf1 = sm + p.off_buf[1] + wg * p.buf_blocks[1] * PRED_BLOCK_BYTES;
  unsigned char* staging = sm + p.off_stage + wg * 64 * PRED_SPITCH * 2;
  float2* rows = reinterpret_cast<float2*>(sm + p.off_rows) + wg * 64;
  // the first chunk's rows load while the launch's LayerNorm parameters
  // and biases go to shared memory (the biases with zeros to a multiple of
  // 128, which the epilogue reads past N), and the split's per-sample terms
  pred_issue_chunk(p, buf0, row0, 0, ct);
  for (int u = 0; u < p.n_units; ++u) {
    const PredUnit& U = p.u[u];
    const int kl = pred_ln_width(p, u), kp = pred_pitch(kl);
    float* ln = reinterpret_cast<float*>(sm + U.s_ln);
    for (int i = tid; i < kp; i += mma_threads) {
      ln[i] = i < kl ? __ldg(U.ln_w + i) : 0.f;
      ln[kp + i] = i < kl ? __ldg(U.ln_b + i) : 0.f;
    }
    float* bias = reinterpret_cast<float*>(sm + U.s_bias);
    for (int i = tid; i < pred_round(U.N, 128); i += mma_threads)
      bias[i] = i < U.N ? __ldg(U.bias + i) : 0.f;
  }
  if (p.end == PRED_END_SCORE) {
    const int k = p.n_units ? p.u[p.n_units - 1].N : p.c2 + p.cg, kp = pred_pitch(k);
    float* fln = reinterpret_cast<float*>(sm + p.s_fln);
    for (int i = tid; i < kp; i += mma_threads) {
      fln[i] = i < k ? __ldg(p.fln_w + i) : 0.f;
      fln[kp + i] = i < k ? __ldg(p.fln_b + i) : 0.f;
    }
  }
  if (p.split) pred_load_terms(p, sm, s_lo, S, tid, mma_threads);
  pred_bar(1 + PRED_MAX_WGS, mma_threads);
  int stage = 0;
  uint32_t phase = 0;

  // the first unit's row statistics, chunk by chunk; the split unit's with
  // its sample's pooled half
  const PredUnit& U0 = p.u[0];
  const int row = ct >> 1, half = ct & 1;
  float2 st = make_float2(0.f, 0.f);
  float n_st = 0.f;
  for (int c = 0; c < p.chunks; ++c) {
    if (c) {
      pred_bar(1 + wg, 128);  // the last chunk's statistics are read
      pred_issue_chunk(p, buf0, row0, c, ct);
    }
    cp_async_wait<0>();
    pred_bar(1 + wg, 128);
    const int k = min(U0.K - c * p.kc, p.kc);
    const float2 part = pred_row_stats(buf0, row, k, half);
    st = c ? pred_combine(n_st, st, k, part) : part;
    n_st += k;
  }
  if (p.split) {
    const int s = min(row0 + row, p.M - 1) / p.ntok - s_lo;
    st = pred_combine(n_st, st, p.cg, reinterpret_cast<const float2*>(sm + p.off_gstat)[s]);
    n_st += p.cg;
  }
  const float rstd = rsqrtf(__fdividef(st.y, n_st) + p.eps);
  if (p.n_units == 0) {
    pred_scores_concat(p, buf0, sm, st.x, rstd, row0, s_lo, ct);
    return;
  }
  if (half == 0) rows[row] = make_float2(st.x, rstd);
  if (p.chunks == 1) {
    const float* ln = pred_ln(p, sm, 0);
    pred_row_normalize(buf0, row, U0.K, half, st.x, rstd, ln,
                       ln + pred_pitch(pred_ln_width(p, 0)));
    pred_fence_async();
  }
  pred_bar(1 + wg, 128);

  for (int u = 0; u < p.n_units; ++u) {
    const PredUnit& U = p.u[u];
    const bool last = u + 1 == p.n_units;
    const bool to_stage = last && p.end != PRED_END_SCORE;
    unsigned char* src = u & 1 ? buf1 : buf0;
    unsigned char* dst = to_stage ? staging : u & 1 ? buf0 : buf1;
    for (int n0 = 0; n0 < U.N;) {
      const int nt = pred_tile_n(U.N - n0, p.split && u == 0 ? 64 : 128);
      if (nt == 128)
        pred_tile<128>(p, sm, u, n0, src, dst, to_stage, stage, phase, row0, grp, s_lo, wg, ct);
      else if (nt == 64)
        pred_tile<64>(p, sm, u, n0, src, dst, to_stage, stage, phase, row0, grp, s_lo, wg, ct);
      else
        pred_tile<32>(p, sm, u, n0, src, dst, to_stage, stage, phase, row0, grp, s_lo, wg, ct);
      n0 += nt;
    }
    if (to_stage) break;
    __syncwarp();  // a warp's epilogue wrote the rows its own pairs read next
    if (last) {
      pred_scores(p, dst, sm + p.s_fln, U.N, row0, ct);
      break;
    }
    const float2 s2 = pred_row_stats(dst, row, U.N, half);
    const float* ln = pred_ln(p, sm, u + 1);
    pred_row_normalize(dst, row, U.N, half, s2.x, rsqrtf(__fdividef(s2.y, (float)U.N) + p.eps),
                       ln, ln + pred_pitch(U.N));
    pred_fence_async();
    pred_bar(1 + wg, 128);
  }
}

// The two kernels, one body: launches of up to two warpgroups, and of three
// (rows that fit three warpgroups' shared memory: the small predictor's
// tail), whose 13 warps leave 128 registers a thread (four warps share one
// of the SM's four 64 KB register files), with some spills.
static __global__ void __launch_bounds__(2 * 128 + 32, 1)
    predictor_kernel(const __grid_constant__ PredArgs p) {
  pred_body(p);
}

static __global__ void __launch_bounds__(3 * 128 + 32, 1)
    predictor_kernel_wide(const __grid_constant__ PredArgs p) {
  pred_body(p);
}

// ---- host: the plan of launches --------------------------------------------

struct PredLaunch {
  int s_ln[PRED_MAX_UNITS], s_bias[PRED_MAX_UNITS], s_fln;  // the parameters' copies
  int a, b;  // the units it runs (b = a - 1: none, the terms or a split's final unit)
  int wgs, kc, chunks, end;
  int s_max;  // samples one of its row tiles touches, at most
  int off_ring, off_buf[2], buf_blocks[2], off_stage, off_rows, off_glob, off_t, off_uv,
      off_gstat, off_bar, smem;
};

struct PredShapes {
  int B, N, D, n_units, n_in;
  const int* widths;
  int in_width(int u) const { return u ? widths[u - 1] : D; }
  int M() const { return B * N; }
  // the split's input: c = the head's output width, c2 its local half
  int c() const { return widths[n_in - 1]; }
  int c2() const { return c() / 2; }
  int cg() const { return c() - c() / 2; }
  // out_0's width, or 0 for a split after the last unit
  int n0() const { return n_in < n_units ? widths[n_in] : 0; }
  // the head's pooled sums: segments a group of 64 rows touches, at most
  int pool_segs() const { return std::min(B, 62 / N + 2); }
};

// Lays out L's shared memory; returns its bytes (with the base's alignment).
static int pred_layout(PredLaunch& L, const PredShapes& s) {
  int off = 0;
  auto take = [&](long long bytes, int align) {
    off = pred_round(off, align);
    const int at = off;
    off += (int)std::min<long long>(bytes, PRED_SMEM_MAX + 1);
    return at;
  };
  if (L.end == PRED_END_MEANS) {
    take((PRED_TERMS_THREADS / 32 + 2LL * s.cg()) * 4, 16);
    return off + 1024;
  }
  if (L.end == PRED_END_TERMS) {
    L.off_glob = take((long long)s.cg() * (PRED_TROWS + 4) * 4, 16);
    L.off_t = take(PRED_TN * (PRED_TKC / 2 + 1) * 4, 16);
    L.off_gstat = take(PRED_TS * 8, 16);
    return off + 1024;
  }
  int blocks[2] = {L.kc / 64, 0};
  for (int u = L.a; u <= L.b; ++u) {
    if (u == L.b && L.end != PRED_END_SCORE) break;  // staged, not kept
    const int i = (u - L.a + 1) & 1;
    blocks[i] = std::max(blocks[i], pred_round(pred_round(s.widths[u], 16), 64) / 64);
  }
  L.off_ring = take(PRED_STAGES * PRED_STAGE_BYTES, 1024);
  L.off_buf[0] = take((long long)L.wgs * blocks[0] * PRED_BLOCK_BYTES, 1024);
  L.off_buf[1] = take((long long)L.wgs * blocks[1] * PRED_BLOCK_BYTES, 1024);
  L.buf_blocks[0] = blocks[0];
  L.buf_blocks[1] = blocks[1];
  L.off_stage = take(L.end != PRED_END_SCORE ? L.wgs * 64 * PRED_SPITCH * 2 : 0, 16);
  L.off_rows = take(L.wgs * 64 * 8, 16);
  L.s_max = std::min(s.B, (64 * L.wgs - 2) / s.N + 2);
  L.off_glob = L.off_t = L.off_uv = L.off_gstat = off;
  if (L.a == s.n_in) {  // the terms' copy
    const int np = pred_round(s.n0(), PRED_BN);
    if (np) {
      L.off_t = take((long long)L.s_max * np * 4, 16);
      L.off_uv = take(2LL * np * 4, 16);
    } else {
      L.off_glob = take((long long)L.s_max * s.cg() * 4, 16);
    }
    L.off_gstat = take(L.s_max * 8, 16);
  }
  for (int u = L.a; u <= L.b; ++u) {
    const int kl = u == s.n_in ? s.c() : s.in_width(u);
    L.s_ln[u - L.a] = take(2LL * pred_pitch(kl) * 4, 16);
    L.s_bias[u - L.a] = take((long long)pred_round(s.widths[u], 128) * 4, 16);
  }
  L.s_fln = take(L.end == PRED_END_SCORE ? 2LL * pred_pitch(s.widths[s.n_units - 1]) * 4 : 0, 16);
  L.off_bar = take(2 * PRED_STAGES * 8, 8);
  return off + 1024;
}

// Launches in order, from the shapes alone: each runs as many consecutive
// units as fit on chip (two warpgroups of rows where the first unit's input
// fits, else one; a first input too wide even then in column chunks,
// alone), never across the split, which needs every head tile's sums first.
// After the head, the terms; a split after the last unit ends in a launch of
// the final unit alone.
static bool pred_plan(const PredShapes& s, std::vector<PredLaunch>& plan) {
  auto end_of = [&](int b) {
    return b == s.n_in - 1 ? PRED_END_POOL : b == s.n_units - 1 ? PRED_END_SCORE : PRED_END_OUT;
  };
  auto fits = [&](PredLaunch& L) {
    L.smem = pred_layout(L, s);
    return L.smem <= PRED_SMEM_MAX;
  };
  for (int a = 0; a < s.n_units;) {
    const int stop = a < s.n_in ? s.n_in : s.n_units;
    const int kin = a == s.n_in ? s.c2() : s.in_width(a);
    const int k16 = pred_round(kin, 16), kfull = pred_round(k16, 64);
    PredLaunch L{};
    bool found = false;
    for (int wgs = PRED_MAX_WGS; wgs >= 1 && !found; --wgs) {
      for (int b = a; b < stop && b - a < PRED_MAX_UNITS; ++b) {
        PredLaunch t{};
        t.a = a;
        t.b = b;
        t.wgs = wgs;
        t.kc = kfull;
        t.chunks = 1;
        t.end = end_of(b);
        if (!fits(t)) break;
        L = t;
        found = true;
      }
    }
    for (int kc = kfull - 64; !found && kc >= 64; kc -= 64) {
      PredLaunch t{};
      t.a = t.b = a;
      t.wgs = 1;
      t.kc = kc;
      t.chunks = (k16 + kc - 1) / kc;
      t.end = end_of(a);
      if (fits(t)) {
        L = t;
        found = true;
      }
    }
    if (!found) return false;
    plan.push_back(L);
    a = L.b + 1;
    if (a != s.n_in) continue;
    for (const int end : {PRED_END_MEANS, PRED_END_TERMS}) {
      if (end == PRED_END_TERMS && a == s.n_units) break;  // no out_0
      PredLaunch T{};
      T.a = a;
      T.b = a - 1;
      T.end = end;
      if (!fits(T)) return false;
      plan.push_back(T);
    }
    if (a < s.n_units) continue;
    PredLaunch F{};
    F.a = a;
    F.b = a - 1;
    F.kc = pred_round(pred_round(s.c2(), 16), 64);
    F.chunks = 1;
    F.end = PRED_END_SCORE;
    bool ok = false;
    for (int wgs = PRED_MAX_WGS; wgs >= 1 && !ok; --wgs) {
      F.wgs = wgs;
      ok = fits(F);
    }
    if (!ok) return false;
    plan.push_back(F);
  }
  return true;
}

// What a launch writes for the next: its bf16 columns per row (the head:
// its local half, to a multiple of 8), or 0.
static int pred_out_cols(const PredLaunch& L, const PredShapes& s) {
  if (L.end == PRED_END_SCORE || L.end >= PRED_END_MEANS) return 0;
  return pred_pitch(L.end == PRED_END_POOL ? s.c2() : s.widths[L.b]);
}

// scratch: two bf16 activation buffers between launches, the pooled sums,
// then the terms (gstat, g, t, u and v)
struct PredScratch {
  long long act, pool, gstat, g, t, uv, total;
};

static PredScratch pred_scratch(const PredShapes& s, const std::vector<PredLaunch>& plan) {
  auto up = [](long long v) { return (v + 255) / 256 * 256; };
  int w = 8;
  for (const PredLaunch& L : plan) w = std::max(w, pred_out_cols(L, s));
  PredScratch r{};
  const long long act = up((long long)s.M() * w * 2);
  r.pool = 2 * act;
  r.gstat = r.pool + up((long long)(s.M() + 63) / 64 * s.pool_segs() * s.cg() * 4);
  r.g = r.gstat + up((long long)s.B * 8);
  r.t = r.g + up((long long)s.B * s.cg() * 4);
  r.uv = r.t + up((long long)s.B * s.n0() * 4);
  r.total = r.uv + up(2LL * s.n0() * 4);
  r.act = act;
  return r;
}

static bool pred_shapes_ok(const PredShapes& s) {
  if (s.B < 1 || s.N < 1 || s.D < 1 || s.n_in < 1 || s.n_in > s.n_units) return false;
  for (int u = 0; u < s.n_units; ++u)
    if (s.widths[u] < 1) return false;
  return true;
}

}  // namespace d2s

using d2s::bf16;

// Bytes of scratch d2s_predictor_forward needs at these shapes, or -1 for
// shapes it does not take.
extern "C" long long d2s_predictor_scratch_bytes(int B, int N, int D, int n_units, int n_in,
                                                 const int* widths) {
  const d2s::PredShapes s{B, N, D, n_units, n_in, widths};
  std::vector<d2s::PredLaunch> plan;
  if (!d2s::pred_shapes_ok(s) || !d2s::pred_plan(s, plan)) return -1;
  return d2s::pred_scratch(s, plan).total;
}

// x: spatial tokens, row n of sample b at x + b * x_bstride + n * P (bf16),
// P = D rounded up to a multiple of 8. scores: (B, N) bf16. scratch:
// d2s_predictor_scratch_bytes bytes. Unit u maps width (u ? widths[u-1] : D)
// -> widths[u] with LayerNorm (ln_w[u], ln_b[u] fp32), weight w[u]
// (widths[u], in) bf16 with rows the in width rounded up to 8 apart, and
// bias b[u] fp32; the local/global split follows unit n_in - 1. The final
// unit has LayerNorm (fln_w, fln_b), a bf16 weight of widths[n_units-1]
// values (readable to the next multiple of 8) and an fp32 scalar bias. act: 1 = GELU, 2 = ReLU. Host arrays: widths and the four pointer
// arrays. Launches on `stream`; returns the launch error (cudaSuccess = 0),
// cudaErrorInvalidValue for shapes or arguments it does not take.
extern "C" int d2s_predictor_forward(const void* x, long long x_bstride, void* scores,
                                     void* scratch,
                                     long long scratch_bytes, int B, int N, int D, int n_units,
                                     int n_in, const int* widths, const void* const* ln_w,
                                     const void* const* ln_b, const void* const* w,
                                     const void* const* b, const void* fln_w, const void* fln_b,
                                     const void* fw, const void* fb, int act, float eps,
                                     void* stream) {
  using namespace d2s;
  const PredShapes s{B, N, D, n_units, n_in, widths};
  std::vector<PredLaunch> plan;
  if (!pred_shapes_ok(s) || !pred_plan(s, plan)) return (int)cudaErrorInvalidValue;
  const PredScratch sc = pred_scratch(s, plan);
  if (scratch_bytes < sc.total || (B > 1 && x_bstride % 8 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      predictor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PRED_SMEM_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(predictor_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PRED_SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  bf16* act_buf[2] = {reinterpret_cast<bf16*>(base), reinterpret_cast<bf16*>(base + sc.act)};
  const int M = s.M(), c = s.c(), c2 = s.c2(), n0 = s.n0();
  // the next launch's input: the strided spatial view, then what the last launch wrote
  const bf16* in = static_cast<const bf16*>(x);
  int in_rows = N, in_pitch = pred_pitch(D), next = 0;
  long long in_bstride = B > 1 ? x_bstride : (long long)N * in_pitch;
  for (const PredLaunch& L : plan) {
    PredArgs p{};
    p.M = M;
    p.ntok = N;
    p.samples = B;
    p.act = act;
    p.eps = eps;
    p.end = L.end;
    if (L.a == n_in) {  // the terms launch and the tail
      p.split = 1;
      p.c2 = c2;
      p.cg = c - c2;
      p.pool = reinterpret_cast<const float*>(base + sc.pool);
      p.pool_segs = s.pool_segs();
      p.gstat = reinterpret_cast<float2*>(base + sc.gstat);
      p.terms_g = reinterpret_cast<float*>(base + sc.g);
      p.terms_t = reinterpret_cast<float*>(base + sc.t);
      p.terms_uv = reinterpret_cast<float*>(base + sc.uv);
    }
    if (L.end == PRED_END_MEANS) {
      predictor_kernel<<<(B + 1) / 2, PRED_TERMS_THREADS, L.smem, st>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      continue;
    }
    if (L.end == PRED_END_TERMS) {
      p.n_units = 1;
      p.u[0].ln_w = static_cast<const float*>(ln_w[n_in]);
      p.u[0].ln_b = static_cast<const float*>(ln_b[n_in]);
      p.u[0].bias = static_cast<const float*>(b[n_in]);
      p.u[0].N = n0;
      p.w_full = static_cast<const bf16*>(w[n_in]);
      p.off_glob = L.off_glob;
      p.off_t = L.off_t;
      p.off_gstat = L.off_gstat;
      const dim3 grid((n0 + PRED_TN - 1) / PRED_TN, (B + PRED_TS - 1) / PRED_TS);
      predictor_kernel<<<grid, PRED_TERMS_THREADS, L.smem, st>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      continue;
    }
    p.n_units = L.b - L.a + 1;
    for (int u = L.a; u <= L.b; ++u) {
      PredUnit& U = p.u[u - L.a];
      U.ln_w = static_cast<const float*>(ln_w[u]);
      U.ln_b = static_cast<const float*>(ln_b[u]);
      U.bias = static_cast<const float*>(b[u]);
      U.N = widths[u];
      U.s_ln = L.s_ln[u - L.a];
      U.s_bias = L.s_bias[u - L.a];
      const int ld = s.in_width(u);  // the weight's row length
      U.K = p.split && u == L.a ? c2 : ld;
      const cuuint64_t dims[2] = {(cuuint64_t)U.K, (cuuint64_t)U.N};
      const cuuint64_t strides[1] = {(cuuint64_t)pred_pitch(ld) * 2};
      const cuuint32_t box[2] = {PRED_BK, PRED_BN};
      if (!encode_map(&p.wmap[u - L.a], w[u], 2, dims, strides, box))
        return (int)cudaErrorInvalidValue;
    }
    if (p.n_units == 0) p.u[0].K = c2;  // the final unit on the concat row: the local half's width
    p.in = in;
    p.in_rows = in_rows;
    p.in_bstride = in_bstride;
    p.in_pitch = in_pitch;
    p.wgs = L.wgs;
    p.kc = L.kc;
    p.chunks = L.chunks;
    const int cols = pred_out_cols(L, s);
    if (L.end == PRED_END_SCORE) {
      p.scores = static_cast<bf16*>(scores);
      p.fln_w = static_cast<const float*>(fln_w);
      p.fln_b = static_cast<const float*>(fln_b);
      p.fw = static_cast<const bf16*>(fw);
      p.fb = static_cast<const float*>(fb);
    } else {
      p.out = act_buf[next];
      p.out_pitch = cols;
      p.out_c2 = L.end == PRED_END_POOL ? c2 : widths[L.b];
      p.pool_out = reinterpret_cast<float*>(base + sc.pool);
      p.pool_segs_out = s.pool_segs();
    }
    p.off_ring = L.off_ring;
    p.off_buf[0] = L.off_buf[0];
    p.off_buf[1] = L.off_buf[1];
    p.buf_blocks[0] = L.buf_blocks[0];
    p.buf_blocks[1] = L.buf_blocks[1];
    p.off_stage = L.off_stage;
    p.off_rows = L.off_rows;
    p.off_glob = L.off_glob;
    p.off_t = L.off_t;
    p.off_uv = L.off_uv;
    p.off_gstat = L.off_gstat;
    p.off_bar = L.off_bar;
    p.s_fln = L.s_fln;
    const int rows = 64 * L.wgs;
    if (L.wgs == 3)
      predictor_kernel_wide<<<(M + rows - 1) / rows, 128 * L.wgs + 32, L.smem, st>>>(p);
    else
      predictor_kernel<<<(M + rows - 1) / rows, 128 * L.wgs + 32, L.smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (cols) {
      in = act_buf[next];
      in_rows = M;
      in_bstride = 0;
      in_pitch = cols;
      next ^= 1;
    }
  }
  return (int)cudaSuccess;
}
