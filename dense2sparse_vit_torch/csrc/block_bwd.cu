// Whole pre-norm transformer block, backward, for sm_90a.
//
// Replaces dense2sparse_vit_tpu/ops/pallas/block.py::
// fused_transformer_block_backward (kernel body `_block_bwd_kernel`) in its
// plain and its policy mode, with its DropPath branch scales. Given the
// block's input x and the cotangent g of its output, it recomputes the
// forward and returns dx and the twelve parameter gradients summed over the
// batch, for
//   x_mid = x + sa[b] * proj(MHA(qkv(LN1 x)))
//   out   = x_mid + sm[b] * fc2(GELU(fc1(LN2 x_mid)))
// with the softmax of block.cu, and in policy mode the (B, N) gradient of
// the keep policy, dPolicy. dx is bf16, the gradients fp32, as the TPU
// kernel returns them. The scales (B,) fp32, each or both null (1, and no
// multiply: the unscaled path is bit for bit unchanged) are constants, as
// in the TPU kernel's custom VJP: the cotangent entering the MLP branch is
// sm[b] g and the one entering the attention branch sa[b] dx_mid, while the
// residual terms of dx_mid and dx stay unscaled (steps 2 and 3 below).
//
// d2s_block_backward runs this sequence on the caller's stream (M = B*N
// token rows; "wgrad" is ln_gemm.cuh's split-K weight-gradient GEMM, "gemm"
// its A @ W with W in the (out, in) layout; the recompute runs the
// forward's own GEMMs on the same tiles, so its qkv has the forward's bits):
//   1. recompute  d2s_block_forward without its fc2 stage (x_mid with sa),
//                 keeping qkv, the attention output O (bf16, and the rest
//                 of it in fp32 for D below), x_mid, h = GELU(y),
//                 the pre-activation
//                 y and each attention row's statistics (plain: log-sum-exp;
//                 policy: max, denominator, ties); LN1(x) and LN2(x_mid)
//                 again, with their row statistics (ln_apply)
//   2. MLP half   with gm = sm g (scale_rows; g itself without sm):
//                 dW2 = gm^T h with db2 = sum gm (the wgrad's column sums);
//                 dy = (gm W2) * GELU'(y) in the gemm's epilogue; dW1 =
//                 dy^T LN2(x_mid) with db1 = sum dy; dLN2 = dy W1 (fp32);
//                 LayerNorm backward (norm.cu's ln_bwd) with dgamma2,
//                 dbeta2, giving dx_mid = LN-bwd + g
//   3. attn half  with da = sa dx_mid (dx_mid itself without sa):
//                 dWproj = da^T O (on da's bf16 copy), dbproj = sum da over
//                 the fp32 da (norm.cu's column_sums); dO = da Wproj
//   4. core       attention_bwd_kernel, one CTA per (sample, head) (N <= 384;
//                 policy mode N <= 352; longer sequences, up to
//                 ATT_SHORT_N = 800, over 2-3 CTAs: the long path below;
//                 past 800 attention_hd_bwd_kernel, as at other widths):
//                 P = exp(scale q.k - lse),
//                 D = rowsum(dO * O) with O the recompute's fp32 output,
//                 normalised by the bf16 probabilities its P.V took (its
//                 bf16 copy plus out_res, launch_attention_strided's):
//                 where V's rows share a large part, as deep in ViT-H, D
//                 is a small difference of large terms, and the bf16 O
//                 alone moved dQ and dK by ~3% (the TPU kernel sums
//                 dP * P in fp32),
//                 dS = P * (dO V^T - D), dV = P^T dO,
//                 dQ = scale dS K, dK = scale dS^T Q in one pass over the
//                 scores on wgmma (the design below); writes packed dqkv
//                 (policy mode below)
//   5. LN1 input  dWqkv = dqkv^T LN1(x) with dbqkv = sum dqkv; dLN1 = dqkv Wqkv
//                 (fp32); LayerNorm backward with dgamma1, dbeta1, giving
//                 dx = LN-bwd + dx_mid
// Every sum over the token rows is split over CTAs into fp32 partials that
// one more kernel adds in a fixed order: no atomics, the same bits each run.
// The scaled cotangents take no scratch of their own: gm (bf16) sits in the
// bf16 dx_mid buffer until step 2's LayerNorm backward overwrites it, and da
// in the bf16 dx_mid buffer (bf16) and the dLN buffer (fp32), free between
// step 2 and step 5; dx_mid's fp32 copy, the residual into dx, is kept.
//
// Two halves of this sequence are also entries of their own, the backward
// of a training block that captures its CLS rows (its qkv and proj products
// run outside, as torch calls):
//   d2s_attention_packed_backward  replaces dense2sparse_vit_tpu/ops/pallas/
//       attention.py::fused_attention_backward_packed: step 4 from packed
//       qkv and the output's cotangent, after recomputing the attention
//       output and its row statistics from qkv (the TPU kernel recomputes P
//       from qkv too), with the CLS rows' cotangent folded into dP's row 0
//       (attention_bwd_kernel below);
//   d2s_mlp_residual_backward  replaces dense2sparse_vit_tpu/ops/pallas/
//       mlp.py::fused_mlp_residual_backward: step 2 for out = x + MLP(LN x),
//       after recomputing LN(x) and fc1 with its GELU from x.
// Both are bound by the same things as the steps they run here: the core by
// its bytes (~0.04 ms at B=128, N=197; attention_bwd_kernel's notes), the
// MLP half by its four products (~150 GFLOP with fc1
// recomputed). Steps 3-5 with the output's cotangent as the branch's are
// d2s_attention_block_backward, the attention half-block's backward
// (dense2sparse_vit_tpu/ops/pallas/attention.py::
// fused_attention_block_backward and its policy mode; see its entry below).
//
// Policy mode differentiates ops/masked_softmax.py::softmax_with_policy,
// p_ij = (e_ij + c) / den_i with e_ij = exp(s_ij - m_i) a_ij, c = eps/N:
//   de_ij = (dP_ij - D_i) / den_i, D_i = rowsum(dO * O) as in plain mode
//           (O includes the smoothing), dS_ij = de_ij e_ij;
//   the max path: m_i is a function of the scores, and since the smoothing
//           breaks shift invariance it carries gmx_i = -sum_j de_ij e_ij,
//           which (sum_j p_ij = 1) is (c / den_i) (dO_i . colsum(V) - N D_i):
//           no extra pass over the scores. It goes to the columns where s_ij
//           reaches m_i, split evenly among ties as JAX's max does. Those
//           columns are found by comparing with the forward's stored max,
//           which only products bit-identical to the forward core's may do,
//           and block.cu's core takes its max on mma.sync: a wgmma product
//           sums in another order, and a max of the backward's own would
//           need every key of a row before the row's first dS. So in policy
//           mode alone S comes from mma.sync m16n8k16, from zero in kk order
//           on the fragments block.cu loads from the same swizzled rows
//           (ab_scores_mma), into the very registers a wgmma m64n32
//           accumulator uses: S stays one product, and dP, dQ, dK, dV stay
//           on wgmma. The forward stores how many columns tie (float4
//           statistics);
//   dPolicy_j = sum_h sum_{i != j} de_ij exp(s_ij - m_i): the unmasked exp,
//           the diagonal left out. Each warp sums its 16 query rows by
//           shuffles into a row of the stage (per key block), the warp rows
//           are added in order by the key block's dV owner, and the
//           (B, H, N) fp32 partials over the heads in order by
//           sum_heads_kernel, so dPolicy is deterministic and takes no
//           atomics. With a null d_policy (the threshold path, whose policy
//           needs no gradient) none of this runs.
//
// What bounds it on the H100: at B=128, N=197, C=384 the eleven projection
// products (three of the forward's recomputed, each backward projection's
// dX and dW) are ~238 GFLOP, ~90% of the work, tensor-core bound. They run
// on ln_gemm.cuh's engine: TMA into a 4-stage mbarrier ring and wgmma
// m64n128k16, the dX products reading the (out, in) weights as an
// MN-major operand, the weight gradients with both operands MN-major and
// their 25,216 rows split across the SMs into fp32 partials (dWproj is
// 384 x 384, nine tiles) added in a fixed order. With the products near
// the tensor cores' rate, what remains is memory-bound: the intermediates
// (qkv, O, x_mid, h, y, dy, dqkv, the LayerNorm outputs, about 0.6 GB at
// that shape) go through device memory, the two LayerNorm backwards (at
// about their bytes bound, norm.cu) and dbproj's column sums read them
// again (the bf16 bias sums ride on the weight gradients' reads). A faster
// design would keep the MLP's hidden activation on chip (fc1, GELU', fc2
// fused per row tile) and fuse the LayerNorm backward's row reductions into
// the dX GEMMs' epilogues.
//
// The attention core's backward (attention_bwd_kernel), what bounds it:
// bytes. At B=128, N=197 it reads qkv, O and dO and writes dqkv, ~0.04 ms
// at 3.35 TB/s, against ~19 GFLOP of products (five of N x N x 64 per
// sample-head), ~0.02 ms at the bf16 peak. A sample-head is small (N <= 384
// rows of 64), so one CTA holds it and every sum stays inside the CTA:
//   - the work: W warpgroups, each owning one 64-row query block (three
//     where N > 256, W = 2, for the registers), its dQ accumulator in
//     registers for the whole pass. The keys go by in blocks of 64. For each, a
//     warpgroup forms S and dP for its rows in two 32-key halves (wgmma
//     m64n32k16, Q and dO K-major from shared memory; 16 accumulator
//     registers each, so four warpgroups fit 128 registers a thread), turns
//     them into P and dS in registers, stores both to a stage in shared
//     memory as bf16, and adds dS K to dQ (wgmma m64n64k16 with dS as the A
//     operand from registers: the accumulator's layout is the A fragment's).
//     Five products, not seven: S and dP once per tile;
//   - dK and dV sum over the queries, that is over the warpgroups: once all
//     have written a key block's stage (an mbarrier), warpgroup j % W forms
//     dV_j = P^T dO and warpgroup (j + 1) % W dK_j = dS^T Q, each one wgmma
//     chain over every query (both operands MN-major from shared memory,
//     the 128-byte swizzle ln_gemm's MN-major operands use) written straight
//     to dqkv. dQ's sum over the key blocks runs in one accumulator in key
//     order, dK's and dV's in one chain in query order: no atomics, the
//     same bits every run, for every plan below;
//   - the long path: past 384 queries (policy mode 352) Q, dO and a stage
//     no longer fit one CTA, so a sample-head's query blocks are split over
//     2 (N <= 768) or 3 CTAs (ab_splits: at most six blocks a CTA, five in
//     policy mode), each running the body above over its own query blocks
//     while its ring streams every key block. Its dQ is then complete; its
//     dK and dV (and dPolicy's partials) are sums over its own queries,
//     stored as fp32 partials (kv_part, (splits, B*N, 2C)) and added in
//     split order by reduce_kv_kernel (dPolicy's by sum_heads_kernel), so
//     the long path too takes no atomics and gives the same bits every run.
//     The partials cost ~2 x B N 2C x 4 bytes each split more than the
//     one-CTA path moves (~0.45 GB written and read at B=64, N=577, C=768);
//     the key blocks are read once by each split. Where a split holds fewer
//     query blocks than the others (the last), its spare warpgroups only
//     keep the stage barriers' counts;
//   - the copies: one thread issues TMA loads (3-D maps over the strided
//     qkv and dO, rows past N arriving as zeros) of the first key block's K
//     and V, every query block's Q and dO (an mbarrier each) and the next
//     key blocks into a ring of `ring` slots, which each key block's dV
//     owner refills once its stage is complete. Meanwhile the threads read
//     the row statistics and form D = rowsum(dO * O) for their rows by
//     16-byte loads (policy mode: colsum(V) and the max path's gmx; with
//     gcls the fold), so the first products start as soon as Q_i, dO_i, K_0
//     and V_0 are in;
//   - the stages: `stages` (2 where it fits) buffers of P and dS, so the
//     warpgroups go on to the next key block while the owners read the
//     last; the host picks ring and stage depths by N (ab_plan), the
//     deepest of those with the most CTAs an SM holds (at N <= 128 two
//     CTAs fit).
// The tensor cores take about 1.7x the products' FLOPs (64-row blocks at
// N = 197 compute 256 x 256 scores); what the kernel spends beyond its bound
// is not measured here but on the card (PERF.md). ptxas serializes none of
// the products (chip_smoke.py's build phase fails if it does); it adds a wgmma fence
// (notice C7519) before the owners' products, whose chain runs over a
// count of query blocks known only at run time, and none before S, dP or
// dQ's.
#include <algorithm>

#include "attention_hd.cuh"

namespace d2s {

// d2s_block_forward, writing out_res beside the attention output too
// (launch_attention_strided's)
int block_forward(const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf,
                  void* hid_buf, void* stats_buf, const void* ln1_w, const void* ln1_b,
                  const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
                  const void* ln2_w, const void* ln2_b, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* preact, void* lse, void* cls,
                  const void* policy, const void* sa, const void* sm, int B, int N, int C, int H,
                  int hidden, float scale, float ln_eps, float eps, void* stream, void* attn_res);
// block.cu's attention core, on qkv rows q_ld apart and samples q_bstride
// apart, heads of width d (at d != 64, lse is (B, H, N) float4 in both modes);
// out_res, where not null, what rounding out to bf16 left out
cudaError_t launch_attention_strided(const bf16* qkv, long long q_bstride, int q_ld, bf16* out,
                                     float* lse, bf16* cls, const float* pol, int B, int N,
                                     int H, int d, float scale, float eps, cudaStream_t stream,
                                     bf16* out_res = nullptr);
// block.cu's stage 1, qkv = LN1(x) Wqkv^T + bqkv
cudaError_t qkv_stage(const bf16* x, bf16* qkv, float2* stats, const float* ln_w,
                      const float* ln_b, const bf16* wqkv, const float* bqkv, int M, int C,
                      float ln_eps, cudaStream_t stream);

// ---- LayerNorm forward, materialised (warp per row) ----------------------

// out = bf16((x - mu) * rstd * gamma + beta) and stats = (mu, rstd), with
// the same arithmetic as ln_stats_kernel and ln_gemm's prologue, so that the
// recomputed LN1(x) and LN2(x_mid) equal what the forward multiplied; the
// statistics over the first k columns (NARROW: k < C, the rest zeros).
template <bool NARROW>
static __global__ void ln_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, bf16* __restrict__ out,
                                       float2* __restrict__ stats, int M, int C, int k,
                                       float eps) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= M) return;
  const int lane = threadIdx.x & 31;
  const uint4* row = reinterpret_cast<const uint4*>(x + (long long)m * C);
  const int nv = C / 8, n = NARROW ? k : C;
  float s = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const uint4 v = row[j];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
  }
  const float mu = warp_sum(s) / n;
  const float q = row_sq_dev<NARROW>(row, nv, lane, mu, n);
  const float rs = rsqrtf(warp_sum(q) / n + eps);
  if (lane == 0) stats[m] = make_float2(mu, rs);
  uint4* dst = reinterpret_cast<uint4*>(out + (long long)m * C);
  for (int j = lane; j < nv; j += 32) {
    uint4 v = row[j];
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int c = j * 8 + t;
      e[t] = __float2bfloat16((__bfloat162float(e[t]) - mu) * rs * gamma[c] + beta[c]);
    }
    dst[j] = v;
  }
}

static cudaError_t launch_ln_apply(const bf16* x, const float* gamma, const float* beta,
                                   bf16* out, float2* stats, int M, int C, float eps,
                                   cudaStream_t stream) {
  constexpr int rows_per_cta = 8;
  const int ctas = (M + rows_per_cta - 1) / rows_per_cta, k = ln_width(C);
  if (k == C)
    ln_apply_kernel<false><<<ctas, 32 * rows_per_cta, 0, stream>>>(x, gamma, beta, out, stats, M,
                                                                    C, k, eps);
  else
    ln_apply_kernel<true><<<ctas, 32 * rows_per_cta, 0, stream>>>(x, gamma, beta, out, stats, M,
                                                                   C, k, eps);
  return cudaGetLastError();
}

// ---- DropPath: a cotangent scaled per sample ----------------------------

// For the M = B * rows rows of C values in in_b (bf16) or else in_f (fp32):
// v = s[m / rows] * in, written to out_b as bf16 and, where not null, to
// out_f as fp32. out_b may be in_b's buffer: each element is read, then
// written, by the same thread.
static __global__ void scale_rows_kernel(const bf16* in_b, const float* __restrict__ in_f,
                                         const float* __restrict__ s, int rows, bf16* out_b,
                                         float* __restrict__ out_f, long long M, int C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= M * C) return;
  const float v = s[e / C / rows] * (in_b ? __bfloat162float(in_b[e]) : in_f[e]);
  out_b[e] = __float2bfloat16(v);
  if (out_f) out_f[e] = v;
}

static cudaError_t launch_scale_rows(const bf16* in_b, const float* in_f, const float* s,
                                     int rows, bf16* out_b, float* out_f, long long M, int C,
                                     cudaStream_t stream) {
  const long long n = M * C;
  scale_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(in_b, in_f, s, rows, out_b,
                                                                     out_f, M, C);
  return cudaGetLastError();
}

// ---- norm.cu: the LayerNorm backward and the fp32 column sums -------------

// dx = rstd (dz - mean dz - z mean(dz z)) + residual (res_b or res_f or
// none) into dx_f and/or dx_b, with dgamma, dbeta; work:
// ln_bwd_workspace_floats(M, C) floats
cudaError_t launch_ln_bwd(const float* dy, const bf16* x, const float2* stats,
                          const float* gamma, const bf16* res_b, const float* res_f,
                          float* dx_f, bf16* dx_b, float* dgamma, float* dbeta, float* work,
                          int M, int C, cudaStream_t stream);
long long ln_bwd_workspace_floats(int M, int C);
bool ln_bwd_takes(int C);  // the widths the LayerNorm backward takes
// out (N) = the column sums of a (M, N) fp32; work:
// column_sums_workspace_floats(M, N, 4) floats
cudaError_t launch_column_sums(const float* a, float* out, float* work, int M, int N,
                               cudaStream_t stream);
long long column_sums_workspace_floats(int M, int N, int elem);

// ---- attention core backward ----------------------------------------------

constexpr int AB_HD = 64;
constexpr int AB_BLK = 64;  // the rows of a query block (a warpgroup's wgmma M) and of a key block
constexpr int AB_TILE = AB_BLK * AB_HD * 2;  // bytes of a 64 x 64 bf16 tile: 128-byte rows
// the most query blocks one CTA holds: Q, dO and one stage of P and dS of
// 384 query rows stay under 227 KB; in policy mode, with its row vectors and
// dPolicy partials, 352 rows alone (six blocks, the last partial) or five
// full blocks a CTA of a split sample-head
constexpr int AB_CTA_QB = 6;
constexpr int AB_POLICY_ONE_CTA_N = 352;
constexpr int AB_POLICY_CTA_QB = 5;
constexpr int AB_SMEM_MAX = (int)HD_SMEM_MAX;  // the most dynamic shared memory a CTA takes

// The CTAs a sample-head's query blocks are split over: 1 while one CTA
// holds them all (N <= 384; policy mode N <= 352), else the fewest that
// hold AB_CTA_QB (policy: AB_POLICY_CTA_QB) blocks each.
inline int ab_splits(int N, bool policy) {
  const int qb = (N + 63) / 64;
  if (policy ? N <= AB_POLICY_ONE_CTA_N : qb <= AB_CTA_QB) return 1;
  const int per = policy ? AB_POLICY_CTA_QB : AB_CTA_QB;
  return (qb + per - 1) / per;
}

// The query blocks of one CTA at N: all of them with one split, else as
// even a share as the splits allow (the last split's may be fewer). The
// host computes it and hands it to the kernel, whose layout takes it.
inline int ab_cta_blocks(int N, bool policy) {
  const int qb = (N + 63) / 64, sp = ab_splits(N, policy);
  return (qb + sp - 1) / sp;
}

// The shared memory of one launch, as byte offsets from the 1024-aligned
// base: Q and dO of the CTA's query blocks (TMA, the 128-byte swizzle), a
// ring of `ring` key blocks' K and V, `stages` stages of P and dS
// ([query][64 keys], the same swizzle: the owner products' MN-major A),
// then the fp32 rows (the CTA's queries; the policy and gcls of every key)
// and the mbarriers. With one split it is the whole sample-head's.
struct AbLayout {
  int qb;        // key blocks: ceil(N / 64)
  int lqb;       // the query blocks of a CTA (ab_cta_blocks; the last split's may be fewer)
  int nq16;      // the query rows the owner products reduce over, at most: rounded up to 16
  int qpw, wgs;  // query blocks a warpgroup (1, or 3 past 4 blocks), warpgroups
  int ring, stages;
  size_t q, dout, kv, st, ds, ls, rd, gc, ps, cv, cvp, dpw, gs, misc, bars, bytes;
};

__host__ __device__ inline AbLayout ab_layout(int N, int lqb, bool split, bool policy, bool fold,
                                              int ring, int stages) {
  AbLayout l;
  l.qb = (N + AB_BLK - 1) / AB_BLK;
  l.lqb = split ? lqb : l.qb;
  l.nq16 = split ? lqb * AB_BLK : (N + 15) / 16 * 16;
  l.qpw = l.lqb <= 4 ? 1 : 3;
  l.wgs = (l.lqb + l.qpw - 1) / l.qpw;
  l.ring = ring;
  l.stages = stages;
  const size_t rows = (size_t)l.lqb * AB_BLK;  // the CTA's query rows
  const size_t keys = (size_t)l.qb * AB_BLK;
  size_t off = 0;
  l.q = off, off += rows * 128;
  l.dout = off, off += rows * 128;
  l.kv = off, off += (size_t)ring * 2 * AB_TILE;
  l.st = off, off += (size_t)stages * 2 * l.nq16 * 128;
  l.ds = off, off += rows * 4;
  l.ls = off, off += rows * 4;  // plain: log-sum-exp; policy: the row max m
  l.rd = l.gc = l.ps = l.cv = l.cvp = l.dpw = l.gs = 0;
  if (policy) {
    l.rd = off, off += rows * 4;                 // 1 / den
    l.gc = off, off += rows * 4;                 // the max path's gmx / ties
    l.ps = off, off += keys * 4;                 // pol_j of every key
    l.cv = off, off += AB_HD * 4;                // colsum(V)
    l.cvp = off, off += 8 * AB_HD * 4;           // its partial sums, a row per 64 threads
    l.dpw = off, off += (size_t)stages * 4 * l.wgs * AB_BLK * 4;  // dPolicy, a row per warp
  }
  if (fold) l.gs = off, off += keys * 4;         // gcls: the CLS row's cotangent
  l.misc = off, off += 16 + 2 * 16 * 4;          // gcls: sum_j gcls_j; the warps' fold sums
  l.bars = off, off += (size_t)(l.lqb + ring + 2 * stages) * 8;
  l.bytes = off + 1024;  // and the base's alignment
  return l;
}

// element offset of chunk c of row r in a [row][64] bf16 tile in the 128-byte
// swizzle, as TMA writes it: the 16-byte chunk c of row r lies at c ^ (r & 7)
__device__ __forceinline__ int ab_swz(int r, int c) { return r * AB_HD + ((c ^ (r & 7)) << 3); }

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A from registers (the
// mma.sync a fragment of warp w's rows 16w..16w+15), B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// s (this warp's 16 query rows of the Q tile x the 32 keys at Kh, the layout
// of the m64n32 accumulator) = Q K^T on mma.sync from zero in kk order, on
// the fragments block.cu's forward core loads from the same swizzled rows:
// bit for bit the forward's scores, which the policy mode's tie test needs.
// HOLD_Q: the Q fragments loaded once for the 32 keys (16 registers), else
// again for each 8 keys (where three query blocks' dQ fill the registers)
template <bool HOLD_Q>
__device__ __forceinline__ void ab_scores_mma(float (&s)[16], const unsigned char* qt,
                                              const unsigned char* kh, int warp, int lane) {
  const bf16* Q = reinterpret_cast<const bf16*>(qt);
  const bf16* K = reinterpret_cast<const bf16*>(kh);
  uint32_t qa[HOLD_Q ? AB_HD / 16 : 1][4];
  auto load_q = [&](uint32_t (&a)[4], int kk) {
    ldmatrix_x4(a, Q + ab_swz(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              2 * kk + (lane >> 4)));
  };
  if (HOLD_Q) {
#pragma unroll
    for (int kk = 0; kk < AB_HD / 16; ++kk) load_q(qa[HOLD_Q ? kk : 0], kk);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint32_t kb[2][4];
    ldmatrix_x4(kb[0], K + ab_swz(8 * jj + (lane & 7), lane >> 3));
    ldmatrix_x4(kb[1], K + ab_swz(8 * jj + (lane & 7), 4 + (lane >> 3)));
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < AB_HD / 16; ++kk) {
      if (!HOLD_Q) load_q(qa[0], kk);
      mma_16816(c, qa[HOLD_Q ? kk : 0], kb[kk >> 1][2 * (kk & 1)], kb[kk >> 1][2 * (kk & 1) + 1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * jj + e] = c[e];
  }
}

// rows r and r + 8 of a 64 x 64 accumulator (this thread's part) into the
// (rows, ld) bf16 matrix `dst`, rows past n left alone
__device__ __forceinline__ void ab_store(bf16* dst, long long ld, int r, int n,
                                         const float (&acc)[32], int t) {
#pragma unroll
  for (int nd = 0; nd < AB_HD / 8; ++nd) {
    if (r < n)
      *reinterpret_cast<uint32_t*>(dst + r * ld + nd * 8 + 2 * t) =
          pack_bf16(acc[4 * nd], acc[4 * nd + 1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * ld + nd * 8 + 2 * t) =
          pack_bf16(acc[4 * nd + 2], acc[4 * nd + 3]);
  }
}

// the same into the (rows, ld) fp32 matrix `dst`
__device__ __forceinline__ void ab_store_f32(float* dst, long long ld, int r, int n,
                                             const float (&acc)[32], int t) {
#pragma unroll
  for (int nd = 0; nd < AB_HD / 8; ++nd) {
    if (r < n)
      *reinterpret_cast<float2*>(dst + r * ld + nd * 8 + 2 * t) =
          make_float2(acc[4 * nd], acc[4 * nd + 1]);
    if (r + 8 < n)
      *reinterpret_cast<float2*>(dst + (r + 8) * ld + nd * 8 + 2 * t) =
          make_float2(acc[4 * nd + 2], acc[4 * nd + 3]);
  }
}

// CTA = one (sample, head) (blockIdx.x) and one split of its query blocks
// (blockIdx.y: blocks lqb y .. lqb y + lqb - 1), ab_layout(...).wgs
// warpgroups of 128 threads. qkv (B, N, 3C) with token rows q_ld elements
// apart and samples q_bstride apart (tm_qkv: its TMA map (3C, N, B)), o and
// dout (B*N, C) (tm_dout: dout's (C, N, B)), lse (B, H, N) (policy mode:
// float4 (m, den, ties, 0)), dqkv (B*N, 3C) packed; policy mode: pol
// (B, N), dpol_part (splits, B, H, N) or null. gcls: (B, H, N) fp32, the
// cotangent of the CLS (query 0) rows of the probabilities, or null.
// kv_part: with more than one split, (splits, B*N, 2C) fp32, each split's
// dK (columns h 64 ..) and dV (C + h 64 ..) over its own queries, which
// reduce_kv_kernel adds in split order into dqkv; null with one split,
// whose owners write dK and dV to dqkv themselves. dQ is each split's own.
// SPLIT: the long path's instantiation; without it (one CTA a sample-head)
// every split quantity is a constant and the code is the one-CTA kernel's.
//
// The CLS rows are the probabilities' row 0, so their cotangent adds to dP's
// row 0: dP_0j += gcls_j, and with it D_0 = sum_j P_0j dP_0j gains
// sum_j gcls_j P_0j, which warp 0 computes from row 0's scores recomputed in
// fp32 before the loop. Policy mode's de = (dP - D) / den then carries the
// fold into dS, dPolicy and, through sum_j dP_0j = dO_0 . colsum(V) +
// sum_j gcls_j, the max path.
template <bool POLICY, int QPW, bool SPLIT>
static __global__ void __launch_bounds__(QPW == 1 ? 4 * 128 : 2 * 128, 1)
    attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                         const __grid_constant__ CUtensorMap tm_dout,
                         const bf16* __restrict__ qkv, long long q_bstride, int q_ld,
                         const bf16* __restrict__ o, const bf16* __restrict__ o_res,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ pol,
                         const float* __restrict__ gcls, bf16* __restrict__ dqkv,
                         float* __restrict__ dpol_part, float* __restrict__ kv_part, int N,
                         int lqb, int H, float scale, float eps, int ring, int stages) {
  extern __shared__ unsigned char ab_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ab_smem) + 1023) & ~uintptr_t(1023));
  const AbLayout L = ab_layout(N, lqb, SPLIT, POLICY, gcls != nullptr, ring, stages);
  unsigned char* Qs = base + L.q;
  unsigned char* dOs = base + L.dout;
  unsigned char* KVs = base + L.kv;
  unsigned char* Sts = base + L.st;
  auto fl = [&](size_t at) { return reinterpret_cast<float*>(base + at); };
  float* Ds = fl(L.ds);
  float* Ls = fl(L.ls);
  float* Rd = fl(L.rd);
  float* Gc = fl(L.gc);
  float* Ps = fl(L.ps);
  float* Cv = fl(L.cv);
  float* Cvp = fl(L.cvp);
  float* Dpw = fl(L.dpw);
  float* Gs = fl(L.gs);
  float* gsum = fl(L.misc);
  float* Fold = gsum + 4;  // gcls: per warp, its part of the fold and of sum_j gcls_j
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L.bars);  // Q and dO of a query block in
  uint64_t* kvbar = qbar + L.lqb;      // a ring slot's K and V in
  uint64_t* fullb = kvbar + ring;      // a stage's P, dS (and dPolicy rows) written
  uint64_t* freeb = fullb + stages;    // a stage read by its owners

  const int QB = L.qb, W = L.wgs;
  const int rows = L.lqb * AB_BLK;  // the CTA's query rows in shared memory
  const int q0b = SPLIT ? blockIdx.y * L.lqb : 0;  // its first query block
  const int q0 = q0b * AB_BLK;                     // and first query row
  const int QBl = SPLIT ? min(L.lqb, QB - q0b) : QB;  // its query blocks
  // the rows its owners reduce over
  const int nq16 = SPLIT ? min(L.nq16, (N - q0 + 15) / 16 * 16) : L.nq16;
  const int C = H * AB_HD;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ct = tid & 127;
  const int warp = ct >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sbytes = nq16 * 128;  // one half of a stage: P or dS
  const long long ld3 = 3LL * C;
  const float cc = POLICY ? eps / N : 0.f;

  if (tid == 0) {
    for (int i = 0; i < L.lqb; ++i) mbar_init(&qbar[i], 1);
    for (int r = 0; r < ring; ++r) mbar_init(&kvbar[r], 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&fullb[s], W * 128);
      mbar_init(&freeb[s], W > 1 ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // key block j's K and V into its ring slot; rows past N arrive as zeros
  auto load_kv = [&](int j) {
    uint64_t* bar = &kvbar[j % ring];
    unsigned char* dst = KVs + (j % ring) * 2 * AB_TILE;
    mbar_expect_tx(bar, 2 * AB_TILE);
    tma_load_3d(dst, &tm_qkv, bar, C + h * AB_HD, j * AB_BLK, b);
    tma_load_3d(dst + AB_TILE, &tm_qkv, bar, 2 * C + h * AB_HD, j * AB_BLK, b);
  };
  if (tid == 0) {
    load_kv(0);
    for (int i = 0; i < QBl; ++i) {
      mbar_expect_tx(&qbar[i], 2 * AB_TILE);
      tma_load_3d(Qs + i * AB_TILE, &tm_qkv, &qbar[i], h * AB_HD, q0 + i * AB_BLK, b);
      tma_load_3d(dOs + i * AB_TILE, &tm_dout, &qbar[i], h * AB_HD, q0 + i * AB_BLK, b);
    }
    for (int j = 1; j < ring; ++j) load_kv(j);
  }

  // while the copies run: the CTA's rows' statistics, D, and in policy
  // mode colsum(V); rows past N get zero probabilities below. Ps and Gs
  // hold every key's.
  const float4* st4 = reinterpret_cast<const float4*>(lse);
  for (int r = tid; r < rows; r += blockDim.x) {
    const bool in = q0 + r < N;
    if (POLICY) {
      const float4 st = in ? st4[(long long)bh * N + q0 + r] : make_float4(0.f, 1.f, 1.f, 0.f);
      Ls[r] = st.x;
      Rd[r] = in ? 1.f / st.y : 0.f;
      Gc[r] = st.z;  // the ties, until gmx replaces them below
    } else {
      Ls[r] = in ? lse[(long long)bh * N + q0 + r] : 0.f;
    }
    if (!SPLIT) {  // one CTA: its rows are every key
      if (POLICY) Ps[r] = in ? pol[(long long)b * N + r] : 0.f;
      if (gcls) Gs[r] = in ? gcls[(long long)bh * N + r] : 0.f;
    }
  }
  for (int k = tid; SPLIT && k < QB * AB_BLK; k += blockDim.x) {
    if (POLICY) Ps[k] = k < N ? pol[(long long)b * N + k] : 0.f;
    if (gcls) Gs[k] = k < N ? gcls[(long long)bh * N + k] : 0.f;
  }
  // D = rowsum(dO * O), the softmax backward's sum_j P_ij dP_ij, for the
  // warpgroup's query rows: two threads a row, 16-byte loads. O is the
  // forward's fp32 output normalised by the bf16 probabilities its P.V took:
  // its bf16 copy plus o_res (where V's rows share a large part, D is a
  // small difference of large terms, and O's bf16 rounding alone would move
  // dQ and dK by percents)
  for (int qq = 0; qq < QPW; ++qq) {
    const int qb = wg * QPW + qq;
    if (qb >= QBl) break;
    const int r = qb * AB_BLK + (ct >> 1);
    float acc = 0.f;
    if (q0 + r < N) {
      const long long at = ((long long)b * N + q0 + r) * C + h * AB_HD + (ct & 1) * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
        const uint4 rv = o_res ? *reinterpret_cast<const uint4*>(o_res + at + c)
                               : make_uint4(0u, 0u, 0u, 0u);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
        const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc += (__bfloat162float(oe[k]) + __bfloat162float(re[k])) * __bfloat162float(de[k]);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((ct & 1) == 0) {
      Ds[r] = acc;
    }
  }
  if (POLICY) {  // colsum(V), 64 columns x blockDim / 64 row groups, added in order below
    const int groups = blockDim.x >> 6;
    const bf16* vcol = qkv + (long long)b * q_bstride + 2 * C + h * AB_HD + (tid & 63);
    float acc = 0.f;
    for (int r = tid >> 6; r < N; r += groups) acc += __bfloat162float(vcol[(long long)r * q_ld]);
    Cvp[tid] = acc;
  }
  __syncthreads();
  if (POLICY && tid < AB_HD) {
    float acc = 0.f;
    for (int grp = 0; grp < (int)(blockDim.x >> 6); ++grp) acc += Cvp[grp * AB_HD + tid];
    Cv[tid] = acc;
  }
  if (gcls && q0 == 0) {
    // D_0 += sum_j gcls_j P_0j, P_0j from row 0's scores in fp32: a key a
    // thread, the warps' sums added in order (the first split's CTA)
    const bf16* qrow0 = qkv + (long long)b * q_bstride + h * AB_HD;
    float s0 = 0.f, gs = 0.f;
    for (int j = tid; j < N; j += blockDim.x) {
      const uint4* kj = reinterpret_cast<const uint4*>(qrow0 + (long long)j * q_ld + C);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < AB_HD / 8; ++c) {
        const uint4 qv = reinterpret_cast<const uint4*>(qrow0)[c];
        const uint4 kv = kj[c];
        const bf16* qe = reinterpret_cast<const bf16*>(&qv);
        const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
        for (int k = 0; k < 8; ++k) dot += __bfloat162float(qe[k]) * __bfloat162float(ke[k]);
      }
      float p;
      if (POLICY) {
        const float pk = Ps[j];
        p = (__expf(dot * scale - Ls[0]) * (j == 0 ? pk + (1.f - pk) : pk) + cc) * Rd[0];
      } else {
        p = __expf(dot * scale - Ls[0]);
      }
      s0 += Gs[j] * p;
      gs += Gs[j];
    }
    s0 = warp_sum(s0);
    gs = warp_sum(gs);
    if (lane == 0) {
      Fold[tid >> 5] = s0;
      Fold[16 + (tid >> 5)] = gs;
    }
    __syncthreads();
    if (tid == 0) {
      s0 = gs = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        s0 += Fold[w];
        gs += Fold[16 + w];
      }
      Ds[0] += s0;
      *gsum = gs;
    }
  }
  if (POLICY || (gcls && q0 == 0)) __syncthreads();
  if (POLICY) {
    // the max path: gmx_i = (c / den_i) (dO_i . colsum(V) - N D_i), split
    // over the row's ties; the warpgroup's rows, two threads a row
    for (int qq = 0; qq < QPW; ++qq) {
      const int qb = wg * QPW + qq;
      if (qb >= QBl) break;
      const int r = qb * AB_BLK + (ct >> 1);
      float dv = 0.f;
      if (q0 + r < N) {
        const bf16* drow = dout + ((long long)b * N + q0 + r) * C + h * AB_HD + (ct & 1) * 32;
        const float* cv = Cv + (ct & 1) * 32;
#pragma unroll
        for (int c = 0; c < 32; c += 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(drow + c);
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int k = 0; k < 8; ++k) dv += __bfloat162float(e[k]) * cv[c + k];
        }
      }
      dv += __shfl_xor_sync(0xffffffffu, dv, 1);
      if ((ct & 1) == 0 && q0 + r < N) {
        if (gcls && q0 + r == 0) dv += *gsum;  // sum_j dP_0j
        Gc[r] = cc * Rd[r] * (dv - N * Ds[r]) / Gc[r];
      }
    }
    __syncthreads();
  }

  // One pass over the key blocks. Step j: each warpgroup, for its query
  // blocks and the block's two 32-key halves, forms S = Q K^T (plain: wgmma;
  // policy: mma.sync, ab_scores_mma) and dP = dO V^T (wgmma m64n32k16),
  // then P and dS = P (dP - D) scale in registers, writes both to the
  // stage as bf16 and adds dS K into its dQ accumulator (wgmma, dS the A
  // operand from registers). Once every warpgroup has written the stage,
  // warpgroup j % W forms dV_j = P^T dO and warpgroup (j + 1) % W dK_j =
  // dS^T Q over all queries (wgmma, both operands MN-major from shared
  // memory), and the first refills the ring with key block j + ring.
  float dq[QPW][32];
#pragma unroll
  for (int qq = 0; qq < QPW; ++qq)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[qq][i] = 0.f;
  uint32_t da[2][4];  // dS as the A fragments of the dQ product, 16 keys each
#pragma unroll
  for (int i = 0; i < 8; ++i) da[i >> 2][i & 3] = 0u;

  for (int j = 0; j < QB; ++j) {
    const int slot = j % ring;
    const int st = j % stages;
    const int use = j / stages;
    mbar_wait(&kvbar[slot], (j / ring) & 1);
    __syncwarp();
    const unsigned char* Kt = KVs + slot * 2 * AB_TILE;
    const unsigned char* Vt = Kt + AB_TILE;
    unsigned char* Pt = Sts + st * 2 * sbytes;
    unsigned char* dSt = Pt + sbytes;
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq) {
      const int qb = wg * QPW + qq;
      if (qb >= QBl) break;
      if (j == 0) {
        mbar_wait(&qbar[qb], 0);
        __syncwarp();
      }
      const unsigned char* Qt = Qs + qb * AB_TILE;
      const unsigned char* dOt = dOs + qb * AB_TILE;
      const int ra = qb * AB_BLK + warp * 16 + g;  // this thread's query rows ra, rb (the CTA's)
      const int rb = ra + 8;
#pragma unroll 1  // (unrolled, the two halves' live ranges overlap and spill)
      for (int half = 0; half < 2; ++half) {
        const unsigned char* Kh = Kt + half * 32 * 128;  // keys 32 half .. 32 half + 31
        const unsigned char* Vh = Vt + half * 32 * 128;
        float s[16], dp[16];
        wgmma_fence();
        if (!POLICY) {
#pragma unroll
          for (int kk = 0; kk < AB_HD / 16; ++kk)
            wgmma_m64n32k16_ss<0, 0>(s, wgmma_desc(Qt + kk * 32, 16, 1024),
                                     wgmma_desc(Kh + kk * 32, 16, 1024), kk);
        }
#pragma unroll
        for (int kk = 0; kk < AB_HD / 16; ++kk)
          wgmma_m64n32k16_ss<0, 0>(dp, wgmma_desc(dOt + kk * 32, 16, 1024),
                                   wgmma_desc(Vh + kk * 32, 16, 1024), kk);
        wgmma_commit();
        if (POLICY) {
          wgmma_wait<1>();  // the previous half's dQ product: its A registers are free
          fence_acc(da[0]);
          fence_acc(da[1]);
          ab_scores_mma<QPW == 1>(s, Qt, Kh, warp, lane);
        }
        wgmma_wait<0>();  // and the previous half's dQ product
        fence_acc(s);
        fence_acc(dp);
        fence_acc(da[0]);
        fence_acc(da[1]);

        if (use > 0 && qq == 0 && half == 0) {
          mbar_wait(&freeb[st], (use - 1) & 1);  // the stage's last owners are done
          __syncwarp();
        }
        // the rows' statistics, read here (not held across the products)
        const float la = Ls[ra], lb = Ls[rb], Da = Ds[ra], Db = Ds[rb];
        float rda = 0.f, rdb = 0.f, gca = 0.f, gcb = 0.f;
        if (POLICY) {
          rda = Rd[ra];
          rdb = Rd[rb];
          gca = Gc[ra];
          gcb = Gc[rb];
        }
        // P and dS = P (dP - D) scale of this thread's 4 x 2 x 2 scores, into
        // the stage as bf16 ([query][key], the swizzle; rows past nq16 are
        // not in it), and in policy mode dPolicy over the warp's 16 rows
        // into a row of the stage's partials per (warpgroup, warp), its
        // query blocks added in order
        float* dst = Dpw + ((st * W + wg) * 4 + warp) * AB_BLK + 32 * half + 2 * t;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float dpa[2] = {0.f, 0.f};  // dPolicy of keys k0, k0 + 1 over the two rows
          const int k0 = j * AB_BLK + 32 * half + 8 * jj + 2 * t;
          float2 pk = make_float2(0.f, 0.f);
          if (POLICY) pk = *reinterpret_cast<const float2*>(Ps + k0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            const bool hi = e >> 1;
            const int key = k0 + (e & 1);
            const int q = q0 + (hi ? rb : ra);  // the query's row in the sequence
            const bool valid = key < N && q < N;
            float dpv = dp[i];
            if (gcls && q == 0) dpv += Gs[key];
            if (POLICY) {
              const float m = hi ? lb : la;
              const float v = s[i] * scale;
              const float xe = valid ? __expf(v - m) : 0.f;
              const float a = (e & 1) ? pk.y : pk.x;
              const float ew = xe * (key == q ? a + (1.f - a) : a);
              const float de = (dpv - (hi ? Db : Da)) * (hi ? rdb : rda);
              if (dpol_part) {
                if (key != q) dpa[e & 1] += de * xe;  // dPolicy: the diagonal left out
              }
              float ds = de * ew;
              if (valid && v == m) ds += hi ? gcb : gca;  // the max path, at a tie
              s[i] = valid ? (ew + cc) * (hi ? rdb : rda) : 0.f;
              dp[i] = ds * scale;
            } else {
              const float p = valid ? __expf(s[i] * scale - (hi ? lb : la)) : 0.f;
              s[i] = p;
              dp[i] = p * (dpv - (hi ? Db : Da)) * scale;
            }
          }
          const int chunk = 4 * half + jj;
          if (ra < nq16) {
            const int at = ra * 128 + ((chunk ^ (ra & 7)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(Pt + at) = pack_bf16(s[4 * jj], s[4 * jj + 1]);
            *reinterpret_cast<uint32_t*>(dSt + at) = pack_bf16(dp[4 * jj], dp[4 * jj + 1]);
          }
          if (rb < nq16) {
            const int at = rb * 128 + ((chunk ^ (rb & 7)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(Pt + at) = pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
            *reinterpret_cast<uint32_t*>(dSt + at) = pack_bf16(dp[4 * jj + 2], dp[4 * jj + 3]);
          }
          if (POLICY && dpol_part) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = dpa[e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (g == 0) dst[8 * jj + e] = qq == 0 ? v : dst[8 * jj + e] + v;
            }
          }
        }
        // dQ += dS K over the half's keys, 16 at a time
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          da[c][0] = pack_bf16(dp[8 * c], dp[8 * c + 1]);
          da[c][1] = pack_bf16(dp[8 * c + 2], dp[8 * c + 3]);
          da[c][2] = pack_bf16(dp[8 * c + 4], dp[8 * c + 5]);
          da[c][3] = pack_bf16(dp[8 * c + 6], dp[8 * c + 7]);
        }
        fence_acc(da[0]);
        fence_acc(da[1]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wgmma_m64n64k16_rs<1>(dq[qq], da[c], wgmma_desc(Kh + c * 16 * 128, 0, 1024));
        wgmma_commit();
      }
    }
    wgmma_wait<0>();  // every product that reads K_j and V_j
    fence_acc(da[0]);
    fence_acc(da[1]);
#pragma unroll
    for (int qq = 0; qq < QPW; ++qq) fence_acc(dq[qq]);
    // a warpgroup with no query block here (the last split's CTA) writes
    // nothing, but arrives only once the stage's last owners are done, as
    // the others do before they write it
    if (SPLIT && use > 0 && wg * QPW >= QBl) {
      mbar_wait(&freeb[st], (use - 1) & 1);
      __syncwarp();
    }
    // the stage's generic-proxy writes, before the owners' wgmma reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&fullb[st]);

    const int ov = j % W, ok = (j + 1) % W;  // the owners of dV_j and dK_j
    if (wg == ov || wg == ok) {
      mbar_wait(&fullb[st], use & 1);
      if (wg == ov && ct == 0 && j + ring < QB) load_kv(j + ring);  // the slot is read
      __syncwarp();
      const int nk = nq16 / 16;
      auto owner = [&](const unsigned char* A, const unsigned char* Bm, int col) {
        float acc[32];
        if (SPLIT) {
          // the chain's first product starts the sum (scale-d 0) outside
          // the loop: a chain ptxas cannot prove non-empty, over an
          // accumulator zeroed by ordinary instructions, it serializes
          // (C7515), as it does where nk comes from the split
          wgmma_fence();
          wgmma_m64n64k16_ss<1, 1>(acc, wgmma_desc(A, 0, 1024), wgmma_desc(Bm, 0, 1024), 0);
          for (int kq = 1; kq < nk; ++kq)
            wgmma_m64n64k16_ss<1, 1>(acc, wgmma_desc(A + kq * 2048, 0, 1024),
                                     wgmma_desc(Bm + kq * 2048, 0, 1024), 1);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] = 0.f;
          wgmma_fence();
          for (int kq = 0; kq < nk; ++kq)
            wgmma_m64n64k16_ss<1, 1>(acc, wgmma_desc(A + kq * 2048, 0, 1024),
                                     wgmma_desc(Bm + kq * 2048, 0, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        if (SPLIT)  // this split's (B*N, 2C) part, from column col - C
          ab_store_f32(kv_part + ((long long)blockIdx.y * (gridDim.x / H) + b) * N * (2 * C) +
                           col - C + h * AB_HD,
                       2 * C, j * AB_BLK + warp * 16 + g, N, acc, t);
        else
          ab_store(dqkv + (long long)b * N * ld3 + col + h * AB_HD, ld3,
                   j * AB_BLK + warp * 16 + g, N, acc, t);
      };
      if (wg == ov) owner(Pt, dOs, 2 * C);  // dV_j = P^T dO
      if (wg == ok) owner(dSt, Qs, C);      // dK_j = dS^T Q
      if (POLICY && dpol_part && wg == ov && ct < AB_BLK && j * AB_BLK + ct < N) {
        // the rows of the warpgroups that have query blocks here
        const float* src = Dpw + (size_t)st * W * 4 * AB_BLK + ct;
        const int wr = SPLIT ? 4 * min(W, (QBl + QPW - 1) / QPW) : 4 * W;
        float acc = 0.f;
        for (int r = 0; r < wr; ++r) acc += src[r * AB_BLK];
        dpol_part[((long long)(SPLIT ? blockIdx.y : 0) * gridDim.x + bh) * N + j * AB_BLK + ct] =
            acc;
      }
      mbar_arrive(&freeb[st]);
    }
  }

#pragma unroll
  for (int qq = 0; qq < QPW; ++qq) {
    const int qb = wg * QPW + qq;
    if (qb < QBl)
      ab_store(dqkv + (long long)b * N * ld3 + h * AB_HD, ld3, q0 + qb * AB_BLK + warp * 16 + g,
               N, dq[qq], t);
  }
}

// dpol[b][j] = sum over h, in order, of part[b][h][j]
// dpol[b][j] = sum over h, and within a head over the splits, in order, of
// part[split][b][h][j]
static __global__ void sum_heads_kernel(const float* __restrict__ part, float* __restrict__ out,
                                        int B, int H, int N, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, j = i % N;
  float acc = 0.f;
  for (int h = 0; h < H; ++h)
    for (int sp = 0; sp < splits; ++sp) acc += part[(((long long)sp * B + b) * H + h) * N + j];
  out[i] = acc;
}

// dK and dV of a split sample-head: dqkv[m][C + c] = bf16 of the sum over
// the splits, in order, of part[split][m][c], for the M rows and 2C columns;
// four columns a thread
static __global__ void reduce_kv_kernel(const float* __restrict__ part, bf16* __restrict__ dqkv,
                                        long long M, int C, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c4 = C / 2;  // 2C columns, four at a time
  if (i >= M * c4) return;
  const long long m = i / c4;
  const int c = (int)(i % c4) * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 v =
        *reinterpret_cast<const float4*>(part + ((long long)sp * M + m) * (2 * C) + c);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  uint2 packed;
  packed.x = pack_bf16(acc.x, acc.y);
  packed.y = pack_bf16(acc.z, acc.w);
  *reinterpret_cast<uint2*>(dqkv + m * 3 * C + C + c) = packed;
}

// launches of attention_bwd_kernel, where it is launched (the backward
// entries' own included), and those of them on the long path (a
// sample-head split over CTAs), read by d2s_attention_bwd_launches
static long long attention_bwd_launches = 0;
static long long attention_bwd_long_launches = 0;

static decltype(&attention_bwd_kernel<false, 1, false>) ab_kernel(bool policy, int qpw,
                                                                   bool split) {
  if (split) {
    if (policy)
      return qpw == 1 ? attention_bwd_kernel<true, 1, true> : attention_bwd_kernel<true, 3, true>;
    return qpw == 1 ? attention_bwd_kernel<false, 1, true> : attention_bwd_kernel<false, 3, true>;
  }
  if (policy)
    return qpw == 1 ? attention_bwd_kernel<true, 1, false> : attention_bwd_kernel<true, 3, false>;
  return qpw == 1 ? attention_bwd_kernel<false, 1, false> : attention_bwd_kernel<false, 3, false>;
}

// The layout of a launch at N: of the ring and stage depths whose layout
// fits, the one with the most CTAs an SM holds, then the deepest. The depths
// change when copies and products overlap, not what is summed: every plan
// gives the same bits. The plan is cached per (N, mode, fold); the kernel's
// shared-memory limit, an attribute of the current device, is set on every
// call, so a second card in the process launches with it too.
static cudaError_t ab_plan(int N, bool policy, bool fold, AbLayout* out) {
  // 4 ring + stages, 0 while unknown; N up to ATT_SHORT_N (att_on_hd: longer
  // d = 64 heads take attention_hd_bwd_kernel)
  static int cache[2][2][ATT_SHORT_N + 1];
  int& plan = cache[policy][fold][N];
  const int lqb = ab_cta_blocks(N, policy);
  const bool split = ab_splits(N, policy) > 1;
  const AbLayout one = ab_layout(N, lqb, split, policy, fold, 1, 1);
  auto kernel = ab_kernel(policy, one.qpw, split);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AB_SMEM_MAX);
  if (err != cudaSuccess) return err;
  if (plan == 0) {
    const int qb = one.qb;
    int best = 0, choice = 0;
    for (int stages = 2; stages >= 1; --stages)
      for (int ring = std::min(3, qb); ring >= 1; --ring) {
        const AbLayout l = ab_layout(N, lqb, split, policy, fold, ring, stages);
        if (l.bytes > (size_t)AB_SMEM_MAX) continue;
        int fit = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, l.wgs * 128, l.bytes);
        if (err != cudaSuccess) return err;
        if (fit > best) {
          best = fit;
          choice = 4 * ring + stages;
        }
      }
    if (choice == 0) return cudaErrorInvalidValue;
    plan = choice;
  }
  *out = ab_layout(N, lqb, split, policy, fold, plan / 4, plan % 4);
  return cudaSuccess;
}

// The splits of dPolicy's partials at head width d: attention_bwd_kernel's
// (ab_splits) at d = 64 up to ATT_SHORT_N, one on the attention_hd path
// (att_on_hd: attention_hd_bwd_kernel sums every query of a key in one CTA).
static int dpol_splits(int N, int d) { return att_on_hd(N, d) ? 1 : ab_splits(N, true); }

// The fp32 floats of the split partials at these shapes (head width d): on
// attention_bwd_kernel (d = 64 up to ATT_SHORT_N) dK and dV (splits, B*N,
// 2C) where a sample-head is split, else none; on the attention_hd path
// dQ's sum over the passes (B*N, C) past one pass (two key blocks, one
// past HD_NARROW: attention_hd_bwd_kernel), each split's own (splits, B*N,
// C) where its passes are split; dPolicy's (splits, B, H, N) in policy mode.
static long long kv_part_floats(int B, int N, int H, int d, bool policy) {
  if (att_on_hd(N, d))
    return hd_bwd_passes(N, hd_bwd_kb(hd_pad(d))) > 1 ? (long long)hd_bwd_splits(N) * B * N * H * d
                                                      : 0;
  const int sp = ab_splits(N, policy);
  return sp > 1 ? (long long)sp * B * N * 2 * H * AB_HD : 0;
}
static long long dpol_part_floats(int B, int N, int H, int d, bool policy) {
  return policy ? (long long)dpol_splits(N, d) * B * H * N : 0;
}

// dpol_part: dpol_part_floats(...) floats, or null (no dPolicy); kv_part:
// kv_part_floats(...) floats (null where that is 0). A split sample-head's
// dK and dV are added by reduce_kv_kernel right after.
// At head width d != 64, and at d = 64 past ATT_SHORT_N tokens (att_on_hd),
// the backward is attention_hd_bwd_kernel's (launch_attention_hd_bwd: lse
// the forward's float4 statistics; kv_part dQ's fp32 sum over the passes),
// up to hd_max_tokens.
static cudaError_t launch_attention_bwd(const bf16* qkv, long long q_bstride, int q_ld,
                                        const bf16* o, const bf16* o_res, const bf16* dout,
                                        float* lse, const float* pol, const float* gcls,
                                        bf16* dqkv, float* dpol_part, float* kv_part, int B, int N,
                                        int H, int d, float scale, float eps,
                                        cudaStream_t stream) {
  const bool policy = pol != nullptr;
  if (B <= 0 || !att_takes(N, d, policy, true) || q_ld < 3 * H * d || q_ld % 8 ||
      q_bstride % 8 || (kv_part == nullptr) != (kv_part_floats(B, N, H, d, policy) == 0))
    return cudaErrorInvalidValue;
  if (att_on_hd(N, d)) {
    return launch_attention_hd_bwd(qkv, q_bstride, q_ld, d, o, o_res, dout,
                                   reinterpret_cast<float4*>(lse), pol, gcls, dqkv, dpol_part,
                                   kv_part, B, N, H, scale, eps, stream);
  }
  AbLayout l;
  cudaError_t err = ab_plan(N, policy, gcls != nullptr, &l);
  if (err != cudaSuccess) return err;
  // TMA maps: qkv as (3C, N, B), rows q_ld and samples q_bstride apart; dout
  // as (C, N, B); boxes of one head's 64 columns x 64 rows, rows past N zero
  const int C = H * AB_HD;
  const long long q_bs = B > 1 ? q_bstride : (long long)N * q_ld;
  const cuuint32_t box[3] = {AB_HD, AB_BLK, 1};
  const cuuint64_t q_dims[3] = {(cuuint64_t)3 * C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t q_strides[2] = {(cuuint64_t)q_ld * 2, (cuuint64_t)q_bs * 2};
  const cuuint64_t d_dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t d_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)N * C * 2};
  CUtensorMap tq, td;
  if (!encode_map(&tq, qkv, 3, q_dims, q_strides, box) ||
      !encode_map(&td, dout, 3, d_dims, d_strides, box))
    return cudaErrorInvalidValue;
  const int splits = ab_splits(N, policy);
  ab_kernel(policy, l.qpw, splits > 1)<<<dim3(B * H, splits), l.wgs * 128, l.bytes, stream>>>(
      tq, td, qkv, q_bstride, q_ld, o, o_res, dout, lse, pol, gcls, dqkv, dpol_part, kv_part,
      N, l.lqb, H, scale, eps, l.ring, l.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++attention_bwd_launches;
  if (splits == 1) return cudaSuccess;
  ++attention_bwd_long_launches;
  const long long n4 = (long long)B * N * C / 2;
  reduce_kv_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(kv_part, dqkv,
                                                                     (long long)B * N, C,
                                                                     splits);
  return cudaGetLastError();
}

// dPolicy from its (splits, B, H, N) partials at head width d
static cudaError_t launch_sum_heads(const float* part, float* out, int B, int H, int N, int d,
                                   cudaStream_t stream) {
  sum_heads_kernel<<<(B * N + 255) / 256, 256, 0, stream>>>(part, out, B, H, N,
                                                            dpol_splits(N, d));
  return cudaGetLastError();
}

// ---- the attention half-block's backward ---------------------------------

// scratch of d2s_attention_block_backward
struct AttnScratch {
  bf16 *qkv, *attn, *ores, *ln1o, *dattn, *dqkv;
  float *lse, *dpol_part, *kv_part, *dln, *work;
  float2 *stats, *st1;
};

static size_t carve_attn(char* base, int B, int N, int C, int H, bool policy, AttnScratch* s) {
  const long long M = (long long)B * N;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t e2 = sizeof(bf16), e4 = sizeof(float);
  s->qkv = reinterpret_cast<bf16*>(take(M * 3 * C * e2));
  s->attn = reinterpret_cast<bf16*>(take(M * C * e2));
  s->ores = reinterpret_cast<bf16*>(take(M * C * e2));
  s->ln1o = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dattn = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dqkv = reinterpret_cast<bf16*>(take(M * 3 * C * e2));
  const int d = C / H;
  const size_t lse_floats = (size_t)B * H * N * (policy || att_on_hd(N, d) ? 4 : 1);
  s->lse = reinterpret_cast<float*>(take(lse_floats * e4));
  s->dpol_part = reinterpret_cast<float*>(take(dpol_part_floats(B, N, H, d, policy) * e4));
  s->kv_part = reinterpret_cast<float*>(take(kv_part_floats(B, N, H, d, policy) * e4));
  if (kv_part_floats(B, N, H, d, policy) == 0) s->kv_part = nullptr;
  s->dln = reinterpret_cast<float*>(take(M * C * e4));
  s->stats = reinterpret_cast<float2*>(take(M * sizeof(float2)));
  s->st1 = reinterpret_cast<float2*>(take(M * sizeof(float2)));
  const int m = (int)M;
  long long work = std::max(wgrad_workspace_floats(m, C, C), wgrad_workspace_floats(m, 3 * C, C));
  work = std::max(work, ln_bwd_workspace_floats(m, C));
  s->work = reinterpret_cast<float*>(take(work * e4));
  return off;
}

static bool attn_shapes_ok(int B, int N, int C, int H, bool policy) {
  return B > 0 && head_width_ok(C, H) && att_takes(N, C / H, policy, true) && ln_bwd_takes(C) &&
         (long long)B * N <= (1LL << 31) - 1;
}

// ---- scratch ----------------------------------------------------------------

struct Scratch {
  bf16 *qkv, *attn, *ores, *mid, *hid, *pre, *ln1o, *ln2o, *dy, *dmid_b, *dattn, *dqkv;
  float *lse, *dln, *dmid_f, *work, *dpol_part, *kv_part;
  float2 *stats, *st1, *st2;
};

// Carves `base` into the backward's buffers; with base == nullptr only
// counts. Returns the bytes needed. Policy mode keeps float4 row statistics
// and the dPolicy partials; a split attention core its dK and dV partials.
static size_t carve(char* base, int B, int N, int C, int H, int hidden, bool policy,
                    Scratch* s) {
  const long long M = (long long)B * N;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t e2 = sizeof(bf16), e4 = sizeof(float);
  s->qkv = reinterpret_cast<bf16*>(take(M * 3 * C * e2));
  s->attn = reinterpret_cast<bf16*>(take(M * C * e2));
  s->ores = reinterpret_cast<bf16*>(take(M * C * e2));
  s->mid = reinterpret_cast<bf16*>(take(M * C * e2));
  s->hid = reinterpret_cast<bf16*>(take(M * hidden * e2));
  s->pre = reinterpret_cast<bf16*>(take(M * hidden * e2));
  s->ln1o = reinterpret_cast<bf16*>(take(M * C * e2));
  s->ln2o = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dy = reinterpret_cast<bf16*>(take(M * hidden * e2));
  s->dmid_b = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dattn = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dqkv = reinterpret_cast<bf16*>(take(M * 3 * C * e2));
  const int d = C / H;
  const size_t lse_floats = (size_t)B * H * N * (policy || att_on_hd(N, d) ? 4 : 1);
  s->lse = reinterpret_cast<float*>(take(lse_floats * e4));
  s->dpol_part = reinterpret_cast<float*>(take(dpol_part_floats(B, N, H, d, policy) * e4));
  s->kv_part = reinterpret_cast<float*>(take(kv_part_floats(B, N, H, d, policy) * e4));
  if (kv_part_floats(B, N, H, d, policy) == 0) s->kv_part = nullptr;
  s->dln = reinterpret_cast<float*>(take(M * C * e4));
  s->dmid_f = reinterpret_cast<float*>(take(M * C * e4));
  s->stats = reinterpret_cast<float2*>(take(M * sizeof(float2)));
  s->st1 = reinterpret_cast<float2*>(take(M * sizeof(float2)));
  s->st2 = reinterpret_cast<float2*>(take(M * sizeof(float2)));
  const int m = (int)M;
  long long work = wgrad_workspace_floats(m, C, hidden);
  work = std::max(work, wgrad_workspace_floats(m, hidden, C));
  work = std::max(work, wgrad_workspace_floats(m, C, C));
  work = std::max(work, wgrad_workspace_floats(m, 3 * C, C));
  work = std::max(work, column_sums_workspace_floats(m, C, 4));
  work = std::max(work, ln_bwd_workspace_floats(m, C));
  s->work = reinterpret_cast<float*>(take(work * e4));
  return off;
}

// A @ W over M rows, W (K, N) in the (out, in) layout of a Linear with
// out = K; with gelu_in, times GELU'(gelu_in) in the epilogue
static cudaError_t gemm_kn(const bf16* a, const bf16* wt, int M, int K, int Nn,
                           const bf16* gelu_in, bf16* out, float* out_f32, cudaStream_t st) {
  GemmArgs p{};
  p.a = a;
  p.a_rows = M;
  p.w = wt;
  p.w_kn = 1;
  p.gelu_in = gelu_in;
  p.out = out;
  p.out_f32 = out_f32;
  p.M = M;
  p.N = Nn;
  p.K = K;
  p.act = ACT_NONE;
  return launch_ln_gemm(p, st);
}

// The MLP half's backward, out = x + s fc2(h), h = GELU(y), y = fc1(LN(x)),
// over M rows, given g (the cotangent entering the branch, s times the
// output's) and g_res (the output's: the residual's), x with its
// LayerNorm's row statistics and output ln_x, h and y: dW2 = g^T h, db2 =
// sum g; dy = (g W2) * GELU'(y) in the gemm's epilogue; dW1 = dy^T LN(x),
// db1 = sum dy; dLN = dy W1 (fp32); the LayerNorm backward with dgamma,
// dbeta, giving dx = LN-bwd + g_res, into dx_f (fp32) and/or dx_b (bf16),
// which may be g's buffer. dy (M, hidden) bf16, dln (M, C) fp32 and work
// are scratch.
static cudaError_t mlp_backward(const bf16* g, const bf16* g_res, const bf16* x,
                                const float2* stats, const bf16* ln_x, const bf16* h,
                                const bf16* y, const float* ln_w, const bf16* w1,
                                const bf16* w2, float* d_ln_w, float* d_ln_b, float* d_w1,
                                float* d_b1, float* d_w2, float* d_b2, float* dx_f,
                                bf16* dx_b, bf16* dy, float* dln, float* work, int M, int C,
                                int hidden, cudaStream_t st) {
  cudaError_t err;
  if ((err = launch_wgrad(g, h, d_w2, work, M, C, hidden, st, d_b2)) != cudaSuccess) return err;
  if ((err = gemm_kn(g, w2, M, C, hidden, y, dy, nullptr, st)) != cudaSuccess) return err;
  if ((err = launch_wgrad(dy, ln_x, d_w1, work, M, hidden, C, st, d_b1)) != cudaSuccess)
    return err;
  if ((err = gemm_kn(dy, w1, M, hidden, C, nullptr, nullptr, dln, st)) != cudaSuccess) return err;
  return launch_ln_bwd(dln, x, stats, ln_w, g_res, nullptr, dx_f, dx_b, d_ln_w, d_ln_b, work, M,
                       C, st);
}

// scratch of d2s_mlp_residual_backward
struct MlpScratch {
  bf16 *ln_x, *hid, *pre, *dy;
  float *dln, *work;
  float2* stats;
};

static size_t carve_mlp(char* base, int M, int C, int hidden, MlpScratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t m = (size_t)M, e2 = sizeof(bf16), e4 = sizeof(float);
  s->ln_x = reinterpret_cast<bf16*>(take(m * C * e2));
  s->hid = reinterpret_cast<bf16*>(take(m * hidden * e2));
  s->pre = reinterpret_cast<bf16*>(take(m * hidden * e2));
  s->dy = reinterpret_cast<bf16*>(take(m * hidden * e2));
  s->dln = reinterpret_cast<float*>(take(m * C * e4));
  s->stats = reinterpret_cast<float2*>(take(m * sizeof(float2)));
  long long work = std::max(wgrad_workspace_floats(M, C, hidden),
                            wgrad_workspace_floats(M, hidden, C));
  work = std::max(work, ln_bwd_workspace_floats(M, C));
  s->work = reinterpret_cast<float*>(take(work * e4));
  return off;
}

static bool mlp_shapes_ok(int M, int C, int hidden) {
  return M > 0 && ln_bwd_takes(C) && hidden > 0 && hidden % 8 == 0;
}

static bool shapes_ok(int B, int N, int C, int H, int hidden, bool policy) {
  return B > 0 && head_width_ok(C, H) && att_takes(N, C / H, policy, true) && ln_bwd_takes(C) &&
         hidden > 0 && hidden % 8 == 0 && (long long)B * N <= (1LL << 31) - 1;
}

}  // namespace d2s

using d2s::bf16;

// Bytes of scratch d2s_block_backward needs at these shapes (policy: 1 in
// policy mode, else 0); 0 for shapes it does not take.
extern "C" long long d2s_block_backward_scratch_bytes(int B, int N, int C, int H, int hidden,
                                                      int policy) {
  if (!d2s::shapes_ok(B, N, C, H, hidden, policy != 0)) return 0;
  d2s::Scratch s;
  return (long long)d2s::carve(nullptr, B, N, C, H, hidden, policy != 0, &s);
}

// x, g: (B, N, C) bf16, the block's input and its output's cotangent; dx
// (B, N, C) bf16 out. Weights as d2s_block_forward takes them (bqkv may be
// null); the twelve gradients fp32 in the same shapes (d_bqkv null when
// bqkv is). policy: (B, N) fp32 keep policy or null (plain mode); d_policy:
// its (B, N) fp32 gradient, or null where it is not wanted (always null in
// plain mode); eps: the policy softmax's smoothing. sa, sm: (B) fp32
// DropPath scales of the attention and the MLP branch, each or both null
// (no scale); they get no gradient. scratch:
// d2s_block_backward_scratch_bytes(...) bytes. Requires C == d * H with a
// head width d up to 256, C a multiple of 8 up to
// d2s_ln_backward_max_width() (norm.cu's LayerNorm backward),
// hidden % 8 == 0, N up to hd_max_tokens (attention_hd.cuh), 16-byte
// aligned pointers. ln_c: the LayerNorms' width, C or less where the rows
// end in zero columns (d2s::LnWidth), as the forward took them.
extern "C" int d2s_block_backward(
    const void* x, const void* g, void* dx, const void* ln1_w, const void* ln1_b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* ln2_w, const void* ln2_b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* d_ln1_w, void* d_ln1_b, void* d_wqkv, void* d_bqkv, void* d_wproj,
    void* d_bproj, void* d_ln2_w, void* d_ln2_b, void* d_w1, void* d_b1, void* d_w2,
    void* d_b2, const void* policy, void* d_policy, const void* sa, const void* sm, void* scratch,
    int B, int N, int C, int H, int hidden, int ln_c, float scale, float ln_eps, float eps,
    void* stream) {
  using namespace d2s;
  const LnWidth scope(ln_c);
  const bool use_policy = policy != nullptr;
  if (!shapes_ok(B, N, C, H, hidden, use_policy) || (bqkv == nullptr) != (d_bqkv == nullptr) ||
      (d_policy != nullptr && !use_policy))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s;
  carve(static_cast<char*>(scratch), B, N, C, H, hidden, use_policy, &s);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };

  // 1. recompute
  int rc = block_forward(x, nullptr, s.qkv, s.attn, s.mid, s.hid, s.stats, ln1_w, ln1_b, wqkv,
                         bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, s.pre, s.lse, nullptr,
                         policy, sa, nullptr, B, N, C, H, hidden, scale, ln_eps, eps, stream,
                         s.ores);
  if (rc != 0) return rc;
  cudaError_t err = launch_ln_apply(xb, f(ln1_w), f(ln1_b), s.ln1o, s.st1, M, C, ln_eps, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_ln_apply(s.mid, f(ln2_w), f(ln2_b), s.ln2o, s.st2, M, C, ln_eps, st);
  if (err != cudaSuccess) return (int)err;

  // 2. MLP half, its branch's cotangent sm g in the dx_mid buffer
  const bf16* gm = gb;
  if (sm) {
    if ((err = launch_scale_rows(gb, nullptr, f(sm), N, s.dmid_b, nullptr, M, C, st)) !=
        cudaSuccess)
      return (int)err;
    gm = s.dmid_b;
  }
  if ((err = mlp_backward(gm, gb, s.mid, s.st2, s.ln2o, s.hid, s.pre, f(ln2_w), w(w1), w(w2),
                          fo(d_ln2_w), fo(d_ln2_b), fo(d_w1), fo(d_b1), fo(d_w2), fo(d_b2),
                          s.dmid_f, s.dmid_b, s.dy, s.dln, s.work, M, C, hidden, st)) !=
      cudaSuccess)
    return (int)err;

  // 3. attention half, its branch's cotangent sa dx_mid in the bf16 dx_mid
  // buffer and the dLN buffer
  const float* da_f = s.dmid_f;
  if (sa) {
    if ((err = launch_scale_rows(nullptr, s.dmid_f, f(sa), N, s.dmid_b, s.dln, M, C, st)) !=
        cudaSuccess)
      return (int)err;
    da_f = s.dln;
  }
  if ((err = launch_wgrad(s.dmid_b, s.attn, fo(d_wproj), s.work, M, C, C, st)) != cudaSuccess)
    return (int)err;
  if ((err = launch_column_sums(da_f, fo(d_bproj), s.work, M, C, st)) != cudaSuccess)
    return (int)err;
  if ((err = gemm_kn(s.dmid_b, w(wproj), M, C, C, nullptr, s.dattn, nullptr, st)) != cudaSuccess)
    return (int)err;

  // 4. attention core
  if ((err = launch_attention_bwd(s.qkv, (long long)N * 3 * C, 3 * C, s.attn, s.ores, s.dattn,
                                  s.lse, f(policy), nullptr, s.dqkv,
                                  d_policy ? s.dpol_part : nullptr, s.kv_part, B, N, H, C / H,
                                  scale, eps, st)) != cudaSuccess)
    return (int)err;
  if (d_policy && (err = launch_sum_heads(s.dpol_part, fo(d_policy), B, H, N, C / H, st)) !=
                      cudaSuccess)
    return (int)err;

  // 5. LN1 input
  if ((err = launch_wgrad(s.dqkv, s.ln1o, fo(d_wqkv), s.work, M, 3 * C, C, st, fo(d_bqkv))) !=
      cudaSuccess)
    return (int)err;
  if ((err = gemm_kn(s.dqkv, w(wqkv), M, 3 * C, C, nullptr, nullptr, s.dln, st)) != cudaSuccess)
    return (int)err;
  err = launch_ln_bwd(s.dln, xb, s.st1, f(ln1_w), nullptr, s.dmid_f, nullptr,
                      static_cast<bf16*>(dx), fo(d_ln1_w), fo(d_ln1_b), s.work, M, C, st);
  return (int)err;
}

// The packed attention core's backward (the CLS-capture route of a training
// block): dqkv (B, N, 3C) bf16 packed, from qkv (B, N, 3C) bf16 with token
// rows q_ld elements apart and samples q_bstride apart, and g (B, N, C)
// bf16, the cotangent of the attention output. gcls: (B, H, N) fp32, the
// cotangent of the CLS rows, or null (no fold). policy: (B, N) fp32 keep
// policy or null; d_policy: its (B, N) fp32 gradient or null. The forward
// is recomputed from qkv first (as the TPU kernel recomputes P): o_buf (2,
// B*N, C) bf16 (its output, then its out_res: launch_attention_strided) and
// stats (B, H, N) fp32 (policy mode float4) are its scratch,
// dpol_part dPolicy's partials (d2s_attention_bwd_part_floats(..., 1)
// floats, fp32; null without d_policy) and kv_part the core backward's
// other partials (d2s_attention_bwd_part_floats(..., 0) floats; null where
// that is 0). stats_buf is (B, H, N, 4) fp32 at a head width other
// than 64, and at 64 past ATT_SHORT_N tokens. Requires C == d * H (d at
// most 256), N up to hd_max_tokens, q_ld and
// q_bstride multiples of 8, 16-byte aligned pointers.
extern "C" int d2s_attention_packed_backward(const void* qkv, long long q_bstride, int q_ld,
                                             const void* g, const void* gcls,
                                             const void* policy, void* dqkv, void* d_policy,
                                             void* o_buf, void* stats_buf, void* dpol_part,
                                             void* kv_part, int B, int N, int H, int C,
                                             float scale, float eps, void* stream) {
  using namespace d2s;
  if (B <= 0 || !head_width_ok(C, H) ||
      (d_policy != nullptr && (policy == nullptr || dpol_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int d = C / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* pol = static_cast<const float*>(policy);
  bf16* o = static_cast<bf16*>(o_buf);
  bf16* o_res = o + (long long)B * N * C;
  cudaError_t err = launch_attention_strided(q, q_bstride, q_ld, o,
                                             static_cast<float*>(stats_buf), nullptr, pol, B, N,
                                             H, d, scale, eps, st, o_res);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention_bwd(q, q_bstride, q_ld, o, o_res,
                             static_cast<const bf16*>(g), static_cast<float*>(stats_buf),
                             pol, static_cast<const float*>(gcls), static_cast<bf16*>(dqkv),
                             d_policy ? static_cast<float*>(dpol_part) : nullptr,
                             static_cast<float*>(kv_part), B, N, H, d, scale, eps, st);
  if (err != cudaSuccess || d_policy == nullptr) return (int)err;
  return (int)launch_sum_heads(static_cast<const float*>(dpol_part),
                               static_cast<float*>(d_policy), B, H, N, d, st);
}

// The fp32 floats of d2s_attention_packed_backward's partials at these
// shapes (C = H d): dPolicy's (which = 1; policy: 1 in policy mode) or
// the core backward's others (which = 0, kv_part_floats: a split
// sample-head's dK and dV on attention_bwd_kernel, dQ's sums on the
// attention_hd path; 0 where there are none); -1 for shapes the kernels do
// not take.
extern "C" long long d2s_attention_bwd_part_floats(int which, int B, int N, int H, int C,
                                                   int policy) {
  if (B <= 0 || !d2s::head_width_ok(C, H) || !d2s::att_takes(N, C / H, policy != 0, true))
    return -1;
  return which ? d2s::dpol_part_floats(B, N, H, C / H, policy != 0)
               : d2s::kv_part_floats(B, N, H, C / H, policy != 0);
}

// The longest sequence the attention cores take at head width d, in policy
// mode (policy 1) or not, forward alone (backward 0) or both ways
// (backward 1): attention_hd.cuh's hd_max_tokens, 0 for a width they do not
// take. ops/block.py::attention_max_tokens computes the same without a card.
extern "C" int d2s_attention_max_tokens(int d, int policy, int backward) {
  return d2s::hd_max_tokens(d, policy != 0, backward != 0);
}

// The launches of attention_bwd_kernel (which = 0) and of those on its
// long path (which = 1) since the last reset, counted where it is launched,
// inside the backward entries too; set resets the count to `value` when it
// is 0 or more.
extern "C" long long d2s_attention_bwd_launches(int which, long long value) {
  if (which != 0 && which != 1) return -1;
  long long& n = which ? d2s::attention_bwd_long_launches : d2s::attention_bwd_launches;
  if (value >= 0) n = value;
  return n;
}

// Bytes of scratch d2s_attention_block_backward needs at these shapes
// (policy: 1 in policy mode, else 0); 0 for shapes it does not take.
extern "C" long long d2s_attention_block_backward_scratch_bytes(int B, int N, int C, int H,
                                                                int policy) {
  if (!d2s::attn_shapes_ok(B, N, C, H, policy != 0)) return 0;
  d2s::AttnScratch s;
  return (long long)d2s::carve_attn(nullptr, B, N, C, H, policy != 0, &s);
}

// The attention half-block's backward, for out = x + proj(MHA(qkv(LN1 x)))
// (block.cu's d2s_attention_block_forward). Replaces dense2sparse_vit_tpu/
// ops/pallas/attention.py::fused_attention_block_backward (plain mode,
// `_attn_block_bwd_kernel`) and ::fused_attention_block_backward_policy
// (with dPolicy, `_attn_block_bwd_policy_kernel`): one entry, the policy and
// its gradient nullable, as d2s_block_backward has them. It recomputes qkv,
// the attention output and its row statistics (stages 1-2 of the forward)
// and LN1(x), then runs steps 3-5 of d2s_block_backward with g, the
// output's cotangent, as the branch's: dWproj = g^T O, dbproj = sum g,
// dO = g Wproj; the attention core's backward (and dPolicy's head sum);
// dWqkv = dqkv^T LN1(x), dbqkv = sum dqkv, dLN1 = dqkv Wqkv (fp32); and
// the LayerNorm backward with dgamma, dbeta, whose fp32 sum takes g, bf16
// as it comes, as its residual term: dx = g + LN1-bwd, rounded once to
// bf16, with no widened copy of g. Bound by operations (qkv's product
// recomputed, qkv's and proj's dX and dW products, the core's score
// products recomputed and its five backward ones: ~108 GFLOP at B=128,
// N=197, C=384), as the block's backward is.
// x, g: (B, N, C) bf16; dx (B, N, C) bf16 out. Weights as
// d2s_attention_block_forward takes them (bqkv may be null; bproj is not
// needed); the six gradients fp32 in the weights' shapes (d_bqkv null when
// bqkv is). policy: (B, N) fp32 keep policy or null; d_policy: its (B, N)
// fp32 gradient or null. scratch: d2s_attention_block_backward_scratch_bytes
// bytes. Requires C == d * H (d at most 256) a multiple of 8 up to
// d2s_ln_backward_max_width(), N up to hd_max_tokens,
// 16-byte aligned pointers.
extern "C" int d2s_attention_block_backward(
    const void* x, const void* g, void* dx, const void* ln_w, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, void* d_ln_w, void* d_ln_b,
    void* d_wqkv, void* d_bqkv, void* d_wproj, void* d_bproj, const void* policy,
    void* d_policy, void* scratch, int B, int N, int C, int H, int ln_c, float scale,
    float ln_eps, float eps, void* stream) {
  using namespace d2s;
  const LnWidth scope(ln_c);
  const bool use_policy = policy != nullptr;
  if (!attn_shapes_ok(B, N, C, H, use_policy) || (bqkv == nullptr) != (d_bqkv == nullptr) ||
      (d_policy != nullptr && !use_policy))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  AttnScratch s;
  carve_attn(static_cast<char*>(scratch), B, N, C, H, use_policy, &s);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* pol = static_cast<const float*>(policy);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };

  // recompute qkv, O with its row statistics, and LN1(x)
  cudaError_t err = qkv_stage(xb, s.qkv, s.stats, f(ln_w), f(ln_b), w(wqkv), f(bqkv), M, C,
                              ln_eps, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_attention_strided(s.qkv, (long long)N * 3 * C, 3 * C, s.attn, s.lse, nullptr,
                                      pol, B, N, H, C / H, scale, eps, st, s.ores)) !=
      cudaSuccess)
    return (int)err;
  if ((err = launch_ln_apply(xb, f(ln_w), f(ln_b), s.ln1o, s.st1, M, C, ln_eps, st)) !=
      cudaSuccess)
    return (int)err;

  // the proj product
  if ((err = launch_wgrad(gb, s.attn, fo(d_wproj), s.work, M, C, C, st, fo(d_bproj))) !=
      cudaSuccess)
    return (int)err;
  if ((err = gemm_kn(gb, w(wproj), M, C, C, nullptr, s.dattn, nullptr, st)) != cudaSuccess)
    return (int)err;

  // the attention core
  if ((err = launch_attention_bwd(s.qkv, (long long)N * 3 * C, 3 * C, s.attn, s.ores, s.dattn,
                                  s.lse, pol, nullptr, s.dqkv, d_policy ? s.dpol_part : nullptr,
                                  s.kv_part, B, N, H, C / H, scale, eps, st)) != cudaSuccess)
    return (int)err;
  if (d_policy && (err = launch_sum_heads(s.dpol_part, fo(d_policy), B, H, N, C / H, st)) !=
                      cudaSuccess)
    return (int)err;

  // the qkv product and LN1
  if ((err = launch_wgrad(s.dqkv, s.ln1o, fo(d_wqkv), s.work, M, 3 * C, C, st, fo(d_bqkv))) !=
      cudaSuccess)
    return (int)err;
  if ((err = gemm_kn(s.dqkv, w(wqkv), M, 3 * C, C, nullptr, nullptr, s.dln, st)) != cudaSuccess)
    return (int)err;
  const bf16* res = gb;  // dx's residual term, g itself
  return (int)launch_ln_bwd(s.dln, xb, s.st1, f(ln_w), res, nullptr, nullptr,
                            static_cast<bf16*>(dx), fo(d_ln_w), fo(d_ln_b), s.work, M, C, st);
}

// Bytes of scratch d2s_mlp_residual_backward needs for M rows; 0 for shapes
// it does not take.
extern "C" long long d2s_mlp_residual_backward_scratch_bytes(int M, int C, int hidden) {
  if (!d2s::mlp_shapes_ok(M, C, hidden)) return 0;
  d2s::MlpScratch s;
  return (long long)d2s::carve_mlp(nullptr, M, C, hidden, &s);
}

// The MLP half's backward alone, for out = x + fc2(GELU(fc1(LN x))) over
// M = B*N rows: x and g (the cotangent of out) (M, C) bf16; dx (M, C) bf16
// out; weights as d2s_block_forward takes ln2/w1/b1/w2 (b2 is not needed);
// the six gradients fp32 in the weights' shapes, summed over the rows in a
// fixed order. LN(x) and fc1 with GELU are recomputed from x. scratch:
// d2s_mlp_residual_backward_scratch_bytes(M, C, hidden) bytes. Requires
// C a multiple of 8 up to d2s_ln_backward_max_width(), hidden % 8 == 0,
// 16-byte aligned pointers.
extern "C" int d2s_mlp_residual_backward(const void* x, const void* g, void* dx,
                                         const void* ln_w, const void* ln_b, const void* w1,
                                         const void* b1, const void* w2, void* d_ln_w,
                                         void* d_ln_b, void* d_w1, void* d_b1, void* d_w2,
                                         void* d_b2, void* scratch, int M, int C, int hidden,
                                         int ln_c, float ln_eps, void* stream) {
  using namespace d2s;
  const LnWidth scope(ln_c);
  if (!mlp_shapes_ok(M, C, hidden)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpScratch s;
  carve_mlp(static_cast<char*>(scratch), M, C, hidden, &s);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* lw = static_cast<const float*>(ln_w);
  cudaError_t err =
      launch_ln_apply(xb, lw, static_cast<const float*>(ln_b), s.ln_x, s.stats, M, C, ln_eps, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs p{};  // h = GELU(y), y = LN(x) W1^T + b1, kept for GELU'
  p.a = s.ln_x;
  p.a_rows = M;
  p.w = static_cast<const bf16*>(w1);
  p.bias = static_cast<const float*>(b1);
  p.preact = s.pre;
  p.out = s.hid;
  p.M = M;
  p.N = hidden;
  p.K = C;
  p.act = ACT_GELU;
  if ((err = launch_ln_gemm(p, st)) != cudaSuccess) return (int)err;
  auto fo = [](void* q) { return static_cast<float*>(q); };
  const bf16* gb = static_cast<const bf16*>(g);
  return (int)mlp_backward(gb, gb, xb, s.stats, s.ln_x, s.hid, s.pre, lw,
                           static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
                           fo(d_ln_w), fo(d_ln_b), fo(d_w1), fo(d_b1), fo(d_w2), fo(d_b2),
                           nullptr, static_cast<bf16*>(dx), s.dy, s.dln, s.work, M, C, hidden,
                           st);
}
