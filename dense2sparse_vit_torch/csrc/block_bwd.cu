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
//                 keeping qkv, the attention output O, x_mid, h = GELU(y),
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
//   4. core       attention_bwd, one CTA per (sample, head), all of that
//                 sample-head's Q, K, V and dO in shared memory (N <= 384;
//                 policy mode N <= 352): P = exp(scale q.k - lse),
//                 D = rowsum(dO * O), dS = P * (dO V^T - D), dV = P^T dO,
//                 dQ = scale dS K, dK = scale dS^T Q, all on mma.sync;
//                 writes packed dqkv (policy mode below)
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
// its recomputed score products on mma.sync (~0.04 ms of bytes at B=128,
// N=197), the MLP half by its four products (~150 GFLOP with fc1
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
//           columns are found by comparing with the stored max, which only
//           products bit-identical to the forward's may do: the query-row
//           products of pass 2 below are (the same mma.sync on the same
//           fragments as block.cu's pass 1); pass 1's key-row products are
//           not, so pass 1 recomputes its tile's scores query-row-wise, and
//           where a tile holds a tie (a warp vote) moves the tie terms into
//           its key-row layout through a per-warp shared-memory tile. The
//           forward stores how many columns tie (float4 statistics);
//   dPolicy_j = sum_h sum_{i != j} de_ij exp(s_ij - m_i): the unmasked exp,
//           the diagonal left out. A warp of pass 1 owns a key tile and sums
//           over every query in a fixed order; the (B, H, N) fp32 partials
//           are then added over the heads in order by sum_heads_kernel, so
//           dPolicy is deterministic and takes no atomics. With a null
//           d_policy (the threshold path, whose policy needs no gradient)
//           none of this runs.
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
// again (the bf16 bias sums ride on the weight gradients' reads), and the
// attention core recomputes the scores twice (once for dK/dV, once for
// dQ), seven products on mma.sync where five would do (policy mode: eight,
// with the tie recompute). A faster design would keep the MLP's hidden
// activation on chip (fc1, GELU', fc2 fused per row tile), produce dK/dV
// and dQ from one pass over the scores, and fuse the LayerNorm backward's
// row reductions into the dX GEMMs' epilogues.
#include <algorithm>

#include "ln_gemm.cuh"

extern "C" int d2s_block_forward(
    const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf, void* hid_buf,
    void* stats_buf, const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ln2_w, const void* ln2_b,
    const void* w1, const void* b1, const void* w2, const void* b2, void* preact, void* lse,
    void* cls, const void* policy, const void* sa, const void* sm, int B, int N, int C, int H,
    int hidden, float scale, float ln_eps, float eps, void* stream);

namespace d2s {

// block.cu's attention core, on qkv rows q_ld apart and samples q_bstride apart
cudaError_t launch_attention_strided(const bf16* qkv, long long q_bstride, int q_ld, bf16* out,
                                     float* lse, bf16* cls, const float* pol, int B, int N,
                                     int H, float scale, float eps, cudaStream_t stream);
// block.cu's stage 1, qkv = LN1(x) Wqkv^T + bqkv
cudaError_t qkv_stage(const bf16* x, bf16* qkv, float2* stats, const float* ln_w,
                      const float* ln_b, const bf16* wqkv, const float* bqkv, int M, int C,
                      float ln_eps, cudaStream_t stream);

// ---- LayerNorm forward, materialised (warp per row) ----------------------

// out = bf16((x - mu) * rstd * gamma + beta) and stats = (mu, rstd), with
// the same arithmetic as ln_stats_kernel and ln_gemm's prologue, so that the
// recomputed LN1(x) and LN2(x_mid) equal what the forward multiplied.
static __global__ void ln_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, bf16* __restrict__ out,
                                       float2* __restrict__ stats, int M, int C, float eps) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= M) return;
  const int lane = threadIdx.x & 31;
  const uint4* row = reinterpret_cast<const uint4*>(x + (long long)m * C);
  const int nv = C / 8;
  float s = 0.f;
  for (int j = lane; j < nv; j += 32) {
    const uint4 v = row[j];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(e[t]);
  }
  const float mu = warp_sum(s) / C;
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
  const float rs = rsqrtf(warp_sum(q) / C + eps);
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
  ln_apply_kernel<<<(M + rows_per_cta - 1) / rows_per_cta, 32 * rows_per_cta, 0, stream>>>(
      x, gamma, beta, out, stats, M, C, eps);
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
constexpr int AB_THREADS = 256;
constexpr int AB_WARPS = AB_THREADS / 32;
constexpr int AB_LD = AB_HD + 8;  // bf16 pitch of the Q, K, V, dO rows
constexpr int AB_MAX_N = 384;     // four (N, 64) bf16 tiles stay under 227 KB
constexpr int AB_POLICY_MAX_N = 352;  // policy mode: and four more row vectors
constexpr int AB_TIE_LD = 17;     // fp32 pitch of a warp's 16 x 16 tie tile

__host__ __device__ inline int ab_padded(int n) { return (n + 15) / 16 * 16; }

static size_t ab_smem_bytes(int n, bool policy, bool fold) {
  const size_t np = ab_padded(n);
  size_t bytes = 4 * np * AB_LD * 2 + 2 * np * sizeof(float);
  // 1/den, gmx/ties, pol per row; colsum(V); the warps' tie tiles
  if (policy) bytes += (3 * np + AB_HD + AB_WARPS * 16 * AB_TIE_LD) * sizeof(float);
  if (fold) bytes += np * sizeof(float);  // the CLS row's cotangent
  return bytes;
}

// the four A fragments of a 16 x 64 row slice of a [row][d] bf16 tile
__device__ __forceinline__ void ld_a_rows(uint32_t (&a)[AB_HD / 16][4], const bf16* rows,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < AB_HD / 16; ++kk) {
    const bf16* p = rows + g * AB_LD + kk * 16 + 2 * t;
    a[kk][0] = ld32(p);
    a[kk][1] = ld32(p + 8 * AB_LD);
    a[kk][2] = ld32(p + 8);
    a[kk][3] = ld32(p + 8 * AB_LD + 8);
  }
}

// c (16 x 8) += a (16 x 64 rows) . b^T, b the 8 rows of a [row][d] tile at `rows`
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[AB_HD / 16][4],
                                         const bf16* rows, int g, int t) {
  const bf16* p = rows + g * AB_LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < AB_HD / 16; ++kk) mma_16816(c, a[kk], ld32(p + kk * 16), ld32(p + kk * 16 + 8));
}

// the A fragment of a 16 x 16 tile held as two 16 x 8 accumulators
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// acc (16 x 64) += a (16 x 16) . rows (16 x 64), rows the [row][d] tile slice
__device__ __forceinline__ void mma_into(float (&acc)[AB_HD / 8][4], const uint32_t (&a)[4],
                                         const bf16* rows, int lane) {
#pragma unroll
  for (int nd = 0; nd < AB_HD / 8; nd += 2) {
    uint32_t r[4];
    ld_b_kn(r, rows + nd * 8, AB_LD, lane);
    mma_16816(acc[nd], a, r[0], r[1]);
    mma_16816(acc[nd + 1], a, r[2], r[3]);
  }
}

// rows r and r + 8 of a 16 x 64 accumulator into columns [col0, col0 + 64)
// of the (rows, ld) bf16 matrix `dst`, rows past n left alone
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int r, int n,
                                           const float (&acc)[AB_HD / 8][4], int t) {
#pragma unroll
  for (int nd = 0; nd < AB_HD / 8; ++nd) {
    if (r < n)
      *reinterpret_cast<uint32_t*>(dst + r * ld + nd * 8 + 2 * t) =
          pack_bf16(acc[nd][0], acc[nd][1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * ld + nd * 8 + 2 * t) =
          pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// CTA = one (sample, head). qkv (B, N, 3C) with token rows q_ld elements
// apart and samples q_bstride apart, o and dout (B*N, C), lse (B, H, N)
// (policy mode: float4 (m, den, ties, 0)), dqkv (B*N, 3C) packed; policy
// mode: pol (B, N), dpol_part (B, H, N) or null. gcls: (B, H, N) fp32, the
// cotangent of the CLS (query 0) rows of the probabilities, or null.
//
// The CLS rows are the probabilities' row 0, so their cotangent adds to dP's
// row 0: dP_0j += gcls_j, and with it D_0 = sum_j P_0j dP_0j gains
// sum_j gcls_j P_0j, which warp 0 computes from row 0's scores recomputed in
// fp32 before the passes. Policy mode's de = (dP - D) / den then carries the
// fold into dS, dPolicy and, through sum_j dP_0j = dO_0 . colsum(V) +
// sum_j gcls_j, the max path.
template <bool POLICY>
static __global__ void __launch_bounds__(AB_THREADS)
    attention_bwd_kernel(const bf16* __restrict__ qkv, long long q_bstride, int q_ld,
                         const bf16* __restrict__ o, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ pol,
                         const float* __restrict__ gcls, bf16* __restrict__ dqkv,
                         float* __restrict__ dpol_part, int N, int H, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = ab_padded(N);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + np * AB_LD;
  bf16* Vs = Ks + np * AB_LD;
  bf16* dOs = Vs + np * AB_LD;
  float* Ds = reinterpret_cast<float*>(dOs + np * AB_LD);
  float* Ls = Ds + np;  // plain: log-sum-exp; policy: the row max m
  float* Rd = Ls + np;  // policy: 1 / den
  float* Gc = Rd + np;  // policy: the max path's gmx / ties
  float* Ps = Gc + np;  // policy: pol_j
  float* Cv = Ps + np;  // policy: colsum(V)
  float* Tw = Cv + AB_HD;  // policy: a 16 x 16 tie tile per warp
  float* Gs = POLICY ? Tw + AB_WARPS * 16 * AB_TIE_LD : Rd;  // gcls: the CLS row's cotangent
  __shared__ float gsum;  // gcls: sum_j gcls_j

  const int C = H * AB_HD;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const bf16* base = qkv + (long long)b * q_bstride + h * AB_HD;
  const bf16* ob = o + (long long)b * N * C + h * AB_HD;
  const bf16* dob = dout + (long long)b * N * C + h * AB_HD;
  const float4* st4 = reinterpret_cast<const float4*>(lse);

  // rows past N are zero; their probabilities are masked to 0 below
  constexpr int VPR = AB_HD / 8;
  for (int v = tid; v < np * VPR; v += AB_THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 q = make_uint4(0u, 0u, 0u, 0u), k = q, vv = q, d = q;
    if (r < N) {
      const bf16* row = base + (long long)r * q_ld + c;
      q = *reinterpret_cast<const uint4*>(row);
      k = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
      d = *reinterpret_cast<const uint4*>(dob + (long long)r * C + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * AB_LD + c) = q;
    *reinterpret_cast<uint4*>(Ks + r * AB_LD + c) = k;
    *reinterpret_cast<uint4*>(Vs + r * AB_LD + c) = vv;
    *reinterpret_cast<uint4*>(dOs + r * AB_LD + c) = d;
  }
  for (int r = tid; r < np; r += AB_THREADS) {
    if (gcls) Gs[r] = r < N ? gcls[(long long)blockIdx.x * N + r] : 0.f;
    if (POLICY) {
      const float4 st = r < N ? st4[(long long)blockIdx.x * N + r] : make_float4(0.f, 1.f, 1.f, 0.f);
      Ls[r] = st.x;
      Rd[r] = r < N ? 1.f / st.y : 0.f;
      Gc[r] = st.z;  // the ties, until gmx replaces them below
      Ps[r] = r < N ? pol[(long long)b * N + r] : 0.f;
    } else {
      Ls[r] = r < N ? lse[(long long)blockIdx.x * N + r] : 0.f;
    }
    // D = rowsum(dO * O): the softmax backward's sum_j P_ij dP_ij
    float acc = 0.f;
    if (r < N) {
      for (int c = 0; c < AB_HD; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(ob + (long long)r * C + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dob + (long long)r * C + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
      }
    }
    Ds[r] = acc;
  }
  __syncthreads();
  const float cc = POLICY ? eps / N : 0.f;
  if (gcls) {
    // D_0 += sum_j gcls_j P_0j, P_0j from row 0's scores in fp32
    if (tid < 32) {
      float s0 = 0.f, gs = 0.f;
      for (int j = tid; j < N; j += 32) {
        float dot = 0.f;
        for (int c = 0; c < AB_HD; ++c)
          dot += __bfloat162float(Qs[c]) * __bfloat162float(Ks[j * AB_LD + c]);
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
      if (tid == 0) {
        Ds[0] += s0;
        gsum = gs;
      }
    }
    __syncthreads();
  }
  if (POLICY) {
    if (tid < AB_HD) {
      float acc = 0.f;
      for (int r = 0; r < N; ++r) acc += __bfloat162float(Vs[r * AB_LD + tid]);
      Cv[tid] = acc;
    }
    __syncthreads();
    // the max path: gmx_i = (c / den_i) (dO_i . colsum(V) - N D_i), split
    // over the row's ties
    for (int r = tid; r < N; r += AB_THREADS) {
      float dv = 0.f;
      for (int c = 0; c < AB_HD; ++c) dv += __bfloat162float(dOs[r * AB_LD + c]) * Cv[c];
      if (gcls && r == 0) dv += gsum;  // sum_j dP_0j
      Gc[r] = cc * Rd[r] * (dv - N * Ds[r]) / Gc[r];
    }
    __syncthreads();
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles = np / 16;
  const long long ld = 3LL * C;
  bf16* drow = dqkv + (long long)b * N * ld + h * AB_HD;
  float* tw = Tw + warp * 16 * AB_TIE_LD;

  // pass 1, a warp per 16-key tile: dV = P^T dO and dK = dS^T Q, over all
  // queries; the transposed tiles P^T, dP^T = V dO^T come straight out of
  // the products with the keys as rows
  for (int kt = warp; kt < tiles; kt += AB_WARPS) {
    const int j0 = kt * 16;
    uint32_t ka[AB_HD / 16][4], va[AB_HD / 16][4];
    ld_a_rows(ka, Ks + j0 * AB_LD, g, t);
    ld_a_rows(va, Vs + j0 * AB_LD, g, t);
    float dk[AB_HD / 8][4], dv[AB_HD / 8][4];
#pragma unroll
    for (int nd = 0; nd < AB_HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
    float dpa[2] = {0.f, 0.f};  // dPolicy of keys j0 + g and j0 + g + 8
    for (int i0 = 0; i0 < np; i0 += 16) {
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_rows(st[nt], ka, Qs + (i0 + nt * 8) * AB_LD, g, t);
        mma_rows(dpt[nt], va, dOs + (i0 + nt * 8) * AB_LD, g, t);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + g + 8 * (e >> 1);
          const int q = i0 + nt * 8 + 2 * t + (e & 1);
          const bool valid = key < N && q < N;
          const float dpv = dpt[nt][e] + (gcls && q == 0 ? Gs[key] : 0.f);
          if (POLICY) {
            const float xe = valid ? __expf(st[nt][e] * scale - Ls[q]) : 0.f;
            const float pk = Ps[key];
            const float ew = xe * (key == q ? pk + (1.f - pk) : pk);
            const float de = (dpv - Ds[q]) * Rd[q];
            if (dpol_part) {
              if (key != q) dpa[e >> 1] += de * xe;  // dPolicy: the diagonal left out
            }
            st[nt][e] = valid ? (ew + cc) * Rd[q] : 0.f;
            dpt[nt][e] = de * ew * scale;
          } else {
            const float p = valid ? __expf(st[nt][e] * scale - Ls[q]) : 0.f;
            st[nt][e] = p;
            dpt[nt][e] = p * (dpv - Ds[q]) * scale;
          }
        }
      if (POLICY) {
        // the max path's share of dS^T: this tile's scores query-row-wise,
        // bit for bit the forward's, compared with the stored max
        uint32_t qa[AB_HD / 16][4];
        ld_a_rows(qa, Qs + i0 * AB_LD, g, t);
        float sf[2][4] = {};
        bool tie[2][4];
        bool any = false;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_rows(sf[nt], qa, Ks + (j0 + nt * 8) * AB_LD, g, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = i0 + g + 8 * (e >> 1);
            const int key = j0 + nt * 8 + 2 * t + (e & 1);
            tie[nt][e] = q < N && key < N && sf[nt][e] * scale == Ls[q];
            any |= tie[nt][e];
          }
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ql = g + 8 * (e >> 1);
              const int kl = nt * 8 + 2 * t + (e & 1);
              tw[ql * AB_TIE_LD + kl] = tie[nt][e] ? Gc[i0 + ql] * scale : 0.f;
            }
          __syncwarp();
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[nt][e] += tw[(nt * 8 + 2 * t + (e & 1)) * AB_TIE_LD + g + 8 * (e >> 1)];
          __syncwarp();
        }
      }
      uint32_t pa[4], da[4];
      pack_a(pa, st);
      pack_a(da, dpt);
      mma_into(dv, pa, dOs + i0 * AB_LD, lane);
      mma_into(dk, da, Qs + i0 * AB_LD, lane);
    }
    store_rows(drow + C, ld, j0 + g, N, dk, t);
    store_rows(drow + 2 * C, ld, j0 + g, N, dv, t);
    if (POLICY && dpol_part) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dpa[0] += __shfl_xor_sync(0xffffffffu, dpa[0], o);
        dpa[1] += __shfl_xor_sync(0xffffffffu, dpa[1], o);
      }
      float* dp = dpol_part + (long long)blockIdx.x * N;
      if (t == 0 && j0 + g < N) dp[j0 + g] = dpa[0];
      if (t == 0 && j0 + g + 8 < N) dp[j0 + g + 8] = dpa[1];
    }
  }

  // pass 2, a warp per 16-query tile: dQ = dS K over all keys
  for (int qt = warp; qt < tiles; qt += AB_WARPS) {
    const int i0 = qt * 16;
    uint32_t qa[AB_HD / 16][4], oa[AB_HD / 16][4];
    ld_a_rows(qa, Qs + i0 * AB_LD, g, t);
    ld_a_rows(oa, dOs + i0 * AB_LD, g, t);
    const float l0 = Ls[i0 + g], l1 = Ls[i0 + g + 8];
    const float d0 = Ds[i0 + g], d1 = Ds[i0 + g + 8];
    const bool r0 = i0 + g < N, r1 = i0 + g + 8 < N;
    float rd0 = 0.f, rd1 = 0.f, gc0 = 0.f, gc1 = 0.f;
    if (POLICY) {
      rd0 = Rd[i0 + g];
      rd1 = Rd[i0 + g + 8];
      gc0 = Gc[i0 + g];
      gc1 = Gc[i0 + g + 8];
    }
    float dq[AB_HD / 8][4];
#pragma unroll
    for (int nd = 0; nd < AB_HD / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
    for (int j0 = 0; j0 < np; j0 += 16) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_rows(s[nt], qa, Ks + (j0 + nt * 8) * AB_LD, g, t);
        mma_rows(dp[nt], oa, Vs + (j0 + nt * 8) * AB_LD, g, t);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >> 1;
          const int key = j0 + nt * 8 + 2 * t + (e & 1);
          const int q = i0 + g + 8 * hi;
          const bool valid = key < N && (hi ? r1 : r0);
          const float dpv = dp[nt][e] + (gcls && q == 0 ? Gs[key] : 0.f);
          if (POLICY) {
            const float m = hi ? l1 : l0;
            const float v = s[nt][e] * scale;
            const float xe = valid ? __expf(v - m) : 0.f;
            const float pk = Ps[key];
            const float ew = xe * (key == q ? pk + (1.f - pk) : pk);
            float ds = (dpv - (hi ? d1 : d0)) * (hi ? rd1 : rd0) * ew;
            if (valid && v == m) ds += hi ? gc1 : gc0;
            s[nt][e] = ds * scale;
          } else {
            const float p =
                valid ? __expf(s[nt][e] * scale - (hi ? l1 : l0)) : 0.f;
            s[nt][e] = p * (dpv - (hi ? d1 : d0)) * scale;
          }
        }
      uint32_t da[4];
      pack_a(da, s);
      mma_into(dq, da, Ks + j0 * AB_LD, lane);
    }
    store_rows(drow, ld, i0 + g, N, dq, t);
  }
}

// dpol[b][j] = sum over h, in order, of part[b][h][j]
static __global__ void sum_heads_kernel(const float* __restrict__ part, float* __restrict__ out,
                                        int B, int H, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, j = i % N;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += part[((long long)b * H + h) * N + j];
  out[i] = acc;
}

static cudaError_t launch_attention_bwd(const bf16* qkv, long long q_bstride, int q_ld,
                                        const bf16* o, const bf16* dout, const float* lse,
                                        const float* pol, const float* gcls, bf16* dqkv,
                                        float* dpol_part, int B, int N, int H, float scale,
                                        float eps, cudaStream_t stream) {
  const bool policy = pol != nullptr;
  if (N <= 0 || N > (policy ? AB_POLICY_MAX_N : AB_MAX_N) || q_ld < 3 * H * AB_HD || q_ld % 8 ||
      q_bstride % 8)
    return cudaErrorInvalidValue;
  const size_t smem = ab_smem_bytes(N, policy, gcls != nullptr);
  auto kernel = policy ? attention_bwd_kernel<true> : attention_bwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, AB_THREADS, smem, stream>>>(qkv, q_bstride, q_ld, o, dout, lse, pol, gcls, dqkv,
                                              dpol_part, N, H, scale, eps);
  return cudaGetLastError();
}

static cudaError_t launch_sum_heads(const float* part, float* out, int B, int H, int N,
                                   cudaStream_t stream) {
  sum_heads_kernel<<<(B * N + 255) / 256, 256, 0, stream>>>(part, out, B, H, N);
  return cudaGetLastError();
}

// ---- the attention half-block's backward ---------------------------------

// scratch of d2s_attention_block_backward
struct AttnScratch {
  bf16 *qkv, *attn, *ln1o, *dattn, *dqkv;
  float *lse, *dpol_part, *dln, *work;
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
  s->ln1o = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dattn = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dqkv = reinterpret_cast<bf16*>(take(M * 3 * C * e2));
  s->lse = reinterpret_cast<float*>(take((size_t)B * H * N * e4 * (policy ? 4 : 1)));
  s->dpol_part = reinterpret_cast<float*>(take(policy ? (size_t)B * H * N * e4 : 0));
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
  return B > 0 && N > 0 && N <= (policy ? AB_POLICY_MAX_N : AB_MAX_N) && H > 0 &&
         C == H * AB_HD && ln_bwd_takes(C) && (long long)B * N <= (1LL << 31) - 1;
}

// ---- scratch ----------------------------------------------------------------

struct Scratch {
  bf16 *qkv, *attn, *mid, *hid, *pre, *ln1o, *ln2o, *dy, *dmid_b, *dattn, *dqkv;
  float *lse, *dln, *dmid_f, *work, *dpol_part;
  float2 *stats, *st1, *st2;
};

// Carves `base` into the backward's buffers; with base == nullptr only
// counts. Returns the bytes needed. Policy mode keeps float4 row statistics
// and the (B, H, N) dPolicy partials.
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
  s->mid = reinterpret_cast<bf16*>(take(M * C * e2));
  s->hid = reinterpret_cast<bf16*>(take(M * hidden * e2));
  s->pre = reinterpret_cast<bf16*>(take(M * hidden * e2));
  s->ln1o = reinterpret_cast<bf16*>(take(M * C * e2));
  s->ln2o = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dy = reinterpret_cast<bf16*>(take(M * hidden * e2));
  s->dmid_b = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dattn = reinterpret_cast<bf16*>(take(M * C * e2));
  s->dqkv = reinterpret_cast<bf16*>(take(M * 3 * C * e2));
  s->lse = reinterpret_cast<float*>(take((size_t)B * H * N * e4 * (policy ? 4 : 1)));
  s->dpol_part = reinterpret_cast<float*>(take(policy ? (size_t)B * H * N * e4 : 0));
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
  return B > 0 && N > 0 && N <= (policy ? AB_POLICY_MAX_N : AB_MAX_N) && H > 0 &&
         C == H * AB_HD && ln_bwd_takes(C) &&
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
// d2s_block_backward_scratch_bytes(...) bytes. Requires C == 64 * H <= 768,
// hidden % 8 == 0, N <= 384 (policy mode 352), 16-byte aligned pointers.
extern "C" int d2s_block_backward(
    const void* x, const void* g, void* dx, const void* ln1_w, const void* ln1_b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* ln2_w, const void* ln2_b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* d_ln1_w, void* d_ln1_b, void* d_wqkv, void* d_bqkv, void* d_wproj,
    void* d_bproj, void* d_ln2_w, void* d_ln2_b, void* d_w1, void* d_b1, void* d_w2,
    void* d_b2, const void* policy, void* d_policy, const void* sa, const void* sm, void* scratch,
    int B, int N, int C, int H, int hidden, float scale, float ln_eps, float eps, void* stream) {
  using namespace d2s;
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
  int rc = d2s_block_forward(x, nullptr, s.qkv, s.attn, s.mid, s.hid, s.stats, ln1_w, ln1_b,
                             wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, s.pre,
                             s.lse, nullptr, policy, sa, nullptr, B, N, C, H, hidden, scale,
                             ln_eps, eps, stream);
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
  if ((err = launch_attention_bwd(s.qkv, (long long)N * 3 * C, 3 * C, s.attn, s.dattn, s.lse,
                                  f(policy), nullptr, s.dqkv, d_policy ? s.dpol_part : nullptr,
                                  B, N, H, scale, eps, st)) != cudaSuccess)
    return (int)err;
  if (d_policy &&
      (err = launch_sum_heads(s.dpol_part, fo(d_policy), B, H, N, st)) != cudaSuccess)
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
// is recomputed from qkv first (as the TPU kernel recomputes P): o (B*N, C)
// bf16 and stats (B, H, N) fp32 (policy mode float4) are its scratch, and
// dpol_part (B, H, N) fp32 dPolicy's per-head partials (null without
// d_policy). Requires C == 64 * H, N <= 384 (policy mode 352), q_ld and
// q_bstride multiples of 8, 16-byte aligned pointers.
extern "C" int d2s_attention_packed_backward(const void* qkv, long long q_bstride, int q_ld,
                                             const void* g, const void* gcls,
                                             const void* policy, void* dqkv, void* d_policy,
                                             void* o_buf, void* stats_buf, void* dpol_part,
                                             int B, int N, int H, float scale, float eps,
                                             void* stream) {
  using namespace d2s;
  if (B <= 0 || (d_policy != nullptr && (policy == nullptr || dpol_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* pol = static_cast<const float*>(policy);
  cudaError_t err = launch_attention_strided(q, q_bstride, q_ld, static_cast<bf16*>(o_buf),
                                             static_cast<float*>(stats_buf), nullptr, pol, B, N,
                                             H, scale, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention_bwd(q, q_bstride, q_ld, static_cast<const bf16*>(o_buf),
                             static_cast<const bf16*>(g), static_cast<const float*>(stats_buf),
                             pol, static_cast<const float*>(gcls), static_cast<bf16*>(dqkv),
                             d_policy ? static_cast<float*>(dpol_part) : nullptr, B, N, H, scale,
                             eps, st);
  if (err != cudaSuccess || d_policy == nullptr) return (int)err;
  return (int)launch_sum_heads(static_cast<const float*>(dpol_part),
                               static_cast<float*>(d_policy), B, H, N, st);
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
// recomputed, qkv's and proj's dX and dW products, the core's seven score
// products: ~105 GFLOP at B=128, N=197, C=384), as the block's backward is.
// x, g: (B, N, C) bf16; dx (B, N, C) bf16 out. Weights as
// d2s_attention_block_forward takes them (bqkv may be null; bproj is not
// needed); the six gradients fp32 in the weights' shapes (d_bqkv null when
// bqkv is). policy: (B, N) fp32 keep policy or null; d_policy: its (B, N)
// fp32 gradient or null. scratch: d2s_attention_block_backward_scratch_bytes
// bytes. Requires C == 64 * H <= 768, N <= 384 (policy mode 352), 16-byte
// aligned pointers.
extern "C" int d2s_attention_block_backward(
    const void* x, const void* g, void* dx, const void* ln_w, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, void* d_ln_w, void* d_ln_b,
    void* d_wqkv, void* d_bqkv, void* d_wproj, void* d_bproj, const void* policy,
    void* d_policy, void* scratch, int B, int N, int C, int H, float scale, float ln_eps,
    float eps, void* stream) {
  using namespace d2s;
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
                                      pol, B, N, H, scale, eps, st)) != cudaSuccess)
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
  if ((err = launch_attention_bwd(s.qkv, (long long)N * 3 * C, 3 * C, s.attn, s.dattn, s.lse,
                                  pol, nullptr, s.dqkv, d_policy ? s.dpol_part : nullptr, B, N,
                                  H, scale, eps, st)) != cudaSuccess)
    return (int)err;
  if (d_policy &&
      (err = launch_sum_heads(s.dpol_part, fo(d_policy), B, H, N, st)) != cudaSuccess)
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
// C % 32 == 0, C <= 768, hidden % 8 == 0, 16-byte aligned pointers.
extern "C" int d2s_mlp_residual_backward(const void* x, const void* g, void* dx,
                                         const void* ln_w, const void* ln_b, const void* w1,
                                         const void* b1, const void* w2, void* d_ln_w,
                                         void* d_ln_b, void* d_w1, void* d_b1, void* d_w2,
                                         void* d_b2, void* scratch, int M, int C, int hidden,
                                         float ln_eps, void* stream) {
  using namespace d2s;
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
