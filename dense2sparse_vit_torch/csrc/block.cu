// Whole pre-norm transformer block, forward, for sm_90a.
//
// Replaces dense2sparse_vit_tpu/ops/pallas/block.py::fused_transformer_block
// (kernel body `_block_kernel`) in its plain and its policy mode, with its
// `return_cls` output and its DropPath branch scales. It computes what
// `_ref_block` defines:
//   x_mid = x + sa[b] * proj(MHA(qkv(LN1 x)))
//   out   = x_mid + sm[b] * fc2(GELU(fc1(LN2 x_mid)))
// where sa, sm are the per-sample (B,) fp32 DropPath scales (Bernoulli(keep)
// / keep, the TPU kernel's `sa_ref`/`sm_ref`), or absent (null): 1, and no
// multiply at all, so that a block without them is bit for bit the same. A
// scale multiplies the branch in the residual GEMM's fp32 epilogue, before
// the residual is added and the sum rounded once (ln_gemm.cuh `row_scale`).
// with an exact row-max softmax in fp32 over the N real columns. The TPU
// kernel's clamped exp(clip(s, -30, 30)) without a row max, its 16-token
// padding with the padded columns subtracted from the denominator, and its
// LayerNorm folded into the weights are TPU layout choices and are not
// carried over: here nothing is padded, so no row's denominator can cancel.
//
// Policy mode (a (B, N) fp32 keep policy, `use_policy` in the TPU kernel)
// computes the softmax of ops/masked_softmax.py::softmax_with_policy: with
// m_i the row's max over all N columns, dropped ones included, and
// a_ij = pol_j + (1 - pol_j) [i = j],
//   e_ij = exp(s_ij - m_i) a_ij,  den_i = sum_j e_ij + eps,
//   out_i = (sum_j e_ij v_j + (eps/N) colsum(V)) / den_i.
// colsum(V) is one reduction per CTA over the V tile already in shared
// memory; the policy row sits beside it.
//
// d2s_block_forward runs these kernels on the caller's stream (each ln_gemm
// with a LayerNorm is preceded by its row-statistics kernel):
//   1. ln_gemm  qkv   = LN1(x) @ Wqkv^T + bqkv              (B*N, 3C)
//   2. attention       per (sample, head, 64-query tile)      (B*N, C)
//   3. ln_gemm  x_mid = x + sa (attn @ Wproj^T + bproj)      (B*N, C)
//   4. ln_gemm  h     = GELU(LN2(x_mid) @ W1^T + b1)         (B*N, 4C)
//   5. ln_gemm  out   = x_mid + sm (h @ W2^T + b2)           (B*N, C)
// Three outputs are optional, each written only where its pointer is not
// null, so that the serving path pays nothing for them:
//   cls     (B, H, N) bf16: the CLS (query 0) row of each head's attention
//           probabilities, the TPU kernel's `return_cls` output (in policy
//           mode (e_0j + eps/N) / den_0). The CTA of the first query tile
//           already holds that row's max and sum; once the sum is known its
//           first warp recomputes row 0's scores and writes them normalised
//           (one extra pass over the keys for one warp of one CTA per
//           sample-head).
//   lse     what the backward (block_bwd.cu) needs to rebuild the
//           probabilities: in plain mode (B, H, N) fp32, each row's
//           log-sum-exp of its scaled scores, max + log(sum); in policy
//           mode (B, H, N) float4 (m, den, ties, 0): the max, the
//           denominator, and how many columns reach the max, which the
//           backward's max path splits its gradient among;
//   preact  (B*N, 4C) bf16: the fc1 pre-activation, GELU's input, which the
//           backward needs for GELU'.
// With out == null the fc2 stage is skipped: the backward recomputes the
// forward up to the fc1 activation and has no use for the block's output.
//
// Two stages are also entries of their own, for a training block that
// captures its CLS rows (its qkv and proj products run outside, as torch
// calls): d2s_attention_packed_forward, stage 2 on qkv the caller gives
// (with its own row stride), replaces dense2sparse_vit_tpu/ops/pallas/
// attention.py::fused_attention_packed with return_cls; and
// d2s_mlp_residual_forward, stages 4-5 on their own, replaces
// dense2sparse_vit_tpu/ops/pallas/mlp.py::fused_mlp_residual. The first is
// bound by bytes (qkv read, the output and CLS rows written: ~78 MB at
// B=128, N=197, against ~6 GFLOP of score products), the second by its two
// products (~60 GFLOP at that shape); each runs this file's kernels as they
// run inside the block, with the fc1 activation through device memory.
// Stages 1-3 together are d2s_attention_block_forward, the attention
// half-block x + proj(MHA(qkv(LN1 x))), which replaces dense2sparse_vit_tpu/
// ops/pallas/attention.py::fused_attention_block (see its entry below).
//
// What bounds it on the H100: at the headline shapes (B=256, C=384, N from
// 197 down to 68) the four projections are ~92% of the block's FLOPs and
// are tensor-core bound in principle, but this first version's GEMM
// (mma.sync fed by a cp.async ring, not wgmma) reaches a fraction of the
// card's bf16 rate. The intermediates qkv, attn, x_mid and the (B*N, 4C)
// fc1 activation go through device memory (about 21 bf16 reads and writes
// per element of x, against 2 for the TPU kernel, which keeps them in
// VMEM). A faster design fuses fc1 -> GELU -> fc2 so the hidden activation
// stays on chip, fuses the attention output into the proj GEMM, and moves
// the GEMMs to TMA + wgmma pipelines. Policy mode adds a multiply per score
// and the colsum: its time is the plain mode's at the same N.
//
// Attention: one CTA of 4 warps per (sample, head, 64-row query tile); each
// warp owns 16 query rows. The sample-head's K (row-major) and V (stored
// transposed) for all N <= 800 keys sit in shared memory. The products run
// on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the PTX ISA's
// documented fragment layouts, so the scores never leave registers: a
// first pass over the keys takes each row's maximum, a second recomputes
// the scores, exponentiates them against that maximum and multiplies the
// bf16 probabilities (the score accumulators repacked as A fragments)
// into V; the rows are divided by their fp32 sums at the end. The scores
// of the first pass are bit for bit those of the backward's query-row pass
// (the same mma.sync on the same fragments), so the backward finds the
// columns that reach the max by comparing with the stored max.
#include "ln_gemm.cuh"

namespace d2s {

constexpr int ATT_HD = 64;
constexpr int ATT_BQ = 64;
constexpr int ATT_THREADS = 128;
constexpr int ATT_LDK = ATT_HD + 8;  // bf16 pitch of Q and K rows
constexpr int ATT_MAX_N = 800;       // keeps shared memory under 227 KB

__host__ __device__ inline int att_padded(int n) { return (n + 15) / 16 * 16; }

static size_t att_smem_bytes(int n, bool policy) {
  const size_t np = att_padded(n);
  size_t bytes = ((size_t)ATT_BQ * ATT_LDK + np * ATT_LDK + (size_t)ATT_HD * (np + 8)) * 2;
  if (policy) bytes += (np + ATT_HD) * sizeof(float);  // the policy row, colsum(V)
  return bytes;
}

// s[e] of a 16 x 8 score tile: rows g (e < 2) and g + 8, columns 2t + (e & 1)
// of the 8-key block; (max, ties) of a row, merged across a quad
__device__ __forceinline__ void max_count(float v, float& m, float& c) {
  if (v > m) {
    m = v;
    c = 1.f;
  } else if (v == m) {
    c += 1.f;
  }
}

template <bool POLICY>
static __global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const bf16* __restrict__ qkv, long long q_bstride, int q_ld,
                     bf16* __restrict__ out, float* __restrict__ lse, bf16* __restrict__ cls,
                     const float* __restrict__ pol, int N, int H, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = att_padded(N);
  const int ldt = np + 8;  // bf16 pitch of the transposed V rows
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + ATT_BQ * ATT_LDK;
  bf16* Vt = Ks + np * ATT_LDK;
  float* Ps = reinterpret_cast<float*>(Vt + ATT_HD * ldt);  // policy mode: pol_j
  float* Cv = Ps + np;                                      // policy mode: colsum(V)

  const int C = H * ATT_HD;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * ATT_BQ;
  const int tid = threadIdx.x;
  const bf16* base = qkv + (long long)b * q_bstride + h * ATT_HD;

  // rows past N are zero: padded keys score 0 and are masked below, padded
  // V columns then multiply zero probabilities by zero
  constexpr int VPR = ATT_HD / 8;  // 16-byte vectors per head row
  for (int v = tid; v < ATT_BQ * VPR; v += ATT_THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N) val = *reinterpret_cast<const uint4*>(base + (long long)(q0 + r) * q_ld + c);
    *reinterpret_cast<uint4*>(Qs + r * ATT_LDK + c) = val;
  }
  for (int v = tid; v < np * VPR; v += ATT_THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r < N) {
      const bf16* row = base + (long long)r * q_ld + c;
      kv = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(Ks + r * ATT_LDK + c) = kv;
    const bf16* e = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(c + j) * ldt + r] = e[j];
  }
  if (POLICY)
    for (int r = tid; r < np; r += ATT_THREADS) Ps[r] = r < N ? pol[(long long)b * N + r] : 0.f;
  __syncthreads();
  if (POLICY) {
    if (tid < ATT_HD) {
      float acc = 0.f;
      for (int r = 0; r < N; ++r) acc += __bfloat162float(Vt[tid * ldt + r]);
      Cv[tid] = acc;
    }
    __syncthreads();
  }

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (tid >> 5) * 16;

  uint32_t qa[ATT_HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < ATT_HD / 16; ++kk) {
    const bf16* p = Qs + (row0 + g) * ATT_LDK + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * ATT_LDK);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * ATT_LDK + 8);
  }

  // pass 1: each row's largest score over the N real keys (policy mode:
  // the scaled scores' max, and how many columns reach it)
  float mx0 = -INFINITY, mx1 = -INFINITY;  // rows g and g + 8
  float ct0 = 0.f, ct1 = 0.f;
  for (int n0 = 0; n0 < np; n0 += 8) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* kp = Ks + (n0 + g) * ATT_LDK + 2 * t;
#pragma unroll
    for (int kk = 0; kk < ATT_HD / 16; ++kk)
      mma_16816(s, qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    const int col = n0 + 2 * t;
    if (POLICY) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + (e & 1) < N) {
          const float v = s[e] * scale;
          if (e < 2) max_count(v, mx0, ct0);
          else max_count(v, mx1, ct1);
        }
      }
    } else {
      if (col < N) {
        mx0 = fmaxf(mx0, s[0]);
        mx1 = fmaxf(mx1, s[2]);
      }
      if (col + 1 < N) {
        mx0 = fmaxf(mx0, s[1]);
        mx1 = fmaxf(mx1, s[3]);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float m0 = __shfl_xor_sync(0xffffffffu, mx0, o);
    const float m1 = __shfl_xor_sync(0xffffffffu, mx1, o);
    if (POLICY) {
      const float c0 = __shfl_xor_sync(0xffffffffu, ct0, o);
      const float c1 = __shfl_xor_sync(0xffffffffu, ct1, o);
      if (m0 > mx0) ct0 = c0; else if (m0 == mx0) ct0 += c0;
      if (m1 > mx1) ct1 = c1; else if (m1 == mx1) ct1 += c1;
    }
    mx0 = fmaxf(mx0, m0);
    mx1 = fmaxf(mx1, m1);
  }
  if (!POLICY) {
    mx0 *= scale;  // scale > 0, so the max of the scaled scores
    mx1 *= scale;
  }

  // pass 2: p = exp(scale * s - max) (times a_ij in policy mode), O += p V,
  // l += p
  const int qr0 = q0 + row0 + g;  // this thread's two query rows
  const int qr1 = qr0 + 8;
  float o[ATT_HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < ATT_HD / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < np; k0 += 16) {
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kp = Ks + (k0 + 8 * j + g) * ATT_LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < ATT_HD / 16; ++kk)
        mma_16816(s, qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float v = col < N ? __expf(s[e] * scale - (e < 2 ? mx0 : mx1)) : 0.f;
        if (POLICY && col < N) {
          const float pc = Ps[col];
          v *= col == (e < 2 ? qr0 : qr1) ? pc + (1.f - pc) : pc;
        }
        p[j][e] = v;
      }
      l0 += p[j][0] + p[j][1];
      l1 += p[j][2] + p[j][3];
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int nd = 0; nd < ATT_HD / 8; ++nd) {
      const bf16* vp = Vt + (nd * 8 + g) * ldt + k0 + 2 * t;
      mma_16816(o[nd], pa, ld32(vp), ld32(vp + 8));
    }
  }
#pragma unroll
  for (int s = 1; s < 4; s <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, s);
    l1 += __shfl_xor_sync(0xffffffffu, l1, s);
  }
  const float cc = POLICY ? eps / N : 0.f;  // the smoothing's share per column
  if (POLICY) {
    l0 += eps;
    l1 += eps;
#pragma unroll
    for (int nd = 0; nd < ATT_HD / 8; ++nd) {
      const float c0 = cc * Cv[nd * 8 + 2 * t], c1 = cc * Cv[nd * 8 + 2 * t + 1];
      o[nd][0] += c0;
      o[nd][1] += c1;
      o[nd][2] += c0;
      o[nd][3] += c1;
    }
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  const int q = qr0;
  const long long stat = (long long)blockIdx.y * N;  // (b, h) row of lse and cls
  if (lse && t == 0) {
    if (POLICY) {
      float4* st4 = reinterpret_cast<float4*>(lse);
      if (q < N) st4[stat + q] = make_float4(mx0, l0, ct0, 0.f);
      if (q + 8 < N) st4[stat + q + 8] = make_float4(mx1, l1, ct1, 0.f);
    } else {
      if (q < N) lse[stat + q] = mx0 + logf(l0);
      if (q + 8 < N) lse[stat + q + 8] = mx1 + logf(l1);
    }
  }
  if (cls && q0 == 0 && row0 == 0) {
    // query row 0 is row g == 0 of warp 0: recompute its scores, normalise
    for (int n0 = 0; n0 < np; n0 += 8) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kp = Ks + (n0 + g) * ATT_LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < ATT_HD / 16; ++kk)
        mma_16816(s, qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 2 * t + e;
          if (col >= N) continue;
          float v = __expf(s[e] * scale - mx0);
          if (POLICY) {
            const float pc = Ps[col];
            v = v * (col == 0 ? pc + (1.f - pc) : pc) + cc;
          }
          cls[stat + col] = __float2bfloat16(v * inv0);
        }
      }
    }
  }
  bf16* obase = out + (long long)b * N * C + h * ATT_HD + 2 * t;
#pragma unroll
  for (int nd = 0; nd < ATT_HD / 8; ++nd) {
    if (q < N)
      *reinterpret_cast<uint32_t*>(obase + (long long)q * C + nd * 8) =
          pack_bf16(o[nd][0] * inv0, o[nd][1] * inv0);
    if (q + 8 < N)
      *reinterpret_cast<uint32_t*>(obase + (long long)(q + 8) * C + nd * 8) =
          pack_bf16(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

// qkv's token rows lie q_ld elements apart and its samples q_bstride apart
// (both multiples of 8); out is (B*N, C) packed. Also launched by
// block_bwd.cu (the packed backward's recompute).
cudaError_t launch_attention_strided(const bf16* qkv, long long q_bstride, int q_ld, bf16* out,
                                     float* lse, bf16* cls, const float* pol, int B, int N,
                                     int H, float scale, float eps, cudaStream_t stream) {
  if (N <= 0 || N > ATT_MAX_N || q_ld < 3 * H * ATT_HD || q_ld % 8 || q_bstride % 8)
    return cudaErrorInvalidValue;
  const size_t smem = att_smem_bytes(N, pol != nullptr);
  auto kernel = pol ? attention_kernel<true> : attention_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ATT_BQ - 1) / ATT_BQ, B * H);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(qkv, q_bstride, q_ld, out, lse, cls, pol, N, H,
                                              scale, eps);
  return cudaGetLastError();
}

// qkv packed (B*N, 3C); also launched by quant_block.cu (the int8 block's
// bf16 attention core)
cudaError_t launch_attention(const bf16* qkv, bf16* out, float* lse, bf16* cls,
                             const float* pol, int B, int N, int H, float scale, float eps,
                             cudaStream_t stream) {
  const int ld = 3 * H * ATT_HD;
  return launch_attention_strided(qkv, (long long)N * ld, ld, out, lse, cls, pol, B, N, H, scale,
                                  eps, stream);
}

// Stage 1, qkv = LN1(x) Wqkv^T + bqkv over M rows (the rows' LayerNorm
// statistics into stats first); also launched by block_bwd.cu (the
// recompute of the half-block's backward) and attn_variants.cu.
cudaError_t qkv_stage(const bf16* x, bf16* qkv, float2* stats, const float* ln_w,
                      const float* ln_b, const bf16* wqkv, const float* bqkv, int M, int C,
                      float ln_eps, cudaStream_t stream) {
  GemmArgs g{};
  g.a = x;
  g.a_rows = M;
  g.M = M;
  g.w = wqkv;
  g.bias = bqkv;
  g.ln_w = ln_w;
  g.ln_b = ln_b;
  g.ln_eps = ln_eps;
  g.ln_stats = stats;
  g.out = qkv;
  g.N = 3 * C;
  g.K = C;
  g.act = ACT_NONE;
  return launch_ln_gemm(g, stream);
}

// Stage 3, out = x + sa (attn Wproj^T + bproj) over M rows, the branch
// scaled per `rows` rows by sa where sa is not null; also launched by
// attn_variants.cu.
cudaError_t proj_stage(const bf16* x, const bf16* attn, bf16* out, const bf16* wproj,
                       const float* bproj, const float* sa, int rows, int M, int C,
                       cudaStream_t stream) {
  GemmArgs g{};
  g.a = attn;
  g.a_rows = M;
  g.M = M;
  g.w = wproj;
  g.bias = bproj;
  g.residual = x;
  g.row_scale = sa;
  g.scale_rows = rows;
  g.out = out;
  g.N = C;
  g.K = C;
  g.act = ACT_NONE;
  return launch_ln_gemm(g, stream);
}

// Stages 1-3, the attention half x + sa proj(MHA(qkv(LN1 x))) into out
static cudaError_t attention_half(const bf16* x, bf16* out, bf16* qkv, bf16* attn, float2* stats,
                                  const float* ln_w, const float* ln_b, const bf16* wqkv,
                                  const float* bqkv, const bf16* wproj, const float* bproj,
                                  float* lse, bf16* cls, const float* policy, const float* sa,
                                  int B, int N, int C, int H, float scale, float ln_eps,
                                  float eps, cudaStream_t stream) {
  const int M = B * N;
  cudaError_t err = qkv_stage(x, qkv, stats, ln_w, ln_b, wqkv, bqkv, M, C, ln_eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_attention(qkv, attn, lse, cls, policy, B, N, H, scale, eps, stream);
  if (err != cudaSuccess) return err;
  return proj_stage(x, attn, out, wproj, bproj, sa, N, M, C, stream);
}

// The MLP half x + sm fc2(GELU(fc1(LN x))) over M token rows: the
// LayerNorm's row statistics, fc1 with the LN prologue and the GELU
// epilogue into hid (and its input into preact, where not null), then fc2
// with the residual epilogue into out (skipped where out is null); sm: a
// scale per `rows` rows, or null.
static cudaError_t mlp_half(const bf16* x, bf16* out, bf16* hid, bf16* preact, float2* stats,
                            const float* ln_w, const float* ln_b, const bf16* w1,
                            const float* b1, const bf16* w2, const float* b2, int M, int C,
                            int hidden, float ln_eps, const float* sm, int rows,
                            cudaStream_t stream) {
  GemmArgs g{};
  g.a = x;
  g.a_rows = M;
  g.M = M;
  g.w = w1;
  g.bias = b1;
  g.ln_w = ln_w;
  g.ln_b = ln_b;
  g.ln_eps = ln_eps;
  g.ln_stats = stats;
  g.out = hid;
  g.preact = preact;
  g.N = hidden;
  g.K = C;
  g.act = ACT_GELU;
  cudaError_t err = launch_ln_gemm(g, stream);
  if (err != cudaSuccess || out == nullptr) return err;

  g.a = hid;
  g.w = w2;
  g.bias = b2;
  g.ln_w = nullptr;
  g.ln_b = nullptr;
  g.residual = x;
  g.row_scale = sm;
  g.scale_rows = rows;
  g.preact = nullptr;
  g.out = out;
  g.N = C;
  g.K = hidden;
  g.act = ACT_NONE;
  return launch_ln_gemm(g, stream);
}

}  // namespace d2s

using d2s::bf16;

// x, out: (B, N, C) bf16; out may be null (the fc2 stage is then skipped).
// Scratch: qkv (B*N, 3C), attn (B*N, C), mid (B*N, C), hid (B*N, hidden),
// all bf16, and stats (B*N) float2. Optional outputs (null: not written):
// preact (B*N, hidden) bf16, lse (B, H, N) fp32 (policy mode: (B, H, N)
// float4), cls (B, H, N) bf16. policy: (B, N) fp32 keep policy, or null for
// the plain softmax; eps: the policy softmax's smoothing. sa, sm: (B) fp32
// DropPath scales of the attention and the MLP branch, each or both null
// (no scale). Matrices are bf16
// in the torch Linear layout (out, in); LayerNorm parameters and biases are
// fp32; bqkv may be null. Requires C == 64 * H, hidden % 8 == 0, N <= 800,
// 16-byte aligned pointers.
extern "C" int d2s_block_forward(
    const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf, void* hid_buf,
    void* stats_buf, const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ln2_w, const void* ln2_b,
    const void* w1, const void* b1, const void* w2, const void* b2, void* preact, void* lse,
    void* cls, const void* policy, const void* sa, const void* sm, int B, int N, int C, int H,
    int hidden, float scale, float ln_eps, float eps, void* stream) {
  if (C != H * d2s::ATT_HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = d2s::attention_half(
      static_cast<const bf16*>(x), static_cast<bf16*>(mid_buf), static_cast<bf16*>(qkv_buf),
      static_cast<bf16*>(attn_buf), static_cast<float2*>(stats_buf),
      static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const bf16*>(wproj), static_cast<const float*>(bproj),
      static_cast<float*>(lse), static_cast<bf16*>(cls), static_cast<const float*>(policy),
      static_cast<const float*>(sa), B, N, C, H, scale, ln_eps, eps, s);
  if (err != cudaSuccess) return (int)err;
  return (int)d2s::mlp_half(
      static_cast<const bf16*>(mid_buf), static_cast<bf16*>(out), static_cast<bf16*>(hid_buf),
      static_cast<bf16*>(preact), static_cast<float2*>(stats_buf),
      static_cast<const float*>(ln2_w), static_cast<const float*>(ln2_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), B * N, C, hidden, ln_eps, static_cast<const float*>(sm), N,
      s);
}

// The attention half-block alone, out = x + proj(MHA(qkv(LN1 x))): stages
// 1-3 of d2s_block_forward, with out in place of x_mid and no MLP stage.
// Replaces dense2sparse_vit_tpu/ops/pallas/attention.py::
// fused_attention_block (kernel body `_attn_block_kernel`) in its plain and
// policy mode with its `return_cls` output; the plain mode is that
// kernel's `exact=True` softmax (the exact row max over the N real columns),
// whatever the caller asks of the TPU kernel: its clamped fast path has no
// counterpart here. Its LayerNorm folded into the qkv weights, its
// 16-token padding and its VMEM-resident qkv are TPU layout choices; here
// qkv and the attention output go through device memory (~5 bf16 reads and
// writes per element of x besides x and out), and the two products and the
// core run on the kernels of the whole block. Bound by operations: the
// projections (8 B N C^2) and the core (4 B N^2 C), ~75 GFLOP at B=256,
// N=197, C=384.
// x, out: (B, N, C) bf16; scratch qkv (B*N, 3C) and attn (B*N, C) bf16 and
// stats (B*N) float2; lse, cls, policy as d2s_block_forward takes them
// (each may be null); weights bf16 (out, in), LayerNorm and biases fp32,
// bqkv and bproj may be null. Requires C == 64 * H, N <= 800, 16-byte
// aligned pointers.
extern "C" int d2s_attention_block_forward(const void* x, void* out, void* qkv_buf,
                                           void* attn_buf, void* stats_buf, const void* ln_w,
                                           const void* ln_b, const void* wqkv, const void* bqkv,
                                           const void* wproj, const void* bproj, void* lse,
                                           void* cls, const void* policy, int B, int N, int C,
                                           int H, float scale, float ln_eps, float eps,
                                           void* stream) {
  if (B <= 0 || C != H * d2s::ATT_HD || out == nullptr) return (int)cudaErrorInvalidValue;
  return (int)d2s::attention_half(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<bf16*>(qkv_buf),
      static_cast<bf16*>(attn_buf), static_cast<float2*>(stats_buf),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const bf16*>(wproj), static_cast<const float*>(bproj),
      static_cast<float*>(lse), static_cast<bf16*>(cls), static_cast<const float*>(policy),
      nullptr, B, N, C, H, scale, ln_eps, eps, static_cast<cudaStream_t>(stream));
}

// The packed attention core alone (the MHA of a Block whose qkv projection
// runs outside: the CLS-capture route of a training block). qkv: (B, N, 3C)
// bf16 with token rows q_ld elements apart and samples q_bstride apart; out
// (B, N, C) bf16; cls (B, H, N) bf16 or null; policy (B, N) fp32 or null.
// Requires C == 64 * H, N <= 800, q_ld and q_bstride multiples of 8,
// 16-byte aligned pointers.
extern "C" int d2s_attention_packed_forward(const void* qkv, long long q_bstride, int q_ld,
                                            void* out, void* cls, const void* policy, int B,
                                            int N, int H, float scale, float eps, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  return (int)d2s::launch_attention_strided(
      static_cast<const bf16*>(qkv), q_bstride, q_ld, static_cast<bf16*>(out), nullptr,
      static_cast<bf16*>(cls), static_cast<const float*>(policy), B, N, H, scale, eps,
      static_cast<cudaStream_t>(stream));
}

// The MLP half alone, out = x + fc2(GELU(fc1(LN x))), over M = B*N rows: x,
// out (M, C) bf16; scratch hid (M, hidden) bf16 and stats (M) float2;
// weights as d2s_block_forward takes ln2/w1/b1/w2/b2. Requires C and hidden
// multiples of 8, 16-byte aligned pointers.
extern "C" int d2s_mlp_residual_forward(const void* x, void* out, void* hid_buf, void* stats_buf,
                                        const void* ln_w, const void* ln_b, const void* w1,
                                        const void* b1, const void* w2, const void* b2, int M,
                                        int C, int hidden, float ln_eps, void* stream) {
  if (M <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  return (int)d2s::mlp_half(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<bf16*>(hid_buf), nullptr,
      static_cast<float2*>(stats_buf), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      M, C, hidden, ln_eps, nullptr, M, static_cast<cudaStream_t>(stream));
}
