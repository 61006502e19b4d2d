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
// The (eps/N) colsum(V) term rides in P.V (see the attention note below);
// the policy row sits in shared memory beside K and V.
//
// d2s_block_forward runs these kernels on the caller's stream (each ln_gemm
// with a LayerNorm is preceded by its row-statistics kernel):
//   1. ln_gemm  qkv   = LN1(x) @ Wqkv^T + bqkv              (B*N, 3C)
//   2. attention       per (sample, head[, query slice])      (B*N, C)
//   3. ln_gemm  x_mid = x + sa (attn @ Wproj^T + bproj)      (B*N, C)
//   4. ln_gemm  h     = GELU(LN2(x_mid) @ W1^T + b1)         (B*N, 4C)
//   5. ln_gemm  out   = x_mid + sm (h @ W2^T + b2)           (B*N, C)
// Three outputs are optional, each written only where its pointer is not
// null, so that the serving path pays nothing for them:
//   cls     (B, H, N) bf16: the CLS (query 0) row of each head's attention
//           probabilities, the TPU kernel's `return_cls` output (in policy
//           mode (e_0j + eps/N) / den_0). The warp of the first query tile
//           already holds that row's max and sum; once the sum is known it
//           recomputes row 0's scores and writes them normalised (one
//           extra pass over the keys for one warp per sample-head).
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
// 197 down to 68) the four projections are ~92% of the block's FLOPs,
// tensor-core bound, on ln_gemm.cuh's TMA + wgmma engine (its notes). The
// intermediates qkv, attn, x_mid and the (B*N, 4C) fc1 activation go
// through device memory (about 21 bf16 reads and writes per element of x,
// against 2 for the TPU kernel, which keeps them in VMEM), and each stage
// is a launch of its own. A faster design fuses fc1 -> GELU -> fc2 so the
// hidden activation stays on chip and fuses the attention output into the
// proj GEMM. Policy mode adds to the attention core a multiply and an add
// per score and the count of the ties.
//
// Attention, what bounds it: bytes. At B=128, N=197 the core reads qkv
// (~58 MB) and writes its output (~19 MB) and the CLS rows, ~0.023 ms at
// 3.35 TB/s, while its score and P.V products come to ~7.6 GFLOP, a third
// of that time at the bf16 peak. So the design moves each byte once and
// keeps the tensor cores fed from shared memory:
//   - one CTA of 4 warps holds one sample-head's K and V (all N <= 800
//     keys; a longer sequence takes attention_hd_kernel at DP = 64, and its
//     backward attention_hd_bwd_kernel: attention_hd.cuh), copied once from
//     device memory by 16-byte cp.async in two commit groups, K then V, so
//     that the first query tiles' pass 1 (which needs only K) runs while V
//     is still arriving;
//   - the rows lie in shared memory as they lie in qkv, 64 bf16 wide and
//     unpadded, with the 16-byte chunk c of row r stored at chunk
//     c ^ (r & 7): the eight rows an ldmatrix reads fall on eight different
//     bank groups, so K's fragments (ldmatrix.x4) and V's transposed ones
//     for P.V (ldmatrix.x4.trans) load without bank conflicts and no
//     transposed copy of V is made (2 * 800 * 64 * 2 B fits with the policy
//     row, where a padded pitch would not);
//   - the warps walk 16-row query tiles, ceil(N / 16) of them (13 at N=197),
//     two at a time (the last alone where the count is odd), so that each K
//     and V fragment loaded from shared memory feeds two tiles' products;
//     each warp stages its next tiles' Q by cp.async while it works on the
//     current ones; the keys go by in blocks of 16, whose four score chains
//     (two 8-key halves, two tiles) are issued interleaved, and only the
//     last block, where it reaches past N, masks columns;
//   - the grid is (S, B*H): S query slices per sample-head, chosen on the
//     host from B*H and the CTAs that fit on an SM so that the grid covers
//     the SMs (S = 1 at B >= 64 with 6 heads; more at B = 1 or 8, where one
//     CTA per sample-head would leave most SMs idle).
// The products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the
// PTX ISA's fragment layouts, so the scores never leave registers: a first
// pass over the keys takes each row's maximum, a second recomputes the
// scores, exponentiates them against that maximum and multiplies the bf16
// probabilities (the score accumulators repacked as A fragments) into V;
// the rows are divided by their fp32 sums at the end (the exponentials as
// 2^x of scores pre-scaled by log2 e). The scores of the
// first pass are bit for bit those of the backward's query-row pass (the
// same mma.sync in the same kk order on the same fragment bits: ldmatrix
// gives what a 32-bit load of the same pair gives), so the backward finds
// the columns that reach the max by comparing with the stored max. In
// policy mode the smoothing eps/N rides in the probabilities fed to P.V
// (p_ij + eps/N for every real column j), which adds (eps/N) colsum(V)
// without a pass of its own.
// What still holds it back (B=128, N=197 on the H100): ~0.064 ms, where
// scaled_dot_product_attention takes ~0.046, against ~0.023 ms of bytes.
// Its tensor work is 1.5 times a one-pass kernel's
// (pass 1 recomputes the scores, which the bit-identical max asks for) on
// mma.sync at ~200 TFLOP/s; 168 registers leave 12 warps on an SM; and 13
// query tiles on 4 warps keep a CTA's K and V resident for 4 tiles' time
// while one warp has 3.
#include "attention_hd.cuh"

#include <algorithm>
#include <type_traits>

namespace d2s {

constexpr int ATT_HD = 64;
constexpr int ATT_WARPS = 4;
constexpr int ATT_THREADS = 32 * ATT_WARPS;
constexpr int ATT_QT = 2;        // 16-row query tiles a warp carries at once
// K and V of ATT_SHORT_N (attention_hd.cuh) keys stay under 227 KB; longer
// d = 64 heads take attention_hd_kernel
constexpr int ATT_CHUNKS = ATT_HD / 8;  // 16-byte chunks of a head row

__host__ __device__ inline int att_padded(int n) { return (n + 15) / 16 * 16; }

static size_t att_smem_bytes(int n, bool policy) {
  const size_t np = att_padded(n);
  size_t bytes = (2 * np + (size_t)ATT_WARPS * ATT_QT * 16) * ATT_HD * 2;  // K, V, the warps' Q
  if (policy) bytes += np * sizeof(float);  // the policy row
  return bytes;
}

// element offset of chunk c of row r in a swizzled [row][64] bf16 tile
__device__ __forceinline__ int att_swz(int r, int c) {
  return r * ATT_HD + ((c ^ (r & 7)) << 3);
}

// the A fragments of the warp's query tiles from its Q buffer
__device__ __forceinline__ void att_load_q(uint32_t (&qa)[ATT_QT][ATT_HD / 16][4],
                                           const bf16* Qw, int lane) {
#pragma unroll
  for (int qt = 0; qt < ATT_QT; ++qt)
#pragma unroll
    for (int kk = 0; kk < ATT_HD / 16; ++kk)
      ldmatrix_x4(qa[qt][kk], Qw + att_swz(qt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                           2 * kk + (lane >> 4)));
}

// the B fragments of keys n0..n0+7 for the score product: kb[kk / 2][2 (kk % 2)]
// and kb[kk / 2][2 (kk % 2) + 1] are head dims 16 kk + (0..7) and + (8..15)
__device__ __forceinline__ void att_load_k(uint32_t (&kb)[2][4], const bf16* Ks, int n0,
                                           int lane) {
  ldmatrix_x4(kb[0], Ks + att_swz(n0 + (lane & 7), lane >> 3));
  ldmatrix_x4(kb[1], Ks + att_swz(n0 + (lane & 7), 4 + (lane >> 3)));
}

// s[j][qt] = q . k for keys n0 + 8 j + (0..7) of the first NQ query tiles:
// 2 NQ independent chains of products, each in the kk order the backward
// uses (from zero, kk = 0..3)
template <int NQ>
__device__ __forceinline__ void att_scores16(float (&s)[2][ATT_QT][4],
                                             const uint32_t (&qa)[ATT_QT][ATT_HD / 16][4],
                                             const bf16* Ks, int n0, int lane) {
  uint32_t kb[2][2][4];
  att_load_k(kb[0], Ks, n0, lane);
  att_load_k(kb[1], Ks, n0 + 8, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) s[j][qt][0] = s[j][qt][1] = s[j][qt][2] = s[j][qt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < ATT_HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int qt = 0; qt < NQ; ++qt)
        mma_16816(s[j][qt], qa[qt][kk], kb[j][kk >> 1][2 * (kk & 1)],
                  kb[j][kk >> 1][2 * (kk & 1) + 1]);
}

// pass 1 over keys n0..n0+15: each row's largest score (policy mode: the
// scaled scores' max, and how many columns reach it); EDGE: the block holds
// columns past N, which are left out
template <int NQ, bool POLICY, bool EDGE>
__device__ __forceinline__ void att_max16(float (&mx)[ATT_QT][2], float (&ct)[ATT_QT][2],
                                          const uint32_t (&qa)[ATT_QT][ATT_HD / 16][4],
                                          const bf16* Ks, int n0, int N, float scale, int lane) {
  float s[2][ATT_QT][4];
  att_scores16<NQ>(s, qa, Ks, n0, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EDGE && n0 + 8 * j + 2 * (lane & 3) + (e & 1) >= N) continue;
        if (POLICY) {
          const float v = s[j][qt][e] * scale;
          max_count(v, mx[qt][e >> 1], ct[qt][e >> 1]);
        } else {
          mx[qt][e >> 1] = fmaxf(mx[qt][e >> 1], s[j][qt][e]);
        }
      }
}

// pass 2 over keys k0..k0+15: p = 2^(s scale log2 e - max log2 e) (policy
// mode: times a_ij, the smoothing eps/N added for P.V), l += p, O += p V.
// ml: the rows' max times log2 e; query rows row0 + 16 qt + {0, 8}; EDGE as
// above. RES: lb += the bf16 p that P.V takes, for attention_kernel's
// out_res.
template <int NQ, bool POLICY, bool EDGE, bool RES>
__device__ __forceinline__ void att_pv16(float (&o)[ATT_QT][ATT_HD / 8][4], float (&l)[ATT_QT][2],
                                         float (&lb)[ATT_QT][2],
                                         const uint32_t (&qa)[ATT_QT][ATT_HD / 16][4],
                                         const float (&ml)[ATT_QT][2], const bf16* Ks,
                                         const bf16* Vs, const float* Ps, int k0, int N,
                                         float sl2, float cc, int row0, int lane) {
  float s[2][ATT_QT][4];
  att_scores16<NQ>(s, qa, Ks, k0, lane);
  uint32_t pa[ATT_QT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c0 = k0 + 8 * j + 2 * (lane & 3);  // this thread's columns c0, c0 + 1
    float2 pc = make_float2(0.f, 0.f);
    if (POLICY) pc = *reinterpret_cast<const float2*>(Ps + c0);  // zero past N
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + (e & 1);
        p[e] = (!EDGE || col < N) ? att_exp2(s[j][qt][e] * sl2 - ml[qt][e >> 1]) : 0.f;
      }
      if (POLICY) {
        // a_ij = pol_j, and pol_j + (1 - pol_j) on the diagonal, which lies
        // in the key block that starts where the tile does
        if (k0 == row0 - (lane >> 2) + 16 * qt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float a = (e & 1) ? pc.y : pc.x;
            p[e] *= c0 + (e & 1) == row0 + 16 * qt + 8 * (e >> 1) ? a + (1.f - a) : a;
          }
        } else {
          p[0] *= pc.x;
          p[1] *= pc.y;
          p[2] *= pc.x;
          p[3] *= pc.y;
        }
      }
      l[qt][0] += p[0] + p[1];
      l[qt][1] += p[2] + p[3];
      if (POLICY) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!EDGE || c0 + (e & 1) < N) p[e] += cc;
      }
      pa[qt][2 * j] = pack_bf16(p[0], p[1]);
      pa[qt][2 * j + 1] = pack_bf16(p[2], p[3]);
      if (RES) {
        const float2 p01 = bf16x2_to_float2(pa[qt][2 * j]);
        const float2 p23 = bf16x2_to_float2(pa[qt][2 * j + 1]);
        lb[qt][0] += p01.x + p01.y;
        lb[qt][1] += p23.x + p23.y;
      }
    }
  }
#pragma unroll
  for (int nd = 0; nd < ATT_HD / 8; nd += 2) {
    uint32_t vb[4];
    ldmatrix_x4_trans(vb, Vs + att_swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       nd + (lane >> 4)));
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
      mma_16816(o[qt][nd], pa[qt], vb[0], vb[1]);
      mma_16816(o[qt][nd + 1], pa[qt], vb[2], vb[3]);
    }
  }
}

template <int V>
using att_int = std::integral_constant<int, V>;

template <bool POLICY, bool RES>
static __global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const bf16* __restrict__ qkv, long long q_bstride, int q_ld,
                     bf16* __restrict__ out, bf16* __restrict__ out_res, float* __restrict__ lse,
                     bf16* __restrict__ cls, const float* __restrict__ pol, int N, int H,
                     float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = att_padded(N);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + np * ATT_HD;
  bf16* Qs = Vs + np * ATT_HD;  // per warp ATT_QT x 16 query rows
  float* Ps = reinterpret_cast<float*>(Qs + ATT_WARPS * ATT_QT * 16 * ATT_HD);  // pol_j

  const int C = H * ATT_HD;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* base = qkv + (long long)b * q_bstride + h * ATT_HD;
  bf16* Qw = Qs + warp * ATT_QT * 16 * ATT_HD;

  // units of ATT_QT query tiles (the last may hold fewer); this CTA's slice
  // of them, dealt to its warps in turn
  const int tiles = np / 16;
  const int units = (tiles + ATT_QT - 1) / ATT_QT;
  const int u_end = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  int u = (int)((long long)blockIdx.x * units / gridDim.x) + warp;

  // rows past N are zero-filled: padded keys score 0 and are masked below,
  // padded V rows then multiply zero probabilities by zero
  auto copy_q = [&](int unit) {
    for (int i = lane; i < ATT_QT * 16 * ATT_CHUNKS; i += 32) {
      const int r = i / ATT_CHUNKS, c = i % ATT_CHUNKS;
      const int q = unit * ATT_QT * 16 + r;
      cp_async16(Qw + att_swz(r, c), base + (long long)(q < N ? q : 0) * q_ld + c * 8, q < N);
    }
  };
  if (u < u_end) copy_q(u);
  for (int i = tid; i < np * ATT_CHUNKS; i += ATT_THREADS) {
    const int r = i / ATT_CHUNKS, c = i % ATT_CHUNKS;
    cp_async16(Ks + att_swz(r, c), base + (long long)(r < N ? r : 0) * q_ld + C + c * 8, r < N);
  }
  cp_async_commit();  // group: this warp's first Q tiles and K
  for (int i = tid; i < np * ATT_CHUNKS; i += ATT_THREADS) {
    const int r = i / ATT_CHUNKS, c = i % ATT_CHUNKS;
    cp_async16(Vs + att_swz(r, c), base + (long long)(r < N ? r : 0) * q_ld + 2 * C + c * 8,
               r < N);
  }
  cp_async_commit();  // group: V
  if (POLICY)
    for (int r = tid; r < np; r += ATT_THREADS) Ps[r] = r < N ? pol[(long long)b * N + r] : 0.f;
  cp_async_wait<1>();
  __syncthreads();  // K and every warp's first Q in

  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = scale * LOG2E;
  const float cc = POLICY ? eps / N : 0.f;  // the smoothing's share per column
  const long long stat = (long long)blockIdx.y * N;  // (b, h) row of lse and cls
  uint32_t qa[ATT_QT][ATT_HD / 16][4];
  float mx[ATT_QT][2], ct[ATT_QT][2];

  // take the current unit's Q fragments, start copying the next unit's Q
  auto take_q = [&]() {
    att_load_q(qa, Qw, lane);
    __syncwarp();
    if (u + ATT_WARPS < u_end) copy_q(u + ATT_WARPS);
  };
  // pass 1 for NQ query tiles: each row's max over the N real keys, merged
  // across the quad
  auto pass1 = [&](auto nq) {
    constexpr int NQ = decltype(nq)::value;
#pragma unroll
    for (int qt = 0; qt < ATT_QT; ++qt) {
      mx[qt][0] = mx[qt][1] = -INFINITY;
      ct[qt][0] = ct[qt][1] = 0.f;
    }
    for (int n0 = 0; n0 < np; n0 += 16) {
      if (n0 + 16 <= N) att_max16<NQ, POLICY, false>(mx, ct, qa, Ks, n0, N, scale, lane);
      else att_max16<NQ, POLICY, true>(mx, ct, qa, Ks, n0, N, scale, lane);
    }
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m = __shfl_xor_sync(0xffffffffu, mx[qt][r], o);
          if (POLICY) {
            const float c = __shfl_xor_sync(0xffffffffu, ct[qt][r], o);
            if (m > mx[qt][r]) ct[qt][r] = c;
            else if (m == mx[qt][r]) ct[qt][r] += c;
          }
          mx[qt][r] = fmaxf(mx[qt][r], m);
        }
      }
      if (!POLICY) {
        mx[qt][0] *= scale;  // scale > 0, so the max of the scaled scores
        mx[qt][1] *= scale;
      }
    }
  };
  // pass 2 for NQ query tiles and the unit's outputs
  auto pass2 = [&](auto nq) {
    constexpr int NQ = decltype(nq)::value;
    float o[ATT_QT][ATT_HD / 8][4];
    float l[ATT_QT][2], lb[ATT_QT][2], ml[ATT_QT][2];
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
      l[qt][0] = l[qt][1] = 0.f;
      lb[qt][0] = lb[qt][1] = 0.f;
      ml[qt][0] = mx[qt][0] * LOG2E;
      ml[qt][1] = mx[qt][1] * LOG2E;
#pragma unroll
      for (int nd = 0; nd < ATT_HD / 8; ++nd)
        o[qt][nd][0] = o[qt][nd][1] = o[qt][nd][2] = o[qt][nd][3] = 0.f;
    }
    const int row0 = u * ATT_QT * 16 + g;  // this thread's rows: row0 + 16 qt + {0, 8}
    for (int k0 = 0; k0 < np; k0 += 16) {
      if (k0 + 16 <= N)
        att_pv16<NQ, POLICY, false, RES>(o, l, lb, qa, ml, Ks, Vs, Ps, k0, N, sl2, cc, row0,
                                         lane);
      else
        att_pv16<NQ, POLICY, true, RES>(o, l, lb, qa, ml, Ks, Vs, Ps, k0, N, sl2, cc, row0,
                                        lane);
    }

#pragma unroll
    for (int qt = 0; qt < NQ; ++qt) {
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        l[qt][0] += __shfl_xor_sync(0xffffffffu, l[qt][0], sh);
        l[qt][1] += __shfl_xor_sync(0xffffffffu, l[qt][1], sh);
        if (RES) {
          lb[qt][0] += __shfl_xor_sync(0xffffffffu, lb[qt][0], sh);
          lb[qt][1] += __shfl_xor_sync(0xffffffffu, lb[qt][1], sh);
        }
      }
      if (POLICY) {
        l[qt][0] += eps;
        l[qt][1] += eps;
      }
      const float inv0 = 1.f / l[qt][0], inv1 = 1.f / l[qt][1];
      const int q = row0 + 16 * qt;
      if (lse && t == 0) {
        if (POLICY) {
          float4* st4 = reinterpret_cast<float4*>(lse);
          if (q < N) st4[stat + q] = make_float4(mx[qt][0], l[qt][0], ct[qt][0], 0.f);
          if (q + 8 < N) st4[stat + q + 8] = make_float4(mx[qt][1], l[qt][1], ct[qt][1], 0.f);
        } else {
          if (q < N) lse[stat + q] = mx[qt][0] + logf(l[qt][0]);
          if (q + 8 < N) lse[stat + q + 8] = mx[qt][1] + logf(l[qt][1]);
        }
      }
      if (cls && q - g == 0) {
        // query row 0 is row g == 0 of the first tile: recompute its
        // scores, normalise
        for (int n0 = 0; n0 < np; n0 += 16) {
          float s[2][ATT_QT][4];
          att_scores16<1>(s, qa, Ks, n0, lane);
          if (g == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n0 + 8 * (e >> 1) + 2 * t + (e & 1);
              if (col >= N) continue;
              float v = att_exp2(s[e >> 1][0][e & 1] * sl2 - ml[0][0]);
              if (POLICY) {
                const float pc = Ps[col];
                v = v * (col == 0 ? pc + (1.f - pc) : pc) + cc;
              }
              cls[stat + col] = __float2bfloat16(v * inv0);
            }
          }
        }
      }
      const long long oat = (long long)b * N * C + h * ATT_HD + 2 * t;
#pragma unroll
      for (int nd = 0; nd < ATT_HD / 8; ++nd) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (q + 8 * r >= N) continue;
          const float inv = r ? inv1 : inv0;
          const float lo = o[qt][nd][2 * r] * inv, hi = o[qt][nd][2 * r + 1] * inv;
          const uint32_t v = pack_bf16(lo, hi);
          const long long at = oat + (long long)(q + 8 * r) * C + nd * 8;
          *reinterpret_cast<uint32_t*>(out + at) = v;
          if (RES) {  // O normalised by the bf16 probabilities P.V took, less v
            const float ib = 1.f / lb[qt][r];
            *reinterpret_cast<uint32_t*>(out_res + at) =
                pack_bf16_residual(o[qt][nd][2 * r] * ib, o[qt][nd][2 * r + 1] * ib, v);
          }
        }
      }
    }
  };
  // a unit of ATT_QT tiles, or the last, single tile of an odd count
  auto full = [&]() { return u * ATT_QT + ATT_QT <= tiles; };

  if (u < u_end) take_q();
  cp_async_commit();  // group: the next unit's Q (empty where there is none)
  if (u < u_end) {
    if (full()) pass1(att_int<ATT_QT>{});
    else pass1(att_int<1>{});
  }
  cp_async_wait<1>();
  __syncthreads();  // V in
  if (u >= u_end) return;

  for (;;) {
    if (full()) pass2(att_int<ATT_QT>{});
    else pass2(att_int<1>{});
    u += ATT_WARPS;
    if (u >= u_end) break;
    cp_async_wait<0>();
    __syncwarp();  // the next unit's Q in, from every lane's copies
    take_q();
    cp_async_commit();
    if (full()) pass1(att_int<ATT_QT>{});
    else pass1(att_int<1>{});
  }
}

// qkv's token rows lie q_ld elements apart and its samples q_bstride apart
// (both multiples of 8); out is (B*N, C) packed, C = H d. Heads of d = 64
// up to ATT_SHORT_N tokens take attention_kernel, longer ones and every
// other d up to 256 attention_hd_kernel (att_on_hd; its lse is always
// float4), up to hd_max_tokens. Also launched by block_bwd.cu (the
// backwards' recompute), which takes out_res: where not null, (B*N, C)
// bf16, the output's P.V normalised by the sum of the bf16 probabilities
// it took, less out (their sum is that output to ~2^-17 of its size), so
// that the backward's D = rowsum(dO * (out + out_res)) is sum_j p_ij dP_ij
// with probabilities that sum to 1 (the kernels' RES instantiations).
cudaError_t launch_attention_strided(const bf16* qkv, long long q_bstride, int q_ld, bf16* out,
                                     float* lse, bf16* cls, const float* pol, int B, int N,
                                     int H, int d, float scale, float eps, cudaStream_t stream,
                                     bf16* out_res = nullptr) {
  if (!att_takes(N, d, pol != nullptr, false) || q_ld < 3 * H * d || q_ld % 8 || q_bstride % 8)
    return cudaErrorInvalidValue;
  if (att_on_hd(N, d))
    return launch_attention_hd(qkv, q_bstride, q_ld, d, out, out_res, lse, cls, pol, B, N, H,
                               scale, eps, stream);
  const size_t smem = att_smem_bytes(N, pol != nullptr);
  auto kernel = pol ? (out_res ? attention_kernel<true, true> : attention_kernel<true, false>)
                    : (out_res ? attention_kernel<false, true> : attention_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // query slices per sample-head: enough CTAs to cover the SMs, at most one
  // per unit of query tiles
  int dev = 0, sms = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, ATT_THREADS, smem)) !=
          cudaSuccess)
    return err;
  const int units = (att_padded(N) / 16 + ATT_QT - 1) / ATT_QT;
  const int slices = std::max(1, std::min(units, sms * std::max(fit, 1) / (B * H)));
  const dim3 grid(slices, B * H);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(qkv, q_bstride, q_ld, out, out_res, lse, cls, pol,
                                              N, H, scale, eps);
  return cudaGetLastError();
}

// qkv packed (B*N, 3C); also launched by quant_block.cu (the int8 block's
// bf16 attention core); out_res as launch_attention_strided's
cudaError_t launch_attention(const bf16* qkv, bf16* out, float* lse, bf16* cls,
                             const float* pol, int B, int N, int H, int d, float scale, float eps,
                             cudaStream_t stream, bf16* out_res = nullptr) {
  const int ld = 3 * H * d;
  return launch_attention_strided(qkv, (long long)N * ld, ld, out, lse, cls, pol, B, N, H, d,
                                  scale, eps, stream, out_res);
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
                                  float eps, cudaStream_t stream, bf16* attn_res = nullptr) {
  const int M = B * N;
  cudaError_t err = qkv_stage(x, qkv, stats, ln_w, ln_b, wqkv, bqkv, M, C, ln_eps, stream);
  if (err != cudaSuccess) return err;
  err = launch_attention(qkv, attn, lse, cls, policy, B, N, H, C / H, scale, eps, stream,
                         attn_res);
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

int block_forward(const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf,
                  void* hid_buf, void* stats_buf, const void* ln1_w, const void* ln1_b,
                  const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
                  const void* ln2_w, const void* ln2_b, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* preact, void* lse, void* cls,
                  const void* policy, const void* sa, const void* sm, int B, int N, int C, int H,
                  int hidden, float scale, float ln_eps, float eps, void* stream, void* attn_res);

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
// fp32; bqkv may be null. Requires C == d * H with a head width d
// up to 256 (attention_hd.cuh), hidden % 8 == 0, N up to hd_max_tokens
// (attention_hd.cuh), 16-byte aligned pointers. ln_c: the LayerNorms'
// width, C or less where the rows end in zero columns (d2s::LnWidth).
extern "C" int d2s_block_forward(
    const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf, void* hid_buf,
    void* stats_buf, const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ln2_w, const void* ln2_b,
    const void* w1, const void* b1, const void* w2, const void* b2, void* preact, void* lse,
    void* cls, const void* policy, const void* sa, const void* sm, int B, int N, int C, int H,
    int hidden, int ln_c, float scale, float ln_eps, float eps, void* stream) {
  const d2s::LnWidth scope(ln_c);
  return d2s::block_forward(x, out, qkv_buf, attn_buf, mid_buf, hid_buf, stats_buf, ln1_w,
                            ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
                            preact, lse, cls, policy, sa, sm, B, N, C, H, hidden, scale, ln_eps,
                            eps, stream, nullptr);
}

// d2s_block_forward with attn_res: where not null, (B*N, C) bf16, the
// attention output's out_res (launch_attention_strided); block_bwd.cu's
// recompute takes it.
int d2s::block_forward(const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf,
                       void* hid_buf, void* stats_buf, const void* ln1_w, const void* ln1_b,
                       const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
                       const void* ln2_w, const void* ln2_b, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* preact, void* lse, void* cls,
                       const void* policy, const void* sa, const void* sm, int B, int N, int C,
                       int H, int hidden, float scale, float ln_eps, float eps, void* stream,
                       void* attn_res) {
  if (!d2s::head_width_ok(C, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = d2s::attention_half(
      static_cast<const bf16*>(x), static_cast<bf16*>(mid_buf), static_cast<bf16*>(qkv_buf),
      static_cast<bf16*>(attn_buf), static_cast<float2*>(stats_buf),
      static_cast<const float*>(ln1_w), static_cast<const float*>(ln1_b),
      static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const bf16*>(wproj), static_cast<const float*>(bproj),
      static_cast<float*>(lse), static_cast<bf16*>(cls), static_cast<const float*>(policy),
      static_cast<const float*>(sa), B, N, C, H, scale, ln_eps, eps, s,
      static_cast<bf16*>(attn_res));
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
// bqkv and bproj may be null; ln_c as d2s_block_forward's. Requires C ==
// d * H (d at most 256), N up to hd_max_tokens, 16-byte aligned pointers.
extern "C" int d2s_attention_block_forward(const void* x, void* out, void* qkv_buf,
                                           void* attn_buf, void* stats_buf, const void* ln_w,
                                           const void* ln_b, const void* wqkv, const void* bqkv,
                                           const void* wproj, const void* bproj, void* lse,
                                           void* cls, const void* policy, int B, int N, int C,
                                           int H, int ln_c, float scale, float ln_eps, float eps,
                                           void* stream) {
  if (B <= 0 || !d2s::head_width_ok(C, H) || out == nullptr) return (int)cudaErrorInvalidValue;
  const d2s::LnWidth scope(ln_c);
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
// Requires C == d * H (d at most 256), N up to hd_max_tokens, q_ld
// and q_bstride multiples of 8, 16-byte aligned pointers.
extern "C" int d2s_attention_packed_forward(const void* qkv, long long q_bstride, int q_ld,
                                            void* out, void* cls, const void* policy, int B,
                                            int N, int H, int C, float scale, float eps,
                                            void* stream) {
  if (B <= 0 || !d2s::head_width_ok(C, H)) return (int)cudaErrorInvalidValue;
  return (int)d2s::launch_attention_strided(
      static_cast<const bf16*>(qkv), q_bstride, q_ld, static_cast<bf16*>(out), nullptr,
      static_cast<bf16*>(cls), static_cast<const float*>(policy), B, N, H, C / H, scale, eps,
      static_cast<cudaStream_t>(stream));
}

// The MLP half alone, out = x + fc2(GELU(fc1(LN x))), over M = B*N rows: x,
// out (M, C) bf16; scratch hid (M, hidden) bf16 and stats (M) float2;
// weights as d2s_block_forward takes ln2/w1/b1/w2/b2; ln_c as its. Requires
// C and hidden multiples of 8, 16-byte aligned pointers.
extern "C" int d2s_mlp_residual_forward(const void* x, void* out, void* hid_buf, void* stats_buf,
                                        const void* ln_w, const void* ln_b, const void* w1,
                                        const void* b1, const void* w2, const void* b2, int M,
                                        int C, int hidden, int ln_c, float ln_eps, void* stream) {
  if (M <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  const d2s::LnWidth scope(ln_c);
  return (int)d2s::mlp_half(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<bf16*>(hid_buf), nullptr,
      static_cast<float2*>(stats_buf), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      M, C, hidden, ln_eps, nullptr, M, static_cast<cudaStream_t>(stream));
}
