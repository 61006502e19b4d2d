// Attention half-block forward, inference schedules v1-v3, for sm_90a.
//
// Replaces scripts/attn_variants.py::run_variant (kernel body
// `_variant_kernel`), the JAX package's on-chip A/B of three schedules of the
// same function: the half-block's inference forward
//   out = x + proj(MHA(qkv(LN1 x)))
// with no policy and no CLS rows. v0, the shipped half-block, is block.cu's
// d2s_attention_block_forward, whose core (attention_kernel) makes two passes
// over the keys: the row max, then exp and P V. LN1 + qkv and proj + the
// residual run here on block.cu's stages (qkv_stage, proj_stage, the
// ln_gemm.cuh GEMM); only the attention core differs between the variants.
//
// Every variant computes the exact softmax: an fp32 row max over the N real
// keys, exp against it, the fp32 sum. The TPU variants' exp(clip(s, -30, 30))
// without a row max (and the 16-token padding whose exp(0) = 1 columns they
// subtract from the denominator) is not carried over: inside |scaled logits|
// <= 30, where the script's inputs lie, the two agree. Each TPU variant is a
// schedule for the TPU's MXU and VPU; on Hopper each keeps its idea:
//   v1  (TPU: the pad-free softmax, fewer VPU passes per score) one pass
//       over the keys with an online softmax: a running row max, and the
//       output and sum rescaled by exp(m_old - m_new) when it grows. One CTA
//       of 4 warps per (sample, head, 64-query tile), 16 rows a warp, 32
//       keys a step.
//   v2  (TPU: sum/difference head pairing, full-width MXU contractions) v1
//       with one CTA per (sample, head pair, 64-query tile): with a, b the
//       pair's heads, S+ = [qa|qb] [ka|kb]^T and S- = [qa|-qb] [ka|kb]^T as
//       K = 128 products on mma.sync, then Sa = (S+ + S-) / 2 and
//       Sb = (S+ - S-) / 2, each head's online softmax from there. An odd
//       last head runs alone, on v1's kernel. On Hopper the pairing buys
//       nothing: mma.sync has no 128-wide contraction to fill, and S- doubles
//       the score products (4 B N^2 C against 2 B N^2 C).
//   v3  (TPU: two-phase, all QK^T, then all exps, then all P V) one CTA of 4
//       warps per (sample, 16-query tile), all heads: every head's scaled
//       scores staged in shared memory in fp32, then every row's max, exps
//       (bf16) and sum, then every head's P V. The 16-row tile keeps the
//       fp32 staging at H x 16 x N (6 x 16 x 224 x 4 bytes = 86 KB at
//       N = 197, with the bf16 exps 43 KB more) where 64 rows would take
//       344 KB, over the 227 KB a CTA may have; the widths where it still
//       does not fit are refused (d2s_attention_variant_supported), as the
//       TPU wrapper gates its two-phase schedule on N.
// Each K and V head tile sits in shared memory, loaded once per CTA (v3 once
// per head in turn); the scores never leave registers in v1 and v2.
//
// What bounds it on the H100: the same as the half-block, operations: the
// two projections (8 B N C^2) and the score and P V products (4 B N^2 C;
// v2's S- adds 2 B N^2 C), ~75 GFLOP at B=256, N=197, C=384, on mma.sync
// and the ln_gemm GEMM at a fraction of the bf16 rate.
#include <algorithm>

#include "ln_gemm.cuh"

namespace d2s {

// block.cu's stages 1 and 3
cudaError_t qkv_stage(const bf16* x, bf16* qkv, float2* stats, const float* ln_w,
                      const float* ln_b, const bf16* wqkv, const float* bqkv, int M, int C,
                      float ln_eps, cudaStream_t stream);
cudaError_t proj_stage(const bf16* x, const bf16* attn, bf16* out, const bf16* wproj,
                       const float* bproj, const float* sa, int rows, int M, int C,
                       cudaStream_t stream);

constexpr int AV_HD = 64;
constexpr int AV_THREADS = 128;          // 4 warps
constexpr int AV_BQ = 64;                // v1, v2: query rows per CTA, 16 a warp
constexpr int AV_BK = 32;                // keys per step of the online softmax
constexpr int AV_LD = AV_HD + 8;         // bf16 pitch of a head's Q and K rows
constexpr int AV_LD2 = 2 * AV_HD + 8;    // v2: of a head pair's
constexpr int AV3_BQ = 16;               // v3: query rows per CTA
constexpr size_t AV_SMEM_MAX = 232448;   // the most a CTA may have

__host__ __device__ inline int av_keys(int n) { return (n + AV_BK - 1) / AV_BK * AV_BK; }

// rows r0 .. r0 + rows - 1 of a W-wide column slice whose token rows lie
// src_ld elements apart into dst (pitch ld), zero from row N on
template <int W>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, long long src_ld,
                                          int r0, int rows, int N) {
  constexpr int VPR = W / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < rows * VPR; v += blockDim.x) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * src_ld + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// the first np rows of a W-wide slice, transposed: dst[d * ldt + r] = src[r][d],
// zero from row N on
template <int W>
__device__ __forceinline__ void load_transposed(bf16* dst, int ldt, const bf16* src,
                                                long long src_ld, int np, int N) {
  constexpr int VPR = W / 8;
  for (int v = threadIdx.x; v < np * VPR; v += blockDim.x) {
    const int r = v / VPR, c = (v % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < N) val = *reinterpret_cast<const uint4*>(src + (long long)r * src_ld + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ldt + r] = e[j];
  }
}

// the A fragments of rows g, g + 8 and K = 16 KK columns of a [row][col]
// bf16 tile at `rows` (pitch ld)
template <int KK>
__device__ __forceinline__ void load_a(uint32_t (&a)[KK][4], const bf16* rows, int ld, int g,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const bf16* p = rows + g * ld + kk * 16 + 2 * t;
    a[kk][0] = ld32(p);
    a[kk][1] = ld32(p + 8 * ld);
    a[kk][2] = ld32(p + 8);
    a[kk][3] = ld32(p + 8 * ld + 8);
  }
}

// One step of the online softmax over keys k0 .. k0 + 31 for a warp's 16
// query rows (this thread's rows g, g + 8 as r = 0, 1): s holds the four
// 16 x 8 tiles of unscaled scores (c layout of mma_16816). The running max
// m, this thread's share of the row sums l and the 16 x 64 output o are
// rescaled by exp(m_old - m_new), then p = exp(scale s - m_new) is added to
// l and, in bf16, multiplied into V (transposed, pitch ldt).
__device__ __forceinline__ void online_step(float (&s)[4][4], int k0, int N, float scale,
                                            float (&m)[2], float (&l)[2],
                                            float (&o)[AV_HD / 8][4], const bf16* vt, int ldt,
                                            int g, int t) {
  float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      const float v = col < N ? s[j][e] * scale : -INFINITY;
      s[j][e] = v;
      bm[e >> 1] = fmaxf(bm[e >> 1], v);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
    bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
    const float mn = fmaxf(m[r], bm[r]);  // finite: key k0 < N is in every step
    const float alpha = __expf(m[r] - mn);  // 0 on the first step, where m = -inf
    m[r] = mn;
    l[r] *= alpha;
#pragma unroll
    for (int nd = 0; nd < AV_HD / 8; ++nd) {
      o[nd][2 * r] *= alpha;
      o[nd][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[j][e] - m[e >> 1]);  // 0 past N
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                            pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                            pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                            pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int nd = 0; nd < AV_HD / 8; ++nd) {
      const bf16* vp = vt + (nd * 8 + g) * ldt + k0 + 16 * kc + 2 * t;
      mma_16816(o[nd], pa, ld32(vp), ld32(vp + 8));
    }
  }
}

// rows q, q + 8 (those below N) of a warp's 16 x 64 output, divided by the
// row sums (this thread's shares, summed over the quad here), into columns
// col0 .. col0 + 63 of the (B*N, C) output from row `row0` on
__device__ __forceinline__ void store_head(bf16* out, long long row0, int C, int col0, int q,
                                           int N, const float (&o)[AV_HD / 8][4], float (&l)[2],
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  bf16* base = out + row0 * C + col0 + 2 * t;
#pragma unroll
  for (int nd = 0; nd < AV_HD / 8; ++nd) {
    if (q < N)
      *reinterpret_cast<uint32_t*>(base + (long long)q * C + nd * 8) =
          pack_bf16(o[nd][0] * inv0, o[nd][1] * inv0);
    if (q + 8 < N)
      *reinterpret_cast<uint32_t*>(base + (long long)(q + 8) * C + nd * 8) =
          pack_bf16(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

// ---- v1: one pass, online softmax ------------------------------------------

static size_t v1_smem(int n) {
  const size_t np = av_keys(n);
  return ((size_t)AV_BQ * AV_LD + np * AV_LD + (size_t)AV_HD * (np + 8)) * sizeof(bf16);
}

// CTA = (sample, head head0 + blockIdx.y % nh, 64-query tile); qkv packed
// (B*N, 3C), out (B*N, C)
static __global__ void __launch_bounds__(AV_THREADS)
    variant1_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                    int head0, int nh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = av_keys(N);
  const int ldt = np + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + AV_BQ * AV_LD;
  bf16* Vt = Ks + np * AV_LD;
  const int C = H * AV_HD;
  const int b = blockIdx.y / nh;
  const int h = head0 + blockIdx.y % nh;
  const int q0 = blockIdx.x * AV_BQ;
  const long long ld = 3LL * C;
  const bf16* base = qkv + (long long)b * N * ld + h * AV_HD;
  load_rows<AV_HD>(Qs, AV_LD, base, ld, q0, AV_BQ, N);
  load_rows<AV_HD>(Ks, AV_LD, base + C, ld, 0, np, N);
  load_transposed<AV_HD>(Vt, ldt, base + 2 * C, ld, np, N);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  uint32_t qa[AV_HD / 16][4];
  load_a(qa, Qs + row0 * AV_LD, AV_LD, g, t);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[AV_HD / 8][4] = {};
  for (int k0 = 0; k0 < N; k0 += AV_BK) {
    float s[4][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* kp = Ks + (k0 + 8 * j + g) * AV_LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < AV_HD / 16; ++kk)
        mma_16816(s[j], qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }
    online_step(s, k0, N, scale, m, l, o, Vt, ldt, g, t);
  }
  store_head(out, (long long)b * N, C, h * AV_HD, q0 + row0 + g, N, o, l, t);
}

// ---- v2: head pairs, sum and difference -----------------------------------

static size_t v2_smem(int n) {
  const size_t np = av_keys(n);
  return ((size_t)AV_BQ * AV_LD2 + np * AV_LD2 + (size_t)2 * AV_HD * (np + 8)) * sizeof(bf16);
}

// CTA = (sample, head pair (2p, 2p + 1), 64-query tile); the pair's q, k and
// v are each one 128-wide column slice of qkv
static __global__ void __launch_bounds__(AV_THREADS)
    variant2_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = av_keys(N);
  const int ldt = np + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + AV_BQ * AV_LD2;
  bf16* Vt = Ks + np * AV_LD2;  // rows 0-63: head a's dims, 64-127: head b's
  const int C = H * AV_HD;
  const int pairs = H / 2;
  const int b = blockIdx.y / pairs;
  const int ha = 2 * (blockIdx.y % pairs);
  const int q0 = blockIdx.x * AV_BQ;
  const long long ld = 3LL * C;
  const bf16* base = qkv + (long long)b * N * ld + ha * AV_HD;
  load_rows<2 * AV_HD>(Qs, AV_LD2, base, ld, q0, AV_BQ, N);
  load_rows<2 * AV_HD>(Ks, AV_LD2, base + C, ld, 0, np, N);
  load_transposed<2 * AV_HD>(Vt, ldt, base + 2 * C, ld, np, N);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x >> 5) * 16;
  uint32_t qp[2 * AV_HD / 16][4];  // [qa | qb]
  load_a(qp, Qs + row0 * AV_LD2, AV_LD2, g, t);
  uint32_t qn[AV_HD / 16][4];  // -qb: the sign bits of both bf16 halves flipped
#pragma unroll
  for (int kk = 0; kk < AV_HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qn[kk][i] = qp[AV_HD / 16 + kk][i] ^ 0x80008000u;

  float ma[2] = {-INFINITY, -INFINITY}, la[2] = {0.f, 0.f};
  float mb[2] = {-INFINITY, -INFINITY}, lb[2] = {0.f, 0.f};
  float oa[AV_HD / 8][4] = {}, ob[AV_HD / 8][4] = {};
  for (int k0 = 0; k0 < N; k0 += AV_BK) {
    float sp[4][4] = {}, sd[4][4] = {};  // S+, S- of the step's 32 keys
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16* kp = Ks + (k0 + 8 * j + g) * AV_LD2 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 2 * AV_HD / 16; ++kk) {
        const uint32_t b0 = ld32(kp + kk * 16), b1 = ld32(kp + kk * 16 + 8);
        mma_16816(sp[j], qp[kk], b0, b1);
        if (kk < AV_HD / 16)
          mma_16816(sd[j], qp[kk], b0, b1);
        else
          mma_16816(sd[j], qn[kk - AV_HD / 16], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sum = sp[j][e], dif = sd[j][e];
        sp[j][e] = 0.5f * (sum + dif);  // head a's scores
        sd[j][e] = 0.5f * (sum - dif);  // head b's
      }
    }
    online_step(sp, k0, N, scale, ma, la, oa, Vt, ldt, g, t);
    online_step(sd, k0, N, scale, mb, lb, ob, Vt + AV_HD * ldt, ldt, g, t);
  }
  const int q = q0 + row0 + g;
  store_head(out, (long long)b * N, C, ha * AV_HD, q, N, oa, la, t);
  store_head(out, (long long)b * N, C, (ha + 1) * AV_HD, q, N, ob, lb, t);
}

// ---- v3: two phases over all heads ----------------------------------------

static size_t v3_smem(int n, int H) {
  const size_t np = av_keys(n), C = (size_t)H * AV_HD;
  const size_t kv = std::max(np * AV_LD, (size_t)AV_HD * (np + 8));  // one head's K, or V^T
  return (AV3_BQ * (C + 8) + kv) * sizeof(bf16)               // Q of every head, K or V
         + (size_t)H * AV3_BQ * (np + 4) * sizeof(float)      // the scaled scores
         + (size_t)H * AV3_BQ * (np + 8) * sizeof(bf16)       // the exps
         + (size_t)H * AV3_BQ * sizeof(float);                // 1 / row sum
}

// CTA = (sample, 16-query tile), every head
static __global__ void __launch_bounds__(AV_THREADS)
    variant3_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = av_keys(N);
  const int C = H * AV_HD;
  const int ldq = C + 8, lds = np + 4, ldp = np + 8, ldt = np + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + AV3_BQ * ldq;
  const int kv = max(np * AV_LD, AV_HD * ldt);
  float* S = reinterpret_cast<float*>(KV + kv);
  bf16* P = reinterpret_cast<bf16*>(S + H * AV3_BQ * lds);
  float* Inv = reinterpret_cast<float*>(P + H * AV3_BQ * ldp);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * AV3_BQ;
  const long long ld = 3LL * C;
  const bf16* base = qkv + (long long)b * N * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int WARPS = AV_THREADS / 32;
  for (int h = 0; h < H; ++h)
    load_rows<AV_HD>(Qs + h * AV_HD, ldq, base + h * AV_HD, ld, q0, AV3_BQ, N);

  // phase 1: every head's scaled scores, masked past N
  for (int h = 0; h < H; ++h) {
    __syncthreads();
    load_rows<AV_HD>(KV, AV_LD, base + C + h * AV_HD, ld, 0, np, N);
    __syncthreads();
    uint32_t qa[AV_HD / 16][4];
    load_a(qa, Qs + h * AV_HD, ldq, g, t);
    float* sh = S + h * AV3_BQ * lds;
    for (int j = warp; j < np / 8; j += WARPS) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kp = KV + (8 * j + g) * AV_LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < AV_HD / 16; ++kk)
        mma_16816(s, qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        sh[(g + 8 * (e >> 1)) * lds + col] = col < N ? s[e] * scale : -INFINITY;
      }
    }
  }
  __syncthreads();

  // phase 2: every row's max, exps (bf16 for P V) and fp32 sum
  for (int row = warp; row < H * AV3_BQ; row += WARPS) {
    const float* sr = S + row * lds;
    float mx = -INFINITY;
    for (int c = lane; c < N; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    bf16* pr = P + row * ldp;
    for (int c = lane; c < np; c += 32) {
      const float p = __expf(sr[c] - mx);  // 0 past N
      sum += p;
      pr[c] = __float2bfloat16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) Inv[row] = 1.f / sum;
  }

  // phase 3: every head's P V, two 8-wide column tiles a warp
  for (int h = 0; h < H; ++h) {
    __syncthreads();
    load_transposed<AV_HD>(KV, ldt, base + 2 * C + h * AV_HD, ld, np, N);
    __syncthreads();
    const bf16* ph = P + h * AV3_BQ * ldp;
    float o[2][4] = {};
    for (int k0 = 0; k0 < np; k0 += 16) {
      uint32_t a[4];
      a[0] = ld32(ph + g * ldp + k0 + 2 * t);
      a[1] = ld32(ph + (g + 8) * ldp + k0 + 2 * t);
      a[2] = ld32(ph + g * ldp + k0 + 8 + 2 * t);
      a[3] = ld32(ph + (g + 8) * ldp + k0 + 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* vp = KV + ((2 * warp + i) * 8 + g) * ldt + k0 + 2 * t;
        mma_16816(o[i], a, ld32(vp), ld32(vp + 8));
      }
    }
    const float inv0 = Inv[h * AV3_BQ + g], inv1 = Inv[h * AV3_BQ + g + 8];
    bf16* ob = out + ((long long)b * N + q0) * C + h * AV_HD + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = (2 * warp + i) * 8;
      if (q0 + g < N)
        *reinterpret_cast<uint32_t*>(ob + (long long)g * C + col) =
            pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
      if (q0 + g + 8 < N)
        *reinterpret_cast<uint32_t*>(ob + (long long)(g + 8) * C + col) =
            pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
    }
  }
}

// ---- launch -----------------------------------------------------------------

static size_t variant_smem(int variant, int N, int H) {
  switch (variant) {
    case 1:
      return v1_smem(N);
    case 2:  // the pairs, and v1's kernel for an odd last head
      return std::max(H >= 2 ? v2_smem(N) : 0, H % 2 ? v1_smem(N) : 0);
    case 3:
      return v3_smem(N, H);
    default:
      return 0;
  }
}

static bool variant_fits(int variant, int N, int H) {
  const size_t smem = variant_smem(variant, N, H);
  return N > 0 && H > 0 && smem > 0 && smem <= AV_SMEM_MAX;
}

template <typename K>
static cudaError_t launch_core(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                               const bf16* qkv, bf16* out, int N, int H, float scale) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, AV_THREADS, smem, st>>>(qkv, out, N, H, scale);
  return cudaGetLastError();
}

// the attention core of `variant` on packed (B*N, 3C) qkv into (B*N, C) out
static cudaError_t launch_variant(int variant, const bf16* qkv, bf16* out, int B, int N, int H,
                                  float scale, cudaStream_t st) {
  if (!variant_fits(variant, N, H)) return cudaErrorInvalidValue;
  const int qtiles = (N + AV_BQ - 1) / AV_BQ;
  cudaError_t err;
  if (variant == 3)
    return launch_core(variant3_kernel, dim3((N + AV3_BQ - 1) / AV3_BQ, B), v3_smem(N, H), st,
                       qkv, out, N, H, scale);
  if (variant == 2 && H >= 2) {
    err = launch_core(variant2_kernel, dim3(qtiles, B * (H / 2)), v2_smem(N), st, qkv, out, N,
                      H, scale);
    if (err != cudaSuccess || H % 2 == 0) return err;
  }
  // v1, or v2's odd last head alone
  const int head0 = variant == 2 ? H - 1 : 0, nh = H - head0;
  err = cudaFuncSetAttribute(variant1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)v1_smem(N));
  if (err != cudaSuccess) return err;
  variant1_kernel<<<dim3(qtiles, B * nh), AV_THREADS, v1_smem(N), st>>>(qkv, out, N, H, head0,
                                                                         nh, scale);
  return cudaGetLastError();
}

}  // namespace d2s

using d2s::bf16;

// 1 where variant (1-3) takes N tokens and H heads of 64 (its shared memory
// fits a CTA), else 0.
extern "C" int d2s_attention_variant_supported(int variant, int N, int H) {
  return d2s::variant_fits(variant, N, H) ? 1 : 0;
}

// The half-block forward out = x + proj(MHA(qkv(LN1 x))) with the attention
// core of `variant` (1-3): x, out (B, N, C) bf16; scratch qkv (B*N, 3C) and
// attn (B*N, C) bf16, stats (B*N) float2; weights bf16 (out, in), LayerNorm
// and biases fp32, bqkv and bproj may be null. Requires C == 64 * H,
// d2s_attention_variant_supported(variant, N, H), 16-byte aligned pointers.
extern "C" int d2s_attention_variant_forward(const void* x, void* out, void* qkv_buf,
                                             void* attn_buf, void* stats_buf, const void* ln_w,
                                             const void* ln_b, const void* wqkv,
                                             const void* bqkv, const void* wproj,
                                             const void* bproj, int variant, int B, int N,
                                             int C, int H, float scale, float ln_eps,
                                             void* stream) {
  using namespace d2s;
  if (B <= 0 || C != H * AV_HD || out == nullptr || !variant_fits(variant, N, H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* attn = static_cast<bf16*>(attn_buf);
  cudaError_t err = qkv_stage(xb, qkv, static_cast<float2*>(stats_buf),
                              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                              static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv), M,
                              C, ln_eps, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_variant(variant, qkv, attn, B, N, H, scale, st)) != cudaSuccess)
    return (int)err;
  return (int)proj_stage(xb, attn, static_cast<bf16*>(out), static_cast<const bf16*>(wproj),
                         static_cast<const float*>(bproj), nullptr, N, M, C, st);
}
