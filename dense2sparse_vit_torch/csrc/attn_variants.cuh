// Attention half-block forward, inference schedules v1-v3, for sm_90a: the
// attention cores and their launch at each padded head width. Each padded
// width's launch is instantiated in one of attn_variants.cu (16 to 64),
// attn_variants_dp80.cu (80, 96) and attn_variants_dp112.cu (112, 128), so
// that nvcc builds them in parallel.
//
// Replaces scripts/attn_variants.py::run_variant (kernel body
// `_variant_kernel`), the JAX package's on-chip A/B of three schedules of the
// same function: the half-block's inference forward
//   out = x + proj(MHA(qkv(LN1 x)))
// with no policy and no CLS rows. v0, the shipped half-block, is block.cu's
// d2s_attention_block_forward. LN1 + qkv and proj + the residual run on
// block.cu's stages (qkv_stage, proj_stage, the ln_gemm.cuh GEMM); only the
// attention core differs between the variants.
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
//       K = 2 DP products on mma.sync, then Sa = (S+ + S-) / 2 and
//       Sb = (S+ - S-) / 2, each head's online softmax from there. An odd
//       last head runs alone, on v1's kernel. On Hopper the pairing buys
//       nothing: mma.sync has no 128-wide contraction to fill, and S- doubles
//       the score products (4 B N^2 C against 2 B N^2 C).
//   v3  (TPU: two-phase, all QK^T, then all exps, then all P V) one CTA of 4
//       warps per (sample, 16-query tile) at a time, all heads: every head's
//       scaled scores staged in fp32, then every row's max, exps (in place)
//       and sum, then every head's P V. The staging takes H x 16 x N fp32: in
//       shared memory where it fits a CTA beside the tiles (6 x 16 x 260 x 4
//       bytes = 100 KB at N = 197, 6 heads; 200 KB at 12), else in a global
//       workspace the entry is handed, one slot per CTA in flight: a
//       persistent grid of at most 4 CTAs an SM (and AV_WORK_MAX bytes in
//       all) walks the tiles (av3_plan).
//
// Widths. A head's d columns (1 to 128: the wrapper takes d up to 127, as
// JAX's run_variant does, and hands over heads padded to 128 by ops.rowpad)
// are copied into shared memory zero-padded to DP = roundup(d, 16) columns
// in attention_hd.cuh's tile layout of 8 x 8 core matrices (hd_at): rows
// start at byte 2 h d of a qkv row, 16-, 8- or 4-byte cp.async pieces as
// their alignment allows, element by element at an odd d (hd_copy_tile).
// Every fragment comes out of such a tile by ldmatrix (av_load_a, _k, _v):
// the 8 rows of a core matrix are 128 contiguous bytes, so no load meets a
// bank conflict. Zero columns change no score; the output's columns past d
// are not stored (element by element at an odd d: hd_store_pair).
//
// Sequence length. K and V stream through shared memory in 64-key blocks, a
// ring of two cp.async stages (one block ahead of the products), so nothing
// in v1's and v2's shared memory grows with N: they take any N. v3's
// staging grows with H N and goes to the workspace where it outgrows a CTA.
// The wrapper holds N to fused_attention_block's forward ceiling at d
// (attention_hd.cuh's hd_max_tokens, 45,824 at d = 64).
//
// What bounds it on the H100: operations: the two projections (8 B N C^2)
// and the score and P V products (4 B N^2 C; v2's S- adds 2 B N^2 C), ~75
// GFLOP at B=256, N=197, C=384, on mma.sync and the ln_gemm GEMM at a
// fraction of the bf16 rate; v3 past its shared memory also moves 12 B H N^2
// bytes of staging through L2 and device memory.
#pragma once

#include <algorithm>

#include "attention_hd.cuh"

namespace d2s {

// block.cu's stages 1 and 3
cudaError_t qkv_stage(const bf16* x, bf16* qkv, float2* stats, const float* ln_w,
                      const float* ln_b, const bf16* wqkv, const float* bqkv, int M, int C,
                      float ln_eps, cudaStream_t stream);
cudaError_t proj_stage(const bf16* x, const bf16* attn, bf16* out, const bf16* wproj,
                       const float* bproj, const float* sa, int rows, int M, int C,
                       cudaStream_t stream);

constexpr int AV_THREADS = 128;   // 4 warps
constexpr int AV_BQ = 64;         // v1, v2: query rows per CTA, 16 a warp
constexpr int AV_BK = 32;         // keys per step of the online softmax
constexpr int AV3_BQ = 16;        // v3: query rows per tile
constexpr int AV_MAX_D = 127;     // the widest head the variants take (JAX's run_variant's)
constexpr int AV_MAX_DP = 128;    // the widest (padded) head a kernel takes
constexpr int AV3_CTAS_PER_SM = 4;           // v3's persistent grid, staged in the workspace
constexpr long long AV_WORK_MAX = 1LL << 30;  // v3's workspace, at most

// the A fragments of rows r0 + g, r0 + g + 8 and columns 16 kk .. 16 kk + 15
// of a DP-wide tile (hd_at layout)
template <int DP>
__device__ __forceinline__ void av_load_a(uint32_t (&a)[4], const unsigned char* tile, int r0,
                                          int kk, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, c = kk * 16 + (lane >> 4) * 8;
  ldmatrix_x4(a, reinterpret_cast<const bf16*>(tile + hd_at<DP>(r, c)));
}

// the B fragments of S = Q K^T for keys n0 .. n0 + 15 of a K tile and its
// columns 16 kk .. 16 kk + 15: b[0], b[1] keys n0 .. n0 + 7, b[2], b[3] the
// next eight
template <int DP>
__device__ __forceinline__ void av_load_k(uint32_t (&b)[4], const unsigned char* tile, int n0,
                                          int kk, int lane) {
  const int mi = lane >> 3;
  const int r = n0 + (lane & 7) + (mi >> 1) * 8, c = kk * 16 + (mi & 1) * 8;
  ldmatrix_x4(b, reinterpret_cast<const bf16*>(tile + hd_at<DP>(r, c)));
}

// the B fragments of P V for keys k0 .. k0 + 15 of a V tile and its columns
// n0 .. n0 + 15: b[0], b[1] columns n0 .. n0 + 7, b[2], b[3] the next eight
template <int DP>
__device__ __forceinline__ void av_load_v(uint32_t (&b)[4], const unsigned char* tile, int k0,
                                          int n0, int lane) {
  const int mi = lane >> 3;
  const int r = k0 + (lane & 7) + (mi & 1) * 8, c = n0 + (mi >> 1) * 8;
  ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(tile + hd_at<DP>(r, c)));
}

// One step of the online softmax over keys k0 .. k0 + 31 for a warp's 16
// query rows (this thread's rows g, g + 8 as r = 0, 1): s holds the four
// 16 x 8 tiles of unscaled scores (c layout of mma_16816). The running max
// m, this thread's share of the row sums l and the 16 x DP output o are
// rescaled by exp(m_old - m_new), then p = exp(scale s - m_new) is added to
// l and, in bf16, multiplied into V (key k0 at row kr of the V tile).
template <int DP>
__device__ __forceinline__ void av_online_step(float (&s)[4][4], int k0, int N, float scale,
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[DP / 8][4], const unsigned char* vt,
                                               int kr, int lane) {
  const int t = lane & 3;
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
    for (int nd = 0; nd < DP / 8; ++nd) {
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
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      uint32_t b[4];
      av_load_v<DP>(b, vt, kr + 16 * kc, 16 * n2, lane);
      mma_16816(o[2 * n2], pa, b[0], b[1]);
      mma_16816(o[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
}

// rows q, q + 8 (those below N) of a warp's 16 x DP output, divided by the
// row sums (this thread's shares, summed over the quad here), into the d
// columns from col0 on of the (B*N, C) output from row `row0` on
template <int DP, bool ODD>
__device__ __forceinline__ void av_store_head(bf16* out, long long row0, int C, int col0, int d,
                                              int q, int N, const float (&o)[DP / 8][4],
                                              float (&l)[2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  bf16* base = out + row0 * C + col0;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c >= d) continue;
    if (q < N) hd_store_pair<ODD>(base + (long long)q * C, c, d, o[nd][0] * inv0, o[nd][1] * inv0);
    if (q + 8 < N)
      hd_store_pair<ODD>(base + (long long)(q + 8) * C, c, d, o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

// ---- v1: one pass, online softmax ------------------------------------------

// a Q tile and a ring of two (K, V) tile pairs
template <int DP>
constexpr size_t AV1_SMEM = 5 * (size_t)HD_TILE<DP>;

// CTA = (64-query tile, then sample and head head0 + its index mod nh);
// qkv packed (B*N, 3C), out (B*N, C), C = H d
template <int DP, bool ODD>
static __global__ void __launch_bounds__(AV_THREADS)
    variant1_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int d,
                    int head0, int nh, int qtiles, float scale, int pb) {
  constexpr int T = HD_TILE<DP>;
  extern __shared__ __align__(128) unsigned char av_smem[];
  unsigned char* Qs = av_smem;
  unsigned char* KV = Qs + T;  // the ring: block j's K and V at slot j % 2
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / nh, h = head0 + bh % nh;
  const int q0 = (blockIdx.x % qtiles) * AV_BQ;
  const int C = H * d;
  const long long ld = 3LL * C;
  const bf16* base = qkv + (long long)b * N * ld + (long long)h * d;
  const int nkb = (N + HD_BLK - 1) / HD_BLK;
  // key block j's K and V into its slot; a commit group each, empty past the last
  auto load_kv = [&](int j) {
    if (j < nkb) {
      unsigned char* slot = KV + (j & 1) * 2 * T;
      hd_copy_tile<DP, ODD>(slot, base + C, ld, j * HD_BLK, N, d, pb, tid, AV_THREADS);
      hd_copy_tile<DP, ODD>(slot + T, base + 2 * C, ld, j * HD_BLK, N, d, pb, tid, AV_THREADS);
    }
    cp_async_commit();
  };
  hd_copy_tile<DP, ODD>(Qs, base, ld, q0, N, d, pb, tid, AV_THREADS);
  load_kv(0);  // the first group holds Q too

  uint32_t qa[DP / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DP / 8][4] = {};
  for (int j = 0; j < nkb; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // block j in for every thread; every product of block j - 1 done
    load_kv(j + 1);
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) av_load_a<DP>(qa[kk], Qs, row0, kk, lane);
    }
    const unsigned char* Kt = KV + (j & 1) * 2 * T;
    for (int kr = 0; kr < HD_BLK; kr += AV_BK) {
      const int k0 = j * HD_BLK + kr;
      if (k0 >= N) break;
      float s[4][4] = {};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t kf[4];
          av_load_k<DP>(kf, Kt, kr + 16 * jj, kk, lane);
          mma_16816(s[2 * jj], qa[kk], kf[0], kf[1]);
          mma_16816(s[2 * jj + 1], qa[kk], kf[2], kf[3]);
        }
      }
      av_online_step<DP>(s, k0, N, scale, m, l, o, Kt + T, kr, lane);
    }
  }
  av_store_head<DP, ODD>(out, (long long)b * N, C, h * d, d, q0 + row0 + g, N, o, l, t);
}

// ---- v2: head pairs, sum and difference -----------------------------------

// the pair's two Q tiles and a ring of two stages of four tiles (Ka, Kb, Va, Vb)
template <int DP>
constexpr size_t AV2_SMEM = 10 * (size_t)HD_TILE<DP>;

// CTA = (64-query tile, then sample and head pair (2p, 2p + 1))
template <int DP, bool ODD>
static __global__ void __launch_bounds__(AV_THREADS)
    variant2_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int d,
                    int qtiles, float scale, int pb) {
  constexpr int T = HD_TILE<DP>, KK = DP / 16;
  // the pair's Q fragments stay in registers up to DP = 96; wider, they are
  // read from the Q tiles at each use, where the two heads' outputs (DP / 2
  // registers each) leave no room for them
  constexpr bool QREG = DP <= 96;
  extern __shared__ __align__(128) unsigned char av_smem[];
  unsigned char* Qs = av_smem;     // head a's Q tile, then head b's
  unsigned char* KV = Qs + 2 * T;  // the ring: block j's Ka, Kb, Va, Vb at slot j % 2
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16;
  const int pairs = H / 2;
  const int bp = blockIdx.x / qtiles;
  const int b = bp / pairs, ha = 2 * (bp % pairs);
  const int q0 = (blockIdx.x % qtiles) * AV_BQ;
  const int C = H * d;
  const long long ld = 3LL * C;
  const bf16* base = qkv + (long long)b * N * ld + (long long)ha * d;  // head b's at + d
  const int nkb = (N + HD_BLK - 1) / HD_BLK;
  auto load_kv = [&](int j) {
    if (j < nkb) {
      unsigned char* slot = KV + (j & 1) * 4 * T;
#pragma unroll
      for (int i = 0; i < 4; ++i)  // K then V, head a then b
        hd_copy_tile<DP, ODD>(slot + i * T, base + (1 + i / 2) * C + (i & 1) * d, ld,
                              j * HD_BLK, N, d, pb, tid, AV_THREADS);
    }
    cp_async_commit();
  };
  hd_copy_tile<DP, ODD>(Qs, base, ld, q0, N, d, pb, tid, AV_THREADS);
  hd_copy_tile<DP, ODD>(Qs + T, base + d, ld, q0, N, d, pb, tid, AV_THREADS);
  load_kv(0);

  uint32_t qp[QREG ? 2 * KK : 1][4];  // [qa | qb]
  float ma[2] = {-INFINITY, -INFINITY}, la[2] = {0.f, 0.f};
  float mb[2] = {-INFINITY, -INFINITY}, lb[2] = {0.f, 0.f};
  float oa[DP / 8][4] = {}, ob[DP / 8][4] = {};
  for (int blk = 0; blk < nkb; ++blk) {
    cp_async_wait<0>();
    __syncthreads();
    load_kv(blk + 1);
    if (QREG && blk == 0) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? 2 * KK : 0); ++kk)
        av_load_a<DP>(qp[kk], Qs + (kk / KK) * T, row0, kk % KK, lane);
    }
    const unsigned char* Kt = KV + (blk & 1) * 4 * T;
    for (int kr = 0; kr < HD_BLK; kr += AV_BK) {
      const int k0 = blk * HD_BLK + kr;
      if (k0 >= N) break;
      float sp[4][4] = {}, sd[4][4] = {};  // S+, S- of the step's 32 keys
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int kk = 0; kk < 2 * KK; ++kk) {
          uint32_t qf[4], qn[4], kf[4];
          if (QREG) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qf[i] = qp[QREG ? kk : 0][i];
          } else {
            av_load_a<DP>(qf, Qs + (kk / KK) * T, row0, kk % KK, lane);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)  // -qb: the sign bits of both bf16 halves flipped
            qn[i] = kk < KK ? qf[i] : qf[i] ^ 0x80008000u;
          av_load_k<DP>(kf, Kt + (kk / KK) * T, kr + 16 * jj, kk % KK, lane);
          mma_16816(sp[2 * jj], qf, kf[0], kf[1]);
          mma_16816(sd[2 * jj], qn, kf[0], kf[1]);
          mma_16816(sp[2 * jj + 1], qf, kf[2], kf[3]);
          mma_16816(sd[2 * jj + 1], qn, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sum = sp[j][e], dif = sd[j][e];
          sp[j][e] = 0.5f * (sum + dif);  // head a's scores
          sd[j][e] = 0.5f * (sum - dif);  // head b's
        }
      }
      av_online_step<DP>(sp, k0, N, scale, ma, la, oa, Kt + 2 * T, kr, lane);
      av_online_step<DP>(sd, k0, N, scale, mb, lb, ob, Kt + 3 * T, kr, lane);
    }
  }
  const int q = q0 + row0 + g;
  av_store_head<DP, ODD>(out, (long long)b * N, C, ha * d, d, q, N, oa, la, t);
  av_store_head<DP, ODD>(out, (long long)b * N, C, (ha + 1) * d, d, q, N, ob, lb, t);
}

// ---- v3: two phases over all heads ----------------------------------------

// where v3 stages its scores and how it is launched at padded width dp:
// shared memory (grid: every tile) where the staging fits a CTA beside its
// tiles, else the workspace (grid: persistent, work_bytes of it)
struct Av3Plan {
  bool in_smem;
  int grid;
  size_t smem;
  long long work_bytes;
};

// the fp32 pitch of a staged score row: every key of the 64-key blocks, then
// the row's 1 / sum at column `keys`, padded to keep rows 16-byte aligned
__host__ __device__ inline int av3_pitch(int N) { return (N + HD_BLK - 1) / HD_BLK * HD_BLK + 4; }

inline Av3Plan av3_plan(int dp, int B, int N, int H) {
  const long long tiles = (long long)B * ((N + AV3_BQ - 1) / AV3_BQ);
  const long long rows = (long long)H * AV3_BQ * av3_pitch(N) * 4;  // a tile's staging
  const size_t fixed = (size_t)(2 * AV3_BQ + 2 * HD_BLK) * dp * 2;  // 2 Q tiles, 2 K / V tiles
  if ((long long)fixed + rows <= HD_SMEM_MAX) return {true, (int)tiles, fixed + rows, 0};
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  long long grid = std::min(tiles, (long long)AV3_CTAS_PER_SM * sms);
  grid = std::max(1LL, std::min(grid, AV_WORK_MAX / rows));
  return {false, (int)grid, fixed, grid * rows};
}

// CTA = one (sample, 16-query tile) after another from blockIdx.x, gridDim.x
// apart; S: the staged scores in shared memory, or `work`'s slot blockIdx.x
// (work non-null)
template <int DP, bool ODD>
static __global__ void __launch_bounds__(AV_THREADS)
    variant3_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, float* __restrict__ work,
                    int N, int H, int d, int qtiles, int tiles, float scale, int pb) {
  constexpr int T = HD_TILE<DP>, TQ = AV3_BQ * DP * 2, KK = DP / 16;
  constexpr int GPW = (DP / 16 + 3) / 4;  // P V's 16-column groups a warp: w, w + 4, ...
  extern __shared__ __align__(128) unsigned char av_smem[];
  unsigned char* Qs = av_smem;      // head h's Q rows at slot h % 2
  unsigned char* KV = Qs + 2 * TQ;  // the ring: item i's K (phase 1) or V (phase 3) at i % 2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nkb = (N + HD_BLK - 1) / HD_BLK, np = nkb * HD_BLK, lds = av3_pitch(N);
  const int items = H * nkb;  // (head, key block) in order
  float* S = work != nullptr ? work + (long long)blockIdx.x * H * AV3_BQ * lds
                             : reinterpret_cast<float*>(KV + 2 * T);
  const int C = H * d;
  const long long ld = 3LL * C;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / qtiles, q0 = (tile % qtiles) * AV3_BQ;
    const bf16* base = qkv + (long long)b * N * ld;
    __syncthreads();  // the last tile's reads of the tiles and of S done

    // phase 1: every head's scaled scores, -inf past N
    auto load_k = [&](int i) {
      if (i < items) {
        const int h = i / nkb, j = i % nkb;
        if (j == 0)
          hd_copy_tile<DP, ODD, AV3_BQ>(Qs + (h & 1) * TQ, base + (long long)h * d, ld, q0, N, d,
                                        pb, tid, AV_THREADS);
        hd_copy_tile<DP, ODD>(KV + (i & 1) * T, base + C + (long long)h * d, ld, j * HD_BLK, N,
                              d, pb, tid, AV_THREADS);
      }
      cp_async_commit();
    };
    load_k(0);
    for (int i = 0; i < items; ++i) {
      cp_async_wait<0>();
      __syncthreads();  // item i in; item i - 1's products done
      load_k(i + 1);
      const int h = i / nkb, j = i % nkb;
      const unsigned char* Kt = KV + (i & 1) * T;
      uint32_t qa[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) av_load_a<DP>(qa[kk], Qs + (h & 1) * TQ, 0, kk, lane);
      float s[2][4] = {};  // keys 16 warp .. 16 warp + 15 of the block
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t kf[4];
        av_load_k<DP>(kf, Kt, 16 * warp, kk, lane);
        mma_16816(s[0], qa[kk], kf[0], kf[1]);
        mma_16816(s[1], qa[kk], kf[2], kf[3]);
      }
      float* sh = S + (long long)h * AV3_BQ * lds;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * HD_BLK + 16 * warp + 8 * u + 2 * t + (e & 1);
          sh[(g + 8 * (e >> 1)) * lds + col] = col < N ? s[u][e] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // phase 2: every row's max, exps (in place, fp32) and 1 / sum
    for (int row = warp; row < H * AV3_BQ; row += AV_THREADS / 32) {
      float* sr = S + (long long)row * lds;
      float mx = -INFINITY;
      for (int c = lane; c < N; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int c = lane; c < np; c += 32) {
        const float p = __expf(sr[c] - mx);  // 0 past N
        sum += p;
        sr[c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) sr[np] = 1.f / sum;
    }
    __syncthreads();

    // phase 3: every head's P V, each warp its 16-column groups
    auto load_v = [&](int i) {
      if (i < items)
        hd_copy_tile<DP, ODD>(KV + (i & 1) * T, base + 2 * C + (long long)(i / nkb) * d, ld,
                              (i % nkb) * HD_BLK, N, d, pb, tid, AV_THREADS);
      cp_async_commit();
    };
    load_v(0);
    float o[GPW][2][4] = {};
    for (int i = 0; i < items; ++i) {
      cp_async_wait<0>();
      __syncthreads();
      load_v(i + 1);
      const int h = i / nkb, j = i % nkb;
      if (j == 0) {
#pragma unroll
        for (int u = 0; u < GPW; ++u)
#pragma unroll
          for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[u][w][e] = 0.f;
      }
      const float* ph = S + (long long)h * AV3_BQ * lds;
      const unsigned char* Vt = KV + (i & 1) * T;
      for (int kc = 0; kc < HD_BLK / 16; ++kc) {
        const int k = j * HD_BLK + 16 * kc;
        if (k >= N) break;
        const float2 p0 = *reinterpret_cast<const float2*>(ph + g * lds + k + 2 * t);
        const float2 p1 = *reinterpret_cast<const float2*>(ph + (g + 8) * lds + k + 2 * t);
        const float2 p2 = *reinterpret_cast<const float2*>(ph + g * lds + k + 8 + 2 * t);
        const float2 p3 = *reinterpret_cast<const float2*>(ph + (g + 8) * lds + k + 8 + 2 * t);
        const uint32_t a[4] = {pack_bf16(p0.x, p0.y), pack_bf16(p1.x, p1.y),
                               pack_bf16(p2.x, p2.y), pack_bf16(p3.x, p3.y)};
#pragma unroll
        for (int u = 0; u < GPW; ++u) {
          const int grp = warp + 4 * u;
          if (grp >= DP / 16) continue;
          uint32_t vf[4];
          av_load_v<DP>(vf, Vt, 16 * kc, 16 * grp, lane);
          mma_16816(o[u][0], a, vf[0], vf[1]);
          mma_16816(o[u][1], a, vf[2], vf[3]);
        }
      }
      if (j == nkb - 1) {
        const float inv0 = ph[g * lds + np], inv1 = ph[(g + 8) * lds + np];
        bf16* ob = out + ((long long)b * N + q0) * C + (long long)h * d;
#pragma unroll
        for (int u = 0; u < GPW; ++u) {
          const int grp = warp + 4 * u;
          if (grp >= DP / 16) continue;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const int c = 16 * grp + 8 * w + 2 * t;
            if (c >= d) continue;
            if (q0 + g < N)
              hd_store_pair<ODD>(ob + (long long)g * C, c, d, o[u][w][0] * inv0,
                                 o[u][w][1] * inv0);
            if (q0 + g + 8 < N)
              hd_store_pair<ODD>(ob + (long long)(g + 8) * C, c, d, o[u][w][2] * inv1,
                                 o[u][w][3] * inv1);
          }
        }
      }
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename K>
static cudaError_t av_smem_attr(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the attention core of `variant` at padded head width DP on packed (B*N,
// 3C) qkv into (B*N, C) out, C = H d; work: v3's workspace where av3_plan
// stages in it
template <int DP>
cudaError_t launch_variant_dp(int variant, const bf16* qkv, bf16* out, float* work, int B, int N,
                              int H, int d, float scale, cudaStream_t st) {
  const bool odd = d & 1;
  const int pb = hd_piece_bytes(d);
  const int qtiles = (N + AV_BQ - 1) / AV_BQ;
  cudaError_t err;
  if (variant == 3) {
    const Av3Plan plan = av3_plan(DP, B, N, H);
    if (!plan.in_smem && work == nullptr) return cudaErrorInvalidValue;
    auto kernel = odd ? variant3_kernel<DP, true> : variant3_kernel<DP, false>;
    if ((err = av_smem_attr(kernel, plan.smem)) != cudaSuccess) return err;
    const int q3 = (N + AV3_BQ - 1) / AV3_BQ;
    kernel<<<plan.grid, AV_THREADS, plan.smem, st>>>(qkv, out, plan.in_smem ? nullptr : work, N,
                                                      H, d, q3, B * q3, scale, pb);
    return cudaGetLastError();
  }
  if (variant == 2 && H >= 2) {
    auto kernel = odd ? variant2_kernel<DP, true> : variant2_kernel<DP, false>;
    if ((err = av_smem_attr(kernel, AV2_SMEM<DP>)) != cudaSuccess) return err;
    kernel<<<qtiles * B * (H / 2), AV_THREADS, AV2_SMEM<DP>, st>>>(qkv, out, N, H, d, qtiles,
                                                                    scale, pb);
    if ((err = cudaGetLastError()) != cudaSuccess || H % 2 == 0) return err;
  }
  // v1, or v2's odd last head alone
  const int head0 = variant == 2 ? H - 1 : 0, nh = H - head0;
  auto kernel = odd ? variant1_kernel<DP, true> : variant1_kernel<DP, false>;
  if ((err = av_smem_attr(kernel, AV1_SMEM<DP>)) != cudaSuccess) return err;
  kernel<<<qtiles * B * nh, AV_THREADS, AV1_SMEM<DP>, st>>>(qkv, out, N, H, d, head0, nh, qtiles,
                                                            scale, pb);
  return cudaGetLastError();
}

// the explicit instantiation of launch_variant_dp<DP>
#define D2S_AV_LAUNCH(DP)                                                                     \
  template cudaError_t launch_variant_dp<DP>(int, const bf16*, bf16*, float*, int, int, int, \
                                             int, float, cudaStream_t)

}  // namespace d2s
