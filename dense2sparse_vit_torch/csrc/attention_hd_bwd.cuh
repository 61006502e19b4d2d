// The attention core's backward at head widths other than 64 (and at 64
// past ATT_SHORT_N tokens): the kernel and its launch at each padded
// width, for sm_90a. Each padded width's launch is instantiated in one of
// attention_hd_bwd.cu (16 to 64), attention_hd_bwd_dp80.cu (80 to 128),
// attention_hd_bwd_dp144.cu (144 to 192) and attention_hd_bwd_dp208.cu (208
// to 256), so that nvcc builds them in parallel.
#pragma once

#include "attention_hd.cuh"

namespace d2s {

// dQ of a sample-head whose attention_hd_bwd_kernel passes are split:
// dqkv[m][c] = bf16 of the sum over the splits, in order, of part[split][m][c],
// for the M rows and C columns; two columns a thread (at an odd C, which
// the packed attention takes, element by element, the last thread of a row
// with one)
static __global__ void reduce_q_kernel(const float* __restrict__ part, bf16* __restrict__ dqkv,
                                       long long M, int C, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c2 = (C + 1) / 2;
  if (i >= M * c2) return;
  const long long m = i / c2;
  const int c = (int)(i % c2) * 2;
  float2 acc = make_float2(0.f, 0.f);
  if (C & 1) {
    for (int sp = 0; sp < splits; ++sp) {
      const float* v = part + ((long long)sp * M + m) * C + c;
      acc.x += v[0];
      if (c + 1 < C) acc.y += v[1];
    }
    hd_store_pair<true>(dqkv + m * 3 * C, c, C, acc.x, acc.y);
    return;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const float2 v = *reinterpret_cast<const float2*>(part + ((long long)sp * M + m) * C + c);
    acc.x += v.x;
    acc.y += v.y;
  }
  *reinterpret_cast<uint32_t*>(dqkv + m * 3 * C + c) = pack_bf16(acc.x, acc.y);
}

// ---- the core's backward at head widths other than 64 ----------------------
//
// attention_hd_bwd_kernel computes what attention_bwd_kernel computes, in
// its modes (plain; policy, with dPolicy's per-head partials summed by
// sum_heads_kernel; the CLS fold), for every head width d from 1 to 256 (the
// layout and product notes of attention_hd.cuh): dQ, dK and dV from qkv,
// dO and the forward's float4 statistics, deterministic (no atomics, the
// same bits every launch), every N up to hd_max_tokens (attention_hd.cuh),
// and at d = 64 every N past ATT_SHORT_N (the forward's attention_kernel
// stops there; its pair, attention_hd_kernel, takes over both ways). What
// grows with N in shared memory is each query row's statistics (16 B a
// row); the keys' pol_j and gcls_j are read from device memory for the
// pass's own keys, so that d = 96 reaches 4544 tokens, d = 128 1920.
// What bounds it: at B=64, N=197, d=96 (8 heads) its bytes (qkv, O and dO
// read, dqkv written, ~0.04 ms on the H100, 700 W) against ~19 GFLOP of
// products (five of N x N x d per sample-head). The design, one launch, a
// CTA of two warpgroups per sample-head:
//   - the prologue, the whole CTA, while the first pass's copies run: each
//     query row's statistics in shared memory, (lse or the max m, 1 / den,
//     D = rowsum(dO * O), the max path's gmx), a segment of lanes a row
//     (8 to 32 lanes by the width, so several rows a warp at d = 12) over
//     coalesced pairs, four rows' loads in flight; in policy mode
//     colsum(V), with gcls the CLS fold D_0 += sum_j gcls_j P_0j (P_0j from
//     row 0's scores in fp32), each summed in a fixed order;
//   - passes over the key blocks two at a time: warpgroup w owns key block
//     2p + w of pass p (past the last block: every key masked), its K and V
//     in shared memory and its dK and dV in registers for the pass, while
//     the query blocks stream through a ring of Q and dO tiles (cp.async,
//     ring - 1 blocks ahead). Per query block each warpgroup forms S^T = K
//     Q^T and dP^T = V dO^T for its 64 keys, 32 queries at a time (16 at d >
//     96; wgmma m64n32k16 or n16, the forward's instruction with the
//     operands' roles swapped), turns them into P^T and dS^T (scaled) in registers, adds dV
//     += P^T dO and dK += dS^T Q (wgmma m64nDPk16, A from registers, dO and
//     Q MN-major from the ring) and stores dS^T to a stage. Five products,
//     S and dP once per (query block, key block);
//   - dQ: once both warpgroups have staged a query block, each forms half
//     of dQ_i's columns over the pass's 128 keys (wgmma, the stage as an
//     MN-major A, K as an MN-major B; the same instructions in both
//     warpgroups) and adds it to the fp32 sum of the earlier passes, which
//     a cp.async group brought into shared memory while the products ran;
//     the sum goes back to dq_acc ((B*N, C), a sample-head's rows touched by
//     its own CTA alone, in pass order), the last pass writing bf16 into
//     dqkv. With one pass (N <= 128) there is no dq_acc;
//   - past ATT_SHORT_N tokens a sample-head's passes are split over CTAs,
//     HD_BWD_PASSES (4, 512 keys) a CTA (hd_bwd_splits: 3 at N = 1025, 8 at
//     3601), since one CTA a sample-head leaves most SMs idle there (DINO-S/8
//     at 480 px, B = 2: 12 CTAs). A pass owns its keys, so dK, dV and
//     dPolicy are still written once; each split sums dQ over its own passes
//     into its slice of dq_acc ((splits, B*N, C) fp32, the prologue run by
//     every split alike), and reduce_q_kernel adds the slices in split order
//     into dqkv: no atomics, the same bits every launch. Up to 800 tokens
//     nothing changes;
//   - past DP = HD_NARROW (d > 128) two key blocks' tiles and a ring no
//     longer fit (369,928 B at DP = 256), so a pass takes one key block,
//     which both warpgroups share: each forms the same S^T and dP^T (the
//     same instructions on the same tiles: the same bits, so the policy
//     tie test holds), warpgroup 0 alone stages dS^T, and the key block's
//     dK, dV and dQ columns are cut into 2 or 4 parts (hd_bwd_parts), the
//     parts 2s + w warpgroup w's on the pass's s-th run over the queries.
//     dQ's sum of the earlier passes is read from dq_acc by the thread that
//     wrote it (no staging). So d = 256 takes 1088 tokens both ways, d =
//     129 to 144 6720 (hd_max_tokens); the score products run 2 or 4 times;
//   - dPolicy_j is a sum over the queries of key j's row of the
//     warpgroup's own accumulators: summed in registers in query order,
//     then across the quad, one partial per head.
// Policy mode's max path is attention_bwd_kernel's: gmx_i goes to the
// columns whose scaled score equals the forward's stored max, split evenly
// over the ties it counted; the scores are the forward's bits, so the test
// finds the forward's maxima (checked on planted ties on the card). What
// still holds it back: one CTA an SM (dK and dV take up to 96 registers a
// thread), whose two warpgroups run the same phases in step (copies,
// products, softmax, the dQ sum), so little of one phase hides behind
// another's. Its times are in PERF.md.

// dQ of query block rows qa, qa + 8 (this thread's), columns c0 .. c0 + CN -
// 1 of the head (those from c_end on are dropped): the stage's dS^T (64 keys x
// 64 queries a key block, the MN-major A of dS) times the key blocks' K
// (MN-major B), over the pass's KB key blocks (a block past the last holds
// zeros); added to the earlier passes' fp32 sum (KB = 2: its copy in shared
// memory, dqs: rows of d from the block's first, qs; KB = 1: dq_acc itself,
// which this thread wrote), into dq_acc (rows ld apart), or, at the last
// pass, written bf16 into dq; element by element at an odd d (ODD)
template <int DP, int CN, int KB, bool ODD>
__device__ __forceinline__ void hd_dq_chunk(const unsigned char* stg, const unsigned char* kv,
                                            int c0, const float* dqs, int qs, float* dq_acc,
                                            bf16* dq, long long ld, long long ld3, int qa, int N,
                                            int d, int c_end, int t, bool first, bool last) {
  constexpr int SB = HD_BLK * HD_BLK * 2;
  constexpr int T = HD_TILE<DP>;
  float acc[CN / 2];
  const unsigned char* kc = kv + (c0 / 8) * 128;
  wgmma_fence();
#pragma unroll
  for (int w2 = 0; w2 < KB; ++w2)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      HdMma<CN>::template ss<1, 1>(acc, hd_mdesc<HD_BLK>(stg + w2 * SB + ks * 2048),
                                   hd_mdesc<DP>(kc + w2 * 2 * T + ks * 2 * DP * 16),
                                   w2 + ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int j = 0; j < CN / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    if (c >= c_end) continue;
    const bool two = c + 1 < c_end;  // false at an odd d's last column alone
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qa + 8 * r;
      if (q >= N) continue;
      float2 v = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (!first) {
        const float* prev = KB == 1 ? dq_acc + q * ld + c : dqs + (q - qs) * d + c;
        if (ODD) {
          v.x += prev[0];
          if (two) v.y += prev[1];
        } else {
          const float2 pv = *reinterpret_cast<const float2*>(prev);
          v = make_float2(pv.x + v.x, pv.y + v.y);
        }
      }
      if (last) {
        hd_store_pair<ODD>(dq + q * ld3, c, d, v.x, v.y);
      } else if (ODD) {
        dq_acc[q * ld + c] = v.x;
        if (two) dq_acc[q * ld + c + 1] = v.y;
      } else {
        *reinterpret_cast<float2*>(dq_acc + q * ld + c) = v;
      }
    }
  }
}

// The column parts of dK, dV and dQ a pass of attention_hd_bwd_kernel forms
// one at a time at padded width DP, and their width: up to HD_NARROW one
// part (two at DP >= 112, so that dK and dV fit the registers beside the
// rest), both warpgroups on the same part of their own key blocks; past it
// 2 (DP <= 192) or 4 parts of at most 96 columns, warpgroup w taking the
// parts 2s + w of the one key block, rounded up to an n of HdMma (the last
// part's columns past DP read past its tile, in shared memory, and are
// dropped)
__host__ __device__ constexpr int hd_bwd_parts(int DP) {
  return DP > HD_NARROW ? 2 * ((DP + 191) / 192) : DP >= 112 ? 2 : 1;
}
__host__ __device__ constexpr int hd_bwd_part_cols(int DP) {
  return DP > HD_NARROW ? hd_mma_n((DP + hd_bwd_parts(DP) - 1) / hd_bwd_parts(DP))
                        : DP / hd_bwd_parts(DP);
}

// a CTA per sample-head (blockIdx.x) and split of its passes (blockIdx.y:
// passes per y .. per y + per - 1), 256 threads. qkv (B, N, 3C) with token
// rows q_ld elements apart and samples q_bstride apart, o and dout (B*N, C),
// st the forward's (B, H, N) float4 statistics, dqkv (B*N, 3C) packed;
// policy mode: pol (B, N), dpol_part (B, H, N) or null; gcls (B, H, N) or
// null; dq_acc (splits, B*N, C) fp32 past one pass, else null: with one
// split the sum of dQ over the passes, the last writing dQ to dqkv; with
// more, each split's own sum, which reduce_q_kernel adds in split order;
// pb: the copies' bytes (hd_piece_bytes); ODD: d is odd (its own
// instantiation, so that the even widths' code is unchanged; its gathered
// copies take more registers than two CTAs an SM leave a thread)
template <int DP, bool POLICY, bool ODD>
// plain mode at an even d <= 16: two CTAs an SM
static __global__ void __launch_bounds__(256, DP == 16 && !POLICY && !ODD ? 2 : 1)
    attention_hd_bwd_kernel(const bf16* __restrict__ qkv, long long q_bstride, int q_ld, int d,
                            const bf16* __restrict__ o, const bf16* __restrict__ o_res,
                            const bf16* __restrict__ dout,
                            const float4* __restrict__ st, const float* __restrict__ pol,
                            const float* __restrict__ gcls, bf16* __restrict__ dqkv,
                            float* __restrict__ dpol_part, float* __restrict__ dq_acc, int N,
                            int H, float scale, float eps, int ring, int pb, int per) {
  constexpr int T = HD_TILE<DP>;
  constexpr int SB = HD_BLK * HD_BLK * 2;  // a stage tile: 64 keys x 64 queries
  constexpr int SN = hd_score_n(DP);       // the queries of a step: the score products' n
  constexpr bool WIDE = DP > HD_NARROW;    // one key block a pass, shared by the warpgroups
  constexpr int KB = hd_bwd_kb(DP);        // key blocks a pass
  extern __shared__ __align__(128) unsigned char hb_smem[];
  const int nb = (N + HD_BLK - 1) / HD_BLK;  // query blocks, and key blocks
  const int rows = nb * HD_BLK;
  unsigned char* KV = hb_smem;                                // [key block of the pass][K, V]
  unsigned char* Ring = KV + KB * 2 * T;                      // [slot][Q, dO]
  unsigned char* Stg = Ring + (size_t)ring * 2 * T;           // [buffer][key block] dS^T
  float* Dqs = reinterpret_cast<float*>(Stg + (WIDE ? 1 : 4) * SB);  // dQ of the earlier passes
  float2* Rs0 = reinterpret_cast<float2*>(Dqs + (WIDE ? 0 : HD_BLK * DP));  // (lse or m, D)
  float2* Rs1 = Rs0 + rows;                                   // policy mode: its (1 / den, gmx)
  float* Cv = reinterpret_cast<float*>(Rs1 + rows);           // colsum(V)
  float* Cvp = Cv + DP;                                       // its segments' parts
  float* Fold = Cvp + 8 * 32 / hd_seg(DP) * DP;               // the fold's segment sums, totals

  const int C = H * d;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;  // the CTA's warp
  const int wg = tid >> 7;
  const int warp = wid & 3;  // the warpgroup's
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* base = qkv + (long long)b * q_bstride + h * d;
  const bf16* dbase = dout + (long long)b * N * C + h * d;
  const bf16* obase = o + (long long)b * N * C + h * d;
  const bf16* rbase = o_res ? o_res + (long long)b * N * C + h * d : nullptr;
  const long long srow = (long long)bh * N;
  const long long ld3 = 3LL * C;
  const float cc = POLICY ? eps / N : 0.f;
  // query block i's Q and dO into its ring slot; a commit group each, empty
  // past the last block
  auto load_q = [&](int i) {
    if (i < nb) {
      unsigned char* slot = Ring + (size_t)(i % ring) * 2 * T;
      hd_copy_tile<DP, ODD>(slot, base, q_ld, i * HD_BLK, N, d, pb, tid, 256);
      hd_copy_tile<DP, ODD>(slot + T, dbase, C, i * HD_BLK, N, d, pb, tid, 256);
    }
    cp_async_commit();
  };
  // pass p's K and V with the first query blocks' Q and dO, which complete
  // with the first group
  auto start_pass = [&](int p) {
#pragma unroll
    for (int w2 = 0; w2 < KB; ++w2) {
      unsigned char* kv = KV + w2 * 2 * T;
      const int k0 = (KB * p + w2) * HD_BLK;
      hd_copy_tile<DP, ODD>(kv, base + C, q_ld, k0, N, d, pb, tid, 256);
      hd_copy_tile<DP, ODD>(kv + T, base + 2 * C, q_ld, k0, N, d, pb, tid, 256);
    }
    for (int i = 0; i + 1 < ring; ++i) load_q(i);
  };
  // this CTA's passes, p0 .. p1 - 1; with more than one split its dQ is a
  // partial sum, written in fp32 to its own slice of dq_acc
  const int passes = (nb + KB - 1) / KB;
  const int p0 = blockIdx.y * per, p1 = min(passes, p0 + per);
  const bool split = gridDim.y > 1;
  start_pass(p0);  // its copies run during the prologue

  // The prologue, over a head's rows of d columns: a segment of SEG lanes a
  // row (its column pairs, PPL a lane), RPW rows a warp at once, U of those
  // in flight; a segment's sums by shuffles within it, in a fixed order.
  constexpr int SEG = hd_seg(DP), RPW = 32 / SEG, PPL = (DP / 2 + SEG - 1) / SEG, U = 4;
  const int sub = lane / SEG, sl = lane % SEG;
  auto seg_sum = [](float v) {
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  };
  // the rows' statistics as the forward stored them; colsum(V)'s parts; the
  // fold's parts (the keys' policy and gcls are read per pass, below)
  for (int r = tid; r < rows; r += 256)
    Rs0[r] = Rs1[r] = make_float2(0.f, 0.f);  // rows past N: zero probabilities below
  if (POLICY) {  // segment (wid, sub) sums rows wid RPW + sub, + 8 RPW, ...
    float a[2 * PPL];
#pragma unroll
    for (int k = 0; k < 2 * PPL; ++k) a[k] = 0.f;
#pragma unroll 4
    for (int r = wid * RPW + sub; r < N; r += 8 * RPW) {
      const bf16* v = base + 2 * C + (long long)r * q_ld;
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const int c = 2 * (sl + SEG * k);
        if (c < d) {
          const float2 f = hd_pair<ODD>(v, c, d);
          a[2 * k] += f.x;
          a[2 * k + 1] += f.y;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int c = 2 * (sl + SEG * k);
      if (c < d) {
        Cvp[(wid * RPW + sub) * DP + c] = a[2 * k];
        Cvp[(wid * RPW + sub) * DP + c + 1] = a[2 * k + 1];
      }
    }
  }
  if (gcls) {
    // D_0 += sum_j gcls_j P_0j, P_0j from row 0's scores in fp32: a key a
    // segment, the segments' sums added in order below
    const float4 s0 = st[srow];
    const float rd0 = POLICY ? 1.f / s0.y : 0.f;
    float acc = 0.f, gs = 0.f;
    for (int j0 = wid * U * RPW; j0 < N; j0 += 8 * U * RPW) {
      float dot[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * RPW + sub;
        const bf16* kj = base + C + (long long)j * q_ld;
        dot[u] = 0.f;
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          const int c = 2 * (sl + SEG * k);
          if (j < N && c < d) {
            const float2 qv = hd_pair<ODD>(base, c, d), kv = hd_pair<ODD>(kj, c, d);
            dot[u] += qv.x * kv.x + qv.y * kv.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * RPW + sub;
        const float dt = seg_sum(dot[u]);
        if (j >= N) continue;
        float p;
        if (POLICY) {
          const float pk = pol[(long long)b * N + j];
          p = (__expf(dt * scale - s0.x) * (j == 0 ? pk + (1.f - pk) : pk) + cc) * rd0;
        } else {
          p = __expf(dt * scale - s0.x);
        }
        const float gj = gcls[srow + j];
        acc += gj * p;
        gs += gj;
      }
    }
    if (sl == 0) {
      Fold[wid * RPW + sub] = acc;
      Fold[32 + wid * RPW + sub] = gs;
    }
  }
  __syncthreads();
  if (POLICY && tid < DP) {  // zero past d: an odd d's pair reads column d
    float a = 0.f;
    if (tid < d)
      for (int w = 0; w < 8 * RPW; ++w) a += Cvp[w * DP + tid];
    Cv[tid] = a;
  }
  if (gcls && tid == 0) {
    float a = 0.f, gs = 0.f;
    for (int w = 0; w < 8 * RPW; ++w) {
      a += Fold[w];
      gs += Fold[32 + w];
    }
    Fold[64] = a;  // sum_j gcls_j P_0j
    Fold[65] = gs;  // sum_j gcls_j
  }
  __syncthreads();
  // each real row's (lse or m, 1 / den, D, gmx), a segment a row: D =
  // rowsum(dO * O) (row 0 with the fold; O its bf16 copy plus o_res, as
  // attention_bwd_kernel takes it), and in policy
  // mode the max path's gmx_i = (c / den_i) (dO_i . colsum(V) - N D_i) over
  // the row's ties
  for (int r0 = wid * U * RPW; r0 < N; r0 += 8 * U * RPW) {
    float Du[U], dvu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RPW + sub;
      const long long at = (long long)r * C;
      Du[u] = dvu[u] = 0.f;
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const int c = 2 * (sl + SEG * k);
        if (r < N && c < d) {
          float2 ov = hd_pair<ODD>(obase + at, c, d);
          const float2 dov = hd_pair<ODD>(dbase + at, c, d);
          if (rbase) {
            const float2 rv = hd_pair<ODD>(rbase + at, c, d);
            ov = make_float2(ov.x + rv.x, ov.y + rv.y);
          }
          Du[u] += ov.x * dov.x + ov.y * dov.y;
          if (POLICY) dvu[u] += dov.x * Cv[c] + dov.y * Cv[c + 1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * RPW + sub;
      float D = seg_sum(Du[u]), dv = 0.f;
      if (POLICY) dv = seg_sum(dvu[u]);
      if (sl != 0 || r >= N) continue;
      const float4 sr = st[srow + r];  // (lse, ...) or (m, den, ties, 0)
      if (gcls && r == 0) {
        D += Fold[64];
        dv += Fold[65];  // sum_j dP_0j gains sum_j gcls_j
      }
      Rs0[r] = make_float2(sr.x, D);
      if (POLICY) {
        const float rd = 1.f / sr.y;
        Rs1[r] = make_float2(rd, cc * rd * (dv - N * D) / sr.z);
      }
    }
  }
  __syncthreads();

  const int wrow = warp * 16 + g;  // this thread's key rows of its block: wrow, wrow + 8
  // A pass runs NS times over the queries, each time for DV of dK's, dV's
  // and dQ's columns (hd_bwd_parts), the scores formed again: up to
  // HD_NARROW part ch of both warpgroups' own key blocks; past it part 2 ch +
  // wg of the pass's one key block
  constexpr int NP = hd_bwd_parts(DP), DV = hd_bwd_part_cols(DP), NS = WIDE ? NP / 2 : NP;
  for (int pc = p0 * NS; pc < p1 * NS; ++pc) {
    const int p = pc / NS, ch = WIDE ? 2 * (pc % NS) + wg : pc % NS;  // the pass, its part
    // this warpgroup's key block (past the last: all keys masked)
    const int jb = KB * p + (WIDE ? 0 : wg);
    if (pc > p0 * NS) start_pass(p);
    // dQ's sum (this split's), rows C apart
    float* acc = dq_acc + ((long long)blockIdx.y * (gridDim.x / H) + b) * N * C + h * d;
    const int c_end = min(d, (ch + 1) * DV);  // the part's columns: ch DV .. c_end - 1

    const unsigned char* Kt = KV + (WIDE ? 0 : wg) * 2 * T;
    const unsigned char* Vt = Kt + T;
    const int ka = jb * HD_BLK + wrow;  // this thread's keys ka, ka + 8
    // pol_j of those keys, 0 past N (and past the last block)
    float pk[2] = {0.f, 0.f};
    if (POLICY)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (jb < nb && ka + 8 * r < N) pk[r] = pol[(long long)b * N + ka + 8 * r];
    float dk[DV / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dk[i] = dv[i] = 0.f;
    float dpa[2] = {0.f, 0.f};  // dPolicy of keys ka, ka + 8 over the queries so far

    for (int i = 0; i < nb; ++i) {
      if (ring == 2) cp_async_wait<0>();
      else cp_async_wait<1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // Q_i and dO_i in; both warpgroups past query block i - 1
      if (!WIDE && p > p0) {
        // the earlier passes' dQ of query block i ([64][d] fp32), for its sum
        // after the products below: a commit group of its own, before the
        // ring's; pieces of 4, 2 or 1 floats by the rows' alignment
        const int lg = ODD ? 0 : (d & 3) == 0 ? 2 : 1;  // log2 of the floats a piece
#pragma unroll 1
        for (int k = tid; k < (HD_BLK * d) >> lg; k += 256) {
          const int r = (k << lg) / d, c = (k << lg) % d;
          const int q = i * HD_BLK + r;
          hd_cp_async(Dqs + r * d + c, acc + (q < N ? (long long)q * C + c : 0), 4 << lg, q < N);
        }
      }
      cp_async_commit();
      load_q(i + ring - 1);
      const unsigned char* Qt = Ring + (size_t)(i % ring) * 2 * T;
      const unsigned char* dOt = Qt + T;
      unsigned char* stg = WIDE ? Stg : Stg + ((i & 1) * 2 + wg) * SB;
      uint32_t pa[SN / 16][4], da[SN / 16][4];  // P^T, dS^T of 16 queries each: A fragments
#pragma unroll
      for (int k = 0; k < SN / 4; ++k) pa[k >> 2][k & 3] = da[k >> 2][k & 3] = 0u;
#pragma unroll 1
      for (int hq = 0; hq < HD_BLK / SN; ++hq) {  // queries i 64 + SN hq .. + SN - 1
        float s[SN / 2], dp[SN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          HdMma<SN>::template ss<0, 0>(s, hd_kdesc<DP>(Kt + kk * 256),
                                       hd_kdesc<DP>(Qt + hq * (SN / 8) * DP * 16 + kk * 256), kk);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          HdMma<SN>::template ss<0, 0>(dp, hd_kdesc<DP>(Vt + kk * 256),
                                       hd_kdesc<DP>(dOt + hq * (SN / 8) * DP * 16 + kk * 256),
                                       kk);
        wgmma_commit();
        wgmma_wait<0>();  // and the last half's dV and dK products, which read pa and da
        fence_acc(s);
        fence_acc(dp);
#pragma unroll
        for (int k = 0; k < SN / 16; ++k) {
          fence_acc(pa[k]);
          fence_acc(da[k]);
        }
        // P^T and dS^T scaled: element e is key ka + 8 ((e >> 1) & 1), query
        // i 64 + SN hq + 8 (e >> 2) + 2t + (e & 1)
#pragma unroll
        for (int e = 0; e < SN / 2; ++e) {
          const int r = (e >> 1) & 1;
          const int key = ka + 8 * r;
          const int q = i * HD_BLK + SN * hq + 8 * (e >> 2) + 2 * t + (e & 1);
          const bool valid = key < N && q < N;
          const float2 r0 = Rs0[q];  // (lse or m, D)
          float dpv = dp[e];
          if (gcls != nullptr && q == 0 && jb < nb) dpv += key < N ? gcls[srow + key] : 0.f;
          if (POLICY) {
            const float2 r1 = Rs1[q];  // (1 / den, gmx)
            const float v = s[e] * scale;
            const float xe = valid ? __expf(v - r0.x) : 0.f;
            const float a = pk[r];
            const float ew = xe * (key == q ? a + (1.f - a) : a);
            const float de = (dpv - r0.y) * r1.x;
            if (dpol_part != nullptr && key != q) dpa[r] += de * xe;  // the diagonal left out
            float dsv = de * ew;
            if (valid && v == r0.x) dsv += r1.y;  // the max path, at a tie
            s[e] = valid ? (ew + cc) * r1.x : 0.f;
            dp[e] = dsv * scale;
          } else {
            const float pv = valid ? __expf(s[e] * scale - r0.x) : 0.f;
            s[e] = pv;
            dp[e] = pv * (dpv - r0.y) * scale;
          }
        }
#pragma unroll
        for (int k = 0; k < SN / 16; ++k) {
          hd_pack_a(pa[k], s, k);
          hd_pack_a(da[k], dp, k);
        }
        // dS^T into the stage, (key, query) at the MN-major A layout of dS:
        // the A fragments' pairs, da[jq / 2][2 (jq % 2) + r] for keys wrow +
        // 8 r and queries 8 jq + 2t, + 1 of the step's (past HD_NARROW the
        // warpgroups hold the same dS^T: the first stages it)
        if (!WIDE || wg == 0) {
#pragma unroll
          for (int jq = 0; jq < SN / 8; ++jq)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<uint32_t*>(
                  stg + hd_at<HD_BLK>(wrow + 8 * r, SN * hq + 8 * jq + 2 * t)) =
                  da[jq >> 1][2 * (jq & 1) + r];
        }
        // dV += P^T dO, dK += dS^T Q over the step's queries, 16 at a time
#pragma unroll
        for (int k = 0; k < SN / 16; ++k) {
          fence_acc(pa[k]);
          fence_acc(da[k]);
        }
        fence_acc(dv);
        fence_acc(dk);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < SN / 16; ++ks) {
          const int at = ((SN / 8) * hq + 2 * ks) * DP * 16 + ch * (DV / 8) * 128;
          HdMma<DV>::template rs<1>(dv, pa[ks], hd_mdesc<DP>(dOt + at), 1);
          HdMma<DV>::template rs<1>(dk, da[ks], hd_mdesc<DP>(Qt + at), 1);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
#pragma unroll
      for (int k = 0; k < SN / 16; ++k) {
        fence_acc(pa[k]);
        fence_acc(da[k]);
      }
      cp_async_wait<1>();  // the earlier passes' dQ (and all but the newest ring group)
      // the stage's generic-proxy writes, before the dQ products' wgmma reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // the key blocks' dS^T of query block i staged; Q_i, dO_i read
      const int qa = i * HD_BLK + wrow;
      bf16* dq = dqkv + (long long)b * N * ld3 + h * d;
      const bool first = p == p0, last = p + 1 == p1 && !split;
      if (WIDE) {
        // dQ_i over the pass's key block: warpgroup w its part's columns
        hd_dq_chunk<DP, DV, 1, ODD>(Stg, KV, ch * DV, nullptr, 0, acc, dq, C, ld3, qa, N, d, c_end,
                               t, first, last);
      } else {
        // dQ_i over the pass's keys, added to the earlier passes': warpgroup
        // w the part's DQ0 columns from w DQ0 (the same instructions in both,
        // so no wgmma sits on a divergent path; columns past the part are
        // dropped, and the K columns they read past the tile lie in shared
        // memory)
        constexpr int DQ0 = (DV + 31) / 32 * 16;
        const unsigned char* st0 = Stg + (i & 1) * 2 * SB;
        hd_dq_chunk<DP, DQ0, 2, ODD>(st0, KV, ch * DV + wg * DQ0, Dqs, i * HD_BLK, acc, dq, C, ld3,
                                qa, N, d, c_end, t, first, last);
      }
    }
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    // dK and dV of the warpgroup's key block; dPolicy's partial of its keys
    bf16* drow = dqkv + (long long)b * N * ld3 + h * d;
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd) {
      const int c = ch * DV + nd * 8 + 2 * t;
      if (c >= c_end) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = ka + 8 * r;
        if (key >= N) continue;
        hd_store_pair<ODD>(drow + key * ld3 + C, c, d, dk[4 * nd + 2 * r], dk[4 * nd + 2 * r + 1]);
        hd_store_pair<ODD>(drow + key * ld3 + 2 * C, c, d, dv[4 * nd + 2 * r],
                      dv[4 * nd + 2 * r + 1]);
      }
    }
    if (POLICY && dpol_part != nullptr && ch == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = dpa[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && ka + 8 * r < N) dpol_part[srow + ka + 8 * r] = v;
      }
    }
    __syncthreads();  // the pass's K, V and ring read before the next pass refills them
  }
}

template <int DP>
cudaError_t launch_attention_hd_bwd_dp(const bf16* qkv, long long q_bstride, int q_ld, int d,
                                       const bf16* o, const bf16* o_res, const bf16* dout,
                                       float4* st, const float* pol, const float* gcls,
                                       bf16* dqkv, float* dpol_part, float* dq_acc, int B, int N,
                                       int H, float scale, float eps, cudaStream_t stream) {
  const int ring = hd_bwd_smem(DP, N, 3) <= HD_SMEM_MAX ? 3 : 2;
  const size_t smem = hd_bwd_smem(DP, N, ring);
  auto kernel = (d & 1) ? (pol ? attention_hd_bwd_kernel<DP, true, true>
                               : attention_hd_bwd_kernel<DP, false, true>)
                        : (pol ? attention_hd_bwd_kernel<DP, true, false>
                               : attention_hd_bwd_kernel<DP, false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // passes of KB key blocks: a split's 512 keys, or all
  constexpr int KB = hd_bwd_kb(DP);
  const int splits = hd_bwd_splits(N);
  const int per = splits > 1 ? HD_BWD_PASSES * 2 / KB : hd_bwd_passes(N, KB);
  kernel<<<dim3(B * H, splits), 256, smem, stream>>>(qkv, q_bstride, q_ld, d, o, o_res, dout, st,
                                                     pol, gcls, dqkv, dpol_part, dq_acc, N, H,
                                                     scale, eps, ring, hd_piece_bytes(d), per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++attention_hd_launches[1];
  ++attention_hd_dp_launches[1][DP / 16 - 1][d & 1];
  if (splits == 1) return cudaSuccess;
  const long long m = (long long)B * N, n2 = m * ((H * d + 1) / 2);
  reduce_q_kernel<<<(unsigned)((n2 + 255) / 256), 256, 0, stream>>>(dq_acc, dqkv, m, H * d,
                                                                   splits);
  return cudaGetLastError();
}

// the explicit instantiation of launch_attention_hd_bwd_dp<DP>
#define D2S_HD_BWD_LAUNCH(DP) \
  template cudaError_t launch_attention_hd_bwd_dp<DP>(                                           \
      const bf16*, long long, int, int, const bf16*, const bf16*, const bf16*, float4*,          \
      const float*, const float*, bf16*, float*, float*, int, int, int, float, float, cudaStream_t)

}  // namespace d2s
