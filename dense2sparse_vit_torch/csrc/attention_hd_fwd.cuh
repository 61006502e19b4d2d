// The attention core's forward at head widths other than 64 (and at 64 past
// ATT_SHORT_N tokens): the kernel and its launch at each padded width, for
// sm_90a. Each padded width's launch is instantiated in one of
// attention_hd_fwd.cu (16 to 64), attention_hd_fwd_dp80.cu (80 to 128),
// attention_hd_fwd_dp144.cu (144 to 192) and attention_hd_fwd_dp208.cu (208
// to 256), so that nvcc builds them in parallel.
#pragma once

#include "attention_hd.cuh"

namespace d2s {

// ---- the core at head widths other than 64 (attention_hd.cuh) ------------
//
// attention_hd_kernel computes what attention_kernel computes, in its three
// modes (plain, policy, the CLS rows), for every head width d from 1 to 256
// (odd widths: gathered copies and element-wise stores, attention_hd.cuh;
// past 128, P V as two products, hd_pv): the same exact fp32 row-max
// softmax, the same policy softmax,
// and the statistics the backward takes, always (B, H, N) float4 at these
// widths: (lse, 0, 0, 0) in plain mode, (max, den, ties, 0) in policy mode.
// What bounds it: bytes. At B=64, N=197, d=96 (8 heads) it reads qkv and
// writes its output, ~0.023 ms at 3.35 TB/s, against ~7.6 GFLOP of score and
// P.V products (~0.008 ms at the bf16 peak, ~0.012 ms with the padding to
// 64-key blocks); at d=12 (32 heads) ~0.012 ms of bytes, but ~4 times as
// many exponentials a byte. The design:
//   - a CTA is two warpgroups, each with one 64-row query block of a
//     sample-head, sharing the keys' tiles (grid: half the query blocks x
//     B H): each key reaches shared memory once per 128 queries, from L2
//     mostly, as the CTAs of one sample-head read the same K and V (one
//     warpgroup a CTA, or four, took longer on the card);
//   - one pass over the keys with an online softmax: per 64-key block, S =
//     Q K^T on wgmma (m64n32k16 chains, n16 at d > 96: hd_score_n; Q and
//     K from shared memory),
//     the block's row max (policy mode: of the scaled scores, with the
//     columns that reach it, merged into the running count as the max
//     moves), the running sums and the output rescaled by 2^(m_old -
//     m_new), p = 2^(s scale log2 e - m log2 e) (policy mode: times a_ij),
//     and O += P V on wgmma m64nDPk16 with P from registers, V from shared
//     memory as an MN-major operand. Nothing but the accumulators is
//     rescaled: in policy mode the smoothing's (eps/N) colsum(V) stays
//     apart, summed in fp32 from the V tiles as they pass, and added at the
//     end;
//   - the keys stream through a ring of `ring` (2 or 3) K and V tile pairs,
//     filled by cp.async (attention_hd.cuh) ring - 1 blocks ahead of the
//     products;
//   - the CLS rows: the threads of query row 0 keep its raw scores in
//     shared memory as the blocks pass and write the normalised row at the
//     end, against the final max and sum.
// Its times are in PERF.md.
// ODD: d is odd (its own instantiation, so that the even widths' code is
// unchanged: gathered copies, element-wise stores)
template <int DP, bool POLICY, bool RES, bool ODD>
static __global__ void __launch_bounds__(128 * HD_FWD_WG)
    attention_hd_kernel(const bf16* __restrict__ qkv, long long q_bstride, int q_ld, int d,
                        bf16* __restrict__ out, bf16* __restrict__ out_res,
                        float* __restrict__ lse, bf16* __restrict__ cls,
                        const float* __restrict__ pol, int N, int H, float scale, float eps,
                        int ring, int pb) {
  constexpr int T = HD_TILE<DP>;
  constexpr int NT = 128 * HD_FWD_WG;
  constexpr int CP = DP / 2;  // column pairs
  constexpr int GROUPS = hd_fwd_groups(DP);
  constexpr int SN = hd_score_n(DP), NH = HD_BLK / SN;  // a score chain's keys, chains a block
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char hd_smem[];
  const int nkb = (N + HD_BLK - 1) / HD_BLK;
  unsigned char* Qs = hd_smem;                   // the warpgroups' Q tiles
  unsigned char* KVs = Qs + HD_FWD_WG * T;       // the ring's (K, V) tile pairs
  float* Ps = reinterpret_cast<float*>(KVs + (size_t)ring * 2 * T);  // pol_j of every key
  float* Cvp = Ps + (POLICY ? nkb * HD_BLK : 0);  // colsum(V)'s parts, [group][DP]
  float* Row0 = Cvp + (POLICY ? GROUPS * DP : 0);  // with cls: row 0's raw scores

  const int C = H * d;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ct = tid & 127;
  const int lane = tid & 31;
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (blockIdx.x * HD_FWD_WG + wg) * HD_BLK;  // the warpgroup's query block
  const bf16* base = qkv + (long long)b * q_bstride + h * d;
  const float sl2 = scale * LOG2E;
  const float cc = POLICY ? eps / N : 0.f;
  const int ra = q0 + warp * 16 + g;  // this thread's query rows ra, ra + 8
  const bool row0 = cls != nullptr && ra == 0;
  const int cpair = ct % CP, cgrp = ct / CP;  // colsum: a column pair, a key group
  const unsigned char* Qt = Qs + wg * T;

  // key block j's K and V into its ring slot; a commit group each, empty
  // past the last block
  auto load_kv = [&](int j) {
    if (j < nkb) {
      unsigned char* slot = KVs + (size_t)(j % ring) * 2 * T;
      hd_copy_tile<DP, ODD>(slot, base + C, q_ld, j * HD_BLK, N, d, pb, tid, NT);
      hd_copy_tile<DP, ODD>(slot + T, base + 2 * C, q_ld, j * HD_BLK, N, d, pb, tid, NT);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int w = 0; w < HD_FWD_WG; ++w)  // rows past N (a CTA's spare block) are zeros
    hd_copy_tile<DP, ODD>(Qs + w * T, base, q_ld, (blockIdx.x * HD_FWD_WG + w) * HD_BLK, N, d,
                          pb, tid, NT);
  for (int j = 0; j + 1 < ring; ++j) load_kv(j);  // the first group holds Q too
  if (POLICY)
    for (int k = tid; k < nkb * HD_BLK; k += NT) Ps[k] = k < N ? pol[(long long)b * N + k] : 0.f;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ct2[2] = {0.f, 0.f};
  float lb[2] = {0.f, 0.f};   // RES: the sums of the bf16 p that P.V takes
  float cs[2] = {0.f, 0.f};  // policy mode: this thread's part of colsum(V)

  for (int j = 0; j < nkb; ++j) {
    wgmma_wait<0>();  // block j - 1's P V, whose V slot is refilled below
    fence_acc(o);
    if (ring == 2) cp_async_wait<0>();
    else cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // K_j and V_j in for every thread; every product of block j - 1 done
    load_kv(j + ring - 1);
    const unsigned char* Kt = KVs + (size_t)(j % ring) * 2 * T;
    const unsigned char* Vt = Kt + T;
    const int k0 = j * HD_BLK;

    // S = Q K^T for keys k0 + SN hh .. + SN - 1: m64nSNk16 from zero in kk order
    float s[NH][SN / 2];
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        HdMma<SN>::template ss<0, 0>(s[hh], hd_kdesc<DP>(Qt + kk * 256),
                                     hd_kdesc<DP>(Kt + hh * (SN / 8) * DP * 16 + kk * 256), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_acc(s[hh]);

    // the block's max per row (policy mode: of the scaled scores, and the
    // columns that reach it), columns past N left out; s[hh][i] is row
    // (i >> 1) & 1 (ra or ra + 8), column k0 + SN hh + 8 (i >> 2) + 2t + (i & 1)
    const bool edge = k0 + HD_BLK > N;
    float bm[2] = {-INFINITY, -INFINITY}, bc[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) {
        const int r = (i >> 1) & 1;
        if (edge && k0 + SN * hh + 8 * (i >> 2) + 2 * t + (i & 1) >= N) {
          s[hh][i] = -INFINITY;  // a probability of 0 below
          continue;
        }
        if (POLICY) max_count(s[hh][i] * scale, bm[r], bc[r]);
        else bm[r] = fmaxf(bm[r], s[hh][i]);
      }
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, bm[r], off);
        if (POLICY) {
          const float co = __shfl_xor_sync(0xffffffffu, bc[r], off);
          if (mo > bm[r]) bc[r] = co;
          else if (mo == bm[r]) bc[r] += co;
        }
        bm[r] = fmaxf(bm[r], mo);
      }
      // scale > 0, so the max of the scaled scores
      const float bmax = POLICY ? bm[r] : bm[r] * scale;
      const float mn = fmaxf(m[r], bmax);
      if (POLICY) ct2[r] = bmax > m[r] ? bc[r] : bmax == m[r] ? ct2[r] + bc[r] : ct2[r];
      const float alpha = att_exp2((m[r] - mn) * LOG2E);  // 0 at the first block
      m[r] = mn;
      ml[r] = mn * LOG2E;
      l[r] *= alpha;
      if (RES) lb[r] *= alpha;
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        o[4 * nd + 2 * r] *= alpha;
        o[4 * nd + 2 * r + 1] *= alpha;
      }
    }

    if (row0) {  // query row 0's raw scores, for the CLS row at the end
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int i = 0; i < SN / 2; ++i) {
          const int col = k0 + SN * hh + 8 * (i >> 2) + 2 * t + (i & 1);
          if (!(i & 2) && col < N) Row0[col] = s[hh][i];  // row ra, not ra + 8
        }
    }

    // p = 2^(s scale log2 e - m log2 e) (policy mode: times a_ij = pol_j,
    // pol_j + (1 - pol_j) on the diagonal), l += p, P as A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int col = k0 + SN * hh + 8 * (i >> 2) + 2 * t + (i & 1);
        float p = att_exp2(s[hh][i] * sl2 - ml[r]);
        if (POLICY) {
          const float a = Ps[col];  // zero past N
          p *= col == ra + 8 * r ? a + (1.f - a) : a;
        }
        l[r] += p;
        if (RES) lb[r] += __bfloat162float(__float2bfloat16_rn(p));
        s[hh][i] = p;
      }
#pragma unroll
      for (int kk = 0; kk < SN / 16; ++kk) hd_pack_a(pa[(SN / 16) * hh + kk], s[hh], kk);
    }
    if (POLICY && wg == 0 && cgrp < GROUPS) {  // colsum(V): rows past N are zero
      for (int k = cgrp; k < HD_BLK; k += GROUPS) {
        const __nv_bfloat162 v2 =
            *reinterpret_cast<const __nv_bfloat162*>(Vt + hd_at<DP>(k, 2 * cpair));
        cs[0] += __low2float(v2);
        cs[1] += __high2float(v2);
      }
    }

    // O += P V over the block's keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_acc(pa[kk]);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hd_pv<DP>(o, pa[kk], Vt + kk * 2 * DP * 16);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (POLICY) l[r] += eps;
    if (RES) {
      lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 1);
      lb[r] += __shfl_xor_sync(0xffffffffu, lb[r], 2);
      if (POLICY) lb[r] += eps;  // the smoothing's colsum(V) term is added in fp32
    }
  }
  if (POLICY) {  // colsum(V): the key groups' parts added in order
    if (wg == 0 && cgrp < GROUPS) {
      Cvp[cgrp * DP + 2 * cpair] = cs[0];
      Cvp[cgrp * DP + 2 * cpair + 1] = cs[1];
    }
    __syncthreads();
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const long long stat = (long long)blockIdx.y * N;  // (b, h) row of lse and cls
  if (lse && t == 0) {
    float4* st4 = reinterpret_cast<float4*>(lse);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ra + 8 * r < N)
        st4[stat + ra + 8 * r] = POLICY ? make_float4(m[r], l[r], ct2[r], 0.f)
                                        : make_float4(m[r] + logf(l[r]), 0.f, 0.f, 0.f);
  }
  if (cls && q0 == 0 && warp == 0) {
    // query row 0: its probabilities against the final max and sum (lanes
    // 0-3 hold them)
    __syncwarp();
    const float inv0 = __shfl_sync(0xffffffffu, inv[0], 0);
    const float ml0 = __shfl_sync(0xffffffffu, m[0], 0) * LOG2E;
    for (int col = lane; col < N; col += 32) {
      float v = att_exp2(Row0[col] * sl2 - ml0);
      if (POLICY) {
        const float a = Ps[col];
        v = v * (col == 0 ? a + (1.f - a) : a) + cc;
      }
      cls[stat + col] = __float2bfloat16(v * inv0);
    }
  }
  const long long oat = (long long)b * N * C + h * d;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c >= d) continue;
    float add0 = 0.f, add1 = 0.f;  // policy mode: (eps/N) colsum(V)
    if (POLICY) {
      for (int grp = 0; grp < GROUPS; ++grp) {
        add0 += Cvp[grp * DP + c];
        add1 += Cvp[grp * DP + c + 1];
      }
      add0 *= cc;
      add1 *= cc;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (ra + 8 * r >= N) continue;
      const float lo = (o[4 * nd + 2 * r] + add0) * inv[r];
      const float hi = (o[4 * nd + 2 * r + 1] + add1) * inv[r];
      const long long at = oat + (long long)(ra + 8 * r) * C + c;
      if (ODD) {  // element by element, column d left alone
        const bf16 vl = __float2bfloat16_rn(lo), vh = __float2bfloat16_rn(hi);
        out[at] = vl;
        if (c + 1 < d) out[at + 1] = vh;
        if (RES) {
          const float ib = 1.f / lb[r];
          out_res[at] = __float2bfloat16_rn((o[4 * nd + 2 * r] + add0) * ib -
                                            __bfloat162float(vl));
          if (c + 1 < d)
            out_res[at + 1] = __float2bfloat16_rn((o[4 * nd + 2 * r + 1] + add1) * ib -
                                                  __bfloat162float(vh));
        }
        continue;
      }
      const uint32_t v = pack_bf16(lo, hi);
      *reinterpret_cast<uint32_t*>(out + at) = v;
      if (RES) {  // O normalised by the bf16 probabilities P.V took, less v
        const float ib = 1.f / lb[r];
        *reinterpret_cast<uint32_t*>(out_res + at) = pack_bf16_residual(
            (o[4 * nd + 2 * r] + add0) * ib, (o[4 * nd + 2 * r + 1] + add1) * ib, v);
      }
    }
  }
}

template <int DP>
cudaError_t launch_attention_hd_dp(const bf16* qkv, long long q_bstride, int q_ld, int d,
                                   bf16* out, bf16* out_res, float* lse, bf16* cls,
                                   const float* pol, int B, int N, int H, float scale, float eps,
                                   cudaStream_t stream) {
  // the ring: three slots where two CTAs still fit an SM's 228 KB, else two
  const bool policy = pol != nullptr, with_cls = cls != nullptr;
  const int ring = 2 * (hd_fwd_smem(DP, N, 3, policy, with_cls) + 1024) <= 233472 ? 3 : 2;
  const size_t smem = hd_fwd_smem(DP, N, ring, policy, with_cls);
  auto pick = [&](auto odd) {
    constexpr bool ODD = decltype(odd)::value;
    return pol ? (out_res ? attention_hd_kernel<DP, true, true, ODD>
                          : attention_hd_kernel<DP, true, false, ODD>)
               : (out_res ? attention_hd_kernel<DP, false, true, ODD>
                          : attention_hd_kernel<DP, false, false, ODD>);
  };
  auto kernel = (d & 1) ? pick(std::true_type{}) : pick(std::false_type{});
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nqb = (N + HD_BLK - 1) / HD_BLK;
  const dim3 grid((nqb + HD_FWD_WG - 1) / HD_FWD_WG, B * H);
  kernel<<<grid, 128 * HD_FWD_WG, smem, stream>>>(qkv, q_bstride, q_ld, d, out, out_res, lse,
                                                  cls, pol, N, H, scale, eps, ring,
                                                  hd_piece_bytes(d));
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    ++attention_hd_launches[0];
    ++attention_hd_dp_launches[0][DP / 16 - 1][d & 1];
  }
  return err;
}

// the explicit instantiation of launch_attention_hd_dp<DP>
#define D2S_HD_FWD_LAUNCH(DP) \
  template cudaError_t launch_attention_hd_dp<DP>(const bf16*, long long, int, int, bf16*, bf16*, \
                                                  float*, bf16*, const float*, int, int, int,   \
                                                  float, float, cudaStream_t)

}  // namespace d2s
