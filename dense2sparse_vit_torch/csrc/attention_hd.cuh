// The attention core at head widths other than 64: what block.cu's forward
// (attention_hd_kernel) and block_bwd.cu's backward (attention_hd_bwd_kernel)
// share, for sm_90a.
//
// The d = 64 cores (block.cu's attention_kernel, block_bwd.cu's
// attention_bwd_kernel) lay a head's rows out 64 bf16 wide for ldmatrix's
// swizzle and wgmma's 64-deep tiles, and hold a sample-head's K and V in
// shared memory. Neither carries over to another width d (the JAX kernels
// take any: dense2sparse_vit_tpu/ops/pallas/block.py:226, :753; the zoo has
// heads of 12 and 96): at d = 96 the K and V of 800 keys take 300 KB, more
// than a CTA's 227 KB. This path is the simple one, for every even d up to
// 128:
//   - a head's rows are zero-padded to DP = roundup(d, 16) columns in
//     shared memory, [row][DP + 8] bf16 tiles: zero columns change no score
//     and no product, the padded output columns are dropped, and a pitch of
//     an odd number of 16-byte chunks lets the eight rows an ldmatrix reads
//     fall on eight different bank groups;
//   - the copies are 4-byte loads: a head's row starts at byte 2 h d of a
//     qkv row, which at d = 12 is only 8-byte aligned;
//   - the keys stream through shared memory in blocks of 64 (HD_BLK), so
//     every N up to 800 fits at every width;
//   - the products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// The scores S = Q K^T and the backward's dP = dO V^T are the same
// function, hd_scores16: each 16 x 16 tile a chain of mma.sync from zero in
// kk order over the padded width, on fragments loaded the same way from
// tiles laid out the same way. So the backward's scores are bit for bit the
// forward's, which policy mode's tie test needs (see block_bwd.cu).
#pragma once

#include "ln_gemm.cuh"

namespace d2s {

constexpr int HD_MAX = 128;      // the widest head this path takes
constexpr int HD_BLK = 64;       // a CTA's query rows (4 warps x 16) and a streamed key block
constexpr int HD_THREADS = 128;  // the forward's and the backward's CTAs

__host__ __device__ constexpr int hd_pad(int d) { return (d + 15) / 16 * 16; }

// the head widths the attention cores take: even, 2 to 128 (64 on the d = 64
// path, the others on this one)
inline bool hd_width_ok(int d) { return d > 0 && d <= HD_MAX && d % 2 == 0; }
inline bool head_width_ok(int C, int H) { return H > 0 && C % H == 0 && hd_width_ok(C / H); }

// rows r0 .. r0 + 63 of one head's d columns (src: the head's first column of
// row 0; rows ld elements apart) into a [64][DP + 8] tile: zero past d and at
// rows from n on; 4-byte loads, nthreads threads
template <int DP>
__device__ __forceinline__ void hd_load_tile(bf16* dst, const bf16* src, long long ld, int r0,
                                             int n, int d, int tid, int nthreads) {
  constexpr int P = DP + 8;
  constexpr int PAIRS = DP / 2;
  for (int i = tid; i < HD_BLK * PAIRS; i += nthreads) {
    const int r = i / PAIRS, c = (i % PAIRS) * 2;
    uint32_t v = 0u;
    if (r0 + r < n && c < d)
      v = *reinterpret_cast<const uint32_t*>(src + (long long)(r0 + r) * ld + c);
    *reinterpret_cast<uint32_t*>(dst + r * P + c) = v;
  }
}

// s[j]: the scores of the warp's 16 rows q0 .. q0 + 15 of tile A ([row][DP +
// 8]) with rows k0 + 8 j .. + 7 of tile B, an m16n8 accumulator each (rows
// g and g + 8, columns 2t, 2t + 1 of the 8): A B^T over the DP columns, a
// chain of mma.sync from zero in kk order. S = Q K^T with (A, B) = (Q, K);
// dP = dO V^T with (dO, V).
template <int DP>
__device__ __forceinline__ void hd_scores16(float (&s)[2][4], const bf16* A, int q0,
                                            const bf16* B, int k0, int lane) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, A + (q0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + kk * 16 + (lane >> 4) * 8);
    ldmatrix_x4(b, B + (k0 + (lane & 7) + (lane >> 4) * 8) * P + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_16816(s[0], a, b[0], b[1]);
    mma_16816(s[1], a, b[2], b[3]);
  }
}

// acc[nd] (16 rows x DP columns, m16n8 accumulators) += A (16 x 16, an mma
// A fragment) times rows k0 .. k0 + 15 of tile V ([row][DP + 8]): P V, dS K,
// P^T dO, dS^T Q
template <int DP>
__device__ __forceinline__ void hd_mma_rows(float (&acc)[DP / 8][4], const uint32_t (&a)[4],
                                            const bf16* V, int k0, int lane) {
  constexpr int P = DP + 8;
#pragma unroll
  for (int nd = 0; nd < DP / 8; nd += 2) {
    uint32_t vb[4];
    ldmatrix_x4_trans(vb, V + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                              (nd + (lane >> 4)) * 8);
    mma_16816(acc[nd], a, vb[0], vb[1]);
    mma_16816(acc[nd + 1], a, vb[2], vb[3]);
  }
}

// the warp's rows r and r + 8 of a 16 x DP accumulator into a bf16 matrix
// (dst: column 0 of row 0; rows ld apart), columns below d and rows below n
template <int DP>
__device__ __forceinline__ void hd_store(bf16* dst, long long ld, int r, int n, int d,
                                         const float (&acc)[DP / 8][4], int t) {
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (c >= d) continue;
    if (r < n) *reinterpret_cast<uint32_t*>(dst + r * ld + c) = pack_bf16(acc[nd][0], acc[nd][1]);
    if (r + 8 < n)
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * ld + c) = pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

// Launch counts of the two kernels, where they are launched (the entries'
// own included): the forward core, and the backward (its three launches
// counted once); read by d2s_attention_hd_launches
extern long long attention_hd_launches[2];

}  // namespace d2s
