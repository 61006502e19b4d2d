// The attention core at head widths other than 64: what its forward
// (attention_hd_fwd.cuh's attention_hd_kernel) and its backward
// (attention_hd_bwd.cuh's attention_hd_bwd_kernel) share, for sm_90a.
//
// The d = 64 cores (block.cu's attention_kernel, block_bwd.cu's
// attention_bwd_kernel) lay a head's rows out 64 bf16 wide, one 128-byte
// row of the swizzle a row, and neither carries over to another width d (the
// JAX kernels take any: dense2sparse_vit_tpu/ops/pallas/block.py:226, :753;
// the zoo has heads of 12 and 96). This path takes every d from 1 to 256,
// odd or even (HD_MAX: wgmma's widest n, twice ViT-22B's head of 128):
//   - a head's rows are zero-padded to DP = roundup(d, 16) columns in shared
//     memory, in 64-row tiles of 8 x 8 "core matrices" without swizzle: the
//     element (r, c) of a tile lies at byte (r / 8) 16 DP + (c / 8) 128 +
//     (r % 8) 16 + (c % 8) 2 (hd_at). A core matrix is 8 rows of 16
//     contiguous bytes, which wgmma reads as a K-major operand (rows the M or
//     N index, columns the reduction: Q K^T's K, dO V^T's V) and, the same
//     bytes, as an MN-major one (rows the reduction: P V's V, dS K's K,
//     P^T dO's dO, dS^T Q's Q), so no tile is ever copied transposed; zero
//     columns change no product and the padded output columns are dropped;
//   - the copies are cp.async of 16 bytes where a head's rows are 16-byte
//     aligned (d % 8 == 0: d = 96), else 8 (d % 4 == 0: d = 12) or 4 bytes:
//     a head's row starts at byte 2 h d of a qkv row; eight neighbouring
//     threads fill one core matrix, so the stores meet no bank conflict and
//     each row is read 64 contiguous bytes at a time (hd_copy_tile). At an
//     odd d a row starts at any 2-byte address, and a 4-byte piece at
//     column d - 1 would carry the next head's column 0 into the padding,
//     which must stay zero: there each 16-byte piece is gathered element by
//     element and stored (pb = 2), and every paired access of the kernels
//     (O's stores, dQ, dK and dV, the backward's prologue) goes element by
//     element (hd_pair, hd_store_pair). The even widths keep their code;
//   - past d = 128 (DP > HD_NARROW) the forward's P V runs as two products,
//     columns 0-127 and the rest (hd_pv); the backward takes one key block a
//     pass, its column parts split over the two warpgroups (block_bwd.cu);
//   - the products run on wgmma m64nNk16 (bf16 in, fp32 accumulate): the
//     scores S = Q K^T (forward) and S^T = K Q^T (backward) as m64n32k16
//     chains (m64n16k16 at DP >= 112: hd_score_n) from zero in kk order
//     over the padded width (DP / 16 steps: 6 at d = 96, one at d = 12), so
//     the backward's scores are bit for bit
//     the forward's, which policy mode's tie test needs: the same
//     instruction, the same bf16 products summed in the same order, the
//     roles of the two operands swapped (block_bwd.cu's notes); P V, P^T dO
//     and dS^T Q as m64nDPk16 with P, P^T or dS^T from registers (an
//     accumulator's layout is the A fragment's); dS K from a stage in shared
//     memory.
#pragma once

#include "ln_gemm.cuh"

namespace d2s {

constexpr int HD_MAX = 256;     // the widest head this path takes
constexpr int HD_NARROW = 128;  // the widest padded head of the two-key-block backward
constexpr int HD_BLK = 64;      // the rows of a query or key block: a warpgroup's wgmma M

__host__ __device__ constexpr int hd_pad(int d) { return (d + 15) / 16 * 16; }

// the head widths the attention cores take: 1 to 256, odd or even (64 on the
// d = 64 path, the others on this one)
inline bool hd_width_ok(int d) { return d > 0 && d <= HD_MAX; }
inline bool head_width_ok(int C, int H) { return H > 0 && C % H == 0 && hd_width_ok(C / H); }

// the bytes of one cp.async that a head's rows are aligned to at width d;
// 2 at an odd d: no cp.async, the pieces are gathered (hd_copy_tile)
inline int hd_piece_bytes(int d) { return d % 8 == 0 ? 16 : d % 4 == 0 ? 8 : d % 2 == 0 ? 4 : 2; }

// bytes of a 64-row tile at padded width DP, and the byte offset of (r, c) in it
template <int DP>
constexpr int HD_TILE = HD_BLK * DP * 2;

// ---- sequence length -------------------------------------------------------
//
// block.cu's attention_kernel keeps a whole sample-head's K and V in shared
// memory, which holds ATT_SHORT_N keys of width 64 at most. A d = 64 head
// longer than that takes this path at DP = 64 in both directions, switched
// at the same N on both sides (att_on_hd): the pair's scores are one
// instruction's both ways, which policy mode's tie test needs, where a long
// attention_kernel paired with attention_bwd_kernel would need a third
// kernel. The pair streams the keys (forward) and the queries (backward)
// through rings, so what grows with N is the rows each keeps of every key
// or query: the forward pol_j and the CLS row's raw scores (4 B a key
// each), the backward each query row's statistics (16 B). hd_max_tokens is
// the longest N whose layout fits a CTA's shared memory (HD_SMEM_MAX) with
// a ring of two; ops/block.py::attention_max_tokens repeats this arithmetic
// for the wrappers' checks.
constexpr int ATT_SHORT_N = 800;
constexpr long long HD_SMEM_MAX = 232448;  // the most dynamic shared memory a CTA takes
constexpr int HD_FWD_WG = 2;               // warpgroups (query blocks) a CTA of the forward

inline bool att_on_hd(int N, int d) { return d != 64 || N > ATT_SHORT_N; }

// the forward's key groups of colsum(V) at padded width DP: a column pair a
// thread of the first warpgroup (one group from DP = 144 on, whose DP / 2 <=
// 128 pairs its threads cover)
__host__ __device__ constexpr int hd_fwd_groups(int DP) { return 128 / (DP / 2); }

// the forward's shared memory at padded width DP: the CTA's Q tiles, a ring
// of `ring` K and V tile pairs; in policy mode pol_j of every key and
// colsum(V)'s parts; with cls row 0's raw scores
inline long long hd_fwd_smem(int DP, int N, int ring, bool policy, bool cls) {
  const long long keys = (long long)(N + HD_BLK - 1) / HD_BLK * HD_BLK;
  long long bytes = (long long)(HD_FWD_WG + 2 * ring) * HD_BLK * DP * 2;
  if (policy) bytes += (keys + hd_fwd_groups(DP) * DP) * 4;
  if (cls) bytes += keys * 4;
  return bytes;
}

// the lanes a row of the backward's prologue takes at padded width DP: its
// column pairs rounded up to a power of two, 8 to 32
__host__ __device__ constexpr int hd_seg(int DP) { return DP >= 64 ? 32 : DP >= 32 ? 16 : 8; }

// the key blocks of a pass of attention_hd_bwd_kernel at padded width DP:
// two (a warpgroup each) up to HD_NARROW, one (shared) past it
__host__ __device__ constexpr int hd_bwd_kb(int DP) { return DP > HD_NARROW ? 1 : 2; }

// the bytes of attention_hd_bwd_kernel's shared memory at padded width DP:
// the pass's key blocks' K and V, a ring of `ring` query blocks' Q and dO,
// the dS^T stage (up to HD_NARROW two buffers of the two key blocks' and a
// query block's dQ sum of the earlier passes (fp32); past it one key
// block's, the sum read from device memory), every query row's statistics
// (two float2), colsum(V) with its eight warps' parts, the fold's warp sums
inline long long hd_bwd_smem(int DP, int N, int ring) {
  const long long rows = (long long)(N + HD_BLK - 1) / HD_BLK * HD_BLK;
  const bool narrow = DP <= HD_NARROW;
  return (long long)(2 * hd_bwd_kb(DP) + 2 * ring) * HD_BLK * DP * 2 +
         (narrow ? 4 : 1) * HD_BLK * HD_BLK * 2 + (narrow ? HD_BLK * DP * 4 : 0) + rows * 16 +
         (1 + 8 * 32 / hd_seg(DP)) * DP * 4 + 66 * 4;
}

// The longest sequence the attention cores take at head width d in either
// direction (backward: the backward with the forward it recomputes), 0 for
// a width they do not take. The forward's bound assumes the CLS rows, the
// backward's the policy rows, in either mode's layout as `policy` says.
inline int hd_max_tokens(int d, bool policy, bool backward) {
  if (!hd_width_ok(d)) return 0;
  const int DP = hd_pad(d);
  const long long fwd_fixed = hd_fwd_smem(DP, 0, 2, policy, true);
  const long long fwd = (HD_SMEM_MAX - fwd_fixed) / (policy ? 8 : 4) / HD_BLK * HD_BLK;
  if (!backward) return (int)fwd;
  const long long bwd = (HD_SMEM_MAX - hd_bwd_smem(DP, 0, 2)) / 16 / HD_BLK * HD_BLK;
  return (int)(fwd < bwd ? fwd : bwd);
}

// whether the cores take N tokens of width d (at d = 64 up to ATT_SHORT_N
// also on the width-64 cores, which take any N to that)
inline bool att_takes(int N, int d, bool policy, bool backward) {
  return N > 0 && N <= hd_max_tokens(d, policy, backward);
}

template <int DP>
__device__ __forceinline__ int hd_at(int r, int c) {
  return (r >> 3) * (DP * 16) + (c >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// `bytes` (4, 8 or 16) global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void hd_cp_async(void* dst, const void* src, int bytes, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// rows r0 .. r0 + ROWS - 1 of one head's d columns (src: the head's column 0
// of row 0; rows ld elements apart) into a tile, zero past d and at rows from
// n on: pieces of pb bytes (hd_piece_bytes), nthreads threads from tid; at an
// odd d (GATHER, pb = 2) gathered instead. ROWS (a multiple of 8): 64, a
// block's; 16 for attn_variants.cuh's v3 query tiles, the first 16 rows of
// the same layout
template <int DP, bool GATHER, int ROWS = HD_BLK>
__device__ __forceinline__ void hd_copy_tile(unsigned char* dst, const bf16* src, long long ld,
                                             int r0, int n, int d, int pb, int tid,
                                             int nthreads) {
  if (GATHER) {
    // an odd width: each 16 bytes of the tile (8 columns of a row) gathered
    // element by element and stored at once, zero past d and from row n on;
    // synchronous, so the commit groups around it stay empty
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
    for (int i = tid; i < ROWS * DP * 2 / 16; i += nthreads) {
      const int rr = i & 7, cm = i >> 3;
      const int r = (cm / (DP / 8)) * 8 + rr, c0 = (cm % (DP / 8)) * 8;
      const bool rok = r0 + r < n;
      const unsigned short* row = s16 + (rok ? (long long)(r0 + r) * ld : 0);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 2 * k;
        const uint32_t lo = rok && c < d ? row[c] : 0u, hi = rok && c + 1 < d ? row[c + 1] : 0u;
        w[k] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + (i << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  const int lg = pb == 16 ? 4 : pb == 8 ? 3 : 2;  // log2 of the piece's bytes
  const int pieces = (ROWS * DP * 2) >> lg;
  for (int i = tid; i < pieces; i += nthreads) {
    // i walks the tile's bytes in order: core matrix (row group, column
    // chunk), its row, the piece within the row's 16 bytes
    const int byte = i << lg;
    const int rr = (byte >> 4) & 7, sub = (byte & 15) >> 1;
    const int cm = byte >> 7;  // core matrix: row group cm / (DP / 8), chunk cm % (DP / 8)
    const int r = (cm / (DP / 8)) * 8 + rr, c = (cm % (DP / 8)) * 8 + sub;
    const bool ok = r0 + r < n && c < d;
    hd_cp_async(dst + byte, src + (ok ? (long long)(r0 + r) * ld + c : 0), pb, ok);
  }
}

// columns c and c + 1 (c even) of a head's row p as floats, the second 0
// where c + 1 == d: one 4-byte load at an even d; element by element at an
// odd d (ODD), where the row may start at any 2-byte address
template <bool ODD>
__device__ __forceinline__ float2 hd_pair(const bf16* p, int c, int d) {
  if (ODD)
    return make_float2(__bfloat162float(p[c]), c + 1 < d ? __bfloat162float(p[c + 1]) : 0.f);
  return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(p + c));
}

// lo, hi into columns c and c + 1 (c even, c < d) of a head's row p in
// bf16: one 4-byte store at an even d; element by element at an odd d
// (ODD), hi dropped where c + 1 == d (the next head's column)
template <bool ODD>
__device__ __forceinline__ void hd_store_pair(bf16* p, int c, int d, float lo, float hi) {
  if (ODD) {
    p[c] = __float2bfloat16_rn(lo);
    if (c + 1 < d) p[c + 1] = __float2bfloat16_rn(hi);
  } else {
    *reinterpret_cast<uint32_t*>(p + c) = pack_bf16(lo, hi);
  }
}

// wgmma shared-memory descriptors of a tile without swizzle: `lead` bytes
// between core matrices along the reduction, `stride` along M or N
__device__ __forceinline__ uint64_t hd_desc(const void* tile, uint32_t lead, uint32_t stride) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32);
}
// the tile (from `at`) as a K-major operand: its rows M or N, its columns
// the reduction
template <int DP>
__device__ __forceinline__ uint64_t hd_kdesc(const void* at) {
  return hd_desc(at, 128, DP * 16);
}
// the tile as an MN-major operand: its rows the reduction, its columns N
template <int DP>
__device__ __forceinline__ uint64_t hd_mdesc(const void* at) {
  return hd_desc(at, DP * 16, 128);
}

// the n of the score products (S = Q K^T, S^T = K Q^T, dP^T = V dO^T): 32,
// and 16 at the widest heads, where the backward's registers are scarcest;
// one function of the width for both cores, so that their scores are the
// same instruction's
__host__ __device__ constexpr int hd_score_n(int DP) { return DP >= 112 ? 16 : 32; }

// the A fragments of keys (or queries) 16 kk .. 16 kk + 15 of a bf16 copy of
// a m64nM accumulator s (this thread's part, M / 2 values): an accumulator's
// layout is the A fragment's
template <int M>
__device__ __forceinline__ void hd_pack_a(uint32_t (&a)[4], const float (&s)[M], int kk) {
  const int i = 8 * kk;
  a[0] = pack_bf16(s[i], s[i + 1]);
  a[1] = pack_bf16(s[i + 2], s[i + 3]);
  a[2] = pack_bf16(s[i + 4], s[i + 5]);
  a[3] = pack_bf16(s[i + 6], s[i + 7]);
}

// wgmma m64nNk16, f32 += bf16 x bf16, d this thread's N / 2 accumulators
// (warp w of the warpgroup rows 16 w .. 16 w + 15; d[4j .. 4j + 3] the
// mma.sync c fragment of columns 8j .. 8j + 7): rs, A from registers (an
// mma.sync a fragment of the warp's 16 rows) and B from shared memory, at
// every n the cores' P V, P^T dO and dS^T Q take; ss, both from shared
// memory, at the n of the score and dQ products. TA / TB: the operand is
// MN-major. acc = 0 starts the sum from zero.
template <int N>
struct HdMma;

template <>
struct HdMma<16> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<32> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<48> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<56> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[28], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[28], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "%28, %29, p, 1, 1, %31, %32;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<64> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<80> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[40], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<96> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct HdMma<112> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

template <>
struct HdMma<128> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

// the smallest n of an HdMma<n>::rs above that is at least x (x <= 128)
__host__ __device__ constexpr int hd_mma_n(int x) {
  return x <= 16 ? 16 : x <= 32 ? 32 : x <= 48 ? 48 : x <= 56 ? 56 : x <= 64 ? 64 : x <= 80 ? 80
       : x <= 96 ? 96 : x <= 112 ? 112 : 128;
}

// o += P V over 16 keys at padded width DP: P (a) from registers, V's 16
// rows (vt, MN-major) from shared memory. Past 128 columns two products,
// columns 0-127 and the rest (o[64..] is columns 128 on in the accumulator
// layout), each on a specialisation above
template <int DP>
__device__ __forceinline__ void hd_pv(float (&o)[DP / 2], const uint32_t (&a)[4],
                                      const unsigned char* vt) {
  if constexpr (DP <= 128) {
    HdMma<DP>::template rs<1>(o, a, hd_mdesc<DP>(vt), 1);
  } else {
    HdMma<128>::template rs<1>(*reinterpret_cast<float(*)[64]>(o), a, hd_mdesc<DP>(vt), 1);
    HdMma<DP - 128>::template rs<1>(*reinterpret_cast<float(*)[DP / 2 - 64]>(o + 64), a,
                                    hd_mdesc<DP>(vt + 16 * 128), 1);
  }
}

// (max, ties) of a row's values so far, v merged in (the cores' policy
// mode counts the columns that reach the max)
__device__ __forceinline__ void max_count(float v, float& m, float& c) {
  if (v > m) {
    m = v;
    c = 1.f;
  } else if (v == m) {
    c += 1.f;
  }
}

// 2^x (the exponentials take their argument pre-scaled by log2 e)
__device__ __forceinline__ float att_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// attention_hd_bwd_kernel's passes (of kb key blocks: two, one past
// HD_NARROW, hd_bwd_kb) at N tokens; the passes of 512 keys that a CTA takes
// past ATT_SHORT_N tokens, where a sample-head's passes are split over CTAs
// (hd_bwd_splits); up to it one CTA takes them all
constexpr int HD_BWD_PASSES = 4;  // a split's passes of two key blocks
inline int hd_bwd_passes(int N, int kb = 2) { return (N + kb * HD_BLK - 1) / (kb * HD_BLK); }
inline int hd_bwd_splits(int N) {
  return N > ATT_SHORT_N ? (hd_bwd_passes(N) + HD_BWD_PASSES - 1) / HD_BWD_PASSES : 1;
}

// The two cores at a head width d other than 64 (or at 64 past ATT_SHORT_N):
// the forward (attention_hd_fwd.cu; block.cu's launch_attention_strided
// calls it) and the backward (attention_hd_bwd.cu; block_bwd.cu's
// launch_attention_bwd), each dispatching to its padded width
cudaError_t launch_attention_hd(const bf16* qkv, long long q_bstride, int q_ld, int d, bf16* out,
                                bf16* out_res, float* lse, bf16* cls, const float* pol, int B,
                                int N, int H, float scale, float eps, cudaStream_t stream);
cudaError_t launch_attention_hd_bwd(const bf16* qkv, long long q_bstride, int q_ld, int d,
                                    const bf16* o, const bf16* o_res, const bf16* dout,
                                    float4* st, const float* pol, const float* gcls, bf16* dqkv,
                                    float* dpol_part, float* dq_acc, int B, int N, int H,
                                    float scale, float eps, cudaStream_t stream);

// Launch counts of the two kernels, where they are launched (the entries'
// own included): the forward core, and the backward; read by
// d2s_attention_hd_launches. By padded width and parity as well
// (attention_hd_dp_launches[backward][DP / 16 - 1][d odd]), read by
// d2s_attention_hd_dp_launches
extern long long attention_hd_launches[2];
extern long long attention_hd_dp_launches[2][HD_MAX / 16][2];

}  // namespace d2s
