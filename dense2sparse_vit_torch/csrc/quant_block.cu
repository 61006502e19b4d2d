// Whole pre-norm transformer block with W8A8 projections, forward, for sm_90a.
//
// Replaces dense2sparse_vit_tpu/ops/pallas/quant.py::fused_transformer_block_int8
// (kernel body `_quant_block_kernel`), the policy-free block of the int8
// serving path. It computes what ops/quant.py::quant_block_reference defines:
//   h1    = LN1(x)                        fp32
//   qkv   = bf16(deq(q8(h1) . Wqkv) + bqkv)
//   attn  = MHA(qkv)                      bf16, exact row-max softmax
//   x_mid = x + deq(q8(attn) . Wproj) + bproj      fp32
//   act   = bf16(GELU(bf16(deq(q8(LN2(x_mid)) . W1) + b1)))
//   out   = bf16(x_mid + deq(q8(act) . W2) + b2)
// where q8(h) is one symmetric int8 scale per row, s = max(absmax, 1e-8) /
// 127, codes = clip(rint(h / s), -127, 127); the weights come quantized per
// output channel; a product accumulates exactly in int32 and is dequantized
// as acc * (s_row * s_col). Every rounding point is the plain version's, and
// the epilogue spells its multiplies and adds out (no contraction into fma)
// so that a stage fed the same codes gives the same bits. The TPU kernel's
// +-30 logit clip and 16-token padding are not carried over: the attention
// core is block.cu's exact one over the N real keys.
//
// d2s_block_int8_forward runs nine kernels on the caller's stream:
//   1. rowq  LN1(x)        -> codes, row scales      (B*N, C)
//   2. qgemm qkv                                     (B*N, 3C) bf16
//   3. attention (block.cu)                          (B*N, C) bf16
//   4. rowq  attn          -> codes, row scales
//   5. qgemm x_mid = x + proj                        (B*N, C) fp32
//   6. rowq  LN2(x_mid)    -> codes, row scales
//   7. qgemm act = GELU(fc1)                         (B*N, 4C) bf16
//   8. rowq  act           -> codes, row scales      (B*N, 4C)
//   9. qgemm out = x_mid + fc2                       (B*N, C) bf16
//
// What bounds it on the H100: at B=256, N=197 the four projections are
// 178.5 GOP of int8 (0.090 ms at the dense int8 peak of 1,979 TOP/s) and
// the attention dots 15.3 GFLOP of bf16 (0.015 ms at 989 TFLOP/s): it is
// operations-bound in principle. This first version does not come near:
// the GEMM is an mma.sync design with int8 operands (m16n8k32.s8.s8.s32,
// 128 x 128 x 128-byte tiles, a 3-stage cp.async ring), not ln_gemm.cuh's
// TMA + wgmma engine, and the intermediates (codes, qkv, attn, the fp32
// x_mid, the (B*N, 4C) activation) go through device memory, about 30
// bytes moved per element of x. A faster design quantizes inside the GEMM
// epilogue that produces each activation (a row's absmax needs the whole
// row: one CTA across N, or a second pass), keeps fc1 -> GELU -> fc2 on
// chip, and moves the GEMM to TMA + wgmma.
//
// Row quantization (rowq_kernel): one warp per row, read once into
// registers (all of a lane's loads in flight), then the LayerNorm's fp32
// mean and variance, the absmax and the codes from there. The int8 GEMM (qgemm_kernel): the PTX ISA's fragments
// of m16n8k32 with s8 operands lie in bytes exactly as m16n8k16's bf16 ones
// do (a register holds four int8 where it held two bf16), so the tiles are
// loaded with ln_gemm.cuh's ldmatrix helper, over byte columns; the
// weight's torch layout (out, in) is the `col` operand as it lies.
#include "ln_gemm.cuh"

namespace d2s {

// block.cu's attention core (plain mode: pol, lse and cls null)
cudaError_t launch_attention(const bf16* qkv, bf16* out, float* lse, bf16* cls,
                             const float* pol, int B, int N, int H, float scale, float eps,
                             cudaStream_t stream);

constexpr float QMAX = 127.f;
constexpr float SCALE_FLOOR = 1e-8f;

// 8 consecutive elements as fp32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp per row of `in` (M, K), K % 8 == 0, K <= 256 * CH: lane l holds
// the 8-value chunks at columns 8l + 256j (j < CH) in registers, loaded
// once. With ln_w, the row is first normalised, (h - mean) * (1 / sqrt(var
// + eps)) * ln_w + ln_b in fp32; then scales[m] = max(absmax, 1e-8) / 127
// and codes = clip(rint(h / s)).
template <typename T, int CH>
static __global__ void rowq_kernel(const T* __restrict__ in, int M, int K,
                                   const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                                   float ln_eps, int8_t* __restrict__ codes,
                                   float* __restrict__ scales) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= M) return;
  const int lane = threadIdx.x & 31;
  const T* row = in + (long long)m * K;
  float v[CH][8];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane * 8 + j * 256;
    if (c < K) load8(row + c, v[j]);
  }
  if (ln_w) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (lane * 8 + j * 256 < K)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[j][e];
    const float mu = __fdiv_rn(warp_sum(s), (float)K);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (lane * 8 + j * 256 < K)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(v[j][e], mu);
          q = __fadd_rn(q, __fmul_rn(d, d));
        }
    const float rs =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), (float)K), ln_eps)));
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane * 8 + j * 256;
      if (c < K)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[j][e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][e], mu), rs), __ldg(ln_w + c + e)),
                              __ldg(ln_b + c + e));
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if (lane * 8 + j * 256 < K)
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
  const float s = __fdiv_rn(fmaxf(warp_max(amax), SCALE_FLOOR), QMAX);
  if (lane == 0) scales[m] = s;
  int8_t* out = codes + (long long)m * K;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane * 8 + j * 256;
    if (c >= K) continue;
    uint2 packed;
    int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[e] = (int8_t)max(-127, min(127, __float2int_rn(__fdiv_rn(v[j][e], s))));
    *reinterpret_cast<uint2*>(out + c) = packed;
  }
}

// rows of up to 3,072 values (DeiT-B's MLP width); CH is the fewest chunks
// per lane that cover K, from a few instantiations
constexpr int ROWQ_MAX_K = 3072;

template <typename T>
static cudaError_t launch_rowq(const T* in, int M, int K, const float* ln_w, const float* ln_b,
                               float ln_eps, int8_t* codes, float* scales, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || K > ROWQ_MAX_K) return cudaErrorInvalidValue;
  constexpr int rows_per_cta = 8;
  const dim3 grid((M + rows_per_cta - 1) / rows_per_cta), block(32 * rows_per_cta);
  if (K <= 512)
    rowq_kernel<T, 2><<<grid, block, 0, stream>>>(in, M, K, ln_w, ln_b, ln_eps, codes, scales);
  else if (K <= 768)
    rowq_kernel<T, 3><<<grid, block, 0, stream>>>(in, M, K, ln_w, ln_b, ln_eps, codes, scales);
  else if (K <= 1536)
    rowq_kernel<T, 6><<<grid, block, 0, stream>>>(in, M, K, ln_w, ln_b, ln_eps, codes, scales);
  else
    rowq_kernel<T, 12><<<grid, block, 0, stream>>>(in, M, K, ln_w, ln_b, ln_eps, codes, scales);
  return cudaGetLastError();
}

// ---- int8 GEMM: out[m, n] = epi(sum_k a[m, k] * w[n, k]) ------------------

constexpr int QG_BM = 128;
constexpr int QG_BN = 128;
constexpr int QG_BK = 128;  // bytes (int8 values) of K per slice
constexpr int QG_THREADS = 256;
constexpr int QG_STAGES = 3;
constexpr int QG_LDS = QG_BK + 16;  // byte pitch: rows 9 x 16 bytes apart, conflict-free ldmatrix
constexpr int QG_STAGE = (QG_BM + QG_BN) * QG_LDS;  // bytes per stage
constexpr int QG_SMEM_BYTES = QG_STAGES * QG_STAGE;
constexpr int QG_LDC = QG_BN + 4;  // int32 pitch of the epilogue tile
constexpr int QG_VECS = QG_BM * QG_BK / 16 / QG_THREADS;  // 16-byte vectors per operand
static_assert(QG_BM == QG_BN, "A and B slices share the copy mapping");
static_assert(QG_VECS * QG_THREADS * 16 == QG_BM * QG_BK, "slice copy");
static_assert(QG_BM * QG_LDC * 4 <= QG_SMEM_BYTES, "epilogue tile fits the ring");

struct QGemmArgs {
  const int8_t* a;        // (M, K) activation codes
  const int8_t* w;        // (N, K) weight codes, the torch Linear layout
  const float* row_s;     // (M) activation scales
  const float* col_s;     // (N) weight scales
  const float* bias;      // (N) or null
  const bf16* res_bf16;   // (M, N) or null: + residual
  const float* res_f32;   // (M, N) or null: + residual
  bf16* out;              // (M, N) bf16, or null with out_f32
  float* out_f32;         // (M, N) fp32 instead
  int M, N, K;
  int gelu;               // GELU of the bf16-rounded dequantized value, before any residual
};

// c += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate; fragments as
// m16n8k16's in bytes: a: {(g, 4t..4t+3), (g+8, 4t..), (g, 16+4t..),
// (g+8, 16+4t..)}, b: {(4t..4t+3, g), (16+4t.., g)}, c: as m16n8k16's
__device__ __forceinline__ void mma_16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  ldmatrix_x4(r, reinterpret_cast<const bf16*>(p));
}

static __global__ void __launch_bounds__(QG_THREADS, 2) qgemm_kernel(const QGemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* stages = reinterpret_cast<int8_t*>(smem);  // [STAGES][A (BM x LDS) | B (BN x LDS)]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * QG_BM;
  const int n0 = blockIdx.x * QG_BN;
  const int wm = (warp & 1) * 64;  // warp tile 64 x 32: 2 warps down, 4 across
  const int wn = (warp >> 1) * 32;

  auto issue = [&](int slice) {
    const int k0 = slice * QG_BK;
    int8_t* As = stages + (slice % QG_STAGES) * QG_STAGE;
    int8_t* Bs = As + QG_BM * QG_LDS;
#pragma unroll
    for (int i = 0; i < QG_VECS; ++i) {
      const int v = tid + i * QG_THREADS;
      const int r = v / (QG_BK / 16);
      const int c = (v % (QG_BK / 16)) * 16;
      const bool kin = k0 + c < p.K;
      const bool va = kin && m0 + r < p.M;
      cp_async16(As + r * QG_LDS + c, va ? p.a + (long long)(m0 + r) * p.K + k0 + c : p.a, va);
      const bool vb = kin && n0 + r < p.N;
      cp_async16(Bs + r * QG_LDS + c, vb ? p.w + (long long)(n0 + r) * p.K + k0 + c : p.w, vb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int slices = (p.K + QG_BK - 1) / QG_BK;
#pragma unroll
  for (int s = 0; s < QG_STAGES - 1; ++s) {
    if (s < slices) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<QG_STAGES - 2>();
    __syncthreads();  // slice s has landed; slice s-1's stage is free
    if (s + QG_STAGES - 1 < slices) issue(s + QG_STAGES - 1);
    cp_async_commit();
    const int8_t* As = stages + (s % QG_STAGES) * QG_STAGE;
    const int8_t* Bs = As + QG_BM * QG_LDS;
#pragma unroll
    for (int kk = 0; kk < QG_BK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], As + (wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QG_LDS + kk +
                           (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, Bs + (wn + j * 8 + (lane & 7) + (lane >> 4) * 8) * QG_LDS + kk +
                       ((lane >> 3) & 1) * 16);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16832_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it for the tile

  int* Cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int2*>(Cs + (wm + i * 16 + g + half * 8) * QG_LDC + wn + j * 8 + 2 * t) =
            make_int2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
  __syncthreads();

  // 8 consecutive columns a thread: N % 8 == 0, so a chunk is all in or out
  for (int e = tid; e < QG_BM * QG_BN / 8; e += QG_THREADS) {
    const int r = e / (QG_BN / 8);
    const int c = (e % (QG_BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    const float rs = p.row_s[m];
    const long long o = (long long)m * p.N + n;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // acc * (s_row * s_col) + bias, each operation rounded on its own
      v[j] = __fmul_rn(__int2float_rn(Cs[r * QG_LDC + c + j]), __fmul_rn(rs, __ldg(p.col_s + n + j)));
      if (p.bias) v[j] = __fadd_rn(v[j], __ldg(p.bias + n + j));
      if (p.gelu) v[j] = gelu_exact(__bfloat162float(__float2bfloat16(v[j])));
    }
    if (p.res_bf16) {
      float rv[8];
      load8(p.res_bf16 + o, rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(rv[j], v[j]);
    }
    if (p.res_f32) {
      float rv[8];
      load8(p.res_f32 + o, rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(rv[j], v[j]);
    }
    if (p.out_f32) {
      *reinterpret_cast<float4*>(p.out_f32 + o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p.out_f32 + o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(p.out + o) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
}

static cudaError_t launch_qgemm(const QGemmArgs& p, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.K % 16 != 0 || p.N % 8 != 0 ||
      (!p.out) == (!p.out_f32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         QG_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + QG_BN - 1) / QG_BN, (p.M + QG_BM - 1) / QG_BM);
  qgemm_kernel<<<grid, QG_THREADS, QG_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace d2s

using d2s::bf16;

// x, out: (B, N, C) bf16. Scratch, written as the stages go: qkv (B*N, 3C)
// bf16, attn (B*N, C) bf16, mid (B*N, C) fp32, act (B*N, hidden) bf16; the
// codes and row scales of the four quantizations, aq1..aq4 int8 ((B*N, C)
// for 1-3, (B*N, hidden) for 4) and rs1..rs4 fp32 (B*N) (they may share
// one buffer: each is read by the next kernel only). Weights: the matrices'
// int8 codes in the torch Linear layout (out, in) with fp32 scales per
// output channel; LayerNorm parameters and biases fp32; bqkv may be null.
// Requires C == 64 * H, C % 16 == 0, hidden % 16 == 0, C and hidden <= 3072,
// N <= 800, 16-byte aligned pointers.
extern "C" int d2s_block_int8_forward(
    const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf, void* act_buf,
    void* aq1, void* aq2, void* aq3, void* aq4, void* rs1, void* rs2, void* rs3, void* rs4,
    const void* ln1_w, const void* ln1_b, const void* wqkv_q, const void* sqkv, const void* bqkv,
    const void* wproj_q, const void* sproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1_q, const void* s1, const void* b1, const void* w2_q,
    const void* s2, const void* b2, int B, int N, int C, int H, int hidden, float scale,
    float ln_eps, void* stream) {
  if (C != H * 64 || C % 16 != 0 || hidden % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto q8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto codes = [](void* p) { return static_cast<int8_t*>(p); };
  auto scales = [](void* p) { return static_cast<float*>(p); };
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* attn = static_cast<bf16*>(attn_buf);
  float* mid = static_cast<float*>(mid_buf);
  bf16* act = static_cast<bf16*>(act_buf);

  cudaError_t err = d2s::launch_rowq(xb, M, C, f(ln1_w), f(ln1_b), ln_eps, codes(aq1),
                                     scales(rs1), s);
  if (err != cudaSuccess) return (int)err;
  d2s::QGemmArgs q{};
  q.M = M;
  q.a = codes(aq1);
  q.row_s = scales(rs1);
  q.w = q8(wqkv_q);
  q.col_s = f(sqkv);
  q.bias = f(bqkv);
  q.out = qkv;
  q.N = 3 * C;
  q.K = C;
  if ((err = d2s::launch_qgemm(q, s)) != cudaSuccess) return (int)err;

  err = d2s::launch_attention(qkv, attn, nullptr, nullptr, nullptr, B, N, H, scale, 0.f, s);
  if (err != cudaSuccess) return (int)err;

  err = d2s::launch_rowq(static_cast<const bf16*>(attn), M, C, nullptr, nullptr, 0.f, codes(aq2),
                         scales(rs2), s);
  if (err != cudaSuccess) return (int)err;
  q.a = codes(aq2);
  q.row_s = scales(rs2);
  q.w = q8(wproj_q);
  q.col_s = f(sproj);
  q.bias = f(bproj);
  q.res_bf16 = xb;
  q.out = nullptr;
  q.out_f32 = mid;
  q.N = C;
  q.K = C;
  if ((err = d2s::launch_qgemm(q, s)) != cudaSuccess) return (int)err;

  err = d2s::launch_rowq(static_cast<const float*>(mid), M, C, f(ln2_w), f(ln2_b), ln_eps,
                         codes(aq3), scales(rs3), s);
  if (err != cudaSuccess) return (int)err;
  q.a = codes(aq3);
  q.row_s = scales(rs3);
  q.w = q8(w1_q);
  q.col_s = f(s1);
  q.bias = f(b1);
  q.res_bf16 = nullptr;
  q.out_f32 = nullptr;
  q.out = act;
  q.gelu = 1;
  q.N = hidden;
  q.K = C;
  if ((err = d2s::launch_qgemm(q, s)) != cudaSuccess) return (int)err;

  err = d2s::launch_rowq(static_cast<const bf16*>(act), M, hidden, nullptr, nullptr, 0.f,
                         codes(aq4), scales(rs4), s);
  if (err != cudaSuccess) return (int)err;
  q.a = codes(aq4);
  q.row_s = scales(rs4);
  q.w = q8(w2_q);
  q.col_s = f(s2);  // fc2's column scales
  q.bias = f(b2);
  q.res_f32 = mid;
  q.out = static_cast<bf16*>(out);
  q.gelu = 0;
  q.N = C;
  q.K = hidden;
  return (int)d2s::launch_qgemm(q, s);
}
