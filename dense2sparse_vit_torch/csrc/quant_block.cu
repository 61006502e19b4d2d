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
// The four products (2, 5, 7, 9) run on ln_gemm.cuh's engine, instantiated
// for int8 operands (launch_qgemm): TMA loads of 128-byte K slices into an
// mbarrier ring, wgmma m64n128k32 .s32.s8.s8 with exact int32 sums, a
// persistent CTA per SM, a producer warpgroup, and epilogue warpgroups
// that dequantize one tile (in the order and at the rounding points above)
// while the MMA warpgroups multiply the next. Int32 sums are exact in any
// order, so the products give the bits of any exact int8 GEMM followed by
// that epilogue.
//
// What bounds it on the H100: bytes. Per token row at C=384, hidden=1536
// the products move 12,672 bytes (the codes and the residuals x and x_mid
// read; qkv, x_mid, the activation and the output written): at B=256,
// N=197 that is 0.64 GB, 0.19 ms at 3.35 TB/s, against 178.5 GOP of int8,
// 0.09 ms at the dense int8 peak of 1,979 TOP/s. The four row
// quantizations move 8,832 bytes a row (0.45 GB, 0.13 ms), the attention
// core 15.3 GFLOP of bf16. What holds the block above that now: the
// products' epilogue at K = C (ln_gemm.cuh's notes), then the row
// quantizations.
//
// Row quantization (rowq_kernel) stays a pass of its own: one warp per row,
// read once into registers (all of a lane's loads in flight), then the
// LayerNorm's fp32 mean and variance, the absmax and the codes from there.
// A warp's registers hold 4,096 values (ViT-L's MLP); a longer row (ViT-H's
// MLP is 5,120 wide, ViT-G's 8,192) is spread over a CTA's eight warps
// (rowq_row_kernel), its sums and absmax added across them through shared
// memory, up to 16,384 values. Both read the row once and write its codes
// once: the same bytes bound.
// A row's absmax spans 3 to 12 of the producing GEMM's 128-column tiles, so
// quantizing in that GEMM's epilogue needs a CTA across the whole row or a
// second pass over it, and a LayerNorm in the consuming GEMM's prologue is
// what holds the bf16 engine's qkv and fc1 products to a fraction of their
// rate. The pass already runs near its bytes bound; a fold would save
// traffic only (each quantized activation's second read).
#include "attention_hd.cuh"  // head_width_ok: the head widths of block.cu's cores
#include "ln_gemm.cuh"

namespace d2s {

// block.cu's attention core (plain mode: pol, lse and cls null)
cudaError_t launch_attention(const bf16* qkv, bf16* out, float* lse, bf16* cls,
                             const float* pol, int B, int N, int H, int d, float scale, float eps,
                             cudaStream_t stream, bf16* out_res = nullptr);

constexpr float QMAX = 127.f;
constexpr float SCALE_FLOOR = 1e-8f;

// launches of rowq_row_kernel, wherever launched; read by d2s_quant_launches
static long long rowq_row_launches;

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
// and codes = clip(rint(h / s)). The LayerNorm's statistics run over the
// first n columns (NARROW: n < K, the rest zeros with zero ln_w and ln_b).
template <typename T, int CH, bool NARROW>
static __global__ void rowq_kernel(const T* __restrict__ in, int M, int K, int n,
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
    const int k = NARROW ? n : K;
    const float mu = __fdiv_rn(warp_sum(s), (float)k);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (lane * 8 + j * 256 < K)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(v[j][e], mu);
          if (!NARROW || lane * 8 + j * 256 + e < k) q = __fadd_rn(q, __fmul_rn(d, d));
        }
    const float rs =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), (float)k), ln_eps)));
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

// A row past ROWQ_WARP_K values over a whole CTA, one CTA a row: thread t
// holds the 8-value chunks at columns 8t + 8 RQR_THREADS j (j < CH) in
// registers, loaded once; each of the row's sums and its absmax is a
// thread's, then its warp's (shuffles), then the warps' in order (shared
// memory), so the bits depend on K alone. The arithmetic and its roundings
// are rowq_kernel's.
constexpr int RQR_THREADS = 256;
constexpr int RQR_WARPS = RQR_THREADS / 32;

template <typename T, int CH, bool NARROW>
static __global__ void __launch_bounds__(RQR_THREADS)
    rowq_row_kernel(const T* __restrict__ in, int K, int n, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, float ln_eps, int8_t* __restrict__ codes,
                    float* __restrict__ scales) {
  __shared__ float red[RQR_WARPS];
  const int m = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the CTA's sum (max) of one value a thread, added in warp order; the
  // barrier after the read frees `red` for the next
  auto cta_sum = [&](float v) {
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < RQR_WARPS; ++w) s = __fadd_rn(s, red[w]);
    __syncthreads();
    return s;
  };
  auto cta_max = [&](float v) {
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < RQR_WARPS; ++w) s = fmaxf(s, red[w]);
    __syncthreads();
    return s;
  };
  auto col = [&](int j) { return 8 * t + 8 * RQR_THREADS * j; };
  const T* row = in + (long long)m * K;
  float v[CH][8];
#pragma unroll
  for (int j = 0; j < CH; ++j)
    if (col(j) < K) load8(row + col(j), v[j]);
  if (ln_w) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (col(j) < K)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[j][e];
    const int k = NARROW ? n : K;
    const float mu = __fdiv_rn(cta_sum(s), (float)k);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (col(j) < K)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __fsub_rn(v[j][e], mu);
          if (!NARROW || col(j) + e < k) q = __fadd_rn(q, __fmul_rn(d, d));
        }
    const float rs =
        __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(cta_sum(q), (float)k), ln_eps)));
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = col(j);
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
    if (col(j) < K)
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
  const float s = __fdiv_rn(fmaxf(cta_max(amax), SCALE_FLOOR), QMAX);
  if (t == 0) scales[m] = s;
  int8_t* out = codes + (long long)m * K;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = col(j);
    if (c >= K) continue;
    uint2 packed;
    int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[e] = (int8_t)max(-127, min(127, __float2int_rn(__fdiv_rn(v[j][e], s))));
    *reinterpret_cast<uint2*>(out + c) = packed;
  }
}

// Rows of up to ROWQ_WARP_K values (4,096: ViT-L's MLP width) take
// rowq_kernel, a warp a row, with CH the fewest chunks a lane that cover K;
// longer rows, up to ROWQ_MAX_K (16,384: past ViT-e's MLP width of 15,360),
// rowq_row_kernel, with CH the fewest a thread. Both from a few
// instantiations.
constexpr int ROWQ_WARP_K = 4096;
constexpr int ROWQ_MAX_K = 16384;

template <typename T, bool NARROW>
static cudaError_t launch_rowq_as(const T* in, int M, int K, int n, const float* ln_w,
                                  const float* ln_b, float ln_eps, int8_t* codes, float* scales,
                                  cudaStream_t stream) {
  if (K > ROWQ_WARP_K) {
    const auto kernel = K <= 6144    ? rowq_row_kernel<T, 3, NARROW>
                        : K <= 8192  ? rowq_row_kernel<T, 4, NARROW>
                        : K <= 12288 ? rowq_row_kernel<T, 6, NARROW>
                                     : rowq_row_kernel<T, 8, NARROW>;
    kernel<<<M, RQR_THREADS, 0, stream>>>(in, K, n, ln_w, ln_b, ln_eps, codes, scales);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++rowq_row_launches;
    return err;
  }
  constexpr int rows_per_cta = 8;
  const dim3 grid((M + rows_per_cta - 1) / rows_per_cta), block(32 * rows_per_cta);
  const auto kernel = K <= 512    ? rowq_kernel<T, 2, NARROW>
                      : K <= 768  ? rowq_kernel<T, 3, NARROW>
                      : K <= 1536 ? rowq_kernel<T, 6, NARROW>
                      : K <= 3072 ? rowq_kernel<T, 12, NARROW>
                                  : rowq_kernel<T, 16, NARROW>;
  kernel<<<grid, block, 0, stream>>>(in, M, K, n, ln_w, ln_b, ln_eps, codes, scales);
  return cudaGetLastError();
}

// With a LayerNorm, its statistics over ln_width(K) columns (the rows' zero
// columns past it left out).
template <typename T>
static cudaError_t launch_rowq(const T* in, int M, int K, const float* ln_w, const float* ln_b,
                               float ln_eps, int8_t* codes, float* scales, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || K > ROWQ_MAX_K) return cudaErrorInvalidValue;
  const int n = ln_w ? ln_width(K) : K;
  return n == K ? launch_rowq_as<T, false>(in, M, K, n, ln_w, ln_b, ln_eps, codes, scales, stream)
                : launch_rowq_as<T, true>(in, M, K, n, ln_w, ln_b, ln_eps, codes, scales, stream);
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
// Requires C == d * H (d at most 256: block.cu's cores), C % 16 == 0,
// hidden % 16 == 0, C and hidden <= d2s_rowq_max_width() (ROWQ_MAX_K),
// N up to hd_max_tokens (attention_hd.cuh), 16-byte aligned pointers.
// ln_c: the LayerNorms' width, C or less where the rows end in zero
// columns (d2s::LnWidth).
extern "C" int d2s_block_int8_forward(
    const void* x, void* out, void* qkv_buf, void* attn_buf, void* mid_buf, void* act_buf,
    void* aq1, void* aq2, void* aq3, void* aq4, void* rs1, void* rs2, void* rs3, void* rs4,
    const void* ln1_w, const void* ln1_b, const void* wqkv_q, const void* sqkv, const void* bqkv,
    const void* wproj_q, const void* sproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1_q, const void* s1, const void* b1, const void* w2_q,
    const void* s2, const void* b2, int B, int N, int C, int H, int hidden, int ln_c,
    float scale, float ln_eps, void* stream) {
  if (!d2s::head_width_ok(C, H) || C % 16 != 0 || hidden % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const d2s::LnWidth scope(ln_c);
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

  err = d2s::launch_attention(qkv, attn, nullptr, nullptr, nullptr, B, N, H, C / H, scale, 0.f,
                              s);
  if (err != cudaSuccess) return (int)err;

  err = d2s::launch_rowq(static_cast<const bf16*>(attn), M, C, nullptr, nullptr, 0.f, codes(aq2),
                         scales(rs2), s);
  if (err != cudaSuccess) return (int)err;
  q.a = codes(aq2);
  q.row_s = scales(rs2);
  q.w = q8(wproj_q);
  q.col_s = f(sproj);
  q.bias = f(bproj);
  q.residual = xb;
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
  q.residual = nullptr;
  q.out_f32 = nullptr;
  q.out = act;
  q.act = d2s::ACT_GELU;
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
  q.residual_f32 = mid;
  q.out = static_cast<bf16*>(out);
  q.act = d2s::ACT_NONE;
  q.N = C;
  q.K = hidden;
  return (int)d2s::launch_qgemm(q, s);
}

// The longest row the row quantization takes (ROWQ_MAX_K).
extern "C" int d2s_rowq_max_width() { return d2s::ROWQ_MAX_K; }

// The launches of rowq_row_kernel (which = 0: the rows past 4,096 values)
// since the last reset, inside the int8 block too; set resets the count to
// `value` when it is 0 or more.
extern "C" long long d2s_quant_launches(int which, long long value) {
  if (which != 0) return -1;
  if (value >= 0) d2s::rowq_row_launches = value;
  return d2s::rowq_row_launches;
}

// The row quantization alone (launch_rowq, the int8 block's stages 1, 4, 6
// and 8): in (M, K) bf16 (fp32 = 0) or fp32 (fp32 = 1); with ln_w and ln_b
// (K) fp32 each row first normalised by its own LayerNorm (ln_eps), else
// both null; codes (M, K) int8 and scales (M) fp32 out; ln_k: the
// LayerNorm's width, K or less where the rows end in zero columns. Requires
// K a multiple of 8 up to d2s_rowq_max_width(), 16-byte aligned pointers.
extern "C" int d2s_rowq(const void* in, int fp32, const void* ln_w, const void* ln_b,
                        float ln_eps, void* codes, void* scales, int M, int K, int ln_k,
                        void* stream) {
  const d2s::LnWidth scope(ln_k);
  const float* w = static_cast<const float*>(ln_w);
  const float* b = static_cast<const float*>(ln_b);
  if ((w == nullptr) != (b == nullptr)) return (int)cudaErrorInvalidValue;
  int8_t* q = static_cast<int8_t*>(codes);
  float* s = static_cast<float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? (int)d2s::launch_rowq(static_cast<const float*>(in), M, K, w, b, ln_eps, q, s, st)
              : (int)d2s::launch_rowq(static_cast<const bf16*>(in), M, K, w, b, ln_eps, q, s, st);
}
