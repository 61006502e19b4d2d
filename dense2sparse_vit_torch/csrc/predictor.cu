// PredictorLG (LayerNorm variants) forward for sm_90a: (B, N, D) spatial
// tokens -> (B, N) raw keep scores.
//
// Replaces dense2sparse_vit_tpu/ops/pallas/predictor.py::fused_predictor_lg
// (kernel body `_predictor_kernel`). Per sample:
//   h = units_in(x)                       LN -> Linear -> act, each
//   h = [h[:, :c/2], mean_tokens(h[:, c/2:])]   local / global split
//   h = units_out(h)                      LN -> Linear -> act, each
//   s = LN(h) . w + b                     final unit, width -> 1
// LayerNorm eps is the predictor's 1e-5, act is GELU (small predictor) or
// ReLU (large). d2s_predictor_forward runs on the caller's stream:
//   - ln_gemm (ln_gemm.cuh) for every unit, bias and activation in its
//     epilogue; the first unit reads x in place with a per-sample stride, so
//     the caller can pass the spatial view x[:, 1:] of the residual stream;
//   - after the last input unit, pool_broadcast_kernel: the per-sample mean
//     of channels [c/2:] over the N tokens (fp32 sum, rounded to bf16 as the
//     TPU kernel does), written back over those channels of every row. This
//     is the broadcast-concat form of the split: out_0 then runs as a plain
//     LN-GEMM. The TPU kernel instead splits out_0's product into a per-token
//     local half and a per-sample rank-1 global half, which saves half of
//     out_0's FLOPs; that is left for a later version;
//   - final_score_kernel: one warp per token row, LN then the dot product
//     with the 1-unit head.
//
// What bounds it on the H100: at the headline shapes (small predictor,
// D=384, N = 196 / 137 / 96, B=256) the four GEMMs are about 0.3 GFLOP per
// sample-stage in all, small next to the 12 blocks, so the kernel is bound
// by this first version's GEMM efficiency and by the activations it writes
// between units ((B*N, 384) and (B*N, 192) bf16). A faster design keeps a
// tile of token rows on chip through the whole pyramid, which needs the
// per-sample pooled vector first (a two-pass schedule: pool, then the rest).
#include "ln_gemm.cuh"

namespace d2s {

static __global__ void pool_broadcast_kernel(bf16* h, int N, int C, int c2) {
  const int b = blockIdx.y;
  const int c = c2 + blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  bf16* col = h + (long long)b * N * C + c;
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += __bfloat162float(col[(long long)n * C]);
  const bf16 mean = __float2bfloat16(s / N);
  for (int n = 0; n < N; ++n) col[(long long)n * C] = mean;
}

static __global__ void final_score_kernel(const bf16* __restrict__ h,
                                          const float* __restrict__ ln_w,
                                          const float* __restrict__ ln_b,
                                          const bf16* __restrict__ w,
                                          const float* __restrict__ bias,
                                          bf16* __restrict__ out, int M, int C, float eps) {
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= M) return;
  const int lane = threadIdx.x & 31;
  const bf16* row = h + (long long)m * C;
  float s = 0.f;
  for (int k = lane; k < C; k += 32) s += __bfloat162float(row[k]);
  const float mu = warp_sum(s) / C;
  float q = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float d = __bfloat162float(row[k]) - mu;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / C + eps);
  float acc = 0.f;
  for (int k = lane; k < C; k += 32) {
    const bf16 y = __float2bfloat16((__bfloat162float(row[k]) - mu) * rs * ln_w[k] + ln_b[k]);
    acc += __bfloat162float(y) * __bfloat162float(w[k]);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[m] = __float2bfloat16(acc + bias[0]);
}

}  // namespace d2s

using d2s::bf16;

// x: spatial tokens, row n of sample b at x + b * x_bstride + n * D (bf16).
// scores: (B, N) bf16. buf0, buf1: scratch of B*N*max(widths) bf16 each;
// stats: scratch of B*N float2.
// Unit u maps width (u ? widths[u-1] : D) -> widths[u] with LayerNorm
// (ln_w[u], ln_b[u] fp32), weight w[u] (widths[u], in) bf16 and bias b[u]
// fp32; the local/global split follows unit n_in - 1. The final unit has
// LayerNorm (fln_w, fln_b), a (widths[n_units-1],) bf16 weight and an fp32
// scalar bias. act: 1 = GELU, 2 = ReLU. Host arrays: widths and the four
// pointer arrays.
extern "C" int d2s_predictor_forward(const void* x, long long x_bstride, void* scores,
                                     void* buf0, void* buf1, void* stats, int B, int N,
                                     int D, int n_units, int n_in, const int* widths,
                                     const void* const* ln_w, const void* const* ln_b,
                                     const void* const* w, const void* const* b,
                                     const void* fln_w, const void* fln_b, const void* fw,
                                     const void* fb, int act, float eps, void* stream) {
  if (n_units < 1 || n_in < 1 || n_in > n_units) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  d2s::GemmArgs g{};
  g.a = static_cast<const bf16*>(x);
  g.a_rows = N;
  g.a_bstride = x_bstride;
  g.ln_eps = eps;
  g.ln_stats = static_cast<float2*>(stats);
  g.residual = nullptr;
  g.M = M;
  g.K = D;
  g.act = act;
  bf16* dst = nullptr;
  for (int u = 0; u < n_units; ++u) {
    dst = static_cast<bf16*>(u % 2 == 0 ? buf0 : buf1);
    g.w = static_cast<const bf16*>(w[u]);
    g.bias = static_cast<const float*>(b[u]);
    g.ln_w = static_cast<const float*>(ln_w[u]);
    g.ln_b = static_cast<const float*>(ln_b[u]);
    g.out = dst;
    g.N = widths[u];
    cudaError_t err = d2s::launch_ln_gemm(g, s);
    if (err != cudaSuccess) return (int)err;
    if (u == n_in - 1) {
      const int c = widths[u];
      const int c2 = c / 2;
      const dim3 grid((c - c2 + 127) / 128, B);
      d2s::pool_broadcast_kernel<<<grid, 128, 0, s>>>(dst, N, c, c2);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    g.a = dst;
    g.a_rows = M;
    g.a_bstride = 0;
    g.K = widths[u];
  }
  const int rows_per_cta = 8;
  d2s::final_score_kernel<<<(M + rows_per_cta - 1) / rows_per_cta, 32 * rows_per_cta, 0, s>>>(
      dst, static_cast<const float*>(fln_w), static_cast<const float*>(fln_b),
      static_cast<const bf16*>(fw), static_cast<const float*>(fb), static_cast<bf16*>(scores),
      M, widths[n_units - 1], eps);
  return (int)cudaGetLastError();
}
