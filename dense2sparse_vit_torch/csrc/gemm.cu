// The shared GEMM engine of ln_gemm.cuh as entries of its own, for sm_90a.
//
// The engine runs inside every block kernel (block.cu's stages 1, 3, 4 and
// 5, block_bwd.cu's recompute, dX and weight-gradient products,
// predictor.cu's units; with int8 operands, quant_block.cu's four
// products) and replaces no TPU kernel of its own: these entries exist so
// that it can be tested and timed alone, at the shapes the block kernels
// give it, against its plain version (ops/gemm.py::ln_gemm_reference,
// weight_grad_reference; ops/quant.py::qgemm_reference) and one torch
// call. What bounds it and what its design does: ln_gemm.cuh's notes.
#include "ln_gemm.cuh"

using d2s::bf16;

// One product out = epi(LN(a) W) with every option of d2s::GemmArgs: a has
// a_rows rows per sample, samples a_bstride elements apart (M = samples *
// a_rows); w is (N, K), or (K, N) with w_kn; ln_w, ln_b null for no
// LayerNorm (ln_stats: M float2 of scratch); bias, residual, row_scale (M /
// scale_rows), gelu_in, preact each null for none; exactly one of out
// (bf16) and out_f32; act: 0 none, 1 GELU, 2 ReLU; ln_k: the LayerNorm's
// width, K or less where a's rows end in zero columns (0: K). Requires K
// and N multiples of 8 and 16-byte aligned pointers.
extern "C" int d2s_ln_gemm(const void* a, int a_rows, long long a_bstride, const void* w,
                           int w_kn, const void* bias, const void* ln_w, const void* ln_b,
                           float ln_eps, int ln_k, void* ln_stats, const void* residual,
                           const void* row_scale, int scale_rows, const void* gelu_in,
                           void* preact, void* out, void* out_f32, int M, int N, int K, int act,
                           void* stream) {
  d2s::GemmArgs g{};
  g.a = static_cast<const bf16*>(a);
  g.a_rows = a_rows;
  g.a_bstride = a_bstride;
  g.w = static_cast<const bf16*>(w);
  g.w_kn = w_kn;
  g.bias = static_cast<const float*>(bias);
  g.ln_w = static_cast<const float*>(ln_w);
  g.ln_b = static_cast<const float*>(ln_b);
  g.ln_eps = ln_eps;
  g.ln_k = ln_k;
  g.ln_stats = static_cast<float2*>(ln_stats);
  g.residual = static_cast<const bf16*>(residual);
  g.row_scale = static_cast<const float*>(row_scale);
  g.scale_rows = scale_rows;
  g.gelu_in = static_cast<const bf16*>(gelu_in);
  g.preact = static_cast<bf16*>(preact);
  g.out = static_cast<bf16*>(out);
  g.out_f32 = static_cast<float*>(out_f32);
  g.M = M;
  g.N = N;
  g.K = K;
  g.act = act;
  return (int)d2s::launch_ln_gemm(g, static_cast<cudaStream_t>(stream));
}

// Bytes of workspace d2s_wgrad needs for an (I, J) gradient over M rows.
extern "C" long long d2s_wgrad_workspace_bytes(int M, int I, int J) {
  if (M <= 0 || I <= 0 || J <= 0) return 0;
  return d2s::wgrad_workspace_floats(M, I, J) * (long long)sizeof(float);
}

// dw (I, J) fp32 = p^T q for p (M, I), q (M, J) bf16 and, where db is not
// null, db (I) fp32 = the column sums of p (its bias gradient, summed on
// the product's reads of p); work: d2s_wgrad_workspace_bytes(M, I, J)
// bytes. I, J multiples of 8.
extern "C" int d2s_wgrad(const void* p, const void* q, void* dw, void* db, void* work, int M,
                         int I, int J, void* stream) {
  return (int)d2s::launch_wgrad(static_cast<const bf16*>(p), static_cast<const bf16*>(q),
                                static_cast<float*>(dw), static_cast<float*>(work), M, I, J,
                                static_cast<cudaStream_t>(stream), static_cast<float*>(db));
}

// One int8 product out = res + act(acc * (row_s * col_s) + bias), acc the
// exact int32 sum of a (M, K) and w (N, K) codes over K (d2s::QGemmArgs,
// launch_qgemm): row_s (M) and col_s (N) fp32; bias (N) fp32, residual
// (M, N) bf16 and residual_f32 (M, N) fp32 each null for none (not both);
// gelu: the exact GELU of the bf16-rounded value; exactly one of out (bf16)
// and out_f32. Requires K a multiple of 16, N of 8, 16-byte aligned pointers.
extern "C" int d2s_qgemm(const void* a, const void* row_s, const void* w, const void* col_s,
                         const void* bias, const void* residual, const void* residual_f32,
                         void* out, void* out_f32, int M, int N, int K, int gelu, void* stream) {
  d2s::QGemmArgs q{};
  q.a = static_cast<const int8_t*>(a);
  q.row_s = static_cast<const float*>(row_s);
  q.w = static_cast<const int8_t*>(w);
  q.col_s = static_cast<const float*>(col_s);
  q.bias = static_cast<const float*>(bias);
  q.residual = static_cast<const bf16*>(residual);
  q.residual_f32 = static_cast<const float*>(residual_f32);
  q.out = static_cast<bf16*>(out);
  q.out_f32 = static_cast<float*>(out_f32);
  q.M = M;
  q.N = N;
  q.K = K;
  q.act = gelu ? d2s::ACT_GELU : d2s::ACT_NONE;
  return (int)d2s::launch_qgemm(q, static_cast<cudaStream_t>(stream));
}
