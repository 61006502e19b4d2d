// Attention half-block forward, inference schedules v1-v3, for sm_90a: the
// C entries, the launch by padded head width (the kernels:
// attn_variants.cuh) and the instantiations at padded widths 16 to 64.
#include "attn_variants.cuh"

namespace d2s {

D2S_AV_LAUNCH(16);
D2S_AV_LAUNCH(32);
D2S_AV_LAUNCH(48);
D2S_AV_LAUNCH(64);
// instantiated in attn_variants_dp80.cu and attn_variants_dp112.cu
extern D2S_AV_LAUNCH(80);
extern D2S_AV_LAUNCH(96);
extern D2S_AV_LAUNCH(112);
extern D2S_AV_LAUNCH(128);

static cudaError_t launch_variant(int variant, const bf16* qkv, bf16* out, float* work, int B,
                                  int N, int H, int d, float scale, cudaStream_t st) {
#define D2S_AV(DP) \
  case DP:         \
    return launch_variant_dp<DP>(variant, qkv, out, work, B, N, H, d, scale, st);
  switch (hd_pad(d)) {
    D2S_AV(16)
    D2S_AV(32)
    D2S_AV(48)
    D2S_AV(64)
    D2S_AV(80)
    D2S_AV(96)
    D2S_AV(112)
    D2S_AV(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef D2S_AV
}

// the kernels' own shapes: head widths (padded by ops.rowpad or not) 1 to
// AV_MAX_DP, N up to the half-block's forward ceiling at that width
static bool variant_takes(int variant, int B, int N, int C, int H) {
  return variant >= 1 && variant <= 3 && B > 0 && head_width_ok(C, H) && C / H <= AV_MAX_DP &&
         C % 8 == 0 && att_takes(N, C / H, false, false);
}

}  // namespace d2s

using d2s::bf16;

// 1 where variant (1-3) takes N tokens and H heads of width d (1 to 127, as
// JAX's run_variant; N from 1 to the half-block forward's ceiling at d,
// hd_max_tokens), else 0: ops/attention.py::attention_variant_supported's
// rule, repeated.
extern "C" int d2s_attention_variant_supported(int variant, int N, int H, int d) {
  return variant >= 1 && variant <= 3 && H > 0 && d >= 1 && d <= d2s::AV_MAX_D &&
                 d2s::att_takes(N, d, false, false)
             ? 1
             : 0;
}

// The bytes of the workspace d2s_attention_variant_forward needs at these
// shapes (C, H: the kernel's, padded or not): v3's staged scores where they
// do not fit a CTA's shared memory (d2s::av3_plan), else 0; -1 for shapes it
// does not take.
extern "C" long long d2s_attention_variant_scratch_bytes(int variant, int B, int N, int C,
                                                         int H) {
  using namespace d2s;
  if (!variant_takes(variant, B, N, C, H)) return -1;
  return variant == 3 ? av3_plan(hd_pad(C / H), B, N, H).work_bytes : 0;
}

// The half-block forward out = x + proj(MHA(qkv(LN1 x))) with the attention
// core of `variant` (1-3): x, out (B, N, C) bf16; scratch qkv (B*N, 3C) and
// attn (B*N, C) bf16, stats (B*N) float2, work
// (d2s_attention_variant_scratch_bytes; may be null where that is 0);
// weights bf16 (out, in), LayerNorm and biases fp32, bqkv and bproj may be
// null. Requires C == d * H, C % 8 == 0, d up to 128 (heads the wrapper
// padded to 128 included), N up to hd_max_tokens(d), 16-byte aligned
// pointers. ln_c: the LayerNorm's width, C or less where the rows end in
// zero columns (d2s::LnWidth).
extern "C" int d2s_attention_variant_forward(const void* x, void* out, void* qkv_buf,
                                             void* attn_buf, void* stats_buf, const void* ln_w,
                                             const void* ln_b, const void* wqkv,
                                             const void* bqkv, const void* wproj,
                                             const void* bproj, void* work, int variant, int B,
                                             int N, int C, int H, int ln_c, float scale,
                                             float ln_eps, void* stream) {
  using namespace d2s;
  if (!variant_takes(variant, B, N, C, H) || out == nullptr) return (int)cudaErrorInvalidValue;
  const LnWidth scope(ln_c);
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
  if ((err = launch_variant(variant, qkv, attn, static_cast<float*>(work), B, N, H, C / H, scale,
                            st)) != cudaSuccess)
    return (int)err;
  return (int)proj_stage(xb, attn, static_cast<bf16*>(out), static_cast<const bf16*>(wproj),
                         static_cast<const float*>(bproj), nullptr, N, M, C, st);
}
