// The attention core's backward at head widths other than 64: its launch
// by padded width (the kernel: attention_hd_bwd.cuh).
#include "attention_hd_bwd.cuh"

namespace d2s {

// instantiated in attention_hd_bwd_dp80.cu, _dp144.cu and _dp208.cu
extern D2S_HD_BWD_LAUNCH(80);
extern D2S_HD_BWD_LAUNCH(96);
extern D2S_HD_BWD_LAUNCH(112);
extern D2S_HD_BWD_LAUNCH(128);
extern D2S_HD_BWD_LAUNCH(144);
extern D2S_HD_BWD_LAUNCH(160);
extern D2S_HD_BWD_LAUNCH(176);
extern D2S_HD_BWD_LAUNCH(192);
extern D2S_HD_BWD_LAUNCH(208);
extern D2S_HD_BWD_LAUNCH(224);
extern D2S_HD_BWD_LAUNCH(240);
extern D2S_HD_BWD_LAUNCH(256);

// the d != 64 backward: st the forward's (B, H, N) float4 statistics;
// dpol_part (B, H, N) or null; dq_acc (hd_bwd_splits, B*N, C) fp32 past 128
// tokens
cudaError_t launch_attention_hd_bwd(const bf16* qkv, long long q_bstride, int q_ld, int d,
                                    const bf16* o, const bf16* o_res, const bf16* dout,
                                    float4* st, const float* pol, const float* gcls, bf16* dqkv,
                                    float* dpol_part, float* dq_acc, int B, int N, int H,
                                    float scale, float eps, cudaStream_t stream) {
#define D2S_HD_BWD(DP)                                                                       \
  case DP:                                                                                   \
    return launch_attention_hd_bwd_dp<DP>(qkv, q_bstride, q_ld, d, o, o_res, dout, st, pol, \
                                          gcls, dqkv, dpol_part, dq_acc, B, N, H, scale, eps, \
                                          stream);
  switch (hd_pad(d)) {
    D2S_HD_BWD(16)
    D2S_HD_BWD(32)
    D2S_HD_BWD(48)
    D2S_HD_BWD(64)
    D2S_HD_BWD(80)
    D2S_HD_BWD(96)
    D2S_HD_BWD(112)
    D2S_HD_BWD(128)
    D2S_HD_BWD(144)
    D2S_HD_BWD(160)
    D2S_HD_BWD(176)
    D2S_HD_BWD(192)
    D2S_HD_BWD(208)
    D2S_HD_BWD(224)
    D2S_HD_BWD(240)
    D2S_HD_BWD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef D2S_HD_BWD
}

}  // namespace d2s
