// The attention core's forward at head widths other than 64: its launch by
// padded width (the kernel: attention_hd_fwd.cuh), the two cores' launch
// counts and their C entries.
#include "attention_hd_fwd.cuh"

namespace d2s {

long long attention_hd_launches[2] = {0, 0};
long long attention_hd_dp_launches[2][HD_MAX / 16][2] = {};

// instantiated in attention_hd_fwd_dp80.cu, _dp144.cu and _dp208.cu
extern D2S_HD_FWD_LAUNCH(80);
extern D2S_HD_FWD_LAUNCH(96);
extern D2S_HD_FWD_LAUNCH(112);
extern D2S_HD_FWD_LAUNCH(128);
extern D2S_HD_FWD_LAUNCH(144);
extern D2S_HD_FWD_LAUNCH(160);
extern D2S_HD_FWD_LAUNCH(176);
extern D2S_HD_FWD_LAUNCH(192);
extern D2S_HD_FWD_LAUNCH(208);
extern D2S_HD_FWD_LAUNCH(224);
extern D2S_HD_FWD_LAUNCH(240);
extern D2S_HD_FWD_LAUNCH(256);

// the d != 64 core: rows as launch_attention_strided takes them (2-byte
// aligned suffices), lse (B, H, N) float4 or null
cudaError_t launch_attention_hd(const bf16* qkv, long long q_bstride, int q_ld, int d, bf16* out,
                                bf16* out_res, float* lse, bf16* cls, const float* pol, int B,
                                int N, int H, float scale, float eps, cudaStream_t stream) {
#define D2S_HD_FWD(DP)                                                                    \
  case DP:                                                                                \
    return launch_attention_hd_dp<DP>(qkv, q_bstride, q_ld, d, out, out_res, lse, cls, pol, \
                                      B, N, H, scale, eps, stream);
  switch (hd_pad(d)) {
    D2S_HD_FWD(16)
    D2S_HD_FWD(32)
    D2S_HD_FWD(48)
    D2S_HD_FWD(64)
    D2S_HD_FWD(80)
    D2S_HD_FWD(96)
    D2S_HD_FWD(112)
    D2S_HD_FWD(128)
    D2S_HD_FWD(144)
    D2S_HD_FWD(160)
    D2S_HD_FWD(176)
    D2S_HD_FWD(192)
    D2S_HD_FWD(208)
    D2S_HD_FWD(224)
    D2S_HD_FWD(240)
    D2S_HD_FWD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef D2S_HD_FWD
}

}  // namespace d2s

// The launches of the attention core at head widths other than 64 since the
// last reset, counted where they are launched, inside every entry: which = 0
// the forward (attention_hd_kernel), 1 the backward (block_bwd.cu's
// attention_hd_bwd_kernel, once a backward);
// value >= 0 resets the count to it.
extern "C" long long d2s_attention_hd_launches(int which, long long value) {
  if (which != 0 && which != 1) return -1;
  long long& n = d2s::attention_hd_launches[which];
  if (value >= 0) n = value;
  return n;
}

// The same launches by padded head width dp (16 to 256, a multiple of 16)
// and parity (odd 1: an odd head width), counted with them;
// value >= 0 resets the count to it; -1 for another which or dp.
extern "C" long long d2s_attention_hd_dp_launches(int which, int dp, int odd, long long value) {
  if ((which != 0 && which != 1) || dp < 16 || dp > d2s::HD_MAX || dp % 16) return -1;
  long long& n = d2s::attention_hd_dp_launches[which][dp / 16 - 1][odd != 0];
  if (value >= 0) n = value;
  return n;
}
