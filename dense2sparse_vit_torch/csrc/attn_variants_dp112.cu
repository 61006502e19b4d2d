// The variants' attention cores at the padded head widths 112 and 128
// (attn_variants.cuh), built apart from the others.
#include "attn_variants.cuh"

namespace d2s {

D2S_AV_LAUNCH(112);
D2S_AV_LAUNCH(128);

}  // namespace d2s
