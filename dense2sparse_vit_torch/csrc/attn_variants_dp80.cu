// The variants' attention cores at the padded head widths 80 and 96
// (attn_variants.cuh), built apart from the others.
#include "attn_variants.cuh"

namespace d2s {

D2S_AV_LAUNCH(80);
D2S_AV_LAUNCH(96);

}  // namespace d2s
