// The attention core's backward at the padded head widths 80 to 128
// (attention_hd_bwd.cuh), built apart from the others.
#include "attention_hd_bwd.cuh"

namespace d2s {

D2S_HD_BWD_LAUNCH(80);
D2S_HD_BWD_LAUNCH(96);
D2S_HD_BWD_LAUNCH(112);
D2S_HD_BWD_LAUNCH(128);

}  // namespace d2s
