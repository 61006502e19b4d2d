// The attention core's backward at the padded head widths 144 to 192
// (attention_hd_bwd.cuh), built apart from the others.
#include "attention_hd_bwd.cuh"

namespace d2s {

D2S_HD_BWD_LAUNCH(144);
D2S_HD_BWD_LAUNCH(160);
D2S_HD_BWD_LAUNCH(176);
D2S_HD_BWD_LAUNCH(192);

}  // namespace d2s
