// The attention core's backward at the padded head widths 208 to 256
// (attention_hd_bwd.cuh), built apart from the others.
#include "attention_hd_bwd.cuh"

namespace d2s {

D2S_HD_BWD_LAUNCH(208);
D2S_HD_BWD_LAUNCH(224);
D2S_HD_BWD_LAUNCH(240);
D2S_HD_BWD_LAUNCH(256);

}  // namespace d2s
