// The attention core's forward at the padded head widths 144 to 192
// (attention_hd_fwd.cuh), built apart from the others.
#include "attention_hd_fwd.cuh"

namespace d2s {

D2S_HD_FWD_LAUNCH(144);
D2S_HD_FWD_LAUNCH(160);
D2S_HD_FWD_LAUNCH(176);
D2S_HD_FWD_LAUNCH(192);

}  // namespace d2s
