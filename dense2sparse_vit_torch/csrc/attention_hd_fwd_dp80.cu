// The attention core's forward at the padded head widths 80 to 128
// (attention_hd_fwd.cuh), built apart from the others.
#include "attention_hd_fwd.cuh"

namespace d2s {

D2S_HD_FWD_LAUNCH(80);
D2S_HD_FWD_LAUNCH(96);
D2S_HD_FWD_LAUNCH(112);
D2S_HD_FWD_LAUNCH(128);

}  // namespace d2s
