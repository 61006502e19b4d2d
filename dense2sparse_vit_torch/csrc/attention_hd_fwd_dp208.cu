// The attention core's forward at the padded head widths 208 to 256
// (attention_hd_fwd.cuh), built apart from the others.
#include "attention_hd_fwd.cuh"

namespace d2s {

D2S_HD_FWD_LAUNCH(208);
D2S_HD_FWD_LAUNCH(224);
D2S_HD_FWD_LAUNCH(240);
D2S_HD_FWD_LAUNCH(256);

}  // namespace d2s
