// The float32 cluster tier of csrc/match_grid.cu at the widths it has no
// instantiation for: its padded instantiations (kernels/match_grid.pad_side;
// entry points pcr_match_pooled_pad and pcr_match_pooled_image_pad),
// compiled apart from the exact ones so that the two build side by side.
#define MATCH_GRID_PAD_UNIT
#include "match_grid.cu"
