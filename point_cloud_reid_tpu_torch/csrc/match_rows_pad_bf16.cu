// The bf16 rows tier (csrc/match_rows_wg.cuh, policy Bf16) in the padded
// layout (kernels/match_grid.pad_side): widths up to 128 that the tier has
// no instantiation for, heads of any width, and the image head (no position
// term). Entry point pcr_match_rows_wg_pad_bf16; compiled apart from
// csrc/match_rows_bf16.cu so that the two build side by side.
#include "match_rows_wg.cuh"

ROWS_WG_PAD_ENTRIES(rowswg::Bf16, _bf16)
