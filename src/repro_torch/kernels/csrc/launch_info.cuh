// The launch-geometry query of the kernel library (launch_info.cu):
// for a kernel and its shape arguments, what its C entry would launch.
// out[0..2] grid x, y, z; out[3] threads per block; out[4] dynamic shared
// memory bytes; out[5..7] cluster x, y, z; out[8] how many such clusters
// can be active at once (cudaOccupancyMaxActiveClusters; score_select
// only, 0 for the matmuls, which launch no clusters).
#pragma once

namespace wisparse {

// score_select's geometry (score_select.cu), from the code its launch
// uses; `aligned`: x and xm 16-byte aligned.  Returns the entry's error
// for arguments it refuses.
int score_select_info(int E, int B, int n, int blk, int kb, int dtype,
                      bool aligned, int* out);

}  // namespace wisparse
