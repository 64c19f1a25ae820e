// The launch-geometry query of the kernel library (launch_info.cu):
// for a kernel and its shape arguments, what its C entry would launch.
// out[0..2] grid x, y, z; out[3] threads per block; out[4] dynamic shared
// memory bytes; out[5..7] cluster x, y, z; out[8] how many such clusters
// (or, in score_select's per-expert and spread forms, blocks) can be
// active at once (cudaOccupancyMaxActiveClusters or
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs; score_select only,
// 0 for the matmuls, which launch no clusters); out[9] score_select's
// form: 0 one cluster per expert, 1 + i the per-expert form of config i
// (score_select.cu's kExpertNJ / kExpertRU), -1 the spread form of
// either entry (grid (nb, row slabs, E), E = 1 for the 2-D entry, the
// geometry of both its launches); the
// matmuls': 0 the gather form (gather_mma.cuh), 1 the tile form
// (sparse_matmul_tile.cu).
#pragma once

namespace wisparse {

// score_select's geometry (score_select.cu), from the code its launch
// uses; `experts`: the expert entry's (which may take the per-expert
// form, and takes the spread form from its own row threshold); `aligned`:
// x and xm 16-byte aligned.  Returns the entry's error
// for arguments it refuses.
int score_select_info(bool experts, int E, int B, int n, int blk, int kb,
                      int dtype, bool aligned, int* out);

}  // namespace wisparse
