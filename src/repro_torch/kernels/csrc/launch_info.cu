// wisparse_launch_info: the launch geometry each C entry of the library
// would use for a kernel name and its shape arguments, computed by the
// code the launches run (score_select.cu's Geometry, gather_mma.cuh's
// grid_of, Layout::kBytes and argument checks), with the card's limits.
// It launches nothing.  The port's static checker
// (repro_torch.analysis, pass launch-geometry) holds its Python mirror,
// kernels/geometry.py, against it at every served shape.
#include <cstring>

#include "gather_mma.cuh"
#include "launch_info.cuh"
#include "sparse_matmul_tile.cuh"

namespace wisparse {
namespace {

template <typename T, int NB, bool kPerSeq>
int matmul_info(int E, int B, int m, int S, int* out) {
  using L = gm::Layout<T, NB, kPerSeq>;
  const dim3 grid = gm::grid_of<T, NB>(E, B, m, S);
  const int fill[10] = {static_cast<int>(grid.x), static_cast<int>(grid.y),
                        static_cast<int>(grid.z), gm::kThreads,
                        static_cast<int>(L::kBytes), 1, 1, 1, 0, 0};
  for (int i = 0; i < 10; ++i) out[i] = fill[i];
  return 0;
}

template <typename T, bool kPerSeq>
int matmul_rows(int E, int B, int m, int rows, int cols, int S, int* out) {
  if (!gm::tiles_ok<T>(B, rows, cols, E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (rows) {
    case 8:
      return matmul_info<T, 8, kPerSeq>(E, B, m, S, out);
    case 16:
      return matmul_info<T, 16, kPerSeq>(E, B, m, S, out);
    default:
      return matmul_info<T, 32, kPerSeq>(E, B, m, S, out);
  }
}

// The shared entry's tile form (rows == tile::kRows): persistent CTAs
// over the device's SMs; out[9] = 1 names the form.
int tile_info(int E, int B, int m, int* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int fill[10] = {tile::ctas(E, B, m, sms), 1, 1, tile::kThreads,
                        tile::kBytes, 1, 1, 1, 0, 1};
  for (int i = 0; i < 10; ++i) out[i] = fill[i];
  return 0;
}

int matmul(bool per_seq, int E, int B, int n, int m, int blk, int kb,
           int rows, int cols, int S, int dtype, bool aligned, int* out) {
  const bool ok = per_seq ? E == 1 && gm::per_seq_args_ok(B, n, m, blk, kb, S)
                          : gm::shared_args_ok(E, B, n, m, blk, kb, S);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == tile::kRows) {
    if (per_seq || dtype != kBFloat16 || !aligned ||
        !tile::args_ok(n, m, blk, cols, S)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return tile_info(E, B, m, out);
  }
  if (dtype == kFloat32) {
    return per_seq ? matmul_rows<float, true>(E, B, m, rows, cols, S, out)
                   : matmul_rows<float, false>(E, B, m, rows, cols, S, out);
  }
  if (dtype == kBFloat16) {
    return per_seq
               ? matmul_rows<__nv_bfloat16, true>(E, B, m, rows, cols, S, out)
               : matmul_rows<__nv_bfloat16, false>(E, B, m, rows, cols, S,
                                                   out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The card's limits: out[0] threads per block, out[1] opt-in dynamic
// shared memory per block, out[2] SMs, out[3..5] grid x, y, z maxima.
int device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMaxThreadsPerBlock, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxGridDimX,
      cudaDevAttrMaxGridDimY, cudaDevAttrMaxGridDimZ};
  for (int i = 0; i < 6 && e == cudaSuccess; ++i) {
    e = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
  }
  return static_cast<int>(e);
}

}  // namespace
}  // namespace wisparse

// `kernel`: "score_select", "score_select_experts", "sparse_matmul_shared",
// "sparse_matmul_shared_experts", "sparse_matmul_per_seq", or "device" for
// the card's limits.  The shape arguments are the C entry's (E = 1 for the
// 2-D kernels; rows, cols and splits the host's plan, unused by
// score_select; aligned: its x and xm, or the matmul's x and w, 16-byte
// aligned).  Fills out (10 ints, launch_info.cuh) and returns 0, or the
// cudaError_t the entry would return for these arguments.
extern "C" int wisparse_launch_info(const char* kernel, int E, int B, int n,
                                    int m, int blk, int kb, int rows,
                                    int cols, int splits, int dtype,
                                    int aligned, int* out) {
  using namespace wisparse;
  if (std::strcmp(kernel, "device") == 0) return device_limits(out);
  const bool experts = std::strcmp(kernel, "score_select_experts") == 0;
  if (experts || std::strcmp(kernel, "score_select") == 0) {
    return score_select_info(experts, E, B, n, blk, kb, dtype, aligned != 0,
                             out);
  }
  if (std::strcmp(kernel, "sparse_matmul_shared") == 0 ||
      std::strcmp(kernel, "sparse_matmul_shared_experts") == 0) {
    return matmul(false, E, B, n, m, blk, kb, rows, cols, splits, dtype,
                  aligned != 0, out);
  }
  if (std::strcmp(kernel, "sparse_matmul_per_seq") == 0) {
    return matmul(true, E, B, n, m, blk, kb, rows, cols, splits, dtype,
                  aligned != 0, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
