// The whole-prefill form of the expert-batched block-gather matmul
// (sparse_matmul_tile.cu): its tile geometry, the persistent grid, the
// arguments it takes, and its launch.  sparse_matmul_shared.cu's expert
// entry launches it when the host's plan passes rows == kRows; the
// launch-geometry query (launch_info.cu) reads the same functions.
// kernels/geometry.py mirrors them in Python.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <numeric>

namespace wisparse {
namespace tile {

constexpr int kRows = 128;    // expert rows per tile: two warpgroups of 64
constexpr int kCols = 256;    // output columns per tile: one wgmma N
constexpr int kDepth = 64;    // channels per ring stage: one 128-byte row
constexpr int kStages = 4;    // ring stages in shared memory
constexpr int kThreads = 384; // a producer warpgroup, two consumers
constexpr int kMaxIds = 128;  // kept-block ids held in shared memory
constexpr int kXBytes = kRows * kDepth * 2;   // a stage's x tile, bf16
constexpr int kWBytes = kDepth * kCols * 2;   // a stage's W tile, bf16
constexpr int kStageBytes = kXBytes + kWBytes;
// the ring, 1024 bytes to align it (the 128-byte swizzle repeats every
// 1024), a full and an empty barrier per stage, the expert's ids
constexpr int kBytes =
    kStages * kStageBytes + 1024 + 2 * kStages * 8 + kMaxIds * 4;

__host__ __device__ inline int row_tiles(int R) {
  return (R + kRows - 1) / kRows;
}
__host__ __device__ inline int col_tiles(int m) {
  return (m + kCols - 1) / kCols;
}
__host__ __device__ inline long long tiles(int E, int R, int m) {
  return static_cast<long long>(E) * row_tiles(R) * col_tiles(m);
}

// Persistent CTAs: one per SM (every tile where there are fewer).  CTA b
// walks tiles b, b + G, b + 2G, ... in the order (expert, column tile,
// row tile), row tile fastest; G is kept coprime with the row tiles, so
// that each CTA takes its share of the cheaper ragged-tail tiles.
inline int ctas(int E, int R, int m, int sms) {
  const long long t = tiles(E, R, m);
  int g = static_cast<int>(t < sms ? t : sms);
  if (t > sms) {
    while (g > 1 && std::gcd(g, row_tiles(R)) != 1) --g;
  }
  return g;
}

// The arguments the form takes, beyond gm::shared_args_ok: its column
// tile, one slice (no split-K), kept blocks of whole 64-channel halves,
// and 16-byte row strides for the tensor maps (bf16: n and m multiples
// of 8).
inline bool args_ok(int n, int m, int blk, int cols, int S) {
  return cols == kCols && S == 1 && blk % kDepth == 0 && n % 8 == 0 &&
         m % 8 == 0;
}

// x (E, R, n) and w (E, n, m) bf16, 16-byte aligned; idx (E, kb) int32;
// y (E, R, m) f32, 8-byte aligned.  Encodes the two tensor maps and
// launches on `st`; returns cudaErrorInvalidValue where an encode fails,
// else cudaGetLastError().
int launch(const void* x, const void* w, const void* idx, void* y, int E,
           int R, int n, int m, int blk, int kb, cudaStream_t st);

}  // namespace tile
}  // namespace wisparse
