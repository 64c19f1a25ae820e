// WiSparse block-gather matmul with one kept-block set for the batch.
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:
// sparse_matmul_shared (_acc_kernel, geometry in shared_plan):
//   y[b, :] = sum_{i < kb} x[b, blk*idx[i] : +blk] @ W[blk*idx[i] : +blk, :]
// x (B, n) and W (n, m) in f32 or bf16, idx (kb,) int32, y (B, m) f32.  A
// repeated block id counts once per occurrence (the reference's pad
// contract); ids are clamped to [0, n/blk), as the reference's dynamic
// slice clamps.
//
// What bounds it on an H100: bytes.  At decode (B = 8) it does 2*B flops
// per weight element read, far below the ~295 flops/byte at which bf16
// tensor cores would bound it, so the least time is the kept weight bytes
// over 3.35 TB/s (e.g. 58.7 MB, 17.5 us, for mlp/wi_gate at 50% kept).
//
// Design: W is row-major, so a kept block is one contiguous blk x m slab
// and every weight row is read along m.  One thread block per (64-column
// tile of m, 8-row tile of B), 256 threads = 8 warps.  The block loads
// the ids itself from device memory (the TPU took them by scalar
// prefetch) and walks them in order; for each it stages the 8 x blk tile
// of x in shared memory as f32, then warp w reads weight rows w, w+8, ...
// of the slab.  Lane l owns columns l and l+32 of the tile, so each warp
// load covers 32 neighbouring elements (coalesced), and keeps the sums of
// its two columns for all 8 batch rows in f32 registers.  The 8 warps'
// partial sums are added in a fixed order through shared memory at the
// end: no atomics, bit-identical across runs.  Ragged B and m are masked
// in the kernel, not padded.  Known limit, left to a later change: at
// m = 1024 (attn/wk, attn/wv) only 16 blocks launch on the 132 SMs, so
// those projections cannot reach the card's bandwidth (split-K would).
#include "common.cuh"

namespace wisparse {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;   // output columns per block (2 per lane)
constexpr int kRows = 8;    // batch rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_matmul_shared_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const int* __restrict__ idx, float* __restrict__ y,
                            int B, int n, int m, int blk, int kb) {
  extern __shared__ float smem[];
  float* xs = smem;                  // kRows * blk staged x values
  float* red = smem + kRows * blk;   // kWarps * kRows * kCols partial sums
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;
  const int nb = n / blk;
  const int c0 = col0 + lane;
  const int c1 = col0 + 32 + lane;
  const bool ok0 = c0 < m;
  const bool ok1 = c1 < m;

  float acc0[kRows];
  float acc1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc0[r] = 0.0f;
    acc1[r] = 0.0f;
  }

  for (int i = 0; i < kb; ++i) {
    const int id = min(max(idx[i], 0), nb - 1);
    const int k0 = id * blk;
    __syncthreads();  // every warp is done reading the previous tile
    for (int t = threadIdx.x; t < kRows * blk; t += kThreads) {
      const int r = t / blk;
      const int c = t - r * blk;
      const int row = row0 + r;
      xs[t] = row < B ? to_f32(x[static_cast<size_t>(row) * n + k0 + c])
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = warp; k < blk; k += kWarps) {
      const T* wr = w + static_cast<size_t>(k0 + k) * m;
      const float w0 = ok0 ? to_f32(wr[c0]) : 0.0f;
      const float w1 = ok1 ? to_f32(wr[c1]) : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xs[r * blk + k];
        acc0[r] = fmaf(xv, w0, acc0[r]);
        acc1[r] = fmaf(xv, w1, acc1[r]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red[(warp * kRows + r) * kCols + lane] = acc0[r];
    red[(warp * kRows + r) * kCols + 32 + lane] = acc1[r];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kRows * kCols; t += kThreads) {
    const int r = t / kCols;
    const int c = t - r * kCols;
    const int row = row0 + r;
    const int col = col0 + c;
    if (row < B && col < m) {
      float s = 0.0f;
      for (int v = 0; v < kWarps; ++v) s += red[(v * kRows + r) * kCols + c];
      y[static_cast<size_t>(row) * m + col] = s;
    }
  }
}

}  // namespace wisparse

// x: (B, n) and w: (n, m) of `dtype`; idx: (kb,) int32; y: (B, m) f32.
// Returns cudaGetLastError().
extern "C" int wisparse_sparse_matmul_shared(const void* x, const void* w,
                                             const void* idx, void* y, int B,
                                             int n, int m, int blk, int kb,
                                             int dtype, void* stream) {
  using namespace wisparse;
  if (B <= 0 || n <= 0 || m <= 0 || blk <= 0 || kb <= 0 || n % blk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // shared memory: the staged x tile and the warps' partial sums; a blk
  // that needs more than the 48 KB default is refused
  const int smem = static_cast<int>(
      (kRows * blk + kWarps * kRows * kCols) * sizeof(float));
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  float* yf = static_cast<float*>(y);
  if (dtype == kFloat32) {
    sparse_matmul_shared_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ids, yf, B,
        n, m, blk, kb);
  } else if (dtype == kBFloat16) {
    sparse_matmul_shared_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), ids, yf, B, n, m, blk, kb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
