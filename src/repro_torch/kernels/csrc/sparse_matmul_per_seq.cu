// WiSparse block-gather matmul with one kept-block list per row.
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:
// sparse_matmul_per_seq (_acc_kernel_perseq, geometry in per_seq_plan):
//   y[b, :] = sum_{i < kb} x[b, blk*idx[b,i] : +blk] @ W[blk*idx[b,i] : +blk, :]
// x (B, n) and W (n, m) in f32 or bf16, idx (B, kb) int32, y (B, m) f32.  A
// repeated block id counts once per occurrence; ids are clamped to
// [0, n/blk), as the reference's block index map clamps.
//
// What bounds it on an H100: bytes.  Each row does 2 flops per weight
// element it reads, so the least time is the kept weight rows (their union
// over the rows), the kept x blocks, the ids and y over 3.35 TB/s.
//
// Design: one thread block per (64-column tile of m, row b), 256 threads =
// 8 warps.  The TPU grid walked the row's ids as its sequential axis and
// accumulated in VMEM; here the block walks them itself, kChunk ids at a
// time: it loads the chunk's ids from device memory (the TPU took them by
// scalar prefetch) and stages the row's x values of those blocks in shared
// memory as f32, then warp w reads weight rows w, w+8, ... of each staged
// block.  Lane l owns columns l and l+32 of the tile, so each warp load
// covers 32 neighbouring elements (coalesced), and keeps their two sums in
// f32 registers, adding in a fixed order.  Staging kChunk blocks per
// barrier pair keeps the barriers out of the inner loop.  The 8 warps'
// partial sums are added in a fixed order through shared memory at the
// end: no atomics, bit-identical across runs.  Ragged m is masked in the
// kernel, not padded.  No tensor cores and no TMA yet: rows with the same
// ids read the same weight rows again (from L2 when they share a wave).
#include "common.cuh"

namespace wisparse {

constexpr int kPsWarps = 8;
constexpr int kPsThreads = kPsWarps * 32;
constexpr int kPsCols = 64;   // output columns per block (2 per lane)
constexpr int kChunk = 8;     // kept blocks staged per barrier pair

template <typename T>
__global__ void __launch_bounds__(kPsThreads)
sparse_matmul_per_seq_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const int* __restrict__ idx,
                             float* __restrict__ y, int n, int m, int blk,
                             int kb) {
  extern __shared__ float smem[];
  float* xs = smem;                   // kChunk * blk staged x values
  float* red = smem + kChunk * blk;   // kPsWarps * kPsCols partial sums
  __shared__ int ids[kChunk];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kPsCols;
  const int b = blockIdx.y;
  const int nb = n / blk;
  const int c0 = col0 + lane;
  const int c1 = col0 + 32 + lane;
  const bool ok0 = c0 < m;
  const bool ok1 = c1 < m;
  const T* xr = x + static_cast<size_t>(b) * n;
  const int* ir = idx + static_cast<size_t>(b) * kb;

  float acc0 = 0.0f;
  float acc1 = 0.0f;
  for (int i0 = 0; i0 < kb; i0 += kChunk) {
    const int nc = min(kChunk, kb - i0);
    __syncthreads();  // every warp is done with the previous chunk
    if (threadIdx.x < nc) {
      ids[threadIdx.x] = min(max(ir[i0 + threadIdx.x], 0), nb - 1);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nc * blk; t += kPsThreads) {
      const int c = t / blk;
      const int k = t - c * blk;
      xs[t] = to_f32(xr[static_cast<size_t>(ids[c]) * blk + k]);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const T* wb = w + static_cast<size_t>(ids[c]) * blk * m;
      const float* xb = xs + c * blk;
#pragma unroll 4
      for (int k = warp; k < blk; k += kPsWarps) {
        const T* wr = wb + static_cast<size_t>(k) * m;
        const float xv = xb[k];
        const float w0 = ok0 ? to_f32(wr[c0]) : 0.0f;
        const float w1 = ok1 ? to_f32(wr[c1]) : 0.0f;
        acc0 = fmaf(xv, w0, acc0);
        acc1 = fmaf(xv, w1, acc1);
      }
    }
  }

  red[warp * kPsCols + lane] = acc0;
  red[warp * kPsCols + 32 + lane] = acc1;
  __syncthreads();
  if (threadIdx.x < kPsCols) {
    const int col = col0 + threadIdx.x;
    if (col < m) {
      float s = 0.0f;
      for (int v = 0; v < kPsWarps; ++v) s += red[v * kPsCols + threadIdx.x];
      y[static_cast<size_t>(b) * m + col] = s;
    }
  }
}

}  // namespace wisparse

// x: (B, n) and w: (n, m) of `dtype`; idx: (B, kb) int32; y: (B, m) f32.
// Returns cudaGetLastError().
extern "C" int wisparse_sparse_matmul_per_seq(const void* x, const void* w,
                                              const void* idx, void* y, int B,
                                              int n, int m, int blk, int kb,
                                              int dtype, void* stream) {
  using namespace wisparse;
  if (B <= 0 || B > 65535 || n <= 0 || m <= 0 || blk <= 0 || kb <= 0 ||
      n % blk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // dynamic shared memory: the staged x chunk and the warps' partial sums;
  // a blk that needs more than the 48 KB default is refused
  const int smem = static_cast<int>(
      (kChunk * blk + kPsWarps * kPsCols) * sizeof(float));
  if (smem > 48 * 1024 - static_cast<int>(kChunk * sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kPsCols - 1) / kPsCols, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  float* yf = static_cast<float*>(y);
  if (dtype == kFloat32) {
    sparse_matmul_per_seq_kernel<float><<<grid, kPsThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ids, yf,
        n, m, blk, kb);
  } else if (dtype == kBFloat16) {
    sparse_matmul_per_seq_kernel<__nv_bfloat16>
        <<<grid, kPsThreads, smem, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w), ids, yf, n, m, blk, kb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
