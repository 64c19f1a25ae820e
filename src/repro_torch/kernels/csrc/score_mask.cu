// WiSparse fused scoring + threshold mask + per-channel-block score sums.
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:score_mask
// (_score_mask_kernel, geometry in score_mask_plan): for x (B, n) and
// channel blocks of `blk`,
//   s = |x| * max(g, 1e-12)^alpha        (f32, paper Eq. 4)
//   keep = s >= tau                      (paper Eq. 5)
//   xm = keep ? x : 0                    (x's dtype)
//   bs[j] = sum_rows sum_{c in block j} (keep ? s : 0) * rw[row]   (f32)
// alpha and tau are read from device memory (the sp tree's own f32
// scalars), as the TPU kernel took them by scalar prefetch, so the caller
// never syncs to read them and builds nothing per call.  A null rw
// weights every row by 1.
//
// What bounds it on an H100: bytes.  It reads x once and writes xm once
// (about 0.5 MB at the decode shapes B=8, n=14336 in bf16), a fraction of
// a microsecond at 3.35 TB/s, so in practice the launch latency bounds it.
//
// Design: one thread block per channel block (the TPU grid's one program
// per channel block), 128 threads, each thread owning channels c, c+128,
// ... of its block and looping over the B rows.  Neighbouring threads read
// neighbouring channels of one row, so every load and store is coalesced.
// Each thread keeps its share of the block score in a register; the block
// then sums the 128 partials with a fixed-shape tree in shared memory.  No
// atomics: the summation order is fixed, so repeated runs are
// bit-identical (the engine's token-parity checks rely on that).
#include "common.cuh"

namespace wisparse {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_mask_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ alpha_p,
                  const float* __restrict__ tau_p, const float* __restrict__ rw,
                  T* __restrict__ xm, float* __restrict__ bs, int B, int n,
                  int blk) {
  const int j = blockIdx.x;
  const float alpha = *alpha_p;
  const float tau = *tau_p;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < blk; c += kThreads) {
    const int col = j * blk + c;
    const float gp = powf(fmaxf(g[col], 1e-12f), alpha);
    for (int b = 0; b < B; ++b) {
      const size_t off = static_cast<size_t>(b) * n + col;
      const T xv = x[off];
      const float s = fabsf(to_f32(xv)) * gp;
      const bool keep = s >= tau;
      xm[off] = keep ? xv : zero_of<T>();
      acc += (keep ? s : 0.0f) * (rw != nullptr ? rw[b] : 1.0f);
    }
  }
  __shared__ float red[kThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) bs[j] = red[0];
}

}  // namespace wisparse

// x, xm: (B, n) of `dtype`; g: (n,) f32; alpha, tau: one f32 each;
// rw: (B,) f32 or null (weight 1); bs: (n / blk,) f32.  Returns
// cudaGetLastError().
extern "C" int wisparse_score_mask(const void* x, const void* g,
                                   const void* alpha, const void* tau,
                                   const void* rw, void* xm, void* bs, int B,
                                   int n, int blk, int dtype, void* stream) {
  using namespace wisparse;
  if (B <= 0 || n <= 0 || blk <= 0 || n % blk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n / blk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* af = static_cast<const float*>(alpha);
  const float* tf = static_cast<const float*>(tau);
  const float* rwf = static_cast<const float*>(rw);
  float* bsf = static_cast<float*>(bs);
  if (dtype == kFloat32) {
    score_mask_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), gf, af, tf, rwf, static_cast<float*>(xm),
        bsf, B, n, blk);
  } else if (dtype == kBFloat16) {
    score_mask_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), gf, af, tf, rwf,
        static_cast<__nv_bfloat16*>(xm), bsf, B, n, blk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
