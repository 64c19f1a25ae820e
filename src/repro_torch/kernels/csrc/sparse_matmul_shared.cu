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
// What bounds it on an H100: bytes.  At the main path's B (8 decode slots,
// 32 rows of a prefill chunk) it does 2*B flops per weight element read,
// far below the ~295 flops/byte at which the bf16 tensor cores would bound
// it, so the least time is the kept weight bytes over 3.35 TB/s (58.7 MB,
// 17.5 us, for mlp/wi_gate at 50% kept).
//
// Design (shared with sparse_matmul_per_seq through gather_mma.cuh):
// - Split-K.  The grid is (column tiles of m) x (S slices of idx) x (tiles
//   of B).  Slice s takes positions [s*kb/S, (s+1)*kb/S) of idx, so slices
//   differ by at most one kept block; a block reads its slice's ids into
//   shared memory once.  S and the batch rows per tile come from the host
//   (sparse_matmul.launch_plan), from the shapes alone, so that about one
//   block per SM is in flight; the C entry checks them.
// - A ring of 3 stages in dynamic shared memory, each one chunk of 128
//   weight rows (a whole kept block at blk = 128) x 128 columns (bf16)
//   and its x values, filled by 16-byte cp.async copies two chunks ahead;
//   one barrier per chunk.  PERF.md holds the ring and split variants
//   measured against this choice.
// - bf16 on the tensor cores: mma.sync m16n8k16, A = W^T from ldmatrix
//   .trans, B = x^T (8 batch rows per N tile), f32 accumulators.  f32 runs
//   on CUDA-core FMA in the same grid (64-column tiles).
// - The S partial tiles are summed in the order s = 0..S-1 by the last
//   block of a column tile to finish: no float atomics, bit-identical runs.
// Expert axis: the reference runs this kernel under jax.vmap over a MoE
// layer's experts (src/repro/models/moe.py:93-112), one kept-block list
// and one weight slab per expert.  Here that is one launch whose grid's z
// runs over (expert, row tile): x (E, B, n), W (E, n, m), idx (E, kb) and
// y (E, B, m) are strided by expert, the split-K partials are planes of
// E x B x m, and the arrival counters are indexed per (expert, row tile,
// column tile).  That form was sized for 8-32 decode and chunk rows; at a
// whole prefill's rows (bound by operations, not bytes) the host passes
// rows == tile::kRows and the entry launches the TMA + wgmma tile kernel
// of sparse_matmul_tile.cu instead.
// Measured result: PERF.md (chip_smoke.py, per projection shape).
#include "gather_mma.cuh"
#include "sparse_matmul_tile.cuh"

namespace wisparse {
namespace {

template <typename T, int NB>
__global__ void __launch_bounds__(gm::kThreads, 2)
sparse_matmul_shared_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const int* __restrict__ idx, float* __restrict__ y,
                            float* ws, int* counters, int B, int n, int m,
                            int blk, int kb, int S, int flags) {
  using L = gm::Layout<T, NB, false>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* wring = reinterpret_cast<T*>(smem);
  T* xring = wring + L::kStages * L::kWStage;
  const int col0 = blockIdx.x * L::kCols;
  const int s = blockIdx.y;
  const int tiles_b = (B + NB - 1) / NB;
  const int row0 = (blockIdx.z % tiles_b) * NB;
  const int nb = n / blk;
  // expert blockIdx.z / tiles_b's slices (one expert: the only one)
  const size_t ex = blockIdx.z / tiles_b;
  const size_t plane = static_cast<size_t>(gridDim.z / tiles_b) * B * m;
  x += ex * B * n;
  w += ex * n * m;
  idx += ex * kb;
  y += ex * B * m;
  if (ws != nullptr) ws += ex * B * m;
  const int p0 = static_cast<int>(static_cast<long long>(s) * kb / S);
  const int p1 = static_cast<int>(static_cast<long long>(s + 1) * kb / S);
  const int nchunks = (blk + L::kKC - 1) / L::kKC;
  // the slice's ids, clamped, read once (the ring then finds them in
  // shared memory); a slice longer than kMaxSlice reads the rest directly
  int* sids = reinterpret_cast<int*>(smem + L::kRing);
  for (int i = threadIdx.x; i < min(p1 - p0, gm::kMaxSlice);
       i += gm::kThreads) {
    sids[i] = min(max(idx[p0 + i], 0), nb - 1);
  }
  __syncthreads();

  gm::Acc<T, NB> acc;
  gm::zero_acc(acc);
  auto rows_of = [&](int item) {
    return min(L::kKC, blk - (item % nchunks) * L::kKC);
  };
  auto load = [&](int item, int stage) {
    const int p = item / nchunks;
    const int id = p < gm::kMaxSlice ? sids[p]
                                     : min(max(idx[p0 + p], 0), nb - 1);
    const int k0 = id * blk + (item % nchunks) * L::kKC;
    gm::load_stage<T, NB, false>(wring + stage * L::kWStage,
                                 xring + stage * L::kXStage, w, x, B, n, m,
                                 row0, col0, k0, rows_of(item),
                                 (flags & 1) != 0, nullptr);
  };
  auto compute = [&](int item, int stage) {
    gm::chunk_mma<NB, false>(acc, wring + stage * L::kWStage,
                             xring + stage * L::kXStage, rows_of(item),
                             nullptr, 1);
  };
  gm::run_ring<L::kStages>((p1 - p0) * nchunks, load, compute);

  float* out = reinterpret_cast<float*>(smem);
  gm::store_acc<NB, false>(acc, out);
  __syncthreads();
  gm::finish<T, NB, false>(out, y, ws, counters, B, m, row0, col0, S, s,
                           blockIdx.z * gridDim.x + blockIdx.x,
                           (flags & 2) != 0, plane);
}

template <typename T, int NB>
int launch_shared(const void* x, const void* w, const void* idx, void* y,
                  void* ws, void* counters, int E, int B, int n, int m,
                  int blk, int kb, int S, cudaStream_t st) {
  using L = gm::Layout<T, NB, false>;
  static unsigned done = 0;
  auto kern = sparse_matmul_shared_kernel<T, NB>;
  cudaError_t e = gm::allow_smem(kern, L::kBytes, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gm::grid_of<T, NB>(E, B, m, S);
  kern<<<grid, gm::kThreads, L::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(idx), static_cast<float*>(y),
      static_cast<float*>(ws), static_cast<int*>(counters), B, n, m, blk, kb,
      S, (gm::vec_ok<T>(x, w, n, m, blk) ? 1 : 0) |
             (gm::out4_ok(y, ws, m) ? 2 : 0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_shared(const void* x, const void* w, const void* idx, void* y,
                    void* ws, void* counters, int E, int B, int n, int m,
                    int blk, int kb, int rows, int cols, int S,
                    cudaStream_t st) {
  if (!gm::tiles_ok<T>(B, rows, cols, E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (rows) {
    case 8:
      return launch_shared<T, 8>(x, w, idx, y, ws, counters, E, B, n, m, blk,
                                 kb, S, st);
    case 16:
      return launch_shared<T, 16>(x, w, idx, y, ws, counters, E, B, n, m,
                                  blk, kb, S, st);
    default:
      return launch_shared<T, 32>(x, w, idx, y, ws, counters, E, B, n, m,
                                  blk, kb, S, st);
  }
}

int entry_shared(const void* x, const void* w, const void* idx, void* y,
                 void* ws, void* counters, int E, int B, int n, int m,
                 int blk, int kb, int rows, int cols, int S, int dtype,
                 void* stream) {
  if (!gm::shared_args_ok(E, B, n, m, blk, kb, S) ||
      (S > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == tile::kRows) {
    // the whole-prefill form: bf16, 16-byte aligned x and w, one slice
    if (dtype != kBFloat16 || !tile::args_ok(n, m, blk, cols, S) ||
        !gm::vec_ok<__nv_bfloat16>(x, w, n, m, blk) ||
        reinterpret_cast<uintptr_t>(y) % 8 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return tile::launch(x, w, idx, y, E, B, n, m, blk, kb, st);
  }
  if (dtype == kFloat32) {
    return dispatch_shared<float>(x, w, idx, y, ws, counters, E, B, n, m, blk,
                                  kb, rows, cols, S, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_shared<__nv_bfloat16>(x, w, idx, y, ws, counters, E, B, n,
                                          m, blk, kb, rows, cols, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace wisparse

// x: (B, n) and w: (n, m) of `dtype`; idx: (kb,) int32; y: (B, m) f32.
// The host's plan: `rows` batch rows per tile (8, 16 or 32), `cols`
// columns per tile (must be the kernel's: 128 bf16, 64 f32), S split-K
// slices (1 <= S <= kb); or rows 128, cols 256 and S 1 for the tile form
// (sparse_matmul_tile.cu: bf16, aligned, blk a multiple of 64).  For
// S > 1, ws: S x B x m f32 scratch and counters: one int32 per (column
// tile, row tile), zero on entry and left zero.  Returns
// cudaGetLastError().
extern "C" int wisparse_sparse_matmul_shared(const void* x, const void* w,
                                             const void* idx, void* y,
                                             void* ws, void* counters, int B,
                                             int n, int m, int blk, int kb,
                                             int rows, int cols, int S,
                                             int dtype, void* stream) {
  return wisparse::entry_shared(x, w, idx, y, ws, counters, 1, B, n, m, blk,
                                kb, rows, cols, S, dtype, stream);
}

// The expert-batched form: x (E, B, n) and w (E, n, m) of `dtype`; idx
// (E, kb) int32; y (E, B, m) f32.  For S > 1, ws: S x E x B x m f32 and
// counters: one int32 per (expert, row tile, column tile).  rows 128
// launches the tile form (whole-prefill rows), which takes neither.
// Returns cudaGetLastError(), or cudaErrorInvalidValue where the tile
// form's tensor maps cannot be encoded.
extern "C" int wisparse_sparse_matmul_shared_experts(
    const void* x, const void* w, const void* idx, void* y, void* ws,
    void* counters, int E, int B, int n, int m, int blk, int kb, int rows,
    int cols, int S, int dtype, void* stream) {
  return wisparse::entry_shared(x, w, idx, y, ws, counters, E, B, n, m, blk,
                                kb, rows, cols, S, dtype, stream);
}
