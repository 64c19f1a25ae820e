// WiSparse block-gather matmul with one kept-block list per row.
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:
// sparse_matmul_per_seq (_acc_kernel_perseq, geometry in per_seq_plan):
//   y[b, :] = sum_{i < kb} x[b, blk*idx[b,i] : +blk] @ W[blk*idx[b,i] : +blk, :]
// x (B, n) and W (n, m) in f32 or bf16, idx (B, kb) int32, y (B, m) f32.  A
// repeated block id counts once per occurrence; ids are clamped to
// [0, n/blk), as the reference's block index map clamps.
//
// What bounds it on an H100: bytes.  The least it must read is the union
// over the rows of their kept weight rows, plus the kept x blocks, the ids
// and y, over 3.35 TB/s; at the main path's B it does far fewer than the
// ~295 flops per byte that would make the tensor cores the limit.
//
// Design (the ring, the tensor-core step and the split-K epilogue are the
// shared kernel's, in gather_mma.cuh, here with 4 stages of 64 weight rows
// and about two blocks per SM): the TPU grid walked each row's ids
// as its sequential axis, so every row read its own weight rows.  Here the
// K axis is sliced by block id: slice s of the grid owns ids
// [s*nb/S, (s+1)*nb/S) (at most 128 of them).  Each thread block first
// reads the ids of its batch rows and counts, in shared memory, how many
// times each row keeps each block of its slice; blocks no row keeps are
// skipped, so W is read once per kept block of the union, whatever B is.
// A listed block is multiplied with the x tile of all the tile's rows,
// those that do not keep it zeroed, once per occurrence (one more MMA pass
// per extra repeat of an id), which keeps the once-per-occurrence contract
// exact.  With every row given the same ids it reads what the shared
// kernel reads; the sums are taken in block-id order, not idx order, so
// the two agree to rounding, not bit for bit.
// Measured result: PERF.md (chip_smoke.py, per projection shape).
#include "gather_mma.cuh"

namespace wisparse {
namespace {

template <typename T, int NB>
__global__ void __launch_bounds__(gm::kThreads, 2)
sparse_matmul_per_seq_kernel(const T* __restrict__ x,
                             const T* __restrict__ w,
                             const int* __restrict__ idx,
                             float* __restrict__ y, float* ws, int* counters,
                             int B, int n, int m, int blk, int kb, int S,
                             int flags) {
  using L = gm::Layout<T, NB, true>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* wring = reinterpret_cast<T*>(smem);
  T* xring = wring + L::kStages * L::kWStage;
  int* cnt = reinterpret_cast<int*>(smem + L::kRing);  // NB x kMaxSlice
  int* list = cnt + NB * gm::kMaxSlice;    // kept ids of the slice, in order
  int* passes = list + gm::kMaxSlice;      // each listed id's largest count
  int* nlist = passes + gm::kMaxSlice;
  const int col0 = blockIdx.x * L::kCols;
  const int s = blockIdx.y;
  const int row0 = blockIdx.z * NB;
  const int nb = n / blk;
  const int b0 = static_cast<int>(static_cast<long long>(s) * nb / S);
  const int b1 = static_cast<int>(static_cast<long long>(s + 1) * nb / S);
  const int width = b1 - b0;

  for (int e = threadIdx.x; e < NB * width; e += gm::kThreads) {
    cnt[(e / width) * gm::kMaxSlice + e % width] = 0;
  }
  for (int l = threadIdx.x; l < width; l += gm::kThreads) passes[l] = 0;
  __syncthreads();
  const int nrows = min(NB, B - row0);
  for (int e = threadIdx.x; e < nrows * kb; e += gm::kThreads) {
    const int r = e / kb;
    const int id = min(max(idx[static_cast<size_t>(row0) * kb + e], 0),
                       nb - 1);
    if (id >= b0 && id < b1) {
      // passes[l] collects each id's largest count before the list
      // (built in place below, in id order) takes its slot
      const int c = atomicAdd(cnt + r * gm::kMaxSlice + id - b0, 1) + 1;
      atomicMax(passes + id - b0, c);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // list the slice's kept ids in id order
    const int lane = threadIdx.x;
    int base = 0;
    for (int l0 = 0; l0 < width; l0 += 32) {
      const int l = l0 + lane;
      const int most = l < width ? passes[l] : 0;
      __syncwarp();
      const unsigned kept = __ballot_sync(0xffffffffu, most > 0);
      if (most > 0) {
        const int pos = base + __popc(kept & ((1u << lane) - 1u));
        list[pos] = l;
        passes[pos] = most;
      }
      base += __popc(kept);
    }
    if (lane == 0) *nlist = base;
  }
  __syncthreads();
  const int nchunks = (blk + L::kKC - 1) / L::kKC;

  gm::Acc<T, NB> acc;
  gm::zero_acc(acc);
  auto rows_of = [&](int item) {
    return min(L::kKC, blk - (item % nchunks) * L::kKC);
  };
  auto load = [&](int item, int stage) {
    const int l = list[item / nchunks];
    const int k0 = (b0 + l) * blk + (item % nchunks) * L::kKC;
    gm::load_stage<T, NB, true>(wring + stage * L::kWStage,
                                xring + stage * L::kXStage, w, x, B, n, m,
                                row0, col0, k0, rows_of(item),
                                (flags & 1) != 0, cnt + l);
  };
  auto compute = [&](int item, int stage) {
    const int p = item / nchunks;
    gm::chunk_mma<NB, true>(acc, wring + stage * L::kWStage,
                            xring + stage * L::kXStage, rows_of(item),
                            cnt + list[p], passes[p]);
  };
  gm::run_ring<L::kStages>(*nlist * nchunks, load, compute);

  float* out = reinterpret_cast<float*>(smem);
  gm::store_acc<NB, true>(acc, out);
  __syncthreads();
  gm::finish<T, NB, true>(out, y, ws, counters, B, m, row0, col0, S, s,
                          blockIdx.z * gridDim.x + blockIdx.x,
                          (flags & 2) != 0, static_cast<size_t>(B) * m);
}

template <typename T, int NB>
int launch_per_seq(const void* x, const void* w, const void* idx, void* y,
                   void* ws, void* counters, int B, int n, int m, int blk,
                   int kb, int S, cudaStream_t st) {
  using L = gm::Layout<T, NB, true>;
  static unsigned done = 0;
  auto kern = sparse_matmul_per_seq_kernel<T, NB>;
  cudaError_t e = gm::allow_smem(kern, L::kBytes, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid = gm::grid_of<T, NB>(1, B, m, S);
  kern<<<grid, gm::kThreads, L::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(idx), static_cast<float*>(y),
      static_cast<float*>(ws), static_cast<int*>(counters), B, n, m, blk, kb,
      S, (gm::vec_ok<T>(x, w, n, m, blk) ? 1 : 0) |
             (gm::out4_ok(y, ws, m) ? 2 : 0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_per_seq(const void* x, const void* w, const void* idx, void* y,
                     void* ws, void* counters, int B, int n, int m, int blk,
                     int kb, int rows, int cols, int S, cudaStream_t st) {
  if (!gm::tiles_ok<T>(B, rows, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (rows) {
    case 8:
      return launch_per_seq<T, 8>(x, w, idx, y, ws, counters, B, n, m, blk,
                                  kb, S, st);
    case 16:
      return launch_per_seq<T, 16>(x, w, idx, y, ws, counters, B, n, m, blk,
                                   kb, S, st);
    default:
      return launch_per_seq<T, 32>(x, w, idx, y, ws, counters, B, n, m, blk,
                                   kb, S, st);
  }
}

}  // namespace
}  // namespace wisparse

// x: (B, n) and w: (n, m) of `dtype`; idx: (B, kb) int32; y: (B, m) f32.
// The host's plan: `rows` batch rows per tile (8, 16 or 32), `cols`
// columns per tile (must be the kernel's: 128 bf16, 64 f32), S split-K
// slices of the block ids (ceil(nb/128) <= S <= nb, nb = n/blk).  For
// S > 1, ws: S x B x m f32 scratch and counters: one int32 per (column
// tile, row tile), zero on entry and left zero.  Returns
// cudaGetLastError().
extern "C" int wisparse_sparse_matmul_per_seq(const void* x, const void* w,
                                              const void* idx, void* y,
                                              void* ws, void* counters,
                                              int B, int n, int m, int blk,
                                              int kb, int rows, int cols,
                                              int S, int dtype,
                                              void* stream) {
  using namespace wisparse;
  if (!gm::per_seq_args_ok(B, n, m, blk, kb, S) ||
      (S > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return dispatch_per_seq<float>(x, w, idx, y, ws, counters, B, n, m, blk,
                                   kb, rows, cols, S, st);
  }
  if (dtype == kBFloat16) {
    return dispatch_per_seq<__nv_bfloat16>(x, w, idx, y, ws, counters, B, n,
                                           m, blk, kb, rows, cols, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
