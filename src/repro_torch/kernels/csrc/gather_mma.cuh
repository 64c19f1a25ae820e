// The parts the two block-gather matmul kernels share: tile geometry, the
// cp.async ring that streams weight slabs and x tiles into shared memory,
// the "x tile x weight slab" step (bf16 tensor cores, f32 CUDA cores), and
// the fixed-order split-K epilogue.
//
// Both kernels compute y^T = W^T x^T for one (column tile of m, slice of
// the kept blocks, tile of batch rows): the tile's columns fill the MMA's
// 16-row M side, the batch rows its N = 8 side, and K runs over the kept
// channels.  A kept block of blk channels is streamed as chunks of kKC
// weight rows; one ring stage holds one chunk of W (kKC x kCols) and the
// matching x values (NB x kKC).  Each kernel has its own ring depth and
// chunk size; PERF.md holds the measurements that chose them.  The host
// owns the grid: repro_torch.kernels.sparse_matmul.launch_plan picks the
// batch rows per tile and the split, and passes them with the column tile
// it assumes, which the C entries check against kCols.
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace wisparse {
namespace gm {

constexpr int kThreads = 256;   // 8 warps
constexpr int kMaxSlice = 128;  // per-seq: most block ids one slice spans

// Column tile: bf16 128 columns (256 bytes of a weight row; 8 warps of 16
// MMA rows), f32 64 columns; rows are padded by 16 bytes so that
// ldmatrix's eight row addresses fall in distinct banks.
template <typename T>
struct Geom;
template <>
struct Geom<__nv_bfloat16> {
  static constexpr int kCols = 128;
  static constexpr int kPad = 8;
};
template <>
struct Geom<float> {
  static constexpr int kCols = 64;
  static constexpr int kPad = 4;
};

template <typename T, int NB, bool kPerSeq>
struct Layout {
  // weight rows per ring stage, and stages: the shared kernel runs about
  // one block per SM with 3 stages of a whole 128-row block, per-seq about
  // two with 4 stages of 64 rows
  static constexpr int kKC = kPerSeq ? 64 : 128;
  static constexpr int kStages = kPerSeq ? 4 : 3;
  static constexpr int kCols = Geom<T>::kCols;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWStride = kCols + Geom<T>::kPad;  // elements
  static constexpr int kXStride = kKC + Geom<T>::kPad;    // elements
  static constexpr int kWStage = kKC * kWStride;
  static constexpr int kXStage = NB * kXStride;
  static constexpr size_t kRing =
      static_cast<size_t>(kStages) * (kWStage + kXStage) * sizeof(T);
  // the per-block result tile, aliased onto the ring once it drains: bf16
  // keeps one f32 tile (padded rows), f32 one partial tile per k group
  static constexpr int kOutStride =
      sizeof(T) == 2 ? kCols + 4 : kCols;
  static constexpr size_t kOut =
      (sizeof(T) == 2 ? static_cast<size_t>(NB) * kOutStride
                      : static_cast<size_t>(4) * NB * kCols) *
      sizeof(float);
  static_assert(kOut <= kRing, "result tile must fit in the drained ring");
  // per-seq: occurrence counts (NB x kMaxSlice), the kept-block list of
  // the slice, each listed block's largest count, and the list length;
  // shared: the slice's first kMaxSlice block ids
  static constexpr size_t kCounts =
      (kPerSeq ? static_cast<size_t>(NB) * kMaxSlice + 2 * kMaxSlice + 4
               : kMaxSlice) *
      sizeof(int);
  static constexpr size_t kBytes = kRing + kCounts;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Stage weight rows [k0, k0 + rows) x columns [col0, col0 + kCols) and the
// x values of batch rows [row0, row0 + NB) at channels [k0, k0 + rows).
// Rows past `rows` (up to the next multiple of 16, the MMA depth), columns
// past m and batch rows past B are zero.  `vec`: 16-byte copies (m, n and
// blk multiples of 16 bytes' worth of elements, pointers aligned); else
// masked scalar loads, stored synchronously (the ring's barrier publishes
// them all the same).  Per-seq: `cnt` is the block's column of the count
// table, and the x rows that do not keep the block are zero too.
template <typename T, int NB, bool kPerSeq>
__device__ __forceinline__ void load_stage(T* ws, T* xs,
                                           const T* __restrict__ w,
                                           const T* __restrict__ x, int B,
                                           int n, int m, int row0, int col0,
                                           int k0, int rows, bool vec,
                                           const int* cnt) {
  using L = Layout<T, NB, kPerSeq>;
  constexpr int C = L::kCols;
  constexpr int V = L::kVec;
  const int kfill = round16(rows);
  if (vec) {
    // each thread copies one fixed 16-byte column of every rstep-th row
    constexpr int cpr = C / V;  // copies per weight row
    constexpr int rstep = kThreads / cpr;
    static_assert(kThreads % cpr == 0, "copies per row divide the block");
    const int c = (threadIdx.x % cpr) * V;
    const bool col_ok = col0 + c < m;
    const T* wcol = w + static_cast<size_t>(k0) * m + col0 + c;
    for (int r = threadIdx.x / cpr; r < kfill; r += rstep) {
      const bool ok = r < rows && col_ok;
      cp_async16(ws + r * L::kWStride + c,
                 ok ? wcol + static_cast<size_t>(r) * m : w, ok);
    }
    constexpr int xpr = L::kKC / V;  // copies per x row of a full stage
    for (int e = threadIdx.x; e < NB * xpr; e += kThreads) {
      const int r = e / xpr;
      const int cx = (e - r * xpr) * V;
      if (cx >= kfill) continue;
      const bool ok = row0 + r < B && cx < rows &&
                      (!kPerSeq || cnt[r * kMaxSlice] > 0);
      const T* src = ok ? x + static_cast<size_t>(row0 + r) * n + k0 + cx : x;
      cp_async16(xs + r * L::kXStride + cx, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kfill * C; e += kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      ws[r * L::kWStride + c] =
          (r < rows && col0 + c < m)
              ? w[static_cast<size_t>(k0 + r) * m + col0 + c]
              : zero_of<T>();
    }
    for (int e = threadIdx.x; e < NB * kfill; e += kThreads) {
      const int r = e / kfill;
      const int c = e - r * kfill;
      xs[r * L::kXStride + c] =
          (row0 + r < B && c < rows && (!kPerSeq || cnt[r * kMaxSlice] > 0))
              ? x[static_cast<size_t>(row0 + r) * n + k0 + c]
              : zero_of<T>();
    }
  }
}

// The ring: item t is loaded into stage t % kStages, kStages - 1 items
// ahead of the one being multiplied.  One barrier per item: it both
// publishes item t's stage and tells every warp that the stage about to be
// refilled (item t - 1's) has been read.
template <int kStages, typename Load, typename Compute>
__device__ __forceinline__ void run_ring(int items, Load load,
                                         Compute compute) {
#pragma unroll 1
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < items) load(t, t);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < items; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int tn = t + kStages - 1;
    if (tn < items) load(tn, tn % kStages);
    cp_async_commit();
    compute(t, t % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Accumulators of one thread.  bf16: warp w owns the 16 columns
// [16 w, 16 w + 16), one m16n8 C fragment per 8 batch rows.  f32: thread
// (c = tid % 64, g = tid / 64) owns column c and the g-th quarter of each
// stage's k rows, one sum per batch row.
template <typename T, int NB>
struct Acc;
template <int NB>
struct Acc<__nv_bfloat16, NB> {
  float c[NB / 8][4];
};
template <int NB>
struct Acc<float, NB> {
  float c[NB];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged chunk into the accumulators.  `cnt` (per-seq only) points at
// the chunk's block in the count table: row r keeps the block cnt[r *
// kMaxSlice] times, and the block is multiplied `passes` (its largest
// count) times with the rows whose count is not above the pass zeroed, so
// each occurrence adds once.  The loader already zeroed the rows that do
// not keep it, so the first pass needs no mask.  The shared kernel passes
// cnt = nullptr and passes = 1.
template <int NB, bool kPerSeq>
__device__ __forceinline__ void chunk_mma(Acc<__nv_bfloat16, NB>& acc,
                                          const __nv_bfloat16* ws,
                                          const __nv_bfloat16* xs, int rows,
                                          const int* cnt, int passes) {
  using L = Layout<__nv_bfloat16, NB, kPerSeq>;
  constexpr int NT = NB / 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  // ldmatrix.x4.trans: lane l gives the address of row (l & 7) of matrix
  // l >> 3; matrices 0-3 are (k 0-7, cols 0-7), (k 0-7, cols 8-15),
  // (k 8-15, cols 0-7), (k 8-15, cols 8-15) of a group of 16 columns,
  // which transposed are the A fragment's four registers in order.
  const int mi = lane >> 3;
  const __nv_bfloat16* arow =
      ws + ((lane & 7) + ((mi >> 1) << 3)) * L::kWStride + warp * 16 +
      ((mi & 1) << 3);
  const int ksteps = round16(rows) / 16;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(static_cast<unsigned>(
            __cvta_generic_to_shared(arow + ks * 16 * L::kWStride))));
    // B fragments (x^T, k = 2t, 2t + 1 and + 8 of batch row 8j + g) by
    // ldmatrix without .trans: matrices (rows 8j.., k 0-7), (rows 8j..,
    // k 8-15), then the same for j + 1
    uint32_t b[NT][2];
    const __nv_bfloat16* xrow =
        xs + ((lane & 7) + ((lane >> 4) << 3)) * L::kXStride + ks * 16 +
        (((lane >> 3) & 1) << 3);
    if constexpr (NT == 1) {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(b[0][0]), "=r"(b[0][1])
          : "r"(static_cast<unsigned>(__cvta_generic_to_shared(xrow))));
    } else {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]),
              "=r"(b[j + 1][1])
            : "r"(static_cast<unsigned>(__cvta_generic_to_shared(
                xrow + j * 8 * L::kXStride))));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc.c[j], a, b[j][0], b[j][1]);
    if (kPerSeq && passes > 1) {  // repeated ids: rows with more occurrences
      for (int o = 1; o < passes; ++o) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const bool on = cnt[(j * 8 + g) * kMaxSlice] > o;
          mma_bf16(acc.c[j], a, on ? b[j][0] : 0u, on ? b[j][1] : 0u);
        }
      }
    }
  }
}

template <int NB, bool kPerSeq>
__device__ __forceinline__ void chunk_mma(Acc<float, NB>& acc,
                                          const float* ws, const float* xs,
                                          int rows, const int* cnt,
                                          int /*passes*/) {
  using L = Layout<float, NB, kPerSeq>;
  constexpr int kGroup = L::kKC / (kThreads / L::kCols);  // k rows each
  const int c = threadIdx.x % L::kCols;
  const int k_lo = (threadIdx.x / L::kCols) * kGroup;
  const int k_hi = min(k_lo + kGroup, rows);
  int reps[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) reps[r] = kPerSeq ? cnt[r * kMaxSlice] : 1;
#pragma unroll 4
  for (int k = k_lo; k < k_hi; ++k) {
    const float wv = ws[k * L::kWStride + c];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const float xv = xs[r * L::kXStride + k];
      for (int o = 0; o < reps[r]; ++o) acc.c[r] = fmaf(xv, wv, acc.c[r]);
    }
  }
}

template <typename T, int NB>
__device__ __forceinline__ void zero_acc(Acc<T, NB>& acc) {
  float* p = reinterpret_cast<float*>(&acc);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(acc) / sizeof(float)); ++i) {
    p[i] = 0.0f;
  }
}

// Write the accumulators into the result tile (the drained ring).
template <int NB, bool kPerSeq>
__device__ __forceinline__ void store_acc(const Acc<__nv_bfloat16, NB>& acc,
                                          float* out) {
  using L = Layout<__nv_bfloat16, NB, kPerSeq>;
  const int lane = threadIdx.x % 32;
  const int i = (threadIdx.x / 32) * 16 + (lane >> 2);  // tile column
  const int n = 2 * (lane & 3);                         // batch row within 8
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    float* o = out + (j * 8 + n) * L::kOutStride + i;
    o[0] = acc.c[j][0];
    o[L::kOutStride] = acc.c[j][1];
    o[8] = acc.c[j][2];
    o[L::kOutStride + 8] = acc.c[j][3];
  }
}

template <int NB, bool kPerSeq>
__device__ __forceinline__ void store_acc(const Acc<float, NB>& acc,
                                          float* out) {
  using L = Layout<float, NB, kPerSeq>;
  const int c = threadIdx.x % L::kCols;
  const int grp = threadIdx.x / L::kCols;
#pragma unroll
  for (int r = 0; r < NB; ++r) out[(grp * NB + r) * L::kCols + c] = acc.c[r];
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// Four neighbouring columns [c, c + 4) of row r of the result tile.
template <typename T, int NB, bool kPerSeq>
__device__ __forceinline__ float4 tile_value4(const float* out, int r, int c) {
  using L = Layout<T, NB, kPerSeq>;
  if constexpr (sizeof(T) == 2) {
    return *reinterpret_cast<const float4*>(out + r * L::kOutStride + c);
  } else {
    // the four k groups' partial sums, in a fixed order
    constexpr int C = L::kCols;
    float4 v = *reinterpret_cast<const float4*>(out + r * C + c);
#pragma unroll
    for (int grp = 1; grp < 4; ++grp) {
      add4(v, *reinterpret_cast<const float4*>(out + (grp * NB + r) * C + c));
    }
    return v;
  }
}

// Row-major f32 values [p, p + 4) of which the first `left` exist.  `v4`:
// whole, 16-byte aligned float4s (m % 4 == 0 and aligned buffers).
__device__ __forceinline__ float4 load4(const float* p, int left, bool v4) {
  if (v4) return __ldcg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = __ldcg(p);
  if (left > 1) v.y = __ldcg(p + 1);
  if (left > 2) v.z = __ldcg(p + 2);
  if (left > 3) v.w = __ldcg(p + 3);
  return v;
}

__device__ __forceinline__ void store4(float* p, const float4& v, int left,
                                       bool v4) {
  if (v4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (left > 1) p[1] = v.y;
  if (left > 2) p[2] = v.z;
  if (left > 3) p[3] = v.w;
}

// Epilogue, after the result tile is complete in shared memory.  S == 1:
// write y.  Otherwise write this slice's partial to ws + s * plane (a
// B x m f32 plane per slice: plane = B * m, or E * B * m in the
// expert-batched launch, whose ws points at its expert's part); the last
// of the S blocks of the tile to arrive (an int counter per tile, which it
// resets) sums the S partials in the order s = 0..S-1 and writes y.  No
// float atomics: the result does not depend on arrival order.  Each thread
// handles groups of 4 neighbouring columns.
template <typename T, int NB, bool kPerSeq>
__device__ __forceinline__ void finish(const float* out, float* __restrict__ y,
                                       float* ws, int* counters, int B, int m,
                                       int row0, int col0, int S, int s,
                                       int tile, bool v4, size_t plane) {
  constexpr int C4 = Geom<T>::kCols / 4;
  __shared__ int last;
  float* dst = S == 1 ? y : ws + static_cast<size_t>(s) * plane;
  for (int e = threadIdx.x; e < NB * C4; e += kThreads) {
    const int r = e / C4;
    const int c = (e - r * C4) * 4;
    if (row0 + r < B && col0 + c < m) {
      store4(dst + static_cast<size_t>(row0 + r) * m + col0 + c,
             tile_value4<T, NB, kPerSeq>(out, r, c), m - col0 - c, v4);
    }
  }
  if (S == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + tile, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: each thread's EPT column groups, their loads of QC
  // partials issued together, then added in the order s = 0..S-1
  constexpr int EPT = (NB * C4 + kThreads - 1) / kThreads;
  constexpr int QC = EPT >= 4 ? 2 : 4;  // <= 8 float4 loads (128 columns)
  size_t off[EPT];
  int left[EPT];
  float4 sum[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / C4;
    const int c = (e - r * C4) * 4;
    const bool ok = e < NB * C4 && row0 + r < B && col0 + c < m;
    off[i] = static_cast<size_t>(row0 + r) * m + col0 + c;
    left[i] = ok ? m - col0 - c : 0;
    sum[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int q0 = 0; q0 < S; q0 += QC) {
    float4 v[EPT][QC];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
#pragma unroll
      for (int u = 0; u < QC; ++u) {
        if (left[i] > 0 && q0 + u < S) {
          v[i][u] = load4(ws + (q0 + u) * plane + off[i], left[i], v4);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
#pragma unroll
      for (int u = 0; u < QC; ++u) {
        if (left[i] > 0 && q0 + u < S) add4(sum[i], v[i][u]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    if (left[i] > 0) store4(y + off[i], sum[i], left[i], v4);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// 16-byte copies are possible: every row start of x and W is 16-byte
// aligned, and a block's channels are whole 16-byte pieces.
template <typename T>
inline bool vec_ok(const void* x, const void* w, int n, int m, int blk) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && n % V == 0 &&
         m % V == 0 && blk % V == 0;
}

// The epilogue's float4 path: whole, aligned 4-column groups in y and ws.
inline bool out4_ok(const void* y, const void* ws, int m) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(ws) % 16 == 0;
}

// The host's tile geometry fits the kernel: `rows` batch rows per tile
// (8, 16 or 32) in at most 65535 row tiles over all E experts, and a
// column tile of kCols.
template <typename T>
inline bool tiles_ok(int B, int rows, int cols, int E = 1) {
  return (rows == 8 || rows == 16 || rows == 32) &&
         static_cast<long long>((B + rows - 1) / rows) * E <= 65535 &&
         cols == Geom<T>::kCols;
}

// The arguments the C entries accept (ws and counters aside): the shared
// kernel's S slices of the kb positions of idx (the expert-batched form's
// too), per-seq's S slices of the nb block ids, none longer than
// kMaxSlice.
inline bool shared_args_ok(int E, int B, int n, int m, int blk, int kb,
                           int S) {
  return E > 0 && B > 0 && n > 0 && m > 0 && blk > 0 && kb > 0 &&
         n % blk == 0 && S >= 1 && S <= kb && S <= 65535;
}

inline bool per_seq_args_ok(int B, int n, int m, int blk, int kb, int S) {
  if (B <= 0 || n <= 0 || m <= 0 || blk <= 0 || kb <= 0 || n % blk != 0) {
    return false;
  }
  const int nb = n / blk;
  return S >= 1 && S <= nb && S <= 65535 && (nb + S - 1) / S <= kMaxSlice;
}

// The grid of a launch of NB-row tiles: (column tiles of m, S slices,
// row tiles x E experts); its block is kThreads and its dynamic shared
// memory Layout::kBytes.
template <typename T, int NB>
inline dim3 grid_of(int E, int B, int m, int S) {
  return dim3((m + Geom<T>::kCols - 1) / Geom<T>::kCols, S,
              (B + NB - 1) / NB * E);
}

// Allow the kernel's dynamic shared memory above the 48 KB default, once
// per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) done |= bit;
  return e;
}

}  // namespace gm
}  // namespace wisparse
