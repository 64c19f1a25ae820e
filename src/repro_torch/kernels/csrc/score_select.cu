// WiSparse scoring, threshold mask, block sums, top-k block selection and
// rank mask in one launch of one thread-block cluster.
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:319
// (score_mask, body _score_mask_kernel) together with the selection that
// src/repro/kernels/ops.py:wisparse_project runs after it (lax.top_k, the
// keep_frac rank limit, the block mask).  For x (B, n), channel blocks of
// `blk` (nb = n / blk of them) and the static budget kb:
//   s = |x| * max(g, 1e-12)^alpha        (f32, paper Eq. 4)
//   bs[j] = sum_rows sum_{c in block j} (s >= tau ? s : 0) * rw[row]   (f32)
//   rank(j) = #{i : bs[i] > bs[j] or (bs[i] == bs[j] and i < j)}
//   idx[rank(j)] = j                     for rank(j) < kb   (lax.top_k order)
//   xm = (s >= tau && rank(block) < min(kb, rint(keep_frac * nb))) ? x : 0
// alpha, tau and keep_frac are read from device memory (the sp tree's own
// f32 scalars), so the caller never syncs to read them.  A null rw weights
// every row by 1.  A null idx runs the mask alone (no rank limit: the
// score_mask entry point), with no exchange between the cluster's blocks.
//
// What bounds it on an H100: bytes.  It reads x once and writes xm once
// (0.42 us per decode layer at B = 8 in bf16 over 3.35 TB/s), but at the
// main path's B its time is set by latency: a launch (about 1.2 us for an
// empty cluster launch), one round trip to memory, the cluster barrier
// and the stores.  Before this kernel the selection ran as about a dozen
// PyTorch launches after the scoring kernel (top-k, round, arange, zeros,
// scatter, repeat_interleave, casts, a multiply), each a launch of
// latency on the device and tens of microseconds on the host.  Folding
// them into the scoring launch leaves one launch where there were a dozen.
//
// Design:
// - One cluster of C = min(16, nb) blocks (16 needs the non-portable
//   cluster size; 8 was slower at every main-path shape), 512 threads
//   each.  Block c owns the channel blocks [c*nb/C, (c+1)*nb/C).  A
//   thread owns one 16-byte column of those channels (8 bf16 or 4 f32)
//   and a strided set of rows; the rows' loads are issued 4 at a time
//   (kUnroll) before any is used, the first 4 before anything else.
// - g^alpha is computed once per channel into shared memory, not once
//   per row group.
// - Block sums: each thread's (row group, column) partial goes to shared
//   memory; one warp per channel block sums them in a fixed order and a
//   fixed-shape shuffle tree.  No atomics: two launches are bit-equal.
// - Selection: every block writes its sums into every peer's shared
//   memory (map_shared_rank); one cluster barrier makes them visible
//   (a second, arrived at on entry and awaited before the first remote
//   write, ensures every peer has started); then each block ranks its
//   own blocks by counting over all nb sums: no sort, no second launch.
//   NaN sums rank first, as torch.sort puts them.
// - xm: each thread writes its own columns again, from the registers that
//   still hold its first rows, or by re-reading x from L2; a block
//   outside the rank limit is written as zeros without reading x.
// - The score expression powf(fmaxf(g, 1e-12f), alpha) is the plain
//   version's, so xm is bit-equal to it; rintf rounds half to even, as
//   torch.round and jnp.round do.
// One cluster uses 8-16 of the 132 SMs, so at a whole-prompt B (hundreds
// of rows) the time grows with B, far from the bound.
// Measured result: PERF.md (chip_smoke.py, per projection shape).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace wisparse {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kCluster = 16;
constexpr int kMaxBlocks = 8192;           // nb limit of the shared table
constexpr size_t kMaxSmem = 232448;        // an H100 block's shared memory

// A thread's load unit: 16 bytes (uint4) when the channel block is a
// multiple of 16 bytes and x, xm are 16-byte aligned, else one element.
template <typename T, bool kWide>
struct Unit;

template <typename T>
struct Unit<T, false> {
  using Raw = T;
  static constexpr int kElems = 1;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static void store(T* p, Raw r) { *p = r; }
  __device__ static float get(Raw r, int) { return to_f32(r); }
  __device__ static Raw masked(Raw r, unsigned keep) {
    return (keep & 1u) ? r : zero_of<T>();
  }
};

template <typename T>
struct Unit<T, true> {
  using Raw = uint4;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  __device__ static Raw load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void store(T* p, Raw r) {
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ static unsigned word(const Raw& r, int k) {
    return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  }
  // element e as f32 (bf16 -> f32 is a 16-bit shift, exact)
  __device__ static float get(const Raw& r, int e) {
    const unsigned w = word(r, e / kPerWord);
    if (kPerWord == 1) return __uint_as_float(w);
    return __uint_as_float((e % 2 == 0 ? w & 0xffffu : w >> 16) << 16);
  }
  // keep element e where bit e of `keep` is set, else +0
  __device__ static unsigned mask_word(unsigned w, int k, unsigned keep) {
    if (kPerWord == 1) return ((keep >> k) & 1u) ? w : 0u;
    const unsigned lo = ((keep >> (2 * k)) & 1u) ? 0x0000ffffu : 0u;
    const unsigned hi = ((keep >> (2 * k + 1)) & 1u) ? 0xffff0000u : 0u;
    return w & (lo | hi);
  }
  __device__ static Raw masked(const Raw& r, unsigned keep) {
    return make_uint4(mask_word(r.x, 0, keep), mask_word(r.y, 1, keep),
                      mask_word(r.z, 2, keep), mask_word(r.w, 3, keep));
  }
};

// The cluster barrier in two halves: arrive early, wait where it is
// needed (every thread of every block of the cluster calls both).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// bs[i] is ranked before bs[j]: larger first, NaN before any number, the
// lower id first among equals (a strict total order, so ranks are a
// permutation of 0..nb-1)
__device__ __forceinline__ bool ranks_before(float b, int i, float a, int j) {
  const bool bn = b != b, an = a != a;
  if (bn || an) return bn && (!an || i < j);
  return b > a || (b == a && i < j);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
score_select_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ alpha_p,
                    const float* __restrict__ tau_p,
                    const float* __restrict__ keep_p,
                    const float* __restrict__ rw, T* __restrict__ xm,
                    int* __restrict__ idx, float* __restrict__ bs, int B,
                    int n, int blk, int kb) {
  using U = Unit<T, kWide>;
  constexpr int E = U::kElems;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int nb = n / blk;
  const int j0 = c * nb / C;
  const int nloc = (c + 1) * nb / C - j0;      // >= 1: the host keeps C <= nb
  const int lmax = (nb + C - 1) / C;
  const int bv = blk / E;                      // units per channel block
  const int V = nloc * bv;                     // units per row of this block
  const int VT = min(V, kThreads);             // column lanes
  const int R = kThreads / VT;                 // row groups
  const int t = threadIdx.x;
  const int c0 = t % VT;
  const int r0 = t / VT;
  const bool active = r0 < R;
  const int RB = min(R, B);                    // row groups that hold rows
  const size_t chan0 = static_cast<size_t>(j0) * blk;
  const bool select = idx != nullptr;
  // a peer's shared memory may be written only once it has started: its
  // arrival here, awaited just before the first remote write
  if (select) cluster_arrive_relaxed();

  extern __shared__ float smem[];
  float* table = smem;                         // nb block sums
  int* kept = reinterpret_cast<int*>(table + nb);              // lmax flags
  float* gps = reinterpret_cast<float*>(kept + lmax);   // lmax*blk g^alpha
  float* part = gps + static_cast<size_t>(lmax) * blk;         // R x V

  // The kernel's time is a chain of latencies, so every load that does
  // not depend on another is issued before the first one is used: the
  // scalars (keep_frac too, though it is read only after the cluster
  // barriers) and the first rows of x with their row weights, then g.
  const float alpha = *alpha_p;
  const float tau = *tau_p;
  const float keep_frac = (select && keep_p != nullptr) ? *keep_p : 0.0f;
  typename U::Raw first[kUnroll];              // rows r0 + u*R of column c0
  float wfirst[kUnroll];
  if (active) {
    const size_t col = chan0 + static_cast<size_t>(c0) * E;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = r0 + u * R;
      if (b < B) {
        first[u] = U::load(x + static_cast<size_t>(b) * n + col);
        wfirst[u] = rw != nullptr ? rw[b] : 1.0f;
      }
    }
  }
  // g^alpha once per channel (not once per row group), in shared memory
  for (int ch = t; ch < nloc * blk; ch += kThreads) {
    gps[ch] = powf(fmaxf(g[chan0 + ch], 1e-12f), alpha);
  }
  __syncthreads();

  // pass 1: scores and per-thread partial block sums
  if (active) {
    for (int v = c0; v < V; v += VT) {
      const size_t col = chan0 + static_cast<size_t>(v) * E;
      float gp[E];
#pragma unroll
      for (int e = 0; e < E; ++e) gp[e] = gps[v * E + e];
      float acc = 0.0f;
      for (int b0 = r0; b0 < B; b0 += kUnroll * R) {
        const bool cached = v == c0 && b0 == r0;
        typename U::Raw vals[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int b = b0 + u * R;
          if (b < B) {
            vals[u] = cached ? first[u]
                             : U::load(x + static_cast<size_t>(b) * n + col);
            wt[u] = cached ? wfirst[u] : (rw != nullptr ? rw[b] : 1.0f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (b0 + u * R < B) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float s = fabsf(U::get(vals[u], e)) * gp[e];
              acc += (s >= tau ? s : 0.0f) * wt[u];
            }
          }
        }
      }
      part[r0 * V + v] = acc;
    }
  }
  __syncthreads();

  // block sums: one warp per channel block, over the row groups that
  // hold rows, in a fixed order and a fixed shuffle tree
  const int warp = t / 32;
  const int lane = t % 32;
  for (int jl = warp; jl < nloc; jl += kWarps) {
    const float* pj = part + jl * bv;
    float s = 0.0f;
    if (32 % bv == 0) {                        // bv divides the warp
      for (int r = lane / bv; r < RB; r += 32 / bv) {
        s += pj[r * V + lane % bv];
      }
    } else {
      for (int e = lane; e < RB * bv; e += 32) {
        s += pj[(e / bv) * V + e % bv];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      table[j0 + jl] = s;
      bs[j0 + jl] = s;
    }
  }

  if (select) {
    // selection: every block writes its sums into every peer's table,
    // one cluster barrier makes them visible, and each block ranks its
    // own blocks from its full table.  No block touches another's shared
    // memory after that barrier, so none needs to wait at its exit.
    cluster_wait();
    __syncthreads();
    for (int k = t; k < C * nloc; k += kThreads) {
      const int p = k / nloc;
      const int j = j0 + k - p * nloc;
      if (p != c) cluster.map_shared_rank(table, p)[j] = table[j];
    }
    cluster.sync();
    const float kb_l = keep_p != nullptr
                           ? rintf(keep_frac * static_cast<float>(nb))
                           : static_cast<float>(kb);
    for (int jl = warp; jl < nloc; jl += kWarps) {
      const int j = j0 + jl;
      const float a = table[j];
      int cnt = 0;
      for (int i = lane; i < nb; i += 32) {
        cnt += ranks_before(table[i], i, a, j) ? 1 : 0;
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0) {
        if (cnt < kb) idx[cnt] = j;
        kept[jl] = cnt < kb && static_cast<float>(cnt) < kb_l;
      }
    }
  } else {
    for (int jl = t; jl < nloc; jl += kThreads) kept[jl] = 1;
  }
  __syncthreads();

  // pass 2: xm, from the registers or L2; blocks outside the limit as 0
  if (active) {
    for (int v = c0; v < V; v += VT) {
      const size_t col = chan0 + static_cast<size_t>(v) * E;
      const bool blk_kept = kept[v / bv] != 0;
      float gp[E];
#pragma unroll
      for (int e = 0; e < E; ++e) gp[e] = gps[v * E + e];
      for (int b0 = r0; b0 < B; b0 += kUnroll * R) {
        const bool cached = v == c0 && b0 == r0;
        typename U::Raw vals[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int b = b0 + u * R;
          if (b < B && blk_kept) {
            vals[u] = cached ? first[u]
                             : U::load(x + static_cast<size_t>(b) * n + col);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int b = b0 + u * R;
          if (b < B) {
            unsigned keep = 0u;
            if (blk_kept) {
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const float s = fabsf(U::get(vals[u], e)) * gp[e];
                keep |= (s >= tau ? 1u : 0u) << e;
              }
            }
            U::store(xm + static_cast<size_t>(b) * n + col,
                     blk_kept ? U::masked(vals[u], keep)
                              : U::masked(typename U::Raw{}, 0u));
          }
        }
      }
    }
  }
}

// Dynamic shared memory above 48 KB and clusters above 8 blocks need a
// function attribute, set once per device.
template <typename Kern>
cudaError_t prepare(Kern kern, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxSmem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done |= bit;
  return e;
}

template <typename T, bool kWide>
int launch(const void* x, const void* g, const void* alpha, const void* tau,
           const void* keep, const void* rw, void* xm, void* idx, void* bs,
           int B, int n, int blk, int kb, cudaStream_t st) {
  static unsigned done = 0;
  auto kern = score_select_kernel<T, kWide>;
  cudaError_t e = prepare(kern, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nb = n / blk;
  const int C = std::min(kCluster, nb);
  const int lmax = (nb + C - 1) / C;
  const int vmax = lmax * (blk / Unit<T, kWide>::kElems);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(nb) + lmax +
                       static_cast<size_t>(lmax) * blk +
                       std::max(kThreads, vmax));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(alpha), static_cast<const float*>(tau),
      static_cast<const float*>(keep), static_cast<const float*>(rw),
      static_cast<T*>(xm), static_cast<int*>(idx), static_cast<float*>(bs), B,
      n, blk, kb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* g, const void* alpha,
             const void* tau, const void* keep, const void* rw, void* xm,
             void* idx, void* bs, int B, int n, int blk, int kb,
             cudaStream_t st) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool wide = blk % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(xm) % 16 == 0;
  if (wide) {
    return launch<T, true>(x, g, alpha, tau, keep, rw, xm, idx, bs, B, n,
                           blk, kb, st);
  }
  return launch<T, false>(x, g, alpha, tau, keep, rw, xm, idx, bs, B, n, blk,
                          kb, st);
}

}  // namespace
}  // namespace wisparse

// x, xm: (B, n) of `dtype`; g: (n,) f32; alpha, tau, keep_frac: one f32
// each (keep_frac null: no limit below kb); rw: (B,) f32 or null (weight
// 1); idx: (kb,) int32, or null for the mask alone (then kb = n / blk);
// bs: (n / blk,) f32.  Returns cudaGetLastError().
extern "C" int wisparse_score_select(const void* x, const void* g,
                                     const void* alpha, const void* tau,
                                     const void* keep_frac, const void* rw,
                                     void* xm, void* idx, void* bs, int B,
                                     int n, int blk, int kb, int dtype,
                                     void* stream) {
  using namespace wisparse;
  if (B <= 0 || n <= 0 || blk <= 0 || n % blk != 0 || n / blk > kMaxBlocks ||
      kb < 1 || kb > n / blk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return dispatch<float>(x, g, alpha, tau, keep_frac, rw, xm, idx, bs, B, n,
                           blk, kb, st);
  }
  if (dtype == kBFloat16) {
    return dispatch<__nv_bfloat16>(x, g, alpha, tau, keep_frac, rw, xm, idx,
                                   bs, B, n, blk, kb, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
