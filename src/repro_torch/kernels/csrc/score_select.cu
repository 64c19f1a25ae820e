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
// to thousands of rows) its time grows with B, far from the bound (185 us
// per llama31_8b layer at B = 448 against a 20.9 us bound).  There the
// 2-D entry takes the spread form instead (Geometry: from kSpreadMinRows
// rows on, 16-byte units, blk / units dividing kSpreadThreads, nb <=
// kSpreadMaxBlocks), two launches over a grid of (channel block, row
// slab) blocks, about kSpreadPerSM blocks per SM:
// - spread_sums_kernel: each block scores its slab's rows of its channel
//   block (a thread owns one 16-byte column and every RG-th row, RG =
//   threads / (blk / units), kSpreadUnroll loads in flight) and writes one
//   f32 partial sum, summed over its threads by a fixed shuffle tree and
//   its warps in order, to ws[slab * nb + block].  No atomics.
// - spread_mask_kernel: every block sums the nb x S partials again, in
//   slab order (the same bits in every block: 4 x SMs + nb values from
//   L2), ranks its own channel block by counting over the nb sums
//   (ranks_before, as the cluster form), and writes its slab of xm: x
//   re-read (from L2 where the first pass left it) and masked where the
//   block is kept, zeros without a read where it is not.  The blocks of
//   slab 0 write bs and idx.
// Two launches of one call are bit-equal to two more; one call counts
// once on the host.  Bound: bytes, x read once and xm written once; the
// design reads x twice, the second time mostly from L2 and only in kept
// blocks.
// Expert axis: the reference runs this kernel under jax.vmap over a MoE
// layer's experts (src/repro/models/moe.py:93-112), one selection per
// expert, each with its own x (R, n), g, idx and bs, while alpha, tau
// and keep_frac are the layer's and shared.  The expert entry takes one
// of three forms, chosen by Geometry from (E, R, n, blk, dtype,
// alignment, SMs) alone, for the launch and for score_select_info alike:
// - One block per expert, no cluster (select_expert_kernel), wherever an
//   expert's rows fit one block's registers: aligned 16-byte units,
//   channel blocks of 128, nb <= 32 and the rows per lane of a
//   kExpertConfigs entry.  That holds at every decode and 32-token-chunk
//   row count of granite_moe_1b_a400m and _3b_a800m (R <= 32 in bf16)
//   and at jamba_v01_52b's n = 4096 up to R = 16.  The grid is min(E,
//   SMs) blocks (a block takes several experts in turn where E exceeds
//   the SMs) of one warp per channel block, up to 16: a lane owns a
//   16-byte column of its warp's block (16 lanes a row in bf16, so two
//   rows per pass) and every lane issues all its loads (its rows of x,
//   its g, the scalars) before the first use.  The rows stay in
//   registers from scoring to the store: x is read once.  g^alpha is
//   the plain version's powf(fmaxf(g, 1e-12f), alpha), each channel once
//   per warp (the two row groups of a column split its 8 channels and
//   trade them by shuffle); at alpha = 1 powf returns every float it can
//   see here unchanged (the GPU tests check all of them), so the
//   uncalibrated sp tree's alpha skips it.  A lane keeps one sum per
//   element position over its rows, a fixed tree and a fixed xor-shuffle
//   tree over the warp give the block sum, one __syncthreads publishes
//   the nb sums, and each warp then ranks its own blocks by counting
//   (one ballot over the nb sums) and writes its rows, masked, from the
//   registers.  One block barrier, no cluster barrier, no DSMEM.  The
//   rows per lane come in small steps because a predicated-off unit
//   still issues its instructions.  The cluster form it replaces at
//   these shapes spent its time in a chain of six barriers (two
//   cluster-wide) around 8-25 KB per expert; this form's time follows
//   the instructions one SM issues for one expert (powf the largest
//   share), so it stops at nb = 32: at jamba's n = 14336 (nb = 112) an
//   early version of it took 2.1x its cluster of 8.  Tried and dropped
//   (PERF.md):
//   two warps per channel block, g^alpha through shared memory, and the
//   slab moved by bulk copies through shared memory, all slower.
// - The spread form at a whole prefill's rows (kExpertSpreadMinRows rows
//   per expert on, where the per-expert form does not fit, with the 2-D
//   entry's conditions on units, blk and nb):
//   the 2-D entry's two launches with the expert axis in the grid, (nb,
//   slabs, E) blocks of kSpreadThreads threads, slabs cut so that nb x
//   slabs x E is about kSpreadPerSM x SMs but no thread takes fewer than
//   kSpreadUnroll rows (jamba's 16 x 32 and 16 x 112 channel blocks,
//   granite's 48 x 12, fill the card with one or two slabs per expert:
//   the expert axis, not the rows, spreads the work).
//   Block (j, q, e) works on expert e's slices only; its partials go to
//   ws[(e * slabs + q) * nb + j], and the mask pass ranks channel block j
//   among expert e's nb sums.  The cluster form it replaces there ran one
//   cluster of min(16, nb, SMs / E) blocks per expert, one block of 512
//   threads per SM walking every row of its channel blocks around two
//   cluster barriers: 781 us per jamba MoE layer at R = 641 against a
//   276 us byte bound.
// - One cluster per expert (score_select_kernel on a (C, E) grid, cluster
//   y is expert y) everywhere else: jamba's n = 4096 at 17-31 rows, its
//   n = 14336 below kExpertSpreadMinRows rows, f32 at 17-31 rows,
//   unaligned tensors.  C = min(16, nb, SMs / E), so that every expert's
//   cluster runs at once (clusters of min(16, nb) = 12 ran in waves, 28
//   us per launch at n = 1536).  The map_shared_rank exchange addresses cluster
//   ranks, so it stays inside one expert's cluster.
// In all three, an expert that no token chose has zero rows: every block
// sum is 0, and the ids come out 0..kb-1.  No atomics and a fixed
// summation order in each: two launches are bit-equal.  A form the card
// refuses returns its error; no other form is tried in its place.
// Measured result: PERF.md (chip_smoke.py, per projection shape).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <utility>

#include "common.cuh"
#include "launch_info.cuh"

namespace cg = cooperative_groups;

namespace wisparse {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kCluster = 16;
constexpr int kMaxBlocks = 8192;           // nb limit of the shared table
constexpr size_t kMaxSmem = 232448;        // an H100 block's shared memory
// The per-expert form: channel blocks of kExpertBlk, at most
// kExpertWarps warps, each owning whole channel blocks; its (channel
// blocks per warp, rows per lane) instantiations, tried in order.  A
// predicated-off unit still issues its instructions, so rows per lane
// come in small steps.  Registers: 4 per 16-byte unit held, under the
// 128 a thread of 512 may use.
constexpr int kExpertBlk = 128;
constexpr int kExpertWarps = 16;
constexpr int kExpertConfigs = 13;
constexpr int kExpertNJ[kExpertConfigs] = {1, 1, 1, 1, 1, 1, 1,
                                           1, 1, 2, 2, 2, 2};
constexpr int kExpertRU[kExpertConfigs] = {1, 2, 3, 4, 5, 6, 8,
                                           12, 16, 1, 2, 4, 8};
constexpr int kExpertMaxBlocks = 32;       // kExpertWarps x the largest NJ
// The 2-D entry's spread form (whole-prefill rows): threads per block,
// loads in flight per thread, target blocks per SM, the least rows it
// takes (PERF.md holds the times of both forms that chose it) and the
// most channel blocks (each block sums every block's partials again).
constexpr int kSpreadThreads = 256;
constexpr int kSpreadWarps = kSpreadThreads / 32;
constexpr int kSpreadUnroll = 8;
constexpr int kSpreadPerSM = 4;
constexpr int kSpreadMinRows = 64;
constexpr int kSpreadMaxBlocks = 512;
// The expert entry's spread form, from kExpertSpreadMinRows rows per
// expert on where the per-expert form does not hold the rows (Geometry
// tries that form first).  PERF.md holds the times of both forms at
// 1-641 rows that chose it; it lies above the rows per expert of the
// served engines' captured steps (8 decode slots, 32-token chunks and
// verify windows of 8 slots: at most 16).
constexpr int kExpertSpreadMinRows = 32;
// Geometry's form codes besides the per-expert configs (>= 0)
constexpr int kClusterForm = -1;
constexpr int kSpreadForm = -2;

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
  // expert blockIdx.y's slices (E = 1: the only one)
  const size_t ex = blockIdx.y;
  x += ex * B * n;
  xm += ex * B * n;
  g += ex * n;
  bs += ex * nb;
  if (idx != nullptr) idx += ex * kb;
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

// The per-expert form (see the design comment): block e % gridDim.x
// selects expert e, one after another where E exceeds the grid.  Warp w
// owns channel blocks w, w + W, ... (kNJ at most); lane l owns 16-byte
// column l % BV of each and rows l / BV + G * r, r < kRU.  At n = 1536
// twelve warps share one SM's four schedulers, so the time follows the
// instructions issued: powf is the largest part of them.
template <typename T, int kNJ, int kRU>
__global__ void __launch_bounds__(kExpertWarps * 32, 1)
select_expert_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ alpha_p,
                     const float* __restrict__ tau_p,
                     const float* __restrict__ keep_p, T* __restrict__ xm,
                     int* __restrict__ idx, float* __restrict__ bs, int E,
                     int R, int n, int kb) {
  using U = Unit<T, true>;
  using Raw = typename U::Raw;
  constexpr int EL = U::kElems;                // elements per unit
  constexpr int BV = kExpertBlk / EL;          // lanes per block row
  constexpr int G = 32 / BV;                   // rows per warp pass
  constexpr int GE = EL / G;                   // g^alpha values per lane
  static_assert(GE == 4, "a lane's g is one 16-byte load");
  __shared__ float table[kExpertMaxBlocks];
  const int nb = n / kExpertBlk;
  const int W = static_cast<int>(blockDim.x) / 32;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = lane / BV;
  const int lane_col = (lane % BV) * EL;       // the lane's first channel
  const bool g_vec = reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const float alpha = *alpha_p;
  const float tau = *tau_p;
  const float kb_l = keep_p != nullptr
                         ? rintf(*keep_p * static_cast<float>(nb))
                         : static_cast<float>(kb);
  for (int e = blockIdx.x; e < E; e += gridDim.x) {
    // the expert's slab; offsets inside it fit 32 bits (R <= 32 rows of
    // n <= 4096 channels in this form)
    const T* xe = x + static_cast<size_t>(e) * R * n;
    T* xme = xm + static_cast<size_t>(e) * R * n;
    const float* ge = g + static_cast<size_t>(e) * n;
    // every load before the first use: the rows, then the lane's share
    // of its column's g (the G row groups of a column split its EL
    // channels)
    Raw v[kNJ][kRU];
    float gl[kNJ][GE];
#pragma unroll
    for (int k = 0; k < kNJ; ++k) {
      const int j = w + k * W;
      if (j < nb) {
        const int col = j * kExpertBlk + lane_col;
#pragma unroll
        for (int r = 0; r < kRU; ++r) {
          const int row = rg + G * r;
          if (row < R) v[k][r] = U::load(xe + row * n + col);
        }
        const float* gs = ge + col + rg * GE;
        if (g_vec) {
          const float4 q = *reinterpret_cast<const float4*>(gs);
          gl[k][0] = q.x;
          gl[k][1] = q.y;
          gl[k][2] = q.z;
          gl[k][3] = q.w;
        } else {
#pragma unroll
          for (int i = 0; i < GE; ++i) gl[k][i] = gs[i];
        }
      }
    }
    // per channel block: g^alpha (each channel once per warp, then
    // shuffled to the row groups; at alpha = 1 powf returns every float
    // it can be given here unchanged, which the GPU tests check over all
    // of them, so it is skipped), the scores, the tau mask applied to
    // the registers in place, and the block sum: one sum per element
    // position over the lane's rows in order, a fixed tree over the
    // positions, then a fixed xor-shuffle tree over the warp.  The sums
    // are of s >= 0 from +0, so adding only the kept scores equals
    // adding 0 for the others.
#pragma unroll
    for (int k = 0; k < kNJ; ++k) {
      const int j = w + k * W;
      if (j < nb) {                            // the same for the warp
#pragma unroll
        for (int i = 0; i < GE; ++i) {
          const float gc = fmaxf(gl[k][i], 1e-12f);
          gl[k][i] = alpha == 1.0f ? gc : powf(gc, alpha);
        }
        float gp[EL];
#pragma unroll
        for (int el = 0; el < EL; ++el) {
          gp[el] = G == 1 ? gl[k][el % GE]
                          : __shfl_sync(0xffffffffu, gl[k][el % GE],
                                        lane % BV + (el / GE) * BV);
        }
        float acc[EL];
#pragma unroll
        for (int el = 0; el < EL; ++el) acc[el] = 0.0f;
#pragma unroll
        for (int r = 0; r < kRU; ++r) {
          if (rg + G * r < R) {
            unsigned m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int el = 0; el < EL; ++el) {
              const float s = fabsf(U::get(v[k][r], el)) * gp[el];
              if (s >= tau) {
                acc[el] += s;
                m[el / U::kPerWord] |= U::kPerWord == 1 ? ~0u
                                       : el % 2 ? 0xffff0000u : 0x0000ffffu;
              }
            }
            v[k][r] = make_uint4(v[k][r].x & m[0], v[k][r].y & m[1],
                                 v[k][r].z & m[2], v[k][r].w & m[3]);
          }
        }
#pragma unroll
        for (int h = EL / 2; h > 0; h /= 2) {
#pragma unroll
          for (int el = 0; el < h; ++el) acc[el] += acc[el + h];
        }
        float sum = acc[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        if (lane == 0) table[j] = sum;
      }
    }
    // the one barrier: every block's sum published
    __syncthreads();
    // each warp ranks its own blocks by counting (lane i holds block i's
    // sum, block j's comes from lane j, one ballot counts the blocks
    // ranked before it; the lower id first among equal sums) and stores
    // their rows from the registers: blocks outside the limit as zeros
    const float ti = lane < nb ? table[lane] : 0.0f;
#pragma unroll
    for (int k = 0; k < kNJ; ++k) {
      const int j = w + k * W;
      if (j < nb) {
        const float a = __shfl_sync(0xffffffffu, ti, j);
        const int cnt = __popc(__ballot_sync(
            0xffffffffu, lane < nb && ranks_before(ti, lane, a, j)));
        const bool blk_kept =
            idx == nullptr || (cnt < kb && static_cast<float>(cnt) < kb_l);
        if (lane == 0) {
          bs[static_cast<size_t>(e) * nb + j] = a;
          if (idx != nullptr && cnt < kb) {
            idx[static_cast<size_t>(e) * kb + cnt] = j;
          }
        }
        const int col = j * kExpertBlk + lane_col;
#pragma unroll
        for (int r = 0; r < kRU; ++r) {
          const int row = rg + G * r;
          if (row < R) U::store(xme + row * n + col, blk_kept ? v[k][r] : Raw{});
        }
      }
    }
    // the next expert reuses the table
    if (e + static_cast<int>(gridDim.x) < E) __syncthreads();
  }
}


// The spread form's first pass (see the design comment): block (j, q, e)
// scores rows [q * rows, (q + 1) * rows) of expert e's channel block j
// and writes their kept-score sum, weighted by rw, to ws[(e * S + q) * nb
// + j] (the 2-D entry: e = 0).
template <typename T>
__global__ void __launch_bounds__(kSpreadThreads)
spread_sums_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ alpha_p,
                   const float* __restrict__ tau_p,
                   const float* __restrict__ rw, float* __restrict__ ws,
                   int B, int n, int blk, int rows) {
  using U = Unit<T, true>;
  constexpr int EL = U::kElems;
  extern __shared__ float smem[];
  float* gps = smem;                           // blk g^alpha values
  float* wsum = smem + blk;                    // one sum per warp
  const int j = blockIdx.x;
  const int q = blockIdx.y;
  const int nb = gridDim.x;
  // expert blockIdx.z's slices
  const size_t ex = blockIdx.z;
  x += ex * B * n;
  g += ex * n;
  ws += ex * gridDim.y * nb;
  const int bv = blk / EL;                     // lanes per block row
  const int rg = kSpreadThreads / bv;          // row groups
  const int t = threadIdx.x;
  const int r0 = q * rows + t / bv;
  const int r1 = min(B, (q + 1) * rows);
  const size_t col = static_cast<size_t>(j) * blk + (t % bv) * EL;
  const float alpha = *alpha_p;
  const float tau = *tau_p;
  for (int ch = t; ch < blk; ch += kSpreadThreads) {
    gps[ch] = powf(fmaxf(g[static_cast<size_t>(j) * blk + ch], 1e-12f),
                   alpha);
  }
  __syncthreads();
  float gp[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) gp[e] = gps[(t % bv) * EL + e];
  float acc = 0.0f;
  for (int b0 = r0; b0 < r1; b0 += kSpreadUnroll * rg) {
    typename U::Raw v[kSpreadUnroll];
    float wt[kSpreadUnroll];
#pragma unroll
    for (int u = 0; u < kSpreadUnroll; ++u) {
      const int b = b0 + u * rg;
      if (b < r1) {
        v[u] = U::load(x + static_cast<size_t>(b) * n + col);
        wt[u] = rw != nullptr ? rw[b] : 1.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSpreadUnroll; ++u) {
      if (b0 + u * rg < r1) {
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const float s = fabsf(U::get(v[u], e)) * gp[e];
          acc += (s >= tau ? s : 0.0f) * wt[u];
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (t % 32 == 0) wsum[t / 32] = acc;
  __syncthreads();
  if (t == 0) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kSpreadWarps; ++w) sum += wsum[w];
    ws[static_cast<size_t>(q) * nb + j] = sum;
  }
}

// The spread form's second pass: block (j, q, e) sums expert e's S x nb
// partials in slab order (every block of the expert the same bits), ranks
// channel block j among the expert's nb sums, and writes its slab of xm;
// the blocks of slab 0 write bs and, with a selection (idx), idx.  keep_p
// null: no limit below kb.
template <typename T>
__global__ void __launch_bounds__(kSpreadThreads)
spread_mask_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ alpha_p,
                   const float* __restrict__ tau_p,
                   const float* __restrict__ keep_p,
                   const float* __restrict__ ws, T* __restrict__ xm,
                   int* __restrict__ idx, float* __restrict__ bs, int B,
                   int n, int blk, int kb, int rows) {
  using U = Unit<T, true>;
  constexpr int EL = U::kElems;
  extern __shared__ float smem[];
  float* gps = smem;                           // blk g^alpha values
  float* table = smem + blk;                   // nb block sums
  __shared__ int kept;
  const int j = blockIdx.x;
  const int q = blockIdx.y;
  const int nb = gridDim.x;
  const int S = gridDim.y;
  const int bv = blk / EL;
  const int rg = kSpreadThreads / bv;
  const int t = threadIdx.x;
  // expert blockIdx.z's slices
  const size_t ex = blockIdx.z;
  x += ex * B * n;
  xm += ex * B * n;
  g += ex * n;
  ws += ex * S * nb;
  bs += ex * nb;
  if (idx != nullptr) idx += ex * kb;
  const float alpha = *alpha_p;
  const float tau = *tau_p;
  for (int i = t; i < nb; i += kSpreadThreads) {
    float sum = 0.0f;
    for (int p = 0; p < S; ++p) sum += ws[static_cast<size_t>(p) * nb + i];
    table[i] = sum;
  }
  for (int ch = t; ch < blk; ch += kSpreadThreads) {
    gps[ch] = powf(fmaxf(g[static_cast<size_t>(j) * blk + ch], 1e-12f),
                   alpha);
  }
  __syncthreads();
  if (t < 32) {
    const float a = table[j];
    int cnt = 0;
    if (idx != nullptr) {
      for (int i = t; i < nb; i += 32) {
        cnt += ranks_before(table[i], i, a, j) ? 1 : 0;
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
    }
    if (t == 0) {
      const float kb_l = keep_p != nullptr
                             ? rintf(*keep_p * static_cast<float>(nb))
                             : static_cast<float>(kb);
      kept = idx == nullptr || (cnt < kb && static_cast<float>(cnt) < kb_l);
      if (q == 0) {
        bs[j] = a;
        if (idx != nullptr && cnt < kb) idx[cnt] = j;
      }
    }
  }
  __syncthreads();
  const bool blk_kept = kept != 0;
  const int r0 = q * rows + t / bv;
  const int r1 = min(B, (q + 1) * rows);
  const size_t col = static_cast<size_t>(j) * blk + (t % bv) * EL;
  float gp[EL];
#pragma unroll
  for (int e = 0; e < EL; ++e) gp[e] = gps[(t % bv) * EL + e];
  for (int b0 = r0; b0 < r1; b0 += kSpreadUnroll * rg) {
    typename U::Raw v[kSpreadUnroll];
#pragma unroll
    for (int u = 0; u < kSpreadUnroll; ++u) {
      const int b = b0 + u * rg;
      if (b < r1 && blk_kept) {
        v[u] = U::load(x + static_cast<size_t>(b) * n + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kSpreadUnroll; ++u) {
      const int b = b0 + u * rg;
      if (b < r1) {
        unsigned keep = 0u;
        if (blk_kept) {
#pragma unroll
          for (int e = 0; e < EL; ++e) {
            const float s = fabsf(U::get(v[u], e)) * gp[e];
            keep |= (s >= tau ? 1u : 0u) << e;
          }
        }
        U::store(xm + static_cast<size_t>(b) * n + col,
                 blk_kept ? U::masked(v[u], keep)
                          : U::masked(typename U::Raw{}, 0u));
      }
    }
  }
}

// Dynamic shared memory above 48 KB and clusters above 8 blocks need a
// function attribute, set once per device; the device's SM count is read
// at the same time and kept for later launches in ``sms``.
int sm_counts[32] = {};

template <typename Kern>
cudaError_t prepare(Kern kern, unsigned& done, int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (!(done & bit)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sm_counts[dev & 31],
                                 cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return e;
    done |= bit;
  }
  sms = sm_counts[dev & 31];
  return cudaSuccess;
}

// The launch geometry of an (E, B, n) call, computed here for `launch`
// and `score_select_info` alike.  The expert entry (`experts`) takes the
// per-expert form where an expert's slab fits one block's registers
// (form >= 0: the index of the first kExpertConfigs entry that holds the
// warp's channel blocks and the lane's rows); both entries take the
// spread form (form kSpreadForm) from kSpreadMinRows rows (the expert
// entry: kExpertSpreadMinRows rows per expert) on where its blocks can
// hold a channel block's columns; else one cluster per expert
// (kClusterForm): the E experts' clusters share the card, each taking at
// most SMs / E blocks so that all of them run at once.  `want`: -1 the
// shape's own form, 0 the cluster form, 1 the spread form (a forced form
// the shape cannot take leaves `ok` false).
template <typename T, bool kWide>
struct Geometry {
  int form = kClusterForm;
  int C;          // blocks per cluster (1 in the other forms)
  int grid;       // grid x (the cluster form's grid is (C, E), the spread
                  // form's (nb, slabs, E))
  int slabs = 1;  // spread form: row slabs, of `rows` rows each
  int rows = 0;
  int threads;
  size_t smem;    // dynamic shared memory per block
  bool ok = true;
  Geometry(bool experts, int E, int B, int nb, int blk, int sms,
           int want = -1) {
    if (experts && want < 0 && kWide && blk == kExpertBlk) {
      const int G = 32 * Unit<T, true>::kElems / kExpertBlk;
      const int W = std::min(kExpertWarps, nb);
      const int nj = (nb + W - 1) / W;
      const int ru = (B + G - 1) / G;
      for (int i = 0; i < kExpertConfigs && form < 0; ++i) {
        if (nj <= kExpertNJ[i] && ru <= kExpertRU[i]) form = i;
      }
      if (form >= 0) {
        C = 1;
        grid = std::min(E, sms);
        threads = 32 * W;
        smem = 0;
        return;
      }
    }
    const int bv = blk / Unit<T, true>::kElems;
    const bool spread_ok = kWide && nb <= kSpreadMaxBlocks && bv > 0 &&
                           kSpreadThreads % bv == 0;
    const int min_rows = experts ? kExpertSpreadMinRows : kSpreadMinRows;
    if (want == 1 || (want < 0 && B >= min_rows)) {
      ok = spread_ok || want != 1;   // a forced spread form it cannot take
      if (spread_ok) {
        // about kSpreadPerSM blocks per SM over the E x nb channel
        // blocks, slabs of whole row groups; the expert entry, whose
        // expert axis fills the card, cuts an expert's rows only as far
        // as kSpreadUnroll rows per thread (below that, more and smaller
        // blocks were slower at jamba's and granite's shapes, PERF.md)
        const int rg = kSpreadThreads / bv;
        const int least = experts ? rg * kSpreadUnroll : rg;
        const long long cells = static_cast<long long>(nb) * E;
        const long long target = static_cast<long long>(kSpreadPerSM) * sms;
        const int s0 = static_cast<int>(std::max(
            1LL, std::min(static_cast<long long>((B + least - 1) / least),
                          (target + cells - 1) / cells)));
        rows = ((B + s0 - 1) / s0 + rg - 1) / rg * rg;
        slabs = (B + rows - 1) / rows;
        form = kSpreadForm;
        C = 1;
        grid = nb;
        threads = kSpreadThreads;
        smem = sizeof(float) *
               (static_cast<size_t>(blk) + std::max(nb, kSpreadWarps));
        return;
      }
    }
    C = std::min({kCluster, nb, std::max(1, sms / E)});
    grid = C;
    threads = kThreads;
    const int lmax = (nb + C - 1) / C;
    const int vmax = lmax * (blk / Unit<T, kWide>::kElems);
    smem = sizeof(float) * (static_cast<size_t>(nb) + lmax +
                            static_cast<size_t>(lmax) * blk +
                            std::max(kThreads, vmax));
  }
};

// The launch of `geo` over E experts on `st`: a (C, E) grid of
// clusters of C blocks (cfg points at the caller's `attr`).
template <typename T, bool kWide>
void cluster_config(const Geometry<T, kWide>& geo, int E, cudaStream_t st,
                    cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1]) {
  cfg = {};
  cfg.gridDim = dim3(geo.C, E);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// The kernel's function attributes, set once per device (`prepared`
// keeps the per-instantiation flags).
template <typename T, bool kWide>
cudaError_t prepared(int& sms) {
  static unsigned done = 0;
  return prepare(score_select_kernel<T, kWide>, done, sms);
}

// The per-expert kernel of config `form`.
template <typename T, size_t... I>
auto expert_kernel_of(int form, std::index_sequence<I...>) {
  static decltype(&select_expert_kernel<T, 1, 1>) const table[] = {
      &select_expert_kernel<T, kExpertNJ[I], kExpertRU[I]>...};
  return table[form];
}

template <typename T>
auto expert_kernel(int form) {
  return expert_kernel_of<T>(form,
                             std::make_index_sequence<kExpertConfigs>{});
}

// The spread form's two launches over E experts on `st` (ws: E x
// geo.slabs x nb partials).
template <typename T>
int launch_spread(const Geometry<T, true>& geo, const void* x, const void* g,
                  const void* alpha, const void* tau, const void* keep,
                  const void* rw, void* xm, void* idx, void* bs, void* ws,
                  int E, int B, int n, int blk, int kb, cudaStream_t st) {
  const dim3 grid(geo.grid, geo.slabs, E);
  spread_sums_kernel<T><<<grid, geo.threads, geo.smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(alpha), static_cast<const float*>(tau),
      static_cast<const float*>(rw), static_cast<float*>(ws), B, n, blk,
      geo.rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  spread_mask_kernel<T><<<grid, geo.threads, geo.smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(alpha), static_cast<const float*>(tau),
      static_cast<const float*>(keep), static_cast<const float*>(ws),
      static_cast<T*>(xm), static_cast<int*>(idx), static_cast<float*>(bs),
      B, n, blk, kb, geo.rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWide>
int launch(bool experts, const void* x, const void* g, const void* alpha,
           const void* tau, const void* keep, const void* rw, void* xm,
           void* idx, void* bs, void* ws, int ws_len, int E, int B, int n,
           int blk, int kb, int want, cudaStream_t st) {
  int sms = 0;
  cudaError_t e = prepared<T, kWide>(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Geometry<T, kWide> geo(experts, E, B, n / blk, blk, sms, want);
  if (!geo.ok) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kWide) {
    if (geo.form == kSpreadForm) {
      if (ws == nullptr ||
          static_cast<long long>(E) * geo.slabs * (n / blk) > ws_len) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch_spread<T>(geo, x, g, alpha, tau, keep, rw, xm, idx, bs,
                              ws, E, B, n, blk, kb, st);
    }
    if (geo.form >= 0) {
      expert_kernel<T>(geo.form)<<<geo.grid, geo.threads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const float*>(g),
          static_cast<const float*>(alpha), static_cast<const float*>(tau),
          static_cast<const float*>(keep), static_cast<T*>(xm),
          static_cast<int*>(idx), static_cast<float*>(bs), E, B, n, kb);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (geo.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(geo, E, st, cfg, attr);
  e = cudaLaunchKernelEx(
      &cfg, score_select_kernel<T, kWide>, static_cast<const T*>(x),
      static_cast<const float*>(g), static_cast<const float*>(alpha),
      static_cast<const float*>(tau), static_cast<const float*>(keep),
      static_cast<const float*>(rw), static_cast<T*>(xm),
      static_cast<int*>(idx), static_cast<float*>(bs), B, n, blk, kb);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What `launch` would use, written to out[0..9] as in launch_info.cuh:
// with the blocks (per-expert and spread forms) or clusters of that shape
// that can be active at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs, or cudaOccupancyMaxActiveClusters).  Launches nothing.
template <typename T, bool kWide>
int info(bool experts, int E, int B, int n, int blk, int* out) {
  int sms = 0;
  cudaError_t e = prepared<T, kWide>(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Geometry<T, kWide> geo(experts, E, B, n / blk, blk, sms);
  const bool cluster = geo.form == kClusterForm;
  const int fill[10] = {geo.grid, cluster ? E : geo.slabs,
                        geo.form == kSpreadForm ? E : 1, geo.threads,
                        static_cast<int>(geo.smem), geo.C, 1, 1, 0,
                        geo.form + 1};
  for (int i = 0; i < 10; ++i) out[i] = fill[i];
  if constexpr (kWide) {
    if (!cluster) {
      int per_sm = 0;
      e = geo.form == kSpreadForm
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, spread_sums_kernel<T>, geo.threads, geo.smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, expert_kernel<T>(geo.form), geo.threads, 0);
      out[8] = per_sm * sms;
      return static_cast<int>(e);
    }
  }
  if (geo.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(geo, E, nullptr, cfg, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      &out[8], score_select_kernel<T, kWide>, &cfg));
}

// 16-byte units: x and xm 16-byte aligned and every expert's rows too
// (blk, so n, a multiple of the 16-byte unit)
template <typename T>
bool wide_ok(int blk, bool aligned) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  return blk % kVec == 0 && aligned;
}

template <typename T>
int dispatch(bool experts, const void* x, const void* g, const void* alpha,
             const void* tau, const void* keep, const void* rw, void* xm,
             void* idx, void* bs, void* ws, int ws_len, int E, int B, int n,
             int blk, int kb, int want, cudaStream_t st) {
  if (wide_ok<T>(blk, reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(xm) % 16 == 0)) {
    return launch<T, true>(experts, x, g, alpha, tau, keep, rw, xm, idx, bs,
                           ws, ws_len, E, B, n, blk, kb, want, st);
  }
  return launch<T, false>(experts, x, g, alpha, tau, keep, rw, xm, idx, bs,
                          ws, ws_len, E, B, n, blk, kb, want, st);
}

bool args_ok(int E, int B, int n, int blk, int kb) {
  return E > 0 && E <= 65535 && B > 0 && n > 0 && blk > 0 && n % blk == 0 &&
         n / blk <= kMaxBlocks && kb >= 1 && kb <= n / blk;
}

int entry(bool experts, const void* x, const void* g, const void* alpha,
          const void* tau, const void* keep_frac, const void* rw, void* xm,
          void* idx, void* bs, void* ws, int ws_len, int E, int B, int n,
          int blk, int kb, int dtype, int want, void* stream) {
  if (!args_ok(E, B, n, blk, kb) || want < -1 || want > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return dispatch<float>(experts, x, g, alpha, tau, keep_frac, rw, xm, idx,
                           bs, ws, ws_len, E, B, n, blk, kb, want, st);
  }
  if (dtype == kBFloat16) {
    return dispatch<__nv_bfloat16>(experts, x, g, alpha, tau, keep_frac, rw,
                                   xm, idx, bs, ws, ws_len, E, B, n, blk, kb,
                                   want, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int score_select_info(bool experts, int E, int B, int n, int blk, int kb,
                      int dtype, bool aligned, int* out) {
  if (!args_ok(E, B, n, blk, kb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kFloat32) {
    return wide_ok<float>(blk, aligned)
               ? info<float, true>(experts, E, B, n, blk, out)
               : info<float, false>(experts, E, B, n, blk, out);
  }
  if (dtype == kBFloat16) {
    return wide_ok<__nv_bfloat16>(blk, aligned)
               ? info<__nv_bfloat16, true>(experts, E, B, n, blk, out)
               : info<__nv_bfloat16, false>(experts, E, B, n, blk, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wisparse

// x, xm: (B, n) of `dtype`; g: (n,) f32; alpha, tau, keep_frac: one f32
// each (keep_frac null: no limit below kb); rw: (B,) f32 or null (weight
// 1); idx: (kb,) int32, or null for the mask alone (then kb = n / blk);
// bs: (n / blk,) f32; ws: ws_len f32 values of scratch for the spread
// form (slabs x nb of them; null where the form is the cluster's); form:
// -1 the shape's own (Geometry), 0 the cluster form, 1 the spread form
// (a form the shape cannot take is refused).  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments it refuses.
extern "C" int wisparse_score_select(const void* x, const void* g,
                                     const void* alpha, const void* tau,
                                     const void* keep_frac, const void* rw,
                                     void* xm, void* idx, void* bs, int B,
                                     int n, int blk, int kb, int dtype,
                                     void* ws, int ws_len, int form,
                                     void* stream) {
  return wisparse::entry(false, x, g, alpha, tau, keep_frac, rw, xm, idx, bs,
                         ws, ws_len, 1, B, n, blk, kb, dtype, form, stream);
}

// The expert-batched form: x, xm (E, B, n); g (E, n); idx (E, kb); bs
// (E, n / blk); alpha, tau and keep_frac shared; no row weights; ws:
// ws_len f32 values of scratch for the spread form (E x slabs x nb of
// them; null in the other forms).  form: -1 the shape's own (Geometry:
// one block per expert where its slab fits, the spread form from
// kExpertSpreadMinRows rows per expert, else one cluster per expert), 0
// the cluster form, 1 the spread form (a form the shape cannot take is
// refused).  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it refuses.
extern "C" int wisparse_score_select_experts(const void* x, const void* g,
                                             const void* alpha,
                                             const void* tau,
                                             const void* keep_frac, void* xm,
                                             void* idx, void* bs, int E,
                                             int B, int n, int blk, int kb,
                                             int dtype, void* ws, int ws_len,
                                             int form, void* stream) {
  return wisparse::entry(true, x, g, alpha, tau, keep_frac, nullptr, xm, idx,
                         bs, ws, ws_len, E, B, n, blk, kb, dtype, form,
                         stream);
}
