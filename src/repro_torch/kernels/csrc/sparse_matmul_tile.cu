// WiSparse block-gather matmul, expert-batched, at whole-prefill rows: a
// TMA + wgmma tile kernel for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/sparse_matmul.py:
// sparse_matmul_shared (_acc_kernel) as the reference runs it under
// jax.vmap over a MoE layer's experts (src/repro/models/moe.py:93-112):
//   y[e, r, :] = sum_{i < kb} x[e, r, blk*idx[e, i] : +blk]
//                             @ W[e, blk*idx[e, i] : +blk, :]
// x (E, R, n) already masked and W (E, n, m) in bf16, idx (E, kb) int32,
// y (E, R, m) f32.  A repeated id counts once per occurrence; ids are
// clamped to [0, n/blk).  The contract of the expert entry's gather form
// (sparse_matmul_shared.cu), which keeps decode and chunk rows; the host's
// plan (sparse_matmul.expert_plan) picks this form from R, in bf16 with
// 16-byte aligned operands.
//
// What bounds it on an H100: operations.  A whole prefill gives each
// expert R rows (641 for a 4096-token prompt of jamba_v01_52b: 16 experts,
// top 2, capacity factor 1.25), so it does 2R operations per kept weight
// element it reads, far above the ~295 per byte at which the bf16 tensor
// cores and not HBM set the time: the least time is 2 E R kb blk m
// operations at 989 TFLOP/s (609 us for each of jamba's three expert
// projections at 50% kept).  The gather form's 32-row mma.sync tiles
// re-read each kept slab once per 32 rows and reach 8.5% of that.
//
// Design:
// - Tiles.  A CTA tile is 128 expert rows x 256 output columns.  K runs
//   over the expert's kept blocks in halves of 64 channels (128 bytes of
//   bf16, one 128-byte-swizzled row), in idx order.
// - TMA.  3-D tensor maps over x (n, R, E) and W (m, n, E), encoded on
//   the host per launch and passed as __grid_constant__ parameters.  A kept
//   block is a contiguous slab of W, so the gather is only the box
//   coordinate id * blk + half * 64.  The R bound is per expert: rows past
//   R arrive as zeros, never as the next expert's; columns past m too.
// - Pipeline.  A ring of 4 stages of 48 KB (the x tile, 128 x 64; the W
//   tile, 64 x 256, as four 64-column boxes) with a full and an empty
//   mbarrier per stage.  One producer thread keeps the TMA loads in
//   flight; two consumer warpgroups, 64 rows each, run wgmma.mma_async
//   m64n256k16 (bf16 in, 128 f32 accumulators a thread), A the x tile
//   K-major, B the W tile N-major (the transpose bit), one group of
//   products in flight while the stage before it is released.  setmaxnreg
//   moves registers from the producer (40) to the consumers (232).
// - Persistent.  One CTA per SM walks the tiles in the order (expert,
//   column tile, row tile), row tile fastest: the CTAs working at one time
//   share each (expert, column tile)'s kept slabs, read from HBM once and
//   from L2 by the others.  The next tile's loads run while the consumers
//   store the last one's result.
// - The ragged tail.  The capacity rule's + 1 makes R rarely a multiple
//   of 64 (641 = 5 x 128 + 1).  A tile's second warpgroup skips its
//   products where its 64 rows lie past R, so a tail of up to 64 rows
//   costs about half a tile (641 rows: 5.5 tiles' work, against 6 for
//   whole 128-row tiles); the grid is kept coprime with the row tiles, so
//   each CTA takes its share of tail tiles.
// - Epilogue.  Each consumer thread stores its f32 results from registers
//   in 8-byte pairs, rows past R and columns past m masked.  No split-K,
//   no workspace, no counters: the k order is fixed, so two launches are
//   bit-equal.  Capture-safe: no host read of device memory, no
//   allocation, no sync.  A ring stalled for about 20 s traps, so a fault
//   in it surfaces as a launch error rather than a hang.
// Measured result: PERF.md (chip_smoke.py phase 3, per jamba MoE layer).
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "gather_mma.cuh"
#include "sparse_matmul_tile.cuh"

namespace wisparse {
namespace tile {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait until the phase of `bar` of parity `parity` has completed.  The
// loop stays inside the asm, so the compiler sees no divergent branch
// around the products (it would serialize them); one stalled for 2^35
// cycles (about 20 s) traps.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 34359738368;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` where `pred` holds (a predicate, not a branch).
__device__ __forceinline__ void bar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One box of `map` at coordinates (c0, c1, c2) into shared memory at
// `dst`, its bytes reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: `lbo`
// bytes between 64-element blocks along M or N (read for the N-major B
// only), `sbo` bytes between groups of 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above the wait
// that completes the products writing them.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16 from da, K-major) x B (16 x 256 from db, N-major), plus
// d where `add`.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, bool add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(static_cast<int>(add)));
}

// The (expert, column tile, row tile) of linear tile t, row tile fastest.
struct Tile {
  int e, c, r;
};

__device__ __forceinline__ Tile tile_of(long long t, int rt, int ct) {
  return {static_cast<int>(t / (static_cast<long long>(rt) * ct)),
          static_cast<int>(t / rt % ct), static_cast<int>(t % rt)};
}

__device__ __forceinline__ int clamp_id(const int* idx, size_t at, int nb) {
  return min(max(idx[at], 0), nb - 1);
}

__global__ void __launch_bounds__(kThreads, 1)
    tile_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const int* __restrict__ idx, float* __restrict__ y, int E,
                int R, int m, int nb, int blk, int kb) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  int* ids = reinterpret_cast<int*>(empty + kStages);
  const int rt = row_tiles(R);
  const int ct = col_tiles(m);
  const long long ntiles = tiles(E, R, m);
  const int halves = blk / kDepth;
  const int items = kb * halves;
  // the warpgroup, read from lane 0 so that the compiler knows it is
  // uniform over the warp: wgmma under a branch it cannot prove uniform
  // is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);    // the producer's expect_tx
      bar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: warp 0; lane 0 starts the copies, the warp reloads
    // the ids
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int stage = 0, phase = 0, held = -1;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = tile_of(t, rt, ct);
      if (tl.e != held) {
        __syncwarp();
        for (int i = lane; i < min(kb, kMaxIds); i += 32) {
          ids[i] = clamp_id(idx, static_cast<size_t>(tl.e) * kb + i, nb);
        }
        __syncwarp();
        held = tl.e;
      }
      for (int it = 0; it < items; ++it) {
        if (lane == 0) {
          bar_wait(&empty[stage], phase ^ 1);
          const int p = it / halves;
          const int id =
              p < kMaxIds
                  ? ids[p]
                  : clamp_id(idx, static_cast<size_t>(tl.e) * kb + p, nb);
          const int k0 = id * blk + (it - p * halves) * kDepth;
          unsigned char* st = ring + stage * kStageBytes;
          bar_expect(&full[stage], kStageBytes);
          tma_load(st, &xmap, &full[stage], k0, tl.r * kRows, tl.e);
#pragma unroll
          for (int j = 0; j < kCols / 64; ++j) {
            tma_load(st + kXBytes + j * (kWBytes / 4), &wmap, &full[stage],
                     tl.c * kCols + 64 * j, k0, tl.e);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g takes rows [64 g, 64 g + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[128];
  int stage = 0, phase = 0;
  auto next = [&] {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of(t, rt, ct);
    const int row0 = tl.r * kRows + g * 64;
    if (row0 >= R) {
      // the ragged tail's empty half: release each stage as it fills
      for (int it = 0; it < items; ++it) {
        bar_wait(&full[stage], phase);
        bar_arrive_if(&empty[stage], tid == 0);
        next();
      }
      continue;
    }
    // Only the products write acc: the tile's first one with scale-d 0
    // (d = a b), so no other instruction defines an accumulator while
    // products are in flight (the compiler would serialize them).
    int held = -1;   // the stage whose products may still be running
    for (int it = 0; it < items; ++it) {
      bar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * kStageBytes;
      // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart; B: four
      // 64-column boxes of 64 k-rows, 8192 bytes apart
      const uint64_t da = smem_desc(st + g * 64 * 128, 16, 1024);
      const uint64_t db = smem_desc(st + kXBytes, kWBytes / 4, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk) {
        // 16 channels on: 32 bytes along A's rows, 16 rows of B
        wgmma_256(acc, da + (32 * kk >> 4), db + (16 * 128 * kk >> 4),
                  it > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      bar_arrive_if(&empty[held < 0 ? stage : held], held >= 0 && tid == 0);
      held = stage;
      next();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    bar_arrive_if(&empty[held], tid == 0);
    // acc[4j .. 4j + 3]: rows ra and ra + 8, columns cb + 8j and + 1
    float* ye = y + static_cast<size_t>(tl.e) * R * m;
    const int ra = row0 + warp * 16 + (lane >> 2);
    const int cb = tl.c * kCols + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int col = cb + 8 * j;
      if (col >= m) continue;
      if (ra < R) {
        *reinterpret_cast<float2*>(ye + static_cast<size_t>(ra) * m + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      }
      if (ra + 8 < R) {
        *reinterpret_cast<float2*>(ye + static_cast<size_t>(ra + 8) * m +
                                   col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library links no libcuda.
Encode encoder() {
  static Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<Encode>(p);
    }
  }
  return fn;
}

// A bf16 tensor map over a dense (d2, d1, d0) array, d0 innermost, with
// boxes of (b0, b1, 1), the 128-byte swizzle and zeros out of bounds.
bool encode(CUtensorMap* map, const void* base, int d0, int d1, int d2,
            int b0, int b1) {
  const Encode fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

int launch(const void* x, const void* w, const void* idx, void* y, int E,
           int R, int n, int m, int blk, int kb, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, x, n, R, E, kDepth, kRows) ||
      !encode(&wmap, w, m, n, E, 64, kDepth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // setmaxnreg moves registers within the CTA: the consumers' 232 are
  // there only if the kernel was given its 168 (65536 / 384) at launch
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes attr;
    const cudaError_t a = cudaFuncGetAttributes(&attr, tile_kernel);
    if (a != cudaSuccess) return static_cast<int>(a);
    regs = attr.numRegs;
  }
  if (regs * kThreads < 40 * 128 + 232 * 256) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  static unsigned done = 0;
  cudaError_t e = gm::allow_smem(tile_kernel, kBytes, done);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_kernel<<<ctas(E, R, m, sms), kThreads, kBytes, st>>>(
      xmap, wmap, static_cast<const int*>(idx), static_cast<float*>(y), E, R,
      m, n / blk, blk, kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
}  // namespace wisparse
