// Segmented combines for Hopper (sm_90a): the hand-written CUDA counterparts
// of the reference's Pallas kernels
//   repro/kernels/spmv.py::edge_block_sum / _kernel            (kernel 3, sum)
//   repro/kernels/block_sweep.py::_edge_block_select / _seg_kernel
//     (edge_block_min, edge_block_max)                        (kernel 2)
// reached through repro/core/engine.py::_combine_local(use_pallas=True) from
// make_block_processor, the distributed engine's per-block update.
//
// What it computes, for one row of a group-padded storage (E edge slots, a
// block of C destinations):
//   out[d] = combine over the slots i with dst[i] == d of msg[i]
// with 0 (sum) or the identity (min/max) where d has no slot. The row's tail
// past its true edges carries dst 0 and msg = identity, so dst is not sorted
// across a row and slot 0 can have runs at both ends: any dst in [0, C) is
// taken. The TPU kernels do this as a one-hot (1, 512) @ (512, C) matmul
// (sum) or a masked select and tree reduce (min/max) per 512-edge tile into
// a resident (1, C) accumulator; that is a matrix-unit idiom, and a one-hot
// product is 2C flops per edge where the function needs one.
//
// Order of the sum (the plain version, kernels/segment.py, defines it and
// this kernel repeats it bitwise):
//   * the slots are split into 512-slot tiles;
//   * within a tile, each maximal run of consecutive slots with equal dst is
//     folded left to right in slot order, starting from its first message;
//   * each destination's run partials are added, in (tile, run) order, to an
//     accumulator that starts at 0.
// This is the TPU kernel's tile-order accumulation; it differs from the
// reference's dense scatter (one chain per destination in slot order) by
// reordering roundoff only. Min and max are exact in any order.
//
// Bound: bytes. msg and dst are read once (8 B per slot) and C values are
// written; ~1 flop per slot. Two launches, so a hub row (19.7M slots in one
// row at n = 2^21, block 4096) is spread over the whole card instead of one
// thread block:
//   1. seg_runs: one warp per tile, grid-stride over the row's tiles. The
//      warp stages the tile's dst and msg in shared memory; the lane at each
//      run's head folds the run and writes the partial at the head's slot in
//      `part` (a scratch as long as the row).
//   2. seg_fold: one warp per destination folds its partials through the
//      head list heads[hptr[d] .. hptr[d+1]) (slots sorted by destination,
//      then slot: (tile, run) order). The lanes gather FOLD_GROUPS x 32
//      partials at once; the fold itself is one sequential chain, the
//      partials passed to it in order by shuffles. The head lists depend on
//      dst alone: the distributed engine's rows are static, so they are
//      built once per storage group on the device.
// A destination with many runs (a hub: 8.6K tiles for the 4.4M in-edges of
// the PageRank graph's top vertex; or slot 0 over a long padded tail) is one
// sequential fold over its runs: one partial per tile, not per edge, with
// the gathers of 256 partials in flight rather than one thread's few.
//
// Explicit _rn intrinsics keep nvcc from contracting or reassociating.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 512
#define RUN_WARPS 4
#define FOLD_WARPS 4
#define FOLD_GROUPS 8

namespace {

enum { SUM = 0, MIN = 1, MAX = 2 };

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == SUM) return __fadd_rn(a, b);
  if (op == MIN) return fminf(a, b);
  return fmaxf(a, b);
}

// Launch 1: run partials. A tile's slots are [t*TILE, min(t*TILE + TILE, e)).
// A slot heads a run when it starts its tile or its dst differs from the
// slot before it.
__global__ void __launch_bounds__(RUN_WARPS * 32)
seg_runs(const float* __restrict__ msg, const int32_t* __restrict__ dst,
         long long e, int op, float* __restrict__ part) {
  __shared__ float s_msg[RUN_WARPS][TILE];
  __shared__ int32_t s_dst[RUN_WARPS][TILE];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long ntiles = (e + TILE - 1) / TILE;
  // the loop is uniform across the warp, so __syncwarp is safe in it
  for (long long t = (long long)blockIdx.x * RUN_WARPS + wid; t < ntiles;
       t += (long long)gridDim.x * RUN_WARPS) {
    const long long t0 = t * TILE;
    const int len = (int)min((long long)TILE, e - t0);
    float* m = s_msg[wid];
    int32_t* d = s_dst[wid];
    for (int i = lane; i < len; i += 32) {
      m[i] = msg[t0 + i];
      d[i] = dst[t0 + i];
    }
    __syncwarp();
    for (int i = lane; i < len; i += 32) {
      const int di = d[i];
      if (i == 0 || d[i - 1] != di) {
        float acc = m[i];
        for (int j = i + 1; j < len && d[j] == di; ++j)
          acc = combine(op, acc, m[j]);
        part[t0 + i] = acc;
      }
    }
    __syncwarp();
  }
}

// Launch 2: one warp per destination folds its run partials in (tile, run)
// order from `init` (0 for the sum, the identity for min/max). Lane l
// gathers the partials k0 + 32u + l; every lane then runs the same chain
// over them in k order (u, then the lane index), so acc is the same in all
// lanes and lane 0 writes it.
__global__ void __launch_bounds__(FOLD_WARPS * 32)
seg_fold(const float* __restrict__ part, const int32_t* __restrict__ heads,
         const long long* __restrict__ hptr, int c, int op, float init,
         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * FOLD_WARPS + (threadIdx.x >> 5);
  if (d >= c) return;  // uniform across the warp
  const long long end = hptr[d + 1];
  float acc = init;
  for (long long k0 = hptr[d]; k0 < end; k0 += 32 * FOLD_GROUPS) {
    float v[FOLD_GROUPS];
#pragma unroll
    for (int u = 0; u < FOLD_GROUPS; ++u) {
      const long long k = k0 + 32 * u + lane;
      v[u] = k < end ? part[heads[k]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < FOLD_GROUPS; ++u) {
      const long long n = end - (k0 + 32 * u);  // uniform across the warp
      if (n <= 0) break;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float x = __shfl_sync(0xffffffffu, v[u], j);
        if (j < n) acc = combine(op, acc, x);
      }
    }
  }
  if (lane == 0) out[d] = acc;
}

}  // namespace

// One launch pair on `stream`: out (c,) from msg/dst (e,) of one row, with
// the row's head lists (hptr: c + 1 offsets into heads) and a scratch `part`
// of at least e floats. Returns 0, or the cudaError_t of the first launch
// that failed.
extern "C" int segment_combine_launch(const void* msg, const void* dst,
                                      long long e, int c, const void* heads,
                                      const void* hptr, void* part, void* out,
                                      int op, float init, int run_grid,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (e > 0) {
    seg_runs<<<run_grid, RUN_WARPS * 32, 0, st>>>(
        (const float*)msg, (const int32_t*)dst, e, op, (float*)part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  seg_fold<<<(c + FOLD_WARPS - 1) / FOLD_WARPS, FOLD_WARPS * 32, 0, st>>>(
      (const float*)part, (const int32_t*)heads, (const long long*)hptr, c,
      op, init, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
