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
// with 0 (sum) or the identity (min/max) where d has no slot. The TPU
// kernels do this as a one-hot (1, 512) @ (512, C) matmul (sum) or a masked
// select and tree reduce (min/max) per 512-edge tile into a resident (1, C)
// accumulator; that is a matrix-unit idiom, and a one-hot product is 2C
// flops per edge where the function needs one.
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
// The order is a plain function of msg and a table of the row's runs, built
// once with the layout (segment_layout): each run's start slot and target,
// in slot order. The runs partition the row, so a run ends where the next
// one starts, and a tile's runs are consecutive in the table. Destination
// d's j-th run in slot order has partial lptr[d] + j, so part is contiguous
// per destination and in (tile, run) order. No dst read, no compare. Every
// row the distributed engine builds is a contiguous CSC slice, and it calls
// the kernel on each row's valid prefix, so dst is non-decreasing over the
// slots of a call: destination d's runs are then its slot range
// [off[d], off[d+1]) cut at the multiples of 512. The code calls a run a
// piece.
//   * Short rows (no destination of more than LONG_PIECES runs, at most
//     CHAIN_MAX of more than one; kernels/segment.py sets both and chooses
//     each row's path), one launch, seg_tiles: a warp per tile stages the
//     tile's messages and its runs' entries in shared memory (coalesced
//     loads, all issued before they are stored), and a lane per run folds
//     it from there. A destination of one run is written at once (init
//     combined with it); a run of a longer destination goes to its
//     partial. The block that finishes last (a completion counter between
//     acquire-release fences) folds each longer destination's partials, a
//     thread each, from init, and resets the counter.
//   * Long rows (any other row: a hub, or a row of many short runs), two
//     launches. seg_pieces: a lane per run folds it from global memory in
//     batches of 8 float4, the next batch in flight, and writes it as
//     above. seg_chain: a warp per longer destination folds its partials in
//     one chain: the lanes load 512 partials at a time (the next 512 in
//     flight) and pass them to the chain in order by shuffles.
//   Both write init to the empty destinations from a grid-stride loop.
// No lane folds more than 512 slots serially, however skewed the
// destinations. On the PageRank graph's storage at block 4096 its cold rows
// have at most 3 runs per destination and its other hot rows at most 4;
// the hub row's top destination has 8627 runs, and its chain, 8627
// dependent adds, is the floor the order sets on that row.
//
// seg_tiles folds a run from the identity of the combine (+0, +inf or
// -inf) rather than from its first message. For min and max that changes
// nothing; for the sum it can turn a run of -0 into +0, which the
// accumulator cannot tell apart: it starts at +0, so it is never -0, and
// x + (+0) == x + (-0) for every x that is not -0.
//
// Bound: bytes. The least a sorted row's call needs is msg (4 B per slot),
// the destination offsets (4 B per destination) and the C outputs; the
// kernel reads the run table (8 B per run) in place of the offsets. A
// function that reads dst needs 8 B per slot. ~1 flop per slot.
//
// Explicit _rn intrinsics keep nvcc from contracting or reassociating.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 512
#define TILE_SHIFT 9
#define TILE_WARPS 4  // tiles per block of seg_tiles
#define PIECE_THREADS 128
#define EMPTY_BATCH 8
#define CHAIN_WARPS 4
#define CHAIN_GROUPS 16

namespace {

enum { SUM = 0, MIN = 1, MAX = 2 };

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == SUM) return __fadd_rn(a, b);
  if (OP == MIN) return fminf(a, b);
  return fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == SUM) return 0.0f;
  return __int_as_float(OP == MIN ? 0x7f800000 : 0xff800000);  // +-inf
}

template <int OP>
__device__ __forceinline__ float combine4(float p, float4 v) {
  return combine<OP>(combine<OP>(combine<OP>(combine<OP>(p, v.x), v.y), v.z),
                     v.w);
}

// m[i .. end), end > i, folded left to right from its first element. The
// body goes in batches of 8 float4 (32 floats), the next batch loaded before
// the current one is folded.
template <int OP>
__device__ float fold_global(const float* __restrict__ m, int i, int end) {
  float p = __ldg(m + i++);
  while (i < end && (reinterpret_cast<uintptr_t>(m + i) & 15))
    p = combine<OP>(p, __ldg(m + i++));
  const float4* q = reinterpret_cast<const float4*>(m + i);
  const int nq = (end - i) >> 2, nb = nq >> 3;
  float4 cur[8], nxt[8];
  if (nb > 0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) cur[u] = __ldg(q + u);
  }
  for (int b = 0; b < nb; ++b) {
    const bool more = b + 1 < nb;
    if (more) {
#pragma unroll
      for (int u = 0; u < 8; ++u) nxt[u] = __ldg(q + 8 * (b + 1) + u);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) p = combine4<OP>(p, cur[u]);
    if (more) {
#pragma unroll
      for (int u = 0; u < 8; ++u) cur[u] = nxt[u];
    }
  }
  for (int k = 8 * nb; k < nq; ++k) p = combine4<OP>(p, __ldg(q + k));
  for (int j = i + 4 * nq; j < end; ++j) p = combine<OP>(p, __ldg(m + j));
  return p;
}

// out[empty[k]] = init for every k, by all the grid's threads, each
// issuing EMPTY_BATCH loads before its stores.
__device__ __forceinline__ void write_empty(
    const int32_t* __restrict__ empty, int nempty, float init,
    float* __restrict__ out) {
  const int n = gridDim.x * blockDim.x;
  for (int k0 = blockIdx.x * blockDim.x + threadIdx.x; k0 < nempty;
       k0 += EMPTY_BATCH * n) {
    int d[EMPTY_BATCH];
#pragma unroll
    for (int u = 0; u < EMPTY_BATCH; ++u)
      d[u] = k0 + u * n < nempty ? __ldg(empty + k0 + u * n) : -1;
#pragma unroll
    for (int u = 0; u < EMPTY_BATCH; ++u)
      if (d[u] >= 0) out[d[u]] = init;
  }
}

// p folded over s[i .. end) (shared memory) left to right: scalars up to a
// float4 boundary, then float4s, each loaded one ahead of its fold.
template <int OP>
__device__ __forceinline__ float fold_shared(float p, const float* s, int i,
                                             int end) {
  for (; i < end && (i & 3); ++i) p = combine<OP>(p, s[i]);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  int k = i >> 2;
  const int k1 = end >> 2;
  if (k < k1) {
    float4 x = s4[k];
    for (++k; k < k1; ++k) {
      const float4 y = s4[k];
      p = combine4<OP>(p, x);
      x = y;
    }
    p = combine4<OP>(p, x);
    i = k1 << 2;
  }
  for (; i < end; ++i) p = combine<OP>(p, s[i]);
  return p;
}

// Short rows, one launch: a warp per tile, a lane per piece; the
// last block to finish folds the longer destinations' partials.
template <int OP>
__global__ void __launch_bounds__(TILE_WARPS * 32)
seg_tiles(const float* __restrict__ msg, long long e,
          const int32_t* __restrict__ pstart,
          const int32_t* __restrict__ ptarget,
          const int32_t* __restrict__ tpiece,
          const int32_t* __restrict__ lptr,
          const int32_t* __restrict__ empty, int nempty,
          const int32_t* __restrict__ chain, int nchain, float init,
          float* __restrict__ out, float* __restrict__ part,
          unsigned int* __restrict__ counter) {
  __shared__ float4 s_tile[TILE_WARPS][TILE / 4 + 1];
  __shared__ int32_t s_start[TILE_WARPS][TILE + 1];
  __shared__ int32_t s_target[TILE_WARPS][TILE];
  __shared__ unsigned int s_ticket;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long ntiles = (e + TILE - 1) / TILE;
  const int t = blockIdx.x * TILE_WARPS + wid;
  if (t < ntiles) {  // no return: the block meets at __syncthreads below
    const int t0 = t * TILE, t1 = (int)min(e, (long long)t0 + TILE);
    // the tile from t0 rounded down to a 16-byte address: whole float4s,
    // none of which crosses a page, so reading one that holds a valid
    // element is safe
    const int base =
        t0 - (int)((reinterpret_cast<uintptr_t>(msg + t0) & 15) >> 2);
    const float4* q = reinterpret_cast<const float4*>(msg + base);
    const int nq = (t1 - base + 3) >> 2;  // at most TILE / 4 + 1
    float4 v[5];
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const int k = 32 * u + lane;
      if (k < nq) v[u] = __ldg(q + k);
    }
    const int k0 = __ldg(tpiece + t), np = __ldg(tpiece + t + 1) - k0;
    // the tile's pieces: their starts (and the next piece's, the end of
    // the last) and targets
    int32_t ps[TILE / 32 + 1], pt[TILE / 32];
#pragma unroll
    for (int u = 0; u <= TILE / 32; ++u) {
      const int k = 32 * u + lane;
      if (k <= np) ps[u] = __ldg(pstart + k0 + k);
      if (u < TILE / 32 && k < np) pt[u] = __ldg(ptarget + k0 + k);
    }
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const int k = 32 * u + lane;
      if (k < nq) s_tile[wid][k] = v[u];
    }
#pragma unroll
    for (int u = 0; u <= TILE / 32; ++u) {
      const int k = 32 * u + lane;
      if (k <= np) s_start[wid][k] = ps[u];
      if (u < TILE / 32 && k < np) s_target[wid][k] = pt[u];
    }
    __syncwarp();
    const float* s = reinterpret_cast<const float*>(s_tile[wid]);
    for (int k = lane; k < np; k += 32) {
      const int lo = s_start[wid][k] - base, hi = s_start[wid][k + 1] - base;
      const int target = s_target[wid][k];
      float p = identity<OP>();
      if (hi - lo < 16) {
#pragma unroll 4
        for (int i = lo; i < hi; ++i) p = combine<OP>(p, s[i]);
      } else {
        p = fold_shared<OP>(p, s, lo, hi);
      }
      if (target >= 0)  // the destination's only piece
        out[target] = combine<OP>(init, p);
      else  // a piece of a longer destination: its partial ~target
        part[~target] = p;
    }
  }
  write_empty(empty, nempty, init, out);
  // The block's partials are ordered before thread 0's release by the
  // barrier (a release is cumulative); the last block's acquire orders
  // every other block's before its reads. One acq_rel fence each side:
  // __threadfence() in every thread is a seq_cst fence.
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    s_ticket = atomicAdd(counter, 1u);
    if (s_ticket == gridDim.x - 1)
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (s_ticket != gridDim.x - 1) return;
  for (int k = threadIdx.x; k < nchain; k += blockDim.x) {
    const int d = __ldg(chain + k);
    const int j1 = __ldg(lptr + d + 1);
    float acc = init;
    for (int j = __ldg(lptr + d); j < j1; ++j)
      acc = combine<OP>(acc, __ldcg(part + j));
    out[d] = acc;
  }
  if (threadIdx.x == 0) *counter = 0;
}

// Long rows, launch 1: a lane per piece, folded from global memory
// (a hub row's pieces are mostly whole tiles: a warp per tile would leave
// 31 of its lanes idle), written at once or into its partial.
template <int OP>
__global__ void __launch_bounds__(PIECE_THREADS)
seg_pieces(const float* __restrict__ msg, const int32_t* __restrict__ pstart,
           const int32_t* __restrict__ ptarget, int npieces,
           const int32_t* __restrict__ empty, int nempty, float init,
           float* __restrict__ out, float* __restrict__ part) {
  write_empty(empty, nempty, init, out);
  const int k = blockIdx.x * PIECE_THREADS + threadIdx.x;
  if (k >= npieces) return;
  const int target = __ldg(ptarget + k);
  const float p =
      fold_global<OP>(msg, __ldg(pstart + k), __ldg(pstart + k + 1));
  if (target >= 0)
    out[target] = combine<OP>(init, p);
  else
    part[~target] = p;
}

// Long rows, launch 2: a warp per listed destination d = chain[k]
// folds part[lptr[d] .. lptr[d+1]) from `init` into out[d]. Lane l loads the
// partials r0 + 32u + l; every lane runs the same chain over them in order
// (u, then the lane index), so acc is the same in all lanes and lane 0
// writes it.
template <int OP>
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
seg_chain(const float* __restrict__ part, const int32_t* __restrict__ lptr,
          const int32_t* __restrict__ chain, int nchain, float init,
          float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * CHAIN_WARPS + (threadIdx.x >> 5);
  if (k >= nchain) return;  // uniform across the warp
  const int d = chain[k];
  const int lo = lptr[d], n = lptr[d + 1] - lo;
  const float* pp = part + lo;
  float acc = init, v[CHAIN_GROUPS], w[CHAIN_GROUPS];
#pragma unroll
  for (int u = 0; u < CHAIN_GROUPS; ++u) {
    const int j = 32 * u + lane;
    v[u] = j < n ? pp[j] : 0.0f;
    w[u] = 0.0f;
  }
  for (int r0 = 0; r0 < n; r0 += 32 * CHAIN_GROUPS) {
    const int r1 = r0 + 32 * CHAIN_GROUPS;
    if (r1 < n) {
#pragma unroll
      for (int u = 0; u < CHAIN_GROUPS; ++u) {
        const int j = r1 + 32 * u + lane;
        w[u] = j < n ? pp[j] : 0.0f;
      }
    }
    if (n >= r1) {  // a whole batch
#pragma unroll
      for (int u = 0; u < CHAIN_GROUPS; ++u) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          acc = combine<OP>(acc, __shfl_sync(0xffffffffu, v[u], j));
      }
    } else {
#pragma unroll
      for (int u = 0; u < CHAIN_GROUPS; ++u) {
        const int m = n - (r0 + 32 * u);  // uniform across the warp
        if (m <= 0) break;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = __shfl_sync(0xffffffffu, v[u], j);
          if (j < m) acc = combine<OP>(acc, x);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < CHAIN_GROUPS; ++u) v[u] = w[u];
  }
  if (lane == 0) out[d] = acc;
}

}  // namespace

// One row's constants, built once with the layout (kernels/segment.py:
// _SegRow mirrors it field by field).
struct SegRow {
  const int32_t* pstart;  // each run's first slot, then e
  const int32_t* ptarget; // each run's output or ~partial
  const int32_t* tpiece;  // each tile's first run, then all
  const int32_t* lptr;    // C + 1 offsets of the destinations' runs
  const int32_t* empty;   // destinations without a run
  const int32_t* chain;   // destinations of 2 runs or more
  float* part;            // scratch
  unsigned int* counter;  // short rows: blocks done (0 between calls)
  long long e;            // slots the call covers
  int path;               // SHORT or LONG
  int npieces;            // runs
  int nempty;
  int nchain;
};

enum { SHORT = 0, LONG = 1 };

template <int OP>
static int launch_row(const SegRow* r, const float* msg, float* out,
                      float init, cudaStream_t st) {
  if (r->path == SHORT) {
    const long long ntiles = (r->e + TILE - 1) / TILE;
    const int grid = (int)max(1LL, (ntiles + TILE_WARPS - 1) / TILE_WARPS);
    seg_tiles<OP><<<grid, TILE_WARPS * 32, 0, st>>>(
        msg, r->e, r->pstart, r->ptarget, r->tpiece, r->lptr, r->empty,
        r->nempty, r->chain, r->nchain, init, out, r->part, r->counter);
    return (int)cudaGetLastError();
  }
  seg_pieces<OP><<<(r->npieces + PIECE_THREADS - 1) / PIECE_THREADS,
                   PIECE_THREADS, 0, st>>>(msg, r->pstart, r->ptarget,
                                           r->npieces, r->empty, r->nempty,
                                           init, out, r->part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || r->nchain == 0) return (int)err;
  seg_chain<OP><<<(r->nchain + CHAIN_WARPS - 1) / CHAIN_WARPS,
                  CHAIN_WARPS * 32, 0, st>>>(r->part, r->lptr, r->chain,
                                             r->nchain, init, out);
  return (int)cudaGetLastError();
}

// out (c,) from msg (e,) of one row on `stream`: one launch on a short
// row, two on a long row. Returns 0, or the cudaError_t of
// the first launch that failed.
extern "C" int segment_combine(const SegRow* row, const void* msg, void* out,
                               int op, float init, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)msg;
  float* o = (float*)out;
  if (op == SUM) return launch_row<SUM>(row, m, o, init, st);
  if (op == MIN) return launch_row<MIN>(row, m, o, init, st);
  return launch_row<MAX>(row, m, o, init, st);
}

extern "C" const char* segment_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
