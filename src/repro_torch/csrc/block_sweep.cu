// Fused block sweep for Hopper (sm_90a): the hand-written CUDA counterpart of
// the reference's Pallas kernel repro/kernels/block_sweep.py::_sweep_kernel
// (single-lane, unmasked), together with the delta tail of
// repro/core/engine.py::make_tiled_processor.process_one.
//
// What it computes, for a slate of scheduled blocks (rows[s], ok[s]):
//   for every ok slot's block b (vertices [b*C, b*C + C)):
//     agg[d] = combine over b's in-edges (src, w) -> d of edge_map(values[src], aux[src], w)
//     new[d] = apply(values[b*C + d], agg[d])          (live vertices only)
//     psd[b] = mean over live d of sd_delta(old, new),  dmax[b] = max of it
// Every slot reads one snapshot of `values_in` and writes its own block of
// `values_out` (the same buffer for an in-place sweep; distinct rows never
// overlap). Slots that are not ok do nothing.
//
// Bound: bytes. Per edge slot it reads 13 B of tile row (src, dstl, w, valid)
// plus a 4 B value gather and a 4 B aux gather, and per vertex it writes 4 B;
// there is ~1 flop per edge.
//
// Order of the sum. Each tile's partial for destination d starts from the
// identity and adds d's messages in slot order; agg adds the partials in
// tile order. Tiles are in destination order (CSC), so d's messages in a tile
// are one contiguous run of slots. The plain version (block_sweep_ref)
// repeats this order, so kernel and plain version agree bitwise. The
// reference's dense path is one sequential chain per destination over all
// of its edges (XLA folds the per-tile partials into the scatter), so a sum
// agrees with it only to the reordering roundoff (a few ulps); min/max are
// exact in any order. Matching that chain bitwise would make a hub
// destination one dependent chain of adds over millions of edges.
//
// Skew. After the active-degree sort, block 0 of a Zipf(1.2) graph holds
// most of the edges (78% at n = 2^21), so no thread block ever walks a whole
// graph block. Two launches:
//   1. sweep_tiles: a grid-stride loop over every tile of every ok slot (the
//      slate's tile prefix is scanned in shared memory, so no host sync is
//      needed to size the work). One thread per slot gathers, maps and masks;
//      the thread at the head of each destination run adds the run in slot
//      order and writes the tile's partial at the head's slot index in
//      `part` (a scratch array shaped like the tile rows).
//   2. sweep_fold: one thread block per slot, one thread per destination. The
//      thread reads d's partials in tile order (d's run in tile t starts at
//      slot max(vlo[d], t*TILE)), applies, writes, and the block reduces the
//      deltas with a pairwise tree whose order block_sweep_ref repeats.
// A hub destination costs one sequential fold over its tiles (one partial
// per 512 edges, loaded FOLD_AHEAD at a time so the loads overlap);
// everything else is parallel over tiles.
//
// Arithmetic is pinned to the reference (XLA on CPU): IEEE division for
// PageRank's message (no fast math), apply fused into one FMA as XLA fuses
// it, and explicit _rn intrinsics elsewhere so nvcc cannot contract.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 512
#define MAX_SLOTS 8192
#define MAX_BLOCK 1024
#define FOLD_AHEAD 32

namespace {

enum { PAGERANK = 0, SSSP = 1, BFS = 2, CC = 3 };

__device__ __forceinline__ float merge(int prog, float a, float b) {
  if (prog == PAGERANK) return __fadd_rn(a, b);
  if (prog == CC) return fmaxf(a, b);
  return fminf(a, b);
}

__device__ __forceinline__ float edge_map(int prog, float v, float a, float w) {
  switch (prog) {
    case PAGERANK: return __fdiv_rn(v, a);
    case SSSP: return __fadd_rn(v, w);
    case BFS: return __fadd_rn(v, 1.0f);
    default: return v;
  }
}

__device__ __forceinline__ float apply(int prog, float old, float agg, float d,
                                       float c) {
  switch (prog) {
    case PAGERANK: return __fmaf_rn(d, agg, c);
    case CC: return fmaxf(old, agg);
    default: return fminf(old, agg);
  }
}

__device__ __forceinline__ float sd_delta(int prog, float old, float nw) {
  switch (prog) {
    case PAGERANK: return fabsf(__fsub_rn(nw, old));
    case SSSP: return nw < old ? fminf(nw, old) : 0.0f;
    case BFS: return nw < old ? 1.0f : 0.0f;
    default: return nw > old ? fmaxf(nw, old) : 0.0f;
  }
}

__global__ void __launch_bounds__(TILE) sweep_tiles(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dstl,
    const float* __restrict__ w, const uint8_t* __restrict__ valid,
    const float* __restrict__ values, const float* __restrict__ aux,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_cnt, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, int nslots, int prog, float ident,
    float* __restrict__ part) {
  __shared__ int s_pre[MAX_SLOTS];
  __shared__ int s_tot[TILE];
  __shared__ float s_msg[TILE];
  __shared__ int s_dst[TILE];
  __shared__ uint8_t s_val[TILE];
  const int tid = threadIdx.x;

  // inclusive prefix of the slate's tile counts (slots that are not ok own
  // no tiles): each thread scans a run of `per` slots, then the run totals
  // are scanned across the block
  const int per = (nslots + TILE - 1) / TILE;
  const int beg = min(tid * per, nslots), end = min(beg + per, nslots);
  int run = 0;
  for (int s = beg; s < end; ++s) {
    run += ok[s] ? tile_cnt[rows[s]] : 0;
    s_pre[s] = run;
  }
  s_tot[tid] = run;
  __syncthreads();
  for (int off = 1; off < TILE; off <<= 1) {
    const int add = tid >= off ? s_tot[tid - off] : 0;
    __syncthreads();
    s_tot[tid] += add;
    __syncthreads();
  }
  const int carry = tid ? s_tot[tid - 1] : 0;
  for (int s = beg; s < end; ++s) s_pre[s] += carry;
  __syncthreads();
  const int total = s_pre[nslots - 1];

  for (int v = blockIdx.x; v < total; v += gridDim.x) {
    // the slot that owns virtual tile v: the first s with s_pre[s] > v
    int lo = 0, hi = nslots - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_pre[mid] > v) hi = mid; else lo = mid + 1;
    }
    const int before = lo ? s_pre[lo - 1] : 0;
    const long long r = (long long)tile_start[rows[lo]] + (v - before);
    const long long e = r * TILE + tid;
    const bool vd = valid[e] != 0;
    float m = ident;
    int dl = -1;
    if (vd) {
      const int sv = src[e];
      m = edge_map(prog, values[sv], aux[sv], w[e]);
      dl = dstl[e];
    }
    s_msg[tid] = m;
    s_dst[tid] = dl;
    s_val[tid] = vd;
    __syncthreads();
    if (vd && (tid == 0 || !s_val[tid - 1] || s_dst[tid - 1] != dl)) {
      // head of d's run: the partial starts from the identity and adds the
      // run's messages in slot order
      float acc = merge(prog, ident, m);
      for (int k = tid + 1; k < TILE && s_val[k] && s_dst[k] == dl; ++k)
        acc = merge(prog, acc, s_msg[k]);
      part[e] = acc;
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

__global__ void sweep_fold(
    const float* __restrict__ part, const int32_t* __restrict__ vlo,
    const int32_t* __restrict__ vhi, const float* values_in,
    float* values_out, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, int c, int n_live, int prog, float ident,
    float d, float cst, int first, int last, float* __restrict__ oldbuf,
    float* __restrict__ psd, float* __restrict__ dmax) {
  __shared__ float s_sum[MAX_BLOCK];
  __shared__ float s_max[MAX_BLOCK];
  const int slot = blockIdx.x;
  if (!ok[slot]) return;  // uniform over the thread block
  const int tid = threadIdx.x;
  const int row = rows[slot];
  const long long base = (long long)row * c;
  float delta = 0.0f;
  if (tid < c) {
    const long long v = base + tid;
    const float old = values_in[v];
    float nw = old;
    if (first && !last) oldbuf[tid] = old;  // a hot slot's pre-sweep values
    if (v < n_live) {
      float agg = ident;
      const int e0 = vlo[v], e1 = vhi[v];
      if (e1 > e0) {
        agg = merge(prog, agg, part[e0]);
        int h = (e0 / TILE + 1) * TILE;
        // a hub's chain is thousands of partials long: keep FOLD_AHEAD
        // independent loads in flight, then add them in tile order
        for (; h + (FOLD_AHEAD - 1) * TILE < e1; h += FOLD_AHEAD * TILE) {
          float p[FOLD_AHEAD];
#pragma unroll
          for (int k = 0; k < FOLD_AHEAD; ++k) p[k] = part[h + k * TILE];
#pragma unroll
          for (int k = 0; k < FOLD_AHEAD; ++k) agg = merge(prog, agg, p[k]);
        }
        for (; h < e1; h += TILE) agg = merge(prog, agg, part[h]);
      }
      nw = apply(prog, old, agg, d, cst);
      if (last) delta = sd_delta(prog, first ? old : oldbuf[tid], nw);
    }
    values_out[v] = nw;
  }
  if (!last) return;  // uniform over the thread block
  s_sum[tid] = delta;
  s_max[tid] = delta;
  __syncthreads();
  for (int h = blockDim.x >> 1; h > 0; h >>= 1) {
    if (tid < h) {
      s_sum[tid] = __fadd_rn(s_sum[tid], s_sum[tid + h]);
      s_max[tid] = fmaxf(s_max[tid], s_max[tid + h]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    long long live = (long long)n_live - base;
    live = live < 1 ? 1 : (live > c ? c : live);
    psd[row] = __fdiv_rn(s_sum[0], (float)live);
    dmax[row] = s_max[0];
  }
}

}  // namespace

// One launch pair on `stream`. Returns 0, or the cudaError_t of the first
// launch that failed.
extern "C" int block_sweep_launch(
    const void* src, const void* dstl, const void* w, const void* valid,
    const void* values_in, void* values_out, const void* aux,
    const void* tile_start, const void* tile_cnt, const void* vlo,
    const void* vhi, const void* rows, const void* ok, int nslots,
    int tile_grid, int fold_threads, int c, int n_live, int prog, float ident,
    float d, float cst, int first, int last, void* part, void* oldbuf,
    void* psd, void* dmax, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  sweep_tiles<<<tile_grid, TILE, 0, st>>>(
      (const int32_t*)src, (const int32_t*)dstl, (const float*)w,
      (const uint8_t*)valid, (const float*)values_in, (const float*)aux,
      (const int32_t*)tile_start, (const int32_t*)tile_cnt,
      (const int32_t*)rows, (const uint8_t*)ok, nslots, prog, ident,
      (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_fold<<<nslots, fold_threads, 0, st>>>(
      (const float*)part, (const int32_t*)vlo, (const int32_t*)vhi,
      (const float*)values_in, (float*)values_out, (const int32_t*)rows,
      (const uint8_t*)ok, c, n_live, prog, ident, d, cst, first, last,
      (float*)oldbuf, (float*)psd, (float*)dmax);
  return (int)cudaGetLastError();
}

extern "C" const char* block_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
