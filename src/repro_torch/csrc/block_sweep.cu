// Fused block sweep for Hopper (sm_90a): the hand-written CUDA counterpart of
// the reference's Pallas kernel repro/kernels/block_sweep.py::_sweep_kernel
// (single-lane; unmasked, and masked for sub-blocks), together with the delta
// tail of repro/core/engine.py::make_tiled_processor.process_one.
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
// Masked form (kernel 1m, `masked` = 1, S sub-blocks of C/S vertices each):
// a slot's mask is sub_act[s] = psd[b][s] >= floor, read on the device when
// the slot starts. Tiles whose coverage cov[t] holds no active sub-range are
// skipped; only live vertices of active sub-ranges are written; the last pass
// writes per-sub-block mean and max deltas for the active sub-ranges and
// leaves the masked ones' psd/dmax as they were. A skipped tile holds no edge
// into an active sub-range (cov is exact), so no active destination reads a
// partial of it. A hot slot's passes leave psd[b] alone until the last one,
// so every pass derives the mask the slot had at entry.
//
// Bound: bytes. Per edge slot it reads 13 B of tile row (src, w, valid, link)
// plus a 4 B value gather and a 4 B aux gather, and per vertex it writes 4 B;
// there is ~1 flop per edge.
//
// Order of the sum, on any tile layout. A destination's RUN in a tile is its
// valid slots there, in slot order, wherever they lie (a streaming layout
// appends at a watermark, leaves holes where edges die, and rebuilds runs in
// bucket order). The run's partial starts from the identity and adds the
// run's messages in slot order; agg adds the partials in tile order. The
// plain version (block_sweep_ref) defines exactly this order, so kernel and
// plain version agree bitwise. On the build-time layout (CSC order) a run is
// contiguous and this is the order of the first version of this kernel. The
// reference's dense path is one sequential chain per destination over all of
// its edges (XLA folds the per-tile partials into the scatter), so a sum
// agrees with it only to the reordering roundoff (a few ulps); min/max are
// exact in any order. Matching that chain bitwise would make a hub
// destination one dependent chain of adds over millions of edges.
//
// The runs come from fold metadata that the host side derives from the tiles
// and refreshes for every block a streaming commit touches
// (kernels/block_sweep.py::fold_metadata): link[e] gives the local index + 1
// of the next slot of e's run (LINK_NEXT bits, 0: none) and flags the run's
// head (LINK_HEAD); heads[hlo[v] .. hhi[v]) lists vertex v's head slots in
// tile order.
//
// Skew. After the active-degree sort, block 0 of a Zipf(1.2) graph holds
// most of the edges (78% at n = 2^21), so no thread block ever walks a whole
// graph block. Two launches:
//   1. sweep_tiles: a grid-stride loop over every tile of every ok slot (the
//      slate's tile prefix is scanned in shared memory, so no host sync is
//      needed to size the work). One thread per slot gathers, maps and masks;
//      the thread at each run's head walks the run's links in slot order and
//      writes the tile's partial at the head's slot index in `part` (a
//      scratch array shaped like the tile rows).
//   2. sweep_fold: one thread block per slot, one thread per destination. The
//      thread reads its heads' partials in tile order, applies, writes, and
//      the block reduces the deltas of each sub-range with a pairwise tree
//      whose order block_sweep_ref repeats.
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
#define LINK_NEXT 0x3ff
#define LINK_HEAD 0x10000

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

// Whether tile r of block `row` feeds an active sub-range (masked form).
__device__ __forceinline__ bool tile_active(const uint8_t* __restrict__ cov,
                                            const float* psd, long long r,
                                            int row, int nsub, float floor) {
  for (int s = 0; s < nsub; ++s)
    if (cov[r * nsub + s] && psd[(long long)row * nsub + s] >= floor)
      return true;
  return false;
}

__global__ void __launch_bounds__(TILE) sweep_tiles(
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ link,
    const float* __restrict__ values, const float* __restrict__ aux,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_cnt, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ cov,
    const float* psd, int nslots, int prog, float ident, int masked, int nsub,
    float floor, float* __restrict__ part) {
  __shared__ int s_pre[MAX_SLOTS];
  __shared__ int s_tot[TILE];
  __shared__ float s_msg[TILE];
  __shared__ int s_link[TILE];
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
    const int row = rows[lo];
    const long long r = (long long)tile_start[row] + (v - before);
    // uniform over the thread block: every thread reads the same entries
    if (masked && !tile_active(cov, psd, r, row, nsub, floor)) continue;
    const long long e = r * TILE + tid;
    const bool vd = valid[e] != 0;
    float m = ident;
    int lk = 0;
    if (vd) {
      const int sv = src[e];
      m = edge_map(prog, values[sv], aux[sv], w[e]);
      lk = link[e];
    }
    s_msg[tid] = m;
    s_link[tid] = lk;
    __syncthreads();
    if (vd && (lk & LINK_HEAD)) {
      // head of a run: the partial starts from the identity and adds the
      // run's messages in slot order
      float acc = merge(prog, ident, m);
      for (int k = lk & LINK_NEXT; k; k = s_link[k - 1] & LINK_NEXT)
        acc = merge(prog, acc, s_msg[k - 1]);
      part[e] = acc;
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

__global__ void sweep_fold(
    const float* __restrict__ part, const int32_t* __restrict__ heads,
    const int32_t* __restrict__ hlo, const int32_t* __restrict__ hhi,
    const float* values_in, float* values_out, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, int c, int n_live, int prog, float ident,
    float d, float cst, int masked, int nsub, float floor, int first, int last,
    float* __restrict__ oldbuf, float* psd, float* __restrict__ dmax) {
  __shared__ float s_sum[2 * MAX_BLOCK];
  __shared__ float s_max[2 * MAX_BLOCK];
  const int slot = blockIdx.x;
  if (!ok[slot]) return;  // uniform over the thread block
  const int tid = threadIdx.x;
  const int row = rows[slot];
  const long long base = (long long)row * c;
  const int sub = c / nsub;
  int sub_p2 = 1;
  while (sub_p2 < sub) sub_p2 <<= 1;
  const int my_sub = tid < c ? tid / sub : 0;
  // read before this block writes psd[row] below (after __syncthreads)
  const bool act =
      !masked || psd[(long long)row * nsub + my_sub] >= floor;
  float delta = 0.0f;
  if (tid < c) {
    const long long v = base + tid;
    const float old = values_in[v];
    float nw = old;
    if (first && !last) oldbuf[tid] = old;  // a hot slot's pre-sweep values
    if (v < n_live && act) {
      float agg = ident;
      int i = hlo[v];
      const int i1 = hhi[v];
      // a hub's chain is thousands of partials long: keep FOLD_AHEAD
      // independent loads in flight, then add them in tile order
      for (; i + FOLD_AHEAD <= i1; i += FOLD_AHEAD) {
        int h[FOLD_AHEAD];
        float p[FOLD_AHEAD];
#pragma unroll
        for (int k = 0; k < FOLD_AHEAD; ++k) h[k] = heads[i + k];
#pragma unroll
        for (int k = 0; k < FOLD_AHEAD; ++k) p[k] = part[h[k]];
#pragma unroll
        for (int k = 0; k < FOLD_AHEAD; ++k) agg = merge(prog, agg, p[k]);
      }
      for (; i < i1; ++i) agg = merge(prog, agg, part[heads[i]]);
      nw = apply(prog, old, agg, d, cst);
      if (last) delta = sd_delta(prog, first ? old : oldbuf[tid], nw);
    }
    values_out[v] = nw;
  }
  if (!last) return;  // uniform over the thread block
  // one zero-padded power-of-two segment per sub-range, each reduced by
  // adding its upper half onto its lower half until one entry is left
  const int width = nsub * sub_p2;  // <= 2 * blockDim.x
  for (int i = tid; i < width; i += blockDim.x) {
    s_sum[i] = 0.0f;
    s_max[i] = 0.0f;
  }
  __syncthreads();
  if (tid < c) {
    const int j = my_sub * sub_p2 + (tid - my_sub * sub);
    s_sum[j] = delta;
    s_max[j] = delta;
  }
  __syncthreads();
  for (int h = sub_p2 >> 1; h > 0; h >>= 1) {
    for (int i = tid; i < width; i += blockDim.x) {
      if ((i & (sub_p2 - 1)) < h) {
        s_sum[i] = __fadd_rn(s_sum[i], s_sum[i + h]);
        s_max[i] = fmaxf(s_max[i], s_max[i + h]);
      }
    }
    __syncthreads();
  }
  if (tid < nsub) {
    const long long at = (long long)row * nsub + tid;
    if (!masked || psd[at] >= floor) {  // masked ranges keep psd and dmax
      long long live = (long long)n_live - (base + (long long)tid * sub);
      live = live < 1 ? 1 : (live > sub ? sub : live);
      psd[at] = __fdiv_rn(s_sum[tid * sub_p2], (float)live);
      dmax[at] = s_max[tid * sub_p2];
    }
  }
}

}  // namespace

// One launch pair on `stream`. Returns 0, or the cudaError_t of the first
// launch that failed. With masked == 0, cov is not read and nsub is 1.
extern "C" int block_sweep_launch(
    const void* src, const void* w, const void* valid, const void* link,
    const void* values_in, void* values_out, const void* aux,
    const void* tile_start, const void* tile_cnt, const void* heads,
    const void* hlo, const void* hhi, const void* rows, const void* ok,
    const void* cov, int nslots, int tile_grid, int fold_threads, int c,
    int n_live, int prog, int masked, int nsub, float ident, float d,
    float cst, float floor, int first, int last, void* part, void* oldbuf,
    void* psd, void* dmax, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  sweep_tiles<<<tile_grid, TILE, 0, st>>>(
      (const int32_t*)src, (const float*)w, (const uint8_t*)valid,
      (const int32_t*)link, (const float*)values_in, (const float*)aux,
      (const int32_t*)tile_start, (const int32_t*)tile_cnt,
      (const int32_t*)rows, (const uint8_t*)ok, (const uint8_t*)cov,
      (const float*)psd, nslots, prog, ident, masked, nsub, floor,
      (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_fold<<<nslots, fold_threads, 0, st>>>(
      (const float*)part, (const int32_t*)heads, (const int32_t*)hlo,
      (const int32_t*)hhi, (const float*)values_in, (float*)values_out,
      (const int32_t*)rows, (const uint8_t*)ok, c, n_live, prog, ident, d, cst,
      masked, nsub, floor, first, last, (float*)oldbuf, (float*)psd,
      (float*)dmax);
  return (int)cudaGetLastError();
}

extern "C" const char* block_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
