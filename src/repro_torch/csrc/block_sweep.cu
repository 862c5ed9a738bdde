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
// Lane form (kernels 1l and 1lm, lane_block_sweep_launch): the counterpart of
// _sweep_kernel(lanes=True) with make_lane_processor.process_one's delta tail,
// for query serving. Values, vconst, psd and dmax carry a trailing lane axis
// of L entries: values (values_len, L) row-major, psd/dmax (P, S, L). Per edge
// slot the tile row and aux[src] are read once and the L messages come from
// one contiguous values[src, :] row; every lane then runs kernel 1's order
// (run partials in slot order, partials in tile order, kernel 1's pairwise
// tree for the deltas), so a one-lane k_sssp sweep is bitwise kernel 1's sssp
// sweep. apply takes vconst: personalized PageRank computes
// fma(1-d, vconst, d*agg) as XLA fuses it. The masked form derives one mask
// per slot, shared by the lanes: sub-range s is live when the max over the
// lanes not done (lane_done, (L,)) of psd[row, s, l] clears the floor.
// Bound: bytes, 13 B of tile row + 4L B of value gather per edge slot and
// 4L B written per vertex; personalized PageRank adds 4 B of aux per edge
// slot and 4L B of vconst read per vertex (the kernel reads aux and vconst
// for that family alone). The tile pass gathers value rows coalesced (a
// warp's threads on neighbouring lanes), keeps the L messages of each slot
// in dynamic shared memory at an odd stride and walks each run's L lanes in
// L threads side by side; the fold keeps one thread per destination (C*L
// work items exceed the 1024 threads of a block) and folds LANE_GROUP lanes
// at once in registers, so a hub's long chain of partials is walked once per
// lane group, not once per lane.
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
#define MAX_LANES 32
#define FOLD_AHEAD 32
#define LANE_GROUP 8
#define LANE_AHEAD 4
#define LINK_NEXT 0x3ff
#define LINK_HEAD 0x10000

namespace {

enum { PAGERANK = 0, SSSP = 1, BFS = 2, CC = 3, PPR = 4 };

__device__ __forceinline__ float merge(int prog, float a, float b) {
  if (prog == PAGERANK || prog == PPR) return __fadd_rn(a, b);
  if (prog == CC) return fmaxf(a, b);
  return fminf(a, b);
}

__device__ __forceinline__ float edge_map(int prog, float v, float a, float w) {
  switch (prog) {
    case PAGERANK:
    case PPR: return __fdiv_rn(v, a);
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
    case PAGERANK:
    case PPR: return fabsf(__fsub_rn(nw, old));
    case SSSP: return nw < old ? fminf(nw, old) : 0.0f;
    case BFS: return nw < old ? 1.0f : 0.0f;
    default: return nw > old ? fmaxf(nw, old) : 0.0f;
  }
}

// apply of the lane families: personalized PageRank restarts into vconst
// (read for that family alone); the min families are kernel 1's.
__device__ __forceinline__ float lane_apply(int prog, float old, float agg,
                                            const float* __restrict__ vconst,
                                            long long at, float d, float omd) {
  if (prog == PPR) return __fmaf_rn(omd, vconst[at], __fmul_rn(d, agg));
  return apply(prog, old, agg, d, omd);
}

// Inclusive prefix of the slate's tile counts in s_pre (slots that are not ok
// own no tiles): each thread scans a run of `per` slots, then the run totals
// are scanned across the block. Returns the slate's tile total.
__device__ __forceinline__ int slate_prefix(
    const int32_t* __restrict__ tile_cnt, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, int nslots, int* s_pre, int* s_tot) {
  const int tid = threadIdx.x;
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
  return s_pre[nslots - 1];
}

// The slot that owns virtual tile v: the first s with s_pre[s] > v.
__device__ __forceinline__ int slate_owner(const int* s_pre, int nslots,
                                           int v) {
  int lo = 0, hi = nslots - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_pre[mid] > v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Whether sub-range s of block `row` is live for the lanes (masked lane
// form): the max over the lanes not done of psd[row, s, l] clears the floor.
__device__ __forceinline__ bool sub_live(const float* psd,
                                         const uint8_t* __restrict__ lane_done,
                                         int row, int s, int nsub, int lanes,
                                         float floor) {
  const float* p = psd + ((long long)row * nsub + s) * lanes;
  float mx = lane_done[0] ? 0.0f : p[0];
  for (int l = 1; l < lanes; ++l) mx = fmaxf(mx, lane_done[l] ? 0.0f : p[l]);
  return mx >= floor;
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
  const int total = slate_prefix(tile_cnt, rows, ok, nslots, s_pre, s_tot);

  for (int v = blockIdx.x; v < total; v += gridDim.x) {
    const int lo = slate_owner(s_pre, nslots, v);
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

// Lane tile pass (kernels 1l/1lm): sweep_tiles with L messages per slot.
// Each warp gathers the value rows of its 32 slots with neighbouring threads
// on neighbouring lanes of a row (coalesced for any L), taking each slot's
// src and map operand from its own thread by shuffle; then one thread per
// (head, lane) walks the run, so the L walks of a run proceed side by side
// and a tile's partials are written in one contiguous sweep.
__global__ void __launch_bounds__(TILE) lane_sweep_tiles(
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ link,
    const float* __restrict__ values, const float* __restrict__ aux,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_cnt, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ cov,
    const float* psd, const uint8_t* __restrict__ lane_done, int nslots,
    int lanes, int prog, float ident, int masked, int nsub, float floor,
    float* __restrict__ part) {
  __shared__ int s_pre[MAX_SLOTS];
  __shared__ int s_tot[TILE];
  __shared__ int s_link[TILE];
  extern __shared__ float s_msg[];  // TILE rows of `stride` lanes
  const int stride = lanes | 1;  // odd: lane l of all slots hits all banks
  const int tid = threadIdx.x;
  const bool reads_aux = prog == PAGERANK || prog == PPR;
  const int total = slate_prefix(tile_cnt, rows, ok, nslots, s_pre, s_tot);

  for (int v = blockIdx.x; v < total; v += gridDim.x) {
    const int lo = slate_owner(s_pre, nslots, v);
    const int before = lo ? s_pre[lo - 1] : 0;
    const int row = rows[lo];
    const long long r = (long long)tile_start[row] + (v - before);
    if (masked) {  // uniform over the thread block
      bool act = false;
      for (int s = 0; s < nsub && !act; ++s)
        act = cov[r * nsub + s] &&
              sub_live(psd, lane_done, row, s, nsub, lanes, floor);
      if (!act) continue;
    }
    const long long e = r * TILE + tid;
    const bool ve = valid[e];
    const int sv = ve ? src[e] : -1;
    // the map's per-edge operand: aux[src] for the families that divide by
    // it, the weight for the others
    const float par = !ve ? 0.0f : reads_aux ? aux[sv] : w[e];
    s_link[tid] = ve ? link[e] : 0;  // a valid slot's link; 0 for the others
    // L rounds per warp, uniform over it: element q of the warp's 32 x L
    // messages is lane q % L of its slot q / L
    const int wl = tid & 31;
    float* wmsg = s_msg + (tid - wl) * stride;
    for (int q = wl; q < 32 * lanes; q += 32) {
      const int j = q / lanes, l = q - j * lanes;
      const int sj = __shfl_sync(0xffffffffu, sv, j);
      const float pj = __shfl_sync(0xffffffffu, par, j);
      if (sj >= 0)
        wmsg[j * stride + l] =
            edge_map(prog, values[(long long)sj * lanes + l], pj, pj);
    }
    __syncthreads();
    // per (head, lane): the partial starts from the identity and adds the
    // run's messages in slot order
    for (int q = tid; q < TILE * lanes; q += TILE) {
      const int j = q / lanes, l = q - j * lanes;
      const int lj = s_link[j];
      if (!(lj & LINK_HEAD)) continue;
      float acc = merge(prog, ident, s_msg[j * stride + l]);
      for (int k = lj & LINK_NEXT; k; k = s_link[k - 1] & LINK_NEXT)
        acc = merge(prog, acc, s_msg[(k - 1) * stride + l]);
      part[r * TILE * lanes + q] = acc;
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

// Lane fold: sweep_fold over the lanes, one thread per destination. A thread
// folds LANE_GROUP lanes at once in registers, so a hub's chain of partials
// is walked once per group of lanes, in tile order for every lane; then each
// lane of the group is applied, written and reduced by kernel 1's tree.
__global__ void __launch_bounds__(MAX_BLOCK) lane_sweep_fold(
    const float* __restrict__ part, const int32_t* __restrict__ heads,
    const int32_t* __restrict__ hlo, const int32_t* __restrict__ hhi,
    const float* values_in, float* values_out,
    const float* __restrict__ vconst, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ lane_done,
    int c, int lanes, int n_live, int prog, float ident, float d, float cst,
    int masked, int nsub, float floor, int first, int last,
    float* __restrict__ oldbuf, float* psd, float* __restrict__ dmax) {
  __shared__ float s_sum[2 * MAX_BLOCK];
  __shared__ float s_max[2 * MAX_BLOCK];
  __shared__ uint8_t s_act[MAX_BLOCK];
  const int slot = blockIdx.x;
  if (!ok[slot]) return;  // uniform over the thread block
  const int tid = threadIdx.x;
  const int row = rows[slot];
  const long long base = (long long)row * c;
  const int sub = c / nsub;
  int sub_p2 = 1;
  while (sub_p2 < sub) sub_p2 <<= 1;
  // the slot's mask, from psd[row] as it stands at entry (read before this
  // block writes psd[row] below)
  for (int s = tid; s < nsub; s += blockDim.x)
    s_act[s] = !masked || sub_live(psd, lane_done, row, s, nsub, lanes, floor);
  __syncthreads();
  const int my_sub = tid < c ? tid / sub : 0;
  const long long v = base + tid;
  const bool upd = tid < c && v < n_live && s_act[my_sub];
  const int h0 = upd ? hlo[v] : 0, h1 = upd ? hhi[v] : 0;
  const int width = nsub * sub_p2;  // <= 2 * blockDim.x
  for (int l0 = 0; l0 < lanes; l0 += LANE_GROUP) {
    const int nl = min(LANE_GROUP, lanes - l0);
    float agg[LANE_GROUP];
#pragma unroll
    for (int k = 0; k < LANE_GROUP; ++k) agg[k] = ident;
    if (upd) {
      // keep LANE_AHEAD heads' partials in flight, then add them in order
      int i = h0;
      for (; i + LANE_AHEAD <= h1; i += LANE_AHEAD) {
        float p[LANE_AHEAD][LANE_GROUP];
#pragma unroll
        for (int j = 0; j < LANE_AHEAD; ++j) {
          const float* pr = part + (long long)heads[i + j] * lanes + l0;
#pragma unroll
          for (int k = 0; k < LANE_GROUP; ++k) p[j][k] = k < nl ? pr[k] : ident;
        }
#pragma unroll
        for (int j = 0; j < LANE_AHEAD; ++j)
#pragma unroll
          for (int k = 0; k < LANE_GROUP; ++k)
            agg[k] = merge(prog, agg[k], p[j][k]);
      }
      for (; i < h1; ++i) {
        const float* pr = part + (long long)heads[i] * lanes + l0;
#pragma unroll
        for (int k = 0; k < LANE_GROUP; ++k)
          if (k < nl) agg[k] = merge(prog, agg[k], pr[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < LANE_GROUP; ++k) {
      if (k >= nl) break;  // uniform over the thread block
      const int l = l0 + k;
      float delta = 0.0f;
      if (tid < c) {
        const long long at = v * lanes + l;
        const float old = values_in[at];
        float nw = old;
        if (first && !last) oldbuf[tid * lanes + l] = old;
        if (upd) {
          nw = lane_apply(prog, old, agg[k], vconst, at, d, cst);
          if (last)
            delta = sd_delta(prog, first ? old : oldbuf[tid * lanes + l], nw);
        }
        values_out[at] = nw;
      }
      if (!last) continue;  // uniform over the thread block
      // kernel 1's per-sub-range pairwise tree, for lane l
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
      if (tid < nsub && s_act[tid]) {  // masked ranges keep psd and dmax
        const long long at = ((long long)row * nsub + tid) * lanes + l;
        long long live = (long long)n_live - (base + (long long)tid * sub);
        live = live < 1 ? 1 : (live > sub ? sub : live);
        psd[at] = __fdiv_rn(s_sum[tid * sub_p2], (float)live);
        dmax[at] = s_max[tid * sub_p2];
      }
      __syncthreads();  // the next lane reuses s_sum and s_max
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

// One lane launch pair on `stream` (kernels 1l/1lm). Returns 0, or the
// cudaError_t of the first call that failed. With masked == 0, cov and
// lane_done are not read and nsub is 1.
extern "C" int lane_block_sweep_launch(
    const void* src, const void* w, const void* valid, const void* link,
    const void* values_in, void* values_out, const void* vconst,
    const void* aux, const void* tile_start, const void* tile_cnt,
    const void* heads, const void* hlo, const void* hhi, const void* rows,
    const void* ok, const void* cov, const void* lane_done, int nslots,
    int tile_grid, int fold_threads, int c, int lanes, int n_live, int prog,
    int masked, int nsub, float ident, float d, float cst, float floor,
    int first, int last, void* part, void* oldbuf, void* psd, void* dmax,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the tile pass's static arrays take 36 KB, so its lane messages may need
  // dynamic shared memory past 48 KB: raise the limit once per device
  static int smem_set[64] = {0};
  const int smem = TILE * (lanes | 1) * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_set[dev] < smem) {
    err = cudaFuncSetAttribute(lane_sweep_tiles,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  lane_sweep_tiles<<<tile_grid, TILE, smem, st>>>(
      (const int32_t*)src, (const float*)w, (const uint8_t*)valid,
      (const int32_t*)link, (const float*)values_in, (const float*)aux,
      (const int32_t*)tile_start, (const int32_t*)tile_cnt,
      (const int32_t*)rows, (const uint8_t*)ok, (const uint8_t*)cov,
      (const float*)psd, (const uint8_t*)lane_done, nslots, lanes, prog,
      ident, masked, nsub, floor, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lane_sweep_fold<<<nslots, fold_threads, 0, st>>>(
      (const float*)part, (const int32_t*)heads, (const int32_t*)hlo,
      (const int32_t*)hhi, (const float*)values_in, (float*)values_out,
      (const float*)vconst, (const int32_t*)rows, (const uint8_t*)ok,
      (const uint8_t*)lane_done, c, lanes, n_live, prog, ident, d, cst,
      masked, nsub, floor, first, last, (float*)oldbuf, (float*)psd,
      (float*)dmax);
  return (int)cudaGetLastError();
}

extern "C" const char* block_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
