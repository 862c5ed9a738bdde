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
// slot and 4L B of vconst read per vertex. The lane tile pass takes a tile
// per 512-thread block, gathers value rows coalesced (a warp's threads on
// neighbouring lanes) into dynamic shared memory at an odd stride, and folds
// each run's L lanes in L threads side by side; the lane fold keeps one
// thread per destination and folds LANE_GROUP lanes at once in registers.
//
// Order of the sum, on any tile layout. A destination's RUN in a tile is its
// valid slots there, in slot order, wherever they lie (a streaming layout
// appends at a watermark, leaves holes where edges die, and rebuilds runs in
// bucket order). The run's partial starts from the identity and adds the
// run's messages in slot order; agg adds the partials in tile order, from the
// identity. The plain version (block_sweep_ref) defines exactly this order,
// so kernel and plain version agree bitwise. The reference's dense path is
// one sequential chain per destination over all of its edges, so a sum
// agrees with it only to the reordering roundoff (a few ulps); min/max are
// exact in any order.
//
// The run table (kernels/block_sweep.py::fold_metadata, refreshed by the
// streaming commits for every block they touch) lists, per tile row r:
//   rslot[r][j], j < nv: the tile's valid slots in RUN ORDER, sorted by
//     (destination, slot), so each run is a stretch [first, end) of j;
//   tinfo[r]: nv | nr << TINFO_RUNS | TINFO_SORTED when rslot[r][j] == j for
//     every j (the build-time CSC layout: then rslot is not read);
//   runs[r*TILE + k], k < nr: run k's first position and the index of its
//     partial. Destination v's partials are part[pspan[v].x .. pspan[v].y),
//     contiguous and in tile order, inside its block's own slot range.
//
// Skew. After the active-degree sort, block 0 of a Zipf(1.2) graph holds
// most of the edges (78% at n = 2^21), one destination there can span
// thousands of tiles, and a tile can be one run of 512 slots. One launch per
// call, `sweep`, of SWEEP_WARPS warps per block:
//   1. Tiles, a warp each, dealt over the grid's warps from the slate's tile
//      prefix (scanned in shared memory by every block, so no host sync sizes
//      the work). The warp gathers its tile's messages in run order into its
//      own shared buffer (coalesced on the build-time layout, all of a
//      lane's loads issued before their messages are formed), then a lane
//      per run folds its stretch from shared memory, a float4 at a time, and
//      writes the partial. No block-wide barrier between tiles: a long run
//      stalls one warp. The masked form tests a tile's coverage against the
//      slot's mask with S lanes at once and skips it.
//   2. The fold, after every tile of the slot: a one-slot call (a hot pass)
//      folds in the block that arrives last at a counter (one
//      fence.acq_rel.gpu by thread 0 on each side), and the others exit; a
//      call of several slots meets at a grid barrier (cooperative launch:
//      every block resident), since a slot's writes must not reach the
//      gathers of another slot of the same snapshot, then block i folds slots
//      i, i + grid, ... A thread per destination folds its partials from the
//      identity; a destination of more than LONG_SPAN partials (a hub's
//      thousands) goes to a warp, whose lanes load 32 * LONG_BATCH partials
//      at a time, the next batch in flight, and pass them to the chain in
//      order by shuffles. Then the deltas of each sub-range go through a
//      pairwise tree whose order block_sweep_ref repeats.
// A hub destination costs one chain of dependent combines over its partials
// (one per tile it spans): the floor the order sets. Each program is its own
// instance of the kernel: a combine chosen at run time puts a branch into
// every step of those chains.
//
// Bound: bytes. Per edge slot the function reads 13 B of tile row (src, w,
// valid, destination) plus a 4 B value gather and, for PageRank, a 4 B aux
// gather, and per vertex it writes 4 B; there is ~1 flop per edge. The
// kernel reads src, w only where edge_map uses it, rslot only off the sorted
// layout, and 8 B of run table per run in place of the destination.
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
#define MAX_SUB 32
#define SWEEP_WARPS 8
#define SWEEP_THREADS (SWEEP_WARPS * 32)
#define GATHER 8
#define LONG_SPAN 64
#define LONG_BATCH 8
#define LANE_GROUP 8
#define LANE_AHEAD 4
#define TINFO_RUNS 10
#define TINFO_COUNT 0x3ff
#define TINFO_SORTED 0x100000

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

// p folded over s[i .. end) (shared memory) left to right: scalars up to a
// float4 boundary, then float4s, each loaded one ahead of its fold.
__device__ __forceinline__ float fold_shared(int prog, float p, const float* s,
                                             int i, int end) {
  for (; i < end && (i & 3); ++i) p = merge(prog, p, s[i]);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  int k = i >> 2;
  const int k1 = end >> 2;
  if (k < k1) {
    float4 x = s4[k];
    for (++k; k < k1; ++k) {
      const float4 y = s4[k];
      p = merge(prog, merge(prog, merge(prog, merge(prog, p, x.x), x.y), x.z),
                x.w);
      x = y;
    }
    p = merge(prog, merge(prog, merge(prog, merge(prog, p, x.x), x.y), x.z),
              x.w);
    i = k1 << 2;
  }
  for (; i < end; ++i) p = merge(prog, p, s[i]);
  return p;
}

// Inclusive prefix of the slate's tile counts in s_pre (slots that are not ok
// own no tiles), by NT threads: each scans a run of `per` slots, then the
// run totals are scanned across the block. Returns the slate's tile total.
template <int NT>
__device__ __forceinline__ int slate_prefix(
    const int32_t* __restrict__ tile_cnt, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, int nslots, int* s_pre, int* s_tot) {
  const int tid = threadIdx.x;
  const int per = (nslots + NT - 1) / NT;
  const int beg = min(tid * per, nslots), end = min(beg + per, nslots);
  int run = 0;
  for (int s = beg; s < end; ++s) {
    run += ok[s] ? tile_cnt[rows[s]] : 0;
    s_pre[s] = run;
  }
  s_tot[tid] = run;
  __syncthreads();
  for (int off = 1; off < NT; off <<= 1) {
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

}  // namespace

// One engine's edge state and scratch, packed once with the scratch
// (kernels/block_sweep.py: _SweepTiles mirrors it field by field).
struct SweepTiles {
  const int32_t* src;
  const float* w;
  const float* aux;
  const int16_t* rslot;
  const int32_t* tinfo;
  const int2* runs;
  const int2* pspan;
  const int32_t* tile_start;
  const int32_t* tile_cnt;
  const uint8_t* cov;
  float* part;           // scratch: one partial per run
  float* oldbuf;         // scratch: a hot slot's pre-sweep values (C)
  unsigned int* sync;    // [0] blocks arrived (0 between calls), [1] epoch
  int c;                 // block size
  int ncov;              // sub-ranges of cov's rows
};

// One call's arguments, by value.
struct SweepCall {
  SweepTiles t;
  const float* vin;
  float* vout;
  const int32_t* rows;
  const uint8_t* ok;
  float* psd;
  float* dmax;
  int nslots, n_live, masked, nsub, first, last;
  float ident, d, cst, floor;
};

namespace {

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Tile r of block `row`, by one warp: messages in run order into msg (TILE
// floats of this warp's shared buffer), then a lane per run folds its
// stretch and writes its partial.
template <int PROG>
__device__ __forceinline__ void sweep_tile(const SweepCall& p, long long r,
                                           float* msg) {
  const int lane = threadIdx.x & 31;
  const int info = __ldg(p.t.tinfo + r);
  const int nv = info & TINFO_COUNT;
  const int nr = (info >> TINFO_RUNS) & TINFO_COUNT;
  const bool sorted = info & TINFO_SORTED;
  const long long base = r * TILE;
  constexpr int prog = PROG;
  constexpr bool needs_w = prog == SSSP, needs_aux = prog == PAGERANK;
  for (int j0 = 0; j0 < nv; j0 += 32 * GATHER) {  // uniform over the warp
    int e[GATHER], sv[GATHER];
    float x[GATHER], par[GATHER];
#pragma unroll
    for (int k = 0; k < GATHER; ++k) {
      const int j = j0 + 32 * k + lane;
      e[k] = j >= nv ? -1 : sorted ? j : __ldg(p.t.rslot + base + j);
    }
#pragma unroll
    for (int k = 0; k < GATHER; ++k) {
      sv[k] = e[k] >= 0 ? __ldg(p.t.src + base + e[k]) : 0;
      par[k] = e[k] >= 0 && needs_w ? __ldg(p.t.w + base + e[k]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < GATHER; ++k) {
      if (e[k] >= 0) {
        x[k] = p.vin[sv[k]];
        if (needs_aux) par[k] = __ldg(p.t.aux + sv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < GATHER; ++k)
      if (e[k] >= 0) msg[j0 + 32 * k + lane] = edge_map(prog, x[k], par[k],
                                                        par[k]);
  }
  __syncwarp();
  for (int k = lane; k < nr; k += 32) {
    const int2 run = __ldg(p.t.runs + base + k);
    const int end = k + 1 < nr ? __ldg(p.t.runs + base + k + 1).x : nv;
    p.t.part[run.y] = fold_shared(prog, p.ident, msg, run.x, end);
  }
  __syncwarp();  // the warp's next tile reuses msg
}

// Whether tile r of block `row` feeds an active sub-range (masked form):
// lane s tests sub-range s. Uniform over the warp.
__device__ __forceinline__ bool tile_live(const SweepCall& p, long long r,
                                          int row) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < p.nsub && p.t.cov[r * p.nsub + lane] &&
                    p.psd[(long long)row * p.nsub + lane] >= p.floor;
  return __any_sync(0xffffffffu, mine);
}

// Destination v's partials part[lo .. hi), hi - lo > LONG_SPAN, folded
// from the identity by the calling warp: lane l loads the partials
// lo + 32u + l of each batch of 32 * LONG_BATCH (the next batch in flight),
// and every lane runs the same chain over them in order, so every lane
// returns the result. Each group of 32 is shuffled out before its chain
// starts, so only the combines are dependent.
template <int PROG>
__device__ float fold_long(const SweepCall& p, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  const float* pp = p.t.part + lo;
  const int n = hi - lo;
  float acc = p.ident, cur[LONG_BATCH], nxt[LONG_BATCH];
#pragma unroll
  for (int u = 0; u < LONG_BATCH; ++u) {
    const int j = 32 * u + lane;
    cur[u] = j < n ? __ldcg(pp + j) : 0.0f;
  }
  for (int r0 = 0; r0 < n; r0 += 32 * LONG_BATCH) {
    const int r1 = r0 + 32 * LONG_BATCH;
#pragma unroll
    for (int u = 0; u < LONG_BATCH; ++u) {
      const int j = r1 + 32 * u + lane;
      nxt[u] = j < n ? __ldcg(pp + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LONG_BATCH; ++u) {
      const int m = n - (r0 + 32 * u);  // uniform over the warp
      float y[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) y[j] = __shfl_sync(0xffffffffu, cur[u], j);
      if (m >= 32) {
#pragma unroll
        for (int j = 0; j < 32; ++j) acc = merge(PROG, acc, y[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (j < m) acc = merge(PROG, acc, y[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < LONG_BATCH; ++u) cur[u] = nxt[u];
  }
  return acc;
}

// The fold of one ok slot by the whole block: every destination's partials
// from the identity in tile order, apply, write; then the deltas of each
// sub-range reduced by adding the upper half of its zero-padded
// power-of-two segment onto the lower half until one entry is left.
// s_sum/s_max: 2 * MAX_BLOCK floats each.
template <int PROG>
__device__ void fold_slot(const SweepCall& p, int slot, float* s_sum,
                          float* s_max, int* s_long, int* s_nlong) {
  if (!p.ok[slot]) return;  // uniform over the block
  const int tid = threadIdx.x;
  const int c = p.t.c, nsub = p.nsub;
  const int row = p.rows[slot];
  const long long base = (long long)row * c;
  const int sub = c / nsub;
  int sub_p2 = 1;
  while (sub_p2 < sub) sub_p2 <<= 1;
  const int width = nsub * sub_p2;  // <= 2 * c
  for (int i = tid; i < width; i += SWEEP_THREADS) {
    s_sum[i] = 0.0f;
    s_max[i] = 0.0f;
  }
  if (tid == 0) *s_nlong = 0;
  __syncthreads();
  // a thread per destination; the long ones are listed for the warps
  for (int i = tid; i < c; i += SWEEP_THREADS) {
    const long long v = base + i;
    const int my_sub = i / sub;
    // read before this block writes psd[row] below (after __syncthreads)
    const bool act =
        !p.masked || p.psd[(long long)row * nsub + my_sub] >= p.floor;
    const float old = p.vin[v];
    if (p.first && !p.last) p.t.oldbuf[i] = old;  // a hot slot's values
    if (v < p.n_live && act) {
      const int2 span = __ldg(p.t.pspan + v);
      if (span.y - span.x > LONG_SPAN) {
        s_long[atomicAdd(s_nlong, 1)] = i;
        continue;
      }
      float agg = p.ident;
      for (int j = span.x; j < span.y; ++j)
        agg = merge(PROG, agg, __ldcg(p.t.part + j));
      const float nw = apply(PROG, old, agg, p.d, p.cst);
      p.vout[v] = nw;
      if (p.last) {
        const float dl = sd_delta(PROG, p.first ? old : p.t.oldbuf[i], nw);
        const int j = my_sub * sub_p2 + (i - my_sub * sub);
        s_sum[j] = dl;
        s_max[j] = dl;
      }
    } else {
      p.vout[v] = old;
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int k = tid >> 5; k < *s_nlong; k += SWEEP_WARPS) {
    const int i = s_long[k];
    const long long v = base + i;
    const int2 span = __ldg(p.t.pspan + v);
    const float agg = fold_long<PROG>(p, span.x, span.y);
    if (lane == 0) {
      const float old = p.vin[v];
      const float nw = apply(PROG, old, agg, p.d, p.cst);
      p.vout[v] = nw;
      if (p.last) {
        const int my_sub = i / sub;
        const float dl = sd_delta(PROG, p.first ? old : p.t.oldbuf[i], nw);
        const int j = my_sub * sub_p2 + (i - my_sub * sub);
        s_sum[j] = dl;
        s_max[j] = dl;
      }
    }
  }
  if (!p.last) {
    __syncthreads();  // the next slot reuses the shared arrays
    return;
  }
  __syncthreads();
  for (int h = sub_p2 >> 1; h > 0; h >>= 1) {
    for (int i = tid; i < width; i += SWEEP_THREADS) {
      if ((i & (sub_p2 - 1)) < h) {
        s_sum[i] = __fadd_rn(s_sum[i], s_sum[i + h]);
        s_max[i] = fmaxf(s_max[i], s_max[i + h]);
      }
    }
    __syncthreads();
  }
  if (tid < nsub) {
    const long long at = (long long)row * nsub + tid;
    if (!p.masked || p.psd[at] >= p.floor) {  // masked ranges keep psd, dmax
      long long live = (long long)p.n_live - (base + (long long)tid * sub);
      live = live < 1 ? 1 : (live > sub ? sub : live);
      p.psd[at] = __fdiv_rn(s_sum[tid * sub_p2], (float)live);
      p.dmax[at] = s_max[tid * sub_p2];
    }
  }
  __syncthreads();  // the next slot reuses the shared arrays
}

// Kernels 1 and 1m, one launch per call, an instance per program (a combine
// chosen at run time costs a branch per message). Dynamic shared memory:
// the warps' message buffers (SWEEP_WARPS * TILE floats, the fold's s_sum
// and s_max afterwards), then the slate prefix (nslots ints).
template <int PROG>
__global__ void __launch_bounds__(SWEEP_THREADS, 4) sweep(const SweepCall p) {
  extern __shared__ float4 s_dyn[];
  float* s_msg = reinterpret_cast<float*>(s_dyn);
  int* s_pre = reinterpret_cast<int*>(s_msg + SWEEP_WARPS * TILE);
  __shared__ int s_tot[SWEEP_THREADS];
  __shared__ int s_long[MAX_BLOCK];
  __shared__ int s_nlong;
  __shared__ unsigned int s_last;
  const int total = slate_prefix<SWEEP_THREADS>(p.t.tile_cnt, p.rows, p.ok,
                                                p.nslots, s_pre, s_tot);
  const bool barrier = p.nslots > 1;
  // a one-slot call takes only the blocks its tiles need
  const int nblk =
      barrier ? (int)gridDim.x
              : max(1, min((int)gridDim.x,
                           (total + SWEEP_WARPS - 1) / SWEEP_WARPS));
  if ((int)blockIdx.x >= nblk) return;  // uniform over the block
  const int warp = threadIdx.x >> 5;
  float* msg = s_msg + warp * TILE;
  for (int v = blockIdx.x * SWEEP_WARPS + warp; v < total;
       v += nblk * SWEEP_WARPS) {
    const int slot = slate_owner(s_pre, p.nslots, v);
    const int before = slot ? s_pre[slot - 1] : 0;
    const int row = p.rows[slot];
    const long long r = (long long)p.t.tile_start[row] + (v - before);
    if (p.masked && !tile_live(p, r, row)) continue;  // uniform over the warp
    sweep_tile<PROG>(p, r, msg);
  }
  // The block's partials are ordered before thread 0's release by the
  // barrier (a release is cumulative); the acquire on the other side orders
  // every other block's before this block's reads.
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int epoch = ld_acquire(p.t.sync + 1);
    fence_acq_rel();
    const bool last = atomicAdd(p.t.sync, 1u) == (unsigned int)nblk - 1;
    if (last) p.t.sync[0] = 0;  // for the next call
    if (barrier) {
      if (last) {
        st_release(p.t.sync + 1, epoch + 1);
      } else {
        unsigned int polls = 0;
        while (ld_acquire(p.t.sync + 1) == epoch) {
          __nanosleep(64);
          if (++polls == (1u << 26)) __trap();  // never hang the card
        }
      }
    }
    fence_acq_rel();
    s_last = last;
  }
  __syncthreads();
  float* s_sum = s_msg;
  float* s_max = s_msg + 2 * MAX_BLOCK;
  if (!barrier) {
    if (s_last) fold_slot<PROG>(p, 0, s_sum, s_max, s_long, &s_nlong);
    return;
  }
  for (int slot = blockIdx.x; slot < p.nslots; slot += gridDim.x)
    fold_slot<PROG>(p, slot, s_sum, s_max, s_long, &s_nlong);
}

// Lane tile pass (kernels 1l/1lm): a block per tile, a thread per run-order
// position. Each warp gathers the value rows of its 32 positions with
// neighbouring threads on neighbouring lanes of a row (coalesced for any L),
// taking each position's src and map operand from its own thread by
// shuffle; then one thread per (run, lane) folds the run's stretch, so the L
// folds of a run proceed side by side and a tile's partials are written in
// one sweep.
__global__ void __launch_bounds__(TILE) lane_sweep_tiles(
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const int16_t* __restrict__ rslot, const int32_t* __restrict__ tinfo,
    const int2* __restrict__ runs, const float* __restrict__ values,
    const float* __restrict__ aux, const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_cnt, const int32_t* __restrict__ rows,
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ cov,
    const float* psd, const uint8_t* __restrict__ lane_done, int nslots,
    int lanes, int prog, float ident, int masked, int nsub, float floor,
    float* __restrict__ part) {
  __shared__ int s_pre[MAX_SLOTS];
  __shared__ int s_tot[TILE];
  extern __shared__ float s_msg[];  // TILE rows of `stride` lanes
  const int stride = lanes | 1;  // odd: lane l of all slots hits all banks
  const int tid = threadIdx.x;
  const bool reads_aux = prog == PAGERANK || prog == PPR;
  const int total =
      slate_prefix<TILE>(tile_cnt, rows, ok, nslots, s_pre, s_tot);

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
    const int info = tinfo[r];
    const int nv = info & TINFO_COUNT;
    const int nr = (info >> TINFO_RUNS) & TINFO_COUNT;
    const long long base = r * TILE;
    const bool ve = tid < nv;
    const int slot = !ve ? 0 : (info & TINFO_SORTED) ? tid : rslot[base + tid];
    const int sv = ve ? src[base + slot] : -1;
    // the map's per-edge operand: aux[src] for the families that divide by
    // it, the weight for the others
    const float par = !ve ? 0.0f : reads_aux ? aux[sv] : w[base + slot];
    // L rounds per warp, uniform over it: element q of the warp's 32 x L
    // messages is lane q % L of its position q / L
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
    // per (run, lane): the partial starts from the identity and adds the
    // run's messages in slot order
    for (int q = tid; q < nr * lanes; q += TILE) {
      const int k = q / lanes, l = q - k * lanes;
      const int2 run = runs[base + k];
      const int end = k + 1 < nr ? runs[base + k + 1].x : nv;
      float acc = ident;
      for (int j = run.x; j < end; ++j)
        acc = merge(prog, acc, s_msg[j * stride + l]);
      part[(long long)run.y * lanes + l] = acc;
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

// Lane fold: one thread per destination. A thread folds LANE_GROUP lanes at
// once in registers, so a hub's chain of partials is walked once per group
// of lanes, in tile order for every lane; then each lane of the group is
// applied, written and reduced by kernel 1's tree.
__global__ void __launch_bounds__(MAX_BLOCK) lane_sweep_fold(
    const float* __restrict__ part, const int2* __restrict__ pspan,
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
  const int2 span = upd ? pspan[v] : make_int2(0, 0);
  const int h0 = span.x, h1 = span.y;
  const int width = nsub * sub_p2;  // <= 2 * blockDim.x
  for (int l0 = 0; l0 < lanes; l0 += LANE_GROUP) {
    const int nl = min(LANE_GROUP, lanes - l0);
    float agg[LANE_GROUP];
#pragma unroll
    for (int k = 0; k < LANE_GROUP; ++k) agg[k] = ident;
    if (upd) {
      // keep LANE_AHEAD partials' lanes in flight, then add them in order
      int i = h0;
      for (; i + LANE_AHEAD <= h1; i += LANE_AHEAD) {
        float p[LANE_AHEAD][LANE_GROUP];
#pragma unroll
        for (int j = 0; j < LANE_AHEAD; ++j) {
          const float* pr = part + (long long)(i + j) * lanes + l0;
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
        const float* pr = part + (long long)i * lanes + l0;
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

constexpr int SWEEP_SMEM_MAX =
    SWEEP_WARPS * TILE * 4 + MAX_SLOTS * 4;  // dynamic, at MAX_SLOTS

// The blocks of sweep<PROG> resident at once on the device (cached per
// device): a call of several slots meets at a grid barrier, so its grid must
// fit at once. Taken at the largest dynamic shared memory, so it holds for
// every slate. It costs no residency: at 64 registers a thread (ptxas) the
// register file holds 4 blocks per SM, and so does shared memory at
// SWEEP_SMEM_MAX.
template <int PROG>
int sweep_capacity(int* cap) {
  static int caps[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!caps[dev]) {
    err = cudaFuncSetAttribute(sweep<PROG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SWEEP_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep<PROG>, SWEEP_THREADS, SWEEP_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    caps[dev] = per_sm * sms;
  }
  *cap = caps[dev];
  return 0;
}

// One launch of sweep<PROG>: `grid` capped at what the device holds at
// once; a call of several slots is a cooperative launch (the grid barrier
// needs every block resident).
template <int PROG>
int launch_sweep(SweepCall& call, int grid, cudaStream_t st) {
  int cap = 0;
  const int err = sweep_capacity<PROG>(&cap);
  if (err) return err;
  const int g = max(1, min(grid, cap));
  const int smem = SWEEP_WARPS * TILE * 4 + call.nslots * 4;
  if (call.nslots > 1) {
    void* args[] = {&call};
    return (int)cudaLaunchCooperativeKernel((const void*)sweep<PROG>, dim3(g),
                                            dim3(SWEEP_THREADS), args,
                                            (size_t)smem, st);
  }
  sweep<PROG><<<g, SWEEP_THREADS, smem, st>>>(call);
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep (kernel 1, or 1m with masked = 1) on `stream`: one launch.
// `grid` is the host's bound on the blocks the slate's tiles can use; it is
// capped at what the device holds at once. Returns 0 or the cudaError_t of
// the launch. With masked == 0, cov is not read and nsub is 1.
extern "C" int block_sweep_launch(
    const SweepTiles* t, const void* values_in, void* values_out,
    const void* rows, const void* ok, void* psd, void* dmax, int nslots,
    int grid, int n_live, int prog, int masked, int nsub, float ident,
    float d, float cst, float floor, int first, int last, void* stream) {
  SweepCall call;
  call.t = *t;
  call.vin = (const float*)values_in;
  call.vout = (float*)values_out;
  call.rows = (const int32_t*)rows;
  call.ok = (const uint8_t*)ok;
  call.psd = (float*)psd;
  call.dmax = (float*)dmax;
  call.nslots = nslots;
  call.n_live = n_live;
  call.masked = masked;
  call.nsub = nsub;
  call.first = first;
  call.last = last;
  call.ident = ident;
  call.d = d;
  call.cst = cst;
  call.floor = floor;
  cudaStream_t st = (cudaStream_t)stream;
  switch (prog) {
    case PAGERANK: return launch_sweep<PAGERANK>(call, grid, st);
    case SSSP: return launch_sweep<SSSP>(call, grid, st);
    case BFS: return launch_sweep<BFS>(call, grid, st);
    case CC: return launch_sweep<CC>(call, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One lane launch pair on `stream` (kernels 1l/1lm). Returns 0, or the
// cudaError_t of the first call that failed. With masked == 0, cov and
// lane_done are not read and nsub is 1.
extern "C" int lane_block_sweep_launch(
    const SweepTiles* t, const void* values_in, void* values_out,
    const void* vconst, const void* aux, const void* rows, const void* ok,
    const void* lane_done, int nslots, int tile_grid, int fold_threads,
    int lanes, int n_live, int prog, int masked, int nsub, float ident,
    float d, float cst, float floor, int first, int last, void* part,
    void* oldbuf, void* psd, void* dmax, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the tile pass's static arrays take 34 KB, so its lane messages may need
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
      t->src, t->w, t->rslot, t->tinfo, t->runs, (const float*)values_in,
      (const float*)aux, t->tile_start, t->tile_cnt, (const int32_t*)rows,
      (const uint8_t*)ok, t->cov, (const float*)psd,
      (const uint8_t*)lane_done, nslots, lanes, prog, ident, masked, nsub,
      floor, (float*)part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lane_sweep_fold<<<nslots, fold_threads, 0, st>>>(
      (const float*)part, t->pspan, (const float*)values_in,
      (float*)values_out, (const float*)vconst, (const int32_t*)rows,
      (const uint8_t*)ok, (const uint8_t*)lane_done, t->c, lanes, n_live,
      prog, ident, d, cst, masked, nsub, floor, first, last, (float*)oldbuf,
      (float*)psd, (float*)dmax);
  return (int)cudaGetLastError();
}

extern "C" const char* block_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
