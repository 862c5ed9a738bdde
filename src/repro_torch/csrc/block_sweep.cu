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
// lanes not done (lane_done, (L,)) of psd[row, s, l] clears the floor. The
// lane sweep is in place (the query service's only form).
// Bound: bytes. Each input read once: 9 B of tile row per needed edge slot
// (4 B more of w for k_sssp), the values (4L B per vertex) and aux (4 B per
// vertex, personalized PageRank only); 4L B written per active vertex, and
// its vconst read for personalized PageRank. A kernel that caches nothing
// across slots reads a value row per needed slot instead: 4L B, one 32-byte
// L2 sector at L = 8, as kernel 1's 4 B gather is one sector.
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
// The lane kernel, lane_sweep<PROG> (1l and 1lm), is one launch per call of
// the same shape, LANE_WARPS warps per block:
//   0. Masks (1lm), from psd as it stands at entry: a one-slot call's mask is
//      derived by warp 0 of every block into shared memory (the folding
//      block derives it before it writes psd[row]); a call of several slots
//      derives each slot's mask once, a warp per slot, into the scratch and
//      meets at the grid barrier before any block reads them. A slot whose
//      mask is empty owns no tiles; a tile whose coverage misses the mask
//      costs its tinfo and cov reads (S lanes of the warp test S sub-ranges).
//   1. Tiles, a warp each, from the slate's tile prefix: the tile's sources
//      (and w for k_sssp, aux[src] for personalized PageRank) staged in run
//      order in the warp's shared memory, all of a thread's loads issued
//      first; then the value rows gathered coalesced, neighbouring threads on
//      neighbouring lanes of a row (float4 where L is a multiple of 4, else
//      a float at a time). A whole tile's messages take TILE x L floats, 64 KB at
//      L = 32, so the warp takes its tile in chunks of `chunk` positions
//      with chunk x (L | 1) <= LANE_MSG floats (128 at L = 8, 32 at L = 32;
//      the odd stride spreads a chunk's lanes over the banks), one batch of
//      LANE_GATHER loads a thread; the next chunk's batch is in flight while
//      a thread per (run, lane) folds the chunk, the runs read by shuffles
//      from a window of 64 that the warp loads 32 at a time. A run that goes
//      on past the chunk leaves its partial in a carry (two buffers of L
//      floats, by chunk parity) that the next chunk's fold starts from, so
//      every (run, lane) is still one left fold in slot order. The tile rows
//      are read evict-first, leaving L2 to the values (64 MB at L = 8 and
//      n = 2^21: more than L2 holds, so most row gathers reach DRAM) and the
//      partials. Chunks rather than
//      warps per block chosen by L: the footprint does not depend on L (two
//      blocks of 8 warps per SM at any L), so one occupancy figure per
//      program holds for every lane count.
//   2. The fold of each slot (a several-slot call deals the slots from a
//      counter, so that the block that takes a hub slot takes no more), in
//      groups of `group` lanes (all L lanes where shared memory holds their
//      delta trees: L <= 9 at C = 512): a thread per destination folds its
//      partials from the identity for the group's lanes, 8 at a time in
//      registers from vector loads, two partials ahead; a destination of
//      more than LONG_SPAN partials goes to a warp, which stages batches of
//      LONG_FLOATS / L partials (all L lanes, coalesced) through shared
//      memory, the next batch loading while lanes t < group run lane t's
//      chain over the last one in tile order. Then apply, the writes, and the
//      deltas of the group's lanes through kernel 1's tree, every lane of a
//      level at once, each level visiting only the entries it adds into.
// The host computes vw, chunk and group (kernels/block_sweep.py lane_shape),
// and the CPU tests re-enact the chunks, carries and chains from them.
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
#define LANE_WARPS 8
#define LANE_THREADS (LANE_WARPS * 32)
#define LANE_GATHER 8
#define LANE_MSG 1152
#define LONG_FLOATS 1024
// a lane warp's shared memory: sources and operands of a tile, a chunk's
// messages, the two carries
#define LANE_WARP_FLOATS (2 * TILE + LANE_MSG + 2 * MAX_LANES)
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

// apply of the lane families: personalized PageRank restarts into vc, the
// vertex's vconst (loaded for that family alone); the min families are
// kernel 1's.
__device__ __forceinline__ float lane_apply(int prog, float old, float agg,
                                            float vc, float d, float omd) {
  if (prog == PPR) return __fmaf_rn(omd, vc, __fmul_rn(d, agg));
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

// Inclusive prefix of the slate's tile counts tiles(s) in s_pre, by NT
// threads: each scans a run of `per` slots, then the run totals are scanned
// across the block. Returns the slate's tile total.
template <int NT, typename Tiles>
__device__ __forceinline__ int slate_prefix(Tiles tiles, int nslots,
                                            int* s_pre, int* s_tot) {
  const int tid = threadIdx.x;
  const int per = (nslots + NT - 1) / NT;
  const int beg = min(tid * per, nslots), end = min(beg + per, nslots);
  int run = 0;
  for (int s = beg; s < end; ++s) {
    run += tiles(s);
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
  unsigned int* sync;    // [0] blocks arrived (0 between calls), [1] epoch;
                         // lanes: [2] slots dealt, [3] blocks done (0, 0)
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

// One lane call's arguments, by value: t holds the tiles with the lane
// scratch's part, oldbuf and sync, and this call's aux.
struct LaneCall {
  SweepTiles t;
  float* vals;                // (values_len, L), swept in place
  const float* vconst;        // (values_len, L)
  const int32_t* rows;
  const uint8_t* ok;
  const uint8_t* done;        // lane_done (L,)
  unsigned int* mask;         // scratch: each slot's mask (several slots)
  float* psd;                 // (P, S, L)
  float* dmax;
  int nslots, n_live, masked, nsub, first, last;
  int lanes, vw, chunk, group;  // lane_shape: vector width, chunk, lane group
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

// Thread 0's arrival for its block at the counter sync[0], which nblk blocks
// reach once each: returns whether its block came last, and leaves the
// counter at 0 for the next arrival. With `wait` every block waits there
// until the last one has arrived (a grid barrier: every block resident). The
// block's writes are ordered before thread 0's release by a __syncthreads
// before the call (a release is cumulative); the acquire on the other side
// orders every other block's before this block's reads after the next one.
__device__ bool arrive(unsigned int* sync, unsigned int nblk, bool wait) {
  const unsigned int epoch = ld_acquire(sync + 1);
  fence_acq_rel();
  const bool last = atomicAdd(sync, 1u) == nblk - 1;
  if (last) sync[0] = 0;  // for the next arrival
  if (wait) {
    if (last) {
      st_release(sync + 1, epoch + 1);
    } else {
      unsigned int polls = 0;
      while (ld_acquire(sync + 1) == epoch) {
        __nanosleep(64);
        if (++polls == (1u << 26)) __trap();  // never hang the card
      }
    }
  }
  fence_acq_rel();
  return last;
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
  const int total = slate_prefix<SWEEP_THREADS>(
      [&](int s) { return p.ok[s] ? p.t.tile_cnt[p.rows[s]] : 0; }, p.nslots,
      s_pre, s_tot);
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
  __syncthreads();
  if (threadIdx.x == 0) s_last = arrive(p.t.sync, nblk, barrier);
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

// VW floats of a lane row: through the read-only path (the values, written
// only after the tile pass of a launch), or through L2 (the partials, written
// by other blocks of the same launch).
template <int VW> struct Row;
template <> struct Row<1> {
  using T = float;
  static __device__ __forceinline__ T ld(const float* a) { return __ldg(a); }
  static __device__ __forceinline__ T ldcg(const float* a) {
    return __ldcg(a);
  }
  static __device__ __forceinline__ float at(const T& x, int) { return x; }
};
template <> struct Row<4> {
  using T = float4;
  static __device__ __forceinline__ T ld(const float* a) {
    return __ldg(reinterpret_cast<const float4*>(a));
  }
  static __device__ __forceinline__ T ldcg(const float* a) {
    return __ldcg(reinterpret_cast<const float4*>(a));
  }
  static __device__ __forceinline__ float at(const T& x, int c) {
    return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
  }
};

// Slot mask of block `row` by one warp (masked lane form): bit s is set when
// the max over the lanes not done of psd[row, s, :] clears the floor; lane s
// tests sub-range s. Uniform over the warp.
__device__ __forceinline__ unsigned int lane_mask(const LaneCall& p, int row) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  if (lane < p.nsub) {
    const float* q = p.psd + ((long long)row * p.nsub + lane) * p.lanes;
    float mx = p.done[0] ? 0.0f : q[0];
    for (int l = 1; l < p.lanes; ++l) mx = fmaxf(mx, p.done[l] ? 0.0f : q[l]);
    live = mx >= p.floor;
  }
  return __ballot_sync(0xffffffffu, live);
}

// Whether tile r meets the mask: lane s tests sub-range s. Uniform over the
// warp.
__device__ __forceinline__ bool tile_meets(const LaneCall& p, long long r,
                                           unsigned int mask) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < p.nsub && ((mask >> lane) & 1u) &&
                    p.t.cov[r * p.nsub + lane];
  return __any_sync(0xffffffffu, mine);
}

// acc folded over m[lo * stride], ..., m[(hi - 1) * stride] left to right.
template <int PROG>
__device__ __forceinline__ float fold_strided(float acc, const float* m,
                                              int stride, int lo, int hi) {
  int j = lo;
  for (; j + 4 <= hi; j += 4) {
    const float a = m[j * stride], b = m[(j + 1) * stride],
                c = m[(j + 2) * stride], d = m[(j + 3) * stride];
    acc = merge(PROG, merge(PROG, merge(PROG, merge(PROG, acc, a), b), c), d);
  }
  for (; j < hi; ++j) acc = merge(PROG, acc, m[j * stride]);
  return acc;
}

// A warp's window on a tile's run table: runs 32 b .. 32 b + 63, run
// 32 b + t and 32 b + 32 + t in lane t, each loaded once, coalesced.
struct RunWindow {
  int b;
  int2 lo, hi;
};

__device__ __forceinline__ int2 window_load(const LaneCall& p, long long base,
                                            int nr, int k) {
  return k < nr ? __ldg(p.t.runs + base + k) : make_int2(0x7fffffff, 0);
}

// Run j (32 b <= j < 32 b + 64) of the window: its first position and its
// partial, by shuffles (every lane of the warp takes part).
__device__ __forceinline__ int2 window_run(const RunWindow& w, int j) {
  const int rel = j - 32 * w.b, src = rel & 31;
  const int2 a = make_int2(__shfl_sync(0xffffffffu, w.lo.x, src),
                           __shfl_sync(0xffffffffu, w.lo.y, src));
  const int2 c = make_int2(__shfl_sync(0xffffffffu, w.hi.x, src),
                           __shfl_sync(0xffffffffu, w.hi.y, src));
  return rel < 32 ? a : c;
}

// The (run, lane) folds of chunk [c0, c1) of a tile, by one warp, a thread
// per pair: the runs from k_lo (the run that holds c0) to the last that
// starts before c1, each round's from the window (moved on as the rounds
// go). A run that started in an earlier chunk starts from its carry, one
// that goes on past c1 leaves its partial in the other carry, the others
// write their partial. Returns the run that holds c1.
template <int PROG>
__device__ __forceinline__ int lane_fold_chunk(const LaneCall& p,
                                               long long base, int nv, int nr,
                                               RunWindow& w, const float* msg,
                                               float* carry, int c0, int c1,
                                               int k_lo, int ci) {
  const int lane = threadIdx.x & 31;
  const int lanes = p.lanes, stride = lanes | 1;
  const float* cin = carry + (ci & 1) * MAX_LANES;
  float* cout = carry + ((ci + 1) & 1) * MAX_LANES;
  int pairs = 0;
  bool goes_on = false;
  if (k_lo < 32 * w.b) {  // the last chunk's final round moved past k_lo
    w.b = k_lo / 32;
    w.lo = window_load(p, base, nr, 32 * w.b + lane);
    w.hi = window_load(p, base, nr, 32 * w.b + 32 + lane);
  }
  for (int q0 = 0;; q0 += 32) {  // uniform over the warp
    // a round's runs lie in k_r .. k_r + 32 / L, their ends one further:
    // within the window while it starts in k_r - 31 .. k_r
    const int k_r = k_lo + q0 / lanes;
    while (k_r >= 32 * (w.b + 1)) {
      ++w.b;
      w.lo = w.hi;
      w.hi = window_load(p, base, nr, 32 * w.b + 32 + lane);
    }
    const int q = q0 + lane;
    const int k = k_lo + q / lanes, l = q - (q / lanes) * lanes;
    const int2 run = window_run(w, min(k, 32 * w.b + 63));
    const int end_x = window_run(w, min(k + 1, 32 * w.b + 63)).x;
    const bool mine = k < nr && run.x < c1;
    bool on = false;
    if (mine) {
      const int end = k + 1 < nr ? end_x : nv;
      on = end > c1;
      const float start = run.x < c0 ? cin[l] : p.ident;
      const float acc = fold_strided<PROG>(start, msg + l, stride,
                                           max(run.x, c0) - c0,
                                           min(end, c1) - c0);
      if (on) cout[l] = acc;
      else p.t.part[(long long)run.y * lanes + l] = acc;
    }
    const unsigned int m = __ballot_sync(0xffffffffu, mine);
    pairs += __popc(m);
    goes_on |= __any_sync(0xffffffffu, on);
    if (!(m >> 31)) break;  // the runs start in order: no later pair is mine
  }
  return k_lo + pairs / lanes - (goes_on ? 1 : 0);
}

// Tile r, by one warp, from its share of shared memory: the tile's sources
// (and the map's operand: w for k_sssp, aux[src] for personalized PageRank)
// staged in run order, then its chunks in turn: a chunk's value rows are
// loaded (LANE_GATHER vectors a thread, neighbouring threads on neighbouring
// lanes of a row) while the chunk before it folds, then mapped into msg (row
// j at j * (L | 1)) and folded.
template <int PROG, int VW>
__device__ void lane_tile(const LaneCall& p, long long r, float* wbuf) {
  constexpr bool needs_w = PROG == SSSP, needs_aux = PROG == PPR;
  constexpr int NS = TILE / 32;
  const int lane = threadIdx.x & 31;
  const int info = __ldg(p.t.tinfo + r);
  const int nv = info & TINFO_COUNT;
  const int nr = (info >> TINFO_RUNS) & TINFO_COUNT;
  const bool sorted = info & TINFO_SORTED;
  const long long base = r * TILE;
  int* s_src = reinterpret_cast<int*>(wbuf);
  float* s_par = wbuf + TILE;
  float* msg = wbuf + 2 * TILE;
  float* carry = msg + LANE_MSG;
  {  // every load of the staging issued before its first store; the tile
     // rows stream (evict first), leaving L2 to the values and partials
    int e[NS], sv[NS];
    float par[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = 32 * k + lane;
      e[k] = j >= nv ? -1 : sorted ? j : __ldcs(p.t.rslot + base + j);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      sv[k] = e[k] >= 0 ? __ldcs(p.t.src + base + e[k]) : 0;
      par[k] = e[k] >= 0 && needs_w ? __ldcs(p.t.w + base + e[k]) : 0.0f;
    }
    if (needs_aux) {
#pragma unroll
      for (int k = 0; k < NS; ++k)
        if (e[k] >= 0) par[k] = __ldg(p.t.aux + sv[k]);
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      s_src[32 * k + lane] = sv[k];
      s_par[32 * k + lane] = par[k];
    }
  }
  __syncwarp();
  const int lanes = p.lanes, stride = lanes | 1, rv = lanes / VW;
  // element u of this thread in a chunk: position j, vector m of its row
  // (without a division where L / VW divides 32)
  const bool fast = 32 % rv == 0;
  const int per = fast ? 32 / rv : 0, jl = fast ? lane / rv : 0;
  const int mv = fast ? lane - jl * rv : 0;
  typename Row<VW>::T x[LANE_GATHER];
  auto pos = [&](int u, int& j, int& m) {
    if (fast) {
      j = u * per + jl;
      m = mv;
    } else {
      const int q = 32 * u + lane;
      j = q / rv;
      m = q - j * rv;
    }
  };
  auto load = [&](int c0, int n) {
#pragma unroll
    for (int u = 0; u < LANE_GATHER; ++u) {
      int j, m;
      pos(u, j, m);
      if (j < n)
        x[u] = Row<VW>::ld(p.vals + (long long)s_src[c0 + j] * lanes + m * VW);
    }
  };
  auto map = [&](int c0, int n) {
#pragma unroll
    for (int u = 0; u < LANE_GATHER; ++u) {
      int j, m;
      pos(u, j, m);
      if (j < n) {
        const float par = s_par[c0 + j];
        float* o = msg + j * stride + m * VW;
#pragma unroll
        for (int c = 0; c < VW; ++c)
          o[c] = edge_map(PROG, Row<VW>::at(x[u], c), par, par);
      }
    }
  };
  const int chunk = p.chunk;  // at most one batch of LANE_GATHER vectors
  if (nv > 0) load(0, min(chunk, nv));
  RunWindow w{0, window_load(p, base, nr, lane),
              window_load(p, base, nr, 32 + lane)};
  int k = 0;
  for (int c0 = 0, ci = 0; c0 < nv; c0 += chunk, ++ci) {  // uniform
    const int n = min(chunk, nv - c0);
    map(c0, n);
    __syncwarp();
    if (c0 + chunk < nv) load(c0 + chunk, min(chunk, nv - c0 - chunk));
    k = lane_fold_chunk<PROG>(p, base, nv, nr, w, msg, carry, c0, c0 + n,
                              k, ci);
    __syncwarp();  // the next chunk (or tile) reuses msg, s_src and s_par
  }
}

// Destination partials part[lo .. hi) (hi - lo > LONG_SPAN), lanes
// l0 .. l0 + lg, folded from the identity by the calling warp: batches of
// LONG_FLOATS / L partials (all L lanes, coalesced, VW floats a load) pass
// through the warp's stage in shared memory, the next batch loading while
// lanes t < lg run lane l0 + t's chain over the last one in tile order.
// Lane t < lg returns lane l0 + t's aggregate.
template <int PROG, int VW>
__device__ float lane_fold_long(const LaneCall& p, int lo, int hi, int l0,
                                int lg, float* stage) {
  constexpr int PER = LONG_FLOATS / VW / 32;
  const int lane = threadIdx.x & 31, lanes = p.lanes;
  const int bp = LONG_FLOATS / lanes;  // partials per batch
  const int n = hi - lo;
  const float* src = p.t.part + (long long)lo * lanes;
  typename Row<VW>::T x[PER];
  auto load = [&](int b) {
    const int left = (n - b * bp) * lanes / VW;  // vectors from batch b on
    const float* a = src + (long long)b * bp * lanes;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int q = 32 * u + lane;
      if (q * VW < bp * lanes && q < left) x[u] = Row<VW>::ldcg(a + q * VW);
    }
  };
  load(0);
  float acc = p.ident;
  for (int b = 0; b * bp < n; ++b) {  // uniform over the warp
    const int left = (n - b * bp) * lanes / VW;
    __syncwarp();  // the last batch's chains are done with the stage
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int q = 32 * u + lane;
      if (q * VW < bp * lanes && q < left)
        *reinterpret_cast<typename Row<VW>::T*>(stage + q * VW) = x[u];
    }
    __syncwarp();
    if ((b + 1) * bp < n) load(b + 1);
    if (lane < lg)
      acc = fold_strided<PROG>(acc, stage + l0 + lane, lanes, 0,
                               min(bp, n - b * bp));
  }
  return acc;
}

// Up to 8 lanes (n) of a row at a (VW-aligned) into x (zeros past n):
// through L2 (CG: the partials, written by other blocks of the launch) or
// plainly loaded (a value row); or stored from x.
template <int VW, bool CG>
__device__ __forceinline__ void row8_ld(const float* a, int n, float* x) {
  using T = typename Row<VW>::T;
  if (VW > 1 && n % VW == 0) {
#pragma unroll
    for (int v = 0; v < 8 / VW; ++v) {
      const float* e = a + v * VW;
      const T y = v * VW >= n ? T()
                  : CG ? Row<VW>::ldcg(e) : *reinterpret_cast<const T*>(e);
#pragma unroll
      for (int c = 0; c < VW; ++c) x[v * VW + c] = Row<VW>::at(y, c);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = k >= n ? 0.0f : CG ? __ldcg(a + k) : a[k];
  }
}

template <int VW>
__device__ __forceinline__ void row8_st(float* a, int n, const float* x) {
  if (VW == 4 && n % 4 == 0) {
#pragma unroll
    for (int v = 0; v < 2; ++v)
      if (4 * v < n)
        *reinterpret_cast<float4*>(a + 4 * v) =
            make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < n) a[k] = x[k];
  }
}

// The fold of one ok slot by the whole block, lane group by lane group: a
// thread per destination folds its partials from the identity in tile order
// for the group's lanes, 8 lanes at a time in registers (a destination of
// more than LONG_SPAN partials goes to a warp), then apply and the writes;
// then the deltas of each sub-range and lane through kernel 1's pairwise
// tree, every lane of a level at once (s_sum/s_max: width x lg floats each,
// lane fastest; each level visits only the entries it adds into). Masked
// sub-ranges keep their values, psd and dmax in every lane.
template <int PROG, int VW>
__device__ void lane_fold_slot(const LaneCall& p, int slot, unsigned int mask,
                               float* s_buf, int* s_long, int* s_nlong) {
  if (!p.ok[slot]) return;  // uniform over the block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = p.t.c, nsub = p.nsub, lanes = p.lanes, sub = c / nsub;
  int sub_p2 = 1;
  while (sub_p2 < sub) sub_p2 <<= 1;
  const int width = nsub * sub_p2;
  const int row = p.rows[slot];
  const long long base = (long long)row * c;
  float* stage = s_buf + warp * LONG_FLOATS;
  float* s_tree = s_buf + LANE_WARPS * LONG_FLOATS;
  for (int l0 = 0; l0 < lanes; l0 += p.group) {
    const int lg = min(p.group, lanes - l0);
    float* s_sum = s_tree;
    float* s_max = s_tree + width * lg;
    if (p.last && sub < sub_p2) {  // the zero padding of each sub-range
      for (int q = tid; q < width * lg; q += LANE_THREADS) {
        s_sum[q] = 0.0f;
        s_max[q] = 0.0f;
      }
    }
    if (tid == 0) *s_nlong = 0;
    __syncthreads();
    // a thread per destination, each one's span loaded a destination ahead
    auto span_of = [&](int i) {
      const long long v = base + i;
      return i < c && v < p.n_live && ((mask >> (i / sub)) & 1u)
                 ? __ldg(p.t.pspan + v) : make_int2(0, 0);
    };
    int2 next = span_of(tid);
#pragma unroll 1
    for (int i = tid; i < c; i += LANE_THREADS) {
      const long long v = base + i;
      const int my_sub = i / sub;
      const bool keep = v < p.n_live && ((mask >> my_sub) & 1u);
      const int2 span = next;
      next = span_of(i + LANE_THREADS);
      float* orow = p.t.oldbuf + (long long)i * lanes + l0;
      if (p.first && !p.last)
        for (int k = 0; k < lg; ++k) orow[k] = p.vals[v * lanes + l0 + k];
      if (span.y - span.x > LONG_SPAN) {
        s_long[atomicAdd(s_nlong, 1)] = i;
        continue;
      }
      const int j0 = (my_sub * sub_p2 + (i - my_sub * sub)) * lg;
      for (int lb = 0; lb < lg; lb += 8) {
        const int nl = min(8, lg - lb);
        const float* prow = p.t.part + l0 + lb;
        const long long at = v * lanes + l0 + lb;
        float old[8], vc[8], acc[8];
        if (keep) {
          row8_ld<VW, false>(p.vals + at, nl, old);
          if (PROG == PPR) row8_ld<VW, false>(p.vconst + at, nl, vc);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) old[k] = vc[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = p.ident;
        // two partials' loads ahead of their combines
        int j = span.x;
        for (; j + 2 <= span.y; j += 2) {
          float x[2][8];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            row8_ld<VW, true>(prow + (long long)(j + u) * lanes, nl, x[u]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = merge(PROG, acc[k], x[u][k]);
        }
        for (; j < span.y; ++j) {
          float x[8];
          row8_ld<VW, true>(prow + (long long)j * lanes, nl, x);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = merge(PROG, acc[k], x[k]);
        }
        float nw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          nw[k] = lane_apply(PROG, old[k], acc[k], vc[k], p.d, p.cst);
        if (keep) row8_st<VW>(p.vals + at, nl, nw);
        if (p.last) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (k >= nl) break;
            const float dl =
                keep ? sd_delta(PROG, p.first ? old[k] : orow[lb + k], nw[k])
                     : 0.0f;
            s_sum[j0 + lb + k] = dl;
            s_max[j0 + lb + k] = dl;
          }
        }
      }
    }
    __syncthreads();
    for (int k = warp; k < *s_nlong; k += LANE_WARPS) {
      const int i = s_long[k];
      const long long v = base + i;
      const int2 span = __ldg(p.t.pspan + v);
      const float agg =
          lane_fold_long<PROG, VW>(p, span.x, span.y, l0, lg, stage);
      if (lane < lg) {
        const long long at = v * lanes + l0 + lane;
        const float old = p.vals[at];
        const float vc = PROG == PPR ? p.vconst[at] : 0.0f;
        const float nw = lane_apply(PROG, old, agg, vc, p.d, p.cst);
        p.vals[at] = nw;
        if (p.last) {
          const int my_sub = i / sub;
          const float dl = sd_delta(
              PROG,
              p.first ? old : p.t.oldbuf[(long long)i * lanes + l0 + lane],
              nw);
          const int j = (my_sub * sub_p2 + (i - my_sub * sub)) * lg + lane;
          s_sum[j] = dl;
          s_max[j] = dl;
        }
      }
    }
    __syncthreads();
    if (!p.last) continue;  // uniform over the block
    // (a power-of-two lane group indexes by shifts; h is one)
    const int lg_log = (lg & (lg - 1)) ? -1 : __ffs(lg) - 1;
    for (int h = sub_p2 >> 1, h_log = __ffs(sub_p2) - 2; h > 0;
         h >>= 1, --h_log) {
      for (int q = tid; q < nsub * h * lg; q += LANE_THREADS) {
        const int e = lg_log >= 0 ? q >> lg_log : q / lg;  // sub-range e / h
        const int lk = q - e * lg;
        const int at = (((e >> h_log) * sub_p2) + (e & (h - 1))) * lg + lk;
        s_sum[at] = __fadd_rn(s_sum[at], s_sum[at + h * lg]);
        s_max[at] = fmaxf(s_max[at], s_max[at + h * lg]);
      }
      __syncthreads();
    }
    if (tid < nsub * lg) {
      const int s = tid / lg, lk = tid - s * lg;
      if ((mask >> s) & 1u) {  // masked ranges keep psd and dmax
        const long long at = ((long long)row * nsub + s) * lanes + l0 + lk;
        long long live = (long long)p.n_live - (base + (long long)s * sub);
        live = live < 1 ? 1 : (live > sub ? sub : live);
        p.psd[at] = __fdiv_rn(s_sum[s * sub_p2 * lg + lk], (float)live);
        p.dmax[at] = s_max[s * sub_p2 * lg + lk];
      }
    }
    __syncthreads();  // the next lane group reuses the shared arrays
  }
}

// The lane kernel's phases after the masks, at vector width VW.
template <int PROG, int VW>
__device__ void lane_sweep_body(const LaneCall& p, float* s_warps,
                                int* s_pre, int* s_tot, int* s_long,
                                int* s_nlong, unsigned int* s_last,
                                unsigned int mask1) {
  const int warp = threadIdx.x >> 5;
  const bool several = p.nslots > 1;
  auto mask_of = [&](int s) -> unsigned int {
    return !p.masked ? 0xffffffffu : several ? __ldcg(p.mask + s) : mask1;
  };
  // a slot whose mask is empty owns no tiles
  const int total = slate_prefix<LANE_THREADS>(
      [&](int s) { return p.ok[s] && mask_of(s) ? p.t.tile_cnt[p.rows[s]] : 0; },
      p.nslots, s_pre, s_tot);
  // a one-slot call takes only the blocks its tiles need
  const int nblk =
      several ? (int)gridDim.x
              : max(1, min((int)gridDim.x, (total + LANE_WARPS - 1) / LANE_WARPS));
  if ((int)blockIdx.x >= nblk) return;  // uniform over the block
  float* wbuf = s_warps + warp * LANE_WARP_FLOATS;
  for (int v = blockIdx.x * LANE_WARPS + warp; v < total;
       v += nblk * LANE_WARPS) {
    const int slot = slate_owner(s_pre, p.nslots, v);
    const int before = slot ? s_pre[slot - 1] : 0;
    const long long r = (long long)p.t.tile_start[p.rows[slot]] + (v - before);
    if (p.masked && !tile_meets(p, r, mask_of(slot))) continue;  // uniform
    lane_tile<PROG, VW>(p, r, wbuf);
  }
  __syncthreads();
  if (threadIdx.x == 0) *s_last = arrive(p.t.sync, nblk, several);
  __syncthreads();
  if (!several) {
    if (*s_last)
      lane_fold_slot<PROG, VW>(p, 0, mask1, s_warps, s_long, s_nlong);
    return;
  }
  // the slots dealt from a counter (sync[2]), so that a block that folds a
  // hub slot takes no others; the last block done (sync[3]) resets both
  for (;;) {
    if (threadIdx.x == 0) *s_last = atomicAdd(p.t.sync + 2, 1u);
    __syncthreads();
    const int slot = (int)*s_last;
    __syncthreads();
    if (slot >= p.nslots) break;  // uniform over the block
    lane_fold_slot<PROG, VW>(p, slot, mask_of(slot), s_warps, s_long,
                             s_nlong);
  }
  if (threadIdx.x == 0 &&
      atomicAdd(p.t.sync + 3, 1u) == gridDim.x - 1) {
    p.t.sync[2] = 0;
    p.t.sync[3] = 0;
  }
}

// Kernels 1l and 1lm, one launch per call, an instance per program. Dynamic
// shared memory: the warps' shares (LANE_WARP_FLOATS each; the fold's stages
// and trees afterwards), then the slate prefix (nslots ints).
template <int PROG>
__global__ void __launch_bounds__(LANE_THREADS, 2) lane_sweep(const LaneCall p) {
  extern __shared__ float4 s_dyn[];
  float* s_warps = reinterpret_cast<float*>(s_dyn);
  int* s_pre = reinterpret_cast<int*>(s_warps + LANE_WARPS * LANE_WARP_FLOATS);
  __shared__ int s_tot[LANE_THREADS];
  __shared__ int s_long[MAX_BLOCK];
  __shared__ int s_nlong;
  __shared__ unsigned int s_last, s_mask;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // 0. the masks, from psd as it stands at entry
  if (!p.masked) {
    if (threadIdx.x == 0) s_mask = 0xffffffffu;
  } else if (p.nslots == 1) {
    if (warp == 0) {
      const unsigned int m = lane_mask(p, p.rows[0]);
      if (lane == 0) s_mask = m;
    }
  } else {
    for (int s = blockIdx.x * LANE_WARPS + warp; s < p.nslots;
         s += gridDim.x * LANE_WARPS) {  // uniform over the warp
      const unsigned int m = p.ok[s] ? lane_mask(p, p.rows[s]) : 0u;
      if (lane == 0) p.mask[s] = m;
    }
    __syncthreads();
    if (threadIdx.x == 0) arrive(p.t.sync, gridDim.x, true);
  }
  __syncthreads();
  if (p.vw == 4)
    lane_sweep_body<PROG, 4>(p, s_warps, s_pre, s_tot, s_long, &s_nlong,
                             &s_last, s_mask);
  else
    lane_sweep_body<PROG, 1>(p, s_warps, s_pre, s_tot, s_long, &s_nlong,
                             &s_last, s_mask);
}

constexpr int SWEEP_SMEM_MAX =
    SWEEP_WARPS * TILE * 4 + MAX_SLOTS * 4;  // dynamic, at MAX_SLOTS
constexpr int LANE_SMEM_MAX =
    LANE_WARPS * LANE_WARP_FLOATS * 4 + MAX_SLOTS * 4;  // the same for lanes

// The blocks of `kernel` resident at once on the current device, cached in
// caps[device]: a call of several slots meets at a grid barrier, so its grid
// must fit at once. Taken at the kernel's largest dynamic shared memory, so
// it holds for every slate (and, for the lane kernel, every lane count: its
// footprint does not depend on L). It costs kernel 1 no residency: at 64
// registers a thread (ptxas) the register file holds 4 blocks per SM, and so
// does shared memory at SWEEP_SMEM_MAX; the lane kernel is bounded at 2
// blocks per SM by its shared memory.
int residency(const void* kernel, int threads, int smem_max, int* caps,
              int* cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!caps[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_max);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    caps[dev] = per_sm * sms;
  }
  *cap = caps[dev];
  return 0;
}

// One launch of `kernel` for `call`: `grid` capped at what the device holds
// at once; a call of several slots is a cooperative launch (the grid barrier
// needs every block resident).
template <typename Call>
int launch(void (*kernel)(const Call), Call& call, int grid, int threads,
           int smem_max, int smem, int* caps, cudaStream_t st) {
  int cap = 0;
  const int err = residency((const void*)kernel, threads, smem_max, caps,
                            &cap);
  if (err) return err;
  const int g = max(1, min(grid, cap));
  if (call.nslots > 1) {
    void* args[] = {&call};
    return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(g),
                                            dim3(threads), args, (size_t)smem,
                                            st);
  }
  kernel<<<g, threads, smem, st>>>(call);
  return (int)cudaGetLastError();
}

template <int PROG>
int launch_sweep(SweepCall& call, int grid, cudaStream_t st) {
  static int caps[64] = {0};
  return launch(sweep<PROG>, call, grid, SWEEP_THREADS, SWEEP_SMEM_MAX,
                SWEEP_WARPS * TILE * 4 + call.nslots * 4, caps, st);
}

template <int PROG>
int launch_lane(LaneCall& call, int grid, cudaStream_t st) {
  static int caps[64] = {0};
  return launch(lane_sweep<PROG>, call, grid, LANE_THREADS, LANE_SMEM_MAX,
                LANE_WARPS * LANE_WARP_FLOATS * 4 + call.nslots * 4, caps,
                st);
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

// One lane sweep (kernel 1l, or 1lm with masked = 1) on `stream`, in place
// on `values`: one launch. `grid` as for block_sweep_launch; vw, chunk and
// group are lane_shape's (kernels/block_sweep.py), checked here against the
// shared memory they fill. `t` is the lane scratch's packing (part, oldbuf,
// sync); aux rides with the call. Returns 0 or the cudaError_t of the
// launch. With masked == 0, cov and lane_done are not read and nsub is 1.
extern "C" int lane_block_sweep_launch(
    const SweepTiles* t, void* values, const void* vconst, const void* aux,
    const void* rows, const void* ok, const void* lane_done, void* mask,
    int nslots, int grid, int lanes, int vw, int chunk, int group,
    int n_live, int prog, int masked, int nsub, float ident, float d,
    float cst, float floor, int first, int last, void* psd, void* dmax,
    void* stream) {
  int sub_p2 = 1;
  while (nsub > 0 && sub_p2 < t->c / nsub) sub_p2 <<= 1;
  if (lanes < 1 || lanes > MAX_LANES || nsub < 1 || nsub > MAX_SUB ||
      nslots < 1 || nslots > MAX_SLOTS || (vw != 1 && vw != 4) ||
      lanes % vw || chunk < 1 || chunk > TILE ||
      chunk * (lanes | 1) > LANE_MSG ||
      chunk * (lanes / vw) > 32 * LANE_GATHER || group < 1 ||
      group > lanes || (group < lanes && group % vw) ||
      2 * nsub * sub_p2 * group >
          LANE_WARPS * (LANE_WARP_FLOATS - LONG_FLOATS))
    return (int)cudaErrorInvalidValue;
  LaneCall call;
  call.t = *t;
  call.t.aux = (const float*)aux;
  call.vals = (float*)values;
  call.vconst = (const float*)vconst;
  call.rows = (const int32_t*)rows;
  call.ok = (const uint8_t*)ok;
  call.done = (const uint8_t*)lane_done;
  call.mask = (unsigned int*)mask;
  call.psd = (float*)psd;
  call.dmax = (float*)dmax;
  call.nslots = nslots;
  call.n_live = n_live;
  call.masked = masked;
  call.nsub = nsub;
  call.first = first;
  call.last = last;
  call.lanes = lanes;
  call.vw = vw;
  call.chunk = chunk;
  call.group = group;
  call.ident = ident;
  call.d = d;
  call.cst = cst;
  call.floor = floor;
  cudaStream_t st = (cudaStream_t)stream;
  switch (prog) {
    case PPR: return launch_lane<PPR>(call, grid, st);
    case SSSP: return launch_lane<SSSP>(call, grid, st);
    case BFS: return launch_lane<BFS>(call, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* block_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
