"""Activity-based initial partitioning (paper Alg. 1, §3.2); numpy copy of
``repro.core.partition``.

The vertices are sorted by active degree (descending), dead vertices moved to
the tail, and the live prefix is chunked into fixed-size *blocks* (the paper's
cache blocks). Because the sort is a one-time permutation, every block is a
contiguous vertex range and its in-edges are a contiguous CSC range — dynamic
repartitioning later only re-labels blocks (barrier move / flag flip), never
moves vertices, matching the paper's O(n) bookkeeping claim.

Storage layouts:

  * unified tiled rows (:class:`TiledStorage`): every block's in-edges are
    chunked into fixed (TILE,)-wide tile rows, and each block owns a
    contiguous run of tile rows, so any block id is processed by one kernel
    while compute stays proportional to the block's true edge count;
  * per-group padded rows (:class:`EdgeStorage`, ``PartitionPlan.hot`` and
    ``.cold``): blocks padded to a common edge capacity per *storage group*
    (hot-born vs cold-born), the layout of the distributed engine. A group
    pays its block count times its largest block's edges.

Padding is masked with a validity bit in both layouts, so any combine
(sum/min/max) stays exact.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import degrees
from repro_torch.core.graph import Graph, permute
from repro_torch.core.metrics import block_io_bytes


@dataclasses.dataclass(frozen=True)
class EdgeStorage:
    """Padded per-block in-edge arrays for one storage group.

    Shapes: (num_blocks, capacity). ``src`` indexes the *permuted* vertex
    space; ``dst_local`` is the destination offset within the block. The
    plan's groups hold numpy arrays; the distributed engine's copy on its
    device holds the four (B, E) arrays as tensors (``block_ids`` and
    ``edges`` stay numpy).
    """

    block_ids: np.ndarray  # (B,) global block id of each row
    src: np.ndarray  # (B, E) int32
    dst_local: np.ndarray  # (B, E) int32
    w: np.ndarray  # (B, E) float32
    valid: np.ndarray  # (B, E) bool
    edges: np.ndarray  # (B,) true edge count per block

    @property
    def num_blocks(self) -> int:
        return int(self.block_ids.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.src.shape[1])


TILE = 512  # tile width of the unified layout (edge slots per tile row)


@dataclasses.dataclass(frozen=True)
class TiledStorage:
    """Unified per-block in-edge tiles: block b owns tile rows
    [tile_start[b], tile_start[b] + tile_cnt[b]).

    Shapes: (n_tiles, TILE) for the edge arrays; (num_blocks,) for the
    per-block indices. ``src`` indexes the owning graph's vertex space;
    ``dst_local`` is the destination offset within the block.
    """

    src: np.ndarray  # (n_tiles, TILE) int32
    dst_local: np.ndarray  # (n_tiles, TILE) int32
    w: np.ndarray  # (n_tiles, TILE) float32
    valid: np.ndarray  # (n_tiles, TILE) bool
    tile_start: np.ndarray  # (num_blocks,) int32
    tile_cnt: np.ndarray  # (num_blocks,) int32
    edges: np.ndarray  # (num_blocks,) true edge count per block

    @property
    def num_blocks(self) -> int:
        return int(self.tile_start.shape[0])

    @property
    def tile(self) -> int:
        return int(self.src.shape[1])


def build_tiled_storage(g: Graph, block_size: int, num_blocks: int,
                        tile: int = TILE, slack: float = 0.0,
                        spare_tiles: int = 0) -> TiledStorage:
    """Chunk every block's contiguous CSC in-edge range into tile rows.

    ``slack``/``spare_tiles`` over-provision each block's tile run beyond its
    current edge count (capacity = ceil(edges * (1 + slack) / tile) +
    spare_tiles). The extra tiles are fully masked invalid, so results are
    unchanged; the streaming subsystem appends edge inserts into them in
    place, deferring a full rebuild until a block's run overflows.
    """
    counts = np.empty(num_blocks, dtype=np.int64)
    for b in range(num_blocks):
        lo, hi = b * block_size, min((b + 1) * block_size, g.n)
        counts[b] = int(g.in_indptr[hi] - g.in_indptr[lo])
    tile_cnt = -(-counts // tile)
    if slack > 0.0 or spare_tiles > 0:
        want = np.ceil(counts * (1.0 + slack) / tile).astype(np.int64)
        tile_cnt = np.maximum(tile_cnt, want) + spare_tiles
    tile_start = np.concatenate([[0], np.cumsum(tile_cnt)[:-1]])
    n_tiles = max(int(tile_cnt.sum()), 1)

    src = np.zeros((n_tiles, tile), dtype=np.int32)
    dstl = np.zeros((n_tiles, tile), dtype=np.int32)
    w = np.zeros((n_tiles, tile), dtype=np.float32)
    valid = np.zeros((n_tiles, tile), dtype=bool)
    for b in range(num_blocks):
        lo, hi = b * block_size, min((b + 1) * block_size, g.n)
        e0, e1 = int(g.in_indptr[lo]), int(g.in_indptr[hi])
        e = e1 - e0
        if e == 0:
            continue
        t0 = int(tile_start[b]) * tile
        flat = slice(t0, t0 + e)
        src.reshape(-1)[flat] = g.in_src[e0:e1]
        w.reshape(-1)[flat] = g.in_w[e0:e1]
        dst = np.repeat(np.arange(lo, hi, dtype=np.int64),
                        np.diff(g.in_indptr[lo:hi + 1]))
        dstl.reshape(-1)[flat] = (dst - lo).astype(np.int32)
        valid.reshape(-1)[flat] = True
    return TiledStorage(src=src, dst_local=dstl, w=w, valid=valid,
                        tile_start=tile_start.astype(np.int32),
                        tile_cnt=tile_cnt.astype(np.int32),
                        edges=counts)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Everything the engine needs after one-time preprocessing."""

    graph: Graph  # permuted graph
    inv: np.ndarray  # old->new vertex map (for reporting back)
    order: np.ndarray  # new->old vertex map
    block_size: int  # C, vertices per block
    num_blocks: int  # live blocks (excludes the dead tail)
    n_live: int
    n_dead: int
    barrier_block: int  # blocks [0, barrier) born hot, [barrier, P) born cold
    unified: TiledStorage  # all blocks, one layout (row index = block id)
    ad: np.ndarray  # AD in permuted order (diagnostics)
    t1: float  # AD threshold used
    alpha: float
    # Hierarchical partitions: every block is split into `subblocks`
    # contiguous vertex ranges of sub_size = block_size / subblocks each.
    # Sub-blocks are an ACTIVITY-TRACKING granularity (per-sub-block PSD,
    # calm counters, sweep masks), not a storage granularity — the tiled
    # layout is unchanged, and subblocks = 1 is the flat plan.
    subblocks: int = 1

    @property
    def sub_size(self) -> int:
        """Vertices per sub-block (block_size / subblocks, exact)."""
        return self.block_size // self.subblocks

    # Group-padded storages are only consumed by the distributed engine (and
    # its tests); built lazily so the single-device path never pays the
    # O(blocks_in_group * group_max_edges) padding cost.
    @functools.cached_property
    def hot(self) -> EdgeStorage:
        return _build_storage(self.graph, self.group_blocks("hot"),
                              self.block_size)

    @functools.cached_property
    def cold(self) -> EdgeStorage:
        return _build_storage(self.graph, self.group_blocks("cold"),
                              self.block_size)

    def group_blocks(self, key: str) -> np.ndarray:
        """The global block ids of storage group ``key`` ('hot': born hot,
        'cold': born cold)."""
        if key == "hot":
            return np.arange(0, self.barrier_block, dtype=np.int64)
        return np.arange(self.barrier_block, self.num_blocks, dtype=np.int64)

    def group_storage(self, key: str, device) -> EdgeStorage:
        """Storage group ``key`` with its (B, E) arrays as tensors on
        ``device``: a copy of :attr:`hot`/:attr:`cold` where the host arrays
        were built or handed over (``repro_torch.interop``), else built on
        the device itself, so a multi-GB group never passes through host
        numpy."""
        host = self.__dict__.get(key)
        if host is None:
            return _build_storage(self.graph, self.group_blocks(key),
                                  self.block_size, device=device)
        return dataclasses.replace(host, **{
            f: torch.as_tensor(np.ascontiguousarray(getattr(host, f))).to(
                device) for f in ("src", "dst_local", "w", "valid")})

    @property
    def dead_start(self) -> int:
        return self.n_live

    def block_range(self, b: int) -> tuple[int, int]:
        lo = b * self.block_size
        return lo, min(lo + self.block_size, self.n_live)

    def block_bytes(self, b: int) -> int:
        """I/O proxy: bytes loaded when block b is scheduled."""
        return int(block_io_bytes(int(self.unified.edges[b]),
                                  self.block_size))


def _build_storage(g: Graph, block_ids: np.ndarray, block_size: int,
                   device=None) -> EdgeStorage:
    """Slice contiguous CSC ranges per block and pad to the group max. With
    ``device`` the (B, E) arrays are torch tensors built there (one row at a
    time from the CSC slices), else numpy arrays equal to the reference's
    field for field: capacity rounded up to 128, ``dst_local`` 0 and
    ``valid`` False in each row's tail."""
    block_ids = np.asarray(block_ids, dtype=np.int64)
    lo = block_ids * block_size
    hi = np.minimum(lo + block_size, g.n)
    counts = (g.in_indptr[hi] - g.in_indptr[lo]).astype(np.int64)
    cap = int(max(counts.max() if counts.size else 0, 1))
    # Round capacity to a lane-friendly multiple (the reference's TPU
    # tiling: 128).
    cap = int(-(-cap // 128) * 128)

    dev = torch.device("cpu" if device is None else device)
    nb = block_ids.size
    src = torch.zeros((nb, cap), dtype=torch.int32, device=dev)
    dstl = torch.zeros((nb, cap), dtype=torch.int32, device=dev)
    w = torch.zeros((nb, cap), dtype=torch.float32, device=dev)
    valid = torch.zeros((nb, cap), dtype=torch.bool, device=dev)
    for r in range(nb):
        e0, e1 = int(g.in_indptr[lo[r]]), int(g.in_indptr[hi[r]])
        e = e1 - e0
        src[r, :e] = torch.as_tensor(g.in_src[e0:e1]).to(dev)
        w[r, :e] = torch.as_tensor(g.in_w[e0:e1]).to(dev)
        # destination local offset: dst vertex - block start
        deg = torch.as_tensor(np.diff(g.in_indptr[lo[r]:hi[r] + 1])).to(dev)
        dstl[r, :e] = torch.repeat_interleave(
            torch.arange(deg.numel(), dtype=torch.int32, device=dev), deg)
        valid[r, :e] = True
    arrays = dict(src=src, dst_local=dstl, w=w, valid=valid)
    if device is None:
        arrays = {k: v.numpy() for k, v in arrays.items()}
    return EdgeStorage(block_ids=block_ids, edges=counts, **arrays)


def build_plan(g: Graph, *, block_size: int = 256, alpha: float | None = None,
               sample_frac: float = 0.1, hot_ratio: float = 0.1,
               seed: int = 0, tile_slack: float = 0.0, spare_tiles: int = 0,
               keep_dead: bool = False, subblocks: int = 1) -> PartitionPlan:
    """Alg. 1: rank by AD, split hot/cold/dead, chunk into blocks.

    ``keep_dead`` routes zero-AD vertices into the live blocks (they sort to
    the tail anyway) instead of the unscheduled dead partition — required by
    the streaming subsystem, where an isolated vertex can gain edges later
    and must already own a block slot + spare tile capacity.

    ``subblocks`` splits every block into that many equal contiguous
    sub-ranges for sub-block activity tracking (see PartitionPlan); it must
    divide ``block_size`` so every sub-block is the same size.
    """
    if subblocks < 1 or block_size % subblocks:
        raise ValueError(
            f"subblocks ({subblocks}) must be >= 1 and divide "
            f"block_size ({block_size})")
    if alpha is None:
        alpha = degrees.suggest_alpha(g)
    ad = degrees.active_degree(g, alpha)
    t1 = degrees.sampled_threshold(ad, sample_frac, hot_ratio, seed)

    dead = np.zeros(g.n, dtype=bool) if keep_dead else (ad <= 0.0)
    n_dead = int(dead.sum())
    live_order = np.argsort(-ad[~dead], kind="stable")
    live_ids = np.flatnonzero(~dead)[live_order]
    order = np.concatenate([live_ids, np.flatnonzero(dead)])
    pg, inv = permute(g, order)
    ad_perm = ad[order]

    n_live = g.n - n_dead
    num_blocks = max(-(-n_live // block_size), 1) if n_live else 0
    # Hot prefix: blocks whose FIRST vertex clears T1 (AD-descending order
    # means hotness decays along the block index).
    barrier = 0
    for b in range(num_blocks):
        if ad_perm[b * block_size] >= t1 and t1 > 0:
            barrier = b + 1
        else:
            break
    if num_blocks and barrier == 0 and n_live:
        barrier = 1  # always at least one hot block to seed the schedule

    unified = build_tiled_storage(pg, block_size, num_blocks,
                                  slack=tile_slack, spare_tiles=spare_tiles)
    return PartitionPlan(graph=pg, inv=inv, order=order, block_size=block_size,
                         num_blocks=num_blocks, n_live=n_live, n_dead=n_dead,
                         barrier_block=barrier, unified=unified, ad=ad_perm,
                         t1=t1, alpha=alpha, subblocks=subblocks)
