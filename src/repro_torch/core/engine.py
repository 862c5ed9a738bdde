"""Structure-aware iteration engine (paper §3–§4, Algorithms 1–3); port of
``repro.core.engine`` for PyTorch on a CUDA card.

The engine executes one vertex program over a :class:`PartitionPlan`:

  * hot-labelled blocks run **sequentially** within an iteration (the paper's
    asynchronous mode — each block sees the freshest values), each for a
    per-rank number of block-local Gauss-Seidel passes;
  * cold-labelled blocks run **batched** from one snapshot (the paper's
    synchronous mode);
  * the scheduler picks the top-PSD m hot + n cold blocks per iteration
    (Alg. 3) and the repartitioner re-labels blocks on a growing cadence
    (Alg. 2);
  * convergence is SUM_j PSD(j) < T2 (§4), with unvisited blocks carrying an
    UNSEEN sentinel so the whole graph is covered at least once.

Every block update goes through one hand-written CUDA kernel, the fused
block sweep (:mod:`repro_torch.kernels.block_sweep`): its unmasked form at
``subblocks = 1``, its sub-block-masked form at ``subblocks > 1``; the
query lanes of :mod:`repro_torch.serve` through its lane forms
(:func:`make_lane_processor`).

Device-resident loop (``run()``, the default). The host enqueues the
supersteps of a chunk — up to the next repartition boundary — without
reading anything back: select, both sweeps, the staleness post and the
convergence test read and write device tensors, and a device ``done`` flag
turns every superstep after convergence (or after an empty schedule) into a
no-op, so the trajectory is the reference's early exit. The iteration
count, per-block schedule counts, hot-slot counts and the sub-block
accounting live on the device and are read once per boundary, where the
host repartitions (Alg. 2 is O(P) numpy bookkeeping). ``run(fused=False)``
is the host-driven reference loop (one sync per iteration).

The reference's buffer donation becomes in-place updates here: the sweeps
write new block values, PSD and max-delta rows into the live tensors.

Staleness coupling: when block j's vertices change, downstream blocks must
become schedulable again even if their own PSD already decayed to 0. The
block->block coupling matrix is built once on the host and applied after
every superstep as a max-product matvec on the device.

Adaptive active-set execution (``EngineConfig.adaptive``, default on), as in
the reference: per-block ``calm`` counters retire blocks that stay under the
pruning floor, hot slot i runs ``max(1, hot_inner_iters >> i)`` passes, and
the dispatch width shrinks to the live active set at repartition
boundaries.

Hierarchical partitions (``EngineConfig.subblocks = S``): psd/dmax/calm
are (P, S); scheduling and repartitioning stay block-granular (block
priority = max over sub-blocks), a swept block masks the sub-ranges under
the pruning floor, and the staleness coupling is (P, P, S), so an upstream
delta re-arms only the sub-ranges that receive its edges.

Warm starts and streaming commits (``run(warm=WarmStart(...))``,
``update_edge_rows``/``update_aux``/``update_coupling_rows``) serve
:mod:`repro_torch.stream`: the commits copy the touched rows into the live
tensors in place, billing the host->device bytes as the reference does.

Tracing (``run(trace=True)``, or any run while a recorder of
:mod:`repro_torch.obs` is installed): every superstep writes one timeline row
(its counter deltas through the accounting table the boundary multiplies by,
its hot loads, the retired and UNSEEN blocks and the PSD's finite sum and
max after it) into a device buffer of the chunk's span, read at the chunk's
boundary read with the rest; ``RunResult.timeline`` holds the rows. The
loop emits ``run``, ``chunk`` and ``repartition`` spans and the rows as
``superstep`` counters into the installed recorder. A traced run is bitwise
its untraced twin, and an untraced run enqueues nothing for the timeline.

Out-of-core block tier (``EngineConfig.resident_blocks < P``): a
:class:`repro_torch.ooc.store.SpillStore` keeps at most that many blocks'
edge tile rows on the card. A host scheduler twin of the device select
(``schedule.schedule_predictor``) predicts each superstep's blocks, which
are paged in before the superstep is enqueued, so the schedule never
changes and the run is bitwise the fully resident one. Paged chunks are one
superstep each (one host read a superstep); the dispatch bucket still
changes only at fired repartition boundaries, where the store also stages
the next demand. Without a budget nothing of this runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import state as state_lib
from repro_torch.core.algorithms import LaneProgram, VertexProgram
from repro_torch.core.graph import Graph, symmetrize
from repro_torch.core.metrics import (COUNTER_FIELDS, Metrics, Timer,
                                      block_io_bytes)
from repro_torch.core.partition import (TILE, EdgeStorage, PartitionPlan,
                                        TiledStorage, build_plan)
from repro_torch.core.repartition import RepartitionState
from repro_torch.core.schedule import (Scheduler, Selection,
                                       make_device_select, pick_width,
                                       schedule_predictor, width_ladder)
from repro_torch.kernels import block_sweep as kb
from repro_torch.kernels import segment as kseg
from repro_torch.obs import trace as obs_trace
from repro_torch.ooc import prefetch as ooc_policy
from repro_torch.ooc.store import SpillStore


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    block_size: int = 256
    width: int = 8  # W = m + n (paper: worker count)
    i2: int = 4  # cold-admission cadence (paper I2)
    cold_frac: float = 0.25  # n/W; paper requires m > n
    repartition_interval: int = 4  # paper I1 (grows over time)
    repartition_growth: float = 1.5
    hot_inner_iters: int = 8  # async hot mode: block-local Gauss-Seidel
    hot_ratio: float = 0.1
    sample_frac: float = 0.1
    alpha: float | None = None  # Eq. 1 alpha; None -> suggest_alpha
    t2: float = 1e-6  # paper's default convergence threshold
    max_iterations: int = 100000
    stale_eps: float = 1e-12  # PSD above this marks downstream blocks dirty
    fused: bool = True  # device-resident superstep loop
    adaptive: bool = True  # active-set execution (False = fixed-slate)
    subblocks: int = 1  # sub-blocks per block (hierarchical activity)
    retire_after: int = 3  # consecutive sub-floor supersteps before retire
    min_width: int = 2  # narrowest dispatch-width bucket
    # out-of-core block tier: device memory as a fixed budget of resident
    # block slots. None (the default) = fully resident, no spill tier. With
    # resident_blocks < P the engine evicts cold blocks' edge tile rows to
    # the host (or spill_dir) and pages the predicted schedule back in
    # before each superstep; the budget must be >= width + 2 (the slate
    # plus the pinned pad blocks).
    resident_blocks: int | None = None
    spill_dir: str | None = None  # npz segment dir; None = host cache only
    tile_slack: float = 0.0  # spare tile capacity per block (streaming)
    spare_tiles: int = 0  # flat extra tiles per block (streaming)
    keep_dead_blocks: bool = False  # dead vertices get block slots (streaming)
    seed: int = 0


def check_config(config: EngineConfig) -> None:
    """Reject the options the kernels cannot run."""
    if not 1 <= config.width <= kb.MAX_SLOTS:
        raise ValueError(f"width must be 1..{kb.MAX_SLOTS}")
    if config.subblocks < 1 or config.block_size % config.subblocks:
        raise ValueError(f"subblocks ({config.subblocks}) must be >= 1 and "
                         f"divide block_size ({config.block_size})")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A CUDA request without a card raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class RunResult:
    values: np.ndarray  # indexed by ORIGINAL vertex id
    metrics: Metrics
    history: list  # per-iteration (or per-chunk) dicts
    host_syncs: int = 0  # device->host reads of the loop state
    # per-SUPERSTEP timeline (``run(trace=True)``; None otherwise): dicts
    # with TIMELINE_INT_COLS / TIMELINE_FLOAT_COLS plus superstep/width. The
    # counter columns sum exactly to the aggregate Metrics counters.
    timeline: list | None = None


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Re-enter convergence from a previous fixpoint (streaming re-heat).

    ``values`` is in PERMUTED order, padded to the engine's value length;
    ``psd`` carries UNSEEN for dirty (sub-)blocks and 0 or a finite bump for
    clean ones (``state.warm_psd``/``warm_psd_sub``); ``is_hot`` is the
    dirty mask (warm runs repartition in universal mode). ``calm`` seeds the
    block-local convergence counters and ``i2`` overrides the cold-admission
    cadence for this run; both are ignored when ``config.adaptive`` is off.
    """

    values: np.ndarray
    psd: np.ndarray
    is_hot: np.ndarray
    calm: np.ndarray | None = None
    i2: int | None = None


class EdgeData(NamedTuple):
    """Device-resident edge state of the tiled layout. The first six fields
    are the reference's ``EdgeData``; the last four are the sweep kernel's
    run table (``kernels.block_sweep.fold_metadata``), derived from the
    tiles, kept current by the commits and never billed as an upload."""

    src: torch.Tensor  # (n_tiles, TILE) int32
    dstl: torch.Tensor  # (n_tiles, TILE) int32
    w: torch.Tensor  # (n_tiles, TILE) float32
    valid: torch.Tensor  # (n_tiles, TILE) bool
    cov: torch.Tensor  # (n_tiles, S) bool: sub-block dst coverage per tile
    aux: torch.Tensor  # (n,) float32 per-vertex constant (e.g. out-degree)
    tile_start: torch.Tensor  # (P,) int32
    tile_cnt: torch.Tensor  # (P,) int32
    rslot: torch.Tensor  # (n_tiles, TILE) int16: valid slots in run order
    tinfo: torch.Tensor  # (n_tiles,) int32: valid slots, runs, sorted flag
    runs: torch.Tensor  # (n_tiles * TILE, 2) int32: first position, partial
    pspan: torch.Tensor  # (values_len, 2) int32: v's partials [lo, hi)


# the reference's EdgeData fields: the full upload and the commits' bytes
UPLOADED_FIELDS = ("src", "dstl", "w", "valid", "cov", "aux")


def tile_coverage(dst_local, valid, subblocks: int,
                  block_size: int | None = None) -> np.ndarray:
    """(n_tiles, S) bool: which of a block's S sub-ranges each tile's VALID
    destinations land in (numpy copy of the reference's). At S = 1 it is
    'tile has any valid slot'."""
    d = np.asarray(dst_local)
    v = np.asarray(valid, dtype=bool)
    if subblocks <= 1:
        return v.any(axis=1, keepdims=True)
    sub = block_size // subblocks
    cov = np.zeros((d.shape[0], subblocks), dtype=bool)
    ii, jj = np.nonzero(v)
    cov[ii, d[ii, jj] // sub] = True
    return cov


def edge_data(store: TiledStorage, aux, block_size: int, values_len: int,
              subblocks: int, device: torch.device) -> EdgeData:
    cnt = np.asarray(store.tile_cnt, dtype=np.int64)
    if not np.array_equal(np.asarray(store.tile_start, dtype=np.int64),
                          np.cumsum(cnt) - cnt):
        # the run table packs each block's partials in its own slot range
        raise ValueError("tile runs must be laid out in block order")

    def dev(a, dtype):
        a = np.asarray(a)
        if not a.flags.writeable:  # torch shares memory only if writable
            a = a.copy()
        # always a copy: the commits write the live tensors in place
        return torch.as_tensor(a).to(device=device, dtype=dtype, copy=True)

    dstl = dev(store.dst_local, torch.int32)
    valid = dev(store.valid, torch.bool)
    tile_start = dev(store.tile_start, torch.int32)
    tile_cnt = dev(store.tile_cnt, torch.int32)
    rslot, tinfo, runs, pspan = kb.fold_metadata(
        dstl, valid, tile_start, tile_cnt, block_size, values_len)
    return EdgeData(src=dev(store.src, torch.int32), dstl=dstl,
                    w=dev(store.w, torch.float32), valid=valid,
                    cov=dev(tile_coverage(store.dst_local, store.valid,
                                          subblocks, block_size), torch.bool),
                    aux=dev(aux, torch.float32), tile_start=tile_start,
                    tile_cnt=tile_cnt, rslot=rslot, tinfo=tinfo, runs=runs,
                    pspan=pspan)


# -- adaptive-schedule decision helpers (copies of the reference's) ----------
def inner_depths(cfg: EngineConfig, width: int) -> np.ndarray:
    """Per-slot Gauss-Seidel depth for the hot sweep, by PSD rank: slot 0
    runs the full ``hot_inner_iters``, halving per rank down to 1. Dense
    mode keeps the constant depth."""
    t = max(cfg.hot_inner_iters, 1)
    if not cfg.adaptive:
        return np.full(width, t, dtype=np.int32)
    return np.maximum(1, t >> np.minimum(np.arange(width), 30)) \
        .astype(np.int32)


def dispatch_width(cfg: EngineConfig, ladder: list[int], active: int,
                   psd_host: np.ndarray) -> int:
    """Dispatch bucket for the live active-set size, chosen by the host at
    repartition boundaries; 2x headroom while an UNSEEN wave is in flight."""
    if not cfg.adaptive:
        return cfg.width
    if bool((psd_host >= state_lib.UNSEEN).any()):
        active *= 2
    return pick_width(ladder, active)


def acct_table(plan: PartitionPlan, edge_counts: np.ndarray) -> np.ndarray:
    """(P, 4) host-side accounting row per schedule of a block: [vertices
    updated, edges processed, 1 load, bytes loaded]."""
    acct = np.zeros((plan.num_blocks, 4), dtype=np.int64)
    for b in range(plan.num_blocks):
        lo, hi = plan.block_range(b)
        e = int(edge_counts[b])
        acct[b] = (hi - lo, e, 1, block_io_bytes(e, plan.block_size))
    return acct


# -- per-superstep trace timeline --------------------------------------------
# Columns of a timeline row: the four COUNTER_FIELDS deltas, then hot
# dispatches / retired blocks / UNSEEN blocks (int64 on the device: one
# superstep may bill more than 2^31 bytes), and the block-folded finite PSD
# sum/max after the superstep (float32).
TIMELINE_INT_COLS = COUNTER_FIELDS + ("hot_loads", "retired", "unseen")
TIMELINE_FLOAT_COLS = ("psd_sum", "psd_max")


def timeline_row(superstep: int, width: int, ints, floats) -> dict:
    """One timeline row from its integer and float columns."""
    row = {"superstep": superstep, "width": width}
    row.update(zip(TIMELINE_INT_COLS, (int(v) for v in ints)))
    row.update(zip(TIMELINE_FLOAT_COLS, (float(v) for v in floats)))
    return row


def make_tiled_processor(program: VertexProgram, ed: EdgeData,
                         block_size: int, n_live: int, n_total: int,
                         subblocks: int = 1, floor: float = 0.0):
    """Block processor over the unified tiled layout, through the sweep
    kernel. Unlike the reference's functional per-block processors, both
    update in place and take a whole slate (``rows``/``ok``, (W,)):

    * ``process_one(ed, values, psd, dmax, rows, ok, out=None)`` — one pass
      over every ok slot from one snapshot of ``values`` (the cold sweep,
      and the baseline's full sweep);
    * ``process_iterated(ed, values, psd, dmax, rows, ok, t_inner)`` —
      ``t_inner`` block-local Gauss-Seidel passes of a one-slot slate (the
      hot sweep), each pass reading the previous one's writes.

    Both write the block's new values, and its (mean, max) delta at
    ``psd[row]``/``dmax[row]``; slots that are not ok write nothing. With
    ``subblocks > 1`` they run the masked kernel: each slot's mask is
    ``psd[row] >= floor`` at its entry, and the deltas are per sub-block
    ((P, S) psd/dmax; masked entries keep their values)."""
    scratch = kb.make_scratch(ed, block_size)
    kw = dict(block_size=block_size, n_live=n_live)
    if subblocks == 1:
        sweep = kb.block_sweep
    else:
        sweep = functools.partial(kb.masked_block_sweep, floor=floor)

    def process_one(ed, values, psd, dmax, rows, ok, out=None):
        if out is None:
            sweep(program, n_total, ed, values, rows, ok, psd, dmax,
                  scratch, **kw)
        else:  # the baseline's double buffer (flat blocks only)
            kb.block_sweep(program, n_total, ed, values, rows, ok, psd,
                           dmax, scratch, out=out, **kw)

    def process_iterated(ed, values, psd, dmax, rows, ok, t_inner):
        for p in range(t_inner):
            sweep(program, n_total, ed, values, rows, ok, psd, dmax,
                  scratch, first=p == 0, last=p == t_inner - 1, **kw)

    return process_one, process_iterated


def make_lane_processor(program: LaneProgram, block_size: int, n_live: int,
                        n_total: int, subblocks: int = 1,
                        floor: float = 0.0):
    """Lane-axis generalization of :func:`make_tiled_processor`, through the
    lane sweep kernel: values and ``vconst`` are (values_len, L), psd/dmax
    (P, S, L), and one pass over a block's tiles advances every lane.

    * ``process_one(ed, values, vconst, psd, dmax, rows, ok, lane_done,
      scratch)`` — one pass over every ok slot from one snapshot;
    * ``process_iterated(..., scratch, t_inner)`` — ``t_inner``
      Gauss-Seidel passes of a one-slot slate.

    With ``subblocks > 1`` each slot applies one (S,) mask shared by the
    lanes: a sub-range is live if any lane not done prices it at or over
    ``floor``. ``scratch`` comes from ``kernels.block_sweep.
    make_lane_scratch`` for the tiles of ``ed``."""
    kw = dict(block_size=block_size, n_live=n_live)
    if subblocks == 1:
        sweep = kb.lane_block_sweep
    else:
        sweep = functools.partial(kb.masked_lane_block_sweep, floor=floor)

    def process_one(ed, values, vconst, psd, dmax, rows, ok, lane_done,
                    scratch):
        sweep(program, n_total, ed, values, vconst, rows, ok, psd, dmax,
              lane_done, scratch, **kw)

    def process_iterated(ed, values, vconst, psd, dmax, rows, ok, lane_done,
                         scratch, t_inner):
        for p in range(t_inner):
            sweep(program, n_total, ed, values, vconst, rows, ok, psd, dmax,
                  lane_done, scratch, first=p == 0, last=p == t_inner - 1,
                  **kw)

    return process_one, process_iterated


def _combine_local(program: VertexProgram, msg: torch.Tensor,
                   dst_local: torch.Tensor, block_size: int,
                   layout: kseg.SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """The segmented combine of one block row (kernels 3 and 2): the
    reference's ``_combine_local(use_pallas=True)``. ``layout``/``row``
    name the storage group's kernel layout for ``dst_local``."""
    kw = dict(layout=layout, row=row)
    if program.combine == "sum":
        return kseg.edge_block_sum(msg, dst_local, block_size, **kw)
    fn = (kseg.edge_block_min if program.combine == "min"
          else kseg.edge_block_max)
    return fn(msg, dst_local, block_size, float(program.identity), **kw)


def make_block_processor(program: VertexProgram, store: EdgeStorage,
                         aux: torch.Tensor, block_size: int, n_live: int,
                         n_total: int):
    """Returns (process_one, process_iterated, gids): the pull-mode update
    for one block row of one storage group, whose (B, E) arrays are tensors
    on the device of ``aux`` (``PartitionPlan.group_storage``). The
    gather, ``edge_map``, the validity mask and ``apply`` are plain torch
    ops, as the reference computes them outside any kernel; the combine
    goes through the segmented-combine kernels, with the group's kernel
    layout (``segment_layout``) built once here. ``gids`` (host) maps a
    row to its global block id, so ``base`` is known on the host.

    * ``process_one(values, row) -> (base, new, psd, dmax)``: one pass,
      functional like the reference's;
    * ``process_iterated(values, row, t_inner)``: ``t_inner`` block-local
      Gauss-Seidel passes, each reading the previous one's writes, and the
      (mean, max) delta against the block's values before the first pass.
      It writes the passes into ``values`` in place (the reference returns
      the block and its caller writes it) and returns the same tuple, with
      ``new`` a view of the block.

    A row's padded tail (``valid`` False past its true edges) is left out,
    and with it the reference's ``where(valid, msg, identity)``: the tail's
    messages are the identity, which leaves every run partial and every
    destination's fold as it was (x + 0 = x for the sums, whose accumulator
    starts at +0 and so is never -0; min/max exactly), so a row costs its
    true edges rather than the group's capacity, with the same result
    bits."""
    src, dstl, ew = store.src, store.dst_local, store.w
    gids = np.asarray(store.block_ids, dtype=np.int64)
    dev, c = aux.device, block_size
    ends = _valid_prefix(store)
    layout = (kseg.segment_layout(dstl, c, ends) if dev.type == "cuda" and
              store.num_blocks else None)
    reads_aux = program.aux_fn is not None  # the others' edge_map ignores it
    lanes = torch.arange(c, device=dev)

    def live(base: int) -> int:
        return min(max(n_live - base, 0), c)

    def update(values, row):
        e = int(ends[row])
        e_src = src[row, :e]
        msg = program.edge_map(values.index_select(0, e_src),
                               aux.index_select(0, e_src) if reads_aux
                               else None, ew[row, :e])
        agg = _combine_local(program, msg, dstl[row, :e], c, layout, row)
        base = int(gids[row]) * c
        old = values[base:base + c]
        new = program.apply(old, agg, n_total)
        if live(base) < c:
            new = torch.where(lanes < live(base), new, old)
        return base, new

    counts: dict[int, torch.Tensor] = {}

    def deltas(base, old, new):
        delta = program.sd_delta(old, new)
        if live(base) < c:
            delta = torch.where(lanes < live(base), delta, 0.0)
        # the live count as a device scalar, made once per value: a true
        # division (torch divides by a host scalar through its reciprocal),
        # and no host-to-device copy, which would stall the queue per slot
        k = max(live(base), 1)
        if k not in counts:
            counts[k] = torch.tensor(float(k), device=dev)
        # (mean, max) per-block deltas: mean is the paper's PSD; max feeds
        # the sound staleness bound
        return kb.pairwise_sum(delta) / counts[k], delta.max()

    def process_one(values, row):
        base, new = update(values, row)
        return (base, new) + deltas(base, values[base:base + c], new)

    def process_iterated(values, row, t_inner):
        base = int(gids[row]) * c
        old = values[base:base + c].clone()
        for _ in range(t_inner):
            values[base:base + c] = update(values, row)[1]
        new = values[base:base + c]
        return (base, new) + deltas(base, old, new)

    return process_one, process_iterated, gids


def _valid_prefix(store: EdgeStorage) -> np.ndarray:
    """The rows' edge counts, (B,), checked to be exactly each row's valid
    prefix (the padded layout, also as handed over by interop)."""
    ends = np.asarray(store.edges, dtype=np.int64)
    valid = store.valid
    for r, e in enumerate(ends.tolist()):
        if not (bool(valid[r, :e].all()) and not bool(valid[r, e:].any())):
            raise ValueError(f"storage row {r}: valid is not the prefix of "
                             f"its {e} edges")
    return ends


def coupling_from_counts(block_edge_counts: np.ndarray,
                         program: VertexProgram | LaneProgram,
                         block_size: int) -> np.ndarray:
    """(P, P) staleness-coupling matrix from the block->block edge-count
    matrix W_jb (number of edges from block j's vertices into block b), or
    (P, P, S) from sub-resolved counts W_jbs."""
    w = block_edge_counts
    if program.combine == "sum":
        k = (np.minimum(w, block_size) / block_size).astype(np.float32)
        return k * np.float32(program.damping)
    return (w > 0).astype(np.float32)


def _f32(x: float) -> float:
    """A Python float rounded to f32: the value the reference's weak-typed
    scalar takes in f32 arithmetic."""
    return float(np.float32(x))


class StructureAwareEngine:
    """Paper pipeline: build plan -> iterate (schedule, process, repartition)."""

    # the reference's fixed-size commit chunks (entries per scatter); its
    # byte accounting bills whole chunks
    _ROW_CHUNK = 16  # tile rows
    _AUX_CHUNK = 256  # aux entries
    _COUPLING_CHUNK = 16  # coupling rows

    def __init__(self, graph: Graph, program: VertexProgram,
                 config: EngineConfig = EngineConfig(), device="cuda",
                 **engine_kw):
        config = self._configure(config, **engine_kw)
        check_config(config)
        dev = resolve_device(device)
        g = symmetrize(graph) if program.needs_symmetric else graph
        plan = build_plan(
            g, block_size=config.block_size, alpha=config.alpha,
            sample_frac=config.sample_frac, hot_ratio=config.hot_ratio,
            seed=config.seed, tile_slack=config.tile_slack,
            spare_tiles=config.spare_tiles,
            keep_dead=config.keep_dead_blocks, subblocks=config.subblocks)
        vals0, aux0 = program.init(g)  # original ids ...
        values0 = _init_dead(program, plan, vals0[plan.order])  # ... permuted
        # pad so every block's (base, block_size) slice is in bounds
        values_len = max(plan.num_blocks * plan.block_size, plan.graph.n)
        values0 = np.concatenate(
            [values0, np.zeros(values_len - values0.size, np.float32)])
        counts = block_coupling_counts(plan)
        self._setup(plan, program, config, dev, values0, aux0[plan.order],
                    coupling_from_counts(counts, program, plan.block_size),
                    plan.barrier_block, counts)

    @classmethod
    def from_plan(cls, plan: PartitionPlan, program: VertexProgram,
                  config: EngineConfig, values0: np.ndarray, aux: np.ndarray,
                  coupling: np.ndarray, barrier_block: int,
                  device="cuda", **engine_kw) -> "StructureAwareEngine":
        """An engine over given state (see :mod:`repro_torch.interop`):
        ``values0`` permuted, dead-initialised and padded; ``aux`` permuted;
        the (P, P) coupling matrix, (P, P, S) at S > 1; the born hot
        prefix. ``engine_kw`` are a subclass's own keyword arguments."""
        self = cls.__new__(cls)
        config = self._configure(config, **engine_kw)
        check_config(config)
        self._setup(plan, program, config, resolve_device(device),
                    np.asarray(values0, np.float32),
                    np.asarray(aux, np.float32),
                    np.asarray(coupling, np.float32), int(barrier_block))
        return self

    def _setup(self, plan, program, config, device, values0, aux, coupling,
               barrier_block, coupling_counts=None):
        self.plan, self.program, self.config = plan, program, config
        self.device = device
        self.values0 = values0
        self._values_len = values0.size
        self.barrier_block = barrier_block
        # host copies the streaming engine reads and the commits keep
        # current: permuted aux, per-block live edge counts (the accounting
        # units), and the block->block edge counts behind the coupling
        self.aux = np.array(aux, dtype=np.float32)
        self.edge_counts = np.array(plan.unified.edges, dtype=np.int64)
        self.coupling_counts = coupling_counts
        self._coupling = np.array(coupling, dtype=np.float32)
        self._coupling_dev = torch.tensor(self._coupling, device=device)
        self._setup_sweeps(aux)
        self._sweep_fns: dict = {}
        self._ladder = (width_ladder(config.width, config.min_width)
                        if config.adaptive else [config.width])
        # pad block for dispatch slots beyond the take counts (never ok)
        tile_cnt = plan.unified.tile_cnt
        self.pad_id = int(np.argmin(tile_cnt)) if tile_cnt.size else 0
        # activity state of the last completed run (the epoch-persistence
        # record; repro_torch.ooc.snapshot)
        self.last_psd: np.ndarray | None = None
        self.last_calm: np.ndarray | None = None
        self.spill = None
        if (config.resident_blocks is not None
                and config.resident_blocks < plan.num_blocks):
            self.spill = SpillStore(self, config.resident_blocks,
                                    directory=config.spill_dir)

    def _configure(self, config: EngineConfig) -> EngineConfig:
        """The configuration the engine runs with (a subclass pins fields
        here, from its own keyword arguments)."""
        return config

    def _setup_sweeps(self, aux: np.ndarray) -> None:
        """The device edge state and the block processors of the sweeps."""
        plan, config = self.plan, self.config
        self._ed = edge_data(plan.unified, aux, plan.block_size,
                             self._values_len, config.subblocks, self.device)
        self._proc = make_tiled_processor(self.program, self._ed,
                                          plan.block_size, plan.n_live,
                                          plan.graph.n, config.subblocks,
                                          _f32(self._psd_floor()))
        # the block owning each tile row (commits refresh fold metadata)
        self._row_block = np.repeat(np.arange(plan.num_blocks),
                                    plan.unified.tile_cnt)

    # -- schedule helpers ----------------------------------------------------
    def _psd_floor(self) -> float:
        """Per-block pruning floor (t2/P), shared by the scheduler's live
        test and the calm/retire counters."""
        return self.config.t2 / max(self.plan.num_blocks, 1)

    def _post(self, coupling, psd, dmax, calm):
        """Consume dmax: re-arm downstream blocks through the coupling
        (max-product matvec), then reset it; advance the calm counters.
        The outgoing signal is block-granular (the block's max sub-delta);
        with a (P, P, S) coupling the incoming bump is per sub-range."""
        eps, floor = _f32(self.config.stale_eps), _f32(self._psd_floor())
        d = torch.where(dmax > eps, dmax, 0.0)
        dblk = d.amax(dim=1)
        if coupling.dim() == 3:
            bump = (dblk[:, None, None] * coupling).amax(dim=0)
        else:
            bump = (dblk[:, None] * coupling).amax(dim=0)[:, None]
        psd = torch.maximum(psd, torch.clamp(bump, max=_f32(1e29)))
        calm = torch.where(psd < floor, calm + 1, 0).to(torch.int32)
        return psd, torch.zeros_like(dmax), calm

    def _inner_depths(self, width: int) -> np.ndarray:
        return inner_depths(self.config, width)

    def _pick_width(self, active: int, psd_host: np.ndarray) -> int:
        return dispatch_width(self.config, self._ladder, active, psd_host)

    def _active_count(self, calm_host: np.ndarray) -> int:
        if not self.config.adaptive:
            return self.plan.num_blocks
        live = np.asarray(calm_host) < self.config.retire_after
        if live.ndim == 2:
            live = live.any(axis=-1)
        return int(live.sum())

    def _subblocks_retired(self, calm_host: np.ndarray) -> int:
        if not self.config.adaptive:
            return 0
        return int((np.asarray(calm_host) >=
                    self.config.retire_after).sum())

    def _acct_table(self) -> np.ndarray:
        return acct_table(self.plan, self.edge_counts)

    # -- sweeps --------------------------------------------------------------
    def _sweeps(self, width: int):
        """(hot_sweep, cold_sweep) over a (width,) slate, both in place on
        (values, psd, dmax). Hot slots run one after another, slot i with
        its rank's inner depth, so slot i+1 sees slot i's writes; the cold
        slate is one launch reading one snapshot."""
        if width in self._sweep_fns:
            return self._sweep_fns[width]
        depths = self._inner_depths(width).tolist()
        process_one, process_iterated = self._proc

        def hot_sweep(ed, values, psd, dmax, rows, ok):
            for i in range(width):
                process_iterated(ed, values, psd, dmax, rows[i:i + 1],
                                 ok[i:i + 1], depths[i])

        def cold_sweep(ed, values, psd, dmax, rows, ok):
            process_one(ed, values, psd, dmax, rows, ok)

        self._sweep_fns[width] = (hot_sweep, cold_sweep)
        return hot_sweep, cold_sweep

    def _account(self, metrics: Metrics, ids: np.ndarray):
        p = self.plan
        for b in ids:
            lo, hi = p.block_range(int(b))
            e = int(self.edge_counts[int(b)])
            metrics.updates += hi - lo
            metrics.block_loads += 1
            metrics.bytes_loaded += block_io_bytes(e, p.block_size)
            metrics.edges_processed += e

    # -- streaming hooks -----------------------------------------------------
    @property
    def edge_state(self) -> EdgeData:
        """The live device-resident edge state (the commits update it in
        place). Across commits, take :meth:`edge_snapshot` instead."""
        return self._ed

    def edge_snapshot(self) -> EdgeData:
        """Device-side deep copy of the current edge state: all twelve
        fields, the fold metadata included, since the commits rewrite tile
        rows and metadata in place. A caller that must keep reading this
        epoch across future commits (the query service's snapshot
        isolation) copies first. O(m) device bytes, no host traffic, except
        under an out-of-core budget, where the copy's spilled holes are
        filled from the spill tier's truth and its run table refreshed
        (residency and the live state unchanged): a pinned epoch must
        survive the eviction of its blocks."""
        ed = EdgeData(*(t.clone() for t in self._ed))
        if self.spill is not None:
            ed = self.spill.materialize(ed)
        return ed

    def _copy_rows(self, targets, idx: np.ndarray, payloads,
                   chunk: int) -> int:
        """Copy ``payloads`` into ``targets`` at the (unique) ``idx``, in
        place. Returns the entry count the reference bills: its fixed-size
        chunks of ``chunk`` entries, whole."""
        i = torch.as_tensor(idx).to(self.device)
        for t, p in zip(targets, payloads):
            t.index_copy_(0, i, torch.as_tensor(
                np.ascontiguousarray(p)).to(self.device))
        return -(-idx.size // chunk) * chunk

    def fill_edge_rows(self, ed: EdgeData, rows: np.ndarray, *, src,
                       dst_local, w, valid) -> int:
        """Copy TILE ROWS into ``ed`` (the live state or a copy of it),
        recompute their coverage, and refresh the run table of the blocks
        that own them. ``rows`` are unified-tile row indices; the payloads
        the matching (len(rows), TILE) slices. Returns the billed entry
        count of :meth:`_copy_rows`."""
        c = self.plan.block_size
        cov = tile_coverage(dst_local, valid, self.config.subblocks, c)
        pk = self._copy_rows(
            (ed.src, ed.dstl, ed.w, ed.valid, ed.cov), rows,
            [np.asarray(src, np.int32), np.asarray(dst_local, np.int32),
             np.asarray(w, np.float32), np.asarray(valid, bool), cov],
            self._ROW_CHUNK)
        kb.refresh_fold_metadata(ed, c, np.unique(self._row_block[rows]))
        return pk

    def update_edge_rows(self, rows: np.ndarray, *, src, dst_local, w,
                         valid) -> int:
        """Copy updated TILE ROWS into the live EdgeData
        (:meth:`fill_edge_rows`). Returns the transferred bytes as the
        reference bills them (chunked rows + indices; the fold metadata is
        derived on the device and not billed)."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return 0
        pk = self.fill_edge_rows(self._ed, rows, src=src,
                                 dst_local=dst_local, w=w, valid=valid)
        # 4B src + 4B dst offset + 4B w + 1B valid per slot + 1B per
        # sub-block coverage bit + 4B row index
        return pk * (TILE * 13 + int(self._ed.cov.shape[1]) + 4)

    def clear_edge_rows(self, rows: np.ndarray) -> None:
        """Invalidate TILE ROWS of the live EdgeData on the device (a spill
        eviction): zero them and their coverage, and refresh the run table
        of the blocks that own them, whose runs and vertex spans then come
        out empty. Nothing crosses to the device and nothing is billed."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        ed = self._ed
        idx = torch.as_tensor(rows).to(self.device)
        for t in (ed.src, ed.dstl, ed.w, ed.valid, ed.cov):
            t.index_fill_(0, idx, 0)
        kb.refresh_fold_metadata(ed, self.plan.block_size,
                                 np.unique(self._row_block[rows]))

    def update_aux(self, idx: np.ndarray, vals: np.ndarray) -> int:
        """Copy changed per-vertex aux entries into the live EdgeData.
        Returns the transferred bytes (chunked values + indices)."""
        idx = np.asarray(idx, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float32)
        if idx.size == 0:
            return 0
        pk = self._copy_rows((self._ed.aux,), idx, [vals], self._AUX_CHUNK)
        self.aux[idx] = vals
        return pk * 8

    def update_coupling_rows(self, rows: np.ndarray,
                             row_vals: np.ndarray) -> int:
        """Replace changed ROWS of the staleness-coupling matrix (host copy
        and device). Returns the transferred bytes (chunked rows +
        indices)."""
        rows = np.asarray(rows, dtype=np.int64)
        row_vals = np.asarray(row_vals, dtype=np.float32)
        if rows.size == 0:
            return 0
        self._coupling[rows] = row_vals
        pk = self._copy_rows((self._coupling_dev,), rows, [row_vals],
                             self._COUPLING_CHUNK)
        return pk * (int(self._coupling[0].size) * 4 + 4)

    @property
    def values_nbytes(self) -> int:
        """Bytes of one padded warm-values upload."""
        return int(self._values_len * 4)

    def full_upload_bytes(self) -> int:
        """Host->device bytes of a FULL dynamic-state refresh (the
        reference's EdgeData fields + coupling + warm values): the
        denominator of the streaming ``upload_frac``."""
        edge_bytes = sum(t.numel() * t.element_size() for t in
                         (getattr(self._ed, f) for f in UPLOADED_FIELDS))
        return int(edge_bytes + self._coupling.nbytes + self._values_len * 4)

    def pad_values(self, values_perm: np.ndarray) -> np.ndarray:
        """Pad a permuted (n,) value vector to the engine's value length."""
        pad = self._values_len - values_perm.shape[0]
        if pad:
            return np.concatenate(
                [values_perm, np.zeros(pad, dtype=values_perm.dtype)])
        return values_perm

    def prewarm_buckets(self) -> list[int]:
        """The reference compiles one fused chunk per dispatch-width bucket
        here; the kernel takes any slate, so there is nothing to compile.
        On a card this builds and loads the sweep kernel, so no streaming
        batch pays for it. Returns the width ladder."""
        if self.device.type == "cuda":
            kb.load_library()
        return list(self._ladder)

    # -- main loop ----------------------------------------------------------
    def run(self, max_iterations: int | None = None,
            fused: bool | None = None, warm: WarmStart | None = None,
            trace: bool | None = None) -> RunResult:
        """Run to convergence. ``fused`` overrides ``config.fused``: True =
        device-resident chunked loop (host reads only at repartition
        boundaries), False = host-driven reference loop (one read per
        iteration). ``warm`` re-enters from a previous fixpoint with only
        the dirty (sub-)blocks re-heated.

        ``trace`` captures the per-superstep timeline
        (``RunResult.timeline``) and emits the superstep counters into the
        installed :mod:`repro_torch.obs` recorder; ``None`` (the default)
        traces exactly when one is installed. The run/chunk/repartition
        spans go to an installed recorder either way."""
        fused = self.config.fused if fused is None else fused
        if trace is None:
            trace = obs_trace.current() is not None
        with obs_trace.span("run", cat="engine", fused=bool(fused),
                            warm=warm is not None) as sp:
            res = (self._run_fused(max_iterations, warm, trace) if fused
                   else self._run_host(max_iterations, warm, trace))
            sp.set(iterations=res.metrics.iterations,
                   converged=res.metrics.converged)
        return res

    def _sub2d(self, a: np.ndarray) -> np.ndarray:
        """A per-block (P,) state vector in the engine's (P, S) layout,
        replicated across sub-blocks; (P, S) input passes through."""
        a = np.asarray(a)
        if a.ndim == 2:
            return a
        return np.repeat(a[:, None], self.config.subblocks, axis=1)

    def _start_state(self, warm: WarmStart | None):
        """(values, psd, psd host copy, rep, calm, i2): the start state of a
        run. Cold runs start fully active at the configured cadence; warm
        runs may seed calm counters and a delta-scaled cadence (ignored
        when adaptive is off)."""
        cfg, p, dev = self.config, self.plan, self.device
        calm0 = np.zeros((p.num_blocks, cfg.subblocks), dtype=np.int32)
        if warm is None:
            mode = ("barrier" if self.program.monotone_cooling
                    else "universal")
            rep = RepartitionState.create(
                p.num_blocks, self.barrier_block, mode,
                interval=cfg.repartition_interval,
                growth=cfg.repartition_growth)
            psd0 = state_lib.init_psd(p.num_blocks, cfg.subblocks)
            values, i2 = self.values0, cfg.i2
        else:
            if warm.values.shape[0] != self._values_len:
                raise ValueError(
                    "warm values must be permuted + padded "
                    f"({warm.values.shape[0]} != {self._values_len})")
            rep = RepartitionState.warm(
                warm.is_hot, interval=cfg.repartition_interval,
                growth=cfg.repartition_growth)
            if cfg.adaptive and warm.calm is not None:
                calm0 = self._sub2d(warm.calm).astype(np.int32)
            i2 = (warm.i2 if cfg.adaptive and warm.i2 is not None
                  else cfg.i2)
            psd0 = self._sub2d(np.asarray(warm.psd, dtype=np.float32)) \
                .astype(np.float32)
            values = np.asarray(warm.values, dtype=np.float32)
        return (torch.tensor(values, device=dev),
                torch.tensor(psd0, device=dev), psd0, rep, calm0, int(i2))

    def _timeline_row(self, acct_dev, hot_rows, hot_ok, cold_rows, cold_ok,
                      psd, calm, row_i, row_f) -> None:
        """Write one superstep's timeline row into ``row_i``/``row_f`` (views
        of the chunk's device buffers): its counter deltas through the
        accounting table, its hot loads, and the retired and UNSEEN blocks
        and the finite PSD sum/max of the post-superstep state (``psd`` and
        ``calm`` after the staleness post)."""
        delta = (acct_dev[hot_rows.long()] * hot_ok[:, None]).sum(dim=0) \
            + (acct_dev[cold_rows.long()] * cold_ok[:, None]).sum(dim=0)
        folded = psd.amax(dim=-1)  # block fold
        finite = folded < state_lib.UNSEEN
        if self.config.adaptive:
            live = (calm < self.config.retire_after).any(dim=-1)
            retired = self.plan.num_blocks - live.sum()
        else:
            retired = torch.zeros((), dtype=torch.int64, device=psd.device)
        row_i.copy_(torch.cat([delta, torch.stack(
            [hot_ok.sum(), retired, (~finite).sum()])]))
        fin = torch.where(finite, folded, 0.0)
        row_f.copy_(torch.stack([fin.sum(), fin.amax()]))

    def _run_fused(self, max_iterations: int | None = None,
                   warm: WarmStart | None = None,
                   trace: bool = False) -> RunResult:
        cfg, p, dev = self.config, self.plan, self.device
        max_it = max_iterations or cfg.max_iterations
        values, psd, psd_sub_host, rep, calm_host, i2 = \
            self._start_state(warm)
        t2 = cfg.t2
        floor = _f32(self._psd_floor())
        calm = torch.as_tensor(calm_host).to(dev)
        psd_host = state_lib.fold_subblock_psd(psd_sub_host)
        active = self._active_count(calm_host)
        dmax = torch.zeros((p.num_blocks, cfg.subblocks), dtype=torch.float32,
                           device=dev)
        coupling = self._coupling_dev
        ed = self._ed
        acct = self._acct_table()
        metrics = Metrics()
        history = []
        depth_hist: dict[int, int] = {}
        width_iters = 0
        sb_total = 0
        syncs = 0
        wb = self._pick_width(active, psd_host)
        # tracing: the timeline rows go to a device buffer per chunk, read
        # with the boundary's other reads; the counter rows go to the
        # installed recorder (if any)
        rec = obs_trace.current() if trace else None
        timeline: list | None = [] if trace else None
        acct_dev = torch.as_tensor(acct).to(dev) if trace else None
        # out-of-core paging: the host scheduler twin predicts each
        # superstep's blocks so they are paged in before the sweeps read
        # them; residency never changes the schedule. Paged chunks are one
        # superstep each (the demand changes every superstep); the bucket
        # still changes only at fired boundaries, the resident cadence.
        spill = self.spill
        if spill is not None:
            spill.begin_run()
            pred = schedule_predictor(self._ladder[0], i2, cfg.cold_frac,
                                      self._psd_floor())

        with Timer() as t:
            it = 0
            while it < max_it:
                if spill is None:
                    it_end = rep.chunk_end(max_it)
                else:
                    pred.width = wb
                    sel = pred.select(it, psd_sub_host, rep.is_hot)
                    spill.admit(ooc_policy.demand_blocks(sel, self.pad_id),
                                psd_host, calm_host)
                    it_end = it + 1
                # the chunk span runs from the first enqueue to the
                # boundary read, which waits for the chunk's device work
                with obs_trace.span("chunk", cat="engine", it0=it,
                                    width=wb) as csp:
                    select = make_device_select(
                        width=wb, cold_frac=cfg.cold_frac,
                        min_psd=self._psd_floor(), pad_id=self.pad_id)
                    hot_sweep, cold_sweep = self._sweeps(wb)
                    is_hot = torch.as_tensor(rep.is_hot).to(dev)
                    # chunk-local device counters, read at the boundary
                    it_dev = torch.tensor(it, dtype=torch.int64, device=dev)
                    done = torch.zeros((), dtype=torch.bool, device=dev)
                    counts = torch.zeros(p.num_blocks, dtype=torch.int32,
                                         device=dev)
                    hslots = torch.zeros(wb, dtype=torch.int32, device=dev)
                    sbacc = torch.zeros((), dtype=torch.int64, device=dev)
                    if trace:
                        # row k - it is superstep k: the first it_new - it
                        # rows are the supersteps that ran (a superstep
                        # that finds nothing to schedule sets done and is
                        # not counted)
                        hist_i = torch.zeros(
                            (it_end - it, len(TIMELINE_INT_COLS)),
                            dtype=torch.int64, device=dev)
                        hist_f = torch.zeros(
                            (it_end - it, len(TIMELINE_FLOAT_COLS)),
                            dtype=torch.float32, device=dev)
                    for k in range(it, it_end):
                        # while not done, the device iteration count is k
                        hot_rows, hot_ok, cold_rows, cold_ok = select(
                            k, i2, psd, is_hot)
                        running = ~done
                        hot_ok = hot_ok & running
                        cold_ok = cold_ok & running
                        live = (psd >= floor).sum(dim=-1)
                        sbacc += (live[hot_rows.long()] * hot_ok).sum() \
                            + (live[cold_rows.long()] * cold_ok).sum()
                        hot_sweep(ed, values, psd, dmax, hot_rows, hot_ok)
                        cold_sweep(ed, values, psd, dmax, cold_rows, cold_ok)
                        counts.index_add_(0, hot_rows.long(),
                                          hot_ok.to(torch.int32))
                        counts.index_add_(0, cold_rows.long(),
                                          cold_ok.to(torch.int32))
                        hslots += hot_ok.to(torch.int32)
                        # staleness propagation + calm/retire counter advance
                        psd2, dmax2, calm2 = self._post(coupling, psd, dmax,
                                                        calm)
                        psd = torch.where(done, psd, psd2)
                        dmax = torch.where(done, dmax, dmax2)
                        calm = torch.where(done, calm, calm2)
                        if trace:
                            self._timeline_row(acct_dev, hot_rows, hot_ok,
                                               cold_rows, cold_ok, psd, calm,
                                               hist_i[k - it], hist_f[k - it])
                        scheduled = hot_ok.any() | cold_ok.any()
                        it_dev += scheduled.to(torch.int64)
                        done = done | state_lib.converged_device(psd, t2) \
                            | ~scheduled
                    # the chunk's single host read
                    it_new = int(it_dev)
                    psd_sub_host = psd.cpu().numpy()
                    psd_host = state_lib.fold_subblock_psd(psd_sub_host)
                    calm_host = calm.cpu().numpy()
                    counts_host = counts.cpu().numpy().astype(np.int64)
                    hslots_host = hslots.cpu().numpy()
                    sb_total += int(sbacc)
                    conv = bool(state_lib.converged_device(psd, t2))
                    syncs += 1
                    if trace:
                        ran = it_new - it
                        rows = [timeline_row(it + j, wb, ri, rf)
                                for j, (ri, rf) in enumerate(zip(
                                    hist_i[:ran].cpu().numpy(),
                                    hist_f[:ran].cpu().numpy()))]
                        timeline.extend(rows)
                    csp.set(it_end=it_new)
                if rec is not None and rows:
                    rec.counter_rows("superstep", rows, csp.t0, csp.t1)
                delta = counts_host @ acct
                metrics.absorb_counters(delta)
                span = it_new - it
                width_iters += wb * span
                for d, cnt in zip(self._inner_depths(wb).tolist(),
                                  hslots_host.tolist()):
                    if cnt:
                        depth_hist[int(d)] = depth_hist.get(int(d), 0) + \
                            int(cnt)
                history.append({
                    "iteration": max(it_new - 1, 0),
                    "span": span,
                    "psd_sum": float(psd_host[psd_host <
                                              state_lib.UNSEEN].sum()),
                    "unseen": int((psd_host >= state_lib.UNSEEN).sum()),
                    "hot_blocks": int(rep.is_hot.sum()),
                    "scheduled": int(delta[2]),
                    "width": wb,
                    "retired": p.num_blocks - self._active_count(calm_host),
                })
                if conv:
                    metrics.converged = True
                    it = it_new
                    break
                if it_new == it:  # schedule went empty: nothing left to do
                    break
                it = it_new
                # a no-op until it - 1 reaches the boundary, so paged
                # one-superstep chunks fire on the resident cadence
                with obs_trace.span("repartition", cat="engine",
                                    iteration=it - 1) as rsp:
                    fired = rep.maybe_repartition(it - 1, psd_host,
                                                  cfg.hot_ratio)
                    rsp.set(fired=fired)
                # resident chunks end at boundaries, so this is the same
                # cadence: a paged retarget at every superstep would change
                # the cold quota and fork the trajectory
                if spill is None or fired:
                    wb = self._pick_width(self._active_count(calm_host),
                                          psd_host)
                if spill is not None and fired:
                    # stage the predicted next demand and the hottest
                    # non-resident blocks, swapping out retired ones only
                    pred.width = wb
                    nsel = pred.select(it, psd_sub_host, rep.is_hot)
                    spill.prefetch_boundary(
                        ooc_policy.demand_blocks(nsel, self.pad_id),
                        psd_host, calm_host)
        return self._finish(metrics, t.elapsed, it, width_iters,
                            psd_sub_host, calm_host, depth_hist, sb_total,
                            values, history, syncs, timeline)

    def _finish(self, metrics, elapsed, it, width_iters, psd_sub, calm_host,
                depth_hist, sb_total, values, history, syncs,
                timeline=None) -> RunResult:
        p = self.plan
        if self.spill is not None:
            self.spill.flush_metrics(metrics)
        self.last_psd = psd_sub
        self.last_calm = np.asarray(calm_host)
        metrics.iterations = it
        metrics.wall_time_s = elapsed
        metrics.mean_dispatch_width = width_iters / max(it, 1)
        metrics.blocks_retired = p.num_blocks - self._active_count(calm_host)
        metrics.inner_depth_hist = depth_hist
        metrics.subblocks_retired = self._subblocks_retired(calm_host)
        metrics.mean_subblock_dispatch = sb_total / \
            max(metrics.block_loads, 1)
        out = values.cpu().numpy()[p.inv]  # back to original ids
        return RunResult(values=out, metrics=metrics, history=history,
                         host_syncs=syncs + 1, timeline=timeline)

    def _dispatch(self, values, psd, dmax, block_ids: np.ndarray,
                  sequential: bool, width: int):
        """Run the selected blocks through the sweeps, padded to the given
        dispatch bucket. Slot index == PSD rank, which is what the hot
        sweep's depth ladder keys on."""
        hot_sweep, cold_sweep = self._sweeps(width)
        sweep = hot_sweep if sequential else cold_sweep
        for at in range(0, block_ids.size, width):
            chunk = block_ids[at:at + width]
            rows = np.zeros(width, dtype=np.int32)
            ok = np.zeros(width, dtype=bool)
            rows[:chunk.size] = chunk.astype(np.int32)
            ok[:chunk.size] = True
            sweep(self._ed, values, psd, dmax,
                  torch.as_tensor(rows).to(self.device),
                  torch.as_tensor(ok).to(self.device))

    def _run_host(self, max_iterations: int | None = None,
                  warm: WarmStart | None = None,
                  trace: bool = False) -> RunResult:
        cfg, p = self.config, self.plan
        max_it = max_iterations or cfg.max_iterations
        values, psd, psd_sub, rep, calm_host, i2 = self._start_state(warm)
        psd_host = state_lib.fold_subblock_psd(psd_sub)
        sched = Scheduler(width=self._pick_width(
                              self._active_count(calm_host), psd_host),
                          i2=i2, cold_frac=cfg.cold_frac,
                          min_psd=self._psd_floor())
        calm = torch.as_tensor(calm_host).to(self.device)
        dmax = torch.zeros((p.num_blocks, cfg.subblocks), dtype=torch.float32,
                           device=self.device)
        floor = self._psd_floor()
        metrics = Metrics()
        history = []
        depth_hist: dict[int, int] = {}
        hslots = np.zeros(cfg.width, dtype=np.int64)
        width_iters = 0
        sb_total = 0
        syncs = 0
        # host-loop timeline: one row per iteration from the same acct table
        # and post-superstep state the device-resident loop's rows read
        timeline: list | None = [] if trace else None
        acct = self._acct_table() if trace else None
        spill = self.spill
        if spill is not None:
            spill.begin_run()
            calm_now = calm_host  # the calm counters the store ranks by

        with Timer() as t:
            it = 0
            while it < max_it:
                sel: Selection = sched.select(it, psd_sub, rep.is_hot)
                if sel.hot_ids.size == 0 and sel.cold_ids.size == 0:
                    break
                if spill is not None:
                    # page the slate in before the dispatch reads it (block
                    # 0, the dispatch's row padding, is pinned resident)
                    spill.admit(ooc_policy.demand_blocks(sel, self.pad_id),
                                psd_host, calm_now)
                processed = np.concatenate([sel.hot_ids, sel.cold_ids])
                sb_total += int((psd_sub[processed] >= floor).sum())
                self._dispatch(values, psd, dmax, sel.hot_ids,
                               sequential=True, width=sched.width)
                self._dispatch(values, psd, dmax, sel.cold_ids,
                               sequential=False, width=sched.width)
                self._account(metrics, processed)
                hslots[:sel.hot_ids.size] += 1
                width_used = sched.width  # before the boundary retarget
                width_iters += width_used
                psd, dmax, calm = self._post(self._coupling_dev, psd, dmax,
                                             calm)
                psd_sub = psd.cpu().numpy()
                psd_host = state_lib.fold_subblock_psd(psd_sub)
                syncs += 1
                if spill is not None:
                    calm_now = calm.cpu().numpy()
                if trace:  # the iteration's read, with calm beside psd
                    finite = psd_host < state_lib.UNSEEN
                    fin = psd_host[finite].astype(np.float32)
                    timeline.append(timeline_row(
                        it, width_used,
                        list(acct[processed].sum(axis=0))
                        + [sel.hot_ids.size, p.num_blocks
                           - self._active_count(calm.cpu().numpy()),
                           (~finite).sum()],
                        [fin.sum(), fin.max() if fin.size else 0.0]))
                with obs_trace.span("repartition", cat="engine",
                                    iteration=it) as rsp:
                    fired = rep.maybe_repartition(it, psd_host,
                                                  cfg.hot_ratio)
                    rsp.set(fired=fired)
                if fired and cfg.adaptive:
                    calm_host = calm.cpu().numpy()
                    sched.width = self._pick_width(
                        self._active_count(calm_host), psd_host)
                if fired and spill is not None:
                    # boundary prefetch: the predicted next demand and the
                    # hottest non-resident blocks
                    nsel = sched.select(it + 1, psd_sub, rep.is_hot)
                    spill.prefetch_boundary(
                        ooc_policy.demand_blocks(nsel, self.pad_id),
                        psd_host, calm_now)
                history.append({
                    "iteration": it,
                    "psd_sum": float(psd_host[psd_host <
                                              state_lib.UNSEEN].sum()),
                    "unseen": int((psd_host >= state_lib.UNSEEN).sum()),
                    "hot_blocks": int(rep.is_hot.sum()),
                    "scheduled": int(processed.size),
                    "width": sched.width,
                })
                it += 1
                if state_lib.converged(psd_sub, cfg.t2):
                    metrics.converged = True
                    break
        calm_host = calm.cpu().numpy()
        for d, cnt in zip(self._inner_depths(cfg.width).tolist(),
                          hslots.tolist()):
            if cnt:
                depth_hist[int(d)] = depth_hist.get(int(d), 0) + int(cnt)
        return self._finish(metrics, t.elapsed, it, width_iters, psd_sub,
                            calm_host, depth_hist, sb_total, values, history,
                            syncs, timeline)


def _init_dead(program: VertexProgram, plan: PartitionPlan,
               values_perm: np.ndarray) -> np.ndarray:
    """Dead partition: processed once at start (§3.2) — apply() with the
    identity aggregate, after which these vertices are final."""
    values = np.array(values_perm, dtype=np.float32)
    if plan.n_dead == 0:
        return values
    dead = slice(plan.n_live, plan.graph.n)
    old = torch.from_numpy(values[dead])
    agg = torch.full((plan.n_dead,), 0.0 if program.combine == "sum"
                     else float(program.identity))
    values[dead] = program.apply(old, agg, plan.graph.n).numpy()
    return values


def block_coupling_counts(plan: PartitionPlan) -> np.ndarray:
    """(P, P) block->block edge counts W_jb over the permuted graph's
    out-edges (the dead tail dropped); (P, P, S) W_jbs, resolved to the
    destination's sub-range, when the plan has S > 1 sub-blocks."""
    g, c, s = plan.graph, plan.block_size, plan.subblocks
    nb = plan.num_blocks
    deg = np.diff(g.out_indptr[:plan.n_live + 1])
    src_blk = np.repeat(np.arange(plan.n_live, dtype=np.int64) // c, deg)
    dst = g.out_dst[:g.out_indptr[plan.n_live]].astype(np.int64)
    keep = dst // c < nb
    src_blk, dst = src_blk[keep], dst[keep]
    idx = src_blk * nb + dst // c
    if s > 1:
        idx = idx * s + (dst % c) // plan.sub_size
    shape = (nb, nb) if s == 1 else (nb, nb, s)
    return np.bincount(idx, minlength=int(np.prod(shape))).reshape(shape)


# -- Betweenness centrality (Brandes, sampled sources) -----------------------
def betweenness(graph: Graph, sources: list[int],
                config: EngineConfig = EngineConfig(),
                structure_aware: bool = True,
                device="cuda") -> tuple[np.ndarray, Metrics]:
    """BC per the paper's algorithm set: the forward BFS waves run through
    the structure-aware engine (or the baseline when
    ``structure_aware=False``) on ``device``; the path counting and the
    dependency accumulation are level-synchronous numpy float64 sweeps on
    the host, as in the reference (single passes, not iterative-convergent
    phases). BFS levels are exact, so both engines give the same bits."""
    from repro_torch.core import algorithms as algos
    from repro_torch.core.baseline import BaselineEngine

    n = graph.n
    bc = np.zeros(n, dtype=np.float64)
    total = Metrics()
    s_arr, d_arr, _ = _coo(graph)
    for s in sources:
        prog = algos.bfs(source=s)
        eng = (StructureAwareEngine(graph, prog, config, device=device)
               if structure_aware
               else BaselineEngine(graph, prog, config, device=device))
        res = eng.run()
        dist = res.values
        for k, v in res.metrics.as_dict().items():
            # skip non-summable entries: converged, and derived rates that
            # as_dict computes from counters (read-only properties)
            if (isinstance(v, (int, float)) and k != "converged"
                    and not isinstance(getattr(type(total), k, None),
                                       property)):
                setattr(total, k, getattr(total, k) + v)
        # sigma: #shortest paths, level-synchronous accumulation
        finite = dist < algos.INF / 2
        max_lvl = int(dist[finite].max()) if finite.any() else 0
        sigma = np.zeros(n, dtype=np.float64)
        sigma[s] = 1.0
        on_sp = dist[d_arr] == dist[s_arr] + 1
        for lvl in range(1, max_lvl + 1):
            e = on_sp & (dist[d_arr] == lvl)
            np.add.at(sigma, d_arr[e], sigma[s_arr[e]])
        # delta: backward dependency accumulation
        delta = np.zeros(n, dtype=np.float64)
        for lvl in range(max_lvl, 0, -1):
            e = on_sp & (dist[d_arr] == lvl)
            contrib = sigma[s_arr[e]] / np.maximum(sigma[d_arr[e]], 1.0) * \
                (1.0 + delta[d_arr[e]])
            np.add.at(delta, s_arr[e], contrib)
        delta[s] = 0.0
        bc += delta
    return bc, total


def _coo(g: Graph):
    """(src, dst, w) of ``g``'s in-edges in CSC order."""
    dst = np.repeat(np.arange(g.n, dtype=np.int64), g.in_deg)
    return g.in_src.astype(np.int64), dst, g.in_w
