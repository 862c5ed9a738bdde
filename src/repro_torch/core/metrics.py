"""Accounting the paper evaluates on: runtime, updates, partition loads.

No cache-miss counter is read, but the schedule makes the quantity *exact*:
every scheduled block is one partition load (a read of its edge slice +
vertex slice from device memory). ``bytes_loaded`` is the I/O proxy
(paper §2.1), ``updates`` the convergence-work proxy (§2.2 contribution 1).
"""
from __future__ import annotations

import dataclasses
import time


# Order of the accounting vector the fused engine flushes at repartition
# boundaries: the device accumulates exact per-block schedule counts, the
# host expands them through a per-block [vertices, edges, loads, bytes]
# table into this layout.
COUNTER_FIELDS = ("updates", "edges_processed", "block_loads",
                  "bytes_loaded")


def _with_properties(m) -> dict:
    """``dataclasses.asdict`` plus every ``@property`` on the class — the
    one serializer all three metrics classes share, so a derived quantity
    added to a class can never silently miss its report/JSON row
    (``tests/test_obs.py`` asserts the parity)."""
    d = dataclasses.asdict(m)
    for klass in reversed(type(m).__mro__):
        for name, attr in vars(klass).items():
            if isinstance(attr, property):
                d[name] = getattr(m, name)
    return d


def block_io_bytes(edges, block_size):
    """Shared I/O cost model — bytes loaded when a block is scheduled:
    4B src id + 4B weight + 4B dst offset per edge, plus the block's vertex
    values. The ONE definition consumed by the engine accounting, the plan,
    and the baseline, so the bytes_loaded columns can never desync."""
    return edges * 12 + block_size * 4


@dataclasses.dataclass
class Metrics:
    iterations: int = 0
    updates: int = 0  # vertex apply() executions
    edges_processed: int = 0
    block_loads: int = 0  # partition loads (cache/I-O proxy)
    bytes_loaded: int = 0
    wall_time_s: float = 0.0
    converged: bool = False
    # adaptive active-set audit trail: how much of the schedule the run
    # actually retired / narrowed / shallowed (zero on the dense path)
    blocks_retired: int = 0  # blocks individually converged-and-retired at end
    mean_dispatch_width: float = 0.0  # iteration-weighted dispatch bucket
    inner_depth_hist: dict = dataclasses.field(default_factory=dict)
    # hot-slot executions per Gauss-Seidel depth {t_inner: count}
    # hierarchical-partition audit trail (block-level fields above are
    # untouched for comparability across versions; both are 0/1.0-trivial when
    # subblocks == 1)
    subblocks_retired: int = 0  # sub-blocks retired at end (calm >= limit)
    mean_subblock_dispatch: float = 0.0  # live sub-blocks per block load
    # out-of-core residency accounting (all zero when the run is fully
    # resident — resident_blocks unset or >= P). These audit the spill
    # tier's traffic; they are NOT part of the algorithmic trajectory, so
    # the budget-vs-resident bitwise parity tests exclude them.
    spill_evictions: int = 0  # blocks evicted device -> spill tier
    bytes_spilled: int = 0  # tile-row bytes moved off-device
    prefetch_hits: int = 0  # scheduled-block demands already resident
    prefetch_misses: int = 0  # demand fetches the prefetcher missed
    bytes_fetched: int = 0  # tile-row bytes scattered back on demand/prefetch

    @property
    def prefetch_hit_rate(self) -> float:
        """Fraction of scheduled-block demands that were already resident
        when the superstep needed them (1.0 when nothing ever spilled)."""
        total = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / total if total else 1.0

    def as_dict(self) -> dict:
        return _with_properties(self)

    def absorb_counters(self, counters) -> None:
        """Add a (len(COUNTER_FIELDS),) device-counter flush (cumulative
        deltas, COUNTER_FIELDS order). Deltas arrive as exact int64s; no
        float round-trip, so totals stay exact at any scale."""
        for name, v in zip(COUNTER_FIELDS, counters):
            setattr(self, name, getattr(self, name) + int(v))


@dataclasses.dataclass
class StreamMetrics:
    """Cumulative accounting for a :class:`repro.stream.StreamingEngine`.

    The quantities the streaming claim rides on: per-batch latency, the
    dirty-block fraction (how much of the graph a delta actually
    re-heats), host->device upload bytes (how much of the mutated state
    actually moves), and edges reprocessed by the warm reconvergence — the
    number a cold full recompute is compared against.

    ``dirty_blocks`` / ``blocks_seen`` accumulate over IN-PLACE batches
    only: a tile-overflow batch re-heats every block by construction
    (``plan_rebuilds`` counts those), and folding it into the average
    would inflate ``dirty_frac`` past what the in-place path touches.
    """

    batches: int = 0
    ingest_time_s: float = 0.0  # delta application (storage mutation)
    reconverge_time_s: float = 0.0  # warm engine reconvergence
    edges_inserted: int = 0
    edges_deleted: int = 0  # deleted edge copies (incl. parallel edges)
    edges_reprocessed: int = 0  # engine edges_processed across warm runs
    iterations: int = 0  # warm reconvergence iterations across batches
    dirty_blocks: int = 0  # cumulative over in-place (non-rebuild) batches
    blocks_seen: int = 0  # cumulative P over in-place batches (denominator)
    appended_blocks: int = 0  # in-place tile appends (no rebuild)
    killed_blocks: int = 0  # in-place slot kills (no rebuild, no movement)
    rebuilt_blocks: int = 0  # per-block tile-run rebuilds (incl. compactions)
    aux_bumped_blocks: int = 0  # finite-PSD aux re-arms (not re-heated)
    plan_rebuilds: int = 0  # full overflow-triggered plan/storage rebuilds
    vertices_reset: int = 0  # non-monotone delete re-heat resets
    bytes_uploaded: int = 0  # actual host->device payload across batches
    bytes_full: int = 0  # what full per-batch re-uploads would have cost
    snapshots_preserved: int = 0  # epoch pins device-copied for isolation
    # adaptive active-set accounting across warm reconvergences
    blocks_retired: int = 0  # cumulative end-of-batch retired blocks
    width_iterations: float = 0.0  # sum of dispatch width over iterations
    inner_depth_hist: dict = dataclasses.field(default_factory=dict)
    # hierarchical-partition accounting (same in-place-batch convention as
    # dirty_blocks/blocks_seen; all 0 or degenerate when subblocks == 1)
    dirty_subblocks: int = 0  # cumulative armed sub-blocks (in-place batches)
    subblocks_seen: int = 0  # cumulative P*S over in-place batches
    subblocks_retired: int = 0  # cumulative end-of-batch retired sub-blocks
    subblock_loads: int = 0  # live sub-blocks actually swept across runs
    subblock_load_slots: int = 0  # block loads across warm runs (denominator)
    # out-of-core residency accounting across warm reconvergences (zero
    # when the engine runs fully resident)
    spill_evictions: int = 0
    bytes_spilled: int = 0
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    bytes_fetched: int = 0

    @property
    def dirty_frac(self) -> float:
        return self.dirty_blocks / max(self.blocks_seen, 1)

    @property
    def subblock_dirty_frac(self) -> float:
        """Armed sub-blocks over sub-block slots (in-place batches): the
        granularity win over ``dirty_frac`` — a small delta arms few
        sub-blocks even when it pigeonholes into most blocks."""
        return self.dirty_subblocks / max(self.subblocks_seen, 1)

    @property
    def mean_subblock_dispatch(self) -> float:
        """Live sub-blocks swept per block load (1.0 when subblocks == 1):
        how much of each loaded block's vertex range actually computed."""
        return self.subblock_loads / max(self.subblock_load_slots, 1)

    @property
    def mean_dispatch_width(self) -> float:
        """Iteration-weighted mean dispatch-bucket width across batches —
        the claimed tail-superstep saving, auditable."""
        return self.width_iterations / max(self.iterations, 1)

    @property
    def prefetch_hit_rate(self) -> float:
        """Scheduled-block demands already resident, across warm runs
        (1.0 when nothing ever spilled)."""
        total = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / total if total else 1.0

    @property
    def upload_frac(self) -> float:
        return self.bytes_uploaded / max(self.bytes_full, 1)

    @property
    def latency_per_batch_s(self) -> float:
        return ((self.ingest_time_s + self.reconverge_time_s)
                / max(self.batches, 1))

    def as_dict(self) -> dict:
        return _with_properties(self)


@dataclasses.dataclass
class ServeMetrics:
    """Cumulative accounting for a :class:`repro.serve.QueryService`.

    The serving claims ride on three quantities: queries per second
    (lane batching amortizes partition loads and loop overhead over L
    queries), lane utilization (admitted lanes over lane slots — padding
    lanes are masked work), and how often snapshot isolation actually
    cost something (``epochs_pinned`` vs the stream side's
    ``snapshots_preserved``)."""

    queries: int = 0  # completed queries
    lane_batches: int = 0  # lane-engine runs executed
    lanes_admitted: int = 0  # real queries placed into lane slots
    lane_slots: int = 0  # total slots incl. padding (utilization denom)
    run_time_s: float = 0.0  # lane-engine wall time
    wait_time_s: float = 0.0  # submit -> completion minus own run time
    iterations: int = 0  # supersteps across lane batches
    epochs_pinned: int = 0  # distinct epochs queries pinned
    stale_answers: int = 0  # results served from a pre-ingest epoch
    blocks_retired: int = 0  # end-of-batch retired blocks across lane runs

    @property
    def lane_utilization(self) -> float:
        return self.lanes_admitted / max(self.lane_slots, 1)

    @property
    def queries_per_s(self) -> float:
        return self.queries / max(self.run_time_s, 1e-9)

    def as_dict(self) -> dict:
        return _with_properties(self)


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
