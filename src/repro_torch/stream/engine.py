"""StreamingEngine: ingest edge deltas, re-heat dirty blocks, reconverge;
port of ``repro.stream.engine``.

Wraps one :class:`StructureAwareEngine` epoch and alternates

    ingest (incremental storage mutation, `apply.py`)
      -> dirty-block re-heat (affected blocks labelled hot with PSD =
         UNSEEN, convergence flags of clean blocks left converged,
         values warm-started from the previous fixpoint)
      -> the device-resident convergence loop (`engine.run(warm=...)`)

which is exactly the universal repartitioner's cold->hot path (§3.3)
driven by graph mutation instead of in-run decay. The engine's edge
tensors are updated in place, so the mutated tiles re-enter the same
sweeps; a full plan rebuild happens only when a block's slack tile run
overflows. The per-batch cost is proportional to the blocks the batch
TOUCHES, not to m: storage mutation is per-block (in-place slot kills,
watermark appends, per-block compactions), the device commit scatters
only the touched tile rows / changed aux entries / changed coupling rows
into the live device tensors (`StructureAwareEngine.update_edge_rows`
and friends, which also refresh the sweep kernel's fold metadata of the
touched blocks), and the delete-reset frontier closure is served from the
EdgeStore's by-src buckets instead of an O(m) CSR rebuild. The
`StreamBatchReport.upload_frac` column measures exactly this.

Delta-proportional reconvergence (adaptive engines): the warm restart
seeds the engine's block-local convergence counters so only the
perturbed blocks (dirty re-heats + aux bumps) start in the active set —
a 200-edit batch opens in a narrow dispatch-width bucket with a
cold-admission cadence scaled to the perturbed fraction
(`schedule.adaptive_i2`), and clean blocks re-enter only when the
staleness coupling lifts them over the pruning floor. Reconvergence
effort therefore scales with the batch, not the graph (BLADYG's
argument for delta-local recomputation). With hierarchical partitions
(`EngineConfig.subblocks > 1`) the arming is SUB-block granular: the
warm PSD/calm seeds mark only the sub-ranges holding the batch's touched
destination vertices, so a 10-edit batch whose endpoints pigeonhole into
10 different blocks still starts with ~10 armed sub-blocks — the engine
sweeps only those sub-ranges of each loaded block
(`StreamBatchReport.subblock_dirty_frac` / `mean_subblock_dispatch`
audit exactly this).

Non-monotone deletions: min/max programs can never take back a value, so
before the warm re-start the program's ``reset_on_delete`` hook
re-initialises every vertex whose value might (transitively) depend on a
deleted edge (KickStarter-style trimming; see `algorithms.py`). PageRank
needs no resets — its apply() ignores the old value, the warm state is
just a good initial guess.

Snapshot isolation for the query service (``snapshot`` -> :class:`EpochState`):
a pin copies the epoch's host bookkeeping at once and its device edge state
only when an ingest is about to mutate it, in the ingest preamble, before
any commit; pins of one epoch share that copy. Under an out-of-core budget
(``EngineConfig.resident_blocks``) a pin taken while blocks are spilled is
preserved at once (the copy's holes filled from the spill tier), and the
tier's pre-eviction hook preserves every live pin before rows leave the
card.

Epoch persistence (:mod:`repro_torch.ooc.snapshot`): ``save_epoch`` writes
the epoch's COO truth, fixpoint values and activity state; ``restore``
rebuilds the epoch from the COO and warm-starts from the values.

With a :mod:`repro_torch.obs` recorder installed, ``snapshot`` emits a
``snapshot`` span and ``ingest`` an ``ingest`` span around a ``reconverge``
span, which holds the engine's ``run`` spans (the reference's names, cats
and args).
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np

from repro_torch.analysis.contracts import decision_identical
from repro_torch.core import state as state_lib
from repro_torch.core.algorithms import VertexProgram, graph_successors
from repro_torch.core.engine import (EdgeData, EngineConfig, RunResult,
                                     StructureAwareEngine, WarmStart,
                                     coupling_from_counts, resolve_device)
from repro_torch.core.graph import Graph, edges_of, from_edges, symmetrize
from repro_torch.core.metrics import StreamMetrics, Timer
from repro_torch.core.schedule import adaptive_i2
from repro_torch.obs import trace as obs_trace
from repro_torch.ooc.snapshot import GraphCheckpoint
from repro_torch.stream.apply import EdgeStore, MutableTiledState
from repro_torch.stream.delta import DeltaBatch


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    tile_slack: float = 0.5  # spare tile capacity fraction per block
    spare_tiles: int = 1  # flat extra tiles per block (covers empty blocks)
    warm: bool = True  # False: cold full recompute per batch (reference)


@dataclasses.dataclass
class StreamBatchReport:
    inserts: int
    deletes: int  # killed base edge copies (incl. parallel edges)
    dirty_blocks: int
    num_blocks: int
    appended_blocks: int
    killed_blocks: int  # blocks whose slots were invalidated in place
    rebuilt_blocks: int
    aux_bumped_blocks: int  # finite-PSD re-arms (aux change, not re-heated)
    plan_rebuild: bool
    vertices_reset: int
    iterations: int
    edges_processed: int
    bytes_uploaded: int  # actual host->device payload of this batch
    bytes_full: int  # what a full dynamic-state re-upload would cost
    ingest_time_s: float
    reconverge_time_s: float
    converged: bool
    # adaptive active-set stats of the warm reconvergence. All zero when
    # the batch needed no run; on the dense fallback retirement stays 0
    # but mean_dispatch_width reports the full configured width (the
    # fixed slate IS the dispatch width) and the depth histogram carries
    # the constant depth.
    blocks_retired: int = 0  # blocks retired at reconvergence end
    mean_dispatch_width: float = 0.0  # iteration-weighted bucket width
    inner_depth_hist: dict = dataclasses.field(default_factory=dict)
    # hierarchical-partition stats (degenerate at subblocks == 1: every
    # dirty block is one dirty sub-block and the mean dispatch is 1.0)
    subblocks: int = 1  # sub-blocks per block this epoch
    dirty_subblocks: int = 0  # armed sub-blocks (UNSEEN re-heats)
    block_loads: int = 0  # engine block loads of the reconvergence
    subblocks_retired: int = 0  # sub-blocks retired at reconvergence end
    mean_subblock_dispatch: float = 0.0  # live sub-blocks per block load
    # out-of-core residency traffic of the warm reconvergence (all zero
    # when the engine runs fully resident)
    spill_evictions: int = 0
    bytes_spilled: int = 0
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    bytes_fetched: int = 0

    @property
    def dirty_frac(self) -> float:
        return self.dirty_blocks / max(self.num_blocks, 1)

    @property
    def subblock_dirty_frac(self) -> float:
        """Armed sub-blocks over sub-block slots — the granularity the
        P-pigeonhole can't see: a small batch arms few sub-blocks even
        when its endpoints land in most blocks."""
        return self.dirty_subblocks / max(self.num_blocks *
                                          self.subblocks, 1)

    @property
    def upload_frac(self) -> float:
        """Fraction of the full per-batch upload the batch actually paid —
        the tentpole number: it scales with the blocks a batch touches,
        not with m. A warm plan-rebuild batch pays exactly 1.0; cold
        reference mode never uploads warm values, so its rebuild batches
        land just under 1.0."""
        return self.bytes_uploaded / max(self.bytes_full, 1)

    @property
    def latency_s(self) -> float:
        return self.ingest_time_s + self.reconverge_time_s


@dataclasses.dataclass
class EpochState:
    """A consistent read view of one StreamingEngine epoch: what a query
    pins at admission (snapshot isolation for the serve subsystem).

    Host bookkeeping (coupling counts, degrees, per-block edge counts) is
    copied when the pin is taken. The device edge state is copied only when
    an ingest is about to mutate it: :meth:`preserve`, called by the ingest
    preamble for every live pin, so pins on a quiet graph cost nothing and
    N pins of one epoch share one copy."""

    epoch: int
    engine: StructureAwareEngine  # geometry and processors of the epoch
    coupling_counts: np.ndarray  # (P, P), or (P, P, S), block->block counts
    out_deg: np.ndarray  # (n,) permuted, incremental truth at pin time
    in_deg: np.ndarray
    edge_counts: np.ndarray  # (P,) per-block live edge counts
    _ed: EdgeData | None = None  # preserved copy; None -> the live state

    @property
    def ed(self) -> EdgeData:
        if self._ed is None:
            spill = self.engine.spill
            if spill is not None and spill.spilled_blocks.size:
                # safety net: never hand out a live view with spilled holes;
                # copy and fill them instead. The eager paths (snapshot()
                # under spill, the eviction hook, the ingest preamble)
                # normally preserve before this fires.
                self.preserve()
        return self._ed if self._ed is not None else self.engine.edge_state

    @property
    def preserved(self) -> bool:
        return self._ed is not None

    def preserve(self) -> None:
        if self._ed is None:
            self._ed = self.engine.edge_snapshot()


class StreamingEngine:
    """Long-lived engine over a mutating graph (fixed vertex set)."""

    def __init__(self, graph: Graph, program: VertexProgram,
                 config: EngineConfig = EngineConfig(),
                 stream: StreamConfig = StreamConfig(), device="cuda"):
        self.program = program
        self.stream = stream
        self.device = resolve_device(device)
        self.config = dataclasses.replace(
            config, tile_slack=stream.tile_slack,
            spare_tiles=stream.spare_tiles, keep_dead_blocks=True)
        self.metrics = StreamMetrics()
        self.n = graph.n
        # epoch id: bumped once per ingest (and once per plan rebuild,
        # which happens inside an ingest): the version a query pins
        self.epoch = 0
        self._snapshots: list = []  # weakrefs to unpreserved EpochStates
        s, d, w = edges_of(graph)
        self._build_epoch(s, d, w)
        # bootstrap: one cold run to the initial fixpoint
        self.initial_result: RunResult = self.engine.run()
        self._values = self.initial_result.values

    # -- epoch snapshots (serve-side snapshot isolation) ---------------------
    def snapshot(self) -> EpochState:
        """Pin the current epoch. The view stays consistent across future
        :meth:`ingest` calls (the ingest preamble preserves the device state
        of every live pin before mutating it); it is tracked by weakref, so
        dropping the last reference makes future ingests free again."""
        with obs_trace.span("snapshot", cat="stream", epoch=self.epoch):
            es = EpochState(
                epoch=self.epoch, engine=self.engine,
                coupling_counts=self.W.copy(), out_deg=self.out_deg.copy(),
                in_deg=self.in_deg.copy(),
                edge_counts=np.array(self.engine.edge_counts))
            spill = self.engine.spill
            if spill is not None and spill.spilled_blocks.size:
                # the live edge state already has spilled holes: preserve
                # now (edge_snapshot fills them from the spill tier), not at
                # the next ingest, since the pin must be readable before
                es.preserve()
                self.metrics.snapshots_preserved += 1
            self._snapshots.append(weakref.ref(es))
        return es

    def _preserve_pinned(self) -> int:
        """Device-copy every live, unpreserved pin: the ingest preamble,
        run before any commit rewrites the pinned tensors in place. Pins of
        one epoch share one copy (they are read-only views of identical
        state). Returns the number of copies taken."""
        copies = 0
        shared: dict[int, EdgeData] = {}
        for ref in self._snapshots:
            es = ref()
            if es is None or es.preserved:
                continue
            ed = shared.get(es.epoch)
            if ed is None:
                es.preserve()
                shared[es.epoch] = es.ed
                copies += 1
            else:
                es._ed = ed
        self._snapshots = []
        return copies

    def _on_spill_evict(self) -> None:
        """Spill-tier pre-eviction hook: pinned epochs must survive the
        eviction of their blocks. The eviction really zeroes the rows on
        the card, so every live pin is preserved first (``edge_snapshot``
        fills the holes already spilled; the rows about to go are still
        resident when the hook runs)."""
        self.metrics.snapshots_preserved += self._preserve_pinned()

    # -- epoch management ----------------------------------------------------
    def _build_epoch(self, src: np.ndarray, dst: np.ndarray,
                     w: np.ndarray) -> None:
        """(Re)build engine + mutable mirrors from a base COO snapshot."""
        g = from_edges(self.n, src, dst, w)
        self.engine = StructureAwareEngine(g, self.program, self.config,
                                           device=self.device)
        plan = self.engine.plan
        inv = plan.inv
        sym = self.program.needs_symmetric
        self.store = EdgeStore(inv[src], inv[dst],
                               np.asarray(w, dtype=np.float32), self.n,
                               plan.num_blocks, plan.block_size, sym)
        self.tiles = MutableTiledState(plan.unified)
        # incrementally-maintained degrees of the INTERNAL (symmetrized)
        # graph, permuted order — the activity inputs (paper Eq. 1)
        self.out_deg = plan.graph.out_deg.astype(np.int64)
        self.in_deg = plan.graph.in_deg.astype(np.int64)
        # block -> block internal edge counts (staleness coupling truth)
        self.W = self.engine.coupling_counts.copy()
        self._aux = np.array(self.engine.aux)
        # every init is structure-independent (its values do not depend on
        # the edges), so one epoch snapshot serves every delete-reset
        # without rebuilding a Graph
        self._init_values = np.asarray(self.program.init(g)[0])
        # build the sweep kernel at epoch build, not inside a batch
        self.engine.prewarm_buckets()
        spill = self.engine.spill
        if spill is not None:
            # the host tile mirror is the truth under ingest: evictions
            # need no read from the card, and fetches copy the CURRENT
            # truth even for blocks mutated while spilled (a commit to a
            # non-resident block is harmless: the fetch overwrites its rows)
            spill.row_source = self.tiles.rows2d
            spill.on_evict = self._on_spill_evict

    def _rebuild_epoch(self) -> None:
        ps, pd, w = self.store.live_base()
        order = self.engine.plan.order
        if self.engine.spill is not None:
            # the old epoch's queued segments land before the new store
            # writes to the same directory, and its writer thread ends
            self.engine.spill.close()
        self._build_epoch(order[ps], order[pd], w)
        self.metrics.plan_rebuilds += 1

    # -- public state --------------------------------------------------------
    @property
    def values(self) -> np.ndarray:
        """Current converged values, indexed by original vertex id."""
        return self._values

    def current_graph(self) -> Graph:
        """The mutated base graph (original ids) — what a cold run sees."""
        ps, pd, w = self.store.live_base()
        order = self.engine.plan.order
        return from_edges(self.n, order[ps], order[pd], w)

    def activity(self, alpha: float | None = None) -> np.ndarray:
        """Incrementally-maintained per-vertex activity a*in + b*out (the
        degree function D(v) = out + alpha*in of paper Eq. 1), original
        ids — no rescan of the edge set."""
        a = self.engine.plan.alpha if alpha is None else alpha
        d = (self.out_deg + a * self.in_deg)
        return d[self.engine.plan.inv]

    # -- epoch persistence (warm restarts; repro_torch.ooc.snapshot) --------
    def save_epoch(self, ckpt, step: int | None = None):
        """Persist the current epoch (edge truth, fixpoint values, activity
        state) through a :class:`repro_torch.ooc.snapshot.GraphCheckpoint`.
        ``ckpt`` is a directory path or a GraphCheckpoint; ``step`` defaults
        to the epoch counter. Every state between batches is a fixpoint
        (ingest ends with reconvergence), so the snapshot is consistent.
        Returns the checkpoint (``.wait()`` blocks on the async writer)."""
        if not isinstance(ckpt, GraphCheckpoint):
            ckpt = GraphCheckpoint(ckpt)
        ckpt.save(self, step)
        return ckpt

    @classmethod
    def restore(cls, ckpt, program: VertexProgram,
                config: EngineConfig = EngineConfig(),
                stream: StreamConfig = StreamConfig(),
                step: int | None = None, verify: bool = True,
                device="cuda"):
        """Warm-restart a StreamingEngine on ``device`` from a saved epoch.
        The epoch's geometry is rebuilt from the checkpointed COO
        (``build_plan`` is a pure function of the edge set and config, the
        path every overflow batch takes), and the engine starts from the
        checkpointed fixpoint values instead of ``program.init``. With
        ``verify`` (the default) a verification pass re-heats every block
        once (PSD = UNSEEN, universal mode) and reconverges; from a fixpoint
        the deltas die at once (``initial_result`` holds its metrics).
        ``verify=False`` trusts the checkpoint and skips the run. A
        checkpoint written under one residency budget restores under any
        other (``config.resident_blocks`` applies to the new engine)."""
        if not isinstance(ckpt, GraphCheckpoint):
            ckpt = GraphCheckpoint(ckpt)
        tree, meta = ckpt.load(step)
        src, dst, w = tree["edges"]
        self = cls.__new__(cls)
        self.program = program
        self.stream = stream
        self.device = resolve_device(device)
        self.config = dataclasses.replace(
            config, tile_slack=stream.tile_slack,
            spare_tiles=stream.spare_tiles, keep_dead_blocks=True)
        self.metrics = StreamMetrics()
        self.n = int(meta["n"])
        self.epoch = int(meta["epoch"])
        self._snapshots = []
        self._build_epoch(np.asarray(src, dtype=np.int64),
                          np.asarray(dst, dtype=np.int64),
                          np.asarray(w, dtype=np.float32))
        self._values = np.asarray(tree["values"])
        self.initial_result = None
        self.restored_meta = meta
        if verify:
            plan = self.engine.plan
            vals = self._values[plan.order].astype(np.float32)
            res = self.engine.run(warm=WarmStart(
                values=self.engine.pad_values(vals),
                psd=state_lib.init_psd(plan.num_blocks,
                                       self.config.subblocks),
                is_hot=np.ones(plan.num_blocks, dtype=bool)))
            self._values = res.values
            self.initial_result = res
        return self

    # -- ingest --------------------------------------------------------------
    def ingest(self, batch: DeltaBatch) -> StreamBatchReport:
        with obs_trace.span("ingest", cat="stream",
                            inserts=batch.n_inserts,
                            deletes=batch.n_deletes,
                            epoch=self.epoch) as sp:
            report = self._ingest_impl(batch)
            sp.set(dirty_blocks=report.dirty_blocks,
                   plan_rebuild=report.plan_rebuild,
                   iterations=report.iterations)
        return report

    def _ingest_impl(self, batch: DeltaBatch) -> StreamBatchReport:
        prog, eng = self.program, self.engine
        plan = eng.plan
        c = plan.block_size
        inv = plan.inv
        self._validate(batch)
        # snapshot isolation: queries pinned to the current epoch keep
        # reading it, so copy their device state before this batch's
        # commits (or plan rebuild) touch it
        self.metrics.snapshots_preserved += self._preserve_pinned()
        sym = prog.needs_symmetric
        appended = rebuilt = killed_blocks = 0
        n_reset = 0
        bytes_up = 0
        empty = np.empty(0, dtype=np.int64)
        reset_blocks = empty
        reset_verts = empty  # permuted ids, for sub-block-granular arming

        with Timer() as t_ing:
            # 1. mutate the base truth (deletes first, then inserts)
            killed = self.store.kill_pairs(inv[batch.del_src],
                                           inv[batch.del_dst])
            kps, kpd = self.store.psrc[killed], self.store.pdst[killed]
            killed_orig = (plan.order[kps], plan.order[kpd],
                           self.store.w[killed].copy())
            ip_src, ip_dst = inv[batch.ins_src], inv[batch.ins_dst]
            ins_ids = self.store.insert(ip_src, ip_dst, batch.ins_w)
            iw = self.store.w[ins_ids]
            self._bump(killed, -1)
            self._bump(ins_ids, +1)
            # coupling rows whose counts moved (refresh is O(rows * P))
            wrow_parts = [kps // c, ip_src // c]
            if sym:
                wrow_parts += [kpd // c, ip_dst // c]
            wrows = np.unique(np.concatenate(wrow_parts))

            # 2. per-block tile mutation. Deletes: in-place slot kills
            # (masked holes — only the rows holding killed slots move);
            # symmetric engines rebuild the touched blocks from truth
            # instead, since a mirror slot of (s, d) is sig-identical to a
            # base slot of (d, s). Inserts: append at the watermark, with
            # a rebuild (= hole compaction, the store already holds this
            # batch's inserts) when the watermark hits capacity.
            overflow = False
            rebuild_set = empty
            kill_set = empty
            if killed.size:
                if sym:
                    rebuild_set = np.union1d(self._blocks_of(kpd),
                                             self._blocks_of(kps))
                    for b in rebuild_set:
                        if not self.tiles.rebuild(
                                int(b), *self.store.gather_block(int(b))):
                            overflow = True
                            break
                        rebuilt += 1
                else:
                    kb = kpd // c
                    kill_set = np.unique(kb)
                    for b in kill_set:
                        sel = kb == b
                        self.tiles.kill(int(b), kps[sel],
                                        kpd[sel] - int(b) * c)
                    killed_blocks = int(kill_set.size)
            ins_rows = [(ip_dst // c, ip_src, ip_dst, iw)]
            if sym:
                ins_rows.append((ip_src // c, ip_dst, ip_src, iw))
            append_set = np.setdiff1d(
                np.unique(np.concatenate([blk for blk, *_ in ins_rows]))
                if ins_ids.size else empty, rebuild_set)
            compacted: list[int] = []
            if not overflow:
                for b in append_set:
                    asrc = np.concatenate(
                        [es[blk == b] for blk, es, _, _ in ins_rows])
                    adst = np.concatenate(
                        [ed[blk == b] for blk, _, ed, _ in ins_rows])
                    aw = np.concatenate(
                        [ew[blk == b] for blk, _, _, ew in ins_rows])
                    if self.tiles.append(
                            int(b), asrc.astype(np.int32),
                            (adst - int(b) * c).astype(np.int32), aw):
                        appended += 1
                    elif self.tiles.rebuild(
                            int(b), *self.store.gather_block(int(b))):
                        rebuilt += 1  # watermark full, holes reclaimed
                        compacted.append(int(b))
                    else:
                        overflow = True
                        break
            if compacted and kill_set.size:
                # a kill-touched block whose append fell back to a rebuild
                # is a rebuild, not in-place maintenance — count it once
                kill_set = np.setdiff1d(
                    kill_set, np.asarray(compacted, dtype=np.int64))
                killed_blocks = int(kill_set.size)

            # 3. non-monotone deletions: KickStarter-style trimming before
            # the warm start (min/max programs cannot take a value back).
            # The frontier closure is served straight from the EdgeStore's
            # by-src buckets — no O(m) CSR rebuild per delete batch; the
            # Graph-building hook remains only as a fallback for programs
            # that predate the oracle interface. Cold reference mode
            # restarts from program.init, so it skips trimming entirely.
            if self.stream.warm and killed.size:
                if prog.reset_on_delete_frontier is not None:
                    mask = np.asarray(prog.reset_on_delete_frontier(
                        self._successors, self.n, self._values,
                        *killed_orig))
                elif prog.reset_on_delete is not None:
                    mask = np.asarray(prog.reset_on_delete(
                        self._internal_graph(), self._values, *killed_orig))
                else:
                    mask = None
                if mask is not None and mask.any():
                    self._values = self._values.copy()
                    self._values[mask] = self._init_values[mask]
                    reset_verts = inv[np.flatnonzero(mask)]
                    reset_blocks = self._blocks_of(reset_verts)
                    n_reset = int(mask.sum())

            # 4. aux refresh from the incremental degrees — batched to the
            # batch's own endpoints (aux_fns are elementwise in the degrees,
            # so only vertices whose degrees moved can change), never an
            # O(n) rescan. A changed SOURCE aux silently changes the aggregates
            # of its out-neighbour blocks; programs exposing aux_delta turn
            # that into a finite PSD bump (scheduled by priority, skipped
            # below the pruning floor) instead of an UNSEEN re-heat of
            # nearly every block.
            aux_dirty = empty
            aux_dirty_sub = None  # (blk, sub) index pair at S > 1
            aux_bump = None  # (P,) flat / (P, S) sub-resolved
            aux_changed = empty
            aux_vals = np.empty(0, dtype=np.float32)
            subblocks = eng.config.subblocks
            if prog.aux_fn is not None and not overflow and (
                    killed.size or ins_ids.size):
                cand = np.unique(np.concatenate(
                    [kps, kpd, ip_src, ip_dst]))
                a_new = np.asarray(prog.aux_fn(self.out_deg[cand],
                                               self.in_deg[cand]),
                                   dtype=np.float32)
                ch = a_new != self._aux[cand]
                aux_changed, aux_vals = cand[ch], a_new[ch]
                if aux_changed.size:
                    if prog.aux_delta is not None and prog.combine == "sum":
                        dmsg = np.asarray(prog.aux_delta(
                            self._values[plan.order[aux_changed]],
                            self._aux[aux_changed], aux_vals))
                        mass = self.store.out_block_mass(
                            aux_changed, dmsg, subblocks)
                        # sound per-block bound: damping * (message-delta
                        # mass entering the block) / C, the same form the
                        # staleness coupling uses; at S > 1 the mass is
                        # resolved per destination sub-range, so only the
                        # sub-blocks actually fed by the changed sources
                        # re-arm (block-granular bumps would re-open the
                        # pigeonhole: ~every bump arms S sub-blocks)
                        aux_bump = (prog.damping * mass / c).astype(
                            np.float32)
                    else:
                        # min/max programs: UNSEEN re-heat of the changed
                        # sources' out-neighbourhood, resolved to the
                        # destination sub-ranges when S > 1
                        _, sdst, _ = self.store.successors(aux_changed)
                        aux_dirty = np.unique(sdst // c)
                        if subblocks > 1:
                            ks_ = c // subblocks
                            aux_dirty_sub = (sdst // c, (sdst % c) // ks_)
                    self._aux[aux_changed] = aux_vals

            # 5. commit to the engine — inside the ingest timer, so both
            # the worst case (overflow -> full plan rebuild) and the
            # device upload are billed to the batch's latency
            calm0 = None
            i2_warm = None
            subblocks = eng.config.subblocks
            if overflow:
                # a block outgrew its slack capacity: new epoch
                # (re-permute by current activity, re-provision slack,
                # recompile); values stay warm, every block re-heats. The
                # partial appends/rebuilds made before the overflow were
                # discarded with the old tiles — do not let them count as
                # in-place maintenance. Everything is perturbed, so the
                # warm run starts fully active (no calm seed, base i2).
                appended = rebuilt = killed_blocks = 0
                self._rebuild_epoch()
                eng = self.engine
                plan = eng.plan
                dirty = np.ones(plan.num_blocks, dtype=bool)
                dirty_sub = np.ones((plan.num_blocks, subblocks),
                                    dtype=bool)
                is_hot = np.zeros(plan.num_blocks, dtype=bool)
                is_hot[:plan.barrier_block] = True
                psd0 = state_lib.init_psd(plan.num_blocks, subblocks)
                # the warm-values upload is billed where it happens (below)
                bytes_up = eng.full_upload_bytes() - eng.values_nbytes
            else:
                # device-side incremental commit: copy only the touched
                # tile rows / changed aux entries / changed coupling rows
                # into the live device tensors — O(touched), not O(m),
                # host->device traffic
                rows = self.tiles.pop_dirty_rows()
                if rows.size:
                    bytes_up += eng.update_edge_rows(
                        rows, **self.tiles.rows2d(rows))
                bytes_up += eng.update_aux(aux_changed, aux_vals)
                if wrows.size:
                    bytes_up += eng.update_coupling_rows(
                        wrows, coupling_from_counts(self.W[wrows], prog, c))
                eng.edge_counts = self.tiles.live.copy()
                dirty = np.zeros(plan.num_blocks, dtype=bool)
                for ids in (kill_set, rebuild_set, append_set, aux_dirty,
                            reset_blocks):
                    dirty[ids.astype(np.int64)] = True
                # sub-block refinement of the dirty set: arm only the
                # sub-ranges holding this batch's touched DESTINATION
                # vertices (mirror dsts too on symmetric engines) and the
                # delete-reset frontier — the dst vertex is where an edge
                # mutation changes an aggregate. Aux-dirty re-heats are
                # likewise resolved to the destination sub-ranges the
                # changed sources actually feed (whole rows at S = 1).
                # Block-level `dirty` stays the truth for reports/is_hot/
                # i2 — at S = 1 the two views coincide column for column.
                ksub = c // subblocks
                dirty_sub = np.zeros((plan.num_blocks, subblocks),
                                     dtype=bool)
                tv_parts = [kpd, ip_dst, reset_verts]
                if sym:
                    tv_parts += [kps, ip_src]
                tv = np.concatenate([np.asarray(v, dtype=np.int64)
                                     for v in tv_parts])
                if tv.size:
                    dirty_sub[tv // c, (tv % c) // ksub] = True
                if aux_dirty_sub is not None:
                    dirty_sub[aux_dirty_sub] = True
                else:
                    dirty_sub[aux_dirty.astype(np.int64)] = True
                # safety net: a dirty block must own >= 1 armed sub-block
                # (rebuild bookkeeping paths all arm through tv/aux, but
                # the invariant is load-bearing for convergence)
                dirty_sub |= (dirty & ~dirty_sub.any(axis=1))[:, None]
                dirty_sub &= dirty[:, None]
                is_hot = dirty.copy()
                # block-level view of the (possibly sub-resolved) aux bump:
                # a block is bumped iff any of its sub-blocks is
                bump_blk = (None if aux_bump is None else
                            aux_bump.max(axis=-1) if aux_bump.ndim == 2
                            else aux_bump)
                if bump_blk is not None:
                    # bumped blocks are scheduled with hot priority (their
                    # pending delta is known and front-loading it converges
                    # in fewer sweeps) but stay out of the dirty set: they
                    # carry a finite prunable PSD, not the UNSEEN re-heat
                    is_hot |= bump_blk > 0
                psd0 = state_lib.warm_psd_sub(plan.num_blocks, subblocks,
                                              dirty_sub, aux_bump)
                if eng.config.adaptive:
                    # delta-proportional warm restart: only the perturbed
                    # sub-blocks (dirty re-heats + aux bumps) start active,
                    # so the reconvergence opens in a dispatch bucket sized
                    # to the batch, with a cold-admission cadence scaled to
                    # the perturbed fraction — effort follows the delta,
                    # not the graph. A 10-edit batch arms ~10 sub-blocks
                    # even when its endpoints pigeonhole into 10 blocks.
                    armed = dirty.copy()
                    armed_sub = dirty_sub.copy()
                    if aux_bump is not None:
                        armed |= bump_blk > 0
                        armed_sub |= (aux_bump > 0 if aux_bump.ndim == 2
                                      else (aux_bump > 0)[:, None])
                    calm0 = state_lib.warm_calm_sub(
                        plan.num_blocks, subblocks, armed_sub,
                        eng.config.retire_after)
                    i2_warm = adaptive_i2(eng.config.i2, plan.num_blocks,
                                          int(armed.sum()))

            # 6. reclaim dead store rows — at the very END of ingest, after
            # every use of this batch's edge ids (compaction renumbers
            # rows, invalidating killed/ins_ids and anything derived)
            self.store.maybe_compact()

        res = None
        with obs_trace.span("reconverge", cat="stream",
                            warm=self.stream.warm), Timer() as t_run:
            if self.stream.warm:
                if psd0.any():
                    vals_perm = self._values[self.engine.plan.order].astype(
                        np.float32)
                    res = self.engine.run(warm=WarmStart(
                        values=self.engine.pad_values(vals_perm),
                        psd=psd0, is_hot=is_hot, calm=calm0, i2=i2_warm))
                    bytes_up += self.engine.values_nbytes
            else:
                # reference mode: cold full recompute on the SAME mutated
                # storage (sound because inits are @structure_independent)
                res = self.engine.run()
            if res is not None:
                self._values = res.values
        self.epoch += 1  # the mutated graph is the next epoch

        n_bumped = (int(((bump_blk > 0) & ~dirty).sum())
                    if aux_bump is not None else 0)
        report = StreamBatchReport(
            inserts=batch.n_inserts, deletes=int(killed.size),
            dirty_blocks=int(dirty.sum()),
            num_blocks=int(self.engine.plan.num_blocks),
            appended_blocks=appended, killed_blocks=killed_blocks,
            rebuilt_blocks=rebuilt, aux_bumped_blocks=n_bumped,
            plan_rebuild=bool(overflow), vertices_reset=n_reset,
            iterations=res.metrics.iterations if res else 0,
            edges_processed=res.metrics.edges_processed if res else 0,
            bytes_uploaded=int(bytes_up),
            bytes_full=int(self.engine.full_upload_bytes()),
            ingest_time_s=t_ing.elapsed, reconverge_time_s=t_run.elapsed,
            converged=res.metrics.converged if res else True,
            blocks_retired=res.metrics.blocks_retired if res else 0,
            mean_dispatch_width=(res.metrics.mean_dispatch_width
                                 if res else 0.0),
            inner_depth_hist=dict(res.metrics.inner_depth_hist)
            if res else {},
            subblocks=subblocks,
            dirty_subblocks=int(dirty_sub.sum()),
            block_loads=res.metrics.block_loads if res else 0,
            subblocks_retired=res.metrics.subblocks_retired if res else 0,
            mean_subblock_dispatch=(res.metrics.mean_subblock_dispatch
                                    if res else 0.0),
            spill_evictions=res.metrics.spill_evictions if res else 0,
            bytes_spilled=res.metrics.bytes_spilled if res else 0,
            prefetch_hits=res.metrics.prefetch_hits if res else 0,
            prefetch_misses=res.metrics.prefetch_misses if res else 0,
            bytes_fetched=res.metrics.bytes_fetched if res else 0)
        self._absorb(report)
        return report

    # -- internals -----------------------------------------------------------
    def _validate(self, batch: DeltaBatch) -> None:
        for a in (batch.ins_src, batch.ins_dst, batch.del_src,
                  batch.del_dst):
            if a.size and (a.min() < 0 or a.max() >= self.n):
                raise ValueError(
                    f"delta vertex ids must be in [0, {self.n}) — the "
                    "streaming engine mutates edges over a fixed vertex set")

    def _blocks_of(self, vertices: np.ndarray) -> np.ndarray:
        if vertices.size == 0:
            return np.empty(0, dtype=np.int64)
        return np.unique(vertices // self.engine.plan.block_size)

    def _bump(self, ids: np.ndarray, sign: int) -> None:
        """Degree + block-coupling counts for internal copies (with mirrors
        for symmetric engines) — incremental, no edge rescans. At S > 1
        the coupling counts carry a destination-sub axis (P, P, S); the
        sub index is (dst % C) // sub_size, free from the ids in hand."""
        if ids.size == 0:
            return
        plan = self.engine.plan
        c = plan.block_size
        ks = plan.sub_size
        ps, pd = self.store.psrc[ids], self.store.pdst[ids]
        np.add.at(self.out_deg, ps, sign)
        np.add.at(self.in_deg, pd, sign)
        if self.W.ndim == 2:
            np.add.at(self.W, (ps // c, pd // c), sign)
        else:
            np.add.at(self.W, (ps // c, pd // c, (pd % c) // ks), sign)
        if self.program.needs_symmetric:
            np.add.at(self.out_deg, pd, sign)
            np.add.at(self.in_deg, ps, sign)
            if self.W.ndim == 2:
                np.add.at(self.W, (pd // c, ps // c), sign)
            else:
                np.add.at(self.W, (pd // c, ps // c, (ps % c) // ks), sign)

    def _internal_graph(self) -> Graph:
        g = self.current_graph()
        return symmetrize(g) if self.program.needs_symmetric else g

    @decision_identical(twin=graph_successors)
    def _successors(self, frontier: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray,
                                                         np.ndarray]:
        """Out-edge oracle over ORIGINAL vertex ids for the delete-reset
        frontier closure, served from the EdgeStore's by-src buckets —
        replaces the per-delete-batch ``from_edges`` CSR rebuild. Must
        return the same (src, dst, w) multiset as
        :func:`repro_torch.core.algorithms.graph_successors` over the built
        graph (its ``@decision_identical`` twin;
        tests/test_torch_analysis.py holds the two against each other)."""
        plan = self.engine.plan
        ps, pd, w = self.store.successors(plan.inv[frontier])
        return plan.order[ps], plan.order[pd], w

    def _absorb(self, r: StreamBatchReport) -> None:
        m = self.metrics
        m.batches += 1
        m.ingest_time_s += r.ingest_time_s
        m.reconverge_time_s += r.reconverge_time_s
        m.edges_inserted += r.inserts
        m.edges_deleted += r.deletes
        m.edges_reprocessed += r.edges_processed
        m.iterations += r.iterations
        if not r.plan_rebuild:
            # dirty_frac measures the in-place re-heat only: an overflow
            # batch re-heats everything by construction and is tracked by
            # plan_rebuilds instead of skewing the average
            m.dirty_blocks += r.dirty_blocks
            m.blocks_seen += r.num_blocks
            m.dirty_subblocks += r.dirty_subblocks
            m.subblocks_seen += r.num_blocks * r.subblocks
        m.appended_blocks += r.appended_blocks
        m.killed_blocks += r.killed_blocks
        m.rebuilt_blocks += r.rebuilt_blocks
        m.aux_bumped_blocks += r.aux_bumped_blocks
        m.vertices_reset += r.vertices_reset
        m.bytes_uploaded += r.bytes_uploaded
        m.bytes_full += r.bytes_full
        m.blocks_retired += r.blocks_retired
        m.width_iterations += r.mean_dispatch_width * r.iterations
        m.subblocks_retired += r.subblocks_retired
        # mean_subblock_dispatch is block-load-weighted: recover the exact
        # live-sub-block count from the per-run mean (the division by
        # block_loads round-trips within an ulp; round() restores the int)
        m.subblock_loads += int(round(r.mean_subblock_dispatch *
                                      r.block_loads))
        m.subblock_load_slots += r.block_loads
        m.spill_evictions += r.spill_evictions
        m.bytes_spilled += r.bytes_spilled
        m.prefetch_hits += r.prefetch_hits
        m.prefetch_misses += r.prefetch_misses
        m.bytes_fetched += r.bytes_fetched
        for d, cnt in r.inner_depth_hist.items():
            m.inner_depth_hist[d] = m.inner_depth_hist.get(d, 0) + cnt
