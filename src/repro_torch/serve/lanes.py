"""Multi-lane fused execution: L independent queries per superstep sweep;
port of ``repro.serve.lanes``.

The :class:`LaneEngine` is the query-serving generalization of
``StructureAwareEngine._run_fused``: vertex values carry a lane axis
``(values_len, L)``, one device-resident chunk loop advances every lane per
superstep, and the paper's scheduling stack prices the **union** of the
lane frontiers:

  * the block priority is the max over live lanes of the per-lane PSD
    (``state.fold_lane_psd_device``): a block hot in ANY running lane is
    schedulable, so one dispatch serves every lane that needs the block;
  * per-lane convergence masks retire finished lanes (lane l is done when
    SUM_b PSD[b, l] < T2); a retired lane stops pricing blocks, so the
    active set and the dispatch width shrink as lanes finish;
  * the adaptive machinery (calm/retire counters, depth ladder, width
    buckets) is the engine's own decision helpers, so with one admitted lane
    the schedule is the single-program engine's;
  * hierarchical partitions carry through: lane PSD/dmax are (P, S, L),
    calm is (P, S), and each scheduled block applies ONE (S,) sub-block mask
    shared by the lanes (the lane-folded sub priority over the floor).

Every sweep goes through the lane sweep kernel (``kernels.block_sweep``:
kernel 1l at S = 1, kernel 1lm at S > 1). The chunk loop is the engine's:
the host enqueues the supersteps up to the next repartition boundary
without reading anything back; the lane PSD, calm counters, ``lane_done``,
``lane_it`` and a ``done`` flag live on the device and turn the supersteps
after convergence into no-ops; the host reads them once per boundary.

Partition loads and bytes are billed once per block schedule (the load is
shared); updates and edges are billed per admitted lane. Padding lanes
start converged, are swept, and are never billed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import state as state_lib
from repro_torch.core.algorithms import LaneProgram
from repro_torch.core.engine import (EdgeData, StructureAwareEngine, _f32,
                                     acct_table, dispatch_width,
                                     inner_depths, make_lane_processor)
from repro_torch.core.metrics import Metrics, Timer
from repro_torch.core.repartition import RepartitionState
from repro_torch.core.schedule import make_device_select
from repro_torch.kernels import block_sweep as kb


@dataclasses.dataclass
class LaneResult:
    values: np.ndarray  # (n, L), original vertex ids
    metrics: Metrics  # batch-level accounting (see module docstring)
    lane_iterations: np.ndarray  # (L,) supersteps until each lane converged
    lane_converged: np.ndarray  # (L,) bool
    host_syncs: int = 0  # device->host reads of the loop state


class LaneEngine:
    """Fused multi-lane runner over one engine epoch's tile geometry.

    Borrows plan, config and the decision helpers from a
    :class:`StructureAwareEngine` (the geometry owner); edge state and
    coupling arrive per run, so one LaneEngine serves every epoch that keeps
    the geometry (a plan rebuild needs a new one)."""

    def __init__(self, engine: StructureAwareEngine, program: LaneProgram):
        self.engine = engine
        self.program = program
        p, cfg = engine.plan, engine.config
        self._proc = make_lane_processor(program, p.block_size, p.n_live,
                                         p.graph.n, cfg.subblocks,
                                         _f32(engine._psd_floor()))
        self._scratch: kb.LaneScratch | None = None

    # -- device pieces (mirrors of the engine's, with a lane axis) -----------
    def _sweeps(self, width: int):
        """(hot_sweep, cold_sweep) over a (width,) slate, in place on
        (values, psd, dmax), as the engine's."""
        depths = inner_depths(self.engine.config, width).tolist()
        process_one, process_iterated = self._proc

        def hot_sweep(ed, vconst, values, psd, dmax, rows, ok, lane_done,
                      scratch):
            for i in range(width):
                process_iterated(ed, values, vconst, psd, dmax,
                                 rows[i:i + 1], ok[i:i + 1], lane_done,
                                 scratch, depths[i])

        def cold_sweep(ed, vconst, values, psd, dmax, rows, ok, lane_done,
                       scratch):
            process_one(ed, values, vconst, psd, dmax, rows, ok, lane_done,
                        scratch)

        return hot_sweep, cold_sweep

    def _post(self, coupling, psd, dmax, calm, lane_done):
        """Per-lane staleness propagation and the SHARED calm counters: a
        delta in lane l re-arms downstream (sub-)blocks for lane l only,
        while calm advances on the lane-folded sub priority. The coupling is
        applied lane by lane, as the engine's ``_post`` applies it (a
        (P, P, S) temporary per lane, not (P, P, S, L)); max is exact, so
        this is bitwise the reference's all-lane product."""
        eng = self.engine
        eps, floor = _f32(eng.config.stale_eps), _f32(eng._psd_floor())
        d = torch.where(dmax > eps, dmax, 0.0)  # (P, S, L)
        dblk = d.amax(dim=1)  # (P, L)
        cpl = coupling if coupling.dim() == 3 else coupling[:, :, None]
        bump = torch.stack([(dblk[:, k, None, None] * cpl).amax(dim=0)
                            for k in range(psd.shape[-1])], dim=-1)
        psd = torch.maximum(psd, torch.clamp(bump, max=_f32(1e29)))
        quiet = state_lib.lane_sub_psd_device(psd, lane_done)  # (P, S)
        calm = torch.where(quiet < floor, calm + 1, 0).to(torch.int32)
        return psd, torch.zeros_like(dmax), calm

    # -- host side -----------------------------------------------------------
    def _pad_lane_values(self, arr: np.ndarray) -> np.ndarray:
        pad = self.engine._values_len - arr.shape[0]
        if pad:
            return np.concatenate(
                [arr, np.zeros((pad, arr.shape[1]), dtype=arr.dtype)])
        return arr

    def _init_dead(self, values0: np.ndarray, vconst: np.ndarray):
        """Dead partition one-shot (engine parity): apply() with the
        identity aggregate, per lane. Streaming plans keep no dead vertices;
        this covers LaneEngines over plain engines."""
        p = self.engine.plan
        if p.n_dead == 0:
            return values0
        dead = slice(p.n_live, p.graph.n)
        agg = torch.full((p.n_dead, values0.shape[1]),
                         0.0 if self.program.combine == "sum"
                         else float(self.program.identity))
        values0 = values0.copy()
        values0[dead] = self.program.apply(
            torch.from_numpy(values0[dead]), agg,
            torch.from_numpy(vconst[dead]), p.graph.n).numpy()
        return values0

    def prewarm(self, n_lanes: int) -> list[int]:
        """The reference compiles the lane chunk per width bucket here; the
        kernel takes any slate and lane count up to ``MAX_LANES``, so there
        is nothing to compile. On a card this builds and loads the kernel,
        so no query batch pays for it. Returns the width ladder."""
        if not 1 <= n_lanes <= kb.MAX_LANES:
            raise ValueError(f"lane sweeps take 1..{kb.MAX_LANES} lanes")
        if self.engine.device.type == "cuda":
            kb.load_library()
        return list(self.engine._ladder)

    def run(self, *, ed: EdgeData, coupling: np.ndarray,
            values0: np.ndarray, vconst: np.ndarray | None,
            lane_active: np.ndarray, edge_counts: np.ndarray,
            max_iterations: int | None = None) -> LaneResult:
        """Run every active lane to convergence over the given epoch state.

        ``ed`` is the epoch's edge state on the engine's device (its aux is
        the family's); ``values0``/``vconst`` are (n, L) in ORIGINAL vertex
        ids; ``lane_active`` marks admitted lanes (padding lanes start
        converged and never price a block); ``edge_counts`` is the pinned
        epoch's per-block live edge counts (the accounting truth)."""
        eng = self.engine
        cfg, p, dev = eng.config, eng.plan, eng.device
        max_it = max_iterations or cfg.max_iterations
        lane_active = np.asarray(lane_active, dtype=bool)
        nl = values0.shape[1]
        n_adm = int(lane_active.sum())
        sb = cfg.subblocks
        floor = _f32(eng._psd_floor())
        t2 = cfg.t2

        vals = np.asarray(values0, dtype=np.float32)[p.order]
        vc = (np.asarray(vconst, dtype=np.float32)[p.order]
              if vconst is not None else np.zeros_like(vals))
        vals = self._init_dead(vals, vc)
        values = torch.tensor(self._pad_lane_values(vals), device=dev)
        vconst_dev = torch.tensor(self._pad_lane_values(vc), device=dev)
        scratch = self._scratch = kb.make_lane_scratch(
            ed, p.block_size, nl, reuse=self._scratch)

        psd_host = state_lib.init_lane_psd(p.num_blocks, lane_active, sb)
        psd = torch.tensor(psd_host, device=dev)  # (P, S, L)
        lane_done_host = ~lane_active
        lane_done = torch.tensor(lane_done_host, device=dev)
        lane_it = torch.zeros(nl, dtype=torch.int64, device=dev)
        folded = state_lib.fold_lane_psd(psd_host, lane_done_host)
        mode = "barrier" if self.program.monotone_cooling else "universal"
        rep = RepartitionState.create(
            p.num_blocks, p.barrier_block, mode,
            interval=cfg.repartition_interval,
            growth=cfg.repartition_growth)
        calm_host = np.zeros((p.num_blocks, sb), dtype=np.int32)
        calm = torch.tensor(calm_host, device=dev)
        dmax = torch.zeros_like(psd)
        active = eng._active_count(calm_host)
        # loads/bytes billed once per block schedule (shared by the lanes);
        # updates/edges per admitted lane
        acct = acct_table(p, edge_counts)
        acct[:, 0] *= max(n_adm, 1)
        acct[:, 1] *= max(n_adm, 1)
        coupling_dev = torch.tensor(np.asarray(coupling, dtype=np.float32),
                                    device=dev)
        metrics = Metrics()
        depth_hist: dict[int, int] = {}
        width_iters = 0
        sb_total = 0
        loads_total = 0
        syncs = 0

        with Timer() as t:
            it = 0
            while it < max_it and n_adm:
                wb = dispatch_width(cfg, eng._ladder, active, folded)
                it_end = rep.chunk_end(max_it)
                select = make_device_select(
                    width=wb, cold_frac=cfg.cold_frac,
                    min_psd=eng._psd_floor(), pad_id=eng.pad_id)
                hot_sweep, cold_sweep = self._sweeps(wb)
                is_hot = torch.as_tensor(rep.is_hot).to(dev)
                it_dev = torch.tensor(it, dtype=torch.int64, device=dev)
                done = torch.zeros((), dtype=torch.bool, device=dev)
                counts = torch.zeros(p.num_blocks, dtype=torch.int32,
                                     device=dev)
                hslots = torch.zeros(wb, dtype=torch.int32, device=dev)
                sbacc = torch.zeros((), dtype=torch.int64, device=dev)
                for k in range(it, it_end):
                    # while not done, the device iteration count is k
                    sub_psd = state_lib.lane_sub_psd_device(psd, lane_done)
                    hot_rows, hot_ok, cold_rows, cold_ok = select(
                        k, cfg.i2, sub_psd, is_hot)
                    running = ~done
                    hot_ok = hot_ok & running
                    cold_ok = cold_ok & running
                    # sub-block dispatch accounting from the pre-superstep
                    # priorities: the masks the sweeps apply
                    live = (sub_psd >= floor).sum(dim=-1)
                    sbacc += (live[hot_rows.long()] * hot_ok).sum() \
                        + (live[cold_rows.long()] * cold_ok).sum()
                    hot_sweep(ed, vconst_dev, values, psd, dmax, hot_rows,
                              hot_ok, lane_done, scratch)
                    cold_sweep(ed, vconst_dev, values, psd, dmax, cold_rows,
                               cold_ok, lane_done, scratch)
                    counts.index_add_(0, hot_rows.long(),
                                      hot_ok.to(torch.int32))
                    counts.index_add_(0, cold_rows.long(),
                                      cold_ok.to(torch.int32))
                    hslots += hot_ok.to(torch.int32)
                    psd2, dmax2, calm2 = self._post(coupling_dev, psd, dmax,
                                                    calm, lane_done)
                    psd = torch.where(done, psd, psd2)
                    dmax = torch.where(done, dmax, dmax2)
                    calm = torch.where(done, calm, calm2)
                    scheduled = hot_ok.any() | cold_ok.any()
                    it_dev += scheduled.to(torch.int64)
                    lane_conv = state_lib.lane_converged_device(psd, t2) \
                        & running
                    lane_it = torch.where(lane_conv & ~lane_done, it_dev,
                                          lane_it)
                    lane_done = lane_done | lane_conv
                    done = done | lane_done.all() | ~scheduled
                # the chunk's single host read
                it_new = int(it_dev)
                psd_host = psd.cpu().numpy()
                lane_done_host = lane_done.cpu().numpy()
                calm_host = calm.cpu().numpy()
                counts_host = counts.cpu().numpy().astype(np.int64)
                hslots_host = hslots.cpu().numpy()
                sb_total += int(sbacc)
                conv = bool(lane_done_host.all())
                syncs += 1
                active = eng._active_count(calm_host)
                folded = state_lib.fold_lane_psd(psd_host, lane_done_host)
                metrics.absorb_counters(counts_host @ acct)
                loads_total += int(counts_host.sum())
                width_iters += wb * (it_new - it)
                for d, cnt in zip(inner_depths(cfg, wb).tolist(),
                                  hslots_host.tolist()):
                    if cnt:
                        depth_hist[int(d)] = depth_hist.get(int(d), 0) + \
                            int(cnt)
                if conv:
                    metrics.converged = True
                    it = it_new
                    break
                if it_new == it:  # schedule went empty
                    break
                it = it_new
                rep.maybe_repartition(it - 1, folded, cfg.hot_ratio)
        metrics.iterations = it
        metrics.wall_time_s = t.elapsed
        metrics.mean_dispatch_width = width_iters / max(it, 1)
        metrics.blocks_retired = p.num_blocks - active
        metrics.subblocks_retired = eng._subblocks_retired(calm_host)
        metrics.mean_subblock_dispatch = sb_total / max(loads_total, 1)
        metrics.inner_depth_hist = depth_hist
        lane_conv_host = lane_done.cpu().numpy() & lane_active
        lane_iters = np.where(lane_conv_host, lane_it.cpu().numpy(), it)
        out = values.cpu().numpy()[p.inv]  # (n, L), original ids
        return LaneResult(values=out, metrics=metrics,
                          lane_iterations=lane_iters,
                          lane_converged=lane_conv_host,
                          host_syncs=syncs + 1)
