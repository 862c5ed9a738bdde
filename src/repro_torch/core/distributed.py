"""Distributed execution of the structure-aware engine (paper Alg. 3's
master/mirror update); port of ``repro.core.distributed`` from a
``shard_map`` mesh to a ``torch.distributed`` process group.

Topology: the schedule width W = (ranks in the group) x (blocks per rank).
Each rank runs its assigned blocks *sequentially* (async semantics within
the rank, the paper's hot mode), then replicas are reconciled once per
dispatch chunk:

  * sum-combine programs (PageRank): blocks are disjoint across ranks, so
    the update is an additive delta: ``values_in + all_reduce_SUM(
    values_local - values_in)`` (Alg. 3 ``master <- mirror vertex update``).
    A world of one does the same arithmetic, as the reference does on a
    one-device mesh (it does not fold ``a + (b - a)`` to ``b``);
  * min/max programs (SSSP/BFS/CC): ``all_reduce`` MIN/MAX over replicas is
    exact because the combine is idempotent (``mirror <- master``).

PSD and max-delta rows are reconciled by a masked MAX: a block processed by
one rank takes that rank's entry, a block no rank processed keeps the
incoming one.

Each block row is updated by :func:`~repro_torch.core.engine.
make_block_processor` over the group-padded storage (``PartitionPlan.hot``/
``.cold``, built on the rank's device): plain torch gather, ``edge_map`` and
``apply`` around the hand-written segmented-combine kernels (kernels 2 and
3, :mod:`repro_torch.kernels.segment`).

The host loop is the engine's ``run(fused=False)``: every rank runs the same
numpy ``Scheduler`` on the same reconciled PSD, so every rank picks the same
blocks, and nothing in the loop reads a value that differs between ranks.
Vertex state is replicated per rank (it is O(n) floats).

The process group is the initialized default group unless one is given (NCCL
on cards, rank r on ``cuda:r``; gloo on the CPU). Without an initialized
``torch.distributed`` the engine is a world of one with no group, the
counterpart of ``default_mesh`` over one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import (EngineConfig, StructureAwareEngine,
                                     make_block_processor)
from repro_torch.kernels import segment as kseg

_NEG = float(np.float32(-1e38))
_REDUCE = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _all_reduce(t: torch.Tensor, op: str, group, collective: bool) -> None:
    if collective:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=group)


def reconcile_values(combine: str, values_in: torch.Tensor,
                     values_l: torch.Tensor, group=None,
                     collective: bool = True) -> torch.Tensor:
    """The vertex values after a dispatch chunk, from each rank's local
    ``values_l`` (``collective`` False: a world of one with no group).
    Sums reconcile an additive delta, always as ``values_in +
    sum(values_l - values_in)``; min/max in place on ``values_l``."""
    if combine == "sum":
        delta = values_l - values_in
        _all_reduce(delta, "SUM", group, collective)
        return values_in + delta
    _all_reduce(values_l, _REDUCE[combine], group, collective)
    return values_l


class DistributedEngine(StructureAwareEngine):
    """Drop-in engine with per-rank block processing over a process group.

    The configuration is pinned as the reference pins it: ``width = world x
    blocks_per_device`` (default ``max(1, config.width // world)``),
    ``fused=False`` (dispatch is host-driven, one reconcile per chunk),
    ``adaptive=False`` (the width IS the group: shrinking it would idle
    ranks, and the per-rank depth ladder would skew the round-robin load
    balance) and ``subblocks=1`` (the group-padded storages have no masked
    sweep)."""

    def __init__(self, graph, program, config: EngineConfig = EngineConfig(),
                 *, group=None, blocks_per_device: int | None = None,
                 device="cuda"):
        super().__init__(graph, program, config, device=device, group=group,
                         blocks_per_device=blocks_per_device)

    def _configure(self, config: EngineConfig, group=None,
                   blocks_per_device: int | None = None) -> EngineConfig:
        self.group = group
        self.collective = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size(group) if self.collective else 1
        self.rank = dist.get_rank(group) if self.collective else 0
        self.bpd = blocks_per_device or max(1, config.width // self.world)
        return dataclasses.replace(config, width=self.world * self.bpd,
                                   fused=False, adaptive=False, subblocks=1)

    def _setup_sweeps(self, aux: np.ndarray) -> None:
        plan, dev = self.plan, self.device
        if dev.type == "cuda":
            kseg.load_library()  # built here, not inside the first run
        aux_dev = torch.tensor(aux, dtype=torch.float32, device=dev)
        self._stores = {k: plan.group_storage(k, dev)
                        for k in ("hot", "cold")}
        self._procs = {k: make_block_processor(
                           self.program, st, aux_dev, plan.block_size,
                           plan.n_live, plan.graph.n)
                       for k, st in self._stores.items()}

    def storage_bytes(self) -> int:
        """Device bytes of the two padded storage groups' edge arrays."""
        return sum(t.numel() * t.element_size()
                   for st in self._stores.values()
                   for t in (st.src, st.dst_local, st.w, st.valid))

    def run(self, max_iterations: int | None = None,
            fused: bool | None = None, warm=None, trace: bool | None = None):
        """Dispatch is host-driven; the single-device fused loop would
        silently ignore the group, so asking for it is an error (and warm
        streaming restarts are not distributed yet)."""
        if fused:
            raise ValueError(
                "DistributedEngine does not support the fused loop: "
                "dispatch is reconciled across ranks per host call")
        if warm is not None:
            raise ValueError(
                "DistributedEngine does not support warm restarts yet")
        return super().run(max_iterations, fused=False, trace=trace)

    def _dispatch(self, values, psd, dmax, block_ids: np.ndarray,
                  sequential: bool, width: int | None = None):
        """Pad the selection to (world x bpd) slots, round-robin across
        ranks; this rank runs its slots in order, then the chunk is
        reconciled. In place on (values, psd, dmax). ``width`` is accepted
        for base-class compatibility and ignored: the group fixes this
        engine's dispatch width."""
        p, w = self.plan, self.world * self.bpd
        t_inner = max(self.config.hot_inner_iters, 1) if sequential else 1
        mine = range(self.rank * self.bpd, (self.rank + 1) * self.bpd)
        for store_key, cond in (("hot", block_ids < p.barrier_block),
                                ("cold", block_ids >= p.barrier_block)):
            ids = block_ids[cond]
            if ids.size == 0:
                continue
            offset = 0 if store_key == "hot" else p.barrier_block
            _, process_iterated, gids = self._procs[store_key]
            for at in range(0, ids.size, w):
                chunk = ids[at:at + w]
                rows = np.zeros(w, dtype=np.int64)
                ok = np.zeros(w, dtype=bool)
                # round-robin so each rank's sequential sweep covers a
                # spread of priorities (straggler-friendly: equal bpd each)
                idx = np.arange(chunk.size)
                slot = (idx % self.world) * self.bpd + idx // self.world
                rows[slot] = chunk - offset
                ok[slot] = True
                values_in = values.clone()
                psd_in, dmax_in = psd.clone(), dmax.clone()
                # the blocks this rank processed, marked on the device (a
                # host-to-device copy would stall the queue)
                done = torch.zeros(p.num_blocks, dtype=torch.bool,
                                   device=self.device)
                for i in mine:
                    if not ok[i]:
                        continue
                    _, _, psd_v, dmax_v = process_iterated(
                        values, int(rows[i]), t_inner)
                    gid = int(gids[rows[i]])
                    psd[gid] = psd_v
                    dmax[gid] = dmax_v
                    done[gid] = True
                self._reconcile(values, values_in, psd, dmax, psd_in,
                                dmax_in, done)

    def _reconcile(self, values, values_in, psd, dmax, psd_in, dmax_in,
                   done: torch.Tensor) -> None:
        values.copy_(reconcile_values(self.program.combine, values_in,
                                      values, self.group, self.collective))
        # psd/dmax carry a trailing (singleton) sub-block axis
        mask = done[None, :, None]
        masked = torch.where(mask, torch.stack([psd, dmax]), _NEG)
        _all_reduce(masked, "MAX", self.group, self.collective)
        out = torch.where(masked > _NEG / 2, masked,
                          torch.stack([psd_in, dmax_in]))
        psd.copy_(out[0])
        dmax.copy_(out[1])
