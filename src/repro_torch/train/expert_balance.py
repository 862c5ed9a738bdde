"""Structure-aware expert rebalancing at runtime; port of
``repro.train.expert_balance``.

Mapping: experts are vertices; tokens routed to an expert are its
in-edges; expert-parallel shards are the partitions. The paper's moves
become:

  * activity degree  -> EMA routed-token count blended with instantaneous
                        load (Eq. 1's D_o + alpha*D_i re-read);
  * dynamic repartitioning on a growing cadence (I1) -> periodic greedy
    re-binning of experts onto shards by activity (rebalance_plan);
  * O(n) bookkeeping -> permuting the expert axis of the MoE parameters
    (and the optimizer moments) together with the router columns, which is
    FUNCTION-PRESERVING: the model computes the same outputs, only the
    shard each expert lives on changes.

The trainer (``launch/train.py``) runs the rebalancer at its mesh's
"model" size, the expert-parallel shards, as the reference's does (one
shard on one device). The bookkeeping is the reference's numpy, on the
port's ``models.moe.expert_activity`` and ``rebalance_plan``; on a
sharded state the permutation gathers each expert tensor's rows in the
new order and lays them out as they were.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import replicated_like

EXPERT_TENSORS = ("w_gate", "w_up", "w_down")


def permute_expert_axis(params, perm: np.ndarray):
    """Relabel experts: slot perm[i] <- expert i, in every MoE layer's
    (E, ...) expert tensors and the router's (D, E) output columns (shared
    experts stay). ``params``: a :class:`repro_torch.models.model.Model`,
    permuted in place and returned, or a dict of tensors keyed by its
    parameter names (``m``, ``v``), for which a new dict is returned."""
    inv = np.argsort(perm)  # new slot j holds old expert inv[j]
    if isinstance(params, torch.nn.Module):
        with torch.no_grad():
            for name, p in params.named_parameters():
                q = _permuted(name, p, inv)
                if q is not p:
                    p.copy_(q)
        return params
    return {name: _permuted(name, p, inv) for name, p in params.items()}


def _permuted(name: str, p: torch.Tensor, inv: np.ndarray) -> torch.Tensor:
    parts = name.split(".")
    if len(parts) < 2 or parts[-2] != "moe":
        return p
    idx = replicated_like(torch.as_tensor(inv, dtype=torch.int64)
                          .to(p.device), p)
    if parts[-1] in EXPERT_TENSORS:
        q = p.index_select(0, idx)
    elif parts[-1] == "router":
        q = p.index_select(1, idx)
    else:
        return p
    if isinstance(p, DTensor):  # back to p's own layout
        q = q.redistribute(p.device_mesh, p.placements)
    return q


@dataclasses.dataclass
class ExpertRebalancer:
    """Paper Alg. 2's cadence, for experts: observe loads, re-bin on a
    growing interval when the predicted imbalance justifies the move."""

    num_experts: int
    num_shards: int
    alpha: float = 0.75  # Eq. 1 blend
    ema: float = 0.9
    interval: int = 50  # I1: steps between rebalance checks
    growth: float = 1.5  # the paper's growing cadence
    min_gain: float = 0.05  # skip moves worth <5% imbalance reduction
    load_ema: np.ndarray | None = None
    next_at: int = 0
    moves: int = 0

    def __post_init__(self):
        if self.load_ema is None:
            self.load_ema = np.zeros(self.num_experts)
        self.next_at = self.interval

    def shard_imbalance(self, activity: np.ndarray) -> float:
        """max-shard / mean-shard predicted load under current placement."""
        per = self.num_experts // self.num_shards
        loads = activity.reshape(self.num_shards, per).sum(1)
        return float(loads.max() / max(loads.mean(), 1e-9))

    def observe(self, expert_load: np.ndarray, step: int):
        """Feed this step's (E,) routed-token counts. Returns a permutation
        (slot perm[i] <- expert i) when a rebalance should happen, else
        None. The caller applies it with permute_expert_axis to the
        parameters AND the optimizer moments."""
        activity, self.load_ema = moe_lib.expert_activity(
            self.load_ema, np.asarray(expert_load, np.float64),
            alpha=self.alpha, ema=self.ema)
        if step < self.next_at:
            return None
        self.interval = max(int(np.ceil(self.interval * self.growth)),
                            self.interval + 1)
        self.next_at = step + self.interval
        before = self.shard_imbalance(activity)
        perm = moe_lib.rebalance_plan(activity, self.num_shards)
        after = self.shard_imbalance(activity[np.argsort(perm)])
        if before - after < self.min_gain * before:
            return None
        self.moves += 1
        return perm
