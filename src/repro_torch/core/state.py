"""Partition state degree (PSD) bookkeeping + convergence test (§3.3, §4).

Port of ``repro.core.state``: the host helpers are numpy copies, the device
twins take torch tensors.

PSD(j) is the mean per-vertex state-degree delta from the most recent time
block j was processed. Unprocessed blocks carry PSD = UNSEEN (a large
sentinel), which (a) gives every block first-visit priority and (b) blocks
convergence until the whole graph has been processed at least once.

Hierarchical partitions (sub-blocks): with ``EngineConfig.subblocks = S``
every block is split into S contiguous vertex ranges and the PSD / calm
state is (P, S). Scheduling stays block-granular: the block priority is the
MAX over its sub-blocks, and convergence is SUM over blocks of that max. At
S = 1 every fold over the trailing axis is an identity.
"""
from __future__ import annotations

import numpy as np
import torch

UNSEEN = np.float32(1e30)


def init_psd(num_blocks: int, subblocks: int | None = None) -> np.ndarray:
    """(P,) cold-start PSD vector, or (P, S) when ``subblocks`` is given."""
    if subblocks is None:
        return np.full(num_blocks, UNSEEN, dtype=np.float32)
    return np.full((num_blocks, subblocks), UNSEEN, dtype=np.float32)


def fold_subblock_psd(psd: np.ndarray) -> np.ndarray:
    """(P,) block scheduling priority from a (P, S) per-sub-block PSD: the
    max over sub-blocks. 1-D input passes through."""
    psd = np.asarray(psd)
    return psd.max(axis=-1) if psd.ndim == 2 else psd


def fold_subblock_psd_device(psd: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`fold_subblock_psd`."""
    return psd.amax(dim=-1) if psd.dim() == 2 else psd


def warm_psd(num_blocks: int, dirty: np.ndarray,
             bump: np.ndarray | None = None) -> np.ndarray:
    """PSD vector for a warm re-start over an already-converged state
    (streaming re-heat): dirty blocks carry the UNSEEN sentinel, clean
    blocks start individually converged (PSD 0) or at the finite aux
    staleness ``bump`` when given."""
    psd = np.zeros(num_blocks, dtype=np.float32)
    if bump is not None:
        psd = np.maximum(psd, np.asarray(bump, dtype=np.float32))
    psd[np.asarray(dirty)] = UNSEEN
    return psd


def warm_calm(num_blocks: int, armed: np.ndarray,
              retire_after: int) -> np.ndarray:
    """Block-local convergence counters for a warm restart: armed blocks
    start fresh (calm 0), clean ones start retired (``retire_after``) and
    re-enter only when a bump lifts their PSD back over the floor."""
    calm = np.full(num_blocks, retire_after, dtype=np.int32)
    calm[np.asarray(armed, dtype=bool)] = 0
    return calm


def warm_psd_sub(num_blocks: int, subblocks: int, dirty_sub: np.ndarray,
                 bump: np.ndarray | None = None) -> np.ndarray:
    """(P, S) warm-restart PSD: the sub-block refinement of
    :func:`warm_psd`. ``bump`` is (P, S), or (P,) applied to every
    sub-block of a bumped block."""
    psd = np.zeros((num_blocks, subblocks), dtype=np.float32)
    if bump is not None:
        b = np.asarray(bump, dtype=np.float32)
        psd = np.maximum(psd, b if b.ndim == 2 else b[:, None])
    psd[np.asarray(dirty_sub, dtype=bool)] = UNSEEN
    return psd


def warm_calm_sub(num_blocks: int, subblocks: int, armed_sub: np.ndarray,
                  retire_after: int) -> np.ndarray:
    """(P, S) warm-restart calm counters: armed sub-blocks start fresh,
    clean ones start retired (see :func:`warm_calm`)."""
    calm = np.full((num_blocks, subblocks), retire_after, dtype=np.int32)
    calm[np.asarray(armed_sub, dtype=bool)] = 0
    return calm


def init_lane_psd(num_blocks: int, lane_active: np.ndarray,
                  subblocks: int | None = None) -> np.ndarray:
    """(P, L) per-lane PSD start state for a multi-lane query run, or
    (P, S, L) when ``subblocks`` is given: active lanes carry UNSEEN in
    every (sub-)block, padding lanes start at 0 (individually converged
    from the first superstep)."""
    lane_active = np.asarray(lane_active, dtype=bool)
    shape = ((num_blocks, lane_active.shape[0]) if subblocks is None
             else (num_blocks, subblocks, lane_active.shape[0]))
    psd = np.zeros(shape, dtype=np.float32)
    psd[..., lane_active] = UNSEEN
    return psd


def fold_lane_psd(psd: np.ndarray, lane_done: np.ndarray) -> np.ndarray:
    """(P,) block priority from (P, L) per-lane PSDs, or (P, S, L): the max
    over the lanes still running (and over sub-blocks), so a block hot in
    ANY live lane is schedulable and a retired lane stops pricing blocks."""
    psd = np.asarray(psd, dtype=np.float32)
    lane_done = np.asarray(lane_done, dtype=bool)
    mask = lane_done[None, :] if psd.ndim == 2 else lane_done[None, None, :]
    masked = np.where(mask, 0.0, psd)
    if masked.shape[-1] == 0:
        return np.zeros(masked.shape[0], np.float32)
    out = masked.max(axis=-1)  # over lanes
    return out.max(axis=-1) if out.ndim == 2 else out  # over sub-blocks


def fold_lane_psd_device(psd: torch.Tensor,
                         lane_done: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`fold_lane_psd`."""
    mask = lane_done[None, :] if psd.dim() == 2 else lane_done[None, None, :]
    out = torch.where(mask, 0.0, psd).amax(dim=-1)
    return out.amax(dim=-1) if out.dim() == 2 else out


def lane_sub_psd_device(psd: torch.Tensor,
                        lane_done: torch.Tensor) -> torch.Tensor:
    """(P, S) lane-folded per-sub-block priority from a (P, S, L) lane PSD:
    the max over the lanes still running. This is the one sub-block mask
    the masked lane sweep applies (``>= floor``), shared by the lanes. A
    (P, L) input is masked, not folded, as in the reference."""
    if psd.dim() == 2:
        return torch.where(lane_done[None, :], 0.0, psd)
    return torch.where(lane_done[None, None, :], 0.0, psd).amax(dim=-1)


def lane_converged_device(psd: torch.Tensor, t2: float) -> torch.Tensor:
    """(L,) per-lane SUM < T2 on the device; with a sub-block axis the
    summand is each block's max over sub-blocks. The f32 sum's order is
    torch's, not XLA's (see :func:`converged_device`)."""
    blk = psd.amax(dim=1) if psd.dim() == 3 else psd
    return blk.sum(dim=0) < float(np.float32(t2))


def converged(psd: np.ndarray, t2: float) -> bool:
    """Paper §4: the entire graph converges when sum of PSDs < T2. With a
    sub-block axis the per-block summand is the max over sub-blocks."""
    folded = fold_subblock_psd(np.asarray(psd, dtype=np.float64))
    return bool(folded.sum() < t2)


def converged_device(psd: torch.Tensor, t2: float) -> torch.Tensor:
    """SUM(PSD) < T2 on the device, as a 0-d bool tensor (no host sync).
    f32 sum, as in the reference: UNSEEN sentinels keep the sum far above
    any realistic T2, and near the threshold every PSD is tiny. The f32
    reduction order differs from XLA's, so a sum within an ulp of T2 can
    decide differently than the reference."""
    return fold_subblock_psd_device(psd).sum() < float(np.float32(t2))


def psd_threshold(psd: np.ndarray, hot_ratio: float = 0.1) -> float:
    """Adaptive T1-for-PSD used at repartition time: the hot_ratio quantile of
    the currently-seen PSDs."""
    seen = psd[psd < UNSEEN]
    if seen.size == 0:
        return float("inf")
    q = np.quantile(seen.astype(np.float64), 1.0 - hot_ratio)
    return float(max(q, 1e-12))
