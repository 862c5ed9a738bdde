"""Partition state degree (PSD) bookkeeping + convergence test (§3.3, §4).

Port of ``repro.core.state``: the host helpers are numpy copies, the device
twins take torch tensors. Only the cold-start, single-lane helpers are here;
the warm-restart and lane helpers arrive with the streaming and serving
slices.

PSD(j) is the mean per-vertex state-degree delta from the most recent time
block j was processed. Unprocessed blocks carry PSD = UNSEEN (a large
sentinel), which (a) gives every block first-visit priority and (b) blocks
convergence until the whole graph has been processed at least once.

The engine keeps psd as (P, S) with S = 1 sub-blocks (the layout of the
reference); every fold over that trailing axis is an identity.
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


def converged(psd: np.ndarray, t2: float) -> bool:
    """Paper §4: the entire graph converges when sum of PSDs < T2."""
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
