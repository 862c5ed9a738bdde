"""Activity-directed residency policy (pure numpy, no device state); port
of ``repro.ooc.prefetch``.

The engine predicts its own future: the host
:class:`repro_torch.core.schedule.Scheduler` is decision-identical to the
device select (``make_device_select``), so one numpy ``select`` tells the
spill tier which blocks the next superstep reads. These helpers turn that
prediction and the PSD/calm activity state into residency decisions:

  * :func:`demand_blocks`: the block set a superstep touches (scheduled hot
    and cold slots, plus the pad block);
  * :func:`rank_fetch_candidates`: non-resident blocks worth staging ahead
    of need, hottest PSD first (UNSEEN re-heats sort to the front);
  * :func:`rank_victims`: eviction order, most calm first, then lowest PSD,
    then block id. Retired and calm blocks (the paper's cold partition) are
    the spill set; ``retired_only`` restricts a speculative swap to blocks
    the active set has left, while a demand eviction takes the calmest
    victim regardless.

Every ranking is deterministic (stable orders, id tie-breaks), so a run
under a budget makes the same residency decisions every time. The
reference marks each helper ``@deterministic`` (its contracts module, which
the port has not yet; ROADMAP Queue 1 item 8 adds the mark back).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schedule import Selection


def demand_blocks(sel: Selection, pad_id: int) -> np.ndarray:
    """Unique block ids the next superstep reads: every scheduled hot/cold
    slot plus ``pad_id`` (the slots beyond the take counts carry it)."""
    return np.unique(np.concatenate(
        [sel.hot_ids.astype(np.int64), sel.cold_ids.astype(np.int64),
         np.array([pad_id], dtype=np.int64)]))


def fold_calm(calm: np.ndarray | None) -> np.ndarray | None:
    """(P, S) sub-block calm counters -> block calm: a block is only as
    retired as its least calm sub-block (the engine's ``_active_count``)."""
    if calm is None:
        return None
    calm = np.asarray(calm)
    return calm.min(axis=-1) if calm.ndim == 2 else calm


def rank_fetch_candidates(psd_blk: np.ndarray, resident: np.ndarray,
                          floor: float) -> np.ndarray:
    """Non-resident blocks worth prefetching, hottest first. Blocks under
    the scheduler's pruning floor are left out: they cannot be scheduled
    until something re-arms them. Ties break by block id."""
    cand = np.flatnonzero(~resident & (psd_blk >= floor))
    return cand[np.argsort(-psd_blk[cand], kind="stable")]


def rank_victims(psd_blk: np.ndarray, calm_blk: np.ndarray | None,
                 resident: np.ndarray, protect: np.ndarray,
                 retire_after: int, retired_only: bool) -> np.ndarray:
    """Eviction candidates among the resident, unprotected blocks, coldest
    first: most consecutive calm supersteps, then lowest PSD, then block
    id. With ``retired_only`` only blocks past the retire threshold
    qualify (a speculative prefetch must not evict the active set). Without
    it the calmest block goes regardless (a demand eviction must make
    room). ``protect`` is a (P,) bool mask (demand set and pins)."""
    cand = np.flatnonzero(resident & ~protect)
    if calm_blk is None:
        return cand[np.argsort(psd_blk[cand], kind="stable")]
    if retired_only:
        cand = cand[calm_blk[cand] >= retire_after]
    # np.lexsort: the last key is primary -> calm desc, then psd asc, then
    # the ascending id order for full ties
    return cand[np.lexsort((psd_blk[cand], -calm_blk[cand]))]
