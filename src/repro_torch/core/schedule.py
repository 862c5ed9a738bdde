"""Adaptive partition scheduling (paper Alg. 3, §4); port of
``repro.core.schedule``.

Each iteration selects the m highest-PSD hot blocks; every I2-th iteration it
also admits the n highest-PSD cold blocks, with m + n = the worker count
(here: the schedule width) and m > n. When no hot blocks remain, the full
width goes to the highest-PSD cold blocks.

Two implementations of the same policy:

  * :meth:`Scheduler.select` — numpy, host-driven loop (reference);
  * :func:`make_device_select` — torch, run on the device inside the
    device-resident superstep so scheduling never leaves the card. The two
    return the same blocks, same order, same tie-breaking
    (tests/test_torch_select.py holds both against the JAX select).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import state


@dataclasses.dataclass(frozen=True)
class Selection:
    hot_ids: np.ndarray  # (<=m,) global block ids scheduled in async mode
    cold_ids: np.ndarray  # (<=n or <=W,) block ids scheduled in sync mode


@dataclasses.dataclass
class Scheduler:
    """Host reference scheduler. ``width`` and ``i2`` are mutable: the
    adaptive engine retargets the width at repartition boundaries."""

    width: int  # W = m + n
    i2: int = 4  # cold-admission cadence
    cold_frac: float = 0.25  # n = floor(W * cold_frac) (m > n per the paper)
    min_psd: float = 0.0  # prune individually-converged blocks (see engine)

    def select(self, iteration: int, psd: np.ndarray,
               is_hot: np.ndarray) -> Selection:
        w = self.width
        psd = state.fold_subblock_psd(psd)
        live = psd >= self.min_psd  # safe: if ALL pruned, sum(psd) < T2
        hot_ids = np.flatnonzero(is_hot & live)
        cold_ids = np.flatnonzero(~is_hot & live)
        if hot_ids.size == 0:  # "only remains P_cold"
            pick = cold_ids[np.argsort(-psd[cold_ids], kind="stable")][:w]
            return Selection(hot_ids=np.empty(0, np.int64), cold_ids=pick)

        if self.i2 and iteration % self.i2 == 0:
            # I2 iteration: m hot + n cold (m > n), paper Alg. 3.
            n = int(w * self.cold_frac)
            m = w - n
        else:
            # non-I2 iteration: hot partitions have absolute priority...
            m, n = w, 0
        hot_pick = hot_ids[np.argsort(-psd[hot_ids], kind="stable")][:m]
        # ...but scheduling is work-conserving: idle workers (fewer live hot
        # blocks than m) take the next-hottest cold blocks instead.
        n = w - hot_pick.size if hot_pick.size < m else n
        cold_pick = cold_ids[np.argsort(-psd[cold_ids], kind="stable")][:n]
        return Selection(hot_ids=hot_pick, cold_ids=cold_pick)


def make_device_select(width: int, cold_frac: float,
                       min_psd: float, pad_id: int = 0):
    """torch port of :meth:`Scheduler.select` for the device-resident loop.

    Returns ``select(iteration, i2, psd, is_hot) -> (hot_rows, hot_ok,
    cold_rows, cold_ok)``: fixed-width (W,) int32 block-id slots plus bool
    validity masks, where ``hot_rows[hot_ok]`` equals ``Selection.hot_ids``
    (same blocks, same order) and likewise for cold. Tie-breaking matches
    the numpy version exactly: descending PSD, lowest block id first on
    equal PSD (a stable sort over ids in ascending order).

    ``iteration`` and ``i2`` are host ints: within a chunk the superstep
    index is known to the host (a superstep after the device ``done`` flag
    is set is a no-op whatever it selects), so the I2 cadence costs no
    device work. ``psd`` and ``is_hot`` are device tensors and nothing is
    read back.

    ``pad_id`` fills slots beyond the take counts. Those slots are never
    marked ok, and the sweep kernel skips them.
    """
    n_cold_quota = int(width * cold_frac)
    # compare in f32 exactly as the reference's weak-typed jnp comparison
    floor = float(np.float32(min_psd))

    def select(iteration: int, i2: int, psd: torch.Tensor,
               is_hot: torch.Tensor):
        dev = psd.device
        slots = torch.arange(width, device=dev)
        psd = state.fold_subblock_psd_device(psd)
        live = psd >= floor
        hot_live = is_hot & live
        cold_live = ~is_hot & live
        n_hot = hot_live.sum()
        n_cold = cold_live.sum()
        inf = torch.tensor(float("inf"), device=dev)
        # Dead slots sink to +inf: a stable ascending argsort of the negated
        # key yields (psd desc, id asc) — identical to np.flatnonzero order
        # followed by a stable sort on -psd.
        hot_order = torch.argsort(torch.where(hot_live, -psd, inf),
                                  stable=True)
        cold_order = torch.argsort(torch.where(cold_live, -psd, inf),
                                   stable=True)
        is_i2 = i2 > 0 and iteration % max(i2, 1) == 0
        m = width - n_cold_quota if is_i2 else width
        n = n_cold_quota if is_i2 else 0
        hot_take = torch.clamp(n_hot, max=m)
        # work-conserving top-up (also covers the no-hot-blocks case:
        # hot_take == 0 < m hands the full width to cold)
        n = torch.where(hot_take < m, width - hot_take, n)
        cold_take = torch.minimum(n, n_cold)

        def to_slots(order, take):
            # slots beyond the take (and beyond P when P < width) carry
            # pad_id, not whatever pruned block the argsort left there
            k = min(width, order.shape[0])
            rows = torch.full((width,), pad_id, dtype=torch.int32,
                              device=dev)
            rows[:k] = order[:k].to(torch.int32)
            return torch.where(slots < take, rows, pad_id)

        return (to_slots(hot_order, hot_take), slots < hot_take,
                to_slots(cold_order, cold_take), slots < cold_take)

    return select


def schedule_predictor(width: int, i2: int, cold_frac: float,
                       min_psd: float) -> Scheduler:
    """The out-of-core tier's lookahead: a host :class:`Scheduler` twin of
    :func:`make_device_select`. The two are decision-identical
    (tests/test_torch_select.py, tests/test_torch_ooc.py), so one numpy
    ``select`` tells the spill tier which blocks the next device superstep
    reads before the device runs it: ``repro_torch.ooc.store.SpillStore``
    pages that demand in ahead of the sweep without changing the schedule,
    and a run under a budget stays bitwise the fully resident one. The
    engine sets ``.width`` at fired repartition boundaries (the cold quota
    depends on the width, so the predictor tracks the live bucket)."""
    return Scheduler(width=width, i2=i2, cold_frac=cold_frac,
                     min_psd=min_psd)


# -- adaptive active-set helpers ---------------------------------------------
def width_ladder(width: int, min_width: int = 2) -> list[int]:
    """Descending dispatch-width buckets: the configured width, then powers
    of two below it down to ``min_width``."""
    ladder = [width]
    b = 1 << max(width.bit_length() - 1, 0)
    if b == width:
        b >>= 1
    while b >= max(min_width, 1):
        ladder.append(b)
        b >>= 1
    return ladder


def pick_width(ladder: list[int], active: int) -> int:
    """Smallest bucket that covers the active set (the widest bucket when
    none does). ``ladder`` is descending, as built by :func:`width_ladder`."""
    for wb in reversed(ladder):
        if wb >= active:
            return wb
    return ladder[0]


def admission_order(priority: np.ndarray) -> np.ndarray:
    """Lane-admission order for the query service: stable descending sort
    of per-query priorities, ties broken by submit order."""
    return np.argsort(-np.asarray(priority, dtype=np.float64),
                      kind="stable")


def adaptive_i2(i2: int, num_blocks: int, perturbed: int,
                max_scale: int = 8) -> int:
    """Delta-proportional cold-admission cadence for warm restarts: a batch
    that perturbs only a small fraction of the blocks admits cold blocks
    proportionally less often (up to ``max_scale`` times rarer). Batches
    touching >= a quarter of the blocks keep the configured cadence."""
    if i2 <= 0:
        return i2
    frac = perturbed / max(num_blocks, 1)
    scale = int(np.clip(round(0.25 / max(frac, 1e-9)), 1, max_scale))
    return i2 * scale
