"""Dynamic structure-based repartitioning (paper Alg. 2, §3.3).

Two modes:
  * ``barrier``  — monotone-cooling algorithms (PageRank): hot blocks only
    ever become cold, so a single integer barrier suffices ("only needs to
    maintain a Vertex_ID variable"). The barrier never moves backwards.
  * ``universal`` — non-monotone algorithms (SSSP/BFS/CC): cold blocks can
    re-heat ("cold vertices will first become hot and then converge"), so
    every block is re-labelled from its PSD against the threshold.

Re-labelling is pure bookkeeping over (P,) arrays — O(P) <= O(n) — matching
the paper's cost claim. The repartition *cadence* grows with the iteration
count (§3.3 last paragraph): interval_{k+1} = ceil(interval_k * growth).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import state


@dataclasses.dataclass
class RepartitionState:
    mode: str  # 'barrier' | 'universal'
    is_hot: np.ndarray  # (P,) bool, current labels
    barrier: int  # first cold block (barrier mode)
    interval: int  # iterations until next repartition
    growth: float = 1.5
    next_at: int = 0

    @classmethod
    def create(cls, num_blocks: int, born_barrier: int, mode: str,
               interval: int = 4, growth: float = 1.5) -> "RepartitionState":
        is_hot = np.zeros(num_blocks, dtype=bool)
        is_hot[:born_barrier] = True
        return cls(mode=mode, is_hot=is_hot, barrier=born_barrier,
                   interval=interval, growth=growth, next_at=interval)

    @classmethod
    def warm(cls, is_hot: np.ndarray, interval: int = 4,
             growth: float = 1.5) -> "RepartitionState":
        """Warm re-start over a converged state (streaming re-heat): the hot
        set is the arbitrary dirty-block mask, not a prefix barrier, so the
        mode is always 'universal' — re-heating converged blocks is exactly
        the cold->hot path, even for monotone-cooling programs."""
        is_hot = np.array(is_hot, dtype=bool)
        return cls(mode="universal", is_hot=is_hot, barrier=0,
                   interval=interval, growth=growth, next_at=interval)

    def chunk_end(self, max_iterations: int) -> int:
        """Exclusive end of the device-resident iteration chunk: the fused
        engine runs through the iteration at which the repartition cadence
        fires (inclusive), then hands control back to the host."""
        return min(self.next_at + 1, max_iterations)

    def maybe_repartition(self, iteration: int, psd: np.ndarray,
                          hot_ratio: float = 0.1) -> bool:
        """Re-label blocks if the cadence fires. Returns True if it ran."""
        if iteration < self.next_at:
            return False
        thr = state.psd_threshold(psd, hot_ratio)
        seen = psd < state.UNSEEN
        if self.mode == "barrier":
            # Move the barrier over trailing hot blocks whose activity fell
            # below the threshold. Monotone: never re-heats.
            b = self.barrier
            while b > 0 and seen[b - 1] and psd[b - 1] < thr:
                b -= 1
            self.barrier = b
            self.is_hot[:] = False
            self.is_hot[:b] = True
        else:
            hot = psd >= thr
            # unseen blocks keep their current label
            self.is_hot = np.where(seen, hot, self.is_hot)
        # growing cadence
        self.interval = max(int(np.ceil(self.interval * self.growth)),
                            self.interval + 1)
        self.next_at = iteration + self.interval
        return True
