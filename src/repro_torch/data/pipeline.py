"""Deterministic synthetic LM data pipeline; a copy of
``repro.data.pipeline`` (numpy only: its batches are bitwise the
reference's for the same ``(seed, step)``).

Sequences follow a noisy affine recurrence over the vocab, so there IS
learnable structure (the loss drops in ``repro_torch.train_lm``).
Deterministic in (seed, step): restarts resume mid-stream exactly, the
property the checkpoint/restart tests assert. Batches are built host-side
as numpy and moved to the device by the trainer; at scale each host builds
only its own shard (``build_shard``)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05

    def _sequn(self, rng: np.random.Generator, n: int):
        a, c = 31, 17
        x = np.empty((n, self.seq_len + 1), np.int32)
        x[:, 0] = rng.integers(0, self.vocab_size, n)
        for t in range(self.seq_len):
            nxt = (x[:, t] * a + c) % self.vocab_size
            flip = rng.random(n) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab_size, n), nxt)
            x[:, t + 1] = nxt
        return x

    def batch(self, step: int) -> dict:
        """Global batch for ``step`` (deterministic)."""
        rng = np.random.default_rng((self.seed, step))
        x = self._sequn(rng, self.global_batch)
        return {"tokens": x[:, :-1], "targets": x[:, 1:]}

    def build_shard(self, step: int, host_id: int, num_hosts: int) -> dict:
        """Per-host shard of the global batch (data-parallel ingestion)."""
        b = self.batch(step)
        per = self.global_batch // num_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in b.items()}
