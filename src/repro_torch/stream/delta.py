"""Edge deltas (:class:`DeltaBatch`) + a reproducible synthetic stream;
numpy copy of ``repro.stream.delta``.

The stream generator models the regimes the paper's big-data motivation
names (graphs "incrementally described" over time): preferential-attachment
inserts (the rich-get-richer growth that KEEPS the degree distribution
power-law as the graph evolves), uniform random deletes (unfollow /
link-rot churn), and bursty hotspots (a celebrity moment: a batch
concentrates its inserts onto one vertex, re-heating a cold region).

Semantics — fixed vertex set, edge multiset deltas, applied
deletes-then-inserts:

  * an insert appends one (src, dst, w) edge copy (parallel copies allowed,
    matching ``from_edges``);
  * a delete removes ALL live parallel copies of its (src, dst) pair —
    pair-granular deletion keeps the semantics identical between the
    incremental path and a cold ``from_edges`` rebuild, with no ambiguity
    about WHICH copy dies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph, edges_of


def _ids(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).reshape(-1)


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One atomic mutation step: deletes applied first, then inserts."""

    ins_src: np.ndarray  # (I,) int64
    ins_dst: np.ndarray  # (I,) int64
    ins_w: np.ndarray  # (I,) float32
    del_src: np.ndarray  # (D,) int64 — pair deletes (all parallel copies)
    del_dst: np.ndarray  # (D,) int64

    def __post_init__(self):
        for name in ("ins_src", "ins_dst", "del_src", "del_dst"):
            object.__setattr__(self, name, _ids(getattr(self, name)))
        object.__setattr__(
            self, "ins_w",
            np.asarray(self.ins_w, dtype=np.float32).reshape(-1))
        if not (self.ins_src.size == self.ins_dst.size == self.ins_w.size):
            raise ValueError("insert arrays must have equal length")
        if self.del_src.size != self.del_dst.size:
            raise ValueError("delete arrays must have equal length")

    @property
    def n_inserts(self) -> int:
        return int(self.ins_src.size)

    @property
    def n_deletes(self) -> int:
        return int(self.del_src.size)

    @classmethod
    def empty(cls) -> "DeltaBatch":
        z = np.empty(0, dtype=np.int64)
        return cls(ins_src=z, ins_dst=z, ins_w=np.empty(0, np.float32),
                   del_src=z, del_dst=z)

    @classmethod
    def of(cls, ins=(), dels=(), weighted: bool = False,
           seed: int = 0) -> "DeltaBatch":
        """Convenience constructor from [(u, v), ...] / [(u, v, w), ...]."""
        rng = np.random.default_rng(seed)
        isrc, idst, iw = [], [], []
        for e in ins:
            isrc.append(e[0])
            idst.append(e[1])
            iw.append(e[2] if len(e) > 2
                      else (rng.uniform(0.1, 1.0) if weighted else 1.0))
        dsrc = [e[0] for e in dels]
        ddst = [e[1] for e in dels]
        return cls(ins_src=np.array(isrc), ins_dst=np.array(idst),
                   ins_w=np.array(iw, dtype=np.float32),
                   del_src=np.array(dsrc), del_dst=np.array(ddst))


def synthetic_stream(g: Graph, num_batches: int, batch_size: int,
                     seed: int = 0, delete_frac: float = 0.2,
                     hotspot_prob: float = 0.25, hotspot_frac: float = 0.5,
                     weighted: bool = False) -> list[DeltaBatch]:
    """Reproducible delta stream over ``g``'s live edge multiset.

    Each batch carries ~``batch_size`` operations: ``delete_frac`` of them
    pair-deletes sampled from the CURRENT live edges (so deletes always hit
    something), the rest preferential-attachment inserts (dst ~ in_deg + 1,
    src uniform). With probability ``hotspot_prob`` a batch is a burst:
    ``hotspot_frac`` of its inserts all land on one random hotspot vertex.
    The generator tracks the live multiset across batches (delete-all-pairs
    semantics, exactly like the engine), so the same seed always produces
    the same mutated graph trajectory.
    """
    if g.n < 2:
        raise ValueError("stream needs at least 2 vertices")
    rng = np.random.default_rng(seed)
    src, dst, w = edges_of(g)
    src = src.copy()
    dst = dst.copy()
    w = w.astype(np.float32).copy()
    in_deg = np.bincount(dst, minlength=g.n).astype(np.float64)
    n = g.n
    batches: list[DeltaBatch] = []

    for _ in range(num_batches):
        n_del = min(int(round(batch_size * delete_frac)), src.size)
        n_ins = max(batch_size - n_del, 0)

        # deletes: distinct pairs drawn from the live multiset
        if n_del and src.size:
            pick = rng.choice(src.size, size=n_del, replace=False)
            dkeys = np.unique(src[pick] * n + dst[pick])
            dsrc, ddst = dkeys // n, dkeys % n
        else:
            dsrc = ddst = np.empty(0, dtype=np.int64)

        # inserts: preferential attachment + optional hotspot burst
        p = in_deg + 1.0
        p /= p.sum()
        idst = rng.choice(n, size=n_ins, p=p)
        isrc = rng.integers(0, n, size=n_ins)
        if n_ins and rng.random() < hotspot_prob:
            hot = int(rng.integers(0, n))
            burst = rng.random(n_ins) < hotspot_frac
            idst[burst] = hot
        iw = (rng.uniform(0.1, 1.0, size=n_ins).astype(np.float32)
              if weighted else np.ones(n_ins, dtype=np.float32))

        batches.append(DeltaBatch(ins_src=isrc, ins_dst=idst, ins_w=iw,
                                  del_src=dsrc, del_dst=ddst))

        # advance the live multiset: deletes first, then inserts
        if dsrc.size:
            keys = src * n + dst
            gone = np.isin(keys, dsrc * n + ddst)
            np.subtract.at(in_deg, dst[gone], 1.0)
            src, dst, w = src[~gone], dst[~gone], w[~gone]
        if n_ins:
            src = np.concatenate([src, isrc])
            dst = np.concatenate([dst, idst])
            w = np.concatenate([w, iw])
            np.add.at(in_deg, idst, 1.0)

    return batches


def apply_to_coo(src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int,
                 batch: DeltaBatch) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Reference (non-incremental) application of a batch to a COO edge
    list: the oracle the incremental path is tested against."""
    if batch.n_deletes:
        keys = src * n + dst
        gone = np.isin(keys, batch.del_src * n + batch.del_dst)
        src, dst, w = src[~gone], dst[~gone], w[~gone]
    if batch.n_inserts:
        src = np.concatenate([src, batch.ins_src])
        dst = np.concatenate([dst, batch.ins_dst])
        w = np.concatenate([w.astype(np.float32), batch.ins_w])
    return src, dst, w
