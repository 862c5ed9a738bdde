"""QueryService: batched multi-source query sessions over a live graph;
port of ``repro.serve.service``.

The read-side counterpart of :class:`repro_torch.stream.StreamingEngine`:
user-style queries (k-source SSSP/BFS traversals, personalized PageRank)
are admitted into **lane slots**, batched by program family, and executed
as one fused multi-lane run per batch (:class:`LaneEngine`), so L queries
pay one schedule, one partition-load stream and one chunk loop.

Session model (synchronous and deterministic: "concurrency" is the
interleaving of submits, ingests and runs):

  * ``submit(query)`` pins the CURRENT streaming epoch (snapshot isolation:
    the answer is computed on the graph as of submission, however many
    delta batches land before the query runs);
  * ``ingest(batch)`` forwards to the streaming engine, whose preamble
    device-copies the pinned epoch state before the commits mutate it;
  * ``run_pending()`` groups pending queries by (epoch, family), orders
    admission by activity priority (hottest frontier first,
    ``schedule.admission_order``), packs them into lane batches of
    ``max_lanes`` (padded to a fixed width), and runs each batch on its
    pinned epoch.

One LaneEngine is kept per (epoch engine, family): epochs that only mutate
edge data in place reuse it; a plan rebuild makes a new one, and the old
engine's lane engines (and their device scratch) are dropped once no
pending query pins that engine.

Out-of-core budgets (``EngineConfig.resident_blocks``): pinned epochs
survive eviction. The spill tier's pre-eviction hook preserves every live
pin before the eviction zeroes rows on the card, and a pin taken while
blocks are already spilled fills the holes of its copy from the tier's
truth, run table included (``StreamingEngine.snapshot`` /
``EpochState.ed``), so lane batches always read a whole, consistent edge
state even when the live engine keeps a fraction of the graph resident.

With a :mod:`repro_torch.obs` recorder installed, each lane batch runs in a
``query_batch`` span (lanes, family, epoch, then its supersteps), which
ends at the batch's last device read.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.algorithms import LANE_FAMILIES, LaneProgram
from repro_torch.core.engine import coupling_from_counts
from repro_torch.core.metrics import ServeMetrics, Timer
from repro_torch.core.schedule import admission_order
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.lanes import LaneEngine
from repro_torch.stream.delta import DeltaBatch
from repro_torch.stream.engine import EpochState, StreamingEngine


@dataclasses.dataclass(frozen=True)
class Query:
    """One user query. ``kind`` picks the lane family:

      * ``sssp`` / ``bfs``: single-source traversal from ``source``;
      * ``ppr``: personalized PageRank restarting into ``reset`` (vertex
        ids, uniform over the set; or a dense (n,) distribution), with
        ``damping``.
    """

    kind: str
    source: int | None = None
    reset: object = None
    damping: float = 0.85

    def lane_param(self):
        if self.kind in ("sssp", "bfs"):
            return self.source
        return np.asarray(self.reset)

    def family_key(self) -> tuple:
        return ((self.kind, self.damping) if self.kind == "ppr"
                else (self.kind,))


@dataclasses.dataclass
class QueryResult:
    query_id: int
    kind: str
    epoch: int  # the pinned epoch the answer is consistent with
    values: np.ndarray  # (n,), original vertex ids
    iterations: int  # supersteps until THIS lane's convergence mask set
    batch_iterations: int  # supersteps of the whole lane batch
    lanes: int  # admitted lanes in the batch that served this query
    run_s: float  # the batch's execution wall time
    wait_s: float  # submit -> completion, minus the batch run time
    converged: bool

    @property
    def latency_s(self) -> float:
        return self.wait_s + self.run_s


@dataclasses.dataclass
class _Pending:
    qid: int
    query: Query
    epoch_state: EpochState  # strong ref: keeps the pin alive until served
    t_submit: float
    priority: float


class QueryService:
    """Long-lived query facade over one StreamingEngine."""

    def __init__(self, streaming: StreamingEngine, max_lanes: int = 8,
                 prewarm: bool = True):
        if max_lanes < 1:
            raise ValueError("max_lanes must be >= 1")
        self.streaming = streaming
        self.max_lanes = max_lanes
        self.n = streaming.n
        self.metrics = ServeMetrics()
        self._prewarm = prewarm
        self._pending: list[_Pending] = []
        self._epoch_state: EpochState | None = None
        # id(epoch engine) -> {family_key -> LaneEngine}, for the live
        # engine and the engines pending queries pin (each LaneEngine holds
        # its engine, so the id stays taken while the entry exists)
        self._lane_engines: dict[int, dict[tuple, LaneEngine]] = {}
        self._next_id = 0
        self._epochs_pinned: set[int] = set()
        self.last_batch = None  # LaneResult of the last batch: counters

    # -- admission -----------------------------------------------------------
    def submit(self, query: Query) -> int:
        """Admit a query; pins the current epoch and returns a query id."""
        family = self._family(query.family_key())
        if family.needs_symmetric != self.streaming.program.needs_symmetric:
            raise ValueError(
                f"family {family.name} needs_symmetric="
                f"{family.needs_symmetric} does not match the host "
                "program's storage: symmetric and asymmetric tile layouts "
                "cannot share an epoch")
        if query.kind in ("sssp", "bfs"):
            if not (query.source is not None
                    and 0 <= int(query.source) < self.n):
                raise ValueError(f"query source must be in [0, {self.n})")
        else:
            self._validate_reset(query.reset)
        es = self._pin()
        qid = self._next_id
        self._next_id += 1
        self._pending.append(_Pending(
            qid=qid, query=query, epoch_state=es,
            t_submit=time.perf_counter(),
            priority=self._priority(query, es)))
        if es.epoch not in self._epochs_pinned:
            self._epochs_pinned.add(es.epoch)
            self.metrics.epochs_pinned += 1
        return qid

    @property
    def pending(self) -> int:
        return len(self._pending)

    def ingest(self, batch: DeltaBatch):
        """Forward a delta batch to the write side. Pending queries keep
        their pinned epoch (the streaming preamble preserves it)."""
        self._epoch_state = None  # the next submit pins the new epoch
        report = self.streaming.ingest(batch)
        self._drop_unpinned_engines()
        return report

    # -- execution -----------------------------------------------------------
    def run_pending(self) -> list[QueryResult]:
        """Execute every pending query, batched by (epoch, family), lanes
        admitted hottest-frontier-first. Returns results in completion
        order (batch by batch)."""
        groups: dict[tuple, list[_Pending]] = {}
        for p in self._pending:
            groups.setdefault((p.epoch_state.epoch, p.query.family_key()),
                              []).append(p)
        self._pending = []
        # drop the admission cache: with nothing pending, holding the pin
        # would make the next ingest copy an epoch nobody will read
        self._epoch_state = None
        plan: list[list[_Pending]] = []
        for key in sorted(groups, key=lambda k: (k[0], k[1])):
            batch = groups[key]
            order = admission_order(np.array([p.priority for p in batch]))
            ranked = [batch[i] for i in order]
            plan.extend(ranked[at:at + self.max_lanes]
                        for at in range(0, len(ranked), self.max_lanes))
        results: list[QueryResult] = []
        i = 0
        try:
            for i, batch in enumerate(plan):
                results.extend(self._run_batch(batch))
        except Exception:
            # a failing batch consumes only its own queries; everything not
            # yet served goes back on the queue
            for rest in plan[i + 1:]:
                self._pending.extend(rest)
            raise
        finally:
            self._drop_unpinned_engines()
        return results

    def _run_batch(self, pend: list[_Pending]) -> list[QueryResult]:
        es = pend[0].epoch_state
        query0 = pend[0].query
        family = self._family(query0.family_key())
        lane_eng = self._lane_engine(es, query0.family_key(), family)
        k = len(pend)
        # pad to the fixed lane width; padding lanes start converged and are
        # never billed
        params = [p.query.lane_param() for p in pend]
        params += [params[0]] * (self.max_lanes - k)
        lane_active = np.zeros(self.max_lanes, dtype=bool)
        lane_active[:k] = True
        values0, vconst = family.lane_init(self.n, params)
        aux = (family.aux_fn(es.out_deg, es.in_deg)
               if family.aux_fn is not None
               else np.zeros(es.out_deg.shape[0], np.float32))
        ed = es.ed._replace(aux=torch.as_tensor(
            np.asarray(aux, np.float32)).to(es.ed.src.device))
        coupling = coupling_from_counts(
            es.coupling_counts, family, es.engine.plan.block_size)
        with obs_trace.span("query_batch", cat="serve", lanes=k,
                            family=query0.family_key()[0],
                            epoch=es.epoch) as sp, Timer() as t:
            res = lane_eng.run(ed=ed, coupling=coupling, values0=values0,
                               vconst=vconst, lane_active=lane_active,
                               edge_counts=es.edge_counts)
            sp.set(iterations=res.metrics.iterations)
        done_at = time.perf_counter()
        out: list[QueryResult] = []
        for lane, p in enumerate(pend):
            out.append(QueryResult(
                query_id=p.qid, kind=p.query.kind, epoch=es.epoch,
                values=res.values[:, lane],
                iterations=int(res.lane_iterations[lane]),
                batch_iterations=res.metrics.iterations, lanes=k,
                run_s=t.elapsed,
                wait_s=max(done_at - p.t_submit - t.elapsed, 0.0),
                converged=bool(res.lane_converged[lane])))
        m = self.metrics
        m.queries += k
        m.lane_batches += 1
        m.lanes_admitted += k
        m.lane_slots += self.max_lanes
        m.run_time_s += t.elapsed
        m.wait_time_s += sum(r.wait_s for r in out)
        m.iterations += res.metrics.iterations
        m.blocks_retired += res.metrics.blocks_retired
        m.stale_answers += k if es.epoch < self.streaming.epoch else 0
        self.last_batch = res
        return out

    # -- internals -----------------------------------------------------------
    def _validate_reset(self, reset) -> np.ndarray:
        """Admission-time validation of a ppr personalization: a dense (n,)
        float distribution or a non-empty id set within [0, n). Returns the
        seed vertex ids (priority scoring reuses them)."""
        if reset is None:
            raise ValueError("ppr query needs a reset set")
        rs = np.asarray(reset)
        if rs.ndim == 1 and rs.size == self.n and rs.dtype.kind == "f":
            col = rs.astype(np.float64)
            if col.min() < 0 or not np.isclose(col.sum(), 1.0, rtol=1e-4):
                raise ValueError("dense ppr reset must be a distribution "
                                 "(non-negative, summing to 1)")
            return np.flatnonzero(rs > 0)
        ids = rs.astype(np.int64).reshape(-1)
        if ids.size == 0 or ids.min() < 0 or ids.max() >= self.n:
            raise ValueError("ppr reset must be non-empty vertex ids in "
                             f"[0, {self.n}) or a dense (n,) distribution")
        return ids

    def _pin(self) -> EpochState:
        es = self._epoch_state
        if es is None or es.epoch != self.streaming.epoch:
            es = self.streaming.snapshot()
            self._epoch_state = es
        return es

    @staticmethod
    def _family(key: tuple) -> LaneProgram:
        kind = key[0]
        if kind not in LANE_FAMILIES:
            raise ValueError(f"unknown query kind {kind!r} "
                             f"(have {sorted(LANE_FAMILIES)})")
        return (LANE_FAMILIES[kind](damping=key[1]) if kind == "ppr"
                else LANE_FAMILIES[kind]())

    def _lane_engine(self, es: EpochState, key: tuple,
                     family: LaneProgram) -> LaneEngine:
        eng = self._lane_engines.get(id(es.engine), {}).get(key)
        if eng is None:
            eng = LaneEngine(es.engine, family)
            if self._prewarm:
                eng.prewarm(self.max_lanes)
            self._lane_engines.setdefault(id(es.engine), {})[key] = eng
        return eng

    def _drop_unpinned_engines(self) -> None:
        """Forget the lane engines of epoch engines that neither the
        streaming engine nor a pending query holds (a plan rebuild's old
        engine), so its device state and their scratch can be freed."""
        keep = {id(self.streaming.engine)} | {
            id(p.epoch_state.engine) for p in self._pending}
        for k in [k for k in self._lane_engines if k not in keep]:
            del self._lane_engines[k]

    def _priority(self, query: Query, es: EpochState) -> float:
        """Admission priority: the pinned epoch's activity D(v) = out +
        alpha * in of the query's seed vertices (max over a ppr reset set),
        the Eq. 1 quantity that ranks unseen blocks."""
        plan = es.engine.plan
        if query.kind in ("sssp", "bfs"):
            seeds = np.array([int(query.source)])
        else:
            seeds = self._validate_reset(query.reset)
            if seeds.size == 0:  # dense vector with empty support
                return 0.0
        perm = plan.inv[seeds]
        act = es.out_deg[perm] + plan.alpha * es.in_deg[perm]
        return float(act.max())
