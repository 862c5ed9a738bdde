"""Query-serving demo: mixed user traffic against a live mutating graph, on
the card. Mirrors the reference's examples/graph_service.py.

A powerlaw graph converges once under the streaming engine (PageRank as
the resident host program), then user-style queries (k-source shortest
paths and personalized PageRank) are admitted into lane slots while
synthetic delta batches mutate the graph underneath. Each query pins the
epoch it was submitted against (snapshot isolation: its answer is the
fixpoint of the graph AS OF submission), compatible queries batch into one
fused multi-lane run through the lane sweep kernel, and admission is
ordered hottest-frontier-first (paper Eq. 1 activity).

    PYTHONPATH=src python -m repro_torch.graph_service [--n 10000] \
        [--lanes 8] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.engine import EngineConfig
from repro_torch.serve import Query, QueryService
from repro_torch.stream import StreamingEngine, synthetic_stream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--batches", type=int, default=2,
                    help="delta batches ingested between query waves")
    ap.add_argument("--batch-size", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = G.powerlaw_graph(args.n, avg_deg=8, seed=1, weighted=True)
    cfg = EngineConfig(t2=1e-8, width=16, block_size=512)
    se = StreamingEngine(g, A.pagerank(), cfg, device=args.device)
    svc = QueryService(se, max_lanes=args.lanes)
    print(f"host program converged: "
          f"{se.initial_result.metrics.iterations} iterations; "
          f"serving with {args.lanes} lane slots")

    rng = np.random.default_rng(7)
    deltas = synthetic_stream(g, args.batches, args.batch_size, seed=3,
                              delete_frac=0.2, weighted=True)

    # wave 1: a mix of traversals and personalized ranks, pinned to epoch 0
    for _ in range(args.queries // 2):
        s = int(rng.integers(0, args.n))
        if rng.random() < 0.7:
            svc.submit(Query(kind="sssp", source=s))
        else:
            svc.submit(Query(kind="ppr",
                             reset=[s, int(rng.integers(0, args.n))]))
    # ... the graph mutates while those queries are still pending ...
    for d in deltas:
        rep = svc.ingest(d)
        print(f"ingest: +{rep.inserts}/-{rep.deletes} edges, "
              f"{rep.dirty_blocks}/{rep.num_blocks} dirty, "
              f"latency {rep.latency_s * 1e3:.0f} ms")
    # ... wave 2 pins the mutated epoch
    for _ in range(args.queries - args.queries // 2):
        s = int(rng.integers(0, args.n))
        svc.submit(Query(kind="sssp", source=s))

    results = svc.run_pending()
    print(f"\n{'qid':>4s} {'kind':>5s} {'epoch':>6s} {'lanes':>6s} "
          f"{'iters':>6s} {'wait ms':>8s} {'run ms':>8s} {'conv':>5s}")
    for r in results:
        print(f"{r.query_id:4d} {r.kind:>5s} {r.epoch:6d} {r.lanes:6d} "
              f"{r.iterations:6d} {r.wait_s * 1e3:8.1f} "
              f"{r.run_s * 1e3:8.1f} {str(r.converged):>5s}")
    if not all(r.converged for r in results):
        raise SystemExit("a query lane did not converge")

    m = svc.metrics
    print(f"\n{m.queries} queries in {m.lane_batches} lane batches "
          f"({m.lane_utilization:.0%} lane utilization), "
          f"{m.queries_per_s:.2f} queries/s of engine time; "
          f"{m.epochs_pinned} epochs pinned, "
          f"{se.metrics.snapshots_preserved} snapshot(s) device-copied for "
          f"isolation, {m.stale_answers} answers served from a pinned "
          f"(pre-ingest) epoch")


if __name__ == "__main__":
    main()
