"""Run all five paper algorithms (PR, CC, SSSP, BFS, BC) on three graph
families through both engines and print the comparison table, on the card.
Mirrors the reference's examples/graph_suite.py.

    PYTHONPATH=src python -m repro_torch.graph_suite [--n N] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.baseline import BaselineEngine
from repro_torch.core.engine import (EngineConfig, StructureAwareEngine,
                                     betweenness)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, dev = args.n, args.device
    graphs = {
        "powerlaw": G.powerlaw_graph(n, avg_deg=8, seed=1, weighted=True),
        "core-periphery": G.core_periphery_graph(n, avg_deg=8, seed=1,
                                                 chords=1, weighted=True),
        "road-like": G.uniform_graph(n // 4, deg=4, seed=2, weighted=True),
    }
    cfg = EngineConfig(t2=1e-8, width=16, block_size=512)
    print(f"{'graph':16s}{'algo':10s}{'base-loads':>11s}{'sa-loads':>9s}"
          f"{'base-upd':>10s}{'sa-upd':>9s}{'agree':>6s}")
    agree = []
    for gname, g in graphs.items():
        for aname, prog in [("pagerank", A.pagerank()), ("cc", A.cc()),
                            ("sssp", A.sssp(0)), ("bfs", A.bfs(0))]:
            base = BaselineEngine(g, prog, cfg, frontier=False,
                                  device=dev).run()
            sa = StructureAwareEngine(g, prog, cfg, device=dev).run()
            # both engines stop within t2 of the fixpoint, not at it:
            # compare at the tolerance t2 guarantees (hub ranks ~1e-2)
            ok = np.allclose(np.minimum(base.values, 1e18),
                             np.minimum(sa.values, 1e18),
                             rtol=1e-3, atol=1e-5)
            agree.append(ok)
            print(f"{gname:16s}{aname:10s}{base.metrics.block_loads:>11d}"
                  f"{sa.metrics.block_loads:>9d}{base.metrics.updates:>10d}"
                  f"{sa.metrics.updates:>9d}{str(ok):>6s}")
        bc_sa, m_sa = betweenness(g, [0, 1], cfg, structure_aware=True,
                                  device=dev)
        bc_b, m_b = betweenness(g, [0, 1], cfg, structure_aware=False,
                                device=dev)
        ok = np.allclose(bc_sa, bc_b, rtol=1e-4, atol=1e-6)
        agree.append(ok)
        print(f"{gname:16s}{'bc':10s}{m_b.block_loads:>11d}"
              f"{m_sa.block_loads:>9d}{m_b.updates:>10d}"
              f"{m_sa.updates:>9d}{str(ok):>6s}")
    return agree


if __name__ == "__main__":
    main()
