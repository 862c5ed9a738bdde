"""Quickstart: the paper's structure-aware engine vs the Gemini-style
baseline on a convergence-skewed power-law graph (PageRank), on the card.
Mirrors the reference's examples/quickstart.py.

    PYTHONPATH=src python -m repro_torch.quickstart [--n N] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.baseline import BaselineEngine
from repro_torch.core.engine import EngineConfig, StructureAwareEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = G.core_periphery_graph(args.n, avg_deg=8, seed=1, chords=1)
    prog = A.pagerank()
    cfg = EngineConfig(t2=1e-9, width=16, block_size=512)

    base = BaselineEngine(g, prog, cfg, frontier=False,
                          device=args.device).run()
    sa = StructureAwareEngine(g, prog, cfg, device=args.device).run()

    if not np.allclose(base.values, sa.values, rtol=1e-4, atol=1e-7):
        raise SystemExit("engines disagree!")
    print(f"{'':14s}{'iters':>8s}{'updates':>12s}{'loads':>8s}{'MB':>10s}")
    for name, r in [("baseline", base), ("structure-aware", sa)]:
        m = r.metrics
        print(f"{name:14s}{m.iterations:8d}{m.updates:12d}"
              f"{m.block_loads:8d}{m.bytes_loaded/1e6:10.1f}")
    m0, m1 = base.metrics, sa.metrics
    print(f"\nstructure-aware gain: {m0.updates/m1.updates:.2f}x fewer "
          f"updates, {m0.block_loads/m1.block_loads:.2f}x fewer partition "
          f"loads, {m0.bytes_loaded/m1.bytes_loaded:.2f}x less I/O")


if __name__ == "__main__":
    main()
