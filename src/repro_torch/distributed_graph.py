"""The paper's engine over a ``torch.distributed`` process group; the port's
counterpart of ``examples/distributed_graph.py``.

    PYTHONPATH=src python -m repro_torch.distributed_graph --nproc 4 --device cpu

Runs the local structure-aware engine and the distributed engine on
PageRank over ``core_periphery_graph(n)`` and prints the iterations of both
and whether they agree. ``--nproc K`` spawns K ranks with
``torch.multiprocessing`` over a ``FileStore`` in a temporary directory:
gloo on ``--device cpu``, NCCL on ``cuda`` (rank r on ``cuda:r``, K at most
the card count). Without it the distributed engine runs in this process as a
world of one. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.distributed import DistributedEngine
from repro_torch.core.engine import (EngineConfig, StructureAwareEngine,
                                     resolve_device)
from repro_torch.launch.mesh import run_ranks as mesh_run_ranks


def _run_jobs(rank: int, jobs: list, device_type: str) -> list:
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    return [DistributedEngine(g, A.REGISTRY[name](), cfg,
                              blocks_per_device=bpd, device=device).run()
            for g, name, cfg, bpd in jobs]


def run_ranks(jobs: list, nproc: int, device="cuda",
              timeout: float = 600.0) -> list:
    """Run ``jobs`` ((graph, program name, EngineConfig, blocks_per_device)
    tuples) through :class:`DistributedEngine` on a group of ``nproc``
    spawned ranks (``launch.mesh.run_ranks``). Returns each rank's list of
    RunResults. Raises ``TimeoutError`` (after killing the ranks) when
    they outlast ``timeout`` seconds."""
    dev = resolve_device(device)
    if dev.type == "cuda" and nproc > torch.cuda.device_count():
        raise ValueError(f"{nproc} ranks need {nproc} cards; "
                         f"{torch.cuda.device_count()} present")
    return mesh_run_ranks(_run_jobs, nproc, dev.type, (jobs, dev.type),
                          timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--nproc", type=int, default=0,
                    help="ranks to spawn (0: a world of one in process)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    g = G.core_periphery_graph(args.n, avg_deg=8, seed=1, chords=1)
    prog = A.pagerank()
    cfg = EngineConfig(t2=1e-9, width=8, block_size=512)
    local = StructureAwareEngine(g, prog, cfg, device=device).run()
    if args.nproc:
        ranks = run_ranks([(g, "pagerank", cfg, None)], args.nproc, device)
        dist_r = ranks[0][0]
        same = all(np.array_equal(r[0].values, dist_r.values)
                   for r in ranks)
    else:
        dist_r = DistributedEngine(g, prog, cfg, device=device).run()
        same = True
    ok = np.allclose(local.values, dist_r.values, rtol=1e-5, atol=1e-9)
    print(f"ranks={max(args.nproc, 1)} device={device.type} "
          f"local iters={local.metrics.iterations} "
          f"dist iters={dist_r.metrics.iterations} "
          f"ranks agree={same} agree={ok}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
