"""Streaming demo: a long-lived engine serving edge deltas beats rerunning
a batch job per snapshot, on the card. Mirrors the reference's
examples/streaming_graph.py.

A core-periphery graph (the paper's convergence-skew regime) converges
once, then a synthetic delta stream — preferential-attachment inserts,
random unfollows, the occasional celebrity burst — is ingested batch by
batch. Each batch re-heats only the dirty (sub-)blocks and reconverges from
the previous fixpoint; the cold column reruns the full convergence from
scratch on the same mutated graph.

With ``--resident-blocks`` the warm engine runs OUT OF CORE: only that many
partition blocks keep their edge tiles on the card, the rest spill to the
host (or to npz segments under ``--spill-dir``) and page back in ahead of
the schedule; the values stay bitwise those of a fully resident run.
``--snapshot-dir`` then saves the live epoch, restores it in a fresh
engine, and warm-reconverges in a handful of supersteps instead of a cold
start.

    PYTHONPATH=src python -m repro_torch.streaming_graph [--n 10000] \
        [--subblocks 4] [--resident-blocks 8] [--spill-dir DIR] \
        [--snapshot-dir DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.engine import EngineConfig
from repro_torch.stream import StreamConfig, StreamingEngine, synthetic_stream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=150)
    ap.add_argument("--subblocks", type=int, default=1,
                    help="sub-blocks per partition block (hierarchical "
                         "activity tracking; 1 = flat blocks)")
    ap.add_argument("--resident-blocks", type=int, default=None,
                    help="device budget for the warm engine's edge tiles "
                         "(out-of-core; default: fully resident)")
    ap.add_argument("--spill-dir", default=None,
                    help="spill evicted tiles to npz segments here instead "
                         "of the host cache (needs --resident-blocks)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="save the final epoch here, then restore and "
                         "warm-reconverge a fresh engine from it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = G.core_periphery_graph(args.n, avg_deg=8, seed=1, chords=1,
                               weighted=True)
    cfg = EngineConfig(t2=1e-8, width=16, block_size=512,
                       subblocks=args.subblocks)
    prog = A.pagerank()

    warm_cfg = dataclasses.replace(cfg, resident_blocks=args.resident_blocks,
                                   spill_dir=args.spill_dir)
    warm = StreamingEngine(g, prog, warm_cfg, device=args.device)
    cold = StreamingEngine(g, prog, cfg, StreamConfig(warm=False),
                           device=args.device)
    print(f"initial convergence: {warm.initial_result.metrics.iterations} "
          f"iterations, {warm.initial_result.metrics.edges_processed} edges")

    batches = synthetic_stream(g, args.batches, args.batch_size, seed=3,
                               delete_frac=0.2, weighted=True)
    print(f"\n{'batch':>5s} {'+ins':>5s} {'-del':>5s} {'dirty':>9s} "
          f"{'width':>6s} {'retired':>8s} "
          f"{'warm edges':>11s} {'cold edges':>11s} {'warm ms':>8s} "
          f"{'cold ms':>8s}")
    for i, b in enumerate(batches):
        rw = warm.ingest(b)
        rc = cold.ingest(b)
        print(f"{i:5d} {rw.inserts:5d} {rw.deletes:5d} "
              f"{rw.dirty_blocks:3d}/{rw.num_blocks:<3d}   "
              f"{rw.mean_dispatch_width:6.1f} "
              f"{rw.blocks_retired:3d}/{rw.num_blocks:<3d} "
              f"{rw.edges_processed:11d} {rc.edges_processed:11d} "
              f"{rw.latency_s * 1e3:8.1f} {rc.latency_s * 1e3:8.1f}")

    if not np.allclose(warm.values, cold.values, rtol=1e-3, atol=1e-5):
        raise SystemExit("warm and cold disagree!")
    mw, mc = warm.metrics, cold.metrics
    print(f"\nwarm == cold (rtol=1e-3, atol=1e-5) over {mw.batches} batches: "
          f"{mc.edges_reprocessed / max(mw.edges_reprocessed, 1):.2f}x fewer "
          f"edges reprocessed, "
          f"{mc.latency_per_batch_s / max(mw.latency_per_batch_s, 1e-9):.2f}x "
          f"faster per batch, mean dirty fraction {mw.dirty_frac:.2f} "
          f"({mw.appended_blocks} in-place appends, {mw.rebuilt_blocks} "
          f"block rebuilds, {mw.plan_rebuilds} plan rebuilds); "
          f"upload fraction {mw.upload_frac:.4f}")
    if args.subblocks > 1:
        print(f"hierarchical partitions (S={args.subblocks}): mean sub-block "
              f"dirty fraction {mw.subblock_dirty_frac:.2f} vs block "
              f"fraction {mw.dirty_frac:.2f}, mean sub-blocks swept per "
              f"block load {mw.mean_subblock_dispatch:.2f}")
    if args.resident_blocks is not None:
        P = warm.engine.plan.num_blocks
        init = warm.initial_result.metrics
        # paging never changes the schedule, so the budget run is bitwise
        # a fully resident warm engine's (tests/test_torch_ooc.py); here
        # the cold column cross-checks the converged values above
        print(f"out-of-core: {args.resident_blocks}/{P} blocks resident; "
              f"spill traffic incl. initial run: "
              f"{mw.spill_evictions + init.spill_evictions} evictions, "
              f"{(mw.bytes_spilled + init.bytes_spilled) / 1e6:.1f} MB out, "
              f"{(mw.bytes_fetched + init.bytes_fetched) / 1e6:.1f} MB in, "
              f"prefetch hit rate {mw.prefetch_hit_rate:.2f}")
    if args.snapshot_dir:
        warm.save_epoch(args.snapshot_dir).wait()
        back = StreamingEngine.restore(args.snapshot_dir, A.pagerank(),
                                       warm_cfg, verify=True,
                                       device=args.device)
        wm = back.initial_result.metrics
        if not np.allclose(back.values, warm.values, rtol=1e-4, atol=1e-6):
            raise SystemExit("restored epoch disagrees with the live engine!")
        print(f"\nepoch persistence: saved epoch {warm.epoch} to "
              f"{args.snapshot_dir}, restored and warm-reconverged in "
              f"{wm.iterations} supersteps (the initial cold start took "
              f"{warm.initial_result.metrics.iterations})")


if __name__ == "__main__":
    main()
