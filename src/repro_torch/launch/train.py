"""End-to-end training driver; port of ``repro/launch/train.py``.

Trains on the card unless ``--device cpu`` is given: streams the
synthetic pipeline, checkpoints on a cadence and on SIGTERM through
``repro_torch.ckpt.CheckpointManager`` (the reference's format, through
``interop.train_state_to_arrays``: a checkpoint written by either package
resumes in the other), auto-resumes from the latest checkpoint, feeds the
straggler monitor, rebalances MoE experts (``--expert-rebalance``), and
can simulate a crash after a step (``--fail-at``: it saves and exits 42)
to exercise the restart.

On one device without ``--nproc`` the state is plain tensors. With
``--nproc K`` it spawns K ranks (gloo on ``--device cpu``, NCCL on the
cards, over a FileStore in a temporary directory) and, on each, builds
the ("data", "model") mesh ``make_host_mesh(model=--model-axis)`` over
them, as the reference builds it over its devices: the state laid out by
``state_specs``, the batch by ``P("data", None)``, a resume through
``restore(shardings=...)`` onto the mesh, and the expert rebalancer at
the mesh's model size. Rank 0 logs and writes the checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3p2_1b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 20 --batch 4 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --model-axis 2 --nproc 4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.ft import StragglerMonitor
from repro_torch.interop import (checkpoint_specs, train_state_from_arrays,
                                 train_state_to_arrays)
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import init_state, make_train_step


def _config(args):
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
        if args.scale != 1.0:
            s = args.scale
            cfg = dataclasses.replace(
                cfg, d_model=int(cfg.d_model * s),
                d_ff=int(cfg.d_ff * s) if cfg.d_ff else 0,
                num_layers=max(int(cfg.num_layers * s), 1))
    return cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash after this step (FT test)")
    ap.add_argument("--expert-rebalance", action="store_true",
                    help="structure-aware expert re-binning (MoE archs): "
                         "the paper's dynamic repartitioning at runtime")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--nproc", type=int, default=0,
                    help="ranks to spawn, each training on the mesh (0: "
                         "this process alone, on one device)")
    return ap


def main(argv=None):
    """Trains as the arguments say; returns the losses (rank 0's)."""
    args = _parser().parse_args(argv)
    if args.nproc:
        device = resolve_device(args.device)
        return run_ranks(_rank_main, args.nproc, device.type,
                         (argv if argv is not None else sys.argv[1:],),
                         timeout=3600.0)[0]
    return _train(args)


def _rank_main(rank: int, argv) -> list:
    return _train(_parser().parse_args(argv))


def _train(args) -> list:
    device = resolve_device(args.device)
    mesh = None
    if args.model_axis > 1 or args.nproc:
        if not dist.is_initialized():
            raise ValueError(f"--model-axis {args.model_axis} needs a group "
                             "of ranks: pass --nproc")
        mesh = make_host_mesh(model=args.model_axis,
                              device_type=device.type)
    lead = mesh is None or dist.get_rank() == 0

    def log(msg):
        if lead:
            print(msg, flush=True)

    cfg = _config(args)
    opt_cfg = AdamWConfig(peak_lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5 + 1))
    step_fn = make_train_step(cfg, opt_cfg, num_microbatches=args.micro)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    sspecs = (shard_lib.state_specs({"params": Model(cfg, "meta")}, mesh)
              if mesh is not None else None)
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        if mesh is None:
            tree, meta = ckpt.restore()
        else:
            tree, meta = ckpt.restore(shardings=checkpoint_specs(sspecs),
                                      mesh=mesh)
        state = train_state_from_arrays(cfg, tree, device)
        start_step = meta["step"]
        log(f"[train] resumed from step {start_step}")
    else:
        gen = torch.Generator(device).manual_seed(args.seed)
        state = init_state(cfg, gen, opt_cfg)
        if mesh is not None:
            state = shard_lib.distribute_state(state, mesh, sspecs)
    if mesh is not None:
        bspec = shard_lib.to_placements(("data", None), mesh)

        def to_device(v):
            return shard_lib.distribute(torch.from_numpy(v).to(device),
                                        mesh, bspec)
    else:
        def to_device(v):
            return torch.from_numpy(v).to(device)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    monitor = StragglerMonitor()
    rebalancer = None
    if args.expert_rebalance and cfg.num_experts:
        from repro_torch.train.expert_balance import (ExpertRebalancer,
                                                      permute_expert_axis)
        shards = (mesh.shape[mesh.mesh_dim_names.index("model")]
                  if mesh is not None else 1)
        rebalancer = ExpertRebalancer(
            num_experts=cfg.experts_eff, num_shards=shards,
            interval=max(args.steps // 8, 5))
        log(f"[train] expert rebalancer over {shards} shard(s)")

    def save(step):
        arrays = train_state_to_arrays(cfg, state)  # every rank gathers
        if lead:
            ckpt.save(step, arrays)

    def wait():
        if lead:
            ckpt.wait()
        if mesh is not None:
            dist.barrier()

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.update(now=True))
    losses = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {k: to_device(v) for k, v in data.batch(step).items()}
            state, metrics = step_fn(state, batch)
            metrics = {k: shard_lib.full(v) for k, v in metrics.items()}
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            health = monitor.observe(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                log(f"[train] step={step} loss={loss:.4f} "
                    f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                    + (" STRAGGLER" if health["straggler"] else ""))
            if rebalancer is not None:
                perm = rebalancer.observe(
                    metrics["expert_load"].cpu().numpy().astype(np.float64),
                    step + 1)
                if perm is not None:
                    # function-preserving expert relabel -> balanced shards
                    permute_expert_axis(state["params"], perm)
                    for mom in ("m", "v"):
                        state["opt"][mom] = permute_expert_axis(
                            state["opt"][mom], perm)
                    log(f"[train] step={step} expert rebalance #"
                        f"{rebalancer.moves} applied")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if args.fail_at is not None and step + 1 >= args.fail_at:
                log(f"[train] simulating failure at step {step + 1}")
                if ckpt:
                    save(step + 1)
                    wait()
                sys.exit(42)
            if stop["now"]:
                log("[train] SIGTERM: checkpointing and exiting")
                if ckpt:
                    save(step + 1)
                    wait()
                sys.exit(0)
        if ckpt:
            save(args.steps)
            wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if losses:
        log(f"[train] done: first loss {losses[0]:.4f} -> last "
            f"{losses[-1]:.4f}")
    else:
        log(f"[train] nothing to do (resumed at step {start_step} "
            f">= {args.steps})")
    return losses


if __name__ == "__main__":
    main()
