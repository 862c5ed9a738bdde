"""End-to-end training driver; port of ``repro/launch/train.py``.

Trains on one device, the card unless ``--device cpu`` is given: streams
the synthetic pipeline, checkpoints on a cadence and on SIGTERM through
``repro_torch.ckpt.CheckpointManager`` (the reference's format, through
``interop.train_state_to_arrays``: a checkpoint written by either package
resumes in the other), auto-resumes from the latest checkpoint, feeds the
straggler monitor, rebalances MoE experts (``--expert-rebalance``), and
can simulate a crash after a step (``--fail-at``: it saves and exits 42)
to exercise the restart. There is no mesh yet (ROADMAP Queue 1 item 10):
``--model-axis`` above 1 raises, and the rebalancer runs at one shard, as
the reference's does on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3p2_1b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 20 --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.ft import StragglerMonitor
from repro_torch.interop import (train_state_from_arrays,
                                 train_state_to_arrays)
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


def main(argv=None):
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
    args = ap.parse_args(argv)
    if args.model_axis > 1:
        raise NotImplementedError(
            "--model-axis > 1 needs the port's device mesh (ROADMAP Queue 1 "
            "item 10); the port trains on one device")
    device = resolve_device(args.device)

    cfg = _config(args)
    opt_cfg = AdamWConfig(peak_lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5 + 1))
    step_fn = make_train_step(cfg, opt_cfg, num_microbatches=args.micro)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        tree, meta = ckpt.restore()
        state = train_state_from_arrays(cfg, tree, device)
        start_step = meta["step"]
        print(f"[train] resumed from step {start_step}")
    else:
        gen = torch.Generator(device).manual_seed(args.seed)
        state = init_state(cfg, gen, opt_cfg)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    monitor = StragglerMonitor()
    rebalancer = None
    if args.expert_rebalance and cfg.num_experts:
        from repro_torch.train.expert_balance import (ExpertRebalancer,
                                                      permute_expert_axis)
        rebalancer = ExpertRebalancer(
            num_experts=cfg.experts_eff, num_shards=1,
            interval=max(args.steps // 8, 5))

    def save(step):
        ckpt.save(step, train_state_to_arrays(cfg, state))

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.update(now=True))
    losses = []
    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch(step).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            health = monitor.observe(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                      + (" STRAGGLER" if health["straggler"] else ""),
                      flush=True)
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
                    print(f"[train] step={step} expert rebalance #"
                          f"{rebalancer.moves} applied")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if args.fail_at is not None and step + 1 >= args.fail_at:
                print(f"[train] simulating failure at step {step + 1}")
                if ckpt:
                    save(step + 1)
                    ckpt.wait()
                sys.exit(42)
            if stop["now"]:
                print("[train] SIGTERM: checkpointing and exiting")
                if ckpt:
                    save(step + 1)
                    ckpt.wait()
                sys.exit(0)
        if ckpt:
            save(args.steps)
            ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    else:
        print(f"[train] nothing to do (resumed at step {start_step} "
              f">= {args.steps})")
    return losses


if __name__ == "__main__":
    main()
