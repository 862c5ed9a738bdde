"""AdamW (decoupled weight decay) with a cosine LR; port of
``repro.optim.adamw``, the reference's formula op for op.

The parameters are a :class:`repro_torch.models.model.Model` or any
mapping of names to tensors; the optimizer state is ``{"m", "v",
"step"}``: ``m`` and ``v`` dicts of f32 tensors keyed by the parameters'
names, ``step`` a 0-d int32 tensor on their device. :func:`adamw_update`
writes the new parameters, ``m`` and ``v`` into their tensors in place
(eager PyTorch has no buffer donation; a new copy of a 1.2B-parameter
state would be 15 GB more) and returns them. The learning rate, the bias
corrections and the clip scale are 0-d device tensors, so an update reads
nothing back to the host.

Division is by a tensor throughout, never by a Python number: on the card
``x / 2.0`` is computed as ``x * (1 / 2.0)``, which can round differently
from the reference's division. ``torch.optim.AdamW`` is not used: its
decay and bias correction are applied in another order, which rounds
differently.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def named(params) -> dict:
    """The parameters as a dict of names to tensors (a Model's
    ``named_parameters()``, or the mapping itself)."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _f32(value, device) -> torch.Tensor:
    """A 0-d f32 tensor filled on ``device`` (a fill, not a copy from the
    host: no sync)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a 0-d f32
    tensor: linear warmup to ``peak_lr``, then a cosine to ``min_lr`` at
    ``total_steps``."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = _f32(step, device)
    dev = step.device
    warm = cfg.peak_lr * step / _f32(max(cfg.warmup_steps, 1), dev)
    t = (step - cfg.warmup_steps) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), dev)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    """Zero moments in f32 for every parameter, and step 0."""
    p = named(params)
    dev = next(iter(p.values())).device
    return {"m": {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                  for k, v in p.items()},
            "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                  for k, v in p.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares. The leaves are
    added one at a time in the dict's order (a Model's: embed, then layer 0
    to L-1, each in its parameters' order, then ln_f and lm_head); the
    reference adds its stacked (L, ...) leaves in ``jax.tree.leaves``
    order, so the two sums round apart by a few f32 ulps."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(grads: dict, state: dict, params, cfg: AdamWConfig):
    """One AdamW step on ``params`` from ``grads`` (names to tensors).
    Writes the parameters and ``state``'s ``m`` and ``v`` in place, and
    returns (params, state with the new step, {"lr", "grad_norm"})."""
    p_named = named(params)
    step = state["step"] + 1
    dev = step.device
    stepf = step.to(torch.float32)
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.clip_norm, dev)
                        / torch.clamp_min(gnorm, 1e-9), max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    with torch.no_grad():
        for name, g in grads.items():
            p, m, v = p_named[name], state["m"][name], state["v"][name]
            g = g.to(torch.float32) * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            mhat = m / bc1
            vhat = v / bc2
            pf = p.to(torch.float32)
            pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                            + cfg.weight_decay * pf)
            p.copy_(pf)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
