"""Training step: CE loss (+ MoE aux and z-loss), gradients, AdamW update;
port of ``repro.train.step``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
The state is ``{"params": Model, "opt": {"m", "v", "step"}}``
(:func:`init_state`, or ``repro_torch.interop.train_state_from_arrays``
from the reference's); ``step`` writes the new parameters and moments
into its tensors in place and returns it. The metrics are 0-d device
tensors (``expert_load`` an (E,) one): the step reads nothing back to the
host. Microbatching (gradient accumulation) runs the batch's row blocks
one after another, so the optimizer sees the whole batch while the
activations are bounded by one microbatch.

The reference never differentiates through a Pallas kernel (its
``use_pallas`` defaults to False and its launcher never sets it), and the
port has no backward kernel: ``use_kernel=True`` raises.

A state laid out on a mesh (``launch.sharding.distribute_state``: DTensor
parameters and moments) with a batch laid out by ``P("data", None)`` runs
the same step as a sharded program. Its microbatches are the reference's:
microbatch j is the global batch's j-th row block, laid out as the batch
(each rank gathers the batch's rows, a few integers each, and keeps its
shard of the block), so an MoE's load-balancing loss, which is not linear
in a microbatch's rows, sees the same rows as the reference's and the
unsharded step's.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import model as model_lib
from repro_torch.models.attention import local_span
from repro_torch.models.layers import wrap_local
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     named)

TrainState = dict  # {"params", "opt"}


def _no_kernel(use_kernel: bool) -> None:
    if use_kernel:
        raise NotImplementedError(
            "use_kernel=True: the reference never differentiates through a "
            "Pallas kernel, and the port has no backward kernel; train on "
            "the plain routes")


def init_state(cfg: ArchConfig, generator: torch.Generator,
               opt_cfg: AdamWConfig | None = None) -> TrainState:
    """f32 masters from ``generator`` on its device, zero moments."""
    params = model_lib.init_params(cfg, generator)
    return {"params": params, "opt": adamw_init(params)}


def loss_fn(params, cfg: ArchConfig, batch, use_kernel: bool = False):
    """(total loss, aux): the mean next-token cross entropy from an f32
    log-softmax over the last ``targets.shape[1]`` positions (a vlm's
    patch positions carry no target), plus ``1e-2 * lb_loss + 1e-3 *
    z_loss`` for the MoE archs. aux holds ``ce``, ``lb_loss``, ``z_loss``
    and ``expert_load``."""
    _no_kernel(use_kernel)
    logits, aux = model_lib.forward(params, cfg, batch)
    targets = batch["targets"]
    t = targets.shape[1]
    logits = logits[:, -t:]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    ce = nll.mean()
    total = ce
    if cfg.num_experts:
        total = total + 1e-2 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return total, {"ce": ce, "lb_loss": aux["lb_loss"],
                   "z_loss": aux["z_loss"],
                   "expert_load": aux["expert_load"]}


def _grads(model, params: dict, cfg: ArchConfig, batch):
    """(loss, aux, f32 gradients by name) of one (micro)batch; ``params``
    is ``model``'s parameters by name."""
    loss, aux = loss_fn(model, cfg, batch)
    gs = torch.autograd.grad(loss, list(params.values()),
                             materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            {k: g.to(torch.float32) for k, g in zip(params, gs)})


def _micro(v: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """The j-th of n row blocks of a batch leaf; of a DTensor, the j-th
    block of the global rows, laid out as the leaf."""
    rows = v.shape[0] // n
    if not isinstance(v, DTensor):
        return v[j * rows:(j + 1) * rows]
    mesh, pl = v.device_mesh, v.placements
    block = v.full_tensor()[j * rows:(j + 1) * rows]
    shape = block.shape
    for d, size in enumerate(shape):
        off, length = local_span(size, mesh, pl, d)
        block = block.narrow(d, off, length)
    return wrap_local(block.contiguous(), mesh, pl, shape)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, use_kernel: bool = False):
    """``step(state, batch) -> (state, metrics)``. ``batch``: ``tokens``
    and ``targets`` (B, S) integer tensors on the model's device (and a
    vlm's ``patches``, whisper's ``frames``). With ``num_microbatches`` n >
    1 the batch's rows split into n consecutive blocks; their f32 gradients
    are summed from zero in block order and divided by n once, the loss
    likewise, and the aux values are the blocks' means (the reference's
    scan). Metrics: ``loss``, ``ce``, ``lr``, ``grad_norm``, and for the
    MoE archs ``expert_load`` (the summed routed-token counts per expert
    that drive ``train.expert_balance``)."""
    _no_kernel(use_kernel)
    n = num_microbatches

    def step(state: TrainState, batch: dict):
        model = state["params"]
        params = named(model)
        if n > 1:
            gsum, lsum, auxs = None, None, []
            for j in range(n):
                mb = {k: _micro(v, j, n) for k, v in batch.items()}
                loss, aux, g = _grads(model, params, cfg, mb)
                if gsum is None:  # the reference's scan carry starts at 0
                    gsum = {k: torch.zeros_like(x) for k, x in g.items()}
                    lsum = torch.zeros_like(loss)
                for k in gsum:
                    gsum[k] += g[k]
                lsum = lsum + loss
                auxs.append(aux)
            div = torch.full((), float(n), dtype=torch.float32,
                             device=lsum.device)
            grads = {k: g / div for k, g in gsum.items()}
            loss = lsum / div
            aux = {k: torch.stack([a[k] for a in auxs]).mean(0)
                   for k in auxs[0]}
        else:
            loss, aux, grads = _grads(model, params, cfg, batch)
        _, new_opt, opt_metrics = adamw_update(grads, state["opt"], model,
                                               opt_cfg)
        metrics = {"loss": loss, **opt_metrics, "ce": aux["ce"]}
        if cfg.num_experts:
            metrics["expert_load"] = aux["expert_load"]
        return {"params": model, "opt": new_opt}, metrics

    return step
