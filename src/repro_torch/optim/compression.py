"""int8 error-feedback gradient compression; port of
``repro.optim.compression`` over a ``torch.distributed`` process group.

At 1000+ nodes the cross-pod gradient all-reduce dominates the step;
8-bit quantization with error feedback cuts those bytes 4x with no
measurable convergence loss (the residual re-enters next step's
gradient). The reference's ``lax.psum(...) / n`` over a mesh axis is an
``all_reduce`` sum over ``group`` divided by the group's size. Rounding is
half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def int8_encode(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf)) / torch.full(
        (), 127.0, device=xf.device) + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_psum(grads: dict, residuals: dict, group=None):
    """Error-feedback compressed mean over ``group`` (the default group
    when None) of each gradient in ``grads`` (names to tensors), with this
    rank's ``residuals`` (the same names, f32). Returns (mean-reduced
    grads in each gradient's dtype, new residuals)."""
    size = float(dist.get_world_size(group))
    out, new_res = {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32) + residuals[name]
        q, scale = int8_encode(gf)
        deq = int8_decode(q, scale)
        new_res[name] = gf - deq  # what quantization lost, fed back next step
        summed = deq.clone()
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        n = torch.full((), size, device=summed.device)
        out[name] = (summed / n).to(g.dtype)
    return out, new_res
