"""Mixture-of-Experts FFN: token-choice top-k, sort-based capacity dispatch.

The port of ``repro/models/moe.py``, in plain torch: the reference
computes routing, dispatch and the expert products outside any Pallas
kernel. Each batch row is a dispatch group. Within a group the (token,
slot) assignments are sorted stably by expert id, each takes the next free
position of its expert's buffer, and positions past the capacity drop
(their expert output reads back as 0; the shared experts and the residual
still reach the token). All groups dispatch at once into one buffer laid
out expert-major, (E, B, C + 1, D): each expert's rows of every group are
contiguous, so each expert weight is one batched matrix product with no
copy of the buffer, and row C of each group takes the dropped
assignments and is never read back.

What fixes the numbers, where they could differ from the reference:

* the router is rounded to the compute dtype first (the reference casts
  the whole ``moe`` subtree) and the logits are taken in f32;
* ties of the top-k go to the lower expert id, as ``lax.top_k``: a stable
  descending sort, not ``torch.topk``, whose order among equals is not
  specified;
* padded experts (``num_experts`` above ``num_real_experts``) are outside
  the softmax, the top-k and the dispatch altogether: the reference masks
  their logits to -1e30, which gives them probability 0 exactly, so they
  never win a slot while ``top_k`` <= the real experts, and padding cannot
  change a bit of the output;
* the combine sums each token's k gated outputs one at a time in
  ascending expert id, rounding after each add, which is the order of the
  reference's scatter-add over the expert-sorted list; an atomic
  ``index_add_`` on the card would add in no fixed order;
* no host sync: counts by ``scatter_add_``, dropped rows to a spare row C
  that reads back as 0 (no boolean indexing, no ``nonzero``, no
  ``.item()``).

``expert_activity`` and ``rebalance_plan`` (the structure-aware expert
schedule, numpy) are copied from the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import (arange_like, keep_shards, local,
                                       silu, wrap_local)


def capacity(s: int, top_k: int, num_real: int, capacity_factor: float
             ) -> int:
    """Rows of each expert's buffer for a group of ``s`` tokens: the
    reference's ``max(int(s * k / E * cf), k)`` (a decode step drops
    nothing)."""
    return max(int(s * top_k / num_real * capacity_factor), top_k)


def route(x: torch.Tensor, router: torch.Tensor, *, num_experts: int,
          top_k: int, norm_topk: bool = True,
          num_real_experts: int | None = None):
    """Router of ``moe_ffn``. x: (B, S, D); router (D, E) in x's dtype.
    Returns (logits (B, S, E) f32 with padded experts at -1e30, probs
    (B, S, E) f32, gates (B, S, k) f32, eidx (B, S, k) int64)."""
    real = num_real_experts or num_experts
    logits = x.float() @ router.float()
    probs = torch.softmax(logits[..., :real], dim=-1)
    if real < num_experts:  # out of place: a DTensor takes no slice writes
        logits = torch.where(arange_like(num_experts, logits) < real,
                             logits, -1e30)
        probs = F.pad(probs, (0, num_experts - real))
    gates, eidx = torch.sort(probs[..., :real], dim=-1, descending=True,
                             stable=True)
    gates, eidx = gates[..., :top_k], eidx[..., :top_k]
    if norm_topk:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gates, eidx


def _group_dispatch(x: torch.Tensor, eidx: torch.Tensor, num_experts: int,
                    cap: int):
    """Every group at once. x: (B, S, D); eidx: (B, S, k). Returns the
    buffer (E, B, C + 1, D), each expert's rows of every group side by side
    for one batched product per weight (row C of each group holds the
    dropped assignments and is never read back), and each assignment's row
    of the buffer's flat (E * B * (C + 1), D) view in (token, slot) order,
    (B, S, k), at row C where it dropped."""
    b, s, d = x.shape
    k = eidx.shape[-1]
    c1 = cap + 1
    flat_e = eidx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # stable by expert id
    e_sorted = torch.gather(flat_e, 1, order)
    counts = torch.zeros(b, num_experts, dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(s * k, device=x.device) - torch.gather(seg_start, 1,
                                                              e_sorted)
    group = torch.arange(b, device=x.device)[:, None]
    row_sorted = (e_sorted * b + group) * c1 + torch.clamp_max(pos, cap)
    row = torch.empty_like(row_sorted).scatter_(1, order, row_sorted)
    buf = torch.zeros(num_experts * b * c1, d, dtype=x.dtype,
                      device=x.device)
    # rows inside the capacity are distinct; the dropped ones all land on
    # their group's row C
    buf.index_copy_(0, row.reshape(-1),
                    x[:, :, None].expand(b, s, k, d).reshape(-1, d))
    return buf.view(num_experts, b, c1, d), row.view(b, s, k)


def _group_combine(out_rows: torch.Tensor, row: torch.Tensor,
                   gates: torch.Tensor, eidx: torch.Tensor,
                   cap: int) -> torch.Tensor:
    """out_rows: (E * B * (C + 1), D); row, gates, eidx: (B, S, k). Each
    token's k gated outputs summed in ascending expert id, rounded to the
    buffer's dtype after each add; a dropped assignment (row C) reads 0."""
    b, s, k = row.shape
    up = torch.argsort(eidx, dim=-1)  # a token's k experts are distinct
    row, gates = torch.gather(row, 2, up), torch.gather(gates, 2, up)
    vals = out_rows.index_select(0, row.reshape(-1)).view(b, s, k, -1)
    vals = torch.where((row % (cap + 1) == cap)[..., None], 0, vals)
    vals = vals * gates.to(out_rows.dtype)[..., None]
    out = vals[:, :, 0]
    for j in range(1, k):
        out = out + vals[:, :, j]
    return out


class _Groups:
    """A sharded program's dispatch and combine. Each batch row is a
    dispatch group of its own, so the groups are laid out whole on each
    rank (``x``'s batch shards, replicated over every other axis: what the
    batch axes give a DTensor activation) and dispatched and combined
    rank-locally, on each rank's rows, by the plain functions. The buffer
    is (E, B, C + 1, D) sharded on B as x is on its batch; the expert
    products on it take DTensor's rules (expert-sharded weights shard it
    on E); the combine gathers every expert's rows of the rank's groups
    back (``redistribute``) first. In-place writes into a fresh buffer are
    rank-local here: a DTensor does not take them."""

    def __init__(self, x: DTensor):
        self.mesh = x.device_mesh
        self.grp = keep_shards(x, (0,))

    def _on(self, dim: int) -> list:  # the groups' shards on tensor dim
        return [Shard(dim) if isinstance(p, Shard) else p for p in self.grp]

    def _local(self, t: DTensor, dim: int = 0) -> torch.Tensor:
        return local(t, self._on(dim))

    def _wrap(self, t: torch.Tensor, dim: int, shape) -> DTensor:
        return wrap_local(t, self.mesh, self._on(dim), shape)

    def dispatch(self, x, eidx, num_experts: int, cap: int):
        buf, row = _group_dispatch(self._local(x), self._local(eidx),
                                   num_experts, cap)
        b = x.shape[0]
        return (self._wrap(buf, 1, (num_experts, b, *buf.shape[2:])),
                self._wrap(row, 0, (b, *row.shape[1:])))

    def combine(self, ob, row, gates, eidx, cap: int):
        e, _, d = ob.shape
        rows = self._local(ob.view(e, row.shape[0], cap + 1, d), 1)
        y = _group_combine(rows.reshape(-1, d), self._local(row),
                           self._local(gates), self._local(eidx), cap)
        return self._wrap(y, 0, (row.shape[0], *y.shape[1:]))

    def load(self, eidx, num_experts: int) -> DTensor:
        """The routed-token count per expert: each rank's groups counted
        locally, summed over the batch axes (an all-reduce)."""
        e = self._local(eidx).reshape(-1)
        part = torch.zeros(num_experts, dtype=torch.float32,
                           device=e.device)
        part.scatter_add_(0, e, torch.ones(e.numel(), device=e.device))
        want = [Partial() if isinstance(p, Shard) else p for p in self.grp]
        return wrap_local(part, self.mesh, want, (num_experts,)).redistribute(
            self.mesh, [Replicate()] * len(want))


def moe_ffn(x: torch.Tensor, params: dict, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, norm_topk: bool = True,
            num_real_experts: int | None = None):
    """x: (B, S, D). params (in x's dtype): router (D, E), w_gate/w_up
    (E, D, Fe), w_down (E, Fe, D), optional shared_{gate,up,down}.
    ``num_experts`` may exceed ``num_real_experts`` (structural padding):
    padded experts are outside the routing entirely. Returns (y, aux) with
    aux = {lb_loss, z_loss, expert_load (E,)}."""
    b, s, d = x.shape
    real = num_real_experts or num_experts
    logits, probs, gates, eidx = route(
        x, params["router"], num_experts=num_experts, top_k=top_k,
        norm_topk=norm_topk, num_real_experts=real)
    cap = capacity(s, top_k, real, capacity_factor)
    groups = _Groups(x) if isinstance(x, DTensor) else None
    if groups is None:
        buf, row = _group_dispatch(x, eidx, real, cap)
    else:
        buf, row = groups.dispatch(x, eidx, real, cap)
    rows = buf.view(real, -1, d)  # (E, B * (C + 1), D)

    def experts(w):  # padded experts' weights left out (none if unpadded)
        return w if real == num_experts else w[:real]
    h = torch.bmm(rows, experts(params["w_gate"]))
    u = torch.bmm(rows, experts(params["w_up"]))
    ob = torch.bmm(silu(h) * u, experts(params["w_down"]))
    if groups is None:
        y = _group_combine(ob.view(-1, d), row, gates.to(x.dtype), eidx,
                           cap)
    else:
        y = groups.combine(ob, row, gates.to(x.dtype), eidx, cap)

    if "shared_gate" in params:
        hs = silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
        y = y + hs @ params["shared_down"]

    # aux losses in f32 on router stats
    me = probs.mean(dim=(0, 1))  # mean prob per expert
    if groups is None:
        load1 = torch.zeros(num_experts, dtype=torch.float32,
                            device=x.device)
        load1.scatter_add_(0, eidx.reshape(-1),
                           torch.ones(eidx.numel(), device=x.device))
    else:
        load1 = groups.load(eidx, num_experts)
    ce = load1 / torch.clamp_min(load1.sum(), 1.0)  # share of assignments
    lb_loss = num_experts * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits[..., :real], dim=-1) ** 2)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "expert_load": load1}
    return y, aux


# ---- structure-aware expert scheduling (paper technique, beyond-paper) ----
def expert_activity(load_ema: np.ndarray, load_now: np.ndarray,
                    alpha: float = 0.75, ema: float = 0.9) -> np.ndarray:
    """AD-analogue for experts (Eq. 1/2 re-read): 'in-degree' = tokens routed
    now, 'out-degree' = historical load; activity blends them just as
    D(v) = D_o + alpha*D_i blends the two degree directions."""
    new_ema = ema * load_ema + (1 - ema) * load_now
    return new_ema + alpha * load_now, new_ema


def rebalance_plan(activity: np.ndarray, num_shards: int) -> np.ndarray:
    """Greedy hot/cold re-binning: order experts by activity (descending) and
    deal them round-robin-by-load onto EP shards, so each shard's predicted
    load is even — the paper's hot/cold partition balancing, with experts as
    vertices. Returns perm such that expert i should live at slot perm[i]."""
    e = activity.shape[0]
    order = np.argsort(-activity)
    shard_load = np.zeros(num_shards)
    shard_fill = [[] for _ in range(num_shards)]
    per_shard = e // num_shards
    for idx in order:
        k = int(np.argmin(np.where(
            np.array([len(f) for f in shard_fill]) < per_shard,
            shard_load, np.inf)))
        shard_fill[k].append(idx)
        shard_load[k] += activity[idx]
    perm = np.empty(e, dtype=np.int64)
    slot = 0
    for f in shard_fill:
        for idx in f:
            perm[idx] = slot
            slot += 1
    return perm
