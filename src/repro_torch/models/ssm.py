"""Mamba2 SSD (state-space duality) mixer: chunked prefill and O(1) decode.

The port of ``repro/models/ssm.py``. The chunked algorithm (SSD,
arXiv:2405.21060 §6): an intra-chunk quadratic term (a Q x Q decay-masked
Gram matrix per head) and an inter-chunk recurrence over the chunks'
states. Decode carries (state, conv window), no KV cache.

Layout as in the reference: x (B, S, H, P); the B/C projections are shared
by the heads (one group); A is a per-head scalar decay, dt per head and
step. Everything runs in f32 and returns x's dtype, as the reference's
casts do. ``use_kernel=True`` routes the intra-chunk term through kernel 5
(``repro_torch.kernels.ssd_scan.ssd_intra_chunk``, its heads form: b and c
read once per chunk for all heads); without it the term is the reference's
einsum. No reference model calls the Pallas kernel: this route is the
port's own.

DTensor inputs (a sharded program) run rank-locally: the scan is
independent per batch row and per head, so each rank runs the plain
function on its (batch, head) shard (b and c whole on each rank's rows).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ssd_scan as kernel5
from repro_torch.models.layers import keep_shards, local, wrap_local


def _head_layouts(x: DTensor, head_dim: int):
    """x's batch shards and its head shards (on ``head_dim``), and the
    layouts they give a (B, ...) tensor without heads, an (H,) vector, a
    (B, S, H) one and a (B, H, ...) one."""
    px = keep_shards(x, (0, head_dim))
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in px]
    heads = [Shard(0) if isinstance(p, Shard) and p.dim == head_dim
             else Replicate() for p in px]
    bsh = [Shard(2) if h != Replicate() else b for b, h in zip(batch, heads)]
    bh = [Shard(1) if h != Replicate() else b for b, h in zip(batch, heads)]
    return px, batch, heads, bsh, bh


def ssd_chunked(x, a_log, b, c, dt, chunk: int = 128,
                return_state: bool = False, use_kernel: bool = False):
    """x: (B,S,H,P), a_log: (H,), b/c: (B,S,N), dt: (B,S,H) -> y (B,S,H,P).

    Equal up to fp error to the sequential recurrence
        state_t = exp(dt_t * A) * state_{t-1} + (x_t * dt_t) (x) b_t
        y_t     = <state_t, c_t>
    return_state=True also returns the final state (B,H,P,N), f32."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        px, batch, heads, bsh, bh = _head_layouts(x, 2)
        out = ssd_chunked(local(x, px), local(a_log, heads, px),
                          local(b, batch, px), local(c, batch, px),
                          local(dt, bsh, px), chunk, return_state,
                          use_kernel)
        if not return_state:
            return wrap_local(out, mesh, px, x.shape)
        y, state = out
        shp = (x.shape[0], x.shape[2], x.shape[3], b.shape[-1])
        return (wrap_local(y, mesh, px, x.shape),
                wrap_local(state, mesh, bh, shp))
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    a = -torch.exp(a_log.float())  # (H,) negative decay rates
    xs = x.reshape(bsz, nc, q, h, p).float()
    bs = b.reshape(bsz, nc, q, n).float()
    cs = c.reshape(bsz, nc, q, n).float()
    dts = dt.reshape(bsz, nc, q, h).float()
    ld = torch.cumsum(dts * a, dim=2)  # inclusive within-chunk log-decay
    u = xs * dts[..., None]  # effective inputs (B,nc,Q,H,P)

    # --- intra-chunk (causal quadratic term) ---
    if use_kernel:
        y_intra = kernel5.ssd_intra_chunk(
            cs.reshape(bsz * nc, q, n), bs.reshape(bsz * nc, q, n),
            u.reshape(bsz * nc, q, h, p), ld.reshape(bsz * nc, q, h)
        ).reshape(bsz, nc, q, h, p)
    else:
        gram = torch.einsum("bcqn,bcsn->bcqs", cs, bs)
        # decay from step s (exclusive) to step q (inclusive), per head;
        # selected, never multiplied: above the diagonal its exp may be inf
        ldiff = ld[:, :, :, None, :] - ld[:, :, None, :, :]  # (B,nc,Q,S,H)
        causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, None, :, :, None],
                            torch.exp(ldiff), 0.0)
        y_intra = torch.einsum("bcqsh,bcshp->bcqhp", gram[..., None] * decay,
                               u)

    # --- chunk states: contribution of each chunk to its final state ---
    l_last = ld[:, :, -1:, :]  # (B,nc,1,H)
    state_decay = torch.exp(l_last - ld)  # decay from step s to chunk end
    chunk_states = torch.einsum("bcqhp,bcqn->bchpn",
                                u * state_decay[..., None], bs)

    # --- inter-chunk recurrence over nc (sequential, nc is small) ---
    chunk_total = torch.exp(l_last[:, :, 0, :])  # (B,nc,H) whole-chunk decay
    carry = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    prev = []  # the state before each chunk
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_total[:, i, :, None, None] + chunk_states[:, i]
    prev_states = torch.stack(prev, 1)  # (B,nc,H,P,N)

    # --- inter-chunk contribution ---
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cs, prev_states) \
        * torch.exp(ld)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype)
    if return_state:
        return y, carry
    return y


def ssd_decode_step(state, x_t, a_log, b_t, c_t, dt_t):
    """One-token recurrence. state: (B,H,P,N) f32; x_t: (B,H,P); b_t/c_t:
    (B,N); dt_t: (B,H). Returns (new_state, y_t (B,H,P) in x_t's dtype)."""
    if isinstance(x_t, DTensor):
        mesh = x_t.device_mesh
        px, batch, heads, _, bh = _head_layouts(x_t, 1)
        st, y = ssd_decode_step(local(state, bh), local(x_t, px),
                                local(a_log, heads), local(b_t, batch),
                                local(c_t, batch), local(dt_t, bh))
        return (wrap_local(st, mesh, bh, state.shape),
                wrap_local(y, mesh, px, x_t.shape))
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt_t.float() * a[None])  # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", x_t.float() * dt_t[..., None].float(),
                       b_t.float())
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_t.float())
    return state, y.to(x_t.dtype)


def causal_conv(x, w, cache=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C). With a cache
    ((B, K-1, C)) performs streaming decode and returns the new cache.

    A sum of K shifted products in x's dtype, as the reference writes it:
    not ``conv1d``, which in f32 on the card runs through cuDNN in TF32."""
    k = w.shape[0]
    if cache is None:
        pad = x.new_zeros(x.shape[0], k - 1, x.shape[2])
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_cache = xp[:, -(k - 1):] if k > 1 else pad
    return out.to(x.dtype), new_cache
