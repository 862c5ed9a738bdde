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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ssd_scan as kernel5


def ssd_chunked(x, a_log, b, c, dt, chunk: int = 128,
                return_state: bool = False, use_kernel: bool = False):
    """x: (B,S,H,P), a_log: (H,), b/c: (B,S,N), dt: (B,S,H) -> y (B,S,H,P).

    Equal up to fp error to the sequential recurrence
        state_t = exp(dt_t * A) * state_{t-1} + (x_t * dt_t) (x) b_t
        y_t     = <state_t, c_t>
    return_state=True also returns the final state (B,H,P,N), f32."""
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
        pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_cache = xp[:, -(k - 1):] if k > 1 else pad
    return out.to(x.dtype), new_cache
