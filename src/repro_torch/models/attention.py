"""Attention paths: quadratic, chunked online-softmax (prefill), decode with
a KV cache.

The port of ``repro/models/attention.py``, in plain torch: the reference
computes all four outside any Pallas kernel. Layout convention:
activations (B, S, H, Dh); the math is f32 and the output is cast to q's
dtype. Masked logits are ``NEG_INF`` = -1e30, not -inf, as in the
reference. The prefill kernel (kernel 4) is
``repro_torch.kernels.flash_attention``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def full_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Reference quadratic path (small S / tests). (B, S, H, D) layout."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, s, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def chunked_attention(q, k, v, causal: bool = True, chunk_q: int = 512,
                      chunk_k: int = 512) -> torch.Tensor:
    """Flash-style attention in plain torch. q: (B, S, Hq, D), k/v:
    (B, S, Hkv, D). An online softmax over KV chunks, so the (S x S)
    logits never materialize; S not a multiple of the chunks falls back to
    :func:`full_attention`. Every KV chunk is visited and the causal ones
    masked, as the reference's static loop (the model's route) does."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if s % chunk_q or s % chunk_k:
        return full_attention(q, k, v, causal)
    nq, nk = s // chunk_q, s // chunk_k
    scale = d ** -0.5
    qc = q.reshape(b, nq, chunk_q, hkv, g, d)
    kc = k.reshape(b, nk, chunk_k, hkv, d)
    vc = v.reshape(b, nk, chunk_k, hkv, d)
    rows = torch.arange(chunk_q, device=q.device)[:, None]
    cols = torch.arange(chunk_k, device=q.device)[None, :]
    out = torch.empty(b, nq, chunk_q, hkv, g, d, dtype=torch.float32,
                      device=q.device)
    for qi in range(nq):
        q_i = qc[:, qi].float()  # (B, Cq, Hkv, G, D)
        m = torch.full((b, hkv, g, chunk_q, 1), NEG_INF, device=q.device)
        lse = torch.zeros(b, hkv, g, chunk_q, 1, device=q.device)
        acc = torch.zeros(b, hkv, g, chunk_q, d, device=q.device)
        for ki in range(nk):
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_i,
                                  kc[:, ki].float()) * scale
            if causal:
                keep = qi * chunk_q + rows >= ki * chunk_k + cols
                logits = logits.masked_fill(~keep, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            lse = lse * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                             vc[:, ki].float())
            m = m_new
        o = acc / torch.clamp_min(lse, 1e-30)
        out[:, qi] = o.permute(0, 3, 1, 2, 4)  # bhgqd -> bqhgd
    return out.reshape(b, s, hq, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """One-step attention. q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D);
    pos: int (tokens [0, pos] are valid, [pos] being the new one)."""
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    valid = torch.arange(smax, device=q.device) <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def update_cache(cache_k, cache_v, new_k, new_v, pos):
    """Write new_k/new_v ((B, T, Hkv, D)) at [pos, pos+T). In place (the
    reference's functional update would copy the whole cache); returns
    the caches."""
    pos, t = int(pos), new_k.shape[1]
    cache_k[:, pos:pos + t] = new_k.to(cache_k.dtype)
    cache_v[:, pos:pos + t] = new_v.to(cache_v.dtype)
    return cache_k, cache_v
