"""Attention paths: quadratic, chunked online-softmax (prefill), decode with
a KV cache.

The port of ``repro/models/attention.py``, in plain torch: the reference
computes all four outside any Pallas kernel. Layout convention:
activations (B, S, H, Dh); the math is f32 and the output is cast to q's
dtype. Masked logits are ``NEG_INF`` = -1e30, not -inf, as in the
reference. The prefill kernel (kernel 4) is
``repro_torch.kernels.flash_attention``.

DTensor inputs (a sharded program) run rank-locally: attention is
independent per batch row and per query head, so each rank computes the
plain function on its (batch, head) shard (:func:`_on_head_shards`), and
a decode step over a cache whose sequence is sharded combines each
shard's partial softmax across the ranks (flash-decoding,
:func:`_decode_seq_shards`). A mesh dim of one rank shards nothing: there
the local call is the plain function on the whole tensors, bit for bit.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.layers import (keep_shards, local, replicated_like,
                                       wrap_local)

NEG_INF = -1e30


def _ranks(mesh, placements, dim: int) -> int:
    """How many shards ``placements`` cut tensor dim ``dim`` into."""
    n = 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(i)
    return n


def _on_head_shards(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` on each rank's shard of DTensor q (B, S, Hq,
    D), k and v (B, S_kv, Hkv, D): batch and query heads as q has them
    sharded, every other dim whole; k and v sharded on heads alongside
    where both head counts divide by the head shards, else whole, each
    local query head taking its own KV head (``index_select``)."""
    mesh = q.device_mesh
    pq = keep_shards(q, (0, 2))
    heads = _ranks(mesh, pq, 2)
    hq, hkv = q.shape[2], k.shape[2]
    kv_sharded = hq % heads == 0 and hkv % heads == 0
    pkv = [p if isinstance(p, Shard) and (p.dim == 0 or kv_sharded)
           else Replicate() for p in pq]
    q_l, k_l, v_l = local(q, pq), local(k, pkv, pq), local(v, pkv, pq)
    if not kv_sharded and heads > 1:
        off, n = local_span(hq, mesh, pq, 2)
        idx = (off + torch.arange(n, device=k_l.device)) // (hq // hkv)
        k_l, v_l = k_l.index_select(2, idx), v_l.index_select(2, idx)
    return wrap_local(fn(q_l, k_l, v_l, *args), mesh, pq, q.shape)


def full_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Reference quadratic path (small S / tests). (B, S, H, D) layout."""
    if isinstance(q, DTensor):
        return _on_head_shards(full_attention, q, k, v, causal)
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
    if isinstance(q, DTensor):
        return _on_head_shards(chunked_attention, q, k, v, causal, chunk_q,
                               chunk_k)
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
    if isinstance(k_cache, DTensor):
        return _decode_seq_shards(q, k_cache, v_cache, pos)
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


def _decode_seq_shards(q, k_cache, v_cache, pos) -> torch.Tensor:
    """:func:`decode_attention` over DTensor caches (B, Smax, Hkv, D)
    sharded on batch and, for flash-decoding, on the sequence: each rank
    attends its batch rows' every query head to its keys with a softmax of
    its own maximum, and the shards' partial sums are rescaled to the
    global maximum and summed across the sequence's ranks (a max and two
    sum all-reduces). Without a sequence shard of more than one rank it
    is :func:`decode_attention` on the local tensors."""
    mesh = k_cache.device_mesh
    pc = keep_shards(k_cache, (0, 1))
    pq = keep_shards(k_cache, (0,))  # batch as the cache's, heads whole
    q_l = local(replicated_like(q, k_cache), pq)
    k_l, v_l = local(k_cache, pc), local(v_cache, pc)
    seq = [i for i, p in enumerate(pc) if isinstance(p, Shard)
           and p.dim == 1 and mesh.size(i) > 1]
    if not seq:
        return wrap_local(decode_attention(q_l, k_l, v_l, pos), mesh, pq,
                          q.shape)
    b, _, hq, d = q_l.shape
    hkv = k_l.shape[2]
    g = hq // hkv
    off, n = local_span(k_cache.shape[1], mesh, pc, 1)
    qg = q_l.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_l.float()) * d ** -0.5
    valid = off + torch.arange(n, device=k_l.device) <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)

    def across(t, op):  # t summed (or maxed) over the sequence's ranks
        part = [Partial(op) if i in seq else pl for i, pl in enumerate(pq)]
        return local(wrap_local(t, mesh, part, (q.shape[0], *t.shape[1:])),
                     pq)
    scale = torch.exp(m - across(m, "max"))
    den = across(p.sum(-1, keepdim=True) * scale, "sum")
    num = across(torch.einsum("bhgk,bkhd->bhgd", p, v_l.float())
                 * scale, "sum")
    out = (num / den).reshape(b, 1, hq, d).to(q_l.dtype)
    return wrap_local(out, mesh, pq, q.shape)


def update_cache(cache_k, cache_v, new_k, new_v, pos):
    """Write new_k/new_v ((B, T, Hkv, D)) at [pos, pos+T). In place (the
    reference's functional update would copy the whole cache); returns
    the caches. A DTensor cache, whose sequence dim may be sharded, is
    written shard by shard (:func:`_write_shard`)."""
    pos, t = int(pos), new_k.shape[1]
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        if isinstance(cache, DTensor):
            _write_shard(cache, new.to(cache.dtype), pos)
        else:
            cache[:, pos:pos + t] = new.to(cache.dtype)
    return cache_k, cache_v


def local_span(size: int, mesh, placements, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's shard of dim ``dim`` (global size
    ``size``): DTensor's ``Shard`` splits, nested in mesh-dim order, each
    a chunk of ceil(n / ranks) with the last ones short or empty. Plain
    Python on the mesh coordinate: no tensor is made."""
    coord = mesh.get_coordinate()
    off = 0
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n = mesh.size(i)
            chunk = -(-size // n)
            start = min(coord[i] * chunk, size)
            off += start
            size = min(chunk, size - start)
    return off, size


def _write_shard(cache: DTensor, new, pos: int) -> None:
    """``cache[:, pos:pos + T] = new`` on a DTensor cache (B, S, Hkv, D)
    in place: ``new`` laid out as the cache but whole along the sequence,
    and each rank writes the part of [pos, pos + T) its shard holds."""
    mesh, pl = cache.device_mesh, cache.placements
    t = new.shape[1]
    new = replicated_like(new, cache)  # a DTensor, or a constant
    if pos == 0 and t == cache.shape[1]:  # the whole cache: laid out as it
        cache.to_local().copy_(new.redistribute(mesh, pl).to_local())
        return
    want = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in pl]
    local_new = new.redistribute(mesh, want).to_local()
    off, n = local_span(cache.shape[1], mesh, pl, 1)
    lo, hi = max(pos, off), min(pos + t, off + n)
    if lo < hi:
        cache.to_local()[:, lo - off:hi - off] = local_new[:, lo - pos:
                                                           hi - pos]
