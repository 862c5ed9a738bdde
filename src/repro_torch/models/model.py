"""The dense decoder family: init, full-sequence forward, and serving
(cache, prefill, decode).

The port of ``repro/models/model.py`` for ``family == "dense"`` (llama3p2_1b,
yi_6b, qwen3_14b, mistral_nemo_12b). The parameters live in an
:class:`Model` (``nn.Module``) named as the reference's tree: ``embed``,
``ln_f``, ``lm_head`` (untied archs), and per layer ``ln1``, ``ln2``,
``attn.{wq,wk,wv,wo,q_norm,k_norm}``, ``mlp.{wg,wu,wd}``; the block math is
plain functions on tensors. Master weights are f32; each matmul casts its
weight to ``cfg.dtype`` at use, as the reference's ``.astype(cdt)`` does,
and activations stay in ``cfg.dtype``.

Entry points (the reference's, with ``use_pallas`` named ``use_kernel``):
    init_params(cfg, generator)                 -> Model (f32 masters)
    forward(params, cfg, batch)                 -> (logits, aux)
    init_cache(cfg, batch, max_seq)             -> cache dict
    prefill(params, cfg, batch, cache)          -> (last logits, cache)
    decode_step(params, cfg, tokens, cache)     -> (logits, cache)

``use_kernel=True`` routes the prefill's attention through kernel 4
(``repro_torch.kernels.flash_attention``, S a multiple of 128); without it
the reference's split holds: ``chunked_attention`` at S >= 2048,
``full_attention`` below. Decoding uses ``decode_attention``. The cache's
K/V are updated in place and the cache dict is returned; its ``pos`` is a
Python int. The other families raise ``NotImplementedError``; the
reference's sharding hooks and ``cast_weights_once`` are not ported yet
(ROADMAP Queue 1 items 9-10), and ``remat`` has no effect on inference.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import flash_attention as kernel4
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, swiglu)

# the ROADMAP item that ports each family the port does not serve yet
NOT_PORTED = {"ssm": "ROADMAP Queue 1 item 1b",
              "hybrid": "ROADMAP Queue 1 item 1b",
              "moe": "ROADMAP Queue 1 item 1c",
              "vlm": "ROADMAP Queue 1 item 1c",
              "audio": "ROADMAP Queue 1 item 1c"}


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch yet ({NOT_PORTED.get(cfg.family, 'ROADMAP')})")


def _param(*shape, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.q_heads_eff, cfg.kv_heads_eff
        self.wq = _param(d, hq * dh, device=device)
        self.wk = _param(d, hkv * dh, device=device)
        self.wv = _param(d, hkv * dh, device=device)
        self.wo = _param(hq * dh, d, device=device)
        if cfg.qk_norm:
            self.q_norm = _param(dh, device=device, fill=1.0)
            self.k_norm = _param(dh, device=device, fill=1.0)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wg = _param(d, f, device=device)
        self.wu = _param(d, f, device=device)
        self.wd = _param(f, d, device=device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param(d, device=device, fill=1.0)
        self.attn = Attention(cfg, device)
        self.ln2 = _param(d, device=device, fill=1.0)
        self.mlp = MLP(cfg, device)


class Model(nn.Module):
    """A dense decoder's parameters (uninitialized; :func:`init_params` or
    ``repro_torch.interop.lm_params_from_arrays`` fills them)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        _require_dense(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _param(cfg.vocab_padded, cfg.d_model, device=device)
        self.ln_f = _param(cfg.d_model, device=device, fill=1.0)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab_padded,
                                  device=device)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator) -> Model:
    """The reference's initialization, drawn from ``generator`` on its
    device: normal embeddings at 0.02, dense weights at fan_in^-0.5, norms
    at one, and ``wo`` at zero (the reference's skip-init, so each
    attention sublayer adds nothing until ``wo`` moves). Padded heads have
    zero wq/wk/wv columns and wo rows."""
    _require_dense(cfg)
    model = Model(cfg, generator.device)
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    hq, hkv = cfg.q_heads_eff, cfg.kv_heads_eff
    model.embed.copy_(embed_init(generator, (cfg.vocab_padded, d)))
    for layer in model.layers:
        a = layer.attn
        a.wq.copy_(dense_init(generator, (d, hq * dh)))
        a.wk.copy_(dense_init(generator, (d, hkv * dh)))
        a.wv.copy_(dense_init(generator, (d, hkv * dh)))
        a.wo.zero_()
        # EXACT padding: padded q heads see uniform attention over zero
        # values and have zero wo rows; padded kv heads are zero
        a.wq[:, cfg.num_heads * dh:] = 0.0
        a.wo[cfg.num_heads * dh:, :] = 0.0
        a.wk[:, cfg.num_kv_heads * dh:] = 0.0
        a.wv[:, cfg.num_kv_heads * dh:] = 0.0
        layer.mlp.wg.copy_(dense_init(generator, (d, f)))
        layer.mlp.wu.copy_(dense_init(generator, (d, f)))
        layer.mlp.wd.copy_(dense_init(generator, (f, d), scale=f ** -0.5))
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(generator, (d, cfg.vocab_padded)))
    return model


# --------------------------------------------------------------------------
# layer forward pieces
# --------------------------------------------------------------------------
def _attention_block(h, ap: Attention, cfg: ArchConfig, positions,
                     causal: bool, use_kernel: bool = False):
    """h: (B, S, D) normed input. Returns (out, (k, v))."""
    b, s, _ = h.shape
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.q_heads_eff, cfg.kv_heads_eff
    cdt = h.dtype
    q = (h @ ap.wq.to(cdt)).reshape(b, s, hq, dh)
    k = (h @ ap.wk.to(cdt)).reshape(b, s, hkv, dh)
    v = (h @ ap.wv.to(cdt)).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, ap.q_norm)
        k = rms_norm(k, ap.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernel:
        o = kernel4.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    elif s >= 2048:
        o = attn_lib.chunked_attention(q, k, v, causal=causal)
    else:
        o = attn_lib.full_attention(q, k, v, causal=causal)
    out = o.reshape(b, s, hq * dh) @ ap.wo.to(cdt)
    return out, (k, v)


def _ffn_block(x, layer: DecoderLayer):
    cdt = x.dtype
    m = layer.mlp
    return swiglu(x, m.wg.to(cdt), m.wu.to(cdt), m.wd.to(cdt))


def _embed_inputs(params: Model, cfg: ArchConfig, batch) -> torch.Tensor:
    return params.embed[batch["tokens"].long()].to(getattr(torch, cfg.dtype))


def _logits(params: Model, cfg: ArchConfig, x) -> torch.Tensor:
    x = rms_norm(x, params.ln_f)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(x.dtype)


# --------------------------------------------------------------------------
# full-sequence forward (train / prefill math)
# --------------------------------------------------------------------------
def forward(params: Model, cfg: ArchConfig, batch, use_kernel: bool = False,
            remat: bool = True):
    """Returns (logits (B, S, V), aux dict). ``remat`` is accepted and has
    no effect here."""
    _require_dense(cfg)
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    for layer in params.layers:
        h = rms_norm(x, layer.ln1)
        a, _ = _attention_block(h, layer.attn, cfg, positions, True,
                                use_kernel=use_kernel)
        x = x + a
        x = x + _ffn_block(rms_norm(x, layer.ln2), layer)
    logits = _logits(params, cfg, x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero,
           "expert_load": torch.zeros(1, device=x.device)}
    return logits, aux


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    """Zero K/V caches (L, B, max_seq, Hkv, Dh) in ``cfg.dtype`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    _require_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.kv_heads_eff,
             cfg.resolved_head_dim)
    cdt = getattr(torch, cfg.dtype)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, batch, cache: dict,
            use_kernel: bool = False):
    """Full-sequence prefill that also fills the cache's [0, S).
    Returns (last-position logits (B, V), cache)."""
    _require_dense(cfg)
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1)
        a, (k, v) = _attention_block(h, layer.attn, cfg, positions, True,
                                     use_kernel=use_kernel)
        attn_lib.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
        x = x + a
        x = x + _ffn_block(rms_norm(x, layer.ln2), layer)
    cache["pos"] = s
    return _logits(params, cfg, x[:, -1]), cache


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, tokens, cache: dict):
    """One decode step. tokens: (B, 1) int. Returns (logits (B, V),
    cache)."""
    _require_dense(cfg)
    x = _embed_inputs(params, cfg, {"tokens": tokens})  # (B, 1, D)
    cdt = x.dtype
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    dh, hq, hkv = cfg.resolved_head_dim, cfg.q_heads_eff, cfg.kv_heads_eff
    for i, layer in enumerate(params.layers):
        ap = layer.attn
        h = rms_norm(x, layer.ln1)
        q = (h @ ap.wq.to(cdt)).reshape(b, 1, hq, dh)
        k = (h @ ap.wk.to(cdt)).reshape(b, 1, hkv, dh)
        v = (h @ ap.wv.to(cdt)).reshape(b, 1, hkv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, ap.q_norm)
            k = rms_norm(k, ap.k_norm)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc = attn_lib.update_cache(cache["k"][i], cache["v"][i], k, v,
                                       pos)
        o = attn_lib.decode_attention(q, kc, vc, pos)
        x = x + o.reshape(b, 1, hq * dh) @ ap.wo.to(cdt)
        x = x + _ffn_block(rms_norm(x, layer.ln2), layer)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x[:, 0]), cache
