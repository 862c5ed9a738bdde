"""The dense, SSM and hybrid decoder families: init, full-sequence forward,
and serving (cache, prefill, decode).

The port of ``repro/models/model.py`` for ``family`` in ``dense``
(llama3p2_1b, yi_6b, qwen3_14b, mistral_nemo_12b), ``ssm`` (mamba2_2p7b)
and ``hybrid`` (hymba_1p5b: attention and SSM heads side by side in every
layer, their outputs averaged). The parameters live in a :class:`Model`
(``nn.Module``) named as the reference's tree: ``embed``, ``ln_f``,
``lm_head`` (untied archs), and per layer ``ln1``, then as the config asks
``attn.{wq,wk,wv,wo,q_norm,k_norm}``, ``ssm.{in_x,in_z,in_b,in_c,in_dt,
dt_bias,a_log,d_skip,conv_w,ssm_norm,out}``, ``ln2`` and
``mlp.{wg,wu,wd}`` (mamba2 has ``ln1`` and ``ssm`` only); the block math
is plain functions on tensors. Master weights are f32; each matmul casts
its weight to ``cfg.dtype`` at use, as the reference's ``.astype(cdt)``
does, and activations stay in ``cfg.dtype`` (the SSM's dt, scan and state
in f32, as the reference's).

Entry points (the reference's, with ``use_pallas`` named ``use_kernel``):
    init_params(cfg, generator)                 -> Model (f32 masters)
    forward(params, cfg, batch)                 -> (logits, aux)
    init_cache(cfg, batch, max_seq)             -> cache dict
    prefill(params, cfg, batch, cache)          -> (last logits, cache)
    decode_step(params, cfg, tokens, cache)     -> (logits, cache)

``use_kernel=True`` routes the prefill's and the forward's attention
through kernel 4 (``repro_torch.kernels.flash_attention``, S a multiple of
128) and the SSM's intra-chunk term through kernel 5
(``repro_torch.kernels.ssd_scan``, via ``models/ssm.py``); without it the
reference's routes hold: ``chunked_attention`` at S >= 2048,
``full_attention`` below, and the SSD einsum. Decoding uses
``decode_attention`` and ``ssd_decode_step``. The cache's K/V, SSM states
and conv windows are updated in place and the cache dict is returned; its
``pos`` is a Python int. The moe, vlm and audio families raise
``NotImplementedError``, and so does ``cast_weights_once``; the reference's
sharding hooks are not ported yet (ROADMAP Queue 1 items 9-10), and
``remat`` has no effect on inference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import flash_attention as kernel4
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, silu, swiglu)

# the ROADMAP item that ports each family the port does not serve yet
NOT_PORTED = {"moe": "ROADMAP Queue 1 item 1c",
              "vlm": "ROADMAP Queue 1 item 1c",
              "audio": "ROADMAP Queue 1 item 1c"}


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch yet ({NOT_PORTED.get(cfg.family, 'ROADMAP')})")
    if cfg.cast_weights_once:
        # the reference casts the >= 2-D masters once per forward, outside
        # its layer scan, so that sharded gathers move bf16; eager PyTorch
        # casts each weight once per forward at its use, which gives the
        # same bits, and the port has no sharded gathers to spare
        raise NotImplementedError(
            f"{cfg.name}: cast_weights_once is not ported (each weight is "
            "cast once per forward at its use, with the same bits); set it "
            "False")


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


class SSM(nn.Module):
    """The Mamba2 mixer's parameters (the reference's ``_ssm_params``)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        h, n = cfg.ssm_heads, cfg.ssm_state
        din = h * cfg.ssm_head_dim
        self.in_x = _param(d, din, device=device)
        self.in_z = _param(d, din, device=device)
        self.in_b = _param(d, n, device=device)
        self.in_c = _param(d, n, device=device)
        self.in_dt = _param(d, h, device=device)
        self.dt_bias = _param(h, device=device)
        self.a_log = _param(h, device=device)
        self.d_skip = _param(h, device=device, fill=1.0)
        self.conv_w = _param(cfg.ssm_conv_width, din + 2 * n, device=device)
        self.ssm_norm = _param(din, device=device, fill=1.0)
        self.out = _param(din, d, device=device)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wg = _param(d, f, device=device)
        self.wu = _param(d, f, device=device)
        self.wd = _param(f, d, device=device)


class DecoderLayer(nn.Module):
    """``ln1``, then ``attn`` and/or ``ssm``, then ``ln2`` and ``mlp``
    where the config has a feed-forward width, as the reference's
    ``_layer_params`` builds them."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param(d, device=device, fill=1.0)
        if cfg.has_attention:
            self.attn = Attention(cfg, device)
        if cfg.has_ssm:
            self.ssm = SSM(cfg, device)
        if cfg.d_ff:
            self.ln2 = _param(d, device=device, fill=1.0)
            self.mlp = MLP(cfg, device)


class Model(nn.Module):
    """A decoder's parameters (uninitialized; :func:`init_params` or
    ``repro_torch.interop.lm_params_from_arrays`` fills them)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        _require_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _param(cfg.vocab_padded, cfg.d_model, device=device)
        self.ln_f = _param(cfg.d_model, device=device, fill=1.0)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab_padded,
                                  device=device)


def tree_param_count(cfg: ArchConfig) -> int:
    """The parameters of the reference's ``init_params`` tree for ``cfg``
    (``_attn_params``, ``_ssm_params``, ``_layer_params``), counted from the
    config for the dense, ssm and hybrid families: what a :class:`Model`
    must hold. ``ArchConfig.param_count()`` is the reference's analytic
    count: it leaves out the SSM's dt_bias, a_log, d_skip, conv_w and
    ssm_norm, and counts an ln2 that mamba2 does not have."""
    d = cfg.d_model
    layer = d  # ln1
    if cfg.has_attention:
        dh, hq, hkv = (cfg.resolved_head_dim, cfg.q_heads_eff,
                       cfg.kv_heads_eff)
        layer += 2 * d * hq * dh + 2 * d * hkv * dh
        layer += 2 * dh if cfg.qk_norm else 0
    if cfg.has_ssm:
        h, n = cfg.ssm_heads, cfg.ssm_state
        din = h * cfg.ssm_head_dim
        layer += (3 * d * din + 2 * d * n + d * h + 3 * h
                  + cfg.ssm_conv_width * (din + 2 * n) + din)
    if cfg.d_ff:
        layer += d + 3 * d * cfg.d_ff
    head = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    return cfg.num_layers * layer + head + d


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_attention(a: Attention, cfg: ArchConfig, gen) -> None:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.q_heads_eff, cfg.kv_heads_eff
    a.wq.copy_(dense_init(gen, (d, hq * dh)))
    a.wk.copy_(dense_init(gen, (d, hkv * dh)))
    a.wv.copy_(dense_init(gen, (d, hkv * dh)))
    a.wo.zero_()
    # EXACT padding: padded q heads see uniform attention over zero values
    # and have zero wo rows; padded kv heads are zero
    a.wq[:, cfg.num_heads * dh:] = 0.0
    a.wo[cfg.num_heads * dh:, :] = 0.0
    a.wk[:, cfg.num_kv_heads * dh:] = 0.0
    a.wv[:, cfg.num_kv_heads * dh:] = 0.0


def _init_ssm(sp: SSM, cfg: ArchConfig, gen) -> None:
    d, h = cfg.d_model, cfg.ssm_heads
    din, n, k = h * cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width
    sp.in_x.copy_(dense_init(gen, (d, din)))
    sp.in_z.copy_(dense_init(gen, (d, din)))
    sp.in_b.copy_(dense_init(gen, (d, n)))
    sp.in_c.copy_(dense_init(gen, (d, n)))
    sp.in_dt.copy_(dense_init(gen, (d, h)))
    # dt log-uniform in [1e-3, 1e-1] through softplus; A in [1, 16]
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(h, generator=gen,
                                               device=gen.device))
    sp.dt_bias.copy_(torch.log(torch.expm1(dt)))
    sp.a_log.copy_(torch.log(1.0 + 15.0 * torch.rand(h, generator=gen,
                                                     device=gen.device)))
    sp.conv_w.copy_(dense_init(gen, (k, din + 2 * n), scale=k ** -0.5))
    sp.out.copy_(dense_init(gen, (din, d), scale=din ** -0.5))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator) -> Model:
    """The reference's initialization, drawn from ``generator`` on its
    device: normal embeddings at 0.02, dense weights at fan_in^-0.5, norms
    and ``d_skip`` at one, ``wo`` at zero (the reference's skip-init, so
    each attention sublayer adds nothing until ``wo`` moves; padded heads
    have zero wq/wk/wv columns and wo rows), the SSM's dt bias the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1] and ``a_log`` the log of
    a uniform A in [1, 16]."""
    _require_ported(cfg)
    model = Model(cfg, generator.device)
    d, f = cfg.d_model, cfg.d_ff
    model.embed.copy_(embed_init(generator, (cfg.vocab_padded, d)))
    for layer in model.layers:
        if cfg.has_attention:
            _init_attention(layer.attn, cfg, generator)
        if cfg.has_ssm:
            _init_ssm(layer.ssm, cfg, generator)
        if cfg.d_ff:
            layer.mlp.wg.copy_(dense_init(generator, (d, f)))
            layer.mlp.wu.copy_(dense_init(generator, (d, f)))
            layer.mlp.wd.copy_(dense_init(generator, (f, d),
                                          scale=f ** -0.5))
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


def _ssm_in(h, sp: SSM):
    """The SSM's input projections: the gate z in h's dtype, dt (B, S, H)
    in f32 after softplus, and the conv input [x, b, c] in h's dtype."""
    cdt = h.dtype
    x = h @ sp.in_x.to(cdt)  # (B,S,H*P)
    z = h @ sp.in_z.to(cdt)
    bb = h @ sp.in_b.to(cdt)  # (B,S,N)
    cc = h @ sp.in_c.to(cdt)
    dt = F.softplus((h @ sp.in_dt.to(cdt)).float() + sp.dt_bias)
    return z, dt, torch.cat([x, bb, cc], dim=-1)


def _ssm_out(y, xh, z, sp: SSM):
    """The skip, the gate, the norm and the out projection. y, xh:
    (B, S, H, P) in the compute dtype."""
    b, s, hh, pp = xh.shape
    cdt = xh.dtype
    y = y + xh * sp.d_skip.to(cdt)[None, None, :, None]
    y = rms_norm(y.reshape(b, s, hh * pp) * silu(z), sp.ssm_norm)
    return y @ sp.out.to(cdt)


def _ssm_block(h, sp: SSM, cfg: ArchConfig, use_kernel: bool = False):
    """h: (B, S, D) normed input -> (out (B, S, D), final state, conv
    input); full sequence (forward and prefill)."""
    b, s, _ = h.shape
    hh, pp, nn_ = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, dt, conv_in = _ssm_in(h, sp)
    conv_out, _ = ssm_lib.causal_conv(conv_in, sp.conv_w.to(h.dtype))
    x, bb, cc = torch.split(silu(conv_out), [hh * pp, nn_, nn_], dim=-1)
    xh = x.reshape(b, s, hh, pp)
    y, state = ssm_lib.ssd_chunked(xh, sp.a_log, bb, cc, dt,
                                   chunk=min(cfg.ssm_chunk, s),
                                   return_state=True, use_kernel=use_kernel)
    return _ssm_out(y, xh, z, sp), state, conv_in


def _ssm_decode(h, sp: SSM, cfg: ArchConfig, state, conv):
    """One token. h: (B, 1, D); state (B, H, P, N) f32 and conv
    (B, K-1, C) are this layer's caches, updated in place."""
    b = h.shape[0]
    hh, pp, nn_ = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, dt, conv_in = _ssm_in(h, sp)
    conv_out, new_conv = ssm_lib.causal_conv(conv_in, sp.conv_w.to(h.dtype),
                                             cache=conv)
    conv.copy_(new_conv)
    x, bb, cc = torch.split(silu(conv_out), [hh * pp, nn_, nn_], dim=-1)
    new_state, y = ssm_lib.ssd_decode_step(state, x.reshape(b, hh, pp),
                                           sp.a_log, bb[:, 0], cc[:, 0],
                                           dt[:, 0])
    state.copy_(new_state)
    return _ssm_out(y[:, None], x.reshape(b, 1, hh, pp), z, sp)


def _mix(parts):
    """The mixers' outputs: one, or the hybrid's two averaged."""
    return parts[0] if len(parts) == 1 else (parts[0] + parts[1]) * 0.5


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


def _layers(params: Model, cfg: ArchConfig, x, use_kernel: bool,
            cache: dict | None = None) -> torch.Tensor:
    """The decoder stack over a full sequence from position 0; with a cache
    it also writes each layer's K/V at [0, S), SSM state and conv window."""
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None]
    k_conv = cfg.ssm_conv_width - 1
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1)
        parts = []
        if cfg.has_attention:
            a, (k, v) = _attention_block(h, layer.attn, cfg, positions, True,
                                         use_kernel=use_kernel)
            if cache is not None:
                attn_lib.update_cache(cache["k"][i], cache["v"][i], k, v, 0)
            parts.append(a)
        if cfg.has_ssm:
            sout, state, conv_in = _ssm_block(h, layer.ssm, cfg,
                                              use_kernel=use_kernel)
            if cache is not None:
                cache["ssm_state"][i].copy_(state)
                cache["conv"][i].copy_(conv_in[:, -k_conv:])
            parts.append(sout)
        x = x + _mix(parts)
        if cfg.d_ff:
            x = x + _ffn_block(rms_norm(x, layer.ln2), layer)
    return x


# --------------------------------------------------------------------------
# full-sequence forward (train / prefill math)
# --------------------------------------------------------------------------
def forward(params: Model, cfg: ArchConfig, batch, use_kernel: bool = False,
            remat: bool = True):
    """Returns (logits (B, S, V), aux dict). ``remat`` is accepted and has
    no effect here."""
    _require_ported(cfg)
    x = _layers(params, cfg, _embed_inputs(params, cfg, batch), use_kernel)
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
    """Zero caches on ``device`` (the card unless the caller asks for the
    CPU): K/V (L, B, max_seq, Hkv, Dh) in ``cfg.dtype`` where the family
    has attention; SSM states (L, B, H, P, N) in f32 and conv windows
    (L, B, K-1, H*P + 2N) in ``cfg.dtype`` where it has an SSM."""
    _require_ported(cfg)
    device = resolve_device(device)
    cdt = getattr(torch, cfg.dtype)
    nl = cfg.num_layers
    cache = {"pos": 0}
    if cfg.has_attention:
        shape = (nl, batch, max_seq, cfg.kv_heads_eff,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=cdt, device=device)
        cache["v"] = torch.zeros(shape, dtype=cdt, device=device)
    if cfg.has_ssm:
        cache["ssm_state"] = torch.zeros(
            (nl, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device)
        conv_ch = cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
        cache["conv"] = torch.zeros(
            (nl, batch, cfg.ssm_conv_width - 1, conv_ch), dtype=cdt,
            device=device)
    return cache


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, batch, cache: dict,
            use_kernel: bool = False):
    """Full-sequence prefill that also fills the cache (K/V at [0, S), SSM
    states and conv windows). Returns (last-position logits (B, V),
    cache)."""
    _require_ported(cfg)
    x = _layers(params, cfg, _embed_inputs(params, cfg, batch), use_kernel,
                cache)
    cache["pos"] = x.shape[1]
    return _logits(params, cfg, x[:, -1]), cache


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, tokens, cache: dict):
    """One decode step. tokens: (B, 1) int. Returns (logits (B, V),
    cache)."""
    _require_ported(cfg)
    x = _embed_inputs(params, cfg, {"tokens": tokens})  # (B, 1, D)
    cdt = x.dtype
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    dh, hq, hkv = cfg.resolved_head_dim, cfg.q_heads_eff, cfg.kv_heads_eff
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1)
        parts = []
        if cfg.has_attention:
            ap = layer.attn
            q = (h @ ap.wq.to(cdt)).reshape(b, 1, hq, dh)
            k = (h @ ap.wk.to(cdt)).reshape(b, 1, hkv, dh)
            v = (h @ ap.wv.to(cdt)).reshape(b, 1, hkv, dh)
            if cfg.qk_norm:
                q = rms_norm(q, ap.q_norm)
                k = rms_norm(k, ap.k_norm)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            kc, vc = attn_lib.update_cache(cache["k"][i], cache["v"][i], k,
                                           v, pos)
            o = attn_lib.decode_attention(q, kc, vc, pos)
            parts.append(o.reshape(b, 1, hq * dh) @ ap.wo.to(cdt))
        if cfg.has_ssm:
            parts.append(_ssm_decode(h, layer.ssm, cfg,
                                     cache["ssm_state"][i],
                                     cache["conv"][i]))
        x = x + _mix(parts)
        if cfg.d_ff:
            x = x + _ffn_block(rms_norm(x, layer.ln2), layer)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x[:, 0]), cache
