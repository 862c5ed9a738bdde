"""Every decoder family of the repo: init, full-sequence forward, and
serving (cache, prefill, decode).

The port of ``repro/models/model.py`` for all ten configs: ``dense``
(llama3p2_1b, yi_6b, qwen3_14b, mistral_nemo_12b), ``moe``
(deepseek_moe_16b, granite_moe_3b_a800m: the feed-forward is
``models/moe.py``'s routed experts, deepseek's with shared experts),
``ssm`` (mamba2_2p7b), ``hybrid`` (hymba_1p5b: attention and SSM heads side
by side in every layer, their outputs averaged), ``vlm`` (phi3_vision_4p2b:
``batch["patches"]``, precomputed patch embeddings, fill the first
positions ahead of the text) and ``audio`` (whisper_base: an encoder over
``batch["frames"]``, precomputed frame embeddings plus fixed sinusoids,
non-causal and without RoPE, and per decoder layer a cross-attention to
its output). The parameters live in a :class:`Model` (``nn.Module``)
named as the reference's tree: ``embed``, ``ln_f``, ``lm_head`` (untied
archs), ``enc_layers`` and ``enc_ln_f`` (whisper), and per layer ``ln1``,
then as the config asks ``attn.{wq,wk,wv,wo,q_norm,k_norm}``,
``ssm.{in_x,in_z,in_b,in_c,in_dt,dt_bias,a_log,d_skip,conv_w,ssm_norm,
out}``, ``ln_cross`` and ``cross.*`` (whisper's decoder), ``ln2`` and
``mlp.{wg,wu,wd}`` or ``moe.{router,w_gate,w_up,w_down,shared_gate,
shared_up,shared_down}`` (mamba2 has ``ln1`` and ``ssm`` only); the block
math is plain functions on tensors. Master weights are f32; each matmul
casts its weight to ``cfg.dtype`` at use, as the reference's
``.astype(cdt)`` does (the MoE's whole subtree, router included, before
the router's f32 logits), and activations stay in ``cfg.dtype`` (the SSM's
dt, scan and state in f32, as the reference's).

Entry points (the reference's, with ``use_pallas`` named ``use_kernel``):
    init_params(cfg, generator)                 -> Model (f32 masters)
    forward(params, cfg, batch)                 -> (logits, aux)
    init_cache(cfg, batch, max_seq, enc_seq)    -> cache dict
    prefill(params, cfg, batch, cache)          -> (last logits, cache)
    decode_step(params, cfg, tokens, cache)     -> (logits, cache)

``use_kernel=True`` routes the prefill's and the forward's (decoder
self-) attention through kernel 4 (``repro_torch.kernels.flash_attention``,
S a multiple of 128, patches included) and the SSM's intra-chunk term
through kernel 5
(``repro_torch.kernels.ssd_scan``, via ``models/ssm.py``); without it the
reference's routes hold: ``chunked_attention`` at S >= 2048,
``full_attention`` below, and the SSD einsum. Decoding uses
``decode_attention`` and ``ssd_decode_step``. Whisper's encoder and
cross-attention take the plain routes always, as the reference's do. The
cache's K/V, SSM states, conv windows and cross K/V are updated in place
and the cache dict is returned; its ``pos`` is a Python int.
``forward`` is differentiable (the training path, ``repro_torch.train``):
with ``remat`` each decoder layer, the reference's scan ``body`` with
whisper's cross K/V, runs under ``cfg.remat_policy`` through
``torch.utils.checkpoint`` (:func:`remat_wrap`); prefill and decoding run
without autograd.

Sharding (the reference's hooks): a model whose parameters are DTensors
(``repro_torch.launch.sharding.distribute_model``) runs the same code as a
sharded program, every op through DTensor's sharding rules; an op without
a rule raises. The constants the blocks make (positions, RoPE tables,
the sinusoids) are replicated DTensors (``layers.replicated_like``); the
attention, the SSD scan, the MoE's dispatch and combine and the
embedding lookup run on each rank's shard as plain tensors.
``set_attention_sharding`` installs the attention activations' layout:
with ``cfg.shard_attn`` q, k, v and o (B, S, H, D) are redistributed to
batch over the batch axes and heads over the model axis. A sharded
program takes the plain routes: ``use_kernel=True`` raises there. With
``cfg.cast_weights_once`` every >= 2-D f32 master of the layer stacks is
cast to ``cfg.dtype`` once per forward, prefill or decode step, before the
layer loop (so sharded gathers move ``cfg.dtype``), where each matmul
otherwise casts its weight at its use: the same casts of the same values,
so the logits are the same bits either way. Plain tensors take none of
this: the unsharded program pays no DTensor overhead.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import flash_attention as kernel4
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import local_span
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, arange_like, dense_init,
                                       embed_init, keep_shards, local,
                                       replicated_like, rms_norm, settle,
                                       silu, swiglu, wrap_local)


# Launcher-installed activation sharding for attention (see
# set_attention_sharding): (batch axes, model axis name) or None.
_ATTN_SHARDING: list = [None]


def set_attention_sharding(batch_axes, model_axis) -> None:
    """Install (or clear, with a None ``model_axis``) the attention
    activations' layout used when ``cfg.shard_attn`` is on, by mesh axis
    names. Called by the launch layer per mesh."""
    _ATTN_SHARDING[0] = ((tuple(batch_axes), model_axis)
                         if model_axis else None)


def _constrain_bshd(x, cfg: ArchConfig):
    """x (B, S, H, D) redistributed to batch over the installed batch axes
    and heads over the model axis, where ``cfg.shard_attn`` is on and x
    is a DTensor; x itself otherwise."""
    if (not cfg.shard_attn or _ATTN_SHARDING[0] is None
            or not isinstance(x, DTensor)):
        return x
    batch_axes, model_axis = _ATTN_SHARDING[0]
    mesh = x.device_mesh
    want = [Shard(0) if a in batch_axes else
            Shard(2) if a == model_axis else Replicate()
            for a in mesh.mesh_dim_names]
    return x.redistribute(mesh, want)


def _heads(x, n: int, dh: int):
    """(B, S, n * dh) -> (B, S, n, dh). A DTensor whose last dim is
    sharded across more ranks than divide ``n`` (a head would be split) is
    gathered on it first (``redistribute``)."""
    if isinstance(x, DTensor):
        mesh, want, ranks = x.device_mesh, list(x.placements), 1
        for i, p in enumerate(want):
            if isinstance(p, Shard) and p.dim == x.dim() - 1:
                ranks *= mesh.size(i)
        if n % ranks:
            want = [Replicate() if isinstance(p, Shard)
                    and p.dim == x.dim() - 1 else p for p in want]
            x = x.redistribute(mesh, want)
    return x.reshape(*x.shape[:-1], n, dh)


def _plain_routes(params, use_kernel: bool) -> None:
    """A sharded model (DTensor parameters) takes the plain routes, as the
    reference's sharded programs do: ``use_kernel`` raises there."""
    if use_kernel and isinstance(params.embed, DTensor):
        raise NotImplementedError(
            "use_kernel=True on a sharded model: the sharded program takes "
            "the plain routes (kernels 4 and 5 take plain tensors)")


class _CastLayer:
    """A layer's parameters under their names, each >= 2-D f32 master cast
    to ``dtype`` (``cast_weights_once``); 1-D vectors (norms, biases,
    a_log, dt_bias) stay f32."""

    def __init__(self, module: nn.Module, dtype):
        self._params = {}
        for name, p in module.named_parameters(recurse=False):
            if p.dim() >= 2 and p.dtype == torch.float32:
                p = p.to(dtype)
            self._params[name] = p
            setattr(self, name, p)
        for name, child in module.named_children():
            setattr(self, name, _CastLayer(child, dtype))

    def named_parameters(self):
        return self._params.items()


def _cast_layers(layers, cfg: ArchConfig):
    """The layer stack as the loop reads it: cast once per call under
    ``cfg.cast_weights_once`` (the reference's ``_cast_layers``), else the
    modules themselves (each matmul casts at its use)."""
    if not cfg.cast_weights_once:
        return layers
    cdt = getattr(torch, cfg.dtype)
    return [_CastLayer(layer, cdt) for layer in layers]


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


class MoE(nn.Module):
    """Routed experts (``experts_eff`` of them, padded ones zero) and, where
    the config has them, the shared experts' SwiGLU."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        d, fe, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.experts_eff
        self.router = _param(d, e, device=device)
        self.w_gate = _param(e, d, fe, device=device)
        self.w_up = _param(e, d, fe, device=device)
        self.w_down = _param(e, fe, d, device=device)
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * fe
            self.shared_gate = _param(d, fs, device=device)
            self.shared_up = _param(d, fs, device=device)
            self.shared_down = _param(fs, d, device=device)


class DecoderLayer(nn.Module):
    """``ln1``, then ``attn`` and/or ``ssm``, then ``ln_cross`` and
    ``cross`` in whisper's decoder, then ``ln2`` and ``moe`` or ``mlp``
    where the config has experts or a feed-forward width, as the
    reference's ``_layer_params`` builds them."""

    def __init__(self, cfg: ArchConfig, device, cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _param(d, device=device, fill=1.0)
        if cfg.has_attention:
            self.attn = Attention(cfg, device)
        if cfg.has_ssm:
            self.ssm = SSM(cfg, device)
        if cross:
            self.ln_cross = _param(d, device=device, fill=1.0)
            self.cross = Attention(cfg, device)
        if cfg.num_experts:
            self.ln2 = _param(d, device=device, fill=1.0)
            self.moe = MoE(cfg, device)
        elif cfg.d_ff:
            self.ln2 = _param(d, device=device, fill=1.0)
            self.mlp = MLP(cfg, device)


class Model(nn.Module):
    """A decoder's parameters (uninitialized; :func:`init_params` or
    ``repro_torch.interop.lm_params_from_arrays`` fills them)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        # "meta" builds the parameters' shapes and nothing else (the dry
        # run's abstract model); any other device must be a real one
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        self.cfg = cfg
        self.embed = _param(cfg.vocab_padded, cfg.d_model, device=device)
        self.ln_f = _param(cfg.d_model, device=device, fill=1.0)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, cross=cfg.is_encdec)
            for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab_padded,
                                  device=device)
        if cfg.is_encdec:  # whisper's encoder: the decoder's widths
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, device)
                for _ in range(cfg.encoder_layers))
            self.enc_ln_f = _param(cfg.d_model, device=device, fill=1.0)


def set_parameter(model: nn.Module, name: str, t: torch.Tensor,
                  requires_grad: bool = True) -> None:
    """Replace ``model``'s parameter ``name`` (a dotted path) by ``t``."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    setattr(mod, leaf, nn.Parameter(t, requires_grad=requires_grad))


def tree_param_count(cfg: ArchConfig) -> int:
    """The parameters of the reference's ``init_params`` tree for ``cfg``
    (``_attn_params``, ``_ssm_params``, ``_layer_params``, whisper's
    encoder), counted from the config: what a :class:`Model` must hold.
    ``ArchConfig.param_count()`` is the reference's analytic count: it
    leaves out the SSM's dt_bias, a_log, d_skip, conv_w and ssm_norm, the
    norms of the encoder and cross-attention and padded experts, and counts
    an ln2 that mamba2 does not have."""
    d = cfg.d_model
    attn = 0
    if cfg.has_attention:
        dh, hq, hkv = (cfg.resolved_head_dim, cfg.q_heads_eff,
                       cfg.kv_heads_eff)
        attn = 2 * d * hq * dh + 2 * d * hkv * dh
        attn += 2 * dh if cfg.qk_norm else 0
    layer = d + attn  # ln1, attn
    if cfg.has_ssm:
        h, n = cfg.ssm_heads, cfg.ssm_state
        din = h * cfg.ssm_head_dim
        layer += (3 * d * din + 2 * d * n + d * h + 3 * h
                  + cfg.ssm_conv_width * (din + 2 * n) + din)
    if cfg.num_experts:
        fe, e = cfg.moe_d_ff or cfg.d_ff, cfg.experts_eff
        layer += d + d * e + 3 * e * d * fe  # ln2, router, experts
        layer += 3 * d * cfg.num_shared_experts * fe
    elif cfg.d_ff:
        layer += d + 3 * d * cfg.d_ff
    head = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    total = cfg.num_layers * layer + head + d
    if cfg.is_encdec:  # ln_cross and cross per decoder layer; the encoder
        total += cfg.num_layers * (d + attn)
        total += cfg.encoder_layers * layer + d
    return total


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


def _init_moe(m: MoE, cfg: ArchConfig, gen) -> None:
    d, fe, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.experts_eff
    m.router.copy_(dense_init(gen, (d, e)))
    m.w_gate.copy_(dense_init(gen, (e, d, fe)))
    m.w_up.copy_(dense_init(gen, (e, d, fe)))
    m.w_down.copy_(dense_init(gen, (e, fe, d), scale=fe ** -0.5))
    # padded experts are never routed: zero weights and router columns
    real = cfg.num_experts
    for w in (m.w_gate, m.w_up, m.w_down):
        w[real:] = 0.0
    m.router[:, real:] = 0.0
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * fe
        m.shared_gate.copy_(dense_init(gen, (d, fs)))
        m.shared_up.copy_(dense_init(gen, (d, fs)))
        m.shared_down.copy_(dense_init(gen, (fs, d), scale=fs ** -0.5))


def _init_layer(layer: DecoderLayer, cfg: ArchConfig, gen) -> None:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.has_attention:
        _init_attention(layer.attn, cfg, gen)
    if cfg.has_ssm:
        _init_ssm(layer.ssm, cfg, gen)
    if hasattr(layer, "cross"):
        _init_attention(layer.cross, cfg, gen)
    if cfg.num_experts:
        _init_moe(layer.moe, cfg, gen)
    elif cfg.d_ff:
        layer.mlp.wg.copy_(dense_init(gen, (d, f)))
        layer.mlp.wu.copy_(dense_init(gen, (d, f)))
        layer.mlp.wd.copy_(dense_init(gen, (f, d), scale=f ** -0.5))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator) -> Model:
    """The reference's initialization, drawn from ``generator`` on its
    device: normal embeddings at 0.02, dense weights (routers and experts
    too) at fan_in^-0.5, norms and ``d_skip`` at one, ``wo`` at zero (the
    reference's skip-init, so each attention sublayer, cross-attention
    included, adds nothing until ``wo`` moves; padded heads have zero
    wq/wk/wv columns and wo rows, padded experts zero weights and router
    columns), the SSM's dt bias the inverse softplus of a log-uniform dt in
    [1e-3, 1e-1] and ``a_log`` the log of a uniform A in [1, 16]."""
    model = Model(cfg, generator.device)
    d = cfg.d_model
    model.embed.copy_(embed_init(generator, (cfg.vocab_padded, d)))
    for layer in model.layers:
        _init_layer(layer, cfg, generator)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(dense_init(generator, (d, cfg.vocab_padded)))
    if cfg.is_encdec:
        for layer in model.enc_layers:
            _init_layer(layer, cfg, generator)
    return model


# --------------------------------------------------------------------------
# layer forward pieces
# --------------------------------------------------------------------------
def _attention_block(h, ap: Attention, cfg: ArchConfig, positions,
                     causal: bool, use_kernel: bool = False,
                     kv_override=None):
    """h: (B, S, D) normed input. kv_override: (k, v) (B, S_kv, Hkv, Dh)
    for cross-attention, which takes no RoPE and no k_norm; ``positions``
    None (whisper's encoder) takes no RoPE either. Returns (out, (k, v))."""
    b, s, _ = h.shape
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.q_heads_eff, cfg.kv_heads_eff
    cdt = h.dtype
    q = _constrain_bshd(_heads(h @ ap.wq.to(cdt), hq, dh), cfg)
    if kv_override is None:
        k = _constrain_bshd(_heads(h @ ap.wk.to(cdt), hkv, dh), cfg)
        v = _constrain_bshd(_heads(h @ ap.wv.to(cdt), hkv, dh), cfg)
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = rms_norm(q, ap.q_norm)
        if kv_override is None:
            k = rms_norm(k, ap.k_norm)
    if kv_override is None and positions is not None:
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
    o = _constrain_bshd(o, cfg)
    out = settle(o.reshape(b, s, hq * dh) @ ap.wo.to(cdt))
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
    return settle(y @ sp.out.to(cdt))


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


def _ffn_block(x, layer: DecoderLayer, cfg: ArchConfig):
    """The feed-forward on the normed input: the routed (and shared)
    experts, whose whole subtree is cast to x's dtype first, as the
    reference's, or the SwiGLU. Returns (out, aux or None)."""
    cdt = x.dtype
    if cfg.num_experts:
        y, aux = moe_lib.moe_ffn(
            x, {name: p.to(cdt) for name, p in layer.moe.named_parameters()},
            num_experts=cfg.experts_eff, top_k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
            num_real_experts=cfg.num_experts)
        return settle(y), aux
    m = layer.mlp
    return settle(swiglu(x, m.wg.to(cdt), m.wu.to(cdt), m.wd.to(cdt))), None


def _embed_inputs(params: Model, cfg: ArchConfig, batch) -> torch.Tensor:
    """Token embeddings, and for the vlm stub the patch embeddings
    (B, P, D) ahead of them, in the compute dtype."""
    cdt = getattr(torch, cfg.dtype)
    x = _lookup(params.embed, batch["tokens"].long()).to(cdt)
    if cfg.num_patches and "patches" in batch:
        x = torch.cat([batch["patches"].to(cdt), x], dim=1)
    return x


def _lookup(table, tokens):
    """``table[tokens]``. A DTensor table runs it rank-locally, as XLA
    partitions the reference's gather: each rank looks up its tokens'
    batch shard in its own vocabulary rows (its D shard kept), zeros where
    a token lies outside them, and the rows' sums across the vocabulary's
    ranks are all-reduced; the gradient is the indexing's own on each
    shard (torch 2.11's DTensor rule for its backward, ``index_put``,
    fails), summed over the batch's ranks where the table is whole."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = replicated_like(tokens, table)
    pk = keep_shards(tokens, (0,))
    pt = [Replicate() if isinstance(k, Shard) else t
          for k, t in zip(pk, keep_shards(table, (0, 1)))]
    tok, rows = local(tokens, pk), local(table, pt, pk)
    off, n = local_span(table.shape[0], mesh, pt, 0)
    mine = (tok >= off) & (tok < off + n)
    got = torch.where(mine[..., None], rows[torch.where(mine, tok - off, 0)],
                      0)
    out = [Shard(0) if isinstance(k, Shard) else
           Partial() if t == Shard(0) else
           Shard(2) if isinstance(t, Shard) else Replicate()
           for k, t in zip(pk, pt)]
    whole = [Replicate() if isinstance(o, Partial) else o for o in out]
    return wrap_local(got, mesh, out, (*tokens.shape, table.shape[1])
                      ).redistribute(mesh, whole)


def _sinusoid_pos(s: int, d: int, dtype, device) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positions (no table: any length)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-(torch.arange(0, d, 2, dtype=torch.float32,
                                   device=device) / d * math.log(10000.0)))
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encode(params: Model, cfg: ArchConfig, frames) -> torch.Tensor:
    """Whisper's encoder: frames (B, S_enc, D) stub embeddings plus the
    sinusoids, non-causal blocks without RoPE on the plain attention
    routes, the final norm -> (B, S_enc, D)."""
    cdt = getattr(torch, cfg.dtype)
    s = frames.shape[1]
    x = frames.to(cdt) + replicated_like(
        _sinusoid_pos(s, cfg.d_model, cdt, frames.device), frames)[None]
    for layer in _cast_layers(params.enc_layers, cfg):
        h = rms_norm(x, layer.ln1)
        a, _ = _attention_block(h, layer.attn, cfg, None, False)
        x = x + a
        x = x + _ffn_block(rms_norm(x, layer.ln2), layer, cfg)[0]
    return rms_norm(x, params.enc_ln_f)


def _cross_kv(layer: DecoderLayer, cfg: ArchConfig, enc_out):
    """A decoder layer's cross-attention K and V (B, S_enc, Hkv, Dh) from
    the encoder's output."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.kv_heads_eff, cfg.resolved_head_dim)
    cdt = enc_out.dtype
    return (_heads(enc_out @ layer.cross.wk.to(cdt), *shape[2:]),
            _heads(enc_out @ layer.cross.wv.to(cdt), *shape[2:]))


def _cross_block(x, layer: DecoderLayer, cfg: ArchConfig, kv):
    """x plus its cross-attention to the encoder's K/V ``kv`` (the plain
    route: non-causal, no RoPE)."""
    c, _ = _attention_block(rms_norm(x, layer.ln_cross), layer.cross, cfg,
                            None, False, kv_override=kv)
    return x + c


def _logits(params: Model, cfg: ArchConfig, x) -> torch.Tensor:
    x = rms_norm(x, params.ln_f)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(x.dtype)


def _layers(params: Model, cfg: ArchConfig, x, use_kernel: bool,
            cache: dict | None = None, enc_out=None, remat: str = "none"):
    """The decoder stack over a full sequence from position 0; with a cache
    it also writes each layer's K/V at [0, S), SSM state and conv window,
    and cross K/V. ``enc_out``: whisper's encoder output. ``remat``: the
    activation-checkpoint policy of each layer (:func:`remat_wrap`; a
    cache takes none). Returns (x, the MoE layers' aux dicts)."""
    s = x.shape[1]
    positions = arange_like(s, x, dtype=torch.int32)[None]
    k_conv = cfg.ssm_conv_width - 1

    def body(x, layer, i):
        """One decoder layer, whisper's cross K/V included: the
        reference's scan ``body``, the unit that remat recomputes."""
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
        if enc_out is not None:
            kv = _cross_kv(layer, cfg, enc_out)
            if cache is not None:
                cache["cross_k"][i].copy_(kv[0])
                cache["cross_v"][i].copy_(kv[1])
            x = _cross_block(x, layer, cfg, kv)
        aux = None
        if cfg.num_experts or cfg.d_ff:
            y, aux = _ffn_block(rms_norm(x, layer.ln2), layer, cfg)
            x = x + y
        return x, aux

    block = body if cache is not None else remat_wrap(body, remat)
    auxes = []
    for i, layer in enumerate(_cast_layers(params.layers, cfg)):
        x, aux = block(x, layer, i)
        if aux is not None:
            auxes.append(aux)
    return x, auxes


REMAT_POLICIES = ("none", "full", "save_dots", "save_all_dots")


def _saved_ops(policy: str) -> set:
    """The ops whose outputs a selective policy keeps: the unbatched
    products (``save_dots``, the reference's
    ``dots_with_no_batch_dims_saveable``: the projections' ``mm``, and the
    down projection's ``mm.dtype`` on the card), and the batched ones too
    (``save_all_dots``, its ``dots_saveable``: the attention's and the
    experts' einsums lower to ``bmm``). No product of the model has a bias,
    so none is an ``addmm``."""
    aten = torch.ops.aten
    ops = {aten.mm.default, aten.mm.dtype}
    if policy == "save_all_dots":
        ops.add(aten.bmm.default)
    return ops


def remat_wrap(fn, policy: str):
    """``fn`` under the activation-checkpoint ``policy``, as the
    reference's ``jax.checkpoint`` of its layer ``body``: ``none`` keeps
    every activation for the backward; ``full`` keeps only ``fn``'s inputs
    and recomputes the rest in the backward; ``save_dots`` and
    ``save_all_dots`` keep the outputs of the products of
    :func:`_saved_ops` and recompute the rest. Without autograd (no grad
    mode) every policy is ``fn`` itself. Recomputing is the same ops on
    the same inputs, so no policy changes a bit of the gradients."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of "
                         f"{REMAT_POLICIES}")
    if policy == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    kw = {}
    if policy != "full":
        saved = _saved_ops(policy)

        def keep(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, keep)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _encoded(params: Model, cfg: ArchConfig, batch):
    """Whisper's encoder output for ``batch["frames"]``, else None."""
    return encode(params, cfg, batch["frames"]) if cfg.is_encdec else None


# --------------------------------------------------------------------------
# full-sequence forward (train / prefill math)
# --------------------------------------------------------------------------
def forward(params: Model, cfg: ArchConfig, batch, use_kernel: bool = False,
            remat: bool = True):
    """Returns (logits (B, S, V), aux dict). With ``remat`` each decoder
    layer runs under ``cfg.remat_policy`` (:func:`remat_wrap`: ``full``,
    ``save_dots``, ``save_all_dots`` or ``none``), as the reference's scan
    body; without it, or under no grad mode, every activation is kept. The
    policy trades memory for recompute in the backward and changes no
    value."""
    _plain_routes(params, use_kernel)
    x, auxes = _layers(params, cfg, _embed_inputs(params, cfg, batch),
                       use_kernel, enc_out=_encoded(params, cfg, batch),
                       remat=cfg.remat_policy if remat else "none")
    logits = _logits(params, cfg, x)
    if auxes:  # the MoE layers': means of the losses, the summed loads
        aux = {"lb_loss": torch.stack([a["lb_loss"] for a in auxes]).mean(),
               "z_loss": torch.stack([a["z_loss"] for a in auxes]).mean(),
               "expert_load": torch.stack([a["expert_load"]
                                           for a in auxes]).sum(0)}
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"lb_loss": zero, "z_loss": zero,
               "expert_load": torch.zeros(1, device=x.device)}
    return logits, aux


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, enc_seq: int = 0,
               device="cuda") -> dict:
    """Zero caches on ``device`` (the card unless the caller asks for the
    CPU): K/V (L, B, max_seq, Hkv, Dh) in ``cfg.dtype`` where the family
    has attention; SSM states (L, B, H, P, N) in f32 and conv windows
    (L, B, K-1, H*P + 2N) in ``cfg.dtype`` where it has an SSM; cross K/V
    (L, B, enc_seq, Hkv, Dh) in ``cfg.dtype`` for whisper, where
    ``enc_seq`` is the frames' length. ``max_seq`` counts every position
    the prefill writes: a vlm's patches too. ``device="meta"`` gives the
    abstract cache (shapes and dtypes, nothing allocated)."""
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
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
    if cfg.is_encdec:
        shape = (nl, batch, enc_seq, cfg.kv_heads_eff,
                 cfg.resolved_head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=cdt, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=cdt, device=device)
    return cache


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, batch, cache: dict,
            use_kernel: bool = False):
    """Full-sequence prefill that also fills the cache (K/V at [0, S), S
    counting a vlm's patches, SSM states and conv windows, whisper's cross
    K/V). Returns (last-position logits (B, V), cache)."""
    _plain_routes(params, use_kernel)
    x, _ = _layers(params, cfg, _embed_inputs(params, cfg, batch),
                   use_kernel, cache, enc_out=_encoded(params, cfg, batch))
    cache["pos"] = x.shape[1]
    return _logits(params, cfg, x[:, -1]), cache


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, tokens, cache: dict):
    """One decode step. tokens: (B, 1) int. Returns (logits (B, V),
    cache)."""
    x = _embed_inputs(params, cfg, {"tokens": tokens})  # (B, 1, D)
    cdt = x.dtype
    b = x.shape[0]
    pos = int(cache["pos"])
    positions = x.new_full((1, 1), pos, dtype=torch.int32)
    dh, hq, hkv = cfg.resolved_head_dim, cfg.q_heads_eff, cfg.kv_heads_eff
    for i, layer in enumerate(_cast_layers(params.layers, cfg)):
        h = rms_norm(x, layer.ln1)
        parts = []
        if cfg.has_attention:
            ap = layer.attn
            q = _heads(h @ ap.wq.to(cdt), hq, dh)
            k = _heads(h @ ap.wk.to(cdt), hkv, dh)
            v = _heads(h @ ap.wv.to(cdt), hkv, dh)
            if cfg.qk_norm:
                q = rms_norm(q, ap.q_norm)
                k = rms_norm(k, ap.k_norm)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            kc, vc = attn_lib.update_cache(cache["k"][i], cache["v"][i], k,
                                           v, pos)
            o = attn_lib.decode_attention(q, kc, vc, pos)
            parts.append(settle(o.reshape(b, 1, hq * dh) @ ap.wo.to(cdt)))
        if cfg.has_ssm:
            parts.append(_ssm_decode(h, layer.ssm, cfg,
                                     cache["ssm_state"][i],
                                     cache["conv"][i]))
        x = x + _mix(parts)
        if cfg.is_encdec:
            x = _cross_block(x, layer, cfg,
                             (cache["cross_k"][i], cache["cross_v"][i]))
        if cfg.num_experts or cfg.d_ff:
            x = x + _ffn_block(rms_norm(x, layer.ln2), layer, cfg)[0]
    cache["pos"] = pos + 1
    return _logits(params, cfg, x[:, 0]), cache
