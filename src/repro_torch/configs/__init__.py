"""Architecture registry: one module per assigned arch, copied from the
reference's ``repro/configs`` (the configs are data).

``get(name)`` returns the full published config; ``reduced(cfg)`` the
family-preserving smoke-test config; ``input_specs(cfg, shape,
concrete=True)`` and ``cache_specs(cfg, shape, concrete=True)`` small
concrete inputs and caches as torch tensors, from the same numpy draws as
the reference's; with ``concrete=False`` (the default, as the reference's)
their abstract form, tensors on the ``meta`` device whose shapes and
dtypes are the reference's ``ShapeDtypeStruct``s (the dry run's,
``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

ARCH_NAMES = [
    "mamba2_2p7b",
    "deepseek_moe_16b",
    "granite_moe_3b_a800m",
    "yi_6b",
    "llama3p2_1b",
    "qwen3_14b",
    "mistral_nemo_12b",
    "phi3_vision_4p2b",
    "hymba_1p5b",
    "whisper_base",
]

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}
_ALIASES.update({
    "mamba2-2.7b": "mamba2_2p7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "yi-6b": "yi_6b",
    "llama3.2-1b": "llama3p2_1b",
    "qwen3-14b": "qwen3_14b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "hymba-1.5b": "hymba_1p5b",
    "whisper-base": "whisper_base",
})


def get(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {n: get(n) for n in ARCH_NAMES}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving small config for CPU smoke tests."""
    kw = dict(
        num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=128, pad_vocab_to=1,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=32)
    if cfg.has_ssm:
        kw.update(ssm_heads=4, ssm_head_dim=8, ssm_state=8, ssm_chunk=32)
    if cfg.is_encdec:
        kw.update(encoder_layers=2)
    if cfg.num_patches:
        kw.update(num_patches=8)
    return dataclasses.replace(cfg, **kw)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, concrete=False,
                batch_override: int | None = None,
                seq_override: int | None = None, device="cuda") -> dict:
    """Model inputs for (cfg, shape): with ``concrete`` small torch tensors
    on ``device`` (the card unless the caller asks for the CPU), drawn as
    the reference draws them (tokens from ``default_rng(0)``, embeddings
    from ``default_rng(1)``); without it ``meta`` tensors of the same
    shapes and dtypes (int32 tokens, ``cfg.dtype`` embeddings)."""
    from repro_torch.core.engine import resolve_device
    device = resolve_device(device) if concrete else torch.device("meta")
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    cdt = getattr(torch, cfg.dtype)

    def tok(shp):
        if not concrete:
            return torch.empty(shp, dtype=torch.int32, device=device)
        rng = np.random.default_rng(0)
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, size=shp,
                                            dtype=np.int32), device=device)

    def emb(shp):
        if not concrete:
            return torch.empty(shp, dtype=cdt, device=device)
        rng = np.random.default_rng(1)
        return torch.as_tensor(rng.normal(size=shp).astype(np.float32),
                               device=device).to(cdt)

    batch: dict = {}
    s_text = s
    if cfg.num_patches:  # vlm: patches occupy the first slots
        s_text = s - cfg.num_patches
        batch["patches"] = emb((b, cfg.num_patches, cfg.d_model))
    if cfg.is_encdec:  # audio stub: encoder frames + decoder tokens
        batch["frames"] = emb((b, s, cfg.d_model))
    if shape.kind == "decode":
        batch["tokens"] = tok((b, 1))
    else:
        batch["tokens"] = tok((b, s_text))
        if shape.kind == "train":
            batch["targets"] = tok((b, s_text))
    return batch


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, *, concrete=False,
                batch_override: int | None = None,
                seq_override: int | None = None, device="cuda") -> dict:
    """A zero cache for decode shapes (``model.init_cache``: K/V where the
    family has attention, f32 SSM states and conv windows where it has an
    SSM, cross K/V of ``enc_seq`` = the sequence length for whisper, as the
    reference's); without ``concrete`` the same cache on the ``meta``
    device, nothing allocated."""
    from repro_torch.models import model as model_lib
    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    return model_lib.init_cache(cfg, b, s, enc_seq=s,
                                device=device if concrete else "meta")


__all__ = ["ARCH_NAMES", "SHAPES", "get", "all_configs", "reduced",
           "input_specs", "cache_specs"]
