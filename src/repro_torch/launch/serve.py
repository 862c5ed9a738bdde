"""LM serving launcher: batched prefill + greedy decode with a KV cache.

The port of ``repro/launch/serve.py``: batches requests, prefills them
together, then decodes greedily, ``--gen`` tokens in all (the first from
the prefill, then ``--gen - 1`` decode steps). It runs on the card unless
``--device cpu`` is given. ``--use-kernel`` (the reference's
``use_pallas``) routes the prefill's attention through kernel 4, which
needs a prefill length (a vlm's patches and the prompt) that is a multiple
of 128, and the SSM's intra-chunk term through kernel 5 (the port's own
route: the reference's SSM has none). Every family serves; an SSM prompt
longer than the chunk (``ssm_chunk``, 256) must be a multiple of it. The
vlm stub (phi3_vision_4p2b) prefills ``num_patches`` seeded patch
embeddings ahead of the prompt, and the cache holds them (the reference's
launcher sizes it for the prompt alone, too short for the patches); the
audio stub (whisper_base) encodes ``--prompt-len`` seeded frame embeddings,
as the reference's launcher draws them.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_1b \\
        --batch 4 --prompt-len 2048 --gen 16 --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \\
        --batch 4 --prompt-len 2048 --gen 16 --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite_moe_3b_a800m --batch 4 --prompt-len 2048 --gen 16 \\
        --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3_vision_4p2b --reduced --prompt-len 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import flash_attention as kernel4
from repro_torch.kernels import ssd_scan as kernel5
from repro_torch.models import model as model_lib
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # (B, gen) generated tokens
    prefill_logits: torch.Tensor  # (B, V) at the prompt's last position
    decode_logits: list  # gen - 1 tensors (B, V), one per decode step
    prefill_s: float  # host seconds, ending in a device sync
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: model_lib.Model, cfg: ArchConfig, prompt: torch.Tensor,
             gen: int, use_kernel: bool = False,
             patches: torch.Tensor | None = None,
             frames: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``prompt`` (B, S) int32, behind a vlm's ``patches``
    (B, P, D) where given, then decode greedily from position P + S:
    ``gen`` tokens, ``gen - 1`` decode steps. Whisper's decoder attends to
    the encoding of ``frames`` (B, S_enc, D)."""
    b, s = prompt.shape
    n_patches = 0 if patches is None else patches.shape[1]
    if use_kernel and cfg.has_attention and (n_patches + s) % kernel4.BLOCK:
        raise ValueError(f"--use-kernel needs a prefill length (patches and "
                         f"prompt) that is a multiple of {kernel4.BLOCK} "
                         f"where the model has attention, got {n_patches} + "
                         f"{s}")
    if cfg.is_encdec and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames")
    device = prompt.device
    if use_kernel and device.type == "cuda":
        # built here, not inside the timed prefill
        if cfg.has_attention:
            kernel4.load_library()
        if cfg.has_ssm:
            kernel5.load_library()
    batch = {"tokens": prompt}
    if patches is not None:
        batch["patches"] = patches
    if frames is not None:
        batch["frames"] = frames
    cache = model_lib.init_cache(
        cfg, b, n_patches + s + gen,
        enc_seq=0 if frames is None else frames.shape[1], device=device)
    _sync(device)
    t0 = time.perf_counter()
    # prefill writes [0, P + S) and leaves the cache's position there
    logits, cache = model_lib.prefill(params, cfg, batch, cache,
                                      use_kernel=use_kernel)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_logits, out_tokens, decode_logits = logits, [tok], []
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model_lib.decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out_tokens.append(tok)
        decode_logits.append(logits)
    _sync(device)
    return ServeResult(torch.cat(out_tokens, dim=1), prefill_logits,
                       decode_logits, prefill_s, time.perf_counter() - t0)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--use-kernel", action="store_true",
                    help="prefill attention through kernel 4, the SSM's "
                         "intra-chunk term through kernel 5")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                     dtype=np.int32), device=device)
    cdt = getattr(torch, cfg.dtype)

    def embeddings(s):  # the reference launcher's draws, in its order
        return torch.as_tensor(rng.normal(size=(
            args.batch, s, cfg.d_model)).astype(np.float32),
            device=device).to(cdt)
    patches = embeddings(cfg.num_patches) if cfg.num_patches else None
    frames = embeddings(args.prompt_len) if cfg.is_encdec else None
    r = generate(params, cfg, prompt, args.gen, use_kernel=args.use_kernel,
                 patches=patches, frames=frames)
    steps = args.gen - 1
    print(f"[serve] prefill {args.batch}x"
          f"{cfg.num_patches or ''}{'+' if cfg.num_patches else ''}"
          f"{args.prompt_len} in "
          f"{r.prefill_s * 1e3:.1f}ms; {steps} decode steps in "
          f"{r.decode_s * 1e3:.1f}ms "
          f"({steps * args.batch / max(r.decode_s, 1e-9):.0f} tok/s) on "
          f"{device}")
    out = r.tokens.cpu().numpy()
    print("[serve] sample tokens:", out[0, :12])
    return out


if __name__ == "__main__":
    main()
