"""LM serving launcher: batched prefill + greedy decode with a KV cache.

The port of ``repro/launch/serve.py``: batches requests, prefills them
together, then decodes greedily, ``--gen`` tokens in all (the first from
the prefill, then ``--gen - 1`` decode steps). It runs on the card unless
``--device cpu`` is given. ``--use-kernel`` (the reference's
``use_pallas``) routes the prefill's attention through kernel 4, which
needs a prompt length that is a multiple of 128, and the SSM's intra-chunk
term through kernel 5 (the port's own route: the reference's SSM has
none). The dense, ssm and hybrid families serve; an SSM prompt longer than
the chunk (``ssm_chunk``, 256) must be a multiple of it. The moe, vlm and
audio families raise ``NotImplementedError``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_1b \\
        --batch 4 --prompt-len 2048 --gen 16 --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \\
        --batch 4 --prompt-len 2048 --gen 16 --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
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
             gen: int, use_kernel: bool = False) -> ServeResult:
    """Prefill ``prompt`` (B, S) int32, then decode greedily from position
    S: ``gen`` tokens, ``gen - 1`` decode steps."""
    b, s = prompt.shape
    if use_kernel and cfg.has_attention and s % kernel4.BLOCK:
        raise ValueError(f"--use-kernel needs a prompt length that is a "
                         f"multiple of {kernel4.BLOCK} where the model has "
                         f"attention, got {s}")
    device = prompt.device
    if use_kernel and device.type == "cuda":
        # built here, not inside the timed prefill
        if cfg.has_attention:
            kernel4.load_library()
        if cfg.has_ssm:
            kernel5.load_library()
    cache = model_lib.init_cache(cfg, b, s + gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    # prefill writes [0, S) and leaves the cache's position at S
    logits, cache = model_lib.prefill(params, cfg, {"tokens": prompt}, cache,
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
    r = generate(params, cfg, prompt, args.gen, use_kernel=args.use_kernel)
    steps = args.gen - 1
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in "
          f"{r.prefill_s * 1e3:.1f}ms; {steps} decode steps in "
          f"{r.decode_s * 1e3:.1f}ms "
          f"({steps * args.batch / max(r.decode_s, 1e-9):.0f} tok/s) on "
          f"{device}")
    out = r.tokens.cpu().numpy()
    print("[serve] sample tokens:", out[0, :12])
    return out


if __name__ == "__main__":
    main()
