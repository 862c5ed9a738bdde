"""Shared layer math: norms, RoPE, SwiGLU, initializers.

The port of ``repro/models/layers.py``: plain functions on tensors, in the
reference's precision (norms and RoPE in f32, cast back to the input's
dtype; the SwiGLU down projection accumulated in f32, on the card through
``aten::mm.dtype`` with a backward of its own, and its SiLU in the
reference's op order). The initializers draw from an explicit
``torch.Generator`` on the generator's device; they do not reproduce
``jax.random``'s numbers (tests hand the reference's parameters over
instead, ``repro_torch.interop.lm_params_from_arrays``).
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference's SSM runs it: x * (1 / (1 +
    exp(-x))), each op rounded to x's dtype (in bf16 ``F.silu`` rounds once
    and differs from it by an ulp on a third of the inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = silu(x @ w_gate) * (x @ w_up)
    return matmul_f32(h, w_down)


def _mm_f32(a2: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) of one half-width dtype, accumulated and written in
    f32 (``aten::mm.dtype``)."""
    return torch.mm(a2, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """The card's route of :func:`matmul_f32`: ``aten::mm.dtype``, which
    autograd has no formula for, rounded once to the operands' dtype. The
    backward is the reference's transpose of ``dot_general(a, b,
    preferred_element_type=f32)``: the cotangent (here of the operands'
    dtype, which f32 holds exactly) times each operand, accumulated in
    f32 and rounded once, ``da = ct @ b^T`` and ``db = a^T @ ct``, each
    a half-width ``mm(out_dtype=f32)``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = _mm_f32(a.reshape(-1, a.shape[-1]), b)
        return out.view(*a.shape[:-1], b.shape[-1]).to(a.dtype)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        c2 = ct.reshape(-1, ct.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(c2, b.t()).to(a.dtype).view(a.shape)
        if ctx.needs_input_grad[1]:
            db = _mm_f32(a.reshape(-1, a.shape[-1]).t(), c2).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a (..., K), b (K, N)) accumulated in f32, as the
    reference's ``preferred_element_type=f32``, and rounded once to a's
    dtype. On a card, a bf16 or fp16 pair goes through ``torch.mm(...,
    out_dtype=torch.float32)`` (:class:`_MatmulF32`, with its backward):
    the GEMM reads the half-width operands into the tensor cores' f32
    accumulator and writes f32, so no partial sum is rounded to the
    operands' type (a plain half-width ``matmul`` may reduce split-K
    partials in it). A torch without that overload raises. Elsewhere both
    operands go to f32 first: the products of two bf16 values are exact in
    f32, so this is the same function up to sum order, and autograd's
    transpose of it is the reference's."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        if "dtype" not in torch.ops.aten.mm.overloads():
            raise RuntimeError(
                f"torch {torch.__version__} has no aten::mm.dtype: no "
                "half-width GEMM with an f32 accumulator and output")
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S). The split-half form: the
    first and second halves of Dh are the pair rotated together."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    angles = positions[..., None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)
