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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a constant that every rank makes alike (positions, masks,
    an accumulator's start), as a replicated DTensor on ``ref``'s mesh
    where ``ref`` is a DTensor (a sharded program's activation); ``t``
    itself where it is not. Every constant of the blocks goes through it
    (or a ``new_*`` factory of a DTensor), so a sharded program never
    mixes plain tensors and DTensors. A DTensor ``t`` is returned as it
    is."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous: a
    DTensor takes a local gradient under its own (contiguous) strides, and
    a view of it fails on a transposed one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local(t: DTensor, placements, work=None) -> torch.Tensor:
    """This rank's shard of ``t`` laid out by ``placements``
    (redistributed first where they differ). ``work``: the placements of
    the rank-local computation that takes it (its output's, or its
    sharded operand's); along a mesh dim where the work is sharded and
    ``t`` is whole, each rank's gradient of ``t`` holds only its shard's
    part, so there it is taken as a partial sum (reduced across the
    ranks), not as a replica."""
    placements = list(placements)
    grad = None
    if work is not None:
        grad = [Partial() if isinstance(w, Shard) and p == Replicate()
                else p for p, w in zip(placements, work)]
    out = t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grad)
    return _ContiguousGrad.apply(out) if out.requires_grad else out


def wrap_local(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this rank is ``t``,
    laid out by ``placements`` (the inverse of :func:`local`). Its
    strides are the contiguous ones, so a strided ``t`` is copied
    contiguous first (DTensor's views act on the shard as laid out)."""
    shape = torch.Size(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh, list(placements),
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def keep_shards(t: DTensor, dims) -> list:
    """``t``'s placements with its ``Shard`` on the tensor dims ``dims``
    kept and every other placement made ``Replicate``."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in t.placements]


def settle(t: torch.Tensor) -> torch.Tensor:
    """A sublayer's output before it joins the residual stream: a DTensor's
    partial sums (a row-sharded projection's) reduced across their ranks
    (an all-reduce), so the stream stays replicated over the model axis,
    as the reference's partitioner keeps it. Left partial, DTensor's
    rules would carry it into the next layer, gather the next weights
    whole and compute the products again on every rank."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def arange_like(n: int, ref: torch.Tensor, **kw) -> torch.Tensor:
    """``torch.arange(n)`` on ``ref``'s device, laid out as
    :func:`replicated_like`."""
    return replicated_like(torch.arange(n, device=ref.device, **kw), ref)


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
    f32 (``aten::mm.dtype``; on DTensors through the rule of
    :func:`register_mm_dtype_sharding`)."""
    if isinstance(a2, DTensor):
        register_mm_dtype_sharding()
    return torch.mm(a2, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """The card's route of :func:`matmul_f32`: ``aten::mm.dtype``, which
    autograd has no formula for, rounded once to the operands' dtype. The
    backward is the reference's transpose of ``dot_general(a, b,
    preferred_element_type=f32)``: the cotangent (here of the operands'
    dtype, which f32 holds exactly) times each operand, accumulated in
    f32 and rounded once, ``da = ct @ b^T`` and ``db = a^T @ ct``, each
    a half-width ``mm(out_dtype=f32)`` whose partial sums (``db``'s over
    the token-sharded rows) are reduced before the rounding, as in the
    forward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = settle(_mm_f32(a.reshape(-1, a.shape[-1]), b))
        return out.view(*a.shape[:-1], b.shape[-1]).to(a.dtype)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        c2 = ct.reshape(-1, ct.shape[-1])
        da = db = None
        if ctx.needs_input_grad[0]:
            da = settle(_mm_f32(c2, b.t())).to(a.dtype).view(a.shape)
        if ctx.needs_input_grad[1]:
            db = settle(_mm_f32(a.reshape(-1, a.shape[-1]).t(), c2)).to(
                b.dtype)
        return da, db


class _SettleGrad(torch.autograd.Function):
    """The identity, whose backward reduces a DTensor gradient's partial
    sums (:func:`settle`): put after an upcast, it makes the f32 gradient
    whole before the upcast's backward rounds it to the narrow dtype."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return settle(g)


_MM_DTYPE_SHARDING: list = [False]


def register_mm_dtype_sharding() -> None:
    """Give DTensor a sharding rule for ``aten::mm.dtype`` (the card's
    route of :func:`matmul_f32`), which it has none of: ``aten::mm``'s,
    per mesh dim replicate all, shard M (the rows of ``a``), shard N (the
    columns of ``b``), or shard K in both operands for a partial sum of
    the f32 output. Idempotent; :func:`matmul_f32`'s card route calls it
    on DTensors."""
    if _MM_DTYPE_SHARDING[0] or "dtype" not in torch.ops.aten.mm.overloads():
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype(a, b, out_dtype):  # placements: [out], [a, b, out_dtype]
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]
    _MM_DTYPE_SHARDING[0] = True


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
    transpose of it is the reference's. A DTensor product's partial sums
    are reduced in f32, before the rounding (:func:`settle`), as the
    reference's partitioner reduces its f32 dot; so are the backward's
    (the weight gradient's, summed over token-sharded rows)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        if "dtype" not in torch.ops.aten.mm.overloads():
            raise RuntimeError(
                f"torch {torch.__version__} has no aten::mm.dtype: no "
                "half-width GEMM with an f32 accumulator and output")
        return _MatmulF32.apply(a, b)
    a32, b32 = a.float(), b.float()
    if isinstance(a, DTensor):
        a32, b32 = _SettleGrad.apply(a32), _SettleGrad.apply(b32)
    return settle(torch.matmul(a32, b32)).to(a.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S). The split-half form: the
    first and second halves of Dh are the pair rotated together."""
    dh = x.shape[-1]
    freqs = replicated_like(rope_freqs(dh, theta, x.device),
                            positions)  # (Dh/2,)
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
