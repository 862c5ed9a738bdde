"""Flash attention: hand-written CUDA kernel 4, its wrapper and its plain
PyTorch versions.

The kernel replaces the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention`` / ``_kernel``, which
``repro/models/model.py::_attention_block`` calls under ``use_pallas`` on
the prefill and full-sequence forward: causal (or full) GQA attention with
an online softmax, q (B, Hq, S, D) and k, v (B, Hkv, S, D), Hq % Hkv == 0,
S % 128 == 0, f32 or bf16 in, the output contiguous in q's dtype. The
kernel is ``repro_torch/csrc/flash_attention.cu``; its source note gives
the design and what bounds it. It takes D in (64, 96, 128); another head
dim raises. D = 96 (phi-3's heads) is an instantiation of each route: the
bf16 route loads a 96-column row as two 64-column boxes whose columns past
96 TMA fills with zeros in shared memory (no padded copy in memory), the
f32 route gives each thread 6 output columns. Two routes:

* bf16: Hopper's tensor cores. One persistent block per SM (two consumer
  warpgroups of 64 q rows and a producer warpgroup) walks (128-row q tile,
  batch * q head) items; 128-key K/V tiles arrive by TMA in two-stage rings;
  S = q k^T and O += P v are ``wgmma`` products with f32 accumulators in
  registers, P rounded to bf16 as the register operand, one tile's softmax
  overlapping the products. The kernel reads q, k and v through their
  strides (the last one unit, the others multiples of 8 elements), so the
  model's transposed views cost no copy; other strides are made contiguous
  first.
* f32: f32 FMAs on the CUDA cores (a block per (batch * q head, 64-row q
  tile), 64-key tiles through shared memory), on contiguous tensors. TF32
  would miss the f32 bar of 2e-5 by 50-100x; a 3xTF32 split on the tensor
  cores is later work.

:func:`flash_attention` launches the kernel for tensors on a CUDA device
and runs :func:`flash_attention_ref`, the same function in plain torch, for
tensors on the CPU; there is no other path. ``flash_attention.launches``
counts its kernel launches. :func:`attention` is the port of the
reference's quadratic oracle ``repro/kernels/ref.py::attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK = 128  # S must be a multiple of it (the reference's block, :76)
HEAD_DIMS = (64, 96, 128)  # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc dtype codes
NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); Hq % Hkv == 0 and
    S % 128 == 0. Returns (B, Hq, S, D) in q's dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv or s % BLOCK:
        raise ValueError(f"flash_attention: needs Hq % Hkv == 0 and S % "
                         f"{BLOCK} == 0, got Hq={hq}, Hkv={hkv}, S={s}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    _check_cuda(q, k, v)
    if q.dtype == torch.float32:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    else:
        q, k, v = (t if _strides_ok(t) else t.contiguous() for t in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: inputs must be 16-byte "
                             "aligned")
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        s, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
        DTYPES[q.dtype], 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def load_library() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                               *[ll] * 9, i, i,
                                               ctypes.c_float, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda(q, k, v) -> None:
    b, hq, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: the kernel takes f32 or bf16, "
                         f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or t.shape != (b, k.shape[1], s, d):
            raise ValueError(f"flash_attention: {name} must be (B, Hkv, S, "
                             f"D) = {(b, k.shape[1], s, d)} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def _strides_ok(t: torch.Tensor) -> bool:
    """Whether the tensor-core route's TMA reads ``t`` in place: a unit
    last stride and the other strides in whole 16-byte units."""
    return t.stride(-1) == 1 and all(st > 0 and st % 8 == 0
                                     for st in t.stride()[:3])


# -- plain versions ------------------------------------------------------------
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the same function in f32,
    q cast and scaled before the dot as the reference does it, the causal mask
    at -1e30, the unnormalized probabilities summed and divided at the end
    (``acc / max(l, 1e-30)``)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = (q.float() * (1.0 / d ** 0.5)).reshape(b, hkv, g, s, d)
    logits = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.matmul(p, v.float()[:, :, None])
    out = out / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    return out.reshape(b, hq, s, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    """The quadratic oracle (the port of ``repro/kernels/ref.py::attention``):
    q: (B, Hq, S, D); k/v: (B, Hkv, S, D) with Hq a multiple of Hkv."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / d ** 0.5
    qg = q.reshape(b, hkv, g, s, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)
