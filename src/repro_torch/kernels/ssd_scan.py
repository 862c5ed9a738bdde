"""The Mamba2 SSD intra-chunk term: hand-written CUDA kernel 5, its wrapper
and its plain PyTorch version.

The kernel replaces the reference's Pallas kernel
``repro/kernels/ssd_scan.py::ssd_intra_chunk`` / ``_kernel``:

    y[q] = sum_{s <= q} (c_q . b_s) * exp(l_q - l_s) * u[s]

per cell, for c, b (G, Q, N), u (G, Q, P) and ld (G, Q) the inclusive
cumulative log-decay, the math in f32 and y (G, Q, P) in u's dtype. No
reference model calls it (the reference's ``ssd_chunked`` computes the
term by einsum); the port's ``repro_torch.models.ssm.ssd_chunked`` routes
its own intra-chunk term through it under ``use_kernel``, in the heads
form below. The kernel is ``repro_torch/csrc/ssd_scan.cu``; its source note
gives the design and what bounds it: a thread block per (cell, 64-row
query tile, group of :func:`head_group` heads) forms the Gram c_q . b_s
once for its heads, then multiplies each head's decayed tile by u, both
products in 3xTF32 on the tensor cores (each f32 operand split into two
TF32 values, three products summed in f32), u's next tile copied in while
the current one is multiplied. It reads and writes f32: bf16 inputs are
widened (exactly) and the result rounded to u's dtype here. It takes N a
multiple of 4 up to 256, P in (16, 32, 64, 128) and any Q; another N or P
raises.

Two forms, one function:
* ``ssd_intra_chunk(c, b, u, ld)`` with u (G, Q, P), ld (G, Q): the
  reference's signature.
* the heads form, u (G, Q, H, P) and ld (G, Q, H) with c and b (G, Q, N)
  shared by the H heads (one B/C group, ``repro/models/ssm.py``): returns
  (G, Q, H, P). The kernel reads c and b once per (cell, head group), and
  u and ld as they lie in the model's (batch * chunks, Q, H, .) layout: no
  copy per head.

:func:`ssd_intra_chunk` launches the kernel for tensors on a CUDA device and
runs :func:`ssd_intra_chunk_ref`, the same function in plain torch, for
tensors on the CPU; there is no other path. ``ssd_intra_chunk.launches``
counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)  # P: the kernel's instantiations
MAX_STATE = 256  # N: a multiple of 4 up to this
DTYPES = (torch.float32, torch.bfloat16)


def head_group(heads: int, n: int, p: int) -> int:
    """Heads per thread block, each block forming one Gram for them. The
    Gram of a 64-key tile costs roundup(N, 32) / P of one head's product
    (the kernel pads N to whole 32-column chunks), so a group of at least 8
    roundup(N, 32) / P heads (and 4) keeps it under ~1/8 of the block's
    products; the groups are then made even. 16 at mamba2_2p7b's (H, N, P)
    = (80, 128, 64), 4 at hymba_1p5b's (25, 16, 64)."""
    target = max(4, -(-8 * (-(-n // 32) * 32) // p))
    groups = -(-heads // target)
    return -(-heads // groups)


def ssd_intra_chunk(c: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                    ld: torch.Tensor) -> torch.Tensor:
    """c, b: (G, Q, N); u: (G, Q, P) and ld: (G, Q), or the heads form
    u: (G, Q, H, P) and ld: (G, Q, H). Returns u's shape in u's dtype."""
    heads = _check_shapes(c, b, u, ld)
    if u.device.type == "cpu":
        return ssd_intra_chunk_ref(c, b, u, ld)
    if not heads:
        return ssd_intra_chunk(c, b, u[:, :, None], ld[:, :, None])[:, :, 0]
    _check_cuda(c, b, u, ld)
    g, q, h, p = u.shape
    n, out_dtype = c.shape[-1], u.dtype
    # the kernel reads f32 (a bf16 -> f32 cast is exact, and the math is
    # f32 anyway) with rows of c, b and u 16-byte aligned (cp.async)
    c, b, u = (_aligned(t.float()) for t in (c, b, u))
    ld = ld.float()
    out = torch.empty((g, q, h, p), dtype=torch.float32, device=u.device)
    strides = (c.stride(0), c.stride(1),
               b.stride(0), b.stride(1),
               u.stride(0), u.stride(2), u.stride(1),
               ld.stride(0), ld.stride(2), ld.stride(1),
               out.stride(0), out.stride(2), out.stride(1))
    lib = _lib()
    err = lib.ssd_intra_chunk_launch(
        c.data_ptr(), b.data_ptr(), u.data_ptr(), ld.data_ptr(),
        out.data_ptr(), g, h, head_group(h, n, p), q, n, p,
        (ctypes.c_longlong * 13)(*strides),
        torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError("ssd_intra_chunk launch failed: "
                           + lib.ssd_intra_chunk_error_string(err).decode())
    ssd_intra_chunk.launches += 1
    return out.to(out_dtype)


ssd_intra_chunk.launches = 0


def load_library() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_chunk_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), p]
        lib.ssd_intra_chunk_launch.restype = i
        lib.ssd_intra_chunk_error_string.argtypes = [i]
        lib.ssd_intra_chunk_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its last dimension is contiguous and every row starts
    16-byte aligned, else a contiguous copy (which is)."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            st % 4 == 0 for st in t.stride()[:-1]):
        return t
    return t.contiguous()


def _check_shapes(c, b, u, ld) -> bool:
    """Raises unless the shapes are one of the two forms; returns whether
    it is the heads form."""
    heads = u.dim() == 4
    g, q = u.shape[:2]
    lead = (g, q, u.shape[2]) if heads else (g, q)
    if c.dim() != 3 or c.shape[:2] != (g, q) or b.shape != c.shape \
            or u.dim() not in (3, 4) or tuple(ld.shape) != lead:
        raise ValueError(
            f"ssd_intra_chunk: needs c, b (G, Q, N) with u (G, Q, P) and ld "
            f"(G, Q), or u (G, Q, H, P) and ld (G, Q, H); got c "
            f"{tuple(c.shape)}, b {tuple(b.shape)}, u {tuple(u.shape)}, ld "
            f"{tuple(ld.shape)}")
    return heads


def _check_cuda(c, b, u, ld) -> None:
    n, p = c.shape[-1], u.shape[-1]
    if p not in HEAD_DIMS or n % 4 or not 4 <= n <= MAX_STATE:
        raise ValueError(f"ssd_intra_chunk: the kernel takes P in "
                         f"{HEAD_DIMS} and N a multiple of 4 up to "
                         f"{MAX_STATE}, got P={p}, N={n}")
    for name, t in (("c", c), ("b", b), ("u", u), ("ld", ld)):
        if t.device != u.device:
            raise ValueError(f"ssd_intra_chunk: {name} on {t.device}, u on "
                             f"{u.device}")
        if t.dtype not in DTYPES:
            raise ValueError(f"ssd_intra_chunk: the kernel takes f32 or "
                             f"bf16, got {name} {t.dtype}")


# -- plain version -------------------------------------------------------------
def ssd_intra_chunk_ref(c: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
                        ld: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ssd_intra_chunk`, both forms: the Gram
    matrix, the decay selected with ``where`` (never multiplied by a 0/1
    mask: above the diagonal exp(l_q - l_s) may be inf), then a matmul, all
    in f32; the result in u's dtype."""
    if u.dim() == 3:
        return ssd_intra_chunk_ref(c, b, u[:, :, None], ld[:, :, None])[
            :, :, 0]
    q = c.shape[1]
    gram = torch.matmul(c.float(), b.float().transpose(1, 2))  # (G, Q, S)
    lf = ld.float()
    ldiff = lf[:, :, None, :] - lf[:, None, :, :]  # (G, Q, S, H)
    tril = torch.ones(q, q, dtype=torch.bool, device=c.device).tril()
    decay = torch.where(tril[None, :, :, None], torch.exp(ldiff), 0.0)
    w = (gram[..., None] * decay).permute(0, 3, 1, 2)  # (G, H, Q, S)
    y = torch.matmul(w, u.float().permute(0, 2, 1, 3))  # (G, H, Q, P)
    return y.permute(0, 2, 1, 3).to(u.dtype)
