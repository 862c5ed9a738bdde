"""The fused block sweep: hand-written CUDA kernel, its wrapper, and its
plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/block_sweep.py::_sweep_kernel`` (single-lane, unmasked),
built by ``make_block_sweep``, together with the delta tail of
``repro/core/engine.py::make_tiled_processor.process_one``. The kernel is
``repro_torch/csrc/block_sweep.cu``; its source note gives the design: two
launches (a parallel pass over every tile of the slate, then an ordered
per-destination fold) so the hub block that a power-law graph puts first
never runs on one SM, and a fixed sum order that the plain version here
repeats bitwise. It is bound by bytes: ~21 B per edge slot (13 B tile row + 4 B value
gather + 4 B aux gather) plus 4 B per vertex written.

:func:`block_sweep` launches the kernel for tensors on a CUDA device and
runs :func:`block_sweep_ref` for tensors on the CPU; there is no other path.
``block_sweep.launches`` counts kernel launch pairs.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

TILE = 512  # csrc/block_sweep.cu: edge slots per tile row (partition.TILE)
MAX_SLOTS = 8192  # csrc/block_sweep.cu: slate size the tile pass can scan
MAX_BLOCK = 1024  # csrc/block_sweep.cu: one thread per block vertex
TILE_CTAS_PER_SM = 4  # 512-thread tile-pass blocks resident per SM


@dataclasses.dataclass
class SweepScratch:
    """Device buffers one engine's sweeps reuse, and the host numbers that
    size the tile pass's grid without reading the device. ``ed`` is the
    edge state the buffers were sized and checked for."""

    ed: tuple
    part: torch.Tensor  # (n_tiles * TILE,) f32: per-tile run partials
    old: torch.Tensor  # (block_size,) f32: a hot slot's pre-sweep values
    tiles_ub: np.ndarray  # [k-1] = most tiles any k-slot slate can hold
    tile_grid_cap: int  # tile-pass thread blocks that fill the card once


def make_scratch(ed, block_size: int) -> SweepScratch:
    """Scratch for sweeps over ``ed``'s tiles (an engine's EdgeData)."""
    dev = ed.src.device
    cnt = np.sort(ed.tile_cnt.cpu().numpy().astype(np.int64))[::-1]
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    scratch = SweepScratch(
        ed=ed,
        part=torch.empty(ed.src.numel(), dtype=torch.float32, device=dev),
        old=torch.empty(block_size, dtype=torch.float32, device=dev),
        tiles_ub=np.maximum(np.cumsum(cnt), 1),
        tile_grid_cap=TILE_CTAS_PER_SM * sms)
    if dev.type == "cuda":
        _check_edge_data(scratch, block_size)
    return scratch


def block_sweep(program, n_total: int, ed, values: torch.Tensor,
                rows: torch.Tensor, ok: torch.Tensor, psd: torch.Tensor,
                dmax: torch.Tensor, scratch: SweepScratch, *,
                block_size: int, n_live: int, first: bool = True,
                last: bool = True, out: torch.Tensor | None = None) -> None:
    """One sweep pass over the slate ``rows``/``ok`` (int32/bool, (W,)).

    Every ok slot's block reads the snapshot ``values`` and writes its new
    values into ``out`` (default: ``values`` itself — the in-place update
    that replaces the reference's buffer donation). ``first``/``last`` mark
    the first and last of a hot slot's Gauss-Seidel passes (a one-slot
    slate): the first saves the block's values, the last writes ``psd`` and
    ``dmax`` at the block's row against them. A one-pass sweep is both.
    Nothing is read back to the host.
    """
    if values.device.type == "cpu":
        return block_sweep_ref(program, n_total, ed, values, rows, ok, psd,
                               dmax, scratch, block_size=block_size,
                               n_live=n_live, first=first, last=last,
                               out=out)
    out = values if out is None else out
    nslots = rows.numel()
    _check_cuda(ed, values, rows, ok, psd, dmax, scratch, out, block_size,
                nslots, first, last)
    lib = _lib()
    d, cst = program.kernel_consts(n_total)
    ub = int(scratch.tiles_ub[min(nslots, scratch.tiles_ub.size) - 1])
    grid = max(1, min(ub, scratch.tile_grid_cap))
    fold_threads = max(32, 1 << (block_size - 1).bit_length())
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.block_sweep_launch(
        ed.src.data_ptr(), ed.dstl.data_ptr(), ed.w.data_ptr(),
        ed.valid.data_ptr(), values.data_ptr(), out.data_ptr(),
        ed.aux.data_ptr(), ed.tile_start.data_ptr(), ed.tile_cnt.data_ptr(),
        ed.vlo.data_ptr(), ed.vhi.data_ptr(), rows.data_ptr(), ok.data_ptr(),
        nslots, grid, fold_threads, block_size, n_live, program.kernel_id,
        float(program.identity), d, cst, int(first), int(last),
        scratch.part.data_ptr(), scratch.old.data_ptr(), psd.data_ptr(),
        dmax.data_ptr(), stream)
    if err:
        raise RuntimeError("block_sweep launch failed: "
                           + lib.block_sweep_error_string(err).decode())
    block_sweep.launches += 1


block_sweep.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_sweep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.block_sweep_launch.argtypes = (
            [p] * 13 + [i] * 6 + [f] * 3 + [i] * 2 + [p] * 5)
        lib.block_sweep_launch.restype = i
        lib.block_sweep_error_string.argtypes = [i]
        lib.block_sweep_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_tensors(pairs, dev) -> None:
    for t, dtype in pairs:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"block_sweep: expected a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def _check_edge_data(scratch, block_size) -> None:
    """Checks of the edge state, once per scratch (per engine)."""
    ed = scratch.ed
    _check_tensors([(scratch.part, torch.float32),
                    (scratch.old, torch.float32), (ed.src, torch.int32),
                    (ed.dstl, torch.int32), (ed.w, torch.float32),
                    (ed.valid, torch.bool), (ed.aux, torch.float32),
                    (ed.tile_start, torch.int32), (ed.tile_cnt, torch.int32),
                    (ed.vlo, torch.int32), (ed.vhi, torch.int32)],
                   ed.src.device)
    if ed.src.dim() != 2 or ed.src.shape[1] != TILE:
        raise ValueError(f"block_sweep: tiles must be (n_tiles, {TILE})")
    if not 1 <= block_size <= MAX_BLOCK:
        raise ValueError(f"block_sweep: block_size must be 1..{MAX_BLOCK}")
    if ed.vlo.numel() < ed.tile_cnt.numel() * block_size:
        raise ValueError("block_sweep: vertex slots must cover every block")


def _check_cuda(ed, values, rows, ok, psd, dmax, scratch, out, block_size,
                nslots, first, last) -> None:
    """Per-launch checks; the edge state was checked with its scratch."""
    if scratch.ed is not ed or scratch.old.numel() != block_size:
        raise ValueError("block_sweep: scratch built for other tiles")
    _check_tensors([(values, torch.float32), (out, torch.float32),
                    (rows, torch.int32), (ok, torch.bool),
                    (psd, torch.float32), (dmax, torch.float32)],
                   ed.src.device)
    nblocks = ed.tile_cnt.numel()
    if not 1 <= nslots <= MAX_SLOTS or ok.numel() != nslots:
        raise ValueError(f"block_sweep: 1..{MAX_SLOTS} slots with one ok "
                         f"flag each, got {nslots} and {ok.numel()}")
    if values.numel() != ed.vlo.numel() or out.numel() != values.numel():
        raise ValueError("block_sweep: values must cover every block")
    if psd.numel() != nblocks or dmax.numel() != nblocks:
        raise ValueError("block_sweep: psd/dmax need one entry per block")
    if not (first and last) and nslots != 1:
        raise ValueError("block_sweep: multi-pass sweeps take one slot")


# -- plain version -----------------------------------------------------------
def _tile_partials(program, msg, valid, dl, c):
    """(T, C) per-tile partials: the partial for destination d starts from
    the identity and combines d's messages in slot order, one
    ``full(identity).at[dstl].add(msg)`` per tile. ``index_add_`` on the CPU
    adds in index order, which is slot order, as the kernel's tile pass
    does; min/max are exact in any order. Slots that are not valid carry
    the identity."""
    n_t = msg.shape[0]
    ident = float(program.identity)
    msg = torch.where(valid, msg, ident).reshape(-1)
    idx = (torch.arange(n_t, device=msg.device)[:, None] * c + dl).reshape(-1)
    part = torch.full((n_t * c,), ident, device=msg.device)
    if program.combine == "sum":
        part.index_add_(0, idx, msg)
    else:
        part.scatter_reduce_(0, idx, msg, reduce="amin"
                             if program.combine == "min" else "amax")
    return part.view(n_t, c)


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a (C,) vector by the kernel's reduction tree: zero-pad to a
    power of two, then add the upper half onto the lower until one is left
    (adding a zero pad is exact, so any padded width gives this result)."""
    p2 = 1 << max(x.numel() - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, p2 - x.numel()))
    while x.numel() > 1:
        h = x.numel() // 2
        x = x[:h] + x[h:]
    return x[0]


def block_sweep_ref(program, n_total: int, ed, values: torch.Tensor,
                    rows: torch.Tensor, ok: torch.Tensor, psd: torch.Tensor,
                    dmax: torch.Tensor, scratch: SweepScratch, *,
                    block_size: int, n_live: int, first: bool = True,
                    last: bool = True, out: torch.Tensor | None = None
                    ) -> None:
    """Plain PyTorch version of :func:`block_sweep`, with the same
    signature and in-place effects; it repeats the kernel's arithmetic in
    the kernel's order. It reads its arguments back to the host freely:
    it serves CPU tensors, the tests and chip_smoke.py."""
    out = values if out is None else out
    c, dev = block_size, values.device
    slots = [int(r) for r, k in zip(rows.tolist(), ok.tolist()) if k]
    if not slots:
        return
    starts = ed.tile_start.tolist()
    cnts = ed.tile_cnt.tolist()
    tiles = torch.cat([torch.arange(starts[r], starts[r] + cnts[r])
                       for r in slots]).to(dev)
    src = ed.src[tiles].long()
    msg = program.edge_map(values[src], ed.aux[src], ed.w[tiles])
    part = _tile_partials(program, msg, ed.valid[tiles],
                          ed.dstl[tiles].long(), c)
    # agg combines each slot's partials in tile order: numpy's accumulate
    # is a sequential f32 loop along the tile axis (torch's CPU cumsum
    # accumulates in double), and min/max are exact in any order
    part = part.cpu().numpy()
    fold = {"sum": np.add, "min": np.minimum, "max": np.maximum}[
        program.combine]
    aggs, at = [], 0
    for r in slots:
        run = part[at:at + cnts[r]]
        at += cnts[r]
        aggs.append(fold.accumulate(run, axis=0)[-1] if cnts[r]
                    else np.full(c, program.identity, np.float32))
    aggs = torch.from_numpy(np.stack(aggs)).to(dev)
    news = []
    for agg, r in zip(aggs, slots):
        base = r * c
        old = values[base:base + c].clone()
        live = (base + torch.arange(c, device=dev)) < n_live
        new = torch.where(live, program.apply(old, agg, n_total), old)
        news.append((r, old, new, live))
    for r, old, new, live in news:  # every slot read the snapshot first
        if first and not last:
            scratch.old.copy_(old)
        out[r * c:(r + 1) * c] = new
        if last:
            old0 = old if first else scratch.old
            delta = torch.where(live, program.sd_delta(old0, new),
                                torch.zeros_like(new))
            cnt = torch.tensor(float(max(int(live.sum()), 1)), device=dev)
            psd.view(-1)[r] = pairwise_sum(delta) / cnt
            dmax.view(-1)[r] = delta.max()
