"""Segmented combines: hand-written CUDA kernels 2 and 3, their wrappers,
and their plain PyTorch versions.

They replace the reference's Pallas kernels

* ``repro/kernels/spmv.py::edge_block_sum`` / ``_kernel`` (kernel 3, the
  segmented sum) — :func:`edge_block_sum`;
* ``repro/kernels/block_sweep.py::_edge_block_select`` / ``_seg_kernel``
  (kernel 2, ``edge_block_min``/``edge_block_max``) — :func:`edge_block_min`,
  :func:`edge_block_max`;

which the reference reaches through ``engine._combine_local(use_pallas=True)``
from ``make_block_processor``, the distributed engine's per-block update:
``out[d]`` combines the messages of the slots with ``dst == d`` into
``block_size`` slots (0 or the identity where there are none).

The kernel is ``repro_torch/csrc/segment_combine.cu``; its source note gives
the design (a warp per 512-slot tile folds runs of equal destinations, then a
warp per destination folds its run partials) and the order of the sum,
which the plain versions here define: 512-slot tiles; in a tile, each
maximal run of consecutive slots with equal ``dst`` folded left to right;
each destination's run partials added in (tile, run) order to an
accumulator that starts at 0. Min and max are exact in any order.

The kernel's second launch walks per-destination lists of run heads, which
depend on ``dst`` alone: :func:`segment_layout` builds them once for a
storage group's (B, E) destination rows (or for a prefix of each row), with
a scratch sized to one row, and the wrappers take the layout and the row.
A call on a CUDA tensor needs one.

The wrappers launch the kernel for tensors on a CUDA device and run their
plain version for tensors on the CPU; there is no other path. Each wrapper's
``launches`` counts its kernel launch pairs.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

TILE = 512  # csrc/segment_combine.cu: slots per tile
RUN_WARPS = 4  # csrc/segment_combine.cu: tiles per thread block of launch 1
RUN_CTAS_PER_SM = 14  # launch-1 blocks resident per SM (16 KB shared each)
FOLD_STEPS = 64  # plain fold: longer chains go through numpy one by one
OPS = {"sum": 0, "min": 1, "max": 2}  # csrc/segment_combine.cu op codes


@dataclasses.dataclass
class SegmentLayout:
    """The kernel's head lists for a storage group's destination rows, and
    its scratch. Row r's destination d has its run heads (slots within the
    row) at ``heads[hptr[r * C + d]:hptr[r * C + d + 1]]``, in slot order,
    which is (tile, run) order. The lists cover the first ``lengths[r]``
    slots of row r, and a call on row r takes exactly that prefix."""

    dst: torch.Tensor  # (B, E) int32: the rows the lists were built for
    lengths: np.ndarray  # (B,) slots of each row the lists cover
    block_size: int
    heads: torch.Tensor  # (H,) int32
    hptr: torch.Tensor  # (B * C + 1,) int64
    part: torch.Tensor  # (E,) f32 scratch: one row's run partials
    run_grid_cap: int  # launch-1 thread blocks that fill the card once


def run_heads(dst: torch.Tensor) -> torch.Tensor:
    """(E,) bool: the slots that start a run, i.e. start a 512-slot tile or
    differ in ``dst`` from the slot before."""
    head = torch.ones(dst.numel(), dtype=torch.bool, device=dst.device)
    head[1:] = dst[1:] != dst[:-1]
    head[::TILE] = True
    return head


def segment_layout(dst: torch.Tensor, block_size: int,
                   lengths=None) -> SegmentLayout:
    """The head lists of every row of ``dst`` ((B, E) or one (E,) row,
    int32, values in [0, block_size)), on its device; of the first
    ``lengths[r]`` slots of row r where ``lengths`` is given."""
    rows = dst.view(1, -1) if dst.dim() == 1 else dst
    dev, c = rows.device, block_size
    lengths = (np.full(rows.shape[0], rows.shape[1], dtype=np.int64)
               if lengths is None else np.asarray(lengths, dtype=np.int64))
    if rows.numel() and not (0 <= int(rows.min()) and int(rows.max()) < c):
        raise ValueError(f"segment_layout: dst must lie in [0, {c})")
    heads, counts = [], []
    for row, e in zip(rows, lengths.tolist()):
        row = row[:e]
        slots = torch.nonzero(run_heads(row)).view(-1)
        key, perm = torch.sort(row[slots].long(), stable=True)
        heads.append(slots[perm].to(torch.int32))
        counts.append(torch.bincount(key, minlength=c))
    total = torch.cat(counts) if counts else torch.zeros(0, dtype=torch.int64,
                                                         device=dev)
    hptr = torch.zeros(total.numel() + 1, dtype=torch.int64, device=dev)
    hptr[1:] = torch.cumsum(total, 0)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 1)
    return SegmentLayout(
        dst=rows, lengths=lengths, block_size=c,
        heads=torch.cat(heads) if heads else torch.zeros(
            0, dtype=torch.int32, device=dev),
        hptr=hptr,
        part=torch.empty(rows.shape[1], dtype=torch.float32, device=dev),
        run_grid_cap=RUN_CTAS_PER_SM * sms)


# -- wrappers ------------------------------------------------------------------
def edge_block_sum(msg: torch.Tensor, dst: torch.Tensor, block_size: int, *,
                   layout: SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """Segment-sum of ``msg`` (E,) f32 into ``block_size`` slots addressed
    by ``dst`` (E,) int32 (kernel 3). ``layout`` holds the head lists of the
    rows ``dst`` is row ``row`` of (required on a CUDA device)."""
    if msg.device.type == "cpu":
        return edge_block_sum_ref(msg, dst, block_size)
    out = _launch(msg, dst, block_size, "sum", 0.0, layout, row)
    edge_block_sum.launches += 1
    return out


edge_block_sum.launches = 0


def edge_block_min(msg: torch.Tensor, dst: torch.Tensor, block_size: int,
                   identity: float, *, layout: SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """Segment-min into ``block_size`` slots (empty slots keep
    ``identity``; kernel 2)."""
    if msg.device.type == "cpu":
        return edge_block_min_ref(msg, dst, block_size, identity)
    out = _launch(msg, dst, block_size, "min", identity, layout, row)
    edge_block_min.launches += 1
    return out


edge_block_min.launches = 0


def edge_block_max(msg: torch.Tensor, dst: torch.Tensor, block_size: int,
                   identity: float, *, layout: SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """Segment-max into ``block_size`` slots (empty slots keep
    ``identity``; kernel 2)."""
    if msg.device.type == "cpu":
        return edge_block_max_ref(msg, dst, block_size, identity)
    out = _launch(msg, dst, block_size, "max", identity, layout, row)
    edge_block_max.launches += 1
    return out


edge_block_max.launches = 0


def _launch(msg, dst, c, op, init, layout, row) -> torch.Tensor:
    if layout is None:
        raise ValueError("segment_combine: a CUDA call needs the head lists "
                         "of its rows (segment_layout)")
    row = int(row)
    _check_cuda(msg, dst, c, layout, row)
    lib = _lib()
    e = msg.numel()
    out = torch.empty(c, dtype=torch.float32, device=msg.device)
    ntiles = -(-e // TILE)
    grid = max(1, min(-(-ntiles // RUN_WARPS), layout.run_grid_cap))
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    err = lib.segment_combine_launch(
        msg.data_ptr(), dst.data_ptr(), e, c, layout.heads.data_ptr(),
        layout.hptr.data_ptr() + row * c * 8, layout.part.data_ptr(),
        out.data_ptr(), OPS[op], float(np.float32(init)), grid, stream)
    if err:
        raise RuntimeError("segment_combine launch failed: "
                           + lib.segment_combine_error_string(err).decode())
    return out


def load_library() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_combine")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.segment_combine_launch.argtypes = [
            p, p, ctypes.c_longlong, i, p, p, p, p, i, f, i, p]
        lib.segment_combine_launch.restype = i
        lib.segment_combine_error_string.argtypes = [i]
        lib.segment_combine_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda(msg, dst, c, layout, row) -> None:
    dev = layout.dst.device
    for t, dtype in ((msg, torch.float32), (dst, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError(f"segment_combine: expected a contiguous (E,) "
                             f"{dtype} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if msg.numel() != dst.numel():
        raise ValueError("segment_combine: msg and dst differ in length")
    if layout.block_size != c or not 0 <= row < layout.dst.shape[0]:
        raise ValueError("segment_combine: layout built for another block "
                         "size, or no such row")
    if dst.data_ptr() != layout.dst[row].data_ptr() \
            or dst.numel() != layout.lengths[row]:
        raise ValueError("segment_combine: dst is not the layout's row")
    if layout.part.numel() < msg.numel():
        raise ValueError("segment_combine: scratch shorter than the row")


# -- plain versions ------------------------------------------------------------
_FOLD = {"sum": (torch.add, np.add), "min": (torch.minimum, np.minimum),
         "max": (torch.maximum, np.maximum)}


def _seq_fold(vals: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
              op: str, init: float | None, max_steps: int) -> torch.Tensor:
    """Each segment ``vals[starts[i]:starts[i] + lens[i]]`` (lens >= 1)
    folded left to right in f32, one sequential chain per segment: from
    ``init``, or from its first element when ``init`` is None. Step k folds
    the k-th element of every segment longer than k (segments sorted by
    length, so those are a prefix); the few segments longer than
    ``max_steps`` go through numpy's accumulate, which is sequential in f32."""
    fold, np_fold = _FOLD[op]
    out = torch.empty(starts.numel(), dtype=vals.dtype, device=vals.device)
    short = torch.nonzero(lens <= max_steps).view(-1)
    if short.numel():
        ls, order = torch.sort(lens[short], descending=True, stable=True)
        idx, s = short[order], starts[short[order]]
        if init is None:
            acc, k0 = vals[s].clone(), 1
        else:
            acc = torch.full(s.shape, init, dtype=vals.dtype,
                             device=vals.device)
            k0 = 0
        ks = torch.arange(k0, int(ls[0]), device=vals.device)
        for k, cnt in zip(ks.tolist(),
                          torch.searchsorted(-ls, -ks).tolist()):
            acc[:cnt] = fold(acc[:cnt], vals[s[:cnt] + k])
        out[idx] = acc
    long_ = torch.nonzero(lens > max_steps).view(-1)
    if long_.numel():
        host = vals.cpu().numpy()
        pre = np.float32([] if init is None else [init])
        got = [np_fold.accumulate(np.concatenate([pre, host[s:s + n]]))[-1]
               for s, n in zip(starts[long_].tolist(), lens[long_].tolist())]
        out[long_] = torch.tensor(got, dtype=vals.dtype, device=vals.device)
    return out


def _segment_ref(msg, dst, block_size, op, init) -> torch.Tensor:
    out = torch.full((block_size,), float(np.float32(init)),
                     dtype=torch.float32, device=msg.device)
    e = msg.numel()
    if e == 0:
        return out
    msg = msg.to(torch.float32)
    starts = torch.nonzero(run_heads(dst)).view(-1)
    lens = torch.diff(starts, append=starts.new_tensor([e]))
    part = _seq_fold(msg, starts, lens, op, None, TILE)  # run partials
    # each destination's partials in (tile, run) order, from init
    key, perm = torch.sort(dst[starts].long(), stable=True)
    dests, cnt = torch.unique_consecutive(key, return_counts=True)
    first = torch.cumsum(cnt, 0) - cnt
    out[dests] = _seq_fold(part[perm], first, cnt, op,
                           float(np.float32(init)), FOLD_STEPS)
    return out


def edge_block_sum_ref(msg: torch.Tensor, dst: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """Plain version of :func:`edge_block_sum`, in the kernel's order."""
    return _segment_ref(msg, dst, block_size, "sum", 0.0)


def edge_block_min_ref(msg: torch.Tensor, dst: torch.Tensor,
                       block_size: int, identity: float) -> torch.Tensor:
    """Plain version of :func:`edge_block_min`."""
    return _segment_ref(msg, dst, block_size, "min", identity)


def edge_block_max_ref(msg: torch.Tensor, dst: torch.Tensor,
                       block_size: int, identity: float) -> torch.Tensor:
    """Plain version of :func:`edge_block_max`."""
    return _segment_ref(msg, dst, block_size, "max", identity)
