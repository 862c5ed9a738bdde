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

The order of the sum is defined by the plain versions here: 512-slot tiles;
in a tile, each maximal run of consecutive slots with equal ``dst`` folded
left to right; each destination's run partials added in (tile, run) order
to an accumulator that starts at 0. Min and max are exact in any order.

The kernel is ``repro_torch/csrc/segment_combine.cu``; its source note gives
the design. :func:`segment_layout` prepares, once for a storage group's
(B, E) destination rows (or for a prefix of each row), each row's table of
runs: their start slots and targets in slot order, the offsets of each
destination's runs, each tile's first run, and the destinations with no run
and with several. On a row sorted by destination (every row the distributed
engine builds: a contiguous CSC slice) the runs are each destination's slot
range cut at the multiples of 512. A short row (no destination of more than
:data:`LONG_PIECES` runs, at most :data:`CHAIN_MAX` of more than one) takes
one launch: a warp per tile folds its runs from shared memory, a run per
lane, and its last block chains the partials of the destinations of several
runs. A long row (a hub, or a row of many short runs) takes two: a lane per
run from global memory, then a warp per destination of several runs.

Each row's launch arguments are packed once into a C struct, so a call is
its checks against cached ints, one ``torch.empty`` and one ctypes call.
A call on a CUDA tensor needs the layout.

The wrappers launch the kernel for tensors on a CUDA device and run their
plain version for tensors on the CPU; there is no other path. Each wrapper's
``launches`` counts its calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

TILE = 512  # csrc/segment_combine.cu: slots per tile
# A short row takes one launch, whose last block chains each destination
# of several runs, a thread each: LONG_PIECES bounds such a chain and
# CHAIN_MAX their number (four rounds of the block's 128 threads), so that
# block stays a few microseconds; a row past either takes the long path's
# second launch, over the whole card. 4 is the smallest LONG_PIECES that
# keeps every row of the PageRank graph's storage at block 4096 but the hub
# row short (its cold rows have at most 3 runs per destination, its other
# hot rows at most 4; chip_smoke.py prints these counts).
LONG_PIECES = 4
CHAIN_MAX = 512
SHORT, LONG = 0, 1  # csrc/segment_combine.cu: a row's path
FOLD_STEPS = 64  # plain fold: longer chains go through numpy one by one
OPS = {"sum": 0, "min": 1, "max": 2}  # csrc/segment_combine.cu op codes


class _SegRow(ctypes.Structure):
    """csrc/segment_combine.cu ``SegRow``: one row's launch arguments."""
    _fields_ = [("pstart", ctypes.c_void_p), ("ptarget", ctypes.c_void_p),
                ("tpiece", ctypes.c_void_p), ("lptr", ctypes.c_void_p),
                ("empty", ctypes.c_void_p), ("chain", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("counter", ctypes.c_void_p),
                ("e", ctypes.c_longlong), ("path", ctypes.c_int),
                ("npieces", ctypes.c_int), ("nempty", ctypes.c_int),
                ("nchain", ctypes.c_int)]


@dataclasses.dataclass
class SegmentLayout:
    """What the kernel needs of a storage group's destination rows, built
    once; it covers the first ``lengths[r]`` slots of row r, and a call on
    row r takes exactly that prefix. Row r's runs (maximal stretches of
    equal ``dst`` inside a 512-slot tile, the plain version's runs) are
    counted per destination by ``lptr[r]``: destination d's j-th run in
    slot order is partial ``lptr[r, d] + j`` of the scratch. Its runs in
    slot order (``npieces[r]``: each one's first slot, then the row's
    length, in ``pstart``; each one's destination, or ``~partial`` where its
    destination has several, in ``ptarget``), each tile's first run (then
    ``npieces[r]``, in ``tpiece``), its destinations without a run and
    those of several follow the earlier rows' in those tables and in
    ``empty`` and ``chain``. ``path[r]`` is ``SHORT`` or ``LONG``."""

    dst: torch.Tensor  # (B, E) int32: the rows it was built for
    lengths: np.ndarray  # (B,) slots of each row it covers
    block_size: int
    path: np.ndarray  # (B,) SHORT or LONG
    lptr: torch.Tensor  # (B, C + 1) int32
    pstart: torch.Tensor  # int32, row after row (npieces + 1 each)
    ptarget: torch.Tensor  # int32, row after row (npieces each)
    tpiece: torch.Tensor  # int32, row after row (tiles + 1 each)
    empty: torch.Tensor  # int32, row after row
    chain: torch.Tensor  # int32, row after row
    npieces: np.ndarray  # (B,) runs of each row
    ntiles: np.ndarray  # (B,) tiles of each row
    nempty: np.ndarray  # (B,)
    nchain: np.ndarray  # (B,)
    part: torch.Tensor  # f32 scratch: one call's partials
    part_len: int
    counter: torch.Tensor  # (1,) int32: a short call's blocks done
    device: torch.device
    args: ctypes.Array  # (B,) _SegRow, one per row
    # per row: (dst pointer, covered length, partials, _SegRow address)
    calls: list = dataclasses.field(default_factory=list)


def run_heads(dst: torch.Tensor) -> torch.Tensor:
    """(E,) bool: the slots that start a run, i.e. start a 512-slot tile or
    differ in ``dst`` from the slot before."""
    head = torch.ones(dst.numel(), dtype=torch.bool, device=dst.device)
    head[1:] = dst[1:] != dst[:-1]
    head[::TILE] = True
    return head


def run_tables(row: torch.Tensor, c: int):
    """A row's tables from its ``dst`` (E,) over ``c`` destinations, on its
    device, int64: ``cnt`` (C,), the runs of each destination; ``lptr``
    (C + 1,), their offsets; ``pstart`` (P + 1,), each run's first slot in
    slot order, then E; ``ptarget`` (P,), each run's destination, or
    ``~(lptr[d] + j)`` for the j-th run of a destination d of several;
    ``tpiece`` (T + 1,), each tile's first run, then P; the destinations
    without a run; and those of several."""
    e, dev = row.numel(), row.device
    heads = torch.nonzero(run_heads(row)).view(-1)
    d = row[heads].long()
    cnt = torch.bincount(d, minlength=c)
    lptr = torch.zeros(c + 1, dtype=torch.int64, device=dev)
    lptr[1:] = torch.cumsum(cnt, 0)
    # a run's rank by (destination, slot) is lptr[d] + j
    rank = torch.empty_like(heads)
    rank[torch.sort(d, stable=True).indices] = torch.arange(
        heads.numel(), device=dev)
    pstart = torch.cat([heads, torch.full((1,), e, device=dev)])
    tpiece = torch.cat([
        torch.searchsorted(pstart, torch.arange(0, e, TILE, device=dev)),
        torch.full((1,), heads.numel(), device=dev)])
    return (cnt, lptr, pstart, torch.where(cnt[d] == 1, d, ~rank), tpiece,
            torch.nonzero(cnt == 0).view(-1), torch.nonzero(cnt > 1).view(-1))


def segment_layout(dst: torch.Tensor, block_size: int,
                   lengths=None) -> SegmentLayout:
    """The kernel's layout of every row of ``dst`` ((B, E) or one (E,) row,
    int32, values in [0, block_size)), on its device; of the first
    ``lengths[r]`` slots of row r where ``lengths`` is given."""
    rows = dst.view(1, -1) if dst.dim() == 1 else dst
    dev, c = rows.device, block_size
    lengths = (np.full(rows.shape[0], rows.shape[1], dtype=np.int64)
               if lengths is None else np.asarray(lengths, dtype=np.int64))
    if rows.numel() and not (0 <= int(rows.min()) and int(rows.max()) < c):
        raise ValueError(f"segment_layout: dst must lie in [0, {c})")
    if rows.shape[1] >= 2 ** 31:
        raise ValueError("segment_layout: rows of 2^31 slots or more")
    nrows = rows.shape[0]
    path = np.full(nrows, SHORT, dtype=np.int64)
    npieces, ntiles, nempty, nchain = (np.zeros(nrows, dtype=np.int64)
                                       for _ in range(4))
    lptr = torch.zeros(nrows, c + 1, dtype=torch.int32, device=dev)
    tables = {f: [] for f in ("pstart", "ptarget", "tpiece", "empty",
                              "chain")}
    for r, (row, e) in enumerate(zip(rows, lengths.tolist())):
        cnt, lptr[r], *rest = run_tables(row[:e], c)
        for f, x in zip(tables, rest):
            tables[f].append(x)
        npieces[r], ntiles[r] = len(rest[1]), len(rest[2]) - 1
        nempty[r], nchain[r] = len(rest[3]), len(rest[4])
        if int(cnt.max()) > LONG_PIECES or nchain[r] > CHAIN_MAX:
            path[r] = LONG

    def cat32(parts):
        return (torch.cat(parts).to(torch.int32) if parts else
                torch.zeros(0, dtype=torch.int32, device=dev))

    scratch = max(1, int(npieces.max(initial=0)))
    layout = SegmentLayout(
        dst=rows, lengths=lengths, block_size=c, path=path, lptr=lptr,
        **{f: cat32(x) for f, x in tables.items()},
        npieces=npieces, ntiles=ntiles, nempty=nempty, nchain=nchain,
        part=torch.empty(scratch, dtype=torch.float32, device=dev),
        part_len=scratch,
        counter=torch.zeros(1, dtype=torch.int32, device=dev), device=dev,
        args=(_SegRow * nrows)())
    _pack_args(layout)
    return layout


def _pack_args(layout: SegmentLayout) -> None:
    """Each row's launch arguments into ``layout.args``, and the ints its
    calls are checked against into ``layout.calls``."""
    rows, c = layout.dst, layout.block_size
    # where each row's entries start: pstart and tpiece hold one more than
    # the runs and tiles of each row
    pbase, qbase, tbase, ebase, cbase = (
        np.concatenate([[0], np.cumsum(n)]) for n in (
            layout.npieces + 1, layout.npieces, layout.ntiles + 1,
            layout.nempty, layout.nchain))
    size = ctypes.sizeof(_SegRow)
    for r in range(rows.shape[0]):
        a = layout.args[r]
        a.pstart = layout.pstart.data_ptr() + int(pbase[r]) * 4
        a.ptarget = layout.ptarget.data_ptr() + int(qbase[r]) * 4
        a.tpiece = layout.tpiece.data_ptr() + int(tbase[r]) * 4
        a.lptr = layout.lptr.data_ptr() + r * (c + 1) * 4
        a.empty = layout.empty.data_ptr() + int(ebase[r]) * 4
        a.chain = layout.chain.data_ptr() + int(cbase[r]) * 4
        a.part = layout.part.data_ptr()
        a.counter = layout.counter.data_ptr()
        a.e = int(layout.lengths[r])
        a.path = int(layout.path[r])
        a.npieces = int(layout.npieces[r])
        a.nempty = int(layout.nempty[r])
        a.nchain = int(layout.nchain[r])
        layout.calls.append((rows.data_ptr() + r * rows.stride(0) * 4, a.e,
                             a.npieces,
                             ctypes.addressof(layout.args) + r * size))


# -- wrappers ------------------------------------------------------------------
def edge_block_sum(msg: torch.Tensor, dst: torch.Tensor, block_size: int, *,
                   layout: SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """Segment-sum of ``msg`` (E,) f32 into ``block_size`` slots addressed
    by ``dst`` (E,) int32 (kernel 3). ``layout`` is the layout of the rows
    ``dst`` is row ``row`` of (required on a CUDA device)."""
    if msg.is_cpu:
        return edge_block_sum_ref(msg, dst, block_size)
    out = _launch(msg, dst, block_size, OPS["sum"], 0.0, layout, row)
    edge_block_sum.launches += 1
    return out


edge_block_sum.launches = 0


def edge_block_min(msg: torch.Tensor, dst: torch.Tensor, block_size: int,
                   identity: float, *, layout: SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """Segment-min into ``block_size`` slots (empty slots keep
    ``identity``; kernel 2)."""
    if msg.is_cpu:
        return edge_block_min_ref(msg, dst, block_size, identity)
    out = _launch(msg, dst, block_size, OPS["min"], identity, layout,
                  row)
    edge_block_min.launches += 1
    return out


edge_block_min.launches = 0


def edge_block_max(msg: torch.Tensor, dst: torch.Tensor, block_size: int,
                   identity: float, *, layout: SegmentLayout | None = None,
                   row: int = 0) -> torch.Tensor:
    """Segment-max into ``block_size`` slots (empty slots keep
    ``identity``; kernel 2)."""
    if msg.is_cpu:
        return edge_block_max_ref(msg, dst, block_size, identity)
    out = _launch(msg, dst, block_size, OPS["max"], identity, layout,
                  row)
    edge_block_max.launches += 1
    return out


edge_block_max.launches = 0

_F32, _I32 = torch.float32, torch.int32


def _launch(msg, dst, c, op, init, layout, row) -> torch.Tensor:
    if layout is None:
        raise ValueError("segment_combine: a CUDA call needs the layout of "
                         "its rows (segment_layout)")
    dev = layout.device
    if (msg.dtype is not _F32 or dst.dtype is not _I32
            or msg.dim() != 1 or dst.dim() != 1 or not msg.is_contiguous()
            or not dst.is_contiguous() or msg.get_device() != dev.index
            or dst.get_device() != dev.index):
        raise ValueError(f"segment_combine: expected contiguous (E,) "
                         f"float32 msg and int32 dst on {dev}, got "
                         f"{msg.dtype} {tuple(msg.shape)} on {msg.device} "
                         f"and {dst.dtype} {tuple(dst.shape)} on "
                         f"{dst.device}")
    e = msg.numel()
    if e != dst.numel():
        raise ValueError("segment_combine: msg and dst differ in length")
    if layout.block_size != c or not 0 <= row < len(layout.calls):
        raise ValueError("segment_combine: layout built for another block "
                         "size, or no such row")
    dst_ptr, length, need, args = layout.calls[row]
    if dst.data_ptr() != dst_ptr or e != length:
        raise ValueError("segment_combine: dst is not the layout's row")
    if need > layout.part_len:
        raise ValueError("segment_combine: scratch shorter than the row's "
                         "partials")
    out = torch.empty(c, dtype=_F32, device=dev)
    err = _lib().segment_combine(
        args, msg.data_ptr(), out.data_ptr(), op, float(init),
        torch._C._cuda_getCurrentRawStream(dev.index))  # the current stream
    if err:
        raise RuntimeError("segment_combine launch failed: "
                           + _lib().segment_combine_error_string(err)
                           .decode())
    return out


def load_library() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_combine")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.segment_combine.argtypes = [p, p, p, i, f, p]
        lib.segment_combine.restype = i
        lib.segment_combine_error_string.argtypes = [i]
        lib.segment_combine_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


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
