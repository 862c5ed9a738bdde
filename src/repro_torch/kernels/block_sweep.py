"""The fused block sweep: hand-written CUDA kernel, its wrappers, and its
plain PyTorch version.

Replaces the reference's Pallas kernel
``repro/kernels/block_sweep.py::_sweep_kernel`` (single-lane), built by
``make_block_sweep``, together with the delta tail of
``repro/core/engine.py::make_tiled_processor.process_one``, in both of its
single-lane forms:

* :func:`block_sweep` — kernel 1, the unmasked sweep (``subblocks = 1``);
* :func:`masked_block_sweep` — kernel 1m, the sub-block-masked sweep
  (``subblocks = S > 1``): each slot derives its block's ``sub_act`` mask
  from its PSD row on the device, skips tiles whose coverage is all
  masked, writes only live, active vertices and per-sub-block deltas.

and, for query serving, in its lane forms (``_sweep_kernel(lanes=True)``
with the delta tail of ``make_lane_processor.process_one``): values,
``vconst``, psd and dmax carry a trailing axis of L lanes, and one pass over
a block's tiles advances every lane:

* :func:`lane_block_sweep` — kernel 1l, unmasked;
* :func:`masked_lane_block_sweep` — kernel 1lm: one mask per slot, shared
  by the lanes, derived on the device from the lanes not done.

The kernel is ``repro_torch/csrc/block_sweep.cu``; its source note gives
the design: kernels 1 and 1m are one launch per call (a warp per tile over
the whole card, then the fold of each slot behind a completion counter, or
behind a grid barrier for a slate of several slots), so the hub block that
a power-law graph puts first never runs on one SM, in a fixed sum order
that the plain version here repeats bitwise on any tile layout. It is
bound by bytes: ~21 B per edge slot (13 B tile row + 4 B value gather + 4 B
aux gather) plus 4 B per vertex written.

The kernel finds each destination's messages through a run table that
:func:`fold_metadata` derives from the tiles: each tile's valid slots in
run order (sorted by destination, then slot), each run's first position and
partial, and each vertex's partials, contiguous in tile order. The
streaming commit path refreshes it for the blocks it touches
(:func:`refresh_fold_metadata`), so appends at a watermark, holes left by
kills and runs rebuilt in any order are all swept in the order the plain
version defines.

The lane kernels have the same shape (one launch per call; the fold
behind the counter or the grid barrier): a warp per tile gathers the value
rows coalesced in chunks of :func:`lane_shape`'s positions, carrying each
run's partial across a chunk's end, and the fold runs the lanes of a
destination side by side. The wrappers launch the kernel for tensors on a
CUDA device and run their plain version (:func:`block_sweep_ref`,
:func:`lane_block_sweep_ref`) for tensors on the CPU; there is no other
path. Each wrapper's ``launches`` counts its calls, each one launch of the
kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.analysis.contracts import one_executable_per
from repro_torch.kernels import _build

TILE = 512  # csrc/block_sweep.cu: edge slots per tile row (partition.TILE)
MAX_SLOTS = 8192  # csrc/block_sweep.cu: slate size the kernels can scan
MAX_BLOCK = 1024  # csrc/block_sweep.cu: vertices per block
MAX_LANES = 32  # csrc/block_sweep.cu: lanes of one lane sweep
MAX_SUB = 32  # csrc/block_sweep.cu: sub-ranges a masked sweep tests at once
SWEEP_WARPS = 8  # csrc/block_sweep.cu: warps (tiles in flight) per block
LANE_WARPS = 8  # csrc/block_sweep.cu: the same for the lane kernel
LONG_SPAN = 64  # csrc/block_sweep.cu: longer partial chains fold on a warp
LANE_MSG = 1152  # csrc/block_sweep.cu: floats of a lane warp's chunk buffer
LANE_GATHER = 8  # csrc/block_sweep.cu: value-row loads a lane thread issues
LONG_FLOATS = 1024  # csrc/block_sweep.cu: a lane warp's long-chain stage
LANE_TREES = LANE_WARPS * (2 * TILE + LANE_MSG + 2 * MAX_LANES
                            - LONG_FLOATS)  # the floats left to the trees
TINFO_RUNS = 10  # csrc/block_sweep.cu: tinfo = nv | nr << TINFO_RUNS ...
TINFO_COUNT = 0x3FF
TINFO_SORTED = 0x100000  # ... | TINFO_SORTED where run order is slot order


class _SweepTiles(ctypes.Structure):
    """csrc/block_sweep.cu ``SweepTiles``: one edge state's pointers and
    scratch, packed once with the scratch."""
    _fields_ = [("src", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("aux", ctypes.c_void_p), ("rslot", ctypes.c_void_p),
                ("tinfo", ctypes.c_void_p), ("runs", ctypes.c_void_p),
                ("pspan", ctypes.c_void_p), ("tile_start", ctypes.c_void_p),
                ("tile_cnt", ctypes.c_void_p), ("cov", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("oldbuf", ctypes.c_void_p),
                ("sync", ctypes.c_void_p), ("c", ctypes.c_int),
                ("ncov", ctypes.c_int)]


def _pack(ed, c, part, old, sync) -> _SweepTiles:
    """The packed pointers of ``ed`` and a scratch's buffers (the lane
    kernels take aux per call)."""
    return _SweepTiles(*(t.data_ptr() for t in (
        ed.src, ed.w, ed.aux, ed.rslot, ed.tinfo, ed.runs, ed.pspan,
        ed.tile_start, ed.tile_cnt, ed.cov, part, old, sync)), c,
        int(ed.cov.shape[1]))


@dataclasses.dataclass
class SweepScratch:
    """Device buffers one engine's sweeps reuse, the host numbers that size
    a call's grid without reading the device, and the edge state's packed
    pointers. ``ed`` is the edge state the buffers were sized and checked
    for."""

    ed: tuple
    part: torch.Tensor  # (n_tiles * TILE,) f32: one partial per run
    old: torch.Tensor  # (block_size,) f32: a hot slot's pre-sweep values
    sync: torch.Tensor  # (2,) int32: blocks arrived, barrier epoch
    tiles_ub: np.ndarray  # [k-1] = most tiles any k-slot slate can hold
    block_size: int
    values_len: int
    nblocks: int
    args: _SweepTiles | None = None  # the packed pointers (CUDA only)


def _tiles_ub(ed) -> np.ndarray:
    """[k-1] = the most tiles any k-slot slate of ``ed``'s blocks holds."""
    cnt = np.sort(ed.tile_cnt.cpu().numpy().astype(np.int64))[::-1]
    return np.maximum(np.cumsum(cnt), 1)


def make_scratch(ed, block_size: int) -> SweepScratch:
    """Scratch for sweeps over ``ed``'s tiles (an engine's EdgeData)."""
    dev = ed.src.device
    scratch = SweepScratch(
        ed, torch.empty(ed.src.numel(), dtype=torch.float32, device=dev),
        torch.empty(block_size, dtype=torch.float32, device=dev),
        torch.zeros(2, dtype=torch.int32, device=dev), _tiles_ub(ed),
        block_size, ed.pspan.shape[0], ed.tile_cnt.numel())
    if dev.type == "cuda":
        _check_edge_data(ed, block_size, scratch.part, scratch.old)
        scratch.args = _pack(ed, block_size, scratch.part, scratch.old,
                             scratch.sync)
    return scratch


@dataclasses.dataclass
class LaneScratch:
    """Device buffers of the lane sweeps. They are keyed to the tile
    tensors they were checked for (every EdgeData field but ``aux``): the
    query service sweeps one epoch's tiles with each family's own aux, and
    a pinned epoch's preserved copy is other tensors. The key holds weak
    references, so a scratch kept for reuse does not keep a served epoch's
    tiles on the card."""

    tiles: tuple  # weakrefs to the EdgeData fields but aux, as checked
    lanes: int
    part: torch.Tensor  # (n_tiles * TILE * L,) f32: one partial per run
    old: torch.Tensor  # (block_size * L,) f32: a hot slot's pre-sweep values
    sync: torch.Tensor  # (4,) int32: blocks arrived, epoch, slots dealt and
    # blocks done (all but the epoch 0 between calls)
    mask: torch.Tensor  # (MAX_SLOTS,) int32: each slot's sub-range mask
    tiles_ub: np.ndarray
    shapes: dict  # nsub -> lane_shape(lanes, block_size, nsub), for the
    # unmasked form (1) and the tiles' coverage (ncov)
    args: _SweepTiles | None = None  # the tiles' packed pointers (CUDA only)


def _tile_fields(ed) -> tuple:
    return tuple(t for f, t in zip(ed._fields, ed) if f != "aux")


def _same_tiles(scratch: LaneScratch, ed) -> bool:
    """Whether ``scratch`` was checked for ``ed``'s tile tensors."""
    return all(r() is t for r, t in zip(scratch.tiles, _tile_fields(ed)))


@one_executable_per("tile geometry", "lanes")
def make_lane_scratch(ed, block_size: int, lanes: int,
                      reuse: LaneScratch | None = None) -> LaneScratch:
    """Scratch for lane sweeps over ``ed``'s tiles at ``lanes`` lanes.
    ``reuse`` comes back as it is when it was made for the same tile
    tensors and lane count (the lane engine keeps one per tile geometry:
    the port's counterpart of the reference's memoized sweep factory);
    otherwise its buffers are reused where their sizes fit and the new
    tiles are checked."""
    if reuse is not None and reuse.lanes == lanes and _same_tiles(reuse, ed):
        return reuse
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"lane sweeps take 1..{MAX_LANES} lanes")
    dev = ed.src.device

    def buf(name, n, dtype=torch.float32):
        old = getattr(reuse, name, None)
        if old is not None and old.numel() == n and old.device == dev:
            return old  # a reused sync is at zero: every call leaves it so
        new = torch.zeros if name == "sync" else torch.empty
        return new(n, dtype=dtype, device=dev)

    tiles = tuple(weakref.ref(t) for t in _tile_fields(ed))
    shapes = {nsub: lane_shape(lanes, block_size, nsub)
              for nsub in {1, int(ed.cov.shape[1])} if nsub >= 1}
    scratch = LaneScratch(tiles, lanes, buf("part", ed.src.numel() * lanes),
                          buf("old", block_size * lanes),
                          buf("sync", 4, torch.int32),
                          buf("mask", MAX_SLOTS, torch.int32), _tiles_ub(ed),
                          shapes)
    if dev.type == "cuda":
        _check_edge_data(ed, block_size, scratch.part, scratch.old)
        scratch.args = _pack(ed, block_size, scratch.part, scratch.old,
                             scratch.sync)
    return scratch


def lane_shape(lanes: int, block_size: int, nsub: int) -> tuple:
    """(vw, chunk, group) of a lane sweep: the floats per value-row load
    (4 where L is a multiple of 4, else 1); the tile positions a warp
    gathers and folds at once (the most, at most TILE, whose messages fit
    LANE_MSG floats at the odd stride L | 1 and whose rows one batch of
    LANE_GATHER loads a thread covers); and the lanes the
    fold takes at once: all L where shared memory holds their delta trees
    (two arrays of ``nsub`` zero-padded power-of-two sub-ranges per lane),
    else a multiple of vw (vw falls to 1 where not even vw lanes fit)."""
    vw = 4 if lanes % 4 == 0 else 1
    def chunk(vw):
        return min(TILE, LANE_MSG // (lanes | 1),
                   32 * LANE_GATHER // (lanes // vw))

    width = nsub * (1 << (block_size // nsub - 1).bit_length())
    fit = LANE_TREES // (2 * width)
    if lanes <= fit:
        return vw, chunk(vw), lanes
    if fit < vw:
        return 1, chunk(1), fit
    return vw, chunk(vw), fit // vw * vw


# -- fold metadata -------------------------------------------------------------
def fold_metadata(dstl: torch.Tensor, valid: torch.Tensor,
                  tile_start: torch.Tensor, tile_cnt: torch.Tensor,
                  block_size: int, values_len: int):
    """(rslot, tinfo, runs, pspan), the run table of every block of the
    tiles, on their device. A destination's RUN in a tile is its valid
    slots there, in slot order; RUN ORDER lists a tile's valid slots by
    (destination, slot), so each run is a stretch of it.

    * ``rslot`` (n_tiles, TILE) int16: position j < nv holds the local
      slot of the tile's j-th valid slot in run order (0 past nv).
    * ``tinfo`` (n_tiles,) int32: ``nv | nr << TINFO_RUNS``, or'ed with
      ``TINFO_SORTED`` where run order is slot order (``rslot[j] == j``).
    * ``runs`` (n_tiles * TILE, 2) int32: row ``r * TILE + k``, k < nr, is
      tile r's run k: its first position and the index of its partial.
    * ``pspan`` (values_len, 2) int32: vertex v's partials are
      ``[pspan[v, 0], pspan[v, 1])``, one per tile it has a run in, in tile
      order, packed per block inside the block's own slot range (a block
      has no more runs than valid slots)."""
    dev = dstl.device
    rslot = torch.zeros(dstl.shape, dtype=torch.int16, device=dev)
    tinfo = torch.zeros(dstl.shape[0], dtype=torch.int32, device=dev)
    runs = torch.zeros((dstl.numel(), 2), dtype=torch.int32, device=dev)
    pspan = torch.zeros((values_len, 2), dtype=torch.int32, device=dev)
    blocks = torch.arange(tile_cnt.numel(), device=dev)
    _run_table(dstl, valid, tile_start, tile_cnt, block_size, blocks, rslot,
               tinfo, runs, pspan)
    return rslot, tinfo, runs, pspan


def refresh_fold_metadata(ed, block_size: int, blocks) -> None:
    """Recompute ``ed``'s run table in place for the given blocks, after
    their tile rows changed (streaming commits)."""
    blocks = torch.as_tensor(np.asarray(blocks, dtype=np.int64)).to(
        ed.src.device)
    if blocks.numel():
        _run_table(ed.dstl, ed.valid, ed.tile_start, ed.tile_cnt, block_size,
                   blocks, ed.rslot, ed.tinfo, ed.runs, ed.pspan)


def _run_table(dstl, valid, tile_start, tile_cnt, c, blocks, rslot, tinfo,
               runs, pspan) -> None:
    dev = dstl.device
    ts = tile_start.long()[blocks]
    tc = tile_cnt.long()[blocks]
    nt = int(tc.sum())
    # the blocks' tile rows, block by block
    owner = torch.repeat_interleave(torch.arange(blocks.numel(), device=dev),
                                    tc)
    first_row = torch.cumsum(tc, 0) - tc
    rows = ts[owner] + torch.arange(nt, device=dev) - first_row[owner]
    if nt:  # the table is a function of the current tiles alone
        rslot[rows] = 0
        tinfo[rows] = 0
        runs.view(-1, TILE, 2)[rows] = 0
    slots = (rows[:, None] * TILE
             + torch.arange(TILE, device=dev)).reshape(-1)
    blk = blocks[owner].repeat_interleave(TILE)
    live = valid.reshape(-1)[slots]
    slots, blk = slots[live], blk[live]
    # run order: the valid slots sorted by (tile, destination, slot); the
    # slots ascend, so a stable sort by (tile, destination) keeps slot order
    tile = slots // TILE
    key, perm = torch.sort(tile * c + dstl.reshape(-1)[slots].long(),
                           stable=True)
    slots, blk, tile = slots[perm], blk[perm], tile[perm]
    n = slots.numel()
    pos = torch.arange(n, device=dev) - torch.searchsorted(tile, tile)
    local = slots % TILE
    rslot.view(-1)[tile * TILE + pos] = local.to(torch.int16)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = key[1:] != key[:-1]
    htile, hpos, hblk = tile[head], pos[head], blk[head]
    hdst = hblk * c + key[head] % c  # the runs' vertices
    hrank = torch.arange(htile.numel(), device=dev) \
        - torch.searchsorted(htile, htile)
    nrows = rslot.shape[0]
    nv = torch.bincount(tile, minlength=nrows)
    nr = torch.bincount(htile, minlength=nrows)
    unsorted = torch.bincount(tile, weights=(local != pos).to(torch.float32),
                              minlength=nrows)
    info = nv | (nr << TINFO_RUNS) | torch.where(unsorted > 0, 0,
                                                 TINFO_SORTED)
    tinfo[rows] = info[rows].to(torch.int32)
    # each vertex's partials in tile order: the runs sorted by vertex
    # (stable: tiles ascend), packed from its block's first slot
    vkey, vperm = torch.sort(hdst, stable=True)
    area = tile_start.long()[hblk[vperm]] * TILE
    part = area + torch.arange(vkey.numel(), device=dev) \
        - torch.searchsorted(vkey, hblk[vperm] * c)
    at = (htile * TILE + hrank)[vperm]
    runs[at] = torch.stack([hpos[vperm], part], dim=1).to(torch.int32)
    verts = (blocks[:, None] * c + torch.arange(c, device=dev)).reshape(-1)
    vblk = verts // c
    start = tile_start.long()[vblk] * TILE - torch.searchsorted(vkey,
                                                               vblk * c)
    pspan[verts] = torch.stack([
        start + torch.searchsorted(vkey, verts),
        start + torch.searchsorted(vkey, verts, right=True)],
        dim=1).to(torch.int32)


# -- wrappers ------------------------------------------------------------------
def block_sweep(program, n_total: int, ed, values: torch.Tensor,
                rows: torch.Tensor, ok: torch.Tensor, psd: torch.Tensor,
                dmax: torch.Tensor, scratch: SweepScratch, *,
                block_size: int, n_live: int, first: bool = True,
                last: bool = True, out: torch.Tensor | None = None) -> None:
    """One unmasked sweep pass (kernel 1) over the slate ``rows``/``ok``
    (int32/bool, (W,)).

    Every ok slot's block reads the snapshot ``values`` and writes its new
    values into ``out`` (default: ``values`` itself — the in-place update
    that replaces the reference's buffer donation). ``first``/``last`` mark
    the first and last of a hot slot's Gauss-Seidel passes (a one-slot
    slate): the first saves the block's values, the last writes ``psd`` and
    ``dmax`` ((P, 1)) at the block's row against them. A one-pass sweep is
    both. Nothing is read back to the host.
    """
    if values.device.type == "cpu":
        return block_sweep_ref(program, n_total, ed, values, rows, ok, psd,
                               dmax, scratch, block_size=block_size,
                               n_live=n_live, first=first, last=last,
                               out=out)
    _launch(program, n_total, ed, values, rows, ok, psd, dmax, scratch,
            block_size, n_live, first, last, out, None)
    block_sweep.launches += 1


block_sweep.launches = 0


def masked_block_sweep(program, n_total: int, ed, values: torch.Tensor,
                       rows: torch.Tensor, ok: torch.Tensor,
                       psd: torch.Tensor, dmax: torch.Tensor,
                       scratch: SweepScratch, *, block_size: int,
                       n_live: int, floor: float, first: bool = True,
                       last: bool = True) -> None:
    """One sub-block-masked sweep pass (kernel 1m), in place, over the
    slate ``rows``/``ok``; ``psd``/``dmax`` are (P, S) with S =
    ``ed.cov.shape[1]``.

    Each slot's mask is ``psd[row] >= floor`` as it stands when the slot
    starts: masked sub-ranges keep their values and their psd/dmax
    entries, tiles whose ``ed.cov`` row covers only masked sub-ranges are
    skipped, and the last pass writes per-sub-block mean and max deltas for
    the active ones. A hot slot's passes leave its psd row alone until the
    last one, so every pass derives the mask of the slot's entry.
    """
    if values.device.type == "cpu":
        return block_sweep_ref(program, n_total, ed, values, rows, ok, psd,
                               dmax, scratch, block_size=block_size,
                               n_live=n_live, floor=floor, first=first,
                               last=last)
    _launch(program, n_total, ed, values, rows, ok, psd, dmax, scratch,
            block_size, n_live, first, last, None, floor)
    masked_block_sweep.launches += 1


masked_block_sweep.launches = 0


def lane_block_sweep(program, n_total: int, ed, values: torch.Tensor,
                     vconst: torch.Tensor, rows: torch.Tensor,
                     ok: torch.Tensor, psd: torch.Tensor, dmax: torch.Tensor,
                     lane_done: torch.Tensor, scratch: LaneScratch, *,
                     block_size: int, n_live: int, first: bool = True,
                     last: bool = True) -> None:
    """One unmasked lane sweep pass (kernel 1l), in place, over the slate
    ``rows``/``ok`` for a :class:`~repro_torch.core.algorithms.LaneProgram`.

    ``values``/``vconst`` are (values_len, L) f32, ``psd``/``dmax`` (P, 1,
    L) or (P, L), ``lane_done`` (L,) bool (read by the masked form only).
    Every ok slot's block reads the snapshot ``values`` and writes its new
    values for all L lanes; ``first``/``last`` mark a hot slot's
    Gauss-Seidel passes as for :func:`block_sweep`, and the last pass writes
    per-lane mean and max deltas at ``psd[row]``/``dmax[row]``.
    """
    if values.device.type == "cpu":
        return lane_block_sweep_ref(
            program, n_total, ed, values, vconst, rows, ok, psd, dmax,
            lane_done, scratch, block_size=block_size, n_live=n_live,
            first=first, last=last)
    _lane_launch(program, n_total, ed, values, vconst, rows, ok, psd, dmax,
                 lane_done, scratch, block_size, n_live, first, last, None)
    lane_block_sweep.launches += 1


lane_block_sweep.launches = 0


def masked_lane_block_sweep(program, n_total: int, ed,
                            values: torch.Tensor, vconst: torch.Tensor,
                            rows: torch.Tensor, ok: torch.Tensor,
                            psd: torch.Tensor, dmax: torch.Tensor,
                            lane_done: torch.Tensor, scratch: LaneScratch, *,
                            block_size: int, n_live: int, floor: float,
                            first: bool = True, last: bool = True) -> None:
    """One sub-block-masked lane sweep pass (kernel 1lm), in place;
    ``psd``/``dmax`` are (P, S, L) with S = ``ed.cov.shape[1]``.

    Each slot's mask is one (S,) vector shared by the lanes: sub-range s is
    live when the max over the lanes not done of ``psd[row, s]`` is
    ``>= floor``, as it stands when the slot starts (the reference's
    ``lane_sub_psd_device``). Masked sub-ranges keep their values and their
    psd/dmax entries in every lane, as for :func:`masked_block_sweep`.
    """
    if values.device.type == "cpu":
        return lane_block_sweep_ref(
            program, n_total, ed, values, vconst, rows, ok, psd, dmax,
            lane_done, scratch, block_size=block_size, n_live=n_live,
            floor=floor, first=first, last=last)
    _lane_launch(program, n_total, ed, values, vconst, rows, ok, psd, dmax,
                 lane_done, scratch, block_size, n_live, first, last, floor)
    masked_lane_block_sweep.launches += 1


masked_lane_block_sweep.launches = 0


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _on(t, dtype, index) -> bool:
    """Whether ``t`` is a contiguous ``dtype`` tensor on CUDA device
    ``index``."""
    return t.dtype is dtype and t.is_contiguous() and t.get_device() == index


def _launch(program, n_total, ed, values, rows, ok, psd, dmax, scratch,
            block_size, n_live, first, last, out, floor) -> None:
    out = values if out is None else out
    masked = floor is not None
    nslots = rows.numel()
    if scratch.ed is not ed or scratch.block_size != block_size \
            or scratch.args is None:
        raise ValueError("block_sweep: scratch built for other tiles, or "
                         "for tiles off the card")
    nsub = scratch.args.ncov if masked else 1
    index = scratch.part.get_device()
    if not (_on(values, _F32, index) and _on(out, _F32, index)
            and _on(rows, _I32, index) and _on(ok, _BOOL, index)
            and _on(psd, _F32, index) and _on(dmax, _F32, index)):
        raise ValueError(f"block_sweep: expected contiguous float32 values, "
                         f"out, psd and dmax, int32 rows and bool ok on "
                         f"cuda:{index}")
    if not 1 <= nslots <= MAX_SLOTS or ok.numel() != nslots:
        raise ValueError(f"block_sweep: 1..{MAX_SLOTS} slots with one ok "
                         f"flag each, got {nslots} and {ok.numel()}")
    if values.numel() != scratch.values_len or out.numel() != values.numel():
        raise ValueError("block_sweep: values must cover every block")
    if psd.numel() != scratch.nblocks * nsub \
            or dmax.numel() != psd.numel():
        raise ValueError(f"block_sweep: psd/dmax need {nsub} entries per "
                         "block")
    if block_size % nsub or nsub > MAX_SUB:
        raise ValueError(f"block_sweep: sub-blocks must divide the block, "
                         f"at most {MAX_SUB}")
    if not (first and last) and nslots != 1:
        raise ValueError("block_sweep: multi-pass sweeps take one slot")
    d, cst = program.kernel_consts(n_total)
    ub = int(scratch.tiles_ub[min(nslots, scratch.tiles_ub.size) - 1])
    lib = _lib()
    err = lib.block_sweep_launch(
        ctypes.byref(scratch.args), values.data_ptr(), out.data_ptr(),
        rows.data_ptr(), ok.data_ptr(), psd.data_ptr(), dmax.data_ptr(),
        nslots, -(-ub // SWEEP_WARPS), n_live, program.kernel_id,
        int(masked), nsub, float(program.identity), d, cst,
        float(np.float32(floor)) if masked else 0.0, int(first), int(last),
        torch._C._cuda_getCurrentRawStream(index))  # the current stream
    if err:
        raise RuntimeError("block_sweep launch failed: "
                           + lib.block_sweep_error_string(err).decode())


def _lane_launch(program, n_total, ed, values, vconst, rows, ok, psd, dmax,
                 lane_done, scratch, block_size, n_live, first, last,
                 floor) -> None:
    masked = floor is not None
    nslots = rows.numel()
    lanes = int(values.shape[1]) if values.dim() == 2 else 0
    nsub = int(ed.cov.shape[1]) if masked else 1
    _check_lane_cuda(ed, values, vconst, rows, ok, psd, dmax, lane_done,
                     scratch, block_size, nslots, first, last, nsub, lanes)
    lib = _lib()
    d, cst = program.kernel_consts(n_total)
    ub = int(scratch.tiles_ub[min(nslots, scratch.tiles_ub.size) - 1])
    err = lib.lane_block_sweep_launch(
        ctypes.byref(scratch.args), values.data_ptr(), vconst.data_ptr(),
        ed.aux.data_ptr(), rows.data_ptr(), ok.data_ptr(),
        lane_done.data_ptr(), scratch.mask.data_ptr(), nslots,
        -(-ub // LANE_WARPS), lanes, *scratch.shapes[nsub],
        n_live, program.kernel_id, int(masked), nsub,
        float(program.identity), d, cst,
        float(np.float32(floor)) if masked else 0.0, int(first), int(last),
        psd.data_ptr(), dmax.data_ptr(),
        torch._C._cuda_getCurrentRawStream(values.get_device()))
    if err:
        raise RuntimeError("lane_block_sweep launch failed: "
                           + lib.block_sweep_error_string(err).decode())


def load_library() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_sweep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.block_sweep_launch.argtypes = (
            [p] * 7 + [i] * 6 + [f] * 4 + [i] * 2 + [p])
        lib.block_sweep_launch.restype = i
        lib.lane_block_sweep_launch.argtypes = (
            [p] * 8 + [i] * 10 + [f] * 4 + [i] * 2 + [p] * 3)
        lib.lane_block_sweep_launch.restype = i
        lib.block_sweep_error_string.argtypes = [i]
        lib.block_sweep_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_tensors(pairs, dev) -> None:
    for t, dtype in pairs:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"block_sweep: expected a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def _check_edge_data(ed, block_size, *bufs) -> None:
    """Checks of the edge state and of a scratch's buffers, once per
    scratch."""
    _check_tensors([(b, torch.float32) for b in bufs] + [
                    (ed.src, torch.int32), (ed.dstl, torch.int32),
                    (ed.w, torch.float32),
                    (ed.valid, torch.bool), (ed.cov, torch.bool),
                    (ed.aux, torch.float32), (ed.tile_start, torch.int32),
                    (ed.tile_cnt, torch.int32), (ed.rslot, torch.int16),
                    (ed.tinfo, torch.int32), (ed.runs, torch.int32),
                    (ed.pspan, torch.int32)], ed.src.device)
    if ed.src.dim() != 2 or ed.src.shape[1] != TILE:
        raise ValueError(f"block_sweep: tiles must be (n_tiles, {TILE})")
    if ed.src.numel() >= 2 ** 31:
        raise ValueError("block_sweep: tile slots must fit int32")
    if ed.rslot.shape != ed.src.shape \
            or ed.tinfo.shape != ed.src.shape[:1] \
            or ed.runs.shape != (ed.src.numel(), 2) \
            or ed.cov.dim() != 2 or ed.cov.shape[0] != ed.src.shape[0]:
        raise ValueError("block_sweep: run table or coverage shaped unlike "
                         "the tiles")
    if not 1 <= block_size <= MAX_BLOCK:
        raise ValueError(f"block_sweep: block_size must be 1..{MAX_BLOCK}")
    if ed.pspan.dim() != 2 or ed.pspan.shape[1] != 2 \
            or ed.pspan.shape[0] < ed.tile_cnt.numel() * block_size:
        raise ValueError("block_sweep: vertex partials must cover every "
                         "block")


def _check_lane_cuda(ed, values, vconst, rows, ok, psd, dmax, lane_done,
                     scratch, block_size, nslots, first, last, nsub,
                     lanes) -> None:
    """Per-launch checks of a lane sweep; the tiles were checked with the
    scratch, the aux that rides with them here."""
    if scratch.lanes != lanes or not _same_tiles(scratch, ed) \
            or scratch.old.numel() != block_size * lanes:
        raise ValueError("lane_block_sweep: scratch built for other tiles "
                         "or another lane count")
    dev = ed.src.device
    _check_tensors([(values, torch.float32), (vconst, torch.float32),
                    (ed.aux, torch.float32), (rows, torch.int32),
                    (ok, torch.bool), (psd, torch.float32),
                    (dmax, torch.float32), (lane_done, torch.bool)], dev)
    nblocks = ed.tile_cnt.numel()
    if values.dim() != 2 or values.shape != (ed.pspan.shape[0], lanes) \
            or vconst.shape != values.shape:
        raise ValueError("lane_block_sweep: values and vconst must be "
                         "(values_len, L) over every block")
    if lane_done.numel() != lanes:
        raise ValueError("lane_block_sweep: one lane_done flag per lane")
    if ed.aux.numel() > values.shape[0] or ed.aux.dim() != 1:
        raise ValueError("lane_block_sweep: aux must be (n,)")
    if not 1 <= nslots <= MAX_SLOTS or ok.numel() != nslots:
        raise ValueError(f"lane_block_sweep: 1..{MAX_SLOTS} slots with one "
                         f"ok flag each, got {nslots} and {ok.numel()}")
    if psd.numel() != nblocks * nsub * lanes \
            or dmax.numel() != psd.numel():
        raise ValueError(f"lane_block_sweep: psd/dmax need {nsub} x {lanes} "
                         "entries per block")
    if block_size % nsub or nsub > MAX_SUB:
        raise ValueError(f"lane_block_sweep: sub-blocks must divide the "
                         f"block, at most {MAX_SUB}")
    if not (first and last) and nslots != 1:
        raise ValueError("lane_block_sweep: multi-pass sweeps take one slot")


# -- plain version -----------------------------------------------------------
def _tile_partials(program, msg, valid, dl, c):
    """(T, C) per-tile partials of a (T, TILE) message, or (T, C, L) of a
    (T, TILE, L) one, lane by lane: the partial for destination d starts
    from the identity and combines d's messages in slot order, one
    ``full(identity).at[dstl].add(msg)`` per tile. ``index_add_`` on the CPU
    adds in index order, which is slot order, as the kernel's tile pass
    does whatever the layout; min/max are exact in any order. Slots that
    are not valid carry the identity."""
    n_t = msg.shape[0]
    ident = float(program.identity)
    lanes = msg.movedim(-1, 0).reshape(-1, n_t * TILE) if msg.dim() == 3 \
        else msg.reshape(1, -1)
    lanes = torch.where(valid.reshape(-1), lanes, ident)
    idx = (torch.arange(n_t, device=msg.device)[:, None] * c + dl).reshape(-1)
    part = torch.full((lanes.shape[0], n_t * c), ident, device=msg.device)
    for p, m in zip(part, lanes):
        if program.combine == "sum":
            p.index_add_(0, idx, m)
        else:
            p.scatter_reduce_(0, idx, m, reduce="amin"
                              if program.combine == "min" else "amax")
    if msg.dim() == 3:
        return part.view(-1, n_t, c).movedim(0, -1)
    return part.view(n_t, c)


def _fold_runs(program, part: np.ndarray, runs) -> list:
    """Each slot's aggregate: its run of per-tile partials (consecutive rows
    of ``part``, (T, C) or (T, C, L)) combined in tile order, one
    sequential f32 fold per destination and lane as the kernel's fold runs
    it (torch's CPU cumsum would accumulate in double); the identity for a
    slot without tiles. Min/max are exact in any order."""
    fold = {"sum": np.add, "min": np.minimum, "max": np.maximum}[
        program.combine]
    aggs, at = [], 0
    for t in runs:
        run = part[at:at + t.numel()]
        at += t.numel()
        if not len(run):
            aggs.append(np.full(part.shape[1:], program.identity, np.float32))
            continue
        agg = run[0].copy()
        for row in run[1:]:
            fold(agg, row, out=agg)
        aggs.append(agg)
    return aggs


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis of a (C,) or (C, L) tensor by the kernel's
    reduction tree: zero-pad to a power of two, then add the upper half onto
    the lower until one is left (adding a zero pad is exact, so any padded
    width gives this result)."""
    n = x.shape[0]
    p2 = 1 << max(n - 1, 0).bit_length()
    x = torch.cat([x, x.new_zeros((p2 - n,) + x.shape[1:])])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def block_sweep_ref(program, n_total: int, ed, values: torch.Tensor,
                    rows: torch.Tensor, ok: torch.Tensor, psd: torch.Tensor,
                    dmax: torch.Tensor, scratch: SweepScratch, *,
                    block_size: int, n_live: int,
                    floor: float | None = None, first: bool = True,
                    last: bool = True, out: torch.Tensor | None = None
                    ) -> None:
    """Plain PyTorch version of :func:`block_sweep` (``floor=None``) and of
    :func:`masked_block_sweep` (``floor`` given), with the same signatures
    and in-place effects; it repeats the kernel's arithmetic in the
    kernel's order on any tile layout. It reads its arguments back to the
    host freely: it serves CPU tensors, the tests and chip_smoke.py."""
    out = values if out is None else out
    c, dev = block_size, values.device
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    sub = c // nsub
    psd2, dmax2 = psd.view(-1, nsub), dmax.view(-1, nsub)
    slots = [int(r) for r, k in zip(rows.tolist(), ok.tolist()) if k]
    if not slots:
        return
    # each slot's mask, from its psd row as it stands at the slot's entry
    acts = [torch.ones(1, dtype=torch.bool, device=dev) if floor is None
            else psd2[r] >= float(np.float32(floor)) for r in slots]
    starts = ed.tile_start.tolist()
    cnts = ed.tile_cnt.tolist()
    runs = []
    for r, act in zip(slots, acts):
        t = torch.arange(starts[r], starts[r] + cnts[r], device=dev)
        if floor is not None:  # skip tiles that cover only masked ranges
            t = t[(ed.cov[t] & act).any(dim=1)]
        runs.append(t)
    tiles = torch.cat(runs)
    src = ed.src[tiles].long()
    msg = program.edge_map(values[src], ed.aux[src], ed.w[tiles])
    part = _tile_partials(program, msg, ed.valid[tiles],
                          ed.dstl[tiles].long(), c).cpu().numpy()
    aggs = torch.from_numpy(np.stack(_fold_runs(program, part, runs))).to(
        dev)
    # every slot at once, each slot's values read before any is written
    act = torch.stack(acts).expand(len(slots), nsub)  # (k, S)
    at = torch.tensor(slots, device=dev)[:, None] * c \
        + torch.arange(c, device=dev)  # (k, C)
    old = values[at]
    live = at < n_live
    keep = live & act.repeat_interleave(sub, dim=1)
    new = torch.where(keep, program.apply(old, aggs, n_total), old)
    if first and not last:
        scratch.old.copy_(old[0])  # a hot slot: one slot
    out[at] = new
    if last:
        old0 = old if first else scratch.old[None]
        delta = torch.where(keep, program.sd_delta(old0, new),
                            torch.zeros_like(new))
        _write_deltas(delta, live, act, psd2, dmax2, at[:, 0] // c, nsub)


def _write_deltas(delta, live, act, psd, dmax, rows, nsub) -> None:
    """psd/dmax ((P, S) or (P, S, L)) at the slots' rows, for each active
    sub-range: the pairwise-tree mean over its live vertices (at least one
    in the count) and the max of ``delta`` ((k, C) or (k, C, L), zero
    where not kept)."""
    k, c = delta.shape[:2]
    seg = delta.view(k, nsub, c // nsub, *delta.shape[2:])
    cnt = live.view(k, nsub, -1).sum(dim=2).clamp_min(1).to(delta.dtype)
    if delta.dim() == 3:
        cnt = cnt[..., None]
    mean = pairwise_sum(seg.movedim(2, 0)) / cnt
    r, s = torch.nonzero(act, as_tuple=True)
    psd[rows[r], s] = mean[r, s]
    dmax[rows[r], s] = seg.amax(dim=2)[r, s]


def lane_block_sweep_ref(program, n_total: int, ed, values: torch.Tensor,
                         vconst: torch.Tensor, rows: torch.Tensor,
                         ok: torch.Tensor, psd: torch.Tensor,
                         dmax: torch.Tensor, lane_done: torch.Tensor,
                         scratch: LaneScratch, *, block_size: int,
                         n_live: int, floor: float | None = None,
                         first: bool = True, last: bool = True) -> None:
    """Plain PyTorch version of :func:`lane_block_sweep` (``floor=None``)
    and of :func:`masked_lane_block_sweep` (``floor`` given), with the same
    signatures and in-place effects: every lane repeats
    :func:`block_sweep_ref`'s arithmetic in the kernel's order."""
    c, dev = block_size, values.device
    lanes = int(values.shape[1])
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    sub = c // nsub
    psd3, dmax3 = psd.view(-1, nsub, lanes), dmax.view(-1, nsub, lanes)
    slots = [int(r) for r, k in zip(rows.tolist(), ok.tolist()) if k]
    if not slots:
        return
    # each slot's mask, shared by the lanes, from its psd row at entry
    acts = [torch.ones(1, dtype=torch.bool, device=dev) if floor is None
            else torch.where(lane_done, 0.0, psd3[r]).amax(dim=-1)
            >= float(np.float32(floor)) for r in slots]
    starts, cnts = ed.tile_start.tolist(), ed.tile_cnt.tolist()
    runs = []
    for r, act in zip(slots, acts):
        t = torch.arange(starts[r], starts[r] + cnts[r], device=dev)
        if floor is not None:  # skip tiles that cover only masked ranges
            t = t[(ed.cov[t] & act).any(dim=1)]
        runs.append(t)
    tiles = torch.cat(runs)
    src = ed.src[tiles].reshape(-1).long()
    msg = program.edge_map(values[src], ed.aux[src],
                           ed.w[tiles].reshape(-1)).view(-1, TILE, lanes)
    part = _tile_partials(program, msg, ed.valid[tiles],
                          ed.dstl[tiles].long(), c).cpu().numpy()
    aggs = torch.from_numpy(np.stack(_fold_runs(program, part, runs))).to(
        dev)
    # every slot at once, each slot's values read before any is written
    act = torch.stack(acts).expand(len(slots), nsub)  # (k, S)
    at = torch.tensor(slots, device=dev)[:, None] * c \
        + torch.arange(c, device=dev)  # (k, C)
    old = values[at]
    live = at < n_live
    keep = (live & act.repeat_interleave(sub, dim=1))[..., None]
    new = torch.where(keep, program.apply(old, aggs, vconst[at], n_total),
                      old)
    old_buf = scratch.old.view(c, lanes)
    if first and not last:
        old_buf.copy_(old[0])  # a hot slot: one slot
    values[at] = new
    if last:
        delta = torch.where(keep, program.sd_delta(
            old if first else old_buf[None], new), torch.zeros_like(new))
        _write_deltas(delta, live, act, psd3, dmax3, at[:, 0] // c, nsub)
