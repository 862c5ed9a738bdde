"""The sweep kernel's run table (``kernels.block_sweep.fold_metadata``) and
the kernel's order re-enacted from it (``_torch_parity.emulate_kernel``),
held bit for bit against the plain version ``block_sweep_ref`` on the CPU,
on the layouts the card meets:

* a hand-built block whose hub destination owns 1200 whole tiles (each
  one run of 512 slots, and 1200 partials: the kernel's warp chain),
  beside destinations of a few slots, and a second block laid out as a
  stream leaves it (slots shuffled inside each tile, holes, no tile in
  run order);
* sub-blocks S = 1, 4 and 8 (the masked sweep's tile skip and masks);
* a one-slot slate of the hub block, and a slate of both blocks;

and the run table a streaming commit refreshes in place for the blocks it
touches equals one built afresh from the mutated tiles.
"""
import numpy as np
import pytest
import torch
from _torch_parity import HUB_TILES, emulate_kernel, hub_edge_data
from _torch_parity import one_torch_thread  # noqa: F401

from repro_torch.core import algorithms as TA
from repro_torch.kernels import block_sweep as kb

C = 64
TILE = kb.TILE


def test_hand_built_table():
    """The hub block's tiles are flagged sorted, one 512-slot run each
    but the last, and its destination 0 has HUB_TILES partials; no tile
    of the streamed block is in run order."""
    ed = hub_edge_data(1, np.random.default_rng(0))
    info = ed.tinfo.numpy()
    nruns = (info >> kb.TINFO_RUNS) & kb.TINFO_COUNT
    hub = slice(0, int(ed.tile_cnt[0]))
    assert np.all(info[hub] & kb.TINFO_SORTED)
    assert np.all(info[:HUB_TILES] & kb.TINFO_COUNT == TILE)
    assert np.all(nruns[:HUB_TILES] == 1)
    lo, hi = ed.pspan[0].tolist()
    assert hi - lo == HUB_TILES
    assert not np.any(info[int(ed.tile_cnt[0]):] & kb.TINFO_SORTED)


@pytest.mark.parametrize("s_sub", [1, 4, 8])
@pytest.mark.parametrize("prog", ["pagerank", "sssp", "cc"])
def test_kernel_order_matches_plain(prog, s_sub):
    """The kernel's order on the hand-built layout equals the plain sweep
    bit for bit: a one-slot hub pass at depth 1, then a slate of both
    blocks; masked at S > 1 with seeded sub-range masks."""
    rng = np.random.default_rng(s_sub)
    ed = hub_edge_data(s_sub, rng)
    program = TA.REGISTRY[prog]()
    floor = np.float32(1e-3) if s_sub > 1 else None
    values = rng.uniform(0.0, 1e-2, 2 * C).astype(np.float32)
    if prog != "pagerank":
        values = np.where(rng.random(2 * C) < 0.3, np.float32(1e18),
                          values * 1e3).astype(np.float32)
    psd0 = np.where(rng.random((2, s_sub)) < 0.6, 1.0, 0.0).astype(
        np.float32)
    psd0[0, 0] = 1.0  # the hub's sub-range is live
    for rows in ([0], [1, 0]):
        out = []
        for sweep in ("plain", "kernel order"):
            tv = torch.from_numpy(values.copy())
            psd = torch.from_numpy(psd0.copy())
            dmax = torch.full((2, s_sub), -1.0)
            args = (program, 2 * C - 5, ed, tv,
                    torch.tensor(rows, dtype=torch.int32),
                    torch.ones(len(rows), dtype=torch.bool), psd, dmax)
            kw = dict(block_size=C, n_live=2 * C - 5, floor=floor)
            if sweep == "plain":
                kb.block_sweep_ref(*args, kb.make_scratch(ed, C), **kw)
            else:
                emulate_kernel(*args, **kw)
            out.append((tv, psd, dmax))
        for a, b in zip(*out):
            assert torch.equal(a, b), (prog, s_sub, rows)


def test_refresh_matches_fresh_table():
    """A commit's refresh of a few blocks' run table, in place, equals the
    table built afresh from the mutated tiles: appends into a block's
    spare slots, kills, and a block's runs rebuilt in another order."""
    rng = np.random.default_rng(3)
    ed = hub_edge_data(1, rng)
    valid, dstl = ed.valid.clone(), ed.dstl.clone()
    spare = torch.nonzero(~valid[HUB_TILES:HUB_TILES + 2]).numpy()[:40]
    for r, j in spare:  # appends after the hub's last full tile
        valid[HUB_TILES + r, j] = True
        dstl[HUB_TILES + r, j] = int(rng.integers(0, C))
    dead = rng.choice(HUB_TILES, 30, replace=False)
    valid[dead, rng.integers(0, TILE, 30)] = False  # kills in whole tiles
    first = int(ed.tile_start[1])
    perm = torch.from_numpy(rng.permutation(TILE))
    dstl[first:] = dstl[first:, perm]  # the streamed block rebuilt
    valid[first:] = valid[first:, perm]
    ed.valid.copy_(valid)
    ed.dstl.copy_(dstl)
    fresh = kb.fold_metadata(ed.dstl, ed.valid, ed.tile_start, ed.tile_cnt,
                             C, 2 * C)
    table = (ed.rslot, ed.tinfo, ed.runs, ed.pspan)
    # every field of the old table is stale somewhere
    assert not any(torch.equal(a, b) for a, b in zip(table, fresh))
    kb.refresh_fold_metadata(ed, C, [1])  # block 1 alone: block 0 stale
    assert not torch.equal(ed.tinfo[:first], fresh[1][:first])
    assert torch.equal(ed.tinfo[first:], fresh[1][first:])
    kb.refresh_fold_metadata(ed, C, [0])
    for got, want in zip(table, fresh):
        assert torch.equal(got, want)
