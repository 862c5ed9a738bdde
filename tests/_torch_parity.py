"""Shared helpers for the port's parity tests (tests/test_torch_*.py): hand
a reference engine's state to the port as numpy arrays, and keep torch to
one intra-op thread (the plain versions run many small ops, which a thread
pool only slows down)."""
import numpy as np
import pytest
import torch

from repro_torch.interop import STORAGE_FIELDS, engine_from_arrays


def reference_arrays(eng) -> dict:
    """The reference StructureAwareEngine's state, as the arrays
    ``repro_torch.interop.engine_from_arrays`` takes: its live edge state
    (the build-time tiles, or the mutated ones after streaming ingests),
    and its plan's group-padded storages (``plan.hot``/``plan.cold``, the
    distributed engine's layout)."""
    p, u, ed = eng.plan, eng.plan.unified, eng.edge_state
    is_hot = np.zeros(p.num_blocks, dtype=bool)
    is_hot[:p.barrier_block] = True
    groups = {f"{key}_{f}": np.asarray(getattr(getattr(p, key), f))
              for key in ("hot", "cold") for f in STORAGE_FIELDS}
    return dict(order=p.order, inv=p.inv, n_live=p.n_live,
                src=np.asarray(ed.src), dst_local=np.asarray(ed.dstl),
                w=np.asarray(ed.w), valid=np.asarray(ed.valid),
                cov=np.asarray(ed.cov), tile_start=u.tile_start,
                tile_cnt=u.tile_cnt, edges=np.asarray(eng.edge_counts),
                values0=np.asarray(eng.values0), aux=np.asarray(ed.aux),
                coupling=np.asarray(eng._coupling), is_hot=is_hot, **groups)


def port_engine(eng, program, config):
    """The port's engine on the CPU over the reference engine's state."""
    return engine_from_arrays(program, config, reference_arrays(eng),
                              device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HUB_TILES = 1200  # hub_edge_data: whole tiles of the hub destination


def _hub_block(c, rng):
    """(dst, src) of a hub block in CSC order: destination 0 owns
    HUB_TILES whole tiles, then every other destination a few edges."""
    few = rng.integers(0, 6, c - 1)
    dst = np.concatenate([np.zeros(HUB_TILES * 512, np.int64),
                          np.repeat(np.arange(1, c), few)])
    return dst, rng.integers(0, 2 * c, dst.size)


def _tile_rows(dst, src, rng, mutate):
    """Tile rows of one block's edges: in order (CSC), or as a stream
    leaves them (each tile's slots shuffled, a fifth of them dead)."""
    n_t = -(-dst.size // 512)
    pad = n_t * 512 - dst.size
    d = np.concatenate([dst, np.zeros(pad, np.int64)]).reshape(n_t, 512)
    s = np.concatenate([src, np.zeros(pad, np.int64)]).reshape(n_t, 512)
    v = (np.arange(n_t * 512) < dst.size).reshape(n_t, 512)
    if mutate:
        for t in range(n_t):
            p = rng.permutation(512)
            d[t], s[t], v[t] = d[t, p], s[t, p], v[t, p]
        v &= rng.random(v.shape) > 0.2
    return d, s, v


def hub_edge_data(s_sub, rng, c=64):
    """A hand-built EdgeData of two blocks of ``c`` vertices on the CPU:
    the hub block in CSC order (destination 0 in HUB_TILES tiles of one
    512-slot run each: HUB_TILES partials), then a block as a stream
    leaves it (no tile in run order), with S = ``s_sub`` coverage and its
    run table."""
    from repro_torch.core.engine import EdgeData, tile_coverage
    from repro_torch.kernels import block_sweep as kb
    d0, s0 = _hub_block(c, rng)
    d1 = np.sort(rng.integers(0, c, 3 * 512))
    parts = [_tile_rows(d0, s0, rng, False),
             _tile_rows(d1, rng.integers(0, 2 * c, d1.size), rng, True)]
    dstl, src, valid = (np.concatenate([p[i] for p in parts])
                        for i in range(3))
    cnt = np.array([p[0].shape[0] for p in parts])
    start = np.cumsum(cnt) - cnt

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt)

    tiles = dict(dstl=t(dstl, torch.int32), valid=t(valid, torch.bool),
                 tile_start=t(start, torch.int32),
                 tile_cnt=t(cnt, torch.int32))
    table = kb.fold_metadata(tiles["dstl"], tiles["valid"],
                             tiles["tile_start"], tiles["tile_cnt"], c,
                             2 * c)
    return EdgeData(
        src=t(src, torch.int32),
        w=t(rng.uniform(0.5, 4.0, dstl.shape), torch.float32),
        cov=t(tile_coverage(dstl, valid, s_sub, c), torch.bool),
        aux=t(rng.uniform(1.0, 9.0, 2 * c), torch.float32),
        **tiles, **dict(zip(("rslot", "tinfo", "runs", "pspan"), table)))


def window_edge_data(s_sub, rng, c=512):
    """A hand-built EdgeData of three one-tile blocks of ``c`` vertices in
    CSC order on the CPU, each tile's first chunk (``lane_shape``'s, at
    L = 1, 8 and 32) holding whole rounds of a lane warp's (run, lane)
    pairs up to the end of its window of 32 runs (64 runs of 4, 32 of 4,
    32 of 1), the last of them carried on into the next chunk; then runs
    of 1-6 slots to the end of the tile. Its fold's final round moves the
    window past the run the next chunk starts in."""
    from repro_torch.core.engine import EdgeData, tile_coverage
    from repro_torch.kernels import block_sweep as kb
    heads = ([4] * 63 + [8], [4] * 31 + [8], [1] * 31 + [2])
    dst = []
    for head in heads:
        lens = list(head)
        while sum(lens) < kb.TILE and len(lens) < c:
            lens.append(int(rng.integers(1, 7)))
        d = np.repeat(np.arange(len(lens)), lens)[:kb.TILE]
        dst.append(np.concatenate([d, np.zeros(kb.TILE - d.size, np.int64)]))
    for lanes, head in zip((1, 8, 32), heads):
        chunk = kb.lane_shape(lanes, c, 1)[1]
        assert sum(head[:-1]) < chunk < sum(head)
    dstl = np.stack(dst)
    valid = np.ones(dstl.shape, bool)
    cnt = np.ones(len(heads), np.int64)

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt)

    tiles = dict(dstl=t(dstl, torch.int32), valid=t(valid, torch.bool),
                 tile_start=t(np.arange(len(heads)), torch.int32),
                 tile_cnt=t(cnt, torch.int32))
    n = len(heads) * c
    table = kb.fold_metadata(tiles["dstl"], tiles["valid"],
                             tiles["tile_start"], tiles["tile_cnt"], c, n)
    return EdgeData(
        src=t(rng.integers(0, n, dstl.shape), torch.int32),
        w=t(rng.uniform(0.5, 4.0, dstl.shape), torch.float32),
        cov=t(tile_coverage(dstl, valid, s_sub, c), torch.bool),
        aux=t(rng.uniform(1.0, 9.0, n), torch.float32),
        **tiles, **dict(zip(("rslot", "tinfo", "runs", "pspan"), table)))


def _chain(fold, start, xs):
    """``xs`` folded left to right from ``start`` (the identity, or a
    carried partial) in f32, one dependent step at a time (numpy's
    ``accumulate`` is sequential; NaN, an unwritten partial, propagates)."""
    return fold.accumulate(np.concatenate(
        [np.broadcast_to(np.float32(start), (1,) + xs.shape[1:]),
         xs.astype(np.float32)]), axis=0)[-1]


def _tile_order(ed, r, kb):
    """Tile row ``r``'s run table as the kernel reads it: the valid slots in
    run order (``rslot``, or the positions themselves on a tile flagged
    sorted), and each run's [first, end) stretch of them with its
    partial's index."""
    info = int(ed.tinfo[r])
    nv = info & kb.TINFO_COUNT
    nr = (info >> kb.TINFO_RUNS) & kb.TINFO_COUNT
    order = (np.arange(nv) if info & kb.TINFO_SORTED
             else ed.rslot[r, :nv].numpy().astype(np.int64))
    runs = ed.runs[r * kb.TILE:r * kb.TILE + nr].numpy()
    ends = np.append(runs[1:, 0], nv)
    return order, [(int(a), int(b), int(p))
                   for (a, p), b in zip(runs, ends)]


def emulate_kernel(program, n_total, ed, values, rows, ok, psd, dmax, *,
                   block_size, n_live, floor=None):
    """A one-pass sweep re-enacted in numpy the way csrc/block_sweep.cu
    runs it, from the run table alone: each tile's messages gathered in run
    order (``rslot``, or the slots themselves where ``tinfo`` flags the
    tile sorted), each run's stretch folded from the identity into the
    partial its table row names; then every vertex's partials
    ``pspan[v]``, contiguous, folded from the identity in order (by a
    thread, or by a warp's shuffled chain past ``LONG_SPAN``: the same
    chain); the masked form skips a tile unless its ``cov`` row meets the
    slot's mask and keeps masked sub-ranges. Partials are NaN until
    written, so one read before its write shows. The CUDA kernel cannot
    run on the CPU, so this holds its order and its run table against
    ``block_sweep_ref`` on any layout. In place, like the kernel."""
    from repro_torch.kernels import block_sweep as kb
    c = block_size
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    sub = c // nsub
    ident = np.float32(program.identity)
    fold = {"sum": np.add, "min": np.minimum,
            "max": np.maximum}[program.combine]
    src = ed.src.numpy()
    w = ed.w.numpy()
    pspan = ed.pspan.numpy()
    cov = ed.cov.numpy()
    ts, tc = ed.tile_start.numpy(), ed.tile_cnt.numpy()
    psd2, dmax2 = psd.view(-1, nsub), dmax.view(-1, nsub)
    slots = [int(r) for r, k in zip(rows.tolist(), ok.tolist()) if k]
    acts = {r: (np.ones(1, bool) if floor is None
                else psd2[r].numpy() >= np.float32(floor)) for r in slots}
    part = np.full(src.size, np.nan, np.float32)
    for r in slots:  # the tiles, a warp each
        for t in range(ts[r], ts[r] + tc[r]):
            if floor is not None and not (cov[t] & acts[r]).any():
                continue
            order, runs = _tile_order(ed, t, kb)
            s_e = torch.from_numpy(src[t, order]).long()
            m = program.edge_map(values[s_e], ed.aux[s_e],
                                 torch.from_numpy(w[t, order])).numpy()
            for lo, hi, p in runs:  # a lane per run
                part[p] = _chain(fold, ident, m[lo:hi])
    news = []
    for r in slots:  # the fold, after every tile
        base = r * c
        live = base + np.arange(c) < n_live
        keep = live & np.repeat(acts[r], sub)
        agg = np.full(c, ident, np.float32)
        for i in np.flatnonzero(keep):
            lo, hi = pspan[base + i]
            agg[i] = _chain(fold, ident, part[lo:hi])
        old = values[base:base + c].clone()
        new = torch.where(torch.from_numpy(keep), program.apply(
            old, torch.from_numpy(agg), n_total), old)
        news.append((r, old, new, live, keep))
    for r, old, new, live, keep in news:
        values[r * c:(r + 1) * c] = new
        delta = torch.where(torch.from_numpy(keep),
                            program.sd_delta(old, new), 0.0)
        for s in np.flatnonzero(acts[r]):
            seg = slice(s * sub, (s + 1) * sub)
            cnt = max(int(live[seg].sum()), 1)
            psd2[r, s] = kb.pairwise_sum(delta[seg]) / torch.tensor(
                float(cnt))
            dmax2[r, s] = delta[seg].max()


class _RunWindow:
    """A lane warp's window on a tile's run table, as the kernel keeps it:
    runs 32 b .. 32 b + 63 (first position, partial), loaded 32 at a time;
    a run outside it is not there to read."""

    def __init__(self, runs):
        self.runs = runs
        self.move(0)

    def move(self, b):
        self.b = b
        self.held = {k: (self.runs[k][0], self.runs[k][2])
                     for k in range(32 * b, min(32 * b + 64, len(self.runs)))}

    def run(self, k):
        return self.held[k]


def _warp_chain(fold, ident, part, lo, hi, lanes):
    """A long destination's partials ``part[lo:hi]`` (the lanes of one
    group) folded as the kernel's warp folds them: batches of
    ``LONG_FLOATS // lanes`` partials staged in shared memory, the next one
    loading, each lane's chain over a batch in tile order: one chain, batch
    after batch, from the identity."""
    from repro_torch.kernels import block_sweep as kb
    step = kb.LONG_FLOATS // lanes
    acc = np.full(part.shape[1:], ident, np.float32)
    for r0 in range(lo, hi, step):
        acc = _chain(fold, acc, part[r0:min(r0 + step, hi)])
    return acc


def emulate_lane_kernel(program, n_total, ed, values, vconst, rows, ok, psd,
                        dmax, lane_done, old=None, *, block_size, n_live,
                        floor=None, first=True, last=True):
    """A lane sweep pass re-enacted in numpy the way ``lane_sweep`` of
    csrc/block_sweep.cu runs it, from the run table and
    ``kb.lane_shape``: one mask per slot from the lanes not done (a slot
    whose mask is empty owns no tiles); each tile staged in run order and
    taken in chunks of ``chunk`` positions, each (run, lane) of a chunk
    folded from the identity, or from its carry where the run began in an
    earlier chunk, into the other carry where it goes on past the chunk and
    into its partial where it ends (the pairs in rounds of 32, each run
    read through the warp's window of 64 runs); then each slot's fold lane group by lane
    group: a destination's contiguous partials ``pspan[v]`` from the
    identity (a warp's batched chain past ``LONG_SPAN``), apply, and the
    group's deltas through the pairwise tree. Partials and carries are NaN
    until written (and a carry once read), so a read before its write
    shows. ``old`` ((C, L)) is the scratch of a multi-pass one-slot chain
    (``first``/``last``). In place, like the kernel."""
    from repro_torch.kernels import block_sweep as kb
    c, lanes = block_size, values.shape[1]
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    sub = c // nsub
    _, chunk, group = kb.lane_shape(lanes, c, nsub)
    ident = np.float32(program.identity)
    fold = {"sum": np.add, "min": np.minimum,
            "max": np.maximum}[program.combine]
    src = ed.src.numpy()
    w = ed.w.numpy()
    pspan = ed.pspan.numpy()
    cov = ed.cov.numpy()
    ts, tc = ed.tile_start.numpy(), ed.tile_cnt.numpy()
    psd3, dmax3 = psd.view(-1, nsub, lanes), dmax.view(-1, nsub, lanes)
    done = lane_done.numpy()
    slots = [int(r) for r, k in zip(rows.tolist(), ok.tolist()) if k]
    acts = {r: (np.ones(1, bool) if floor is None else np.where(
        done, np.float32(0), psd3[r].numpy()).max(axis=-1)
        >= np.float32(floor)) for r in slots}
    part = np.full((src.size, lanes), np.nan, np.float32)
    for r in slots:  # the tiles, a warp each
        if not acts[r].any():
            continue
        for t in range(ts[r], ts[r] + tc[r]):
            if floor is not None and not (cov[t] & acts[r]).any():
                continue
            order, runs = _tile_order(ed, t, kb)
            win = _RunWindow(runs)
            s_e = torch.from_numpy(src[t, order]).long()  # staged
            w_e = torch.from_numpy(w[t, order])
            carry = np.full((2, lanes), np.nan, np.float32)
            k_lo = 0
            for ci, c0 in enumerate(range(0, len(order), chunk)):
                c1 = min(c0 + chunk, len(order))
                at = slice(c0, c1)
                m = program.edge_map(values[s_e[at]], ed.aux[s_e[at]],
                                     w_e[at]).numpy()
                pairs, goes_on = 0, False
                if k_lo < 32 * win.b:  # re-anchored below the window
                    win.move(k_lo // 32)
                for q0 in range(0, 32 * len(runs) * lanes + 32, 32):
                    k_r = k_lo + q0 // lanes  # rounds of 32 (run, lane)
                    while k_r >= 32 * (win.b + 1):
                        win.move(win.b + 1)
                    ks = {k_lo + q // lanes for q in range(q0, q0 + 32)}
                    mine = {k for k in ks
                            if k < len(runs) and win.run(k)[0] < c1}
                    for k in sorted(mine):  # L threads per run
                        lo, p = win.run(k)
                        hi = win.run(k + 1)[0] if k + 1 < len(runs) \
                            else len(order)
                        start = carry[ci % 2].copy() if lo < c0 else ident
                        acc = _chain(fold, start, m[max(lo, c0) - c0:
                                                    min(hi, c1) - c0])
                        if hi > c1:
                            carry[(ci + 1) % 2] = acc
                            goes_on = True
                        else:
                            part[p] = acc
                    pairs += sum(min(q0 + 32, (k - k_lo + 1) * lanes)
                                 - max(q0, (k - k_lo) * lanes)
                                 for k in mine)
                    if k_lo + (q0 + 31) // lanes not in mine:
                        break
                carry[ci % 2] = np.nan  # read by this chunk alone
                k_lo += pairs // lanes - goes_on
    width = nsub * (1 << (sub - 1).bit_length())
    for r in slots:  # the fold of each slot, after every tile
        base = r * c
        live = base + np.arange(c) < n_live
        keep = live & np.repeat(acts[r], sub)
        prev = values[base:base + c].clone()
        if first and not last:
            old.copy_(prev)
        for l0 in range(0, lanes, group):
            lg = slice(l0, min(l0 + group, lanes))
            agg = np.full((c, lg.stop - l0), ident, np.float32)
            for i in np.flatnonzero(keep):
                lo, hi = pspan[base + i]
                agg[i] = (_warp_chain(fold, ident, part[:, lg], lo, hi,
                                      lanes)
                          if hi - lo > kb.LONG_SPAN
                          else _chain(fold, ident, part[lo:hi, lg]))
            new = torch.where(torch.from_numpy(keep)[:, None], program.apply(
                prev[:, lg], torch.from_numpy(agg),
                vconst[base:base + c, lg], n_total), prev[:, lg])
            values[base:base + c, lg] = new
            if not last:
                continue
            was = prev[:, lg] if first else old[:, lg]
            delta = torch.where(torch.from_numpy(keep)[:, None],
                                program.sd_delta(was, new), 0.0)
            assert 2 * width * (lg.stop - l0) <= kb.LANE_TREES
            for s in np.flatnonzero(acts[r]):
                seg = slice(s * sub, (s + 1) * sub)
                cnt = max(int(live[seg].sum()), 1)
                psd3[r, s, lg] = kb.pairwise_sum(delta[seg]) / torch.tensor(
                    float(cnt))
                dmax3[r, s, lg] = delta[seg].amax(dim=0)


def emulate_segment_kernel(msg, layout, row, combine, init):
    """Kernels 2/3 re-enacted in numpy the way csrc/segment_combine.cu runs
    them on row ``row`` of ``layout``, from its run table alone (dst is not
    read): seg_tiles (short rows) takes each 512-slot tile's runs (from the
    layout's first run of each tile), folds each one from the combine's
    identity, and writes it at once where its destination has no other run
    (init combined with it) or else into its partial; seg_pieces (long rows)
    does the same a run per lane, each folded from its first message; the
    empty destinations get ``init``; then each destination of several runs
    folds its partials, in order, from ``init`` (the last block on a short
    row, seg_chain on a long one). The CUDA kernel cannot run on the CPU,
    so this holds its order and the layout's tables against the plain
    versions."""
    from repro_torch.kernels import segment as ks
    merge = {"sum": lambda a, b: np.float32(a + b),
             "min": lambda a, b: np.fmin(a, b),
             "max": lambda a, b: np.fmax(a, b)}[combine]
    ident = {"sum": np.float32(0.0), "min": np.float32(np.inf),
             "max": np.float32(-np.inf)}[combine]
    m, c = msg.numpy(), layout.block_size
    lptr = layout.lptr[row].numpy()

    def rows_of(table, counts):  # this row's entries of a row-after-row table
        base = int(counts[:row].sum())
        return table[base:base + int(counts[row])].numpy()

    pstart = rows_of(layout.pstart, layout.npieces + 1)
    ptarget = rows_of(layout.ptarget, layout.npieces)
    tpiece = rows_of(layout.tpiece, layout.ntiles + 1)
    out = np.full(c, np.nan, np.float32)
    part = np.full(int(lptr[-1]), np.nan, np.float32)
    long = layout.path[row] == ks.LONG
    for t in range(int(layout.ntiles[row])):  # short: a warp per tile
        for k in range(tpiece[t], tpiece[t + 1]):  # a lane per run
            lo, hi = pstart[k], pstart[k + 1]
            p = m[lo] if long else ident  # seg_pieces: from its first
            for x in m[lo + long:hi]:
                p = merge(p, x)
            if ptarget[k] >= 0:
                out[ptarget[k]] = merge(np.float32(init), p)
            else:
                part[~ptarget[k]] = p
    for d in rows_of(layout.empty, layout.nempty):
        out[d] = init
    for d in rows_of(layout.chain, layout.nchain):
        acc = np.float32(init)
        for p in part[lptr[d]:lptr[d + 1]]:
            acc = merge(acc, p)
        out[d] = acc
    return out


def emulate_flash_tc(q, k, v, causal, rows=128, keys=128):
    """Kernel 4's bf16 tensor-core route re-enacted in torch on the CPU, with
    its roundings at the places csrc/flash_attention.cu has them: per
    (128-row q tile, 128-key tile) pair up to the diagonal, the products of
    the bf16 q and k summed in f32 and scaled after the product (folded with
    log2(e) into exp2, one rounding of the exponent as the kernel's fmaf);
    the -1e30 mask on the diagonal tile; the running max and p in f32, l
    summed from the f32 p; P rounded to bf16 before P v, summed in f32; the
    output acc / max(l, 1e-30) rounded once to bf16. The CUDA kernel cannot
    run on the CPU, so this shows that its roundings stay inside the bf16
    bar. q: (B, Hq, S, D) bf16; k, v: (B, Hkv, S, D)."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    c = np.float32(1.0 / d ** 0.5) * np.float32(1.4426950408889634)
    qf = q.float().reshape(b, k.shape[1], g, s, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    out = torch.empty(qf.shape, dtype=torch.float32)
    for qi in range(s // rows):
        qt = qf[..., qi * rows:(qi + 1) * rows, :]
        m = torch.full(qt.shape[:-1] + (1,), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        last = qi * rows // keys if causal else s // keys - 1
        for ki in range(last + 1):
            sl = slice(ki * keys, (ki + 1) * keys)
            sc = qt @ kf[..., sl, :].transpose(-1, -2)
            if causal and ki == last:
                qpos = qi * rows + torch.arange(rows)[:, None]
                kpos = ki * keys + torch.arange(keys)[None]
                sc = sc.masked_fill(kpos > qpos, -1e30)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2((sc.double() * float(c)
                            - (m_new * c).double()).float())
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[..., sl, :]
            m = m_new
        out[..., qi * rows:(qi + 1) * rows, :] = acc / torch.clamp_min(l,
                                                                       1e-30)
    return out.reshape(b, hq, s, d).to(q.dtype)


def tf32_rna(x):
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest with ties away from zero, 10 mantissa bits kept and the low 13
    bits of the word cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as kernel 5's tensor cores form it: each f32 operand split as
    hi = tf32(x), lo = tf32(x - hi), and a_lo b_hi + a_hi b_lo + a_hi b_hi
    summed in f32 (a_lo b_lo dropped)."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate_ssd_tc(c, b, u, ld, tile=64):
    """Kernel 5 (csrc/ssd_scan.cu) re-enacted in torch on the CPU, with its
    roundings at the places the kernel has them: per (64-row query tile,
    64-key tile) pair up to the diagonal, the Gram c_q . b_s in 3xTF32
    (:func:`mm_3xtf32`); W = where(s <= q, G * exp(l_q - l_s), 0) formed in
    f32 (the decay selected, never multiplied by a mask); W u_s in 3xTF32,
    W split again, summed into an f32 accumulator over the key tiles. Rows
    past Q are zero, as the kernel's ragged last tile is. Both forms of
    ``ssd_intra_chunk``; returns u's shape in u's dtype. The CUDA kernel
    cannot run on the CPU, so this shows that the split keeps its f32
    bar."""
    if u.dim() == 3:
        return emulate_ssd_tc(c, b, u[:, :, None], ld[:, :, None], tile)[
            :, :, 0]
    g, q, h, p = u.shape
    qp = -(-q // tile) * tile
    cf = torch.zeros(g, qp, c.shape[-1])
    bf = torch.zeros(g, qp, c.shape[-1])
    uf = torch.zeros(g, h, qp, p)
    lf = torch.zeros(g, h, qp)
    cf[:, :q], bf[:, :q] = c.float(), b.float()
    uf[:, :, :q] = u.float().permute(0, 2, 1, 3)
    lf[:, :, :q] = ld.float().permute(0, 2, 1)
    pos = torch.arange(qp)
    out = torch.empty(g, h, qp, p)
    for q0 in range(0, qp, tile):
        rq = slice(q0, q0 + tile)
        acc = torch.zeros(g, h, tile, p)
        for s0 in range(0, q0 + 1, tile):
            rs = slice(s0, s0 + tile)
            gram = mm_3xtf32(cf[:, rq], bf[:, rs].transpose(1, 2))
            keep = pos[rs][None, :] <= pos[rq][:, None]
            decay = torch.exp(lf[:, :, rq, None] - lf[:, :, None, rs])
            w = torch.where(keep, gram[:, None] * decay, 0.0)
            acc = acc + mm_3xtf32(w, uf[:, :, rs])
        out[:, :, rq] = acc
    return out[:, :, :q].permute(0, 2, 1, 3).to(u.dtype)
