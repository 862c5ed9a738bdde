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


def _chain(fold, ident, xs):
    """``xs`` folded left to right from ``ident`` in f32, one dependent
    step at a time (numpy's ``accumulate`` is sequential; NaN, an unwritten
    partial, propagates)."""
    return fold.accumulate(np.concatenate(
        [np.full((1,) + xs.shape[1:], ident, np.float32),
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


def emulate_lane_kernel(program, n_total, ed, values, vconst, rows, ok, psd,
                        dmax, lane_done, *, block_size, n_live, floor=None):
    """A one-pass lane sweep re-enacted in numpy the way the lane kernel of
    csrc/block_sweep.cu runs it, from the run table: one mask per slot from
    the lanes not done, each tile's L messages per slot gathered in run
    order, each (run, lane) stretch folded from the identity into the run's
    partial, then each vertex's contiguous partials ``pspan[v]`` folded lane
    by lane. In place, like the kernel."""
    from repro_torch.kernels import block_sweep as kb
    c, lanes = block_size, values.shape[1]
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
    psd3, dmax3 = psd.view(-1, nsub, lanes), dmax.view(-1, nsub, lanes)
    done = lane_done.numpy()
    slots = [int(r) for r, k in zip(rows.tolist(), ok.tolist()) if k]
    acts = {r: (np.ones(1, bool) if floor is None else np.where(
        done, np.float32(0), psd3[r].numpy()).max(axis=-1)
        >= np.float32(floor)) for r in slots}
    part = np.full((src.size, lanes), np.nan, np.float32)
    for r in slots:  # launch 1: the tile pass
        for t in range(ts[r], ts[r] + tc[r]):
            if floor is not None and not (cov[t] & acts[r]).any():
                continue
            order, runs = _tile_order(ed, t, kb)
            s_e = torch.from_numpy(src[t, order]).long()
            m = program.edge_map(values[s_e], ed.aux[s_e],
                                 torch.from_numpy(w[t, order])).numpy()
            for lo, hi, p in runs:
                part[p] = _chain(fold, ident, m[lo:hi])
    news = []
    for r in slots:  # launch 2: the fold, one block per slot
        base = r * c
        live = base + np.arange(c) < n_live
        keep = live & np.repeat(acts[r], sub)
        agg = np.full((c, lanes), ident, np.float32)
        for i in np.flatnonzero(keep):
            lo, hi = pspan[base + i]
            agg[i] = _chain(fold, ident, part[lo:hi])
        old = values[base:base + c].clone()
        new = torch.where(torch.from_numpy(keep)[:, None], program.apply(
            old, torch.from_numpy(agg), vconst[base:base + c], n_total), old)
        news.append((r, old, new, live, keep))
    for r, old, new, live, keep in news:
        values[r * c:(r + 1) * c] = new
        delta = torch.where(torch.from_numpy(keep)[:, None],
                            program.sd_delta(old, new), 0.0)
        for s in np.flatnonzero(acts[r]):
            seg = slice(s * sub, (s + 1) * sub)
            cnt = max(int(live[seg].sum()), 1)
            psd3[r, s] = kb.pairwise_sum(delta[seg]) / torch.tensor(
                float(cnt))
            dmax3[r, s] = delta[seg].amax(dim=0)


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
