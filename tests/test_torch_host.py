"""The port's numpy host layers equal the reference's array for array:
graph generators, degrees, the partition plan and its tiled storage,
repartition decisions, the scheduler, and the small helpers."""
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.core import degrees as JD
from repro.core import engine as JE
from repro.core import graph as JG
from repro.core import partition as JP
from repro.core import repartition as JR
from repro.core import schedule as JS
from repro.core import state as JSt
from repro_torch.core import degrees as TD
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import partition as TP
from repro_torch.core import repartition as TR
from repro_torch.core import schedule as TS
from repro_torch.core import state as TSt

GRAPHS = {
    "powerlaw": ("powerlaw_graph", dict(n=1500, avg_deg=6, seed=3,
                                        weighted=True)),
    "core_periphery": ("core_periphery_graph", dict(n=2000, avg_deg=5,
                                                    seed=1, chords=1)),
    "uniform": ("uniform_graph", dict(n=1200, deg=4, seed=2)),
}


def _pair(name):
    fn, kw = GRAPHS[name]
    return getattr(JG, fn)(**kw), getattr(TG, fn)(**kw)


def _same_graph(a, b):
    for f in ("n", "m", "out_indptr", "out_dst", "out_w", "in_indptr",
              "in_src", "in_w"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graphs_equal(name):
    jg, tg = _pair(name)
    _same_graph(jg, tg)
    _same_graph(JG.symmetrize(jg), TG.symmetrize(tg))
    order = np.random.default_rng(0).permutation(jg.n)
    (pj, ij), (pt, it) = JG.permute(jg, order), TG.permute(tg, order)
    _same_graph(pj, pt)
    assert np.array_equal(ij, it)


def test_load_coo_equal(tmp_path):
    path = tmp_path / "edges.txt"
    path.write_text("# c\n0 1 0.5\n2 1 1.5\n1 3 2.0\n3 0 0.25\n")
    _same_graph(JG.load_coo(str(path)), TG.load_coo(str(path)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_degrees_equal(name):
    jg, tg = _pair(name)
    assert JD.suggest_alpha(jg) == TD.suggest_alpha(tg)
    a = JD.suggest_alpha(jg)
    assert np.array_equal(JD.active_degree(jg, a), TD.active_degree(tg, a))
    ad = JD.active_degree(jg, a)
    assert JD.sampled_threshold(ad, 0.1, 0.1, 3) == \
        TD.sampled_threshold(ad, 0.1, 0.1, 3)


@pytest.mark.parametrize("block_size", [64, 256])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_equal(name, block_size):
    jg, tg = _pair(name)
    jp = JP.build_plan(jg, block_size=block_size)
    tp = TP.build_plan(tg, block_size=block_size)
    _same_graph(jp.graph, tp.graph)
    for f in ("inv", "order", "ad"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    for f in ("block_size", "num_blocks", "n_live", "n_dead",
              "barrier_block", "t1", "alpha"):
        assert getattr(jp, f) == getattr(tp, f), f
    for f in ("src", "dst_local", "w", "valid", "tile_start", "tile_cnt",
              "edges"):
        assert np.array_equal(getattr(jp.unified, f),
                              getattr(tp.unified, f)), f
    assert [jp.block_bytes(b) for b in range(jp.num_blocks)] == \
        [tp.block_bytes(b) for b in range(tp.num_blocks)]
    cov = (JE.tile_coverage(jp.unified.dst_local, jp.unified.valid, 4,
                            block_size),
           TE.tile_coverage(tp.unified.dst_local, tp.unified.valid, 4,
                            block_size))
    assert np.array_equal(*cov)


def test_tiled_storage_slack_equal():
    jg, tg = _pair("powerlaw")
    a = JP.build_tiled_storage(jg, 64, 24, slack=0.5, spare_tiles=1)
    b = TP.build_tiled_storage(tg, 64, 24, slack=0.5, spare_tiles=1)
    for f in ("src", "dst_local", "w", "valid", "tile_start", "tile_cnt",
              "edges"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_vertex_slots_cover_each_vertex():
    """The sweep's run table reaches exactly each vertex's in-edge slots:
    the runs whose partials ``pspan[v]`` names are v's valid slots, one run
    per tile in tile order, each run a stretch of its tile's run order in
    slot order, every run's partial inside its block's own slot range. On
    the build-time (CSC) layout every tile is flagged sorted (run order is
    slot order) and a vertex's runs start at its first slot and then at the
    start of every later tile it spans; a layout with each tile's
    destinations reversed (no longer in destination order, so no tile with
    more than one run is sorted) is covered as well."""
    from repro_torch.kernels import block_sweep as kb
    _, tg = _pair("core_periphery")
    plan = TP.build_plan(tg, block_size=64)
    u = plan.unified
    n_pad = plan.num_blocks * 64
    indeg = np.pad(plan.graph.in_deg, (0, n_pad - plan.graph.n))
    bad = TP.TiledStorage(src=u.src, dst_local=u.dst_local[:, ::-1].copy(),
                          w=u.w, valid=u.valid[:, ::-1].copy(),
                          tile_start=u.tile_start, tile_cnt=u.tile_cnt,
                          edges=u.edges)
    block_of_tile = np.repeat(np.arange(plan.num_blocks), u.tile_cnt)
    for store in (u, bad):
        rslot, tinfo, runs, pspan = (t.numpy() for t in kb.fold_metadata(
            *(torch.as_tensor(a) for a in (
                store.dst_local, store.valid, store.tile_start,
                store.tile_cnt)), 64, n_pad))
        dst = block_of_tile[:, None] * 64 + store.dst_local
        run_of = {}  # partial -> (tile, its slots in run order)
        for r in range(dst.shape[0]):
            nv = tinfo[r] & kb.TINFO_COUNT
            nr = (tinfo[r] >> kb.TINFO_RUNS) & kb.TINFO_COUNT
            order = rslot[r, :nv].astype(np.int64)
            assert sorted(order) == np.flatnonzero(store.valid[r]).tolist()
            assert bool(tinfo[r] & kb.TINFO_SORTED) == \
                (order == np.arange(nv)).all()
            first = runs[r * TP.TILE:r * TP.TILE + nr]
            assert first[0, 0] == 0 if nr else nv == 0
            for (lo, p), hi in zip(first, np.append(first[1:, 0], nv)):
                assert lo < hi and p not in run_of
                run_of[p] = (r, order[lo:hi])
        walked = np.zeros(store.valid.shape, int)
        for v in range(n_pad):
            lo, hi = pspan[v]
            area = u.tile_start[v // 64] * TP.TILE
            assert area <= lo <= hi <= area + u.tile_cnt[v // 64] * TP.TILE
            tiles = [run_of[p][0] for p in range(lo, hi)]
            assert np.all(np.diff(tiles) > 0)  # one run per tile, in order
            for p in range(lo, hi):
                r, slots = run_of[p]
                assert np.all(np.diff(slots) > 0)  # slot order
                assert np.all(store.valid[r, slots])
                assert np.all(dst[r, slots] == v)
                walked[r, slots] += 1
        assert len(run_of) == sum(pspan[:, 1] - pspan[:, 0])
        assert np.array_equal(walked, store.valid.astype(int))
        assert np.bincount(dst[store.valid], minlength=n_pad).tolist() == \
            indeg.tolist()
        if store is u:
            assert np.all(tinfo & kb.TINFO_SORTED)
            for v in np.flatnonzero(indeg)[::37]:
                flat = np.flatnonzero((store.valid & (dst == v)).ravel())
                want = [int(flat[0])] + list(range(
                    (flat[0] // TP.TILE + 1) * TP.TILE, flat[-1] + 1,
                    TP.TILE))
                got = [run_of[p][0] * TP.TILE + int(run_of[p][1][0])
                       for p in range(*pspan[v])]
                assert got == want
        else:
            nruns = (tinfo >> kb.TINFO_RUNS) & kb.TINFO_COUNT
            assert not np.any((tinfo & kb.TINFO_SORTED) & (nruns > 1))


def test_repartition_decisions_equal():
    rng = np.random.default_rng(4)
    for mode in ("barrier", "universal"):
        j = JR.RepartitionState.create(40, 12, mode, interval=2)
        t = TR.RepartitionState.create(40, 12, mode, interval=2)
        for it in range(30):
            psd = rng.choice([1e-9, 1e-3, 0.5, 2.0, JSt.UNSEEN],
                             size=40).astype(np.float32)
            assert j.chunk_end(100) == t.chunk_end(100)
            assert j.maybe_repartition(it, psd, 0.2) == \
                t.maybe_repartition(it, psd, 0.2)
            assert np.array_equal(j.is_hot, t.is_hot)
            assert (j.barrier, j.interval, j.next_at) == \
                (t.barrier, t.interval, t.next_at)


def test_state_helpers_equal():
    rng = np.random.default_rng(5)
    psd = rng.choice([1e-9, 1e-3, 0.5, JSt.UNSEEN], size=(30, 1)) \
        .astype(np.float32)
    assert np.array_equal(JSt.init_psd(7, 1), TSt.init_psd(7, 1))
    assert np.array_equal(JSt.fold_subblock_psd(psd),
                          TSt.fold_subblock_psd(psd))
    assert JSt.converged(psd, 1e-6) == TSt.converged(psd, 1e-6)
    assert JSt.psd_threshold(psd[:, 0], 0.2) == \
        TSt.psd_threshold(psd[:, 0], 0.2)


def test_schedule_helpers_equal():
    for w in (1, 5, 8, 16, 100):
        ladder = JS.width_ladder(w, 2)
        assert ladder == TS.width_ladder(w, 2)
        for active in (0, 1, 3, 9, 200):
            assert JS.pick_width(ladder, active) == \
                TS.pick_width(ladder, active)
    pr = np.array([3.0, 1.0, 3.0, 7.0])
    assert np.array_equal(JS.admission_order(pr), TS.admission_order(pr))
    for args in ((4, 100, 1), (4, 100, 30), (0, 10, 3), (3, 7, 0)):
        assert JS.adaptive_i2(*args) == TS.adaptive_i2(*args)


def test_scheduler_picks_equal():
    rng = np.random.default_rng(6)
    for it in range(60):
        p = int(rng.integers(2, 40))
        psd = rng.choice([0.0, 1e-13, 0.5, 0.5, 1.0, JSt.UNSEEN],
                         size=p).astype(np.float32)
        is_hot = rng.random(p) < 0.4
        kw = dict(width=int(rng.integers(1, 12)), i2=int(rng.integers(0, 5)),
                  cold_frac=0.25, min_psd=1e-12)
        a = JS.Scheduler(**kw).select(it, psd, is_hot)
        b = TS.Scheduler(**kw).select(it, psd, is_hot)
        assert np.array_equal(a.hot_ids, b.hot_ids)
        assert np.array_equal(a.cold_ids, b.cold_ids)


def test_engine_helpers_equal():
    jg, tg = _pair("powerlaw")
    jp = JP.build_plan(jg, block_size=64)
    tp = TP.build_plan(tg, block_size=64)
    assert np.array_equal(JE.acct_table(jp, jp.unified.edges),
                          TE.acct_table(tp, tp.unified.edges))
    for adaptive in (True, False):
        jc = JE.EngineConfig(width=16, adaptive=adaptive)
        tc = TE.EngineConfig(width=16, adaptive=adaptive)
        assert np.array_equal(JE.inner_depths(jc, 16),
                              TE.inner_depths(tc, 16))
        ladder = JS.width_ladder(16, 2)
        for active in (1, 5, 20):
            for psd in (np.zeros(4, np.float32),
                        np.full(4, JSt.UNSEEN)):
                assert JE.dispatch_width(jc, ladder, active, psd) == \
                    TE.dispatch_width(tc, ladder, active, psd)
