"""The port's lane sweep (kernels 1l/1lm, plain version on the CPU) and
lane programs against the reference's dense lane processor.

Both run on the same state: the reference engine's EdgeData is handed to
the port through ``repro_torch.interop``. The bar:

* one lane sweep against ``make_lane_processor(..., use_pallas=False)``
  with the same values, vconst and (at S > 1) the same shared sub-block
  mask: k_sssp/k_bfs new values and per-lane max deltas bitwise, per-lane
  mean deltas bitwise for k_bfs (integer deltas) and at rtol=1e-6 for
  k_sssp (another float-sum order); k_ppr values within the roundoff of
  reordering a sum (2(k-1)·2^-24 relative for k in-edges), as PageRank's.
* a one-lane k_sssp/k_bfs sweep equals the single-lane sweep of sssp/bfs
  bitwise, deltas included (the CUDA kernels are held to the same on the
  card by chip_smoke.py).
* the lane kernel's order, re-enacted in numpy (``emulate_lane_kernel``:
  its tile chunks and carries, lane groups and warp chains), equals the
  plain version bitwise, sums included, at S = 1 and S > 1, and on the
  build-time layout, a streamed one and a hand-built hub of whole tiles at
  L = 1, 8 and 32, on a cold slate and a multi-pass one-slot chain.
* k_ppr's ``apply`` is XLA's fused form, bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import emulate_lane_kernel, hub_edge_data
from _torch_parity import window_edge_data
from _torch_parity import one_torch_thread  # noqa: F401
from _torch_parity import port_engine

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core import state as JSt
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import StructureAwareEngine as JEngine
from repro.core.engine import make_lane_processor as j_lane_processor
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import state as TSt
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StructureAwareEngine as TEngine
from repro_torch.core.engine import make_lane_processor, tile_coverage
from repro_torch.kernels import block_sweep as kb

C = 64
L = 4
HOST = {"sssp": "sssp", "bfs": "bfs", "ppr": "pagerank"}


def _pair(fam, s=1):
    """Reference and port engines over one graph; the host program's aux
    is the family's (out-degrees for PageRank and k_ppr)."""
    g = JG.powerlaw_graph(1200, 6, seed=11, weighted=fam == "sssp")
    jeng = JEngine(g, JA.REGISTRY[HOST[fam]](),
                   JConfig(block_size=C, width=4, subblocks=s))
    teng = port_engine(jeng, TA.REGISTRY[HOST[fam]](),
                       TConfig(block_size=C, width=4, subblocks=s))
    return jeng, teng


def _lane_state(fam, n_pad, rng, lanes=L):
    """Mid-run (n_pad, lanes) values and vconst: every kind of entry."""
    shape = (n_pad, lanes)
    if fam == "ppr":
        v = rng.uniform(0.0, 0.2, shape).astype(np.float32)
        vc = np.where(rng.random(shape) < 0.05,
                      rng.uniform(0.0, 1.0, shape), 0.0)
        return v, vc.astype(np.float32)
    v = np.where(rng.random(shape) < 0.4, JA.INF,
                 rng.uniform(0.0, 30.0, shape)).astype(np.float32)
    if fam == "bfs":
        v = np.where(v < JA.INF, np.floor(v), v).astype(np.float32)
    return v, np.zeros(shape, np.float32)


def _port_sweep(teng, fam, ed, values, vconst, psd, dmax, rows, ok,
                lane_done, depth, floor=None):
    prog = TA.LANE_FAMILIES[fam]()
    s = 1 if floor is None else teng.config.subblocks
    one, it = make_lane_processor(prog, C, teng.plan.n_live,
                                  teng.plan.graph.n, s,
                                  0.0 if floor is None else floor)
    sc = kb.make_lane_scratch(ed, C, values.shape[1])
    if depth == 1:
        one(ed, values, vconst, psd, dmax, rows, ok, lane_done, sc)
    else:
        it(ed, values, vconst, psd, dmax, rows, ok, lane_done, sc, depth)


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("fam", ["sssp", "bfs", "ppr"])
def test_lane_sweep_matches_dense(fam, s):
    jeng, teng = _pair(fam, s)
    plan = jeng.plan
    P, n_pad = plan.num_blocks, teng._values_len
    rng = np.random.default_rng(3)
    values, vconst = _lane_state(fam, n_pad, rng)
    jfam = JA.LANE_FAMILIES[fam]()
    j_one, j_iter, _ = j_lane_processor(
        jfam, plan.unified, C, plan.n_live, plan.graph.n, subblocks=s)
    j_one, j_iter = jax.jit(j_one), jax.jit(j_iter, static_argnums=4)
    floor = np.float32(teng._psd_floor())
    lane_done = np.array([False, True, False, False])
    kdeg = np.maximum(np.pad(plan.graph.in_deg, (0, n_pad - plan.graph.n)),
                      1)[:, None]
    same_new = 0
    for row in range(P):
        # a (S, L) psd row whose lane fold leaves some sub-ranges masked
        psd_row = np.where(rng.random((s, L)) < 0.5, 1.0,
                           floor / 2).astype(np.float32)
        sub_act = (np.where(lane_done, 0.0, psd_row).max(axis=-1) >= floor)
        for depth in (1, 3):
            args = (jeng._ed, jnp.asarray(values), jnp.asarray(vconst), row)
            sa = None if s == 1 else jnp.asarray(sub_act)
            _, jnew, jpsd, jdmax = (j_one(*args, sa) if depth == 1
                                    else j_iter(*args, depth, sa))
            jnew, jpsd, jdmax = (np.asarray(a) for a in (jnew, jpsd, jdmax))
            jpsd, jdmax = jpsd.reshape(s, L), jdmax.reshape(s, L)
            tv = torch.from_numpy(values.copy())
            psd = torch.full((P, s, L), -1.0)
            psd[row] = torch.from_numpy(psd_row)
            dmax = torch.full((P, s, L), -1.0)
            _port_sweep(teng, fam, teng._ed, tv, torch.from_numpy(vconst),
                        psd, dmax, torch.tensor([row], dtype=torch.int32),
                        torch.tensor([True]), torch.from_numpy(lane_done),
                        depth, None if s == 1 else floor)
            blk = slice(row * C, (row + 1) * C)
            got = tv.numpy()
            if fam == "ppr":
                tol = 2 * kdeg[blk] * 2.0 ** -24 * np.abs(jnew)
                assert np.all(np.abs(got[blk] - jnew) <= tol), (row, depth)
                same_new += int((got[blk] == jnew).sum())
            else:
                assert np.array_equal(got[blk], jnew), (row, depth)
            rest = np.ones(n_pad, bool)
            rest[blk] = False
            assert np.array_equal(got[rest], values[rest])
            # masked sub-ranges keep their psd/dmax in every lane
            act = sub_act if s > 1 else np.ones(1, bool)
            assert np.array_equal(psd[row][~act].numpy(), psd_row[~act])
            assert (dmax[row][~act] == -1.0).all()
            tp, td = psd[row][act].numpy(), dmax[row][act].numpy()
            if fam == "ppr":
                atol = float(tol.max())
                np.testing.assert_allclose(td, jdmax[act], rtol=1e-6,
                                           atol=atol)
                np.testing.assert_allclose(tp, jpsd[act], rtol=1e-6,
                                           atol=atol)
                continue
            assert np.array_equal(td, jdmax[act])
            if fam == "bfs":
                assert np.array_equal(tp, jpsd[act])
            else:
                np.testing.assert_allclose(tp, jpsd[act], rtol=1e-6, atol=0)
    if fam == "ppr":
        print(f"k_ppr S={s}: values bitwise on {same_new}/{2 * P * C * L}")


@pytest.mark.parametrize("fam", ["sssp", "bfs"])
def test_one_lane_sweep_is_the_single_lane_sweep(fam):
    """A one-lane k_sssp/k_bfs sweep is sssp/bfs's sweep, deltas included:
    a cold slate of every block and a 3-pass hot chain."""
    _, teng = _pair(fam)
    P, n_pad = teng.plan.num_blocks, teng._values_len
    values = _lane_state(fam, n_pad, np.random.default_rng(4))[0][:, :1]
    ed = teng._ed
    for rows, depth in ((torch.arange(P, dtype=torch.int32), 1),
                        (torch.tensor([2], dtype=torch.int32), 3)):
        ok = torch.ones(rows.numel(), dtype=torch.bool)
        lv = torch.from_numpy(values.copy())
        lp, ld = torch.zeros(P, 1, 1), torch.zeros(P, 1, 1)
        _port_sweep(teng, fam, ed, lv, torch.zeros_like(lv), lp, ld, rows,
                    ok, torch.zeros(1, dtype=torch.bool), depth)
        sv = torch.from_numpy(values[:, 0].copy())
        sp, sd = torch.zeros(P, 1), torch.zeros(P, 1)
        if depth == 1:
            teng._proc[0](ed, sv, sp, sd, rows, ok)
        else:
            teng._proc[1](ed, sv, sp, sd, rows, ok, depth)
        assert torch.equal(lv[:, 0], sv)
        assert torch.equal(lp.view(P, 1), sp) and torch.equal(
            ld.view(P, 1), sd)


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("fam", ["sssp", "ppr"])
def test_lane_kernel_order_matches_plain(fam, s):
    """The lane kernel's order, re-enacted in numpy from its fold metadata,
    equals the plain lane sweep bitwise (sums included) on a cold slate;
    at S > 1 with seeded masks and two lanes done."""
    _, teng = _pair(fam, s)
    P, n_pad = teng.plan.num_blocks, teng._values_len
    rng = np.random.default_rng(5)
    values, vconst = _lane_state(fam, n_pad, rng)
    floor = np.float32(teng._psd_floor()) if s > 1 else None
    psd0 = np.where(rng.random((P, s, L)) < 0.4, 1.0,
                    np.float32(teng._psd_floor()) / 2).astype(np.float32)
    lane_done = torch.tensor([True, False, True, False])
    rows = torch.from_numpy(rng.permutation(P).astype(np.int32))
    ok = torch.from_numpy(rng.random(P) < 0.8)
    prog = TA.LANE_FAMILIES[fam]()
    out = []
    for how in ("plain", "kernel order"):
        tv = torch.from_numpy(values.copy())
        psd = torch.from_numpy(psd0.copy())
        dmax = torch.full((P, s, L), -1.0)
        kw = dict(block_size=C, n_live=teng.plan.n_live, floor=floor)
        if how == "plain":
            kb.lane_block_sweep_ref(
                prog, teng.plan.graph.n, teng._ed, tv,
                torch.from_numpy(vconst), rows, ok, psd, dmax, lane_done,
                kb.make_lane_scratch(teng._ed, C, L), **kw)
        else:
            emulate_lane_kernel(prog, teng.plan.graph.n, teng._ed, tv,
                                torch.from_numpy(vconst), rows, ok, psd,
                                dmax, lane_done, **kw)
        out.append((tv, psd, dmax))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _layout(fam, s, layout):
    """(ed, block size, n_total, n_live) of one tile layout at S = ``s``:
    the port engine's build-time tiles of the family's host program (CSC
    order, every tile flagged sorted); the same tiles as a stream leaves
    them (each tile's slots shuffled, a fifth of them dead, coverage and
    run table rebuilt); blocks of 256 laid out so (tiles of up to 256
    runs, past a warp's window of 64); the hand-built hub
    (``hub_edge_data``: a destination of 1200 whole tiles, 1200 partials,
    beside a streamed block); or the hand-built tiles whose first chunk
    ends a round at the end of a warp's window of runs
    (``window_edge_data``, blocks of 512)."""
    rng = np.random.default_rng(17)
    if layout == "hub":
        return hub_edge_data(s, rng), C, 2 * C - 5, 2 * C - 5
    if layout == "window":
        return window_edge_data(s, rng), 512, 3 * 512, 3 * 512 - 7
    c = 256 if layout == "wide" else C
    g = TG.powerlaw_graph(1200 if c == C else 3000, 6, seed=11,
                          weighted=fam == "sssp")
    eng = TEngine(g, TA.REGISTRY[HOST[fam]](),
                  TConfig(block_size=c, width=4, subblocks=s), device="cpu")
    ed = eng.edge_state
    if layout != "build":
        perm = torch.from_numpy(np.argsort(rng.random(ed.src.shape), axis=1))
        src, dstl, w, valid = (torch.gather(t, 1, perm).contiguous()
                               for t in (ed.src, ed.dstl, ed.w, ed.valid))
        valid &= torch.from_numpy(rng.random(valid.shape) > 0.2)
        table = kb.fold_metadata(dstl, valid, ed.tile_start, ed.tile_cnt, c,
                                 ed.pspan.shape[0])
        ed = ed._replace(
            src=src, dstl=dstl, w=w, valid=valid,
            cov=torch.as_tensor(tile_coverage(dstl.numpy(), valid.numpy(),
                                              s, c)),
            **dict(zip(("rslot", "tinfo", "runs", "pspan"), table)))
        assert not (ed.tinfo & kb.TINFO_SORTED).any()
    if layout == "wide":
        assert ((ed.tinfo >> kb.TINFO_RUNS) & kb.TINFO_COUNT).max() > 64
    return ed, c, eng.plan.graph.n, eng.plan.n_live


@pytest.mark.parametrize("layout", ["build", "streamed", "wide", "window",
                                    "hub"])
@pytest.mark.parametrize("fam", ["sssp", "bfs", "ppr"])
@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_lane_kernel_order_on_layouts(lanes, s, fam, layout):
    """The lane kernel's order (``emulate_lane_kernel``: chunks of
    ``lane_shape``'s positions with their carries, lane groups, a warp's
    batched chain past LONG_SPAN partials) equals the plain lane sweep bit
    for bit, sums included: a cold slate of every block in a seeded order
    (a fifth not ok), then a 3-pass one-slot chain of the largest block; at
    S = 8 masked, with seeded psd rows and a third of the lanes done; on
    the build-time, streamed, wide (more runs in a tile than a warp's
    window holds), window (rounds that end at the window's end) and hub
    layouts."""
    ed, c, n_total, n_live = _layout(fam, s, layout)
    P, n_pad = ed.tile_cnt.numel(), ed.pspan.shape[0]
    prog = TA.LANE_FAMILIES[fam]()
    rng = np.random.default_rng(1000 * lanes + 10 * s + len(layout))
    values, vconst = _lane_state(fam, n_pad, rng, lanes)
    vconst = torch.from_numpy(vconst)
    floor = np.float32(1e-3) if s > 1 else None
    psd0 = np.where(rng.random((P, s, lanes)) < 0.4, 1.0, 1e-4).astype(
        np.float32)
    hub = int(np.argmax(ed.tile_cnt))
    psd0[hub, 0, 0] = 1.0  # the largest block's first sub-range is live
    done = torch.from_numpy(np.arange(lanes) % 3 == 1)  # lane 0 is not done
    rows = rng.permutation(P).astype(np.int32)
    ok = rng.random(P) < 0.8
    ok[rows == hub] = True
    changed = 0
    for r, k, depth in ((rows, ok, 1), ([hub], [True], 3)):
        r = torch.tensor(r, dtype=torch.int32)
        k = torch.tensor(k, dtype=torch.bool)
        out = []
        for how in ("plain", "kernel order"):
            tv = torch.from_numpy(values.copy())
            psd = torch.from_numpy(psd0.copy())
            dmax = torch.full((P, s, lanes), -1.0)
            sc = kb.make_lane_scratch(ed, c, lanes)
            old = torch.empty(c, lanes)
            for i in range(depth):
                kw = dict(block_size=c, n_live=n_live, floor=floor,
                          first=i == 0, last=i == depth - 1)
                args = (prog, n_total, ed, tv, vconst, r, k, psd, dmax, done)
                if how == "plain":
                    kb.lane_block_sweep_ref(*args, sc, **kw)
                else:
                    emulate_lane_kernel(*args, old, **kw)
            out.append((tv, psd, dmax))
        for a, b in zip(*out):
            assert torch.equal(a, b), (depth, lanes, s, fam, layout)
        changed += int((out[0][0] != torch.from_numpy(values)).sum())
    assert changed > 0


def test_ppr_apply_is_the_xla_fma():
    """k_ppr's apply equals the reference's under jit (XLA fuses it into
    fma(f32(1-d), vconst, f32(d*agg))) bitwise, on 32,768 entries."""
    rng = np.random.default_rng(6)
    agg = rng.uniform(0.0, 0.3, (4096, 8)).astype(np.float32)
    vc = np.where(rng.random((4096, 8)) < 0.3,
                  rng.uniform(0.0, 1.0, (4096, 8)), 0.0).astype(np.float32)
    old = np.zeros_like(agg)
    want = np.asarray(jax.jit(lambda o, a, v: JA.k_personalized_pagerank()
                              .apply(o, a, v, 100))(old, agg, vc))
    got = TA.k_personalized_pagerank().apply(
        torch.from_numpy(old), torch.from_numpy(agg), torch.from_numpy(vc),
        100).numpy()
    assert np.array_equal(got, want)
    d, omd = TA.k_personalized_pagerank().kernel_consts(100)
    assert (d, omd) == (float(np.float32(0.85)), float(np.float32(0.15)))
    split = (np.float32(omd) * vc + np.float32(d) * agg).astype(np.float32)
    print(f"separate multiply and add: {np.mean(split == want):.4f} equal")


def test_lane_programs_equal():
    n = 300
    for fam in ("sssp", "bfs"):
        jv, jc = JA.LANE_FAMILIES[fam]().lane_init(n, [0, 17, 299])
        tv, tc = TA.LANE_FAMILIES[fam]().lane_init(n, [0, 17, 299])
        assert np.array_equal(jv, tv) and jc is None and tc is None
    resets = [[3], [5, 5, 9], np.full(n, 1.0 / n, np.float32)]
    jv, jc = JA.k_personalized_pagerank().lane_init(n, resets)
    tv, tc = TA.k_personalized_pagerank().lane_init(n, resets)
    assert np.array_equal(jv, tv) and np.array_equal(jc, tc)
    deg = np.arange(n) % 7
    assert np.array_equal(JA.k_personalized_pagerank().aux_fn(deg, deg),
                          TA.k_personalized_pagerank().aux_fn(deg, deg))
    for fam in ("sssp", "bfs", "ppr"):
        j, t = JA.LANE_FAMILIES[fam](), TA.LANE_FAMILIES[fam]()
        assert (j.combine, j.monotone_cooling, j.uses_vconst,
                np.float32(j.identity)) == \
            (t.combine, t.monotone_cooling, t.uses_vconst,
             np.float32(t.identity))
    with pytest.raises(ValueError):
        TA.k_source_sssp().lane_init(n, [n])


def test_lane_state_helpers_equal():
    rng = np.random.default_rng(7)
    active = np.array([True, False, True, True])
    for s in (None, 3):
        assert np.array_equal(JSt.init_lane_psd(5, active, s),
                              TSt.init_lane_psd(5, active, s))
    done = np.array([False, True, False, True])
    for shape in ((6, 4), (6, 3, 4)):
        psd = rng.choice([0.0, 1e-12, 1e-3, 0.5, JSt.UNSEEN],
                         size=shape).astype(np.float32)
        tp, td = torch.from_numpy(psd), torch.from_numpy(done)
        jp, jd = jnp.asarray(psd), jnp.asarray(done)
        assert np.array_equal(JSt.fold_lane_psd(psd, done),
                              TSt.fold_lane_psd(psd, done))
        assert np.array_equal(np.asarray(JSt.fold_lane_psd_device(jp, jd)),
                              TSt.fold_lane_psd_device(tp, td).numpy())
        assert np.array_equal(np.asarray(JSt.lane_sub_psd_device(jp, jd)),
                              TSt.lane_sub_psd_device(tp, td).numpy())
        for t2 in (1e-6, 1.0, 1e31):
            assert np.array_equal(
                np.asarray(JSt.lane_converged_device(jp, t2)),
                TSt.lane_converged_device(tp, t2).numpy())


def test_lane_scratch_is_keyed_to_the_tiles():
    """A scratch serves any aux over the tiles it checked; other tiles (a
    preserved copy) or another lane count get a new one, reusing the
    buffers whose sizes fit."""
    _, teng = _pair("sssp")
    ed = teng._ed
    sc = kb.make_lane_scratch(ed, C, L)
    assert kb.make_lane_scratch(ed._replace(aux=ed.aux + 1.0), C, L,
                                reuse=sc) is sc
    copy = ed._replace(src=ed.src.clone())
    sc2 = kb.make_lane_scratch(copy, C, L, reuse=sc)
    assert sc2 is not sc and sc2.part is sc.part
    assert kb.make_lane_scratch(ed, C, 2, reuse=sc).lanes == 2
    with pytest.raises(ValueError):
        kb.make_lane_scratch(ed, C, kb.MAX_LANES + 1)


def test_lane_cuda_tensor_never_takes_plain_path(monkeypatch):
    """The lane wrappers dispatch on the tensor's device only: anything
    that is not on the CPU goes to the kernel (which raises here)."""
    called = []
    monkeypatch.setattr(kb, "lane_block_sweep_ref",
                        lambda *a, **k: called.append(1))
    _, teng = _pair("sssp")
    P = teng.plan.num_blocks
    meta = torch.empty(teng._values_len, L, device="meta")
    for sweep, kw in ((kb.lane_block_sweep, {}),
                      (kb.masked_lane_block_sweep, dict(floor=1e-9))):
        with pytest.raises(ValueError):
            sweep(TA.k_source_sssp(), 10, teng._ed, meta, meta,
                  torch.zeros(1, dtype=torch.int32),
                  torch.ones(1, dtype=torch.bool), torch.zeros(P, 1, L),
                  torch.zeros(P, 1, L), torch.zeros(L, dtype=torch.bool),
                  kb.make_lane_scratch(teng._ed, C, L), block_size=C,
                  n_live=1, **kw)
    assert not called
