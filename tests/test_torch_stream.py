"""The port's streaming engine (``repro_torch.stream``) against the
reference's, on the CPU through the plain versions of the sweeps.

Both ingest the same numpy-seeded ``synthetic_stream`` batches (inserts and
deletes) over the same graph. The bar, after every batch:

* SSSP/BFS/CC values bitwise equal to the reference's; PageRank at
  rtol=1e-4 (its sums differ by reordering roundoff; ROADMAP Queue 3).
* The batch report's storage and upload columns equal: dirty blocks and
  sub-blocks, appended/killed/rebuilt blocks, plan_rebuild, bytes_uploaded
  and bytes_full (the kernel's fold metadata is never billed). For the
  min/max programs the reconvergence counters (iterations, edges) are
  equal too; for PageRank they are printed beside the reference's.
* The warm values equal a cold run of the port on the mutated graph, to
  the same tolerances (the reference's own acceptance property).

On mutated layouts (appends at a watermark, holes left by kills, runs
rebuilt in bucket order) the plain sweep is held against a per-destination
oracle written independently of it, and the kernel's order (re-enacted in
numpy from its fold metadata, ``emulate_kernel``) against the plain
sweep, bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import emulate_kernel, one_torch_thread  # noqa: F401

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.stream import StreamingEngine as JStream
from repro.stream import synthetic_stream as j_stream
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StructureAwareEngine as TEngine
from repro_torch.kernels import block_sweep as kb
from repro_torch.stream import StreamConfig, StreamingEngine
from repro_torch.stream import synthetic_stream as t_stream
from repro_torch.stream.delta import apply_to_coo

KW = dict(t2=1e-9, width=4, block_size=128)
REPORT = ("inserts", "deletes", "dirty_blocks", "num_blocks",
          "appended_blocks", "killed_blocks", "rebuilt_blocks",
          "aux_bumped_blocks", "plan_rebuild", "vertices_reset",
          "bytes_uploaded", "bytes_full", "subblocks", "dirty_subblocks")
RUN = ("iterations", "edges_processed", "converged", "block_loads",
       "subblocks_retired", "mean_subblock_dispatch", "blocks_retired")


def _close(a, b, **kw):
    return np.allclose(np.minimum(a, 1e18), np.minimum(b, 1e18), **kw)


def _mutated(g, batches, upto):
    s, d, w = TG.edges_of(g)
    for b in batches[:upto]:
        s, d, w = apply_to_coo(s, d, w, g.n, b)
    return TG.from_edges(g.n, s, d, w)


def _pair(algo, n, seed, s, stream=StreamConfig()):
    w = algo == "sssp"
    jg = JG.powerlaw_graph(n, avg_deg=5, seed=seed, weighted=w)
    tg = TG.powerlaw_graph(n, avg_deg=5, seed=seed, weighted=w)
    cfg = dict(KW, subblocks=s)
    from repro.stream import StreamConfig as JStreamConfig
    js = JStream(jg, JA.REGISTRY[algo](), JConfig(**cfg),
                 JStreamConfig(**dataclasses.asdict(stream)))
    ts = StreamingEngine(tg, TA.REGISTRY[algo](), TConfig(**cfg), stream,
                         device="cpu")
    return jg, tg, js, ts


def _check_batch(algo, jr, tr, js, ts, label):
    rj = tuple(getattr(jr, f) for f in REPORT)
    rt = tuple(getattr(tr, f) for f in REPORT)
    assert rt == rj, (label, rj, rt)
    print(f"{label}: reference {[getattr(jr, f) for f in RUN]} "
          f"port {[getattr(tr, f) for f in RUN]}")
    assert tr.converged
    if algo == "pagerank":
        assert _close(ts.values, js.values, rtol=1e-4, atol=1e-7), label
    else:
        assert np.array_equal(ts.values, js.values), label
        assert [getattr(tr, f) for f in RUN] == \
            [getattr(jr, f) for f in RUN], label


@given(seed=st.integers(0, 20), s=st.sampled_from([2, 4]),
       algo=st.sampled_from(["pagerank", "sssp", "bfs", "cc"]))
@settings(max_examples=4, deadline=None, database=None)
def test_stream_matches_reference_property(seed, s, algo):
    n = 900
    jg, tg, js, ts = _pair(algo, n, seed, s)
    batches = t_stream(tg, 3, 40, seed=seed + 1, delete_frac=0.3,
                       weighted=algo == "sssp")
    jbatches = j_stream(jg, 3, 40, seed=seed + 1, delete_frac=0.3,
                        weighted=algo == "sssp")
    for i, (jb, tb) in enumerate(zip(jbatches, batches)):
        _check_batch(algo, js.ingest(jb), ts.ingest(tb), js, ts,
                     f"{algo} S={s} seed={seed} batch {i}")
        cold = TEngine(_mutated(tg, batches, i + 1), TA.REGISTRY[algo](),
                       TConfig(**KW, subblocks=s), device="cpu").run()
        assert cold.metrics.converged
        tol = dict(rtol=1e-4, atol=1e-5) if algo == "pagerank" else {}
        assert _close(ts.values, cold.values, **tol), (algo, i)


def test_warm_after_ingest_with_deletes_subblocks():
    """Sub-block re-heat over a mutating stream (inserts + deletes) matches
    the flat tracker's fixpoint and a cold recompute, arming no more
    sub-blocks than S x dirty blocks and at least one per dirty block
    (the reference's test of the same name, on the port)."""
    g = TG.powerlaw_graph(900, avg_deg=5, seed=3, weighted=True)
    batches = t_stream(g, 3, 40, seed=11, delete_frac=0.4, weighted=True)
    cfg = TConfig(**KW)
    se4 = StreamingEngine(g, TA.pagerank(),
                          dataclasses.replace(cfg, subblocks=4), device="cpu")
    se1 = StreamingEngine(g, TA.pagerank(), cfg, device="cpu")
    cold = StreamingEngine(g, TA.pagerank(), cfg, StreamConfig(warm=False),
                           device="cpu")
    for b in batches:
        r4, r1 = se4.ingest(b), se1.ingest(b)
        cold.ingest(b)
        assert r4.subblocks == 4 and r1.subblocks == 1
        assert r4.dirty_blocks == r1.dirty_blocks
        assert r1.dirty_blocks <= r4.dirty_subblocks <= 4 * r4.dirty_blocks
        assert r4.converged and r1.converged
    assert _close(se4.values, se1.values, rtol=1e-4, atol=1e-5)
    assert _close(se4.values, cold.values, rtol=1e-4, atol=1e-5)
    m = se4.metrics
    assert m.batches == 3 and m.subblocks_seen == 3 * 4 * r4.num_blocks


def test_overflow_rebuilds_the_plan_like_the_reference():
    """A burst that outgrows a block's slack forces a full plan rebuild in
    both packages, with the same report and bitwise values (CC)."""
    stream = StreamConfig(tile_slack=0.0, spare_tiles=0)
    jg, tg, js, ts = _pair("cc", 600, 2, 2, stream)
    batch = t_stream(tg, 1, 600, seed=4, hotspot_prob=1.0,
                     hotspot_frac=0.9)[0]
    jbatch = j_stream(jg, 1, 600, seed=4, hotspot_prob=1.0,
                      hotspot_frac=0.9)[0]
    jr, tr = js.ingest(jbatch), ts.ingest(batch)
    assert tr.plan_rebuild and jr.plan_rebuild
    _check_batch("cc", jr, tr, js, ts, "cc overflow")
    assert ts.metrics.plan_rebuilds == 1


def _oracle(program, ed, values, row, c, n_total):
    """Per-destination oracle: walk the block's tiles in order and each
    tile's slots in order, keeping one partial per destination per tile
    (identity-started), then combine a destination's partials in tile
    order. Returns the new (C,) values before apply, i.e. agg."""
    ident = np.float32(program.identity)
    merge = {"sum": lambda a, b: np.float32(a + b), "min": min,
             "max": max}[program.combine]
    t0, tc = int(ed.tile_start[row]), int(ed.tile_cnt[row])
    agg = [ident] * c
    for t in range(t0, t0 + tc):
        partial = {}
        for j in range(kb.TILE):
            if not ed.valid[t, j]:
                continue
            s = int(ed.src[t, j])
            m = program.edge_map(values[s:s + 1], ed.aux[s:s + 1],
                                 ed.w[t, j:j + 1]).item()
            d = int(ed.dstl[t, j])
            partial[d] = merge(partial.get(d, ident), np.float32(m))
        for d, p in partial.items():
            agg[d] = merge(agg[d], p)
    return torch.from_numpy(np.array(agg, np.float32))


@pytest.mark.parametrize("algo,s", [("pagerank", 4), ("cc", 2)])
def test_sweeps_on_mutated_layouts(algo, s):
    """After ingests with deletes (PageRank: appends + kill holes; CC:
    runs rebuilt in bucket order), every block's one-pass plain sweep
    equals the per-destination oracle (bitwise: the oracle adds in the same
    order), the kernel's re-enacted order equals the plain sweep bitwise,
    masked and unmasked, and the run table the commits refreshed equals
    one derived afresh from the mutated tiles."""
    g = TG.powerlaw_graph(900, avg_deg=5, seed=7)
    se = StreamingEngine(g, TA.REGISTRY[algo](), TConfig(**KW, subblocks=s),
                         device="cpu")
    reports = [se.ingest(b) for b in t_stream(g, 3, 60, seed=9,
                                              delete_frac=0.4)]
    if algo == "cc":
        assert sum(r.rebuilt_blocks for r in reports) > 0
    else:
        assert sum(r.appended_blocks for r in reports) > 0
        assert sum(r.killed_blocks for r in reports) > 0
    eng = se.engine
    ed, c, P = eng.edge_state, eng.plan.block_size, eng.plan.num_blocks
    fresh = kb.fold_metadata(ed.dstl, ed.valid, ed.tile_start, ed.tile_cnt,
                             c, eng._values_len)
    for got, want in zip((ed.rslot, ed.tinfo, ed.runs, ed.pspan), fresh):
        assert torch.equal(got, want)
    rng = np.random.default_rng(3)
    values = torch.from_numpy(rng.uniform(0.0, 1e-3, eng._values_len)
                              .astype(np.float32))
    n_total = eng.plan.graph.n
    args = dict(block_size=c, n_live=eng.plan.n_live)
    scratch = kb.make_scratch(ed, c)
    for row in range(P):
        rows = torch.tensor([row], dtype=torch.int32)
        ok = torch.tensor([True])
        tv = values.clone()
        kb.block_sweep_ref(eng.program, n_total, ed, tv, rows, ok,
                           torch.zeros(P, 1), torch.zeros(P, 1),
                           scratch, **args)
        agg = _oracle(eng.program, ed, values, row, c, n_total)
        blk = slice(row * c, (row + 1) * c)
        live = torch.arange(row * c, (row + 1) * c) < eng.plan.n_live
        want = torch.where(live, eng.program.apply(values[blk], agg,
                                                   n_total), values[blk])
        assert torch.equal(tv[blk], want), row
    floor = np.float32(eng._psd_floor())
    for masked in (False, True):
        nsub = s if masked else 1
        psd0 = np.where(rng.random((P, nsub)) < 0.7, 1.0, floor / 2)
        out = []
        for sweep in ("plain", "kernel order"):
            tv = values.clone()
            psd = torch.from_numpy(psd0.astype(np.float32))
            dmax = torch.full((P, nsub), -1.0)
            rows = torch.arange(P, dtype=torch.int32)
            ok = torch.ones(P, dtype=torch.bool)
            kw = dict(args, floor=floor if masked else None)
            if sweep == "plain":
                kb.block_sweep_ref(eng.program, n_total, ed, tv, rows, ok,
                                   psd, dmax, scratch, **kw)
            else:
                emulate_kernel(eng.program, n_total, ed, tv, rows, ok, psd,
                               dmax, **kw)
            out.append((tv, psd, dmax))
        for a, b in zip(*out):
            assert torch.equal(a, b), (algo, masked)


@pytest.mark.parametrize("ooc", [False, True], ids=["resident", "ooc"])
def test_streaming_graph_example_on_cpu(capsys, tmp_path, ooc):
    """The demo as a user runs it; ``ooc`` adds ``--resident-blocks`` (a
    budget under the demo's P) and ``--snapshot-dir`` (save, restore and
    warm-reconverge)."""
    from repro_torch import streaming_graph
    if not ooc:
        streaming_graph.main(["--n", "2000", "--batches", "2",
                              "--batch-size", "30", "--subblocks", "4",
                              "--device", "cpu"])
        out = capsys.readouterr().out
        assert "warm == cold" in out and "sub-block dirty" in out
        return
    streaming_graph.main(["--n", "12000", "--batches", "2", "--batch-size",
                          "60", "--resident-blocks", "18", "--snapshot-dir",
                          str(tmp_path / "epoch"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warm == cold" in out and "out-of-core: 18/24" in out
    assert "epoch persistence: saved epoch 2" in out


@pytest.mark.parametrize("algo", ["pagerank", "sssp"])
def test_interop_after_ingests_matches_dense(algo):
    """A reference engine's LIVE state after ingests with deletes (mutated
    tiles, S = 2) becomes the port's through ``engine_from_arrays``; one
    masked sweep of every block then matches the reference's dense
    processor on the same tiles and masks (SSSP bitwise; PageRank within
    the reordering roundoff, 2(k-1)·2^-24 relative for k in-edges)."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import port_engine

    from repro.core.engine import make_tiled_processor as j_processor
    jg, tg, js, ts = _pair(algo, 900, 5, 2)
    for b in j_stream(jg, 2, 60, seed=8, delete_frac=0.4,
                      weighted=algo == "sssp"):
        js.ingest(b)
    jeng = js.engine
    teng = port_engine(jeng, TA.REGISTRY[algo](), TConfig(**KW, subblocks=2))
    plan, c = jeng.plan, KW["block_size"]
    one = jax.jit(j_processor(jeng.program, plan.unified, c, plan.n_live,
                              plan.graph.n, False, subblocks=2)[0])
    rng = np.random.default_rng(4)
    values = rng.uniform(0.0, 1e-3, teng._values_len).astype(np.float32)
    ed = jeng.edge_state
    kdeg = np.bincount(
        (np.repeat(np.arange(plan.num_blocks), plan.unified.tile_cnt)[:, None]
         * c + np.asarray(ed.dstl))[np.asarray(ed.valid)],
        minlength=teng._values_len)
    for row in range(plan.num_blocks):
        act = np.array([True, rng.random() < 0.5])
        _, jnew, _, _ = one(ed, jnp.asarray(values), row, jnp.asarray(act))
        jnew = np.asarray(jnew)
        tv = torch.from_numpy(values.copy())
        P = plan.num_blocks
        psd = torch.from_numpy(np.where(act, 1.0, 0.0).astype(np.float32)
                               ).repeat(P, 1)
        teng._proc[0](teng._ed, tv, psd, torch.zeros(P, 2),
                      torch.tensor([row], dtype=torch.int32),
                      torch.tensor([True]))
        got = tv.numpy()[row * c:(row + 1) * c]
        if algo == "pagerank":
            tol = 2 * np.maximum(kdeg[row * c:(row + 1) * c], 1) \
                * 2.0 ** -24 * np.abs(jnew)
            assert np.all(np.abs(got - jnew) <= tol), row
        else:
            assert np.array_equal(got, jnew), row


def test_stream_records_match_reference_fields():
    import repro.core.metrics as JM
    import repro.stream.engine as JSE
    from repro_torch.core import metrics as TM
    from repro_torch.stream import engine as TSE
    for j, t in ((JM.StreamMetrics, TM.StreamMetrics),
                 (JSE.StreamBatchReport, TSE.StreamBatchReport),
                 (JSE.StreamConfig, TSE.StreamConfig)):
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)]
        props = sorted(k for k, v in vars(j).items()
                       if isinstance(v, property))
        assert props == sorted(k for k, v in vars(t).items()
                               if isinstance(v, property))


def test_host_loop_stream_matches_reference():
    """``run(fused=False, warm=...)``: both packages' streaming engines on
    their host-driven loops, SSSP at S = 2, bitwise values and equal
    reports after every batch with deletes."""
    from repro.stream import StreamConfig as JStreamConfig
    cfg = dict(KW, subblocks=2, fused=False)
    jg = JG.powerlaw_graph(700, avg_deg=5, seed=6, weighted=True)
    tg = TG.powerlaw_graph(700, avg_deg=5, seed=6, weighted=True)
    js = JStream(jg, JA.sssp(), JConfig(**cfg), JStreamConfig())
    ts = StreamingEngine(tg, TA.sssp(), TConfig(**cfg), device="cpu")
    for jb, tb in zip(j_stream(jg, 2, 40, seed=2, delete_frac=0.3,
                               weighted=True),
                      t_stream(tg, 2, 40, seed=2, delete_frac=0.3,
                               weighted=True)):
        _check_batch("sssp", js.ingest(jb), ts.ingest(tb), js, ts,
                     "sssp host loop")
