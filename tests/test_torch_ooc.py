"""The port's out-of-core block tier and epoch persistence
(``repro_torch.ooc``) on the CPU, against a fully resident port run and
against the reference's ``repro.ooc``. Mirrors tests/test_ooc.py.

The bar:

* Residency never changes the computation: a run under a budget
  (``resident_blocks < P``) is bitwise the fully resident run in values and
  every algorithmic counter, on both loops, at S = 1 and S = 4, and across
  warm streaming batches with deletes. Only the spill counters differ.
* Against the reference, both under a budget: SSSP and CC values, counters
  and the five spill counters equal (identical PSD gives identical
  residency decisions); PageRank values at rtol=1e-4, atol=1e-7 (its sums
  differ by reordering roundoff, ROADMAP Queue 3) and the share of spill
  counters that agree printed, not held.
* Evict then fetch leaves all twelve EdgeData fields, the run table
  included, bitwise a never-evicted engine's; a pin taken under spill has
  no holes and the resident run table, while the live state keeps its
  holes.
* The budget is real, the disk tier round-trips, epochs save and restore
  (bitwise without verification, warm with it) and cross between the two
  packages in both directions, and pinned epochs survive eviction.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import one_torch_thread  # noqa: F401

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import StructureAwareEngine as JEngine
from repro.ooc import prefetch as j_policy
from repro.stream import StreamingEngine as JStream
from repro.stream import synthetic_stream as j_stream
from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core import state as state_lib
from repro_torch.core.engine import (TIMELINE_INT_COLS, EngineConfig,
                                     StructureAwareEngine)
from repro_torch.core.schedule import (Selection, make_device_select,
                                       schedule_predictor)
from repro_torch.kernels import block_sweep as kb
from repro_torch.obs import trace as obs_trace
from repro_torch.ooc import prefetch as policy
from repro_torch.ooc.snapshot import GraphCheckpoint
from repro_torch.ooc.store import SpillStore
from repro_torch.stream import DeltaBatch, StreamingEngine, synthetic_stream

CFG = EngineConfig(t2=1e-9, width=4, block_size=128)
JCFG = JConfig(t2=1e-9, width=4, block_size=128)
PROGS = {"pagerank": A.pagerank, "sssp": lambda: A.sssp(0), "cc": A.cc}
J_PROGS = {"pagerank": JA.pagerank, "sssp": lambda: JA.sssp(0), "cc": JA.cc}
SPILL = ("spill_evictions", "bytes_spilled", "prefetch_hits",
         "prefetch_misses", "bytes_fetched")
# counters that may differ between budget and resident runs: the spill
# tier's own traffic, and the wall clock
SPILL_FIELDS = SPILL + ("prefetch_hit_rate", "wall_time_s")


def _cfg(cfg=CFG, **kw):
    return dataclasses.replace(cfg, **kw)


def _eng(g, prog, budget=None, **kw):
    return StructureAwareEngine(g, PROGS[prog](),
                                _cfg(resident_blocks=budget, **kw),
                                device="cpu")


def _same_trajectory(full, budget):
    assert np.array_equal(full.values, budget.values)
    a, b = full.metrics.as_dict(), budget.metrics.as_dict()
    for k in a:
        if k not in SPILL_FIELDS:
            assert a[k] == b[k], f"counter {k}: {a[k]} != {b[k]}"


def _graph(mod, n=1500, seed=3, weighted=True):
    return mod.powerlaw_graph(n, avg_deg=6, seed=seed, weighted=weighted)


# -- residency never changes the computation ---------------------------------
@pytest.mark.parametrize("prog,budget,fused,s", [
    ("pagerank", 6, True, 1), ("pagerank", 9, False, 1),
    ("pagerank", 7, True, 4), ("sssp", 7, True, 1), ("sssp", 10, False, 4),
    ("sssp", 6, True, 4), ("cc", 8, True, 1), ("cc", 6, False, 1),
    ("cc", 9, True, 4)])
def test_budget_run_bitwise_identical(prog, budget, fused, s):
    g = _graph(G)
    full = _eng(g, prog, subblocks=s)
    assert full.plan.num_blocks > budget  # the budget binds
    eng = _eng(g, prog, budget, subblocks=s)
    _same_trajectory(full.run(fused=fused), eng.run(fused=fused))
    assert eng.spill.spilled_blocks.size > 0  # it really ran out of core
    # ... and the run ended with the store's holes really on the device
    valid = eng.edge_state.valid.sum().item()
    assert valid < full.edge_state.valid.sum().item()


@pytest.mark.parametrize("prog", ["sssp", "cc", "pagerank"])
def test_budget_run_matches_reference(prog):
    """Both packages under the same budget. The port's engine is built on
    its own (never from the reference's state, whose rows have holes after
    a budget run)."""
    budget = 7
    jr = JEngine(_graph(JG), J_PROGS[prog](),
                 dataclasses.replace(JCFG, resident_blocks=budget)).run()
    tr = _eng(_graph(G), prog, budget).run()
    jm, tm = jr.metrics.as_dict(), tr.metrics.as_dict()
    if prog == "pagerank":
        assert np.allclose(tr.values, jr.values, rtol=1e-4, atol=1e-7)
        agree = [k for k in SPILL if jm[k] == tm[k]]
        print(f"pagerank spill counters agreeing: {len(agree)}/{len(SPILL)}"
              f" {agree}; reference {[jm[k] for k in SPILL]} port "
              f"{[tm[k] for k in SPILL]}")
        return
    assert np.array_equal(tr.values, jr.values)
    for k in jm:
        if k != "wall_time_s":
            assert jm[k] == tm[k], f"{k}: {jm[k]} != {tm[k]}"
    assert tm["spill_evictions"] > 0


def test_evict_fetch_restores_every_field():
    """The run-table test: blocks evicted (their rows zeroed, their run
    table emptied) and fetched back leave all twelve EdgeData fields bitwise
    those of an engine that never evicted."""
    g = _graph(G)
    ref = _eng(g, "sssp")
    eng = _eng(g, "sssp", 8)
    spill, P = eng.spill, eng.plan.num_blocks
    blocks = np.array([b for b in range(1, P) if b != eng.pad_id][:5])
    spill.evict(blocks)
    assert not spill.resident[blocks].any() and spill.spill_evictions == 5
    ed, c = eng.edge_state, eng.plan.block_size
    rows = np.concatenate([spill.block_rows(int(b)) for b in blocks])
    r = torch.as_tensor(rows)
    assert not ed.valid[r].any() and not ed.src[r].any()
    # no valid slots and no runs: an empty tile is flagged sorted
    assert bool((ed.tinfo[r] == kb.TINFO_SORTED).all())
    verts = torch.as_tensor((blocks[:, None] * c + np.arange(c)).ravel())
    assert torch.equal(ed.pspan[verts, 0], ed.pspan[verts, 1])
    spill.fetch(blocks)
    assert spill.resident.all() and spill.bytes_fetched > 0
    for f, a, b in zip(ed._fields, eng.edge_state, ref.edge_state):
        assert torch.equal(a, b), f


def test_pin_under_spill_is_whole():
    """A pin taken while blocks are spilled is preserved at once with no
    holes and the resident engine's run table; the live state keeps its
    holes."""
    g = _graph(G, 900, 7)
    full = StreamingEngine(g, A.sssp(0), CFG, device="cpu")
    se = StreamingEngine(g, A.sssp(0), _cfg(resident_blocks=7),
                         device="cpu")
    assert se.engine.spill.spilled_blocks.size > 0
    es = se.snapshot()
    assert es.preserved and se.metrics.snapshots_preserved == 1
    for f, a, b in zip(es.ed._fields, es.ed, full.engine.edge_state):
        assert torch.equal(a, b), f
    live = se.engine.edge_state
    assert int(live.valid.sum()) < int(es.ed.valid.sum()) == \
        int(se.engine.edge_counts.sum())


# -- the budget is enforced ----------------------------------------------------
def test_residency_budget_enforced():
    eng = _eng(_graph(G, weighted=False), "pagerank", 7)
    res = eng.run()
    spill, m = eng.spill, res.metrics
    assert m.converged and int(spill.resident.sum()) <= 7
    assert m.spill_evictions > 0
    assert m.bytes_spilled > 0 and m.bytes_fetched > 0
    # pinned blocks (the host loop's pad block 0, the fused pad block)
    assert spill.resident[0] and spill.resident[eng.pad_id]
    total = m.prefetch_hits + m.prefetch_misses
    assert total > 0 and m.prefetch_hit_rate == m.prefetch_hits / total


def test_budget_too_small_rejected():
    with pytest.raises(ValueError, match="resident_blocks"):
        _eng(_graph(G, weighted=False), "pagerank", CFG.width + 1)


def test_disk_tier_roundtrip(tmp_path):
    """spill_dir (so keep_host is False): payloads survive evict -> npz segment ->
    fetch with no host cache and the run stays bitwise."""
    g = _graph(G)
    full = _eng(g, "pagerank").run()
    eng = _eng(g, "pagerank", 7, spill_dir=str(tmp_path))
    assert isinstance(eng.spill, SpillStore) and not eng.spill.keep_host
    _same_trajectory(full, eng.run())
    eng.spill.wait()
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path))


def test_close_drains_and_stops_the_segment_writer(tmp_path):
    """close() writes every queued segment and ends the writer's thread; a
    closed store still reads its segments, and a later eviction raises."""
    g = _graph(G)
    full = _eng(g, "pagerank")
    eng = _eng(g, "pagerank", 7, spill_dir=str(tmp_path))
    eng.run()
    spilled = eng.spill.spilled_blocks
    assert spilled.size > 0
    eng.spill.close()
    eng.spill.close()  # idempotent
    assert not eng.spill._writer._thread.is_alive()
    names = set(os.listdir(tmp_path))
    assert {f"blk_{b:06d}.npz" for b in spilled.tolist()} <= names
    assert not any(".tmp" in n for n in names)
    snap, ref = eng.edge_snapshot(), full.edge_state
    for f in snap._fields:  # filled from the closed store's segments
        assert torch.equal(getattr(snap, f), getattr(ref, f)), f
    with pytest.raises(RuntimeError, match="closed"):
        eng.spill.evict(np.flatnonzero(eng.spill.resident
                                       & ~eng.spill.pinned)[:1])


def test_epoch_rebuild_closes_the_old_store(tmp_path):
    """An overflow batch replaces the engine: the old store's writer is
    drained and stopped before the new store writes to the same
    directory, and the stream stays bitwise its resident twin."""
    from repro_torch.stream import StreamConfig
    stream = StreamConfig(tile_slack=0.0, spare_tiles=0)
    g = _graph(G, weighted=False)
    full = StreamingEngine(g, A.cc(), CFG, stream, device="cpu")
    se = StreamingEngine(g, A.cc(), _cfg(resident_blocks=6,
                                         spill_dir=str(tmp_path)),
                         stream, device="cpu")
    old = se.engine.spill
    assert old is not None and old.spilled_blocks.size > 0
    batch = synthetic_stream(g, 1, 600, seed=4, hotspot_prob=1.0,
                             hotspot_frac=0.9)[0]
    rf, rb = full.ingest(batch), se.ingest(batch)
    assert rb.plan_rebuild and rf.plan_rebuild
    assert se.engine.spill is not old
    assert not old._writer._thread.is_alive()
    assert se.engine.spill._writer._thread.is_alive()
    assert np.array_equal(full.values, se.values)
    se.engine.spill.close()


@pytest.mark.parametrize("s", [1, 4])
def test_budget_warm_stream_bitwise_identical(s):
    """Warm streaming reconvergence (inserts and deletes, non-monotone
    re-heats included) under a budget: bitwise the resident stream batch
    for batch, and the reference's budget stream for SSSP."""
    cfg = _cfg(subblocks=s)
    g = G.powerlaw_graph(1200, avg_deg=5, seed=11, weighted=True)
    jg = JG.powerlaw_graph(1200, avg_deg=5, seed=11, weighted=True)
    full = StreamingEngine(g, A.sssp(0), cfg, device="cpu")
    budget = StreamingEngine(g, A.sssp(0), _cfg(cfg, resident_blocks=7),
                             device="cpu")
    ref = JStream(jg, JA.sssp(0), dataclasses.replace(
        JCFG, subblocks=s, resident_blocks=7))
    assert np.array_equal(full.values, budget.values)
    assert np.array_equal(ref.values, budget.values)
    fields = ("iterations", "edges_processed", "dirty_blocks",
              "vertices_reset", "converged", "blocks_retired",
              "mean_dispatch_width", "dirty_subblocks")
    for tb, jb in zip(synthetic_stream(g, 3, 60, seed=5, weighted=True,
                                       delete_frac=0.3),
                      j_stream(jg, 3, 60, seed=5, weighted=True,
                               delete_frac=0.3)):
        rf, rb, rj = full.ingest(tb), budget.ingest(tb), ref.ingest(jb)
        assert np.array_equal(full.values, budget.values)
        assert np.array_equal(ref.values, budget.values)
        for f in fields:
            assert getattr(rf, f) == getattr(rb, f) == getattr(rj, f), f
        for f in SPILL:
            assert getattr(rb, f) == getattr(rj, f), f
    assert budget.metrics.spill_evictions > 0
    assert 0.0 <= budget.metrics.prefetch_hit_rate <= 1.0


# -- epoch persistence ---------------------------------------------------------
def test_save_restore_fixpoint_roundtrip(tmp_path):
    g = G.powerlaw_graph(1200, avg_deg=5, seed=11, weighted=True)
    se = StreamingEngine(g, A.pagerank(), CFG, device="cpu")
    for batch in synthetic_stream(g, 2, 50, seed=5, weighted=True):
        se.ingest(batch)
    se.save_epoch(str(tmp_path / "ck")).wait()
    raw = StreamingEngine.restore(str(tmp_path / "ck"), A.pagerank(), CFG,
                                  verify=False, device="cpu")
    assert np.array_equal(raw.values, se.values)
    assert raw.epoch == se.epoch and raw.n == se.n
    warm = StreamingEngine.restore(str(tmp_path / "ck"), A.pagerank(), CFG,
                                   device="cpu")
    assert warm.initial_result.metrics.converged
    assert np.allclose(warm.values, se.values, atol=1e-6)
    cold = StructureAwareEngine(se.current_graph(), A.pagerank(), CFG,
                                device="cpu").run()
    warm_it = warm.initial_result.metrics.iterations
    assert warm_it < cold.metrics.iterations / 2, \
        f"warm restart took {warm_it} vs cold {cold.metrics.iterations}"
    # the restored engine keeps ingesting
    assert warm.ingest(DeltaBatch.of(ins=[(1, 2), (3, 4)], dels=[])).converged


@pytest.mark.parametrize("written_under_budget", [True, False])
def test_restore_across_budgets(tmp_path, written_under_budget):
    """A checkpoint written under a budget restores fully resident, and the
    other way round: persistence is independent of residency."""
    g = G.powerlaw_graph(1200, avg_deg=5, seed=11, weighted=True)
    cfg_b = _cfg(resident_blocks=7)
    write, read = (cfg_b, CFG) if written_under_budget else (CFG, cfg_b)
    se = StreamingEngine(g, A.sssp(0), write, device="cpu")
    se.ingest(synthetic_stream(g, 1, 40, seed=6, weighted=True)[0])
    se.save_epoch(str(tmp_path / "ck")).wait()
    raw = StreamingEngine.restore(str(tmp_path / "ck"), A.sssp(0), read,
                                  verify=False, device="cpu")
    back = StreamingEngine.restore(str(tmp_path / "ck"), A.sssp(0), read,
                                   device="cpu")
    assert np.array_equal(raw.values, se.values)
    assert np.array_equal(back.values, se.values)
    assert (back.engine.spill is not None) == (read is cfg_b)


def test_checkpoint_edges_tuple_roundtrip(tmp_path):
    g = G.powerlaw_graph(800, avg_deg=4, seed=2, weighted=True)
    se = StreamingEngine(g, A.pagerank(), CFG, device="cpu")
    se.save_epoch(str(tmp_path / "ck")).wait()
    tree, meta = GraphCheckpoint(str(tmp_path / "ck")).load()
    assert isinstance(tree["edges"], tuple) and len(tree["edges"]) == 3
    src, dst, w = tree["edges"]
    assert src.dtype == np.int64 and dst.dtype == np.int64
    assert w.dtype == np.float32
    assert meta["n"] == g.n and meta["format"] == "graph-epoch-v1"
    gs, gd, _ = G.edges_of(se.current_graph())
    order, gorder = np.lexsort((dst, src)), np.lexsort((gd, gs))
    assert np.array_equal(src[order], gs[gorder])
    assert np.array_equal(dst[order], gd[gorder])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_epoch_crosses_packages(tmp_path, writer):
    """An epoch written by either package restores in the other: values
    bitwise, the same epoch and n, the same tree keys; SSSP's verified
    restores agree bitwise, iterations included."""
    from repro.ooc.snapshot import GraphCheckpoint as JCheckpoint
    jg = JG.powerlaw_graph(1000, avg_deg=5, seed=9, weighted=True)
    g = G.powerlaw_graph(1000, avg_deg=5, seed=9, weighted=True)
    path = str(tmp_path / "ck")
    if writer == "reference":
        src = JStream(jg, JA.sssp(0), JCFG)
        src.ingest(j_stream(jg, 1, 40, seed=3, weighted=True,
                            delete_frac=0.2)[0])
    else:
        src = StreamingEngine(g, A.sssp(0), CFG, device="cpu")
        src.ingest(synthetic_stream(g, 1, 40, seed=3, weighted=True,
                                    delete_frac=0.2)[0])
    src.save_epoch(path).wait()
    jtree, jmeta = JCheckpoint(path).load()
    ttree, tmeta = GraphCheckpoint(path).load()
    assert sorted(jmeta["keys"]) == sorted(tmeta["keys"])
    assert isinstance(ttree["edges"], tuple)
    for a, b in zip(jtree["edges"], ttree["edges"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    t_raw = StreamingEngine.restore(path, A.sssp(0), CFG, verify=False,
                                    device="cpu")
    j_raw = JStream.restore(path, JA.sssp(0), JCFG, verify=False)
    for back in (t_raw, j_raw):
        assert np.array_equal(back.values, src.values)
        assert back.epoch == src.epoch and back.n == src.n
    t_warm = StreamingEngine.restore(path, A.sssp(0), CFG, device="cpu")
    j_warm = JStream.restore(path, JA.sssp(0), JCFG)
    assert np.array_equal(t_warm.values, j_warm.values)
    assert np.array_equal(t_warm.values, src.values)
    assert t_warm.initial_result.metrics.iterations == \
        j_warm.initial_result.metrics.iterations


# -- pinned epochs survive eviction ------------------------------------------
def test_pinned_epoch_survives_eviction():
    from repro_torch.serve import Query, QueryService
    g = G.powerlaw_graph(900, avg_deg=5, seed=7, weighted=True)
    se = StreamingEngine(g, A.sssp(0), _cfg(resident_blocks=7),
                         device="cpu")
    assert se.initial_result.metrics.spill_evictions > 0
    svc = QueryService(se, max_lanes=1)
    qid = svc.submit(Query(kind="sssp", source=3))
    # the pin is taken while blocks are spilled: already a whole copy
    es = svc._pending[0].epoch_state
    assert es.preserved
    assert int(es.ed.valid.sum()) == int(se.engine.edge_counts.sum())
    frozen = se.current_graph()
    se.ingest(synthetic_stream(g, 1, 80, seed=9, weighted=True,
                               delete_frac=0.3)[0])
    r = [x for x in svc.run_pending() if x.query_id == qid][0]
    ref = StructureAwareEngine(frozen, A.sssp(3), CFG, device="cpu").run()
    assert np.array_equal(r.values, ref.values)


# -- the prefetch policy and the scheduler twin -------------------------------
@given(p=st.integers(3, 40), seed=st.integers(0, 1000), sub=st.booleans(),
       retired_only=st.booleans(), with_calm=st.booleans())
@settings(max_examples=30, deadline=None)
def test_policy_matches_reference(p, seed, sub, retired_only, with_calm):
    rng = np.random.default_rng(seed)
    psd = rng.choice([0.0, 1e-13, 0.5, 0.5, 1.0, state_lib.UNSEEN],
                     size=p).astype(np.float32)
    calm = rng.integers(0, 5, (p, 3) if sub else p).astype(np.int32)
    resident = rng.random(p) < 0.6
    protect = rng.random(p) < 0.2
    sel = Selection(hot_ids=rng.permutation(p)[:rng.integers(0, 4)],
                    cold_ids=rng.permutation(p)[:rng.integers(0, 4)])
    pad = int(rng.integers(0, p))
    from repro.core.schedule import Selection as JSelection
    jsel = JSelection(hot_ids=sel.hot_ids, cold_ids=sel.cold_ids)
    pairs = [(policy.demand_blocks(sel, pad),
              j_policy.demand_blocks(jsel, pad)),
             (policy.fold_calm(calm), j_policy.fold_calm(calm)),
             (policy.rank_fetch_candidates(psd, resident, 1e-12),
              j_policy.rank_fetch_candidates(psd, resident, 1e-12))]
    cb = policy.fold_calm(calm) if with_calm else None
    pairs.append((policy.rank_victims(psd, cb, resident, protect, 3,
                                      retired_only),
                  j_policy.rank_victims(psd, cb, resident, protect, 3,
                                        retired_only)))
    for t, j in pairs:
        assert t.dtype == j.dtype and np.array_equal(t, j)
    assert policy.fold_calm(None) is None


@given(p=st.integers(2, 40), width=st.integers(1, 12), i2=st.integers(0, 5),
       it=st.integers(0, 9), seed=st.integers(0, 200), sub=st.booleans())
@settings(max_examples=30, deadline=None)
def test_predictor_matches_device_select(p, width, i2, it, seed, sub):
    """The spill tier's lookahead picks exactly the device select's blocks,
    in its order (including after ``.width`` is retargeted)."""
    rng = np.random.default_rng(seed)
    psd = rng.choice([0.0, 1e-13, 0.5, 0.5, 1.0, 2.0, state_lib.UNSEEN],
                     size=(p, 3) if sub else (p, 1)).astype(np.float32)
    is_hot = rng.random(p) < 0.4
    pred = schedule_predictor(width + 3, i2, 0.25, 1e-12)
    pred.width = width
    sel = pred.select(it, psd, is_hot)
    dsel = make_device_select(width=width, cold_frac=0.25, min_psd=1e-12)
    hr, hok, cr, cok = (x.numpy() for x in dsel(
        it, i2, torch.from_numpy(psd), torch.from_numpy(is_hot)))
    assert np.array_equal(hr[hok], sel.hot_ids)
    assert np.array_equal(cr[cok], sel.cold_ids)


# -- traced budget run ---------------------------------------------------------
def test_traced_budget_run():
    """A traced run under a budget is bitwise its untraced twin, its rows
    equal the resident traced run's, and the recorder holds the ooc spans
    with their block and byte counts."""
    g = _graph(G)
    full = _eng(g, "sssp").run(trace=True)
    plain = _eng(g, "sssp", 7).run()
    eng = _eng(g, "sssp", 7)  # residency persists across runs: a twin
    with obs_trace.recording() as rec:
        traced = eng.run()
    _same_trajectory(plain, traced)
    assert [traced.metrics.as_dict()[k] for k in SPILL] == \
        [plain.metrics.as_dict()[k] for k in SPILL]
    cols = TIMELINE_INT_COLS + ("width", "superstep")
    assert [[r[c] for c in cols] for r in traced.timeline] == \
        [[r[c] for c in cols] for r in full.timeline]
    spans = [e for e in rec.events if e["type"] == "span"
             and e["cat"] == "ooc"]
    names = {e["name"] for e in spans}
    assert names == {"spill_evict", "prefetch"}
    assert all(e["args"]["blocks"] > 0 and e["args"]["bytes"] > 0
               for e in spans)
    assert sum(e["args"]["bytes"] for e in spans
               if e["name"] == "prefetch") == traced.metrics.bytes_fetched
