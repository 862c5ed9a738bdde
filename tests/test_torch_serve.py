"""The port's query serving (``repro_torch.serve``) on the CPU, through the
plain version of the lane sweep; mirrors tests/test_serve.py case by case
at its sizes (powerlaw n = 900, block 128, width 4).

The bar:

* k_sssp/k_bfs lane batches against the reference ``LaneEngine(...,
  use_pallas=False)`` on the same epoch inputs: values, lane iterations,
  lane convergence and the counters (updates, loads, bytes) bitwise;
  k_ppr values at rtol=1e-4, atol=1e-7, with the rate of lane-iteration
  agreement printed (its sums differ by reordering roundoff; ROADMAP
  Queue 3).
* a one-query service run, and a padded L = 4 batch, equal the port's own
  ``StructureAwareEngine`` SSSP run bitwise, counters included.
* snapshot isolation across an ingest with deletes and across a plan
  rebuild; same-epoch pins share one device copy.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import one_torch_thread  # noqa: F401

from conftest import bellman_ford_oracle, ppr_oracle
from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import coupling_from_counts as j_coupling
from repro.serve.lanes import LaneEngine as JLaneEngine
from repro.stream import StreamingEngine as JStream
from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.engine import EngineConfig, StructureAwareEngine
from repro_torch.core.engine import coupling_from_counts
from repro_torch.kernels import block_sweep as kb
from repro_torch.serve import LaneEngine, Query, QueryService
from repro_torch.stream import (DeltaBatch, StreamConfig, StreamingEngine,
                                synthetic_stream)
from repro_torch.stream.delta import apply_to_coo

KW = dict(t2=1e-9, width=4, block_size=128)
CFG = EngineConfig(**KW)
COUNTERS = ("iterations", "updates", "edges_processed", "block_loads",
            "bytes_loaded", "converged", "blocks_retired")


def _close(a, b, **kw):
    return np.allclose(np.minimum(a, 1e18), np.minimum(b, 1e18), **kw)


def _frozen(g, batches, upto):
    s, d, w = G.edges_of(g)
    for b in batches[:upto]:
        s, d, w = apply_to_coo(s, d, w, g.n, b)
    return G.from_edges(g.n, s, d, w)


def _jgraph(g):
    """The same graph as the reference's Graph (the oracles take it)."""
    return JG.from_edges(g.n, *G.edges_of(g))


def _counters(m):
    return tuple(getattr(m, f) for f in COUNTERS)


@pytest.fixture(scope="module")
def stream_pl():
    g = G.powerlaw_graph(900, avg_deg=5, seed=7, weighted=True)
    return g, StreamingEngine(g, A.pagerank(), CFG, device="cpu")


# -- single-lane parity: serving is a strict superset of the engine ----------
@pytest.mark.parametrize("lanes", [1, 4])
def test_single_lane_reproduces_engine_trajectory(stream_pl, lanes):
    """A one-query service run, alone or padded to L = 4, equals a plain
    engine run of the same program on the same epoch: iterations, values
    and the update/load/byte counters, bitwise; padding lanes are never
    billed."""
    g, se = stream_pl
    svc = QueryService(se, max_lanes=lanes)
    svc.submit(Query(kind="sssp", source=3))
    r = svc.run_pending()[0]
    ref = StructureAwareEngine(g, A.sssp(3), se.config, device="cpu").run()
    assert r.converged and ref.metrics.converged
    assert r.iterations == r.batch_iterations == ref.metrics.iterations
    assert np.array_equal(r.values, ref.values)
    assert _counters(svc.last_batch.metrics) == _counters(ref.metrics)
    assert svc.last_batch.host_syncs == ref.host_syncs
    m = svc.metrics
    assert m.lanes_admitted == 1 and m.lane_slots == lanes
    assert m.lane_utilization == pytest.approx(1 / lanes)


def test_lane_engine_counters_match_engine(stream_pl):
    g, se = stream_pl
    es = se.snapshot()
    fam = A.k_source_sssp()
    vals0, vconst = fam.lane_init(se.n, [3])
    res = LaneEngine(es.engine, fam).run(
        ed=es.ed._replace(aux=torch.zeros(se.n)),
        coupling=coupling_from_counts(es.coupling_counts, fam,
                                      es.engine.plan.block_size),
        values0=vals0, vconst=vconst, lane_active=np.array([True]),
        edge_counts=es.edge_counts)
    ref = StructureAwareEngine(g, A.sssp(3), se.config, device="cpu").run()
    assert _counters(res.metrics) == _counters(ref.metrics)


# -- lanes against the reference's LaneEngine ----------------------------------
@pytest.fixture(scope="module")
def pair_pl():
    g = G.powerlaw_graph(900, avg_deg=5, seed=7, weighted=True)
    js = JStream(_jgraph(g), JA.pagerank(), JConfig(**KW))
    ts = StreamingEngine(g, A.pagerank(), CFG, device="cpu")
    return js, ts


def _both(js, ts, fam, params, lane_active):
    """One lane batch through the reference (dense path) and the port, on
    the same epoch inputs."""
    import jax.numpy as jnp
    out = []
    for es, le, family, aux_of in (
            (js.snapshot(), JLaneEngine, JA.LANE_FAMILIES[fam](),
             jnp.asarray),
            (ts.snapshot(), LaneEngine, A.LANE_FAMILIES[fam](),
             torch.from_numpy)):
        values0, vconst = family.lane_init(ts.n, params)
        aux = (family.aux_fn(es.out_deg, es.in_deg) if family.aux_fn
               else np.zeros(ts.n, np.float32))
        eng = (le(es.engine, family, use_pallas=False)
               if le is JLaneEngine else le(es.engine, family))
        cpl = (j_coupling if le is JLaneEngine else coupling_from_counts)(
            es.coupling_counts, family, es.engine.plan.block_size)
        out.append(eng.run(ed=es.ed._replace(aux=aux_of(
            np.asarray(aux, np.float32))), coupling=cpl, values0=values0,
            vconst=vconst, lane_active=lane_active,
            edge_counts=es.edge_counts))
    return out


@pytest.mark.parametrize("fam", ["sssp", "bfs"])
def test_min_lanes_match_reference(pair_pl, fam):
    js, ts = pair_pl
    ref, got = _both(js, ts, fam, [0, 7, 42, 130],
                     np.array([True, True, True, False]))
    assert np.array_equal(got.values, ref.values)
    assert np.array_equal(got.lane_iterations, ref.lane_iterations)
    assert np.array_equal(got.lane_converged, ref.lane_converged)
    assert _counters(got.metrics) == _counters(ref.metrics)
    assert got.metrics.converged


def test_ppr_lanes_match_reference(pair_pl):
    js, ts = pair_pl
    ref, got = _both(js, ts, "ppr", [[0], [5, 17, 200], [3], [44, 9]],
                     np.ones(4, bool))
    assert got.lane_converged.all() and ref.lane_converged.all()
    assert _close(got.values, ref.values, rtol=1e-4, atol=1e-7)
    same = np.mean(got.lane_iterations == ref.lane_iterations)
    print(f"k_ppr lane iterations equal on {same:.2f} of the lanes: "
          f"port {got.lane_iterations.tolist()}, reference "
          f"{ref.lane_iterations.tolist()}")


# -- multi-lane correctness ---------------------------------------------------
def test_k_source_sssp_lanes_match_oracles(stream_pl):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=4)
    sources = [0, 7, 42, 130]
    qids = [svc.submit(Query(kind="sssp", source=s)) for s in sources]
    res = {r.query_id: r for r in svc.run_pending()}
    assert len(res) == 4
    by_qid = dict(zip(qids, sources))
    for qid, r in res.items():
        oracle = bellman_ford_oracle(_jgraph(g), by_qid[qid])
        assert r.converged
        assert _close(r.values, oracle.astype(np.float32), rtol=1e-5,
                      atol=1e-3)
    assert svc.metrics.lane_batches == 1
    assert svc.metrics.queries == 4


def test_k_source_bfs_lanes_match_oracles(stream_pl):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=2)
    qids = [svc.submit(Query(kind="bfs", source=s)) for s in (1, 9)]
    res = {r.query_id: r for r in svc.run_pending()}
    for qid, s in zip(qids, (1, 9)):
        oracle = bellman_ford_oracle(_jgraph(g), s, unit=True)
        assert _close(res[qid].values, oracle.astype(np.float32),
                      rtol=1e-5, atol=1e-3)


def test_ppr_lanes_match_power_iteration(stream_pl):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=2)
    resets = [[0], [5, 17, 200]]
    qids = [svc.submit(Query(kind="ppr", reset=r)) for r in resets]
    res = {r.query_id: r for r in svc.run_pending()}
    for qid, rs in zip(qids, resets):
        oracle = ppr_oracle(_jgraph(g), rs)
        assert res[qid].converged
        assert np.allclose(res[qid].values, oracle, rtol=1e-3, atol=1e-6)
        assert res[qid].values[rs[0]] > 1.0 / g.n


def test_mixed_kinds_batch_per_family(stream_pl):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=4)
    svc.submit(Query(kind="sssp", source=2))
    svc.submit(Query(kind="ppr", reset=[3]))
    svc.submit(Query(kind="sssp", source=11))
    res = svc.run_pending()
    assert len(res) == 3
    assert svc.metrics.lane_batches == 2
    assert {r.kind for r in res} == {"sssp", "ppr"}


def test_admission_priority_hottest_frontier_first(stream_pl):
    g, se = stream_pl
    act = se.activity()
    cold_v, hot_v = int(np.argmin(act)), int(np.argmax(act))
    svc = QueryService(se, max_lanes=2)
    q_cold = svc.submit(Query(kind="sssp", source=cold_v))
    q_hot = svc.submit(Query(kind="sssp", source=hot_v))
    q_mid = svc.submit(Query(kind="sssp",
                             source=int(np.argsort(act)[g.n // 2])))
    res = svc.run_pending()
    first_batch = [r.query_id for r in res if r.lanes == 2]
    second_batch = [r.query_id for r in res if r.lanes == 1]
    assert q_hot in first_batch and q_mid in first_batch
    assert second_batch == [q_cold]


# -- snapshot isolation -------------------------------------------------------
@given(seed=st.integers(0, 15), kind=st.sampled_from(["sssp", "ppr"]))
@settings(max_examples=6, deadline=None, database=None)
def test_snapshot_isolation_property(seed, kind):
    """A query admitted at epoch e answers on the graph as of epoch e,
    however many delta batches (deletes included) land before it runs."""
    g = G.powerlaw_graph(400, avg_deg=4, seed=seed, weighted=True)
    se = StreamingEngine(g, A.pagerank(), CFG, device="cpu")
    svc = QueryService(se, max_lanes=2, prewarm=False)
    batches = synthetic_stream(g, 2, 50, seed=seed + 1, delete_frac=0.4,
                               weighted=True)
    mk = (lambda s: Query(kind="sssp", source=s)) if kind == "sssp" else \
        (lambda s: Query(kind="ppr", reset=[s, (s + 3) % g.n]))
    q0 = svc.submit(mk(0))  # pinned to epoch 0
    svc.ingest(batches[0])
    q1 = svc.submit(mk(0))  # pinned to epoch 1
    svc.ingest(batches[1])  # the epoch-1 pin survives this one too
    res = {r.query_id: r for r in svc.run_pending()}
    assert res[q0].epoch == 0 and res[q1].epoch == 1
    for qid, upto in ((q0, 0), (q1, 1)):
        frozen = _jgraph(_frozen(g, batches, upto))
        if kind == "sssp":
            oracle = bellman_ford_oracle(frozen, 0).astype(np.float32)
            assert _close(res[qid].values, oracle, rtol=1e-5, atol=1e-3), \
                f"epoch {upto} answer diverged from its frozen graph"
        else:
            oracle = ppr_oracle(frozen, [0, 3])
            assert np.allclose(res[qid].values, oracle, rtol=1e-3,
                               atol=1e-6)
    assert svc.metrics.stale_answers == 2
    assert se.metrics.snapshots_preserved >= 1


def test_snapshot_survives_plan_rebuild():
    g = G.powerlaw_graph(300, avg_deg=4, seed=1, weighted=True)
    se = StreamingEngine(g, A.pagerank(), CFG,
                         StreamConfig(tile_slack=0.0, spare_tiles=0),
                         device="cpu")
    svc = QueryService(se, max_lanes=2, prewarm=False)
    qid = svc.submit(Query(kind="sssp", source=0))
    burst = DeltaBatch(ins_src=np.arange(250) % g.n,
                       ins_dst=np.full(250, 7),
                       ins_w=np.ones(250, np.float32),
                       del_src=[], del_dst=[])
    rep = svc.ingest(burst)
    assert rep.plan_rebuild
    r = {x.query_id: x for x in svc.run_pending()}[qid]
    oracle = bellman_ford_oracle(_jgraph(g), 0).astype(np.float32)
    assert r.epoch == 0
    assert _close(r.values, oracle, rtol=1e-5, atol=1e-3)
    q2 = svc.submit(Query(kind="sssp", source=0))
    r2 = {x.query_id: x for x in svc.run_pending()}[q2]
    oracle2 = bellman_ford_oracle(_jgraph(_frozen(g, [burst], 1)), 0) \
        .astype(np.float32)
    assert r2.epoch == 1
    assert _close(r2.values, oracle2, rtol=1e-5, atol=1e-3)



@pytest.mark.parametrize("rebuild", [False, True])
def test_served_epoch_state_is_freed(rebuild):
    """Once its queries are served, a pinned epoch's preserved copy is
    freed, and after a plan rebuild so is the old epoch's engine: the lane
    engines and lane scratch the service keeps for reuse hold neither."""
    g = G.powerlaw_graph(300, avg_deg=4, seed=1, weighted=True)
    se = StreamingEngine(g, A.pagerank(), CFG,
                         StreamConfig(tile_slack=0.0, spare_tiles=0),
                         device="cpu")
    svc = QueryService(se, max_lanes=2, prewarm=False)
    svc.submit(Query(kind="sssp", source=0))
    svc.run_pending()  # the lane engine and its scratch now exist
    old_engine = weakref.ref(se.engine)
    svc.submit(Query(kind="sssp", source=0))  # pins epoch 0
    batch = (DeltaBatch(ins_src=np.arange(250) % g.n,
                        ins_dst=np.full(250, 7),
                        ins_w=np.ones(250, np.float32),
                        del_src=[], del_dst=[])
             if rebuild else DeltaBatch.of(ins=[(0, 1)]))
    assert svc.ingest(batch).plan_rebuild == rebuild
    pin = svc._pending[0].epoch_state
    assert pin.preserved
    preserved = weakref.ref(pin.ed.src)
    del pin
    (r,) = svc.run_pending()
    assert r.epoch == 0 and r.converged
    gc.collect()
    assert preserved() is None
    assert (old_engine() is None) == rebuild

def test_pins_cost_nothing_on_quiet_graph(stream_pl):
    g, se = stream_pl
    before = se.metrics.snapshots_preserved
    svc = QueryService(se, max_lanes=2, prewarm=False)
    svc.submit(Query(kind="bfs", source=0))
    svc.run_pending()
    assert se.metrics.snapshots_preserved == before


def test_edge_snapshot_copies_every_field(stream_pl):
    """A preserved epoch shares no storage with the live state: the commits
    rewrite tile rows and the fold metadata in place."""
    _, se = stream_pl
    snap = se.engine.edge_snapshot()
    live = se.engine.edge_state
    assert len(snap) == len(live) == 12
    for a, b in zip(snap, live):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != \
            b.untyped_storage().data_ptr()


# -- validation / bookkeeping -------------------------------------------------
def test_query_validation(stream_pl):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=2, prewarm=False)
    for q in (Query(kind="nope", source=0), Query(kind="sssp", source=g.n),
              Query(kind="sssp"), Query(kind="ppr"),
              Query(kind="ppr", reset=[]), Query(kind="ppr", reset=[g.n]),
              Query(kind="ppr", reset=[-1]),
              Query(kind="ppr", reset=np.full(g.n, 2.0 / g.n, np.float32))):
        with pytest.raises(ValueError):
            svc.submit(q)
    with pytest.raises(ValueError):
        QueryService(se, max_lanes=0)
    assert svc.pending == 0


def test_failing_batch_does_not_discard_other_queries(stream_pl,
                                                       monkeypatch):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=2, prewarm=False)
    q_ppr = svc.submit(Query(kind="ppr", reset=[3]))
    q_sssp = svc.submit(Query(kind="sssp", source=1))
    calls = {"n": 0}
    real = QueryService._run_batch

    def boom_first(self, pend):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("lane batch died")
        return real(self, pend)

    monkeypatch.setattr(QueryService, "_run_batch", boom_first)
    with pytest.raises(RuntimeError):
        svc.run_pending()
    assert svc.pending == 1
    res = svc.run_pending()
    assert len(res) == 1
    assert res[0].query_id in (q_ppr, q_sssp)


def test_same_epoch_pins_share_one_device_copy():
    g = G.powerlaw_graph(250, avg_deg=4, seed=2, weighted=True)
    se = StreamingEngine(g, A.pagerank(), CFG, device="cpu")
    pins = [se.snapshot() for _ in range(3)]
    se.ingest(DeltaBatch.of(ins=[(0, 1)]))
    assert se.metrics.snapshots_preserved == 1
    assert all(p.preserved for p in pins)
    assert pins[1].ed is pins[0].ed and pins[2].ed is pins[0].ed


def test_symmetric_host_rejects_asymmetric_family():
    g = G.powerlaw_graph(200, avg_deg=3, seed=0)
    se = StreamingEngine(g, A.cc(), CFG, device="cpu")
    svc = QueryService(se, max_lanes=2, prewarm=False)
    with pytest.raises(ValueError):
        svc.submit(Query(kind="sssp", source=0))


def test_serve_metrics_accumulate(stream_pl):
    g, se = stream_pl
    svc = QueryService(se, max_lanes=2)
    for s in (0, 1, 2):
        svc.submit(Query(kind="bfs", source=s))
    res = svc.run_pending()
    m = svc.metrics
    assert m.queries == 3 and m.lane_batches == 2
    assert m.lanes_admitted == 3 and m.lane_slots == 4
    assert m.run_time_s > 0 and m.iterations > 0
    assert m.epochs_pinned >= 1
    d = m.as_dict()
    assert "queries_per_s" in d and "lane_utilization" in d
    assert all(r.run_s > 0 for r in res)
    assert svc.pending == 0


def test_serve_subblock_parity():
    """Lane runs inherit the sub-block masks (kernel 1lm): a query batch at
    S > 1 answers exactly like the flat service (values and per-lane
    convergence supersteps)."""
    g = G.powerlaw_graph(700, avg_deg=5, seed=5, weighted=True)

    def serve(subblocks):
        cfg = dataclasses.replace(CFG, subblocks=subblocks)
        svc = QueryService(StreamingEngine(g, A.sssp(), cfg, device="cpu"),
                           max_lanes=2, prewarm=False)
        qids = [svc.submit(Query(kind="sssp", source=s)) for s in (3, 77)]
        res = {r.query_id: r for r in svc.run_pending()}
        return [res[q] for q in qids]

    kb.masked_lane_block_sweep.launches = 0
    r1, r4 = serve(1), serve(4)
    for a, b in zip(r1, r4):
        assert _close(a.values, b.values, rtol=1e-5, atol=1e-6)
        assert a.iterations == b.iterations
        assert a.converged and b.converged
    assert kb.masked_lane_block_sweep.launches == 0  # the CPU takes plain


def test_graph_service_example_on_cpu(capsys):
    from repro_torch import graph_service
    graph_service.main(["--n", "3000", "--lanes", "2", "--queries", "4",
                        "--batches", "1", "--batch-size", "40",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 queries in" in out and "1 snapshot(s) device-copied" in out
