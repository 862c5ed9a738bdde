"""The port's observability layer (``repro_torch.obs`` and
``run(trace=True)``) on the CPU, against the reference's.

The bar:

* Tracing observes only: a traced run is bitwise its untraced twin (values,
  iterations, every counter, ``converged``, ``host_syncs``) for all four
  programs on both loops at S = 1 and S = 4, and its timeline sums exactly
  to the aggregate counters, with ``adaptive`` on and off.
* Against the reference's timeline (the port on the reference's state,
  ``_torch_parity.port_engine``): for SSSP, BFS and CC the integer columns
  and ``width`` are identical row for row and ``psd_max`` is equal on both
  loops; ``psd_sum`` is held at rtol 1e-5, as the frameworks sum floats in
  different orders (ROADMAP fact 3). The port's two loops give identical
  integer columns.
* The recorder, exporter and CLI mirror tests/test_obs.py; a port run's
  Chrome export passes both packages' ``validate``; each package's
  recorder traces its own engines only.
* Streaming and serving: a recorded stream is bitwise its unrecorded
  twin, and the port emits the reference's spans (names, nesting and args,
  the timings aside) for the same stream and queries.
* Queue 3's PageRank cases (ROADMAP): the first superstep whose row
  differs from the reference's, pinned, with the rows before it equal.
"""
import json

import numpy as np
import pytest
from _torch_parity import one_torch_thread, port_engine  # noqa: F401

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import StructureAwareEngine as JEngine
from repro.obs import export as j_export
from repro.obs import trace as j_trace
from repro.serve import Query as JQuery
from repro.serve import QueryService as JService
from repro.stream import StreamingEngine as JStream
from repro.stream import synthetic_stream as j_stream
from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.engine import (TIMELINE_FLOAT_COLS, TIMELINE_INT_COLS,
                                     EngineConfig, StructureAwareEngine)
from repro_torch.core.metrics import COUNTER_FIELDS
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.serve import Query, QueryService
from repro_torch.stream import StreamingEngine, synthetic_stream

KW = dict(t2=1e-9, width=4, block_size=128)
PROGS = ("pagerank", "sssp", "bfs", "cc")
INT_COLS = TIMELINE_INT_COLS + ("width",)


def _graph(mod, prog, n):
    if prog == "pagerank":
        return mod.core_periphery_graph(n, avg_deg=6, seed=4, chords=1)
    return mod.powerlaw_graph(n, avg_deg=5, seed=4, weighted=prog == "sssp")


def _run_key(res):
    m = res.metrics
    return (m.iterations, m.converged, res.host_syncs,
            tuple(getattr(m, f) for f in COUNTER_FIELDS))


def _ints(timeline):
    return [[r[c] for c in INT_COLS] for r in timeline]


# -- tracing observes only ----------------------------------------------------
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("prog", PROGS)
def test_traced_run_bitwise_identical(prog, fused, s):
    eng = StructureAwareEngine(_graph(G, prog, 600), A.REGISTRY[prog](),
                               EngineConfig(**KW, subblocks=s), device="cpu")
    plain = eng.run(fused=fused)
    traced = eng.run(fused=fused, trace=True)
    assert np.array_equal(plain.values, traced.values)
    assert _run_key(plain) == _run_key(traced)
    assert plain.metrics.converged
    assert plain.timeline is None
    assert len(traced.timeline) == traced.metrics.iterations


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_timeline_sums_to_aggregate_counters(prog, fused, adaptive):
    res = StructureAwareEngine(
        _graph(G, prog, 500), A.REGISTRY[prog](),
        EngineConfig(**KW, adaptive=adaptive), device="cpu").run(
            fused=fused, trace=True)
    tl = res.timeline
    assert len(tl) == res.metrics.iterations > 0
    for field in COUNTER_FIELDS:
        assert sum(r[field] for r in tl) == getattr(res.metrics, field)
    cols = set(TIMELINE_INT_COLS) | set(TIMELINE_FLOAT_COLS) \
        | {"superstep", "width"}
    assert all(set(r) == cols for r in tl)
    assert [r["superstep"] for r in tl] == list(range(len(tl)))
    if not adaptive:
        assert all(r["retired"] == 0 for r in tl)


# -- against the reference's timeline -----------------------------------------
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("prog", ["sssp", "bfs", "cc"])
def test_timeline_matches_reference(prog, s):
    jeng = JEngine(_graph(JG, prog, 800), JA.REGISTRY[prog](),
                   JConfig(**KW, subblocks=s))
    teng = port_engine(jeng, A.REGISTRY[prog](),
                       EngineConfig(**KW, subblocks=s))
    loops = {}
    for fused in (True, False):
        ref = jeng.run(fused=fused, trace=True).timeline
        got = teng.run(fused=fused, trace=True).timeline
        assert _ints(got) == _ints(ref)
        assert [r["psd_max"] for r in got] == [r["psd_max"] for r in ref]
        np.testing.assert_allclose([r["psd_sum"] for r in got],
                                   [r["psd_sum"] for r in ref], rtol=1e-5,
                                   atol=0)
        loops[fused] = _ints(got)
    assert loops[True] == loops[False]


# -- recorder / exporter (mirrors tests/test_obs.py) --------------------------
def test_ring_buffer_bounds_memory_and_counts_drops():
    rec = obs_trace.TraceRecorder(capacity=8)
    for i in range(20):
        with rec.span("s", cat="t", i=i):
            pass
    assert len(rec.events) == 8
    assert rec.dropped == 12
    assert [e["args"]["i"] for e in rec.events] == list(range(12, 20))


def test_span_without_recorder_is_noop():
    assert obs_trace.current() is None
    with obs_trace.span("x", cat="y", a=1) as h:
        h.set(b=2)  # must not raise
    obs_trace.instant("z")  # must not raise
    assert obs_trace.current() is None


def test_nested_spans_depth_and_args():
    with obs_trace.recording() as rec:
        with obs_trace.span("outer", cat="t") as o:
            with obs_trace.span("inner", cat="t"):
                pass
            o.set(k=3)
    spans = {e["name"]: e for e in rec.events}
    assert spans["inner"]["depth"] == 1
    assert spans["outer"]["depth"] == 0
    assert spans["outer"]["args"] == {"k": 3}
    assert spans["outer"]["dur"] >= spans["inner"]["dur"]


def test_install_uninstall_and_recording_restore():
    rec = obs_trace.install(obs_trace.TraceRecorder())
    try:
        assert obs_trace.current() is rec
        with obs_trace.recording() as inner:
            assert obs_trace.current() is inner
        assert obs_trace.current() is rec
    finally:
        obs_trace.uninstall()
    assert obs_trace.current() is None


def test_chrome_export_schema_valid(tmp_path):
    with obs_trace.recording() as rec:
        with obs_trace.span("a", cat="x", n=1):
            rec.counter_rows("c", [{"v": 1, "skip": "str"},
                                   {"v": 2}], 0.0, 1.0)
        rec.instant("mark", note="hi")
    payload = obs_export.to_chrome(rec, meta={"suite": "unit"})
    assert obs_export.validate(payload) == []
    phs = [e["ph"] for e in payload["traceEvents"]]
    assert phs.count("C") == 2 and "X" in phs and "i" in phs
    cs = [e for e in payload["traceEvents"] if e["ph"] == "C"]
    assert all("skip" not in e["args"] for e in cs)  # non-numeric filtered
    assert cs[0]["ts"] < cs[1]["ts"]  # interpolated placement
    assert payload["otherData"]["suite"] == "unit"
    p = obs_export.write(rec, str(tmp_path / "t.json"))
    assert obs_export.validate(json.load(open(p))) == []


def test_validate_rejects_malformed_payloads():
    assert obs_export.validate([]) != []
    assert obs_export.validate({}) != []
    bad = {"traceEvents": [
        {"ph": "Z", "name": "x", "pid": 1, "tid": 1, "ts": 0},
        {"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": -1},
        {"ph": "C", "name": "c", "pid": 1, "tid": 1, "ts": 0,
         "args": {"v": "nan"}},
    ]}
    assert len(obs_export.validate(bad)) >= 3


def test_cli_render_and_validate(tmp_path, capsys):
    g = G.uniform_graph(200, deg=4, seed=1, weighted=True)
    with obs_trace.recording() as rec:
        StructureAwareEngine(g, A.pagerank(), EngineConfig(**KW),
                             device="cpu").run()
    path = obs_export.write(rec, str(tmp_path / "trace_run.json"))
    assert obs_cli(["validate", path]) == 0
    assert obs_cli(["render", path, "--limit", "10"]) == 0
    out = capsys.readouterr().out
    assert "valid chrome-trace JSON" in out
    assert "phase breakdown" in out and "engine/run" in out
    assert "superstep counters" in out
    payload = json.load(open(path))
    assert j_export.validate(payload) == []  # the reference's check too
    names = {e["name"] for e in payload["traceEvents"] if e["ph"] == "X"}
    assert {"run", "chunk", "repartition"} <= names


def test_run_trace_follows_the_ports_recorder_only():
    g = G.uniform_graph(200, deg=4, seed=0, weighted=True)
    eng = StructureAwareEngine(g, A.pagerank(), EngineConfig(**KW),
                               device="cpu")
    assert eng.run().timeline is None
    with obs_trace.recording() as rec:
        res = eng.run()  # trace=None + installed recorder -> traced
    assert res.timeline is not None
    assert any(e["type"] == "counter" for e in rec.events)
    assert eng.run().timeline is None  # uninstalled again
    with j_trace.recording() as jrec:  # the reference's recorder
        assert eng.run().timeline is None
        jres = JEngine(JG.uniform_graph(200, deg=4, seed=0, weighted=True),
                       JA.pagerank(), JConfig(**KW)).run()
    assert jres.timeline is not None
    assert {e["name"] for e in jrec.events if e["type"] == "span"} \
        == {"run", "chunk", "repartition"}
    with obs_trace.recording() as rec:
        jres = JEngine(JG.uniform_graph(200, deg=4, seed=0, weighted=True),
                       JA.pagerank(), JConfig(**KW)).run()
    assert jres.timeline is None and len(rec.events) == 0


# -- streaming and serving ----------------------------------------------------
def test_stream_identical_under_recording():
    g = G.powerlaw_graph(300, avg_deg=4, seed=3, weighted=True)
    batches = synthetic_stream(g, 3, 30, seed=4, delete_frac=0.25,
                               weighted=True)
    cfg = EngineConfig(**KW, subblocks=4)
    plain = StreamingEngine(g, A.pagerank(), cfg, device="cpu")
    traced = StreamingEngine(g, A.pagerank(), cfg, device="cpu")
    with obs_trace.recording() as rec:
        reps_t = [traced.ingest(b) for b in batches]
    reps_p = [plain.ingest(b) for b in batches]
    fields = ("iterations", "edges_processed", "dirty_blocks",
              "dirty_subblocks", "bytes_uploaded", "converged")
    for rp, rt in zip(reps_p, reps_t):
        assert [getattr(rp, f) for f in fields] == \
            [getattr(rt, f) for f in fields]
    assert np.array_equal(plain.values, traced.values)
    ing = [e for e in rec.events
           if e["type"] == "span" and e["name"] == "ingest"]
    assert [e["args"]["iterations"] for e in ing] == \
        [r.iterations for r in reps_p]


def _spans(rec):
    """(name, cat, depth, args) of every span, in completion order."""
    return [(e["name"], e["cat"], e["depth"], e["args"])
            for e in rec.events if e["type"] == "span"]


def _serve_session(stream_cls, service_cls, query_cls, stream_fn, g, cfg,
                   **kw):
    """A recorded SSSP stream at S = 4 with queries pinned across an
    ingest, then a wave on the new epoch; returns the recorder."""
    batches = stream_fn(g, 2, 40, seed=9, delete_frac=0.2, weighted=True)
    with (j_trace if stream_cls is JStream else obs_trace).recording() \
            as rec:
        se = stream_cls(g, A.sssp(0) if stream_cls is StreamingEngine
                        else JA.sssp(0), cfg, **kw)
        svc = service_cls(se, max_lanes=4)
        for v in (0, 7, 42):
            svc.submit(query_cls(kind="sssp", source=v))
        svc.ingest(batches[0])
        svc.run_pending()
        svc.ingest(batches[1])
        svc.submit(query_cls(kind="bfs", source=3))
        svc.run_pending()
    return rec


def test_spans_match_reference():
    kw = dict(KW, subblocks=4)
    ref = _serve_session(JStream, JService, JQuery, j_stream,
                         JG.powerlaw_graph(500, avg_deg=5, seed=8,
                                           weighted=True), JConfig(**kw))
    got = _serve_session(StreamingEngine, QueryService, Query,
                         synthetic_stream,
                         G.powerlaw_graph(500, avg_deg=5, seed=8,
                                          weighted=True),
                         EngineConfig(**kw), device="cpu")
    names = {s[0] for s in _spans(got)}
    assert names == {"snapshot", "ingest", "reconverge", "run", "chunk",
                     "repartition", "query_batch"}
    assert _spans(got) == _spans(ref)
    counters = [[e for e in rec.events if e["type"] == "counter"]
                for rec in (ref, got)]
    assert [[c["values"][k] for k in INT_COLS] for c in counters[1]] == \
        [[c["values"][k] for k in INT_COLS] for c in counters[0]]


# -- Queue 3: the first superstep that differs from the reference -------------
def _first(ref, got, cols):
    """The first superstep whose ``cols`` differ, a row missing on one side
    included; None if the timelines agree."""
    for k in range(max(len(ref), len(got))):
        if k >= min(len(ref), len(got)) or \
                [ref[k][c] for c in cols] != [got[k][c] for c in cols]:
            return k
    return None


def _divergence(ref, got):
    k = _first(ref, got, INT_COLS)
    if k is not None:  # the rows agree before it
        assert _ints(got[:k]) == _ints(ref[:k])
    return (k, _first(ref, got, ("psd_max",)),
            _first(ref, got, ("psd_sum",)), len(ref), len(got))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_queue3_pagerank_sum_order_divergence(fused):
    """ROADMAP Queue 3, PR 12: PageRank on core_periphery_graph(1500, 6,
    seed=4, chords=1), block 64, width 4, t2 = 1e-9. The PSD floats differ
    from superstep 0 (fact 3); the first schedule decision that differs is
    at superstep 77, on both loops; the port converges after 95 supersteps,
    the reference after 109."""
    kw = dict(t2=1e-9, width=4, block_size=64)
    jeng = JEngine(JG.core_periphery_graph(1500, 6, seed=4, chords=1),
                   JA.pagerank(), JConfig(**kw))
    ref = jeng.run(fused=fused, trace=True)
    got = port_engine(jeng, A.pagerank(), EngineConfig(**kw)).run(
        fused=fused, trace=True)
    assert _divergence(ref.timeline, got.timeline) == (77, 0, 0, 109, 95)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-4, atol=1e-7)


def test_queue3_warm_limit_cycle_divergence():
    """ROADMAP Queue 3, PR 13: a warm PageRank stream on
    core_periphery_graph(700, 8, seed=1, chords=1, weighted=True), block 512
    (P = 2), S = 4, width 16, t2 = 1e-8, two batches of
    synthetic_stream(g, 2, 30, seed=3, delete_frac=0.2). Per run
    (bootstrap, batch 1, batch 2), from the recorded superstep counters:
    the bootstrap's first differing row is superstep 16 (the port has
    converged), each batch's warm run first differs at superstep 8, and
    the second batch's port run cycles to the superstep cap."""
    kw = dict(block_size=512, width=16, t2=1e-8, subblocks=4,
              max_iterations=300)
    jg = JG.core_periphery_graph(700, avg_deg=8, seed=1, chords=1,
                                 weighted=True)
    g = G.core_periphery_graph(700, avg_deg=8, seed=1, chords=1,
                               weighted=True)
    with j_trace.recording() as jrec:
        js = JStream(jg, JA.pagerank(), JConfig(**kw))
        for b in j_stream(jg, 2, 30, seed=3, delete_frac=0.2,
                          weighted=True):
            js.ingest(b)
    with obs_trace.recording() as rec:
        ts = StreamingEngine(g, A.pagerank(), EngineConfig(**kw),
                             device="cpu")
        for b in synthetic_stream(g, 2, 30, seed=3, delete_frac=0.2,
                                  weighted=True):
            ts.ingest(b)

    def runs(r):
        out, rows = [], []
        for e in r.events:
            if e["type"] == "counter":
                rows.append(e["values"])
            elif e["type"] == "span" and e["name"] == "run":
                out.append(rows)
                rows = []
        return out

    got = [_divergence(a, b) for a, b in zip(runs(jrec), runs(rec))]
    assert got == [(16, 0, 0, 17, 16), (8, 0, 0, 10, 10),
                   (8, 1, 1, 10, 300)]
