"""The port on the card: the CUDA kernels against their plain versions,
and whole runs on the card against the same runs on the CPU. These tests
need an NVIDIA card and nvcc; elsewhere they skip. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core.baseline import BaselineEngine
from repro_torch.core.engine import EngineConfig, StructureAwareEngine
from repro_torch.kernels import block_sweep as kb

pytestmark = pytest.mark.cuda
CFG = EngineConfig(block_size=128, width=8, t2=1e-9)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _graph(prog):
    if prog == "pagerank":
        return G.core_periphery_graph(6000, 8, seed=1, chords=1)
    return G.powerlaw_graph(6000, 8, seed=2, weighted=prog == "sssp")


@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_kernel_matches_plain(card, prog):
    eng = StructureAwareEngine(_graph(prog), A.REGISTRY[prog](), CFG)
    ed, c, P = eng._ed, CFG.block_size, eng.plan.num_blocks
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    rng = np.random.default_rng(0)
    values = rng.uniform(0.0, 1e-3, eng._values_len).astype(np.float32)
    rows = np.arange(P, dtype=np.int32)
    ok = rng.random(P) < 0.7
    kw = dict(block_size=c, n_live=eng.plan.n_live)
    gv = torch.from_numpy(values).cuda()
    gp, gd = torch.zeros(P, 1).cuda(), torch.zeros(P, 1).cuda()
    kb.block_sweep(eng.program, eng.plan.graph.n, ed, gv,
                   torch.from_numpy(rows).cuda(), torch.from_numpy(ok).cuda(),
                   gp, gd, kb.make_scratch(ed, c), **kw)
    cv = torch.from_numpy(values.copy())
    cp, cd = torch.zeros(P, 1), torch.zeros(P, 1)
    kb.block_sweep_ref(eng.program, eng.plan.graph.n, ed_cpu, cv,
                       torch.from_numpy(rows), torch.from_numpy(ok), cp, cd,
                       kb.make_scratch(ed_cpu, c), **kw)
    torch.cuda.synchronize()
    assert torch.equal(gv.cpu(), cv)
    assert torch.equal(gp.cpu(), cp) and torch.equal(gd.cpu(), cd)


@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_run_on_card_matches_cpu(card, prog):
    g, program = _graph(prog), A.REGISTRY[prog]()
    kb.block_sweep.launches = 0
    gpu = StructureAwareEngine(g, program, CFG).run()
    assert kb.block_sweep.launches > 0
    cpu = StructureAwareEngine(g, program, CFG, device="cpu").run()
    assert np.array_equal(gpu.values, cpu.values)
    assert gpu.metrics.iterations == cpu.metrics.iterations
    assert gpu.metrics.updates == cpu.metrics.updates
    base = BaselineEngine(g, program, CFG).run()
    base_cpu = BaselineEngine(g, program, CFG, device="cpu").run()
    assert np.array_equal(base.values, base_cpu.values)


def _guarded(getter):
    """A ``_get_chunk`` whose chunks run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside one
    raises, the boundaries around it are as they were."""
    def get(self, *key):
        chunk = getter(self, *key)

        def guarded(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return chunk(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return guarded
    return get


def _run_key(res):
    m = res.metrics
    return (m.iterations, m.converged, m.updates, m.block_loads,
            m.bytes_loaded, res.host_syncs)


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_chunks_make_no_host_sync(card, monkeypatch, prog, s, trace):
    """Every chunk of a whole run (the engine's _get_chunk) enqueues its
    supersteps without a host sync, and the run equals the unguarded one
    bitwise, timeline rows included."""
    from repro_torch.serve.lanes import LaneEngine
    g, program = _graph(prog), A.REGISTRY[prog]()
    cfg = EngineConfig(block_size=128, width=8, t2=1e-9, subblocks=s)
    want = StructureAwareEngine(g, program, cfg).run(trace=trace)
    eng = StructureAwareEngine(g, program, cfg)
    monkeypatch.setattr(StructureAwareEngine, "_get_chunk",
                        _guarded(StructureAwareEngine._get_chunk))
    got = eng.run(trace=trace)
    assert np.array_equal(got.values, want.values)
    assert _run_key(got) == _run_key(want)
    assert got.timeline == want.timeline
    if prog == "sssp":  # and the lane engine's chunks, L = 8
        fam = A.k_source_sssp()
        values0, _ = fam.lane_init(g.n, list(range(0, 4000, 500)))
        kw = dict(ed=eng.edge_state, coupling=eng._coupling,
                  values0=values0, vconst=None,
                  lane_active=np.ones(8, bool), edge_counts=eng.edge_counts)
        want = LaneEngine(eng, fam).run(**kw)
        monkeypatch.setattr(LaneEngine, "_get_chunk",
                            _guarded(LaneEngine._get_chunk))
        got = LaneEngine(eng, fam).run(**kw)
        assert np.array_equal(got.values, want.values)
        assert np.array_equal(got.lane_iterations, want.lane_iterations)
        assert _run_key(got) == _run_key(want)


def test_analysis_cli_on_the_card(card):
    """python -m repro_torch.analysis --check on the card: the lint, the
    contracts enforced on cuda (kernels 1 and 1l through the tiny
    engines), the golden file skipped (recorded on the CPU)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check"],
        capture_output=True, text=True, cwd=root, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s) [lint+trace (44 contracts)]" in out.stdout


def _slate_vs_plain(program, n_total, ed, c, n_live, values, rows, ok, psd0,
                    floor=None, depth=1):
    """One slate through the kernel on the card and through the plain
    version on CPU copies of the same inputs; returns both results."""
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    out = []
    for dev, e in (("cuda", ed), ("cpu", ed_cpu)):
        v = torch.from_numpy(values.copy()).to(dev)
        p = torch.from_numpy(psd0.copy()).to(dev)
        d = torch.full(psd0.shape, -1.0, device=dev)
        sc = kb.make_scratch(e, c)
        r, k = torch.from_numpy(rows).to(dev), torch.from_numpy(ok).to(dev)
        for i in range(depth):
            kw = dict(block_size=c, n_live=n_live, first=i == 0,
                      last=i == depth - 1)
            if dev == "cpu":
                kb.block_sweep_ref(program, n_total, e, v, r, k, p, d, sc,
                                   floor=floor, **kw)
            elif floor is None:
                kb.block_sweep(program, n_total, e, v, r, k, p, d, sc, **kw)
            else:
                kb.masked_block_sweep(program, n_total, e, v, r, k, p, d, sc,
                                      floor=floor, **kw)
        out.append((v.cpu(), p.cpu(), d.cpu()))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_masked_kernel_matches_plain(card, prog):
    cfg = EngineConfig(block_size=128, width=8, t2=1e-9, subblocks=4)
    eng = StructureAwareEngine(_graph(prog), A.REGISTRY[prog](), cfg)
    P, c = eng.plan.num_blocks, cfg.block_size
    rng = np.random.default_rng(1)
    floor = np.float32(eng._psd_floor())
    values = rng.uniform(0.0, 1e-3, eng._values_len).astype(np.float32)
    psd0 = np.where(rng.random((P, 4)) < 0.5, 1.0, floor / 2).astype(
        np.float32)
    ok = rng.random(P) < 0.7
    # a cold slate of every block, then one-slot hot chains of 3 passes
    slates = [(np.arange(P, dtype=np.int32), ok, 1)] + [
        (np.array([b], np.int32), np.ones(1, bool), 3)
        for b in rng.choice(P, 6, replace=False)]
    for rows, k, depth in slates:
        gpu, cpu = _slate_vs_plain(eng.program, eng.plan.graph.n,
                                   eng.edge_state, c, eng.plan.n_live,
                                   values, rows, k, psd0, floor, depth)
        for a, b in zip(gpu, cpu):
            assert torch.equal(a, b)


@pytest.mark.parametrize("algo", ["pagerank", "cc"])
def test_kernels_on_mutated_layout_match_plain(card, algo):
    """Kernel 1 and 1m against the plain version on a streaming engine's
    tiles after appends and kills (PageRank) or rebuilt runs (CC), for a
    sum, a min and a max program over the same tiles."""
    from repro_torch.stream import StreamingEngine, synthetic_stream
    g = G.powerlaw_graph(6000, 8, seed=3)
    cfg = EngineConfig(block_size=128, width=8, t2=1e-9, subblocks=4)
    se = StreamingEngine(g, A.REGISTRY[algo](), cfg)
    reports = [se.ingest(b) for b in synthetic_stream(g, 2, 400, seed=5,
                                                      delete_frac=0.4)]
    assert sum(r.rebuilt_blocks if algo == "cc" else r.appended_blocks
               for r in reports) > 0
    eng = se.engine
    ed, c, P = eng.edge_state, cfg.block_size, eng.plan.num_blocks
    ed = ed._replace(aux=torch.rand(ed.aux.numel(), device="cuda") + 1.0)
    rng = np.random.default_rng(2)
    values = rng.uniform(0.0, 1e-3, eng._values_len).astype(np.float32)
    rows, ok = np.arange(P, dtype=np.int32), np.ones(P, bool)
    for prog in (A.pagerank(), A.sssp(0), A.cc()):
        for floor, nsub in ((None, 1), (np.float32(1e-6), 4)):
            psd0 = np.where(rng.random((P, nsub)) < 0.6, 1.0, 0.0).astype(
                np.float32)
            gpu, cpu = _slate_vs_plain(prog, eng.plan.graph.n, ed, c,
                                       eng.plan.n_live, values, rows, ok,
                                       psd0, floor)
            for a, b in zip(gpu, cpu):
                assert torch.equal(a, b), (algo, prog.combine, nsub)


@pytest.mark.parametrize("s_sub", [1, 8])
@pytest.mark.parametrize("prog", ["pagerank", "sssp", "cc"])
def test_kernels_on_long_runs_and_hub_pass_match_plain(card, prog, s_sub):
    """Kernels 1 (S = 1) and 1m (S = 8) against the plain version on a
    hand-built layout (``_torch_parity.hub_edge_data``): tiles that are
    one 512-slot run each, a hub destination of 1200 partials (the fold's
    warp chain), and a block laid out as a stream leaves it; a one-slot
    pass of the hub block at depth 1 and 3, and a slate of both blocks."""
    from _torch_parity import hub_edge_data
    rng = np.random.default_rng(7)
    ed = hub_edge_data(s_sub, rng)
    ed = type(ed)(*(t.cuda() for t in ed))
    c = 64
    values = rng.uniform(0.0, 1e-2, 2 * c).astype(np.float32)
    psd0 = np.where(rng.random((2, s_sub)) < 0.6, 1.0, 0.0).astype(
        np.float32)
    psd0[0, 0] = 1.0  # the hub's sub-range is live
    floor = np.float32(1e-3) if s_sub > 1 else None
    for rows, depth in (([0], 1), ([0], 3), ([1, 0], 1)):
        gpu, cpu = _slate_vs_plain(
            A.REGISTRY[prog](), 2 * c - 5, ed, c, 2 * c - 5, values,
            np.array(rows, np.int32), np.ones(len(rows), bool), psd0, floor,
            depth)
        for a, b in zip(gpu, cpu):
            assert torch.equal(a, b), (prog, s_sub, rows, depth)


@pytest.mark.parametrize("algo", ["pagerank", "sssp"])
def test_stream_on_card_matches_cpu(card, algo):
    from repro_torch.stream import StreamingEngine, synthetic_stream
    g = G.powerlaw_graph(6000, 8, seed=4, weighted=algo == "sssp")
    cfg = EngineConfig(block_size=128, width=8, t2=1e-9, subblocks=4)
    batches = synthetic_stream(g, 3, 200, seed=6, delete_frac=0.3,
                               weighted=algo == "sssp")
    gpu = StreamingEngine(g, A.REGISTRY[algo](), cfg)
    cpu = StreamingEngine(g, A.REGISTRY[algo](), cfg, device="cpu")
    kb.masked_block_sweep.launches = 0
    for b in batches:
        rg, rc = gpu.ingest(b), cpu.ingest(b)
        assert np.array_equal(gpu.values, cpu.values)
        assert (rg.iterations, rg.bytes_uploaded, rg.dirty_subblocks) == \
            (rc.iterations, rc.bytes_uploaded, rc.dirty_subblocks)
    assert kb.masked_block_sweep.launches > 0
    for a, b in zip(gpu.engine.edge_state, cpu.engine.edge_state):
        assert torch.equal(a.cpu(), b)


def _lane_inputs(eng, fam, lanes, rng):
    n_pad = eng._values_len
    if fam == "ppr":
        v = rng.uniform(0.0, 1e-3, (n_pad, lanes)).astype(np.float32)
        vc = np.where(rng.random((n_pad, lanes)) < 0.01, 0.5, 0.0)
        return v, vc.astype(np.float32)
    v = np.where(rng.random((n_pad, lanes)) < 0.4, A.INF,
                 rng.uniform(0.0, 30.0, (n_pad, lanes))).astype(np.float32)
    return v, np.zeros_like(v)


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("fam", ["sssp", "bfs", "ppr"])
def test_lane_kernel_matches_plain(card, fam, s):
    """Kernels 1l (S = 1) and 1lm (S = 4) against their plain version at
    L = 8, on a cold slate and on 3-pass hot chains, bitwise."""
    host = "pagerank" if fam == "ppr" else fam
    cfg = EngineConfig(block_size=128, width=8, t2=1e-9, subblocks=s)
    eng = StructureAwareEngine(_graph(host), A.REGISTRY[host](), cfg)
    P, c, lanes = eng.plan.num_blocks, cfg.block_size, 8
    rng = np.random.default_rng(3)
    prog = A.LANE_FAMILIES[fam]()
    values, vconst = _lane_inputs(eng, fam, lanes, rng)
    floor = np.float32(eng._psd_floor()) if s > 1 else None
    psd0 = np.where(rng.random((P, s, lanes)) < 0.3, 1.0,
                    np.float32(eng._psd_floor()) / 2).astype(np.float32)
    done = np.zeros(lanes, bool)
    done[[1, 5]] = True
    ed = eng.edge_state
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    slates = [(np.arange(P, dtype=np.int32), rng.random(P) < 0.7, 1)] + [
        (np.array([b], np.int32), np.ones(1, bool), 3)
        for b in rng.choice(P, 4, replace=False)]
    for rows, ok, depth in slates:
        out = []
        for dev, e in (("cuda", ed), ("cpu", ed_cpu)):
            v = torch.from_numpy(values.copy()).to(dev)
            p = torch.from_numpy(psd0.copy()).to(dev)
            d = torch.full(psd0.shape, -1.0, device=dev)
            args = [torch.from_numpy(a).to(dev) for a in (vconst, rows, ok)]
            sc = kb.make_lane_scratch(e, c, lanes)
            for i in range(depth):
                kw = dict(block_size=c, n_live=eng.plan.n_live,
                          first=i == 0, last=i == depth - 1)
                call = [prog, eng.plan.graph.n, e, v, *args, p, d,
                        torch.from_numpy(done).to(dev), sc]
                if dev == "cpu":
                    kb.lane_block_sweep_ref(*call, floor=floor, **kw)
                elif floor is None:
                    kb.lane_block_sweep(*call, **kw)
                else:
                    kb.masked_lane_block_sweep(*call, floor=floor, **kw)
            out.append((v.cpu(), p.cpu(), d.cpu()))
        torch.cuda.synchronize()
        for a, b in zip(*out):
            assert torch.equal(a, b), (fam, s, depth)


@pytest.mark.parametrize("s_sub", [1, 8])
@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("fam", ["sssp", "bfs", "ppr"])
@pytest.mark.parametrize("layout", ["hub", "window"])
def test_lane_kernels_on_long_runs_and_hub_pass_match_plain(card, layout,
                                                            fam, lanes,
                                                            s_sub):
    """Kernels 1l (S = 1) and 1lm (S = 8) through the kernel itself against
    the plain version on CPU copies, bitwise, on hand-built layouts
    (``_torch_parity``): ``hub_edge_data``, tiles that are one 512-slot run
    each (carried across the chunks of a warp's gather), a hub destination
    of 1200 partials (the fold's warp chain) and a block laid out as a
    stream leaves it; ``window_edge_data``, tiles whose first chunk ends a
    round of (run, lane) pairs at the end of a warp's window of runs. A
    one-slot pass of the first block at depth 8 and a slate of every block,
    with a third of the lanes done."""
    from _torch_parity import hub_edge_data, window_edge_data
    rng = np.random.default_rng(11)
    if layout == "hub":
        ed_cpu, c, nb = hub_edge_data(s_sub, rng), 64, 2
    else:
        ed_cpu, c, nb = window_edge_data(s_sub, rng), 512, 3
    ed = type(ed_cpu)(*(t.cuda() for t in ed_cpu))
    n_live = nb * c - 5
    prog = A.LANE_FAMILIES[fam]()
    if fam == "ppr":
        values = rng.uniform(0.0, 1e-2, (nb * c, lanes)).astype(np.float32)
        vconst = np.where(rng.random(values.shape) < 0.1, 0.5, 0.0)
    else:
        values = np.where(rng.random((nb * c, lanes)) < 0.4, A.INF,
                          rng.uniform(0.0, 30.0, (nb * c, lanes)))
        vconst = np.zeros_like(values)
    values, vconst = values.astype(np.float32), vconst.astype(np.float32)
    psd0 = np.where(rng.random((nb, s_sub, lanes)) < 0.6, 1.0,
                    0.0).astype(np.float32)
    psd0[:, 0, 0] = 1.0  # every block's first sub-range is live
    done = np.arange(lanes) % 3 == 1
    floor = np.float32(1e-3) if s_sub > 1 else None
    for rows, depth in (([0], 8), (list(range(nb))[::-1], 1)):
        out = []
        for dev, e in (("cuda", ed), ("cpu", ed_cpu)):
            v = torch.from_numpy(values.copy()).to(dev)
            p = torch.from_numpy(psd0.copy()).to(dev)
            d = torch.full(psd0.shape, -1.0, device=dev)
            args = [torch.from_numpy(a).to(dev) for a in (
                vconst, np.array(rows, np.int32), np.ones(len(rows), bool))]
            sc = kb.make_lane_scratch(e, c, lanes)
            for i in range(depth):
                kw = dict(block_size=c, n_live=n_live, first=i == 0,
                          last=i == depth - 1)
                call = [prog, n_live, e, v, *args, p, d,
                        torch.from_numpy(done).to(dev), sc]
                if dev == "cpu":
                    kb.lane_block_sweep_ref(*call, floor=floor, **kw)
                elif floor is None:
                    kb.lane_block_sweep(*call, **kw)
                else:
                    kb.masked_lane_block_sweep(*call, floor=floor, **kw)
            out.append((v.cpu(), p.cpu(), d.cpu()))
        torch.cuda.synchronize()
        for a, b in zip(*out):
            assert torch.equal(a, b), (fam, lanes, s_sub, rows, depth)


@pytest.mark.parametrize("fam", ["sssp", "bfs"])
def test_one_lane_kernel_is_kernel_1(card, fam):
    eng = StructureAwareEngine(_graph(fam), A.REGISTRY[fam](), CFG)
    P, c = eng.plan.num_blocks, CFG.block_size
    values = _lane_inputs(eng, fam, 1, np.random.default_rng(4))[0]
    rows = torch.arange(P, dtype=torch.int32, device="cuda")
    ok = torch.ones(P, dtype=torch.bool, device="cuda")
    kw = dict(block_size=c, n_live=eng.plan.n_live)
    lv = torch.from_numpy(values.copy()).cuda()
    lp, ld = torch.zeros(P, 1, 1).cuda(), torch.zeros(P, 1, 1).cuda()
    kb.lane_block_sweep(A.LANE_FAMILIES[fam](), eng.plan.graph.n, eng._ed,
                        lv, torch.zeros_like(lv), rows, ok, lp, ld,
                        torch.zeros(1, dtype=torch.bool, device="cuda"),
                        kb.make_lane_scratch(eng._ed, c, 1), **kw)
    sv = torch.from_numpy(values[:, 0].copy()).cuda()
    sp, sd = torch.zeros(P, 1).cuda(), torch.zeros(P, 1).cuda()
    kb.block_sweep(eng.program, eng.plan.graph.n, eng._ed, sv, rows, ok, sp,
                   sd, kb.make_scratch(eng._ed, c), **kw)
    torch.cuda.synchronize()
    assert torch.equal(lv[:, 0], sv)
    assert torch.equal(lp.view(P, 1), sp) and torch.equal(ld.view(P, 1), sd)


@pytest.mark.parametrize("s", [1, 4])
def test_service_on_card_matches_cpu(card, s):
    """A query service on the card answers like the same service on the
    CPU, bitwise, through the lane kernel (1l at S = 1, 1lm at S = 4)."""
    from repro_torch.serve import Query, QueryService
    from repro_torch.stream import StreamingEngine, synthetic_stream
    g = G.powerlaw_graph(6000, 8, seed=5, weighted=True)
    cfg = EngineConfig(block_size=128, width=8, t2=1e-9, subblocks=s)
    batch = synthetic_stream(g, 1, 200, seed=7, delete_frac=0.3,
                             weighted=True)[0]
    answers = []
    kb.lane_block_sweep.launches = kb.masked_lane_block_sweep.launches = 0
    for dev in ("cuda", "cpu"):
        svc = QueryService(StreamingEngine(g, A.sssp(0), cfg, device=dev),
                           max_lanes=4)
        for src in (1, 50, 700):
            svc.submit(Query(kind="sssp", source=src))
        svc.submit(Query(kind="bfs", source=9))
        svc.ingest(batch)
        svc.submit(Query(kind="sssp", source=2))
        answers.append([(r.epoch, r.iterations, r.values)
                        for r in svc.run_pending()])
    assert (kb.lane_block_sweep.launches if s == 1
            else kb.masked_lane_block_sweep.launches) > 0
    for (ea, ia, va), (eb, ib, vb) in zip(*answers):
        assert (ea, ia) == (eb, ib) and np.array_equal(va, vb)


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_segment_kernels_match_plain(card, combine):
    """Kernels 2 and 3 on the card against their plain version on CPU
    copies: bitwise, sums included, on group rows with sorted prefixes,
    unsorted stretches and padded tails of dst 0, through a group layout,
    a layout of each row's prefix (as the block processor calls them) and
    a one-row layout; a CUDA call without a layout raises."""
    from repro_torch.kernels import segment as ks
    rng = np.random.default_rng(4)
    c, e = 1024, 70000
    rows = []
    for r in range(4):
        d = rng.integers(0, c, e).astype(np.int32)
        if r % 2 == 0:
            d[:e // 2] = np.sort(d[:e // 2])
            d[e - e // 3:] = 0
        rows.append(d)
    dst = torch.from_numpy(np.stack(rows)).cuda()
    layout = ks.segment_layout(dst, c)
    ends = [e, e - e // 3, 5000, 511]
    prefix = ks.segment_layout(dst, c, ends)
    ident = {"sum": (), "min": (1e18,), "max": (-1e18,)}[combine]
    kernel = getattr(ks, f"edge_block_{combine}")
    plain = getattr(ks, f"edge_block_{combine}_ref")
    n0 = kernel.launches
    for r in range(4):
        msg = torch.from_numpy(rng.uniform(0.0, 1.0, e).astype(
            np.float32)).cuda()
        got = kernel(msg, dst[r], c, *ident, layout=layout, row=np.int64(r))
        one = dst[r].clone()
        alone = kernel(msg, one, c, *ident,
                       layout=ks.segment_layout(one, c))
        want = plain(msg.cpu(), dst[r].cpu(), c, *ident)
        k = ends[r]
        pre = kernel(msg[:k], dst[r, :k], c, *ident, layout=prefix, row=r)
        want_pre = plain(msg[:k].cpu(), dst[r, :k].cpu(), c, *ident)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want) and torch.equal(alone.cpu(), want)
        assert torch.equal(pre.cpu(), want_pre)
    assert kernel.launches == n0 + 12
    with pytest.raises(ValueError, match="layout's row"):
        kernel(msg, dst[1], c, *ident, layout=layout, row=0)
    with pytest.raises(ValueError, match="segment_layout"):
        kernel(msg, dst[1], c, *ident)


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_segment_kernels_match_plain_sorted(card, combine):
    """Kernels 2 and 3 on rows sorted by destination (the distributed
    engine's rows) against their plain version on CPU copies, bit for bit
    (the sign of zero included): a long row (a destination of ~41 pieces:
    a lane per piece, then a warp per destination), short rows (a lane per
    destination, one launch) with empty destinations and destinations of
    -0.0 messages, prefixes of 1, 511, 512 and 513 slots, through a group
    layout, a prefix layout and one-row layouts, on messages in a buffer
    aligned to 16 bytes and in a view that is not; each call counts one
    launch."""
    from repro_torch.kernels import segment as ks
    rng = np.random.default_rng(5)
    c, e = 1024, 60000
    rows = [np.sort(rng.integers(0, c, e)).astype(np.int32)
            for _ in range(3)]
    rows[0][7000:28000] = 300  # ~41 pieces into one destination
    rows[0] = np.sort(rows[0])
    rows[1] = np.sort(np.minimum(rows[1] // 3 * 3, c - 1))  # empty ones
    dst = torch.from_numpy(np.stack(rows)).cuda()
    ends = [e, 513, 512]
    layout, prefix = ks.segment_layout(dst, c), ks.segment_layout(dst, c,
                                                                   ends)
    assert layout.path.tolist() == [ks.LONG, ks.SHORT, ks.SHORT]
    assert prefix.path.tolist() == [ks.LONG, ks.SHORT, ks.SHORT]
    ident = {"sum": (), "min": (1e18,), "max": (-1e18,)}[combine]
    kernel = getattr(ks, f"edge_block_{combine}")
    plain = getattr(ks, f"edge_block_{combine}_ref")

    def same(got, want):
        return torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))

    n0, calls = kernel.launches, 0
    for r in range(3):
        buf = torch.from_numpy(rng.uniform(-1.0, 1.0, e + 1).astype(
            np.float32)).cuda()
        # every message of two destinations -0.0, in both views
        for v in (rows[r][5], rows[r][-5]):
            zero = torch.from_numpy(np.flatnonzero(rows[r] == v)).cuda()
            buf[zero] = -0.0
            buf[zero + 1] = -0.0
        for msg in (buf[:e], buf[1:]):  # the second is not 16-B aligned
            want = plain(msg.cpu(), dst[r].cpu(), c, *ident)
            got = kernel(msg, dst[r], c, *ident, layout=layout, row=r)
            one = dst[r].clone()
            alone = kernel(msg, one, c, *ident,
                           layout=ks.segment_layout(one, c))
            for k in (ends[r], 1, 511):
                lay = (prefix if k == ends[r] else
                       ks.segment_layout(dst[r], c, [k]))
                pre = kernel(msg[:k], dst[r, :k], c, *ident, layout=lay,
                             row=r if k == ends[r] else 0)
                want_pre = plain(msg[:k].cpu(), dst[r, :k].cpu(), c, *ident)
                torch.cuda.synchronize()
                assert same(pre, want_pre), (r, k)
            torch.cuda.synchronize()
            assert same(got, want) and same(alone, want), r
            calls += 5
    assert kernel.launches == n0 + calls


@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_distributed_on_card_matches_cpu(card, prog):
    """The distributed engine (a world of one) on the card equals the same
    run on the CPU bitwise, counters included: the kernels repeat their
    plain versions' order."""
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.kernels import segment as ks
    g, program = _graph(prog), A.REGISTRY[prog]()
    cfg = EngineConfig(block_size=256, width=8, t2=1e-9, hot_inner_iters=4)
    kernel = {"sum": ks.edge_block_sum, "min": ks.edge_block_min,
              "max": ks.edge_block_max}[program.combine]
    n0 = kernel.launches
    gpu = DistributedEngine(g, program, cfg, blocks_per_device=4).run()
    assert kernel.launches > n0
    cpu = DistributedEngine(g, program, cfg, blocks_per_device=4,
                            device="cpu").run()
    assert np.array_equal(gpu.values, cpu.values)
    for f in ("iterations", "updates", "block_loads", "bytes_loaded"):
        assert getattr(gpu.metrics, f) == getattr(cpu.metrics, f), f


@pytest.mark.parametrize("arch", ["llama3p2_1b", "yi_6b", "qwen3_14b",
                                  "mistral_nemo_12b", "phi3_vision_4p2b"])
@pytest.mark.parametrize("s", [128, 512, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(card, arch, s, causal, dtype):
    """Kernel 4 against its plain version on the card, on the same inputs,
    at the archs' head shapes (phi3_vision_4p2b's 32/32 heads of 96: the
    D = 96 instantiation of both routes): f32 (the CUDA-core route) at
    2e-5, the plain version's matmuls in full f32, no TF32; bf16 (the
    tensor-core route) at 2e-2."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = configs.get(arch)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v = (torch.randn(2, h, s, d, generator=gen, device="cuda").to(
        getattr(torch, dtype)) for h in (hq, hkv, hkv))
    n0 = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == n0 + 1
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_takes_views_and_refuses_other_head_dims(card):
    """The wrapper takes the model's transposed views: the f32 route makes
    them contiguous (its CUDA-core kernel reads contiguous tensors), the
    bf16 route reads them in place (test_flash_attention_reads_strided_bf16);
    a head dim the kernel lacks raises."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 256, h, 64, generator=gen, device="cuda")
               for h in (8, 2, 2))
    got = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    want = FA.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    q = torch.zeros(1, 2, 128, 32, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(q, q, q)


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_reads_strided_bf16(card, d, causal):
    """The tensor-core route reads q, k and v through their strides: the
    model's (B, S, H, D) projections, transposed to (B, H, S, D) views,
    give the contiguous call's output bitwise, and nothing is copied."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(d + causal)
    q, k, v = (torch.randn(2, 384, h, d, generator=gen, device="cuda").to(
        torch.bfloat16) for h in (10, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert all(FA._strides_ok(t) and not t.is_contiguous() for t in views)
    got = FA.flash_attention(*views, causal=causal)
    want = FA.flash_attention(*(t.contiguous() for t in views), causal=causal)
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got, want)
    plain = FA.flash_attention_ref(*views, causal=causal)
    torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_d96_on_views(card, causal, dtype):
    """Kernel 4 at D = 96 on the model's transposed (B, S, H, D) views, an
    odd GQA group (12 q heads over 4 kv heads) and S = 640, past four
    128-key tiles: both routes against the plain version (f32 2e-5, bf16
    2e-2), the bf16 route bitwise its own contiguous call's, and no launch
    at D = 96 falls back on another head dim's instantiation."""
    from repro_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(96 + causal)
    views = [torch.randn(2, 640, h, 96, generator=gen, device="cuda").to(
        getattr(torch, dtype)).transpose(1, 2) for h in (12, 4, 4)]
    n0 = FA.flash_attention.launches
    got = FA.flash_attention(*views, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == n0 + 1
    assert got.shape == (2, 12, 640, 96) and got.is_contiguous()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(
        got.float(), FA.flash_attention_ref(*views, causal=causal).float(),
        rtol=tol, atol=tol)
    if dtype == "bfloat16":
        assert torch.equal(got, FA.flash_attention(
            *(t.contiguous() for t in views), causal=causal))


@pytest.mark.parametrize("arch", ["llama3p2_1b", "qwen3_14b"])
def test_prefill_with_kernel_matches_plain_route(card, arch):
    """prefill(use_kernel=True) against prefill(use_kernel=False) on the
    card, a reduced config at head_dim 64 (the kernel's smallest) with
    every layer's wo drawn nonzero: kernel 4 launched once per layer, the
    logits and caches within the bf16 bar of 5e-2."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              head_dim=64)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = M.init_params(cfg, gen)
    with torch.no_grad():
        for layer in params.layers:
            layer.attn.wo.normal_(0.0, (cfg.num_heads * 64) ** -0.5,
                                  generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                        device="cuda")
    out = {}
    for use_kernel in (True, False):
        cache = M.init_cache(cfg, 2, 260)
        n0 = FA.flash_attention.launches
        out[use_kernel] = M.prefill(params, cfg, {"tokens": tok}, cache,
                                    use_kernel=use_kernel)
        assert FA.flash_attention.launches - n0 == (
            cfg.num_layers if use_kernel else 0)
    (lk, ck), (lp, cp) = out[True], out[False]
    torch.testing.assert_close(lk.float(), lp.float(), rtol=5e-2, atol=5e-2)
    for key in ("k", "v"):
        torch.testing.assert_close(ck[key].float(), cp[key].float(),
                                   rtol=5e-2, atol=5e-2)


def _ssd_inputs(gen, g, q, n, p, h=None, decay=0.1):
    lead = (g, q) if h is None else (g, q, h)
    c, b = (torch.randn(g, q, n, generator=gen, device="cuda")
            for _ in range(2))
    u = torch.randn(*lead, p, generator=gen, device="cuda")
    ld = torch.cumsum(-decay * torch.rand(*lead, generator=gen,
                                          device="cuda"), dim=1)
    return c, b, u, ld


def _ssd_close(got, want, rtol, afac):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=afac * float(want.abs().max()))


@pytest.mark.parametrize("g,q,n,p", [(4, 64, 32, 16), (2, 128, 128, 64),
                                     (6, 128, 64, 128), (3, 100, 16, 32),
                                     (2, 256, 128, 64), (2, 256, 16, 64),
                                     (3, 128, 20, 32), (2, 256, 36, 64),
                                     (2, 576, 16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_matches_plain(card, g, q, n, p, dtype):
    """Kernel 5 against its plain version on the card, on the same inputs:
    the reference test's shapes, a ragged Q, the models' chunk, N that is
    4 mod 8 (zero-padded to whole 32-column chunks) and a chunk past one
    256-key Gram panel; f32 at rtol=1e-5, atol=1e-4 * max|y| (the plain version's
    matmuls in full f32), bf16 at 2e-2 * max|y|."""
    from repro_torch.kernels import ssd_scan as SSD
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(g * q + n + p)
    c, b, u, ld = (t.to(getattr(torch, dtype)) if t.dim() == 3 else t
                   for t in _ssd_inputs(gen, g, q, n, p))
    n0 = SSD.ssd_intra_chunk.launches
    got = SSD.ssd_intra_chunk(c, b, u, ld)
    want = SSD.ssd_intra_chunk_ref(c, b, u, ld)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches == n0 + 1
    assert got.dtype == u.dtype and got.shape == u.shape
    assert torch.isfinite(got.float()).all()
    tol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    _ssd_close(got, want, *tol)


@pytest.mark.parametrize("g,q,n,p,h", [(4, 256, 128, 64, 5),
                                       (2, 256, 16, 64, 25),
                                       (2, 256, 128, 64, 80),
                                       (3, 100, 20, 32, 25)])
def test_ssd_intra_chunk_heads_form_and_views(card, g, q, n, p, h):
    """The heads form (b and c shared by the heads, u and ld read in the
    model's strided layout) equals the one-head form on each head; the
    wrapper takes strided views and mixed dtypes (f32 c and b, bf16 u:
    the result in u's dtype), keeps finite where exp(l_q - l_s) overflows
    above the diagonal, and refuses a P the kernel lacks. Head counts that
    are no multiple of the kernel's head group (hymba's 25, mamba2's 80 at
    a few cells), a ragged Q and an N that is 4 mod 8 included."""
    from repro_torch.kernels import ssd_scan as SSD
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    c, b, u, ld = _ssd_inputs(gen, g, q, n, p, h=h, decay=2.0)
    assert float((-ld[:, -1]).max()) > 88.7  # overflows above the diagonal
    got = SSD.ssd_intra_chunk(c, b, u, ld)
    assert torch.isfinite(got).all()
    for i in range(h):
        one = SSD.ssd_intra_chunk(c, b, u[:, :, i], ld[:, :, i])
        _ssd_close(got[:, :, i], one, 1e-5, 1e-4)
    _ssd_close(got, SSD.ssd_intra_chunk_ref(c, b, u, ld), 1e-5, 1e-4)
    ut = u.transpose(0, 1).contiguous().transpose(0, 1)  # a strided view
    _ssd_close(SSD.ssd_intra_chunk(c, b, ut, ld), got, 1e-5, 1e-4)
    mixed = SSD.ssd_intra_chunk(c, b, u.bfloat16(), ld)
    assert mixed.dtype == torch.bfloat16
    _ssd_close(mixed, SSD.ssd_intra_chunk_ref(c, b, u.bfloat16(), ld),
               2e-2, 2e-2)
    with pytest.raises(ValueError, match="the kernel takes P"):
        SSD.ssd_intra_chunk(c, b, u[..., :8], ld)


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "hymba_1p5b"])
def test_ssm_prefill_with_kernel_matches_plain_route(card, arch):
    """prefill(use_kernel=True) against prefill(use_kernel=False) on the
    card at a reduced config (head dims 64, the models' chunk of 256) in
    f32, every wo drawn nonzero: kernel 5 (and kernel 4 for hymba)
    launched once per layer, the logits and caches within 1e-4."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                              head_dim=64, ssm_head_dim=64, ssm_state=16,
                              ssm_chunk=256, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = M.init_params(cfg, gen)
    if cfg.has_attention:
        with torch.no_grad():
            for layer in params.layers:
                layer.attn.wo.normal_(0.0, (cfg.num_heads * 64) ** -0.5,
                                      generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                        device="cuda")
    out = {}
    for use_kernel in (True, False):
        cache = M.init_cache(cfg, 2, 516)
        n4, n5 = FA.flash_attention.launches, SSD.ssd_intra_chunk.launches
        out[use_kernel] = M.prefill(params, cfg, {"tokens": tok}, cache,
                                    use_kernel=use_kernel)
        want = cfg.num_layers if use_kernel else 0
        assert SSD.ssd_intra_chunk.launches - n5 == want
        assert FA.flash_attention.launches - n4 == (
            want if cfg.has_attention else 0)
    (lk, ck), (lp, cp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
    for key in set(ck) - {"pos"}:
        torch.testing.assert_close(ck[key], cp[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_moe_16b",
                                  "phi3_vision_4p2b", "whisper_base"])
def test_new_family_prefill_with_kernel_matches_plain_route(card, arch):
    """prefill(use_kernel=True) against prefill(use_kernel=False) on the
    card for the moe, vlm and audio families, a reduced config in f32 at
    head_dim 64 (96 for phi3_vision_4p2b, its own) with every wo drawn
    nonzero: kernel 4 launched once per decoder layer (whisper's encoder
    and cross-attention take the plain routes), the logits and caches
    within 1e-4, the MoE's routes equal."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced(configs.get(arch))
    d = 96 if cfg.num_patches else 64
    cfg = dataclasses.replace(cfg, head_dim=d, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = M.init_params(cfg, gen)
    blocks = [layer.attn for layer in params.layers]
    if cfg.is_encdec:
        blocks += [layer.cross for layer in params.layers]
        blocks += [layer.attn for layer in params.enc_layers]
    with torch.no_grad():
        for block in blocks:
            block.wo.normal_(0.0, (cfg.num_heads * d) ** -0.5,
                             generator=gen)
    p = cfg.num_patches
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256 - p),
                                     generator=gen, device="cuda")}
    if p:
        batch["patches"] = torch.randn(2, p, cfg.d_model, generator=gen,
                                       device="cuda")
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, 100, cfg.d_model, generator=gen,
                                      device="cuda")
    out, routes = {}, {}
    real_route = moe.route
    for use_kernel in (True, False):
        calls = []

        def route(*args, **kw):
            r = real_route(*args, **kw)
            calls.append(r[3])
            return r
        moe.route = route
        try:
            cache = M.init_cache(cfg, 2, 260, enc_seq=100)
            n0 = FA.flash_attention.launches
            out[use_kernel] = M.prefill(params, cfg, batch, cache,
                                        use_kernel=use_kernel)
        finally:
            moe.route = real_route
        routes[use_kernel] = calls
        assert FA.flash_attention.launches - n0 == (
            cfg.num_layers if use_kernel else 0)
    assert len(routes[True]) == (cfg.num_layers if cfg.num_experts else 0)
    for a, b in zip(routes[True], routes[False]):
        assert torch.equal(a, b)
    (lk, ck), (lp, cp) = out[True], out[False]
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
    for key in set(ck) - {"pos"}:
        torch.testing.assert_close(ck[key], cp[key], rtol=1e-4, atol=1e-4)


def test_flash_attention_at_hymba_heads(card):
    """Kernel 4 at hymba_1p5b's heads: 25 q heads over 5 kv heads, an odd
    GQA group, D = 64."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("hymba_1p5b")
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(25)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.randn(2, h, 256, d, generator=gen,
                               device="cuda").to(dtype)
                   for h in (hq, hkv, hkv))
        got = FA.flash_attention(q, k, v)
        want = FA.flash_attention_ref(q, k, v)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
