"""The port's contract checker (src/repro_torch/analysis) against the
reference's (src/repro/analysis), on the CPU:

  * the lint gives the reference's (rule, line) findings on every reference
    fixture and every file of src/repro, and each torch fixture in
    tests/torch_analysis_fixtures makes its rule fire (and the CLI exit 1);
  * the registry carries the reference's 42 contracts through the module
    map and the one_executable_per table below;
  * the device select agrees with the reference's on TC003's trials;
  * the real tree is clean (the CLI exits 0 on --device cpu);
  * the golden op file round-trips, and drift, a missing file and another
    torch version or device are handled as the reference handles them;
  * the engines' runs, built on ``_get_chunk``, hold the reference's bar:
    SSSP and k_sssp lanes bitwise (values, counters, timeline rows),
    PageRank at rtol=1e-4, atol=1e-7; one chunk driven by hand equals the
    run it is part of, bitwise.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread, port_engine  # noqa: F401

from repro.analysis import contracts as j_contracts
from repro.analysis import lint as j_lint
from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import StructureAwareEngine as JEngine
from repro.serve.lanes import LaneEngine as JLaneEngine
from repro_torch.analysis import contracts, lint, tracecheck
from repro_torch.core import algorithms as A
from repro_torch.core import graph as G
from repro_torch.core import state as state_lib
from repro_torch.core.engine import (TIMELINE_FLOAT_COLS, TIMELINE_INT_COLS,
                                     EngineConfig, _hist_cap)
from repro_torch.core.metrics import COUNTER_FIELDS
from repro_torch.serve.lanes import LaneEngine

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
REF_FIXTURES = Path(__file__).parent / "analysis_fixtures"
REF_FILES = sorted(REF_FIXTURES.glob("*.py")) + sorted(
    p for p in (REPO / "src" / "repro").rglob("*.py")
    if "__pycache__" not in p.parts)

# the reference's compiled-function getters and the port's counterparts:
# one row per reference key (module, qualname) -> the port's keys
ONE_EXECUTABLE_PER = {
    ("repro.core.engine", "StructureAwareEngine._get_chunk"): (
        ("repro_torch.core.engine", "StructureAwareEngine._get_chunk"),),
    # the jitted hot/cold sweep per (sequential, width): the sweep
    # closures per width
    ("repro.core.engine", "StructureAwareEngine._get_fn"): (
        ("repro_torch.core.engine", "StructureAwareEngine._sweeps"),),
    # the donated row scatter per scatter type: the row commit per type
    ("repro.core.engine", "StructureAwareEngine._chunked_scatter"): (
        ("repro_torch.core.engine", "StructureAwareEngine._row_commit"),),
    # the lane chunk per width, and the lane sweeps it is built from
    ("repro.serve.lanes", "LaneEngine._get_chunk"): (
        ("repro_torch.serve.lanes", "LaneEngine._get_chunk"),
        ("repro_torch.serve.lanes", "LaneEngine._sweeps")),
    # the Pallas sweep factory memoized per (program, tile geometry, mode):
    # the lane scratch per tile geometry and the kernel library per source
    ("repro.kernels.block_sweep", "make_block_sweep"): (
        ("repro_torch.kernels.block_sweep", "make_lane_scratch"),
        ("repro_torch.kernels._build", "load")),
}


def _port_module(module: str) -> str:
    assert module.startswith("repro.")
    return "repro_torch." + module[len("repro."):]


def _run_cli(*args, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


# -- (a) the lint gives the reference's findings -----------------------------
@pytest.mark.parametrize("path", REF_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_lint_matches_reference(path):
    """On the reference's fixtures and sources the torch forms add
    nothing: the findings are the reference's, rule and line."""
    want = sorted((f.rule, f.line) for f in j_lint.lint_file(path))
    got = sorted((f.rule, f.line) for f in lint.lint_file(path))
    assert got == want


def test_lint_fires_on_reference_fixtures():
    rules = {f.rule for p in REF_FIXTURES.glob("bad_*.py")
             for f in lint.lint_file(p)}
    assert rules == {"RA001", "RA002", "RA003", "RA004"}


# -- (b) the torch fixtures ----------------------------------------------------
def _findings(name, rule):
    return [f for f in lint.lint_file(FIXTURES / name) if f.rule == rule]


def test_fixture_host_sync_fires_ra001():
    found = _findings("bad_host_sync.py", "RA001")
    msgs = " ".join(f.msg for f in found)
    # .item()/.cpu()/.tolist() in the _get_chunk-returned chunk; a host
    # value made a device tensor, torch.cuda.synchronize() and float() on
    # a parameter in the make_* pair
    for form in (".item()", ".cpu()", ".tolist()", "torch.tensor",
                 "torch.cuda.synchronize()", "float() on traced"):
        assert form in msgs, (form, found)
    assert {f.msg.split("'")[1] for f in found} == {"chunk", "hot_sweep",
                                                    "cold_sweep"}
    assert len(found) == 6


def test_fixture_loop_closure_fires_ra003():
    found = _findings("bad_loop_closure.py", "RA003")
    assert len(found) == 1 and "'i2'" in found[0].msg


def test_fixture_nondet_fires_ra004():
    found = _findings("bad_nondet.py", "RA004")
    # torch.rand, torch.manual_seed, torch.randint; not the seeded randperm
    assert sorted(f.msg.split("'")[1] for f in found) == [
        "torch.manual_seed", "torch.rand", "torch.randint"]


def test_allow_comment_suppresses(tmp_path):
    src = (FIXTURES / "bad_nondet.py").read_text().replace(
        "torch.manual_seed(0)", "torch.manual_seed(0)  # lint: allow(RA004)")
    path = tmp_path / "allowed.py"
    path.write_text(src)
    assert len([f for f in lint.lint_file(path) if f.rule == "RA004"]) == 2


@pytest.fixture
def registry_restored():
    """The registry as it was before the test: a fixture module's
    contracts must not reach later discoveries in this process."""
    saved = dict(contracts._REGISTRY)
    yield
    contracts._REGISTRY.clear()
    contracts._REGISTRY.update(saved)


def test_contract_fixture_fires_tc001_tc002(registry_restored):
    import torch_analysis_fixtures.bad_aux_gather as bad
    by_name = {c.qualname: c for c in contracts.registry()
               if c.module == bad.__name__}
    aux = tracecheck.check_elementwise(by_name["aux_fn"])
    assert [f.rule for f in aux] == ["TC001"] and "sort" in aux[0].msg
    host = tracecheck.check_elementwise(by_name["aux_fn_host"])
    assert [f.rule for f in host] == ["TC001"]
    init = tracecheck.check_structure_independent(by_name["init"])
    assert [f.rule for f in init] == ["TC002"]


def test_lint_clean_on_port_tree():
    assert lint.lint_paths([REPO / "src" / "repro_torch"]) == []


# -- (c) the registry ------------------------------------------------------------
def test_discovery_covers_the_reference_contracts():
    ref = {c.key: c for c in j_contracts.discover()}
    got = {c.key: c for c in contracts.discover()}
    assert len(ref) == 42
    # every kind but one_executable_per maps by module, one to one
    want = {(k, _port_module(m), q) for (k, m, q) in ref
            if k != "one_executable_per"}
    assert {key for key in got if key[0] != "one_executable_per"} == want
    for kind, module, qual in ref:
        if kind == "elementwise":  # the same probe shapes
            assert got[(kind, _port_module(module), qual)].meta == \
                ref[(kind, module, qual)].meta, qual
    # one_executable_per through the table: one row per reference key
    assert set(ONE_EXECUTABLE_PER) == {
        (m, q) for (k, m, q) in ref if k == "one_executable_per"}
    assert {(m, q) for (k, m, q) in got if k == "one_executable_per"} == {
        key for keys in ONE_EXECUTABLE_PER.values() for key in keys}
    assert {c.kind for c in got.values()} == {c.kind for c in ref.values()}
    # factory closures re-register under one key each
    n = len(got)
    assert len(contracts.discover()) == n


def test_decorators_stamp_the_definitions():
    from repro_torch.core.schedule import Scheduler, make_device_select
    from repro_torch.stream.engine import StreamingEngine
    assert make_device_select.__contract__ == "decision_identical"
    assert StreamingEngine._successors.__contract__ == "decision_identical"
    assert A.pagerank().aux_fn.__contract__ == "elementwise"
    assert A.k_source_bfs().lane_init.__contract__ == \
        "structure_independent"
    reg = {c.qualname: c for c in contracts.discover()}
    assert reg["make_device_select"].meta["twin"] is Scheduler.select


# -- (d) the device select against the reference's ------------------------------
def test_device_select_matches_reference():
    import jax.numpy as jnp

    from repro.core.schedule import make_device_select as j_select
    from repro_torch.core.schedule import make_device_select as t_select
    rng = np.random.default_rng(11)
    width, i2 = 4, 3
    js = j_select(width, 0.25, 1e-6, pad_id=0)
    ts = t_select(width, 0.25, 1e-6, pad_id=0)
    for trial in range(20):
        p = 8 if trial % 2 == 0 else 5
        shape = (p,) if trial % 3 else (p, 2)
        psd = (rng.random(shape) * rng.integers(0, 3, shape)
               ).astype(np.float32)
        is_hot = rng.random(p) < 0.5
        for it in range(4):
            want = js(jnp.int32(it), jnp.int32(i2), jnp.asarray(psd),
                      jnp.asarray(is_hot))
            got = ts(it, i2, torch.from_numpy(psd),
                     torch.from_numpy(is_hot))
            for w, g in zip(want, got):
                assert np.array_equal(np.asarray(w), g.numpy()), \
                    (trial, it)


def test_edge_store_successors_match_csr():
    """The @decision_identical pair of the stream: the EdgeStore-served
    out-edge oracle agrees with the CSR oracle on the mutated graph."""
    from repro_torch.stream import StreamingEngine, synthetic_stream
    g = G.powerlaw_graph(400, avg_deg=5, seed=9, weighted=True)
    se = StreamingEngine(g, A.sssp(0), EngineConfig(block_size=64, width=4,
                                                    t2=1e-9), device="cpu")
    se.ingest(synthetic_stream(g, 1, 50, seed=2, delete_frac=0.4,
                               weighted=True)[0])
    succ_g = A.graph_successors(se.current_graph())
    rng = np.random.default_rng(0)

    def norm(tri):
        return sorted(zip(tri[0].tolist(), tri[1].tolist(),
                          np.round(np.asarray(tri[2], np.float64),
                                   5).tolist()))

    for _ in range(5):
        frontier = np.unique(rng.integers(0, g.n, 20))
        assert norm(se._successors(frontier)) == norm(succ_g(frontier))


# -- (e) the trace layer on the real tree ------------------------------------
def test_trace_checks_clean_on_registered_contracts():
    assert tracecheck.check_contracts(contracts.discover(), "cpu") == []


def test_one_executable_per_catches_a_rebuilding_getter():
    """TC004 fires on a getter that builds a fresh object per call (the
    lane engine's sweeps before they were cached)."""
    def rebuilding(self, width):
        self._fns.pop(("sweeps", width), None)
        return LaneEngine._sweeps(self, width)

    bad = contracts.Contract(kind="one_executable_per",
                             module="repro_torch.serve.lanes",
                             qualname="LaneEngine._sweeps",
                             target=rebuilding)
    found = tracecheck.check_one_executable_per([bad], "cpu")
    assert [f.rule for f in found] == ["TC004", "TC004"]
    assert all("fresh object" in f.msg for f in found)


# -- (f) golden ops ----------------------------------------------------------
def test_golden_round_trips():
    committed = json.loads(tracecheck.GOLDEN_PATH.read_text())
    if committed["torch_version"] != torch.__version__:
        pytest.skip("golden recorded under another torch version")
    assert committed["device"] == "cpu"
    assert tracecheck.golden_entries("cpu") == committed["entries"]


def test_golden_drift_detected(tmp_path):
    """Drift against a file written at the RUNNING torch version (not the
    committed one, which another torch would skip)."""
    fake = tmp_path / "golden_ops.json"
    payload = tracecheck.write_golden(fake, "cpu")
    assert payload["torch_version"] == torch.__version__
    findings, status = tracecheck.check_golden(fake, "cpu")
    assert (findings, status) == ([], "ok")
    drifted = dict(payload, entries=dict(payload["entries"],
                                         device_select_w4="0" * 16))
    fake.write_text(json.dumps(drifted))
    findings, status = tracecheck.check_golden(fake, "cpu")
    assert status == "ok"
    assert [f.rule for f in findings] == ["TC005"]
    assert "device_select_w4" in findings[0].msg


def test_golden_missing_is_a_finding(tmp_path):
    findings, status = tracecheck.check_golden(tmp_path / "nope.json")
    assert status == "missing"
    assert [f.rule for f in findings] == ["TC005"]


@pytest.mark.parametrize("field,value", [("torch_version", "0.0.0"),
                                         ("device", "cuda")])
def test_golden_other_version_or_device_skips(tmp_path, field, value):
    committed = json.loads(tracecheck.GOLDEN_PATH.read_text())
    fake = tmp_path / "golden_ops.json"
    fake.write_text(json.dumps(dict(committed, **{field: value})))
    findings, status = tracecheck.check_golden(fake, "cpu")
    assert status == "skipped" and findings == []


def test_device_select_copies_nothing_from_the_host():
    """The select enqueues no tensor made from a host value (on a card a
    blocking copy that waits for the stream, once per superstep): the
    recorder sees such a tensor as ``lift_fresh``."""
    from repro_torch.core.schedule import make_device_select
    rec = tracecheck.OpRecorder()
    with rec:
        make_device_select(4, 0.25, 1e-6)(0, 4, torch.rand(8, 2),
                                          torch.rand(8) < 0.5)
    names = [f.overloadpacket.__name__ for f, _, _ in rec.ops]
    assert "sort" in names and "lift_fresh" not in names
    rec = tracecheck.OpRecorder()
    with rec:
        torch.tensor(float("inf"))
    assert [f.overloadpacket.__name__ for f, _, _ in rec.ops] == \
        ["lift_fresh"]


# -- (g) the CLI -------------------------------------------------------------
def test_cli_zero_on_clean_tree():
    r = _run_cli("--check", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s) [lint+trace (44 contracts)]" in r.stdout
    assert "golden ops: " in r.stdout


@pytest.mark.parametrize("name,rule", [("bad_host_sync.py", "RA001"),
                                       ("bad_loop_closure.py", "RA003"),
                                       ("bad_nondet.py", "RA004")])
def test_cli_nonzero_on_lint_fixture(name, rule):
    r = _run_cli("--check", "--no-trace", "--paths", str(FIXTURES / name))
    assert r.returncode == 1, r.stdout + r.stderr
    assert rule in r.stdout


def test_cli_nonzero_on_contract_fixture():
    r = _run_cli(
        "--check", "--device", "cpu", "--paths",
        str(FIXTURES / "bad_loop_closure.py"),
        "--extra-contracts", "torch_analysis_fixtures.bad_aux_gather",
        extra_env={"PYTHONPATH": str(REPO / "tests") + os.pathsep
                   + str(REPO / "src")})
    assert r.returncode == 1, r.stdout + r.stderr
    # the op denylist catches the argsort aux_fn; the concrete probe
    # catches the numpy mean-normalize; the two-graph differential
    # catches the degree-seeded init
    assert r.stdout.count("TC001") == 2
    assert "TC002" in r.stdout and "RA003" in r.stdout


def test_bytecode_guard_flags_staged_pyc(tmp_path, monkeypatch):
    from repro_torch.analysis import __main__ as cli
    # the real checkout must be clean
    assert cli.bytecode_guard() == []
    repo = tmp_path / "r"
    (repo / "src").mkdir(parents=True)
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
    bad = repo / "__pycache__"
    bad.mkdir()
    (bad / "m.cpython-312.pyc").write_bytes(b"\x00")
    subprocess.run(["git", "add", "-f", "__pycache__"], cwd=repo,
                   check=True)
    monkeypatch.setattr(cli, "REPO_SRC", repo / "src")
    found = cli.bytecode_guard()
    assert [(f.rule, f.path) for f in found] == [
        ("RA005", "__pycache__/m.cpython-312.pyc")]


# -- (h) the engines' runs, built on _get_chunk ------------------------------
KW = dict(t2=1e-9, width=4, block_size=64)
INT_COLS = TIMELINE_INT_COLS + ("width",)


def _graph(mod, prog):
    if prog == "pagerank":
        return mod.core_periphery_graph(1000, avg_deg=6, seed=4, chords=1)
    return mod.powerlaw_graph(900, avg_deg=5, seed=4, weighted=True)


def _run_key(res):
    m = res.metrics
    return (m.iterations, m.converged,
            tuple(getattr(m, f) for f in COUNTER_FIELDS))


@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_chunk_runs_match_reference(prog, s):
    jeng = JEngine(_graph(JG, prog), JA.REGISTRY[prog](),
                   JConfig(**KW, subblocks=s))
    teng = port_engine(jeng, A.REGISTRY[prog](),
                       EngineConfig(**KW, subblocks=s))
    ref = jeng.run(trace=True)
    got = teng.run(trace=True)
    assert got.metrics.converged and ref.metrics.converged
    if prog == "sssp":
        assert np.array_equal(got.values, ref.values)
        assert _run_key(got) == _run_key(ref)
        assert [[r[c] for c in INT_COLS] for r in got.timeline] == \
            [[r[c] for c in INT_COLS] for r in ref.timeline]
    else:
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-4,
                                   atol=1e-7)
    untraced = teng.run()
    assert np.array_equal(untraced.values, got.values)
    assert _run_key(untraced) == _run_key(got)
    # repeat runs build no chunk, sweep or commit: one object per key
    fns = dict(teng._fns)
    assert {k[0] for k in fns} == {"chunk", "sweeps"}
    teng.run()
    teng.run(trace=True)
    assert set(teng._fns) == set(fns) and all(
        teng._fns[k] is fns[k] for k in fns)


def _start(teng):
    """The device state at a cold run's first boundary (superstep 0)."""
    p, cfg = teng.plan, teng.config
    values, psd, _, rep, calm_host, i2 = teng._start_state(None)
    return dict(values=values, psd=psd, rep=rep, i2=i2,
                calm=torch.as_tensor(calm_host),
                dmax=torch.zeros((p.num_blocks, cfg.subblocks)))


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_hand_driven_chunk_equals_run(prog, s, traced):
    """One _get_chunk call from the start state, its span the run's first
    chunk, leaves what run(max_iterations=span) reports, bitwise: values,
    PSD, calm counters, block counts (the counters) and timeline rows."""
    teng = port_engine(
        JEngine(_graph(JG, prog), JA.REGISTRY[prog](),
                JConfig(**KW, subblocks=s)),
        A.REGISTRY[prog](), EngineConfig(**KW, subblocks=s))
    st = _start(teng)
    span = st["rep"].chunk_end(10 ** 6)
    p = teng.plan
    wb = teng._pick_width(teng._active_count(st["calm"].numpy()),
                          state_lib.fold_subblock_psd(st["psd"].numpy()))
    cap = _hist_cap(span) if traced else None
    counts = torch.zeros(p.num_blocks, dtype=torch.int32)
    hslots = torch.zeros(wb, dtype=torch.int32)
    sbacc = torch.zeros((), dtype=torch.int64)
    it_dev = torch.zeros((), dtype=torch.int64)
    hist = ()
    if traced:
        hist = (torch.as_tensor(teng._acct_table()),
                torch.zeros((cap, len(TIMELINE_INT_COLS)), dtype=torch.int64),
                torch.zeros((cap, len(TIMELINE_FLOAT_COLS))))
    psd, _, calm = teng._get_chunk(wb, cap)(
        teng._ed, teng._coupling_dev, st["values"], st["psd"], st["dmax"],
        st["calm"], counts, hslots, sbacc, it_dev,
        torch.as_tensor(st["rep"].is_hot), 0, span, st["i2"], *hist)
    res = teng.run(max_iterations=span, trace=traced)
    assert int(it_dev) == res.metrics.iterations == span
    assert np.array_equal(st["values"].numpy()[p.inv], res.values)
    assert np.array_equal(psd.numpy(), teng.last_psd)
    assert np.array_equal(calm.numpy(), teng.last_calm)
    counters = counts.numpy().astype(np.int64) @ teng._acct_table()
    assert tuple(counters) == tuple(getattr(res.metrics, f)
                                    for f in COUNTER_FIELDS)
    if traced:
        rows = hist[1][:span].tolist()
        assert rows == [[r[c] for c in TIMELINE_INT_COLS]
                        for r in res.timeline]


@pytest.mark.parametrize("s", [1, 8])
def test_lane_chunk_runs_match_reference(s):
    """k_sssp lanes through LaneEngine (built on its _get_chunk) against
    the reference's dense lanes, bitwise, and a repeat batch builds
    nothing."""
    jeng = JEngine(_graph(JG, "sssp"), JA.sssp(), JConfig(**KW, subblocks=s))
    teng = port_engine(jeng, A.sssp(), EngineConfig(**KW, subblocks=s))
    sources = [0, 7, 42, 130]
    active = np.array([True, True, True, False])
    out = []
    for eng, lane in ((jeng, JLaneEngine(jeng, JA.k_source_sssp(),
                                         use_pallas=False)),
                      (teng, LaneEngine(teng, A.k_source_sssp()))):
        values0, vconst = lane.program.lane_init(eng.plan.graph.n, sources)
        out.append(lane.run(ed=eng.edge_state, coupling=eng._coupling,
                            values0=values0, vconst=vconst,
                            lane_active=active,
                            edge_counts=np.asarray(eng.edge_counts)))
    ref, got = out
    assert np.array_equal(got.values, ref.values)
    assert np.array_equal(got.lane_iterations, ref.lane_iterations)
    assert np.array_equal(got.lane_converged, ref.lane_converged)
    assert _run_key(got) == _run_key(ref) and got.metrics.converged
    fns = dict(lane._fns)
    again = lane.run(ed=teng.edge_state, coupling=teng._coupling,
                     values0=values0, vconst=vconst, lane_active=active,
                     edge_counts=np.asarray(teng.edge_counts))
    assert np.array_equal(again.values, got.values)
    assert set(lane._fns) == set(fns) and all(
        lane._fns[k] is fns[k] for k in fns)
