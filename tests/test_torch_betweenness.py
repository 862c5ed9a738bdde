"""The port's betweenness centrality (``repro_torch.core.engine.
betweenness``) and its five-algorithm suite (``python -m
repro_torch.graph_suite``) on the CPU, against the reference.

The BFS waves run through the port's engines (the plain sweep here), and
the path counting and dependency accumulation are numpy float64, as in
the reference. BFS levels are exact, so the bar is bitwise: the port's bc
equals the reference's, and so do the summed counters, for both engines;
the chain and diamond oracles of tests/test_engines.py hold in the port.
"""
import numpy as np
import pytest
from _torch_parity import one_torch_thread  # noqa: F401

from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import betweenness as j_betweenness
from repro_torch import graph_suite
from repro_torch.core import graph as G
from repro_torch.core.engine import EngineConfig, betweenness

KW = dict(t2=1e-9, width=8, block_size=256)  # tests/test_engines.py's CFG
CFG = EngineConfig(**KW)
SUMMED = ("iterations", "updates", "edges_processed", "block_loads",
          "bytes_loaded", "blocks_retired")


@pytest.mark.parametrize("structure_aware", [True, False],
                         ids=["structure_aware", "baseline"])
def test_betweenness_matches_reference(structure_aware):
    ref_bc, ref_m = j_betweenness(JG.powerlaw_graph(500, 4, seed=5),
                                  [0, 3], JConfig(**KW),
                                  structure_aware=structure_aware)
    bc, m = betweenness(G.powerlaw_graph(500, 4, seed=5), [0, 3], CFG,
                        structure_aware=structure_aware, device="cpu")
    assert bc.dtype == np.float64 and bc.shape == (500,)
    assert np.array_equal(bc, ref_bc)
    assert [getattr(m, f) for f in SUMMED] == \
        [getattr(ref_m, f) for f in SUMMED]
    assert m.converged is False  # never summed, as in the reference


def test_betweenness_engines_agree():
    g = G.powerlaw_graph(500, 4, seed=5)
    bc_sa, _ = betweenness(g, [0, 3], CFG, structure_aware=True,
                           device="cpu")
    bc_base, _ = betweenness(g, [0, 3], CFG, structure_aware=False,
                             device="cpu")
    assert np.array_equal(bc_sa, bc_base)


def test_betweenness_chain_oracle():
    """Directed path 0->1->...->k from source 0: Brandes dependency is
    delta(v) = (n-1) - v, and the source itself accumulates nothing."""
    n = 8
    bc, metrics = betweenness(G.chain_graph(n), [0], CFG, device="cpu")
    expect = np.array([0.0] + [n - 1 - v for v in range(1, n)])
    assert np.allclose(bc, expect, atol=1e-6)
    assert metrics.iterations > 0 and metrics.updates > 0


def test_betweenness_diamond_split_paths():
    """Two equal-length shortest paths: the middles share the dependency
    (sigma-weighted), the endpoints carry none."""
    #    0 -> 1 -> 3 ; 0 -> 2 -> 3
    g = G.from_edges(4, [0, 0, 1, 2], [1, 2, 3, 3])
    bc, _ = betweenness(g, [0], CFG, device="cpu")
    assert np.allclose(bc, [0.0, 0.5, 0.5, 0.0], atol=1e-6)


def test_graph_suite_on_cpu(capsys):
    agree = graph_suite.main(["--n", "2000", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["graph", "algo", "base-loads", "sa-loads",
                              "base-upd", "sa-upd", "agree"]
    rows = [line.split() for line in out[1:]]
    assert len(rows) == len(agree) == 15  # 3 graphs x 5 algorithms
    assert {r[1] for r in rows} == {"pagerank", "cc", "sssp", "bfs", "bc"}
    assert all(r[-1] == "True" for r in rows) and all(agree)
