"""Shared test fixtures + numpy oracles.

NOTE: no XLA_FLAGS here — tests run with the real single CPU device;
distributed tests spawn subprocesses that set their own device count.
"""
import numpy as np
import pytest

from repro.core import graph as G


def pr_oracle(g, iters=500, d=0.85):
    r = np.full(g.n, 1.0 / g.n, dtype=np.float64)
    outdeg = np.maximum(g.out_deg, 1).astype(np.float64)
    s, dst, _ = G.edges_of(g)
    for _ in range(iters):
        agg = np.zeros(g.n)
        np.add.at(agg, dst, r[s] / outdeg[s])
        r = (1 - d) / g.n + d * agg
    return r


def bellman_ford_oracle(g, src=0, unit=False):
    s, d, w = G.edges_of(g)
    if unit:
        w = np.ones_like(w)
    dist = np.full(g.n, 1e18)
    dist[src] = 0.0
    for _ in range(g.n):
        nd = dist.copy()
        np.minimum.at(nd, d, dist[s] + w)
        if np.array_equal(nd, dist):
            break
        dist = nd
    return dist


def ppr_oracle(g, reset_ids, d=0.85, iters=500):
    """Personalized PageRank power iteration: x = (1-d) r + d A x with r
    uniform over ``reset_ids``; dangling mass vanishes (aux = max(out, 1)),
    matching the engine's pagerank semantics."""
    r = np.zeros(g.n)
    r[np.asarray(reset_ids, dtype=np.int64)] = 1.0 / len(reset_ids)
    s, dst, _ = G.edges_of(g)
    outdeg = np.maximum(g.out_deg, 1).astype(np.float64)
    x = r.copy()
    for _ in range(iters):
        agg = np.zeros(g.n)
        np.add.at(agg, dst, x[s] / outdeg[s])
        x = (1 - d) * r + d * agg
    return x


def cc_oracle(g):
    """Union-find component roots on the symmetrized graph."""
    parent = list(range(g.n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    s, d, _ = G.edges_of(g)
    for a, b in zip(s, d):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[ra] = rb
    return np.array([find(i) for i in range(g.n)])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (skips without)")


@pytest.fixture(scope="session")
def powerlaw_small():
    return G.powerlaw_graph(2000, avg_deg=6, seed=1)


@pytest.fixture(scope="session")
def core_periphery_small():
    return G.core_periphery_graph(5000, avg_deg=8, seed=1, chords=1)
