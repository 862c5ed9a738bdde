"""Degree function, active degree (paper Eq. 1 / Eq. 2) and the sampled T1.

All host-side numpy: this is one-time load-time preprocessing (§3.2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, edges_of


def degree_function(g: Graph, alpha: float = 0.75) -> np.ndarray:
    """Eq. 1:  D(v) = D_o(v) + alpha * D_i(v),  0.5 < alpha < 1.

    alpha -> 0.5 for even (road-like) graphs, -> 1 for skewed (social) graphs.
    """
    if not (0.0 < alpha <= 1.0):
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    return (g.out_deg + alpha * g.in_deg).astype(np.float64)


def suggest_alpha(g: Graph) -> float:
    """Pick alpha from the skew of the in-degree distribution (paper §3.1:
    road networks -> 0.5, follower graphs -> 1). We interpolate on the
    coefficient of variation of in-degree, clipped to the paper's open
    interval (0.5, 1)."""
    ind = g.in_deg.astype(np.float64)
    mean = ind.mean() if ind.size else 1.0
    cv = ind.std() / max(mean, 1e-12)
    # cv ~ 0.3 for near-regular graphs, > 3 for heavy power laws.
    t = np.clip((cv - 0.3) / 3.0, 0.0, 1.0)
    return float(0.55 + 0.40 * t)


def active_degree(g: Graph, alpha: float = 0.75) -> np.ndarray:
    """Eq. 2:  AD(v) = D(v) + sum_k D(v_k) / (sqrt(D_max) * D(v)).

    The neighbour sum runs over both in- and out-neighbours (the paper's
    'neighbor vertex structure'); zero-degree vertices get AD = 0 and are
    routed to the dead partition by the partitioner.
    """
    d = degree_function(g, alpha)
    dmax = d.max() if g.n else 1.0
    s, dsts, _ = edges_of(g)
    # sum of D over out-neighbours of v: edges v->k contribute D(k) to v.
    nbr = np.zeros(g.n, dtype=np.float64)
    np.add.at(nbr, s, d[dsts])
    # ... plus over in-neighbours of v: edges k->v contribute D(k) to v.
    np.add.at(nbr, dsts, d[s])
    dead = d <= 0
    denom = np.sqrt(max(dmax, 1e-12)) * np.where(dead, 1.0, d)
    ad = d + nbr / denom
    ad[dead] = 0.0
    return ad


def sampled_threshold(ad: np.ndarray, sample_frac: float = 0.1,
                      hot_ratio: float = 0.1, seed: int = 0) -> float:
    """HotGraph-style T1 (§3.1): sample ``sample_frac`` of the vertices and
    return the AD of the (hot_ratio * sample)-th largest sampled vertex."""
    n = ad.shape[0]
    rng = np.random.default_rng(seed)
    k = max(int(n * sample_frac), 1)
    sample = ad[rng.choice(n, size=k, replace=False)]
    idx = max(int(k * hot_ratio) - 1, 0)
    return float(np.sort(sample)[::-1][idx])
