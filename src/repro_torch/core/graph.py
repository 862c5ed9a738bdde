"""Graph container + generators.

Host-side (numpy) preprocessing, exactly like production graph systems: the
one-time CSR/CSC build and the activity-based vertex permutation (paper §3.2,
"the time of reordering graph vertices is once in the whole algorithmic
process") happen on the host; the iterate runs on device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph in CSR (out-edges) + CSC (in-edges) form.

    ``in_src``/``in_w`` are sorted by destination, i.e. the in-edges of vertex
    ``v`` occupy ``in_src[in_indptr[v]:in_indptr[v+1]]``. This is the pull-mode
    layout the engine slices per partition (contiguous after permutation).
    """

    n: int
    m: int
    out_indptr: np.ndarray  # (n+1,) int64
    out_dst: np.ndarray  # (m,) int32
    out_w: np.ndarray  # (m,) float32, CSR order
    in_indptr: np.ndarray  # (n+1,) int64
    in_src: np.ndarray  # (m,) int32, CSC order
    in_w: np.ndarray  # (m,) float32, CSC order

    @property
    def out_deg(self) -> np.ndarray:
        return np.diff(self.out_indptr).astype(np.int64)

    @property
    def in_deg(self) -> np.ndarray:
        return np.diff(self.in_indptr).astype(np.int64)


def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
               w: np.ndarray | None = None) -> Graph:
    """Build CSR+CSC from a COO edge list (duplicates kept, self-loops kept)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = src.shape[0]
    if w is None:
        w = np.ones(m, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)

    # CSR: sort by src.
    order = np.argsort(src, kind="stable")
    csr_dst = dst[order].astype(np.int32)
    csr_w = w[order]
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(out_indptr, src + 1, 1)
    out_indptr = np.cumsum(out_indptr)

    # CSC: sort by dst.
    order = np.argsort(dst, kind="stable")
    csc_src = src[order].astype(np.int32)
    csc_w = w[order]
    in_indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(in_indptr, dst + 1, 1)
    in_indptr = np.cumsum(in_indptr)

    return Graph(n=n, m=m, out_indptr=out_indptr, out_dst=csr_dst, out_w=csr_w,
                 in_indptr=in_indptr, in_src=csc_src, in_w=csc_w)


def edges_of(g: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (src, dst, w) in CSC order."""
    dst = np.repeat(np.arange(g.n, dtype=np.int64), g.in_deg)
    return g.in_src.astype(np.int64), dst, g.in_w


def symmetrize(g: Graph) -> Graph:
    """Union of edges with their reverses (for CC / undirected semantics)."""
    s, d, w = edges_of(g)
    src = np.concatenate([s, d])
    dst = np.concatenate([d, s])
    ww = np.concatenate([w, w])
    return from_edges(g.n, src, dst, ww)


def powerlaw_graph(n: int, avg_deg: int = 8, seed: int = 0,
                   zipf_a: float = 1.2, weighted: bool = False) -> Graph:
    """Skewed 'small-world' graph (paper §3: power-function degree law).

    Destinations are Zipf-distributed over a random vertex ranking, so a few
    hub vertices collect most in-edges; sources are uniform. This reproduces
    the hot/cold structure the paper exploits (celebrity/follower example).
    """
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    rank = rng.permutation(n)
    # Zipf weights over ranks; normalize to a categorical.
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), zipf_a)
    p /= p.sum()
    dst = rank[rng.choice(n, size=m, p=p)]
    src = rng.integers(0, n, size=m)
    w = rng.uniform(0.1, 1.0, size=m).astype(np.float32) if weighted else None
    return from_edges(n, src, dst, w)


def core_periphery_graph(n: int, avg_deg: int = 8, seed: int = 0,
                         core_frac: float = 0.02, chords: int = 2,
                         weighted: bool = False) -> Graph:
    """Power-law graph with a *slow-mixing hub core* — the convergence-skew
    regime the paper's real datasets (twitter-2010, WikiTalk) exhibit.

    Periphery edges are Zipf-directed into the hub ids, so the core has huge
    in-degree (AD marks it hot). The core itself is a directed ring with a
    few chords: residual rank mass circulates around the ring and decays only
    at the damping rate per hop (a random dense core would mix at lambda_2 ~
    1/sqrt(deg) and converge almost immediately). Result: the periphery
    settles in a few sweeps while the hot core needs ~log(T2)/log(d) more —
    a structure-unaware system keeps sweeping ALL partitions until the core
    settles (the paper's Figure 1); a structure-aware one re-processes only
    the couple of hot blocks.
    """
    rng = np.random.default_rng(seed)
    n_core = max(int(n * core_frac), 4)
    # periphery -> Zipf-favoured dsts (ids 0..n_core are the hubs)
    m_per = n * avg_deg
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), 1.2)
    p /= p.sum()
    dst = rng.choice(n, size=m_per, p=p)
    # a fraction of follows go uniformly to the hubs (celebrities draw
    # followers throughout), giving every core vertex clearly-top in-degree
    # so the AD sort packs the core into few contiguous blocks
    boost = rng.random(m_per) < 0.3
    dst[boost] = rng.integers(0, n_core, size=int(boost.sum()))
    # sources live strictly in the periphery: hub out-edges are ONLY the
    # ring, so residual mass cannot leak out of the slow-mixing core
    src = rng.integers(n_core, n, size=m_per)
    # slow-mixing core: hub i -> hubs i+1 .. i+chords (mod n_core)
    core_src = np.repeat(np.arange(n_core, dtype=np.int64), chords)
    core_off = np.tile(np.arange(1, chords + 1, dtype=np.int64), n_core)
    core_dst = (core_src + core_off) % n_core
    src = np.concatenate([src, core_src])
    dst = np.concatenate([dst, core_dst])
    m = src.shape[0]
    w = rng.uniform(0.1, 1.0, size=m).astype(np.float32) if weighted else None
    return from_edges(n, src, dst, w)


def uniform_graph(n: int, deg: int = 4, seed: int = 0,
                  weighted: bool = False) -> Graph:
    """Road-network-like graph: even degree distribution, local neighbours.

    Each vertex links to ``deg`` vertices within a small index window (plus a
    wraparound), giving the 'even in/out-edge distribution' regime where the
    paper says alpha -> 0.5.
    """
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    offs = rng.integers(1, 64, size=n * deg)
    dst = (src + offs) % n
    w = rng.uniform(0.1, 1.0, size=n * deg).astype(np.float32) if weighted else None
    return from_edges(n, src, dst, w)


def chain_graph(n: int, weighted: bool = False) -> Graph:
    """Path 0 -> 1 -> ... -> n-1 (oracle-friendly)."""
    src = np.arange(n - 1, dtype=np.int64)
    dst = src + 1
    w = (np.arange(1, n, dtype=np.float32) % 5 + 1.0) if weighted else None
    return from_edges(n, src, dst, w)


def _open_text(path: str):
    if str(path).endswith(".gz"):
        import gzip
        return gzip.open(path, "rt")
    return open(path, "r")


def parse_coo(path: str) -> tuple[np.ndarray, np.ndarray,
                                  np.ndarray | None]:
    """Parse a whitespace 'src dst [w]' edge-list file (SNAP-style; ``.gz``
    accepted) into (src, dst, w|None).

    Vertex ids are parsed as int64 END TO END — routing them through
    float64 (as ``np.loadtxt(dtype=float)`` would) silently corrupts ids
    above 2**53, which real SNAP crawls (hashed ids) do contain. Memory
    stays at the numpy-array level: loadtxt streams the file, and a
    ``.gz`` input is decompressed exactly once (to a temp file) rather
    than per parsing pass.
    """
    import os
    import shutil
    import tempfile

    def parse(opener):
        with opener() as f:
            ncols = 0
            for lineno, line in enumerate(f, 1):
                # strip inline trailing comments the same way loadtxt's
                # comments=('#', '%') does, so the column probe agrees
                # with the parsing passes
                t = line.split("#")[0].split("%")[0].strip()
                if not t:
                    continue
                k = len(t.split())
                if ncols == 0:
                    ncols = k
                elif k != ncols:
                    # loadtxt(usecols=...) would silently accept ragged
                    # rows (dropping weights); fail loudly instead
                    raise ValueError(
                        f"{path}:{lineno}: inconsistent column count "
                        f"({k} vs {ncols})")
        if ncols == 0:
            raise ValueError(f"{path}: no edges found")
        if ncols < 2:
            raise ValueError(f"{path}: expected 'src dst [w]' rows, got "
                             f"{ncols} column(s)")
        with opener() as f:
            ids = np.loadtxt(f, dtype=np.int64, usecols=(0, 1),
                             comments=("#", "%"), ndmin=2)
        w = None
        if ncols > 2:
            with opener() as f:
                w = np.loadtxt(f, dtype=np.float64, usecols=(2,),
                               comments=("#", "%"),
                               ndmin=1).astype(np.float32)
        return ids, w

    if str(path).endswith(".gz"):
        # decompress once into a temp dir and reopen by path (re-opening a
        # live NamedTemporaryFile by name is not portable to Windows)
        with tempfile.TemporaryDirectory() as d:
            plain = os.path.join(d, "edges.coo")
            with _open_text(path) as f, open(plain, "w") as out:
                shutil.copyfileobj(f, out)
            ids, w = parse(lambda: open(plain, "r"))
    else:
        ids, w = parse(lambda: open(path, "r"))
    if ids.size and ids.min() < 0:
        bad = ids[ids < 0].flat[0]
        raise ValueError(f"{path}: negative vertex id {bad} — edge lists "
                         "must use non-negative integer ids")
    return ids[:, 0], ids[:, 1], w


def load_coo(path: str, n: int | None = None) -> Graph:
    """Load a whitespace 'src dst [w]' edge-list file (SNAP-style, plain or
    gzip'd) with exact integer id parsing."""
    src, dst, w = parse_coo(path)
    if n is None:
        n = int(max(src.max(), dst.max())) + 1
    return from_edges(n, src, dst, w)


def permute(g: Graph, order: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Relabel vertices so that new id ``i`` is old vertex ``order[i]``.

    Returns the permuted graph and ``inv`` with ``inv[old] = new`` (use it to
    map results back).
    """
    inv = np.empty(g.n, dtype=np.int64)
    inv[order] = np.arange(g.n, dtype=np.int64)
    s, d, w = edges_of(g)
    return from_edges(g.n, inv[s], inv[d], w), inv
