"""Vertex programs: PR, CC, SSSP, BFS, and the query lane families
(k-source SSSP/BFS, personalized PageRank); port of
``repro.core.algorithms``.

Each program supplies the pull-mode update and its *state degree* delta
(paper §3.3): PR uses Eq. 3 (|rank_curr - rank_next|), SSSP uses Eq. 4 (the
smaller of the two results, on change), CC the max-analogue.

``edge_map``/``apply``/``sd_delta`` take torch tensors and are the plain
versions of what the block-sweep kernel computes for ``kernel_id``; the
kernel gets its float constants from :meth:`VertexProgram.kernel_consts`.
The numpy hooks (``init``, ``aux_fn``, ``aux_delta``, ``reset_on_delete*``)
are copies of the reference's.

Arithmetic is pinned to the reference (XLA on CPU, under ``jit``):
PageRank's ``apply`` ``(1-d)/n + d*agg`` is fused by XLA into one FMA, with
``d`` and ``(1-d)/n`` rounded to f32 as JAX weak-types Python floats. Here it
is evaluated in float64 from the f32 operands and rounded once, which equals
the FMA whenever the exact result fits in a double (the product of two f32
values always does) — see tests/test_torch_block_sweep.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import Graph

INF = np.float32(1e18)  # finite 'infinity': keeps inf-inf NaNs out of f32 math

# kernel program ids (csrc/block_sweep.cu switches on these; PPR is the
# personalized-PageRank lane family)
PAGERANK, SSSP, BFS, CC, PPR = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    name: str
    combine: str  # 'sum' | 'min' | 'max'
    needs_symmetric: bool
    monotone_cooling: bool  # True -> barrier repartitioning is sound (PR-like)
    kernel_id: int  # which program the block-sweep kernel runs
    damping: float = 0.85
    # init(graph) -> (values (n,), aux (n,)); aux is per-vertex constant data
    init: Callable[[Graph], tuple[np.ndarray, np.ndarray]] = None
    # edge_map(src_val, src_aux, w) -> message
    edge_map: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor] = None
    # apply(old_block, agg_block, n_total) -> new_block
    apply: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor] = None
    # sd_delta(old_block, new_block) -> nonnegative activity contribution
    sd_delta: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = None
    # -- streaming hooks (numpy, used by the streaming slice) ----------------
    aux_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None
    aux_delta: Callable[..., np.ndarray] | None = None
    reset_on_delete: Callable[..., np.ndarray] | None = None
    reset_on_delete_frontier: Callable[..., np.ndarray] | None = None

    @property
    def identity(self) -> np.float32:
        return {"sum": np.float32(0.0), "min": INF,
                "max": np.float32(-INF)}[self.combine]

    def kernel_consts(self, n_total: int) -> tuple[float, float]:
        """(d, c) of ``apply = fma(d, agg, c)`` as the f32 values the
        reference computes with: ``d`` and ``(1 - d) / n_total`` evaluated
        in double, then rounded to f32 (JAX's weak typing)."""
        return (float(np.float32(self.damping)),
                float(np.float32((1.0 - self.damping) / n_total)))


def graph_successors(g: Graph, unit: bool = False) -> Callable[[np.ndarray],
                                                               tuple]:
    """``successors(frontier) -> (src, dst, w)`` oracle over a built Graph's
    CSR out-edges. With ``unit`` the weight gather is skipped."""
    indptr, out_dst, out_w = g.out_indptr, g.out_dst, g.out_w

    def successors(frontier: np.ndarray):
        starts, ends = indptr[frontier], indptr[frontier + 1]
        cnt = ends - starts
        total = int(cnt.sum())
        if total == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e, np.empty(0, dtype=np.float64)
        eidx = (np.repeat(starts - np.concatenate(
            [[0], np.cumsum(cnt)[:-1]]), cnt) + np.arange(total))
        return (np.repeat(frontier, cnt), out_dst[eidx].astype(np.int64),
                None if unit else out_w[eidx].astype(np.float64))

    return successors


def _invalidated_by_delete(successors, n: int, dist: np.ndarray,
                           dsrc: np.ndarray, ddst: np.ndarray,
                           dw: np.ndarray, unit: bool = False) -> np.ndarray:
    """KickStarter-style delete trimming for min-combine distance programs:
    the set of vertices whose current distance may (transitively) depend on
    a deleted edge (over-approximate, hence sound)."""
    d64 = np.asarray(dist, dtype=np.float64)
    dw = (np.ones(len(ddst)) if unit
          else np.asarray(dw, dtype=np.float64))
    reach = d64 < float(INF) / 2.0

    def tight(a, b, wab):  # b's value was (one of) a's relaxations
        return reach[a] & np.isclose(d64[b], d64[a] + wab,
                                     rtol=1e-5, atol=1e-4)

    mask = np.zeros(n, dtype=bool)
    dsrc = np.asarray(dsrc, dtype=np.int64)
    ddst = np.asarray(ddst, dtype=np.int64)
    mask[ddst[tight(dsrc, ddst, dw)]] = True
    if not mask.any():
        return mask
    frontier = np.flatnonzero(mask)
    while frontier.size:
        srcs, dsts, ws = successors(frontier)
        if srcs.size == 0:
            break
        if unit:
            ws = np.ones(srcs.size)
        hit = tight(srcs, dsts, ws) & ~mask[dsts]
        frontier = np.unique(dsts[hit])
        mask[frontier] = True
    return mask


def _zero_if(cond: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, val, torch.zeros_like(val))


def pagerank(damping: float = 0.85) -> VertexProgram:
    d32 = float(np.float32(damping))

    def init(g: Graph):
        vals = np.full(g.n, 1.0 / g.n, dtype=np.float32)
        aux = np.maximum(g.out_deg, 1).astype(np.float32)
        return vals, aux

    def edge_map(src_val, src_aux, w):
        del w
        return src_val / src_aux

    def apply(old, agg, n_total):
        del old
        # one rounding, as the reference's fused multiply-add
        c32 = float(np.float32((1.0 - damping) / n_total))
        return (d32 * agg.double() + c32).float()

    def sd_delta(old, new):  # Eq. 3
        return torch.abs(new - old)

    def aux_fn(out_deg, in_deg):
        del in_deg
        return np.maximum(out_deg, 1).astype(np.float32)

    def aux_delta(values, aux_old, aux_new):
        return np.abs(np.asarray(values, np.float64)) * np.abs(
            1.0 / np.asarray(aux_old, np.float64)
            - 1.0 / np.asarray(aux_new, np.float64))

    return VertexProgram(name="pagerank", combine="sum", needs_symmetric=False,
                         monotone_cooling=True, kernel_id=PAGERANK,
                         damping=damping, init=init, edge_map=edge_map,
                         apply=apply, sd_delta=sd_delta, aux_fn=aux_fn,
                         aux_delta=aux_delta)


def sssp(source: int = 0) -> VertexProgram:
    def init(g: Graph):
        vals = np.full(g.n, INF, dtype=np.float32)
        vals[source] = 0.0
        return vals, np.zeros(g.n, dtype=np.float32)

    def edge_map(src_val, src_aux, w):
        del src_aux
        return src_val + w

    def apply(old, agg, n_total):
        del n_total
        return torch.minimum(old, agg)

    def sd_delta(old, new):  # Eq. 4: min of the two results, on change
        return _zero_if(new < old, torch.minimum(new, old))

    def reset_frontier(successors, n, values, dsrc, ddst, dw):
        return _invalidated_by_delete(successors, n, values, dsrc, ddst, dw,
                                      unit=False)

    def reset_on_delete(g, values, dsrc, ddst, dw):
        return reset_frontier(graph_successors(g), g.n, values, dsrc, ddst,
                              dw)

    return VertexProgram(name="sssp", combine="min", needs_symmetric=False,
                         monotone_cooling=False, kernel_id=SSSP, init=init,
                         edge_map=edge_map, apply=apply, sd_delta=sd_delta,
                         reset_on_delete=reset_on_delete,
                         reset_on_delete_frontier=reset_frontier)


def bfs(source: int = 0) -> VertexProgram:
    def init(g: Graph):
        vals = np.full(g.n, INF, dtype=np.float32)
        vals[source] = 0.0
        return vals, np.zeros(g.n, dtype=np.float32)

    def edge_map(src_val, src_aux, w):
        del src_aux, w
        return src_val + 1.0

    def apply(old, agg, n_total):
        del n_total
        return torch.minimum(old, agg)

    def sd_delta(old, new):
        return _zero_if(new < old, torch.ones_like(new))

    def reset_frontier(successors, n, values, dsrc, ddst, dw):
        return _invalidated_by_delete(successors, n, values, dsrc, ddst, dw,
                                      unit=True)

    def reset_on_delete(g, values, dsrc, ddst, dw):
        return reset_frontier(graph_successors(g, unit=True), g.n, values,
                              dsrc, ddst, dw)

    return VertexProgram(name="bfs", combine="min", needs_symmetric=False,
                         monotone_cooling=False, kernel_id=BFS, init=init,
                         edge_map=edge_map, apply=apply, sd_delta=sd_delta,
                         reset_on_delete=reset_on_delete,
                         reset_on_delete_frontier=reset_frontier)


def cc() -> VertexProgram:
    """Connected components via max-label propagation (paper: 'take a
    maximum'); requires the symmetrized graph."""

    def init(g: Graph):
        return np.arange(g.n, dtype=np.float32), np.zeros(g.n, np.float32)

    def edge_map(src_val, src_aux, w):
        del src_aux, w
        return src_val

    def apply(old, agg, n_total):
        del n_total
        return torch.maximum(old, agg)

    def sd_delta(old, new):  # the larger of the two results, on change
        return _zero_if(new > old, torch.maximum(new, old))

    def _label_reset(values, dsrc, ddst):
        labels = np.unique(np.concatenate(
            [np.asarray(values)[np.asarray(dsrc, dtype=np.int64)],
             np.asarray(values)[np.asarray(ddst, dtype=np.int64)]]))
        return np.isin(np.asarray(values), labels)

    def reset_on_delete(g, values, dsrc, ddst, dw):
        del g, dw
        return _label_reset(values, dsrc, ddst)

    def reset_frontier(successors, n, values, dsrc, ddst, dw):
        del successors, n, dw
        return _label_reset(values, dsrc, ddst)

    return VertexProgram(name="cc", combine="max", needs_symmetric=True,
                         monotone_cooling=False, kernel_id=CC, init=init,
                         edge_map=edge_map, apply=apply, sd_delta=sd_delta,
                         reset_on_delete=reset_on_delete,
                         reset_on_delete_frontier=reset_frontier)


REGISTRY: dict[str, Callable[..., VertexProgram]] = {
    "pagerank": pagerank,
    "sssp": sssp,
    "bfs": bfs,
    "cc": cc,
}


# -- multi-lane programs (repro_torch.serve) ---------------------------------
@dataclasses.dataclass(frozen=True)
class LaneProgram:
    """A *family* of per-source queries executed as lanes of one run (port
    of the reference's ``LaneProgram``).

    Vertex values carry a trailing lane axis ``(n, L)`` and one sweep
    advances every lane: the edge slice is read once and the messages and
    aggregates are ``(E, L)``/``(C, L)``. Everything per lane (the query's
    source, a personalized restart vector) lives in data: the init values
    and the optional per-vertex ``vconst`` matrix.

    ``lane_init(n, params)`` builds that data on the host, one param per
    lane, as ``(values (n, L) float32, vconst (n, L) float32 | None)`` in
    ORIGINAL vertex ids. ``aux_fn(out_deg, in_deg)`` gives the family's
    per-vertex constant (None: the family ignores aux). ``edge_map``/
    ``apply``/``sd_delta`` take torch tensors and are the plain versions of
    what the lane sweep kernel computes for ``kernel_id``.
    """

    name: str
    combine: str  # 'sum' | 'min' | 'max'
    needs_symmetric: bool
    monotone_cooling: bool
    uses_vconst: bool
    kernel_id: int  # which program the lane sweep kernel runs
    damping: float = 0.85
    # lane_init(n, params) -> (values (n, L), vconst (n, L) | None)
    lane_init: Callable[[int, list], tuple[np.ndarray,
                                           np.ndarray | None]] = None
    # edge_map(src_vals (E, L), src_aux (E,), w (E,)) -> (E, L)
    edge_map: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                       torch.Tensor] = None
    # apply(old (C, L), agg (C, L), vconst (C, L), n_total) -> (C, L)
    apply: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                    torch.Tensor] = None
    # sd_delta(old (C, L), new (C, L)) -> nonnegative (C, L)
    sd_delta: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = None
    aux_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None

    @property
    def identity(self) -> np.float32:
        return {"sum": np.float32(0.0), "min": INF,
                "max": np.float32(-INF)}[self.combine]

    def kernel_consts(self, n_total: int) -> tuple[float, float]:
        """(d, c) of ``apply = fma(c, vconst, d * agg)`` as the f32 values
        the reference computes with: ``d`` and ``1 - d`` evaluated in
        double, then rounded to f32 (JAX's weak typing). Unused by the
        min families."""
        del n_total
        return (float(np.float32(self.damping)),
                float(np.float32(1.0 - self.damping)))


def _source_lane_values(n: int, sources: list) -> np.ndarray:
    vals = np.full((n, len(sources)), INF, dtype=np.float32)
    for lane, s in enumerate(sources):
        if not 0 <= int(s) < n:
            raise ValueError(f"lane source {s} out of range [0, {n})")
        vals[int(s), lane] = 0.0
    return vals


def _min_apply(old, agg, vconst, n_total):
    del vconst, n_total
    return torch.minimum(old, agg)


def k_source_sssp() -> LaneProgram:
    """L independent single-source shortest-path queries per sweep."""

    def lane_init(n, sources):
        return _source_lane_values(n, sources), None

    def edge_map(src_vals, src_aux, w):
        del src_aux
        return src_vals + w[:, None]

    def sd_delta(old, new):  # Eq. 4 per lane
        return _zero_if(new < old, torch.minimum(new, old))

    return LaneProgram(name="k_sssp", combine="min", needs_symmetric=False,
                       monotone_cooling=False, uses_vconst=False,
                       kernel_id=SSSP, lane_init=lane_init,
                       edge_map=edge_map, apply=_min_apply,
                       sd_delta=sd_delta)


def k_source_bfs() -> LaneProgram:
    """L independent BFS (unit-weight distance) queries per sweep."""

    def lane_init(n, sources):
        return _source_lane_values(n, sources), None

    def edge_map(src_vals, src_aux, w):
        del src_aux, w
        return src_vals + 1.0

    def sd_delta(old, new):
        return _zero_if(new < old, torch.ones_like(new))

    return LaneProgram(name="k_bfs", combine="min", needs_symmetric=False,
                       monotone_cooling=False, uses_vconst=False,
                       kernel_id=BFS, lane_init=lane_init,
                       edge_map=edge_map, apply=_min_apply,
                       sd_delta=sd_delta)


def k_personalized_pagerank(damping: float = 0.85) -> LaneProgram:
    """L personalized-PageRank queries per sweep: lane l restarts into its
    own distribution r_l (``vconst`` column l), v_l = (1-d) r_l + d A v_l.
    A lane's param is a dense (n,) distribution or a set of vertex ids
    (uniform over the set). Dangling mass vanishes as in ``pagerank``
    (aux = max(out_deg, 1)).

    ``apply`` is pinned to what XLA on CPU computes for the reference's
    ``(1-d) * vconst + d * agg``: ``fma(f32(1-d), vconst, f32(d * agg))``,
    with ``1-d`` evaluated in double and rounded once. Here the product
    ``d * agg`` is rounded to f32 and the rest is evaluated in float64
    from f32 operands and rounded once; the kernel computes
    ``__fmaf_rn(omd, vc, __fmul_rn(d, agg))``."""
    d32 = float(np.float32(damping))
    omd = float(np.float32(1.0 - damping))

    def lane_init(n, resets):
        r = np.zeros((n, len(resets)), dtype=np.float32)
        for lane, rs in enumerate(resets):
            rs = np.asarray(rs)
            if rs.ndim == 1 and rs.size == n and rs.dtype.kind == "f":
                col = rs.astype(np.float64)
                if not np.isclose(col.sum(), 1.0, rtol=1e-4):
                    raise ValueError("dense reset must sum to 1")
                r[:, lane] = col.astype(np.float32)
            else:
                ids = rs.astype(np.int64).reshape(-1)
                if ids.size == 0 or ids.min() < 0 or ids.max() >= n:
                    raise ValueError("reset set must be non-empty vertex "
                                     f"ids in [0, {n})")
                # a repeated id accumulates its full share
                np.add.at(r[:, lane], ids, np.float32(1.0 / ids.size))
        # start at the restart vector: the fixpoint's (1-d) r term is
        # already in place
        return r.copy(), r

    def edge_map(src_vals, src_aux, w):
        del w
        return src_vals / src_aux[:, None]

    def apply(old, agg, vconst, n_total):
        del old, n_total
        return (omd * vconst.double() + (d32 * agg).double()).float()

    def sd_delta(old, new):  # Eq. 3 per lane
        return torch.abs(new - old)

    def aux_fn(out_deg, in_deg):
        del in_deg
        return np.maximum(out_deg, 1).astype(np.float32)

    return LaneProgram(name="k_ppr", combine="sum", needs_symmetric=False,
                       monotone_cooling=True, uses_vconst=True,
                       kernel_id=PPR, damping=damping, lane_init=lane_init,
                       edge_map=edge_map, apply=apply, sd_delta=sd_delta,
                       aux_fn=aux_fn)


LANE_FAMILIES: dict[str, Callable[..., LaneProgram]] = {
    "sssp": k_source_sssp,
    "bfs": k_source_bfs,
    "ppr": k_personalized_pagerank,
}
