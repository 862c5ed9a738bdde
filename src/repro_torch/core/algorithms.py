"""Vertex programs: PR, CC, SSSP, BFS; port of ``repro.core.algorithms``.

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

# kernel program ids (csrc/block_sweep.cu switches on these)
PAGERANK, SSSP, BFS, CC = 0, 1, 2, 3


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
