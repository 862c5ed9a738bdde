"""Hierarchical partitions (``subblocks = S > 1``) in the port against the
reference, on the CPU through the plain version of the masked sweep.

The bar (ROADMAP.md, "How the port is held against the reference"):

* one masked sweep, against the reference's dense processor
  ``make_tiled_processor(..., use_pallas=False, subblocks=S)`` on the same
  state and the same ``sub_act`` masks: SSSP/BFS/CC new values and per-sub
  max deltas bitwise; per-sub mean deltas bitwise for BFS/CC (integer
  deltas), rtol=1e-6 for SSSP (another float-sum order); PageRank within
  the roundoff of reordering a sum (2(k-1)·2^-24 relative for k in-edges).
  Masked sub-ranges keep their values, psd and dmax.
* whole runs, ``run()`` and ``run(fused=False)``: SSSP/CC values and every
  counter (sub-block accounting included) equal; PageRank values at
  rtol=1e-4, with the counters printed beside the reference's (its
  trajectory forks by reordering roundoff; ROADMAP Queue 3).
* the (P, P, S) coupling and its counts equal the reference's.
* the kernel's own order (re-enacted in numpy, ``emulate_kernel``) equals
  the plain version bitwise, sums included, at S > 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import emulate_kernel, one_torch_thread  # noqa: F401
from _torch_parity import port_engine

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import StructureAwareEngine as JEngine
from repro.core.engine import make_tiled_processor as j_processor
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StructureAwareEngine as TEngine

C = 128  # P <= 12 blocks on these graphs
KW = dict(t2=1e-9, width=4, block_size=C)
COUNTERS = ("iterations", "updates", "edges_processed", "block_loads",
            "bytes_loaded", "converged", "blocks_retired",
            "subblocks_retired", "mean_subblock_dispatch")
GRAPHS = {
    "pagerank": ("core_periphery_graph", dict(n=1500, avg_deg=6, seed=4,
                                              chords=1)),
    "sssp": ("powerlaw_graph", dict(n=1200, avg_deg=5, seed=4,
                                    weighted=True)),
    "bfs": ("powerlaw_graph", dict(n=1200, avg_deg=5, seed=5)),
    "cc": ("powerlaw_graph", dict(n=900, avg_deg=3, seed=6)),
}


def _graphs(prog):
    fn, kw = GRAPHS[prog]
    return getattr(JG, fn)(**kw), getattr(TG, fn)(**kw)


def _state(prog, n_pad, rng):
    """A mid-run value vector: the sweep sees every kind of entry."""
    if prog == "pagerank":
        return rng.uniform(0.0, 2.0 / n_pad, n_pad).astype(np.float32)
    if prog == "cc":
        return rng.permutation(n_pad).astype(np.float32)
    v = np.where(rng.random(n_pad) < 0.4, JA.INF,
                 rng.uniform(0.0, 30.0, n_pad)).astype(np.float32)
    if prog == "bfs":
        v = np.where(v < JA.INF, np.floor(v), v).astype(np.float32)
    return v


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_masked_sweep_matches_dense(prog, s):
    jg, _ = _graphs(prog)
    cfg = dict(KW, subblocks=s)
    jeng = JEngine(jg, JA.REGISTRY[prog](), JConfig(**cfg))
    teng = port_engine(jeng, TA.REGISTRY[prog](), TConfig(**cfg))
    plan = jeng.plan
    P, n_pad, sub = plan.num_blocks, teng._values_len, C // s
    rng = np.random.default_rng(31 + s)
    values = _state(prog, n_pad, rng)
    floor = np.float32(teng._psd_floor())
    proc_one, proc_iter, _ = j_processor(
        jeng.program, plan.unified, C, plan.n_live, plan.graph.n, False,
        subblocks=s)
    j_one, j_iter = jax.jit(proc_one), jax.jit(proc_iter)
    t_one, t_iter = teng._proc
    kdeg = np.maximum(np.pad(plan.graph.in_deg, (0, n_pad - plan.graph.n)),
                      1)
    same_psd = total = 0
    for row in range(P):
        # a seeded mask: each sub-range live (over the floor) or not
        act = rng.random(s) < 0.6
        prior = np.where(act, 1.0, floor / 2).astype(np.float32)
        for depth in (1, 3):
            sa = jnp.asarray(act)
            if depth == 1:
                _, jnew, jpsd, jdmax = j_one(jeng._ed, jnp.asarray(values),
                                             row, sa)
            else:
                _, jnew, jpsd, jdmax = j_iter(jeng._ed, jnp.asarray(values),
                                              row, depth, sa)
            jnew = np.asarray(jnew)
            jpsd = np.where(act, np.asarray(jpsd), prior)
            jdmax = np.where(act, np.asarray(jdmax), -1.0)
            tv = torch.from_numpy(values.copy())
            psd = torch.zeros(P, s)
            psd[row] = torch.from_numpy(prior)
            dmax = torch.full((P, s), -1.0)
            rows = torch.tensor([row], dtype=torch.int32)
            ok = torch.tensor([True])
            if depth == 1:
                t_one(teng._ed, tv, psd, dmax, rows, ok)
            else:
                t_iter(teng._ed, tv, psd, dmax, rows, ok, depth)
            got = tv.numpy()
            blk = slice(row * C, (row + 1) * C)
            masked = ~np.repeat(act, sub)
            assert np.array_equal(got[blk][masked], values[blk][masked])
            rest = np.ones(n_pad, bool)
            rest[blk] = False
            assert np.array_equal(got[rest], values[rest])
            gpsd, gdmax = psd[row].numpy(), dmax[row].numpy()
            total += s
            same_psd += int((gpsd == jpsd).sum())
            if prog == "pagerank":
                tol_new = 2 * kdeg[blk] * 2.0 ** -24 * np.abs(jnew)
                assert np.all(np.abs(got[blk] - jnew) <= tol_new), row
                tol = dict(rtol=1e-6, atol=float(tol_new.max()))
                np.testing.assert_allclose(gpsd, jpsd, **tol)
                np.testing.assert_allclose(gdmax, jdmax, **tol)
                continue
            assert np.array_equal(got[blk], jnew), (row, depth)
            assert np.array_equal(gdmax, jdmax), (row, depth)
            if prog in ("bfs", "cc"):
                assert np.array_equal(gpsd, jpsd), (row, depth)
            else:
                np.testing.assert_allclose(gpsd, jpsd, rtol=1e-6, atol=0)
    print(f"{prog} S={s}: per-sub PSD bitwise on {same_psd}/{total}")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("prog", ["pagerank", "sssp", "cc"])
def test_run_matches_reference_subblocks(prog, s):
    jg, tg = _graphs(prog)
    cfg = dict(KW, subblocks=s)
    jeng = JEngine(jg, JA.REGISTRY[prog](), JConfig(**cfg))
    teng = TEngine(tg, TA.REGISTRY[prog](), TConfig(**cfg), device="cpu")
    for fused in (True, False):
        ref, got = jeng.run(fused=fused), teng.run(fused=fused)
        rc = tuple(getattr(ref.metrics, f) for f in COUNTERS)
        gc = tuple(getattr(got.metrics, f) for f in COUNTERS)
        print(f"{prog} S={s} fused={fused}: reference {rc} port {gc}")
        assert got.metrics.converged and ref.metrics.converged
        if prog == "pagerank":
            np.testing.assert_allclose(got.values, ref.values, rtol=1e-4,
                                       atol=1e-7)
        else:
            assert np.array_equal(got.values, ref.values)
            assert gc == rc


@pytest.mark.parametrize("prog", ["pagerank", "cc"])
def test_coupling_matches_reference(prog):
    jg, tg = _graphs(prog)
    cfg = dict(KW, subblocks=4)
    jeng = JEngine(jg, JA.REGISTRY[prog](), JConfig(**cfg))
    teng = TEngine(tg, TA.REGISTRY[prog](), TConfig(**cfg), device="cpu")
    assert teng.coupling_counts.shape == (jeng.plan.num_blocks,) * 2 + (4,)
    assert np.array_equal(teng.coupling_counts, jeng.coupling_counts)
    assert np.array_equal(teng._coupling, np.asarray(jeng._coupling))
    assert teng.full_upload_bytes() == jeng.full_upload_bytes()


@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_kernel_order_matches_plain_masked(prog):
    """The kernel's order, re-enacted in numpy from its fold metadata,
    equals the plain masked sweep bitwise (sums included) on a cold slate
    with seeded masks."""
    _, tg = _graphs(prog)
    teng = TEngine(tg, TA.REGISTRY[prog](), TConfig(**KW, subblocks=4),
                   device="cpu")
    P, n_pad = teng.plan.num_blocks, teng._values_len
    rng = np.random.default_rng(5)
    values = _state(prog, n_pad, rng)
    floor = np.float32(teng._psd_floor())
    psd0 = np.where(rng.random((P, 4)) < 0.6, 1.0, floor / 2).astype(
        np.float32)
    rows = torch.from_numpy(rng.permutation(P).astype(np.int32))
    ok = torch.from_numpy(rng.random(P) < 0.8)
    out = []
    for sweep in ("plain", "kernel order"):
        tv = torch.from_numpy(values.copy())
        psd, dmax = torch.from_numpy(psd0.copy()), torch.full((P, 4), -1.0)
        if sweep == "plain":
            teng._proc[0](teng._ed, tv, psd, dmax, rows, ok)
        else:
            emulate_kernel(teng.program, teng.plan.graph.n, teng._ed, tv,
                           rows, ok, psd, dmax, block_size=C,
                           n_live=teng.plan.n_live, floor=floor)
        out.append((tv, psd, dmax))
    for a, b in zip(*out):
        assert torch.equal(a, b)
