"""The port's block sweep (plain version, on the CPU) against the
reference's dense per-block processor and its Pallas kernel.

Both run on the same state: the reference engine's EdgeData and values are
handed to the port through ``repro_torch.interop``. The bar:

* new block values of the min/max programs (SSSP, BFS, CC): bitwise
  against ``make_tiled_processor(..., use_pallas=False)``.
* PageRank's new values: within the roundoff bound of reordering a sum,
  2(k-1)·2^-24 relative for a destination with k in-edges (the bitwise
  share and the worst relative difference are printed).
  ``apply`` matches XLA's fused FMA (float64 from the f32 operands, one
  rounding), but the sum does not follow the same order: XLA folds the
  per-tile partials into ONE sequential chain per destination over all of
  its edges, while the port (kernel and plain version alike) sums each
  tile's run in slot order and then the partials in tile order, so that a
  hub destination is never one sequential chain (see
  csrc/block_sweep.cu).
* min/max programs: also bitwise against the reference Pallas kernel
  (``make_block_sweep(..., interpret=True)``). The Pallas sum is not an
  oracle: it already fails its own parity tests on this JAX version.
* per-block max delta: bitwise for the min/max programs (a max is exact
  in any order); PageRank's deltas inherit the values' difference.
* per-block mean delta (the PSD): BFS and CC deltas are integers, so the
  sum is exact in any order and the PSD is bitwise; SSSP sums floats in
  another order than XLA's reduce, so it is held to rtol=1e-6; the
  bitwise share is printed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread, port_engine  # noqa: F401

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import StructureAwareEngine as JEngine
from repro.core.engine import make_tiled_processor as j_processor
from repro.kernels.block_sweep import make_block_sweep
from repro_torch.core import algorithms as TA
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.kernels import block_sweep as kb

C = 64
GRAPHS = {
    "powerlaw": lambda w: JG.powerlaw_graph(1200, 6, seed=11, weighted=w),
    "core_periphery": lambda w: JG.core_periphery_graph(
        1500, 6, seed=12, chords=1, weighted=w),
}


def _state(name, n_pad, rng):
    """A mid-run value vector: the sweep sees every kind of entry."""
    if name == "pagerank":
        return rng.uniform(0.0, 2.0 / n_pad, n_pad).astype(np.float32)
    if name == "cc":
        return rng.permutation(n_pad).astype(np.float32)
    v = np.where(rng.random(n_pad) < 0.4, JA.INF,
                 rng.uniform(0.0, 30.0, n_pad)).astype(np.float32)
    if name == "bfs":
        v = np.where(v < JA.INF, np.floor(v), v).astype(np.float32)
    return v


def _pair(prog, gname):
    g = GRAPHS[gname](prog == "sssp")
    jeng = JEngine(g, JA.REGISTRY[prog](), JConfig(block_size=C, width=4))
    teng = port_engine(jeng, TA.REGISTRY[prog](), TConfig(block_size=C,
                                                          width=4))
    return jeng, teng


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_sweep_matches_dense(prog, gname):
    jeng, teng = _pair(prog, gname)
    plan = jeng.plan
    n_pad = teng._values_len
    values = _state(prog, n_pad, np.random.default_rng(5))
    proc_one, proc_iter, _ = j_processor(
        jeng.program, plan.unified, C, plan.n_live, plan.graph.n, False)
    j_one = jax.jit(proc_one)
    j_iter = jax.jit(proc_iter)
    t_one, t_iter = teng._proc
    P = plan.num_blocks
    same_psd = same_new = 0
    worst = 0.0
    kdeg = np.maximum(np.pad(plan.graph.in_deg, (0, n_pad - plan.graph.n)),
                      1)
    for row in range(P):
        for depth in (1, 3):
            if depth == 1:
                _, jnew, jpsd, jdmax = j_one(jeng._ed, jnp.asarray(values),
                                             row)
            else:
                _, jnew, jpsd, jdmax = j_iter(jeng._ed, jnp.asarray(values),
                                              row, depth)
            jnew = np.asarray(jnew)
            tv = torch.from_numpy(values.copy())
            psd = torch.zeros(P, 1)
            dmax = torch.zeros(P, 1)
            rows = torch.tensor([row], dtype=torch.int32)
            ok = torch.tensor([True])
            if depth == 1:
                t_one(teng._ed, tv, psd, dmax, rows, ok)
            else:
                t_iter(teng._ed, tv, psd, dmax, rows, ok, depth)
            got = tv.numpy()
            blk = slice(row * C, (row + 1) * C)
            if prog == "pagerank":
                # two orders of summing k positive f32 terms differ by at
                # most 2(k-1) units of roundoff relative to the sum
                tol_new = 2 * kdeg[blk] * 2.0 ** -24 * np.abs(jnew)
                assert np.all(np.abs(got[blk] - jnew) <= tol_new), (row,
                                                                     depth)
                same_new += int((got[blk] == np.asarray(jnew)).sum())
                worst = max(worst, float(np.max(
                    np.abs(got[blk] - jnew) / np.abs(jnew))))
            else:
                assert np.array_equal(got[blk], np.asarray(jnew)), \
                    (row, depth)
            rest = np.ones(n_pad, bool)
            rest[blk] = False
            assert np.array_equal(got[rest], values[rest])
            same_psd += psd[row, 0].item() == float(jpsd)
            if prog == "pagerank":
                # |new - old| inherits new's rounding difference, so the
                # deltas are held to it in absolute terms
                tol = dict(rtol=1e-6, atol=float(tol_new.max()))
                np.testing.assert_allclose(dmax[row, 0].item(),
                                           float(jdmax), **tol)
                np.testing.assert_allclose(psd[row, 0].item(), float(jpsd),
                                           **tol)
                continue
            assert dmax[row, 0].item() == float(jdmax)
            if prog in ("bfs", "cc"):
                assert psd[row, 0].item() == float(jpsd), (row, depth)
            else:
                np.testing.assert_allclose(psd[row, 0].item(), float(jpsd),
                                           rtol=1e-6, atol=0)
    print(f"{prog}/{gname}: PSD bitwise on {same_psd}/{2 * P} sweeps")
    if prog == "pagerank":
        print(f"pagerank/{gname}: values bitwise on "
              f"{same_new}/{2 * P * C}, worst relative difference {worst}")


@pytest.mark.parametrize("prog", ["sssp", "bfs", "cc"])
def test_sweep_matches_pallas_min_max(prog):
    jeng, teng = _pair(prog, "powerlaw")
    plan = jeng.plan
    u = plan.unified
    sweep = make_block_sweep(jeng.program, u.tile_start, u.tile_cnt,
                             n_tiles=int(u.src.shape[0]),
                             tile_w=int(u.src.shape[1]), block_size=C,
                             n_total=plan.graph.n, interpret=True)
    values = _state(prog, teng._values_len, np.random.default_rng(6))
    for row in range(plan.num_blocks):
        pnew = np.asarray(sweep(jeng._ed, jnp.asarray(values), row))
        old = values[row * C:(row + 1) * C]
        live = row * C + np.arange(C) < plan.n_live
        pnew = np.where(live, pnew, old)
        tv = torch.from_numpy(values.copy())
        P = plan.num_blocks
        teng._proc[0](teng._ed, tv, torch.zeros(P, 1), torch.zeros(P, 1),
                      torch.tensor([row], dtype=torch.int32),
                      torch.tensor([True]))
        assert np.array_equal(tv.numpy()[row * C:(row + 1) * C], pnew), row


@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_cold_slate_reads_one_snapshot(prog):
    """A multi-slot sweep equals each slot swept alone from the same
    snapshot; slots that are not ok (padding with repeated ids included)
    write nothing."""
    jeng, teng = _pair(prog, "core_periphery")
    P = jeng.plan.num_blocks
    values = _state(prog, teng._values_len, np.random.default_rng(7))
    rows = torch.tensor([3, 0, 5, 1, 0, 7], dtype=torch.int32)
    ok = torch.tensor([True, True, False, True, False, True])
    tv = torch.from_numpy(values.copy())
    psd, dmax = torch.full((P, 1), -1.0), torch.full((P, 1), -1.0)
    teng._proc[0](teng._ed, tv, psd, dmax, rows, ok)
    for r in range(P):
        blk = slice(r * C, (r + 1) * C)
        if r in (3, 0, 1, 7):
            one = torch.from_numpy(values.copy())
            p1, d1 = torch.zeros(P, 1), torch.zeros(P, 1)
            teng._proc[0](teng._ed, one, p1, d1,
                          torch.tensor([r], dtype=torch.int32),
                          torch.tensor([True]))
            assert torch.equal(tv[blk], one[blk])
            assert psd[r] == p1[r] and dmax[r] == d1[r]
        else:
            assert np.array_equal(tv.numpy()[blk], values[blk])
            assert psd[r] == -1.0 and dmax[r] == -1.0


def test_out_of_place_sweep_keeps_input():
    jeng, teng = _pair("pagerank", "powerlaw")
    P = jeng.plan.num_blocks
    values = _state("pagerank", teng._values_len, np.random.default_rng(8))
    rows = torch.arange(P, dtype=torch.int32)
    ok = torch.ones(P, dtype=torch.bool)
    inp = torch.from_numpy(values.copy())
    out = torch.empty_like(inp)
    teng._proc[0](teng._ed, inp, torch.zeros(P, 1), torch.zeros(P, 1), rows,
                  ok, out=out)
    ref = torch.from_numpy(values.copy())
    teng._proc[0](teng._ed, ref, torch.zeros(P, 1), torch.zeros(P, 1), rows,
                  ok)
    assert np.array_equal(inp.numpy(), values)
    assert torch.equal(out, ref)


def test_pairwise_sum_is_the_kernel_tree():
    """The plain reduction pads to a power of two and halves; for a power
    of two it equals the explicit stride-halving loop the kernel runs."""
    x = torch.from_numpy(np.random.default_rng(9).random(64)
                         .astype(np.float32))
    s = x.clone()
    h = 32
    while h:
        s[:h] = s[:h] + s[h:2 * h]
        h //= 2
    assert kb.pairwise_sum(x).item() == s[0].item()
    assert kb.pairwise_sum(x[:48]).item() == kb.pairwise_sum(
        torch.nn.functional.pad(x[:48], (0, 16))).item()


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """The wrapper dispatches on the tensor's device only: anything that is
    not on the CPU goes to the kernel (which raises without a card)."""
    called = []
    monkeypatch.setattr(kb, "block_sweep_ref",
                        lambda *a, **k: called.append(1))
    jeng, teng = _pair("sssp", "powerlaw")
    P = jeng.plan.num_blocks
    meta = torch.empty(teng._values_len, device="meta")
    with pytest.raises(ValueError):
        kb.block_sweep(teng.program, 10, teng._ed, meta,
                       torch.zeros(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.bool), torch.zeros(P, 1),
                       torch.zeros(P, 1), kb.make_scratch(teng._ed, C),
                       block_size=C, n_live=1)
    assert not called
