"""The port's distributed engine against the JAX package on the same inputs:
the group-padded storage (``PartitionPlan.hot``/``.cold``), the plain
versions of the segmented-combine kernels 2 and 3 against the Pallas kernels
in interpret mode, the kernels' order re-enacted from their head lists,
``make_block_processor``, and whole ``DistributedEngine`` runs: a world of one
in process against the reference's one-device mesh, and four gloo ranks
against the reference on four forced host devices.

Bars (ROADMAP "How the port is held against the reference"): min/max
bitwise; sums within the reordering roundoff 2(k-1)·2^-24 relative for k
messages; SSSP/BFS/CC runs bitwise with identical counters; PageRank runs
at rtol=1e-4, atol=1e-7, with the share of agreeing counters printed.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (emulate_segment_kernel, one_torch_thread,
                           reference_arrays)
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec

from repro.core import algorithms as JA
from repro.core import graph as JG
from repro.core import partition as JP
from repro.core.distributed import DistributedEngine as JDist
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import make_block_processor as j_processor
from repro.kernels import block_sweep as jbs
from repro.kernels import ref as jref
from repro.kernels import spmv as jspmv
from repro_torch import distributed_graph
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import partition as TP
from repro_torch.core.distributed import DistributedEngine, reconcile_values
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.core.engine import StructureAwareEngine, make_block_processor
from repro_torch.interop import STORAGE_FIELDS, engine_from_arrays
from repro_torch.kernels import segment as ks

ROOT = pathlib.Path(__file__).resolve().parents[1]
INF = np.float32(1e18)
IDENT = {"min": INF, "max": -INF}
STORAGE_GRAPHS = {
    "powerlaw": ("powerlaw_graph", dict(n=1500, avg_deg=6, seed=3,
                                        weighted=True)),
    "core_periphery": ("core_periphery_graph", dict(n=2000, avg_deg=5,
                                                    seed=1, chords=1)),
    "uniform": ("uniform_graph", dict(n=1200, deg=4, seed=2)),
}
CFG = dict(t2=1e-9, width=8, block_size=128, hot_inner_iters=4)


def _graph(prog, n=1500):
    """The same graph through both packages (their generators are equal,
    tests/test_torch_host.py)."""
    if prog == "pagerank":
        kw = dict(n=n, avg_deg=8, seed=1, chords=1)
        return JG.core_periphery_graph(**kw), TG.core_periphery_graph(**kw)
    kw = dict(n=n, avg_deg=6, seed=3, weighted=prog == "sssp")
    return JG.powerlaw_graph(**kw), TG.powerlaw_graph(**kw)


def _port(jeng, prog, config, **kw):
    """The port's DistributedEngine on the CPU over the reference engine's
    state and group storages."""
    return engine_from_arrays(TA.REGISTRY[prog](), config,
                              reference_arrays(jeng), device="cpu",
                              cls=DistributedEngine, **kw)


# -- storage -------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(STORAGE_GRAPHS))
def test_group_storage_equals_reference(name):
    fn, kw = STORAGE_GRAPHS[name]
    jplan = JP.build_plan(getattr(JG, fn)(**kw), block_size=128)
    tplan = TP.build_plan(getattr(TG, fn)(**kw), block_size=128)
    fresh = TP.build_plan(getattr(TG, fn)(**kw), block_size=128)
    assert jplan.barrier_block == tplan.barrier_block
    for key in ("hot", "cold"):
        want, got = getattr(jplan, key), getattr(tplan, key)
        on_dev = fresh.group_storage(key, "cpu")  # built as tensors
        assert got.capacity % 128 == 0 and got.capacity == want.capacity
        for f in STORAGE_FIELDS:
            a, b = np.asarray(getattr(want, f)), getattr(got, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (key, f)
            c = getattr(on_dev, f)
            c = c.numpy() if isinstance(c, torch.Tensor) else c
            assert c.dtype == a.dtype and np.array_equal(a, c), (key, f)
        # the padded tail: dst_local 0 and valid False past each row's edges
        tail = np.arange(got.capacity)[None, :] >= got.edges[:, None]
        assert not got.valid[tail].any() and not got.dst_local[tail].any()


# -- plain kernels against the Pallas kernels ------------------------------------
def _row(c, rng, e=1700):
    """A destination row with every case the kernels meet: a sorted valid
    prefix (runs across tile edges), an unsorted stretch, destinations
    without messages, and a padded tail of dst 0; E is not a multiple of
    512."""
    dst = rng.integers(0, c // 2, e).astype(np.int32)
    dst[:e // 2] = np.sort(dst[:e // 2])
    dst[e - e // 4:] = 0
    return dst, e - e // 4


@pytest.mark.parametrize("combine", ["min", "max"])
@pytest.mark.parametrize("c", [128, 512, 4096])
def test_plain_min_max_match_pallas(c, combine):
    rng = np.random.default_rng(c)
    dst, tail = _row(c, rng)
    ident = IDENT[combine]
    msg = rng.uniform(0.0, 30.0, dst.size).astype(np.float32)
    msg[tail:] = ident
    got = getattr(ks, f"edge_block_{combine}_ref")(
        torch.from_numpy(msg), torch.from_numpy(dst), c, ident).numpy()
    pallas = getattr(jbs, f"edge_block_{combine}")(
        jnp.asarray(msg), jnp.asarray(dst), c, float(ident), interpret=True)
    dense = getattr(jref, f"edge_block_{combine}")(
        jnp.asarray(msg), jnp.asarray(dst), c, float(ident))
    assert np.array_equal(got, np.asarray(pallas))
    assert np.array_equal(got, np.asarray(dense))
    assert (got == ident).any()  # empty slots keep the identity
    # the CPU path of the wrapper is the plain version
    wrapped = getattr(ks, f"edge_block_{combine}")(
        torch.from_numpy(msg), torch.from_numpy(dst), c, ident)
    assert np.array_equal(wrapped.numpy(), got)


@pytest.mark.parametrize("c", [128, 512, 4096])
def test_plain_sum_matches_pallas_within_roundoff(c):
    rng = np.random.default_rng(c + 1)
    dst, tail = _row(c, rng)
    msg = rng.uniform(0.0, 1.0, dst.size).astype(np.float32)
    msg[tail:] = 0.0
    got = ks.edge_block_sum(torch.from_numpy(msg), torch.from_numpy(dst),
                            c).numpy()
    k = np.bincount(dst[:tail], minlength=c)
    # two orders of summing k positive f32 terms differ by at most 2(k-1)
    # units of roundoff relative to the sum
    for want in (jspmv.edge_block_sum(jnp.asarray(msg), jnp.asarray(dst), c,
                                      interpret=True),
                 jref.edge_block_sum(jnp.asarray(msg), jnp.asarray(dst), c)):
        want = np.asarray(want)
        tol = 2 * np.maximum(k - 1, 0) * 2.0 ** -24 * np.abs(want)
        assert np.all(np.abs(got - want) <= tol)
    assert np.array_equal(got[k == 0], np.zeros(int((k == 0).sum())))


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_kernel_order_emulated_from_head_lists(combine):
    """The kernel, re-enacted from a group layout's run table (its head
    list: each run's first slot, in slot order), equals the plain version
    bit for bit on rows that are not sorted by destination (a sorted
    prefix, an unsorted stretch and a padded tail of dst 0; fully
    unsorted), sums included; the table lists every run head once."""
    c, rng = 256, np.random.default_rng(7)
    rows = []
    for r in range(3):
        dst, tail = _row(c, rng, e=1300)
        if r == 2:  # fully unsorted, no tail
            dst = rng.integers(0, c, dst.size).astype(np.int32)
        rows.append(dst)
    dst2 = torch.from_numpy(np.stack(rows))
    layout = ks.segment_layout(dst2, c)
    init = 0.0 if combine == "sum" else IDENT[combine]
    for r, dst in enumerate(dst2):
        heads = np.flatnonzero(ks.run_heads(dst).numpy())
        base = int((layout.npieces[:r] + 1).sum())
        assert layout.pstart[base:base + heads.size + 1].tolist() == (
            heads.tolist() + [dst.numel()])
        msg = torch.from_numpy(rng.uniform(0.0, 1.0, dst.numel())
                               .astype(np.float32))
        plain = getattr(ks, f"edge_block_{combine}_ref")(
            msg, dst, c, *(() if combine == "sum" else (init,)))
        got = emulate_segment_kernel(msg, layout, r, combine, init)
        assert np.array_equal(_bits(got), _bits(plain.numpy())), r


def _bits(x):
    """The f32 bit patterns of ``x``: equal bits, not equal values (-0.0 is
    not +0.0)."""
    return np.asarray(x, dtype=np.float32).view(np.uint32)


SORTED_CASES = ("long", "empty", "len1", "len511", "len512", "len513",
                "len1300", "negzero")


def _sorted_row(case, c, rng):
    """A destination row sorted by destination, and its messages, for one
    case of the kernel's sorted paths (c destinations)."""
    e = {"long": 9000, "empty": 3000, "negzero": 2000}.get(case)
    e = int(case[3:]) if e is None else e
    dst = rng.integers(0, c, e)
    if case == "long":  # ~12 pieces into one destination
        dst[1000:7000] = c // 3
    if case == "empty":  # only every 4th destination has slots
        dst = dst // 4 * 4
    dst = np.sort(dst).astype(np.int32)
    msg = rng.uniform(-1.0, 1.0, e).astype(np.float32)
    if case == "negzero":  # a destination of -0.0 messages, and a lone one
        msg[dst == dst[700]] = -0.0
        lone = np.flatnonzero(np.bincount(dst, minlength=c) == 1)
        msg[np.isin(dst, lone[:1])] = -0.0
    return torch.from_numpy(dst), torch.from_numpy(msg)


@pytest.mark.parametrize("case", SORTED_CASES)
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_sorted_kernel_order_emulated(combine, case):
    """The kernel's sorted paths, re-enacted from the layout's offsets and
    piece table, equal the plain version bit for bit (the sign of zero
    included): a destination of more than LONG_PIECES pieces (the long
    path), empty destinations, rows of 1, 511, 512, 513 and 1300 slots,
    pieces of -0.0 (the short path folds a piece from +0)."""
    c, rng = 256, np.random.default_rng(SORTED_CASES.index(case))
    dst, msg = _sorted_row(case, c, rng)
    layout = ks.segment_layout(dst, c)
    assert layout.path[0] == (ks.LONG if case == "long" else ks.SHORT)
    init = 0.0 if combine == "sum" else IDENT[combine]
    plain = getattr(ks, f"edge_block_{combine}_ref")(
        msg, dst, c, *(() if combine == "sum" else (init,)))
    got = emulate_segment_kernel(msg, layout, 0, combine, init)
    assert np.array_equal(_bits(got), _bits(plain.numpy()))
    if case == "negzero" and combine == "sum":
        assert (_bits(plain.numpy()) == 0x80000000).sum() == 0  # no -0 out


@pytest.mark.parametrize("name", sorted(STORAGE_GRAPHS))
@pytest.mark.parametrize("combine", ["sum", "min", "max"])
def test_sorted_kernel_order_on_group_storage(combine, name):
    """Every row of a real group storage (``_build_storage``), over its
    valid prefix as the block processor calls the kernel: sorted by
    destination, and the kernel's order re-enacted from the layout equals
    the plain version bit for bit."""
    fn, kw = STORAGE_GRAPHS[name]
    plan = TP.build_plan(getattr(TG, fn)(**kw), block_size=128)
    rng = np.random.default_rng(11)
    init = 0.0 if combine == "sum" else IDENT[combine]
    for key in ("hot", "cold"):
        st = plan.group_storage(key, "cpu")
        layout = ks.segment_layout(st.dst_local, 128, st.edges)
        for r, e in enumerate(int(x) for x in st.edges):
            assert (np.diff(st.dst_local[r, :e].numpy()) >= 0).all(), key
            msg = torch.from_numpy(rng.uniform(0.0, 30.0, e).astype(
                np.float32))
            plain = getattr(ks, f"edge_block_{combine}_ref")(
                msg, st.dst_local[r, :e], 128,
                *(() if combine == "sum" else (init,)))
            got = emulate_segment_kernel(msg, layout, r, combine, init)
            assert np.array_equal(_bits(got), _bits(plain.numpy())), (key, r)


def _runs(row):
    """A row's runs, independently of the port: (first slot, destination)
    of each maximal stretch of equal dst inside a 512-slot tile."""
    return [(i, int(x)) for i, x in enumerate(row)
            if i % 512 == 0 or row[i - 1] != x]


def test_segment_layout_paths_and_offsets():
    """segment_layout's run table of each row, judged on the covered prefix
    only, equals one built independently: on a row sorted by destination,
    from the offsets of an np.searchsorted (each destination's range cut
    at the multiples of 512); on any row, from a scan for run heads. Its
    run offsets, start slots, targets, each tile's first run, empty and
    chained destinations, and each row's path (long past LONG_PIECES runs
    of a destination or CHAIN_MAX chained ones); the per-row launch
    arguments point at the rows' entries."""
    c, e, rng = 128, 5000, np.random.default_rng(2)
    short = np.sort(rng.integers(0, c, e))
    long_ = np.sort(np.concatenate([rng.integers(0, c, e - 3000),
                                    np.full(3000, 77)]))
    mixed = short.copy()
    mixed[4000:] = rng.integers(0, c, e - 4000)  # sorted up to 4000 only
    tail = short.copy()
    tail[4500:] = 0  # a padded tail of dst 0
    rows = np.stack([short, long_, mixed, mixed, tail, tail]).astype(np.int32)
    lengths = [e, e, e, 4000, e, 4500]
    layout = ks.segment_layout(torch.from_numpy(rows), c, lengths)
    assert layout.path.tolist() == [ks.SHORT, ks.LONG, ks.LONG, ks.SHORT,
                                    ks.SHORT, ks.SHORT]
    bases = {f: 0 for f in ("pstart", "ptarget", "tpiece", "empty",
                            "chain")}
    for r, (row, k) in enumerate(zip(rows, lengths)):
        assert layout.calls[r][:2] == (layout.dst[r].data_ptr(), k)
        runs = _runs(row[:k])
        if (np.diff(row[:k]) >= 0).all():  # sorted: the same from offsets
            off = np.searchsorted(row[:k], np.arange(c + 1), side="left")
            cut = [(x, d) for d in range(c)
                   for x in ([off[d]] + list(range(
                       (off[d] // 512 + 1) * 512, off[d + 1], 512))
                       if off[d + 1] > off[d] else [])]
            assert cut == runs, r
        count = np.bincount([d for _, d in runs], minlength=c)
        lptr = np.concatenate([[0], np.cumsum(count)])
        assert np.array_equal(layout.lptr[r].numpy(), lptr), r
        seen = np.zeros(c, np.int64)
        ptarget = []
        for _, d in runs:
            ptarget.append(d if count[d] == 1
                           else -1 - (int(lptr[d]) + int(seen[d])))
            seen[d] += 1
        pstart = [x for x, _ in runs]
        want = {"pstart": np.array(pstart + [k]),
                "ptarget": np.array(ptarget),
                "tpiece": np.append(np.searchsorted(pstart,
                                                    np.arange(0, k, 512)),
                                    len(pstart)),
                "empty": np.flatnonzero(count == 0),
                "chain": np.flatnonzero(count > 1)}
        for f, w in want.items():
            got = getattr(layout, f)[bases[f]:bases[f] + len(w)].numpy()
            assert np.array_equal(got, w), (r, f)
            bases[f] += len(w)
        assert (layout.npieces[r], layout.ntiles[r]) == (len(ptarget),
                                                         -(-k // 512))
        assert (layout.nempty[r], layout.nchain[r]) == (
            len(want["empty"]), len(want["chain"]))
        long = count.max() > ks.LONG_PIECES or (count > 1).sum() > ks.CHAIN_MAX
        assert (layout.path[r] == ks.LONG) == long, r
    for r in range(len(rows)):  # each row's launch arguments at its entries
        a, before = layout.args[r], slice(0, r)
        assert a.ptarget - layout.ptarget.data_ptr() == 4 * int(
            layout.npieces[before].sum())
        assert a.pstart - layout.pstart.data_ptr() == 4 * int(
            (layout.npieces[before] + 1).sum())
        assert a.path == layout.path[r] and a.e == lengths[r]
    assert layout.part_len == int(layout.lptr[:, -1].max())
    # many destinations of two runs make a row long too
    wide = np.repeat(np.arange(2048), 200).astype(np.int32)
    many = ks.segment_layout(torch.from_numpy(wide), 2048)
    assert many.path[0] == ks.LONG and many.nchain[0] > ks.CHAIN_MAX
    assert int(np.diff(many.lptr[0].numpy()).max()) <= ks.LONG_PIECES


# -- the block processor ---------------------------------------------------------
def _state(prog, n, rng):
    if prog == "pagerank":
        return rng.uniform(0.0, 2.0 / n, n).astype(np.float32)
    if prog == "cc":  # labels: vertex ids
        return rng.integers(0, n, n).astype(np.float32)
    v = np.where(rng.random(n) < 0.4, INF,
                 rng.uniform(0.0, 30.0, n)).astype(np.float32)
    if prog == "bfs":
        v = np.where(v < INF, np.floor(v), v).astype(np.float32)
    return v


@pytest.mark.parametrize("t_inner", [1, 4])
@pytest.mark.parametrize("prog", ["pagerank", "sssp", "bfs", "cc"])
def test_processor_matches_reference(prog, t_inner):
    jg, _ = _graph(prog, 1200)
    jeng = JDist(jg, JA.REGISTRY[prog](), JConfig(**CFG))
    teng = _port(jeng, prog, TConfig(**CFG))
    plan, c = jeng.plan, CFG["block_size"]
    n = teng._values_len
    values = _state(prog, n, np.random.default_rng(5))
    kdeg = np.maximum(np.pad(plan.graph.in_deg, (0, n - plan.graph.n)), 1)
    same_psd = total = 0
    for key in ("hot", "cold"):
        jone, jiter, _ = j_processor(jeng.program, getattr(plan, key),
                                     jeng.aux, c, plan.n_live, plan.graph.n,
                                     False)
        jfn = jax.jit(jone) if t_inner == 1 else jax.jit(
            jiter, static_argnums=2)
        tone, titer, gids = teng._procs[key]
        for row in range(getattr(plan, key).num_blocks):
            jargs = (jnp.asarray(values), row) + (
                () if t_inner == 1 else (t_inner,))
            jbase, jnew, jpsd, jdmax = (np.asarray(x) for x in jfn(*jargs))
            tv = torch.from_numpy(values.copy())
            if t_inner == 1:
                base, new, psd, dmax = tone(tv, row)
                assert np.array_equal(tv.numpy(), values)  # functional
            else:
                base, new, psd, dmax = titer(tv, row, t_inner)
                rest = np.ones(n, bool)
                rest[base:base + c] = False
                assert np.array_equal(tv.numpy()[rest], values[rest])
                assert np.array_equal(tv.numpy()[base:base + c], new)
            assert base == int(jbase) == gids[row] * c
            new = new.numpy()
            total += 1
            same_psd += psd.item() == float(jpsd)
            if prog == "pagerank":
                tol = 2 * kdeg[base:base + c] * 2.0 ** -24 * np.abs(jnew)
                assert np.all(np.abs(new - jnew) <= tol * t_inner), row
                # |new - old| inherits new's rounding difference
                at = dict(rtol=1e-6, atol=float(tol.max()) * t_inner)
                np.testing.assert_allclose(psd.item(), float(jpsd), **at)
                np.testing.assert_allclose(dmax.item(), float(jdmax), **at)
                continue
            assert np.array_equal(new, jnew), row
            assert dmax.item() == float(jdmax), row
            if prog == "sssp":
                # the mean's sum order is the kernels' pairwise tree, not
                # XLA's (ROADMAP fact 3): held to its roundoff
                np.testing.assert_allclose(psd.item(), float(jpsd),
                                           rtol=1e-6, atol=0)
            else:  # integer-valued deltas: exact in any order
                assert psd.item() == float(jpsd), row
    print(f"{prog} t_inner={t_inner}: PSD bitwise on {same_psd}/{total} rows")


# -- whole runs ----------------------------------------------------------------
def _counters(m):
    return (m.iterations, m.updates, m.block_loads, m.bytes_loaded,
            m.converged)


@pytest.mark.parametrize("prog", ["sssp", "bfs", "cc", "pagerank"])
def test_world_of_one_matches_reference(prog):
    jg, _ = _graph(prog)
    jeng = JDist(jg, JA.REGISTRY[prog](), JConfig(**CFG),
                 blocks_per_device=2)
    teng = _port(jeng, prog, TConfig(**CFG), blocks_per_device=2)
    assert (teng.world, teng.rank, teng.bpd) == (1, 0, 2)
    assert (teng.config.width, teng.config.fused, teng.config.adaptive,
            teng.config.subblocks) == (2, False, False, 1)
    jr, tr = jeng.run(), teng.run()
    assert tr.metrics.converged and jr.metrics.converged
    if prog == "pagerank":
        np.testing.assert_allclose(tr.values, jr.values, rtol=1e-4,
                                   atol=1e-7)
        same = sum(a == b for a, b in zip(_counters(tr.metrics),
                                          _counters(jr.metrics)))
        print(f"pagerank world of one: {same}/5 counters agree "
              f"(port {_counters(tr.metrics)}, reference "
              f"{_counters(jr.metrics)}); values bitwise on "
              f"{int((tr.values == jr.values).sum())}/{tr.values.size}")
        return
    assert np.array_equal(tr.values, jr.values)
    assert _counters(tr.metrics) == _counters(jr.metrics)


def test_sum_reconcile_is_a_plus_b_minus_a():
    """On a one-device mesh the reference computes values_in +
    psum(values_l - values_in) as written; the port's world of one does the
    same arithmetic, which is not simply values_l."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, 65536).astype(np.float32)
    b = (rng.uniform(0.0, 1.0, a.size)
         * 10.0 ** rng.uniform(-3.0, 0.0, a.size)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = jax.jit(shard_map(lambda x, y: x + jax.lax.psum(y - x, "data"),
                           mesh=mesh, in_specs=(PartitionSpec(),) * 2,
                           out_specs=PartitionSpec(), check_rep=False))
    want = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
    got = reconcile_values("sum", torch.from_numpy(a), torch.from_numpy(b),
                           collective=False).numpy()
    assert np.array_equal(got, want)
    assert (got != b).any()


JAX_FOUR = """
    import json, sys
    import numpy as np
    import jax
    from repro.core import algorithms as A, graph as G
    from repro.core.distributed import DistributedEngine
    from repro.core.engine import EngineConfig
    assert len(jax.devices()) == 4
    cases, cfg, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), {}
    for key, (prog, gfn, gkw, bpd) in cases.items():
        r = DistributedEngine(getattr(G, gfn)(**gkw), A.REGISTRY[prog](),
                              EngineConfig(**cfg),
                              blocks_per_device=bpd).run()
        m = r.metrics
        out[key + "_values"] = r.values
        out[key + "_counters"] = np.array([m.iterations, m.updates,
            m.block_loads, m.bytes_loaded, m.converged], dtype=np.int64)
    np.savez(sys.argv[3], **out)
"""
FOUR_CFG = dict(t2=1e-9, width=8, block_size=256, hot_inner_iters=4)
FOUR_CASES = {
    f"{prog}_bpd{bpd}": (prog, gfn, gkw, bpd)
    for prog, gfn, gkw in (
        ("pagerank", "core_periphery_graph",
         dict(n=3000, avg_deg=8, seed=1, chords=1)),
        ("sssp", "powerlaw_graph", dict(n=3000, avg_deg=6, seed=3,
                                        weighted=True)),
        ("cc", "powerlaw_graph", dict(n=2000, avg_deg=6, seed=3)))
    for bpd in (1, 2)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference on four forced host devices (a subprocess) and the port
    on four gloo ranks (spawned), side by side; then the port's local
    engine on each graph."""
    out = tmp_path_factory.mktemp("four") / "jax.npz"
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_FOUR),
         json.dumps(FOUR_CASES), json.dumps(FOUR_CFG), str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        graphs = {key: getattr(TG, gfn)(**gkw)
                  for key, (_, gfn, gkw, _) in FOUR_CASES.items()}
        jobs = [(graphs[key], prog, TConfig(**FOUR_CFG), bpd)
                for key, (prog, _, _, bpd) in FOUR_CASES.items()]
        ranks = distributed_graph.run_ranks(jobs, 4, "cpu", timeout=240)
        local = {key: StructureAwareEngine(
                     graphs[key], TA.REGISTRY[prog](), TConfig(**FOUR_CFG),
                     device="cpu").run()
                 for key, (prog, _, _, bpd) in FOUR_CASES.items() if bpd == 1}
        _, err = jax_run.communicate(timeout=240)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, err
    ref = dict(np.load(out))
    return {key: (ref, [r[i] for r in ranks],
                  local[key.replace("bpd2", "bpd1")])
            for i, key in enumerate(FOUR_CASES)}


@pytest.mark.parametrize("key", sorted(FOUR_CASES))
def test_four_ranks_match_reference(four_ranks, key):
    ref, per_rank, local = four_ranks[key]
    got = per_rank[0]
    want = ref[key + "_values"]
    assert got.metrics.converged
    for other in per_rank[1:]:  # every rank holds the same replica
        assert np.array_equal(other.values, got.values)
        assert _counters(other.metrics) == _counters(got.metrics)
    counters = np.array(_counters(got.metrics), dtype=np.int64)
    if key.startswith("pagerank"):
        np.testing.assert_allclose(got.values, want, rtol=1e-4, atol=1e-7)
        print(f"{key}: {int((counters == ref[key + '_counters']).sum())}/5 "
              f"counters agree (port {counters.tolist()}, reference "
              f"{ref[key + '_counters'].tolist()})")
        # as the reference test asserts of its own engines
        np.testing.assert_allclose(local.values, got.values, rtol=1e-4,
                                   atol=1e-8)
        return
    assert np.array_equal(got.values, want)
    assert np.array_equal(counters, ref[key + "_counters"])
    assert np.array_equal(local.values, got.values)


# -- errors, pins, entry points --------------------------------------------------
def test_errors_and_pins(monkeypatch):
    _, tg = _graph("sssp", 800)
    eng = DistributedEngine(tg, TA.sssp(0), TConfig(width=12, fused=True,
                                                    adaptive=True,
                                                    subblocks=4),
                            device="cpu")
    assert eng.bpd == 12 and (eng.config.width, eng.config.fused,
                              eng.config.adaptive,
                              eng.config.subblocks) == (12, False, False, 1)
    with pytest.raises(ValueError, match="fused loop"):
        eng.run(fused=True)
    with pytest.raises(ValueError, match="warm restarts"):
        eng.run(warm=object())
    # a storage whose valid slots are not each row's edge prefix is refused
    st = eng.plan.group_storage("hot", "cpu")
    hole = dataclasses.replace(st, valid=st.valid.clone())
    hole.valid[0, 0] = False
    with pytest.raises(ValueError, match="not the prefix"):
        make_block_processor(TA.sssp(0), hole, torch.zeros(tg.n), 256,
                             eng.plan.n_live, tg.n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedEngine(tg, TA.sssp(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_graph.main(["--n", "300"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_graph.run_ranks([], 2)


def test_distributed_graph_cli(capsys):
    distributed_graph.main(["--n", "1500", "--nproc", "2", "--device",
                            "cpu"])
    out = capsys.readouterr().out
    assert "ranks=2" in out and "ranks agree=True agree=True" in out
