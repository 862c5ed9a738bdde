#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit, torch/CUDA versions, and the
   build of the block-sweep kernel from csrc/ (seconds, ptxas report).
2. Kernel vs plain version, on the full-size graphs of phase 3: the kernel on
   the card and ``block_sweep_ref`` on CPU copies of the same inputs, for the
   hub block plus 64 seeded random blocks, as one slate at depth 1 and as
   one-slot chains at depth 8. Min/max programs must agree bitwise; the sum
   program bitwise or within rtol=1e-6 (the bitwise share is printed). Then
   the time of one full cold sweep of every block (kernel, plain version on
   the card, and a library yardstick that the port never calls) beside the
   least time the card could take for it.
3. The main path at n = 2^21 vertices, avg_deg 16 (~33.5M edges):
   PageRank on core_periphery_graph(seed=1, chords=1) and SSSP on a
   weighted powerlaw_graph, each through StructureAwareEngine.run() and
   BaselineEngine.run() with block_size=512 (P=4096), width=128, t2=1e-9
   (PageRank: scaled to 1/n, see T2_PAGERANK).
   SSSP fixpoints must be bitwise equal, PageRank must agree at rtol=1e-4,
   atol=2e-3/n, and the sweep kernel must have launched on the main path.
4. One JSON line of kernel rows, the card line, and the final ok line.

It needs the repository's src/ beside it, and a CUDA card: without either it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 1 << 21
AVG_DEG = 16
BLOCK = 512
WIDTH = 128
T2 = 1e-9
# PageRank's PSD is in value units, which shrink as 1/n: the quickstart's
# t2 (at n = 20000) scaled to 1/n, like its atol. At t2 = 1e-9 the slow
# core ring keeps a residual over the rtol in the reference engine too.
T2_PAGERANK = T2 * 20000 / N
SA_CAP = 20000  # superstep cap: keeps the script inside its time limit
BASE_CAP = 2000  # baseline iteration cap
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs, after one
    warm-up run, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mid_run_state(name, n_pad, rng):
    """A value vector with every kind of entry a sweep meets mid-run."""
    import numpy as np
    if name == "pagerank":
        return rng.uniform(0.0, 2.0 / n_pad, n_pad).astype(np.float32)
    return np.where(rng.random(n_pad) < 0.4, np.float32(1e18),
                    rng.uniform(0.0, 30.0, n_pad)).astype(np.float32)


def check_kernel(name, eng, rng):
    """Phase 2 for one engine's tiles: kernel vs plain version. Returns the
    largest absolute difference of the new values."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = eng.plan.num_blocks
    c = eng.plan.block_size
    ed = eng._ed
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    hub = int(np.argmax(eng.plan.unified.tile_cnt))
    others = rng.choice(np.setdiff1d(np.arange(P), [hub]), size=64,
                        replace=False)
    blocks = np.concatenate([[hub], others]).astype(np.int32)
    values = mid_run_state(name, eng._values_len, rng)
    sc_gpu = kb.make_scratch(ed, c)
    sc_cpu = kb.make_scratch(ed_cpu, c)
    args = dict(block_size=c, n_live=eng.plan.n_live)
    n_total = eng.plan.graph.n
    worst = 0.0
    same = total = 0

    def compare(label, g_vals, c_vals, g_psd, c_psd, g_dmax, c_dmax):
        nonlocal worst, same, total
        gv, cv = g_vals.cpu().numpy(), c_vals.numpy()
        worst = max(worst, float(np.max(np.abs(gv - cv))))
        same += int((gv == cv).sum())
        total += gv.size
        for a, b, what in ((gv, cv, "values"),
                           (g_psd.cpu().numpy(), c_psd.numpy(), "psd"),
                           (g_dmax.cpu().numpy(), c_dmax.numpy(), "dmax")):
            if eng.program.combine == "sum":
                if not np.allclose(a, b, rtol=1e-6, atol=0):
                    fail(f"{name} {label}: kernel {what} off plain by "
                         f"more than rtol=1e-6")
            elif not np.array_equal(a, b):
                fail(f"{name} {label}: kernel {what} not bitwise plain")

    def fresh(dev):
        return (torch.from_numpy(values.copy()).to(dev),
                torch.zeros(P, 1, device=dev), torch.zeros(P, 1, device=dev))

    # depth 1: the hub and 64 random blocks as one slate
    rows = torch.from_numpy(blocks)
    ok = torch.ones(blocks.size, dtype=torch.bool)
    gv, gp, gd = fresh("cuda")
    kb.block_sweep(eng.program, n_total, ed, gv, rows.cuda(), ok.cuda(), gp,
                   gd, sc_gpu, **args)
    cv, cp, cd = fresh("cpu")
    kb.block_sweep_ref(eng.program, n_total, ed_cpu, cv, rows, ok, cp, cd,
                       sc_cpu, **args)
    torch.cuda.synchronize()
    compare("depth 1", gv, cv, gp, cp, gd, cd)
    # depth 8: each block as a one-slot chain of 8 Gauss-Seidel passes
    gv, gp, gd = fresh("cuda")
    cv, cp, cd = fresh("cpu")
    for b in blocks:
        r = torch.tensor([b], dtype=torch.int32)
        k = torch.ones(1, dtype=torch.bool)
        for p in range(8):
            kw = dict(args, first=p == 0, last=p == 7)
            kb.block_sweep(eng.program, n_total, ed, gv, r.cuda(), k.cuda(),
                           gp, gd, sc_gpu, **kw)
            kb.block_sweep_ref(eng.program, n_total, ed_cpu, cv, r, k, cp,
                               cd, sc_cpu, **kw)
    torch.cuda.synchronize()
    compare("depth 8", gv, cv, gp, cp, gd, cd)
    log(f"[kernel] {name}: kernel vs plain on hub block {hub} "
        f"({int(eng.plan.unified.tile_cnt[hub])} tiles) + 64 blocks, "
        f"depth 1 and 8: bitwise share {same}/{total}, "
        f"max_abs_err {worst!r}")
    return worst


def time_full_sweep(name, eng):
    """Phase 2 timings: one cold sweep of every block from one snapshot."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = eng.plan.num_blocks
    c = eng.plan.block_size
    ed, prog = eng._ed, eng.program
    n_total, n_live = eng.plan.graph.n, eng.plan.n_live
    values = torch.as_tensor(eng.values0).cuda()
    out = torch.empty_like(values)
    psd = torch.zeros(P, 1, device="cuda")
    dmax = torch.zeros(P, 1, device="cuda")
    rows = torch.arange(P, dtype=torch.int32, device="cuda")
    ok = torch.ones(P, dtype=torch.bool, device="cuda")
    sc = kb.make_scratch(ed, c)
    args = dict(block_size=c, n_live=n_live, out=out)
    ms = cuda_ms(lambda: kb.block_sweep(prog, n_total, ed, values, rows, ok,
                                        psd, dmax, sc, **args), 20)
    plain_ms = cuda_ms(lambda: kb.block_sweep_ref(
        prog, n_total, ed, values, rows, ok, psd, dmax, sc, **args), 1)
    # library yardstick (timed here only): gather + map + scatter-reduce
    valid = ed.valid.view(-1)
    src = ed.src.view(-1).long()
    block_of_tile = torch.repeat_interleave(
        torch.arange(P, device="cuda"), ed.tile_cnt.long())
    dst = (block_of_tile[:, None] * c + ed.dstl.long()).view(-1)
    w = ed.w.view(-1)
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[prog.combine]
    ident = float(prog.identity)

    def library():
        msg = prog.edge_map(values.index_select(0, src),
                            ed.aux.index_select(0, src), w)
        msg = torch.where(valid, msg, ident)
        agg = torch.full_like(values, ident).scatter_reduce_(
            0, dst, msg, reduce=reduce)
        return prog.apply(values, agg, n_total)

    library_ms = cuda_ms(library, 20)
    m = int(eng.plan.unified.edges.sum())
    n_pad = eng._values_len
    # each input read once, each output written once: the valid tile slots
    # (4 B src + 4 B dst + 4 B w + 1 B valid), values and aux in, values,
    # psd and dmax out
    nbytes = m * 13 + n_pad * 4 + n_total * 4 + n_pad * 4 + P * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] {name}: full cold sweep of {P} blocks, {m} edges, "
        f"{int(ed.tile_cnt.sum())} tiles: kernel {ms!r} ms, plain "
        f"{plain_ms!r} ms, library {library_ms!r} ms, bound {bound_ms!r} ms "
        f"({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s)")
    del dst, block_of_tile, src
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.baseline import BaselineEngine
    from repro_torch.core.engine import EngineConfig, StructureAwareEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sweep as kb

    t_start = time.perf_counter()
    card = card_line()
    # -- phase 1: device and build -----------------------------------------
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    lib_path = _build.build("block_sweep")
    build_s = time.perf_counter() - t0
    log(f"[build] block_sweep.cu -> {lib_path.name} in {build_s:.1f} s")
    log(Path(str(lib_path) + ".log").read_text().strip())

    # -- the graphs and engines of the main path -----------------------------
    t0 = time.perf_counter()
    cases = {
        "pagerank": (A.pagerank(), G.core_periphery_graph(
            N, avg_deg=AVG_DEG, seed=1, chords=1), T2_PAGERANK),
        "sssp": (A.sssp(0), G.powerlaw_graph(N, avg_deg=AVG_DEG, seed=2,
                                             weighted=True), T2),
    }
    engines = {}
    for name, (prog, g, t2) in cases.items():
        cfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=t2)
        engines[name] = (StructureAwareEngine(g, prog, cfg),
                         BaselineEngine(g, prog, cfg, frontier=False))
        sa = engines[name][0]
        log(f"[setup] {name}: n={g.n} m={g.m} P={sa.plan.num_blocks} "
            f"tiles={int(sa.plan.unified.tile_cnt.sum())} hub block tiles="
            f"{int(sa.plan.unified.tile_cnt.max())} "
            f"hot-born={sa.barrier_block}")
    log(f"[setup] graphs and engines built in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernel vs plain, and the sweep's time ----------------------
    rng = np.random.default_rng(SEED)
    errs, times = {}, {}
    for name, (sa, _) in engines.items():
        errs[name] = check_kernel(name, sa, rng)
        times[name] = time_full_sweep(name, sa)

    # -- phase 3: the main path ----------------------------------------------
    launches = 0
    results = {}
    for name, (sa, base) in engines.items():
        for label, eng, cap in (("structure-aware", sa, SA_CAP),
                                ("baseline", base, BASE_CAP)):
            kb.block_sweep.launches = 0
            torch.cuda.synchronize()
            res = eng.run(max_iterations=cap)
            torch.cuda.synchronize()
            n_launch = kb.block_sweep.launches
            launches += n_launch
            m = res.metrics
            if n_launch == 0:
                fail(f"{name} {label}: the sweep kernel never launched")
            if not np.all(np.isfinite(res.values)) \
                    or res.values.shape != (N,):
                fail(f"{name} {label}: values not finite of shape ({N},)")
            log(f"[run] {name} {label}: iterations={m.iterations} "
                f"converged={m.converged} updates={m.updates} "
                f"loads={m.block_loads} bytes={m.bytes_loaded} "
                f"wall_s={m.wall_time_s!r} host_syncs={res.host_syncs} "
                f"sweep_launches={n_launch}")
            results[(name, label)] = res
    sa_r = results[("sssp", "structure-aware")]
    base_r = results[("sssp", "baseline")]
    if not (sa_r.metrics.converged and base_r.metrics.converged):
        fail("sssp did not converge within the caps")
    if not np.array_equal(sa_r.values, base_r.values):
        fail("sssp: structure-aware and baseline fixpoints differ")
    sa_r = results[("pagerank", "structure-aware")]
    base_r = results[("pagerank", "baseline")]
    if not np.allclose(sa_r.values, base_r.values, rtol=1e-4,
                       atol=2e-3 / N):
        a, b = sa_r.values, base_r.values
        excess = np.abs(a - b) / (1e-4 * np.abs(b) + 2e-3 / N)
        i = int(np.argmax(excess))
        fail(f"pagerank: engines disagree at {int((excess > 1).sum())} "
             f"vertices; worst {i}: {a[i]!r} vs {b[i]!r}")
    log("[check] sssp fixpoints bitwise equal; pagerank within rtol=1e-4, "
        f"atol=2e-3/n; gain: pagerank "
        f"{base_r.metrics.updates / max(sa_r.metrics.updates, 1):.2f}x "
        f"fewer updates, sssp "
        f"{results[('sssp', 'baseline')].metrics.updates / max(results[('sssp', 'structure-aware')].metrics.updates, 1):.2f}x")

    # -- phase 4: the kernels line, the card, and the result -----------------
    t = times["pagerank"]
    row = dict(name="block_sweep", route="cuda",
               source="src/repro_torch/csrc/block_sweep.cu",
               replaces="src/repro/kernels/block_sweep.py:122",
               launches=launches,
               max_abs_err=max(errs.values()), ms=t["ms"],
               plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
               bound_by="bytes", library_ms=t["library_ms"])
    log(f"[done] in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
