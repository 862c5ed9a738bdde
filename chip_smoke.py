#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit, torch/CUDA versions, and the
   build of the block-sweep kernel from csrc/ (seconds, ptxas report).
2. Kernels vs plain version: the kernel on the card and ``block_sweep_ref``
   on CPU copies of the same inputs, for the hub block plus 64 seeded random
   blocks, as one slate at depth 1 and as one-slot chains at depth 8.
   Min/max programs must agree bitwise; the sum program bitwise or within
   rtol=1e-6 (the bitwise share is printed).
   a. Kernel 1 (unmasked) on the full-size graphs of phase 3.
   b. Kernel 1m (masked) on the same graphs with S = 8 sub-blocks and
      seeded random sub_act patterns.
   c. Kernels 1 and 1m on a mutated layout: a StreamingEngine's tiles after
      one synthetic_stream batch of 10,000 edits with deletes. The engine
      runs CC (symmetric), so every delete rebuilds its blocks' runs in
      bucket order; the batch must rebuild at least one block. The
      PageRank, SSSP and CC arithmetic all run over these tiles. It runs
      on powerlaw_graph(n = 2^18): the engine bootstraps with a cold run,
      and a CC run at n = 2^21 would not fit the time limit beside phases
      3-4.
   Then the times of one full cold sweep of every block (kernel, plain
   version on the card, and a library yardstick that the port never calls)
   beside the least time the card could take for it: kernel 1, kernel 1m
   with every sub-block live and with about 1/S live, and kernel 1 on the
   mutated layout of 2c against the same engine's build-time layout
   (timed before the batch).
3. The main path at n = 2^21 vertices, avg_deg 16 (~33.5M edges):
   PageRank on core_periphery_graph(seed=1, chords=1) and SSSP on a
   weighted powerlaw_graph, each through StructureAwareEngine.run() and
   BaselineEngine.run() with block_size=512 (P=4096), width=128, t2=1e-9
   (PageRank: scaled to 1/n, see T2_PAGERANK).
   SSSP fixpoints must be bitwise equal, PageRank must agree at rtol=1e-4,
   atol=2e-3/n, and the sweep kernel must have launched on the main path.
4. Streaming with hierarchical partitions: a StreamingEngine (S = 8,
   StreamConfig() defaults) over PageRank on the phase-3 PageRank graph,
   bootstrapped by a cold run, then three synthetic_stream batches (10
   edits, 200 edits, 200 edits with deletes). After each batch the warm
   values must agree with BaselineEngine on the mutated graph (rtol=1e-4,
   atol=2e-3/n). Then SSSP with deletes (three batches of 200 edits) on a
   weighted powerlaw_graph, bitwise equal to the baseline after each
   batch; it runs at n = 2^19 (SSSP_STREAM_N): its cold bootstrap at
   n = 2^21 alone takes about as long as phase 3's SSSP run. Each batch
   prints its iterations, dirty fractions, upload fraction, bytes and
   latency, and the launches of kernels 1 and 1m; the masked kernel must
   have launched.
5. One JSON line of kernel rows, the card line, and the final ok line.

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
SUB = 8  # sub-blocks per block on the masked paths
MUTATE_N = 1 << 18  # the mutated-layout check's graph (phase 2c)
MUTATE_EDITS = 10000
SSSP_STREAM_N = 1 << 19  # phase 4's SSSP stream
STREAM_CAP = 8000  # superstep cap of one streaming run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SEED = 0
DEV = "cuda"


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


def sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc, *, floor,
          plain=False, **kw):
    """One pass of kernel 1 (floor None) or 1m, or of their plain version."""
    from repro_torch.kernels import block_sweep as kb
    if plain:
        kb.block_sweep_ref(program, n_total, ed, values, rows, ok, psd, dmax,
                           sc, floor=floor, **kw)
    elif floor is None:
        kb.block_sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc,
                       **kw)
    else:
        kb.masked_block_sweep(program, n_total, ed, values, rows, ok, psd,
                              dmax, sc, floor=floor, **kw)


def check_against_plain(label, program, ed, c, n_live, n_total, values,
                        rng, floor=None, psd0=None):
    """Phase 2: the kernel on the card against the plain version on CPU
    copies of the same inputs, for the hub block plus 64 seeded random
    blocks, as one slate at depth 1 and as one-slot chains at depth 8.
    Returns the largest absolute difference of the new values."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    tile_cnt = ed.tile_cnt.cpu().numpy()
    P = tile_cnt.size
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    if psd0 is None:
        psd0 = np.zeros((P, nsub), np.float32)
    hub = int(np.argmax(tile_cnt))
    others = rng.choice(np.setdiff1d(np.arange(P), [hub]), size=64,
                        replace=False)
    blocks = np.concatenate([[hub], others]).astype(np.int32)
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    sc = {DEV: kb.make_scratch(ed, c), "cpu": kb.make_scratch(ed_cpu, c)}
    eds = {DEV: ed, "cpu": ed_cpu}
    args = dict(block_size=c, n_live=n_live, floor=floor)
    worst = 0.0
    same = total = 0

    def compare(what, g, h):
        nonlocal worst, same, total
        for a, b, part in zip(g, h, ("values", "psd", "dmax")):
            a = a.cpu().numpy()
            b = b.numpy()
            if part == "values":
                worst = max(worst, float(np.max(np.abs(a - b))))
                same += int((a == b).sum())
                total += a.size
            if program.combine == "sum":
                if not np.allclose(a, b, rtol=1e-6, atol=0):
                    fail(f"{label} {what}: kernel {part} off plain by more "
                         "than rtol=1e-6")
            elif not np.array_equal(a, b):
                fail(f"{label} {what}: kernel {part} not bitwise plain")

    def fresh(dev):
        return (torch.from_numpy(values.copy()).to(dev),
                torch.from_numpy(psd0.copy()).to(dev),
                torch.zeros(P, nsub, device=dev))

    out = {}
    for dev in (DEV, "cpu"):  # depth 1: one slate
        v, p, d = fresh(dev)
        sweep(program, n_total, eds[dev], v,
              torch.from_numpy(blocks).to(dev),
              torch.ones(blocks.size, dtype=torch.bool, device=dev), p, d,
              sc[dev], plain=dev == "cpu", **args)
        out[dev] = (v, p, d)
    torch.cuda.synchronize()
    compare("depth 1", out[DEV], out["cpu"])
    for dev in (DEV, "cpu"):  # depth 8: one-slot chains
        v, p, d = fresh(dev)
        k = torch.ones(1, dtype=torch.bool, device=dev)
        for b in blocks:
            r = torch.tensor([b], dtype=torch.int32, device=dev)
            for i in range(8):
                sweep(program, n_total, eds[dev], v, r, k, p, d, sc[dev],
                      plain=dev == "cpu", first=i == 0, last=i == 7, **args)
        out[dev] = (v, p, d)
    torch.cuda.synchronize()
    compare("depth 8", out[DEV], out["cpu"])
    log(f"[kernel] {label}: kernel vs plain on hub block {hub} "
        f"({int(tile_cnt[hub])} tiles) + 64 blocks, depth 1 and 8: bitwise "
        f"share {same}/{total}, max_abs_err {worst!r}")
    return worst


def time_full_sweep(label, program, ed, c, n_live, n_total, values0,
                    floor=None, psd0=None):
    """Phase 2 timings: one cold sweep of every block from one snapshot,
    by the kernel, the plain version on the card and a library yardstick,
    beside the least time the card could take for the same work."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = ed.tile_cnt.numel()
    masked = floor is not None
    nsub = int(ed.cov.shape[1]) if masked else 1
    v0 = torch.as_tensor(values0).to(DEV)
    values = v0.clone()
    out = torch.empty_like(values)
    p0 = torch.as_tensor(psd0 if masked else np.zeros((P, 1), np.float32))
    p0 = p0.to(DEV)
    psd = p0.clone()
    dmax = torch.zeros(P, nsub, device=DEV)
    rows = torch.arange(P, dtype=torch.int32, device=DEV)
    ok = torch.ones(P, dtype=torch.bool, device=DEV)
    sc = kb.make_scratch(ed, c)
    args = dict(block_size=c, n_live=n_live, floor=floor)
    if masked:
        # the masked sweep is in place and rewrites its psd: each run
        # starts from the same values and mask (two copies of 16 MB and
        # 128 KB, a few microseconds)
        def run(plain=False):
            values.copy_(v0)
            psd.copy_(p0)
            sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc,
                  plain=plain, **args)
    else:
        def run(plain=False):
            sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc,
                  plain=plain, out=out, **args)
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(lambda: run(plain=True), 1)
    # the work this mask needs: tiles that feed an active sub-range, and
    # the vertices of the active sub-ranges
    valid = ed.valid
    if masked:
        act = (p0 >= floor)  # (P, S)
        block_of_tile = torch.repeat_interleave(
            torch.arange(P, device=DEV), ed.tile_cnt.long())
        keep_tile = (ed.cov & act[block_of_tile]).any(dim=1)
        valid = valid & keep_tile[:, None]
        sub = c // nsub
        vert_act = act.repeat_interleave(sub, dim=1).reshape(-1)
    else:
        vert_act = torch.ones(P * c, dtype=torch.bool, device=DEV)
    m = int(valid.sum())
    n_pad = values.numel()
    n_out = int(vert_act.sum())
    # each input read once, each output written once: the needed tile slots
    # (4 B src + 4 B w + 1 B valid + 4 B link), values and aux in, the
    # active values out, psd and dmax out
    nbytes = m * 13 + n_pad * 4 + n_total * 4 + n_out * 4 + P * nsub * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # library yardstick (timed here only): gather + map + scatter-reduce
    # over the edges the mask needs
    flat = valid.view(-1)
    idx = torch.nonzero(flat).view(-1)
    src = ed.src.view(-1)[idx].long()
    block_of_tile = torch.repeat_interleave(
        torch.arange(P, device=DEV), ed.tile_cnt.long())
    dst = (block_of_tile[:, None] * c + ed.dstl.long()).view(-1)[idx]
    w = ed.w.view(-1)[idx]
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[program.combine]
    ident = float(program.identity)

    def library():
        msg = program.edge_map(values.index_select(0, src),
                               ed.aux.index_select(0, src), w)
        agg = torch.full_like(values, ident).scatter_reduce_(
            0, dst, msg, reduce=reduce)
        return program.apply(values, agg, n_total)

    library_ms = cuda_ms(library, 20)
    log(f"[kernel] {label}: full cold sweep of {P} blocks, {m} needed "
        f"edges, {int(ed.tile_cnt.sum())} tiles, {n_out} active vertex "
        f"slots: kernel {ms!r} ms, plain {plain_ms!r} ms, library "
        f"{library_ms!r} ms, bound {bound_ms!r} ms ({nbytes} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


def masked_tiles(eng, nsub):
    """The engine's build-time tiles with S = ``nsub`` sub-block coverage
    (the masked kernel's view of an S = 1 engine's graph)."""
    import torch
    from repro_torch.core.engine import tile_coverage
    u = eng.plan.unified
    cov = tile_coverage(u.dst_local, u.valid, nsub, eng.plan.block_size)
    return eng.edge_state._replace(cov=torch.as_tensor(cov).to(DEV))


def sub_mask_psd(rng, P, nsub, floor, live_frac):
    """A (P, S) psd whose entries clear the floor with ``live_frac``."""
    import numpy as np
    return np.where(rng.random((P, nsub)) < live_frac, np.float32(1.0),
                    np.float32(floor) / 2).astype(np.float32)


def launch_counts():
    from repro_torch.kernels import block_sweep as kb
    return kb.block_sweep.launches, kb.masked_block_sweep.launches


def zero_counts():
    from repro_torch.kernels import block_sweep as kb
    kb.block_sweep.launches = 0
    kb.masked_block_sweep.launches = 0


def agree(name, got, want, exact):
    import numpy as np
    if exact:
        if not np.array_equal(got, want):
            fail(f"{name}: values not bitwise equal to the baseline's")
        return
    if not np.allclose(got, want, rtol=1e-4, atol=2e-3 / got.size):
        excess = np.abs(got - want) / (1e-4 * np.abs(want)
                                       + 2e-3 / got.size)
        i = int(np.argmax(excess))
        fail(f"{name}: disagree with the baseline at "
             f"{int((excess > 1).sum())} vertices; worst {i}: {got[i]!r} "
             f"vs {want[i]!r}")


def stream_phase(label, g, program, cfg, batches, exact):
    """Phase 4 for one program: bootstrap a StreamingEngine, ingest the
    batches, and hold the warm values against the baseline on the mutated
    graph after each. Returns the masked launches of the streaming runs."""
    import numpy as np
    import torch
    from repro_torch.core.baseline import BaselineEngine
    from repro_torch.stream import StreamingEngine
    masked = 0
    t0 = time.perf_counter()
    zero_counts()
    torch.cuda.synchronize()
    se = StreamingEngine(g, program, cfg, device=DEV)
    torch.cuda.synchronize()
    n1, n1m = launch_counts()
    masked += n1m
    init = se.initial_result.metrics
    log(f"[stream] {label}: P={se.engine.plan.num_blocks} S="
        f"{cfg.subblocks} built and bootstrapped in "
        f"{time.perf_counter() - t0:.1f} s: iterations={init.iterations} "
        f"converged={init.converged} wall_s={init.wall_time_s!r} launches "
        f"kernel1={n1} kernel1m={n1m}")
    if not init.converged:
        fail(f"{label}: the bootstrap run did not converge")
    for i, b in enumerate(batches):
        zero_counts()
        torch.cuda.synchronize()
        r = se.ingest(b)
        torch.cuda.synchronize()
        n1, n1m = launch_counts()
        masked += n1m
        log(f"[stream] {label} batch {i}: +{r.inserts} -{r.deletes} "
            f"iterations={r.iterations} converged={r.converged} "
            f"dirty_frac={r.dirty_frac!r} "
            f"subblock_dirty_frac={r.subblock_dirty_frac!r} "
            f"upload_frac={r.upload_frac!r} bytes_uploaded="
            f"{r.bytes_uploaded} bytes_full={r.bytes_full} latency_s="
            f"{r.latency_s!r} (ingest {r.ingest_time_s!r}, reconverge "
            f"{r.reconverge_time_s!r}) appended={r.appended_blocks} "
            f"killed={r.killed_blocks} rebuilt={r.rebuilt_blocks} "
            f"plan_rebuild={r.plan_rebuild} launches kernel1={n1} "
            f"kernel1m={n1m}")
        base = BaselineEngine(se.current_graph(), program, cfg,
                              frontier=False, device=DEV).run(
                                  max_iterations=BASE_CAP)
        if not base.metrics.converged:
            fail(f"{label} batch {i}: the baseline did not converge")
        if not np.all(np.isfinite(se.values)) or se.values.shape != (g.n,):
            fail(f"{label} batch {i}: values not finite of shape ({g.n},)")
        agree(f"{label} batch {i}", se.values, base.values, exact)
    log(f"[check] {label}: warm values agree with the baseline after every "
        f"batch ({'bitwise' if exact else 'rtol=1e-4, atol=2e-3/n'})")
    return masked, se


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
    from repro_torch.stream import StreamingEngine, synthetic_stream

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
        engines[name] = (StructureAwareEngine(g, prog, cfg, device=DEV),
                         BaselineEngine(g, prog, cfg, frontier=False,
                                        device=DEV))
        sa = engines[name][0]
        log(f"[setup] {name}: n={g.n} m={g.m} P={sa.plan.num_blocks} "
            f"tiles={int(sa.plan.unified.tile_cnt.sum())} hub block tiles="
            f"{int(sa.plan.unified.tile_cnt.max())} "
            f"hot-born={sa.barrier_block}")
    log(f"[setup] graphs and engines built in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernels vs plain, and the sweeps' times --------------------
    rng = np.random.default_rng(SEED)
    errs = {"1": [], "1m": []}
    times = {}
    for name, (sa, _) in engines.items():
        c, n_live, n_total = BLOCK, sa.plan.n_live, sa.plan.graph.n
        floor = np.float32(sa._psd_floor())
        ed8 = masked_tiles(sa, SUB)
        values = mid_run_state(name, sa._values_len, rng)
        errs["1"].append(check_against_plain(
            f"{name} kernel 1", sa.program, sa.edge_state, c, n_live,
            n_total, values, rng))
        errs["1m"].append(check_against_plain(
            f"{name} kernel 1m S={SUB}", sa.program, ed8, c, n_live, n_total,
            values, rng, floor=floor,
            psd0=sub_mask_psd(rng, sa.plan.num_blocks, SUB, floor, 0.5)))
        times[name] = time_full_sweep(f"{name} kernel 1", sa.program,
                                      sa.edge_state, c, n_live, n_total,
                                      sa.values0)
        for frac in (1.0, 1.0 / SUB):
            times[(name, frac)] = time_full_sweep(
                f"{name} kernel 1m S={SUB}, live fraction {frac!r}",
                sa.program, ed8, c, n_live, n_total, sa.values0, floor=floor,
                psd0=sub_mask_psd(rng, sa.plan.num_blocks, SUB, floor, frac))
        del ed8
    # 2c: a mutated layout (appends, kill holes and rebuilt runs)
    t0 = time.perf_counter()
    gm = G.powerlaw_graph(MUTATE_N, avg_deg=AVG_DEG, seed=3)
    mcfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
                        max_iterations=SA_CAP)
    se = StreamingEngine(gm, A.cc(), mcfg, device=DEV)
    # kernel 1 on the build-time layout, before the batch mutates it
    times["unmutated"] = time_full_sweep(
        "cc kernel 1, build-time layout", A.cc(), se.engine.edge_state,
        BLOCK, se.engine.plan.n_live, se.engine.plan.graph.n,
        se.engine.values0)
    # no hotspot burst: one vertex gaining thousands of edges would
    # outgrow its block's slack and rebuild the whole plan instead
    r = se.ingest(synthetic_stream(gm, 1, MUTATE_EDITS, seed=SEED,
                                   hotspot_prob=0.0)[0])
    log(f"[kernel] mutated layout: CC stream on powerlaw_graph(n={gm.n}), "
        f"one batch of {MUTATE_EDITS} edits: +{r.inserts} -{r.deletes}, "
        f"{r.appended_blocks} appended, {r.rebuilt_blocks} rebuilt, "
        f"plan_rebuild={r.plan_rebuild}, in "
        f"{time.perf_counter() - t0:.1f} s")
    if r.rebuilt_blocks < 1 or r.plan_rebuild or not r.converged:
        fail("mutated layout: the batch must rebuild a block in place")
    em = se.engine
    ed = em.edge_state
    # the PageRank arithmetic needs a positive aux; the same tiles serve
    # all three combines
    ed = ed._replace(aux=torch.as_tensor(
        rng.uniform(1.0, 9.0, ed.aux.numel()).astype(np.float32)).to(DEV))
    n_live, n_total = em.plan.n_live, em.plan.graph.n
    floor = np.float32(em._psd_floor())
    for name, prog in (("pagerank", A.pagerank()), ("sssp", A.sssp(0)),
                       ("cc", A.cc())):
        values = mid_run_state(name, em._values_len, rng)
        errs["1"].append(check_against_plain(
            f"mutated {name} kernel 1", prog, ed, BLOCK, n_live, n_total,
            values, rng))
        errs["1m"].append(check_against_plain(
            f"mutated {name} kernel 1m S={SUB}", prog, ed, BLOCK, n_live,
            n_total, values, rng, floor=floor,
            psd0=sub_mask_psd(rng, em.plan.num_blocks, SUB, floor, 0.5)))
    times["mutated"] = time_full_sweep(
        "cc kernel 1, mutated layout (same engine, after the batch)",
        A.cc(), em.edge_state, BLOCK, n_live, n_total, em.values0)
    del se, em, ed

    # -- phase 3: the main path ----------------------------------------------
    launches = 0
    results = {}
    for name, (sa, base) in engines.items():
        for label, eng, cap in (("structure-aware", sa, SA_CAP),
                                ("baseline", base, BASE_CAP)):
            zero_counts()
            torch.cuda.synchronize()
            res = eng.run(max_iterations=cap)
            torch.cuda.synchronize()
            n_launch = launch_counts()[0]
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
    agree("sssp", sa_r.values, base_r.values, exact=True)
    sa_r = results[("pagerank", "structure-aware")]
    base_r = results[("pagerank", "baseline")]
    agree("pagerank", sa_r.values, base_r.values, exact=False)
    log("[check] sssp fixpoints bitwise equal; pagerank within rtol=1e-4, "
        f"atol=2e-3/n; gain: pagerank "
        f"{base_r.metrics.updates / max(sa_r.metrics.updates, 1):.2f}x "
        f"fewer updates, sssp "
        f"{results[('sssp', 'baseline')].metrics.updates / max(results[('sssp', 'structure-aware')].metrics.updates, 1):.2f}x")
    del engines, results

    # -- phase 4: streaming with hierarchical partitions ---------------------
    g = cases["pagerank"][1]
    scfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2_PAGERANK,
                        subblocks=SUB, max_iterations=STREAM_CAP)
    batches = [synthetic_stream(g, 1, 10, seed=11, delete_frac=0.0)[0],
               synthetic_stream(g, 1, 200, seed=12, delete_frac=0.0)[0],
               synthetic_stream(g, 1, 200, seed=13, delete_frac=0.2)[0]]
    masked_launches, se = stream_phase("pagerank stream", g, A.pagerank(),
                                       scfg, batches, exact=False)
    del se, cases
    gs = G.powerlaw_graph(SSSP_STREAM_N, avg_deg=AVG_DEG, seed=2,
                          weighted=True)
    scfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
                        max_iterations=SA_CAP)
    n1m, se = stream_phase(
        "sssp stream", gs, A.sssp(0), scfg,
        synthetic_stream(gs, 3, 200, seed=14, delete_frac=0.2,
                         weighted=True), exact=True)
    masked_launches += n1m
    if masked_launches == 0:
        fail("the masked kernel never launched on the streaming path")
    del se

    # -- phase 5: the kernels line, the card, and the result -----------------
    t, tm = times["pagerank"], times[("pagerank", 1.0)]
    rows = [
        dict(name="block_sweep", route="cuda",
             source="src/repro_torch/csrc/block_sweep.cu",
             replaces="src/repro/kernels/block_sweep.py:122",
             launches=launches, max_abs_err=max(errs["1"]), ms=t["ms"],
             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             bound_by="bytes", library_ms=t["library_ms"]),
        dict(name="masked_block_sweep", route="cuda",
             source="src/repro_torch/csrc/block_sweep.cu",
             replaces="src/repro/kernels/block_sweep.py:131",
             launches=masked_launches, max_abs_err=max(errs["1m"]),
             ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
             bound_by="bytes", library_ms=tm["library_ms"]),
    ]
    log(f"[done] in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
