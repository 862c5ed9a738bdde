"""Run-time contract enforcement + golden op-sequence hashing; port of
``repro.analysis.tracecheck``.

Drives the registered contracts (:mod:`repro_torch.analysis.contracts`)
on small seeded inputs, recording the aten ops a call dispatches under a
``TorchDispatchMode`` (the counterpart of the reference's jaxpr):

  * ``elementwise`` — run on CPU tensors and reject recorded ops that
    couple vertices (gathers, scatters, index ops, sorts, scans,
    reductions over axis 0, matrix products, nonzero, masked_select);
    numpy host functions, which dispatch nothing, and every torch function
    too, then get the concrete slicewise probe
    (``f(x)[i] == f(x[i:i+1])[0]``).
  * ``structure_independent`` — differential check: init values over two
    same-``n`` graphs with different edge sets must be bitwise equal
    (``lane_init`` sees no graph at all; it is probed for determinism).
  * ``decision_identical`` — seeded trials comparing the device select,
    on the checked device, against its host twin, decision for decision.
  * ``one_executable_per`` — build a tiny engine on the checked device,
    call each cached getter twice per key, assert the identical object
    comes back and the cache does not grow; run the engine and a lane
    engine twice (on a card, through kernel 1 and the lane kernels) and
    assert the second run builds nothing.
  * golden ops — hashes of the canonicalized aten op sequence of one call
    of each entry point (device select, the hot and cold sweeps, the
    chunk untraced and traced, the lane chunk, the row commit) on a tiny
    deterministic engine, committed in ``golden_ops.json`` so a silent
    change of what a superstep enqueues diffs loudly. The file is keyed by
    torch version and device type; on another version or device the
    comparison is SKIPPED (with a regeneration hint), not failed.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.contracts import Contract
from repro_torch.analysis.lint import Finding

GOLDEN_PATH = Path(__file__).with_name("golden_ops.json")

# aten ops (overload packets, trailing "_" of the in-place forms dropped)
# an elementwise (axis-0-local) function must not dispatch: structural data
# movement, sorts, scans and products couple vertices. Reductions are
# checked apart, by the dims they reduce (_REDUCTIONS).
_CROSS_VERTEX_OPS = {
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "index_select", "index_add", "index_copy", "index_fill", "index_put",
    "index_reduce", "take", "take_along_dim", "put", "sort", "argsort",
    "topk", "kthvalue", "msort", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "mm", "bmm", "matmul", "addmm", "addmv", "mv", "dot",
    "einsum", "nonzero", "masked_select", "masked_scatter", "unique",
    "_unique", "_unique2", "unique_consecutive", "unique_dim", "roll",
    "flip", "histc", "bincount", "searchsorted", "segment_reduce",
    "embedding",
}
_REDUCTIONS = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax",
    "argmin", "any", "all", "std", "var", "norm", "linalg_vector_norm",
    "logsumexp", "nansum", "median", "nanmedian", "mode", "aminmax",
    "count_nonzero",
}


class OpRecorder(TorchDispatchMode):
    """Records every aten op a block of code dispatches, with the shapes
    and dtypes of its tensor arguments and its other arguments' values."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func, args, kwargs))
        return func(*args, **kwargs)


def _packet(func) -> str:
    return func.overloadpacket.__name__.rstrip("_")


def _reduces_axis0(func, args, kwargs) -> bool:
    """Whether a reduction op reduces over dim 0 (a full reduction
    does)."""
    x = args[0] if args else None
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return False
    dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if isinstance(dims, torch.Tensor) or isinstance(dims, bool):
        dims = None  # max(x, other) / a keepdim flag: not a dim list
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return True
    if isinstance(dims, int):
        dims = [dims]
    return any(int(d) % x.dim() == 0 for d in dims)


def _cross_vertex(rec: OpRecorder) -> list[str]:
    bad = set()
    for func, args, kwargs in rec.ops:
        name = _packet(func)
        if name in _CROSS_VERTEX_OPS:
            bad.add(name)
        elif name in _REDUCTIONS and _reduces_axis0(func, args, kwargs):
            bad.add(f"{name} over axis 0")
    return sorted(bad)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- elementwise -------------------------------------------------------------
def _probe_args(contract: Contract, n: int, rng: np.random.Generator):
    """Concrete seeded inputs for a contract target: one array per
    parameter (axis 0 of length ``n``), honoring an explicit ``shapes``
    spec ("static" entries become plain Python scalars)."""
    params = list(inspect.signature(contract.target).parameters)
    shapes = contract.meta.get("shapes")
    args = []
    for i, _ in enumerate(params):
        spec = shapes[i] if shapes is not None and i < len(shapes) else (n,)
        if spec == "static":
            args.append(n)
            continue
        shape = tuple(n if d == 8 and j == 0 else d
                      for j, d in enumerate(spec))
        # positive, non-degenerate values: aux_fn divides by these, and
        # min-combine deltas need distinct magnitudes
        args.append((rng.random(shape) * 4.0 + 0.5).astype(np.float32))
    return args


def _as_torch(args):
    return [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
            for a in args]


def check_elementwise(contract: Contract) -> list[Finding]:
    rng = np.random.default_rng(7)
    n = 8
    args = _probe_args(contract, n, rng)
    where = f"{contract.module}:{contract.qualname}"
    # torch path: a function that runs on CPU tensors gets the op denylist
    rec = OpRecorder()
    try:
        with rec, warnings.catch_warnings():
            # a numpy fn may half-accept tensors before it fails
            warnings.simplefilter("ignore")
            contract.target(*_as_torch(args))
        call_args = _as_torch
    except Exception:
        call_args = list  # numpy host fn: the probe alone, on arrays
    else:
        bad = _cross_vertex(rec)
        if bad:
            return [Finding(
                "TC001", where, 0,
                f"@elementwise fn dispatches cross-vertex ops {bad} — "
                f"out[i] must depend on in[i] only")]
    # concrete slicewise probe (also exercises numpy host fns): full
    # output row i must equal the output of the length-1 slice at i
    try:
        full = _host(contract.target(*call_args(args)))
    except Exception as e:
        return [Finding("TC001", where, 0,
                        f"@elementwise fn failed on probe inputs: {e!r}")]
    if full.shape[:1] != (n,):
        return [Finding(
            "TC001", where, 0,
            f"@elementwise fn returned leading axis {full.shape[:1]} "
            f"for input axis ({n},) — must map axis 0 one-to-one")]
    for i in range(n):
        sliced = [a[i:i + 1] if isinstance(a, np.ndarray) else a
                  for a in args]
        row = _host(contract.target(*call_args(sliced)))[0]
        if not np.allclose(full[i], row, rtol=1e-6, atol=1e-6,
                           equal_nan=True):
            return [Finding(
                "TC001", where, 0,
                f"@elementwise violated at vertex {i}: full-batch row "
                f"{full[i]!r} != single-slice result {row!r}")]
    return []


# -- structure_independent ---------------------------------------------------
def _two_graphs(n: int = 64):
    from repro_torch.core import graph as G
    return (G.uniform_graph(n, deg=4, seed=0, weighted=True),
            G.uniform_graph(n, deg=6, seed=3, weighted=True))


def check_structure_independent(contract: Contract) -> list[Finding]:
    where = f"{contract.module}:{contract.qualname}"
    params = list(inspect.signature(contract.target).parameters)
    if params and params[0] == "n":
        # lane_init(n, params): cannot see structure by construction;
        # probe determinism (bitwise-equal repeat calls)
        n = 64
        lane_params = ([3, 17, 41] if "pagerank" not in contract.qualname
                       else [[3, 17], [5], [9, 11, 13]])
        a = contract.target(n, lane_params)[0]
        b = contract.target(n, lane_params)[0]
        if not np.array_equal(a, b):
            return [Finding("TC002", where, 0,
                            "@structure_independent lane_init is not "
                            "deterministic across repeat calls")]
        return []
    g1, g2 = _two_graphs()
    try:
        v1 = _host(contract.target(g1)[0])
        v2 = _host(contract.target(g2)[0])
    except Exception as e:
        return [Finding("TC002", where, 0,
                        f"@structure_independent init failed: {e!r}")]
    if not np.array_equal(v1, v2):
        diff = int((v1 != v2).sum())
        return [Finding(
            "TC002", where, 0,
            f"@structure_independent init VALUES differ on two graphs "
            f"with the same n ({diff}/{v1.size} entries) — values must "
            f"be a function of n and program parameters only")]
    return []


# -- decision_identical ------------------------------------------------------
def check_decision_identical(contract: Contract,
                             device: str = "cpu") -> list[Finding]:
    where = f"{contract.module}:{contract.qualname}"
    twin = contract.meta.get("twin")
    if twin is None or not callable(twin):
        return [Finding("TC003", where, 0,
                        "@decision_identical has no callable twin")]
    if contract.qualname != "make_device_select":
        # other decision-identical pairs (the streaming successors
        # oracle) are enforced by their tests; the contract marker
        # records the pairing
        return []
    from repro_torch.core.schedule import Scheduler
    rng = np.random.default_rng(11)
    width, cold_frac, min_psd = 4, 0.25, np.float32(1e-6)
    select = contract.target(width, cold_frac, float(min_psd), pad_id=0)
    sched = Scheduler(width=width, i2=3, cold_frac=cold_frac,
                      min_psd=float(min_psd))
    for trial in range(20):
        p = 8 if trial % 2 == 0 else 5
        shape = (p,) if trial % 3 else (p, 2)
        psd = (rng.random(shape) * rng.integers(0, 3, shape)
               ).astype(np.float32)
        is_hot = rng.random(p) < 0.5
        for it in range(4):
            hr, hok, cr, cok = select(
                it, sched.i2, torch.from_numpy(psd).to(device),
                torch.from_numpy(is_hot).to(device))
            sel = sched.select(it, psd, is_hot)
            dev_hot = _host(hr)[_host(hok)]
            dev_cold = _host(cr)[_host(cok)]
            if not (np.array_equal(dev_hot, sel.hot_ids)
                    and np.array_equal(dev_cold, sel.cold_ids)):
                return [Finding(
                    "TC003", where, 0,
                    f"device select diverged from host twin at trial "
                    f"{trial} it {it}: device hot={dev_hot.tolist()} "
                    f"cold={dev_cold.tolist()} vs host "
                    f"hot={sel.hot_ids.tolist()} "
                    f"cold={sel.cold_ids.tolist()}")]
    return []


# -- one_executable_per ------------------------------------------------------
def _tiny_engine(device: str = "cpu"):
    from repro_torch.core.algorithms import pagerank
    from repro_torch.core.engine import EngineConfig, StructureAwareEngine
    g, _ = _two_graphs(200)
    return StructureAwareEngine(g, pagerank(),
                                EngineConfig(block_size=64, width=2),
                                device=device)


def check_one_executable_per(contracts: list[Contract],
                             device: str = "cpu") -> list[Finding]:
    """One pass over every registered cached getter: identity and
    cache size on repeat calls, then two runs of the engine and of a lane
    engine, the second of which must build nothing."""
    if not contracts:
        return []
    out = []
    eng = _tiny_engine(device)
    from repro_torch.core.algorithms import k_source_sssp
    from repro_torch.kernels import _build
    from repro_torch.serve.lanes import LaneEngine
    lane = LaneEngine(eng, k_source_sssp())

    def fail(name, what, args):
        out.append(Finding(
            "TC004", name, 0,
            f"@one_executable_per {what} on a repeat call with key args "
            f"{args!r}"))

    def probe(obj, getter, *argsets, cache=None):
        name = f"{getter.__module__}:{getter.__qualname__}"
        cache = obj._fns if cache is None else cache
        for args in argsets:
            first = getter(obj, *args) if obj is not None else getter(*args)
            size = len(cache)
            again = getter(obj, *args) if obj is not None else getter(*args)
            if again is not first:
                fail(name, "returned a fresh object", args)
            elif len(cache) != size:
                fail(name, "grew its cache", args)

    for c in contracts:
        fn, qual = c.target, c.qualname
        if qual == "StructureAwareEngine._get_chunk":
            probe(eng, fn, (2,), (1,), (2, 16))
        elif qual == "StructureAwareEngine._sweeps":
            probe(eng, fn, (2,), (1,))
        elif qual == "StructureAwareEngine._row_commit":
            probe(eng, fn, ("edge_rows",), ("aux",), ("coupling",))
        elif qual in ("LaneEngine._get_chunk", "LaneEngine._sweeps"):
            probe(lane, fn, (2,), (1,))
        elif qual == "make_lane_scratch":
            # the scratch of one tile geometry and lane count comes back
            # as it is for the same tiles
            scratch = fn(eng.edge_state, eng.plan.block_size, 2)
            again = fn(eng.edge_state, eng.plan.block_size, 2,
                       reuse=scratch)
            if again is not scratch:
                fail(f"{c.module}:{qual}", "returned a fresh scratch",
                     ("same tiles", 2))
        elif c.module.endswith("._build") and device == "cuda":
            # the loaded library of one source (built once per source
            # hash); there is no nvcc off the card
            probe(None, fn, ("block_sweep",), cache=_build._LOADED)
    # whole runs: the second run of each engine builds nothing new
    lane_kw = dict(ed=eng.edge_state, coupling=eng._coupling,
                   values0=lane.program.lane_init(eng.plan.graph.n,
                                                  [0, 1])[0],
                   vconst=None, lane_active=np.ones(2, bool),
                   edge_counts=eng.edge_counts)
    for label, obj, go in (
            ("StructureAwareEngine.run", eng, lambda: eng.run()),
            ("StructureAwareEngine.run(trace=True)", eng,
             lambda: eng.run(trace=True)),
            ("LaneEngine.run", lane, lambda: lane.run(**lane_kw))):
        go()
        fns, scratch = dict(obj._fns), getattr(obj, "_scratch", None)
        go()
        rebuilt = [k for k in obj._fns
                   if k not in fns or obj._fns[k] is not fns[k]]
        if rebuilt:
            out.append(Finding(
                "TC004", label, 0,
                f"a repeat run built new cached objects "
                f"{sorted(map(str, rebuilt))}"))
        if scratch is not None and obj._scratch is not scratch:
            out.append(Finding("TC004", label, 0,
                               "a repeat run built a new lane scratch"))
    return out


# -- golden ops --------------------------------------------------------------
def _canon(x) -> str:
    """A stable text for one op argument: tensors by dtype and shape,
    everything else by value."""
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype).replace('torch.', '')}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_canon(v) for v in x) + ")"
    if isinstance(x, torch.device):
        return "dev"
    return repr(x)


def _canonical_hash(rec: OpRecorder) -> str:
    text = "\n".join(
        f"{func}(" + ",".join(_canon(a) for a in args)
        + "".join(f",{k}={_canon(v)}" for k, v in sorted(kwargs.items())
                  if k != "device") + ")"
        for func, args, kwargs in rec.ops)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _record(fn) -> str:
    rec = OpRecorder()
    with rec:
        fn()
    return _canonical_hash(rec)


def golden_entries(device: str = "cpu") -> dict[str, str]:
    """Record one call of each entry point on a tiny deterministic engine
    on ``device`` and hash the canonicalized op sequences."""
    from repro_torch.core import state as state_lib
    from repro_torch.core.algorithms import k_source_sssp
    from repro_torch.core.engine import (TIMELINE_FLOAT_COLS,
                                         TIMELINE_INT_COLS)
    from repro_torch.core.schedule import make_device_select
    from repro_torch.kernels import block_sweep as kb
    from repro_torch.serve.lanes import LaneEngine
    eng = _tiny_engine(device)
    lane = LaneEngine(eng, k_source_sssp())
    p, dev = eng.plan, eng.device
    nb, w = p.num_blocks, 2
    entries: dict[str, str] = {}
    rng = np.random.default_rng(5)

    select = make_device_select(4, 0.25, 1e-6, pad_id=0)
    psd8 = torch.from_numpy((rng.random((8, 2)) * rng.integers(
        0, 3, (8, 2))).astype(np.float32)).to(dev)
    hot8 = torch.from_numpy(rng.random(8) < 0.5).to(dev)
    entries["device_select_w4"] = _record(
        lambda: select(0, 4, psd8, hot8))

    def state():
        values = torch.from_numpy(eng.values0.copy()).to(dev)
        psd = torch.from_numpy(state_lib.init_psd(nb, 1)).to(dev)
        return values, psd, torch.zeros_like(psd)

    rows = torch.arange(w, dtype=torch.int32, device=dev)
    ok = torch.ones(w, dtype=torch.bool, device=dev)
    hot, cold = eng._sweeps(w)
    entries["tiled_hot_sweep_w2"] = _record(
        lambda: hot(eng._ed, *state(), rows, ok))
    entries["tiled_cold_sweep_w2"] = _record(
        lambda: cold(eng._ed, *state(), rows, ok))

    def counters(width):
        return (torch.zeros((nb, 1), dtype=torch.int32, device=dev),
                torch.zeros(nb, dtype=torch.int32, device=dev),
                torch.zeros(width, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    is_hot = torch.from_numpy(np.arange(nb) < 1).to(dev)

    def chunk_call(cap):
        values, psd, dmax = state()
        calm, counts, hslots, sbacc, it_dev = counters(w)
        hist = ()
        if cap is not None:
            acct = torch.from_numpy(eng._acct_table()).to(dev)
            hist = (acct, torch.zeros((cap, len(TIMELINE_INT_COLS)),
                                      dtype=torch.int64, device=dev),
                    torch.zeros((cap, len(TIMELINE_FLOAT_COLS)),
                                dtype=torch.float32, device=dev))
        return lambda: eng._get_chunk(w, cap)(
            eng._ed, eng._coupling_dev, values, psd, dmax, calm, counts,
            hslots, sbacc, it_dev, is_hot, 0, 4, 4, *hist)

    entries["chunk_w2"] = _record(chunk_call(None))
    entries["chunk_traced_w2_c16"] = _record(chunk_call(16))

    nl = 2
    vals, _ = lane.program.lane_init(p.graph.n, list(range(nl)))
    lvals = torch.from_numpy(lane._pad_lane_values(
        vals[p.order])).to(dev)
    lpsd = torch.from_numpy(state_lib.init_lane_psd(
        nb, np.ones(nl, bool), 1)).to(dev)
    calm, counts, hslots, sbacc, it_dev = counters(w)
    scratch = kb.make_lane_scratch(eng._ed, eng.plan.block_size, nl)
    entries["lane_chunk_w2_l2"] = _record(
        lambda: lane._get_chunk(w)(
            eng._ed, eng._coupling_dev, torch.zeros_like(lvals), lvals,
            lpsd, torch.zeros_like(lpsd), calm, counts, hslots, sbacc,
            torch.zeros(nl, dtype=torch.bool, device=dev),
            torch.zeros(nl, dtype=torch.int64, device=dev), it_dev, is_hot,
            0, 4, 4, scratch))

    # the row commit of the streaming path: 16 tile rows into copies
    t = eng._ed.src.shape[1]
    idx = np.arange(16, dtype=np.int64) % eng._ed.src.shape[0]
    idx = np.unique(idx)
    targets = tuple(x.clone() for x in (eng._ed.src, eng._ed.dstl,
                                        eng._ed.w, eng._ed.valid,
                                        eng._ed.cov))
    payloads = [np.zeros((idx.size, t), np.int32),
                np.zeros((idx.size, t), np.int32),
                np.zeros((idx.size, t), np.float32),
                np.zeros((idx.size, t), bool),
                np.zeros((idx.size, eng._ed.cov.shape[1]), bool)]
    entries["row_commit_c16"] = _record(
        lambda: eng._row_commit("edge_rows")(targets, idx, payloads))
    return entries


def write_golden(path: Path = GOLDEN_PATH, device: str = "cpu") -> dict:
    payload = {"torch_version": torch.__version__,
               "device": torch.device(device).type,
               "entries": golden_entries(device)}
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return payload


def check_golden(path: Path = GOLDEN_PATH,
                 device: str = "cpu") -> tuple[list[Finding], str]:
    """Returns (findings, status). Status is 'ok', 'skipped', or
    'missing'."""
    if not path.exists():
        return ([Finding(
            "TC005", str(path), 0,
            "golden_ops.json missing — run `python -m repro_torch.analysis "
            "--update-golden` and commit the result")], "missing")
    stored = json.loads(path.read_text())
    if (stored.get("torch_version") != torch.__version__
            or stored.get("device") != torch.device(device).type):
        return ([], "skipped")
    current = golden_entries(device)
    out = []
    for name, want in sorted(stored.get("entries", {}).items()):
        got = current.get(name)
        if got is None:
            out.append(Finding(
                "TC005", str(path), 0,
                f"golden entry '{name}' no longer recorded — if the entry "
                f"point moved intentionally, regenerate with "
                f"--update-golden"))
        elif got != want:
            out.append(Finding(
                "TC005", str(path), 0,
                f"op sequence of '{name}' changed ({want} -> {got}) — if "
                f"intentional, regenerate with `python -m "
                f"repro_torch.analysis --update-golden` and commit"))
    for name in sorted(set(current) - set(stored.get("entries", {}))):
        out.append(Finding(
            "TC005", str(path), 0,
            f"new golden entry '{name}' not in committed file — "
            f"regenerate with --update-golden"))
    return (out, "ok")


# -- all checks --------------------------------------------------------------
def check_contracts(contracts: list[Contract],
                    device: str = "cpu") -> list[Finding]:
    findings: list[Finding] = []
    oep = []
    for c in contracts:
        if c.kind == "elementwise":
            findings += check_elementwise(c)
        elif c.kind == "structure_independent":
            findings += check_structure_independent(c)
        elif c.kind == "decision_identical":
            findings += check_decision_identical(c, device)
        elif c.kind == "one_executable_per":
            oep.append(c)
        # @deterministic is enforced by the lint layer (RA004)
    findings += check_one_executable_per(oep, device)
    return findings
