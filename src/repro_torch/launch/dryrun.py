"""Multi-pod dry run: run every (arch x shape x mesh) cell's program on
fake devices and count its work; port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 512 placeholder CPU
devices and reads XLA's cost and memory analyses. The port has no
compiler to ask, so it runs the program itself, once, on tensors that
hold no data:

* a ``fake`` process group (``FakeStore``) of 256 or 512 ranks, this
  process rank 0, gives the production meshes (``launch/mesh.py``); its
  collectives move nothing;
* under a ``FakeTensorMode`` every parameter, moment, batch leaf and
  cache entry is a DTensor whose local shard is a fake tensor: shapes,
  dtypes and devices, no storage. They are made from the shapes of a
  model built on the ``meta`` device (``Model(cfg, "meta")``), which
  allocates nothing; ``resolve_device`` is not involved and still refuses
  a real ``"cuda"`` without a card. Where a card is present the shards
  are fake CUDA tensors, so the counted program is the card's route
  (``aten::mm.dtype`` for the down projections). A build of torch without
  CUDA cannot run a fake CUDA tensor through Python indexing or the
  autograd engine (both take a CUDA device guard, which such a build
  lacks), so without a card the shards are fake CPU tensors, the counted
  program the CPU's route (the down projection in f32, the same products
  and the same collectives), and each result says which
  (``"device"``).

Each cell runs once: the train step (``train.step.make_train_step``, the
state laid out by ``state_specs``, ``_tok_micro`` microbatches), or
``prefill``, or ``decode_step``, with the reference's layouts. What is
counted, per cell:

* ``flops``: the FLOPs of the local ops that run on the rank, by
  ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: matmuls, batched matmuls, convolutions, attention; not
  elementwise ops; ``mm.dtype`` under ``aten.mm``). A per-device count
  like XLA's, work a rank repeats that another also does (a replicated
  product) included. Counted on the local ops, not on the DTensor ops
  (whose shapes are global), because the attention, the SSM scan and the
  MoE's dispatch run on each rank's shard as plain tensors;
* ``bytes_accessed``: the input and output bytes of every aten op that
  runs on a rank's local shards (views, which move nothing, and the
  collectives left out), summed. XLA counts after fusion, so an
  elementwise chain it fuses reads its input once; here each op of it
  reads and writes its operands: more bytes than XLA's count;
* ``collectives``: the result bytes of each functional collective that
  DTensor issues on the rank (``all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single``), under the
  reference's ``COLLECTIVES`` names; ``collective-permute`` has no eager
  counterpart and reads 0;
* ``argument_bytes``, ``temp_bytes``, ``peak_bytes``: the live bytes of
  the rank's local storages, tracked per storage from its first tensor to
  its last: the arguments' before the run, and the peak over the run
  (``temp_bytes`` = peak - arguments).

The reference's ``_linear_costs`` (compile L = 0 and L = 1 and
extrapolate) has no counterpart: it exists because XLA's cost analysis
counts a ``while`` body once. Eager execution runs every layer, so a
full-depth run counts every layer.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3p2_1b \\
        --shape decode_32k --mesh single --graph

Results go to ``results/dryrun_torch.json`` (``--out``), merged with what
the file holds; ``--force`` reruns cells that are there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                         unset_fake_temporarily)
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import (batch_axes, make_mesh,
                                     production_shape)
from repro_torch.models import model as model_lib
from repro_torch.models.config import SHAPES
from repro_torch.models.layers import wrap_local
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import make_train_step

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# The shapes a run takes unless --shape names others: a prefill_32k or
# train_4k cell runs its 32k-token attention chunk by chunk through the
# fake mode's Python dispatch (llama3p2_1b's prefill_32k on pod16x16 took
# 603 s on a CPU host), so they run when asked for
DEFAULT_SHAPES = ("decode_32k", "long_500k")


# -- the fake world ----------------------------------------------------------
def fake_world(world: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``world`` ranks (the
    default group: the meshes are built over it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_device() -> str:
    """The device of the fake shards: the card's where there is one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class _Counter(FakeTensorMode):
    """The fake mode, counting each op it runs on local fake tensors: the
    bytes it reads and writes, the collectives, and the live storage."""

    def __init__(self):
        # DTensor makes small real index tensors of its own (strided shards)
        super().__init__(allow_non_fake_inputs=True)
        self.bytes = 0
        self.flops = 0
        self.coll = {op: {"count": 0, "bytes": 0} for op in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._refs: dict = {}

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until its last tensor goes."""
        key = t.untyped_storage()._cdata
        if key not in self._refs:
            self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += self._refs[key][1]
            self.peak = max(self.peak, self.live)
        self._refs[key][0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch (sharding propagation, redistribution)
            # runs outside the fake mode, on the real mesh tensors; the
            # local ops it issues on fake shards come back through here
            with unset_fake_temporarily():
                return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs or {})

    def dispatch(self, func, types, args=(), kwargs=None):
        out = super().dispatch(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        ns = func.namespace
        name = func._opname
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            c = self.coll[_FUNCTIONAL[name]]
            c["count"] += 1
            c["bytes"] += sum(t.nbytes for t in outs)
        elif ns == "aten" and not func.is_view and outs:
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.nbytes for t in ins + outs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **(kwargs or {}), out_val=out)
        return out


# -- the cell's tensors ------------------------------------------------------
def _fake_dtensor(shape, dtype, placements, mesh, device, counter):
    local = shard_lib.local_shape(shape, mesh, placements)
    with counter:
        t = torch.empty(local, dtype=dtype, device=device)
    counter.track(t)
    return wrap_local(t, mesh, placements, shape)


def _fake_model(cfg, mesh, device, counter, grad: bool):
    model = model_lib.Model(cfg, "meta")
    specs = shard_lib.param_specs(model, mesh,
                                  embed_d_shard=cfg.embed_d_shard)
    for name, p in list(model.named_parameters()):
        model_lib.set_parameter(
            model, name, _fake_dtensor(p.shape, p.dtype, specs[name], mesh,
                                       device, counter), grad)
    return model


def _fake_tree(tree: dict, specs: dict, mesh, device, counter) -> dict:
    return {k: _fake_dtensor(v.shape, v.dtype, specs[k], mesh, device,
                             counter) if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def _tok_micro(cfg, shape, mesh) -> int:
    """Gradient-accumulation heuristic: ~8k tokens per device per
    microbatch."""
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            dp *= mesh.shape[mesh.mesh_dim_names.index(a)]
    per_dev_tokens = shape.global_batch * shape.seq_len // dp
    micro = max(per_dev_tokens // 8192, 1)
    while shape.global_batch % (micro * dp) and micro > 1:
        micro -= 1
    return micro


def _run_cell(cfg, shape, mesh, device, counter, micro: int):
    """The cell's program, once: returns its argument bytes."""
    train = shape.kind == "train"
    model_lib.set_attention_sharding(
        batch_axes(mesh), "model" if cfg.shard_attn else None)
    model = _fake_model(cfg, mesh, device, counter, grad=train)
    batch = configs.input_specs(cfg, shape)
    batch = _fake_tree(batch, shard_lib.batch_specs(cfg, shape, mesh), mesh,
                       device, counter)
    if train:
        named = dict(model.named_parameters())
        sspecs = shard_lib.state_specs({"params": model}, mesh,
                                       embed_d_shard=cfg.embed_d_shard)
        mom = {k: torch.empty(v.shape, device="meta")
               for k, v in named.items()}
        opt = {"m": _fake_tree(mom, sspecs["opt"]["m"], mesh, device,
                               counter),
               "v": _fake_tree(mom, sspecs["opt"]["v"], mesh, device,
                               counter),
               "step": _fake_dtensor((), torch.int32,
                                     sspecs["opt"]["step"], mesh, device,
                                     counter)}
        args = counter.live
        step = make_train_step(cfg, AdamWConfig(), num_microbatches=micro)
        with counter:
            step({"params": model, "opt": opt}, batch)
        return args
    cache = configs.cache_specs(cfg, shape)
    cache = _fake_tree(cache, shard_lib.cache_sharding(cfg, shape, mesh,
                                                       cache),
                       mesh, device, counter)
    args = counter.live
    with counter:
        if shape.kind == "prefill":
            model_lib.prefill(model, cfg, batch, cache)
        else:
            model_lib.decode_step(model, cfg, batch["tokens"], cache)
    return args


def _mesh_size(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               cfg_override: dict | None = None, cfg=None) -> dict:
    """Run one cell on fake devices and count it (module docstring).
    ``cfg`` replaces ``configs.get(arch)`` (tests: a reduced config)."""
    cfg = cfg or configs.get(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"status": "skipped",
                "reason": "pure full-attention arch: 512k dense attention "
                          "is out of scope (DESIGN.md §Arch-applicability)"}
    train = shape.kind == "train"
    device = fake_device()
    if mesh.device_type != device:  # the same ranks, the cell's device
        mesh = make_mesh(mesh.shape, mesh.mesh_dim_names, device)
    micro = _tok_micro(cfg, shape, mesh) if train else 1
    counter = _Counter()
    t0 = time.perf_counter()
    args = _run_cell(cfg, shape, mesh, device, counter, micro)
    run_s = time.perf_counter() - t0
    peak = counter.peak
    return {
        "status": "ok", "mesh": mesh_name, "devices": _mesh_size(mesh),
        "kind": shape.kind, "device": device,
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "collective_bytes": sum(v["bytes"] for v in counter.coll.values()),
        "collectives": counter.coll,
        "argument_bytes": int(args), "temp_bytes": int(peak - args),
        "peak_bytes": int(peak), "run_s": round(run_s, 2),
        "params": model_lib.tree_param_count(cfg),
        "active_params": cfg.active_param_count(),
        "num_microbatches": micro,
    }


# -- the paper's engine on the production mesh -------------------------------
def lower_graph_cell(mesh, mesh_name: str, n: int = 2_000_000,
                     block_size: int = 4096, e_cap: int = 65536,
                     width_per_dev: int = 1) -> dict:
    """The distributed structure-aware sweep (the hot path) at pod scale,
    as the reference's ``shard_map`` program: vertex state replicated,
    ``width_per_dev`` block rows per data rank (their edge rows replicated,
    the reference's ``P()``), each row's pull update (gather, edge map,
    the plain combine, apply, the PSD delta), then the values' sum and the
    PSD's max reconciled over "data" (``all_reduce``). The combine is the
    reference's plain one (``_combine_local(use_pallas=False)``, a
    scatter-add): the port's plain version of kernel 3 folds in the
    kernel's order by a run table read from the data (``nonzero``, host
    reads), which a fake tensor cannot run; both are the same function
    up to sum order. PageRank's update as the reference writes it
    (``values[src] * w``, then ``0.15 / n + 0.85 * agg``), on the rank's
    local tensors."""
    import torch.distributed._functional_collectives as funcol
    num_blocks = n // block_size
    ndev = 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            ndev *= mesh.shape[mesh.mesh_dim_names.index(a)]
    width = ndev * width_per_dev
    device = fake_device()
    if mesh.device_type != device:
        mesh = make_mesh(mesh.shape, mesh.mesh_dim_names, device)
    data = (mesh, mesh.mesh_dim_names.index("data"))
    counter = _Counter()
    f32, i32 = torch.float32, torch.int32
    with counter:
        values = torch.empty(n, dtype=f32, device=device)
        psd = torch.empty(num_blocks, dtype=f32, device=device)
        src = torch.empty(width, e_cap, dtype=i32, device=device)
        dstl = torch.empty(width, e_cap, dtype=i32, device=device)
        w = torch.empty(width, e_cap, dtype=f32, device=device)
        valid = torch.empty(width, e_cap, dtype=torch.bool, device=device)
        gids = torch.empty(width, dtype=i32, device=device)
        rows = torch.empty(width_per_dev, dtype=i32, device=device)
        ok = torch.empty(width_per_dev, dtype=torch.bool, device=device)
    for t in (values, psd, src, dstl, w, valid, gids, rows, ok):
        counter.track(t)
    args = counter.live
    with counter:
        values_in, values_l, psd_l = values, values, psd
        lanes = torch.arange(block_size, device=device)
        for i in range(width_per_dev):
            row = rows[i:i + 1].long()
            e_src = src.index_select(0, row)[0].long()
            msg = values_l.index_select(0, e_src) * \
                w.index_select(0, row)[0]
            msg = torch.where(valid.index_select(0, row)[0], msg, 0.0)
            agg = torch.zeros(block_size, dtype=f32, device=device)
            agg = agg.index_add(0, dstl.index_select(0, row)[0].long(), msg)
            gid = gids.index_select(0, row).long()
            idx = gid * block_size + lanes
            old = values_l.index_select(0, idx)
            new = 0.15 / n + 0.85 * agg
            keep = ok[i:i + 1]
            values_l = values_l.index_copy(0, idx, torch.where(keep, new, old))
            delta = (torch.abs(new - old).sum() / block_size)[None]
            psd_l = torch.where(keep, psd_l.index_copy(0, gid, delta), psd_l)
        values_out = values_in + funcol.all_reduce(values_l - values_in,
                                                   "sum", data)
        psd_out = funcol.all_reduce(psd_l, "max", data)
        funcol.wait_tensor(values_out)
        funcol.wait_tensor(psd_out)
    peak = counter.peak
    return {"status": "ok", "mesh": mesh_name, "devices": _mesh_size(mesh),
            "kind": "graph", "device": device,
            "flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes),
            "argument_bytes": int(args), "temp_bytes": int(peak - args),
            "peak_bytes": int(peak), "collectives": counter.coll,
            "collective_bytes": sum(v["bytes"]
                                    for v in counter.coll.values()),
            "n_vertices": n, "num_blocks": num_blocks}


# Beyond-paper optimized preset (the reference's §Perf levers): the same
# per-arch overrides, runnable now that cast_weights_once is ported.
_COMMON = {"remat_policy": "save_dots", "cast_weights_once": True}
OPTIMIZED = {
    "deepseek_moe_16b": {**_COMMON, "embed_d_shard": True},
    "granite_moe_3b_a800m": {**_COMMON, "embed_d_shard": True,
                             "pad_experts_to": 48, "capacity_factor": 1.0},
    "qwen3_14b": {**_COMMON, "embed_d_shard": True,
                  "pad_q_heads_to": 48, "pad_kv_heads_to": 16},
    "yi_6b": {**_COMMON, "embed_d_shard": True},
    "llama3p2_1b": dict(_COMMON),          # tied embeddings: no d-shard
    "mistral_nemo_12b": {**_COMMON, "embed_d_shard": True},
    "phi3_vision_4p2b": {"remat_policy": "save_dots"},
    "mamba2_2p7b": dict(_COMMON),          # tied
    "hymba_1p5b": dict(_COMMON),           # 25:5 heads: no exact pad
    "whisper_base": {**_COMMON, "embed_d_shard": True},
}


def _error(e: Exception) -> dict:
    return {"status": "error", "error": repr(e),
            "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="default",
                    help="a shape, 'all', or 'default' (" +
                    ", ".join(DEFAULT_SHAPES) + ")")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--graph", action="store_true",
                    help="also dry-run the graph engine sweep")
    ap.add_argument("--preset", default=None, choices=[None, "optimized"],
                    help="apply the §Perf optimized per-arch levers")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = {"all": list(SHAPES), "default": list(DEFAULT_SHAPES)}.get(
        args.shape, [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):  # --force reruns cells, never drops others
        with open(args.out) as f:
            results = json.load(f)

    def flush():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)

    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        ps = production_shape(multi_pod=multi)
        fake_world(512)
        mesh = make_mesh(ps.shape, ps.mesh_dim_names, fake_device())
        if args.graph:
            key = f"graph_pagerank/sweep/{mesh_name}"
            if key not in results or results[key].get("status") == "error" \
                    or args.force:
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    results[key] = lower_graph_cell(mesh, mesh_name)
                except Exception as e:  # noqa: BLE001 (recorded per cell)
                    results[key] = _error(e)
                flush()
        for arch in archs:
            for shape_name in shapes:
                key = f"{arch}/{shape_name}/{mesh_name}"
                if key in results and results[key].get("status") != "error" \
                        and not args.force:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                t0 = time.perf_counter()
                override = (dict(OPTIMIZED.get(arch, {}))
                            if args.preset == "optimized" else None)
                if override and SHAPES[shape_name].kind == "decode":
                    # head pads double the KV cache: train/prefill only
                    override.pop("pad_q_heads_to", None)
                    override.pop("pad_kv_heads_to", None)
                try:
                    results[key] = lower_cell(arch, shape_name, mesh,
                                              mesh_name,
                                              cfg_override=override)
                except Exception as e:  # noqa: BLE001 (recorded per cell)
                    results[key] = _error(e)
                print(f"[dryrun] {key}: {results[key]['status']} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
                flush()
    flush()
    bad = {k: v for k, v in results.items() if v.get("status") == "error"}
    print(f"[dryrun] done: {len(results)} cells, {len(bad)} errors")
    for k, v in bad.items():
        print(f"  ERROR {k}: {v['error']}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
