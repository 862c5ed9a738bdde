"""State carried across from the reference engine.

:func:`engine_from_arrays` builds the port's :class:`StructureAwareEngine`
(or a subclass of it, such as the distributed engine) from a reference
engine's arrays, handed over as numpy — the vertex
permutation, the unified tile arrays, the initial values and aux, the
coupling matrix and the born hot labels — bypassing the port's own
``build_plan``. A test can then hold a sweep or a superstep against the
reference on identical state even if planning ever diverged: the arrays
play the role that weights play in a model port. The tile arrays may be a
reference engine's LIVE edge state after streaming ingests (appends, kills
and rebuilt runs in any slot order): the port derives its kernel's fold
metadata from whatever layout it is given.

The arrays (all numpy, reference names):

    order, inv            plan.order / plan.inv
    n_live                plan.n_live
    src, dst_local, w,    plan.unified tile arrays, (n_tiles, TILE)
    valid
    tile_start, tile_cnt, plan.unified per-block arrays, (P,)
    edges                 (engine.edge_counts after ingests)
    values0               engine.values0 (permuted, dead-initialised, padded)
    aux                   engine.aux (permuted)
    coupling              engine._coupling, (P, P), or (P, P, S) at S > 1
    is_hot                the born hot labels, a prefix of the blocks (P,)
    cov                   optional: engine EdgeData.cov, (n_tiles, S); the
                          port's own coverage of the tiles must equal it
    hot_block_ids,        optional, together: plan.hot, the group-padded
    hot_src,              storage of the born-hot blocks (EdgeStorage
    hot_dst_local,        fields; (B, E) arrays, (B,) ids and edge counts)
    hot_w, hot_valid,     that the distributed engine sweeps instead of
    hot_edges             building its own
    cold_*                plan.cold, the same six fields

:func:`lm_params_from_arrays` does the same for a language model: it takes
the reference's ``repro.models.model.init_params`` pytree as numpy (the
per-layer tensors stacked on a leading (L,) axis), unstacks it into the
port's :class:`repro_torch.models.model.Model`, and gives the module back,
so both packages run on identical weights (``jax.random`` has no torch
counterpart). :func:`train_state_from_arrays` and
:func:`train_state_to_arrays` carry a whole train state (parameters and
AdamW's moments and step) across, either way: the port's trainer
checkpoints through them, so a checkpoint written by either package
resumes in the other. A sharded state (DTensor leaves) goes out gathered
whole, and comes back sharded from a checkpoint restored onto a mesh
(``CheckpointManager.restore(shardings=checkpoint_specs(...))``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithms import VertexProgram
from repro_torch.core.engine import EngineConfig, StructureAwareEngine
from repro_torch.core.graph import from_edges
from repro_torch.core.partition import (EdgeStorage, PartitionPlan,
                                        TiledStorage)
from repro_torch.models.config import ArchConfig

ARRAYS = ("order", "inv", "n_live", "src", "dst_local", "w", "valid",
          "tile_start", "tile_cnt", "edges", "values0", "aux", "coupling",
          "is_hot")
STORAGE_FIELDS = ("block_ids", "src", "dst_local", "w", "valid", "edges")
_DTYPES = dict(block_ids=np.int64, src=np.int32, dst_local=np.int32,
               w=np.float32, valid=bool, edges=np.int64)


def engine_from_arrays(program: VertexProgram, config: EngineConfig,
                       arrays: dict, device="cuda",
                       cls: type = StructureAwareEngine,
                       **engine_kw) -> StructureAwareEngine:
    """The engine ``cls`` over the reference's arrays; ``engine_kw`` are
    its own keyword arguments (the distributed engine's ``group`` and
    ``blocks_per_device``)."""
    missing = [k for k in ARRAYS if k not in arrays]
    if missing:
        raise KeyError(f"missing arrays: {missing}")
    a = {k: np.asarray(arrays[k]) for k in ARRAYS}
    c = config.block_size
    store = TiledStorage(src=a["src"].astype(np.int32),
                         dst_local=a["dst_local"].astype(np.int32),
                         w=a["w"].astype(np.float32),
                         valid=a["valid"].astype(bool),
                         tile_start=a["tile_start"].astype(np.int32),
                         tile_cnt=a["tile_cnt"].astype(np.int32),
                         edges=a["edges"].astype(np.int64))
    is_hot = a["is_hot"].astype(bool)
    barrier = int(is_hot.sum())
    if not is_hot[:barrier].all():
        raise ValueError("is_hot must be a prefix of the blocks")
    # the permuted graph, read back from the tiles (CSC order is kept)
    n = int(a["order"].size)
    block_of_tile = np.repeat(np.arange(store.num_blocks), store.tile_cnt)
    tt, jj = np.nonzero(store.valid)
    g = from_edges(n, store.src[tt, jj],
                   block_of_tile[tt] * c + store.dst_local[tt, jj],
                   store.w[tt, jj])
    n_live = int(a["n_live"])
    plan = PartitionPlan(graph=g, inv=a["inv"].astype(np.int64),
                         order=a["order"].astype(np.int64), block_size=c,
                         num_blocks=store.num_blocks, n_live=n_live,
                         n_dead=n - n_live, barrier_block=barrier,
                         unified=store, ad=np.zeros(n), t1=0.0, alpha=0.0,
                         subblocks=config.subblocks)
    for key in ("hot", "cold"):  # the cached group storages, handed over
        if f"{key}_src" in arrays:
            plan.__dict__[key] = EdgeStorage(**{
                f: np.ascontiguousarray(arrays[f"{key}_{f}"], _DTYPES[f])
                for f in STORAGE_FIELDS})
    eng = cls.from_plan(plan, program, config, a["values0"], a["aux"],
                        a["coupling"], barrier, device=device, **engine_kw)
    ed = getattr(eng, "_ed", None)  # an engine that sweeps the tiles
    if "cov" in arrays and ed is not None and not torch.equal(
            ed.cov.cpu(),
            torch.as_tensor(np.array(arrays["cov"], dtype=bool))):
        raise ValueError("the tiles' coverage differs from the given cov")
    return eng


def _port_named(tree: dict) -> dict:
    """A reference parameter tree (or a moment tree of the same shape)
    under the port's parameter names: the stacked (L, ...) leaves of
    ``layers`` and ``enc_layers`` unstacked per layer."""
    want = {key: tree[key] for key in ("embed", "ln_f", "lm_head",
                                       "enc_ln_f") if key in tree}
    for stack in ("layers", "enc_layers"):
        for key, leaf in tree.get(stack, {}).items():
            groups = (leaf.items() if isinstance(leaf, dict)
                      else [(None, leaf)])
            for sub, a in groups:
                name = key if sub is None else f"{key}.{sub}"
                for i in range(a.shape[0]):
                    want[f"{stack}.{i}.{name}"] = a[i]
    return want


def _reference_tree(named: dict) -> dict:
    """The inverse of :func:`_port_named`: numpy leaves under the
    reference's names, each layer stack's leaves stacked on (L, ...)."""
    tree: dict = {}
    stacks: dict = {}
    for name, a in named.items():
        parts = name.split(".")
        if parts[0] in ("layers", "enc_layers"):
            stacks.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = a
        else:
            tree[name] = a
    for (stack, *path), per_layer in stacks.items():
        node = tree.setdefault(stack, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([per_layer[i]
                                   for i in range(len(per_layer))])
    return tree


def lm_params_from_arrays(cfg: ArchConfig, tree: dict, device="cuda"):
    """The port's decoder (:class:`repro_torch.models.model.Model`) holding
    the reference's parameter pytree ``tree`` (numpy leaves, the
    reference's names: ``embed``, ``ln_f``, ``lm_head`` where untied,
    ``layers`` with every layer group the tree has, stacked: ``ln1``,
    ``ln2``, ``ln_cross``, ``attn/*``, ``cross/*``, ``ssm/*``, ``mlp/*``,
    ``moe/*``; and whisper's ``enc_layers``, stacked the same way, and
    ``enc_ln_f``)."""
    from repro_torch.models.model import Model
    model = Model(cfg, device)
    named = dict(model.named_parameters())
    want = _port_named(tree)
    _same_names(want, named)
    with torch.no_grad():
        for name, a in want.items():
            named[name].copy_(_f32_like(name, a, named[name]))
    return model


def _same_names(want: dict, have: dict) -> None:
    if set(want) != set(have):
        raise KeyError(f"parameters differ: missing "
                       f"{sorted(set(have) - set(want))}, unexpected "
                       f"{sorted(set(want) - set(have))}")


def _f32_like(name: str, a, like: torch.Tensor) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)
    if a.shape != tuple(like.shape):
        raise ValueError(f"{name}: shape {a.shape}, the port's is "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(a)


def _sharded_state(cfg: ArchConfig, tree: dict) -> dict:
    """:func:`train_state_from_arrays` of DTensor leaves (stacked as the
    checkpoint's): every layer's leaf a DTensor of its own, the model
    built on ``meta`` and given them (nothing else allocated)."""
    from repro_torch.models.model import Model, set_parameter
    model = Model(cfg, "meta")
    want = _port_named(tree["params"])
    _same_names(want, dict(model.named_parameters()))
    for name, t in want.items():
        set_parameter(model, name, t.to(torch.float32).clone())
    opt = {mom: {k: t.to(torch.float32).clone()
                 for k, t in _port_named(tree["opt"][mom]).items()}
           for mom in ("m", "v")}
    opt["step"] = tree["opt"]["step"].to(torch.int32)
    return {"params": model, "opt": opt}


def checkpoint_specs(specs: dict) -> dict:
    """Placements keyed by the port's names (``launch.sharding.
    state_specs``) as the checkpoint's tree (``train_state_to_arrays``):
    a layer stack's leaf (L, ...) takes its layers' placements with each
    ``Shard`` one dim further (its layers' must agree)."""
    from torch.distributed.tensor import Shard

    def stacked(named: dict) -> dict:
        out = {}
        for name, pl in named.items():
            parts = name.split(".")
            if parts[0] in ("layers", "enc_layers"):
                key = ".".join([parts[0], "*", *parts[2:]])
                pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                           for p in pl)
                if out.setdefault(key, pl) != pl:
                    raise ValueError(f"{name}: placements differ across the "
                                     "layer stack")
            else:
                out[name] = pl
        tree: dict = {}
        for key, pl in out.items():
            parts = key.split(".")
            if parts[1:2] == ["*"]:
                parts = [parts[0], *parts[2:]]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = pl
        return tree
    return {"params": stacked(specs["params"]),
            "opt": {"m": stacked(specs["opt"]["m"]),
                    "v": stacked(specs["opt"]["v"]),
                    "step": specs["opt"]["step"]}}


def train_state_from_arrays(cfg: ArchConfig, tree: dict, device="cuda"):
    """The port's train state (``repro_torch.train.step``) from the
    reference's ``{"params", "opt": {"m", "v", "step"}}`` with numpy
    leaves (its ``CheckpointManager.restore()``, or ``jax.device_get`` of
    a live state): the parameters as :func:`lm_params_from_arrays`, ``m``
    and ``v`` as f32 tensors keyed by the port's parameter names, ``step``
    a 0-d int32 tensor, all on ``device``. DTensor leaves (a checkpoint
    restored onto a mesh) give a sharded state laid out as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree["opt"]["step"], DTensor):
        return _sharded_state(cfg, tree)
    model = lm_params_from_arrays(cfg, tree["params"], device)
    named = dict(model.named_parameters())
    opt = {}
    for mom in ("m", "v"):
        want = _port_named(tree["opt"][mom])
        _same_names(want, named)
        opt[mom] = {name: _f32_like(name, a, named[name]).to(
            named[name].device) for name, a in want.items()}
    opt["step"] = torch.tensor(int(np.asarray(tree["opt"]["step"])),
                               dtype=torch.int32, device=model.embed.device)
    return {"params": model, "opt": opt}


def train_state_to_arrays(cfg: ArchConfig, state: dict) -> dict:
    """The reference's train state from the port's: ``{"params", "opt":
    {"m", "v", "step"}}`` as numpy (f32 leaves stacked (L, ...) under the
    reference's names, ``step`` an int32 scalar), which the reference's
    ``jax.tree.map(jnp.asarray, ...)`` resumes from and either package's
    ``CheckpointManager`` saves."""
    from torch.distributed.tensor import DTensor

    def whole(t):  # a DTensor gathered (every rank calls this)
        return t.full_tensor() if isinstance(t, DTensor) else t

    def host(named: dict) -> dict:
        return _reference_tree({k: whole(v.detach()).to("cpu", torch.float32)
                                .numpy() for k, v in named.items()})
    model = state["params"]
    return {"params": host(dict(model.named_parameters())),
            "opt": {"m": host(state["opt"]["m"]),
                    "v": host(state["opt"]["v"]),
                    "step": np.asarray(int(whole(state["opt"]["step"])),
                                       dtype=np.int32)}}
