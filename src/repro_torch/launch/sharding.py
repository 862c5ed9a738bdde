"""Sharding rules for every (arch x shape) cell; port of
``repro.launch.sharding`` onto DTensor placements.

Policy (the reference's):
  * batch shards over ("pod", "data"): only the gradient all-reduce
    crosses pods;
  * "model" carries TP (attention head / ffn-hidden dims, vocab) and EP
    (the expert dim); dims shard only when divisible, else stay replicated;
  * ZeRO-1: optimizer moments additionally shard over "data" on the
    largest still-unsharded dim that is divisible and at least data x 8;
  * decode caches shard seq over "model" and batch over ("pod", "data");
    long_500k (batch 1) shards seq over ALL axes.

A rule first names, per tensor dim, the mesh axes it shards over (a
``PartitionSpec`` as a tuple: ``None``, an axis name, or a tuple of names
major to minor); :func:`to_placements` turns that into one DTensor
placement per mesh dim: ``Shard(i)`` on each axis that names tensor dim
i, ``Replicate()`` elsewhere. Axes of one tuple shard their dim nested in
mesh order, which is the reference's major-to-minor order.

The port's parameters are unstacked: ``layers.{i}.attn.wo`` is (Hq*Dh, D)
where the reference's ``layers/attn/wo`` is (L, Hq*Dh, D). So every rule
that names dim j of a stacked leaf names dim j - 1 here; the sizes the
divisibility tests read are the same numbers. ZeRO-1 picks among the
unstacked dims: where the reference puts "data" on the stacked layer axis
(a leaf whose layer count is the largest divisible dim) the port, which
has no such axis, takes the next dim that qualifies, or none.

The functions return dicts of placements keyed by the port's names
(``dict(model.named_parameters())``; cache and batch leaves by the
reference's leaf names); :func:`distribute_model`, :func:`distribute_state`
and :func:`distribute_tree` lay tensors out with ``distribute_tensor``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.models.attention import local_span
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import set_parameter


def _div(n: int, mesh, axis) -> bool:
    return n % axis_size(mesh, axis) == 0


def to_placements(spec, mesh) -> tuple:
    """One placement per mesh dim for a per-tensor-dim ``spec``."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.mesh_dim_names.index(ax)] = Shard(dim)
    return tuple(out)


def _split_name(name: str) -> tuple[str, str]:
    """(group, leaf) of a port parameter name: ``layers.3.attn.wo`` ->
    ("attn", "wo"); ``embed`` -> ("", "embed")."""
    parts = name.split(".")
    if len(parts) >= 4:
        return parts[-2], parts[-1]
    return "", parts[-1]


def spec_for_param(name: str, shape: tuple, mesh, tied: bool = False,
                   embed_d_shard: bool = False) -> tuple:
    """The reference's rules (``_spec_for_param``) on an unstacked leaf."""
    m = "model"
    nd = len(shape)

    def last_dim_model():
        return (None,) * (nd - 1) + (m,) if _div(shape[-1], mesh, m) else ()

    def first_dim_model():  # the reference's P(None, m, None) on (L, a, b)
        return (m, None) if _div(shape[0], mesh, m) else ()

    group, leaf = _split_name(name)
    if name == "embed":
        # vocab-sharding the input table turns every lookup into a gather
        # of the whole table; with embed_d_shard untied models shard D
        # instead (tied ones keep vocab: their head contracts over D)
        if embed_d_shard and not tied and _div(shape[1], mesh, m):
            return (None, m)
        return (m, None) if _div(shape[0], mesh, m) else ()
    if name == "lm_head":
        return (None, m) if _div(shape[1], mesh, m) else ()
    if group in ("attn", "cross"):
        if leaf in ("wq", "wk", "wv"):
            return last_dim_model()
        if leaf == "wo":
            return first_dim_model()
    if group == "mlp":
        if leaf in ("wg", "wu"):
            return last_dim_model()
        if leaf == "wd":
            return first_dim_model()
    if group == "moe":
        if leaf == "router":
            return last_dim_model()
        if leaf in ("w_gate", "w_up", "w_down"):  # (E, a, b): EP
            if _div(shape[0], mesh, m):
                return (m, None, None)
            hid = 2 if leaf in ("w_gate", "w_up") else 1  # else TP on hidden
            if _div(shape[hid], mesh, m):
                spec = [None] * nd
                spec[hid] = m
                return tuple(spec)
            return ()
        if leaf in ("shared_gate", "shared_up"):
            return last_dim_model()
        if leaf == "shared_down":
            return first_dim_model()
    if group == "ssm":
        if leaf in ("in_x", "in_z", "in_dt"):
            return last_dim_model()
        if leaf == "out":
            return first_dim_model()
        if leaf in ("a_log", "dt_bias", "d_skip", "ssm_norm"):
            return last_dim_model()
    return ()  # norms, conv, small projections: replicated


def _shapes(params) -> dict:
    """Names to shapes of a Model (any device, meta too) or a mapping of
    names to tensors or shapes."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for k, v in params.items()}


def _param_spec_tuples(params, mesh, embed_d_shard: bool) -> dict:
    shapes = _shapes(params)
    tied = "lm_head" not in shapes
    return {k: spec_for_param(k, s, mesh, tied, embed_d_shard)
            for k, s in shapes.items()}


def param_specs(params, mesh, embed_d_shard: bool = False) -> dict:
    """Placements of every parameter, by the port's names."""
    return {k: to_placements(s, mesh) for k, s in
            _param_spec_tuples(params, mesh, embed_d_shard).items()}


def zero1_spec(base: tuple, shape: tuple, mesh) -> tuple:
    """``base`` plus "data" on the largest still-unsharded dim that
    divides by the data axis and holds at least data x 8 (the first such
    dim in index order among equal sizes)."""
    spec = list(base) + [None] * (len(shape) - len(base))
    data = axis_size(mesh, "data")
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % data == 0 \
                and shape[i] >= data * 8:
            spec[i] = "data"
            break
    return tuple(spec)


def zero1_specs(params, mesh, embed_d_shard: bool = False) -> dict:
    """Optimizer-moment placements (ZeRO-1): each parameter's, plus an
    extra "data" shard (:func:`zero1_spec`)."""
    shapes = _shapes(params)
    return {k: to_placements(zero1_spec(s, shapes[k], mesh), mesh)
            for k, s in _param_spec_tuples(params, mesh,
                                           embed_d_shard).items()}


def state_specs(state, mesh, zero1: bool = True,
                embed_d_shard: bool = False) -> dict:
    """Placements of a train state ``{"params", "opt": {"m", "v",
    "step"}}`` (the port's: a Model, or names to tensors or shapes)."""
    params = state["params"]
    p = param_specs(params, mesh, embed_d_shard)
    mom = zero1_specs(params, mesh, embed_d_shard) if zero1 else p
    return {"params": p,
            "opt": {"m": mom, "v": mom, "step": to_placements((), mesh)}}


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                batch_size: int | None = None) -> dict:
    """Placements of the input batch's leaves."""
    b = batch_size or shape.global_batch
    ba = batch_axes(mesh)
    bspec = (ba if ba and _div(b, mesh, ba) else None)

    def named(*spec):
        return to_placements(spec, mesh)

    out = {"tokens": named(bspec, None)}
    if shape.kind == "train":
        out["targets"] = named(bspec, None)
    if cfg.num_patches:
        out["patches"] = named(bspec, None, None)
    if cfg.is_encdec:
        out["frames"] = named(bspec, None, None)
    return out


def cache_sharding(cfg: ArchConfig, shape: ShapeConfig, mesh,
                   cache: dict) -> dict:
    """Placements of the decode cache's leaves (``pos`` replicated)."""
    ba = batch_axes(mesh)
    long_ctx = shape.global_batch == 1
    all_axes = tuple(mesh.mesh_dim_names)
    out = {}
    for name, leaf in cache.items():
        shp = tuple(getattr(leaf, "shape", ()))
        spec = ()
        if name in ("k", "v", "cross_k", "cross_v"):  # (L, B, S, Hkv, Dh)
            if long_ctx:
                seq = all_axes if _div(shp[2], mesh, all_axes) else "model"
                spec = (None, None, seq, None, None)
            else:
                spec = (None, ba if ba and _div(shp[1], mesh, ba) else None,
                        "model" if _div(shp[2], mesh, "model") else None,
                        None, None)
        elif name == "ssm_state":  # (L, B, H, P, N)
            spec = (None, ba if ba and _div(shp[1], mesh, ba) else None,
                    "model" if _div(shp[2], mesh, "model") else None,
                    None, None)
        elif name == "conv":  # (L, B, K-1, CH)
            spec = (None, ba if ba and _div(shp[1], mesh, ba) else None,
                    None, None)
        out[name] = to_placements(spec, mesh)
    return out


def logits_spec(cfg: ArchConfig, shape: ShapeConfig, mesh,
                ndim: int = 2) -> tuple:
    ba = batch_axes(mesh)
    bspec = ba if ba and _div(shape.global_batch, mesh, ba) else None
    v_ax = "model" if _div(cfg.vocab_padded, mesh, "model") else None
    if ndim == 2:
        return to_placements((bspec, v_ax), mesh)
    return to_placements((bspec, None, v_ax), mesh)


# -- laying tensors out ----------------------------------------------------
def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same full tensor on every rank) laid out on ``mesh``."""
    return distribute_tensor(t.detach(), mesh, list(placements))


def distribute_model(model: torch.nn.Module, mesh, specs: dict):
    """Every parameter of ``model`` replaced, in place, by a DTensor
    parameter laid out by ``specs`` (:func:`param_specs`). Returns the
    model."""
    for name, p in list(model.named_parameters()):
        set_parameter(model, name, distribute(p, mesh, specs[name]),
                      p.requires_grad)
    return model


def distribute_tree(tree: dict, mesh, specs: dict) -> dict:
    """A dict of tensors laid out by the placements of ``specs`` under the
    same keys (non-tensor leaves, such as a cache's ``pos``, kept)."""
    return {k: distribute(v, mesh, specs[k]) if isinstance(v, torch.Tensor)
            else v for k, v in tree.items()}


def distribute_state(state: dict, mesh, specs: dict) -> dict:
    """A train state laid out by :func:`state_specs`; the model in place."""
    opt = state["opt"]
    return {"params": distribute_model(state["params"], mesh,
                                       specs["params"]),
            "opt": {"m": distribute_tree(opt["m"], mesh, specs["opt"]["m"]),
                    "v": distribute_tree(opt["v"], mesh, specs["opt"]["v"]),
                    "step": distribute(opt["step"], mesh,
                                       specs["opt"]["step"])}}


def local_shape(shape, mesh, placements) -> tuple:
    """This rank's shard shape of a ``shape`` tensor laid out by
    ``placements`` (plain Python: no tensor is made)."""
    return tuple(local_span(n, mesh, placements, d)[1]
                 for d, n in enumerate(shape))


def full(t: Any):
    """A DTensor's full tensor on every rank; anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t
