"""Rank bodies of tests/test_torch_mesh.py, run on spawned gloo ranks by
``repro_torch.launch.mesh.run_ranks`` (a module of their own: a spawned
rank imports it by name, and it imports no JAX)."""
import dataclasses

import torch
import torch.distributed as dist


def _state(cfg, tree):
    from repro_torch.interop import train_state_from_arrays
    return train_state_from_arrays(cfg, tree, device="cpu")


def train_serve_save(rank, cfg, tree, batch, serve_cfg, serve_tree, prompt,
                     steps, ckpt_dir):
    """On a (2, 2) ("data", "model") mesh of 4 ranks: one train step of
    ``tree``'s state sharded by ``state_specs`` beside the single-device
    step on every rank; the sharded state saved to ``ckpt_dir`` (rank 0
    writes); then ``serve_tree``'s model sharded by ``param_specs`` with
    ``shard_attn`` on: a prefill of ``prompt`` and a decode step for each
    of ``steps`` (B, 1) tokens, the cache laid out by ``cache_sharding``.
    Rank 0 returns the losses, the new states as arrays, the placements
    and the logits."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.interop import train_state_to_arrays
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import make_train_step
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    single, m1 = step(_state(cfg, tree), tb)
    mesh = make_host_mesh(model=2, device_type="cpu")
    state = _state(cfg, tree)
    specs = SH.state_specs(state, mesh)
    state = SH.distribute_state(state, mesh, specs)
    bspec = SH.to_placements(("data", None), mesh)
    state, m2 = step(state, {k: SH.distribute(v, mesh, bspec)
                             for k, v in tb.items()})
    out = {"loss_single": float(m1["loss"]),
           "loss_sharded": float(SH.full(m2["loss"])),
           "single": train_state_to_arrays(cfg, single),
           "sharded": train_state_to_arrays(cfg, state),
           "placements": {k: tuple(v.placements) for k, v in
                          state["params"].named_parameters()},
           "specs": specs["params"]}
    if rank == 0:
        CheckpointManager(ckpt_dir, async_write=False).save(1, out["sharded"])
    dist.barrier()

    from repro_torch.interop import lm_params_from_arrays
    params = lm_params_from_arrays(serve_cfg, serve_tree, device="cpu")
    SH.distribute_model(params, mesh, SH.param_specs(params, mesh))
    M.set_attention_sharding(batch_axes(mesh), "model")
    b, s = prompt.shape
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=b)
    cache = M.init_cache(serve_cfg, b, s + len(steps), device="cpu")
    cache_specs = SH.cache_sharding(serve_cfg, shape, mesh, cache)
    cache = SH.distribute_tree(cache, mesh, cache_specs)
    tok = SH.batch_specs(serve_cfg, shape, mesh)["tokens"]
    lspec = SH.logits_spec(serve_cfg, shape, mesh)
    lg, cache = M.prefill(params, serve_cfg, {"tokens": SH.distribute(
        torch.from_numpy(prompt), mesh, tok)}, cache)
    logits = [SH.full(lg.redistribute(mesh, lspec)).numpy()]
    for t in steps:
        lg, cache = M.decode_step(params, serve_cfg, SH.distribute(
            torch.from_numpy(t), mesh, tok), cache)
        logits.append(SH.full(lg.redistribute(mesh, lspec)).numpy())
    M.set_attention_sharding((), None)
    out.update(logits=logits, cache_placements={
        k: tuple(v.placements) for k, v in cache.items() if k != "pos"})
    return out if rank == 0 else None


def restore(rank, cfg, dirs):
    """On a (1, 2) mesh of 2 ranks: each checkpoint of ``dirs`` restored
    onto the mesh by ``state_specs`` (``restore(shardings=...)``), as a
    sharded state; rank 0 returns each one gathered to arrays and the
    restored parameters' placements."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.interop import (checkpoint_specs,
                                     train_state_from_arrays,
                                     train_state_to_arrays)
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    mesh = make_host_mesh(model=2, device_type="cpu")
    specs = SH.state_specs({"params": Model(cfg, "meta")}, mesh)
    out = []
    for d in dirs:
        tree, _ = CheckpointManager(d).restore(
            shardings=checkpoint_specs(specs), mesh=mesh)
        state = train_state_from_arrays(cfg, tree, device="cpu")
        out.append((train_state_to_arrays(cfg, state),
                    {k: tuple(v.placements) for k, v in
                     state["params"].named_parameters()},
                    specs["params"]))
    return out if rank == 0 else None


def sharded_grads_and_down(rank, cases, a, b, w):
    """On a (2, 2) ("data", "model") mesh of 4 ranks, for each ``(cfg,
    tree, batch, micro)`` of ``cases``: the gradients of the state's loss
    with the state sharded by ``state_specs`` and the batch on "data",
    beside the single-device gradients (each parameter's norm and the norm
    of the difference), and one train step at ``micro`` microbatches on
    each side (loss and gradient norm); then the bf16 down projection's
    weight gradient through both routes of ``matmul_f32`` (the card's
    ``_MatmulF32``, with an f32 GEMM standing in for ``aten::mm.dtype``,
    which the CPU lacks, and the CPU route): ``a`` (T, K) sharded on both
    axes, ``b`` (K, N) on "model" by rows, the loss ``sum(out * w)``, so
    the weight gradient sums over the token rows that "data" splits.
    Rank 0 returns them."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import named
    from repro_torch.train.step import _grads, make_train_step
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_host_mesh(model=2, device_type="cpu")
    bspec = SH.to_placements(("data", None), mesh)

    def sharded(cfg, tree):
        state = _state(cfg, tree)
        return SH.distribute_state(state, mesh, SH.state_specs(state, mesh))

    out = []
    for cfg, tree, batch, micro in cases:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        db = {k: SH.distribute(v, mesh, bspec) for k, v in tb.items()}
        one = _state(cfg, tree)["params"]
        _, _, g1 = _grads(one, named(one), cfg, tb)
        many = sharded(cfg, tree)["params"]
        _, _, g2 = _grads(many, named(many), cfg, db)
        norms = {k: (float(g1[k].norm()),
                     float((SH.full(g2[k]) - g1[k]).norm())) for k in g1}
        step = make_train_step(cfg, opt, num_microbatches=micro)
        _, m1 = step(_state(cfg, tree), tb)
        _, m2 = step(sharded(cfg, tree), db)
        out.append({"grads": norms, "single": {
            k: float(m1[k]) for k in ("loss", "grad_norm")}, "sharded": {
            k: float(SH.full(m2[k])) for k in ("loss", "grad_norm")}})

    def bf16(x, spec):
        return SH.distribute(torch.from_numpy(x).to(torch.bfloat16), mesh,
                             SH.to_placements(spec, mesh))

    def f32_gemm(a2, b2):
        return torch.mm(a2.float(), b2.float())

    down = {}
    card_mm = L._mm_f32
    L._mm_f32 = f32_gemm
    try:
        for route, fn in (("card", L._MatmulF32.apply),
                          ("cpu", L.matmul_f32)):
            wt = bf16(b, ("model", None)).requires_grad_()
            y = fn(bf16(a, ("data", "model")), wt)
            ct = SH.distribute(torch.from_numpy(w), mesh, bspec)
            (y.float() * ct).sum().backward()
            down[route] = (SH.full(wt.grad).float().numpy(),
                           tuple(wt.grad.placements))
    finally:
        L._mm_f32 = card_mm
    return (out, down) if rank == 0 else None


def four_ranks(rank, main_args, extra_args):
    """:func:`train_serve_save` and :func:`sharded_grads_and_down` on one
    spawn of 4 ranks."""
    main = train_serve_save(rank, *main_args)
    extra = sharded_grads_and_down(rank, *extra_args)
    return (main, extra) if rank == 0 else None
