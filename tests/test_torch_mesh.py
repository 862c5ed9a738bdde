"""The port's sharded programs on spawned gloo ranks
(``repro_torch.launch.mesh.run_ranks``), held against the single-device
programs and the reference, at the reference's bars
(tests/test_distributed.py): reduced qwen3_14b's train step on a (2, 2)
("data", "model") mesh of 4 ranks (loss rtol 1e-4; parameters rtol 5e-2,
atol 5e-3: Adam's first step is ~sign(g) * lr and sharded sums can flip
the sign of a near-zero gradient); its prefill and decode steps with
``shard_attn`` on (f32 logits at tests/test_torch_models.py's bar); a
checkpoint saved on 4 ranks and restored onto 2 (the elastic resize), and
one the reference wrote, bitwise; and the training driver at a model axis
of 2 over 4 ranks rebalancing experts at 2 shards; in f32, every
parameter's gradient of a dense, an MoE, an SSM and a hybrid arch equal
to the single device's up to sum order, and reduced
granite_moe_3b_a800m's step at 2 microbatches, whose load-balancing loss
sees the reference's row blocks; and the bf16 down projection's weight
gradient, reduced over the token-sharded rows in f32 before its one
rounding. One spawn of 4 ranks and one of 2 serve every check (module
fixtures)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_mesh_ranks as ranks
from repro import configs as JC
from repro.ckpt import CheckpointManager as JCkpt
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_step
from repro_torch.data import SyntheticLM
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import MeshShape, run_ranks
from repro_torch.models.config import ArchConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3_14b"
MOE_ARCH = "granite_moe_3b_a800m"
GRAD_ARCHS = ("qwen3_14b", MOE_ARCH, "mamba2_2p7b", "hymba_1p5b")
B, S, GEN = 4, 16, 4  # serve: the cache (S + GEN = 20) shards its seq by 2
TOL32 = dict(rtol=1e-4, atol=1e-4)


def _port(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=a.dtype), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's step and serve, the 4-rank spawn and the 2-rank
    restore."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = JC.reduced(JC.get(ARCH))
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state0 = {"params": params, "opt": jadamw_init(params)}
    tree = _np_tree(state0)
    batch = SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch(0)
    opt = JAdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    s_ref, m_ref = jax.jit(jmake_step(cfg, opt))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    # serving: f32, every wo redrawn (the reference's zero wo hides
    # attention from the logits)
    scfg = dataclasses.replace(cfg, dtype="float32", shard_attn=True)
    stree = _np_tree(JM.init_params(scfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    wo = stree["layers"]["attn"]["wo"]
    wo[...] = rng.normal(size=wo.shape) * wo.shape[1] ** -0.5
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
             for _ in range(GEN)]
    jp = jax.tree.map(jnp.asarray, stree)
    cache = JM.init_cache(scfg, B, S + GEN)
    lg, cache = JM.prefill(jp, scfg, {"tokens": jnp.asarray(prompt)}, cache)
    want = [np.asarray(lg)]
    for t in steps:
        lg, cache = JM.decode_step(jp, scfg, jnp.asarray(t), cache)
        want.append(np.asarray(lg))
    # a checkpoint the reference writes, of the same state
    JCkpt(str(tmp / "reference"), async_write=False).save(1, tree)
    # f32 gradients of four families (every wo redrawn), and an MoE's
    # step at 2 microbatches
    cases, micro_ref = [], None
    for i, arch in enumerate(GRAD_ARCHS):
        gcfg = dataclasses.replace(JC.reduced(JC.get(arch)),
                                   dtype="float32")
        gp = JM.init_params(gcfg, jax.random.PRNGKey(10 + i))
        gtree = _np_tree({"params": gp, "opt": jadamw_init(gp)})
        layers = gtree["params"]["layers"]
        if "attn" in layers:
            layers["attn"]["wo"][...] = rng.normal(
                size=layers["attn"]["wo"].shape) * 0.1
        gbatch = SyntheticLM(gcfg.vocab_size, 32, 8, seed=20 + i).batch(0)
        micro = 2 if arch == MOE_ARCH else 1
        cases.append((_port(gcfg), gtree, gbatch, micro))
        if micro > 1:
            _, mm = jax.jit(jmake_step(gcfg, opt, num_microbatches=micro))(
                jax.tree.map(jnp.asarray, gtree),
                jax.tree.map(jnp.asarray, gbatch))
            micro_ref = {k: float(mm[k]) for k in ("loss", "grad_norm")}
    # the down projection's operands, bf16 values held in f32
    a, b, w = (_bf16(rng.normal(size=s)) for s in ((64, 32), (32, 16),
                                                    (64, 16)))
    four, (grads, down) = run_ranks(
        ranks.four_ranks, 4, "cpu",
        ((_port(cfg), tree, batch, _port(scfg), stree, prompt, steps,
          str(tmp / "four")), (cases, a, b, w)),
        timeout=600)[0]
    two = run_ranks(ranks.restore, 2, "cpu",
                    (_port(cfg), [str(tmp / "four"),
                                  str(tmp / "reference")]), timeout=600)[0]
    return {"ref_loss": float(m_ref["loss"]),
            "ref_params": _np_tree(s_ref["params"]), "tree": tree,
            "want": want, "four": four, "two": two,
            "grads": dict(zip(GRAD_ARCHS, grads)), "micro_ref": micro_ref,
            "down": (a, b, w), "down_got": down}


def _bf16(x):
    """``x`` rounded to bf16 (to nearest even), held in f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_sharded_train_step_matches_single_device_and_reference(runs):
    four = runs["four"]
    np.testing.assert_allclose(four["loss_sharded"], four["loss_single"],
                               rtol=1e-4)
    np.testing.assert_allclose(four["loss_sharded"], runs["ref_loss"],
                               rtol=1e-4)
    ref = dict(_leaves(runs["ref_params"]))
    single = dict(_leaves(four["single"]["params"]))
    for path, a in _leaves(four["sharded"]["params"]):
        for want in (single[path], ref[path]):
            np.testing.assert_allclose(a, np.asarray(want, np.float32),
                                       rtol=5e-2, atol=5e-3,
                                       err_msg=str(path))


def test_sharded_state_laid_out_by_the_rules(runs):
    """Every parameter of the stepped state keeps ``state_specs``'
    placements, and the (2, 2) mesh shards some on each axis."""
    four = runs["four"]
    assert four["placements"] == {k: tuple(v)
                                  for k, v in four["specs"].items()}
    dims = {(i, p.dim) for pl in four["placements"].values()
            for i, p in enumerate(pl) if isinstance(p, Shard)}
    assert {(1, 0), (1, 1)} <= dims  # model on rows and on columns
    want = SH.cache_sharding(
        _port(JC.reduced(JC.get(ARCH))),
        dataclasses.replace(JC.SHAPES["decode_32k"], global_batch=B),
        MeshShape((2, 2), ("data", "model")),
        {"k": np.zeros((2, B, S + GEN, 2, 16)),
         "v": np.zeros((2, B, S + GEN, 2, 16))})
    assert four["cache_placements"] == want


def test_sharded_prefill_decode_match_reference(runs):
    got, want = runs["four"]["logits"], runs["want"]
    assert len(got) == len(want) == GEN + 1
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, err_msg=f"step {i}", **TOL32)


def test_elastic_reshard_restores_bitwise(runs):
    """Saved from a (2, 2) mesh of 4 ranks, restored onto a (1, 2) mesh of
    2: every leaf bitwise, each parameter laid out by the new mesh's
    ``state_specs``."""
    arrays, placements, specs = runs["two"][0]
    saved = dict(_leaves(runs["four"]["sharded"]))
    for path, a in _leaves(arrays):
        np.testing.assert_array_equal(a, saved[path], err_msg=str(path))
    assert placements == {k: tuple(v) for k, v in specs.items()}


def test_reference_checkpoint_restores_onto_mesh(runs):
    arrays, _, _ = runs["two"][1]
    want = dict(_leaves(runs["tree"]))
    for path, a in _leaves(arrays):
        np.testing.assert_array_equal(a, np.asarray(want[path], a.dtype),
                                      err_msg=str(path))


def test_launch_train_rebalances_at_model_axis(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite_moe_3b_a800m", "--reduced", "--steps", "6", "--batch",
         "4", "--seq", "16", "--model-axis", "2", "--nproc", "4",
         "--device", "cpu", "--expert-rebalance", "--log-every", "1",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[train] expert rebalancer over 2 shard(s)" in r.stdout
    assert "expert rebalance #1 applied" in r.stdout
    assert "[train] done" in r.stdout


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_match_single_device(runs, arch):
    """In f32 each parameter's gradient on the (2, 2) mesh is the single
    device's up to sum order (relative 1e-5 in norm): a weight that a
    rank-local computation reads whole while the work is split (the
    embedding table over the batch's ranks, the SSM's a_log, b and c over
    the batch's and the heads' ranks, unsharded KV heads over the query
    heads') sums its ranks' gradients."""
    for name, (norm, diff) in runs["grads"][arch]["grads"].items():
        assert diff <= 1e-5 * norm + 1e-7, (name, norm, diff)


def test_sharded_microbatches_are_the_reference_row_blocks(runs):
    """At 2 microbatches, microbatch j is the global batch's j-th row
    block on the mesh too: reduced granite's loss and gradient norm (f32)
    equal the single-device step's up to sum order (rtol 1e-5; blocks of
    each rank's own rows would move the gradient norm by ~2e-4, through
    the load-balancing loss) and the reference's at its bars."""
    got = runs["grads"][MOE_ARCH]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["sharded"][k], got["single"][k],
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["sharded"]["loss"],
                               runs["micro_ref"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["sharded"]["grad_norm"],
                               runs["micro_ref"]["grad_norm"], rtol=1e-3)


@pytest.mark.parametrize("route", ["card", "cpu"])
def test_down_projection_weight_grad_reduced_in_f32(runs, route):
    """The bf16 weight gradient of ``matmul_f32`` on the (2, 2) mesh is the
    f32 product over all token rows rounded once, as the reference reduces
    its f32 dot before rounding: it differs from that far less often than
    the sum of the two "data" ranks' partial products each rounded to
    bf16 first. It is laid out as the weight."""
    a, b, w = runs["down"]
    got, placements = runs["down_got"][route]
    want = _bf16(a.T.astype(np.float64) @ w)
    half = a.shape[0] // 2
    partials = _bf16(sum(_bf16(a[i:i + half].T.astype(np.float64)
                               @ w[i:i + half]) for i in (0, half)))
    off = np.mean(got != want)
    assert np.mean(partials != want) > 0.1
    assert off < 0.02 and off < np.mean(partials != want) / 4
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    assert placements == (Replicate(), Shard(0))
